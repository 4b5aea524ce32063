"""The meshes that compose the pipeline with data parallelism and sequence
parallelism with FSDP2 and tensor parallelism, on four gloo ranks on the CPU
(vpt_tpu_torch/training/pp_bc.py, parallel/model.py):

  * ``PPBCTrainer`` on a (pp=2, dp=2) mesh, each dp pipeline its half of the
    rows: its three steps equal vpt_tpu's single-device BC steps at
    tests/test_torch_fsdp_tp.py's tolerances (loss 1e-5, grad norm 1e-4
    relative, every parameter within 3·lr), and every rank reports the same
    loss, norm and whole weights;
  * BC steps on sp=2 x fsdp=2 and on sp=2 x tp=2 against the same reference
    under the same rules;
  * an IDM step on the same two meshes against the port's own meshless step
    on the same weights and windows (tests/test_torch_distributed.py's
    tolerances);
  * the command-line mesh (``cli_mesh``) takes ``--fsdp 2 --sp 2`` and
    ``--sp 2 --tp 2``, and the pipeline names the axis it does not take;
  * ``python -m vpt_tpu_torch.run_agent --mock-env --mesh-dp 4`` serves 8
    streams in 2 automatic groups, each rank its row of each group.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_distributed as dist_cases
import test_torch_fsdp_tp as bc_cases
from test_torch_mesh import run_ranks

SP_MESHES = {"sp2_fsdp2": dict(n_sp=2, n_fsdp=2), "sp2_tp2": dict(n_sp=2, n_tp=2)}


@pytest.fixture(autouse=True, scope="module")
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


# ------------------------------------------------------------------ rank side


def pp_dp_steps(rank, out_dir):
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training import bc
    from vpt_tpu_torch.training.pp_bc import PPBCTrainer

    mesh = pm.make_mesh(n_pp=2, n_dp=2)
    batches = bc_cases.load_batches(os.path.join(out_dir, "batches.npz"))
    trainer = PPBCTrainer(bc_cases.TINY_KWARGS, bc_cases.PI_KWARGS, hp=bc.BCHyperparams(**bc_cases.HP), mesh=mesh,
                          n_micro=2, device="cpu")
    trainer.load_weights(os.path.join(out_dir, "init.weights"))
    state = trainer.initial_state(bc_cases.B)
    losses, norms = [], []
    for batch in batches:
        state, loss, norm = trainer.train_step(pm.local_batch(mesh, batch), state)
        losses.append(float(loss))
        norms.append(float(norm))
    return {"loss": losses, "grad_norm": norms, "weights": trainer.checkpoint_params(),
            "coords": (pm.axis_rank(mesh, "pp"), pm.axis_rank(mesh, "dp")), "rows": state[0]["k"].shape[0]}


def write_idm_inputs(tmp):
    """Two IDM batches as tests/test_torch_distributed.py draws them (the
    second with a padded tail), and the port's own random initial IDM
    weights."""
    from vpt_tpu_torch.training import idm

    rng = np.random.default_rng(0)
    batches = []
    for s in range(2):
        mask = np.ones((dist_cases.IDM_B, dist_cases.IDM_T), bool)
        if s == 1:  # a padded tail
            mask[1, 5:] = False
        shape = (dist_cases.IDM_B, dist_cases.IDM_T)
        batches.append({"frames": rng.integers(0, 256, shape + (32, 32, 3), dtype=np.uint8),
                        "buttons": rng.integers(0, 8641, shape).astype(np.int32),
                        "camera": rng.integers(0, 121, shape).astype(np.int32),
                        "firsts": np.zeros(shape, bool), "mask": mask})
    torch.save(batches, os.path.join(tmp, "idm_batches.pt"))
    trainer = idm_trainer(None)
    trainer.init()
    torch.save(trainer.full_weights(), os.path.join(tmp, "idm_init.weights"))


def write_policy_files(tmp):
    """The tiny policy's .model and the port's random initial .weights."""
    from vpt_tpu_torch.agent import MineRLAgent
    from vpt_tpu_torch.checkpoint import save_model_parameters, save_weights

    save_model_parameters(os.path.join(tmp, "policy.model"), bc_cases.TINY_KWARGS, bc_cases.PI_KWARGS)
    agent = MineRLAgent(device="cpu", policy_kwargs=bc_cases.TINY_KWARGS, pi_head_kwargs=bc_cases.PI_KWARGS)
    save_weights(os.path.join(tmp, "policy.weights"), agent.policy)


def idm_trainer(mesh):
    from vpt_tpu_torch.training import idm

    return idm.IDMTrainer(dist_cases.IDM_TINY, {"temperature": 1.0}, device="cpu", mesh=mesh,
                          hp=idm.IDMHyperparams(batch_size=dist_cases.IDM_B, window=dist_cases.IDM_T,
                                                learning_rate=dist_cases.LR))


def meshless_idm_steps(tmp):
    trainer = idm_trainer(None)
    trainer.load_weights(os.path.join(tmp, "idm_init.weights"))
    losses, norms = [], []
    for batch in torch.load(os.path.join(tmp, "idm_batches.pt"), weights_only=False):
        loss, norm = trainer.train_step(batch)
        losses.append(float(loss))
        norms.append(float(norm))
    return {"loss": losses, "grad_norm": norms, "weights": trainer.full_weights()}


def compose_cases(rank, world, out_dir):
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training.pp_bc import PPBCTrainer

    out = {"pp_dp": pp_dp_steps(rank, out_dir)}
    out.update(bc_cases.bc_steps(rank, world, out_dir, meshes=SP_MESHES))
    out["idm"] = {name: dist_cases._idm_steps(rank, out_dir, shape) for name, shape in SP_MESHES.items()}
    out["cli"] = {}
    for name, kw in (("fsdp2_sp2", dict(fsdp=2, sp=2)), ("sp2_tp2", dict(sp=2, tp=2))):
        mesh = pm.cli_mesh("cpu", **kw)
        out["cli"][name] = [pm.axis_size(mesh, a) for a in pm.AXES]
    try:
        PPBCTrainer(bc_cases.TINY_KWARGS, bc_cases.PI_KWARGS, mesh=pm.make_mesh(n_pp=2, n_fsdp=2), device="cpu")
        out["pp_fsdp_error"] = None
    except ValueError as e:
        out["pp_fsdp_error"] = str(e)
    out["serving"] = mesh_dp_serving(out_dir)
    return out


def mesh_dp_serving(out_dir):
    from vpt_tpu_torch import run_agent

    seeds = []
    envs = run_agent._rank_envs

    def rank_envs(streams, groups, mesh):
        made = envs(streams, groups, mesh)
        seeds.extend(e._t for e in made)  # MockMinecraftEnv starts its frame pool at its seed
        return made

    run_agent._rank_envs = rank_envs
    stats = run_agent.main(["--model", os.path.join(out_dir, "policy.model"), "--weights",
                            os.path.join(out_dir, "policy.weights"), "--mock-env", "--streams", "8", "--steps", "3",
                            "--mesh-dp", "4", "--device", "cpu"])
    return {"frames": stats["frames"], "groups": stats["groups"], "seeds": seeds}


# ------------------------------------------------------------------ tests


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("compose"))
    ref = bc_cases.shared_reference(tmp_path_factory, tmp)
    write_idm_inputs(tmp)
    write_policy_files(tmp)
    return ref, run_ranks(4, __file__, "compose_cases", tmp), meshless_idm_steps(tmp)


def test_pipeline_with_dp_equals_vpt_tpu(four_ranks):
    ref, outs, _ = four_ranks
    ours = outs[0]["pp_dp"]
    bc_cases.assert_matches(ours, ref, what="pp=2 x dp=2")
    # rank r is (pp, dp) = (r // 2, r % 2), each dp pipeline half the rows
    assert [o["pp_dp"]["coords"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(o["pp_dp"]["rows"] == bc_cases.B // 2 for o in outs)
    for out in outs[1:]:
        assert out["pp_dp"]["loss"] == ours["loss"] and out["pp_dp"]["grad_norm"] == ours["grad_norm"]
        for k, v in ours["weights"].items():
            assert torch.equal(v, out["pp_dp"]["weights"][k]), k


@pytest.mark.parametrize("mesh", sorted(SP_MESHES))
def test_sp_composed_bc_step_equals_vpt_tpu(four_ranks, mesh):
    ref, outs, _ = four_ranks
    bc_cases.assert_matches(outs[0][mesh], ref, what=mesh)
    assert len(outs[0][mesh]["sharded"]) > 0
    for out in outs[1:]:
        np.testing.assert_allclose(out[mesh]["loss"], outs[0][mesh]["loss"], rtol=1e-6)
        np.testing.assert_allclose(out[mesh]["grad_norm"], outs[0][mesh]["grad_norm"], rtol=1e-6)


@pytest.mark.parametrize("mesh", sorted(SP_MESHES))
def test_sp_composed_idm_step_equals_meshless(four_ranks, mesh):
    _, outs, plain = four_ranks
    ours = outs[0]["idm"][mesh]
    np.testing.assert_allclose(ours["loss"], plain["loss"], rtol=1e-5)
    np.testing.assert_allclose(ours["grad_norm"], plain["grad_norm"], rtol=1e-4)
    dist_cases._weights_close(ours["weights"], plain["weights"], 3 * dist_cases.LR)


def test_cli_mesh_takes_sp_with_fsdp_and_tp(four_ranks):
    _, outs, _ = four_ranks
    for out in outs:
        assert out["cli"]["fsdp2_sp2"] == [1, 1, 2, 2, 1]
        assert out["cli"]["sp2_tp2"] == [1, 1, 1, 2, 2]
        assert "fsdp" in out["pp_fsdp_error"]


def test_run_agent_serves_over_mesh_dp(four_ranks):
    _, outs, _ = four_ranks
    served = [out["serving"] for out in outs]
    assert all(s["groups"] == 2 and s["frames"] == 2 * 3 for s in served)  # 2 groups of 4, a stream a rank each
    assert [s["seeds"] for s in served] == [[0, 4], [1, 5], [2, 6], [3, 7]]
