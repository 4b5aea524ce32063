"""Repairs of the port's divergences from vpt_tpu, on the CPU: what raised in
the port and computes in vpt_tpu, held against vpt_tpu or the meshless run.

  * resume at another stream geometry: a BC run checkpointed at B=2 goes on
    at B=1 (this process) and at 2 gloo ranks of one stream each, its step
    count kept and its streams started afresh from the coarse trajectory
    cursor (the loader's batches against vpt_tpu's at such a cursor are in
    tests/test_torch_data.py);
  * QAT over tp: fake quantization of a colwise and a rowwise shard equals
    the whole weight's, and two QAT BC steps on tp=2 (f32, B=2, T=4) equal
    vpt_tpu's single-device QAT steps at tests/test_torch_fsdp_tp.py's
    tolerances (loss rtol 1e-5, grad norm rtol 1e-4, weights within 3·lr a
    step);
  * ``rl_fine_tune --eval-every 1`` at 2 ranks prints vpt_tpu's notice and
    writes the weights of the same run without the flag, bit for bit;
  * the axes vpt_tpu replicates over: MineRLAgent under pp, sp and tp,
    IDMAgent under pp and tp, PPOTrainer under sp, each rank a replica,
    equal to the meshless agent's sampled actions (exactly: the meshed draw
    is the global batch's) and labels (exactly) and the meshless PPO update
    (metrics rtol 1e-5, weights within 1e-6).

One launch of two ranks computes every multi-rank case (``run_ranks`` of
tests/test_torch_mesh.py); the tests read its results.
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import test_torch_distributed as dist_cases
import test_torch_fsdp_tp as bc_cases
from test_torch_mesh import run_ranks

QAT_B, QAT_T, QAT_STEPS = 2, 4, 2
AGENT_MESHES = {"pp": dict(n_pp=2), "sp": dict(n_sp=2), "tp": dict(n_tp=2)}
IDM_MESHES = {"pp": dict(n_pp=2), "tp": dict(n_tp=2)}
PPO_HP = dict(rollout_len=4, n_minibatches=2, n_epochs=2, learning_rate=dist_cases.LR, aux_phase_every=1000)
RL_CLI = dict(mock_env=True, streams=2, updates=1, rollout_len=4, compute_dtype="float32", device="cpu",
              eval_episodes=1, eval_streams=1, eval_max_steps=4)
BC_HP = dict(batch_size=2, chunk_len=4, epochs=1, learning_rate=dist_cases.LR, loss_report_rate=1)


@pytest.fixture(autouse=True, scope="module")
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield

# ------------------------------------------------------------------ both sides


def _bc_resume(out_dir, batch_size, mesh=None):
    """``BCTrainer.train`` at ``batch_size`` resuming ``bc_ckpt``: its steps,
    the steps it logged and what it printed."""
    from vpt_tpu_torch.training import bc
    from vpt_tpu_torch.utils.metrics import MetricsLogger

    trainer = bc.BCTrainer(dist_cases.POLICY_TINY, dist_cases.PI_KWARGS, device="cpu", mesh=mesh,
                           hp=bc.BCHyperparams(**dict(BC_HP, batch_size=batch_size)))
    log, printed = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(printed):
        ranks = 1 if mesh is None else torch.distributed.get_world_size()
        steps = trainer.train(os.path.join(out_dir, "corpus"), os.path.join(out_dir, f"bc_resumed_{ranks}.weights"),
                              metrics=MetricsLogger(stream=log), resume_dir=os.path.join(out_dir, "bc_ckpt"))
    logged = [json.loads(line)["step"] for line in log.getvalue().splitlines() if "loss" in line]
    return {"steps": steps, "logged": logged, "printed": printed.getvalue()}

# ------------------------------------------------------------------ rank side


def _qat_tp(rank, out_dir):
    from torch.distributed.tensor import Shard, distribute_tensor

    from vpt_tpu_torch.ops.int8 import fake_quant_kernel
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training import bc

    mesh = pm.make_mesh(n_tp=2)
    w = torch.load(os.path.join(out_dir, "fq_weight.pt"))
    out = {name: pm.full_tensor(fake_quant_kernel(distribute_tensor(w, mesh["tp"], [Shard(dim)])))
           for name, dim in (("colwise", 0), ("rowwise", 1))}
    batches = bc_cases.load_batches(os.path.join(out_dir, "qat_batches.npz"))
    trainer = bc.BCTrainer(bc_cases.TINY_KWARGS, bc_cases.PI_KWARGS, device="cpu", mesh=mesh, qat_dense=True,
                           hp=bc.BCHyperparams(batch_size=QAT_B, chunk_len=QAT_T, learning_rate=dist_cases.LR))
    report = trainer.load_weights(os.path.join(out_dir, "qat_init.weights"))
    assert not report["missing"] and not report["unexpected"], report
    out["sharded_fake_quant"] = sorted(
        n for n, m in trainer.policy.named_modules() if getattr(m, "fake_quant", False)
        and isinstance(getattr(m, "weight", None) if hasattr(m, "weight") else m.layer.weight,
                       torch.distributed.tensor.DTensor))
    state = trainer.initial_state(QAT_B)
    losses, norms = [], []
    for batch in batches:
        state, loss, norm = trainer.train_step(pm.local_batch(mesh, batch), state)
        losses.append(float(loss))
        norms.append(float(norm))
    out.update(loss=losses, grad_norm=norms, weights=trainer.full_weights())
    return out


def _replicas(rank, out_dir):
    from vpt_tpu_torch.agent.agent import MineRLAgent
    from vpt_tpu_torch.agent.idm import IDMAgent
    from vpt_tpu_torch.parallel import mesh as pm

    obs = np.load(os.path.join(out_dir, "agent_obs.npy"))
    windows = np.load(os.path.join(out_dir, "idm_windows.npy"))
    out = {"agent": {}, "idm": {}}
    for name, shape in AGENT_MESHES.items():
        out["agent"][name] = _agent_actions(obs, pm.make_mesh(**shape))
    for name, shape in IDM_MESHES.items():
        agent = IDMAgent(dist_cases.IDM_TINY, {"temperature": 1.0}, device="cpu", mesh=pm.make_mesh(**shape))
        agent.load_weights(os.path.join(out_dir, "idm.weights"))
        out["idm"][name] = agent.predict_actions_batched(windows)
    out["ppo"] = _ppo_update(out_dir, pm.make_mesh(n_sp=2))
    return out


def _rl_cli(rank, out_dir):
    from vpt_tpu_torch import rl_fine_tune

    args = rl_fine_tune.parse_args(["--in-model", "m", "--in-weights", "w", "--out-weights", "o", "--eval-every",
                                    "1"])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        for name, eval_every in (("eval", args.eval_every), ("plain", 0)):
            rl_fine_tune.main(os.path.join(out_dir, "policy.model"), os.path.join(out_dir, "policy.weights"),
                              os.path.join(out_dir, f"rl_{name}.weights"), eval_every=eval_every, **RL_CLI)
    return printed.getvalue()


def repair_cases(rank, world, out_dir, bc_resume):
    from vpt_tpu_torch.parallel import mesh as pm

    out = {"qat_tp": _qat_tp(rank, out_dir), "replicas": _replicas(rank, out_dir), "rl_cli": _rl_cli(rank, out_dir)}
    if bc_resume:
        out["bc_resume"] = _bc_resume(out_dir, 2, pm.make_mesh(n_dp=2))
    return out

# ------------------------------------------------------------------ meshless runs


def _agent_actions(obs, mesh=None):
    from vpt_tpu_torch.agent.agent import MineRLAgent

    agent = MineRLAgent(device="cpu", policy_kwargs=dist_cases.POLICY_TINY, pi_head_kwargs=dist_cases.PI_KWARGS,
                        batch_size=dist_cases.STREAMS, seed=0, mesh=mesh)
    return [[{k: np.asarray(v) for k, v in a.items()}
             for a in agent.get_action([{"pov": o} for o in obs[t]], first=np.full(dist_cases.STREAMS, t == 0))]
            for t in range(obs.shape[0])]


def _ppo_update(out_dir, mesh=None):
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training import rl

    trainer = rl.PPOTrainer(dist_cases.POLICY_TINY, dist_cases.PI_KWARGS, hp=rl.PPOHyperparams(**PPO_HP),
                            device="cpu", mesh=mesh)
    trainer.load_weights(os.path.join(out_dir, "policy.weights"))
    traj, _, _ = trainer.collect([MockMinecraftEnv(seed=i, done_prob=0.3) for i in range(dist_cases.STREAMS)],
                                 reward_fn=lambda a, o, r, d: float(a["attack"]))
    metrics = trainer.update(traj)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "weights": pm.full_state_dict(trainer.policy)}


def _qat_reference(tmp):
    """vpt_tpu's single-device QAT BC steps (its fake quantization takes the
    max over the whole input axis), from its initial weights."""
    import jax

    from vpt_tpu.parallel.mesh import make_mesh
    from vpt_tpu.training import bc as jax_bc
    from vpt_tpu_torch.checkpoint import from_jax_variables

    batches = bc_cases.make_batches(seed=4, b=QAT_B, t=QAT_T, steps=QAT_STEPS)
    bc_cases.save_batches(os.path.join(tmp, "qat_batches.npz"), batches)
    jt = jax_bc.BCTrainer(bc_cases.TINY_KWARGS, bc_cases.PI_KWARGS, seed=0, qat_dense=True,
                          hp=jax_bc.BCHyperparams(batch_size=QAT_B, chunk_len=QAT_T, learning_rate=dist_cases.LR),
                          mesh=make_mesh(n_dp=1, devices=jax.devices()[:1]))
    jt.init()
    torch.save(from_jax_variables(jax.tree.map(np.asarray, jt.variables)), os.path.join(tmp, "qat_init.weights"))
    state = jt.initial_state(QAT_B)
    losses, norms = [], []
    for batch in batches:
        state, loss, norm = jt.train_step(batch, state)
        losses.append(float(loss))
        norms.append(float(norm))
    return {"loss": losses, "grad_norm": norms, "weights": from_jax_variables(jax.tree.map(np.asarray, jt.variables))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny models: one thread each here, as on each rank
    try:
        yield _run(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _run(tmp_path_factory):
    from vpt_tpu_torch.agent.idm import IDMAgent
    from vpt_tpu_torch.checkpoint import save_model_parameters
    from vpt_tpu_torch.training import bc

    tmp = str(tmp_path_factory.mktemp("repairs"))
    ref = {"qat": _qat_reference(tmp)}
    w = torch.randn((8, 12), generator=torch.Generator().manual_seed(3))
    w[1, 0], w[5, 11] = 9.0, -7.0  # rows whose max |w| lies in one half of the input axis
    torch.save(w, os.path.join(tmp, "fq_weight.pt"))

    policy = bc.BCTrainer(dist_cases.POLICY_TINY, dist_cases.PI_KWARGS, device="cpu", seed=0)
    policy.init()
    save_model_parameters(os.path.join(tmp, "policy.model"), dist_cases.POLICY_TINY, dist_cases.PI_KWARGS)
    torch.save(policy.policy.state_dict(), os.path.join(tmp, "policy.weights"))
    idm = IDMAgent(dist_cases.IDM_TINY, {"temperature": 1.0}, device="cpu", seed=1)
    torch.save(idm.policy.state_dict(), os.path.join(tmp, "idm.weights"))
    rng = np.random.default_rng(5)
    obs = rng.integers(0, 256, (2, dist_cases.STREAMS, 64, 96, 3), dtype=np.uint8)
    np.save(os.path.join(tmp, "agent_obs.npy"), obs)
    windows = rng.integers(0, 256, (4, 8, 32, 32, 3), dtype=np.uint8)
    np.save(os.path.join(tmp, "idm_windows.npy"), windows)
    ref["agent"] = _agent_actions(obs)
    ref["idm"] = idm.predict_actions_batched(windows)
    ref["ppo"] = _ppo_update(tmp)

    bc_resume = dist_cases._native_video()
    if bc_resume:  # a B=2 run checkpointed at every step; its first checkpoint kept
        dist_cases._corpus(os.path.join(tmp, "corpus"))
        trainer = bc.BCTrainer(dist_cases.POLICY_TINY, dist_cases.PI_KWARGS, device="cpu",
                               hp=bc.BCHyperparams(**BC_HP, checkpoint_every=1,
                                                   checkpoint_dir=os.path.join(tmp, "bc_all")))
        trainer.train(os.path.join(tmp, "corpus"), os.path.join(tmp, "bc_b2.weights"))
        first = min(os.listdir(os.path.join(tmp, "bc_all")), key=lambda n: int(n[5:]))
        shutil.copytree(os.path.join(tmp, "bc_all", first), os.path.join(tmp, "bc_ckpt", first))
        ref["bc"] = {"saved_step": int(first[5:]), "steps": trainer.step_count}
    outs = run_ranks(2, __file__, "repair_cases", tmp, bc_resume=bc_resume)
    return tmp, ref, outs

# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("ranks", [1, 2])
def test_bc_resumes_at_another_stream_geometry(run, ranks):
    """A checkpoint of a B=2 run resumes at B=1, and at 2 ranks of one
    stream each (rank 1 finds no cursor of its own and takes rank 0's
    counts): the step count goes on from the saved one, the streams start
    afresh from the coarse trajectory cursor, and the run trains to the end."""
    tmp, ref, outs = run
    if "bc" not in ref:
        pytest.skip("the port's native video library cannot be built (libav)")
    saved = ref["bc"]["saved_step"]
    results = [o["bc_resume"] for o in outs] if ranks == 2 else [_bc_resume(tmp, 1)]
    assert "coarse trajectory cursor" in results[0]["printed"]  # rank 1 has no stream cursor to drop
    for got in results:
        assert got["logged"] and got["logged"][0] == saved + 1
        assert got["logged"] == list(range(saved + 1, got["steps"] + 1))
    assert len({tuple(r["logged"]) for r in results}) == 1
    weights = torch.load(os.path.join(tmp, f"bc_resumed_{ranks}.weights"), weights_only=True)
    assert all(torch.isfinite(v).all() for v in weights.values())


@pytest.mark.parametrize("shard", ["colwise", "rowwise"])
def test_fake_quant_of_a_shard_takes_the_whole_weights_scales(run, shard):
    from vpt_tpu_torch.ops.int8 import fake_quant_kernel

    tmp, _, outs = run
    want = fake_quant_kernel(torch.load(os.path.join(tmp, "fq_weight.pt")))
    for out in outs:
        assert torch.equal(out["qat_tp"][shard], want)


def test_qat_bc_steps_on_tp2_equal_vpt_tpu(run):
    _, ref, outs = run
    ours = outs[0]["qat_tp"]
    assert ours["sharded_fake_quant"], "no fake-quantized layer was sharded over tp"
    assert any(".mlp1." in n or "proj" in n for n in ours["sharded_fake_quant"])  # a rowwise one among them
    bc_cases.assert_matches(ours, ref["qat"], steps=QAT_STEPS, what="QAT tp=2")
    np.testing.assert_allclose(outs[1]["qat_tp"]["loss"], ours["loss"], rtol=1e-6)


def test_rl_fine_tune_eval_every_under_torchrun_trains_as_without(run):
    tmp, _, outs = run
    for out in outs:
        assert out["rl_cli"].count("---eval-every ignored on multi-host launches---") == 1
    with_flag = torch.load(os.path.join(tmp, "rl_eval.weights"), weights_only=True)
    without = torch.load(os.path.join(tmp, "rl_plain.weights"), weights_only=True)
    assert with_flag.keys() == without.keys()
    for k in with_flag:
        assert torch.equal(with_flag[k], without[k]), k


@pytest.mark.parametrize("axis", sorted(AGENT_MESHES))
def test_agent_replicates_over(run, axis):
    _, ref, outs = run
    for out in outs:
        got = out["replicas"]["agent"][axis]
        for t, (ours, theirs) in enumerate(zip(got, ref["agent"])):
            assert len(ours) == len(theirs) == dist_cases.STREAMS
            for a, b in zip(ours, theirs):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{axis} step {t} {k}")


@pytest.mark.parametrize("axis", sorted(IDM_MESHES))
def test_idm_agent_replicates_over(run, axis):
    _, ref, outs = run
    for out in outs:
        got = out["replicas"]["idm"][axis]
        assert got.keys() == ref["idm"].keys()
        for k in got:
            np.testing.assert_array_equal(got[k], ref["idm"][k], err_msg=f"{axis} {k}")


def test_ppo_trainer_replicates_over_sp(run):
    _, ref, outs = run
    want = ref["ppo"]
    for out in outs:
        got = out["replicas"]["ppo"]
        assert got["metrics"].keys() == want["metrics"].keys()
        for k in want["metrics"]:
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5, atol=1e-7, err_msg=k)
        for k, v in want["weights"].items():
            assert (got["weights"][k] - v).abs().max().item() <= 1e-6, k
