"""Sequence parallelism on two gloo ranks on the CPU: each rank embeds its
half of every chunk's frames, the latents are gathered for the blocks, and
each rank's loss covers its own half.

  * an sp=2 BC step equals vpt_tpu's single-device step (the reference of
    tests/test_torch_fsdp_tp.py, the same tolerances);
  * an sp=2 IDM step equals vpt_tpu's, the conv3d front end reaching across
    the halves' edge, and so do dp=2 (each rank stepping its window), fsdp=2
    and tp=2 IDM steps (tests/test_torch_distributed.py's tolerances);
  * sp=2 IDM labels equal the unsharded argmax, bit for bit, and a
    time-sliced embedding equals the whole window's slice within 1e-5 (the
    CPU's convolutions block a batch of fewer frames another way).
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import os

import numpy as np
import pytest
import torch

import test_torch_distributed as dist_cases
import test_torch_fsdp_tp as bc_cases
from test_torch_mesh import run_ranks


@pytest.fixture(autouse=True, scope="module")
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def sp_cases(rank, world, out_dir):
    from vpt_tpu_torch.agent.idm import IDMAgent
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training import idm

    bc = bc_cases.bc_steps(rank, world, out_dir, meshes={"sp": dict(n_sp=2)})["sp"]
    idm_dp = {name: dist_cases._idm_steps(rank, out_dir, shape) for name, shape in IDM_MESHES.items()}
    mesh = pm.make_mesh(n_sp=2)
    data = torch.load(os.path.join(out_dir, "idm_batches.pt"), weights_only=False)
    trainer = idm.IDMTrainer(dist_cases.IDM_TINY, {"temperature": 1.0}, device="cpu", mesh=mesh,
                             hp=idm.IDMHyperparams(batch_size=dist_cases.IDM_B, window=dist_cases.IDM_T,
                                                   learning_rate=dist_cases.LR))
    trainer.load_weights(os.path.join(out_dir, "idm_init.weights"))
    losses, norms = [], []
    for batch in data:
        loss, norm = trainer.train_step(batch)
        losses.append(float(loss))
        norms.append(float(norm))
    agent = IDMAgent(dist_cases.IDM_TINY, {"temperature": 1.0}, device="cpu", mesh=mesh)
    agent.load_weights(os.path.join(out_dir, "idm_init.weights"))
    windows = np.stack([b["frames"] for b in data]).reshape((-1,) + data[0]["frames"].shape[1:])
    labels = agent.predict_actions_batched(windows)
    return {"bc": bc, "idm": {"loss": losses, "grad_norm": norms,
                              "weights": trainer.full_weights() if rank == 0 else None},
            "labels": labels, "rank": pm.axis_rank(mesh, "sp"), "idm_dp": idm_dp}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp"))
    ref = {"bc": bc_cases.shared_reference(tmp_path_factory, tmp), "idm": dist_cases._idm_reference(tmp)}
    return tmp, ref, run_ranks(2, __file__, "sp_cases", tmp)


def test_sp2_bc_step_equals_vpt_tpu(run):
    _, ref, outs = run
    bc_cases.assert_matches(outs[0]["bc"], ref["bc"], what="sp=2")
    np.testing.assert_allclose(outs[1]["bc"]["loss"], outs[0]["bc"]["loss"], rtol=1e-6)


def test_sp2_idm_step_equals_vpt_tpu(run):
    _, ref, outs = run
    ours, theirs = outs[0]["idm"], ref["idm"]
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-5)
    np.testing.assert_allclose(ours["grad_norm"], theirs["grad_norm"], rtol=1e-4)
    dist_cases._weights_close(ours["weights"], theirs["weights"], 3 * dist_cases.LR)


IDM_MESHES = {"dp": dict(n_dp=2), "fsdp": dict(n_fsdp=2), "tp": dict(n_tp=2)}


@pytest.mark.parametrize("mesh", sorted(IDM_MESHES))
def test_two_rank_idm_step_equals_vpt_tpu(run, mesh):
    _, ref, outs = run
    ours, theirs = outs[0]["idm_dp"][mesh], ref["idm"]
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-5)
    np.testing.assert_allclose(ours["grad_norm"], theirs["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(outs[1]["idm_dp"][mesh]["loss"], ours["loss"], rtol=1e-6)
    dist_cases._weights_close(ours["weights"], theirs["weights"], 3 * dist_cases.LR)


def test_sp2_idm_labels_equal_the_unsharded_argmax(run):
    from vpt_tpu_torch.agent.idm import IDMAgent

    tmp, _, outs = run
    agent = IDMAgent(dist_cases.IDM_TINY, {"temperature": 1.0}, device="cpu")
    agent.load_weights(os.path.join(tmp, "idm_init.weights"))
    data = torch.load(os.path.join(tmp, "idm_batches.pt"), weights_only=False)
    windows = np.stack([b["frames"] for b in data]).reshape((-1,) + data[0]["frames"].shape[1:])
    want = agent.predict_actions_batched(windows)
    assert [o["rank"] for o in outs] == [0, 1]
    for out in outs:
        assert out["labels"].keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(out["labels"][k], want[k], err_msg=k)


@pytest.mark.parametrize("lo,hi", [(0, 3), (3, 8), (2, 6), (0, 8)])
def test_time_sliced_embedding_equals_the_windows_slice(lo, hi):
    """The IDM's conv3d front end on a slice of the window, with its kernel's
    reach into the neighbouring frames and the window's zero padding at its
    edges, equals that slice of the whole window's latents."""
    from vpt_tpu_torch.actions.mapping import IDMActionMapping
    from vpt_tpu_torch.config import PolicyConfig
    from vpt_tpu_torch.models.heads import head_specs_from_space
    from vpt_tpu_torch.models.layers import init_parameters
    from vpt_tpu_torch.models.policy import InverseActionPolicy
    from vpt_tpu_torch.spaces import DictType

    specs = head_specs_from_space(DictType(**IDMActionMapping(n_camera_bins=11).get_action_space_update()))
    model = InverseActionPolicy(PolicyConfig.from_kwargs(dict(dist_cases.IDM_TINY)), specs)
    init_parameters(model, torch.Generator().manual_seed(0))
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8))
    with torch.no_grad():
        whole = model.net.embed(frames)
        part = model.embed_time_slice(frames, slice(lo, hi))
    assert part.shape == (2, hi - lo, 64)
    torch.testing.assert_close(part, whole[:, lo:hi], rtol=1e-5, atol=1e-5)
