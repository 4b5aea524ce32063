"""The port's process groups and mesh (vpt_tpu_torch/parallel/mesh.py), and
the harness the multi-rank tests share: ``run_ranks`` starts N gloo ranks of
a function on the CPU, each a process of one thread forked from a clean
forkserver (never from this process, which holds JAX), meeting through a
``FileStore`` under the test's temporary directory (never a fixed port:
several test workers run at once), and joins them under a deadline of its
own, killing them all and failing on expiry.

Held here:
  * the mesh's axis order ("pp", "dp", "fsdp", "sp", "tp") and shapes, and
    the rows and time slice each of 4 ranks owns; rows gathered back;
  * a mean and an OR over ranks; a whole state pulled from a DTensor;
  * on the same 4 ranks, the composed meshes dp=2 x fsdp=2 (FSDP2's hybrid
    sharding), dp=2 x tp=2 (the gradients averaged over dp by hand, since
    DDP takes no DTensors) and fsdp=2 x tp=2 (FSDP2 over the tensor-parallel
    DTensors): their BC steps equal vpt_tpu's single-device steps
    (tests/test_torch_fsdp_tp.py's reference and tolerances);
  * ``maybe_initialize_distributed`` is a no-op without torchrun's
    environment, and ``resolve_device`` gives ``cuda:LOCAL_RANK`` to a rank.
"""

import importlib.util
import multiprocessing
import os
import time
import traceback

import pytest
import torch

DEADLINE = 150.0  # seconds a launch may take before its ranks are killed


@pytest.fixture(autouse=True, scope="module")
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


# what a rank imports, loaded once into the forkserver that forks every rank
PRELOAD = ["torch", "torch.distributed", "numpy", "vpt_tpu_torch.training.bc", "vpt_tpu_torch.training.idm",
           "vpt_tpu_torch.training.rl", "vpt_tpu_torch.agent.agent", "vpt_tpu_torch.parallel.model"]


def _context():
    """The forkserver context: a clean process (no JAX, no threads) that has
    imported ``PRELOAD`` forks each rank, so a rank starts in a fraction of a
    second instead of importing torch anew."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)  # no effect once the server runs
    return ctx


def run_ranks(world: int, module_file: str, fn: str, tmp_path, deadline: float = DEADLINE, **kwargs):
    """Run ``fn(rank, world, out_dir, **kwargs)`` of the module at
    ``module_file`` on ``world`` gloo ranks; returns each rank's return value
    (a picklable tree of tensors, arrays and numbers), rank 0 first."""
    tmp_path = str(tmp_path)
    store = os.path.join(tmp_path, f"store_{fn}_{world}")
    ctx = _context()
    procs = [ctx.Process(target=_rank_main, args=(module_file, fn, r, world, store, tmp_path, kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > end or any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        timed_out = any(p.is_alive() for p in procs)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if timed_out or failed:
        text = "\n".join(f"--- rank {r}\n" + _read(os.path.join(tmp_path, f"{fn}_{world}_rank{r}.log"))[-4000:]
                         for r in range(world))
        pytest.fail(f"{fn} on {world} ranks: {'deadline passed' if timed_out else f'ranks {failed} failed'}\n{text}")
    return [torch.load(os.path.join(tmp_path, f"{fn}_{world}_out{r}.pt"), weights_only=False) for r in range(world)]


def _read(path):
    return open(path).read() if os.path.exists(path) else "(no log)"


def _rank_main(module_file, fn, rank, world, store, out_dir, kwargs):
    """One rank: its group through the FileStore, ``fn`` of the module at
    ``module_file``, its result saved; a traceback goes to its log."""
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
        spec = importlib.util.spec_from_file_location(f"_rank_module_{fn}", module_file)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        result = getattr(module, fn)(rank, world, out_dir, **kwargs)
        torch.save(result, os.path.join(out_dir, f"{fn}_{world}_out{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{fn}_{world}_rank{rank}.log"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ------------------------------------------------------------------ rank side


def mesh_facts(rank, world, out_dir):
    import test_torch_fsdp_tp as bc_cases
    from torch.distributed.tensor import Shard, distribute_tensor

    from vpt_tpu_torch.parallel import mesh as pm

    out = {}
    for name, shape in (("dp", dict(n_dp=4)), ("dp_sp", dict(n_dp=2, n_sp=2)), ("fsdp_tp", dict(n_fsdp=2, n_tp=2)),
                        ("pp_dp", dict(n_pp=2, n_dp=2))):
        mesh = pm.make_mesh(**shape)
        out[name] = {
            "names": mesh.mesh_dim_names,
            "shape": tuple(mesh.mesh.shape),
            "sizes": [pm.axis_size(mesh, a) for a in pm.AXES],
            "ranks": [pm.axis_rank(mesh, a) for a in pm.AXES],
            "rows": pm.local_rows(mesh, 8),
            "time": pm.local_time(mesh, 6) if pm.axis_size(mesh, "sp") > 1 else None,
            "gathered": pm.gather_rows(mesh, torch.arange(8.0)[pm.local_rows(mesh, 8)]),
        }
    mesh = pm.make_mesh(n_dp=4)
    out["mean"] = pm.all_mean(torch.tensor(float(rank)), pm.group(mesh, ("dp",)))
    out["any"] = pm.any_rank([rank == 2, False], "cpu")
    full = torch.arange(24.0).reshape(6, 4)
    out["full"] = pm.full_tensor(distribute_tensor(full, mesh["dp"], [Shard(1)], src_data_rank=None))
    out.update(bc_cases.bc_steps(rank, world, out_dir, meshes=COMPOSED))
    return out


# ------------------------------------------------------------------ tests


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    import test_torch_fsdp_tp as bc_cases

    tmp = tmp_path_factory.mktemp("mesh")
    ref = bc_cases.shared_reference(tmp_path_factory, tmp)
    return ref, run_ranks(4, __file__, "mesh_facts", tmp)


COMPOSED = {"dp2_fsdp2": dict(n_dp=2, n_fsdp=2), "dp2_tp2": dict(n_dp=2, n_tp=2), "fsdp2_tp2": dict(n_fsdp=2, n_tp=2)}


@pytest.mark.parametrize("mesh", sorted(COMPOSED))
def test_composed_mesh_on_four_ranks_equals_vpt_tpu(four_ranks, mesh):
    import test_torch_fsdp_tp as bc_cases

    ref, outs = four_ranks
    bc_cases.assert_matches(outs[0][mesh], ref, what=mesh)
    assert len(outs[0][mesh]["sharded"]) > 0
    for out in outs[1:]:
        assert out[mesh]["loss"] == outs[0][mesh]["loss"] and out[mesh]["grad_norm"] == outs[0][mesh]["grad_norm"]


def test_mesh_axes_rows_and_collectives(four_ranks):
    _, outs = four_ranks
    for r, out in enumerate(outs):
        assert out["dp"]["names"] == ("pp", "dp", "fsdp", "sp", "tp")
        assert out["dp"]["shape"] == (1, 4, 1, 1, 1) and out["dp"]["rows"] == slice(2 * r, 2 * r + 2)
        # (dp, sp) = (r // 2, r % 2): rows by dp, time by sp
        assert out["dp_sp"]["sizes"] == [1, 2, 1, 2, 1] and out["dp_sp"]["ranks"] == [0, r // 2, 0, r % 2, 0]
        assert out["dp_sp"]["rows"] == slice(4 * (r // 2), 4 * (r // 2) + 4)
        assert out["dp_sp"]["time"] == slice(3 * (r % 2), 3 * (r % 2) + 3)
        # (fsdp, tp): rows by fsdp only, the tp pair holds the same rows
        assert out["fsdp_tp"]["ranks"] == [0, 0, r // 2, 0, r % 2]
        assert out["fsdp_tp"]["rows"] == slice(4 * (r // 2), 4 * (r // 2) + 4)
        assert out["pp_dp"]["ranks"] == [r // 2, r % 2, 0, 0, 0] and out["pp_dp"]["shape"] == (2, 2, 1, 1, 1)
        for name in ("dp", "dp_sp", "fsdp_tp", "pp_dp"):
            assert torch.equal(out[name]["gathered"], torch.arange(8.0)), name
        assert float(out["mean"]) == 1.5
        assert out["any"] == [True, False]
        assert torch.equal(out["full"], torch.arange(24.0).reshape(6, 4))


def test_no_torchrun_env_is_a_no_op(monkeypatch):
    from vpt_tpu_torch.parallel import mesh as pm

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert pm.maybe_initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert pm.rank() == 0
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh(n_dp=1)
    assert pm.local_rows(None, 5) == slice(0, 5) and pm.local_time(None, 7) == slice(0, 7)
    assert pm.any_rank([True, False], "cpu") == [True, False]


def test_resolve_device_gives_each_rank_its_card(monkeypatch):
    from vpt_tpu_torch import device as device_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device_mod.resolve_device(None) == torch.device("cuda")  # no group: the current card
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert device_mod.resolve_device(None) == torch.device("cuda", 3)
    assert device_mod.resolve_device("cuda") == torch.device("cuda", 3)
    assert device_mod.resolve_device("cuda:1") == torch.device("cuda", 1)  # an explicit card stays
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_cuda_group_needs_cuda(monkeypatch):
    """NCCL for CUDA: without a card the group does not start, and gloo is
    never taken instead."""
    from vpt_tpu_torch.parallel import mesh as pm

    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        pm.maybe_initialize_distributed(None)
    assert not torch.distributed.is_initialized()
