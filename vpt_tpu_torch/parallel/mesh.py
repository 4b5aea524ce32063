"""Process groups, the device mesh and the rows each rank owns (counterpart
of vpt_tpu/parallel/mesh.py).

The JAX package runs one process over many devices and names every axis in
PartitionSpecs that XLA partitions.  The port runs one process a device
(``torchrun``), so the same five axes become a ``DeviceMesh`` over ranks,
and what SPMD inserted becomes explicit: DDP, FSDP2 and tensor parallelism
wrap the model (parallel/fsdp.py, parallel/tp.py, parallel/model.py), each
rank loads only its own rows, and the collectives below gather them back.

Axes, outermost first, as in the JAX package: ``pp`` (pipeline stages,
parallel/pp.py), ``dp`` (data parallel), ``fsdp`` (data parallel with
sharded parameters), ``sp`` (time slices of a chunk), ``tp`` (tensor
parallel).  The global batch's rows split over dp×fsdp; the ranks of one
(dp, fsdp) coordinate hold the same rows, and under sp each embeds its own
time slice.

The backend follows the device the caller asked for: NCCL for CUDA, gloo
for the CPU.  Whether a GPU happens to be present never decides it, and a
CUDA run whose NCCL group fails to start fails.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor

AXES = ("pp", "dp", "fsdp", "sp", "tp")
DATA_AXES = ("dp", "fsdp")
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(device=None) -> bool:
    """Start the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); a no-op
    returning False without it, True where a group exists after the call.

    ``device`` is the device the run asked for (None means CUDA): NCCL on
    ``cuda:LOCAL_RANK`` for CUDA, gloo for the CPU."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA run needs a CUDA device for its NCCL group; pass device='cpu' for gloo")
        local = torch.device("cuda", local_rank())
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method="env://", rank=rank, world_size=world, device_id=local)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world)
    else:
        raise ValueError(f"no process group backend for device {dev}")
    return True


def cli_mesh(device=None, fsdp: int = 1, sp: int = 1, tp: int = 1) -> Optional[DeviceMesh]:
    """The mesh a command-line entry point trains on: under torchrun, the
    (dp, fsdp, sp, tp) mesh over every rank, dp what the others leave; None
    for a single process, which takes no ``fsdp``, ``sp`` or ``tp``."""
    if maybe_initialize_distributed(device):
        return make_mesh(n_fsdp=fsdp, n_sp=sp, n_tp=tp)
    if fsdp * sp * tp > 1:
        raise ValueError("--fsdp, --sp and --tp need a process group: launch with torchrun --nproc_per_node=N")
    return None


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(n_dp: Optional[int] = None, n_tp: int = 1, n_fsdp: int = 1, n_sp: int = 1, n_pp: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """The (pp, dp, fsdp, sp, tp) mesh over every rank of the default group;
    ``n_dp`` defaults to what the other axes leave.  ``device_type`` follows
    the group's backend unless given."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run under torchrun and call "
                           "maybe_initialize_distributed(), or init_process_group first")
    world = dist.get_world_size()
    rest = n_tp * n_fsdp * n_sp * n_pp
    if n_dp is None:
        n_dp = world // rest
    if n_pp * n_dp * n_fsdp * n_sp * n_tp != world:
        raise ValueError(f"mesh pp={n_pp} dp={n_dp} fsdp={n_fsdp} sp={n_sp} tp={n_tp} does not cover "
                         f"the world of {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_pp, n_dp, n_fsdp, n_sp, n_tp), mesh_dim_names=AXES)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    if mesh is None:
        return 1
    return mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def data_shard(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """(this rank's index, count) of the dp×fsdp row shards."""
    return (axis_rank(mesh, "dp") * axis_size(mesh, "fsdp") + axis_rank(mesh, "fsdp"),
            axis_size(mesh, "dp") * axis_size(mesh, "fsdp"))


def _even_slice(n: int, index: int, count: int, what: str) -> slice:
    if n % count:
        raise ValueError(f"{what} {n} must divide over {count} ranks")
    k = n // count
    return slice(index * k, (index + 1) * k)


def local_rows(mesh: Optional[DeviceMesh], global_rows: int) -> slice:
    """The rows of a global batch this rank owns: its dp×fsdp shard."""
    index, count = data_shard(mesh)
    return _even_slice(global_rows, index, count, "global batch")


def local_time(mesh: Optional[DeviceMesh], steps: int) -> slice:
    """The time steps of a chunk this rank embeds and scores under sp."""
    return _even_slice(steps, axis_rank(mesh, "sp"), axis_size(mesh, "sp"), "chunk length")


def local_batch(mesh: Optional[DeviceMesh], batch: Dict) -> Dict:
    """A host batch of the global rows → this rank's rows (every entry with
    a leading batch axis; other entries pass through)."""
    rows = None
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) >= 1:
            rows = rows or local_rows(mesh, v.shape[0])
            out[k] = v[rows]
        else:
            out[k] = v
    return out


_GROUPS: Dict[Tuple[DeviceMesh, Tuple[str, ...]], dist.ProcessGroup] = {}


def group(mesh: DeviceMesh, axes: Sequence[str]) -> dist.ProcessGroup:
    """The process group spanning ``axes`` of the mesh (one axis, or several
    flattened into one)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (mesh, axes)  # meshes of the same ranks and axes compare equal, and share the group
    if key not in _GROUPS:
        _GROUPS[key] = mesh[axes]._flatten("_".join(axes)).get_group()
    return _GROUPS[key]


def all_gather_cat(x: torch.Tensor, pg: dist.ProcessGroup, dim: int = 0) -> torch.Tensor:
    """The group's tensors of equal shape concatenated along ``dim`` in rank order."""
    if dist.get_world_size(pg) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(parts, x.contiguous(), group=pg)
    return torch.cat(parts, dim=dim)


def gather_rows(mesh: Optional[DeviceMesh], x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`local_rows`: every data shard's rows, in global order."""
    if mesh is None:
        return x
    return all_gather_cat(x, group(mesh, DATA_AXES))


def all_mean(x: torch.Tensor, pg: dist.ProcessGroup) -> torch.Tensor:
    """The group's mean of ``x`` (a sum then a division: gloo has no average)."""
    n = dist.get_world_size(pg)
    if n == 1:
        return x.detach()
    y = x.detach().clone()
    dist.all_reduce(y, group=pg)
    return y / n


def any_rank(flags: Sequence[bool], device) -> List[bool]:
    """Each flag OR-ed over every rank of the default group (one small
    all-reduce on ``device``); the flags as they are without a group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [bool(f) for f in flags]
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def barrier() -> None:
    """Every rank of the default group meets here; a no-op without one."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ----------------------------------------------------------- full state pulls


def full_tensor(x):
    """A DTensor's whole value (a collective: every rank of its mesh calls
    it); anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def full_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state_dict with every sharded entry gathered whole, as
    CPU tensors of their own (copies, never the module's storage).  A
    collective under FSDP2 or tensor parallelism: every rank calls it, in
    the same order, and the caller gates only the file write on the rank."""
    return {k: full_tensor(v).detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


def _placed_like(ref: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` (whole) laid out as ``ref``: distributed from this rank's own
    copy where ``ref`` is a DTensor (every rank holds the same whole value,
    so nothing is sent)."""
    value = value.to(ref.device, ref.dtype)
    if isinstance(ref, DTensor):
        return distribute_tensor(value, ref.device_mesh, ref.placements, src_data_rank=None)
    return value


def load_weights_whole(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> Dict[str, list]:
    """``checkpoint.load_state_dict_report`` (non-strict, shape mismatches
    skipped) on a module whose parameters may be sharded: the file merges
    into the whole state_dict, which is then laid out as the module's.  A
    collective: every rank loads the same file."""
    from vpt_tpu_torch.checkpoint import load_state_dict_report

    holder = _WholeState(full_state_dict(module))
    report = load_state_dict_report(holder, state_dict)
    load_full_state_dict(module, holder.values)
    return report


class _WholeState(torch.nn.Module):
    """A module whose state_dict is ``values``, for ``load_state_dict_report``."""

    def __init__(self, values: Dict[str, torch.Tensor]):
        super().__init__()
        self.values = values

    def state_dict(self, *args, **kwargs):
        return self.values

    def load_state_dict(self, state_dict, strict=True, assign=False):
        missing = [k for k in self.values if k not in state_dict]
        unexpected = [k for k in state_dict if k not in self.values]
        self.values.update((k, v) for k, v in state_dict.items() if k in self.values)
        return torch.nn.modules.module._IncompatibleKeys(missing, unexpected)


def load_full_state_dict(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor], strict: bool = True):
    """Load a whole (unsharded) state_dict into a module that may hold
    sharded parameters; every rank passes the same values."""
    own = module.state_dict()
    placed = {k: _placed_like(own[k], v) if k in own else v for k, v in state_dict.items()}
    return module.load_state_dict(placed, strict=strict)


def full_optimizer_state(optimizer: torch.optim.Optimizer, params: Sequence[torch.nn.Parameter]) -> Dict:
    """``optimizer.state_dict()`` in the single-device layout, whatever the
    mesh: one group over ``params`` in their order, however the optimizer
    groups them at run time (tensor parallelism puts plain and DTensor
    parameters in a group each), and every moment a whole copy on the host
    (a collective where it is sharded)."""
    def host(v):
        return full_tensor(v).detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v

    sd = optimizer.state_dict()
    held = [p for g in optimizer.param_groups for p in g["params"]]
    order = {id(p): i for i, p in enumerate(params)}
    state = {order[id(held[int(i)])]: {k: host(v) for k, v in s.items()} for i, s in sd["state"].items()}
    group = {k: v for k, v in sd["param_groups"][0].items() if k != "params"}
    return {"state": dict(sorted(state.items())), "param_groups": [{**group, "params": list(range(len(params)))}]}


def load_full_optimizer_state(optimizer: torch.optim.Optimizer, params: Sequence[torch.nn.Parameter],
                              sd: Dict) -> None:
    """Load a state of :func:`full_optimizer_state`'s layout (one group over
    ``params``) into an optimizer that may group them otherwise and hold
    them sharded: each moment is laid out as its parameter."""
    held = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    (group,) = sd["param_groups"]
    if len(group["params"]) != len(params):
        raise ValueError(f"the optimizer state holds {len(group['params'])} parameters, the trainer {len(params)}")
    state = {}
    for i, s in sd["state"].items():
        p = params[int(i)]
        state[held[id(p)]] = {k: _placed_like(p, v) if k != "step" and isinstance(v, torch.Tensor)
                              and tuple(v.shape) == tuple(p.shape) else v
                              for k, v in s.items()}
    hyper = {k: v for k, v in group.items() if k != "params"}
    groups, start = [], 0
    for g in optimizer.param_groups:
        groups.append({**hyper, "params": list(range(start, start + len(g["params"])))})
        start += len(g["params"])
    optimizer.load_state_dict({"state": state, "param_groups": groups})


# ------------------------------------------------------------ gradient norm


def clip_grad_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` over parameters that may be
    DTensors, on any mix of meshes and plain tensors; returns the norm of
    all the gradients together before the clip, as a plain tensor.

    Plain gradients alone take torch's own call unchanged.  Otherwise each
    gradient's norm is taken as torch takes it (``_foreach_norm`` on the
    tensor, here its local part), a DTensor sharded over more than one rank
    reducing its norm whole over its mesh, and the norms of all of them
    together are torch's; on one rank the result is torch's, bit for bit.
    The clip scales every local part."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if not any(isinstance(g, DTensor) for g in grads):
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    local = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
    norms = list(torch._foreach_norm(local))
    for i, g in enumerate(grads):
        if isinstance(g, DTensor) and g.device_mesh.size() > 1:
            norms[i] = full_tensor(torch.linalg.vector_norm(g))
    total = torch.linalg.vector_norm(torch.stack(norms))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    torch._foreach_mul_(local, coef)
    return total
