"""A trainer's model on a mesh: the wrappers applied in order, the sequence-
parallel forward, and the gradient reduction over the data axes.

``ParallelModel(model, mesh, unused=...)``:

  * tp > 1: the tensor-parallel plan (parallel/tp.py);
  * fsdp > 1: FSDP2 over the (dp, fsdp) plane (parallel/fsdp.py), which
    reduces the gradients over dp and fsdp itself;
  * otherwise DDP over the (dp, sp) ranks, at any size (one rank included),
    unless tp shards the parameters, since DDP takes no DTensor parameters.
    DDP ignores the parameters in ``unused``, which the loss never reaches
    (BC's value head, the IDM's discarded ``lastlayer``): they get no
    gradient on any rank, so there is nothing to reduce.

What no wrapper reduces, :meth:`ParallelModel.sync_grads` averages by hand
after the backward: over (dp, sp) under tp without fsdp, over sp under
fsdp.

Sequence parallelism (``SequenceParallelForward``): each sp rank embeds its
T/sp frames, which is the FLOPs bulk (the CNN; the IDM's conv3d takes the
frames its kernel reaches across the slice's edges); the latents are
gathered over sp by ``_GatherTime``, whose backward sums each slice's
gradient from every rank (an all-reduce, then the rank's slice: the
``all_gather`` of ``torch.distributed.nn.functional`` scatters from global
rank numbers in its gloo backward, which fails on any sp group that does
not hold rank 0); the blocks run on the whole T from the same
state, and the heads on the rank's own slice, which is all its loss covers.
With each rank's loss a mean over its own B/(dp·fsdp) rows and T/sp steps,
averaging over (dp, sp) gives the gradient of the global mean: the sum over
sp of the slices' terms, the average over dp of the rows'.

The exchange is of the latents, before the blocks, so it stays on the sp
group whatever shards the parameters.  Under tp each rank then runs its
heads of every block on the whole T: B1 and B2 get the rank's heads of q,
k, v and R, as under tp alone.  Under fsdp the FSDP2 root is the
sequence-parallel forward (it enters the model through ``embed_time_slice``,
``recurrent`` and ``heads_from_recurrent``, not its ``forward``), so the
root's parameters are gathered for the whole call.

Nothing gives way quietly: a wrapper that fails to apply raises, and a pp
mesh raises (it trains through training/pp_bc.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.nn.parallel import DistributedDataParallel

from vpt_tpu_torch.parallel.fsdp import apply_fsdp
from vpt_tpu_torch.parallel.mesh import axis_size, group, local_time
from vpt_tpu_torch.parallel.tp import apply_tp


class _GatherTime(torch.autograd.Function):
    """The group's (B, t, E) slices concatenated on the time axis in rank
    order; the backward sums the whole gradient over the group and keeps
    this rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.steps = group, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        start = dist.get_rank(ctx.group) * ctx.steps
        return grad[:, start:start + ctx.steps], None


class SequenceParallelForward(nn.Module):
    """``model(frames, firsts, state)`` with the time axis split over the
    mesh's sp ranks; returns (the heads' outputs on this rank's time slice,
    the state after the whole chunk).  At sp = 1, or without ``split`` (the
    sp ranks then replicas), it is the model's own forward, over the whole
    chunk."""

    def __init__(self, model: nn.Module, mesh: Optional[DeviceMesh], split: bool = True):
        super().__init__()
        self.model = model
        self.mesh = mesh
        self.sp = axis_size(mesh, "sp") if split else 1
        self.group = group(mesh, ("sp",)) if self.sp > 1 else None

    def time_slice(self, steps: int) -> slice:
        return local_time(self.mesh, steps) if self.sp > 1 else slice(0, steps)

    def forward(self, frames: torch.Tensor, firsts: torch.Tensor, state):
        if self.sp == 1:
            return self.model(frames, firsts, state)
        sl = self.time_slice(frames.shape[1])
        x = _GatherTime.apply(self.model.embed_time_slice(frames, sl), self.group)
        x, state_out = self.model.recurrent(x, firsts, state)
        return self.model.heads_from_recurrent(x[:, sl]), state_out


def shard_model(model: nn.Module, mesh: DeviceMesh, root: Optional[nn.Module] = None) -> nn.Module:
    """The mesh's parameter sharding alone, in place (the tensor-parallel
    plan where tp > 1, then FSDP2 where fsdp > 1, its root ``root`` or the
    model): for a model that is run but not trained, such as PPO's frozen
    anchor, and for the trained one."""
    if axis_size(mesh, "tp") > 1:
        apply_tp(model, mesh["tp"])
    if axis_size(mesh, "fsdp") > 1:
        apply_fsdp(model, mesh, root=root)
    return model


class ParallelModel:
    """``model`` (a MinecraftAgentPolicy or an InverseActionPolicy, on its
    device, every rank holding the same weights) wrapped for training on
    ``mesh``; the wrappers change ``model`` in place, so its parameters
    (DTensors where sharded) are what the optimizer takes afterwards.
    Calling it runs the forward of :class:`SequenceParallelForward`; without
    ``sequence_parallel`` the sp ranks run the whole chunk as replicas (their
    gradients, equal, still averaged over sp, which keeps them equal)."""

    def __init__(self, model: nn.Module, mesh: DeviceMesh, unused: Sequence[str] = (),
                 sequence_parallel: bool = True):
        self.mesh = mesh
        self.model = model
        sp, tp, fsdp = axis_size(mesh, "sp"), axis_size(mesh, "tp"), axis_size(mesh, "fsdp")
        if axis_size(mesh, "pp") > 1:
            raise NotImplementedError("a pp mesh trains through training/pp_bc.py's PPBCTrainer")
        self.forward_module = SequenceParallelForward(model, mesh, split=sequence_parallel)
        shard_model(model, mesh, root=self.forward_module if self.forward_module.sp > 1 else None)
        self._sync_group = None
        self._call = self.forward_module
        if fsdp > 1:  # FSDP2 reduces over (dp, fsdp); sp is left
            if sp > 1:
                self._sync_group = group(mesh, ("sp",))
        elif tp > 1:  # DDP takes no DTensors
            if axis_size(mesh, "dp") * sp > 1:
                self._sync_group = group(mesh, ("dp", "sp"))
        else:
            ignored = [f"model.{n}" for n, _ in model.named_parameters() if n.startswith(tuple(unused))]
            DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(self.forward_module, ignored)
            device = next(model.parameters()).device
            self._call = DistributedDataParallel(
                self.forward_module, process_group=group(mesh, ("dp", "sp")),
                device_ids=[device.index] if device.type == "cuda" else None, broadcast_buffers=False)

    def __call__(self, frames, firsts, state):
        return self._call(frames, firsts, state)

    def time_slice(self, steps: int) -> slice:
        return self.forward_module.time_slice(steps)

    def sync_grads(self) -> None:
        """Average the gradients over the axes no wrapper reduces ((dp, sp)
        under tp without fsdp, sp under fsdp); a no-op otherwise."""
        if self._sync_group is None:
            return
        n = dist.get_world_size(self._sync_group)
        for p in self.model.parameters():
            if p.grad is not None:
                g = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
                dist.all_reduce(g, group=self._sync_group)
                g.div_(n)
