"""Fully-sharded data parallelism with FSDP2 (counterpart of
vpt_tpu/parallel/fsdp.py).

``fully_shard`` wraps each residual block, the CNN, each head and the root,
so a block's weights are gathered just before it runs and freed after, and
the gradients are reduce-scattered onto their shards.  The batch splits over
dp×fsdp; with dp > 1 the mesh's (dp, fsdp) plane is a hybrid one (HSDP):
parameters shard over fsdp and replicate over dp, and the gradients reduce
over both.  Adam's moments are made like their DTensor parameters, so they
shard with them.

The shard placement follows the JAX package's ``leaf_spec``: a parameter of
at least ``MIN_SHARD_SIZE`` elements shards on its largest dimension that
divides the fsdp size (the dimensions ranked in the JAX layout, where a
dense kernel is (in, out) and a conv kernel (kh, kw, in, out)), and buffers
(the EWMA return stats, image statistics, batch-norm statistics) stay whole.
FSDP2 cannot leave a parameter whole: a small one, or one with no dimension
that divides, shards on its first dimension instead (padded where it does not
divide), which moves the same numbers in more, smaller collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import Shard

from vpt_tpu_torch.parallel.mesh import axis_size

# smaller parameters stay whole in the JAX package: sharding a 64-float norm
# scale saves nothing and adds a collective
MIN_SHARD_SIZE = 4096

# torch dim i of a kernel weight is JAX dim _JAX_DIM[ndim][i]
# (checkpoint/torch_import.py transposes the same way)
_JAX_DIM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def jax_dims(name: str, ndim: int) -> Tuple[int, ...]:
    """For each torch dim of parameter ``name``, its dim in the JAX layout."""
    if name.rsplit(".", 1)[-1] == "weight" and ndim in _JAX_DIM:
        return _JAX_DIM[ndim]
    return tuple(range(ndim))


def shard_dim(name: str, shape: Sequence[int], fsdp: int, taken: Optional[int] = None,
              min_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The torch dim that ``leaf_spec`` shards over fsdp, or None where it
    keeps the parameter whole; ``taken`` is a dim tensor parallelism
    already shards."""
    size = 1
    for s in shape:
        size *= s
    if fsdp <= 1 or size < min_size:
        return None
    jd = jax_dims(name, len(shape))
    for dim in sorted(range(len(shape)), key=lambda d: (-shape[d], jd[d])):
        if dim != taken and shape[dim] % fsdp == 0:
            return dim
    return None


def fsdp_units(model: nn.Module):
    """The modules ``fully_shard`` wraps before the root: each residual
    block, the CNN (with its projection), each head."""
    units = []
    net = model.net
    rl = getattr(net, "recurrent_layer", None)
    if rl is not None:
        units.extend(rl.blocks)
    units.append(net.img_process)
    for name in ("pi_head", "value_head"):
        head = getattr(model, name, None)
        if head is not None:
            units.append(head)
    return units


def apply_fsdp(model: nn.Module, mesh: DeviceMesh, min_size: int = MIN_SHARD_SIZE,
               root: Optional[nn.Module] = None) -> nn.Module:
    """``fully_shard`` the policy or IDM in place over the mesh's fsdp axis
    (its (dp, fsdp) plane when dp > 1); returns the model.  The root
    ``fully_shard`` goes to ``root`` (a module holding the model, whose
    forward is the one called) where given, else to the model."""
    fsdp = axis_size(mesh, "fsdp")
    shard_mesh = mesh["dp", "fsdp"] if axis_size(mesh, "dp") > 1 else mesh["fsdp"]
    names = {id(p): n for n, p in model.named_parameters()}

    def placement(param: nn.Parameter):
        dim = shard_dim(names[id(param)], tuple(param.shape), fsdp, min_size=min_size)
        return Shard(0 if dim is None else dim)

    for unit in fsdp_units(model):
        fully_shard(unit, mesh=shard_mesh, shard_placement_fn=placement)
    fully_shard(model if root is None else root, mesh=shard_mesh, shard_placement_fn=placement)
    # the IDM's embedding enters the CNN through forward_nchw, not its forward
    register_fsdp_forward_method(model.net.img_process, "forward_nchw")
    return model
