"""Tensor parallelism with ``torch.distributed.tensor.parallel`` (counterpart
of vpt_tpu/parallel/tp.py).

The plan pairs the layers Megatron-style, so a block needs one all-reduce in
its attention and one in its MLP:

  * attention q/k/v and the relative-bias coefficients ``r_layer``: output
    (head) dim over tp; ``proj_layer``: input dim over tp.  Each rank keeps
    H/tp whole heads, so kernels B1 and B2 get that rank's heads as plain
    contiguous tensors: its q, k, v, its R, and the whole b_nd band table.
    The JAX package has no rule for ``r_layer`` (XLA reshards R for the
    attention); here R must split by heads too, or B1 would get H heads of R
    against H/tp heads of q, k and v;
  * pointwise MLP: ``mlp0`` output dim over tp, ``mlp1`` input dim over tp;
  * the action heads' ``linear_layer``: output dim over tp, the logits
    gathered whole;
  * everything else (convolutions, norms outside the planned layers, the
    value head, ``b_nd``) stays a plain, whole tensor on every rank.

A layer is planned only where its sharded dim divides the tp size (and, in
the attention, where the heads do), as in the JAX package.  The planned
layers' other parameters (the LayerNorm inside ``mlp0``) become replicated
DTensors; their biases follow the output (sharded colwise, replicated
rowwise), where the JAX package replicates a colwise bias: the same numbers.

Under tp each attention layer's ``heads`` is its local count, and the
recurrent state a trainer carries holds the rank's heads only
(:func:`local_state`).  Mixed plain and DTensor gradients take the mesh's
``clip_grad_norm_`` (parallel/mesh.py).  QAT's fake-quantized layers shard
as the float ones, their per-row scales those of the whole weight
(ops/int8.py ``fake_quant_kernel``); int8 serving layers do not shard (the
agents replicate over tp).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module
from torch.distributed.tensor.parallel.style import distribute_module

from vpt_tpu_torch.models.heads import CategoricalActionHead, DiagGaussianActionHead
from vpt_tpu_torch.models.layers import FanInInitLayer, NormedLinear
from vpt_tpu_torch.models.transformer import SelfAttentionLayer
from vpt_tpu_torch.parallel.mesh import axis_rank, axis_size

# module-name suffix → (style, torch dim of the weight it shards)
COLWISE, ROWWISE, GATHERED = "colwise", "rowwise", "colwise_gathered"
_RULES = (
    ("q_layer", COLWISE, 0),
    ("k_layer", COLWISE, 0),
    ("v_layer", COLWISE, 0),
    ("r_layer", COLWISE, 0),
    ("proj_layer", ROWWISE, 1),
    ("mlp0", COLWISE, 0),
    ("mlp1", ROWWISE, 1),
    ("linear_layer", GATHERED, 0),
)
_DENSE = ("weight", "bias", "layer.weight", "layer.bias", "linear_layer.weight", "linear_layer.bias")


def _rule(module_name: str):
    for suffix, style, dim in _RULES:
        if module_name == suffix or module_name.endswith("." + suffix):
            return style, dim
    return None


def tp_shard_dim(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The torch dim of weight ``name`` the plan shards over tp, or None.
    Names the planned layer's dense weight (``...q_layer.weight``,
    ``...mlp0.layer.weight``, ``...linear_layer.weight``)."""
    if tp <= 1 or not name.endswith(".weight"):
        return None
    owner = name[:-len(".layer.weight")] if name.endswith(".layer.weight") else name[:-len(".weight")]
    rule = _rule(owner)
    if rule is None:
        return None
    return rule[1] if shape[rule[1]] % tp == 0 else None


class _DenseStyle:
    """A Colwise/RowwiseParallel for the port's dense layers (``NormedLinear``,
    ``FanInInitLayer``, an action head), which are no ``nn.Linear``: the
    dense weight and bias take the style's placements, every other parameter
    of the layer is replicated."""

    weight_placement = Shard(0)
    bias_placement = Shard(0)

    def _partition(self, name, module, device_mesh):
        if name:  # the styled layer's own call covers its submodules
            return
        for pname, param in list(module.named_parameters()):
            if pname in _DENSE:
                placement = self.weight_placement if pname.endswith("weight") else self.bias_placement
            else:
                placement = Replicate()
            owner_name, _, leaf = pname.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name else module
            owner.register_parameter(leaf, nn.Parameter(
                distribute_tensor(param, device_mesh, [placement], src_data_rank=None),
                requires_grad=param.requires_grad))

    def _apply(self, module: nn.Module, device_mesh: DeviceMesh) -> nn.Module:
        return distribute_module(
            module, device_mesh, self._partition,
            lambda mod, inputs, mesh: self._prepare_input_fn(
                self.input_layouts, self.desired_input_layouts, mod, inputs, mesh),
            lambda mod, outputs, mesh: self._prepare_output_fn(
                self.output_layouts, self.use_local_output, mod, outputs, mesh))


class DenseColwise(_DenseStyle, ColwiseParallel):
    pass


class DenseRowwise(_DenseStyle, RowwiseParallel):
    weight_placement = Shard(1)
    bias_placement = Replicate()

    def __init__(self):
        super().__init__()
        self.desired_input_layouts = (Shard(-1),)


def _styled(module: nn.Module) -> bool:
    if isinstance(module, (NormedLinear, CategoricalActionHead, DiagGaussianActionHead)):
        return True
    return isinstance(module, FanInInitLayer) and module.layer_type == "linear"


def tp_plan(model: nn.Module, tp: int) -> Dict[str, object]:
    """{module name: style} of the layers that shard over ``tp``."""
    plan: Dict[str, object] = {}
    heads_ok = {}
    for name, module in model.named_modules():
        if isinstance(module, SelfAttentionLayer):
            heads_ok[name] = module.heads % tp == 0
    for name, module in model.named_modules():
        rule = _rule(name)
        if rule is None or not _styled(module):
            continue
        style, dim = rule
        if name.endswith("linear_layer"):  # the head owns its linear_layer: style the head
            name = name.rsplit(".", 1)[0]
            module = model.get_submodule(name)
            weight = module.linear_layer.weight
        else:
            weight = module.weight if isinstance(module, NormedLinear) else module.layer.weight
        parent = name.rsplit(".", 1)[0]
        if parent in heads_ok and not heads_ok[parent]:
            continue
        if weight.shape[dim] % tp:
            continue
        if getattr(module, "quantize", False):  # int8 serving: the agents replicate over tp instead
            raise NotImplementedError(f"{name}: int8 serving layers do not shard over tp")
        if style == ROWWISE:
            plan[name] = DenseRowwise()
        elif style == GATHERED:
            plan[name] = DenseColwise(output_layouts=Replicate())
        else:
            plan[name] = DenseColwise()
    return plan


def apply_tp(model: nn.Module, tp_mesh: DeviceMesh) -> nn.Module:
    """Shard ``model`` in place by :func:`tp_plan` over the 1-D ``tp_mesh``;
    each sharded attention layer's ``heads`` becomes its local count."""
    tp = tp_mesh.size()
    plan = tp_plan(model, tp)
    for name, module in model.named_modules():
        if isinstance(module, SelfAttentionLayer) and f"{name}.q_layer" in plan:
            module.heads //= tp
    parallelize_module(model, tp_mesh, plan)
    return model


def local_state(state: Optional[List[Dict]], mesh: Optional[DeviceMesh], heads: int):
    """A whole recurrent state → this rank's heads of it on ``mesh``'s tp
    axis: the linear cache's (B, maxlen, E) k/v keep the E/tp columns of the
    rank's heads, the ring cache's (B, H, maxlen, d) its H/tp heads; masks,
    the ring index and LSTM carries stay whole.  As it is where tp is 1 or
    does not divide the heads (the attention then stays whole)."""
    tp = axis_size(mesh, "tp")
    if state is None or tp <= 1 or heads % tp:
        return state
    tp_rank = axis_rank(mesh, "tp")
    out = []
    for blk in state:
        blk = dict(blk)
        if "k" in blk:
            dim = 1 if "idx" in blk else 2
            for key in ("k", "v"):
                blk[key] = blk[key].chunk(tp, dim=dim)[tp_rank].contiguous()
        out.append(blk)
    return out
