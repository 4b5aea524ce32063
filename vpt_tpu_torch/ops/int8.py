"""Int8 dense serving and quantization-aware training (counterpart of
vpt_tpu/ops/int8.py).

  * weights: symmetric per-output-channel int8, derived once from the float
    weights (``quantize_state_dict``); the float checkpoint keeps its layout;
  * activations: symmetric per-row int8, quantized inside the layer;
  * the product accumulates in int32 and is dequantized by
    (row scale × channel scale), in that order.

Torch keeps a dense weight as (out, in), so the per-output-channel scale is
one per ROW of the weight (the JAX package reduces its (in, out) kernel over
every axis but the last).  ``QuantLinear`` takes the float layer's place at
the same module path: ``weight_q8`` (int8, out × in) and ``weight_scale``
(float32, out) are buffers, ``bias`` is a parameter where the float layer
keeps it, so a quantized state_dict is derived from a float one by name
alone (``weight`` → ``weight_q8`` + ``weight_scale``).

On CUDA the int8 product is ``torch._int_mm`` (cuBLASLt), the counterpart of
the JAX package's XLA ``dot_general`` with an int32 result.  It takes K and
N that are multiples of 8 and more than 16 rows: fewer rows are padded with
zero rows (codes 0, sliced off after the product), and any other K or N
raises.  No shape falls back to a float product.

QAT: ``fake_quant_kernel`` is the weight the int8 path will use, with the
straight-through gradient ``w + (fq(w) − w).detach()``.  The set of weights
it applies to comes from the quantized model itself
(``quantized_kernel_mask``), so QAT and serving cannot disagree.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows
INT_MM_ROW_PAD = 32   # rows a smaller product is padded to
INT_MM_ALIGN = 8      # K and N must be multiples of 8


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max|x| / 127, floored at 1e-12, as a true division: CUDA divides by a
    Python scalar as a product with its reciprocal, which can differ from
    the quotient in the last bit and so move codes."""
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)


def quantize_kernel(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of a weight whose first
    axis is the output axis (torch layout).

    :returns: (w_q int8 of w's shape, scale float32 (out,))
    """
    w32 = w.float()
    scale = _scale(w32.abs().amax(dim=tuple(range(1, w32.dim()))))
    w_q = torch.clamp(torch.round(w32 / scale.view(-1, *([1] * (w32.dim() - 1)))), -127, 127).to(torch.int8)
    return w_q, scale


def dynamic_quantize_rows(x: torch.Tensor):
    """Symmetric per-row (last axis) int8 quantization of activations.

    :returns: (x_q int8 of x's shape, scale float32 (..., 1))
    """
    x32 = x.float()
    scale = _scale(x32.abs().amax(dim=-1, keepdim=True))
    x_q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return x_q, scale


def _check_int_mm(k: int, n: int) -> None:
    if k % INT_MM_ALIGN or n % INT_MM_ALIGN:
        raise ValueError(
            f"int8_matmul on CUDA takes K and N that are multiples of {INT_MM_ALIGN} "
            f"(torch._int_mm), got K={k}, N={n}")


def int8_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)ᵀ int8 → (M, N) int32, exact.  On CUDA through
    ``torch._int_mm`` with the weight as its column-major (K, N) view; fewer
    than ``INT_MM_MIN_ROWS`` rows are padded with zero rows."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.is_cuda:
        _check_int_mm(k, n)
        if m < INT_MM_MIN_ROWS:
            padded = x_q.new_zeros((INT_MM_ROW_PAD, k))
            padded[:m] = x_q
            return torch._int_mm(padded, w_q.t())[:m]
    return torch._int_mm(x_q.contiguous(), w_q.t())


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w_q)ᵀ: the rows of x quantized on the fly, an int8 × int8
    → int32 product, dequantized to float32.

    :param x: (..., K) float activations
    :param w_q: (N, K) int8
    :param w_scale: (N,) float32 per-channel scales
    """
    x_q, x_scale = dynamic_quantize_rows(x)
    acc = int8_product(x_q.reshape(-1, x.shape[-1]), w_q).reshape(*x.shape[:-1], w_q.shape[0])
    return acc.float() * x_scale * w_scale


class QuantLinear(nn.Module):
    """Serving replacement of a dense layer with int8 weights (counterpart of
    ``QuantDense``).  The input is quantized as it comes (a bfloat16 input is
    upcast, a float32 one is not rounded to the compute dtype first), the bias
    is added in float32, and the output is cast to ``dtype`` last.  The
    buffers' zero and one fillers are placeholders: a quantized layer means
    something only once ``quantize_state_dict`` has filled it from trained
    float weights."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight_q8", torch.zeros((out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.weight_q8, self.weight_scale)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)


def fake_quant_kernel(w: torch.Tensor) -> torch.Tensor:
    """Quantization-aware view of a dense weight: its value is exactly
    ``quantize_kernel``'s codes times their scales (per output row), its
    gradient the identity (straight-through), so the float master weights
    go on training on the weights int8 serving will use.  A tp-sharded
    weight (a DTensor) gets the scales of the whole weight: see
    :func:`_fake_quant_sharded`."""
    if isinstance(w, DTensor):
        return _fake_quant_sharded(w)
    w32 = w.float()
    with torch.no_grad():
        w_q, scale = quantize_kernel(w32)
        fq = w_q.float() * scale.view(-1, *([1] * (w32.dim() - 1)))
    return (w32 + (fq - w32).detach()).to(w.dtype)


def _fake_quant_sharded(w: DTensor) -> torch.Tensor:
    """``fake_quant_kernel`` of a sharded weight, rank by rank: a shard of
    whole output rows (colwise, ``Shard(0)``: q, k, v, the first MLP layer,
    the heads) has its rows' scales locally; a shard of a slice of every row
    (rowwise, ``Shard(1)``: the attention projection, the second MLP layer)
    takes each row's max |w| over its group before the scale, so the codes
    are those of the whole weight (vpt_tpu's max over the whole input axis)."""
    local = w.to_local().float()
    with torch.no_grad():
        amax = local.abs().amax(dim=tuple(range(1, local.dim())))
        for dim, placement in enumerate(w.placements):
            if placement.is_partial():
                raise ValueError(f"fake_quant_kernel of a partial weight ({w.placements})")
            if isinstance(placement, Shard) and placement.dim != 0:
                dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=w.device_mesh.get_group(dim))
        scale = _scale(amax).view(-1, *([1] * (local.dim() - 1)))
        fq = torch.clamp(torch.round(local / scale), -127, 127) * scale
        delta = DTensor.from_local(fq - local, w.device_mesh, w.placements, run_check=False)
    return (w.float() + delta).to(w.dtype)


def quantized_kernel_mask(float_params: Iterable[str], quant_template: Iterable[str]) -> Dict[str, bool]:
    """{float parameter name: True exactly where the ``quantize_dense`` model
    replaces that weight with int8}, derived from the quantized model's
    state_dict names (``quant_template``: ``<path>.weight_q8`` marks
    ``<path>.weight``), as the JAX version derives its mask from the
    quantized model's variable template."""
    names = {k[: -len(".weight_q8")] + ".weight" for k in quant_template if k.endswith(".weight_q8")}
    return {name: name in names for name in float_params}


def fake_quant_dense_params(params: Mapping[str, torch.Tensor], mask: Mapping[str, bool]) -> Dict[str, torch.Tensor]:
    """``params`` with :func:`fake_quant_kernel` applied where ``mask`` is True."""
    return {k: fake_quant_kernel(v) if mask.get(k, False) else v for k, v in params.items()}


def quantize_state_dict(float_sd: Mapping[str, torch.Tensor], quant_template: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Derive a quantized state_dict from a float one (counterpart of
    ``quantize_variables``): every ``<path>.weight_q8`` of the template is
    quantized from the float ``<path>.weight`` (the scale goes to
    ``<path>.weight_scale``); every other entry is carried over, its shape
    checked against the template.  The quantization runs where the float
    weights lie."""
    out: Dict[str, torch.Tensor] = {}
    for key, tval in quant_template.items():
        if key.endswith(".weight_scale"):
            continue  # written with its weight_q8
        if key.endswith(".weight_q8"):
            path = key[: -len(".weight_q8")]
            w_q, scale = quantize_kernel(float_sd[path + ".weight"])
            if tuple(w_q.shape) != tuple(tval.shape):
                raise ValueError(f"{key}: quantized shape {tuple(w_q.shape)} != template {tuple(tval.shape)}")
            out[key] = w_q
            out[path + ".weight_scale"] = scale
            continue
        if key not in float_sd:
            raise KeyError(f"{key} of the quantized model has no float counterpart")
        leaf = float_sd[key]
        if tuple(leaf.shape) != tuple(tval.shape):
            raise ValueError(f"{key}: float shape {tuple(leaf.shape)} != template {tuple(tval.shape)}")
        out[key] = leaf
    return out


def quantized_model(float_model: nn.Module, build_quantized) -> nn.Module:
    """The int8 serving twin of ``float_model``: ``build_quantized()`` makes
    the ``quantize_dense`` model without naming a device (it is built on the
    meta device, so nothing is allocated twice) and takes the quantized
    state_dict of the float model's weights, on their device."""
    with torch.device("meta"):
        template = build_quantized()
    template.load_state_dict(quantize_state_dict(float_model.state_dict(), template.state_dict()),
                             strict=True, assign=True)
    left = [n for n, t in list(template.named_parameters()) + list(template.named_buffers()) if t.is_meta]
    if left:
        raise ValueError(f"the quantized model holds tensors the state_dict does not fill: {left}")
    return template.train(float_model.training)


def qat_mask(build_quantized, float_params: Iterable[str]) -> Dict[str, bool]:
    """:func:`quantized_kernel_mask` of a float model's parameter names
    against the ``quantize_dense`` model ``build_quantized()`` makes (on the
    meta device: names and shapes only)."""
    with torch.device("meta"):
        template = build_quantized()
    return quantized_kernel_mask(float_params, template.state_dict())
