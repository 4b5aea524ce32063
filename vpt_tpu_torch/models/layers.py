"""Building-block layers (counterpart of vpt_tpu/models/layers.py).

Naming contract: submodules carry the reference torch names (``layer`` and
``norm`` inside FanInInitLayer, ``q_layer`` etc. in the attention layer), so a
reference state_dict loads with ``load_state_dict(strict=False)``.

Precision contract, as in the JAX package: parameters are stored float32; a
dense or conv layer casts its input and parameters to the module's compute
``dtype``; norms compute and return float32.

Init contract: the reference's fan-in init renormalises each output unit's
weight vector to L2 norm ``init_scale`` (reference: lib/util.py:67-73,
lib/torch_util.py:68-82).  Every module that owns parameters has
``reset_parameters(generator=None)``; ``init_parameters`` draws a whole model
from one explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vpt_tpu_torch.ops import conv
from vpt_tpu_torch.ops.int8 import QuantLinear, fake_quant_kernel
from vpt_tpu_torch.utils.profiling import count, span

LN_EPS = 1e-5  # torch LayerNorm/GroupNorm default epsilon

# the recompute's spans (utils/profiling.py): the CNN's (a frame chunk's, or
# an Impala stack's) and a residual block's, which holds kernel B1
REMAT_CNN_SPAN, REMAT_BLOCK_SPAN = "vpt_torch.remat.cnn", "vpt_torch.remat.block"


def remat_call(fn, *args, span_name: str):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (non-reentrant ``torch.utils.checkpoint``; the counterpart of flax's
    ``nn.remat``).  With grad off nothing is kept anyway: a plain call.

    The checkpoint calls ``fn`` first for the forward, then again in the
    backward; each later call, the recompute alone, runs inside the span
    ``span_name`` and counts one under ``remat_recomputes`` while a profiler
    records."""
    if not torch.is_grad_enabled():
        return fn(*args)
    forwarded = False

    def run(*a):
        nonlocal forwarded
        if not forwarded:
            forwarded = True
            return fn(*a)
        count("remat_recomputes")
        with span(span_name):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


@torch.no_grad()
def fan_in_normed_(weight: torch.Tensor, scale: float, generator: Optional[torch.Generator] = None):
    """Fill ``weight`` (output axis first) with gaussian rows of L2 norm ``scale``."""
    w = torch.randn(weight.shape, generator=generator, device=weight.device, dtype=torch.float32)
    norm = w.flatten(1).norm(dim=1).clamp_min(1e-12)
    weight.copy_(scale * w / norm.view(-1, *([1] * (w.dim() - 1))))


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of ``model`` from ``generator``, module by
    module in registration order."""
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator=generator)
    return model


class NormedLinear(nn.Module):
    """Dense layer with fan-in-normalised init and zero bias (reference
    NormedLinear, lib/torch_util.py:68-82), computing in ``dtype``.  With
    ``fake_quant`` set (``set_fake_quant``, QAT) its forward uses the
    weight's int8 fake-quantized view."""

    def __init__(self, in_features: int, out_features: int, scale: float = 1.0,
                 bias: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.scale = scale
        self.dtype = dtype
        self.fake_quant = False
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device)) if bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in_normed_(self.weight, self.scale, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        w = fake_quant_kernel(self.weight) if self.fake_quant else self.weight
        return F.linear(x.to(dt), w.to(dt), bias)


def normed_dense(in_features: int, out_features: int, *, scale: float, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None, quantize: bool = False) -> nn.Module:
    """Counterpart of ``vpt_tpu.models.layers.normed_dense``: ``quantize``
    swaps in the int8 serving layer (ops/int8.py) at the same module path."""
    if quantize:
        return QuantLinear(in_features, out_features, bias=use_bias, dtype=dtype, device=device)
    return NormedLinear(in_features, out_features, scale=scale, bias=use_bias, dtype=dtype, device=device)


class LayerNorm(nn.Module):
    """torch-compatible LayerNorm (eps 1e-5) computing and returning float32."""

    def __init__(self, size: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size, device=device))
        self.bias = nn.Parameter(torch.zeros(size, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, LN_EPS)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW computing and returning float32."""

    def __init__(self, groups: int, channels: int, device=None):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight, self.bias, LN_EPS)


class BatchNorm(nn.Module):
    """Batch norm computing and returning float32, always on its running
    statistics: vpt_tpu's flax ``BatchNorm(use_running_average=True)``, in a
    train step too, so the statistics never move (a stock
    ``nn.BatchNorm2d`` in train mode would normalise by the batch's and
    update them).  The affine ``weight``/``bias`` train.  The channel axis is
    1 (NCHW, NCDHW), or the last with ``channels_last`` (a linear layer's
    input)."""

    def __init__(self, channels: int, channels_last: bool = False, device=None):
        super().__init__()
        self.channels_last = channels_last
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        shape = x.shape
        if self.channels_last:
            x = x.reshape(-1, shape[-1])
        x = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, training=False, eps=LN_EPS)
        return x.reshape(shape)


class FanInInitLayer(nn.Module):
    """norm → layer → ReLU with fan-in-renormalised init.

    Mirrors FanInInitReLULayer (reference: lib/util.py:23-82): the norm is
    applied to the *input*, the layer has a bias only when there is no norm,
    and the activation is optional.  ``layer_type`` ∈ {linear, conv,
    conv3d}: conv layers take NCHW, conv3d layers NCDHW (the IDM's front
    end, with D the time axis); ``kernel_size``, ``padding`` and ``stride``
    are an int for every spatial axis or one per axis.  ``batch_norm`` takes
    precedence over the group and layer norms, as in vpt_tpu.  ``quantize``
    makes a linear layer's ``layer`` the int8 ``QuantLinear``; ``fake_quant``
    (QAT, ``set_fake_quant``) runs a float linear layer on its weight's int8
    fake-quantized view.  This is the models' one conv routing point: a conv
    forward that ``ops.conv.routes_to_c1`` takes (a CUDA f32 3×3, stride 1,
    padding 1, 8 or more input channels) runs on kernel C1, the bias and
    ReLU in its epilogue; every conv and conv3d forward counts its FLOPs
    under ``conv_flops``, C1's also under ``conv_tc_flops``, while a
    profiler records.
    """

    def __init__(
        self,
        inchan: int,
        outchan: int,
        layer_type: str = "conv",
        init_scale: float = 1.0,
        batch_norm: bool = False,
        group_norm_groups: Optional[int] = None,
        layer_norm: bool = False,
        use_activation: bool = True,
        kernel_size: Union[int, Tuple[int, ...]] = 3,
        padding: Union[int, Tuple[int, ...]] = 1,
        stride: Union[int, Tuple[int, ...]] = 1,
        dtype: torch.dtype = torch.float32,
        device=None,
        quantize: bool = False,
    ):
        super().__init__()
        if quantize and layer_type != "linear":
            raise ValueError(f"quantize applies to linear layers only, not {layer_type}")
        self.layer_type = layer_type
        self.init_scale = init_scale
        self.use_activation = use_activation
        self.padding = padding
        self.stride = stride
        self.dtype = dtype
        self.quantize = quantize
        self.fake_quant = False
        self.norm = None
        if batch_norm:
            self.norm = BatchNorm(inchan, channels_last=layer_type == "linear", device=device)
        elif group_norm_groups is not None:
            self.norm = GroupNorm(group_norm_groups, inchan, device=device)
        elif layer_norm:
            self.norm = LayerNorm(inchan, device=device)
        has_bias = self.norm is None
        if layer_type == "linear":
            shape = (outchan, inchan)
        elif layer_type in ("conv", "conv3d"):
            ndim = 2 if layer_type == "conv" else 3
            ks = (kernel_size,) * ndim if isinstance(kernel_size, int) else tuple(kernel_size)
            if len(ks) != ndim:
                raise ValueError(f"{layer_type} needs {ndim} kernel sizes, got {kernel_size}")
            shape = (outchan, inchan) + ks
        else:
            raise NotImplementedError(layer_type)
        if quantize:
            self.layer = QuantLinear(inchan, outchan, bias=has_bias, dtype=dtype, device=device)
            return
        self.layer = nn.Module()
        self.layer.weight = nn.Parameter(torch.empty(shape, device=device))
        self.layer.bias = nn.Parameter(torch.empty(outchan, device=device)) if has_bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.quantize:
            return  # filled by quantize_state_dict
        fan_in_normed_(self.layer.weight, self.init_scale, generator)
        if self.layer.bias is not None:
            self.layer.bias.zero_()

    def forward(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        """``padding`` overrides the layer's own (a conv layer's)."""
        if self.norm is not None:
            x = self.norm(x)
        if self.quantize:
            x = self.layer(x)
            return F.relu(x) if self.use_activation else x
        dt = self.dtype
        w = fake_quant_kernel(self.layer.weight) if self.fake_quant else self.layer.weight
        w = w.to(dt)
        b = None if self.layer.bias is None else self.layer.bias.to(dt)
        x = x.to(dt)
        if self.layer_type == "linear":
            x = F.linear(x, w, b)
            return F.relu(x) if self.use_activation else x
        padding = self.padding if padding is None else padding
        if self.layer_type == "conv" and conv.routes_to_c1(x, w, self.stride, padding):
            x = conv.conv3x3_fwd(x, w, b, relu=self.use_activation)
            _count_conv(x, w, tensor_cores=True)
            return x
        x = (F.conv2d if self.layer_type == "conv" else F.conv3d)(x, w, b, stride=self.stride, padding=padding)
        _count_conv(x, w, tensor_cores=False)
        return F.relu(x) if self.use_activation else x


def _count_conv(out: torch.Tensor, w: torch.Tensor, tensor_cores: bool) -> None:
    """Count a conv forward's FLOPs, 2·N·C_out·C_in·k·(output positions),
    under ``conv_flops``, and C1's under ``conv_tc_flops`` too, while a
    profiler records."""
    if torch.autograd._profiler_enabled():
        flops = 2 * out.numel() * (w.numel() // w.shape[0])
        count("conv_flops", flops)
        if tensor_cores:
            count("conv_tc_flops", flops)


def set_fake_quant(model: nn.Module, mask) -> int:
    """Turn on QAT's fake quantization in every dense layer of ``model``
    whose weight ``mask`` (``ops.int8.quantized_kernel_mask``) marks; returns
    how many.  Raises where a marked weight belongs to no such layer."""
    marked = {name for name, on in mask.items() if on}
    done = set()
    for prefix, module in model.named_modules():
        if isinstance(module, NormedLinear):
            name = f"{prefix}.weight"
        elif isinstance(module, FanInInitLayer) and module.layer_type == "linear" and not module.quantize:
            name = f"{prefix}.layer.weight"
        else:
            continue
        module.fake_quant = name in marked
        if module.fake_quant:
            done.add(name)
    if done != marked:
        raise ValueError(f"no dense layer holds {sorted(marked - done)}")
    return len(done)
