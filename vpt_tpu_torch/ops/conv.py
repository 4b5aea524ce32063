"""Kernel C1: the forward of an f32 3×3 convolution (stride 1, padding 1,
NCHW) with the layer's bias and ReLU, at float32 accuracy on the tensor
cores (csrc/conv3x3_fwd.cu).

C1 is a new hand-written kernel: the JAX package leaves its convolutions to
XLA, so no kernel of ``vpt_tpu`` stands behind it.  It was added because the
Impala CNN's f32 convolutions are where the port's f32 training and
labeling spend their time, and cuDNN runs them (TF32 off) on CUDA cores or
through its FFT engine.  C1 multiplies each operand pair as three TF32
products of hi/lo splits, as B1 and B2 do, so its result does not depend on
``torch.backends.cudnn.allow_tf32``.

``routes_to_c1`` says whether a conv layer's forward goes to C1: from what
the layer sees in its input alone (a CUDA f32 input and weight, plain
tensors, a 3×3 kernel, stride 1, padding 1, at least ``MIN_CHANNELS`` input
channels, a width C1's strip takes).  The models call it at their one
routing point, ``models.layers.FanInInitLayer``; the policy's first conv (3
input channels), the IDM's conv3d, every bf16 conv and every CPU tensor
keep ``F.conv2d``.

``conv3x3_fwd`` goes through the operator ``torch.ops.vpt_torch.conv3x3_fwd``,
which runs the plain version ``conv3x3_fwd_plain`` (``F.conv2d``, then ReLU)
on a CPU tensor and on a CUDA tensor launches C1 or raises: nothing routes
elsewhere and nothing falls back.  Where autograd needs it
the call goes through ``conv3x3_autograd``, whose backward is cuDNN's dgrad
and wgrad (``aten.convolution_backward``) on the incoming gradient masked by
``out > 0``: it saves the input, the weight and the post-ReLU output, the
tensors autograd saves for ``F.relu(F.conv2d(...))``.  ``launches`` counts
C1's launches.  The operator's FLOP formula is registered with
``torch.utils.flop_counter``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import register_flop_formula

from vpt_tpu_torch.ops import cuda_build

KERNEL = "conv3x3_fwd"
# C1 takes at least one chunk of 8 input channels (one k8 step a tap); the
# policy's first conv (3 RGB channels) stays on cuDNN
MIN_CHANNELS = 8
# the strip of a tile's rows, 8 input channels of it, beside the weights,
# fits two stages of shared memory up to this width; C1 copies 16 bytes at a time
MAX_WIDTH, WIDTH_STEP, ALIGN = 256, 4, 16
_SIZE_REFUSAL = (f"C1 takes at least {MIN_CHANNELS} input channels and a width that is a multiple of "
                 f"{WIDTH_STEP} up to {MAX_WIDTH}")

launches = 0


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _refusal(x, w, bias=None, stride=1, padding=1) -> Optional[str]:
    """What C1 cannot take in a conv forward of input ``x`` and weight ``w``
    at ``stride`` and ``padding``, as a fixed phrase, or None where it takes
    it all.  Plain comparisons: the routing point asks this of every conv."""
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (bias is not None and bias.dtype != torch.float32):
        return "C1 takes float32 tensors"
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return "C1 takes plain tensors, not DTensors"
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3) or w.shape[1] != x.shape[1]:
        return "C1 takes x (N, C, H, W) and w (K, C, 3, 3)"
    if _pair(stride) != (1, 1) or _pair(padding) != (1, 1):
        return "C1 takes stride 1 and padding 1"
    if bias is not None and tuple(bias.shape) != (w.shape[0],):
        return "C1 takes a bias of (K,)"
    width = x.shape[-1]
    if x.shape[1] < MIN_CHANNELS or width % WIDTH_STEP or width > MAX_WIDTH:
        return _SIZE_REFUSAL
    return None


def routes_to_c1(x: torch.Tensor, w: torch.Tensor, stride, padding) -> bool:
    """Whether a conv forward of input ``x`` (N, C, H, W) and weight ``w``
    (K, C, kh, kw) at ``stride`` and ``padding`` runs on C1."""
    return x.is_cuda and _refusal(x, w, None, stride, padding) is None


def conv_flops(x_shape, w_shape) -> int:
    """FLOPs of a conv forward of input ``x_shape`` (N, C, H, W) and weight
    ``w_shape`` (K, C, 3, 3) at stride 1, padding 1: 2·N·K·C·9·H·W."""
    n, c, h, w = x_shape
    return 2 * n * w_shape[0] * c * w_shape[2] * w_shape[3] * h * w


def conv3x3_fwd_plain(x, w, bias=None, relu: bool = True) -> torch.Tensor:
    """C1's function in plain PyTorch: ``F.conv2d`` (stride 1, padding 1),
    then ReLU."""
    y = F.conv2d(x, w, bias, padding=1)
    return F.relu(y) if relu else y


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    fn = lib.vpt_conv3x3_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # x w bias y wsplit | N C K H W relu | stream
        fn.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        fn.restype = ctypes.c_int
        lib.vpt_conv3x3_fwd_scratch.argtypes = [i32] * 3  # C K W
        lib.vpt_conv3x3_fwd_scratch.restype = ctypes.c_int64
        lib.vpt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w, bias) -> None:
    refusal = _refusal(x, w, bias)
    if refusal is not None:
        got = f"x {x.dtype} {tuple(x.shape)}, w {w.dtype} {tuple(w.shape)}"
        if bias is not None:
            got += f", bias {bias.dtype} {tuple(bias.shape)}"
        raise ValueError(f"{refusal}, got {got}")
    for t in (w, bias):
        if t is not None and t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got one on {t.device}")


def _launch(x, w, bias, relu: bool) -> torch.Tensor:
    x, w = x.contiguous(), w.contiguous()
    bias = bias.contiguous() if bias is not None else None
    if x.data_ptr() % ALIGN:
        raise ValueError(f"x must start on a {ALIGN}-byte boundary")
    n, c, h, width = x.shape
    k = w.shape[0]
    lib = _library()
    y = torch.empty((n, k, h, width), dtype=torch.float32, device=x.device)
    wsplit = torch.empty(lib.vpt_conv3x3_fwd_scratch(c, k, width), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vpt_conv3x3_fwd(x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
                                  y.data_ptr(), wsplit.data_ptr(), n, c, k, h, width, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: {lib.vpt_cuda_error_string(err).decode()} ({err})")
    global launches
    launches += 1
    return y


# C1 as an operator, so that torch.utils.flop_counter sees its launches (a
# ctypes call is no aten op); the namespace is kernel B1's library's.  On a
# CPU tensor the operator is the plain version.
_ops = torch.library.Library("vpt_torch", "FRAGMENT")
_ops.define("conv3x3_fwd(Tensor x, Tensor w, Tensor? bias, bool relu) -> Tensor")
_ops.impl("conv3x3_fwd", _launch, "CUDA")
_ops.impl("conv3x3_fwd", conv3x3_fwd_plain, "CPU")


def _fwd_meta(x, w, bias, relu):
    return x.new_empty((x.shape[0], w.shape[0], x.shape[2], x.shape[3]))


_ops.impl("conv3x3_fwd", _fwd_meta, "Meta")


@register_flop_formula(torch.ops.vpt_torch.conv3x3_fwd, get_raw=True)
def _fwd_flops(x, w, bias, relu, out_val=None) -> int:
    return conv_flops(x.shape, w.shape)


class Conv3x3(torch.autograd.Function):
    """C1's forward, the bias and ReLU in its epilogue; the backward is
    cuDNN's dgrad and wgrad of the convolution alone, on the gradient of the
    pre-ReLU output (which ``ReLUGrad`` hands it where there is a ReLU)."""

    @staticmethod
    def forward(ctx, x, w, bias, relu: bool):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return torch.ops.vpt_torch.conv3x3_fwd(x, w, bias, relu)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = torch.ops.aten.convolution_backward(
            grad, x, w, [w.shape[0]] if ctx.has_bias else None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [need_x, need_w, need_b and ctx.has_bias])
        return dx, dw, db, None


class ReLUGrad(torch.autograd.Function):
    """The identity on a ReLU's output (a view, no copy), whose backward is
    F.relu's: the gradient masked by ``out > 0``.  A node of its own, as
    F.relu's is, so that autograd frees the incoming gradient before the
    convolution's backward runs: masking inside ``Conv3x3``'s backward kept
    both alive there, a whole extra activation (1.1 GB at the 3x's peak)."""

    @staticmethod
    def forward(ctx, out):
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return torch.ops.aten.threshold_backward(grad, out, 0)


def conv3x3_autograd(x, w, bias=None, relu: bool = True) -> torch.Tensor:
    """``conv3x3_fwd`` through autograd: it saves the input, the weight and
    the post-ReLU output, the tensors autograd saves for
    ``F.relu(F.conv2d(...))``."""
    out = Conv3x3.apply(x, w, bias, relu)
    return ReLUGrad.apply(out) if relu else out


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                relu: bool = True) -> torch.Tensor:
    """relu(conv2d(x, w, bias, stride=1, padding=1)), or without the ReLU.

    :param x: (N, C, H, W) float32; w: (K, C, 3, 3); bias: (K,) or None
    :returns: (N, K, H, W) float32; differentiable in x, w and bias
    """
    if x.device.type == "cuda":
        _check(x, w, bias)
    elif x.device.type != "cpu":
        raise ValueError(f"conv3x3_fwd runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, bias)):
        return conv3x3_autograd(x, w, bias, relu)
    return torch.ops.vpt_torch.conv3x3_fwd(x, w, bias, relu)
