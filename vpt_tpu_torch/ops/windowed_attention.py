"""Fused windowed attention: kernel B1 (forward) and kernel B2 (backward),
counterparts of vpt_tpu/ops/pallas_attention.py and pallas_attention_impl.py.

``windowed_attention_fwd`` computes
``softmax(alpha·QKᵀ + Σ_n R[..,n]·D[n] + maskbias)·V`` from the raw relative
attention inputs (R coefficients and the b_nd band table), so the CUDA kernel
(csrc/windowed_attention_fwd.cu) forms the bias on the chip and neither the
(n, t, T) band table nor a (B, H, t, T) bias reaches device memory.  Where
autograd needs it, the call goes through ``WindowedAttention``, whose
backward is kernel B2 (csrc/windowed_attention_bwd.cu): the gradients of q,
k, v, R and b_nd, with dR and d b_nd reduced in the kernel, so no (B, H, t, T)
dL reaches device memory either.

Both kernels take any number of keys T: past ``KEY_CHUNK`` keys they walk
the keys in chunks of that many through shared memory (an online softmax in
B1, three sweeps over the chunks in B2's first pass).  They take a band
table b_nd of any length: up to 512 offsets it is held in shared memory,
past that (attention_memory_size - timesteps > 512) the kernels read it
from device memory.  They take every head dim d ≥ 1, as vpt_tpu's attention
does: the multiples of 64 run whole, those of the published models (64,
128, 192) and 256 in instances of their own, every wider one (hidsize 6144
at 16 heads, 1024 at 1 head, ...) in one instance whose shared memory does
not depend on d, which streams Q, K, V and dO 64 columns at a time; its
accumulators that outlive a pass (past 512 keys, or over B2's query tiles)
wait in an f32 scratch that the wrapper allocates.  A call of any other
head dim (the tiny test configs' 16, hidsize 512 at 16 heads' 32, 96,
520) runs at ``kernel_d(d)``, the next multiple of 64: its q, k and v are
zero-padded to it, which changes neither Q·Kᵀ nor the real columns of the
output, and the output and gradients are sliced back.  The softmax scale
is the unpadded d's, and the operators' FLOP formulas see the unpadded
shapes.

Both kernels run their products on tensor cores (mma.sync), at the accuracy
of the input type: f32 operands are split into TF32 hi and lo parts and
multiplied in three TF32 products, bf16 ones go straight to the bf16 tensor
cores (csrc/attention_mma.cuh).  The arithmetic does not depend on
``torch.backends.cuda.matmul.allow_tf32``.

On a CPU tensor each wrapper runs its plain PyTorch version
(``windowed_attention_fwd_plain``, differentiated by autograd, and
``windowed_attention_bwd_plain``).  On a CUDA tensor it launches its kernel
or raises: there is no shape or dtype it routes elsewhere (the tiny test
configs' d = 16 runs padded, as above).  ``launches``
counts B1's launches and ``bwd_launches`` B2's, so a run can show that its
path went through both.

The launches go through two operators of the ``vpt_torch`` library,
``windowed_attention_fwd`` and ``windowed_attention_bwd``, whose FLOP
formulas (``attention_flops``) are registered with
``torch.utils.flop_counter``: a ``FlopCounterMode`` counts a step on the
card as it counts the plain version's aten products on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from vpt_tpu_torch.ops import cuda_build
from vpt_tpu_torch.ops.attention import NEG_BIAS, attention_alpha, windowed_attention
from vpt_tpu_torch.ops.rel_bias import banded_bias_matrix, relattn_bias

KERNEL = "windowed_attention_fwd"
BWD_KERNEL = "windowed_attention_bwd"
D_STEP = 64  # the kernels take every head dim that is a multiple of this (csrc/attention_mma.cuh D_CHUNK)
KEY_CHUNK = 512  # keys whose logits a block of the kernels holds at once (csrc/attention_mma.cuh)
MAX_NBASIS = 16
ALIGN = 16  # bytes: the kernels copy q, k, v and dO 16 bytes at a time

launches = 0
bwd_launches = 0


def windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, use_muP_factor: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch: relattn bias, then the
    reference attention (ops/attention.py)."""
    extra = relattn_bias(R, b_nd, k.shape[2]) if R is not None else None
    return windowed_attention(q, k, v, mask, extra, use_muP_factor)


def windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, use_muP_factor: bool):
    """B2's function in plain PyTorch, step by step as the JAX backward
    (pallas_attention_impl.py ``_attn_bwd_kernel`` and ``_bwd``), in float32.

    :returns: (dq, dk, dv) in the input dtype, dR (B, H, t, n) and db_nd
        (n, bandsize) in float32 (None without R)
    """
    t, T = q.shape[2], k.shape[2]
    alpha = attention_alpha(q.shape[-1], use_muP_factor)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dO))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * alpha
    if R is not None:
        D = banded_bias_matrix(b_nd.float(), t, T)  # (n, t, T)
        logits = logits + torch.einsum("bhtn,ntT->bhtT", R.float(), D)
    if mask is not None:
        logits = logits + torch.where(mask[:, None], 0.0, NEG_BIAS)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    dv = torch.matmul(w.transpose(-1, -2), gf)
    dP = torch.matmul(gf, vf.transpose(-1, -2))
    dL = w * (dP - (dP * w).sum(dim=-1, keepdim=True))
    dq = alpha * torch.matmul(dL, kf)
    dk = alpha * torch.matmul(dL.transpose(-1, -2), qf)
    dR = db = None
    if R is not None:
        dR = torch.einsum("bhtT,ntT->bhtn", dL, D)
        dD = torch.einsum("bhtT,bhtn->ntT", dL, R.float())
        # the transpose of banded_bias_matrix: sum dD onto the band offsets
        bandsize = b_nd.shape[-1]
        off = (T - t) + torch.arange(t, device=q.device)[:, None] - torch.arange(T, device=q.device)[None, :]
        valid = (off >= 0) & (off < bandsize)
        db = torch.zeros(b_nd.shape, dtype=torch.float32, device=q.device)
        db.index_add_(1, off[valid], dD[:, valid])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dR, db


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    fn = lib.vpt_windowed_attention_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # q k v R b_nd mask out scratch | B H t T d nbasis bandsize is_bf16 | alpha stream
        fn.argtypes = [ptr] * 8 + [i32] * 8 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.vpt_windowed_attention_fwd_scratch.argtypes = [i32] * 5  # B H t T d
        lib.vpt_windowed_attention_fwd_scratch.restype = ctypes.c_int64
        lib.vpt_windowed_attention_fwd_smem.argtypes = [i32] * 5  # T d nbasis bandsize is_bf16
        lib.vpt_windowed_attention_fwd_smem.restype = ctypes.c_int
        lib.vpt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load(BWD_KERNEL)
    fn = lib.vpt_windowed_attention_bwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # q k v dout R b_nd mask dq dk dv dR db stats partial scratch | B H t T d nbasis bandsize is_bf16 |
        # alpha stream
        fn.argtypes = [ptr] * 15 + [i32] * 8 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.vpt_windowed_attention_bwd_rows.argtypes = [i32] * 5  # T d nbasis bandsize is_bf16
        lib.vpt_windowed_attention_bwd_rows.restype = ctypes.c_int
        lib.vpt_windowed_attention_bwd_scratch.argtypes = [i32] * 5  # B H t T d
        lib.vpt_windowed_attention_bwd_scratch.restype = ctypes.c_int64
        lib.vpt_windowed_attention_bwd_smem.argtypes = [i32] * 6  # T d nbasis bandsize is_bf16 pass
        lib.vpt_windowed_attention_bwd_smem.restype = ctypes.c_int
        lib.vpt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def attention_flops(q, k, R, b_nd) -> Tuple[int, int]:
    """(forward, backward) FLOPs of one call, as ``FlopCounterMode`` counts
    the plain version and its autograd backward: QKᵀ and W·V forward, their
    four products backward (B2's recompute of the logits is not counted), and
    the relative bias's contraction over every (query, key) pair, once
    forward and twice backward (dR and d b_nd).  The kernels' operators
    count these, so a FLOP count of a step is the same on the card as on
    the CPU."""
    B, H, t, d = q.shape
    pairs = B * H * t * k.shape[2]
    bias = 2 * pairs * R.shape[-1] if R is not None else 0
    return 4 * pairs * d + bias, 8 * pairs * d + 2 * bias


def kernel_d(d: int) -> int:
    """The head dim the kernels run a call of head dim ``d`` at: the
    multiple of 64 at or above it; below 1 a ValueError."""
    if d < 1:
        raise ValueError(f"head dim {d} not supported by the kernels (they take every d >= 1, "
                         f"multiples of {D_STEP} whole and the rest zero-padded)")
    return -(-d // D_STEP) * D_STEP


def _padded(x: torch.Tensor, d: int) -> torch.Tensor:
    return x if x.shape[-1] == d else F.pad(x, (0, d - x.shape[-1]))


def padded_fwd(q, k, v, mask, R, b_nd, use_muP_factor: bool, launch) -> torch.Tensor:
    """B1's call at the kernels' head dim: ``launch(q, k, v, mask, R, b_nd,
    alpha)`` on q, k, v zero-padded to ``kernel_d(d)``, with the softmax
    scale of the unpadded d, and the output sliced back to d."""
    d = q.shape[-1]
    dk = kernel_d(d)
    out = launch(*(_padded(x, dk) for x in (q, k, v)), mask, R, b_nd, attention_alpha(d, use_muP_factor))
    return out if dk == d else out[..., :d].contiguous()


def padded_bwd(q, k, v, mask, R, b_nd, dO, use_muP_factor: bool, launch):
    """B2's call at the kernels' head dim, as ``padded_fwd``: ``launch(q,
    k, v, mask, R, b_nd, dO, alpha)`` on padded q, k, v and dO, and dq, dk,
    dv sliced back (dR and d b_nd do not depend on d)."""
    d = q.shape[-1]
    dk = kernel_d(d)
    dq, dk_, dv, dR, db = launch(*(_padded(x, dk) for x in (q, k, v)), mask, R, b_nd, _padded(dO, dk),
                                 attention_alpha(d, use_muP_factor))
    if dk != d:
        dq, dk_, dv = (x[..., :d].contiguous() for x in (dq, dk_, dv))
    return dq, dk_, dv, dR, db


def _check(q, k, v, mask, R, b_nd) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, t, d), (B, H, T, d), (B, H, T, d)")
    B, H, t, d = q.shape
    T = k.shape[2]
    kernel_d(d)
    if k.shape != (B, H, T, d) or v.shape != (B, H, T, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if T < 1:
        raise ValueError(f"key length {T} must be at least 1")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share dtype float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    tensors = [q, k, v]
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (B, t, T):
            raise ValueError(f"mask must be bool (B, t, T) = {(B, t, T)}, got {mask.dtype} {tuple(mask.shape)}")
        tensors.append(mask)
    if (R is None) != (b_nd is None):
        raise ValueError("R and b_nd come together")
    if R is not None:
        n = R.shape[-1]
        if R.dtype != torch.float32 or R.shape != (B, H, t, n) or not 1 <= n <= MAX_NBASIS:
            raise ValueError(f"R must be float32 (B, H, t, n<= {MAX_NBASIS}), got {R.dtype} {tuple(R.shape)}")
        if b_nd.dtype != torch.float32 or b_nd.dim() != 2 or b_nd.shape[0] != n:
            raise ValueError(f"b_nd must be float32 ({n}, bandsize), got {b_nd.dtype} {tuple(b_nd.shape)}")
        tensors += [R, b_nd]
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got one on {x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    if any(x.data_ptr() % ALIGN for x in (q, k, v)):
        raise ValueError(f"q, k and v must start on a {ALIGN}-byte boundary")


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.vpt_cuda_error_string(err).decode()} ({err})")


def _scratch(floats: int, device) -> Optional[torch.Tensor]:
    """The f32 scratch a kernel asks for at a shape, or None where it needs none."""
    return torch.empty(floats, dtype=torch.float32, device=device) if floats > 0 else None


def launch_smem_bytes(T: int, d: int, nbasis: int, bandsize: int, dtype: torch.dtype) -> dict:
    """The dynamic shared memory, in bytes, of B1's launch and B2's two
    passes at this shape on the current card (``d`` a multiple of 64)."""
    is_bf16 = int(dtype == torch.bfloat16)
    fwd, bwd = _library(), _bwd_library()
    out = {"B1": fwd.vpt_windowed_attention_fwd_smem(T, d, nbasis, bandsize, is_bf16),
           "B2 pass 1": bwd.vpt_windowed_attention_bwd_smem(T, d, nbasis, bandsize, is_bf16, 1),
           "B2 pass 2": bwd.vpt_windowed_attention_bwd_smem(T, d, nbasis, bandsize, is_bf16, 2)}
    for name, n in out.items():
        if n < 0:
            _raise_on(fwd, -n, name)
    return out


def _run_fwd(q, k, v, mask, R, b_nd, alpha: float) -> torch.Tensor:
    B, H, t, d = q.shape
    T = k.shape[2]
    lib = _library()
    out = torch.empty_like(q)
    scratch = _scratch(lib.vpt_windowed_attention_fwd_scratch(B, H, t, T, d), q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vpt_windowed_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(R), _ptr(b_nd), _ptr(mask),
            out.data_ptr(), _ptr(scratch), B, H, t, T, d,
            R.shape[-1] if R is not None else 0,
            b_nd.shape[1] if b_nd is not None else 0,
            int(q.dtype == torch.bfloat16), alpha, stream,
        )
    _raise_on(lib, err, KERNEL)
    global launches
    launches += 1
    return out


def _launch_fwd(q, k, v, mask, R, b_nd, use_muP_factor: bool) -> torch.Tensor:
    return padded_fwd(q, k, v, mask, R, b_nd, use_muP_factor, _run_fwd)


def _run_bwd(q, k, v, mask, R, b_nd, dO, alpha: float):
    B, H, t, d = q.shape
    T = k.shape[2]
    nbasis, bandsize = (R.shape[-1], b_nd.shape[1]) if R is not None else (0, 0)
    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = _bwd_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    stats = torch.empty(3 * B * H * t, **f32)  # per query row: softmax max, sum, rowdot
    scratch = _scratch(lib.vpt_windowed_attention_bwd_scratch(B, H, t, T, d), q.device)
    dR = db = partial = None
    with torch.cuda.device(q.device):
        if R is not None:
            rows = lib.vpt_windowed_attention_bwd_rows(T, d, nbasis, bandsize, is_bf16)  # pass 1's rows a block
            if rows <= 0:
                _raise_on(lib, -rows, BWD_KERNEL)
            dR, db = torch.empty_like(R), torch.empty_like(b_nd)
            partial = torch.empty(B * H * ((t + rows - 1) // rows) * nbasis * bandsize, **f32)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vpt_windowed_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(), _ptr(R), _ptr(b_nd), _ptr(mask),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dR), _ptr(db), stats.data_ptr(), _ptr(partial),
            _ptr(scratch), B, H, t, T, d, nbasis, bandsize, is_bf16, alpha, stream,
        )
    _raise_on(lib, err, BWD_KERNEL)
    global bwd_launches
    bwd_launches += 1
    if R is None:  # the operator returns tensors: empty ones stand for no dR and d b_nd
        dR, db = torch.empty(0, **f32), torch.empty(0, **f32)
    return dq, dk, dv, dR, db


def _launch_bwd(q, k, v, mask, R, b_nd, dO, use_muP_factor: bool):
    return padded_bwd(q, k, v, mask, R, b_nd, dO, use_muP_factor, _run_bwd)


# B1 and B2 as operators, so that torch.utils.flop_counter sees their launches
# (a ctypes call is no aten op) at the caller's unpadded shapes.  B2's dR and
# d b_nd are empty without R.
_ops = torch.library.Library("vpt_torch", "DEF")
_ops.define("windowed_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor? mask, Tensor? R, Tensor? b_nd, "
            "bool use_muP_factor) -> Tensor")
_ops.define("windowed_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor? mask, Tensor? R, Tensor? b_nd, "
            "Tensor dO, bool use_muP_factor) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
_ops.impl("windowed_attention_fwd", _launch_fwd, "CUDA")
_ops.impl("windowed_attention_bwd", _launch_bwd, "CUDA")


def _fwd_meta(q, k, v, mask, R, b_nd, use_muP_factor):
    return torch.empty_like(q)


def _bwd_meta(q, k, v, mask, R, b_nd, dO, use_muP_factor):
    if R is None:
        dR, db = q.new_empty(0, dtype=torch.float32), q.new_empty(0, dtype=torch.float32)
    else:
        dR, db = torch.empty_like(R), torch.empty_like(b_nd)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), dR, db


_ops.impl("windowed_attention_fwd", _fwd_meta, "Meta")
_ops.impl("windowed_attention_bwd", _bwd_meta, "Meta")


@register_flop_formula(torch.ops.vpt_torch.windowed_attention_fwd, get_raw=True)
def _fwd_flops(q, k, v, mask, R, b_nd, use_muP_factor, out_val=None) -> int:
    return attention_flops(q, k, R, b_nd)[0]


@register_flop_formula(torch.ops.vpt_torch.windowed_attention_bwd, get_raw=True)
def _bwd_flops(q, k, v, mask, R, b_nd, dO, use_muP_factor, out_val=None) -> int:
    return attention_flops(q, k, R, b_nd)[1]


class WindowedAttention(torch.autograd.Function):
    """B1 forward, B2 backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, mask, R, b_nd, use_muP_factor: bool):
        out = torch.ops.vpt_torch.windowed_attention_fwd(q, k, v, mask, R, b_nd, use_muP_factor)
        ctx.save_for_backward(q, k, v, mask, R, b_nd)
        ctx.use_muP_factor = use_muP_factor
        return out

    @staticmethod
    def backward(ctx, dO):
        q, k, v, mask, R, b_nd = ctx.saved_tensors
        dq, dk, dv, dR, db = windowed_attention_bwd(q, k, v, mask, R, b_nd, dO.contiguous(), ctx.use_muP_factor)
        return dq, dk, dv, None, dR, db, None


def windowed_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    R: Optional[torch.Tensor],
    b_nd: Optional[torch.Tensor],
    use_muP_factor: bool,
) -> torch.Tensor:
    """Windowed attention with in-kernel relative bias.

    :param q: (B, H, t, d); k, v: (B, H, T, d), float32 or bfloat16
    :param mask: (B, t, T) bool (True = may attend) or None
    :param R: (B, H, t, nbasis) float32 basis coefficients, or None
    :param b_nd: (nbasis, bandsize) float32 band table, or None
    :returns: (B, H, t, d) in q's dtype; differentiable in q, k, v, R, b_nd
    """
    if q.device.type == "cpu":
        return windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, use_muP_factor)
    if q.device.type != "cuda":
        raise ValueError(f"windowed_attention_fwd runs on cpu or cuda, not {q.device}")
    _check(q, k, v, mask, R, b_nd)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (q, k, v, R, b_nd)):
        return WindowedAttention.apply(q, k, v, mask, R, b_nd, use_muP_factor)
    return torch.ops.vpt_torch.windowed_attention_fwd(q, k, v, mask, R, b_nd, use_muP_factor)


def windowed_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    R: Optional[torch.Tensor],
    b_nd: Optional[torch.Tensor],
    dO: torch.Tensor,
    use_muP_factor: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Gradients of ``windowed_attention_fwd`` for the output gradient dO.

    :param dO: (B, H, t, d) in q's dtype, contiguous
    :returns: (dq, dk, dv) in the input dtype, dR (B, H, t, nbasis) and
        db_nd (nbasis, bandsize) in float32, or None for both without R
    """
    if q.device.type == "cpu":
        return windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, use_muP_factor)
    if q.device.type != "cuda":
        raise ValueError(f"windowed_attention_bwd runs on cpu or cuda, not {q.device}")
    _check(q, k, v, mask, R, b_nd)
    if (dO.shape != q.shape or dO.dtype != q.dtype or dO.device != q.device or not dO.is_contiguous()
            or dO.data_ptr() % ALIGN):
        raise ValueError(f"dO must be a contiguous, {ALIGN}-byte aligned {q.dtype} {tuple(q.shape)} on {q.device}, "
                         f"got {dO.dtype} {tuple(dO.shape)} on {dO.device}")
    dq, dk, dv, dR, db = torch.ops.vpt_torch.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, use_muP_factor)
    return (dq, dk, dv, dR, db) if R is not None else (dq, dk, dv, None, None)
