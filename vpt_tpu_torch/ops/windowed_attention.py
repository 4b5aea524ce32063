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

On a CPU tensor each wrapper runs its plain PyTorch version
(``windowed_attention_fwd_plain``, differentiated by autograd, and
``windowed_attention_bwd_plain``).  On a CUDA tensor it launches its kernel
or raises: there is no shape or dtype it routes elsewhere.  ``launches``
counts B1's launches and ``bwd_launches`` B2's, so a run can show that its
path went through both.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vpt_tpu_torch.ops import cuda_build
from vpt_tpu_torch.ops.attention import NEG_BIAS, attention_alpha, windowed_attention
from vpt_tpu_torch.ops.rel_bias import banded_bias_matrix, relattn_bias

KERNEL = "windowed_attention_fwd"
BWD_KERNEL = "windowed_attention_bwd"
SUPPORTED_D = (64, 128, 192)
MAX_KEYS = 512
MAX_NBASIS = 16
QUERY_TILE = 32  # query rows per block of B2's first pass (csrc/windowed_attention_bwd.cu)

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
        # q k v R b_nd mask out | B H t T d nbasis bandsize is_bf16 | alpha stream
        fn.argtypes = [ptr] * 7 + [i32] * 8 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.vpt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load(BWD_KERNEL)
    fn = lib.vpt_windowed_attention_bwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # q k v dout R b_nd mask dq dk dv dR db stats partial | B H t T d nbasis bandsize is_bf16 | alpha stream
        fn.argtypes = [ptr] * 14 + [i32] * 8 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.vpt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, mask, R, b_nd) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, t, d), (B, H, T, d), (B, H, T, d)")
    B, H, t, d = q.shape
    T = k.shape[2]
    if k.shape != (B, H, T, d) or v.shape != (B, H, T, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if d not in SUPPORTED_D:
        raise ValueError(f"head dim {d} not supported by the kernel (supports {SUPPORTED_D})")
    if not 1 <= T <= MAX_KEYS:
        raise ValueError(f"key length {T} outside the kernel's range 1..{MAX_KEYS}")
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
        if b_nd.dtype != torch.float32 or b_nd.dim() != 2 or b_nd.shape[0] != n or b_nd.shape[1] > MAX_KEYS:
            raise ValueError(f"b_nd must be float32 ({n}, bandsize<={MAX_KEYS}), got {b_nd.dtype} {tuple(b_nd.shape)}")
        tensors += [R, b_nd]
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got one on {x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.vpt_cuda_error_string(err).decode()} ({err})")


def _launch_fwd(q, k, v, mask, R, b_nd, use_muP_factor: bool) -> torch.Tensor:
    _check(q, k, v, mask, R, b_nd)
    B, H, t, d = q.shape
    T = k.shape[2]
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vpt_windowed_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(R), _ptr(b_nd), _ptr(mask),
            out.data_ptr(), B, H, t, T, d,
            R.shape[-1] if R is not None else 0,
            b_nd.shape[1] if b_nd is not None else 0,
            int(q.dtype == torch.bfloat16), attention_alpha(d, use_muP_factor), stream,
        )
    _raise_on(lib, err, KERNEL)
    global launches
    launches += 1
    return out


class WindowedAttention(torch.autograd.Function):
    """B1 forward, B2 backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, mask, R, b_nd, use_muP_factor: bool):
        out = _launch_fwd(q, k, v, mask, R, b_nd, use_muP_factor)
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
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (q, k, v, R, b_nd)):
        return WindowedAttention.apply(q, k, v, mask, R, b_nd, use_muP_factor)
    return _launch_fwd(q, k, v, mask, R, b_nd, use_muP_factor)


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
    if dO.shape != q.shape or dO.dtype != q.dtype or dO.device != q.device or not dO.is_contiguous():
        raise ValueError(f"dO must be a contiguous {q.dtype} {tuple(q.shape)} on {q.device}, "
                         f"got {dO.dtype} {tuple(dO.shape)} on {dO.device}")
    B, H, t, d = q.shape
    T = k.shape[2]
    nbasis, bandsize = (R.shape[-1], b_nd.shape[1]) if R is not None else (0, 0)
    lib = _bwd_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    stats = torch.empty(3 * B * H * t, **f32)  # per query row: softmax max, sum, rowdot
    dR = db = partial = None
    if R is not None:
        dR, db = torch.empty_like(R), torch.empty_like(b_nd)
        blocks = B * H * ((t + QUERY_TILE - 1) // QUERY_TILE)
        partial = torch.empty(blocks * nbasis * bandsize, **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vpt_windowed_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(), _ptr(R), _ptr(b_nd), _ptr(mask),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dR), _ptr(db), stats.data_ptr(), _ptr(partial),
            B, H, t, T, d, nbasis, bandsize, int(q.dtype == torch.bfloat16),
            attention_alpha(d, use_muP_factor), stream,
        )
    _raise_on(lib, err, BWD_KERNEL)
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv, dR, db
