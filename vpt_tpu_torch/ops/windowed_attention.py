"""Fused windowed attention forward: kernel B1 (counterpart of
vpt_tpu/ops/pallas_attention.py and pallas_attention_impl.py, forward only).

``windowed_attention_fwd`` computes
``softmax(alpha·QKᵀ + Σ_n R[..,n]·D[n] + maskbias)·V`` from the raw relative
attention inputs (R coefficients and the b_nd band table), so the CUDA kernel
(csrc/windowed_attention_fwd.cu) forms the bias on the chip and neither the
(n, t, T) band table nor a (B, H, t, T) bias reaches device memory.

On a CPU tensor it runs ``windowed_attention_fwd_plain``, the same function
in plain PyTorch.  On a CUDA tensor it launches the kernel or raises: there
is no shape or dtype it routes elsewhere.  ``launches`` counts kernel
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vpt_tpu_torch.ops import cuda_build
from vpt_tpu_torch.ops.attention import attention_alpha, windowed_attention
from vpt_tpu_torch.ops.rel_bias import relattn_bias

KERNEL = "windowed_attention_fwd"
SUPPORTED_D = (64, 128, 192)
MAX_KEYS = 512
MAX_NBASIS = 16

launches = 0


def windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, use_muP_factor: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch: relattn bias, then the
    reference attention (ops/attention.py)."""
    extra = relattn_bias(R, b_nd, k.shape[2]) if R is not None else None
    return windowed_attention(q, k, v, mask, extra, use_muP_factor)


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
    :returns: (B, H, t, d) in q's dtype
    """
    if q.device.type == "cpu":
        return windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, use_muP_factor)
    if q.device.type != "cuda":
        raise ValueError(f"windowed_attention_fwd runs on cpu or cuda, not {q.device}")
    _check(q, k, v, mask, R, b_nd)
    B, H, t, d = q.shape
    T = k.shape[2]
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vpt_windowed_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            R.data_ptr() if R is not None else None,
            b_nd.data_ptr() if b_nd is not None else None,
            mask.data_ptr() if mask is not None else None,
            out.data_ptr(), B, H, t, T, d,
            R.shape[-1] if R is not None else 0,
            b_nd.shape[1] if b_nd is not None else 0,
            int(q.dtype == torch.bfloat16), attention_alpha(d, use_muP_factor), stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: {lib.vpt_cuda_error_string(err).decode()} ({err})")
    global launches
    launches += 1
    return out
