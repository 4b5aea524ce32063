"""Bilinear resize matching OpenCV's INTER_LINEAR bit-for-bit.

The VPT models are sensitive to the exact resizer ("For your sanity, do not
resize with any function than INTER_LINEAR", reference: agent.py:100-103), so
this reimplements cv2's uint8 INTER_LINEAR pipeline exactly.  The model was
reverse-engineered against cv2 5.0 and is validated bit-for-bit by
tests/test_resize.py (``cv2`` oracle fuzz over random sizes, plus the
reference's 640x360 -> 128x128 hot path):

  * sample mapping ``f = (float)((dst + 0.5) * (src / dst) - 0.5)`` — the
    fractional part is computed in float32, and is NOT clamped at the
    borders; only the gather *indices* are clamped (border replicate).  A
    destination row above/below the source therefore still blends two
    (identical, replicated) taps with its raw fractional weights, which
    matters because of the floor-based reduction below.
  * coefficients quantized to 11 fractional bits with round-half-even:
    ``a0 = rint((1.f - f) * 2048.f)``, ``a1 = rint(f * 2048.f)``.
  * horizontal pass: integer ``row = S[x0]*a0 + S[x1]*a1`` (int32, 11 frac
    bits, indices border-replicated).
  * vertical reduction (cv2's 8U kernel, both its scalar and SIMD forms):
    ``dst = (((b0*(r0>>4))>>16) + ((b1*(r1>>4))>>16) + 2) >> 2``.
    The two products are floored *separately*, which is why border rows
    come out biased low vs. naive rounding — reproducing that double floor
    is required for bit-exactness.

Three implementations, as in the JAX package:
  * ``resize_uint8_exact``: numpy fixed point on the host, bit-equal to the
    JAX package's host resize (tests/test_torch_actions.py holds the two
    together);
  * ``resize_bilinear``: a float bilinear in PyTorch tensor ops with cv2's
    half-pixel mapping, on any device (the agent's ``resize_on_device``),
    the counterpart of ``resize_bilinear_jnp``; at most 1 intensity step from
    the fixed-point result;
  * the native host resize (ops/host_resize.py, csrc/host_resize.cpp): the
    same fixed-point loop in C++, called without the GIL.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # 2048


@lru_cache(maxsize=64)
def _linear_coeffs(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-output-pixel (floor index, a0, a1) with cv2's exact quantization.

    The returned index is *unclamped* (may be -1 or src-1 at the borders);
    callers clamp the two gather indices independently (border replicate).
    """
    scale = src / dst
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    # cv2 quantizes via saturate_cast<short>(coef * 2048.f): float32 products,
    # round half to even.  f is in [0, 1) so saturation never triggers.
    a0 = np.rint(((np.float32(1.0) - f) * np.float32(COEF_SCALE)).astype(np.float32)).astype(np.int64)
    a1 = np.rint((f * np.float32(COEF_SCALE)).astype(np.float32)).astype(np.int64)
    return s, a0, a1


def resize_uint8_exact(img: np.ndarray, target_resolution: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) for uint8 images.

    Bit-exact with cv2.

    :param img: (H, W) or (H, W, C) uint8
    :param target_resolution: (width, height) — cv2 argument order
    """
    assert img.dtype == np.uint8
    dst_w, dst_h = target_resolution
    src_h, src_w = img.shape[:2]
    sx, ax0, ax1 = _linear_coeffs(src_w, dst_w)
    sy, by0, by1 = _linear_coeffs(src_h, dst_h)
    x0 = np.clip(sx, 0, src_w - 1)
    x1 = np.clip(sx + 1, 0, src_w - 1)
    y0 = np.clip(sy, 0, src_h - 1)
    y1 = np.clip(sy + 1, 0, src_h - 1)

    flat = img.reshape(src_h, src_w, -1).astype(np.int64)
    # horizontal pass → integer rows at 11 fractional bits
    rows = flat[:, x0] * ax0[None, :, None] + flat[:, x1] * ax1[None, :, None]
    # vertical pass: cv2's 8U reduction — the two products floor separately
    out = ((by0[:, None, None] * (rows[y0] >> 4)) >> 16) + (
        ((by1[:, None, None] * (rows[y1] >> 4)) >> 16) + 2
    )
    out = np.clip(out >> 2, 0, 255).astype(np.uint8)
    return out.reshape((dst_h, dst_w) + img.shape[2:])


def resize_bilinear(img: torch.Tensor, target_resolution: Tuple[int, int]) -> torch.Tensor:
    """Float bilinear with cv2's half-pixel mapping, on ``img``'s device.

    (..., H, W, C) of any float or uint dtype → float32 (..., h, w, C):
    cv2's taps and weights (``_linear_coeffs``, the weights as fractions of
    2048), gathered with ``index_select``, the horizontal pass first.
    ``target_resolution`` is (width, height).
    """
    dst_w, dst_h = target_resolution
    src_h, src_w = img.shape[-3], img.shape[-2]
    sx, ax0, _ = _linear_coeffs(src_w, dst_w)
    sy, by0, _ = _linear_coeffs(src_h, dst_h)

    def taps(s, n):
        return (torch.from_numpy(np.clip(s, 0, n - 1)).to(img.device),
                torch.from_numpy(np.clip(s + 1, 0, n - 1)).to(img.device))

    fax0 = torch.from_numpy((ax0 / COEF_SCALE).astype(np.float32)).to(img.device)
    fby0 = torch.from_numpy((by0 / COEF_SCALE).astype(np.float32)).to(img.device)
    x0, x1 = taps(sx, src_w)
    y0, y1 = taps(sy, src_h)
    x = img.float()
    rows = x.index_select(-2, x0) * fax0[:, None] + x.index_select(-2, x1) * (1.0 - fax0)[:, None]
    return rows.index_select(-3, y0) * fby0[:, None, None] + rows.index_select(-3, y1) * (1.0 - fby0)[:, None, None]


def resize_image(img: np.ndarray, target_resolution: Tuple[int, int]) -> np.ndarray:
    """Drop-in for the reference's resize_image (agent.py:100-103)."""
    return resize_uint8_exact(img, target_resolution)
