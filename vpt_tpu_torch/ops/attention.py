"""Windowed multi-head attention, plain PyTorch (counterpart of
vpt_tpu/ops/attention.py; reference lib/xf.py:18-71).

Numerical contract:
  * logits in float32: ``bias + alpha · (Q @ Kᵀ)`` with ``alpha = 1/d`` under
    muP or ``1/sqrt(d)`` otherwise; the bias (mask −1e9 terms and relative
    logits) is NOT scaled by alpha;
  * the mask is an additive −1e9 (not −inf), so a fully masked row softmaxes
    to uniform weights exactly as in the reference;
  * softmax in float32 over the key axis, cast to V's dtype, then W · V.

This is the oracle of the CUDA kernel in ops/windowed_attention.py.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_BIAS = -1e9


def attention_alpha(d: int, use_muP_factor: bool) -> float:
    return (1.0 / d) if use_muP_factor else float(1.0 / math.sqrt(d))


def windowed_attention(
    q_bhtd: torch.Tensor,
    k_bhTd: torch.Tensor,
    v_bhTd: torch.Tensor,
    mask_btT: Optional[torch.Tensor],
    extra_bhtT: Optional[torch.Tensor],
    use_muP_factor: bool,
) -> torch.Tensor:
    """softmax(alpha·QKᵀ + bias)·V with float32 logits and softmax.

    :param q_bhtd: (B, H, t, d)
    :param k_bhTd, v_bhTd: (B, H, T, d)
    :param mask_btT: (B, t, T) bool or None
    :param extra_bhtT: (B, H, t, T) float32 extra logits (relattn) or None
    """
    alpha = attention_alpha(q_bhtd.shape[-1], use_muP_factor)
    logits = torch.matmul(q_bhtd.float(), k_bhTd.float().transpose(-1, -2)) * alpha
    if extra_bhtT is not None:
        logits = logits + extra_bhtT.float()
    if mask_btT is not None:
        logits = logits + torch.where(mask_btT[:, None], 0.0, NEG_BIAS)
    w = torch.softmax(logits, dim=-1).to(v_bhTd.dtype)
    return torch.matmul(w, v_bhTd)


def split_heads(x_bte: torch.Tensor, h: int) -> torch.Tensor:
    """(B, t, e) → (B, h, t, e/h), head-major channel split (reference
    lib/xf.py:96-103).  Returns a view."""
    b, t, e = x_bte.shape
    assert e % h == 0, "Embsize must be divisible by number of heads"
    return x_bte.reshape(b, t, h, e // h).transpose(1, 2)


def merge_heads(x_bhtd: torch.Tensor) -> torch.Tensor:
    """(B, h, t, d) → (B, t, h·d)."""
    b, h, t, d = x_bhtd.shape
    return x_bhtd.transpose(1, 2).reshape(b, t, h * d)
