"""Strided (dilated-window) sparse attention (counterpart of
vpt_tpu/ops/strided_attention.py; reference lib/xf.py:141-216, the dormant
``StridedAttn`` no published model uses).

A query at absolute time i may attend the key at absolute time j iff
d = i - j satisfies d >= 0, d % stride == 0 and d // stride < maxlen: its
own step and the ``maxlen - 1`` previous steps of the same phase.  The
pattern is a (t, T) boolean mask over the dense attention, so on CUDA it
runs through kernel B1 forward and kernel B2 backward as any mask does
(``windowed_attention_fwd`` with the mask alone; counted in ``launches``
and ``bwd_launches``).  With an extra (B, H, t, T) logit tensor, which B1
does not take, the attention is ``ops/attention.py``'s tensor ops, as the
JAX package computes the whole function with XLA (no Pallas kernel); no
path of the port passes one.
"""

from __future__ import annotations

from typing import Optional

import torch

from vpt_tpu_torch.ops.attention import windowed_attention
from vpt_tpu_torch.ops.windowed_attention import windowed_attention_fwd


def strided_mask(t: int, T: int, stride: int, maxlen: int, device=None) -> torch.Tensor:
    """(t, T) boolean dilated causal-window mask (the queries are the last t
    of the T keys)."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    d = (T - t) + i - j
    return (d >= 0) & (d % stride == 0) & (d // stride < maxlen)


def strided_attention(
    q_bhtd: torch.Tensor,
    k_bhTd: torch.Tensor,
    v_bhTd: torch.Tensor,
    stride: int,
    maxlen: int,
    extra_bhtT: Optional[torch.Tensor] = None,
    use_muP_factor: bool = False,
) -> torch.Tensor:
    """Dilated windowed attention: the strided pattern as a dense mask.

    :param q_bhtd: (B, H, t, d); k_bhTd, v_bhTd: (B, H, T, d)
    :param extra_bhtT: optional (B, H, t, T) float32 extra logits
    """
    B, t, T = q_bhtd.shape[0], q_bhtd.shape[2], k_bhTd.shape[2]
    mask = strided_mask(t, T, stride, maxlen, q_bhtd.device)[None].expand(B, t, T).contiguous()
    if extra_bhtT is not None:
        return windowed_attention(q_bhtd, k_bhTd, v_bhTd, mask, extra_bhtT, use_muP_factor)
    return windowed_attention_fwd(q_bhtd, k_bhTd, v_bhTd, mask, None, None, use_muP_factor)
