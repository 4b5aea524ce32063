"""Learned banded relative-position bias (counterpart of vpt_tpu/ops/rel_bias.py;
reference lib/xf.py:259-271 relattn, lib/util.py:232-267 bandify).

A table ``b_nd`` of ``nbasis × maxlen`` entries expands to D (nbasis, t, T)
with ``D[n, i, j] = b_nd[n, (T - t) + i - j]`` on the band
``0 <= (T - t) + i - j < maxlen`` and 0 elsewhere; the per-head bias is
``Σ_n R[..., n] · D[n]``.  This is the plain version: the CUDA kernel
(ops/windowed_attention.py) forms the same bias from b_nd without D.
"""

from __future__ import annotations

import torch


def banded_bias_matrix(b_nd: torch.Tensor, t: int, T: int) -> torch.Tensor:
    """(nbasis, t, T) banded expansion of b_nd over the time-difference grid."""
    bandsize = b_nd.shape[-1]
    i = torch.arange(t, device=b_nd.device)[:, None]
    j = torch.arange(T, device=b_nd.device)[None, :]
    d = (T - t) + i - j
    valid = (d >= 0) & (d < bandsize)
    idx = d.clamp(0, max(bandsize - 1, 0))
    return torch.where(valid[None], b_nd[:, idx], torch.zeros((), dtype=b_nd.dtype, device=b_nd.device))


def relattn_bias(R_bhtn: torch.Tensor, b_nd: torch.Tensor, T: int) -> torch.Tensor:
    """(B, H, t, nbasis) coefficients × band table → (B, H, t, T) float32 logits."""
    t = R_bhtn.shape[2]
    D_ntT = banded_bias_matrix(b_nd.float(), t, T)
    return torch.einsum("bhtn,ntT->bhtT", R_bhtn.float(), D_ntT)
