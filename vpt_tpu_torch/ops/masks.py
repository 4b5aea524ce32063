"""Attention masks for the clipped-causal fixed-window mechanism
(counterpart of vpt_tpu/ops/masks.py; reference lib/masked_attention.py:11-94).

Everything is expressed over the time-difference grid
``d(i, j) = (T - t) + i - j``: the number of steps key column ``j`` lies in
the past of query row ``i``.  ``first`` flags may be per chunk (B,) or per
timestep (B, t); with per-timestep flags a reset anywhere inside the chunk
blocks attention across it exactly as a t=1 stepped rollout would.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _time_difference_grid(t: int, T: int, device=None) -> torch.Tensor:
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return (T - t) + i - j


def band_diagonal_mask(t: int, T: int, maxlen: Optional[int], device=None) -> torch.Tensor:
    """(t, T) bool: True where query i may attend key j — causal (d >= 0)
    and windowed (d < maxlen)."""
    d = _time_difference_grid(t, T, device)
    m = d >= 0
    if maxlen is not None and maxlen < T:
        m = m & (d < maxlen)
    return m


def clipped_causal_mask(
    first: torch.Tensor,
    state_mask: torch.Tensor,
    t: int,
    T: int,
    maxlen: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full per-batch mask (B, t, T) plus the updated state mask (B, T - t).

    With reset counts ``c = cumsum(first)``: query i may attend in-chunk key
    j iff c[i] == c[j]; cached keys need c[i] == 0; a chunk step enters the
    carried state mask iff no later in-chunk reset, c[j] == c[t-1].

    :param first: (B,) or (B, t) bool episode-start flags
    :param state_mask: (B, T - t) bool validity of the cached past slots
    """
    first = first.bool()
    if first.ndim == 1:
        first_bt = torch.zeros((first.shape[0], t), dtype=torch.bool, device=first.device)
        first_bt[:, 0] = first
    else:
        assert first.shape[1] == t, (first.shape, t)
        first_bt = first
    b = first_bt.shape[0]
    n_past = T - t
    assert state_mask.shape == (b, n_past), (tuple(state_mask.shape), (b, n_past))

    c = torch.cumsum(first_bt.to(torch.int32), dim=1)  # (B, t) resets so far
    band = band_diagonal_mask(t, T, maxlen, first.device)
    m_chunk = band[None, :, n_past:] & (c[:, :, None] == c[:, None, :])
    if n_past > 0:
        m_past = band[None, :, :n_past] & state_mask[:, None, :] & (c[:, :, None] == 0)
        m = torch.cat([m_past, m_chunk], dim=2)
    else:
        m = m_chunk

    keep = min(t, n_past)
    c_last = c[:, -1:]
    chunk_valid = c == c_last
    new_state_mask = torch.cat(
        [state_mask[:, t:] & (c_last == 0), chunk_valid[:, t - keep:]], dim=1
    )
    return m, new_state_mask


def initial_state_mask(batch: int, maxlen: int, device=None) -> torch.Tensor:
    """All-invalid past: nothing in the zero-initialised cache may be attended."""
    return torch.zeros((batch, maxlen), dtype=torch.bool, device=device)
