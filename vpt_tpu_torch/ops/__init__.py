"""Attention ops, masks, relative bias and resize.  The plain attention is
``ops.attention.windowed_attention``; kernel B1's wrapper is the submodule
``ops.windowed_attention``."""

from vpt_tpu_torch.ops.masks import band_diagonal_mask, clipped_causal_mask
from vpt_tpu_torch.ops.rel_bias import banded_bias_matrix, relattn_bias

__all__ = [
    "band_diagonal_mask",
    "clipped_causal_mask",
    "banded_bias_matrix",
    "relattn_bias",
]
