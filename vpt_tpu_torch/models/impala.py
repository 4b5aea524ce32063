"""Impala CNN vision trunk (counterpart of vpt_tpu/models/impala.py;
reference lib/impala_cnn.py).

The public ``ImpalaCNN.forward`` takes the JAX package's (B, T, H, W, C)
layout and folds (B, T) into one batch; inside, the stacks run NCHW, the
layout of PyTorch's convolutions.  The final flatten is channel-major
(C, H, W), so dense and LayerNorm weights line up with torch checkpoints.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vpt_tpu_torch.models.layers import REMAT_CNN_SPAN, FanInInitLayer, GroupNorm, remat_call


def fold_frames(x_bthwc: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) frames → (B·T, C, H, W), a view."""
    b, t = x_bthwc.shape[:2]
    return x_bthwc.reshape((b * t,) + tuple(x_bthwc.shape[2:])).permute(0, 3, 1, 2)


class CnnBasicBlock(nn.Module):
    """Residual pair of 3×3 convs (reference: impala_cnn.py:13-52)."""

    def __init__(self, inchan: int, init_scale: float = 1.0, batch_norm: bool = False,
                 group_norm_groups: Optional[int] = None, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        s = math.sqrt(init_scale)
        kw = dict(layer_type="conv", init_scale=s, batch_norm=batch_norm, group_norm_groups=group_norm_groups,
                  dtype=dtype, device=device)
        self.conv0 = FanInInitLayer(inchan, inchan, **kw)
        self.conv1 = FanInInitLayer(inchan, inchan, **kw)

    def forward(self, x):
        return x + self.conv1(self.conv0(x))


class CnnDownStack(nn.Module):
    """conv → maxpool(3, s2, pad 1) → optional GroupNorm → residual blocks
    (reference: impala_cnn.py:55-129)."""

    def __init__(self, inchan: int, outchan: int, nblock: int, init_scale: float = 1.0,
                 pool: bool = True, post_pool_groups: Optional[int] = None, batch_norm: bool = False,
                 group_norm_groups: Optional[int] = None, first_conv_norm: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.pool = pool
        self.firstconv = FanInInitLayer(
            inchan, outchan, layer_type="conv", batch_norm=batch_norm and first_conv_norm,
            group_norm_groups=group_norm_groups if first_conv_norm else None,
            dtype=dtype, device=device,
        )
        self.n = GroupNorm(post_pool_groups, outchan, device=device) if pool and post_pool_groups is not None else None
        self.blocks = nn.ModuleList([
            CnnBasicBlock(outchan, init_scale=init_scale / math.sqrt(nblock), batch_norm=batch_norm,
                          group_norm_groups=group_norm_groups, dtype=dtype, device=device)
            for _ in range(nblock)
        ])

    def forward(self, x):
        x = self.firstconv(x)
        if self.pool:
            x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
            if self.n is not None:
                x = self.n(x)
        for block in self.blocks:
            x = block(x)
        return x


class ImpalaCNN(nn.Module):
    """Stacked downsampling stages + channel-major flatten + dense
    (reference: impala_cnn.py:132-195).  With ``remat`` the backward
    recomputes each stack from its input instead of keeping its activations
    (vpt_tpu/models/impala.py remats each ``CnnDownStack`` the same way)."""

    def __init__(self, inshape: Sequence[int], chans: Sequence[int], outsize: int, nblock: int,
                 post_pool_groups: Optional[int] = None, batch_norm: bool = False,
                 group_norm_groups: Optional[int] = None, first_conv_norm: bool = False,
                 dense_layer_norm: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False, device=None):
        super().__init__()
        self.remat = remat
        h, w, c = inshape
        stacks = []
        for i, outchan in enumerate(chans):
            stacks.append(CnnDownStack(
                c, outchan, nblock, init_scale=math.sqrt(len(chans)),
                post_pool_groups=post_pool_groups, batch_norm=batch_norm, group_norm_groups=group_norm_groups,
                first_conv_norm=first_conv_norm if i == 0 else True, dtype=dtype, device=device,
            ))
            c, h, w = outchan, (h + 1) // 2, (w + 1) // 2
        self.stacks = nn.ModuleList(stacks)
        self.outsize = outsize
        self.dense = FanInInitLayer(c * h * w, outsize, layer_type="linear", init_scale=1.4,
                                    layer_norm=dense_layer_norm, dtype=dtype, device=device)

    def forward(self, x_bthwc: torch.Tensor) -> torch.Tensor:
        b, t = x_bthwc.shape[:2]
        return self.forward_nchw(fold_frames(x_bthwc)).reshape(b, t, self.outsize)

    def forward_nchw(self, x: torch.Tensor, remat: Optional[bool] = None) -> torch.Tensor:
        """(N, C, H, W) frames → (N, outsize); ``remat`` overrides the
        module's per-stack setting."""
        remat = self.remat if remat is None else remat
        for stack in self.stacks:
            x = remat_call(stack, x, span_name=REMAT_CNN_SPAN) if remat else stack(x)
        return self.dense(x.reshape(x.shape[0], -1))  # NCHW flatten is channel-major
