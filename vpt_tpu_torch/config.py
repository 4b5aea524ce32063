"""Typed configuration for the VPT policy (counterpart of vpt_tpu/config.py).

``PolicyConfig.from_kwargs`` accepts a raw kwargs dict from a ``.model``
pickle and ignores keys it does not know, as the reference's
``MinecraftPolicy.__init__`` swallows ``**unused_kwargs``.  The memory
fields ``remat`` and ``cnn_scan_chunks`` and the int8 serving field
``quantize_dense`` are the JAX package's; its TPU-only ``pool_impl`` is not
here: ``from_kwargs`` ignores it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


def _tupled(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tupled(v) for v in x)
    return x


@dataclass(frozen=True)
class PolicyConfig:
    """Architecture config for MinecraftPolicy (reference: lib/policy.py:96-188)."""

    # Vision trunk
    impala_width: int = 1
    impala_chans: Tuple[int, ...] = (16, 32, 32)
    obs_processing_width: int = 256
    img_shape: Tuple[int, int, int] = (128, 128, 3)
    scale_input_img: bool = True
    img_statistics: Optional[str] = None
    first_conv_norm: bool = False
    impala_post_pool_groups: Optional[int] = None
    impala_nblock: int = 2

    # Norm style for conv layers (init_norm_kwargs)
    batch_norm: bool = False
    group_norm_groups: Optional[int] = None

    # Core / recurrence
    hidsize: int = 512
    recurrence_type: str = "lstm"
    n_recurrence_layers: int = 1
    recurrence_is_residual: bool = True
    timesteps: Optional[int] = None
    use_pre_lstm_ln: bool = True

    # Transformer
    attention_heads: int = 8
    attention_memory_size: int = 2048
    attention_mask_style: str = "clipped_causal"
    use_pointwise_layer: bool = True
    pointwise_ratio: int = 4
    pointwise_use_activation: bool = False

    # IDM conv3d front end (reference: policy.py:361-372), e.g. {"inchan": 3,
    # "outchan": 128, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]}
    conv3d_params: Optional[Dict[str, Any]] = None

    # Rematerialization: the backward recomputes each Impala stack and each
    # transformer block from its input (torch.utils.checkpoint) instead of
    # keeping their activations; memory for FLOPs.
    remat: bool = False

    # Run the (B·T)-folded Impala CNN as a loop over this many frame chunks
    # (0 = off), each chunk's whole CNN checkpointed under ``remat``: the
    # CNN's activations then live for (B·T / chunks) frames at a time.
    cnn_scan_chunks: int = 0

    # "float32" or "bfloat16".  Parameters stay float32; attention logits and
    # softmax, layer norms and the head log-softmax stay float32 regardless.
    compute_dtype: str = "float32"

    # Int8 serving: the trunk's dense layers (q/k/v/proj/r, MLPs, the
    # CNN→hidsize projection, lastlayer) hold int8 weights with dynamic
    # per-row activation quantization (ops/int8.py).  Serving only: the
    # state_dict is derived from a float one by ops.int8.quantize_state_dict.
    quantize_dense: bool = False

    @property
    def chans(self) -> Tuple[int, ...]:
        return tuple(int(self.impala_width * c) for c in self.impala_chans)

    @property
    def maxlen(self) -> int:
        """Attention window: memory_size - timesteps (reference: masked_attention.py:137)."""
        return self.attention_memory_size - (self.timesteps or 0)

    @property
    def dense_use_layer_norm(self) -> bool:
        """Dense layers swap group/batch norm for layer norm (reference: policy.py:145-151)."""
        return self.group_norm_groups is not None or self.batch_norm

    @classmethod
    def from_kwargs(cls, kwargs: Dict[str, Any]) -> "PolicyConfig":
        """Build from a raw ``.model`` kwargs dict, ignoring unknown keys."""
        kwargs = dict(kwargs)
        init_norm = kwargs.pop("init_norm_kwargs", {}) or {}
        impala_kwargs = kwargs.pop("impala_kwargs", {}) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        out: Dict[str, Any] = {k: _tupled(v) for k, v in kwargs.items() if k in known}
        out["batch_norm"] = bool(init_norm.get("batch_norm", False))
        out["group_norm_groups"] = init_norm.get("group_norm_groups", None)
        out["impala_post_pool_groups"] = impala_kwargs.get("post_pool_groups", None)
        if "nblock" in impala_kwargs:
            out["impala_nblock"] = impala_kwargs["nblock"]
        return cls(**out)

    def replace(self, **kw) -> "PolicyConfig":
        return dataclasses.replace(self, **kw)


# Fallback defaults matching the published foundation models
# (reference: agent.py:16-36 POLICY_KWARGS, PI_HEAD_KWARGS).  This is the 2x
# model: hidsize 2048, 16 heads, 4 blocks, Impala width 8.
FOUNDATION_POLICY_KWARGS: Dict[str, Any] = dict(
    attention_heads=16,
    attention_mask_style="clipped_causal",
    attention_memory_size=256,
    diff_mlp_embedding=False,
    hidsize=2048,
    img_shape=[128, 128, 3],
    impala_chans=[16, 32, 32],
    impala_kwargs={"post_pool_groups": 1},
    impala_width=8,
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    n_recurrence_layers=4,
    only_img_input=True,
    pointwise_ratio=4,
    pointwise_use_activation=False,
    recurrence_is_residual=True,
    recurrence_type="transformer",
    timesteps=128,
    use_pointwise_layer=True,
    use_pre_lstm_ln=False,
)

FOUNDATION_PI_HEAD_KWARGS: Dict[str, Any] = dict(temperature=2.0)

AGENT_RESOLUTION = (128, 128)  # (width, height) of the agent's frames (reference: agent.py:14)

# Camera quantizer settings (reference: agent.py:40-45)
ACTION_TRANSFORMER_KWARGS: Dict[str, Any] = dict(
    camera_binsize=2,
    camera_maxval=10,
    camera_mu=10,
    camera_quantization_scheme="mu_law",
)


# The 4x-width inverse dynamics model (a copy of the root bench.py's
# IDM_4X_KWARGS): hidsize 4096, 32 heads, 2 blocks, Impala width 16, a conv3d
# front of 3 -> 128 channels, unmasked attention; 0.482 B parameters.  The
# published 4x_idm.model ships its own kwargs; in the reference's convention
# img_shape[2] declares the conv3d's OUTPUT channels (see idm_input_shape).
IDM_4X_KWARGS: Dict[str, Any] = dict(
    hidsize=4096,
    impala_width=16,
    impala_chans=[16, 32, 32],
    img_shape=[128, 128, 128],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2,
    timesteps=128,
    attention_heads=32,
    attention_memory_size=256,
    recurrence_type="transformer",
    attention_mask_style="none",
    conv3d_params={"inchan": 3, "outchan": 128, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]},
    use_pre_lstm_ln=False,
)


def foundation_policy_config(width: int = 1, **overrides) -> PolicyConfig:
    """Config of the published foundation policy at a width multiple:
    1x is hidsize 1024 / impala_width 4, scaling linearly."""
    cfg = PolicyConfig.from_kwargs(FOUNDATION_POLICY_KWARGS)
    return cfg.replace(hidsize=1024 * width, impala_width=4 * width, **overrides)
