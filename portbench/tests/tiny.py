"""Tiny configurations and traffic for the benchmark's CPU tests: the
published graphs at widths a CPU runs in seconds."""

from __future__ import annotations

import copy

from portbench import manifest

POLICY = {"attention_heads": 4, "attention_mask_style": "clipped_causal", "attention_memory_size": 16, "hidsize": 64,
          "img_shape": [32, 32, 3], "impala_chans": [4, 8, 8], "impala_kwargs": {"post_pool_groups": 1},
          "impala_width": 1, "init_norm_kwargs": {"batch_norm": False, "group_norm_groups": 1},
          "n_recurrence_layers": 2, "pointwise_ratio": 4, "recurrence_type": "transformer", "timesteps": 8,
          "use_pre_lstm_ln": False}
IDM = {"hidsize": 64, "impala_width": 1, "impala_chans": [4, 8, 8], "img_shape": [32, 32, 8],
       "init_norm_kwargs": {"batch_norm": False, "group_norm_groups": 1}, "impala_kwargs": {"post_pool_groups": 1},
       "n_recurrence_layers": 2, "timesteps": 16, "attention_heads": 4, "attention_memory_size": 32,
       "recurrence_type": "transformer", "attention_mask_style": "none",
       "conv3d_params": {"inchan": 3, "outchan": 8, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]},
       "use_pre_lstm_ln": False}
TRAFFIC = {
    "bc": {"batch": 2, "chunk": 8, "compute_dtype": "float32", "episode_steps": [5, 12], "frame_pool": 16,
           "pool_batches": 4, "row_block": 1, "trace_units": 2},
    "serve": {"streams": 3, "compute_dtype": "float32", "frame_hw": [36, 64], "frame_pool": 8, "episode_steps": [5, 12],
              "check_streams": 2, "early_reset": 4, "max_check_steps": 64, "warmup_steps": 2, "trace_units": 5},
    "label": {"window": 16, "stride": 8, "window_batch": 2, "video_frames": 60, "frame_pool": 16, "check_labels": 12,
              "row_block": 2, "trace_units": 40},
}
CELLS = {"bc": "policy2x.bc_f32_b4", "serve": "policy2x.serve64_bf16", "label": "idm4x.label_resized_f32"}
# limits for the CPU's float32 at these widths, where the program and the reference agree to rounding
LIMITS = {"loss_gap": 1e-4, "grad_leaf_gap": 1e-3, "change_leaf_gap": 1e-3, "logp_gap": 1e-4, "value_gap": 1e-4,
          "decode_mismatches": 0, "label_logp_gap": 1e-4, "labels_uncompared": 0}


def spec(kind: str) -> dict:
    """The cell of ``kind``'s spec (manifest.resolve) with a tiny
    configuration, tiny traffic and the CPU's limits."""
    cell = CELLS[kind]
    out = copy.deepcopy(manifest.resolve(manifest.load(), cell))
    out["config"]["policy_kwargs"] = copy.deepcopy(IDM if kind == "label" else POLICY)
    out["traffic"].update(copy.deepcopy(TRAFFIC[kind]))
    out["cell"] = {"limits": dict(LIMITS)}
    return out
