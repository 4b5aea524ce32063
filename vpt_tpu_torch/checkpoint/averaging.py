"""Checkpoint weight averaging (counterpart of vpt_tpu/checkpoint/averaging.py):
the mean of N ``.weights`` state_dicts, e.g. to tail-average BC fine-tunes.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch

from vpt_tpu_torch.checkpoint.torch_import import load_weights


def average_state_dicts(state_dicts: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Arithmetic mean of matching tensors, summed in float64 and cast back
    to the first state_dict's dtype; the keys must agree across inputs."""
    if not state_dicts:
        raise ValueError("need at least one state_dict")
    keys = set(state_dicts[0])
    for sd in state_dicts[1:]:
        if set(sd) != keys:
            raise ValueError(f"state_dict keys differ: {sorted(keys ^ set(sd))}")
    out = {}
    for k in state_dicts[0]:
        acc = torch.zeros_like(torch.as_tensor(state_dicts[0][k]), dtype=torch.float64)
        for sd in state_dicts:
            acc += torch.as_tensor(sd[k]).to(torch.float64)
        out[k] = (acc / len(state_dicts)).to(torch.as_tensor(state_dicts[0][k]).dtype)
    return out


def load_average(paths: List[str], device="cpu") -> Dict[str, torch.Tensor]:
    """Average several ``.weights`` files into one state_dict, on ``device``."""
    return average_state_dicts([{k: v.to(device) for k, v in load_weights(p).items()} for p in paths])
