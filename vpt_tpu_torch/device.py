"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means CUDA, and with no CUDA available that is an error, never a silent
fall back to the CPU.  Under a process group (parallel/mesh.py) a CUDA
device without an index is the rank's own card, ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vpt_tpu_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` → torch dtype."""
    if name == "float32":
        return torch.float32
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {name!r}")
