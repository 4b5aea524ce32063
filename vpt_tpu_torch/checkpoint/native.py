"""Native checkpoints: train state and data cursor, safe to take mid-run
(counterpart of vpt_tpu/checkpoint/native.py).

A checkpoint is the directory ``<directory>/step_<n>``, the layout of the
JAX package's, holding

  * ``payload.pt``: a ``torch.save``'d dict of CPU tensors and plain values
    (``variables``: model state_dicts; ``opt_state``: the optimizer's
    state_dict; ``rng_state``: generator states; ``extra``: whatever else a
    trainer carries, such as the streams' recurrent state);
  * ``data_state.json``: the data cursor and counters, as JSON.

A save writes into a hidden temporary directory beside the checkpoints and
renames it into place, so a run killed mid-save leaves the last complete
step (and a ``.tmp_step_<n>`` directory, which ``latest_step`` ignores and
the next save of that step replaces).  ``keep`` prunes to the newest steps.

The port reads and writes only its own checkpoints: ``vpt_tpu``'s are orbax
trees of JAX arrays, and this package imports neither orbax nor JAX.  To
carry weights across, export a ``.weights`` file.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

PAYLOAD = "payload.pt"
DATA_STATE = "data_state.json"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(name.split("_", 1)[1]) for name in os.listdir(directory)
                  if name.startswith("step_") and name.split("_", 1)[1].isdigit())


def save_checkpoint(
    directory: str,
    step: int,
    variables: Dict,
    opt_state: Any = None,
    data_state: Optional[Dict] = None,
    rng_state: Any = None,
    extra: Any = None,
    keep: int = 3,
) -> str:
    """Write ``directory/step_<step>`` (replacing one of that step) and prune
    to the newest ``keep``; returns its path.  Tensors are saved from the
    CPU, so a restore places them where the caller wants."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}")
    tmp = os.path.join(directory, f".tmp_step_{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    payload = {"variables": _to_cpu(variables)}
    for key, value in (("opt_state", opt_state), ("rng_state", rng_state), ("extra", extra)):
        if value is not None:
            payload[key] = _to_cpu(value)
    torch.save(payload, os.path.join(tmp, PAYLOAD))
    if data_state is not None:
        with open(os.path.join(tmp, DATA_STATE), "w") as f:
            json.dump(data_state, f)
    if os.path.exists(path):  # the same step again: the old one goes only once the new one is whole
        old = os.path.join(directory, f".old_step_{step}")
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)
    _prune(directory, keep)
    return path


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None) -> Tuple[Optional[Dict], Optional[Dict]]:
    """``(payload, data_state)`` of ``directory``'s checkpoint at ``step``
    (the latest by default), tensors on the CPU; ``(None, None)`` where
    there is none."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    payload = torch.load(os.path.join(path, PAYLOAD), map_location="cpu", weights_only=True)
    return payload, _read_data_state(path)


def _read_data_state(path: str) -> Optional[Dict]:
    ds_path = os.path.join(path, DATA_STATE)
    if not os.path.exists(ds_path):
        return None
    with open(ds_path) as f:
        return json.load(f)


def save_data_state(directory: str, step: int, data_state: Dict, keep: int = 3) -> str:
    """Write only a data cursor, as ``directory/step_<step>/data_state.json``."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, DATA_STATE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(data_state, f)
    os.replace(tmp, os.path.join(path, DATA_STATE))
    _prune(directory, keep)
    return path


def restore_data_state(directory: str, step: Optional[int] = None) -> Optional[Dict]:
    """The cursor :func:`save_data_state` wrote (the latest by default)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    return _read_data_state(os.path.join(os.path.abspath(directory), f"step_{step}"))


def _prune(directory: str, keep: int) -> None:
    steps = _steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
