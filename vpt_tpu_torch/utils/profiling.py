"""Profiling and activation-statistics taps (counterpart of
vpt_tpu/utils/profiling.py).

  * ``profile_trace``: a ``torch.profiler`` context over the host and the
    card that writes a Chrome trace into a directory
    (tools/profile_ops.py ranks its CUDA kernels);
  * ``activation_stats``: the reference's "activation_mean/<scope>",
    "activation_std/<scope>" statistics of any nest of tensors, named as the
    JAX package names them;
  * ``compiled_flops``: the FLOPs of one call, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
    convolutions; elementwise work counts nothing).  Kernels B1 and B2 are
    operators with registered FLOP formulas (ops/windowed_attention.py), so
    the counter counts them too.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the host and, where there is one, the card, and write the trace
    to ``logdir/trace-<pid>-<time>.json`` (Chrome trace format) on exit.
    Yields the profiler, whose ``events()`` the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _leaves(tree, path=()):
    """(path names, leaf) in jax.tree_util's order and spelling: dict keys
    sorted and by their key, sequence indices as "[i]"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    elif tree is not None:
        yield path, tree


def activation_stats(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"activation_mean/<path>", "activation_std/<path>"} over a nest of
    dicts, lists and tuples of tensors; the std is the population one, as
    ``jnp.std``."""
    out = {}
    for path, leaf in _leaves(tree):
        name = prefix + "/".join(path)
        leaf = torch.as_tensor(leaf).float()
        out[f"activation_mean/{name}"] = leaf.mean()
        out[f"activation_std/{name}"] = leaf.std(unbiased=False)
    return out


def compiled_flops(fn, *args) -> Optional[float]:
    """FLOPs of one call ``fn(*args)``, which runs: the matrix products,
    convolutions and attention kernels it dispatches, forward and backward.
    None where nothing was counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops()) or None
