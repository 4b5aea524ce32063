"""Profiling and activation-statistics taps (counterpart of
vpt_tpu/utils/profiling.py).

  * ``profile_trace``: a ``torch.profiler`` context over the host and the
    card that writes a Chrome trace into a directory
    (tools/profile_ops.py ranks its CUDA kernels);
  * ``span``, ``count``, ``count_h2d`` and ``counters``: the program's own
    spans (``vpt_torch.<layer>.<part>``: the agent's dispatch and collect,
    the labeler's staging and wait, the BC step's parts, the policy's CNN,
    blocks and heads, the backward's recompute of a remat'd CNN chunk or
    stack and of a block) and integer counters (``h2d_bytes``,
    ``h2d_pageable_bytes``, ``remat_recomputes``, and ``conv_flops`` and
    ``conv_tc_flops``: the FLOPs of every conv forward of the CNN and of
    those kernel C1 ran, counted at ``models.layers.FanInInitLayer``),
    recorded only while a ``torch.profiler`` session records.  With no profiler a span is one
    check of well under a microsecond and a shared null context, and a
    count adds nothing.  A
    span is a ``record_function`` range, so it lands in the session's
    Chrome trace on the clock of its kernels and copies; the trace keeps a
    span's name and times but not its arguments, so spans of one request
    are told apart by their nesting on one thread and their order (the
    k-th ``vpt_torch.idm.upload`` pairs with the k-th
    ``vpt_torch.labeler.wait``: groups are harvested in order).
  * ``activation_stats``: the reference's "activation_mean/<scope>",
    "activation_std/<scope>" statistics of any nest of tensors, named as the
    JAX package names them;
  * ``compiled_flops``: the FLOPs of one call, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
    convolutions; elementwise work counts nothing).  Kernels B1 and B2 are
    operators with registered FLOP formulas (ops/windowed_attention.py), so
    the counter counts them too.

An operator gets the spans and counters by running the program inside
``profile_trace``::

    from vpt_tpu_torch.utils import profiling

    with profiling.profile_trace("traces"):
        for _ in range(8):
            agent.get_action(obs)
    print(profiling.counters(reset=True))   # {"h2d_bytes": ..., "h2d_pageable_bytes": ...}

then opens ``traces/trace-*.json`` in ``chrome://tracing`` or Perfetto:
the ``vpt_torch.*`` ranges sit on the host thread that ran them, above
the aten operators and CUDA launches they hold.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

_NULL = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()


def span(name: str):
    """A context manager over a part of the program: a ``record_function``
    range named ``name`` while a profiler records, a shared null context
    otherwise (``record_function`` itself costs microseconds even when
    nothing records)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        with _counts_lock:
            _counts[name] = _counts.get(name, 0) + int(n)


def count_h2d(*tensors: torch.Tensor) -> None:
    """Count the bytes of the host tensors among ``tensors``, about to be
    copied to the device, under ``h2d_bytes``, and under
    ``h2d_pageable_bytes`` too where a tensor is not pinned (its copy blocks
    the host), while a profiler records.  Tensors already on a device count
    nothing; on a CPU device the copy is none, but the bytes count as on
    the card."""
    if not torch.autograd._profiler_enabled():
        return
    for t in tensors:
        if t.device.type != "cpu":
            continue
        n = t.numel() * t.element_size()
        count("h2d_bytes", n)
        if not t.is_pinned():
            count("h2d_pageable_bytes", n)


def counters(reset: bool = False) -> Dict[str, int]:
    """The counters so far (a copy); ``reset`` clears them."""
    with _counts_lock:
        out = dict(_counts)
        if reset:
            _counts.clear()
    return out


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
