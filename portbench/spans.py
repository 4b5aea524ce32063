"""What the readers of the program's own spans and counters share
(``vpt_tpu_torch/utils/profiling.py``: ``vpt_torch.*`` spans and the
``h2d_*`` counters, recorded only while a profiler records, so only in the
trace run's profiled stretch).  A program that opens no such span or keeps
no such counter gives its readers nothing to read: they return None, and
the harness leaves the metric out."""

from __future__ import annotations

from typing import List, Optional


def durations_ms(run, kind: str, name: str) -> List[float]:
    """The duration of every ``name`` span that starts inside the profiled
    window, in ms."""
    t = run.trace_data
    if run.layer.get("kind") != kind or t is None:
        return []
    return [float(e["dur"]) * 1e-3 for e in t.cpu_ops
            if e.get("cat") == "user_annotation" and e.get("name") == name and t.t0 <= float(e["ts"]) <= t.t1]


def mean_ms(run, kind: str, name: str) -> Optional[float]:
    """The mean host time of a ``name`` span, in ms."""
    got = durations_ms(run, kind, name)
    return sum(got) / len(got) if got else None


def device_pct(run, kind: str, name: str) -> Optional[float]:
    """The device time of the kernels launched inside ``name`` spans (the
    reader declares ``OPS = (name,)``: trace.py attributes each kernel to
    the declared span that holds its launch, on the launching thread) over
    the profiled stretch's busy time, in percent."""
    t = run.trace_data
    if run.layer.get("kind") != kind or t is None or not t.busy_s:
        return None
    calls = t.ops.get(name, [])
    if not calls:
        return None
    return 100.0 * sum(c["device_s"] for c in calls) / t.busy_s


def counter_pct(run, kind: str, part: str, whole: str) -> Optional[float]:
    """``part`` over ``whole``, in percent, from the program's counters
    (``profiling.counters()``) after the run."""
    if run.layer.get("kind") != kind or run.trace_data is None:
        return None
    try:
        from vpt_tpu_torch.utils.profiling import counters
    except ImportError:  # a program that keeps no counters
        return None
    got = counters()
    if not got.get(whole):
        return None
    return 100.0 * got.get(part, 0) / got[whole]
