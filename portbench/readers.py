"""What the per-layer metric readers share (each metric's own reader is
``metrics/<name>.py``).  A reader returns None where its run has nothing to
read, and the harness then leaves the metric out of the result."""

from __future__ import annotations

from typing import Optional

from portbench import work

B1_OP = "vpt_torch::windowed_attention_fwd"
B2_OP = "vpt_torch::windowed_attention_bwd"


def mfu(run, kind: str) -> Optional[float]:
    """The whole step's model FLOPs a second over the tensor-core peak of
    the cell's input type, in percent, from the trace run's untraced
    stretch."""
    if run.layer.get("kind") != kind or not run.layer.get("flops_per_s"):
        return None
    return 100.0 * run.layer["flops_per_s"] / run.layer["peak"]


def device_idle(run, kind: str) -> Optional[float]:
    """The share of the profiled stretch in which nothing ran on the device."""
    t = run.trace_data
    if run.layer.get("kind") != kind or t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _dtype(types) -> str:
    return "bfloat16" if types and "BFloat16" in str(types[0]) else "float32"


def roofline(run, kind: str, op: str) -> Optional[float]:
    """The least time of every call of ``op`` in the profiled stretch (from
    each call's recorded shapes, work.py) over the device time of the
    kernels launched inside those calls, in percent."""
    t = run.trace_data
    if run.layer.get("kind") != kind or t is None:
        return None
    calls = [c for c in t.ops.get(op, []) if c["device_s"] > 0 and c["dims"]]
    if not calls:
        return None
    least = work.b1_least_ms if op == B1_OP else work.b2_least_ms
    need = sum(least(c["dims"][0], c["dims"][1], c["dims"][3], c["dims"][4], c["dims"][5], _dtype(c["types"]))
               for c in calls) * 1e-3
    return 100.0 * need / sum(c["device_s"] for c in calls)
