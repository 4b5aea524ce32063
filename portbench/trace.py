"""The traced stretch: torch.profiler (CPU and CUDA activities, shapes
recorded) around a few steady units of work, its Chrome trace written under
``TMPDIR`` and read back into what the per-layer readers and the result's
``breakdown`` need.

* ``busy_s``: the union of the device's kernel, memcpy and memset intervals
  inside the window span (``portbench.window``);
* ``ops``: for each CPU operator of interest, every call's input shapes and
  types and the device time of the kernels launched inside it (a kernel
  belongs to the operator whose interval holds its launch, on the launching
  thread), so a kernel's work is read by operator and not by kernel name;
* ``breakdown``: the device operations by total time, each named with its
  category (the folding of vpt_tpu_torch/tools/profile_ops.py, copied
  here), and the idle gaps by what the host was doing: the benchmark's own
  span and the innermost operator running at the gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

CATEGORIES = (
    ("attention", re.compile(r"windowed_attention|bwd_rows|bwd_keys|db_reduce")),
    ("conv", re.compile(r"conv|fprop|dgrad|wgrad|winograd|implicit_gemm|implicit_convolve|nchwToNhwc|nhwcToNchw|"
                        r"fft|DSE::|pointwise_mult_and_sum_complex|cf32cf32|flip_filter|cudnn", re.I)),
    ("norm", re.compile(r"norm|welford|RowwiseMoments|ComputeFusedParams|ComputeInvStd|Moments|InternalGradients",
                        re.I)),
    ("gemm", re.compile(r"gemm|gemv|matmul|cutlass|cublas|splitKreduce|xmma|nvjet", re.I)),
    ("copy", re.compile(r"memcpy|memset|copy|cat_|CatArray|transpose|permute|gather|scatter|index", re.I)),
    ("reduction", re.compile(r"reduce|softmax|pool|cumsum|scan|argmax|topk|sort", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|pointwise|foreach|fill|where|multi_tensor", re.I)),
)


def category(kernel: str) -> str:
    for name, pattern in CATEGORIES:
        if pattern.search(kernel):
            return name
    return "other"


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the block (CPU and CUDA activities, shapes recorded) and
    yield a dict that holds, after the block, the path of its Chrome trace."""
    out: Dict[str, str] = {}
    if not enabled:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(WINDOW_SPAN):
            yield out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    out["path"] = path


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e["dur"])


class Trace:
    """A Chrome trace of the traced stretch, read for the readers."""

    def __init__(self, events: List[dict], ops_of_interest: Iterable[str] = ()):
        xs = [e for e in events if e.get("ph") == "X"]
        spans = [e for e in xs if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"the trace holds no {WINDOW_SPAN} span")
        w = spans[0]
        self.t0, self.t1 = float(w["ts"]), _end(w)
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.main_tid = w.get("tid")
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        clipped = [(max(self.t0, float(e["ts"])), min(self.t1, _end(e))) for e in self.device]
        self.busy = _union([(a, b) for a, b in clipped if b > a])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        self.cpu_ops = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")]
        self.ops = self._attribute(xs, set(ops_of_interest))

    @classmethod
    def load(cls, path: str, ops_of_interest: Iterable[str] = ()) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, ops_of_interest)

    def _attribute(self, xs: List[dict], names: set) -> Dict[str, List[dict]]:
        """{op name: [{"dims", "types", "device_s"}, ...]} for each call of
        the named operators inside the window."""
        calls: Dict[str, List[dict]] = {n: [] for n in names}
        by_tid: Dict[object, List[Tuple[float, float, dict]]] = {}
        for e in self.cpu_ops:
            if e.get("name") in names and self.t0 <= float(e["ts"]) <= self.t1:
                args = e.get("args", {})
                rec = {"dims": args.get("Input Dims", []), "types": args.get("Input type", []), "device_s": 0.0}
                calls[e["name"]].append(rec)
                by_tid.setdefault(e.get("tid"), []).append((float(e["ts"]), _end(e), rec))
        if not by_tid:
            return calls
        for spans in by_tid.values():
            spans.sort(key=lambda s: s[0])
        starts = {tid: [s[0] for s in spans] for tid, spans in by_tid.items()}
        launch = {e["args"]["correlation"]: (e.get("tid"), float(e["ts"])) for e in xs
                  if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        for k in self.device:
            where = launch.get(k.get("args", {}).get("correlation"))
            if where is None or where[0] not in by_tid:
                continue
            tid, ts = where
            spans = by_tid[tid]
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and ts <= spans[i][1]:  # the operators of interest do not nest in one another
                spans[i][2]["device_s"] += float(k["dur"]) * 1e-6
        return calls

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing."""
        totals: Dict[str, float] = {}
        for e in self.device:
            a, b = max(self.t0, float(e["ts"])), min(self.t1, _end(e))
            if b > a:
                key = f"{category(e['name'])}: {e['name'][:120]}"
                totals[key] = totals.get(key, 0.0) + (b - a) * 1e-6
        device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        main = sorted((e for e in self.cpu_ops if e.get("tid") == self.main_tid and e.get("name") != WINDOW_SPAN),
                      key=lambda e: float(e["ts"]))
        own = [e for e in main if e.get("cat") == "user_annotation" and e["name"].startswith("portbench.")]
        main_starts = [float(e["ts"]) for e in main]
        own_starts = [float(e["ts"]) for e in own]
        gaps: Dict[str, float] = {}
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                name = _host_doing(main, main_starts, own, own_starts, (a + b) / 2)
                gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in device_ops], "idle_gaps": [[k, v] for k, v in idle]}


def _holding(events: List[dict], starts: List[float], at: float, scan: int = 64) -> Optional[dict]:
    """The latest-starting event that holds ``at`` (the innermost, where
    events nest), looking back at most ``scan`` events."""
    i = bisect.bisect_right(starts, at) - 1
    for j in range(i, max(-1, i - scan), -1):
        if _end(events[j]) >= at:
            return events[j]
    return None


def _host_doing(main, main_starts, own, own_starts, at: float) -> str:
    inner = _holding(main, main_starts, at)
    span = _holding(own, own_starts, at)
    if inner is None:
        return f"{span['name']} > python" if span is not None else "host: outside the benchmark's spans"
    if span is None or span is inner:
        return inner["name"]
    return f"{span['name']} > {inner['name']}"


def read(path: Optional[str], ops_of_interest: Iterable[str] = ()) -> Optional[Trace]:
    """The trace at ``path``, which is deleted once read."""
    if not path:
        return None
    try:
        return Trace.load(path, ops_of_interest)
    finally:
        os.unlink(path)
