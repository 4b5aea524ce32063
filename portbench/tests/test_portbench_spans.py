"""The readers of the program's own spans and counters (portbench/spans.py
and the eight metrics that use it): on hand-built traces, where each
number is known; on the counters; and in a traced tiny run of each cell on
the CPU, where the host metrics read and the device ones have nothing to
read."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from portbench import manifest
from portbench.readers import B1_OP
from portbench.run import run_cell
from portbench.tests import tiny
from portbench.trace import WINDOW_SPAN, Trace
from vpt_tpu_torch.utils import profiling

SEED = 2 ** 31 + 777
NEW = {  # metric: its one cell
    "agent_prep_ms.serve": "policy2x.serve64_bf16", "agent_upload_ms.serve": "policy2x.serve64_bf16",
    "agent_unpack_ms.serve": "policy2x.serve64_bf16", "h2d_pageable_pct.serve": "policy2x.serve64_bf16",
    "labeler_stage_ms.label": "idm4x.label_resized_f32", "cnn_device_pct.label": "idm4x.label_resized_f32",
    "cnn_fwd_device_pct.train": "policy2x.bc_f32_b4", "optimizer_device_pct.train": "policy2x.bc_f32_b4",
}
HOST = {"serve": ["agent_prep_ms.serve", "agent_upload_ms.serve", "agent_unpack_ms.serve", "h2d_pageable_pct.serve"],
        "label": ["labeler_stage_ms.label"], "bc": []}
DEVICE = {"serve": [], "label": ["cnn_device_pct.label"],
          "bc": ["cnn_fwd_device_pct.train", "optimizer_device_pct.train"]}


def _reader(name):
    return manifest.load_module(manifest.metric_file(name), f"portbench_metric_{name}")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _span(name, ts, dur, tid=1):
    return _x(name, "user_annotation", ts, dur, tid)


def _kernel(corr, launch_ts, ts, dur, tid=1):
    """A launch on host thread ``tid`` and the kernel it launched."""
    return [_x("cudaLaunchKernel", "cuda_runtime", launch_ts, 1, tid, correlation=corr),
            _x(f"kernel_{corr}", "kernel", ts, dur, 99, correlation=corr)]


def _run(kind, events, ops=()):
    trace = Trace([_span(WINDOW_SPAN, 0, 100_000)] + events, ops)
    return SimpleNamespace(layer={"kind": kind}, trace_data=trace)


def test_the_new_metrics_are_declared_for_their_cell_alone():
    bench = manifest.load()
    assert manifest.problems(bench) == []
    got = {m["name"]: m for m in bench["per_layer"]}
    for name, cell in NEW.items():
        assert got[name]["workloads"] == [cell], name
    assert list(got)[-len(NEW):] == list(NEW)  # appended, after the ten that were there


def test_host_ms_readers_take_the_mean_span_inside_the_window():
    events = [_span("vpt_torch.agent.prep", 1_000, 12_000), _span("vpt_torch.agent.prep", 50_000, 18_000),
              _span("vpt_torch.agent.prep", 200_000, 90_000),  # after the window: not counted
              _span("vpt_torch.agent.upload", 13_000, 6_500), _span("vpt_torch.agent.unpack", 30_000, 1_500),
              _x("vpt_torch.agent.unpack", "cpu_op", 40_000, 9_000)]  # an operator of that name is no span
    run = _run("serve", events)
    assert _reader("agent_prep_ms.serve").read(run) == pytest.approx(15.0)
    assert _reader("agent_upload_ms.serve").read(run) == pytest.approx(6.5)
    assert _reader("agent_unpack_ms.serve").read(run) == pytest.approx(1.5)
    assert _reader("agent_prep_ms.serve").read(_run("label", events)) is None  # another cell's kind
    assert _reader("agent_prep_ms.serve").read(_run("serve", [])) is None  # a program without spans


def test_labeler_stage_is_host_staging_a_forward():
    events = [_span("vpt_torch.labeler.cut", 100 + 1_000 * i, 500) for i in range(8)]  # 8 windows cut: 4 ms
    events += [_span("vpt_torch.labeler.stack", 20_000, 7_000), _span("vpt_torch.labeler.stack", 60_000, 5_000),
               _span("vpt_torch.idm.upload", 30_000, 9_000), _span("vpt_torch.idm.upload", 70_000, 11_000)]
    assert _reader("labeler_stage_ms.label").read(_run("label", events)) == pytest.approx((4 + 12 + 20) / 2)
    assert _reader("labeler_stage_ms.label").read(_run("label", events[:10])) is None  # no forward uploaded


def test_device_readers_take_the_kernels_launched_inside_their_span():
    cnn = "vpt_torch.policy.cnn"
    events = [_span(cnn, 100, 300), *_kernel(1, 150, 200, 40), *_kernel(2, 250, 300, 40),
              *_kernel(3, 500, 500, 20),  # launched after the CNN
              *_kernel(4, 180, 180, 10, tid=2)]  # launched inside its interval, on another thread
    label = _reader("cnn_device_pct.label")
    assert label.OPS == (cnn,)
    assert label.read(_run("label", events, label.OPS)) == pytest.approx(100 * 80 / 110)
    train = _reader("cnn_fwd_device_pct.train")
    assert train.read(_run("train", events, train.OPS)) == pytest.approx(100 * 80 / 110)
    assert train.read(_run("train", events[2:], train.OPS)) is None  # no span: nothing to read
    opt = _reader("optimizer_device_pct.train")
    events = [_span("vpt_torch.bc.optimizer", 1_000, 400), *_kernel(1, 1_100, 1_100, 30), *_kernel(2, 0, 10, 270)]
    assert opt.read(_run("train", events, opt.OPS)) == pytest.approx(10.0)


def test_a_span_holding_b1_would_lose_the_kernels_after_it():
    """Why ``vpt_torch.policy.blocks`` is declared by no reader: trace.py
    gives a kernel to the latest-starting declared operator before its
    launch, so the blocks' kernels launched after a B1 call inside them
    would count for neither."""
    blocks = "vpt_torch.policy.blocks"
    events = [_span(blocks, 400, 300), _x(B1_OP, "cpu_op", 450, 100),
              *_kernel(1, 420, 420, 10), *_kernel(2, 500, 500, 20), *_kernel(3, 600, 600, 30)]
    both = _run("train", events, (B1_OP, blocks)).trace_data.ops
    assert both[B1_OP][0]["device_s"] == pytest.approx(20e-6)
    assert both[blocks][0]["device_s"] == pytest.approx(10e-6)  # not 60: the kernel after B1 is lost
    alone = _run("train", events, (blocks,)).trace_data.ops
    assert alone[blocks][0]["device_s"] == pytest.approx(60e-6)


def test_the_counter_reader_reads_the_programs_counters():
    reader = _reader("h2d_pageable_pct.serve")
    run = SimpleNamespace(layer={"kind": "serve"}, trace_data=_run("serve", []).trace_data)
    profiling.counters(reset=True)
    try:
        assert reader.read(run) is None  # nothing counted
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.count("h2d_bytes", 400)
            profiling.count("h2d_pageable_bytes", 100)
        assert reader.read(run) == pytest.approx(25.0)
        assert reader.read(SimpleNamespace(layer={"kind": "train"}, trace_data=run.trace_data)) is None
    finally:
        profiling.counters(reset=True)


@pytest.mark.parametrize("kind", ["bc", "serve", "label"])
def test_a_traced_tiny_run_reports_the_host_metrics(kind):
    profiling.counters(reset=True)
    try:
        result = run_cell(tiny.spec(kind), SEED, 2.0, True, device="cpu")
    finally:
        profiling.counters(reset=True)
    assert result["correct"], result["checks"]
    for name in HOST[kind]:
        assert result["metrics"][name]["value"] > 0, name
    for name in DEVICE[kind]:
        assert name not in result["metrics"], name  # no device on the CPU: nothing to read
    if kind == "serve":  # the raw frames and episode starts are plain numpy
        assert result["metrics"]["h2d_pageable_pct.serve"]["value"] == 100.0
    json.dumps(result)
