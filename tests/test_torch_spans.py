"""The port's own spans and counters (vpt_tpu_torch/utils/profiling.py), at
tiny widths on the CPU:

  * under ``profile_trace`` one ``MineRLAgent.get_action`` at 2 streams, one
    ``StreamingIDMLabeler`` video through ``finish()`` and one
    ``BCTrainer.train_step`` export every ``vpt_torch.*`` span, nested as
    the agent, the policies and the trainer open them, all on the calling
    thread;
  * with no profiler recording, a span never enters ``record_function``
    and a count adds nothing;
  * the ``h2d_*`` counters count the bytes of an agent step's and a BC
    step's copies to the device, pinned against pageable."""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import glob
import json
import os

import numpy as np
import pytest
import torch

from vpt_tpu_torch.agent import IDMAgent, MineRLAgent
from vpt_tpu_torch.agent.idm import StreamingIDMLabeler
from vpt_tpu_torch.training.bc import TRAIN_KEYS, BCTrainer, batch_to_tensors
from vpt_tpu_torch.utils import profiling

TINY_KWARGS = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], img_shape=[32, 32, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1}, impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2, timesteps=4, attention_heads=4, attention_memory_size=8,
    recurrence_type="transformer", attention_mask_style="clipped_causal", use_pre_lstm_ln=False,
)
IDM_TINY_KWARGS = dict(
    TINY_KWARGS, img_shape=[32, 32, 8], timesteps=8, attention_memory_size=16, attention_mask_style="none",
    conv3d_params={"inchan": 3, "outchan": 8, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]},
)
RAW_HW = (36, 64)

AGENT_SPANS = ["dispatch", "prep", "upload", "resize", "sample", "collect", "download", "unpack"]
POLICY_SPANS = ["cnn", "blocks", "heads"]
LABELER_SPANS = ["labeler.cut", "labeler.stack", "idm.upload", "labeler.wait", "labeler.emit"]
BC_SPANS = ["to_device", "forward", "backward", "optimizer"]
ALL_SPANS = ({f"vpt_torch.agent.{s}" for s in AGENT_SPANS} | {f"vpt_torch.policy.{s}" for s in POLICY_SPANS}
             | {f"vpt_torch.{s}" for s in LABELER_SPANS} | {f"vpt_torch.bc.{s}" for s in BC_SPANS})


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():  # another module of the suite turns grad mode off when pytest imports it
        yield


@pytest.fixture(scope="module")
def programs():
    agent = MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, batch_size=2, resize_on_device=True)
    idm = IDMAgent(IDM_TINY_KWARGS, {}, device="cpu")
    trainer = BCTrainer(TINY_KWARGS, {}, device="cpu")
    return agent, idm, trainer


def _obs(rng):
    return [{"pov": rng.integers(0, 256, (*RAW_HW, 3), dtype=np.uint8)} for _ in range(2)]


def _batch(rng, b=2, t=4):
    return {"frames": rng.integers(0, 256, (b, t, 32, 32, 3), dtype=np.uint8),
            "buttons": rng.integers(0, 2, (b, t)), "camera": rng.integers(0, 121, (b, t)),
            "firsts": np.zeros((b, t), bool), "mask": np.ones((b, t), bool)}


def _drive(agent, idm, trainer, rng):
    """One agent step, one 14-frame video labeled through finish(), one BC step."""
    agent.get_action(_obs(rng))
    labeler = StreamingIDMLabeler(idm, window=8, stride=4, window_batch=2)
    labels = []
    for _ in range(14):
        labels += labeler.feed_resized(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    labels += labeler.finish()
    assert [i for i, _ in labels] == list(range(14))
    trainer.train_step(_batch(rng), trainer.initial_state(2))


def _spans(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("vpt_torch.")]


def _inside(inner, outers):
    a, b = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    return any(o["tid"] == inner["tid"] and float(o["ts"]) <= a and b <= float(o["ts"]) + float(o["dur"])
               for o in outers)


def test_a_profiled_run_exports_every_span_nested(programs, tmp_path):
    rng = np.random.default_rng(0)
    with profiling.profile_trace(str(tmp_path)):
        _drive(*programs, rng)
    profiling.counters(reset=True)
    spans = _spans(tmp_path)
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    assert set(by) == ALL_SPANS
    assert len({e["tid"] for e in spans}) == 1  # all on the calling thread
    dispatch = by["vpt_torch.agent.dispatch"]
    for part in ("prep", "upload", "resize", "sample"):
        assert all(_inside(e, dispatch) for e in by[f"vpt_torch.agent.{part}"]), part
    for part in ("download", "unpack"):
        assert all(_inside(e, by["vpt_torch.agent.collect"]) for e in by[f"vpt_torch.agent.{part}"]), part
    # the policies' parts: inside the agent's step, the BC forward, or an IDM forward after its upload
    owners = dispatch + by["vpt_torch.bc.forward"]
    for part in POLICY_SPANS:
        got = by[f"vpt_torch.policy.{part}"]
        assert len(got) == 1 + 1 + len(by["vpt_torch.idm.upload"]), part
        assert sum(_inside(e, owners) for e in got) == 2, part
    # the harvested group's wait inside its emission; the tail window's, from finish(), outside
    assert [_inside(e, by["vpt_torch.labeler.emit"]) for e in by["vpt_torch.labeler.wait"]] == [True, False]
    assert len(by["vpt_torch.labeler.cut"]) == 2 and len(by["vpt_torch.idm.upload"]) == 2  # windows at 0, 4; the tail
    for part in BC_SPANS:
        assert len(by[f"vpt_torch.bc.{part}"]) == 1, part


def test_no_profiler_no_record_function_no_counts(programs, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    profiling.counters(reset=True)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    _drive(*programs, np.random.default_rng(1))
    with profiling.span("vpt_torch.test"):
        profiling.count("h2d_bytes", 5)
    assert profiling.counters() == {}


def test_counters_count_host_to_device_bytes_pinned_against_pageable(programs, monkeypatch):
    agent, _, trainer = programs
    rng = np.random.default_rng(2)
    profiling.counters(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        agent.get_action(_obs(rng))
        step = profiling.counters(reset=True)
        batch = batch_to_tensors(_batch(rng))
        # frames in pinned memory, the rest pageable (no pinned memory without a card)
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: self.dtype == torch.uint8)
        trainer.train_step(batch, trainer.initial_state(2))
        bc = profiling.counters(reset=True)
    frames = 2 * RAW_HW[0] * RAW_HW[1] * 3
    # beside the bytes, the CNN's conv forwards count their FLOPs (tests/test_torch_conv.py)
    assert set(step) == set(bc) == {"h2d_bytes", "h2d_pageable_bytes", "conv_flops"}
    h2d = ("h2d_bytes", "h2d_pageable_bytes")
    # the frames and the streams' episode starts
    assert {k: step[k] for k in h2d} == {"h2d_bytes": frames + 2, "h2d_pageable_bytes": frames + 2}
    total = sum(batch[k].numel() * batch[k].element_size() for k in TRAIN_KEYS)
    assert {k: bc[k] for k in h2d} == {"h2d_bytes": total, "h2d_pageable_bytes": total - batch["frames"].numel()}
    assert profiling.counters() == {}
