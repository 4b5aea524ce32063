"""Labeling traffic: ``StreamingIDMLabeler.feed_resized`` over videos of
frames already at the IDM's resolution, back to back, each closed with
``finish()``; ``window``-frame windows every ``stride`` frames, labeled
``window_batch`` at a time.

Traffic file keys: ``window``, ``stride``, ``window_batch``,
``compute_dtype``, ``video_frames``, ``frame_pool`` (distinct
frames made from the seed; frame f of video v is
``pool[pool_index(f, v)]``), ``check_labels`` (labels drawn from the seed
among those emitted; the check compares every label their owning windows
emitted), ``row_block`` (windows of the reference's forward at a time),
``trace_units`` (frames fed a trace-run stretch).

Set-up warms the labeler's forward at every window-batch shape its videos
give (full groups, the ragged last group, the tail window).  In the timed
stretches a forward hook on the IDM keeps each forward's log-probabilities
on the device, in dispatch order.  The check: the plain reference IDM
(float32, TF32 off; the control runs the program with TF32 on) recomputes
each owning window from a fresh state, its owner found by the labeler's
published rule (window s owns [s + (window - stride) // 2, + stride), the
first window from frame 0, a tail window of the last ``window`` frames
what the others left), and finds the forward and row that labeled it by
the labeler's order (:func:`groups`).  Compared, over every frame the
checked windows own: the widest gap of the heads' log-probabilities
against the reference's, and the widest gap by which an emitted label's
log-probability lies below the reference's best choice (labels are
greedy, so a sound label lies below the best only where two choices tie
to rounding).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs, work
from portbench.reference import actions as ref_actions
from portbench.reference import model as ref_model


def owned(start: int, window: int, stride: int) -> range:
    """The frames a window starting at ``start`` labels (the first window
    from frame 0)."""
    lo = (window - stride) // 2
    return range(0 if start == 0 else start + lo, start + lo + stride)


def owner(i: int, n_frames: int, window: int, stride: int) -> int:
    """The start of the window that labels frame ``i`` of a video of
    ``n_frames`` frames."""
    lo = (window - stride) // 2
    last = (n_frames - window) // stride * stride  # the last complete window
    if i < lo + stride:
        return 0
    if i < last + lo + stride:
        return (i - lo) // stride * stride
    return n_frames - window  # the tail window


def groups(n_frames: int, window: int, stride: int, batch: int) -> list:
    """The window starts of each forward a video of ``n_frames`` gives, in
    the labeler's order: the complete windows ``batch`` at a time, then the
    tail window, if the complete ones leave frames unowned."""
    starts = list(range(0, n_frames - window + 1, stride))
    out = [starts[i:i + batch] for i in range(0, len(starts), batch)]
    if owned(starts[-1], window, stride).stop < n_frames:
        out.append([n_frames - window])
    return out


class Capture:
    """Each labeling forward's log-probabilities, kept on the device in
    dispatch order (a forward hook on the IDM)."""

    def __init__(self):
        self.forwards = []

    def hook(self, module, args, output):
        self.forwards.append({k: v.float().clone() for k, v in output[0]["pi_logits"].items()})


def run(run) -> None:
    from vpt_tpu_torch.agent.idm import IDMAgent, StreamingIDMLabeler

    tr, arch, cfg = run.traffic, run.arch, run.config
    if run.control and tr["compute_dtype"] != "float32":
        raise ValueError("the label driver has a control for float32 cells only (TF32)")
    torch.backends.cuda.matmul.allow_tf32 = run.control  # the float32 control: TF32 in the program's place
    torch.backends.cudnn.allow_tf32 = run.control
    run.phase("imports")
    agent = IDMAgent(cfg["policy_kwargs"], cfg.get("pi_head_kwargs", {}), device=run.device,
                     compute_dtype=tr["compute_dtype"])
    run.phase("program init")
    agent.policy.load_state_dict(inputs.make_weights(arch, run.seed, run.device))
    run.phase("weights")
    h, w = arch.img
    pool_dev = inputs.frame_pool(run.seed, tr["frame_pool"], (h, w, arch.in_chans), run.device)
    pool = pool_dev.cpu().numpy()
    del pool_dev
    run.phase("traffic")
    W, S, G, V = tr["window"], tr["stride"], tr["window_batch"], tr["video_frames"]
    for b in sorted({len(g) for g in groups(V, W, S, G)}):  # warm every forward shape the videos give
        agent.predict_actions_batched(pool[inputs.pool_index(np.arange(b * W), 0, pool.shape[0])].reshape(b, W, h, w, 3))

    processed = [0]
    collect = agent.collect_actions

    def counted(handle):
        out = collect(handle)
        processed[0] += out["camera"].shape[0] * out["camera"].shape[1]
        return out

    agent.collect_actions = counted
    labels = {}  # (video, frame) -> env action
    cursor = {"video": 0, "frame": 0, "labeler": StreamingIDMLabeler(agent, window=W, stride=S, window_batch=G)}
    capture = Capture()
    agent.policy.register_forward_hook(capture.hook)
    run.setup_done()

    def unit() -> int:
        v, f = cursor["video"], cursor["frame"]
        with torch.profiler.record_function("portbench.feed_resized"):
            out = cursor["labeler"].feed_resized(pool[inputs.pool_index(f, v, pool.shape[0])])
        cursor["frame"] += 1
        if cursor["frame"] == V:
            with torch.profiler.record_function("portbench.finish"):
                out += cursor["labeler"].finish()
            cursor.update(video=v + 1, frame=0, labeler=StreamingIDMLabeler(agent, window=W, stride=S, window_batch=G))
        for i, action in out:
            labels[(v, i)] = action
        return len(out)

    flops = work.forward_flops_per_frame(arch, W + arch.maxlen)
    if run.trace:
        before = processed[0]
        spans = run.stretch(unit, "spans")
        run.layer.update(kind="label", flops_per_s=(processed[0] - before) * flops / spans["seconds"],
                         peak=work.TENSOR_FLOPS[tr["compute_dtype"]])
        run.attempted = spans["done"] + run.stretch(unit, "traced")["done"]
    else:
        window = run.stretch(unit, "window")
        run.attempted = window["done"]
        run.e2e["label_fps"] = window["done"] / window["seconds"]
    run.sync()
    forwards = [{k: v.cpu() for k, v in f.items()} for f in capture.forwards]
    del agent, cursor, collect, capture
    run.free()
    _check(run, arch, pool, labels, forwards)


def _check(run, arch, pool, labels, forwards) -> None:
    tr = run.traffic
    W, S, V = tr["window"], tr["stride"], tr["video_frames"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = inputs.rng(run.seed, inputs.SAMPLE)
    keys = sorted(labels)
    drawn = [keys[i] for i in r.choice(len(keys), size=min(tr["check_labels"], len(keys)), replace=False)]
    windows = sorted({(v, owner(i, V, W, S)) for v, i in drawn + [keys[0]]})
    video_groups = groups(V, W, S, tr["window_batch"])
    where = {s: (g, row) for g, starts in enumerate(video_groups) for row, s in enumerate(starts)}
    params = inputs.make_weights(arch, run.seed, run.device)
    logp_gap, gap, compared = 0.0, 0.0, 0
    for lo in range(0, len(windows), tr["row_block"]):
        block = windows[lo:lo + tr["row_block"]]
        idx = np.stack([inputs.pool_index(np.arange(s, s + W), v, pool.shape[0]) for v, s in block])
        frames = torch.as_tensor(pool[idx], device=run.device)
        first = torch.zeros(frames.shape[:2], dtype=torch.bool, device=run.device)
        with torch.no_grad():
            out, _ = ref_model.forward(params, arch, frames, first, ref_model.initial_state(arch, len(block), run.device))
        ref_b, ref_c = out["buttons"].cpu().numpy(), out["camera"].cpu().numpy()  # (n, W, 20, 2), (n, W, 2, 11)
        for row, (v, s) in enumerate(block):
            g, r = where[s]
            got = forwards[v * len(video_groups) + g]
            got_b, got_c = got["buttons"][r].numpy(), got["camera"][r].numpy()
            for i in range(s, s + W):
                action = labels.get((v, i))
                if action is None or owner(i, V, W, S) != s:
                    continue
                logp_gap = max(logp_gap, float(np.abs(got_b[i - s] - ref_b[row, i - s]).max()),
                               float(np.abs(got_c[i - s] - ref_c[row, i - s]).max()))
                pressed = np.array([int(action[b]) for b in ref_actions.BUTTONS])
                bins = ref_actions.camera_bins(np.asarray(action["camera"]))
                rb, rc = ref_b[row, i - s], ref_c[row, i - s]
                gap = max(gap, float((rb.max(-1) - rb[np.arange(20), pressed]).max()),
                          float((rc.max(-1) - rc[np.arange(2), bins]).max()))
                compared += 1
    run.check("logp_gap", logp_gap)
    run.check("label_logp_gap", gap)
    run.check("labels_uncompared", 0 if compared else 1)
