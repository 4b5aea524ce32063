"""Serving traffic: ``MineRLAgent.get_action`` (``dispatch_action`` then
``collect_action``) stepping ``streams`` env streams at once in a closed
loop: each stream's next frame waits for its action.

Traffic file keys: ``streams``, ``compute_dtype``, ``resize_on_device``,
``ring_cache``, ``stochastic``, ``frame_hw`` (the env's frames, made from
the seed), ``frame_pool`` (distinct frames; stream b shows
``pool[pool_index(step, b)]``), ``episode_steps`` [lo, hi] (episode
lengths; the streams are staggered: each joins its first episode at a
uniform point of it), ``check_streams`` (streams whose every step the
check recomputes, drawn from the seed), ``early_reset`` (the check streams'
first episode ends within this many steps, so the check crosses a reset),
``max_check_steps`` (steps of the check streams kept), ``trace_units``.

The check: the policy's log-probabilities and value for the check streams
are captured at every step (a forward hook on the agent's policy, a copy of
their rows), and the joint action it sampled (around the agent's device
decoder); after the window the plain reference resizes the same frames and
runs the same steps in float32 with TF32 off (in chunks of the policy's
``timesteps``, state carried, episode starts as served).  Compared: the
widest log-probability gap, the widest value gap against the widest
reference value, and, exactly, the env action served against the
reference's decode of the sampled action.

The control (bfloat16 cells): the reference with float8 (e4m3) products
in the program's place, over the same frames and steps
(``reference.model.operands_in``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench import inputs, work
from portbench.reference import actions as ref_actions
from portbench.reference import model as ref_model

HORIZON = 1 << 15  # steps of episode starts drawn; the traffic repeats after them


class Capture:
    """The check streams' log-probabilities, value and sampled joint action
    at every served step, kept on the device."""

    def __init__(self, rows: np.ndarray, steps: int, arch, device):
        self.rows = torch.as_tensor(rows, device=device)
        self.step = 0
        self.steps = steps
        n = len(rows)
        self.logp = {k: torch.zeros((steps, n, c), device=device) for k, (_, c) in arch.head_shapes}
        self.vpred = torch.zeros((steps, n), device=device)
        self.sampled = torch.zeros((steps, n, 2), dtype=torch.long, device=device)

    def policy_hook(self, module, args, output):
        if self.step < self.steps:
            out = output[0]
            for k in self.logp:
                self.logp[k][self.step] = out["pi_logits"][k][self.rows, -1, 0].float()
            self.vpred[self.step] = out["vpred"][self.rows, -1, 0].float()

    def wrap_decode(self, decode):
        def wrapped(buttons, camera):
            if self.step < self.steps:
                self.sampled[self.step, :, 0] = buttons[self.rows]
                self.sampled[self.step, :, 1] = camera[self.rows]
            return decode(buttons, camera)
        return wrapped


def run(run) -> None:
    from vpt_tpu_torch.agent.agent import MineRLAgent

    tr, arch, cfg = run.traffic, run.arch, run.config
    if run.control and tr["compute_dtype"] != "bfloat16":
        raise ValueError("the serve driver has a control for bfloat16 cells only (float8 products)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = tr["streams"]
    run.phase("imports")
    agent = MineRLAgent(device=run.device, policy_kwargs=cfg["policy_kwargs"], pi_head_kwargs=cfg.get("pi_head_kwargs"),
                        batch_size=n, seed=inputs.torch_seed(run.seed, inputs.SAMPLE),
                        compute_dtype=tr["compute_dtype"], ring_cache=tr["ring_cache"],
                        resize_on_device=tr["resize_on_device"])
    run.phase("program init")
    agent.policy.load_state_dict(inputs.make_weights(arch, run.seed, run.device))
    run.phase("weights")

    r = inputs.rng(run.seed, inputs.TRAFFIC)
    lo, hi = tr["episode_steps"]
    first_len = r.integers(lo, hi + 1, size=n)
    first_end = np.array([r.integers(1, e + 1) for e in first_len])
    check = np.sort(r.choice(n, size=tr["check_streams"], replace=False))
    first_end[check[: len(check) // 2]] = r.integers(2, tr["early_reset"] + 1, size=len(check) // 2)
    starts = inputs.episode_starts(r, n, HORIZON, (lo, hi), first_end)
    h, w = tr["frame_hw"]
    pool_dev = inputs.frame_pool(run.seed, tr["frame_pool"], (h, w, 3), run.device)
    pool = pool_dev.cpu().numpy()
    del pool_dev
    run.phase("traffic")

    steps = [0]
    capture = None
    served = []

    def call(record: bool):
        t = steps[0]
        idx = inputs.pool_index(t, np.arange(n), pool.shape[0])
        obs = [{"pov": pool[i]} for i in idx]
        first = starts[:, t % HORIZON]
        with torch.profiler.record_function("portbench.dispatch_action"):
            handle = agent.dispatch_action(obs, first=first, stochastic=tr["stochastic"])
        with torch.profiler.record_function("portbench.collect_action"):
            action = agent.collect_action(handle)
        if record and capture is not None and capture.step < capture.steps:
            served.append([action[i] for i in check])
        if capture is not None:
            capture.step += 1
        steps[0] += 1
        return action

    # warm-up: the shapes of every step (the first step's fresh cache and the ring's slots after it)
    for _ in range(tr["warmup_steps"]):
        call(False)
    # the checked streams start from here: a fresh state for every stream, as a new rollout
    agent.reset()
    steps[0] = 0
    capture = Capture(check, tr["max_check_steps"], arch, run.device)
    agent.policy.register_forward_hook(capture.policy_hook)
    agent.decoder.decode = capture.wrap_decode(agent.decoder.decode)
    run.setup_done()

    dispatch_s = []

    def unit() -> int:
        call(True)
        return n

    flops = work.forward_flops_per_frame(arch, arch.maxlen)
    if run.trace:
        orig = agent.dispatch_action

        def timed_dispatch(*a, **k):
            import time

            t0 = time.perf_counter()
            out = orig(*a, **k)
            dispatch_s.append(time.perf_counter() - t0)
            return out

        agent.dispatch_action = timed_dispatch
        spans = run.stretch(unit, "spans")
        agent.dispatch_action = orig
        del orig, timed_dispatch
        run.layer.update(kind="serve", flops_per_s=spans["done"] * flops / spans["seconds"],
                         peak=work.TENSOR_FLOPS[tr["compute_dtype"]], dispatch_ms=1e3 * float(np.mean(dispatch_s)))
        run.attempted = spans["done"] + run.stretch(unit, "traced")["done"]
    else:
        window = run.stretch(unit, "window")
        run.attempted = window["done"]
        run.e2e["serve_fps"] = window["done"] / window["seconds"]

    kept = min(capture.step, capture.steps)
    got = {k: v[:kept].cpu() for k, v in capture.logp.items()}
    got_v = capture.vpred[:kept].cpu()
    sampled = capture.sampled[:kept].cpu().numpy()
    del agent, capture
    run.free()
    _check(run, arch, pool, starts, check, kept, got, got_v, sampled, served[:kept])


def _reference(run, arch, params, pool, starts, check, kept):
    """The reference's log-probabilities and value for the check streams'
    first ``kept`` steps, (steps, streams, ...) on the host."""
    state = ref_model.initial_state(arch, len(check), run.device)
    chunk = int(run.config["policy_kwargs"]["timesteps"])
    h, w = arch.img
    logp = {k: [] for k, _ in arch.head_shapes}
    value = []
    with torch.no_grad():
        for lo in range(0, kept, chunk):
            t = np.arange(lo, min(kept, lo + chunk))
            idx = inputs.pool_index(t[None, :], check[:, None], pool.shape[0])  # (streams, t)
            raw = torch.as_tensor(pool[idx], device=run.device)  # (S, t, H, W, 3)
            x = raw.flatten(0, 1).permute(0, 3, 1, 2).float()
            x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)  # half-pixel taps, as cv2
            frames = x.permute(0, 2, 3, 1).reshape(len(check), len(t), h, w, 3)
            first = torch.as_tensor(starts[check][:, t], device=run.device)
            out, state = ref_model.forward(params, arch, frames, first, state)
            for k in logp:
                logp[k].append(out[k][:, :, 0].transpose(0, 1).cpu())
            value.append(out["vpred"].transpose(0, 1).cpu())
    return {k: torch.cat(v) for k, v in logp.items()}, torch.cat(value)


def _check(run, arch, pool, starts, check, kept, got, got_v, sampled, served) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = inputs.make_weights(arch, run.seed, run.device)
    ref_logp, ref_v = _reference(run, arch, params, pool, starts, check, kept)
    if run.control:
        with ref_model.operands_in(torch.float8_e4m3fn):  # the bfloat16 control, in the program's place
            got, got_v = _reference(run, arch, params, pool, starts, check, kept)
    run.check("logp_gap", max(float((got[k] - ref_logp[k]).abs().max()) for k in got))
    run.check("value_gap", float((got_v - ref_v).abs().max() / ref_v.abs().max().clamp_min(1e-12)))
    tables = ref_actions.joint_tables()
    mismatched = 0
    for t in range(kept):
        want = ref_actions.decode_joint(sampled[t, :, 0], sampled[t, :, 1], tables)
        for j, action in enumerate(served[t]):
            same = all(int(action[b]) == int(want[b][j]) for b in ref_actions.BUTTONS)
            same = same and np.allclose(np.asarray(action["camera"], np.float64), want["camera"][j], atol=1e-6)
            mismatched += not same
    run.check("decode_mismatches", mismatched)
