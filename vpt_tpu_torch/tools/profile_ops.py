"""Where a step's device time goes: a ranked table of the CUDA kernels of
the port's BC, rollout, IDM or PPO step (counterpart of the JAX package's
tools/profile_hlo.py).

    python -m vpt_tpu_torch.tools.profile_ops --step {bc,rollout,idm,ppo} \\
        [--width W] [--batch 8] [--chunk 32] [--streams 64] [--window-batch 8] \\
        [--compute-dtype bfloat16] [--top N] [--json out.json] [--warmup 2] [--iters 3] [--trace-dir DIR]

It runs warm steps, then traces ``--iters`` more under
``utils.profiling.profile_trace`` (torch.profiler, CUDA activities through
CUPTI), sums each kernel's device time over the traced steps, ranks the
kernels and folds them into categories: conv, gemm, attention (kernels B1
and B2), norm, elementwise, reduction, copy (memcpy, memset, layout copies)
and other.  It prints one JSON line, ``{"device_total_us", "categories":
{category: share of device time}, "top_ops": [...]}``, and with ``--json``
writes every kernel's row too.  A trace with no CUDA kernel in it (no card,
or CUPTI cannot trace on this machine) is an error, never an empty table.

The geometry flags are tools/profile_hlo.py's, with its defaults and
meanings (its ``--pool-impl`` is TPU-only and has no counterpart), on random
weights from seed 0 in ``--compute-dtype``: ``bc`` a BC train step of the
``--width`` policy (hidsize 1024·width, Impala width 4·width; 1 by default)
at ``--batch`` streams of ``--chunk`` steps, with remat and 8 CNN chunks
where batch·chunk·width passes 1024; ``rollout`` the ``--width`` agent's
(2 by default) device step at ``--streams``; ``idm`` the 4x IDM's labeling
forward of ``--window-batch`` windows of 128 frames; ``ppo`` (the port's
own) a ``--width`` (2) PPO update at ``--streams`` streams x 64 steps (4
collection groups, 16 minibatches, 3 epochs) on a collected trajectory.
chip_smoke.py ``--profile`` calls the step builders at its own phases'
shapes.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from typing import Callable, Dict, List

import numpy as np
import torch

# first match wins: the port's kernels; cuDNN's convolutions, with their
# layout transposes and the pieces of its FFT algorithm (the DSE:: transforms,
# the pointwise complex products, the cuBLAS complex (cf32) products it calls:
# the models have no complex matmul of their own); then matrix products, ...
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


def kernel_rows(events) -> List[Dict]:
    """Device time and count of each CUDA kernel (or memcpy/memset) name in
    a profiler's events, longest first.  A user annotation on the device's
    timeline (such as "Optimizer.step#Adam.step") spans kernels counted on
    their own, so it is left out."""
    from torch.autograd import DeviceType

    rows: Dict[str, Dict] = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        row = rows.setdefault(e.name, {"op": e.name, "category": category(e.name), "self_time_us": 0.0, "count": 0})
        row["self_time_us"] += e.time_range.end - e.time_range.start
        row["count"] += 1
    return sorted(rows.values(), key=lambda r: -r["self_time_us"])


def summarize(rows: List[Dict], top: int) -> Dict:
    """Shares of device time by category, and the ``top`` kernels."""
    if not rows:
        raise RuntimeError("the trace holds no CUDA kernel events: torch.profiler saw no device activity "
                           "(no card, or CUPTI cannot trace here), so there is no device time to rank")
    total = sum(r["self_time_us"] for r in rows)
    cats: Dict[str, float] = {}
    for r in rows:
        cats[r["category"]] = cats.get(r["category"], 0.0) + r["self_time_us"]
    return {
        "device_total_us": total,
        "categories": {k: v / total for k, v in sorted(cats.items(), key=lambda kv: -kv[1])},
        "top_ops": [dict(r, self_time_share=r["self_time_us"] / total, op=r["op"][:160]) for r in rows[:top]],
    }


def profile_step(step: Callable[[], object], warmup: int = 2, iters: int = 3, trace_dir: str = None,
                 top: int = 20) -> Dict:
    """Run ``step`` ``warmup`` times, trace ``iters`` more (the card
    synchronised around them) and return ``summarize``'s table, with
    ``"rows"`` (every kernel) and ``"iters"``."""
    from vpt_tpu_torch.utils.profiling import profile_trace

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    with profile_trace(trace_dir or tempfile.mkdtemp(prefix="vpt_torch_trace_")) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    rows = kernel_rows(prof.events())
    return dict(summarize(rows, top), iters=iters, rows=rows)


def _bc_batch(dev, B, T, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"frames": torch.randint(0, 256, (B, T, 128, 128, 3), generator=g, device=dev, dtype=torch.uint8),
            "buttons": torch.randint(0, 8641, (B, T), generator=g, device=dev),
            "camera": torch.randint(0, 121, (B, T), generator=g, device=dev),
            "firsts": torch.zeros((B, T), dtype=torch.bool, device=dev),
            "mask": torch.ones((B, T), dtype=torch.bool, device=dev)}


def policy_kwargs(width: int):
    """The foundation policy at ``width`` (1x, 2x, 3x: hidsize 1024·width,
    Impala width 4·width), as profile_hlo.py scales it."""
    from vpt_tpu_torch.config import FOUNDATION_POLICY_KWARGS

    return dict(FOUNDATION_POLICY_KWARGS, hidsize=1024 * width, impala_width=4 * width)


def make_bc_step(dev, width=2, batch=4, chunk=128, compute_dtype="float32"):  # phase 7(b)'s step by default
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS
    from vpt_tpu_torch.training.bc import BCHyperparams, BCTrainer

    small = batch * chunk * width <= 1024  # profile_hlo.py's rule: remat and 8 CNN chunks past it
    trainer = BCTrainer(policy_kwargs(width), FOUNDATION_PI_HEAD_KWARGS, hp=BCHyperparams(batch_size=batch,
                        chunk_len=chunk), compute_dtype=compute_dtype, remat=not small,
                        cnn_scan_chunks=0 if small else 8, seed=0, device=dev)
    data = _bc_batch(dev, batch, chunk)
    ctx = {"state": trainer.initial_state(batch)}

    def step():
        ctx["state"], loss, _ = trainer.train_step(data, ctx["state"])

    return step


def make_rollout_step(dev, width=2, streams=8, compute_dtype="float32"):  # phase 4's streams by default
    from vpt_tpu_torch.agent import MineRLAgent

    agent = MineRLAgent(device=dev, policy_kwargs=policy_kwargs(width), batch_size=streams, seed=0,
                        compute_dtype=compute_dtype)
    img = np.random.default_rng(0).integers(0, 256, (streams, 1, 128, 128, 3), dtype=np.uint8)
    first = np.zeros((streams, 1), bool)

    def step():
        packed, agent.hidden_state = agent._step(img, first, True, agent.hidden_state)
        packed.cpu()

    return step


def make_idm_label_step(dev, window_batch=8, window=128, compute_dtype="bfloat16"):
    """The 4x IDM's labeling forward of ``window_batch`` windows: its
    actions' argmax, read back (profile_hlo.py's idm step)."""
    from vpt_tpu_torch.agent.idm import IDMAgent
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.models.policy import policy_initial_state

    agent = IDMAgent(IDM_4X_KWARGS, {}, device=dev, compute_dtype=compute_dtype, seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (window_batch, window, 128, 128, 3), generator=g, device=dev, dtype=torch.uint8)
    first = torch.zeros((window_batch, window), dtype=torch.bool, device=dev)
    state = policy_initial_state(agent.cfg, window_batch, device=dev)

    @torch.inference_mode()
    def step():
        out, _ = agent.policy(frames, first, state)
        [v.argmax(-1).cpu() for v in out["pi_logits"].values()]

    return step


def make_idm_step(dev, batch=3, window=128, compute_dtype="float32"):  # phase 8(c)'s train step
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer

    trainer = IDMTrainer(IDM_4X_KWARGS, {}, hp=IDMHyperparams(batch_size=batch, window=window),
                         compute_dtype=compute_dtype, seed=0, device=dev)
    rng = np.random.default_rng(0)
    data = {"frames": rng.integers(0, 256, (batch, window, 128, 128, 3), dtype=np.uint8),
            "buttons": rng.integers(0, 8641, (batch, window)), "camera": rng.integers(0, 121, (batch, window)),
            "firsts": np.zeros((batch, window), bool), "mask": np.ones((batch, window), bool)}
    placed = trainer.to_device(data)

    def step():
        trainer.train_step(placed)

    return step


def make_ppo_step(dev, width=2, streams=64, compute_dtype="bfloat16"):  # phase 9(b)'s update by default
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS
    from vpt_tpu_torch.training.rl import PPOHyperparams, PPOTrainer

    hp = PPOHyperparams(rollout_len=64, n_collect_groups=4, n_minibatches=16, n_epochs=3)
    trainer = PPOTrainer(policy_kwargs(width), FOUNDATION_PI_HEAD_KWARGS, hp=hp, compute_dtype=compute_dtype,
                         seed=0, device=dev)
    traj, _, _ = trainer.collect([MockMinecraftEnv(seed=i) for i in range(streams)],
                                 reward_fn=lambda action, obs, reward, done: float(action["attack"]))

    def step():
        trainer.update(traj)

    return step


def make_step(args, dev) -> Callable[[], object]:
    """The step ``--step`` names, at the geometry of the parsed flags."""
    if args.step == "bc":
        return make_bc_step(dev, args.width or 1, args.batch, args.chunk, args.compute_dtype)
    if args.step == "rollout":
        return make_rollout_step(dev, args.width or 2, args.streams, args.compute_dtype)
    if args.step == "idm":
        return make_idm_label_step(dev, args.window_batch, compute_dtype=args.compute_dtype)
    return make_ppo_step(dev, args.width or 2, args.streams, args.compute_dtype)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--step", required=True, choices=["bc", "idm", "ppo", "rollout"])
    p.add_argument("--width", type=int, default=None, help="policy width (bc: 1, rollout and ppo: 2 by default)")
    p.add_argument("--batch", type=int, default=8, help="bc: streams a step")
    p.add_argument("--chunk", type=int, default=32, help="bc: steps a stream")
    p.add_argument("--streams", type=int, default=64, help="rollout and ppo: env streams")
    p.add_argument("--window-batch", type=int, default=8, help="idm: 128-frame windows a forward")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--top", type=int, default=20, help="kernels in the printed table")
    p.add_argument("--json", type=str, default=None, help="write the full table (every kernel) here")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--trace-dir", type=str, default=None, help="keep the Chrome trace here")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_ops: no CUDA device available", file=sys.stderr)
        return 2
    table = profile_step(make_step(args, torch.device("cuda")), args.warmup, args.iters, args.trace_dir, args.top)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(table, step=args.step), f, indent=1)
    print(json.dumps({k: v for k, v in table.items() if k != "rows"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
