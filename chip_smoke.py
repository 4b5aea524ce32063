"""Drive the PyTorch port (vpt_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel of the main path from the sources in csrc/;
  3. kernel B1 (windowed attention forward) against its plain PyTorch
     version at the 2x chunk shape (B=4, H=16, t=128, T=256, d=128) and at
     d = 64 and 192, with and without mask and relative bias, in float32 and
     bfloat16, with its time beside the plain version's, SDPA's on a
     materialised bias (a yardstick the port never calls) and its bound;
  4. a stepped rollout: the 2x foundation MineRLAgent (random weights from a
     seed) serving 8 streams for 64 get_action calls on 360x640 frames,
     with episode resets;
  5. stepwise = chunkwise: 4 streams, 128 frames with mid-window resets,
     stepped at t=1 on the ring cache and as one (4, 128) chunked forward,
     which must launch B1 once per block.
It prints one JSON line with every kernel's numbers, then, last,
{"ok": true, "device": {...}}.  It exits non-zero, with no "ok" line, where
there is no CUDA device.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
F32_TOL, BF16_TOL = 1e-4, 3e-2
STEP_TOL = 2e-3  # per-step logits and vpred, float32, 2x width (as the full-geometry parity tests)


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(dev, B, H, t, maxlen, d, dtype, seed):
    from vpt_tpu_torch.ops.masks import clipped_causal_mask

    g = torch.Generator(device=dev).manual_seed(seed)
    T = t + maxlen
    q = torch.randn((B, H, t, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, H, T, d), generator=g, device=dev).to(dtype)
    v = torch.randn((B, H, T, d), generator=g, device=dev).to(dtype)
    R = 0.1 * torch.randn((B, H, t, 10), generator=g, device=dev)
    b_nd = 0.2 * torch.randn((10, maxlen), generator=g, device=dev)
    first = torch.rand((B, t), generator=g, device=dev) < 2.0 / t
    state_mask = torch.rand((B, maxlen), generator=g, device=dev) < 0.75
    mask, _ = clipped_causal_mask(first, state_mask, t, T, maxlen)
    return q, k, v, mask, R, b_nd


def b1_bound(q, k, v, mask, R, b_nd):
    """Least time for the call: inputs read once and output written once over
    HBM bandwidth, or its FLOPs (QKᵀ, W·V, the bias FMAs) over the peak
    rate of the input type, whichever is larger."""
    B, H, t, d = q.shape
    T = k.shape[2]
    tensors = [q, k, v, q] + [x for x in (mask, R, b_nd) if x is not None]  # q twice: the output
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    flops = 2 * 2 * B * H * t * T * d + (2 * B * H * t * T * R.shape[-1] if R is not None else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def check_b1(dev):
    """Phase 3: B1 against its plain version; timings at the 2x chunk shape."""
    import torch.nn.functional as F

    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.ops.attention import NEG_BIAS, attention_alpha
    from vpt_tpu_torch.ops.rel_bias import relattn_bias

    main_err = None
    for d in (128, 64, 192):
        for dtype in (torch.float32, torch.bfloat16):
            for use_mask, use_rel in ((True, True), (False, False), (True, False)):
                q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, d, dtype, d)
                mask = mask if use_mask else None
                R, b_nd = (R, b_nd) if use_rel else (None, None)
                got = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
                torch.cuda.synchronize()
                expect = wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True)
                err = (got.float() - expect.float()).abs().max().item()
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                log(f"B1 d={d} {str(dtype)[6:]} mask={use_mask} rel={use_rel}: max_abs_err {err:.3e} (tol {tol})")
                if not err <= tol:
                    raise AssertionError(f"B1 disagrees with its plain version: {err} > {tol}")
                if d == 128 and dtype == torch.float32 and use_mask and use_rel:
                    main_err = err

    # timings at the main path's shape and type: 2x chunk, float32, mask and bias
    q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, 128, torch.float32, 0)
    ms = cuda_time_ms(lambda: wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True))
    plain_ms = cuda_time_ms(lambda: wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True))
    bias = relattn_bias(R, b_nd, k.shape[2]) + torch.where(mask[:, None], 0.0, NEG_BIAS)
    alpha = attention_alpha(128, True)
    ref = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=alpha)
    lib_err = (ref - wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True)).abs().max().item()
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=alpha))
    bound_ms, bound_by, nbytes, flops = b1_bound(q, k, v, mask, R, b_nd)
    log(f"B1 2x chunk f32: {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA+bias {library_ms:.4f} ms "
        f"(SDPA vs plain max_abs_err {lib_err:.2e}); bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    ms_bf16 = cuda_time_ms(lambda: wa.windowed_attention_fwd(qb, kb, vb, mask, R, b_nd, True))
    bound_bf16, by_bf16, _, _ = b1_bound(qb, kb, vb, mask, R, b_nd)
    log(f"B1 2x chunk bf16: {ms_bf16:.4f} ms; bound {bound_bf16:.4f} ms by {by_bf16}")
    return {
        "name": "windowed_attention_fwd",
        "route": "cuda",
        "source": "vpt_tpu_torch/csrc/windowed_attention_fwd.cu",
        "replaces": "vpt_tpu/ops/pallas_attention_impl.py:43",
        "launches": None,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def synthetic_obs(rng, n):
    return [{"pov": rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)} for _ in range(n)]


def stepped_rollout(dev, steps=64, streams=8):
    """Phase 4: the 2x agent serving `streams` env streams for `steps` calls."""
    from vpt_tpu_torch.agent import MineRLAgent
    from vpt_tpu_torch.agent.agent import TARGET_ACTION_NAMES
    from vpt_tpu_torch.ops import windowed_attention as wa

    t0 = time.perf_counter()
    agent = MineRLAgent(device=dev, batch_size=streams, seed=0)
    torch.cuda.synchronize()
    log(f"2x MineRLAgent built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in agent.policy.parameters())} parameters)")
    rng = np.random.default_rng(0)
    frames = [synthetic_obs(rng, streams) for _ in range(4)]
    resets = {16 + 4 * i: i for i in range(streams)}  # stream i restarts its episode at step 16 + 4 i
    wa.launches = 0
    t0 = None
    for step in range(steps):
        if step == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        first = np.zeros(streams, bool)
        if step == 0:
            first[:] = True
        if step in resets:
            first[resets[step]] = True
        actions = agent.get_action(frames[step % 4], first=first)
        assert len(actions) == streams
        for act in actions:
            assert set(act) - {"camera"} <= TARGET_ACTION_NAMES
            assert all(act[k] in (0, 1) for k in act if k != "camera")
            assert act["camera"].shape == (2,) and np.all(np.abs(act["camera"]) <= 10.0)
        assert np.all(np.isfinite(agent._last_vpred))
    seconds = time.perf_counter() - t0
    log(f"stepped rollout: {streams} streams x {steps} steps, {streams * (steps - 1) / seconds:.1f} frames/s "
        f"({1e3 * seconds / (steps - 1):.2f} ms/step incl. host resize of 360x640 frames); "
        f"B1 launches in the ring-cache rollout: {wa.launches}")

    # the step's two halves, each alone: host resize, then device step + one D2H copy
    t0 = time.perf_counter()
    for i in range(8):
        img = agent._env_obs_to_agent(frames[i % 4])
    resize_ms = (time.perf_counter() - t0) * 1e3 / 8
    no_reset = np.zeros((streams, 1), bool)
    t0 = time.perf_counter()
    for _ in range(8):
        agent._step(img, no_reset, True).cpu()
    step_ms = (time.perf_counter() - t0) * 1e3 / 8
    log(f"  per step: host resize of {streams} frames {resize_ms:.2f} ms, policy step + D2H {step_ms:.2f} ms")
    return agent


@torch.inference_mode()
def stepwise_equals_chunkwise(agent, dev, B=4, T=128):
    """Phase 5: per-step outputs of the t=1 ring rollout equal the (B, T)
    chunked forward's; the chunk launches B1 once per block."""
    from vpt_tpu_torch.models.policy import policy_initial_state
    from vpt_tpu_torch.ops import windowed_attention as wa

    policy, cfg = agent.policy, agent.cfg
    g = torch.Generator(device=dev).manual_seed(1)
    h, w, c = cfg.img_shape
    img = torch.randint(0, 256, (B, T, h, w, c), generator=g, device=dev, dtype=torch.uint8)
    first = torch.zeros((B, T), dtype=torch.bool, device=dev)
    first[:, 0] = True
    for i in range(B):  # mid-window resets, one per stream at its own step
        first[i, (i + 1) * T // (B + 1)] = True

    state = policy_initial_state(cfg, B, ring=True, device=dev)
    step_logits, step_vpred = {k: [] for k in ("buttons", "camera")}, []
    for i in range(T):
        out, state = policy(img[:, i:i + 1], first[:, i:i + 1], state)
        for k in step_logits:
            step_logits[k].append(out["pi_logits"][k])
        step_vpred.append(out["vpred"])
    torch.cuda.synchronize()

    wa.launches = 0
    t0 = time.perf_counter()
    out, _ = policy(img, first, policy_initial_state(cfg, B, ring=False, device=dev))
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    launches = wa.launches
    errs = {}
    for k in step_logits:
        stepped = torch.cat(step_logits[k], dim=1)
        assert stepped.shape == out["pi_logits"][k].shape and torch.isfinite(out["pi_logits"][k]).all()
        errs[k] = (stepped - out["pi_logits"][k]).abs().max().item()
    errs["vpred"] = (torch.cat(step_vpred, dim=1) - out["vpred"]).abs().max().item()
    log(f"stepwise vs chunkwise ({B}x{T}, f32): max_abs_err {errs} (tol {STEP_TOL}); "
        f"chunked forward {chunk_s * 1e3:.1f} ms, B1 launches {launches}")
    if not all(e <= STEP_TOL for e in errs.values()):
        raise AssertionError(f"stepwise and chunkwise disagree: {errs}")
    if launches != cfg.n_recurrence_layers:
        raise AssertionError(f"chunked forward launched B1 {launches} times, expected {cfg.n_recurrence_layers}")

    # the first call above includes cuDNN's choice of algorithms; time a second one
    t0 = time.perf_counter()
    policy(img, first, policy_initial_state(cfg, B, ring=False, device=dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"  chunked forward, second call: {seconds * 1e3:.1f} ms ({B * T / seconds:.0f} frames/s)")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vpt_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    report = cuda_build.build(["windowed_attention_fwd"])
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        ptxas = [ln for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {r['seconds']:.1f} s; " + " | ".join(ptxas))

    b1 = check_b1(dev)
    agent = stepped_rollout(dev)
    b1["launches"] = stepwise_equals_chunkwise(agent, dev)

    log(json.dumps({"kernels": [b1]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
