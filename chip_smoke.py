"""Drive the PyTorch port (vpt_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel of the main path from the sources in csrc/, and
     count the tensor-core instructions (HMMA, HGMMA) of each kernel in the
     built library's SASS (cuobjdump): a kernel with none fails the run;
  3. kernel B1 (windowed attention forward) against its plain PyTorch
     version at the 2x chunk shape (B=4, H=16, t=128, T=256, d=128) and at
     d = 64 and 192, with and without mask and relative bias, in float32 and
     bfloat16, with its time in both types beside the plain version's,
     SDPA's on a materialised bias (a yardstick the port never calls) and its
     bound;
  4. a stepped rollout: the 2x foundation MineRLAgent (random weights from a
     seed) serving 8 streams for 64 get_action calls on 360x640 frames,
     with episode resets;
  5. stepwise = chunkwise: 4 streams, 128 frames with mid-window resets,
     stepped at t=1 on the ring cache and as one (4, 128) chunked forward,
     which must launch B1 once per block;
  6. kernel B2 (windowed attention backward) against its plain PyTorch
     version at the 2x chunk shape and at d = 64 and 192, with and without
     mask and relative bias, in float32 and bfloat16, all five gradients;
     autograd through windowed_attention_fwd on CUDA (B1 forward, B2
     backward) against autograd of the plain forward; B2's time in both
     types beside the plain backward's, SDPA's forward and backward on a
     materialised bias (a yardstick the port never calls) and its bound; the
     memory the backward allocates beyond its inputs and outputs;
  7. BC training of the 2x policy (random weights from a seed, float32):
     (a) one train_step on the card against the same step on the CPU (the
     Impala CNN's grads on relative L2, beside the card's own cuDNN-vs-torch
     convolution disagreement);
     (b) five optimizer steps at B=4, T=128 with the state carried across
     chunks, per-stream resets and a padded tail, launching B1 and B2 once
     per block and step.
It prints one JSON line with every kernel's numbers, then, last,
{"ok": true, "device": {...}}.  It exits non-zero, with no "ok" line, where
there is no CUDA device.

    python3 chip_smoke.py --time-kernels

times kernels B1 and B2 alone, in float32 and bfloat16 at the 2x chunk shape,
beside their plain versions, SDPA and their bounds (phases 1 and 2's build,
then the timings of phases 3 and 6), and prints them as its last line.  It
drives whichever vpt_tpu_torch package it imports, so run from an unpacked
older commit with this file copied in, it times that commit's kernels by the
same clock, for a comparison inside one call.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
# tensor-core rate of a matrix product at the accuracy of its input type:
# float32 as three TF32 products at 495 TFLOP/s, bfloat16 at 989 TFLOP/s
PRODUCT_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
SPIN_CYCLES_PER_S = 2.0e9  # the H100 SXM's top SM clock is 1.98 GHz: a spin of this many cycles lasts >= 1 s
TENSOR_CORE_OPS = re.compile(r"\b(HMMA|HGMMA)\b")
KERNELS = ("windowed_attention_fwd", "windowed_attention_bwd")
F32_TOL, BF16_TOL = 1e-4, 3e-2
STEP_TOL = 2e-3  # per-step logits and vpred, float32, 2x width (as the full-geometry parity tests)
# train step, card against CPU, float32: loss and grad norm relative; each
# parameter's grad against its max-abs (f32 sums in another order over a 248M-parameter graph)
LOSS_RTOL, NORM_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3, 1e-3, 1e-7
# The Impala CNN's parameter grads are held on relative L2 error instead.  Its
# ~16M ReLU and max-pool decisions a layer at 128x128 turn f32 rounding in the
# forward into a few flipped activations, each of which moves a whole term of
# a conv weight's gradient sum: two conv algorithms on the same card differ as
# much, and phase 7(a) prints that calibration beside the check.
CNN_PREFIX, CNN_GRAD_REL_L2 = "net.img_process.cnn.", 5e-2


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3, tries=3):
    """Time of one call of fn, in ms, from CUDA events around `iters` calls,
    and whether it is the device's time alone.  The card first spins
    (torch.cuda._sleep) for longer than the host takes to enqueue the calls,
    so the events time the device's work, not the host's launch overhead (a
    few tens of us a call through Python and ctypes, more than a small
    kernel's own time).  The spin must still run when the last call is
    queued (the start event behind it not yet reached); where it does not, it
    is made 4 times longer and the calls timed again.  A fn that waits on the
    device itself (a boolean-mask index, .item()) can never be queued behind
    the spin: its time is then the host's and the device's together, and the
    second value is False."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * iters * (time.perf_counter() - t0) / warmup + 1e-3  # a call's host time bounds its enqueue
    for _ in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(SPIN_CYCLES_PER_S * spin_s))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        device_only = not start.query()
        torch.cuda.synchronize()
        if device_only:
            break
        spin_s *= 4
    return start.elapsed_time(end) / iters, device_only


def kernel_time_ms(fn):
    """A kernel's device time in ms; its wrapper never waits on the device,
    so a time that is not the device's alone fails the run."""
    ms, device_only = cuda_time_ms(fn)
    if not device_only:
        raise AssertionError("the spin ended before the kernel's launches were queued: no device-only time")
    return ms


def timed_note(device_only):
    return "" if device_only else " (host and device: the call waits on the device)"


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


def sass_tensor_core_counts(listing):
    """{function: number of tensor-core instructions} of a `cuobjdump -sass` listing."""
    counts, function = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            function = m.group(1)
            counts[function] = 0
        elif function is not None and TENSOR_CORE_OPS.search(line):
            counts[function] += 1
    return counts


def kernels_without_tensor_cores(counts):
    """The kernels of a library's counts that run no tensor-core instruction,
    but for B2's pass that sums the d b_nd partials, which multiplies no
    matrices; a library with no kernel at all fails too."""
    if not counts:
        return ["(no kernel in the listing)"]
    return [f for f, n in counts.items() if n == 0 and "db_reduce" not in f]


def check_tensor_cores(names):
    """Phase 2: count each built kernel's tensor-core instructions in its SASS."""
    from vpt_tpu_torch.ops import cuda_build

    cuobjdump = str(Path(cuda_build.nvcc()).parent / "cuobjdump")
    for name in names:
        listing = subprocess.run([cuobjdump, "-sass", str(cuda_build.library_path(name))], capture_output=True,
                                 text=True, check=True, timeout=300).stdout
        counts = sass_tensor_core_counts(listing)
        log(f"  {name}: {sum(counts.values())} tensor-core instructions (HMMA/HGMMA) in {len(counts)} kernels: "
            + ", ".join(f"{f} {n}" for f, n in counts.items()))
        missing = kernels_without_tensor_cores(counts)
        if missing:
            raise AssertionError(f"{name}: no tensor-core instruction in {missing}")


def band_pairs(t, T, bandsize):
    """Number of (query, key) pairs on the relative-bias band."""
    return sum(max(0, min(T, i + T - t + 1) - max(0, i + T - t - bandsize + 1)) for i in range(t))


def bound(nbytes, product_flops, bias_flops, dtype):
    """Least time in ms, and what bounds it: the bytes over HBM bandwidth, or
    the products at the tensor-core rate of the input type's accuracy plus
    the bias FLOPs at the float32 one (R and b_nd are float32 in both types,
    and their contractions are matrix products too), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (product_flops / PRODUCT_FLOPS[dtype] + bias_flops / PRODUCT_FLOPS[torch.float32]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def b1_work(q, k, v, mask, R, b_nd):
    """B1's least work: bytes (inputs read once, the output written once),
    product FLOPs (QKᵀ and W·V) and bias FLOPs (n FMAs a pair on the band)."""
    B, H, t, d = q.shape
    T = k.shape[2]
    tensors = [q, k, v, q] + [x for x in (mask, R, b_nd) if x is not None]  # q twice: the output
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    bias = 2 * B * H * band_pairs(t, T, b_nd.shape[1]) * R.shape[-1] if R is not None else 0
    return nbytes, 2 * 2 * B * H * t * T * d, bias


def b1_bound(q, k, v, mask, R, b_nd):
    nbytes, products, bias = b1_work(q, k, v, mask, R, b_nd)
    return bound(nbytes, products, bias, q.dtype) + (nbytes, products + bias)


def time_b1(q, k, v, mask, R, b_nd):
    """B1's time beside its plain version's, SDPA's on a materialised bias
    (in q's dtype) and its bound, at these inputs."""
    import torch.nn.functional as F

    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.ops.attention import NEG_BIAS, attention_alpha
    from vpt_tpu_torch.ops.rel_bias import relattn_bias

    ms = kernel_time_ms(lambda: wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True))
    plain_ms, plain_alone = cuda_time_ms(lambda: wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True))
    bias = (relattn_bias(R, b_nd, k.shape[2]) + torch.where(mask[:, None], 0.0, NEG_BIAS)).to(q.dtype)
    alpha = attention_alpha(q.shape[-1], True)
    library_ms, library_alone = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=alpha))
    bound_ms, bound_by, nbytes, flops = b1_bound(q, k, v, mask, R, b_nd)
    log(f"B1 2x chunk {str(q.dtype)[6:]}: {ms:.4f} ms, plain {plain_ms:.4f} ms{timed_note(plain_alone)}, "
        f"SDPA+bias {library_ms:.4f} ms{timed_note(library_alone)}; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return ms, plain_ms, library_ms, bound_ms, bound_by


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

    # timings at the main path's shape: 2x chunk, mask and bias, float32 (the main path's type) and bfloat16
    q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, 128, torch.float32, 0)
    bias = relattn_bias(R, b_nd, k.shape[2]) + torch.where(mask[:, None], 0.0, NEG_BIAS)
    ref = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=attention_alpha(128, True))
    lib_err = (ref - wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True)).abs().max().item()
    log(f"SDPA+bias vs plain B1, 2x chunk f32: max_abs_err {lib_err:.2e}")
    ms, plain_ms, library_ms, bound_ms, bound_by = time_b1(q, k, v, mask, R, b_nd)
    time_b1(*(x.bfloat16() for x in (q, k, v)), mask, R, b_nd)
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


def b2_work(q, k, v, mask, R, b_nd):
    """B2's least work: bytes (inputs q, k, v, dO, mask, R, b_nd read once
    and outputs dq, dk, dv, dR, db_nd written once), product FLOPs (five
    t x T x d products) and bias FLOPs (on the band: the bias recompute, dR
    and d b_nd, n FMAs a pair each)."""
    B, H, t, d = q.shape
    T = k.shape[2]
    tensors = [q, k, v, q] + [x for x in (mask, R, b_nd) if x is not None]  # dO is q's size
    tensors += [q, k, v] + [x for x in (R, b_nd) if x is not None]  # the outputs
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    bias = 3 * 2 * B * H * band_pairs(t, T, b_nd.shape[1]) * R.shape[-1] if R is not None else 0
    return nbytes, 5 * 2 * B * H * t * T * d, bias


def b2_bound(q, k, v, mask, R, b_nd):
    nbytes, products, bias = b2_work(q, k, v, mask, R, b_nd)
    return bound(nbytes, products, bias, q.dtype) + (nbytes, products + bias)


def time_b2(q, k, v, mask, R, b_nd, dO):
    """B2's time beside its plain version's, SDPA's forward and backward on a
    materialised bias (in q's dtype; q, k, v grads only) and its bound."""
    import torch.nn.functional as F

    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.ops.attention import NEG_BIAS, attention_alpha
    from vpt_tpu_torch.ops.rel_bias import relattn_bias

    ms = kernel_time_ms(lambda: wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True))
    plain_ms, plain_alone = cuda_time_ms(lambda: wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True))
    bias = (relattn_bias(R, b_nd, k.shape[2]) + torch.where(mask[:, None], 0.0, NEG_BIAS)).to(q.dtype)
    alpha = attention_alpha(q.shape[-1], True)
    ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias, scale=alpha)
        return torch.autograd.grad(out, (ql, kl, vl), dO)

    library_ms, library_alone = cuda_time_ms(sdpa_fwd_bwd)
    bound_ms, bound_by, nbytes, flops = b2_bound(q, k, v, mask, R, b_nd)
    log(f"B2 2x chunk {str(q.dtype)[6:]}: {ms:.4f} ms, plain {plain_ms:.4f} ms{timed_note(plain_alone)}, "
        f"SDPA fwd+bwd (q, k, v grads) on a materialised bias {library_ms:.4f} ms{timed_note(library_alone)}; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def b2_errors(got, expect, dtype):
    """Per-gradient max-abs error and its tolerance, tol * (1 + max|ref|)."""
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    out = {}
    for name, g, e in zip(("dq", "dk", "dv", "dR", "db_nd"), got, expect):
        if e is None:
            assert g is None, name
            continue
        if g.dtype != e.dtype or g.shape != e.shape:
            raise AssertionError(f"B2 {name}: {g.dtype} {tuple(g.shape)} against {e.dtype} {tuple(e.shape)}")
        err = (g.float() - e.float()).abs().max().item()
        out[name] = (err, tol * (1 + e.float().abs().max().item()))
    return out


def check_b2(dev):
    """Phase 6: B2 against its plain version, autograd through the kernels,
    timings and extra memory at the 2x chunk shape."""
    import torch.nn.functional as F

    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.ops.attention import NEG_BIAS, attention_alpha
    from vpt_tpu_torch.ops.rel_bias import relattn_bias

    main_err = None
    for d in (128, 64, 192):
        for dtype in (torch.float32, torch.bfloat16):
            for use_mask, use_rel in ((True, True), (False, False), (True, False)):
                q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, d, dtype, d + 1)
                mask = mask if use_mask else None
                R, b_nd = (R, b_nd) if use_rel else (None, None)
                dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(d), device=dev).to(dtype)
                got = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
                torch.cuda.synchronize()
                errs = b2_errors(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True), dtype)
                log(f"B2 d={d} {str(dtype)[6:]} mask={use_mask} rel={use_rel}: max_abs_err (tol) "
                    + ", ".join(f"{n} {e:.3e} ({b:.2e})" for n, (e, b) in errs.items()))
                if not all(e <= b for e, b in errs.values()):
                    raise AssertionError(f"B2 disagrees with its plain version: {errs}")
                if d == 128 and dtype == torch.float32 and use_mask and use_rel:
                    main_err = max(e for e, _ in errs.values())

    # autograd through windowed_attention_fwd (B1 forward, B2 backward) against the plain forward's
    q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, 128, torch.float32, 3)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, R, b_nd)]
    dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    f0, b0 = wa.launches, wa.bwd_launches
    out = wa.windowed_attention_fwd(leaves[0], leaves[1], leaves[2], mask, leaves[3], leaves[4], True)
    got = torch.autograd.grad(out, leaves, dO)
    torch.cuda.synchronize()
    if (wa.launches - f0, wa.bwd_launches - b0) != (1, 1):
        raise AssertionError(f"autograd launched B1 {wa.launches - f0} and B2 {wa.bwd_launches - b0} times")
    out = wa.windowed_attention_fwd_plain(leaves[0], leaves[1], leaves[2], mask, leaves[3], leaves[4], True)
    errs = b2_errors(got, torch.autograd.grad(out, leaves, dO), torch.float32)
    log("autograd through windowed_attention_fwd vs plain forward (2x chunk, f32): max_abs_err (tol) "
        + ", ".join(f"{n} {e:.3e} ({b:.2e})" for n, (e, b) in errs.items()))
    if not all(e <= b for e, b in errs.values()):
        raise AssertionError(f"autograd through the kernels disagrees with the plain forward: {errs}")

    # timings at the main path's shape: 2x chunk, mask and bias, float32 (the main path's type) and bfloat16
    q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, 128, torch.float32, 0)
    dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    ms, plain_ms, library_ms, bound_ms, bound_by = time_b2(q, k, v, mask, R, b_nd, dO)
    time_b2(*(x.bfloat16() for x in (q, k, v)), mask, R, b_nd, dO.bfloat16())

    # memory beyond inputs and outputs: below one (B, H, t, T) f32 tensor, so dL never reaches HBM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
    torch.cuda.synchronize()
    outputs = sum(g.numel() * g.element_size() for g in grads)
    extra = torch.cuda.max_memory_allocated() - base - outputs
    dl_bytes = q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] * 4
    log(f"B2 memory beyond inputs and outputs: {extra / 1e6:.3f} MB (one (B, H, t, T) f32 tensor is "
        f"{dl_bytes / 1e6:.3f} MB)")
    if not extra < dl_bytes:
        raise AssertionError(f"B2 allocated {extra} bytes beyond its inputs and outputs, >= {dl_bytes}")
    return {
        "name": "windowed_attention_bwd",
        "route": "cuda",
        "source": "vpt_tpu_torch/csrc/windowed_attention_bwd.cu",
        "replaces": "vpt_tpu/ops/pallas_attention_impl.py:112",
        "launches": None,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def bc_batch(dev, B, T, hw, seed, firsts_at=(), masked_tail=None):
    """A seeded training batch on `dev`: stream i restarts its episode at
    firsts_at[i] (if any); masked_tail = (stream, first padded step)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {
        "frames": torch.randint(0, 256, (B, T, hw, hw, 3), generator=g, device=dev, dtype=torch.uint8),
        "buttons": torch.randint(0, 8641, (B, T), generator=g, device=dev),
        "camera": torch.randint(0, 121, (B, T), generator=g, device=dev),
        "firsts": torch.zeros((B, T), dtype=torch.bool, device=dev),
        "mask": torch.ones((B, T), dtype=torch.bool, device=dev),
    }
    for i, step in enumerate(firsts_at):
        if step is not None:
            batch["firsts"][i, step] = True
    if masked_tail is not None:
        batch["mask"][masked_tail[0], masked_tail[1]:] = False
    return batch


def value_head_copy(trainer):
    return {k: v.detach().clone() for k, v in trainer.policy.value_head.state_dict().items()}


def rel_l2(got, expect):
    return ((got - expect).norm() / expect.norm().clamp_min(1e-30)).item()


def same_tensors(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def train_card_vs_cpu(dev):
    """Phase 7(a): one 2x train_step on the card and on the CPU from the same
    weights and batch; returns the card's trainer."""
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.training.bc import BCTrainer

    t0 = time.perf_counter()
    gpu = BCTrainer(FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, seed=0, device=dev)
    cpu = BCTrainer(FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, seed=0, device="cpu")
    gpu.init()
    cpu.init()
    log(f"2x BCTrainer on the card and on the CPU built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in gpu.policy.parameters())} parameters, "
        f"{sum(p.numel() for p in gpu.trainable_parameters())} trained)")
    if not same_tensors(gpu.policy.state_dict(), cpu.policy.state_dict()):
        raise AssertionError("the card's and the CPU's trainers start from different weights")
    vh = value_head_copy(cpu)
    batch = bc_batch(torch.device("cpu"), 2, 4, gpu.cfg.img_shape[0], 7, firsts_at=(None, 2), masked_tail=(0, 3))

    # calibration: the CNN's grads on the card with cuDNN's convolutions and with torch's own
    def cnn_grads():
        gpu.optimizer.zero_grad()
        nll, _ = gpu.masked_nll(gpu.to_device(batch), gpu.initial_state(2))
        nll.backward()
        grads = {n: p.grad.detach().clone() for n, p in gpu.policy.named_parameters() if n.startswith(CNN_PREFIX)}
        gpu.optimizer.zero_grad()
        return grads

    with_cudnn = cnn_grads()
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        without_cudnn = cnn_grads()
    calib = max(rel_l2(with_cudnn[n], without_cudnn[n]) for n in with_cudnn)

    state_g, loss_g, norm_g = gpu.train_step({k: v.to(dev) for k, v in batch.items()}, gpu.initial_state(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_c, loss_c, norm_c = cpu.train_step(batch, cpu.initial_state(2))
    cpu_s = time.perf_counter() - t0
    loss_err = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    norm_err = abs(norm_g.item() - norm_c.item()) / abs(norm_c.item())
    worst, worst_cnn = (0.0, ""), (0.0, "")
    for (name, pg), (_, pc) in zip(gpu.policy.named_parameters(), cpu.policy.named_parameters()):
        if name.startswith("value_head."):
            if pg.grad is not None or pc.grad is not None:
                raise AssertionError(f"{name} has a gradient")
            continue
        if name.startswith(CNN_PREFIX):
            worst_cnn = max(worst_cnn, (rel_l2(pg.grad.cpu(), pc.grad), name))
            continue
        err = (pg.grad.cpu() - pc.grad).abs().max().item()
        ratio = err / (GRAD_RTOL * pc.grad.abs().max().item() + GRAD_ATOL)
        worst = max(worst, (ratio, name))
    log(f"train_step card vs CPU (2x, B=2, T=4, f32): loss {loss_g.item():.6f} vs {loss_c.item():.6f} "
        f"(rel {loss_err:.2e}, tol {LOSS_RTOL}), grad norm {norm_g.item():.6f} vs {norm_c.item():.6f} "
        f"(rel {norm_err:.2e}, tol {NORM_RTOL}); CPU step {cpu_s:.1f} s")
    log(f"  grads outside the CNN: worst max-abs error / ({GRAD_RTOL} max|grad| + {GRAD_ATOL}) {worst[0]:.3f} "
        f"({worst[1]}); CNN grads: worst relative L2 error {worst_cnn[0]:.3e} ({worst_cnn[1]}, tol "
        f"{CNN_GRAD_REL_L2}), against {calib:.3e} between cuDNN's and torch's convolutions on the card")
    if not (loss_err <= LOSS_RTOL and norm_err <= NORM_RTOL and worst[0] <= 1.0 and worst_cnn[0] <= CNN_GRAD_REL_L2):
        raise AssertionError("the train step on the card disagrees with the CPU's")
    if not (same_tensors(value_head_copy(gpu), vh) and same_tensors(value_head_copy(cpu), vh)):
        raise AssertionError("a train step moved the value head")
    return gpu


def train_steps(trainer, dev, B=4, T=128, steps=5):
    """Phase 7(b): `steps` optimizer steps at (B, T) with the state carried,
    per-stream resets and a padded tail; B1 and B2 launch once per block and step."""
    from vpt_tpu_torch.ops import windowed_attention as wa

    batches = [bc_batch(dev, B, T, trainer.cfg.img_shape[0], 100 + s,
                        firsts_at=[0 if s == 0 else (17 * i + 31 * s) % T if (i + s) % 2 else None
                                   for i in range(B)],
                        masked_tail=(B - 1, T - 40) if s == steps - 1 else None)
               for s in range(steps)]
    vh = value_head_copy(trainer)
    before = [p.detach().clone() for p in trainer.trainable_parameters()]
    state = trainer.initial_state(B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.launches = wa.bwd_launches = 0
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, loss, norm = trainer.train_step(batch, state)
        losses.append(loss.item())  # synchronises
        times.append(time.perf_counter() - t0)
    f_launches, b_launches = wa.launches, wa.bwd_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = 1e3 * sum(times[1:]) / (steps - 1)
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(trainer.trainable_parameters(), before))
    log(f"BC train ({B}x{T}, 2x, f32): losses {[round(x, 6) for x in losses]}, last grad norm {norm.item():.4f}; "
        f"{step_ms:.1f} ms/step from the second step ({B * T / step_ms * 1e3:.1f} frames/s), "
        f"first step {times[0] * 1e3:.1f} ms; peak memory {peak_gb:.2f} GB; largest parameter change {moved:.3e}; "
        f"launches over {steps} steps: B1 {f_launches}, B2 {b_launches}")
    n_blocks = trainer.cfg.n_recurrence_layers
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"training did not run: losses {losses}, largest change {moved}")
    if not same_tensors(value_head_copy(trainer), vh):
        raise AssertionError("training moved the value head")
    if (f_launches, b_launches) != (n_blocks * steps, n_blocks * steps):
        raise AssertionError(f"B1 launched {f_launches} and B2 {b_launches} times in {steps} steps, "
                             f"expected {n_blocks * steps} each")

    # where a step's time goes: forward, backward, optimizer, each synchronised
    batch = trainer.to_device(batches[0])
    trainer.optimizer.zero_grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nll, _ = trainer.masked_nll(batch, trainer.initial_state(B))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (nll / (B * T)).backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    trainer.optimizer.step()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"  one step split: forward {1e3 * (t1 - t0):.1f} ms, backward {1e3 * (t2 - t1):.1f} ms, "
        f"clip + Adam {1e3 * (t3 - t2):.1f} ms")
    return b_launches // steps


def time_kernels(dev):
    """--time-kernels: B1's and B2's times in both types at the 2x chunk shape."""
    q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, 128, torch.float32, 0)
    dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv, oo = (x.to(dtype) for x in (q, k, v, dO))
        name = str(dtype)[6:]
        times[f"B1 {name}"] = dict(zip(keys, time_b1(qq, kk, vv, mask, R, b_nd)))
        times[f"B2 {name}"] = dict(zip(keys, time_b2(qq, kk, vv, mask, R, b_nd, oo)))
    return times


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--time-kernels", action="store_true", help="time kernels B1 and B2 alone and stop")
    args = parser.parse_args()
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
    report = cuda_build.build(KERNELS)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        ptxas = [ln for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {r['seconds']:.1f} s; " + " | ".join(ptxas))
    if args.time_kernels:
        print(json.dumps({"kernel_times": time_kernels(dev), "device": smi.splitlines()[0]}), flush=True)
        return 0
    check_tensor_cores(KERNELS)

    b1 = check_b1(dev)
    agent = stepped_rollout(dev)
    b1["launches"] = stepwise_equals_chunkwise(agent, dev)
    del agent
    b2 = check_b2(dev)
    torch.cuda.empty_cache()
    trainer = train_card_vs_cpu(dev)
    b2["launches"] = train_steps(trainer, dev)

    log(json.dumps({"kernels": [b1, b2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
