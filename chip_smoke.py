"""Drive the PyTorch port (vpt_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel of the main path from the sources in csrc/, and
     count the tensor-core instructions (HMMA, HGMMA) of each kernel in the
     built library's SASS (cuobjdump): a kernel with none fails the run;
  3. kernel B1 (windowed attention forward) against its plain PyTorch
     version at the 2x chunk shape (B=4, H=16, t=128, T=256, d=128) and at
     d = 64 and 192, with mask and relative bias, with neither, with the
     mask alone and with the bias alone, in float32 and bfloat16; and at the
     4x IDM's shapes (H=32, no mask, with the bias; t=128, T=256 and t=8,
     T=136); with its time in both types, at the 2x chunk and at the IDM's
     labeling shape, beside the plain version's, SDPA's on a materialised
     bias (a yardstick the port never calls) and its bound;
  4. a stepped rollout: the 2x foundation MineRLAgent (random weights from a
     seed) serving 8 streams for 64 get_action calls on 360x640 frames,
     with episode resets;
  5. stepwise = chunkwise: 4 streams, 128 frames with mid-window resets,
     stepped at t=1 on the ring cache and as one (4, 128) chunked forward,
     which must launch B1 once per block;
  6. kernel B2 (windowed attention backward) against its plain PyTorch
     version at the shapes and in the four mask and bias cases of phase 3,
     and at the IDM's shapes, in float32 and bfloat16, all five gradients;
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
     per block and step;
  8. the 4x inverse dynamics model (IDM_4X_KWARGS: hidsize 4096, 32 heads,
     2 blocks, Impala width 16, conv3d front; random weights from seed 0):
     (a) its logits and one IDMTrainer.train_step (B=1, an 8-frame window) on
     the card against the CPU, as phase 7(a);
     (b) StreamingIDMLabeler over 512 synthetic 640x360 frames (window 128,
     stride 64, 4 windows a forward), in float32 and in bfloat16: every frame
     labeled once, in order, each label its owning window's direct
     prediction, B1 launched once per block and forward; frames/s, the host
     resize and the device forward each timed alone, the peak memory and the
     forward's split (conv3d, Impala CNN, blocks, head);
     (c) four IDM train steps at B=3 windows of T=128 in float32 (B1 and B2
     once per block and step), ms/step, frames/s, peak memory and the
     step's split;
     (d) IDMAgent.predict_actions on 512 frames (T = 640 keys, past the
     kernels' 512-key chunk), its logits against the same forward with the
     plain attention on the card, B1 once per block;
  9. KL-anchored PPO on the 2x policy (random weights from seed 0):
     (a) 2 streams x 16 steps collected on the card, then one update
     (n_epochs 1, n_minibatches 1, ending in one PPG aux step) on the card and
     on the CPU from the same weights and anchor: metrics, grad norm, every
     grad of both steps (as 7(a)) and the folded EWMA stats; and the stepped
     collection's logp and values against the chunked re-forward from the
     window-start snapshot, with 1 and 2 collection groups;
     (b) vpt_tpu's PPO geometry in bfloat16 (bench.py bench_ppo_collect): 64
     MockMinecraftEnv streams x 64 steps in 4 collection groups, 16
     minibatches of 4 streams, 3 epochs, the anchor forward in 1024-frame
     chunks; one warm and one timed collect and update: collect frames/s and
     the host resize's share, the update's split, peak memory, and B1 208 and
     B2 192 launches per update;
     (c) PPOTrainer.evaluate on 4 streams until 4 episodes end: a finite
     report, the trainer's generators untouched.
Phases 3 and 6 also check both kernels past 512 keys (T = 640 and 1152) and
time them at the IDM's long-call shape and at the PPO minibatch's.
It prints one JSON line with every kernel's numbers, then, last,
{"ok": true, "device": {...}}.  It exits non-zero, with no "ok" line, where
there is no CUDA device.

    python3 chip_smoke.py --time-kernels

times kernels B1 and B2 alone, in float32 and bfloat16, at every shape of at
most 512 keys that PERF.md's kernel table holds (the 2x chunk, the IDM's
labeling and training batches, the PPO minibatch), beside their plain
versions, SDPA and their bounds (phases 1 and 2's build, then the timings of
phases 3 and 6), and prints them as its last line.  It
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
IDM_CNN_PREFIXES = (CNN_PREFIX, "net.conv3d_layer.")  # the IDM's conv3d front too
BF16_LOGIT_TOL = 5e-2  # bfloat16 against float32 logits (tests/test_torch_policy.py)
# the 4x IDM on the card: labeling windows a forward, and the training batch
# (windows of 128 frames): the largest that fits in 80 GB without remat (a
# step's peak is ~71 GB at 3 windows, and each window adds ~20 GB)
IDM_WINDOW, IDM_STRIDE, IDM_WINDOW_BATCH, IDM_LABEL_FRAMES = 128, 64, 4, 512
IDM_TRAIN_B, IDM_TRAIN_STEPS = 3, 4
# (mask, relative bias) cases of phases 3 and 6; the IDM attends with the bias and no mask
MASK_REL_CASES = ((True, True), (False, False), (True, False), (False, True))
IDM_SHAPES = ((IDM_WINDOW, 128), (8, 128))  # (t, maxlen): the labeling window, phase 8(a)'s window
# (t, maxlen) past the kernels' 512-key chunk: the IDM's 512-frame predict_actions (T = 640), and
# three chunks with the longest band table (T = 1152); the long call's timing shape (B, H)
LONG_SHAPES = ((512, 128), (640, 512))
LONG_CALL_B, LONG_CALL_H = 1, 32
# PPO at vpt_tpu's bench geometry (bench.py bench_ppo_collect): streams, steps, collection groups,
# minibatches (4 streams of 64 steps: 256 frames, bench's fit rule at 2x), epochs, anchor chunk frames
PPO_STREAMS, PPO_STEPS, PPO_GROUPS, PPO_MINIBATCHES, PPO_EPOCHS, PPO_ANCHOR_FRAMES = 64, 64, 4, 16, 3, 1024
PPO_CHECK_STREAMS, PPO_CHECK_STEPS = 2, 16  # phase 9(a)
STATS_RTOL = 1e-6  # the folded EWMA stats, card against CPU
# Phase 9(a)'s grads outside the CNN, on relative L2 as the CNN's: its update
# sums over 32 frames, ~1M ReLU decisions of the blocks' MLPs (8 in phase 7(a):
# ~0.25M), and one decision that rounding flips moves a whole term of a row of
# a weight's gradient, a few percent of that row; over a whole tensor that is
# ~1e-3 in L2, while a wrong attention gradient is O(1)
PPO_GRAD_REL_L2 = 1e-2
TIME_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")


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


def materialised_bias(mask, R, b_nd, T, dtype):
    """The (B, H, t, T) additive bias that SDPA takes: the relative bias and
    the mask's -1e9 where there is one."""
    from vpt_tpu_torch.ops.attention import NEG_BIAS
    from vpt_tpu_torch.ops.rel_bias import relattn_bias

    bias = relattn_bias(R, b_nd, T)
    if mask is not None:
        bias = bias + torch.where(mask[:, None], 0.0, NEG_BIAS)
    return bias.to(dtype)


def time_b1(q, k, v, mask, R, b_nd, label="2x chunk"):
    """B1's time beside its plain version's, SDPA's on a materialised bias
    (in q's dtype) and its bound, at these inputs."""
    import torch.nn.functional as F

    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.ops.attention import attention_alpha

    ms = kernel_time_ms(lambda: wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True))
    plain_ms, plain_alone = cuda_time_ms(lambda: wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True))
    bias = materialised_bias(mask, R, b_nd, k.shape[2], q.dtype)
    alpha = attention_alpha(q.shape[-1], True)
    library_ms, library_alone = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=alpha))
    bound_ms, bound_by, nbytes, flops = b1_bound(q, k, v, mask, R, b_nd)
    log(f"B1 {label} {str(q.dtype)[6:]}: {ms:.4f} ms, plain {plain_ms:.4f} ms{timed_note(plain_alone)}, "
        f"SDPA+bias {library_ms:.4f} ms{timed_note(library_alone)}; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def check_b1_case(wa, q, k, v, mask, R, b_nd, label):
    """B1 on these inputs against its plain version; returns the max-abs error."""
    got = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
    torch.cuda.synchronize()
    err = (got.float() - wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True).float()).abs().max().item()
    tol = F32_TOL if q.dtype == torch.float32 else BF16_TOL
    log(f"B1 {label} {str(q.dtype)[6:]} mask={mask is not None} rel={R is not None}: max_abs_err {err:.3e} "
        f"(tol {tol})")
    if not err <= tol:
        raise AssertionError(f"B1 disagrees with its plain version ({label}): {err} > {tol}")
    return err


def check_b1(dev):
    """Phase 3: B1 against its plain version, past 512 keys too; timings at
    the 2x chunk, the IDM's labeling and long-call shapes and the PPO
    minibatch's."""
    import torch.nn.functional as F

    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.ops.attention import attention_alpha

    main_err = None
    for d in (128, 64, 192):
        for dtype in (torch.float32, torch.bfloat16):
            for use_mask, use_rel in MASK_REL_CASES:
                q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, d, dtype, d)
                mask = mask if use_mask else None
                R, b_nd = (R, b_nd) if use_rel else (None, None)
                err = check_b1_case(wa, q, k, v, mask, R, b_nd, f"d={d}")
                if d == 128 and dtype == torch.float32 and use_mask and use_rel:
                    main_err = err
    for t, maxlen in IDM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _, R, b_nd = attention_inputs(dev, IDM_WINDOW_BATCH, 32, t, maxlen, 128, dtype, t)
            check_b1_case(wa, q, k, v, None, R, b_nd, f"IDM H=32 t={t} T={t + maxlen}")
    for t, maxlen in LONG_SHAPES:  # past the 512-key chunk: the kernel walks the keys in chunks
        for d in (64, 128, 192):
            for dtype in (torch.float32, torch.bfloat16):
                for use_mask, use_rel in MASK_REL_CASES:
                    q, k, v, mask, R, b_nd = attention_inputs(dev, 2, 16, t, maxlen, d, dtype, d + t)
                    check_b1_case(wa, q, k, v, mask if use_mask else None, R if use_rel else None,
                                  b_nd if use_rel else None, f"d={d} t={t} T={t + maxlen}")

    # timings at the main path's shape: 2x chunk, mask and bias, float32 (the main path's type) and bfloat16
    q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, 128, torch.float32, 0)
    bias = materialised_bias(mask, R, b_nd, k.shape[2], q.dtype)
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
        # a window batch of 4 at 32 heads, no mask; the IDM's 512-frame predict_actions; the PPO minibatch
        "idm_labeling_shape": shape_times(time_b1, dev, IDM_WINDOW_BATCH, 32, IDM_WINDOW, 128, False, "IDM window"),
        "long_call_shape": shape_times(time_b1, dev, LONG_CALL_B, LONG_CALL_H, 512, 128, False, "IDM long call"),
        "ppo_minibatch_shape": shape_times(time_b1, dev, PPO_STREAMS // PPO_MINIBATCHES, 16, PPO_STEPS, 128, True,
                                           "PPO minibatch"),
    }


def shape_times(timer, dev, B, H, t, maxlen, use_mask, label):
    """{dtype: the timing keys} of time_b1 or time_b2 at (B, H, t, T = t +
    maxlen, d = 128) with the relative bias, in float32 and bfloat16."""
    q, k, v, mask, R, b_nd = attention_inputs(dev, B, H, t, maxlen, 128, torch.float32, 0)
    mask = mask if use_mask else None
    extra = ()
    if timer is time_b2:
        extra = (torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(6), device=dev),)
    return {str(dt)[6:]: dict(zip(TIME_KEYS, timer(q.to(dt), k.to(dt), v.to(dt), mask, R, b_nd,
                                                   *(x.to(dt) for x in extra), label=label)))
            for dt in (torch.float32, torch.bfloat16)}


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
        packed, agent.hidden_state = agent._step(img, no_reset, True, agent.hidden_state)
        packed.cpu()
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


def time_b2(q, k, v, mask, R, b_nd, dO, label="2x chunk"):
    """B2's time beside its plain version's, SDPA's forward and backward on a
    materialised bias (in q's dtype; q, k, v grads only) and its bound."""
    import torch.nn.functional as F

    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.ops.attention import attention_alpha

    ms = kernel_time_ms(lambda: wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True))
    plain_ms, plain_alone = cuda_time_ms(lambda: wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True))
    bias = materialised_bias(mask, R, b_nd, k.shape[2], q.dtype)
    alpha = attention_alpha(q.shape[-1], True)
    ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias, scale=alpha)
        return torch.autograd.grad(out, (ql, kl, vl), dO)

    library_ms, library_alone = cuda_time_ms(sdpa_fwd_bwd)
    bound_ms, bound_by, nbytes, flops = b2_bound(q, k, v, mask, R, b_nd)
    log(f"B2 {label} {str(q.dtype)[6:]}: {ms:.4f} ms, plain {plain_ms:.4f} ms{timed_note(plain_alone)}, "
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
    from vpt_tpu_torch.ops import windowed_attention as wa

    main_err = None
    for d in (128, 64, 192):
        for dtype in (torch.float32, torch.bfloat16):
            for use_mask, use_rel in MASK_REL_CASES:
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
    for t, maxlen in IDM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _, R, b_nd = attention_inputs(dev, IDM_TRAIN_B, 32, t, maxlen, 128, dtype, t + 1)
            dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(t), device=dev).to(dtype)
            got = wa.windowed_attention_bwd(q, k, v, None, R, b_nd, dO, True)
            torch.cuda.synchronize()
            errs = b2_errors(got, wa.windowed_attention_bwd_plain(q, k, v, None, R, b_nd, dO, True), dtype)
            log(f"B2 IDM H=32 t={t} T={t + maxlen} {str(dtype)[6:]} mask=False rel=True: max_abs_err (tol) "
                + ", ".join(f"{n} {e:.3e} ({b:.2e})" for n, (e, b) in errs.items()))
            if not all(e <= b for e, b in errs.values()):
                raise AssertionError(f"B2 disagrees with its plain version at the IDM's shape: {errs}")
    for t, maxlen in LONG_SHAPES:  # past the 512-key chunk: pass 1 sweeps the keys in chunks
        for d in (64, 128, 192):
            for dtype in (torch.float32, torch.bfloat16):
                for use_mask, use_rel in MASK_REL_CASES:
                    q, k, v, mask, R, b_nd = attention_inputs(dev, 2, 16, t, maxlen, d, dtype, d + t + 1)
                    mask = mask if use_mask else None
                    R, b_nd = (R, b_nd) if use_rel else (None, None)
                    dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(t),
                                     device=dev).to(dtype)
                    got = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
                    torch.cuda.synchronize()
                    errs = b2_errors(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True), dtype)
                    log(f"B2 d={d} t={t} T={t + maxlen} {str(dtype)[6:]} mask={use_mask} rel={use_rel}: "
                        "max_abs_err (tol) " + ", ".join(f"{n} {e:.3e} ({b:.2e})" for n, (e, b) in errs.items()))
                    if not all(e <= b for e, b in errs.values()):
                        raise AssertionError(f"B2 disagrees with its plain version past 512 keys: {errs}")

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
    # and at the IDM's train step (32 heads, no mask), the IDM's long call and the PPO minibatch
    idm = shape_times(time_b2, dev, IDM_TRAIN_B, 32, IDM_WINDOW, 128, False, "IDM window")
    long_call = shape_times(time_b2, dev, LONG_CALL_B, LONG_CALL_H, 512, 128, False, "IDM long call")
    ppo = shape_times(time_b2, dev, PPO_STREAMS // PPO_MINIBATCHES, 16, PPO_STEPS, 128, True, "PPO minibatch")

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
        "idm_train_shape": idm,
        "long_call_shape": long_call,
        "ppo_minibatch_shape": ppo,
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


def cudnn_calibration(trainer, batch, prefixes):
    """The worst relative L2 gap between the grads of the parameters under
    `prefixes` of one loss on the card with cuDNN's convolutions and with
    torch's own, without a step."""
    return conv_calibration(
        trainer.policy,
        lambda: trainer.masked_nll(trainer.to_device(batch), trainer.initial_state(len(batch["mask"])))[0], prefixes)


def conv_calibration(policy, loss_fn, prefixes):
    """cudnn_calibration for any loss: loss_fn() builds it from `policy`."""
    def grads():
        policy.zero_grad(set_to_none=True)
        loss_fn().backward()
        out = {n: p.grad.detach().clone() for n, p in policy.named_parameters() if n.startswith(prefixes)}
        policy.zero_grad(set_to_none=True)
        return out

    with_cudnn = grads()
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        without_cudnn = grads()
    return max(rel_l2(with_cudnn[n], without_cudnn[n]) for n in with_cudnn)


def step_errors(gpu, cpu, got, expect, cnn_prefixes):
    """A train step on the card against the CPU's: the relative errors of
    loss and grad norm (got, expect = (loss, grad_norm)), the worst grad
    outside the CNN as a (max-abs error over its limit, name) pair and the
    worst CNN grad as a (relative L2 error, name) pair.  Parameters without
    a grad on either side are skipped."""
    loss_err, norm_err = (abs(g.item() - e.item()) / abs(e.item()) for g, e in zip(got, expect))
    grads = [{n: p.grad for n, p in t.policy.named_parameters() if p.grad is not None} for t in (gpu, cpu)]
    return (loss_err, norm_err) + grad_errors(*grads, cnn_prefixes)


def grad_errors(gpu_grads, cpu_grads, cnn_prefixes):
    """(worst grad outside the CNN as (max-abs error over its limit, name),
    worst CNN grad as (relative L2 error, name)) of two {name: grad} dicts."""
    assert gpu_grads.keys() == cpu_grads.keys(), set(gpu_grads) ^ set(cpu_grads)
    worst, worst_cnn = (0.0, ""), (0.0, "")
    for name, gc in cpu_grads.items():
        gg = gpu_grads[name].cpu()
        if name.startswith(cnn_prefixes):
            worst_cnn = max(worst_cnn, (rel_l2(gg, gc), name))
            continue
        err = (gg - gc).abs().max().item()
        worst = max(worst, (err / (GRAD_RTOL * gc.abs().max().item() + GRAD_ATOL), name))
    return worst, worst_cnn


def step_split(trainer, batch, B, T):
    """Log where one train step's time goes: forward, backward, optimizer,
    each ended by a synchronise."""
    batch = trainer.to_device(batch)
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
    calib = cudnn_calibration(gpu, batch, (CNN_PREFIX,))

    state_g, loss_g, norm_g = gpu.train_step({k: v.to(dev) for k, v in batch.items()}, gpu.initial_state(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_c, loss_c, norm_c = cpu.train_step(batch, cpu.initial_state(2))
    cpu_s = time.perf_counter() - t0
    if any(p.grad is not None for t in (gpu, cpu) for p in t.policy.value_head.parameters()):
        raise AssertionError("the value head has a gradient")
    loss_err, norm_err, worst, worst_cnn = step_errors(gpu, cpu, (loss_g, norm_g), (loss_c, norm_c), (CNN_PREFIX,))
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

    step_split(trainer, batches[0], B, T)
    return b_launches // steps


def idm_batch(B, T, seed, masked_tail=None):
    """A seeded IDM training batch on the host, in the loader's format (joint
    action indices); masked_tail = (window, first padded step)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), bool)
    if masked_tail is not None:
        mask[masked_tail[0], masked_tail[1]:] = False
    return {"frames": rng.integers(0, 256, (B, T, 128, 128, 3), dtype=np.uint8),
            "buttons": rng.integers(0, 8641, (B, T)), "camera": rng.integers(0, 121, (B, T)),
            "firsts": np.zeros((B, T), bool), "mask": mask}


def idm_card_vs_cpu(dev):
    """Phase 8(a): the 4x IDM's logits and one train step (B=1, an 8-frame
    window, T=136 keys) on the card and on the CPU from the same weights;
    returns the card's trainer."""
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer

    t0 = time.perf_counter()
    hp = IDMHyperparams(batch_size=1, window=8)
    gpu = IDMTrainer(IDM_4X_KWARGS, {}, hp=hp, seed=0, device=dev)
    cpu = IDMTrainer(IDM_4X_KWARGS, {}, hp=hp, seed=0, device="cpu")
    gpu.init()
    cpu.init()
    log(f"4x IDMTrainer on the card and on the CPU built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in gpu.policy.parameters())} parameters)")
    if not same_tensors(gpu.policy.state_dict(), cpu.policy.state_dict()):
        raise AssertionError("the card's and the CPU's IDM trainers start from different weights")
    batch = idm_batch(1, 8, 11, masked_tail=(0, 6))

    with torch.no_grad():
        got = gpu.logits(gpu.to_device(batch)["frames"])
        expect = cpu.logits(cpu.to_device(batch)["frames"])
    logit_errs = {k: (got[k].cpu() - expect[k]).abs().max().item() for k in expect}
    log(f"4x IDM logits card vs CPU (B=1, 8 frames, f32): max_abs_err {logit_errs} (tol {STEP_TOL})")
    if not all(e <= STEP_TOL for e in logit_errs.values()):
        raise AssertionError(f"the IDM's logits on the card disagree with the CPU's: {logit_errs}")

    calib = cudnn_calibration(gpu, batch, IDM_CNN_PREFIXES)
    loss_g, norm_g = gpu.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_c, norm_c = cpu.train_step(batch)
    cpu_s = time.perf_counter() - t0
    loss_err, norm_err, worst, worst_cnn = step_errors(gpu, cpu, (loss_g, norm_g), (loss_c, norm_c), IDM_CNN_PREFIXES)
    log(f"IDM train_step card vs CPU (4x, B=1, T=8, f32): loss {loss_g.item():.6f} vs {loss_c.item():.6f} "
        f"(rel {loss_err:.2e}, tol {LOSS_RTOL}), grad norm {norm_g.item():.6f} vs {norm_c.item():.6f} "
        f"(rel {norm_err:.2e}, tol {NORM_RTOL}); CPU step {cpu_s:.1f} s")
    log(f"  grads outside the conv3d and CNN: worst max-abs error / ({GRAD_RTOL} max|grad| + {GRAD_ATOL}) "
        f"{worst[0]:.3f} ({worst[1]}); conv3d and CNN grads: worst relative L2 error {worst_cnn[0]:.3e} "
        f"({worst_cnn[1]}, tol {CNN_GRAD_REL_L2}), against {calib:.3e} between cuDNN's and torch's convolutions")
    if not (loss_err <= LOSS_RTOL and norm_err <= NORM_RTOL and worst[0] <= 1.0 and worst_cnn[0] <= CNN_GRAD_REL_L2):
        raise AssertionError("the IDM train step on the card disagrees with the CPU's")
    return gpu


def counted_dispatches(agent):
    """Count the window batches `agent` dispatches (the labeler's and the
    tail's), through an instance attribute over its method."""
    calls = []
    dispatch = agent.dispatch_actions_batched

    def counted(windows):
        calls.append(windows.shape[0])
        return dispatch(windows)

    agent.dispatch_actions_batched = counted
    return calls


def owned_labels(agent, resized, window, stride, window_batch):
    """Each frame's label re-derived from the labeler's contract: the window
    starting at s owns [s + lo, s + lo + stride) (the first from 0), the
    rest is the tail window's of the last `window` frames; windows predicted
    directly, grouped `window_batch` at a time as the labeler groups them."""
    n, lo = len(resized), (window - stride) // 2
    starts = list(range(0, n - window + 1, stride))
    owner = {}
    for s in starts:
        for i in range(0 if s == 0 else s + lo, min(s + lo + stride, n)):
            owner.setdefault(i, s)
    windows = {}
    for g in range(0, len(starts), window_batch):
        group = starts[g:g + window_batch]
        actions = agent.predict_actions_batched(np.stack([resized[s:s + window] for s in group]))
        windows.update((s, {k: v[r] for k, v in actions.items()}) for r, s in enumerate(group))
    tail = max(n - window, 0)
    if len(owner) < n:  # the tail window, predicted alone as the labeler predicts it
        tail_actions = {k: v[0] for k, v in agent.predict_actions_batched(resized[tail:][None]).items()}
    labels = []
    for i in range(n):
        s, actions = (owner[i], windows[owner[i]]) if i in owner else (tail, tail_actions)
        labels.append((i, {k: v[i - s] for k, v in actions.items()}))
    return labels


@torch.inference_mode()
def idm_forward_split(policy, img):
    """ms of the IDM forward's parts, each ended by a synchronise: conv3d
    front, Impala CNN (and its projection), blocks, head (relu, lastlayer,
    final_ln, action heads)."""
    from vpt_tpu_torch.models.policy import policy_initial_state

    net = policy.net
    b, t = img.shape[:2]
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    front = net.conv3d_front(net.img_preprocess(img))
    mark()
    x = net.img_process.forward_nchw(*front)
    mark()
    x, _ = net.recurrent_layer(x, torch.zeros((b, t), dtype=torch.bool, device=img.device),
                               policy_initial_state(net.cfg, b, device=img.device))
    mark()
    x = torch.nn.functional.relu(x)
    net.lastlayer(x)
    policy.pi_head(net.final_ln(x))
    mark()
    return {k: 1e3 * (marks[i + 1] - marks[i]) for i, k in enumerate(("conv3d", "impala_cnn", "blocks", "head"))}


def idm_labeling(dev, frames, compute_dtype):
    """Phase 8(b): StreamingIDMLabeler over `frames` with the 4x IDM in
    `compute_dtype`; returns (agent, labels, per-forward B1 launches, the
    logits of the first window batch)."""
    from vpt_tpu_torch.agent import IDMAgent, StreamingIDMLabeler
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.models.policy import policy_initial_state
    from vpt_tpu_torch.ops import windowed_attention as wa

    agent = IDMAgent(IDM_4X_KWARGS, {}, device=dev, compute_dtype=compute_dtype, seed=0)
    n_blocks = agent.cfg.n_recurrence_layers
    calls = counted_dispatches(agent)
    warm = StreamingIDMLabeler(agent, window=IDM_WINDOW, stride=IDM_STRIDE, window_batch=IDM_WINDOW_BATCH)
    for f in frames[:IDM_WINDOW + (IDM_WINDOW_BATCH - 1) * IDM_STRIDE]:  # one full window batch: cuDNN's first calls
        warm.feed(f)
    del calls[:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.launches = 0
    labeler = StreamingIDMLabeler(agent, window=IDM_WINDOW, stride=IDM_STRIDE, window_batch=IDM_WINDOW_BATCH)
    t0 = time.perf_counter()
    labels = []
    for f in frames:
        labels.extend(labeler.feed(f))
    labels.extend(labeler.finish())
    seconds = time.perf_counter() - t0
    launches, forwards, peak_gb = wa.launches, len(calls), torch.cuda.max_memory_allocated() / 1e9
    n = len(frames)
    if [i for i, _ in labels] != list(range(n)):
        raise AssertionError("the labeler did not label every frame once, in order")
    if launches != n_blocks * forwards:
        raise AssertionError(f"B1 launched {launches} times in {forwards} forwards, expected {n_blocks} a forward")

    t0 = time.perf_counter()
    resized = np.stack([labeler._resize(f) for f in frames])
    resize_s = time.perf_counter() - t0
    direct = owned_labels(agent, resized, IDM_WINDOW, IDM_STRIDE, IDM_WINDOW_BATCH)
    wrong = [i for (i, a), (_, b) in zip(labels, direct) if any(not np.array_equal(a[k], b[k]) for k in a)]
    if wrong:
        raise AssertionError(f"{len(wrong)} streamed labels differ from their owning window's prediction: {wrong[:8]}")

    stack = np.stack([resized[s:s + IDM_WINDOW] for s in range(0, IDM_WINDOW_BATCH * IDM_STRIDE, IDM_STRIDE)])
    agent.predict_actions_batched(stack)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        agent.predict_actions_batched(stack)
    forward_s = (time.perf_counter() - t0) / 3
    img = torch.from_numpy(stack).to(dev)
    split = idm_forward_split(agent.policy, img)
    with torch.inference_mode():
        first = torch.zeros(stack.shape[:2], dtype=torch.bool, device=dev)
        logits = agent.policy(img, first, policy_initial_state(agent.cfg, len(stack), device=dev))[0]["pi_logits"]
    frames_per_forward = IDM_WINDOW_BATCH * IDM_WINDOW
    log(f"IDM labeling ({compute_dtype}): {n} frames of 640x360, window {IDM_WINDOW}, stride {IDM_STRIDE}, "
        f"{IDM_WINDOW_BATCH} windows a forward: {n / seconds:.1f} frames/s end to end ({seconds:.2f} s, "
        f"{forwards} forwards, B1 launches {launches}); peak memory {peak_gb:.2f} GB; every label its owning "
        f"window's direct prediction")
    log(f"  alone: host resize {1e3 * resize_s / n:.3f} ms a frame ({n / resize_s:.1f} frames/s); device "
        f"forward of {IDM_WINDOW_BATCH} windows {1e3 * forward_s:.1f} ms ({frames_per_forward / forward_s:.1f} "
        f"frames/s, H2D and label D2H included)")
    log("  forward split (ms, each ended by a synchronise): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + f", total {sum(split.values()):.1f}")
    return agent, labels, launches // max(forwards, 1), {k: v.float() for k, v in logits.items()}


def idm_train_steps(trainer, B=IDM_TRAIN_B, T=IDM_WINDOW, steps=IDM_TRAIN_STEPS):
    """Phase 8(c): `steps` IDM train steps at (B, T), float32; B1 and B2
    launch once per block and step."""
    from vpt_tpu_torch.ops import windowed_attention as wa

    batches = [idm_batch(B, T, 200 + s, masked_tail=(B - 1, T - 40) if s == steps - 1 else None)
               for s in range(steps)]
    before = [p.detach().clone() for p in trainer.policy.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.launches = wa.bwd_launches = 0
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss, norm = trainer.train_step(batch)
        losses.append(loss.item())  # synchronises
        times.append(time.perf_counter() - t0)
    f_launches, b_launches = wa.launches, wa.bwd_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = 1e3 * sum(times[1:]) / (steps - 1)
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(trainer.policy.parameters(), before))
    log(f"IDM train ({B}x{T}, 4x, f32): losses {[round(x, 6) for x in losses]}, last grad norm {norm.item():.4f}; "
        f"{step_ms:.1f} ms/step from the second step ({B * T / step_ms * 1e3:.1f} frames/s), first step "
        f"{times[0] * 1e3:.1f} ms; peak memory {peak_gb:.2f} GB; largest parameter change {moved:.3e}; "
        f"launches over {steps} steps: B1 {f_launches}, B2 {b_launches}")
    n_blocks = trainer.cfg.n_recurrence_layers
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"IDM training did not run: losses {losses}, largest change {moved}")
    if (f_launches, b_launches) != (n_blocks * steps, n_blocks * steps):
        raise AssertionError(f"B1 launched {f_launches} and B2 {b_launches} times in {steps} IDM steps, "
                             f"expected {n_blocks * steps} each")

    step_split(trainer, batches[0], B, T)
    return f_launches // steps, b_launches // steps


def idm_long_call(dev, n_frames=512):
    """Phase 8(d): IDMAgent.predict_actions on `n_frames` frames from a fresh
    state (T = n_frames + maxlen keys, past the kernels' 512-key chunk): B1
    once per block, and the logits of that forward within STEP_TOL of the
    same forward with the plain attention on the card."""
    from vpt_tpu_torch.agent import IDMAgent
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.models import transformer
    from vpt_tpu_torch.models.policy import policy_initial_state
    from vpt_tpu_torch.ops import windowed_attention as wa

    agent = IDMAgent(IDM_4X_KWARGS, {}, device=dev, seed=0)
    frames = np.random.default_rng(1).integers(0, 256, (n_frames, 360, 640, 3), dtype=np.uint8)
    T = n_frames + agent.cfg.maxlen
    torch.cuda.synchronize()
    wa.launches = 0
    t0 = time.perf_counter()
    actions = agent.predict_actions(frames)
    seconds = time.perf_counter() - t0
    launches = wa.launches
    if launches != agent.cfg.n_recurrence_layers or actions["camera"].shape != (1, n_frames, 2):
        raise AssertionError(f"predict_actions on {n_frames} frames: B1 launched {launches} times, "
                             f"camera {actions['camera'].shape}")

    img = torch.from_numpy(agent._video_obs_to_agent(frames)).to(dev)
    first = torch.zeros(img.shape[:2], dtype=torch.bool, device=dev)
    with torch.inference_mode():
        got = agent.policy(img, first, policy_initial_state(agent.cfg, 1, device=dev))[0]["pi_logits"]
        kernel_attention = transformer.windowed_attention_fwd
        transformer.windowed_attention_fwd = wa.windowed_attention_fwd_plain
        try:
            expect = agent.policy(img, first, policy_initial_state(agent.cfg, 1, device=dev))[0]["pi_logits"]
        finally:
            transformer.windowed_attention_fwd = kernel_attention
    errs = {k: (got[k] - expect[k]).abs().max().item() for k in got}
    log(f"IDM predict_actions on {n_frames} frames (4x, f32, T={T} keys): {seconds:.2f} s incl. host resize, "
        f"B1 launches {launches}; logits against the plain attention on the card: max_abs_err {errs} "
        f"(tol {STEP_TOL})")
    if not all(e <= STEP_TOL for e in errs.values()):
        raise AssertionError(f"the IDM's long-call logits disagree with the plain attention's: {errs}")
    return launches


def check_idm(dev):
    """Phase 8: the 4x IDM (a) card against CPU, (c) training, (b) labeling
    in float32 and bfloat16, (d) a 512-frame predict_actions; returns the
    per-forward and per-step launches."""
    trainer = idm_card_vs_cpu(dev)
    train_launches = idm_train_steps(trainer)
    del trainer
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (IDM_LABEL_FRAMES, 360, 640, 3), dtype=np.uint8)
    agent, labels, per_forward, logits = idm_labeling(dev, frames, "float32")
    del agent
    torch.cuda.empty_cache()
    agent, labels16, _, logits16 = idm_labeling(dev, frames, "bfloat16")
    del agent
    torch.cuda.empty_cache()
    err = max((logits16[k] - logits[k]).abs().max().item() for k in logits)
    same = np.mean([all(np.array_equal(a[k], b[k]) for k in a) for (_, a), (_, b) in zip(labels, labels16)])
    log(f"IDM bfloat16 against float32: logits of a window batch max_abs_err {err:.3e} (tol {BF16_LOGIT_TOL}); "
        f"{100 * same:.1f}% of the frames get the same label (random heads have near-ties: not gated)")
    if not err <= BF16_LOGIT_TOL:
        raise AssertionError(f"the IDM's bfloat16 logits are {err} from the float32 ones")
    long_call = idm_long_call(dev)
    torch.cuda.empty_cache()
    return per_forward, train_launches, long_call


def attack_reward(env_action, obs, reward, done):
    """+1 whenever attack is pressed (the port CLI's demo reward)."""
    return float(env_action["attack"])


def captured_grads(trainer):
    """Make `trainer`'s optimizer keep a copy of the grads at each step;
    returns the list it appends {name: grad} to."""
    steps, step = [], trainer.optimizer.step

    def step_and_keep():
        steps.append({n: p.grad.detach().clone() for n, p in trainer.policy.named_parameters() if p.grad is not None})
        return step()

    trainer.optimizer.step = step_and_keep
    return steps


def reforward_errors(trainer, groups):
    """Phase 9(a): collect twice (the second window from carried state) with
    `groups` collection groups, then re-forward the window as one chunk from
    its snapshot; the max-abs gaps to the stepped logp_old and values."""
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.models.heads import dict_logprob

    trainer.hp.n_collect_groups = groups
    envs = [MockMinecraftEnv(seed=20 + i, done_prob=0.1) for i in range(PPO_CHECK_STREAMS)]
    traj, obs, firsts = trainer.collect(envs)
    traj, _, _ = trainer.collect(envs, obs, firsts)
    dev = trainer.device
    with torch.inference_mode():
        out, _ = trainer.policy(torch.from_numpy(traj["frames"]).to(dev), torch.from_numpy(traj["firsts"]).to(dev),
                                traj["initial_state"])
        actions = {k: torch.from_numpy(traj[k]).to(dev)[..., None] for k in ("buttons", "camera")}
        logp = dict_logprob(out["pi_logits"], actions, trainer.head_specs).cpu().numpy()
    return (float(np.abs(logp - traj["logp_old"]).max()),
            float(np.abs(out["vpred"][..., 0].cpu().numpy() - traj["values"]).max()))


def ppo_card_vs_cpu(dev):
    """Phase 9(a): a trajectory collected on the card, then one update and one
    PPG aux phase (one aux step) on the card and on the CPU from the same
    weights and anchor; and the collection's snapshot re-forward at G = 1
    and 2.

    Three settings, the same on both sides, keep the compared numbers off
    rounding noise: the anchor's action-head weights are scaled by 100 (the
    head's init gives near-uniform logits, so KL(π₀‖π_θ) would be ~0 at the
    first update), logp_old gets a seeded offset (so the ratio, its clip and
    approx_kl are not ~1, 0 and 0), and the advantages are not normalised
    (normalised ones have mean 0, and so would pg_loss at ratio ~1).

    The aux phase starts from the card's weights on both sides: Adam's first
    step moves every entry by lr whatever its gradient's size, so entries
    whose gradient is rounding noise leave the PPO step up to 2·lr apart, and
    the aux step's grads would compare that, not the aux step."""
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.models import transformer
    from vpt_tpu_torch.models.heads import dict_logprob
    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.training.rl import PPOHyperparams, PPOTrainer

    def make(device):
        hp = PPOHyperparams(rollout_len=PPO_CHECK_STEPS, n_epochs=1, n_minibatches=1, aux_phase_every=1000,
                            aux_epochs=1, normalize_advantages=False)
        trainer = PPOTrainer(FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, hp=hp, seed=0, device=device)
        trainer.init()
        with torch.no_grad():
            for head in trainer.anchor.pi_head.children():
                head.linear_layer.weight.mul_(100.0)
        return trainer

    t0 = time.perf_counter()
    gpu, cpu = make(dev), make("cpu")
    log(f"2x PPOTrainer on the card and on the CPU built in {time.perf_counter() - t0:.1f} s")
    if not (same_tensors(gpu.policy.state_dict(), cpu.policy.state_dict())
            and same_tensors(gpu.anchor.state_dict(), cpu.anchor.state_dict())):
        raise AssertionError("the card's and the CPU's PPO trainers start from different weights or anchors")

    errs = {g: reforward_errors(gpu, g) for g in (1, 2)}
    log("PPO collection (2x, f32, 2 streams x 16 steps, two windows): stepped logp_old / values against the "
        "chunked re-forward from the window-start snapshot, max_abs_err "
        + ", ".join(f"G={g}: {a:.3e} / {b:.3e}" for g, (a, b) in errs.items()) + f" (tol {STEP_TOL})")
    if not all(e <= STEP_TOL for pair in errs.values() for e in pair):
        raise AssertionError(f"the stepped collection disagrees with the snapshot re-forward: {errs}")

    gpu.hp.n_collect_groups = 1
    envs = [MockMinecraftEnv(seed=i, done_prob=0.1) for i in range(PPO_CHECK_STREAMS)]
    traj, _, _ = gpu.collect(envs, reward_fn=attack_reward)
    traj["logp_old"] = traj["logp_old"] + 0.3 * np.random.default_rng(5).standard_normal(
        traj["logp_old"].shape).astype(np.float32)
    traj_cpu = dict(traj, initial_state=[{k: v.cpu() for k, v in blk.items()} for blk in traj["initial_state"]])

    # calibrations on the card, for a loss through the whole policy: the grads
    # with cuDNN's convolutions against torch's own (the CNN), and with kernels
    # B1 and B2 against the plain attention (everything else)
    frames = torch.from_numpy(traj["frames"]).to(dev)
    firsts = torch.from_numpy(traj["firsts"]).to(dev)
    actions = {k: torch.from_numpy(traj[k]).to(dev)[..., None] for k in ("buttons", "camera")}

    def calibration_loss():
        out, _ = gpu.policy(frames, firsts, traj["initial_state"])
        return -dict_logprob(out["pi_logits"], actions, gpu.head_specs).mean() + out["vpred_raw"].pow(2).mean()

    def loss_grads():
        gpu.policy.zero_grad(set_to_none=True)
        calibration_loss().backward()
        out = {n: p.grad.detach().clone() for n, p in gpu.policy.named_parameters() if not n.startswith(CNN_PREFIX)}
        gpu.policy.zero_grad(set_to_none=True)
        return out

    calib = conv_calibration(gpu.policy, calibration_loss, (CNN_PREFIX,))
    with_kernels = loss_grads()
    kernel_attention = transformer.windowed_attention_fwd
    transformer.windowed_attention_fwd = wa.windowed_attention_fwd_plain
    try:
        with_plain = loss_grads()
    finally:
        transformer.windowed_attention_fwd = kernel_attention
    attn_calib = grad_errors(with_kernels, {k: v.cpu() for k, v in with_plain.items()}, (CNN_PREFIX,))[0]
    attn_calib_l2 = max(rel_l2(with_kernels[n], with_plain[n]) for n in with_kernels)
    del with_kernels, with_plain

    grads_g, grads_c = captured_grads(gpu), captured_grads(cpu)
    m_g = gpu.update(traj)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_c = cpu.update(traj_cpu)
    cpu_s = time.perf_counter() - t0
    stats_err = max(rel_l2(a.cpu(), b) for a, b in zip(gpu.policy.value_head.normalizer.buffers(),
                                                        cpu.policy.value_head.normalizer.buffers()))
    cpu.policy.load_state_dict(gpu.policy.state_dict())
    m_g.update(gpu._aux_phase())
    m_c.update(cpu._aux_phase())

    keys = ("pg_loss", "v_loss", "entropy", "anchor_kl", "approx_kl", "aux_v_loss")
    rel = {k: abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in keys}
    # the loss sums terms that nearly cancel: its rounding scales with the terms, not with the sum
    hp = gpu.hp
    terms = abs(m_c["pg_loss"]) + hp.vf_coef * abs(m_c["v_loss"]) + hp.ent_coef * abs(m_c["entropy"]) \
        + m_c["kl_coef"] / hp.kl_decay * abs(m_c["anchor_kl"])
    rel["loss"] = abs(m_g["loss"] - m_c["loss"]) / terms
    rel["grad_norm"] = abs(m_g["grad_norm"] - m_c["grad_norm"]) / m_c["grad_norm"]
    log("PPO update card vs CPU (2x, f32, 2 x 16, one PPO step, then one aux step from the same weights): "
        + ", ".join(f"{k} {m_g[k]:.6g} vs {m_c[k]:.6g} (rel {rel[k]:.2e})" for k in ("loss",) + keys + ("grad_norm",))
        + f" (the loss relative to the sum of its terms' sizes, {terms:.4g}); clip_frac {m_g['clip_frac']:.4f} vs "
        f"{m_c['clip_frac']:.4f}; aux_clone_kl {m_g['aux_clone_kl']:.3g} vs {m_c['aux_clone_kl']:.3g}; tol "
        f"{LOSS_RTOL} ({NORM_RTOL} for the grad norm); CPU update {cpu_s:.1f} s")
    log(f"  folded EWMA stats: relative error {stats_err:.2e} (tol {STATS_RTOL})")
    if len(grads_g) != 2 or len(grads_c) != 2:
        raise AssertionError(f"expected a PPO step and an aux step, got {len(grads_g)} and {len(grads_c)}")
    worst_l2 = []
    for name, g, c in zip(("PPO step", "aux step"), grads_g, grads_c):
        # at the first aux step the action heads' grads are zero in exact arithmetic (only the clone KL
        # reaches them, and π_θ = π_old is its minimum): both sides hold rounding noise there
        noise = sorted(n for n in c if name == "aux step" and n.startswith("pi_head."))
        noise_norm = max((c[n].norm().item() for n in noise), default=0.0)
        g, c = ({n: x[n] for n in c if n not in noise} for x in (g, c))
        w, wc = grad_errors(g, c, (CNN_PREFIX,))
        l2 = max((rel_l2(g[n].cpu(), c[n]), n) for n in c if not n.startswith(CNN_PREFIX))
        worst_l2.append((l2, wc))
        log(f"  {name} grads outside the CNN: worst relative L2 error {l2[0]:.3e} ({l2[1]}, tol {PPO_GRAD_REL_L2}), "
            f"worst max-abs error / ({GRAD_RTOL} max|grad| + {GRAD_ATOL}) {w[0]:.3f} ({w[1]}); CNN grads: worst "
            f"relative L2 error {wc[0]:.3e} ({wc[1]}, tol {CNN_GRAD_REL_L2})"
            + (f"; the action heads' {len(noise)} grads, zero but for rounding (largest norm {noise_norm:.3e} on "
               f"the CPU), not compared" if noise else ""))
    log(f"  calibrations on the card: cuDNN's against torch's convolutions, CNN grads {calib:.3e}; kernels B1 and B2 "
        f"against the plain attention, grads outside the CNN: worst relative L2 {attn_calib_l2:.3e}, worst max-abs "
        f"error / limit {attn_calib[0]:.3f} ({attn_calib[1]})")
    if not (all(rel[k] <= LOSS_RTOL for k in keys + ("loss",)) and rel["grad_norm"] <= NORM_RTOL
            and stats_err <= STATS_RTOL
            and all(l2[0] <= PPO_GRAD_REL_L2 and wc[0] <= CNN_GRAD_REL_L2 for l2, wc in worst_l2)):
        raise AssertionError("the PPO update on the card disagrees with the CPU's")
    if not (m_g["clip_frac"] > 0 and m_g["anchor_kl"] > 1e-3 and m_g["approx_kl"] > 1e-3):
        raise AssertionError(f"the compared PPO metrics are near rounding noise: {m_g}")
    return gpu


class Stopwatch:
    """Seconds spent in wrapped callables, each call ended by a synchronise."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            return out

        return timed


def ppo_at_bench_geometry(dev):
    """Phase 9(b): vpt_tpu's PPO geometry in bfloat16, one warm and one timed
    collect and update; returns the trainer and the timed update's B1 and B2
    launches."""
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.training import rl

    hp = rl.PPOHyperparams(rollout_len=PPO_STEPS, n_collect_groups=PPO_GROUPS, n_minibatches=PPO_MINIBATCHES,
                           n_epochs=PPO_EPOCHS, anchor_fwd_max_frames=PPO_ANCHOR_FRAMES)
    trainer = rl.PPOTrainer(FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, hp=hp, compute_dtype="bfloat16",
                            seed=0, device=dev)
    streams = PPO_STREAMS
    envs = [MockMinecraftEnv(seed=i) for i in range(streams)]
    t0 = time.perf_counter()
    traj, obs, firsts = trainer.collect(envs, reward_fn=attack_reward)
    trainer.update(traj)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    traj, obs, firsts = trainer.collect(envs, obs, firsts, reward_fn=attack_reward)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(4):
        trainer._resize(obs)
    resize_s = (time.perf_counter() - t0) / 4 * (PPO_STEPS + 1)  # a collect resizes every stream's frame T + 1 times
    frames = streams * PPO_STEPS

    watch = Stopwatch()
    trainer._anchor_logits = watch.wrap("anchor forward", trainer._anchor_logits)
    trainer._ppo_step = watch.wrap("epochs", trainer._ppo_step)
    trainer._fold_return_stats = watch.wrap("stats fold and GAE", trainer._fold_return_stats)
    gae = rl.compute_gae
    rl.compute_gae = watch.wrap("stats fold and GAE", gae)
    wa.launches = wa.bwd_launches = 0
    try:
        t0 = time.perf_counter()
        metrics = trainer.update(traj)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
    finally:
        rl.compute_gae = gae
        for name in ("_anchor_logits", "_ppo_step", "_fold_return_stats"):
            delattr(trainer, name)
    launches = (wa.launches, wa.bwd_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = dict(watch.seconds, other=update_s - sum(watch.seconds.values()))
    log(f"PPO at vpt_tpu's bench geometry (2x, bf16, {streams} streams x {PPO_STEPS} steps, {PPO_GROUPS} collection "
        f"groups, {PPO_MINIBATCHES} minibatches, {PPO_EPOCHS} epochs, anchor chunks of {PPO_ANCHOR_FRAMES} frames): "
        f"warm collect + update {warm_s:.1f} s; collect {collect_s:.2f} s ({frames / collect_s:.1f} frames/s; host "
        f"resize alone {resize_s:.2f} s, {100 * resize_s / collect_s:.1f}%); update {update_s:.2f} s "
        f"({frames / update_s:.1f} frames/s) = " + ", ".join(f"{k} {v:.2f} s" for k, v in split.items())
        + f"; peak memory {peak_gb:.2f} GB; B1 launches {launches[0]}, B2 {launches[1]}")
    log(f"  update metrics: " + json.dumps({k: round(v, 6) for k, v in metrics.items()}))
    n_blocks = trainer.cfg.n_recurrence_layers
    anchor_chunks = streams * PPO_STEPS // (PPO_ANCHOR_FRAMES // PPO_STEPS * PPO_STEPS)
    steps = PPO_EPOCHS * PPO_MINIBATCHES
    expect = ((anchor_chunks + steps) * n_blocks, steps * n_blocks)
    if launches != expect:
        raise AssertionError(f"the PPO update launched B1 {launches[0]} and B2 {launches[1]} times, expected {expect}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"the PPO update's metrics are not finite: {metrics}")
    return trainer, launches


def ppo_evaluate(trainer):
    """Phase 9(c): evaluate on 4 dedicated streams until 4 episodes end."""
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv

    generators = (trainer.sample_generator, trainer.perm_generator)
    before = [g.get_state() for g in generators]
    t0 = time.perf_counter()
    report = trainer.evaluate([MockMinecraftEnv(seed=10_000 + i, done_prob=0.02) for i in range(4)], 4,
                              max_episode_steps=100, reward_fn=attack_reward)
    seconds = time.perf_counter() - t0
    numbers = [report[k] for k in ("mean_return", "std_return", "mean_length", "mean_vpred")]
    numbers += list(report["action_stats"]["button_press_rate"].values()) + [report["latency"]["p99_ms"]]
    log(f"PPO evaluate (2x, bf16, 4 streams, done_prob 0.02, max 100 steps): {report['episodes']} episodes, "
        f"{report['steps']} steps in {seconds:.1f} s, mean return {report['mean_return']:.3f}, mean length "
        f"{report['mean_length']:.1f}, truncated {report['truncated_episodes']}, mean vpred "
        f"{report['mean_vpred']:.4f}, null-action rate {report['action_stats']['null_action_rate']}, step p99 "
        f"{report['latency']['p99_ms']} ms")
    if report["episodes"] != 4 or not all(np.isfinite(x) for x in numbers):
        raise AssertionError(f"the evaluation report is incomplete or not finite: {report}")
    if not all(torch.equal(b, g.get_state()) for b, g in zip(before, generators)):
        raise AssertionError("evaluate moved the trainer's generators")


def check_ppo(dev):
    """Phase 9: (a) card against CPU, (b) vpt_tpu's geometry, (c) evaluate;
    returns the (b) update's B1 and B2 launches."""
    trainer = ppo_card_vs_cpu(dev)
    del trainer
    torch.cuda.empty_cache()
    trainer, launches = ppo_at_bench_geometry(dev)
    ppo_evaluate(trainer)
    return launches


# --time-kernels' shapes besides the 2x chunk: (kernel, label, B, H, t, mask), all T = t + 128 <= 512
TIMED_SHAPES = (("B1", "IDM window", IDM_WINDOW_BATCH, 32, IDM_WINDOW, False),
                ("B2", "IDM window", IDM_TRAIN_B, 32, IDM_WINDOW, False),
                ("B1", "PPO minibatch", PPO_STREAMS // PPO_MINIBATCHES, 16, PPO_STEPS, True),
                ("B2", "PPO minibatch", PPO_STREAMS // PPO_MINIBATCHES, 16, PPO_STEPS, True))


def time_kernels(dev):
    """--time-kernels: B1's and B2's times in both types at the 2x chunk
    shape ("B1 float32", ...) and at TIMED_SHAPES ("B1 float32 IDM window", ...)."""
    q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, 128, torch.float32, 0)
    dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv, oo = (x.to(dtype) for x in (q, k, v, dO))
        name = str(dtype)[6:]
        times[f"B1 {name}"] = dict(zip(TIME_KEYS, time_b1(qq, kk, vv, mask, R, b_nd)))
        times[f"B2 {name}"] = dict(zip(TIME_KEYS, time_b2(qq, kk, vv, mask, R, b_nd, oo)))
    for kernel, label, B, H, t, use_mask in TIMED_SHAPES:
        timer = time_b1 if kernel == "B1" else time_b2
        for name, row in shape_times(timer, dev, B, H, t, 128, use_mask, label).items():
            times[f"{kernel} {name} {label}"] = row
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
    del trainer
    torch.cuda.empty_cache()
    per_forward, (b1_per_step, b2_per_step), long_call = check_idm(dev)
    b1["idm_launches"] = {"labeling_forward": per_forward, "train_step": b1_per_step, "long_call": long_call}
    b2["idm_launches"] = {"train_step": b2_per_step}
    torch.cuda.empty_cache()
    b1_update, b2_update = check_ppo(dev)
    b1["rl_launches"] = {"update": b1_update}
    b2["rl_launches"] = {"update": b2_update}

    log(json.dumps({"kernels": [b1, b2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
