"""Drive the PyTorch port (vpt_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions,
     the host's cores;
  2. build every CUDA kernel of the main path from the sources in csrc/ (and,
     meanwhile, the native host resize, csrc/host_resize.cpp, with g++: the
     run fails unless it loads), and count the tensor-core instructions
     (HMMA, HGMMA) of each kernel in the built library's SASS (cuobjdump): a
     kernel with none fails the run, but for the passes that multiply no
     matrices (B2's sum of the d b_nd partials, C1's split of the weights);
  3. kernel B1 (windowed attention forward) against its plain PyTorch
     version at the 2x chunk shape (B=4, H=16, t=128, T=256, d=128) and at
     d = 64, 192 and 256, with mask and relative bias, with neither, with the
     mask alone and with the bias alone, in float32 and bfloat16; and at the
     4x IDM's shapes (H=32, no mask, with the bias; t=128, T=256 and t=8,
     T=136); with its time in both types, at the 2x chunk and at the IDM's
     labeling shape, beside the plain version's, SDPA's on a materialised
     bias (a yardstick the port never calls) and its bound;
  4. a stepped rollout: the 2x foundation MineRLAgent (random weights from a
     seed) serving 8 streams for 64 deterministic get_action calls on
     360x640 frames, with episode resets, three times: frames resized by
     numpy on one thread (as before the native resize), by the native resize
     on the agent's thread pool, and on the device (resize_on_device); each
     with frames/s and the frame preparation's share; numpy and native give
     the same actions at every step; the device step in float32, bfloat16
     compute, and bfloat16 compute and parameters;
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
     per block and step and C1 14 times a step (every conv of the CNN's
     forward but the first, which takes the 3 RGB channels);
     (c) remat with the CNN in 8 frame chunks: one step at B=2 against the
     same chunked step without remat (loss 1e-6 relative, grads at (a)'s
     rules) and the chunked step against the whole CNN's (loss 1e-4, grads
     on relative L2 as in 9(a)); then three steps at the JAX default batch,
     B=8, T=128: ms a step and the peak; B1 twice a block and step (the
     recompute), B2 once, C1 224 times (14 a chunk, forward and recompute);
  8. the 4x inverse dynamics model (IDM_4X_KWARGS: hidsize 4096, 32 heads,
     2 blocks, Impala width 16, conv3d front; random weights from seed 0):
     (a) its logits and one IDMTrainer.train_step (B=1, an 8-frame window) on
     the card against the CPU, as phase 7(a);
     (b) StreamingIDMLabeler over 512 synthetic 640x360 frames (window 128,
     stride 64, 4 windows a forward), in float32 and in bfloat16: every frame
     labeled once, in order, each label its owning window's direct
     prediction, B1 launched once per block and forward, C1 15 times a
     forward in float32 (every conv behind the conv3d) and never in
     bfloat16; frames/s, the host
     resize and the device forward each timed alone, the peak memory and the
     forward's split (conv3d, Impala CNN, blocks, head);
     (c) four IDM train steps at B=3 windows of T=128 in float32 (B1 and B2
     once per block and step, C1 15 times a step), ms/step, frames/s, peak
     memory and the step's split;
     (d) IDMAgent.predict_actions on 512 frames (T = 640 keys, past the
     kernels' 512-key chunk), its logits against the same forward with the
     plain attention on the card, B1 once per block;
     (e) three IDM train steps at 8 windows of 128 with remat and the CNN in
     8 chunks: ms a step and the peak, C1 240 times a step;
     and (b)'s device forward with bfloat16 parameters;
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
     report, the trainer's generators untouched;
     (d) one collect and update at (b)'s geometry with a PPG aux phase after
     it (each aux step on all 4096 frames), remat and the CNN in 8 chunks:
     its seconds and peak (an out-of-memory error fails the run);
 10. the attention shapes past the published models' that vpt_tpu's Pallas
     kernel takes too: B1 and B2 against their plain versions with a
     640-wide band table (read from device memory) at d = 128 and 256, past
     512 keys and at 256 keys; and one transformer block each at d = 256
     and with a 640-wide band on the card against the CPU, forward and every
     gradient, through B1 and B2 once each;
 11. int8 serving and QAT at full width (random weights from seed 0):
     (a) the 2x MineRLAgent with quantize_dense beside the float32 agent from
     the same seed: its int8 codes and scales on the card equal byte for byte
     those the CPU derives from the float weights; four layers' int8
     products (torch._int_mm, at the 8 stepped rows, padded, and at 512) on
     the card equal the CPU's exactly; 64 lockstep steps x 8 streams hold
     the value within 0.15 and each head's log-probabilities within 0.25
     relative L2 of the float agent's (vpt_tpu's rules), every int8 product
     on CUDA; frames/s of both through the native pool, the device step
     alone (int8 with float32 and bfloat16 compute) and the resident weight
     bytes;
     (b) the 4x IDM with quantize_dense labels 8(b)'s 512 frames as 8(b)
     does (every frame once, in order, its owning window's prediction, B1
     once per block and forward): frames/s, the device forward against
     8(b)'s float32 and bfloat16 ones, the peak, the share of labels equal
     to the float32 agent's and the log-probabilities within 0.25;
     (c) BCTrainer(qat_dense=True): one step on the card against the CPU at
     7(a)'s size and rules, then three steps at B=4, T=128 (ms, peak, B1 and
     B2 once per block and step);
     (d) IDMTrainer(qat_dense=True): 8(a)'s logits and step, card against
     CPU, then one step with B1 and B2 once per block;
 12. resume at full width: BC (2x, B=4, T=128, the recurrent state carried),
     IDM (4x, 8(a)'s size) and PPO (2x, 9(a)'s 2 streams x 16 steps, 2
     epochs of 2 minibatches, each update's env streams fresh), with
     torch's deterministic algorithms on: 2 steps, a save through
     checkpoint/native.py; 4 uninterrupted step 3s from the saved state must
     agree bit for bit (the step is deterministic), and a restore into a
     fresh trainer of another seed and step 3 there must equal them bit for
     bit, in loss and in every parameter; the checkpoint's bytes and the
     save and restore seconds;
     B1 and B2 launched as a step of that trainer launches them;
 13. the reference API and the model variants at the 2x policy's widths
     (random weights from seed 0, float32):
     (a) on a (4, 128) chunk heads_from_recurrent(recurrent_layer(embed))
     equals forward, B1 once per block; over 64 steps at 8 streams on the
     linear state get_output_for_observation and v equal the stepped
     forward's pd and value, B1 once per block and call (one query row,
     129 keys); get_logprob_of_action and get_kl_of_action_dists on the card
     against the CPU; B1 at t=1, T=129 against its plain version, timed;
     (b) strided attention (stride 2 with maxlen 128, stride 4 with maxlen
     64) at the 2x chunk's attention shape, in float32 and bfloat16: B1 and
     B2 against the plain forward and backward, strided_attention's autograd
     launching each once; the first case's times beside the clipped-causal
     mask's (no bias), the bounds over the pairs each mask lets attend;
     (c) multi_layer_lstm, multi_layer_bilstm and multi_masked_lstm: a (4,
     128) chunked forward on the card against the CPU's recurrence and heads
     on the card's CNN output; stepwise = chunkwise (the masked LSTM with
     resets anywhere, the plain one with resets at the chunk start; a
     reversed block sees the future, so not the bilstm); 7(a)'s train step
     card against CPU; three steps at B=4, T=128 (ms, peak); MineRLAgent
     serving 8 streams x 64 steps through the native pool beside the
     transformer's;
     (d) recurrence_type "none" and batch norm: a forward and 7(a)'s train
     step on the card against the CPU, the batch-norm statistics (drawn away
     from 0 and 1) bit for bit the same after the step; a DictActionHead of
     a gaussian and a categorical head on a 2048-wide (4, 128) latent: its
     log-probabilities, entropy, KL and a deterministic sample on the card
     against the CPU;
     (e) 9(a) with multi_masked_lstm: the stepped collection against the
     re-forward from the window-start carries, one update card against CPU;
 14. distribution at world size 1: RANK=0, WORLD_SIZE=1, LOCAL_RANK=0 and a
     free MASTER_PORT, the group started by maybe_initialize_distributed,
     which must pick NCCL (its version printed); under torch's
     deterministic algorithms, each wrapped step against the meshless one
     from the same weights (random, seed 0):
     (a) BCTrainer on a dp=1 mesh under DDP, 3 steps of the 2x policy at
     B=4, T=128: bit for bit in loss, grad norm and every parameter;
     (b) the same steps under fully_shard on the 1-rank fsdp axis and under
     the tensor-parallel plan on the 1-rank tp axis (applied by hand: the
     trainer leaves parameters whole at size 1): bit for bit, or loss and
     every parameter within 1e-6 (relative, of its max-abs), the gaps
     printed;
     (c) IDMTrainer (4x) on a dp=1 mesh, 2 steps at 2 windows of 128,
     against the meshless steps taken after a throwaway warm-up run of them
     from the same state (see --probe-first-call);
     (d) PPOTrainer on a dp=1 mesh, one update at 9(a)'s size;
     (e) a meshed MineRLAgent, 8 streams x 16 deterministic steps on the
     linear cache: the meshless agent's actions;
     every step launching B1 and B2 once per block, each wrapper's ms a step
     and peak beside 7(b)'s plain step, and the phase's seconds;
 15. the entry points, each driven through its main(argv) in this process
     on the default device (CUDA), from a 2x .model written with
     save_model_parameters and .weights of the random inits of seeds 0 and
     1, and the 4x IDM's pair from seed 0's (the weights of phase 8(b)):
     (a) run_agent --mock-env --streams 8 --steps 64: automatic groups must
     be 4 of 2 streams; frames/s and the step's p50/p99;
     (b) tools.eval_agent --mock-env, 8 streams, 8 episodes, done-prob
     0.05, seeds 0 and 1, then --compare of the two reports: every number
     finite;
     (c) tools.average_weights of the two 2x .weights on the card: every
     tensor equal to the mean the CPU computes from the same files;
     (d) on 512 synthetic 640x360 frames (8(b)'s) and the 4x IDM from its
     files: tools.label_videos.label_frames (window 128, stride 64, 4
     windows a forward) labels every frame once, in order, each label 8(b)'s
     StreamingIDMLabeler's, B1 once per block and forward; the IDM CLI's
     print-mode batch function (predict_batches, 128 frames a batch, the
     state carried) every frame once, in order, its labels those of
     predict_actions called directly on the same batches, B1 once per block
     and batch; frames/s of both;
     (e) tools.bench_bc_breakdown at 2x, B=4, T=128, float32 (--cnn-detail)
     and tools.bench_breakdown at 2x, 8 streams: their JSON printed; the
     BC step's own time within 10% of 7(b)'s; B1 and B2 once per block and
     step of the breakdown's train steps;
     and the phase's seconds.
 16. head dims past the four the kernels take whole (64, 128, 192, 256):
     (a) B1 and B2 at d = 16, 32 and 96 (zero-padded by the wrappers to the
     next multiple of 64) and 384, 512, 640, 1024 and 2048 (the streamed
     instance, 64 columns at a time), f32 and bf16, mask and bias, at the 2x
     chunk's geometry at 8 heads, at d = 384 and 1024 past 512 keys, and at
     d = 4096 (B=1, H=2), against their plain versions at phase 3's and 6's
     limits; the streamed instance's dynamic shared memory at d = 320 and
     4096, which must be the same; the times at the 2x chunk's geometry
     beside the plain versions', SDPA's and the bound of the unpadded work;
     (b) one-block policies at d = 32 (hidsize 256, 8 heads), d = 96
     (hidsize 384, 4 heads) and d = 1024 (hidsize 1024, 1 head), the 2x
     policy's CNN at width 1: a (2, 16) chunked forward on the card against
     the CPU (logits and value at phase 5's limit) and one BC step at phase
     7(a)'s limits, then a step whose launches are counted, B1 and B2 once
     each;
     and the phase's seconds.
 17. kernel C1 (the f32 3x3 convolution forward, csrc/conv3x3_fwd.cu) at the
     13 convolutions of the cells' Impala CNNs (C1_SHAPES) on 8 frames, with
     a bias and the ReLU: against its plain version (cuDNN's f32 conv with
     TF32 off, then ReLU) within C1_CHECK_TOL of the output's scale, and
     against float64 within twice the plain version's error; one launch a
     call.
Phases 3 and 6 also check both kernels past 512 keys (T = 640 and 1152) and
time them at the IDM's long-call shape and at the PPO minibatch's.  The CPU
side of every train step held against the card (7(a), 8(a), 9(a), 11(c),
11(d)) replays the card's ReLU decisions of the dense layers outside the
CNN: a decision that rounding flips between the two would move a whole term
of a gradient.
It prints one JSON line with every kernel's numbers, then, last,
{"ok": true, "device": {...}}.  It exits non-zero, with no "ok" line, where
there is no CUDA device.

    python3 chip_smoke.py --time-kernels

times kernels B1 and B2 alone, in float32 and bfloat16, at every shape of at
most 512 keys that PERF.md's kernel table holds (the 2x chunk, the IDM's
labeling and training batches, the PPO minibatch, the 3x policy's BC
chunk at d = 192), beside their plain
versions, SDPA and their bounds (phases 1 and 2's build, then the timings of
phases 3 and 6), and kernel C1 at the 13 f32 3x3 convolutions of the
cells' Impala CNNs (C1_SHAPES) beside its plain version, cuDNN's f32 fprop
with TF32 off and its bound, and prints them as its last line.  It
drives whichever vpt_tpu_torch package it imports, so run from an unpacked
older commit with this file copied in, it times that commit's kernels by the
same clock, for a comparison inside one call.

    python3 chip_smoke.py --profile

builds as phases 1 and 2 do, then traces phase 5's chunked forward, 7(b)'s
BC step, 8(c)'s IDM step, 9(b)'s PPO update and the BC step that
profile_ops' geometry flags PROFILE_FLAGS build with torch.profiler
(vpt_tpu_torch/tools/profile_ops.py), prints each one's device time by
kernel category and its top kernels, writes the full tables to
profile_*.json in --profile-dir (default profile_tables/), and prints them
as its last line.  It fails where the trace holds no CUDA kernel.

    python3 chip_smoke.py --probe-first-call

builds, then takes the 4x IDM's training step three times from one state
under deterministic algorithms, with cuDNN, without it, and with it at the
batch shape it had not seen, and prints
which gradients of the first call differ from the later calls', and whether
the gradient arriving at the first Impala convolution does.

    python3 chip_smoke.py --distribution

builds, then runs phase 14 alone (its BC steps beside no 7(b) time).

    python3 chip_smoke.py --entry-points

builds, then runs phase 15 alone (its labels checked against a
StreamingIDMLabeler run of its own, its BC step beside no 7(b) time).

    python3 chip_smoke.py --head-dims

builds, then runs phase 16 alone (on a fresh process its SDPA and plain
timings pay first calls that phase 6 pays in the whole script).

    python3 chip_smoke.py --c1

builds, then runs phase 17 alone.
"""

import argparse
import contextlib
import copy
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
KERNELS = ("windowed_attention_fwd", "windowed_attention_bwd", "conv3x3_fwd")
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
# remat and the chunked CNN (phases 7(c), 8(e), 9(d)) at the JAX package's default training batches.  8 chunks
# of a (B·T = 1024)-frame batch run the CNN on 128 frames at a time: its largest activation (stack 0's conv
# output, 128 channels at 128x128 for the 2x policy, 256 for the 4x IDM) is then 1.1-2.1 GB a buffer in f32,
# not 8.6-17 GB, while each convolution still takes 128 frames, a full T=128 chunk of one stream.
REMAT_CHUNKS = 8
# C1's launches a forward of the main path's f32 CNNs: every 3x3 conv of the 2x policy's Impala stack but
# its first (3 RGB channels), and all 15 of the 4x IDM's (behind its conv3d, from 128 channels)
C1_POLICY_CONVS, C1_IDM_CONVS = 14, 15
# phase 17: frames a shape, and C1's largest gap to its plain version over the output's largest
# magnitude (the card tests' bound against float64 at ragged shapes; one TF32 product a multiply reads ~1e-4)
C1_CHECK_N, C1_CHECK_TOL = 8, 1e-5
BC_REMAT_B, BC_REMAT_STEPS = 8, 3  # the JAX package's BC default batch (BCHyperparams.batch_size)
IDM_REMAT_B, IDM_REMAT_STEPS = 8, 3  # the JAX package's IDM default batch (IDMHyperparams.batch_size)
REMAT_LOSS_RTOL = 1e-6  # a step with remat against the same step without, on the card
RESUME_RUNS = 4  # phase 12: uninterrupted step 3s from the saved state, which must agree bit for bit
# phase 15: run_agent's and eval_agent's mock-env geometry, the IDM print mode's batch, the BC
# breakdown's geometry and chain length, the rollout breakdown's streams, and how far the breakdown's
# BC step may lie from 7(b)'s
ENTRY_STREAMS, ENTRY_STEPS, ENTRY_EPISODES, ENTRY_DONE_PROB = 8, 64, 8, 0.05
PRINT_MODE_FRAMES = 128
BENCH_WIDTH, BENCH_BC_B, BENCH_BC_T, BENCH_ITERS, BENCH_STREAMS = 2, 4, 128, 3, 8
BENCH_STEP_RTOL = 0.10


def log(msg):
    print(msg, flush=True)


def reset_launch_counts():
    """Zero the wrappers' counts of B1's, B2's and C1's launches."""
    from vpt_tpu_torch.ops import conv
    from vpt_tpu_torch.ops import windowed_attention as wa

    wa.launches = wa.bwd_launches = conv.launches = 0


def check_c1_launches(label, launches, expect):
    """C1's launches in a main-path phase: exactly as many as its f32 convs
    (a conv routed back to cuDNN would launch none)."""
    if launches != expect:
        raise AssertionError(f"{label}: C1 launched {launches} times, expected {expect}")


def release_memory():
    """Free what the last phase left, reference cycles included (a check
    that wraps a trainer's method in a closure over the trainer makes one),
    then return the cached blocks: the next phase's peak is then its own."""
    gc.collect()
    torch.cuda.empty_cache()


def cache_cpu_draws():
    """Draw each model's random weights on the CPU once a run: a later
    init_parameters of the same model class, config, structure and
    generator state (a trainer or an agent built again from the same seed)
    loads the weights the first one drew and leaves its generator where the
    draw did, the same numbers bit for bit without the seconds of drawing
    them again.  The checks build many such models (each trainer draws its
    weights on the CPU), and the draws are most of the script's time on the
    host.  Draws on the card are fast and are not cached."""
    from vpt_tpu_torch.models import layers

    draw, cache = layers.init_parameters, {}

    def cached(model, generator):
        if generator.device.type != "cpu":
            return draw(model, generator)
        key = (type(model).__qualname__, repr(getattr(model, "cfg", None)),
               tuple((k, tuple(v.shape), v.dtype) for k, v in model.state_dict().items()),
               bytes(generator.get_state().numpy()))
        if key not in cache:
            draw(model, generator)
            cache[key] = ({k: v.detach().clone() for k, v in model.state_dict().items()}, generator.get_state())
        else:
            with torch.no_grad():
                model.load_state_dict(cache[key][0])
            generator.set_state(cache[key][1])
        return model

    for module in list(sys.modules.values()):
        if getattr(module, "__name__", "").startswith("vpt_tpu_torch") and getattr(module, "init_parameters", None) is draw:
            module.init_parameters = cached


def host_cores():
    return f"host cores: os.cpu_count() {os.cpu_count()}, this process's affinity {len(os.sched_getaffinity(0))}"


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
    second value is False.  The first call, which may pay one-time costs
    (an algorithm's choice, a library's first load), is left out of the
    spin's estimate: a spin sized from it ran for minutes."""
    fn()
    torch.cuda.synchronize()
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


def ptxas_spills(log):
    """{function: (spill store bytes, spill load bytes)} of the functions
    that spill, from nvcc's ``-Xptxas -v`` report."""
    spills, function = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            function = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and function is not None and (int(m.group(1)) or int(m.group(2))):
            spills[function] = (int(m.group(1)), int(m.group(2)))
    return spills


def demangled(names):
    """C++ names as c++filt prints them, or as given where it is missing."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, timeout=60).stdout
    return out.splitlines() if len(out.splitlines()) == len(names) else list(names)


def kernels_without_tensor_cores(counts):
    """The kernels of a library's counts that run no tensor-core instruction,
    but for the passes that multiply no matrices: B2's sum of the d b_nd
    partials and C1's split of the weights into TF32 halves; a library with
    no kernel at all fails too."""
    if not counts:
        return ["(no kernel in the listing)"]
    return [f for f, n in counts.items() if n == 0 and "db_reduce" not in f and "split_weights" not in f]


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


def b1_work(q, k, v, mask, R, b_nd, pairs=None):
    """B1's least work: bytes (inputs read once, the output written once),
    product FLOPs (QKᵀ and W·V) and bias FLOPs (n FMAs a pair on the band).
    The products span every (query, key) pair of every head, or `pairs`
    where given (the pairs a sparse mask lets attend)."""
    B, H, t, d = q.shape
    T = k.shape[2]
    tensors = [q, k, v, q] + [x for x in (mask, R, b_nd) if x is not None]  # q twice: the output
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    bias = 2 * B * H * band_pairs(t, T, b_nd.shape[1]) * R.shape[-1] if R is not None else 0
    return nbytes, 2 * 2 * (B * H * t * T if pairs is None else pairs) * d, bias


def b1_bound(q, k, v, mask, R, b_nd, pairs=None):
    nbytes, products, bias = b1_work(q, k, v, mask, R, b_nd, pairs)
    return bound(nbytes, products, bias, q.dtype) + (nbytes, products + bias)


def attended_pairs(mask, heads):
    """(query, key, head) triples a (B, t, T) mask lets attend: the work of
    a function that skips what it masks."""
    return int(mask.sum().item()) * heads


def materialised_bias(mask, R, b_nd, T, dtype):
    """The (B, H, t, T) additive bias that SDPA takes: the relative bias and
    the mask's -1e9 where there is one."""
    from vpt_tpu_torch.ops.attention import NEG_BIAS
    from vpt_tpu_torch.ops.rel_bias import relattn_bias

    if R is not None:
        bias = relattn_bias(R, b_nd, T)
    else:
        bias = torch.zeros((mask.shape[0], 1, mask.shape[1], T), device=mask.device)
    if mask is not None:
        bias = bias + torch.where(mask[:, None], 0.0, NEG_BIAS)
    return bias.to(dtype)


def time_b1(q, k, v, mask, R, b_nd, label="2x chunk", pairs=None):
    """B1's time beside its plain version's, SDPA's on a materialised bias
    (in q's dtype) and its bound (over `pairs`, b1_work), at these inputs."""
    import torch.nn.functional as F

    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.ops.attention import attention_alpha

    ms = kernel_time_ms(lambda: wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True))
    plain_ms, plain_alone = cuda_time_ms(lambda: wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True))
    bias = materialised_bias(mask, R, b_nd, k.shape[2], q.dtype)
    alpha = attention_alpha(q.shape[-1], True)
    library_ms, library_alone = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=alpha))
    bound_ms, bound_by, nbytes, flops = b1_bound(q, k, v, mask, R, b_nd, pairs)
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
    for d in (128, 64, 192, 256):
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
        for d in (64, 128, 192, 256):
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


def shape_times(timer, dev, B, H, t, maxlen, use_mask, label, d=128):
    """{dtype: the timing keys} of time_b1 or time_b2 at (B, H, t, T = t +
    maxlen, d) with the relative bias, in float32 and bfloat16."""
    q, k, v, mask, R, b_nd = attention_inputs(dev, B, H, t, maxlen, d, torch.float32, 0)
    mask = mask if use_mask else None
    extra = ()
    if timer is time_b2:
        extra = (torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(6), device=dev),)
    return {str(dt)[6:]: dict(zip(TIME_KEYS, timer(q.to(dt), k.to(dt), v.to(dt), mask, R, b_nd,
                                                   *(x.to(dt) for x in extra), label=label)))
            for dt in (torch.float32, torch.bfloat16)}


def synthetic_obs(rng, n):
    return [{"pov": rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)} for _ in range(n)]


def numpy_resize(agent):
    """The agent's host frame preparation as it was before the native
    library: the numpy cv2-exact resize, on one thread."""
    from vpt_tpu_torch.ops.resize import resize_uint8_exact

    def env_obs_to_agent(minerl_obs):
        povs = minerl_obs if isinstance(minerl_obs, list) else [minerl_obs]
        return np.stack([resize_uint8_exact(o["pov"], agent._resolution) for o in povs])[:, None]

    return env_obs_to_agent


def rollout_run(agent, frames, steps, mode):
    """One stepped rollout of `agent` (deterministic actions, episode resets)
    with frames prepared in `mode`: "numpy" (one thread), "native" (the C++
    resize on the thread pool) or "device" (resize_on_device).  Returns the
    actions of every step (rows: streams) and the timings in ms."""
    from vpt_tpu_torch.agent.agent import TARGET_ACTION_NAMES
    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.ops.resize import resize_bilinear

    streams = agent.batch_size
    agent.resize_on_device = mode == "device"
    agent.__dict__.pop("_env_obs_to_agent", None)
    if mode == "numpy":
        agent._env_obs_to_agent = numpy_resize(agent)
    agent.reset()
    resets = {16 + 4 * i: i for i in range(streams)}  # stream i restarts its episode at step 16 + 4 i
    reset_launch_counts()
    actions, t0 = [], None
    for step in range(steps):
        if step == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        first = np.zeros(streams, bool)
        if step == 0:
            first[:] = True
        if step in resets:
            first[resets[step]] = True
        acts = agent.get_action(frames[step % len(frames)], first=first, stochastic=False)
        assert len(acts) == streams
        for act in acts:
            assert set(act) - {"camera"} <= TARGET_ACTION_NAMES
            assert all(act[k] in (0, 1) for k in act if k != "camera")
            assert act["camera"].shape == (2,) and np.all(np.abs(act["camera"]) <= 10.0)
        assert np.all(np.isfinite(agent._last_vpred))
        actions.append(np.array([np.concatenate([np.ravel(a[k]) for k in sorted(a)]) for a in acts]))
    seconds = time.perf_counter() - t0
    if wa.launches:
        raise AssertionError(f"the ring-cache rollout launched B1 {wa.launches} times")

    # the step's parts, each alone: host frame preparation, then the device step + one D2H copy
    t0 = time.perf_counter()
    for i in range(8):
        img = agent._env_obs_to_agent(frames[i % len(frames)])
    times = {"host_prep_ms": (time.perf_counter() - t0) * 1e3 / 8}
    if mode == "device":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            raw = torch.from_numpy(img).to(agent.device, non_blocking=True)
        torch.cuda.synchronize()
        times["h2d_ms"] = (time.perf_counter() - t0) * 1e3 / 8
        t0 = time.perf_counter()
        for _ in range(8):
            resize_bilinear(raw, agent._resolution)
        torch.cuda.synchronize()
        times["device_resize_ms"] = (time.perf_counter() - t0) * 1e3 / 8
    no_reset = np.zeros((streams, 1), bool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        packed, agent.hidden_state = agent._step(img, no_reset, True, agent.hidden_state)
        packed.cpu()
    times["device_step_ms"] = (time.perf_counter() - t0) * 1e3 / 8
    times["ms_a_step"] = 1e3 * seconds / (steps - 1)
    times["frames_per_s"] = streams * (steps - 1) / seconds
    agent.__dict__.pop("_env_obs_to_agent", None)
    agent.resize_on_device = False
    return np.stack(actions), times


def device_step_ms(agent, img, calls=8):
    """ms of the agent's device step (policy step, sampling, decode, one D2H
    copy) on resized frames, after two warm calls."""
    no_reset = np.zeros((agent.batch_size, 1), bool)
    for i in range(calls + 2):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        packed, agent.hidden_state = agent._step(img, no_reset, True, agent.hidden_state)
        packed.cpu()
    return (time.perf_counter() - t0) * 1e3 / calls


def stepped_rollout(dev, steps=64, streams=8):
    """Phase 4: the 2x agent serving `streams` env streams for `steps` calls,
    its frames prepared three ways (numpy on one thread, the native resize on
    the pool, on the device); the device step in bfloat16 compute, and with
    bfloat16 parameters."""
    from vpt_tpu_torch.agent import MineRLAgent
    from vpt_tpu_torch.ops import host_resize

    t0 = time.perf_counter()
    agent = MineRLAgent(device=dev, batch_size=streams, seed=0)
    torch.cuda.synchronize()
    log(f"2x MineRLAgent built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in agent.policy.parameters())} parameters)")
    rng = np.random.default_rng(0)
    frames = [synthetic_obs(rng, streams) for _ in range(4)]
    backend = host_resize.backend()
    runs = {}
    for mode in ("numpy", "native", "device"):
        actions, t = rollout_run(agent, frames, steps, mode)
        runs[mode] = actions
        prep = "host resize" if mode != "device" else "host stack of raw frames"
        parts = f"{prep} {t['host_prep_ms']:.2f} ms ({100 * t['host_prep_ms'] / t['ms_a_step']:.1f}% of a step)"
        if mode == "device":
            parts += (f", H2D of the raw (B, 1, 360, 640, 3) frames {t['h2d_ms']:.2f} ms, device resize "
                      f"{t['device_resize_ms']:.2f} ms ({100 * t['device_resize_ms'] / t['ms_a_step']:.1f}%)")
        log(f"stepped rollout ({mode} frame preparation{', backend ' + backend if mode == 'native' else ''}): "
            f"{streams} streams x {steps} steps, {t['frames_per_s']:.1f} frames/s, {t['ms_a_step']:.2f} ms/step; "
            f"alone: {parts}, device step + D2H {t['device_step_ms']:.2f} ms; {host_cores()}")
    if not np.array_equal(runs["numpy"], runs["native"]):
        raise AssertionError("the native host resize's rollout chose other actions than the numpy resize's")
    differ = int((runs["device"] != runs["native"]).any(axis=2).sum())
    log(f"  deterministic actions: numpy and native resize equal at every step; the device resize differs in "
        f"{differ} of {runs['native'].shape[0] * streams} stream-steps (its frames are up to 1 intensity step "
        f"off, and random heads have near-ties: not gated)")
    if backend != "native":
        raise AssertionError(f"the host resize runs the {backend} fallback: {host_resize.load_error()}")

    img = agent._env_obs_to_agent(frames[0])
    times = {"float32": device_step_ms(agent, img)}
    for label, kw in (("bfloat16 compute", dict(compute_dtype="bfloat16")),
                      ("bfloat16 compute and parameters", dict(compute_dtype="bfloat16", params_dtype="bfloat16"))):
        other = MineRLAgent(device=dev, batch_size=streams, seed=0, **kw)
        times[label] = device_step_ms(other, img)
        del other
    release_memory()
    log(f"  device step + D2H at {streams} streams: " + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items()))
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

    reset_launch_counts()
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


def b2_work(q, k, v, mask, R, b_nd, pairs=None):
    """B2's least work: bytes (inputs q, k, v, dO, mask, R, b_nd read once
    and outputs dq, dk, dv, dR, db_nd written once), product FLOPs (five
    t x T x d products, or five over `pairs` as in b1_work) and bias FLOPs
    (on the band: the bias recompute, dR and d b_nd, n FMAs a pair each)."""
    B, H, t, d = q.shape
    T = k.shape[2]
    tensors = [q, k, v, q] + [x for x in (mask, R, b_nd) if x is not None]  # dO is q's size
    tensors += [q, k, v] + [x for x in (R, b_nd) if x is not None]  # the outputs
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    bias = 3 * 2 * B * H * band_pairs(t, T, b_nd.shape[1]) * R.shape[-1] if R is not None else 0
    return nbytes, 5 * 2 * (B * H * t * T if pairs is None else pairs) * d, bias


def b2_bound(q, k, v, mask, R, b_nd, pairs=None):
    nbytes, products, bias = b2_work(q, k, v, mask, R, b_nd, pairs)
    return bound(nbytes, products, bias, q.dtype) + (nbytes, products + bias)


def time_b2(q, k, v, mask, R, b_nd, dO, label="2x chunk", pairs=None):
    """B2's time beside its plain version's, SDPA's forward and backward on a
    materialised bias (in q's dtype; q, k, v grads only) and its bound (over
    `pairs`, b2_work)."""
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
    bound_ms, bound_by, nbytes, flops = b2_bound(q, k, v, mask, R, b_nd, pairs)
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
    for d in (128, 64, 192, 256):
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
        for d in (64, 128, 192, 256):
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


def cloned(tree):
    """A deep copy of nested dicts and lists of tensors (and plain values)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: cloned(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cloned(v) for v in tree)
    return tree


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


class ReluDecisions:
    """The ReLU decisions of the dense layers outside the CNN (the blocks'
    first MLP layers, the CNN's projection, lastlayer), recorded in the
    card's forwards of a step and replayed in the CPU's forwards of the same
    step: rounding near 0 flips a few decisions between the two, and each
    flip moves a whole term of its weight's gradient (and of every gradient
    that sums over that frame), which is not what the comparison is after.
    Replayed, the CPU's layer outputs its own pre-activation where the card
    passed it and 0 where the card did not."""

    def __init__(self):
        self.masks, self.flipped, self.total = [], 0, 0

    @staticmethod
    def _layers(model):
        from vpt_tpu_torch.models.layers import FanInInitLayer

        return [m for n, m in model.named_modules() if isinstance(m, FanInInitLayer) and m.layer_type == "linear"
                and m.use_activation and not n.startswith(CNN_PREFIX)]

    @contextlib.contextmanager
    def _hooked(self, model, hook):
        hooks = [m.register_forward_hook(hook) for m in self._layers(model)]
        try:
            yield self
        finally:
            for h in hooks:
                h.remove()

    def record(self, model):
        return self._hooked(model, lambda m, args, out: self.masks.append((out > 0).cpu()))

    @contextlib.contextmanager
    def replay(self, model):
        masks = iter(self.masks)

        def hook(m, args, out):
            mask = next(masks).to(out.device)
            self.flipped += int((mask != (out > 0)).sum())
            self.total += mask.numel()
            m.use_activation = False
            try:
                pre = m.forward(args[0])
            finally:
                m.use_activation = True
            return torch.where(mask, pre, torch.zeros_like(pre))

        with self._hooked(model, hook):
            yield self
        if next(masks, None) is not None:
            raise AssertionError("the CPU's step ran fewer dense ReLUs than the card's")

    def report(self):
        return (f"the CPU replayed the card's {self.total} dense ReLU decisions, {self.flipped} of them other than "
                f"its own")


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


def bc_trainer_pair(dev, policy_kwargs=None, **trainer_kw):
    """A BCTrainer on the CPU (its weights drawn from seed 0 there, as every
    trainer draws them) and its twin on the card: a copy of its policy and an
    optimizer of its own; the 2x policy unless `policy_kwargs` says other."""
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.training.bc import BCTrainer, make_optimizer

    policy_kwargs = policy_kwargs or FOUNDATION_POLICY_KWARGS
    cpu = BCTrainer(policy_kwargs, FOUNDATION_PI_HEAD_KWARGS, seed=0, device="cpu", **trainer_kw)
    cpu.init()
    gpu = BCTrainer(policy_kwargs, FOUNDATION_PI_HEAD_KWARGS, seed=0, device=dev, **trainer_kw)
    gpu.policy = copy.deepcopy(cpu.policy).to(dev)
    gpu.optimizer = make_optimizer(gpu.trainable_parameters(), gpu.hp)
    return gpu, cpu


def train_card_vs_cpu(dev, label="train_step", pair=None, **trainer_kw):
    """Phase 7(a) (and 11(c) with qat_dense, 13(c) and 13(d) on the model
    variants' `pair` of bc_trainer_pair): one 2x train_step on the card and
    on the CPU from the same weights and batch, the CPU replaying the card's
    dense ReLU decisions; returns the card's trainer and the CPU's."""
    t0 = time.perf_counter()
    gpu, cpu = pair or bc_trainer_pair(dev, **trainer_kw)
    log(f"2x BCTrainer on the card and on the CPU built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in gpu.policy.parameters())} parameters, "
        f"{sum(p.numel() for p in gpu.trainable_parameters())} trained)")
    if not same_tensors(gpu.policy.state_dict(), cpu.policy.state_dict()):
        raise AssertionError("the card's and the CPU's trainers start from different weights")
    vh = value_head_copy(cpu)
    batch = bc_batch(torch.device("cpu"), 2, 4, gpu.cfg.img_shape[0], 7, firsts_at=(None, 2), masked_tail=(0, 3))
    calib = cudnn_calibration(gpu, batch, (CNN_PREFIX,))

    relus = ReluDecisions()
    with relus.record(gpu.policy):
        state_g, loss_g, norm_g = gpu.train_step({k: v.to(dev) for k, v in batch.items()}, gpu.initial_state(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with relus.replay(cpu.policy):
        state_c, loss_c, norm_c = cpu.train_step(batch, cpu.initial_state(2))
    cpu_s = time.perf_counter() - t0
    if any(p.grad is not None for t in (gpu, cpu) for p in t.policy.value_head.parameters()):
        raise AssertionError("the value head has a gradient")
    loss_err, norm_err, worst, worst_cnn = step_errors(gpu, cpu, (loss_g, norm_g), (loss_c, norm_c), (CNN_PREFIX,))
    log(f"{label} card vs CPU (2x, B=2, T=4, f32): loss {loss_g.item():.6f} vs {loss_c.item():.6f} "
        f"(rel {loss_err:.2e}, tol {LOSS_RTOL}), grad norm {norm_g.item():.6f} vs {norm_c.item():.6f} "
        f"(rel {norm_err:.2e}, tol {NORM_RTOL}); CPU step {cpu_s:.1f} s")
    log(f"  grads outside the CNN: worst max-abs error / ({GRAD_RTOL} max|grad| + {GRAD_ATOL}) {worst[0]:.3f} "
        f"({worst[1]}); CNN grads: worst relative L2 error {worst_cnn[0]:.3e} ({worst_cnn[1]}, tol "
        f"{CNN_GRAD_REL_L2}), against {calib:.3e} between cuDNN's and torch's convolutions on the card; "
        f"{relus.report()}")
    if not (loss_err <= LOSS_RTOL and norm_err <= NORM_RTOL and worst[0] <= 1.0 and worst_cnn[0] <= CNN_GRAD_REL_L2):
        raise AssertionError("the train step on the card disagrees with the CPU's")
    if not (same_tensors(value_head_copy(gpu), vh) and same_tensors(value_head_copy(cpu), vh)):
        raise AssertionError("a train step moved the value head")
    return gpu, cpu


def train_steps(trainer, dev, B=4, T=128, steps=5, label="BC train", c1_per_step=None):
    """Phase 7(b) (and 11(c)): `steps` optimizer steps at (B, T) with the
    state carried, per-stream resets and a padded tail; B1 and B2 launch
    once per block and step, and C1 `c1_per_step` times where given."""
    from vpt_tpu_torch.ops import conv
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
    reset_launch_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, loss, norm = trainer.train_step(batch, state)
        losses.append(loss.item())  # synchronises
        times.append(time.perf_counter() - t0)
    f_launches, b_launches, c1_launches = wa.launches, wa.bwd_launches, conv.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = 1e3 * sum(times[1:]) / (steps - 1)
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(trainer.trainable_parameters(), before))
    log(f"{label} ({B}x{T}, 2x, f32): losses {[round(x, 6) for x in losses]}, last grad norm {norm.item():.4f}; "
        f"{step_ms:.1f} ms/step from the second step ({B * T / step_ms * 1e3:.1f} frames/s), "
        f"first step {times[0] * 1e3:.1f} ms; peak memory {peak_gb:.2f} GB; largest parameter change {moved:.3e}; "
        f"launches over {steps} steps: B1 {f_launches}, B2 {b_launches}, C1 {c1_launches}")
    n_blocks = trainer.cfg.n_recurrence_layers if trainer.cfg.recurrence_type == "transformer" else 0
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"training did not run: losses {losses}, largest change {moved}")
    if not same_tensors(value_head_copy(trainer), vh):
        raise AssertionError("training moved the value head")
    if (f_launches, b_launches) != (n_blocks * steps, n_blocks * steps):
        raise AssertionError(f"B1 launched {f_launches} and B2 {b_launches} times in {steps} steps, "
                             f"expected {n_blocks * steps} each")
    if c1_per_step is not None:
        check_c1_launches(f"{label}, {steps} steps", c1_launches, c1_per_step * steps)

    step_split(trainer, batches[0], B, T)
    return b_launches // steps, step_ms, peak_gb


def bc_remat_vs_plain(dev):
    """Phase 7(c), first: one 2x BC step at B=2, T=128 on the card, from the
    same weights, three ways: remat with the CNN in REMAT_CHUNKS chunks;
    the chunks without remat, the same step but for the recompute (loss
    1e-6 relative, grads at phase 7(a)'s rules); and neither.  The chunks
    change the convolutions' batch and so cuDNN's arithmetic: against the
    step without them, grads outside the CNN are held on relative L2 as in
    phase 9(a) (a flipped ReLU decision of the blocks' MLPs moves a whole
    term of a row of a weight's grad).  B1 launches twice a block with remat
    (the recompute), B2 once.  Returns the remat trainer."""
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.training.bc import BCTrainer

    B, T = 2, 128
    batch = bc_batch(dev, B, T, 128, 9, firsts_at=(None, 40), masked_tail=(0, 100))
    steps = {}
    for name, kw in (("remat", dict(remat=True, cnn_scan_chunks=REMAT_CHUNKS)),
                     ("chunks", dict(cnn_scan_chunks=REMAT_CHUNKS)), ("neither", {})):
        trainer = BCTrainer(FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, seed=0, device=dev, **kw)
        reset_launch_counts()
        _, loss, norm = trainer.train_step(batch, trainer.initial_state(B))
        torch.cuda.synchronize()
        grads = {n: p.grad.cpu() for n, p in trainer.policy.named_parameters() if p.grad is not None}
        steps[name] = (loss.item(), norm.item(), grads, (wa.launches, wa.bwd_launches))
        if name == "remat":
            remat = trainer
        del trainer

    def errors(a, b):
        (la, na, ga, _), (lb, nb, gb, _) = steps[a], steps[b]
        worst, worst_cnn = grad_errors(ga, gb, (CNN_PREFIX,))
        worst_l2 = max((rel_l2(ga[n], gb[n]), n) for n in gb if not n.startswith(CNN_PREFIX))
        return abs(la - lb) / abs(lb), abs(na - nb) / abs(nb), worst, worst_cnn, worst_l2

    def line(a, b, errs):
        loss_err, norm_err, worst, worst_cnn, worst_l2 = errs
        return (f"{a} against {b}: loss rel {loss_err:.2e}, grad norm rel {norm_err:.2e}; grads outside the CNN: "
                f"worst max-abs error / ({GRAD_RTOL} max|grad| + {GRAD_ATOL}) {worst[0]:.3f} ({worst[1]}), worst "
                f"relative L2 {worst_l2[0]:.2e}; CNN grads: worst relative L2 {worst_cnn[0]:.3e} ({worst_cnn[1]})")

    same, chunked = errors("remat", "chunks"), errors("chunks", "neither")
    n_blocks = remat.cfg.n_recurrence_layers
    log(f"BC step (2x, B={B}, T={T}, f32, on the card), remat with {REMAT_CHUNKS} CNN chunks: {line('remat', 'chunks', same)} "
        f"(tols: loss {REMAT_LOSS_RTOL}, norm {NORM_RTOL}, max-abs 1, CNN {CNN_GRAD_REL_L2}); launches B1, B2 "
        f"with remat {steps['remat'][3]}, without {steps['chunks'][3]}")
    log(f"  {line('chunks', 'neither', chunked)} (tols: loss {LOSS_RTOL}, norm {NORM_RTOL}, L2 outside the CNN "
        f"{PPO_GRAD_REL_L2}, CNN {CNN_GRAD_REL_L2})")
    if not (same[0] <= REMAT_LOSS_RTOL and same[1] <= NORM_RTOL and same[2][0] <= 1.0
            and same[3][0] <= CNN_GRAD_REL_L2):
        raise AssertionError("the BC step with remat disagrees with the step without")
    if not (chunked[0] <= LOSS_RTOL and chunked[1] <= NORM_RTOL and chunked[4][0] <= PPO_GRAD_REL_L2
            and chunked[3][0] <= CNN_GRAD_REL_L2):
        raise AssertionError("the BC step with the chunked CNN disagrees with the step without")
    if steps["remat"][3] != (2 * n_blocks, n_blocks) or steps["chunks"][3] != (n_blocks, n_blocks):
        raise AssertionError(f"BC launches (B1, B2): with remat {steps['remat'][3]}, expected "
                             f"{(2 * n_blocks, n_blocks)}; without {steps['chunks'][3]}")
    return remat


def remat_steps(trainer, batches, label, step, c1_per_step):
    """`step(batch)` on each batch (a trainer with remat): ms a step from the
    second, frames/s and the peak; B1 twice and B2 once a block and step, C1
    `c1_per_step` times."""
    from vpt_tpu_torch.ops import conv
    from vpt_tpu_torch.ops import windowed_attention as wa

    B, T = batches[0]["mask"].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(step(batch).item())  # synchronises
        times.append(time.perf_counter() - t0)
    launches, c1_launches = (wa.launches, wa.bwd_launches), conv.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = 1e3 * sum(times[1:]) / (len(times) - 1)
    log(f"{label} ({B}x{T}, f32, remat, {REMAT_CHUNKS} CNN chunks): losses {[round(x, 6) for x in losses]}; "
        f"{step_ms:.1f} ms/step from the second step ({B * T / step_ms * 1e3:.1f} frames/s), first step "
        f"{times[0] * 1e3:.1f} ms; peak memory {peak_gb:.2f} GB; launches over {len(batches)} steps: B1 "
        f"{launches[0]}, B2 {launches[1]}, C1 {c1_launches}")
    n_blocks = trainer.cfg.n_recurrence_layers * len(batches)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    if launches != (2 * n_blocks, n_blocks):
        raise AssertionError(f"{label}: B1 launched {launches[0]} and B2 {launches[1]} times, expected "
                             f"{(2 * n_blocks, n_blocks)}")
    check_c1_launches(f"{label} with remat, {len(batches)} steps", c1_launches, c1_per_step * len(batches))
    return step_ms, peak_gb


def bc_remat_steps(trainer, dev, B=BC_REMAT_B, T=128, steps=BC_REMAT_STEPS):
    """Phase 7(c), then: BC steps at the JAX default batch, B=8, T=128, with
    remat and the chunked CNN, the state carried."""
    batches = [bc_batch(dev, B, T, 128, 300 + s, firsts_at=[(13 * i + 29 * s) % T if i % 2 else None
                                                            for i in range(B)])
               for s in range(steps)]
    ctx = {"state": trainer.initial_state(B)}

    def step(batch):
        ctx["state"], loss, _ = trainer.train_step(batch, ctx["state"])
        return loss

    return remat_steps(trainer, batches, "BC train", step, 2 * REMAT_CHUNKS * C1_POLICY_CONVS)


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


def idm_card_vs_cpu(dev, label="IDM", **trainer_kw):
    """Phase 8(a) (and 11(d) with qat_dense): the 4x IDM's logits and one
    train step (B=1, an 8-frame window, T=136 keys) on the card and on the
    CPU from the same weights, the CPU's step replaying the card's dense
    ReLU decisions; returns the card's trainer."""
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer

    t0 = time.perf_counter()
    hp = IDMHyperparams(batch_size=1, window=8)
    gpu = IDMTrainer(IDM_4X_KWARGS, {}, hp=hp, seed=0, device=dev, **trainer_kw)
    cpu = IDMTrainer(IDM_4X_KWARGS, {}, hp=hp, seed=0, device="cpu", **trainer_kw)
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
    log(f"4x {label} logits card vs CPU (B=1, 8 frames, f32): max_abs_err {logit_errs} (tol {STEP_TOL})")
    if not all(e <= STEP_TOL for e in logit_errs.values()):
        raise AssertionError(f"the IDM's logits on the card disagree with the CPU's: {logit_errs}")

    calib = cudnn_calibration(gpu, batch, IDM_CNN_PREFIXES)
    relus = ReluDecisions()
    with relus.record(gpu.policy):
        loss_g, norm_g = gpu.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with relus.replay(cpu.policy):
        loss_c, norm_c = cpu.train_step(batch)
    cpu_s = time.perf_counter() - t0
    loss_err, norm_err, worst, worst_cnn = step_errors(gpu, cpu, (loss_g, norm_g), (loss_c, norm_c), IDM_CNN_PREFIXES)
    log(f"{label} train_step card vs CPU (4x, B=1, T=8, f32): loss {loss_g.item():.6f} vs {loss_c.item():.6f} "
        f"(rel {loss_err:.2e}, tol {LOSS_RTOL}), grad norm {norm_g.item():.6f} vs {norm_c.item():.6f} "
        f"(rel {norm_err:.2e}, tol {NORM_RTOL}); CPU step {cpu_s:.1f} s")
    log(f"  grads outside the conv3d and CNN: worst max-abs error / ({GRAD_RTOL} max|grad| + {GRAD_ATOL}) "
        f"{worst[0]:.3f} ({worst[1]}); conv3d and CNN grads: worst relative L2 error {worst_cnn[0]:.3e} "
        f"({worst_cnn[1]}, tol {CNN_GRAD_REL_L2}), against {calib:.3e} between cuDNN's and torch's convolutions; "
        f"{relus.report()}")
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
    front, Impala CNN (and its projection), blocks, head (relu, final_ln,
    action heads)."""
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
    policy.pi_head(net.tail(x))
    mark()
    return {k: 1e3 * (marks[i + 1] - marks[i]) for i, k in enumerate(("conv3d", "impala_cnn", "blocks", "head"))}


def idm_labeling(dev, frames, compute_dtype, **agent_kw):
    """Phase 8(b) (and 11(b) with quantize_dense): StreamingIDMLabeler over
    `frames` with the 4x IDM in `compute_dtype`; returns (agent, labels,
    per-forward B1 launches, the logits of the first window batch, that
    window stack, the device forward's seconds)."""
    from vpt_tpu_torch.agent import IDMAgent, StreamingIDMLabeler
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.models.policy import policy_initial_state
    from vpt_tpu_torch.ops import conv
    from vpt_tpu_torch.ops import windowed_attention as wa

    agent = IDMAgent(IDM_4X_KWARGS, {}, device=dev, compute_dtype=compute_dtype, seed=0, **agent_kw)
    kind = compute_dtype + "".join(f", {k}" for k, v in agent_kw.items() if v)
    n_blocks = agent.cfg.n_recurrence_layers
    calls = counted_dispatches(agent)
    warm = StreamingIDMLabeler(agent, window=IDM_WINDOW, stride=IDM_STRIDE, window_batch=IDM_WINDOW_BATCH)
    for f in frames[:IDM_WINDOW + (IDM_WINDOW_BATCH - 1) * IDM_STRIDE]:  # one full window batch: cuDNN's first calls
        warm.feed(f)
    del calls[:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    labeler = StreamingIDMLabeler(agent, window=IDM_WINDOW, stride=IDM_STRIDE, window_batch=IDM_WINDOW_BATCH)
    t0 = time.perf_counter()
    labels = []
    for f in frames:
        labels.extend(labeler.feed(f))
    labels.extend(labeler.finish())
    seconds = time.perf_counter() - t0
    launches, forwards, peak_gb = wa.launches, len(calls), torch.cuda.max_memory_allocated() / 1e9
    c1_launches = conv.launches
    n = len(frames)
    if [i for i, _ in labels] != list(range(n)):
        raise AssertionError("the labeler did not label every frame once, in order")
    if launches != n_blocks * forwards:
        raise AssertionError(f"B1 launched {launches} times in {forwards} forwards, expected {n_blocks} a forward")
    check_c1_launches(f"IDM labeling ({kind}), {forwards} forwards", c1_launches,
                      C1_IDM_CONVS * forwards if compute_dtype == "float32" else 0)

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
    log(f"IDM labeling ({kind}): {n} frames of 640x360, window {IDM_WINDOW}, stride {IDM_STRIDE}, "
        f"{IDM_WINDOW_BATCH} windows a forward: {n / seconds:.1f} frames/s end to end ({seconds:.2f} s, "
        f"{forwards} forwards, B1 launches {launches}, C1 {c1_launches}); peak memory {peak_gb:.2f} GB; every label its owning "
        f"window's direct prediction")
    log(f"  alone: host resize {1e3 * resize_s / n:.3f} ms a frame ({n / resize_s:.1f} frames/s); device "
        f"forward of {IDM_WINDOW_BATCH} windows {1e3 * forward_s:.1f} ms ({frames_per_forward / forward_s:.1f} "
        f"frames/s, H2D and label D2H included)")
    log("  forward split (ms, each ended by a synchronise): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + f", total {sum(split.values()):.1f}")
    return agent, labels, launches // max(forwards, 1), {k: v.float() for k, v in logits.items()}, stack, forward_s


def idm_forward_ms(dev, stack, calls=3, **agent_kw):
    """ms of a 4x IDMAgent's device forward of a window stack (H2D and label
    D2H included), after one warm call."""
    from vpt_tpu_torch.agent import IDMAgent
    from vpt_tpu_torch.config import IDM_4X_KWARGS

    agent = IDMAgent(IDM_4X_KWARGS, {}, device=dev, seed=0, **agent_kw)
    agent.predict_actions_batched(stack)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        agent.predict_actions_batched(stack)
    return (time.perf_counter() - t0) * 1e3 / calls


def idm_train_steps(trainer, B=IDM_TRAIN_B, T=IDM_WINDOW, steps=IDM_TRAIN_STEPS):
    """Phase 8(c): `steps` IDM train steps at (B, T), float32; B1 and B2
    launch once per block and step, C1 once a conv and step."""
    from vpt_tpu_torch.ops import conv
    from vpt_tpu_torch.ops import windowed_attention as wa

    batches = [idm_batch(B, T, 200 + s, masked_tail=(B - 1, T - 40) if s == steps - 1 else None)
               for s in range(steps)]
    before = [p.detach().clone() for p in trainer.policy.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss, norm = trainer.train_step(batch)
        losses.append(loss.item())  # synchronises
        times.append(time.perf_counter() - t0)
    f_launches, b_launches, c1_launches = wa.launches, wa.bwd_launches, conv.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = 1e3 * sum(times[1:]) / (steps - 1)
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(trainer.policy.parameters(), before))
    log(f"IDM train ({B}x{T}, 4x, f32): losses {[round(x, 6) for x in losses]}, last grad norm {norm.item():.4f}; "
        f"{step_ms:.1f} ms/step from the second step ({B * T / step_ms * 1e3:.1f} frames/s), first step "
        f"{times[0] * 1e3:.1f} ms; peak memory {peak_gb:.2f} GB; largest parameter change {moved:.3e}; "
        f"launches over {steps} steps: B1 {f_launches}, B2 {b_launches}, C1 {c1_launches}")
    n_blocks = trainer.cfg.n_recurrence_layers if trainer.cfg.recurrence_type == "transformer" else 0
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"IDM training did not run: losses {losses}, largest change {moved}")
    if (f_launches, b_launches) != (n_blocks * steps, n_blocks * steps):
        raise AssertionError(f"B1 launched {f_launches} and B2 {b_launches} times in {steps} IDM steps, "
                             f"expected {n_blocks * steps} each")
    check_c1_launches(f"IDM train, {steps} steps", c1_launches, C1_IDM_CONVS * steps)

    step_split(trainer, batches[0], B, T)
    return f_launches // steps, b_launches // steps


def idm_remat_steps(dev, B=IDM_REMAT_B, T=IDM_WINDOW, steps=IDM_REMAT_STEPS):
    """Phase 8(e): 4x IDM train steps at the JAX default batch, 8 windows of
    128, with remat and the chunked CNN."""
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer

    trainer = IDMTrainer(IDM_4X_KWARGS, {}, hp=IDMHyperparams(batch_size=B, window=T), remat=True,
                         cnn_scan_chunks=REMAT_CHUNKS, seed=0, device=dev)
    batches = [idm_batch(B, T, 400 + s) for s in range(steps)]
    return remat_steps(trainer, batches, "IDM train", lambda batch: trainer.train_step(batch)[0],
                       2 * REMAT_CHUNKS * C1_IDM_CONVS)


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
    reset_launch_counts()
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
    """Phase 8: the 4x IDM (a) card against CPU, (c) training, (e) training
    at 8 windows with remat, (b) labeling in float32 and bfloat16 (and the
    forward with bfloat16 parameters), (d) a 512-frame predict_actions;
    returns the per-forward and per-step launches, and the float32
    labeling's frames, labels, first-batch logits and forward times."""
    trainer = idm_card_vs_cpu(dev)
    train_launches = idm_train_steps(trainer)
    del trainer
    release_memory()
    idm_remat_steps(dev)
    release_memory()

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (IDM_LABEL_FRAMES, 360, 640, 3), dtype=np.uint8)
    agent, labels, per_forward, logits, _, forward32_s = idm_labeling(dev, frames, "float32")
    del agent
    release_memory()
    agent, labels16, _, logits16, stack, forward16_s = idm_labeling(dev, frames, "bfloat16")
    del agent
    release_memory()
    params16_ms = idm_forward_ms(dev, stack, compute_dtype="bfloat16", params_dtype="bfloat16")
    release_memory()
    log(f"IDM device forward of {IDM_WINDOW_BATCH} windows: bfloat16 compute {1e3 * forward16_s:.1f} ms, bfloat16 "
        f"compute and parameters {params16_ms:.1f} ms")
    err = max((logits16[k] - logits[k]).abs().max().item() for k in logits)
    same = np.mean([all(np.array_equal(a[k], b[k]) for k in a) for (_, a), (_, b) in zip(labels, labels16)])
    log(f"IDM bfloat16 against float32: logits of a window batch max_abs_err {err:.3e} (tol {BF16_LOGIT_TOL}); "
        f"{100 * same:.1f}% of the frames get the same label (random heads have near-ties: not gated)")
    if not err <= BF16_LOGIT_TOL:
        raise AssertionError(f"the IDM's bfloat16 logits are {err} from the float32 ones")
    long_call = idm_long_call(dev)
    release_memory()
    float_labeling = {"frames": frames, "labels": labels, "logits": {k: v.cpu() for k, v in logits.items()},
                      "forward_ms": {"float32": 1e3 * forward32_s, "bfloat16": 1e3 * forward16_s}}
    return per_forward, train_launches, long_call, float_labeling


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
    its snapshot; the max-abs gaps to the stepped logp_old and values, and
    the window's episode resets after its first step."""
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
            float(np.abs(out["vpred"][..., 0].cpu().numpy() - traj["values"]).max()), int(traj["firsts"][:, 1:].sum()))


def ppo_state(trainer):
    """A PPO trainer's state that an update or an aux phase reads (and its
    frozen anchor), cloned."""
    return {"policy": cloned(trainer.policy.state_dict()), "anchor": cloned(trainer.anchor.state_dict()),
            "adam": cloned(trainer.optimizer.adam.state_dict()),
            "gens": (trainer.sample_generator.get_state(), trainer.perm_generator.get_state()),
            "kl_coef": trainer.kl_coef, "update_count": trainer.update_count, "aux_buffer": list(trainer._aux_buffer)}


def ppo_load(trainer, s):
    trainer.policy.load_state_dict(s["policy"])
    trainer.optimizer.adam.load_state_dict(cloned(s["adam"]))
    trainer.sample_generator.set_state(s["gens"][0])
    trainer.perm_generator.set_state(s["gens"][1])
    trainer.kl_coef, trainer.update_count = s["kl_coef"], s["update_count"]
    trainer._aux_buffer = list(s["aux_buffer"])


def ppo_card_vs_cpu(dev, policy_kwargs=None, label="2x"):
    """Phase 9(a) (and 13(e) with a variant's `policy_kwargs`): a trajectory
    collected on the card, then one update and one PPG aux phase (one aux
    step) on the card and on the CPU from the same weights and anchor; and
    the collection's snapshot re-forward at G = 1 and 2.

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
    from vpt_tpu_torch.models.transformer import map_state
    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.training.bc import ClippedAdam
    from vpt_tpu_torch.training.rl import PPOHyperparams, PPOTrainer

    def make(device):
        hp = PPOHyperparams(rollout_len=PPO_CHECK_STEPS, n_epochs=1, n_minibatches=1, aux_phase_every=1000,
                            aux_epochs=1, normalize_advantages=False)
        return PPOTrainer(policy_kwargs or FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, hp=hp, seed=0,
                          device=device)

    t0 = time.perf_counter()
    cpu = make("cpu")
    cpu.init()
    with torch.no_grad():
        for head in cpu.anchor.pi_head.children():
            head.linear_layer.weight.mul_(100.0)
    gpu = make(dev)  # the CPU trainer's twin: its weights and anchor copied, not drawn again
    gpu.policy, gpu.anchor = copy.deepcopy(cpu.policy).to(dev), copy.deepcopy(cpu.anchor).to(dev)
    gpu.optimizer = ClippedAdam(gpu.policy.parameters(), gpu.hp)
    log(f"{label} PPOTrainer on the card and on the CPU built in {time.perf_counter() - t0:.1f} s")
    if not (same_tensors(gpu.policy.state_dict(), cpu.policy.state_dict())
            and same_tensors(gpu.anchor.state_dict(), cpu.anchor.state_dict())):
        raise AssertionError("the card's and the CPU's PPO trainers start from different weights or anchors")

    errs = {g: reforward_errors(gpu, g) for g in (1, 2)}
    log(f"PPO collection ({label}, f32, 2 streams x 16 steps, two windows): stepped logp_old / values against the "
        "chunked re-forward from the window-start snapshot, max_abs_err "
        + ", ".join(f"G={g}: {a:.3e} / {b:.3e} ({n} resets inside the window)" for g, (a, b, n) in errs.items())
        + f" (tol {STEP_TOL})")
    if not all(e <= STEP_TOL for a, b, _ in errs.values() for e in (a, b)):
        raise AssertionError(f"the stepped collection disagrees with the snapshot re-forward: {errs}")
    if not any(n for _, _, n in errs.values()):
        raise AssertionError("no episode reset inside a re-forwarded window")

    gpu.hp.n_collect_groups = 1
    envs = [MockMinecraftEnv(seed=i, done_prob=0.1) for i in range(PPO_CHECK_STREAMS)]
    traj, _, _ = gpu.collect(envs, reward_fn=attack_reward)
    traj["logp_old"] = traj["logp_old"] + 0.3 * np.random.default_rng(5).standard_normal(
        traj["logp_old"].shape).astype(np.float32)
    traj_cpu = dict(traj, initial_state=map_state(torch.Tensor.cpu, traj["initial_state"]))

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
    relus = ReluDecisions(), ReluDecisions()
    with relus[0].record(gpu.policy):
        m_g = gpu.update(traj)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with relus[0].replay(cpu.policy):
        m_c = cpu.update(traj_cpu)
    cpu_s = time.perf_counter() - t0
    stats_err = max(rel_l2(a.cpu(), b) for a, b in zip(gpu.policy.value_head.normalizer.buffers(),
                                                        cpu.policy.value_head.normalizer.buffers()))
    cpu.policy.load_state_dict(gpu.policy.state_dict())
    with relus[1].record(gpu.policy):
        m_g.update(gpu._aux_phase())
    with relus[1].replay(cpu.policy):
        m_c.update(cpu._aux_phase())

    keys = ("pg_loss", "v_loss", "entropy", "anchor_kl", "approx_kl", "aux_v_loss")
    rel = {k: abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in keys}
    # the loss sums terms that nearly cancel: its rounding scales with the terms, not with the sum
    hp = gpu.hp
    terms = abs(m_c["pg_loss"]) + hp.vf_coef * abs(m_c["v_loss"]) + hp.ent_coef * abs(m_c["entropy"]) \
        + m_c["kl_coef"] / hp.kl_decay * abs(m_c["anchor_kl"])
    rel["loss"] = abs(m_g["loss"] - m_c["loss"]) / terms
    rel["grad_norm"] = abs(m_g["grad_norm"] - m_c["grad_norm"]) / m_c["grad_norm"]
    log(f"PPO update card vs CPU ({label}, f32, 2 x 16, one PPO step, then one aux step from the same weights): "
        + ", ".join(f"{k} {m_g[k]:.6g} vs {m_c[k]:.6g} (rel {rel[k]:.2e})" for k in ("loss",) + keys + ("grad_norm",))
        + f" (the loss relative to the sum of its terms' sizes, {terms:.4g}); clip_frac {m_g['clip_frac']:.4f} vs "
        f"{m_c['clip_frac']:.4f}; aux_clone_kl {m_g['aux_clone_kl']:.3g} vs {m_c['aux_clone_kl']:.3g}; tol "
        f"{LOSS_RTOL} ({NORM_RTOL} for the grad norm); CPU update {cpu_s:.1f} s")
    log(f"  folded EWMA stats: relative error {stats_err:.2e} (tol {STATS_RTOL})")
    if len(grads_g) != 2 or len(grads_c) != 2:
        raise AssertionError(f"expected a PPO step and an aux step, got {len(grads_g)} and {len(grads_c)}")
    worst_l2 = []
    for name, g, c, relu in zip(("PPO step", "aux step"), grads_g, grads_c, relus):
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
            f"relative L2 error {wc[0]:.3e} ({wc[1]}, tol {CNN_GRAD_REL_L2}); {relu.report()}"
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
    """Seconds spent in wrapped callables, each call ended by a synchronise,
    and the peak device memory (GB) of each name's calls."""

    def __init__(self):
        self.seconds, self.peak_gb = {}, {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            self.peak_gb[name] = max(self.peak_gb.get(name, 0.0), torch.cuda.max_memory_allocated() / 1e9)
            return out

        return timed


def ppo_at_bench_geometry(dev):
    """Phase 9(b): vpt_tpu's PPO geometry in bfloat16, one warm and one timed
    collect and update; returns the trainer and the timed update's B1 and B2
    launches."""
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.ops import host_resize
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

    resident_gb = torch.cuda.memory_allocated() / 1e9  # weights, anchor, Adam, grads after the warm update
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    traj, obs, firsts = trainer.collect(envs, obs, firsts, reward_fn=attack_reward)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    collect_peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
    reset_launch_counts()
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
    split = dict(watch.seconds, other=update_s - sum(watch.seconds.values()))
    log(f"PPO at vpt_tpu's bench geometry (2x, bf16, {streams} streams x {PPO_STEPS} steps, {PPO_GROUPS} collection "
        f"groups, {PPO_MINIBATCHES} minibatches, {PPO_EPOCHS} epochs, anchor chunks of {PPO_ANCHOR_FRAMES} frames): "
        f"warm collect + update {warm_s:.1f} s; collect {collect_s:.2f} s ({frames / collect_s:.1f} frames/s; host "
        f"resize alone {resize_s:.2f} s, {100 * resize_s / collect_s:.1f}%, backend {host_resize.backend()}; "
        f"{host_cores()}); update {update_s:.2f} s ({frames / update_s:.1f} frames/s) = "
        + ", ".join(f"{k} {v:.2f} s" for k, v in split.items())
        + f"; a collect and update {frames / (collect_s + update_s):.1f} frames/s; B1 launches {launches[0]}, "
        f"B2 {launches[1]}")
    log(f"  memory: {resident_gb:.2f} GB resident before the collect; peaks: collect {collect_peak_gb:.2f} GB; " + ", ".join(
        f"{k} {v:.2f} GB" for k, v in watch.peak_gb.items()) + " (each from the device's state when it starts)")
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


def ppo_aux_at_bench_geometry(dev):
    """Phase 9(d): one collect and update at 9(b)'s geometry with a PPG aux
    phase after every update (aux_phase_every=1, the default 4 aux epochs),
    so each aux step trains on the whole 64 x 64 = 4096-frame rollout, with
    remat and the chunked CNN; its seconds and peak (an OOM fails the run)."""
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.training import rl

    hp = rl.PPOHyperparams(rollout_len=PPO_STEPS, n_collect_groups=PPO_GROUPS, n_minibatches=PPO_MINIBATCHES,
                           n_epochs=PPO_EPOCHS, anchor_fwd_max_frames=PPO_ANCHOR_FRAMES, aux_phase_every=1)
    trainer = rl.PPOTrainer(dict(FOUNDATION_POLICY_KWARGS, cnn_scan_chunks=REMAT_CHUNKS), FOUNDATION_PI_HEAD_KWARGS,
                            hp=hp, compute_dtype="bfloat16", remat=True, seed=0, device=dev)
    envs = [MockMinecraftEnv(seed=i) for i in range(PPO_STREAMS)]
    trainer.init()
    watch = Stopwatch()
    trainer._aux_phase = watch.wrap("aux phase", trainer._aux_phase)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    label = (f"PPO with the aux phase (2x, bf16, {PPO_STREAMS} streams x {PPO_STEPS} steps, aux_phase_every 1, "
             f"{hp.aux_epochs} aux epochs on {PPO_STREAMS * PPO_STEPS} frames a step, remat, {REMAT_CHUNKS} CNN chunks)")
    t0 = time.perf_counter()
    traj, _, _ = trainer.collect(envs, reward_fn=attack_reward)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    metrics = trainer.update(traj)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = (wa.launches, wa.bwd_launches)
    log(f"{label}: collect {collect_s:.2f} s, update {seconds - collect_s:.2f} s of which the aux phase "
        f"{watch.seconds['aux phase']:.2f} s (peak {watch.peak_gb['aux phase']:.2f} GB); peak memory of the collect "
        f"and update {peak_gb:.2f} GB; B1 launches {launches[0]}, B2 {launches[1]}; aux_v_loss "
        f"{metrics['aux_v_loss']:.6f}, aux_clone_kl {metrics['aux_clone_kl']:.3e}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"the PPO update with the aux phase has metrics that are not finite: {metrics}")
    # collection and anchor chunks launch B1 once a block; each PPO and aux step twice (forward, recompute),
    # and the aux phase's clone-target forward once; B2 once a block and step
    n_blocks = trainer.cfg.n_recurrence_layers
    anchor_chunks = PPO_STREAMS * PPO_STEPS // (PPO_ANCHOR_FRAMES // PPO_STEPS * PPO_STEPS)
    steps = PPO_EPOCHS * PPO_MINIBATCHES + hp.aux_epochs
    expect = ((anchor_chunks + 1 + 2 * steps) * n_blocks, steps * n_blocks)
    if launches != expect:
        raise AssertionError(f"the PPO update with the aux phase launched B1 {launches[0]} and B2 {launches[1]} "
                             f"times, expected {expect}")
    return seconds


def check_ppo(dev):
    """Phase 9: (a) card against CPU, (b) vpt_tpu's geometry, (c) evaluate,
    (d) the aux phase on a whole rollout with remat; returns the (b)
    update's B1 and B2 launches."""
    trainer = ppo_card_vs_cpu(dev)
    del trainer
    release_memory()
    trainer, launches = ppo_at_bench_geometry(dev)
    ppo_evaluate(trainer)
    del trainer
    release_memory()
    ppo_aux_at_bench_geometry(dev)
    release_memory()
    return launches


# phase 10's blocks: (label, hidsize, heads, timesteps, attention_memory_size); d = hidsize / heads
WIDE_BLOCKS = (("d=256", 512, 2, 8, 16), ("band 640", 128, 2, 8, 648))
# phase 10's kernel shapes: (t, T, bandsize) with the band wider than 512 offsets, past 512 keys and within them
WIDE_BAND_SHAPES = ((128, 768, 640), (128, 256, 640))


def wide_band_kernels(dev):
    """B1 and B2 against their plain versions with a 640-wide band table, at
    d = 128 and 256, mask and bias, in both types."""
    from vpt_tpu_torch.ops import windowed_attention as wa

    for t, T, bandsize in WIDE_BAND_SHAPES:
        for d in (128, 256):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, mask, R, _ = attention_inputs(dev, 2, 16, t, T - t, d, dtype, d + T)
                b_nd = 0.2 * torch.randn((R.shape[-1], bandsize), generator=torch.Generator(device=dev).manual_seed(T),
                                         device=dev)
                label = f"d={d} t={t} T={T} band {bandsize}"
                check_b1_case(wa, q, k, v, mask, R, b_nd, label)
                dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(t), device=dev).to(dtype)
                got = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
                torch.cuda.synchronize()
                errs = b2_errors(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True), dtype)
                log(f"B2 {label} {str(dtype)[6:]} mask=True rel=True: max_abs_err (tol) "
                    + ", ".join(f"{n} {e:.3e} ({b:.2e})" for n, (e, b) in errs.items()))
                if not all(e <= b for e, b in errs.values()):
                    raise AssertionError(f"B2 disagrees with its plain version ({label}): {errs}")


def wide_block(dev, label, hidsize, heads, timesteps, memory):
    """One transformer block at a shape past the published models', on the
    card against the CPU from the same weights and inputs: output and every
    gradient within F32_TOL·(1 + max|ref|), through one B1 and one B2 launch."""
    import copy

    from vpt_tpu_torch.models.layers import init_parameters
    from vpt_tpu_torch.models.transformer import ResidualRecurrentBlock
    from vpt_tpu_torch.ops import windowed_attention as wa

    cpu_block = ResidualRecurrentBlock(hidsize, timesteps, attention_heads=heads, attention_memory_size=memory)
    init_parameters(cpu_block, torch.Generator().manual_seed(0))
    card_block = copy.deepcopy(cpu_block).to(dev)
    B, T, maxlen = 2, timesteps, memory - timesteps
    g = torch.Generator().manual_seed(1)
    x, gout = torch.randn((B, T, hidsize), generator=g), torch.randn((B, T, hidsize), generator=g)
    first = torch.zeros((B, T), dtype=torch.bool)
    first[1, T // 2] = True
    state = {"state_mask": torch.rand((B, maxlen), generator=g) < 0.75,
             "k": torch.randn((B, maxlen, hidsize), generator=g), "v": torch.randn((B, maxlen, hidsize), generator=g)}

    def run(block, device):
        xs = x.to(device).requires_grad_(True)
        out, _ = block(xs, first.to(device), {k: v.to(device) for k, v in state.items()})
        return [out] + list(torch.autograd.grad(out, [xs] + list(block.parameters()), gout.to(device)))

    reset_launch_counts()
    got = run(card_block, dev)
    torch.cuda.synchronize()
    counts = (wa.launches, wa.bwd_launches)
    expect = run(cpu_block, torch.device("cpu"))
    names = ["output", "x"] + [n for n, _ in cpu_block.named_parameters()]
    errs = {n: (a.cpu() - b).abs().max().item() / (1 + b.abs().max().item()) for n, a, b in zip(names, got, expect)}
    worst = max(errs, key=errs.get)
    log(f"{label} on the card (one block: hidsize {hidsize}, {heads} heads, d={hidsize // heads}, t={T}, "
        f"T={T + maxlen} keys, band {maxlen}): output and {len(names) - 1} grads against the CPU: worst max-abs "
        f"error / (1 + max|ref|) {errs[worst]:.3e} ({worst}, tol {F32_TOL}); B1 {counts[0]}, B2 {counts[1]}")
    if counts != (1, 1):
        raise AssertionError(f"{label}: launches (B1, B2) {counts}, expected (1, 1)")
    if not errs[worst] <= F32_TOL:
        raise AssertionError(f"{label}: the block on the card disagrees with the CPU: {errs[worst]} ({worst})")


def check_wide_shapes(dev):
    """Phase 10: d = 256 and a band table wider than 512 offsets go through
    B1 and B2, held against their plain versions and the CPU."""
    wide_band_kernels(dev)
    for block in WIDE_BLOCKS:
        wide_block(dev, *block)


# ------------------------------------------------------------------ phase 16

# head dims past the four the kernels take whole: zero-padded to the next multiple of 64 (16: the tiny test
# configs; 32: hidsize 512 at 16 heads; 96) and the streamed instance, 64 columns at a time (384: hidsize 6144
# at 16 heads; 512; 640; 1024: hidsize 1024 at 1 head; 2048: hidsize 2048 at 1 head), checked and timed
HEAD_DIMS = (16, 32, 96, 384, 512, 640, 1024, 2048)
HEAD_DIM_SHAPE = (4, 8, 128, 128)  # (B, H, t, maxlen) of 16(a): the 2x chunk's geometry at 8 heads
# 16(a)'s checks besides HEAD_DIMS at HEAD_DIM_SHAPE, (d, B, H, t, maxlen): the streamed instance past 512 keys
# (its accumulators carried in the scratch), and d = 4096 (hidsize 4096 at 1 head), checked, not timed
HEAD_DIM_CHECKS = ((384, 1, 4, 128, 512), (1024, 1, 2, 128, 512), (4096, 1, 2, 128, 128))
# the streamed instance's shared memory, the same at every d: read at these two, at HEAD_DIM_SHAPE's keys and band
STREAMED_SMEM_DIMS = (320, 4096)
# 16(b)'s one-block policies: (hidsize, heads), d = 32, 96 and 1024, the 2x policy's CNN at width 1
HEAD_DIM_POLICIES = ((256, 8), (384, 4), (1024, 1))


def streamed_smem(T, bandsize, nbasis=10):
    """The dynamic shared memory of B1's and B2's launches at the streamed
    instance's two STREAMED_SMEM_DIMS, in both types; fails unless they
    are the same at both."""
    from vpt_tpu_torch.ops import windowed_attention as wa

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        at = {d: wa.launch_smem_bytes(T, d, nbasis, bandsize, dtype) for d in STREAMED_SMEM_DIMS}
        log(f"streamed instance, {str(dtype)[6:]}, T={T}, band {bandsize}: dynamic shared memory (bytes) "
            + "; ".join(f"d={d}: {b}" for d, b in at.items()))
        if len({tuple(b.items()) for b in at.values()}) != 1:
            raise AssertionError(f"the streamed instance's shared memory depends on d: {at}")
        out[str(dtype)[6:]] = at[STREAMED_SMEM_DIMS[0]]
    return out


def head_dim_kernels(dev):
    """Phase 16(a): B1 and B2 at every d of HEAD_DIMS and HEAD_DIM_CHECKS,
    f32 and bf16, mask and relative bias, against their plain versions at
    phase 3's and 6's limits; the streamed instance's shared memory; then
    the times of HEAD_DIMS at the 2x chunk's geometry (a bound of the
    unpadded work).  Returns {"d=<d> <dtype>": {"B1": timing keys, "B2":
    ...}} and the shared memory."""
    from vpt_tpu_torch.ops import windowed_attention as wa

    t0 = time.perf_counter()
    B, H, t, maxlen = HEAD_DIM_SHAPE
    cases = [(d, B, H, t, maxlen) for d in HEAD_DIMS] + list(HEAD_DIM_CHECKS)
    for d, b, h, tq, ml in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, R, b_nd = attention_inputs(dev, b, h, tq, ml, d, dtype, d + ml)
            label = f"d={d} T={tq + ml}"
            check_b1_case(wa, q, k, v, mask, R, b_nd, label)
            dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(d), device=dev).to(dtype)
            got = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
            torch.cuda.synchronize()
            errs = b2_errors(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True), dtype)
            log(f"B2 {label} {str(dtype)[6:]} mask=True rel=True: max_abs_err (tol) "
                + ", ".join(f"{n} {e:.3e} ({b:.2e})" for n, (e, b) in errs.items()))
            if not all(e <= b for e, b in errs.values()):
                raise AssertionError(f"B2 disagrees with its plain version ({label}): {errs}")
    log(f"  16(a) checks: {time.perf_counter() - t0:.1f} s")
    smem = streamed_smem(t + maxlen, maxlen)
    times = {}
    for d in HEAD_DIMS:
        q, k, v, mask, R, b_nd = attention_inputs(dev, B, H, t, maxlen, d, torch.float32, d)
        dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(d + 1), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd, gd = (x.to(dtype) for x in (q, k, v, dO))
            times[f"d={d} {str(dtype)[6:]}"] = {
                "B1": dict(zip(TIME_KEYS, time_b1(qd, kd, vd, mask, R, b_nd, label=f"d={d} (B={B}, H={H})"))),
                "B2": dict(zip(TIME_KEYS, time_b2(qd, kd, vd, mask, R, b_nd, gd, label=f"d={d} (B={B}, H={H})"))),
            }
    return times, smem


def head_dim_policy(dev, hidsize, heads):
    """Phase 16(b): a one-block policy at d = hidsize / heads on the card
    against the CPU from the same weights: a (2, 16) chunked forward (logits
    and value at phase 5's limit, the CPU replaying the card's dense ReLU
    decisions) and one BC step at phase 7(a)'s limits.  Returns the B1 and
    B2 launches of the two."""
    from vpt_tpu_torch.models.policy import policy_initial_state
    from vpt_tpu_torch.ops import windowed_attention as wa

    kwargs = variant_kwargs(hidsize=hidsize, attention_heads=heads, n_recurrence_layers=1, impala_width=1,
                            timesteps=16, attention_memory_size=32)
    gpu, cpu = bc_trainer_pair(dev, kwargs)
    B, T = 2, 16
    g = torch.Generator().manual_seed(2)
    img = torch.randint(0, 256, (B, T, *gpu.cfg.img_shape), generator=g, dtype=torch.uint8)
    first = torch.zeros((B, T), dtype=torch.bool)
    first[:, 0] = first[1, T // 2] = True
    reset_launch_counts()
    relus = ReluDecisions()
    with torch.no_grad():
        with relus.record(gpu.policy):
            out_g, _ = gpu.policy(img.to(dev), first.to(dev), policy_initial_state(gpu.cfg, B, ring=False, device=dev))
        torch.cuda.synchronize()
        forward = wa.launches
        with relus.replay(cpu.policy):
            out_c, _ = cpu.policy(img, first, policy_initial_state(cpu.cfg, B, ring=False))
    errs = {k: (out_g["pi_logits"][k].cpu() - out_c["pi_logits"][k]).abs().max().item() for k in out_c["pi_logits"]}
    errs["vpred"] = (out_g["vpred"].cpu() - out_c["vpred"]).abs().max().item()
    log(f"d={hidsize // heads} policy (hidsize {hidsize}, {heads} heads, 1 block), chunked ({B}, {T}) forward card vs "
        f"CPU: max_abs_err {errs} (tol {STEP_TOL}), B1 launches {forward}; {relus.report()}")
    if not all(e <= STEP_TOL for e in errs.values()) or forward != 1:
        raise AssertionError(f"the d={hidsize // heads} chunked forward disagrees with the CPU's ({errs}) or "
                             f"launched B1 {forward} times")
    train_card_vs_cpu(dev, label=f"d={hidsize // heads} train_step", pair=(gpu, cpu))
    reset_launch_counts()  # the step above also ran the calibration's forwards and backwards
    gpu.train_step(bc_batch(dev, B, T, gpu.cfg.img_shape[0], 9), gpu.initial_state(B))
    torch.cuda.synchronize()
    counts = (wa.launches, wa.bwd_launches)
    log(f"  d={hidsize // heads} BC step at ({B}, {T}): B1 {counts[0]}, B2 {counts[1]} launches")
    if counts != (1, 1):
        raise AssertionError(f"the d={hidsize // heads} BC step launched (B1, B2) {counts}, expected (1, 1)")
    return {"forward": forward, "bc_step": counts}


def check_head_dims(dev):
    """Phase 16: head dims past the four the kernels take whole go through B1
    and B2 (16(a)), and one-block policies at d = 32, 96 and 1024 run on
    them (16(b))."""
    t0 = time.perf_counter()
    times, smem = head_dim_kernels(dev)
    seconds = {"(a)": time.perf_counter() - t0}
    launches = {}
    for h, n in HEAD_DIM_POLICIES:
        t = time.perf_counter()
        launches[f"d={h // n}"] = head_dim_policy(dev, h, n)
        seconds[f"(b) d={h // n}"] = time.perf_counter() - t
        release_memory()
    log(f"phase 16: {time.perf_counter() - t0:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    return times, launches, smem


# ------------------------------------------------------------------ phase 11

INT8_VALUE_ATOL = 0.15   # int8 against float value estimates (tests/test_int8.py, vpt_tpu's rule)
INT8_LOGIT_REL_L2 = 0.25  # int8 against float log-probabilities, relative L2 a head (tests/test_int8.py)
INT8_PRODUCT_LAYERS = ("net.recurrent_layer.blocks.0.r.orc_block.q_layer", "net.recurrent_layer.blocks.0.r.orc_block.r_layer",
                       "net.recurrent_layer.blocks.0.mlp0.layer", "net.recurrent_layer.blocks.0.mlp1.layer")


class CountedIntMM:
    """Counts the calls of torch._int_mm while active (the library product
    the int8 layers run on), and whether each was on CUDA tensors."""

    def __enter__(self):
        self.calls, self._real = [], torch._int_mm

        def counted(a, b):
            self.calls.append(a.is_cuda and b.is_cuda)
            return self._real(a, b)

        torch._int_mm = counted
        return self

    def __exit__(self, *exc):
        torch._int_mm = self._real


def weight_bytes(model, dtype=None):
    """Bytes of a model's parameters and buffers (of `dtype` only, if given)."""
    tensors = list(model.parameters()) + list(model.buffers())
    return sum(t.numel() * t.element_size() for t in tensors if dtype is None or t.dtype == dtype)


def quant_layers(model):
    from vpt_tpu_torch.ops.int8 import QuantLinear

    return sum(isinstance(m, QuantLinear) for m in model.modules())


def quantized_weights_match_cpu(float_model, quant_model):
    """The int8 codes and scales a quantized model holds on the card against
    those the CPU derives from the float model's weights: the names that
    differ in any byte, and the count compared."""
    from vpt_tpu_torch.ops.int8 import quantize_state_dict

    float_cpu = {k: v.cpu() for k, v in float_model.state_dict().items()}
    got = quant_model.state_dict()
    want = quantize_state_dict(float_cpu, got)
    keys = [k for k in want if k.endswith((".weight_q8", ".weight_scale"))]
    bad = [k for k in want if want[k].dtype != got[k].dtype or not torch.equal(want[k], got[k].cpu())]
    return bad, len(keys)


def int8_products_match_cpu(model, dev, rows_list):
    """int8_product of some layers of `model` on the card against the CPU's,
    exactly, and int8_matmul's largest difference, at each row count."""
    from vpt_tpu_torch.ops import int8

    g = torch.Generator().manual_seed(5)
    out = []
    for name in INT8_PRODUCT_LAYERS:
        layer = model.get_submodule(name)
        w_q, w_s = layer.weight_q8, layer.weight_scale
        for rows in rows_list:
            x = torch.randn((rows, w_q.shape[1]), generator=g)
            x_q, _ = int8.dynamic_quantize_rows(x)
            exact = torch.equal(int8.int8_product(x_q.to(dev), w_q).cpu(), x_q.int() @ w_q.cpu().int().t())
            y_err = (int8.int8_matmul(x.to(dev), w_q, w_s).cpu() - int8.int8_matmul(x, w_q.cpu(), w_s.cpu())).abs().max().item()
            out.append((name.rsplit(".", 2)[-2] + "." + name.rsplit(".", 1)[-1], tuple(w_q.shape), rows, exact, y_err))
    return out


@torch.inference_mode()
def lockstep_int8_vs_float(f_agent, q_agent, frames, steps):
    """Both agents' policies stepped at t=1 on the ring cache over the same
    resized frames (resets as in rollout_run): the largest value gap, the
    largest relative L2 gap of a head's log-probabilities, the share of
    stream-steps whose argmax action agrees, and the int8 layer calls."""
    from vpt_tpu_torch.models.policy import policy_initial_state

    streams, dev = f_agent.batch_size, f_agent.device
    states = [policy_initial_state(a.cfg, streams, ring=True, device=dev) for a in (f_agent, q_agent)]
    resets = {16 + 4 * i: i for i in range(streams)}
    v_err = logit_rel = 0.0
    agree = []
    with CountedIntMM() as mm:
        for step in range(steps):
            first = np.zeros(streams, bool)
            first[:] = step == 0
            if step in resets:
                first[resets[step]] = True
            img = torch.from_numpy(f_agent._env_obs_to_agent(frames[step % len(frames)])).to(dev)
            first_t = torch.from_numpy(first).to(dev)[:, None]
            outs = []
            for i, agent in enumerate((f_agent, q_agent)):
                out, states[i] = agent.policy(img, first_t, states[i])
                outs.append(out)
            v_err = max(v_err, (outs[1]["vpred"] - outs[0]["vpred"]).abs().max().item())
            for k in outs[0]["pi_logits"]:
                a, b = outs[0]["pi_logits"][k].float(), outs[1]["pi_logits"][k].float()
                logit_rel = max(logit_rel, rel_l2(b, a))
                agree.append((a.argmax(-1) == b.argmax(-1)).float().mean().item())
    return v_err, logit_rel, float(np.mean(agree)), mm.calls


def int8_serving(dev, steps=64, streams=8):
    """Phase 11(a): the 2x MineRLAgent with quantize_dense serving `streams`
    streams for `steps` deterministic steps through the native pool, beside
    the float agent from the same seed."""
    from vpt_tpu_torch.agent import MineRLAgent

    t0 = time.perf_counter()
    f_agent = MineRLAgent(device=dev, batch_size=streams, seed=0)
    q_agent = MineRLAgent(device=dev, batch_size=streams, seed=0, quantize_dense=True)
    torch.cuda.synchronize()
    n_quant = quant_layers(q_agent.policy)
    log(f"2x MineRLAgent float32 and quantize_dense built in {time.perf_counter() - t0:.1f} s; "
        f"{n_quant} int8 layers")
    bad, n_keys = quantized_weights_match_cpu(f_agent.policy, q_agent.policy)
    log(f"  int8 weights on the card against the CPU's from the same float weights: {n_keys} code and scale "
        f"tensors, {len(bad)} differ in any byte")
    if bad or not n_keys:
        raise AssertionError(f"the card's int8 weights differ from the CPU's: {bad[:4]}")
    f_bytes, q_bytes, q8_bytes = weight_bytes(f_agent.policy), weight_bytes(q_agent.policy), weight_bytes(
        q_agent.policy, torch.int8)
    log(f"  resident weight bytes: float32 {f_bytes / 1e6:.1f} MB, quantize_dense {q_bytes / 1e6:.1f} MB "
        f"(int8 codes {q8_bytes / 1e6:.1f} MB; the convolutions, norms and heads stay float32)")
    products = int8_products_match_cpu(q_agent.policy, dev, (streams, 512))
    log("  int8 products card vs CPU (torch._int_mm, exact int32; then dequantized, max_abs_err): "
        + "; ".join(f"{n} {s} x {r} rows: {'exact' if e else 'DIFFER'}, {err:.1e}" for n, s, r, e, err in products))
    if not all(e and err == 0.0 for *_, e, err in products):
        raise AssertionError("an int8 product on the card differs from the CPU's")

    rng = np.random.default_rng(0)
    frames = [synthetic_obs(rng, streams) for _ in range(4)]
    v_err, logit_rel, agree, calls = lockstep_int8_vs_float(f_agent, q_agent, frames, steps)
    log(f"  int8 against float32, {steps} steps x {streams} streams in lockstep: value max_abs_err {v_err:.4f} "
        f"(tol {INT8_VALUE_ATOL}), log-probabilities worst relative L2 a head and step {logit_rel:.4f} "
        f"(tol {INT8_LOGIT_REL_L2}); argmax actions agree at {100 * agree:.1f}% (not gated); torch._int_mm "
        f"{len(calls)} calls ({n_quant} a step), all on CUDA: {all(calls)}")
    if not (v_err <= INT8_VALUE_ATOL and logit_rel <= INT8_LOGIT_REL_L2):
        raise AssertionError("the int8 agent strays from the float agent")
    if len(calls) != n_quant * steps or not all(calls):
        raise AssertionError(f"{len(calls)} int8 products in {steps} steps, expected {n_quant * steps} on CUDA")

    rates = {}
    for label, agent in (("float32", f_agent), ("int8", q_agent)):
        _, t = rollout_run(agent, frames, steps, "native")
        rates[label] = t
    img = q_agent._env_obs_to_agent(frames[0])
    q16 = MineRLAgent(device=dev, batch_size=streams, seed=0, quantize_dense=True, compute_dtype="bfloat16")
    step16 = device_step_ms(q16, img)
    del q16
    log(f"  stepped rollout, native resize, {streams} streams x {steps} steps: "
        + ", ".join(f"{k} {t['frames_per_s']:.1f} frames/s ({t['ms_a_step']:.2f} ms/step; device step + D2H alone "
                    f"{t['device_step_ms']:.2f} ms)" for k, t in rates.items())
        + f"; int8 with bfloat16 compute: device step + D2H {step16:.2f} ms")
    del f_agent, q_agent
    release_memory()


def int8_labeling(dev, float_labeling):
    """Phase 11(b): the 4x IDM with quantize_dense labels phase 8(b)'s frames;
    its labels and first-batch logits against the float32 agent's.  Returns
    B1's launches a forward."""
    with CountedIntMM() as mm:
        agent, labels, per_forward, logits, _, forward_s = idm_labeling(
            dev, float_labeling["frames"], "float32", quantize_dense=True)
    n_quant = quant_layers(agent.policy)
    del agent
    release_memory()
    same = np.mean([all(np.array_equal(a[k], b[k]) for k in a)
                    for (_, a), (_, b) in zip(labels, float_labeling["labels"])])
    rel = {k: rel_l2(logits[k].cpu(), v) for k, v in float_labeling["logits"].items()}
    ms = float_labeling["forward_ms"]
    log(f"  int8 IDM device forward of {IDM_WINDOW_BATCH} windows {1e3 * forward_s:.1f} ms against float32 "
        f"{ms['float32']:.1f} and bfloat16 {ms['bfloat16']:.1f} (8(b)); {100 * same:.1f}% of the frames get the "
        f"float32 agent's label (not gated); log-probabilities relative L2 against float32 "
        + ", ".join(f"{k} {v:.4f}" for k, v in rel.items())
        + f" (tol {INT8_LOGIT_REL_L2}); torch._int_mm {len(mm.calls)} calls ({n_quant} a forward), all on CUDA: "
        f"{all(mm.calls)}")
    if not all(v <= INT8_LOGIT_REL_L2 for v in rel.values()):
        raise AssertionError(f"the int8 IDM's logits stray from the float32 ones: {rel}")
    if not mm.calls or not all(mm.calls) or len(mm.calls) % n_quant:
        raise AssertionError(f"{len(mm.calls)} int8 products, expected a multiple of {n_quant}, all on CUDA")
    return per_forward


def check_int8_qat(dev, float_labeling):
    """Phase 11: int8 serving (a) and labeling (b), QAT BC (c) and IDM (d)
    steps on the card against the CPU; returns B1's launches an int8
    labeling forward and B1's and B2's a QAT BC and IDM step."""
    int8_serving(dev)
    per_forward = int8_labeling(dev, float_labeling)
    trainer, cpu = train_card_vs_cpu(dev, label="QAT train_step", qat_dense=True)
    del cpu
    log(f"  QAT: {sum(getattr(m, 'fake_quant', False) for m in trainer.policy.modules())} dense layers fake-quantized")
    per_step = train_steps(trainer, dev, steps=3, label="QAT BC train",  # B1 and B2 alike, checked there
                           c1_per_step=C1_POLICY_CONVS)[0]
    del trainer
    release_memory()
    trainer = idm_card_vs_cpu(dev, label="QAT IDM", qat_dense=True)
    reset_launch_counts()
    trainer.train_step(idm_batch(1, 8, 12))
    idm_launches = launch_counts()
    n_blocks = trainer.cfg.n_recurrence_layers
    log(f"  QAT IDM step launches: B1 {idm_launches[0]}, B2 {idm_launches[1]}")
    if idm_launches != (n_blocks, n_blocks):
        raise AssertionError(f"a QAT IDM step launched B1 and B2 {idm_launches}, expected {n_blocks} each")
    del trainer
    release_memory()
    return per_forward, (per_step, per_step), idm_launches


# ------------------------------------------------------------------ phase 12


def launch_counts():
    from vpt_tpu_torch.ops import windowed_attention as wa

    return wa.launches, wa.bwd_launches


def differing(a, b, path=""):
    """The paths at which two nested trees of tensors and values differ in
    any bit."""
    if isinstance(a, torch.Tensor):
        same = isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
        return [] if same else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [path]
        return [p for k in a for p in differing(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [path]
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in differing(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def max_param_gap(a, b):
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a.values(), b.values()))


def dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms (cuDNN's deterministic convolutions,
    sorted scatter-adds behind gather's backward, a fixed cuBLAS workspace),
    so that a step taken twice from one state gives the same bits; the
    earlier setting is put back after."""
    was, env = torch.are_deterministic_algorithms_enabled(), os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def resume_within_spread(label, state_of, load_state, save, fresh_restore, step3):
    """Phase 12's protocol, on a trainer that has taken 2 steps, with
    deterministic algorithms on: `state_of(trainer)` is its whole state
    (weights, optimizer, counters, generators, carried recurrent state),
    `load_state` puts one back.  Save through `save(path)`; take step 3
    RESUME_RUNS times from the saved state: they must agree bit for bit (the
    spread is 0), in the loss step3 returns and in every parameter after it;
    restore into a fresh trainer with `fresh_restore(path)`, whose state must
    equal the saved one bit for bit; its step 3 must equal the uninterrupted
    ones bit for bit.  Returns B1's and B2's launches in the resumed step."""
    with deterministic_algorithms():
        snap = state_of(None)
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(tmp)
            save_s = time.perf_counter() - t0
            nbytes = dir_bytes(tmp)
            runs = []
            for _ in range(RESUME_RUNS):
                load_state(snap)
                runs.append(step3(None))
            t0 = time.perf_counter()
            fresh = fresh_restore(tmp)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        wrong = differing(state_of(fresh), snap)
        if wrong:
            raise AssertionError(f"the {label} state restored into a fresh trainer differs at {wrong[:6]}")
        reset_launch_counts()
        loss, params = step3(fresh)
        launches = launch_counts()
    pairs = [(a, b) for i, a in enumerate(runs) for b in runs[i + 1:]]
    spread_loss = max(abs(a[0] - b[0]) for a, b in pairs)
    spread_param = max(max_param_gap(a[1], b[1]) for a, b in pairs)
    gap_loss, gap_param = abs(loss - runs[0][0]), max_param_gap(params, runs[0][1])
    log(f"{label} resume: checkpoint {nbytes / 1e9:.3f} GB, save {save_s:.2f} s, restore into a fresh trainer "
        f"{restore_s:.2f} s, its state equal to the saved one bit for bit; step 3 resumed against uninterrupted: "
        f"loss gap {gap_loss:.3e}, largest parameter gap {gap_param:.3e}; spread of {RESUME_RUNS} uninterrupted "
        f"step 3s from the saved state: loss {spread_loss:.3e}, parameters {spread_param:.3e}; resumed step launches "
        f"B1 {launches[0]}, B2 {launches[1]}")
    if any(a[0] != runs[0][0] or differing(a[1], runs[0][1]) for a in runs[1:]):
        raise AssertionError(f"the {label} step 3 is not deterministic: {RESUME_RUNS} runs from one state differ")
    wrong = differing(params, runs[0][1])
    if loss != runs[0][0] or wrong:
        raise AssertionError(f"the resumed {label} step 3 differs from the uninterrupted ones "
                             f"(loss gap {gap_loss:.3e}, parameters at {wrong[:6]})")
    return launches


def trainer_state(trainer, carried=None):
    """A BC or IDM trainer's whole state, cloned: weights, Adam, step count,
    and the carried recurrent state."""
    return {"policy": cloned(trainer.policy.state_dict()), "adam": cloned(trainer.optimizer.adam.state_dict()),
            "step_count": trainer.step_count, "carried": cloned(carried)}


def trainer_load(trainer, snap):
    trainer.policy.load_state_dict(snap["policy"])
    trainer.optimizer.adam.load_state_dict(cloned(snap["adam"]))
    trainer.optimizer.zero_grad()
    trainer.step_count = snap["step_count"]


def resume_trainer(dev, label, make, batches, step):
    """Phase 12 for a BC or IDM trainer: ``step(trainer, batch, state)`` takes
    one step and returns (loss, state), ``state`` None for the IDM."""
    trainer = make(0)
    trainer.init()
    carried = {"state": None}
    for batch in batches[:2]:
        _, carried["state"] = step(trainer, batch, carried["state"])
    after_two = carried["state"]

    def state_of(t):
        if t is None:
            return trainer_state(trainer, after_two)
        return trainer_state(t[0], t[1])

    def load_state(snap):
        trainer_load(trainer, snap)
        carried["state"] = cloned(snap["carried"])

    def save(path):
        trainer.save_checkpoint(path, extra=None if after_two is None else {"recurrent_state": after_two})

    def fresh_restore(path):
        fresh = make(1)  # another seed: the restore must bring every weight
        _, extra = fresh.restore_checkpoint(path)
        state = None if extra is None else [{k: v.to(dev) for k, v in blk.items()} for blk in extra["recurrent_state"]]
        return fresh, state

    def step3(restored):
        t, state = (trainer, carried["state"]) if restored is None else restored
        loss, _ = step(t, batches[2], state)
        return loss, cloned(t.policy.state_dict())

    launches = resume_within_spread(label, state_of, load_state, save, fresh_restore, step3)
    n_blocks = trainer.cfg.n_recurrence_layers
    if launches != (n_blocks, n_blocks):
        raise AssertionError(f"the resumed {label} step launched B1 and B2 {launches}, expected {n_blocks} each")
    return launches


def resume_bc(dev, B=4, T=128):
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.training.bc import BCTrainer

    def make(seed):
        return BCTrainer(FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, seed=seed, device=dev)

    batches = [bc_batch(dev, B, T, 128, 500 + s, firsts_at=[0] * B if s == 0 else [None, T // 3, None, 2 * T // 3][:B])
               for s in range(3)]

    def step(trainer, batch, state):
        state = trainer.initial_state(B) if state is None else state
        state, loss, _ = trainer.train_step(batch, state)
        return loss.item(), state

    return resume_trainer(dev, f"BC (2x, B={B}, T={T}, f32)", make, batches, step)


def resume_idm(dev):
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer

    def make(seed):
        return IDMTrainer(IDM_4X_KWARGS, {}, hp=IDMHyperparams(batch_size=1, window=8), seed=seed, device=dev)

    batches = [idm_batch(1, 8, 600 + s) for s in range(3)]

    def step(trainer, batch, state):
        return trainer.train_step(batch)[0].item(), None

    return resume_trainer(dev, "IDM (4x, B=1, T=8, f32)", make, batches, step)


def resume_ppo(dev):
    """Phase 12 for PPO at phase 9(a)'s size: 2 streams x 16 steps an update,
    2 epochs of 2 minibatches, each update's env streams fresh (they restart
    on resume, as in vpt_tpu); the loss is the last minibatch step's."""
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.training.rl import PPOHyperparams, PPOTrainer

    hp = dict(rollout_len=PPO_CHECK_STEPS, n_epochs=2, n_minibatches=2)

    def make(seed):
        t = PPOTrainer(FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, hp=PPOHyperparams(**hp), seed=seed,
                       device=dev)
        t.init()
        return t

    def update(t, k):
        envs = [MockMinecraftEnv(seed=1000 * k + i, done_prob=0.1) for i in range(PPO_CHECK_STREAMS)]
        traj, _, _ = t.collect(envs, reward_fn=attack_reward)
        return t.update(traj)["loss"]

    trainer = make(0)
    for k in range(2):
        update(trainer, k)

    def fresh_restore(path):
        fresh = make(1)
        if not fresh.resume(path):
            raise AssertionError("no PPO checkpoint to resume")
        return fresh

    def step3(fresh):
        t = trainer if fresh is None else fresh
        return update(t, 2), cloned(t.policy.state_dict())

    launches = resume_within_spread("PPO (2x, 2 streams x 16 steps, f32)", lambda t: ppo_state(t or trainer),
                                    lambda s: ppo_load(trainer, s), trainer.save_checkpoint, fresh_restore, step3)
    n_blocks, steps = trainer.cfg.n_recurrence_layers, hp["n_epochs"] * hp["n_minibatches"]
    if launches != (n_blocks * (1 + steps), n_blocks * steps):
        raise AssertionError(f"the resumed PPO update launched B1 and B2 {launches}, expected "
                             f"{n_blocks * (1 + steps)} and {n_blocks * steps}")
    return launches


def check_resume(dev):
    """Phase 12: resumed BC, IDM and PPO runs against uninterrupted ones;
    returns each resumed step's (B1, B2) launches."""
    out = {}
    for key, fn in (("bc_step", resume_bc), ("idm_step", resume_idm), ("ppo_update", resume_ppo)):
        out[key] = fn(dev)
        release_memory()
    return out


# ------------------------------------------------------------------- phase 13

# (stride, maxlen) of strided attention at the 2x chunk's attention shape: a query's lattice reaches back 256 keys
STRIDED_CASES = ((2, 128), (4, 64))
API_STEPS, API_STREAMS = 64, 8  # phase 13(a)'s t=1 calls on the linear state, as phase 4's rollout
SAME_OPS_TOL = 1e-5  # the same function by two routes on the card (split against whole forward, v against pd)
API_FN_TOL = 1e-5  # get_logprob_of_action and get_kl_of_action_dists, card against CPU
HEAD_TOL = 1e-4  # the dict head's functions card against CPU, times (1 + max|ref|): f32 products of 2048 terms
NEAR_TIE = 1e-4  # a deterministic categorical sample is compared where the CPU's two best logits are this far apart


def variant_kwargs(**kw):
    """The 2x foundation policy's kwargs with a variant's overrides."""
    from vpt_tpu_torch.config import FOUNDATION_POLICY_KWARGS

    return dict(FOUNDATION_POLICY_KWARGS, **kw)


def max_errors(got, expect):
    """{name: max-abs error} of two dicts of tensors, on the CPU."""
    return {k: (got[k].float().cpu() - expect[k].float().cpu()).abs().max().item() for k in expect}


def policy_outputs(out):
    return {**out["pi_logits"], "vpred": out["vpred"]}


@torch.inference_mode()
def api_at_full_width(dev):
    """Phase 13(a): the reference API of the 2x policy on the card, and B1
    at its t=1 shape; returns B1's launches a call of each path and the
    t=1 shape's times."""
    from vpt_tpu_torch.agent import MineRLAgent
    from vpt_tpu_torch.models.heads import dict_sample
    from vpt_tpu_torch.models.policy import get_kl_of_action_dists, get_logprob_of_action, policy_initial_state
    from vpt_tpu_torch.ops import windowed_attention as wa

    agent = MineRLAgent(device=dev, batch_size=API_STREAMS, seed=0)
    policy, cfg, n_blocks = agent.policy, agent.cfg, agent.cfg.n_recurrence_layers
    g = torch.Generator(device=dev).manual_seed(13)
    B, T = 4, 128
    img = torch.randint(0, 256, (B, T) + tuple(cfg.img_shape), generator=g, device=dev, dtype=torch.uint8)
    first = torch.zeros((B, T), dtype=torch.bool, device=dev)
    first[:, 0] = True
    first[1, 50] = first[3, 90] = True
    whole, _ = policy(img, first, policy_initial_state(cfg, B, device=dev))
    reset_launch_counts()
    y, _ = policy.net.recurrent_layer(policy.embed(img), first, policy_initial_state(cfg, B, device=dev))
    split = policy.heads_from_recurrent(y)
    torch.cuda.synchronize()
    chunk_launches = launch_counts()[0]
    errs = max_errors(policy_outputs(split), policy_outputs(whole))
    log(f"13(a) heads_from_recurrent(recurrent_layer(embed(img))) against forward ({B}x{T}, 2x, f32): max_abs_err "
        f"{errs} (tol {SAME_OPS_TOL}); B1 launches {chunk_launches}")
    if not all(e <= SAME_OPS_TOL for e in errs.values()) or chunk_launches != n_blocks:
        raise AssertionError(f"the split forward disagrees or launched B1 {chunk_launches} times: {errs}")

    state, pd, pd_prev = policy_initial_state(cfg, API_STREAMS, device=dev), None, None
    worst, launches, steps_ms = {}, {"forward": set(), "get_output_for_observation": set(), "v": set()}, []
    for step in range(API_STEPS):
        obs = torch.randint(0, 256, (API_STREAMS,) + tuple(cfg.img_shape), generator=g, device=dev,
                            dtype=torch.uint8)
        first = torch.zeros(API_STREAMS, dtype=torch.bool, device=dev)
        first[:] = step == 0
        if 16 <= step < 16 + API_STREAMS:
            first[step - 16] = True
        reset_launch_counts()
        out, state_next = policy(obs[:, None], first[:, None], state)
        launches["forward"].add(launch_counts()[0])
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd_prev = pd
        pd, vpred, _ = policy.get_output_for_observation(obs, state, first)
        torch.cuda.synchronize()
        steps_ms.append(1e3 * (time.perf_counter() - t0))
        launches["get_output_for_observation"].add(launch_counts()[0])
        reset_launch_counts()
        v = policy.v(obs, first, state)
        launches["v"].add(launch_counts()[0])
        errs = max_errors({**pd, "vpred": vpred, "v": v},
                          {**{k: x[:, 0] for k, x in out["pi_logits"].items()}, "vpred": out["vpred"][:, 0, 0],
                           "v": out["vpred"][:, 0, 0]})
        worst = {k: max(worst.get(k, 0.0), e) for k, e in errs.items()}
        state = state_next
    log(f"13(a) get_output_for_observation and v against the stepped forward ({API_STREAMS} streams x {API_STEPS} "
        f"steps, linear state, resets at steps 0 and 16-23): max_abs_err {worst} (tol {SAME_OPS_TOL}); B1 launches "
        f"a call {launches}; get_output_for_observation {np.median(steps_ms[1:]):.2f} ms a call (median, host timing)")
    if not all(e <= SAME_OPS_TOL for e in worst.values()) or any(l != {n_blocks} for l in launches.values()):
        raise AssertionError(f"the t=1 reference API disagrees with the stepped forward or its launches: "
                             f"{worst} {launches}")

    action = dict_sample(pd, agent.head_specs, generator=torch.Generator(device=dev).manual_seed(3))
    pd_c, prev_c, action_c = ({k: x.cpu() for k, x in d.items()} for d in (pd, pd_prev, action))
    errs = {"logprob": (get_logprob_of_action(agent.head_specs, pd, action).cpu()
                        - get_logprob_of_action(agent.head_specs, pd_c, action_c)).abs().max().item(),
            "kl": (get_kl_of_action_dists(agent.head_specs, pd, pd_prev).cpu()
                   - get_kl_of_action_dists(agent.head_specs, pd_c, prev_c)).abs().max().item()}
    log(f"13(a) get_logprob_of_action and get_kl_of_action_dists card against CPU: max_abs_err {errs} "
        f"(tol {API_FN_TOL})")
    if not all(e <= API_FN_TOL for e in errs.values()):
        raise AssertionError(f"the reference API's functions disagree between card and CPU: {errs}")
    del agent
    release_memory()

    times = {}
    for dtype in (torch.float32, torch.bfloat16):  # B1 at one query row and 129 keys, as a t=1 call gives it
        q, k, v, mask, R, b_nd = attention_inputs(dev, API_STREAMS, 16, 1, 128, 128, dtype, 17)
        check_b1_case(wa, q, k, v, mask, R, b_nd, "t=1 T=129")
        times[str(dtype)[6:]] = dict(zip(TIME_KEYS, time_b1(q, k, v, mask, R, b_nd, label="t=1 step (8 streams)")))
    return {"chunked_heads_from_recurrent": chunk_launches, "t1_get_output_for_observation": n_blocks,
            "t1_v": n_blocks}, times


def strided_at_chunk_shape(dev):
    """Phase 13(b): strided attention at the 2x chunk's attention shape
    through B1 and B2, against the plain forward and backward, with the
    times beside the clipped-causal mask's; returns the launches of one
    strided_attention forward and backward, and the times."""
    from vpt_tpu_torch.ops import strided_attention as sa
    from vpt_tpu_torch.ops import windowed_attention as wa

    B, H, t, T, d = 4, 16, 128, 256, 128
    q0, k0, v0, causal, _, _ = attention_inputs(dev, B, H, t, T - t, d, torch.float32, 31)
    dO0 = torch.randn(q0.shape, generator=torch.Generator(device=dev).manual_seed(32), device=dev)
    times, launches = {}, set()
    masks = [(f"stride {s} maxlen {m}", sa.strided_mask(t, T, s, m, dev)[None].expand(B, t, T).contiguous(), (s, m))
             for s, m in STRIDED_CASES] + [("clipped-causal", causal, None)]
    for label, mask, strided in masks:
        pairs = attended_pairs(mask, H)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dO = (x.to(dtype) for x in (q0, k0, v0, dO0))
            name = f"{label} {str(dtype)[6:]}"
            if strided is not None:
                check_b1_case(wa, q, k, v, mask, None, None, label)
                got = wa.windowed_attention_bwd(q, k, v, mask, None, None, dO, True)
                torch.cuda.synchronize()
                errs = b2_errors(got, wa.windowed_attention_bwd_plain(q, k, v, mask, None, None, dO, True), dtype)
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
                reset_launch_counts()
                out = sa.strided_attention(*leaves, *strided, use_muP_factor=True)
                grads = torch.autograd.grad(out, leaves, dO)
                torch.cuda.synchronize()
                launches.add(launch_counts())
                plain = wa.windowed_attention_fwd_plain(*leaves, mask, None, None, True)
                auto = b2_errors(grads, torch.autograd.grad(plain, leaves, dO), dtype)
                fwd_err = (out.float() - plain.float()).abs().max().item()
                log(f"B2 {name}: max_abs_err (tol) " + ", ".join(f"{n} {e:.3e} ({b:.2e})" for n, (e, b) in errs.items())
                    + f"; strided_attention with autograd against the plain forward's: output {fwd_err:.3e}, "
                    + ", ".join(f"{n} {e:.3e} ({b:.2e})" for n, (e, b) in auto.items()))
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                if not (all(e <= b for e, b in list(errs.values()) + list(auto.values())) and fwd_err <= tol):
                    raise AssertionError(f"strided attention through B1 and B2 disagrees with the plain version: "
                                         f"{errs} {auto} {fwd_err}")
            if strided is not None and strided != STRIDED_CASES[0]:
                continue  # timed: the first strided case and the clipped-causal mask
            times[name] = {
                "B1": dict(zip(TIME_KEYS, time_b1(q, k, v, mask, None, None, label=f"2x chunk, {label} mask",
                                                  pairs=pairs))),
                "B2": dict(zip(TIME_KEYS, time_b2(q, k, v, mask, None, None, dO, label=f"2x chunk, {label} mask",
                                                  pairs=pairs))),
                "attended_pairs": pairs}
    log(f"13(b) strided_attention launches (B1, B2) a forward and backward: {launches}; bounds over the attended "
        f"pairs: " + ", ".join(f"{label} {attended_pairs(m, H)}" for label, m, _ in masks))
    if launches != {(1, 1)}:
        raise AssertionError(f"strided_attention launched (B1, B2) {launches}, expected (1, 1)")
    return {"forward": 1, "backward": 1}, times


def variant_chunk_card_vs_cpu(gpu, cpu, dev, B=4, T=128):
    """A (B, T) chunked forward of a variant on the card against the CPU's
    recurrence and heads on the card's CNN output (the CNN itself is held
    against the CPU in the train step); the card's forward time."""
    from vpt_tpu_torch.models.policy import policy_initial_state

    cfg = gpu.cfg
    g = torch.Generator(device=dev).manual_seed(21)
    img = torch.randint(0, 256, (B, T) + tuple(cfg.img_shape), generator=g, device=dev, dtype=torch.uint8)
    first = torch.zeros((B, T), dtype=torch.bool, device=dev)
    first[:, 0] = True
    for i in range(B):
        first[i, (i + 1) * T // (B + 1)] = True
    with torch.inference_mode():
        ms = []
        for _ in range(2):  # the first call includes cuDNN's choice of algorithms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, state = gpu.policy(img, first, policy_initial_state(cfg, B, device=dev))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        x = gpu.policy.embed(img).cpu()
        y, state_c = cpu.policy.net.recurrent(x, first.cpu(), policy_initial_state(cfg, B))
        out_c = cpu.policy.heads_from_recurrent(y)
    errs = max_errors(policy_outputs(out), policy_outputs(out_c))
    if state is not None:
        errs["state"] = max(e for blk, blk_c in zip(state, state_c) for e in max_errors(blk, blk_c).values())
    log(f"13 {cfg.recurrence_type} ({B}x{T}, 2x, f32) chunked forward on the card against the CPU's recurrence and "
        f"heads: max_abs_err {errs} (tol {STEP_TOL}); the card's forward {ms[1]:.1f} ms (first call {ms[0]:.1f})")
    if not all(e <= STEP_TOL for e in errs.values()):
        raise AssertionError(f"{cfg.recurrence_type}: the chunked forward disagrees with the CPU's: {errs}")
    return ms[1]


@torch.inference_mode()
def variant_stepwise(policy, dev, B=4, T=128):
    """One step at a time against the (B, T) chunk on the card: the masked
    LSTM with resets anywhere, the plain one with resets at the chunk's
    start only (a reset inside its chunk is ignored there, honoured by a
    step)."""
    from vpt_tpu_torch.models.policy import policy_initial_state

    cfg = policy.cfg
    g = torch.Generator(device=dev).manual_seed(22)
    img = torch.randint(0, 256, (B, T) + tuple(cfg.img_shape), generator=g, device=dev, dtype=torch.uint8)
    first = torch.zeros((B, T), dtype=torch.bool, device=dev)
    first[:, 0] = True
    if cfg.recurrence_type == "multi_masked_lstm":
        for i in range(B):
            first[i, (i + 1) * T // (B + 1)] = True
    chunk, _ = policy(img, first, policy_initial_state(cfg, B, device=dev))
    state, steps = policy_initial_state(cfg, B, device=dev), []
    for i in range(T):
        out, state = policy(img[:, i:i + 1], first[:, i:i + 1], state)
        steps.append(policy_outputs(out))
    stepped = {k: torch.cat([s[k] for s in steps], dim=1) for k in steps[0]}
    errs = max_errors(stepped, policy_outputs(chunk))
    log(f"13 {cfg.recurrence_type} stepwise against chunkwise ({B}x{T}, f32, resets "
        f"{'anywhere' if cfg.recurrence_type == 'multi_masked_lstm' else 'at the chunk start'}): max_abs_err {errs} "
        f"(tol {STEP_TOL})")
    if not all(e <= STEP_TOL for e in errs.values()):
        raise AssertionError(f"{cfg.recurrence_type}: stepwise and chunkwise disagree: {errs}")


def serving_rollout(dev, frames, kwargs, label):
    """An agent of the 2x policy with `kwargs` serving API_STREAMS streams for
    API_STEPS steps, frames through the native pool: frames/s and the device
    step."""
    from vpt_tpu_torch.agent import MineRLAgent

    agent = MineRLAgent(device=dev, policy_kwargs=kwargs, batch_size=API_STREAMS, seed=0)
    _, t = rollout_run(agent, frames, API_STEPS, "native")
    log(f"13 serving {label}: {API_STREAMS} streams x {API_STEPS} steps, {t['frames_per_s']:.1f} frames/s, "
        f"{t['ms_a_step']:.2f} ms/step; alone: host resize {t['host_prep_ms']:.2f} ms, device step + D2H "
        f"{t['device_step_ms']:.2f} ms")
    del agent
    release_memory()
    return {k: t[k] for k in ("frames_per_s", "ms_a_step", "device_step_ms")}


def lstm_variants(dev):
    """Phase 13(c): the three LSTM recurrences at the 2x policy's widths."""
    from vpt_tpu_torch.models.transformer import LSTM_TYPES

    rng = np.random.default_rng(13)
    frames = [synthetic_obs(rng, API_STREAMS) for _ in range(4)]
    serving = {"transformer": serving_rollout(dev, frames, variant_kwargs(), "transformer (phase 4's policy)")}
    for rt in LSTM_TYPES:
        kwargs = variant_kwargs(recurrence_type=rt)
        gpu, cpu = bc_trainer_pair(dev, kwargs)
        variant_chunk_card_vs_cpu(gpu, cpu, dev)
        if rt != "multi_layer_bilstm":  # a reversed block sees the chunk's future: a step cannot
            variant_stepwise(gpu.policy, dev)
        train_card_vs_cpu(dev, label=f"{rt} train_step", pair=(gpu, cpu))
        del cpu
        launches, step_ms, peak_gb = train_steps(gpu, dev, B=4, T=128, steps=3, label=f"{rt} BC train")
        del gpu
        release_memory()
        serving[rt] = serving_rollout(dev, frames, kwargs, rt)
    return serving


def batch_norm_stats(policy):
    return {k: v.detach().clone() for k, v in policy.state_dict().items() if k.endswith((".norm.running_mean", ".norm.running_var"))}


def none_and_batch_norm(dev):
    """Phase 13(d), first: the 2x policy with recurrence_type "none" and with
    batch norm, a forward and a BC step on the card against the CPU at phase
    7(a)'s size; the batch-norm statistics, drawn away from (0, 1), stay bit
    for bit through the step on both sides."""
    from vpt_tpu_torch.models.policy import policy_initial_state

    for label, kwargs in (("none", variant_kwargs(recurrence_type="none")),
                          ("batch norm", variant_kwargs(init_norm_kwargs={"batch_norm": True}))):
        gpu, cpu = bc_trainer_pair(dev, kwargs)
        stats = batch_norm_stats(cpu.policy)
        g = torch.Generator().manual_seed(23)
        for k, v in stats.items():
            v.copy_(torch.rand(v.shape, generator=g) * 1.5 + 0.5 if k.endswith("var")
                    else 0.3 * torch.randn(v.shape, generator=g))
        for t in (gpu, cpu):
            t.policy.load_state_dict(stats, strict=False)
        if (label == "batch norm") != bool(stats):
            raise AssertionError(f"{label}: {len(stats)} batch-norm statistics")
        batch = bc_batch(torch.device("cpu"), 2, 4, gpu.cfg.img_shape[0], 24, firsts_at=(None, 2))
        with torch.inference_mode():
            out_g, state_g = gpu.policy(batch["frames"].to(dev), batch["firsts"].to(dev),
                                        policy_initial_state(gpu.cfg, 2, device=dev))
            out_c, state_c = cpu.policy(batch["frames"], batch["firsts"], policy_initial_state(cpu.cfg, 2))
        errs = max_errors(policy_outputs(out_g), policy_outputs(out_c))
        log(f"13(d) {label} forward (2x, B=2, T=4, f32) card against CPU: max_abs_err {errs} (tol {STEP_TOL}); "
            f"state {state_g if state_g is None else 'carried'}")
        if not all(e <= STEP_TOL for e in errs.values()) or (label == "none") != (state_g is None):
            raise AssertionError(f"{label}: the forward disagrees with the CPU's: {errs}")
        train_card_vs_cpu(dev, label=f"{label} train_step", pair=(gpu, cpu))
        moved = [k for t in (gpu, cpu) for k, v in batch_norm_stats(t.policy).items() if not torch.equal(v.cpu(), stats[k])]
        log(f"  {len(stats)} batch-norm statistics, {len(moved)} moved by the step on the card or the CPU")
        if moved:
            raise AssertionError(f"a train step moved batch-norm statistics: {moved[:4]}")
        del gpu, cpu
        release_memory()


@torch.no_grad()
def gaussian_dict_head(dev):
    """Phase 13(d), last: a DictActionHead of a 3-dimensional gaussian and a
    121-way categorical head on a 2048-wide (4, 128) latent, card against
    CPU: log-probabilities, entropy, KL, a deterministic sample."""
    from vpt_tpu_torch.models import heads
    from vpt_tpu_torch.models.layers import init_parameters

    specs = (heads.HeadSpec("cont", (3,), kind="gaussian"), heads.HeadSpec("camera", (1,), 121))
    head = init_parameters(heads.DictActionHead(2048, specs, temperature=2.0), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(25)
    for sub in (head.cont, head.camera):  # off the near-zero init: means and logits of order 1
        sub.linear_layer.weight.mul_(100.0)
    head.cont.log_std.copy_(0.3 * torch.randn(3, generator=g))
    card = copy.deepcopy(head).to(dev)
    latent, other = (torch.randn((4, 128, 2048), generator=g) for _ in range(2))
    pd_c, pd2_c = head(latent), head(other)
    pd_g, pd2_g = card(latent.to(dev)), card(other.to(dev))
    action = heads.dict_sample(pd_c, specs, generator=torch.Generator().manual_seed(26))
    action_g = {k: v.to(dev) for k, v in action.items()}
    values = {"logprob": (heads.dict_logprob(pd_g, action_g, specs), heads.dict_logprob(pd_c, action, specs)),
              "entropy": (heads.dict_entropy(pd_g, specs), heads.dict_entropy(pd_c, specs)),
              "kl": (heads.dict_kl(pd_g, pd2_g, specs), heads.dict_kl(pd_c, pd2_c, specs))}
    det_g, det_c = heads.dict_sample(pd_g, specs, deterministic=True), heads.dict_sample(pd_c, specs, deterministic=True)
    values["sample cont"] = (det_g["cont"], det_c["cont"])
    errs = {k: ((a.cpu() - b).abs().max().item(), HEAD_TOL * (1 + b.abs().max().item())) for k, (a, b) in values.items()}
    top2 = pd_c["camera"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > NEAR_TIE
    differ = int(((det_g["camera"].cpu() != det_c["camera"]) & clear).sum())
    log("13(d) DictActionHead (gaussian 3 + categorical 121, 2048 wide, (4, 128)) card against CPU: max_abs_err (tol) "
        + ", ".join(f"{k} {e:.3e} ({b:.2e})" for k, (e, b) in errs.items())
        + f"; deterministic categorical samples differing {differ} of {int(clear.sum())} without a near tie "
        f"({int((~clear).sum())} within {NEAR_TIE} not compared)")
    if not all(e <= b for e, b in errs.values()) or differ:
        raise AssertionError(f"the dict head's functions disagree between card and CPU: {errs}, {differ}")


def check_variants(dev):
    """Phase 13: the reference API and the model variants at the 2x policy's
    widths; returns B1's launches and times of (a) and (b), B2's of (b)."""
    t0 = time.perf_counter()
    api_launches, t1_times = api_at_full_width(dev)
    log(f"[13(a) done in {time.perf_counter() - t0:.1f} s]")
    strided_launches, strided_times = strided_at_chunk_shape(dev)
    release_memory()
    log(f"[13(b) done at {time.perf_counter() - t0:.1f} s]")
    serving = lstm_variants(dev)
    log("13(c) serving at 8 streams, native resize: " + ", ".join(
        f"{k} {v['frames_per_s']:.1f} frames/s (device step {v['device_step_ms']:.2f} ms)" for k, v in serving.items()))
    log(f"[13(c) done at {time.perf_counter() - t0:.1f} s]")
    none_and_batch_norm(dev)
    gaussian_dict_head(dev)
    log(f"[13(d) done at {time.perf_counter() - t0:.1f} s]")
    trainer = ppo_card_vs_cpu(dev, variant_kwargs(recurrence_type="multi_masked_lstm"), label="2x multi_masked_lstm")
    del trainer
    release_memory()
    log(f"[13(e) done at {time.perf_counter() - t0:.1f} s]")
    b1 = {"api_launches": api_launches, "strided_launches": {"forward": strided_launches["forward"]},
          "t1_shape": t1_times, "strided_shape": {k: v["B1"] for k, v in strided_times.items()}}
    b2 = {"strided_launches": {"backward": strided_launches["backward"]},
          "strided_shape": {k: v["B2"] for k, v in strided_times.items()}}
    return b1, b2


# ------------------------------------------------------------------- phase 14

DIST_BC_B, DIST_BC_STEPS = 4, 3  # (a), (b): 2x BC steps at T=128
DIST_IDM_B, DIST_IDM_STEPS = 2, 2  # (c): 4x IDM windows of IDM_WINDOW frames
DIST_AGENT_STREAMS, DIST_AGENT_STEPS = 8, 16  # (e)
DIST_WRAP_RTOL = 1e-6  # (b) where a DTensor path reorders a reduction: loss relative, parameters of their max-abs


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_group(dev):
    """One rank, as torchrun would start it: RANK=0, WORLD_SIZE=1,
    LOCAL_RANK=0 and a free MASTER_PORT, through maybe_initialize_distributed,
    which must pick NCCL for the card (gloo for the CPU); returns the NCCL
    version (None on the CPU)."""
    import torch.distributed as dist

    from vpt_tpu_torch.parallel import mesh as pm

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    if not pm.maybe_initialize_distributed(dev):
        raise AssertionError("maybe_initialize_distributed started no group from torchrun's environment")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise AssertionError(f"the group's backend is {dist.get_backend()}, not {want}")
    return ".".join(map(str, torch.cuda.nccl.version())) if dev.type == "cuda" else None


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_trainer_steps(trainer, batches, dev, carried):
    """The steps of one wrapper: losses, grad norms, whole weights after (on
    the host), ms a step from the second, peak memory, and B1's and B2's
    launches in all."""
    from vpt_tpu_torch.parallel.mesh import full_state_dict

    state = trainer.initial_state(len(batches[0]["mask"])) if carried else None
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, norms, times = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        if carried:
            state, loss, norm = trainer.train_step(batch, state)
        else:
            loss, norm = trainer.train_step(batch)
        losses.append(loss.item())
        norms.append(float(norm))
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")
    return {"loss": losses, "grad_norm": norms, "weights": full_state_dict(trainer.policy),
            "ms": 1e3 * sum(times[1:]) / max(len(times) - 1, 1), "peak_gb": peak, "launches": launches}


def wrapped_gap(got, want):
    """(bit for bit, loss relative gap, largest parameter gap over that
    parameter's max-abs) of two runs' steps."""
    exact = got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"] and not differing(
        got["weights"], want["weights"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    param_gap = max(((got["weights"][k].float() - v.float()).abs().max() / v.float().abs().max().clamp_min(1e-30)).item()
                    for k, v in want["weights"].items() if v.is_floating_point())
    return exact, loss_gap, param_gap


def dist_report(label, run, plain, n_blocks, steps):
    """`plain`: (what, ms a step) of the unwrapped step it stands beside."""
    log(f"  {label}: losses {[round(x, 6) for x in run['loss']]}; {run['ms']:.1f} ms/step ({plain[0]} "
        f"{plain[1]:.1f} ms), peak {run['peak_gb']:.2f} GB; launches B1 {run['launches'][0]}, "
        f"B2 {run['launches'][1]}")
    if run["launches"] != (n_blocks * steps, n_blocks * steps):
        raise AssertionError(f"{label}: B1 and B2 launched {run['launches']} times in {steps} steps, "
                             f"expected {n_blocks * steps} each")


def dist_bc(dev, mesh, plain_ms):
    """14(a) DDP on a dp=1 mesh against the meshless trainer, bit for bit;
    (b) FSDP2 on the 1-rank fsdp axis and the TP plan on the 1-rank tp axis,
    applied by hand (the trainer leaves parameters whole at size 1)."""
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.parallel.fsdp import apply_fsdp
    from vpt_tpu_torch.parallel.tp import apply_tp
    from vpt_tpu_torch.training.bc import BCTrainer, make_optimizer

    def trainer(**kw):
        t = BCTrainer(FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, seed=0, device=dev, **kw)
        t.init()
        return t

    T = 128
    plain_t = trainer()
    n_blocks = plain_t.cfg.n_recurrence_layers
    batches = [bc_batch(dev, DIST_BC_B, T, plain_t.cfg.img_shape[0], 1400 + s,
                        firsts_at=[0 if s == 0 else (13 * i + 29 * s) % T if (i + s) % 2 else None
                                   for i in range(DIST_BC_B)],
                        masked_tail=(DIST_BC_B - 1, T - 24) if s == DIST_BC_STEPS - 1 else None)
               for s in range(DIST_BC_STEPS)]
    runs = {"meshless": run_trainer_steps(plain_t, batches, dev, True)}
    del plain_t
    release_memory()
    ddp = trainer(mesh=mesh)
    if type(ddp.model._call).__name__ != "DistributedDataParallel":
        raise AssertionError("the dp=1 trainer is not under DDP")
    runs["DDP dp=1"] = run_trainer_steps(ddp, batches, dev, True)
    del ddp
    release_memory()
    for label, wrap in (("FSDP2 fsdp=1", lambda p: apply_fsdp(p, mesh)), ("TP tp=1", lambda p: apply_tp(p, mesh["tp"]))):
        t = trainer()
        wrap(t.policy)
        if not any(isinstance(p, torch.distributed.tensor.DTensor) for p in t.policy.parameters()):
            raise AssertionError(f"{label}: no parameter is a DTensor")
        t.optimizer = make_optimizer(t.trainable_parameters(), t.hp)
        runs[label] = run_trainer_steps(t, batches, dev, True)
        del t
        release_memory()
    for label, run in runs.items():
        dist_report(f"14(a/b) BC {label} (2x, {DIST_BC_B}x{T}, f32)", run, ("phase 7(b)'s plain step at B=4", plain_ms),
                    n_blocks, DIST_BC_STEPS)
    for label in ("DDP dp=1", "FSDP2 fsdp=1", "TP tp=1"):
        exact, loss_gap, param_gap = wrapped_gap(runs[label], runs["meshless"])
        norm_gap = max(abs(a - b) / b for a, b in zip(runs[label]["grad_norm"], runs["meshless"]["grad_norm"]))
        log(f"  {label} against the meshless trainer: bit for bit {exact}; loss gap {loss_gap:.3e}, grad norm gap "
            f"{norm_gap:.3e}, parameter gap {param_gap:.3e} of max-abs")
        if label == "DDP dp=1" and not exact:
            raise AssertionError("DDP at dp=1 differs from the meshless trainer")
        if not (exact or (loss_gap <= DIST_WRAP_RTOL and param_gap <= DIST_WRAP_RTOL)):
            raise AssertionError(f"{label} differs from the meshless trainer beyond {DIST_WRAP_RTOL}")
    return runs["DDP dp=1"]["launches"]


def dist_idm(dev, mesh):
    """14(c): the 4x IDM, 2 steps at 2 windows of 128 frames, on a dp=1
    mesh against the meshless trainer's, bit for bit, after a throwaway
    warm-up run of the meshless steps from the same state (cuDNN's first
    call of a convolution differs from the later ones: --probe-first-call)."""
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.training.bc import make_optimizer
    from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer

    def trainer(**kw):
        t = IDMTrainer(IDM_4X_KWARGS, {}, seed=0, device=dev,
                       hp=IDMHyperparams(batch_size=DIST_IDM_B, window=IDM_WINDOW), **kw)
        t.init()
        return t

    batches = [idm_batch(DIST_IDM_B, IDM_WINDOW, 1450 + s, masked_tail=(1, IDM_WINDOW - 20) if s else None)
               for s in range(DIST_IDM_STEPS)]
    t = trainer()
    n_blocks = t.cfg.n_recurrence_layers
    start = {k: v.detach().clone() for k, v in t.policy.state_dict().items()}
    warm_up = run_trainer_steps(t, batches, dev, False)  # thrown away
    t.policy.load_state_dict(start)
    t.optimizer = make_optimizer(t.policy.parameters(), t.hp)
    plain = run_trainer_steps(t, batches, dev, False)
    log(f"  the meshless IDM steps after the warm-up run equal to it: bit for bit {wrapped_gap(plain, warm_up)[0]}")
    del t, start
    release_memory()
    t = trainer(mesh=mesh)
    meshed = run_trainer_steps(t, batches, dev, False)
    del t
    release_memory()
    dist_report(f"14(c) IDM DDP dp=1 (4x, {DIST_IDM_B}x{IDM_WINDOW}, f32)", meshed, ("the meshless step", plain["ms"]),
                n_blocks, DIST_IDM_STEPS)
    exact, loss_gap, param_gap = wrapped_gap(meshed, plain)
    log(f"  against the meshless IDM trainer ({plain['ms']:.1f} ms/step): bit for bit {exact}; loss gap "
        f"{loss_gap:.3e}, parameter gap {param_gap:.3e}")
    if not exact:
        raise AssertionError("the IDM under DDP at dp=1 differs from the meshless trainer")
    return meshed["launches"]


def dist_ppo(dev, mesh):
    """14(d): one PPO update at 9(a)'s size (2 streams x 16 steps, one epoch
    of one minibatch) on a dp=1 mesh against the meshless update of the same
    trajectory, bit for bit."""
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.training.rl import PPOHyperparams, PPOTrainer

    def trainer(**kw):
        hp = PPOHyperparams(rollout_len=PPO_CHECK_STEPS, n_epochs=1, n_minibatches=1)
        t = PPOTrainer(FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS, hp=hp, seed=0, device=dev, **kw)
        t.init()
        return t

    plain = trainer()
    n_blocks = plain.cfg.n_recurrence_layers
    traj, _, _ = plain.collect([MockMinecraftEnv(seed=i, done_prob=0.1) for i in range(PPO_CHECK_STREAMS)],
                               reward_fn=attack_reward)
    out = {}
    for label, t in (("meshless", plain), ("DDP dp=1", None)):
        t = t or trainer(mesh=mesh)
        sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = t.update(traj)
        sync(dev)
        out[label] = {"metrics": metrics, "weights": {k: v.detach().cpu() for k, v in t.policy.state_dict().items()},
                      "s": time.perf_counter() - t0, "launches": launch_counts()}
        del t
        release_memory()
    got, want = out["DDP dp=1"], out["meshless"]
    exact = got["metrics"] == want["metrics"] and not differing(got["weights"], want["weights"])
    log(f"14(d) PPO update DDP dp=1 (2x, {PPO_CHECK_STREAMS}x{PPO_CHECK_STEPS}, f32): loss "
        f"{got['metrics']['loss']:.6f}, {got['s'] * 1e3:.1f} ms against the meshless {want['s'] * 1e3:.1f} ms; "
        f"bit for bit {exact}; launches B1 {got['launches'][0]}, B2 {got['launches'][1]}")
    # the anchor's forward over the window and the one minibatch step
    if got["launches"] != (2 * n_blocks, n_blocks):
        raise AssertionError(f"the PPO update launched B1 and B2 {got['launches']} times, "
                             f"expected {2 * n_blocks} and {n_blocks}")
    if not exact:
        raise AssertionError("the PPO update under DDP at dp=1 differs from the meshless update")
    return got["launches"]


def dist_agent(dev, mesh):
    """14(e): a meshed MineRLAgent (dp=1) against the meshless agent, 8
    streams x 16 deterministic steps on the linear cache (B1 once per block
    and step): the same actions."""
    from vpt_tpu_torch.agent.agent import MineRLAgent

    rng = np.random.default_rng(14)
    frames = [synthetic_obs(rng, DIST_AGENT_STREAMS) for _ in range(DIST_AGENT_STEPS)]
    actions = {}
    for label, kw in (("meshless", {}), ("dp=1", {"mesh": mesh})):
        agent = MineRLAgent(device=dev, batch_size=DIST_AGENT_STREAMS, seed=0, ring_cache=False, **kw)
        reset_launch_counts()
        actions[label] = [agent.get_action(obs, first=np.full(DIST_AGENT_STREAMS, t == 0), stochastic=False)
                          for t, obs in enumerate(frames)]
        actions[label + " launches"] = launch_counts()
        n_blocks = agent.cfg.n_recurrence_layers
        del agent
        release_memory()
    same = all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for sa, sb in zip(actions["dp=1"], actions["meshless"])
               for a, b in zip(sa, sb) for k in a)
    log(f"14(e) meshed MineRLAgent (2x, {DIST_AGENT_STREAMS} streams x {DIST_AGENT_STEPS} steps, linear cache): "
        f"actions equal to the meshless agent's {same}; launches B1 {actions['dp=1 launches'][0]}")
    if not same:
        raise AssertionError("the meshed agent's actions differ from the meshless agent's")
    if actions["dp=1 launches"][0] != n_blocks * DIST_AGENT_STEPS:
        raise AssertionError(f"the meshed agent launched B1 {actions['dp=1 launches'][0]} times")
    return actions["dp=1 launches"][0] // DIST_AGENT_STEPS


def check_distribution(dev, plain_ms):
    """Phase 14: the process group at world size 1 (NCCL on the card), each
    wrapper's steps against the meshless ones, with torch's deterministic
    algorithms on; returns B1's and B2's launches of each wrapped step."""
    import torch.distributed as dist

    from vpt_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    version = start_group(dev)
    try:
        mesh = pm.make_mesh(n_dp=1)
        log(f"phase 14: process group {dist.get_backend()} (NCCL {version}), world size {dist.get_world_size()}, "
            f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on {mesh.device_type}")
        with deterministic_algorithms():
            bc = dist_bc(dev, mesh, plain_ms)
            idm = dist_idm(dev, mesh)
            ppo = dist_ppo(dev, mesh)
            agent = dist_agent(dev, mesh)
    finally:
        dist.destroy_process_group()
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    b1 = {"bc_step": bc[0] // DIST_BC_STEPS, "idm_step": idm[0] // DIST_IDM_STEPS, "ppo_update": ppo[0],
          "agent_step": agent}
    b2 = {"bc_step": bc[1] // DIST_BC_STEPS, "idm_step": idm[1] // DIST_IDM_STEPS, "ppo_update": ppo[1]}
    return {"dist_launches": b1}, {"dist_launches": b2}


# ------------------------------------------------------------------- phase 15


def entry_files(dev, tmp):
    """The files the entry points read: a 2x .model and the .weights of the
    random inits of seeds 0 and 1 (MineRLAgent's draws on `dev`), the 4x
    IDM's .model and the .weights of seed 0's (IDMAgent's, phase 8(b)'s
    weights)."""
    from vpt_tpu_torch.agent import IDMAgent, MineRLAgent
    from vpt_tpu_torch.checkpoint import save_model_parameters, save_weights
    from vpt_tpu_torch.config import FOUNDATION_PI_HEAD_KWARGS, FOUNDATION_POLICY_KWARGS, IDM_4X_KWARGS

    paths = {k: os.path.join(tmp, k) for k in ("2x.model", "2x_seed0.weights", "2x_seed1.weights",
                                                "4x_idm.model", "4x_idm.weights")}
    save_model_parameters(paths["2x.model"], FOUNDATION_POLICY_KWARGS, FOUNDATION_PI_HEAD_KWARGS)
    for seed in (0, 1):
        agent = MineRLAgent(device=dev, seed=seed)
        save_weights(paths[f"2x_seed{seed}.weights"], agent.policy)
        del agent
    save_model_parameters(paths["4x_idm.model"], IDM_4X_KWARGS, {})
    agent = IDMAgent(IDM_4X_KWARGS, {}, device=dev, seed=0)
    save_weights(paths["4x_idm.weights"], agent.policy)
    return paths


def finite_numbers(tree, where=""):
    """Every number of a JSON-like tree is finite (None is no number)."""
    if isinstance(tree, dict):
        return all(finite_numbers(v, f"{where}/{k}") for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return all(finite_numbers(v, where) for v in tree)
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        if not np.isfinite(tree):
            raise AssertionError(f"{where} is {tree}")
    return True


def entry_run_agent(paths, device_args):
    """15(a)."""
    from vpt_tpu_torch import run_agent

    reset_launch_counts()
    stats = run_agent.main(["--model", paths["2x.model"], "--weights", paths["2x_seed0.weights"], "--mock-env",
                            "--streams", str(ENTRY_STREAMS), "--steps", str(ENTRY_STEPS)] + device_args)
    lat = stats["latency"]
    log(f"15(a) run_agent --mock-env --streams {ENTRY_STREAMS} --steps {ENTRY_STEPS} (2x, bf16): "
        f"{stats['groups']} groups, {stats['frames_per_sec']:.1f} frames/s, a rotation p50 {lat['p50_ms']:.2f} ms, "
        f"p99 {lat['p99_ms']:.2f} ms; B1 launches {launch_counts()[0]}")
    if stats["groups"] != 4 or stats["frames"] != ENTRY_STREAMS * ENTRY_STEPS:
        raise AssertionError(f"run_agent took {stats['groups']} groups and {stats['frames']} frames, expected 4 "
                             f"groups of {ENTRY_STREAMS // 4} and {ENTRY_STREAMS * ENTRY_STEPS} frames")
    finite_numbers(stats, "run_agent")
    return stats


def entry_eval_agent(paths, device_args, tmp):
    """15(b)."""
    from vpt_tpu_torch.tools import eval_agent

    reports = []
    for seed in (0, 1):
        out = os.path.join(tmp, f"eval_seed{seed}.json")
        t0 = time.perf_counter()
        reports.append((out, eval_agent.main(
            ["--mock-env", "--model", paths["2x.model"], "--weights", paths["2x_seed0.weights"], "--streams",
             str(ENTRY_STREAMS), "--episodes", str(ENTRY_EPISODES), "--done-prob", str(ENTRY_DONE_PROB), "--seed",
             str(seed), "--out", out] + device_args), time.perf_counter() - t0))
    compared = eval_agent.main(["--compare", reports[0][0], reports[1][0]] + device_args)
    for (_, report, seconds), seed in zip(reports, (0, 1)):
        finite_numbers(report, f"eval_agent seed {seed}")
        if report["episodes"] != ENTRY_EPISODES:
            raise AssertionError(f"eval_agent reported {report['episodes']} episodes, not {ENTRY_EPISODES}")
        log(f"15(b) eval_agent seed {seed}: {report['episodes']} episodes, {report['steps']} steps in {seconds:.2f} s, "
            f"mean length {report['mean_length']}, mean value {report['mean_vpred']:.4f}, step p99 "
            f"{report['latency']['p99_ms']:.2f} ms")
    finite_numbers(compared, "eval_agent --compare")
    log(f"15(b) --compare: {json.dumps(compared)}")


def entry_average_weights(paths, device_args, tmp):
    """15(c)."""
    from vpt_tpu_torch.checkpoint import load_weights
    from vpt_tpu_torch.checkpoint.averaging import average_state_dicts
    from vpt_tpu_torch.tools import average_weights

    out = os.path.join(tmp, "2x_avg.weights")
    t0 = time.perf_counter()
    average_weights.main([out, paths["2x_seed0.weights"], paths["2x_seed1.weights"]] + device_args)
    seconds = time.perf_counter() - t0
    got = load_weights(out)
    want = average_state_dicts([load_weights(paths["2x_seed0.weights"]), load_weights(paths["2x_seed1.weights"])])
    bad = [k for k in want if not (got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]))]
    log(f"15(c) average_weights of two 2x .weights ({len(want)} tensors) in {seconds:.2f} s: "
        f"{len(want) - len(bad)} equal to the CPU's mean")
    if bad or got.keys() != want.keys():
        raise AssertionError(f"average_weights differs from the CPU's mean in {bad[:5]}")


def entry_labeling(paths, dev, frames, labels_8b):
    """15(d): label_frames against 8(b)'s labels (a StreamingIDMLabeler run
    of its own where 8(b) did not run), the print mode's batch function
    against predict_actions; returns B1's launches a forward of each."""
    from vpt_tpu_torch.agent import IDMAgent, StreamingIDMLabeler, action_jsonl_row
    from vpt_tpu_torch.checkpoint import load_model_parameters
    from vpt_tpu_torch.ops.resize import resize_image
    from vpt_tpu_torch.run_inverse_dynamics_model import predict_batches
    from vpt_tpu_torch.tools.label_videos import label_frames

    agent = IDMAgent(*load_model_parameters(paths["4x_idm.model"]), device=dev)
    agent.load_weights(paths["4x_idm.weights"])
    n_blocks, n = agent.cfg.n_recurrence_layers, len(frames)
    size = (agent.cfg.img_shape[1], agent.cfg.img_shape[0])
    if labels_8b is None:
        labeler = StreamingIDMLabeler(agent, window=IDM_WINDOW, stride=IDM_STRIDE, window_batch=IDM_WINDOW_BATCH)
        labels_8b = [lab for f in frames for lab in labeler.feed(f)] + labeler.finish()
    want = [{"frame": i, "action": action_jsonl_row(a)} for i, a in labels_8b]

    def resized_batches():
        for start in range(0, n, 64):
            yield np.stack([resize_image(f, size) for f in frames[start:start + 64]])

    out = os.path.join(os.path.dirname(paths["4x_idm.model"]), "labels.jsonl")
    calls = counted_dispatches(agent)
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    got_n = label_frames(agent, resized_batches(), out, IDM_WINDOW, IDM_STRIDE, IDM_WINDOW_BATCH)
    seconds = time.perf_counter() - t0
    launches, forwards = launch_counts()[0], len(calls)
    rows = [json.loads(line) for line in open(out)]
    if got_n != n or [r["frame"] for r in rows] != list(range(n)):
        raise AssertionError("label_frames did not label every frame once, in order")
    wrong = [r["frame"] for r, w in zip(rows, want) if r != w]
    if wrong or len(rows) != len(want):
        raise AssertionError(f"{len(wrong)} labels of label_frames differ from phase 8(b)'s: {wrong[:8]}")
    if launches != n_blocks * forwards:
        raise AssertionError(f"label_frames launched B1 {launches} times in {forwards} forwards")
    log(f"15(d) label_frames (4x IDM, f32, window {IDM_WINDOW}, stride {IDM_STRIDE}, {IDM_WINDOW_BATCH} windows a "
        f"forward): {n} frames in {seconds:.2f} s ({n / seconds:.1f} frames/s, the host resize included), "
        f"{forwards} forwards, B1 launches {launches}; every label 8(b)'s")

    batches = [frames[s:s + PRINT_MODE_FRAMES] for s in range(0, n, PRINT_MODE_FRAMES)]
    agent.reset()
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    printed = list(predict_batches(agent, iter(batches)))
    print_s = time.perf_counter() - t0
    print_launches = launch_counts()[0]
    agent.reset()
    direct = []
    for batch in batches:
        pred = agent.predict_actions(batch)
        direct.extend(action_jsonl_row({k: v[0, i] for k, v in pred.items()}) for i in range(len(batch)))
    if [i for i, _ in printed] != list(range(n)):
        raise AssertionError("the print mode did not label every frame once, in order")
    wrong = [i for (i, r), d in zip(printed, direct) if r != d]
    if wrong:
        raise AssertionError(f"{len(wrong)} print-mode labels differ from predict_actions': {wrong[:8]}")
    if print_launches != n_blocks * len(batches):
        raise AssertionError(f"the print mode launched B1 {print_launches} times in {len(batches)} batches")
    log(f"15(d) print mode (predict_batches, {PRINT_MODE_FRAMES} frames a batch, the state carried): {n} frames in "
        f"{print_s:.2f} s ({n / print_s:.1f} frames/s), B1 launches {print_launches}; every label predict_actions'")
    return launches // max(forwards, 1), print_launches // len(batches)


def entry_benches(dev, device_args, plain_ms):
    """15(e): the two breakdown tools; returns B1's and B2's launches a BC
    step of the breakdown's train-step chain."""
    from vpt_tpu_torch.config import FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.tools import bench_bc_breakdown, bench_breakdown

    bc = bench_bc_breakdown.main(["--width", str(BENCH_WIDTH), "--batch", str(BENCH_BC_B), "--chunk", str(BENCH_BC_T),
                                  "--iters", str(BENCH_ITERS), "--compute-dtype", "float32", "--cnn-detail"]
                                 + device_args)
    rollout = bench_breakdown.main(["--width", str(BENCH_WIDTH), "--streams", str(BENCH_STREAMS), "--iters", "20"]
                                   + device_args)
    step = bc["chains"]["step_ms"]
    n_blocks = FOUNDATION_POLICY_KWARGS["n_recurrence_layers"]
    gap = bc["step_ms"] / plain_ms - 1
    log(f"15(e) bench_bc_breakdown (2x, B={BENCH_BC_B}, T={BENCH_BC_T}, f32): step {bc['step_ms']:.1f} ms against "
        f"7(b)'s {plain_ms:.1f} ({100 * gap:+.1f}%), forward {bc['fwd_ms']:.1f}, forward and backward "
        f"{bc['grad_ms']:.1f}, optimizer {bc['optimizer_ms']:.1f}; B1 {step['B1']} and B2 {step['B2']} in "
        f"{step['calls']} steps; seconds " + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in bc["chains"].items()))
    log(f"15(e) bench_breakdown (2x, {BENCH_STREAMS} streams, t=1, bf16): CNN {rollout['cnn_ms']:.3f} ms, blocks "
        f"{rollout['transformer_ms']:.3f}, tail {rollout['tail_ms']:.3f}; the CNN at "
        f"{rollout['cnn_achieved_tflops']:.2f} TFLOP/s")
    if (step["B1"], step["B2"]) != (n_blocks * step["calls"], n_blocks * step["calls"]):
        raise AssertionError(f"the breakdown's {step['calls']} BC steps launched B1 {step['B1']} and B2 "
                             f"{step['B2']} times, expected {n_blocks} each a step")
    if plain_ms == plain_ms and not abs(gap) <= BENCH_STEP_RTOL:
        raise AssertionError(f"the breakdown's BC step takes {bc['step_ms']:.1f} ms, 7(b)'s {plain_ms:.1f}: "
                             f"more than {BENCH_STEP_RTOL:.0%} apart")
    return step["B1"] // step["calls"], step["B2"] // step["calls"]


def check_entry_points(dev, plain_ms, float_labeling=None):
    """Phase 15: the entry points through their main(argv) on `dev`'s
    default (no --device on CUDA); returns B1's and B2's launches of (d)'s
    and (e)'s paths.  `float_labeling` is phase 8's (frames and labels), or
    None: then the frames are drawn as 8(b) draws them and labeled here."""
    t0 = time.perf_counter()
    device_args = [] if dev.type == "cuda" else ["--device", str(dev)]
    if float_labeling is None:
        frames = np.random.default_rng(0).integers(0, 256, (IDM_LABEL_FRAMES, 360, 640, 3), dtype=np.uint8)
        labels = None
    else:
        frames, labels = float_labeling["frames"], float_labeling["labels"]
    seconds = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        release_memory()
        seconds[name] = time.perf_counter() - start
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        paths = timed("files", entry_files, dev, tmp)
        timed("a", entry_run_agent, paths, device_args)
        timed("b", entry_eval_agent, paths, device_args, tmp)
        timed("c", entry_average_weights, paths, device_args, tmp)
        per_forward, per_batch = timed("d", entry_labeling, paths, dev, frames, labels)
    b1_step, b2_step = timed("e", entry_benches, dev, device_args, plain_ms)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    return ({"entry_point_launches": {"label_frames_forward": per_forward, "print_mode_batch": per_batch,
                                      "bench_bc_step": b1_step}},
            {"entry_point_launches": {"bench_bc_step": b2_step}})


def probe_first_call(dev):
    """--probe-first-call: the 4x IDM's training step taken three times
    from one state (weights and a fresh Adam) under deterministic
    algorithms, with cuDNN (B=2), without it (B=1) and with it again (B=1,
    a shape new to cuDNN): which gradients differ between the first call
    and the later ones, and whether the gradient arriving at the first
    Impala convolution's output does.  Returns the findings as a dict."""
    from vpt_tpu_torch.config import IDM_4X_KWARGS
    from vpt_tpu_torch.training.bc import make_optimizer
    from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer

    def grad_gaps(a, b):
        return {k: (a[k] - b[k]).abs().max().item() for k in a if not torch.equal(a[k], b[k])}

    found = {}
    with deterministic_algorithms():
        for label, use_cudnn, batch_size in (("cuDNN", True, 2), ("no cuDNN", False, 1), ("cuDNN", True, 1)):
            torch.backends.cudnn.enabled = use_cudnn
            try:
                t = IDMTrainer(IDM_4X_KWARGS, {}, seed=0, device=dev,
                               hp=IDMHyperparams(batch_size=batch_size, window=IDM_WINDOW))
                t.init()
                seen = []
                hook = t.policy.net.img_process.cnn.stacks[0].firstconv.register_full_backward_hook(
                    lambda m, gin, gout: seen.append(gout[0].detach().clone()))
                batch = idm_batch(batch_size, IDM_WINDOW, 1450)
                start = {k: v.detach().clone() for k, v in t.policy.state_dict().items()}
                calls = []
                for _ in range(3):
                    t.policy.load_state_dict(start)
                    t.optimizer = make_optimizer(t.policy.parameters(), t.hp)
                    loss, _ = t.train_step(batch)
                    calls.append({"loss": loss.item(), "dY": seen[-1],
                                  "grads": {n: p.grad.detach().clone() for n, p in t.policy.named_parameters()
                                            if p.grad is not None}})
                hook.remove()
            finally:
                torch.backends.cudnn.enabled = True
            for a, b in ((0, 1), (1, 2)):
                key = f"{label}, B={batch_size}: call {a + 1} against call {b + 1}"
                found[key] = {"loss equal": calls[a]["loss"] == calls[b]["loss"],
                              "first conv's output gradient equal": torch.equal(calls[a]["dY"], calls[b]["dY"]),
                              "gradients differing (max abs gap)": grad_gaps(calls[a]["grads"], calls[b]["grads"])}
                log(f"  {key}: {found[key]}")
            del t, calls, seen
            release_memory()
    return found


# --time-kernels' shapes besides the 2x chunk: (kernel, label, B, H, t, d, mask), all T = t + 128 <= 512;
# the 3x chunk is the 3x policy's BC step at 8 streams (d = 192)
TIMED_SHAPES = (("B1", "IDM window", IDM_WINDOW_BATCH, 32, IDM_WINDOW, 128, False),
                ("B2", "IDM window", IDM_TRAIN_B, 32, IDM_WINDOW, 128, False),
                ("B1", "PPO minibatch", PPO_STREAMS // PPO_MINIBATCHES, 16, PPO_STEPS, 128, True),
                ("B2", "PPO minibatch", PPO_STREAMS // PPO_MINIBATCHES, 16, PPO_STEPS, 128, True),
                ("B1", "3x chunk", 8, 16, 128, 192, True),
                ("B2", "3x chunk", 8, 16, 128, 192, True))


# kernel C1 at the main path's f32 3x3 convolutions, at the cells' frames a
# forward: the IDM's 8 windows of 128 frames, the 2x BC batch of 4 x 128 and a
# 3x BC frame chunk (8 x 128 in 2 chunks): (label, N, C_in, C_out, H = W)
C1_SHAPES = (("IDM 128->256 at 128x128", 1024, 128, 256, 128), ("IDM 256->256 at 64x64", 1024, 256, 256, 64),
             ("IDM 256->512 at 64x64", 1024, 256, 512, 64), ("IDM 512->512 at 32x32", 1024, 512, 512, 32),
             ("IDM 512->512 at 16x16", 1024, 512, 512, 16), ("2x 128->128 at 64x64", 512, 128, 128, 64),
             ("2x 128->256 at 64x64", 512, 128, 256, 64), ("2x 256->256 at 32x32", 512, 256, 256, 32),
             ("2x 256->256 at 16x16", 512, 256, 256, 16), ("3x 192->192 at 64x64", 512, 192, 192, 64),
             ("3x 192->384 at 64x64", 512, 192, 384, 64), ("3x 384->384 at 32x32", 512, 384, 384, 32),
             ("3x 384->384 at 16x16", 512, 384, 384, 16))
C1_TIME_ITERS = 5  # calls a timing: the IDM's first conv takes ~0.1 s on C1 and ~0.2 s on cuDNN


def conv_inputs(dev, n, c, k, hw, seed):
    """A conv layer's input as the CNN gives it (a ReLU's or a norm's
    output; here the ReLU of normal draws) and fan-in-scaled weights."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn((n, c, hw, hw), generator=g, device=dev))
    w = torch.randn((k, c, 3, 3), generator=g, device=dev) / (3 * c ** 0.5)
    return x, w


def c1_work(x, w):
    """C1's least work: bytes (x and w read once, y written once) and the
    products' FLOPs, 2·N·C_out·C_in·9·H·W."""
    from vpt_tpu_torch.ops import conv

    n, _, h, width = x.shape
    nbytes = (x.numel() + w.numel() + n * w.shape[0] * h * width) * 4
    return nbytes, conv.conv_flops(x.shape, w.shape)


def time_c1(x, w, label):
    """C1's time beside its plain version's (F.conv2d, then ReLU), cuDNN's
    f32 fprop alone (TF32 off, as the port runs f32) and its bound."""
    import torch.nn.functional as F

    from vpt_tpu_torch.ops import conv

    ms, alone = cuda_time_ms(lambda: conv.conv3x3_fwd(x, w), iters=C1_TIME_ITERS)
    if not alone:
        raise AssertionError("the spin ended before C1's launches were queued: no device-only time")
    plain_ms, plain_alone = cuda_time_ms(lambda: conv.conv3x3_fwd_plain(x, w), iters=C1_TIME_ITERS)
    library_ms, library_alone = cuda_time_ms(lambda: F.conv2d(x, w, padding=1), iters=C1_TIME_ITERS)
    nbytes, flops = c1_work(x, w)
    bound_ms, bound_by = bound(nbytes, flops, 0, torch.float32)
    log(f"C1 {label} (N={x.shape[0]}): {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms"
        f"{timed_note(plain_alone)}, cuDNN {library_ms:.3f} ms{timed_note(library_alone)} ({ms / library_ms:.3f}x); "
        f"bound {bound_ms:.3f} ms by {bound_by} ({nbytes / 1e9:.2f} GB, {flops / 1e12:.2f} TFLOP)")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def check_c1(dev):
    """Phase 17: C1 at C1_SHAPES on C1_CHECK_N frames, with a bias and the
    ReLU, against its plain version and against float64, once a call; then
    timed at the cells' frames.  Returns C1's entry of the kernels line."""
    from vpt_tpu_torch.ops import conv

    checked, worst = {}, 0.0
    for i, (label, _, c, k, hw) in enumerate(C1_SHAPES):
        x, w = conv_inputs(dev, C1_CHECK_N, c, k, hw, 17 + i)
        b = 0.1 * torch.randn((w.shape[0],), generator=torch.Generator(device=dev).manual_seed(i), device=dev)
        launches = conv.launches
        got = conv.conv3x3_fwd(x, w, b)
        if conv.launches != launches + 1:
            raise AssertionError(f"C1 {label}: {conv.launches - launches} launches, expected 1")
        plain = conv.conv3x3_fwd_plain(x, w, b)
        ref = conv.conv3x3_fwd_plain(x.double(), w.double(), b.double())
        scale = ref.abs().max().item()
        gap = (got - plain).abs().max().item() / scale
        err, plain_err = ((y.double() - ref).abs().max().item() / scale for y in (got, plain))
        log(f"C1 {label} (N={C1_CHECK_N}): against the plain version {gap:.2e} of the output's scale (tol "
            f"{C1_CHECK_TOL}); against float64 {err:.2e}, the plain version's {plain_err:.2e}")
        if not (gap <= C1_CHECK_TOL and err <= 2 * plain_err):
            raise AssertionError(f"C1 {label}: {gap:.2e} from its plain version, {err:.2e} from float64 "
                                 f"(the plain version's {plain_err:.2e})")
        checked[label] = {"gap": gap, "err": err, "plain_err": plain_err}
        worst = max(worst, gap)
        del x, w, b, got, plain, ref
    release_memory()
    times = {}
    for label, n, c, k, hw in C1_SHAPES:
        x, w = conv_inputs(dev, n, c, k, hw, 0)
        times[label] = dict(zip(TIME_KEYS, time_c1(x, w, label)))
        del x, w
        release_memory()
    return {"name": "conv3x3_fwd", "route": "cuda", "source": "vpt_tpu_torch/csrc/conv3x3_fwd.cu",
            "replaces": "none: the JAX package leaves convolutions to XLA",
            "launches": {"bc_step": C1_POLICY_CONVS, "bc_remat_step": 2 * REMAT_CHUNKS * C1_POLICY_CONVS,
                         "idm_labeling_forward": C1_IDM_CONVS, "idm_train_step": C1_IDM_CONVS,
                         "idm_remat_step": 2 * REMAT_CHUNKS * C1_IDM_CONVS, "bf16_labeling_forward": 0},
            "max_rel_gap": worst, "checked": checked, "shapes": times}


def time_kernels(dev):
    """--time-kernels: B1's and B2's times in both types at the 2x chunk
    shape ("B1 float32", ...) and at TIMED_SHAPES ("B1 float32 IDM window",
    ...), and C1's at C1_SHAPES ("C1 float32 IDM 128->256 at 128x128", ...)."""
    q, k, v, mask, R, b_nd = attention_inputs(dev, 4, 16, 128, 128, 128, torch.float32, 0)
    dO = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv, oo = (x.to(dtype) for x in (q, k, v, dO))
        name = str(dtype)[6:]
        times[f"B1 {name}"] = dict(zip(TIME_KEYS, time_b1(qq, kk, vv, mask, R, b_nd)))
        times[f"B2 {name}"] = dict(zip(TIME_KEYS, time_b2(qq, kk, vv, mask, R, b_nd, oo)))
    for kernel, label, B, H, t, d, use_mask in TIMED_SHAPES:
        timer = time_b1 if kernel == "B1" else time_b2
        for name, row in shape_times(timer, dev, B, H, t, 128, use_mask, label, d).items():
            times[f"{kernel} {name} {label}"] = row
    release_memory()
    for label, n, c, k, hw in C1_SHAPES:
        x, w = conv_inputs(dev, n, c, k, hw, 0)
        times[f"C1 float32 {label}"] = dict(zip(TIME_KEYS, time_c1(x, w, label)))
        del x, w
        release_memory()
    return times


PROFILE_FLAGS = ["--step", "bc", "--width", "2", "--batch", "8", "--chunk", "32", "--compute-dtype", "bfloat16"]


def profile_phases(dev, out_dir):
    """--profile: a table of device time by CUDA kernel (tools/profile_ops.py)
    of phase 5's chunked forward, 7(b)'s BC step, 8(c)'s IDM step and 9(b)'s
    PPO update, and of the BC step the tool's geometry flags PROFILE_FLAGS
    build; each full table goes to out_dir/profile_<name>.json."""
    from vpt_tpu_torch.agent import MineRLAgent
    from vpt_tpu_torch.models.policy import policy_initial_state
    from vpt_tpu_torch.tools import profile_ops

    agent = MineRLAgent(device=dev, batch_size=4, seed=0)
    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.randint(0, 256, (4, 128, 128, 128, 3), generator=g, device=dev, dtype=torch.uint8)
    first = torch.zeros((4, 128), dtype=torch.bool, device=dev)

    @torch.inference_mode()
    def chunked_forward():
        agent.policy(img, first, policy_initial_state(agent.cfg, 4, device=dev))

    steps = (("chunked_forward", "phase 5: 2x chunked forward (4, 128), f32", lambda: chunked_forward, 2, 3),
             ("bc_step", "phase 7(b): 2x BC train step (4, 128), f32", lambda: profile_ops.make_bc_step(dev), 2, 3),
             ("idm_step", "phase 8(c): 4x IDM train step (3, 128), f32", lambda: profile_ops.make_idm_step(dev), 2, 3),
             ("ppo_update", "phase 9(b): 2x PPO update, 64 x 64, bf16", lambda: profile_ops.make_ppo_step(dev), 1, 1),
             # the tool's geometry flags (profile_hlo.py's): its bc step at their defaults but the width
             ("flags_bc", f"profile_ops {' '.join(PROFILE_FLAGS)}",
              lambda: profile_ops.make_step(profile_ops.parser().parse_args(PROFILE_FLAGS), dev), 1, 2))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tables = {}
    for name, label, make, warmup, iters in steps:
        t0 = time.perf_counter()
        table = profile_ops.profile_step(make(), warmup=warmup, iters=iters, top=15)
        with open(out_dir / f"profile_{name}.json", "w") as f:
            json.dump(dict(table, label=label), f, indent=1)
        tables[name] = {k: table[k] for k in ("device_total_us", "iters", "categories")}
        tables[name]["top_ops"] = [{k: r[k] for k in ("op", "category", "self_time_share", "count")}
                                   for r in table["top_ops"]]
        log(f"profile of {label} ({iters} traced, {time.perf_counter() - t0:.1f} s with set-up): device time "
            f"{table['device_total_us'] / 1e3 / iters:.1f} ms a step; " + ", ".join(
                f"{k} {100 * v:.1f}%" for k, v in table["categories"].items()))
        for r in table["top_ops"][:8]:
            log(f"    {100 * r['self_time_share']:5.1f}%  {r['count'] // iters:5d}x  {r['category']:<11} {r['op'][:110]}")
        if name == "chunked_forward":
            del agent
        release_memory()  # the step's trainer, before the next one's
    return tables


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--time-kernels", action="store_true", help="time kernels B1, B2 and C1 alone and stop")
    parser.add_argument("--profile", action="store_true",
                        help="trace the chunked forward, the BC and IDM steps and the PPO update and stop")
    parser.add_argument("--profile-dir", default="profile_tables", help="where --profile writes its full tables")
    parser.add_argument("--probe-first-call", action="store_true",
                        help="compare the IDM step's first call with its later ones and stop")
    parser.add_argument("--distribution", action="store_true", help="run phase 14 alone and stop")
    parser.add_argument("--entry-points", action="store_true", help="run phase 15 alone and stop")
    parser.add_argument("--head-dims", action="store_true", help="run phase 16 alone and stop")
    parser.add_argument("--c1", action="store_true", help="run phase 17 alone and stop")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from vpt_tpu_torch.ops import cuda_build, host_resize

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}; {host_cores()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = start = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ builds the host resize while nvcc builds the kernels
        host_build = pool.submit(host_resize.backend)
        report = cuda_build.build(KERNELS)
        backend = host_build.result()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s; host resize backend: {backend}")
    import vpt_tpu_torch.agent  # noqa: F401  (the modules whose draws cache_cpu_draws caches)
    import vpt_tpu_torch.training.bc, vpt_tpu_torch.training.idm, vpt_tpu_torch.training.rl  # noqa: E401, F401
    cache_cpu_draws()
    for name, r in report.items():
        spills = ptxas_spills(r["log"])
        log(f"  {name}: {r['seconds']:.1f} s; {r['log'].count('Function properties for')} functions, "
            f"{len(spills)} spill (store, load bytes): "
            + "; ".join(f"{f} {b}" for f, b in zip(demangled(list(spills)), spills.values())))
    if backend != "native":
        raise AssertionError(f"the native host resize did not build or load: {host_resize.load_error()}")
    if args.time_kernels:
        print(json.dumps({"kernel_times": time_kernels(dev), "device": smi.splitlines()[0]}), flush=True)
        return 0
    if args.profile:
        print(json.dumps({"profiles": profile_phases(dev, args.profile_dir), "device": smi.splitlines()[0]}), flush=True)
        return 0
    if args.probe_first_call:
        print(json.dumps({"first_call": probe_first_call(dev), "device": smi.splitlines()[0]}), flush=True)
        return 0
    if args.distribution:
        print(json.dumps({"distribution_launches": check_distribution(dev, float("nan")),
                          "device": smi.splitlines()[0]}), flush=True)
        return 0
    if args.entry_points:
        print(json.dumps({"entry_point_launches": check_entry_points(dev, float("nan")),
                          "device": smi.splitlines()[0]}), flush=True)
        return 0
    if args.head_dims:
        times, launches, smem = check_head_dims(dev)
        print(json.dumps({"head_dims": times, "launches": launches, "streamed_smem_bytes": smem,
                          "device": smi.splitlines()[0]}), flush=True)
        return 0
    if args.c1:
        print(json.dumps({"c1": check_c1(dev), "device": smi.splitlines()[0]}), flush=True)
        return 0
    check_tensor_cores(KERNELS)

    def phase_done(phases):
        log(f"[phases {phases} done at {time.perf_counter() - start:.1f} s]")

    b1 = check_b1(dev)
    phase_done("1-3")
    agent = stepped_rollout(dev)
    b1["launches"] = stepwise_equals_chunkwise(agent, dev)
    del agent
    phase_done("4-5")
    b2 = check_b2(dev)
    release_memory()
    phase_done("6")
    trainer, cpu = train_card_vs_cpu(dev)
    del cpu
    b2["launches"], plain_step_ms, _ = train_steps(trainer, dev, c1_per_step=C1_POLICY_CONVS)
    del trainer
    release_memory()
    trainer = bc_remat_vs_plain(dev)
    release_memory()
    bc_remat_steps(trainer, dev)
    del trainer
    release_memory()
    phase_done("7")
    per_forward, (b1_per_step, b2_per_step), long_call, float_labeling = check_idm(dev)
    b1["idm_launches"] = {"labeling_forward": per_forward, "train_step": b1_per_step, "long_call": long_call}
    b2["idm_launches"] = {"train_step": b2_per_step}
    release_memory()
    phase_done("8")
    b1_update, b2_update = check_ppo(dev)
    b1["rl_launches"] = {"update": b1_update}
    b2["rl_launches"] = {"update": b2_update}
    phase_done("9")
    check_wide_shapes(dev)
    phase_done("10")
    int8_forward, qat_bc, qat_idm = check_int8_qat(dev, float_labeling)
    release_memory()
    b1["int8_launches"] = {"labeling_forward": int8_forward}
    b1["qat_launches"] = {"bc_step": qat_bc[0], "idm_step": qat_idm[0]}
    b2["qat_launches"] = {"bc_step": qat_bc[1], "idm_step": qat_idm[1]}
    phase_done("11")
    resumed = check_resume(dev)
    b1["resume_launches"] = {k: v[0] for k, v in resumed.items()}
    b2["resume_launches"] = {k: v[1] for k, v in resumed.items()}
    phase_done("12")
    b1_variants, b2_variants = check_variants(dev)
    b1.update(b1_variants)
    b2.update(b2_variants)
    phase_done("13")
    b1_dist, b2_dist = check_distribution(dev, plain_step_ms)
    b1.update(b1_dist)
    b2.update(b2_dist)
    phase_done("14")
    b1_entry, b2_entry = check_entry_points(dev, plain_step_ms, float_labeling)
    del float_labeling
    b1.update(b1_entry)
    b2.update(b2_entry)
    phase_done("15")
    head_dim_times, head_dim_launches, streamed_smem_bytes = check_head_dims(dev)
    for b, name in ((b1, "B1"), (b2, "B2")):
        b["head_dim_shapes"] = {k: v[name] for k, v in head_dim_times.items()}
        b["head_dim_launches"] = {k: v["forward"] if name == "B1" else v["bc_step"][1]
                                  for k, v in head_dim_launches.items()}
        b["streamed_smem_bytes"] = {k: {p: n for p, n in v.items() if p.startswith(name)}
                                    for k, v in streamed_smem_bytes.items()}
    phase_done("16")
    c1 = check_c1(dev)
    phase_done("17")

    log(smi.splitlines()[0])  # again beside the results, for a reader of the log's tail
    log(json.dumps({"kernels": [b1, b2, c1]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
