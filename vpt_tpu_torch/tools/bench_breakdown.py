"""Where the t=1 rollout step's time goes, in the PyTorch port (counterpart
of the root tools/bench_breakdown.py):

    python -m vpt_tpu_torch.tools.bench_breakdown [--width 2] [--streams 64] [--iters 50] [--device cuda]

Times the three parts of the policy step at t=1 on the ring cache, in
bfloat16 with random weights from seed 0: the CNN trunk (preprocessing,
Impala CNN, projection to hidsize), the transformer stack, and the output
tail (relu, lastlayer, final LayerNorm, the action and value heads and the
sample).  Each part runs ``--iters`` times with each call's input depending
on the last one's output; on CUDA the chain is timed by CUDA events around
it, after warm calls, so the time is the device's.  (The JAX tool chains
its calls in a ``lax.scan``, for its TPU's remote dispatch; a CUDA stream
runs its launches in order, so a Python loop of them is the chain.)

Prints one JSON line: each part's ms a step, their sum, the frames a second
they imply, each part's share, the CNN's hand-counted GFLOPs a step and,
on CUDA, the share of the H100's dense bfloat16 tensor-core peak it
reaches, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

# the H100 SXM's dense bfloat16 tensor-core peak (NVIDIA data sheet)
H100_BF16_FLOPS = 989e12


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the device."""
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def chain_ms(step, carry, iters: int, device: torch.device, warmup: int = 2) -> float:
    """ms an application of ``step`` (carry → carry) takes, over ``iters``
    applications each fed the last one's output, after ``warmup`` of them:
    on CUDA between two events on the stream, else on the host's clock."""
    for _ in range(warmup):
        carry = step(carry)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            carry = step(carry)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = step(carry)
    return 1e3 * (time.perf_counter() - t0) / iters


def conv_gflops(width: int, streams: int) -> dict:
    """Hand-counted FLOPs of the Impala trunk for ``streams`` frames at t=1:
    stacks of (64w, 128w, 128w) channels (impala_width 4w, the foundation's
    impala_chans (16, 32, 32)) at 128, 64 and 32 pixels, the dense layer to
    256 and the projection to hidsize 1024w."""
    chans = [4 * width * c for c in (16, 32, 32)]
    hw = [128, 64, 32]
    total = 0.0
    cin = 3
    for c, s in zip(chans, hw):
        total += 2 * 9 * cin * c * s * s  # firstconv (stride 1, before the pool)
        half = (s + 1) // 2
        total += 4 * 2 * 9 * c * c * half * half  # 2 residual blocks x 2 convs
        cin = c
    total += 2 * (chans[-1] * 16 * 16) * 256
    total += 2 * 256 * 1024 * width
    return {"gflops_per_frame": total / 1e9, "gflops_per_step": total * streams / 1e9}


def policy_at_width(width: int, compute_dtype: str, device: torch.device):
    """The foundation policy at hidsize 1024·width and impala width 4·width,
    weights drawn from seed 0; returns (policy, head specs)."""
    from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
    from vpt_tpu_torch.config import FOUNDATION_POLICY_KWARGS, PolicyConfig
    from vpt_tpu_torch.models.heads import head_specs_from_space
    from vpt_tpu_torch.models.layers import init_parameters
    from vpt_tpu_torch.models.policy import MinecraftAgentPolicy
    from vpt_tpu_torch.spaces import DictType

    cfg = PolicyConfig.from_kwargs(dict(FOUNDATION_POLICY_KWARGS, hidsize=1024 * width,
                                        impala_width=4 * width)).replace(compute_dtype=compute_dtype)
    specs = head_specs_from_space(DictType(**CameraHierarchicalMapping(n_camera_bins=11).get_action_space_update()))
    policy = MinecraftAgentPolicy(cfg, specs, 2.0, device=device)
    init_parameters(policy, torch.Generator(device=device).manual_seed(0))
    return policy, specs


@torch.inference_mode()
def breakdown(width: int = 2, streams: int = 64, iters: int = 50, device=None) -> dict:
    from vpt_tpu_torch.device import resolve_device
    from vpt_tpu_torch.models.heads import dict_sample
    from vpt_tpu_torch.models.policy import policy_initial_state

    dev = resolve_device(device)
    policy, specs = policy_at_width(width, "bfloat16", dev)
    policy.eval()
    cfg, net, b = policy.cfg, policy.net, streams
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.randint(0, 255, (b, 1) + tuple(cfg.img_shape), generator=g, device=dev).float()
    results = {"geometry": f"{width}x, {streams} streams, t=1, bfloat16", "device": card(dev)}

    def cnn(acc):  # the next frames depend on the last output's sum
        return net.embed(img + acc * 1e-30).float().sum()

    results["cnn_ms"] = chain_ms(cnn, torch.zeros((), device=dev), iters, dev)

    first = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    lat = torch.zeros((b, 1, cfg.hidsize), dtype=torch.bfloat16, device=dev)

    def blocks(carry):
        x, state = carry
        y, state = net.recurrent(x, first, state)
        return x + y * 1e-30, state

    results["transformer_ms"] = chain_ms(blocks, (lat, policy_initial_state(cfg, b, ring=True, device=dev)),
                                         iters, dev)

    def tail(x):
        out = policy.heads_from_recurrent(x)
        action = dict_sample({k: v[:, -1] for k, v in out["pi_logits"].items()}, specs, generator=g)
        dep = out["vpred"].float().sum() + sum(a.float().sum() for a in action.values())
        return x + dep * 1e-30

    results["tail_ms"] = chain_ms(tail, lat.float(), iters, dev)

    flops = conv_gflops(width, streams)
    results["cnn_gflops_per_step"] = flops["gflops_per_step"]
    results["cnn_achieved_tflops"] = flops["gflops_per_step"] / results["cnn_ms"]  # GFLOP/ms = TFLOP/s
    results["cnn_share_of_h100_bf16_peak"] = (results["cnn_achieved_tflops"] * 1e12 / H100_BF16_FLOPS
                                              if dev.type == "cuda" else None)
    total_ms = results["cnn_ms"] + results["transformer_ms"] + results["tail_ms"]
    results["sum_ms"] = total_ms
    results["implied_fps"] = streams / (total_ms / 1e3)
    results["share"] = {k: results[f"{k}_ms"] / total_ms for k in ("cnn", "transformer", "tail")}
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=2)
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    results = breakdown(args.width, args.streams, args.iters, args.device)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
