"""Where the BC train step's time goes, in the PyTorch port (counterpart of
the root tools/bench_bc_breakdown.py):

    python -m vpt_tpu_torch.tools.bench_bc_breakdown [--width 1] [--batch 8] [--chunk 32] [--iters 20] \\
        [--compute-dtype bfloat16] [--cnn-detail] [--device cuda]

Itemizes the step of ``BCTrainer`` (random weights from seed 0) on a random
batch: the loss forward alone, forward and backward, the whole optimizer
step (the trainer's ``train_step``), the optimizer's clip and Adam alone on
fixed gradients, then forward-and-backward chains of each component on its
own input (the CNN trunk, the transformer stack, the output tail with the
loss) and a GroupNorm/LayerNorm backward microbench at the trunk's shapes.
``--cnn-detail`` adds each Impala stack's forward and backward, the
max-pool's, one float32 GroupNorm's and each bare 3x3 convolution's at the
trunk's shapes.  Kernels B1 and B2 run inside the forward and the backward
of the blocks.

Each figure is ms a call over ``--iters`` calls each fed the last one's
output, after warm calls; on CUDA between CUDA events (``chain_ms`` of
bench_breakdown.py).  ``chains`` gives each chain's B1 and B2 launches,
its calls and its seconds on the host's clock, warm calls included (and
the set-up's).  Prints one JSON line, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from vpt_tpu_torch.tools.bench_breakdown import card, chain_ms


def _grad_sum(loss, params):
    """loss plus 1e-30 times the sum of its gradients' norms: a scalar that
    needs the whole backward."""
    grads = torch.autograd.grad(loss, params)
    return loss.detach() + 1e-30 * sum(g.float().norm() for g in grads)


def breakdown(width: int = 1, batch: int = 8, chunk: int = 32, iters: int = 20, compute_dtype: str = "bfloat16",
              cnn_detail: bool = False, device=None) -> dict:
    from vpt_tpu_torch.config import FOUNDATION_POLICY_KWARGS
    from vpt_tpu_torch.models.heads import dict_logprob
    from vpt_tpu_torch.models.layers import GroupNorm
    from vpt_tpu_torch.models.transformer import map_state
    from vpt_tpu_torch.ops import windowed_attention as wa
    from vpt_tpu_torch.training.bc import BCHyperparams, BCTrainer

    start = time.perf_counter()
    b, t = batch, chunk
    kwargs = dict(FOUNDATION_POLICY_KWARGS, hidsize=1024 * width, impala_width=4 * width)
    trainer = BCTrainer(kwargs, {"temperature": 2.0}, hp=BCHyperparams(batch_size=b, chunk_len=t),
                        compute_dtype=compute_dtype, device=device)
    trainer.init()
    dev, cfg, policy, specs = trainer.device, trainer.cfg, trainer.policy, trainer.head_specs
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(0)
    batch_np = {
        "frames": rng.integers(0, 255, (b, t, 128, 128, 3), dtype=np.uint8),
        "buttons": rng.integers(0, 8641, (b, t)).astype(np.int32),
        "camera": rng.integers(0, 121, (b, t)).astype(np.int32),
        "firsts": np.zeros((b, t), bool),
        "mask": np.ones((b, t), bool),
    }
    placed = trainer.to_device(batch_np)
    params = trainer.trainable_parameters()
    g = torch.Generator(device=dev).manual_seed(0)  # the chains' inputs, drawn where they are used

    def normal(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    results = {"geometry": f"{width}x B={b} T={t} {compute_dtype}", "device": card(dev)}
    chains = {"setup": {"seconds": time.perf_counter() - start}}

    def counted(name, step, carry):
        """``results[name]``, and the chain's B1 and B2 launches, calls and
        seconds (its warm calls included) in ``chains``."""
        wa.launches = wa.bwd_launches = 0
        t0 = time.perf_counter()
        results[name] = chain_ms(step, carry, iters, dev)
        chains[name] = {"B1": wa.launches, "B2": wa.bwd_launches, "calls": iters + 2,
                        "seconds": time.perf_counter() - t0}

    def loss_of(frames, state):
        out, state_out = policy(frames, placed["firsts"], state)
        actions = {"buttons": placed["buttons"][..., None], "camera": placed["camera"][..., None]}
        logp = dict_logprob(out["pi_logits"], actions, specs)
        return -(logp * placed["mask"].float()).sum() / logp.numel(), state_out

    state0 = trainer.initial_state(b)

    def fwd(carry):
        acc, state = carry
        with torch.no_grad():
            loss, state = loss_of(placed["frames"] + (acc * 0).to(torch.uint8), state)
        return loss, state

    counted("fwd_ms", fwd, (torch.zeros((), device=dev), state0))

    def grad(carry):
        acc, state = carry
        loss, state = loss_of(placed["frames"] + (acc * 0).to(torch.uint8), state)
        return _grad_sum(loss, params), map_state(torch.Tensor.detach, state)

    counted("grad_ms", grad, (torch.zeros((), device=dev), state0))

    def step(state):
        state, _, _ = trainer.train_step(placed, state)
        return state

    counted("step_ms", step, state0)

    frozen = [torch.full_like(p, 1e-6) for p in params]

    def opt(_):
        for p, g in zip(params, frozen):
            p.grad = g.clone()
        return trainer.optimizer.step()

    counted("optimizer_ms", opt, None)
    trainer.optimizer.zero_grad()

    # the components' forward and backward chains, each on its own input
    net = policy.net
    img = placed["frames"].float()
    cnn_params = list(net.img_process.parameters())
    counted("cnn_grad_ms", lambda c: _grad_sum(net.img_process(net.img_preprocess(img + c * 1e-30)).float().sum(),
                                               cnn_params), torch.zeros((), device=dev))
    lat = normal((b, t, cfg.hidsize))
    block_params = list(net.recurrent_layer.parameters())

    def blocks(c):
        y, _ = net.recurrent(lat + c * 1e-30, placed["firsts"], trainer.initial_state(b))
        return _grad_sum(y.float().sum(), block_params)

    counted("transformer_grad_ms", blocks, torch.zeros((), device=dev))
    tail_params = [p for n, p in policy.named_parameters()
                   if n.startswith(("net.lastlayer.", "net.final_ln.", "pi_head."))]

    def tail(c):
        out = policy.heads_from_recurrent(lat + c * 1e-30)
        actions = {"buttons": placed["buttons"][..., None], "camera": placed["camera"][..., None]}
        logp = dict_logprob(out["pi_logits"], actions, specs)
        return _grad_sum(-(logp * placed["mask"].float()).sum() / logp.numel(), tail_params)

    counted("tail_loss_grad_ms", tail, torch.zeros((), device=dev))

    # GroupNorm(1 group) at each stack's post-pool shape, LayerNorm at the
    # blocks' (B, T, hidsize) scaled by its ~9 uses a step (2 a block, 4
    # blocks, and the final one)
    chans = [cfg.impala_width * c for c in cfg.impala_chans]  # (64w, 128w, 128w) for the foundation's
    gn_shapes = [(b * t, chans[0], 64, 64), (b * t, chans[1], 32, 32), (b * t, chans[2], 16, 16)]
    norm_inputs = [normal(s).requires_grad_(True) for s in gn_shapes + [(b, t, cfg.hidsize)]]

    def norms(c):
        total = torch.zeros((), device=dev)
        for x in norm_inputs[:-1]:
            total = total + F.group_norm(x + c * 1e-30, 1).sum()
        total = total + 9.0 * F.layer_norm(norm_inputs[-1] + c * 1e-30, (cfg.hidsize,)).sum()
        grads = torch.autograd.grad(total, norm_inputs)
        return total.detach() + 1e-30 * sum(g.sum() for g in grads)

    counted("gn_ln_grad_microbench_ms", norms, torch.zeros((), device=dev))

    step_ms = results["step_ms"]
    results["derived"] = {
        "backward_ms": results["grad_ms"] - results["fwd_ms"],
        "optimizer_share_of_step": results["optimizer_ms"] / step_ms,
        "fwd_share_of_step": results["fwd_ms"] / step_ms,
        "backward_share_of_step": (results["grad_ms"] - results["fwd_ms"]) / step_ms,
        "unattributed_ms": step_ms - results["grad_ms"] - results["optimizer_ms"],
        "component_sum_vs_grad": (results["cnn_grad_ms"] + results["transformer_grad_ms"]
                                  + results["tail_loss_grad_ms"]) / results["grad_ms"],
        "fps_implied": b * t / (step_ms / 1e3),
    }

    if cnn_detail:
        t0 = time.perf_counter()
        detail = {}
        stacks = net.img_process.cnn.stacks
        geoms = [(128, 3, chans[0]), (64, chans[0], chans[1]), (32, chans[1], chans[2])]

        def fwd_and_grad(label, fn, x, module_params):
            with torch.no_grad():
                detail[label + "_fwd_ms"] = chain_ms(lambda c: fn(x + c * 1e-30).float().sum(),
                                                     torch.zeros((), device=dev), iters, dev)
            detail[label + "_grad_ms"] = chain_ms(
                lambda c: _grad_sum(fn(x + c * 1e-30).float().sum(), module_params or [x]),
                torch.zeros((), device=dev), iters, dev)

        for i, (hw, cin, _) in enumerate(geoms):
            fwd_and_grad(f"stack{i}", stacks[i], normal((b * t, cin, hw, hw), dtype), list(stacks[i].parameters()))
        for i, (hw, _, cout) in enumerate(geoms):  # max-pool(3, stride 2, pad 1) at each pre-pool shape
            fwd_and_grad(f"pool{i}", lambda x: F.max_pool2d(x, 3, 2, 1),
                         normal((b * t, cout, hw, hw), dtype).requires_grad_(True), [])
        for i, (hw, _, cout) in enumerate(geoms):  # one float32 GroupNorm(1) from and back to the compute type
            gn = GroupNorm(1, cout, device=dev)
            hw2 = (hw + 1) // 2
            fwd_and_grad(f"gn{i}", lambda x, gn=gn: gn(x).to(dtype), normal((b * t, cout, hw2, hw2), dtype),
                         list(gn.parameters()))
        conv_geoms = {
            "conv_stem_128_3to64": (128, 3, chans[0]),
            "conv_block_64_64": (64, chans[0], chans[0]),
            "conv_first_64_64to128": (64, chans[0], chans[1]),
            "conv_block_32_128": (32, chans[1], chans[1]),
            "conv_first_32_128to128": (32, chans[1], chans[2]),
            "conv_block_16_128": (16, chans[2], chans[2]),
        }
        for label, (hw, cin, cout) in conv_geoms.items():  # bare 3x3 convolutions, no norm
            conv = torch.nn.Conv2d(cin, cout, 3, padding=1, bias=False, device=dev, dtype=dtype)
            fwd_and_grad(label, conv, normal((b * t, cin, hw, hw), dtype), list(conv.parameters()))
        results["cnn_detail"] = detail
        chains["cnn_detail"] = {"seconds": time.perf_counter() - t0}
    results["chains"] = chains
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--cnn-detail", action="store_true",
                    help="also itemize the CNN: each stack's forward and backward, the max-pool's, a GroupNorm's "
                         "and each bare convolution's at the trunk's shapes")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    results = breakdown(args.width, args.batch, args.chunk, args.iters, args.compute_dtype, args.cnn_detail,
                        args.device)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
