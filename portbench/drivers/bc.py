"""Behavioural-cloning traffic: ``BCTrainer.train_step`` on B streams of
T-step chunks, the recurrent state carried from chunk to chunk as
``BCTrainer.train`` carries it.

Traffic file keys: ``batch``, ``chunk`` (T), ``compute_dtype``, ``remat``,
``cnn_scan_chunks``, ``episode_steps`` [lo, hi] (each stream is a run of
episodes of these lengths; a stream joins its first one so that it ends
inside the checked steps, so resets fall inside chunks), ``null_share``
(the share of steps whose action is the null action, which the loss masks,
as the published BC skips null actions), ``pool_batches`` (distinct
batches made in set-up, pinned on the host, moved to the device each step,
taken in turn), ``check_steps``, ``row_block`` (rows of the reference's
forward at a time), ``hp`` (learning rate, weight decay, clip norm),
``trace_units`` (steps a trace-run stretch).

Set-up builds one trainer, loads the seed's weights into it and drives it
through ``check_steps`` steps on the first batches, which also warm every
shape; the window goes on with that same trainer.  The check: the plain
reference (portbench/reference/train.py) runs the same steps from the same
weights, in float32 with TF32 off; compared are each step's loss, the
first step's gradient as Adam took it (read back from Adam's first moment
after step 1), and each parameter's change after the checked steps, both
by the worst leaf.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from portbench import inputs, work
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

BETA1 = 0.9  # the optimizer's first-moment decay (Adam's default, as the published BC)


def _set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def make_batches(run, arch) -> list:
    """The pool of distinct host batches, pinned where there is a card."""
    tr = run.traffic
    b, t, k = tr["batch"], tr["chunk"], tr["pool_batches"]
    r = inputs.rng(run.seed, inputs.TRAFFIC)
    first_end = r.integers(1, tr["check_steps"] * t, size=b)
    starts = inputs.episode_starts(r, b, k * t, tr["episode_steps"], first_end)
    null = r.random((b, k * t)) < tr["null_share"]
    buttons = np.where(null, 0, r.integers(0, arch.head_shapes[0][1][1], size=(b, k * t)))
    camera = np.where(null, arch.head_shapes[1][1][1] // 2, r.integers(0, arch.head_shapes[1][1][1], size=(b, k * t)))
    h, w = arch.img
    pool = inputs.frame_pool(run.seed, tr.get("frame_pool", 512), (h, w, arch.in_chans), run.device)
    steps = np.arange(k * t)
    batches = []
    for i in range(k):
        cols = slice(i * t, (i + 1) * t)
        idx = inputs.pool_index(steps[None, cols], np.arange(b)[:, None], pool.shape[0])
        frames = pool[torch.as_tensor(idx, device=run.device)].cpu()
        batch = {"frames": frames, "buttons": torch.as_tensor(buttons[:, cols]),
                 "camera": torch.as_tensor(camera[:, cols]), "firsts": torch.as_tensor(starts[:, cols]),
                 "mask": torch.as_tensor(~null[:, cols])}
        if run.cuda:
            batch = {key: v.pin_memory() for key, v in batch.items()}
        batches.append(batch)
    return batches


def _leaf_norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def run(run) -> None:
    from vpt_tpu_torch.training.bc import BCHyperparams, BCTrainer

    tr, arch, cfg = run.traffic, run.arch, run.config
    if run.control and tr["compute_dtype"] != "float32":
        raise ValueError("the bc driver has a control for float32 cells only (TF32)")
    _set_tf32(run.control)  # the float32 control: TF32 in the program's place
    run.phase("imports")
    hp = BCHyperparams(batch_size=tr["batch"], chunk_len=tr["chunk"], **tr["hp"])
    trainer = BCTrainer(cfg["policy_kwargs"], cfg.get("pi_head_kwargs", {}), hp=hp,
                        compute_dtype=tr["compute_dtype"], remat=tr["remat"], cnn_scan_chunks=tr["cnn_scan_chunks"],
                        device=run.device)
    trainer.init()
    run.phase("program init")
    trainer.policy.load_state_dict(inputs.make_weights(arch, run.seed, run.device))
    run.phase("weights")
    batches = make_batches(run, arch)
    run.phase("traffic")
    state = trainer.initial_state(tr["batch"])
    named = [(n, p) for n, p in trainer.policy.named_parameters() if not n.startswith("value_head.")]

    losses, grad_norms, change_norms = [], {}, {}
    for i in range(tr["check_steps"]):
        state, loss, _ = trainer.train_step(batches[i], state)
        losses.append(float(loss))
        if i == 0:  # the first gradient as Adam took it: m1 / (1 - β1), less the weight decay's term
            theta0 = inputs.make_weights(arch, run.seed, run.device)
            moments = trainer.optimizer.adam.state  # a leaf Adam did not step reads a gradient of 0
            grad_norms = _leaf_norms({n: moments[p]["exp_avg"] / (1 - BETA1) - hp.weight_decay * theta0[n]
                                      if "exp_avg" in moments.get(p, {}) else torch.zeros_like(p) for n, p in named})
            del theta0
    theta0 = inputs.make_weights(arch, run.seed, run.device)
    change_norms = _leaf_norms({n: p.detach() - theta0[n] for n, p in named})
    del theta0
    run.setup_done()

    cursor = [tr["check_steps"]]
    frames_a_step = tr["batch"] * tr["chunk"]

    def step() -> int:
        nonlocal state
        batch = batches[cursor[0] % len(batches)]
        cursor[0] += 1
        with torch.profiler.record_function("portbench.train_step"):
            state, loss, _ = trainer.train_step(batch, state)
            float(loss)  # the loss comes back every step, as BCTrainer.train reads it
        return frames_a_step

    flops = work.train_flops_per_frame(arch, tr["chunk"])
    if run.trace:
        spans = run.stretch(step, "spans")
        run.layer.update(kind="train", flops_per_s=spans["done"] * flops / spans["seconds"],
                         peak=work.TENSOR_FLOPS[tr["compute_dtype"]])
        run.attempted = spans["done"] + run.stretch(step, "traced")["done"]
    else:
        window = run.stretch(step, "window")
        run.attempted = window["done"]
        run.e2e["train_fps"] = window["done"] / window["seconds"]

    del trainer, state, named, moments
    run.free()
    _check(run, arch, hp, batches, losses, grad_norms, change_norms)


def _check(run, arch, hp, batches, losses, grad_norms, change_norms) -> None:
    tr = run.traffic
    _set_tf32(False)
    params = inputs.make_weights(arch, run.seed, run.device)
    adam = ref_train.Adam({"learning_rate": hp.learning_rate, "weight_decay": hp.weight_decay,
                           "max_grad_norm": hp.max_grad_norm})
    state = ref_model.initial_state(arch, tr["batch"], run.device)
    ref_losses, ref_grads = [], {}
    for i in range(tr["check_steps"]):
        batch = {k: v.to(run.device) for k, v in batches[i].items()}
        loss, grads, state = ref_train.loss_and_grads(params, arch, batch, state, tr["row_block"])
        clipped = adam.step(params, grads)
        ref_losses.append(loss)
        if i == 0:
            ref_grads = _leaf_norms(clipped)
        del grads, clipped
    theta0 = inputs.make_weights(arch, run.seed, run.device)
    ref_change = _leaf_norms({n: params[n] - theta0[n] for n in ref_train.trainable(params)})
    run.check("loss_gap", max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)))
    run.check("grad_leaf_gap", leaf_gap(grad_norms, ref_grads))
    print(f"portbench: losses {losses} against {ref_losses}; worst gradient leaves "
          f"{worst(grad_norms, ref_grads)}", file=sys.stderr)
    # leaves whose reference gradient is nought to rounding move under Adam by round-off alone
    floor = 1e-3 * float(np.median(list(ref_grads.values())))
    moved = [n for n in ref_change if ref_grads[n] >= floor]
    changes = {n: change_norms[n] for n in moved}, {n: ref_change[n] for n in moved}
    run.check("change_leaf_gap", leaf_gap(*changes))
    print(f"portbench: left out of the change {sorted(set(ref_change) - set(moved))}; worst changed leaves "
          f"{worst(*changes)}", file=sys.stderr)


def leaf_gaps(got: dict, ref: dict) -> dict:
    """Each leaf's gap between two norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = float(np.median(list(ref.values())))
    return {n: abs(got[n] - ref[n]) / max(ref[n], med) for n in ref}


def leaf_gap(got: dict, ref: dict) -> float:
    return max(leaf_gaps(got, ref).values())


def worst(got: dict, ref: dict, n: int = 3) -> list:
    """The ``n`` worst leaves: (name, gap, program's norm, reference's norm)."""
    gaps = leaf_gaps(got, ref)
    return [(k, gaps[k], got[k], ref[k]) for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]
