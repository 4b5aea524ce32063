"""The BC step the 3x foundation policy trains with (``remat`` and
``cnn_scan_chunks`` 2: each frame chunk's whole CNN and each block
recomputed in the backward), at d = 192 (hidsize 384 at 2 heads) and a
small Impala stack over 32² frames on the CPU (and the benchmark's 3x
configuration is the port's 3x, at d = 192):

  * it equals the benchmark's plain reference step (portbench/reference:
    no recompute, no kernels) on the benchmark's seeded weights: the loss,
    the clipped gradient and each parameter's change after Adam, by leaf;
  * it equals the port's step without remat or chunks;
  * under a profiler the recompute, and only the recompute, opens
    ``vpt_torch.remat.cnn`` (a chunk's, or with no chunks an Impala
    stack's) and ``vpt_torch.remat.block``, inside the step's backward,
    and ``remat_recomputes`` counts each recomputed call once;
  * with no profiler recording nothing enters ``record_function`` and
    nothing is counted.

Tolerances.  Port against reference: float32 sums in another order, so the
loss within 1e-5 relative, as portbench/tests/test_portbench_reference.py's
BC step, and each leaf by the benchmark's measure (portbench/drivers/bc.py
``leaf_gap``: the gap's norm over the larger of the leaf's and the median
leaf's): the gradient within 2e-5 (read: 1.8e-6), each parameter's change
within 1e-3, the CPU limit of portbench/tests/tiny.py (read: 1.0e-4).
Adam's first step divides a gradient by its own magnitude, so an element
whose gradient and weight decay nearly cancel moves by a share of the
learning rate on a rounding: the change is compared by leaf, not by
element.  Port against port: the same arithmetic recomputed, so the loss
and the gradient norm within 1e-6 relative and every parameter within
1e-6, tests/test_torch_remat.py's numbers."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from portbench import inputs, manifest
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from vpt_tpu_torch.config import PolicyConfig, foundation_policy_config
from vpt_tpu_torch.training.bc import BCHyperparams, BCTrainer
from vpt_tpu_torch.utils import profiling

KWARGS = {"attention_heads": 2, "attention_mask_style": "clipped_causal", "attention_memory_size": 16, "hidsize": 384,
          "img_shape": [32, 32, 3], "impala_chans": [4, 8, 8], "impala_kwargs": {"post_pool_groups": 1},
          "impala_width": 1, "init_norm_kwargs": {"batch_norm": False, "group_norm_groups": 1},
          "n_recurrence_layers": 2, "pointwise_ratio": 4, "recurrence_type": "transformer", "timesteps": 8,
          "use_pre_lstm_ln": False}
PI_HEAD = {"temperature": 2.0}
HP = {"learning_rate": 0.000181, "weight_decay": 0.039428, "max_grad_norm": 5.0}  # the reference BC's
B, T, CHUNKS = 2, 8, 2
ARCH = ref_model.arch_from_config({"policy_kwargs": KWARGS, "pi_head_kwargs": PI_HEAD})
REMAT_SPANS = ("vpt_torch.remat.cnn", "vpt_torch.remat.block")


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():  # another module of the suite turns grad mode off when pytest imports it
        yield


def _trainer(seed=3, **options):
    trainer = BCTrainer(KWARGS, PI_HEAD, hp=BCHyperparams(batch_size=B, chunk_len=T, **HP), device="cpu", **options)
    trainer.init()
    trainer.policy.load_state_dict(inputs.make_weights(ARCH, seed, "cpu"))
    return trainer


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    return {"frames": torch.randint(0, 256, (B, T, 32, 32, 3), generator=g, dtype=torch.uint8),
            "buttons": torch.randint(0, 8641, (B, T), generator=g),
            "camera": torch.randint(0, 121, (B, T), generator=g),
            "firsts": torch.rand((B, T), generator=g) < 0.2, "mask": torch.rand((B, T), generator=g) < 0.8}


def _grads(trainer):
    """The clipped gradient Adam took, by parameter name (value head out)."""
    return {n: p.grad.detach().clone() for n, p in trainer.policy.named_parameters() if p.grad is not None}


def _leaf_gap(got, ref):
    """The widest leaf's gap, against the larger of its norm and the median leaf's."""
    norms = {n: float(r.norm()) for n, r in ref.items()}
    median = float(np.median(list(norms.values())))
    gaps = {n: float((got[n] - r).norm()) / max(norms[n], median) for n, r in ref.items()}
    return max(gaps.values()), max(gaps, key=gaps.get)


def test_the_benchmark_config_is_the_3x_width_rule_at_d192():
    """portbench/configs/policy3x.json: the port's 3x foundation config,
    531,520,958 parameters by the reference's list, d = 192 as here."""
    with open(manifest.config_file(manifest.load(), "policy3x")) as f:
        config = json.load(f)
    assert PolicyConfig.from_kwargs(config["policy_kwargs"]) == foundation_policy_config(3)
    arch = ref_model.arch_from_config(config)
    n = sum(int(np.prod(shape)) for _, shape, _, _ in ref_model.param_spec(arch))
    assert n == config["parameters"] == 531520958
    assert arch.hidsize // arch.heads == ARCH.hidsize // ARCH.heads == 192


def test_remat_chunked_step_matches_the_reference():
    trainer = _trainer(remat=True, cnn_scan_chunks=CHUNKS)
    batch = _batch(1)
    _, loss, _ = trainer.train_step(batch, trainer.initial_state(B))
    grads = _grads(trainer)
    params = inputs.make_weights(ARCH, 3, "cpu")
    ref_loss, ref_grads, _ = ref_train.loss_and_grads(params, ARCH, batch, ref_model.initial_state(ARCH, B), 1)
    clipped = ref_train.Adam(HP).step(params, ref_grads)
    assert abs(float(loss) - ref_loss) < 1e-5 * abs(ref_loss)
    assert set(grads) == set(clipped)
    gap, leaf = _leaf_gap(grads, clipped)
    assert gap < 2e-5, leaf
    theta0 = inputs.make_weights(ARCH, 3, "cpu")
    after = trainer.policy.state_dict()
    gap, leaf = _leaf_gap({n: after[n] - theta0[n] for n in clipped}, {n: params[n] - theta0[n] for n in clipped})
    assert gap < 1e-3, leaf


def test_remat_chunked_step_matches_the_plain_step():
    plain, remat = _trainer(), _trainer(remat=True, cnn_scan_chunks=CHUNKS)
    state_plain, state_remat = plain.initial_state(B), remat.initial_state(B)
    for step in range(2):  # the second from the carried state and after one Adam step
        batch = _batch(10 + step)
        state_plain, loss_plain, norm_plain = plain.train_step(batch, state_plain)
        state_remat, loss_remat, norm_remat = remat.train_step(batch, state_remat)
        torch.testing.assert_close(loss_remat, loss_plain, rtol=1e-6, atol=0)
        torch.testing.assert_close(norm_remat, norm_plain, rtol=1e-6, atol=0)
    for (name, p), q in zip(remat.policy.named_parameters(), plain.policy.parameters()):
        torch.testing.assert_close(p, q, atol=1e-6, rtol=0, msg=name)


def _spans(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("vpt_torch.")]


def _inside(inner, outers):
    a, b = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    return any(o["tid"] == inner["tid"] and float(o["ts"]) <= a and b <= float(o["ts"]) + float(o["dur"])
               for o in outers)


@pytest.mark.parametrize("chunks", [CHUNKS, 0], ids=["frame_chunks", "impala_stacks"])
def test_the_recompute_alone_opens_the_remat_spans(chunks, tmp_path):
    trainer = _trainer(remat=True, cnn_scan_chunks=chunks)
    steps = 2
    state = trainer.initial_state(B)
    profiling.counters(reset=True)
    with profiling.profile_trace(str(tmp_path)):
        for step in range(steps):
            state, _, _ = trainer.train_step(_batch(20 + step), state)
    counted = profiling.counters(reset=True)
    by = {}
    for e in _spans(tmp_path):
        by.setdefault(e["name"], []).append(e)
    cnn_calls = chunks or len(ARCH.chans)  # each chunk's whole CNN, or with no chunks each Impala stack
    assert len(by["vpt_torch.remat.cnn"]) == steps * cnn_calls
    assert len(by["vpt_torch.remat.block"]) == steps * ARCH.n_blocks
    assert counted["remat_recomputes"] == steps * (cnn_calls + ARCH.n_blocks)
    for name in REMAT_SPANS:
        assert all(_inside(e, by["vpt_torch.bc.backward"]) for e in by[name]), name
        assert not any(_inside(e, by["vpt_torch.bc.forward"] + by["vpt_torch.policy.cnn"]) for e in by[name]), name


def test_no_profiler_no_remat_span_no_count(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    trainer = _trainer(remat=True, cnn_scan_chunks=CHUNKS)
    profiling.counters(reset=True)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    trainer.train_step(_batch(30), trainer.initial_state(B))
    assert profiling.counters() == {}
