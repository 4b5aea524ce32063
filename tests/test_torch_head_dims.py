"""Head dims on the CPU.  The kernels take every d >= 1, as vpt_tpu's
attention does: multiples of 64 whole, any other d zero-padded to the next
(ops/windowed_attention.py ``kernel_d``).

  * The wrappers' pad-and-slice (``padded_fwd``, ``padded_bwd``) around a
    stand-in for the kernel that computes the plain attention at the scale
    it is given, against the plain version at the unpadded d: the output
    and every gradient within 1e-5 (float32: the padded columns add exact
    zeros to the products), the scale the kernel gets being the unpadded
    d's (the padded d's moves the output by far more), the kernel seeing
    the padded head dim, and the operators' FLOP count being the unpadded
    work, as the plain version's is.
  * The kernels' plain versions past 512 (d = 640, 1024) against
    ``vpt_tpu.ops.attention.windowed_attention`` with ``relattn_bias`` and
    its ``jax.vjp``, on the same numpy inputs: the output and all five
    gradients within 1e-5 * (1 + max|ref|) (float32 sums in another order).
  * A one-block policy at d = 1024 (hidsize 1024, 1 head) against vpt_tpu's
    on the same weights: the chunked forward's logits and value, and one BC
    step's loss (rtol 1e-5) and every parameter's gradient (max-abs error
    <= max(2e-6, 1e-4 * its max-abs)), the limits of
    tests/test_torch_training.py, the logits and value held to the
    gradients' one.

On the card the same wrappers launch B1 and B2 (chip_smoke.py phase 16,
tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vpt_tpu.checkpoint.torch_import import state_dict_to_variables, variables_to_state_dict
from vpt_tpu.models.heads import dict_logprob as jax_dict_logprob
from vpt_tpu.ops.attention import windowed_attention as jax_attention
from vpt_tpu.ops.rel_bias import relattn_bias as jax_relattn_bias
from vpt_tpu.parallel.mesh import make_mesh
from vpt_tpu.training import bc as jax_bc
from vpt_tpu_torch.ops import windowed_attention as wa
from vpt_tpu_torch.ops.attention import NEG_BIAS
from vpt_tpu_torch.ops.rel_bias import relattn_bias
from vpt_tpu_torch.training import bc

TOL = 1e-5


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def _inputs(d, seed=0, B=2, H=3, t=6, maxlen=10):
    g = torch.Generator().manual_seed(seed)
    T = t + maxlen
    q, k, v = (torch.randn(s, generator=g) for s in ((B, H, t, d), (B, H, T, d), (B, H, T, d)))
    R = torch.randn((B, H, t, 10), generator=g)
    b_nd = torch.randn((10, maxlen), generator=g)
    mask = torch.rand((B, t, T), generator=g) < 0.7
    mask[..., -1] = True  # every row attends somewhere
    return q, k, v, mask, R, b_nd


def _attention_at(q, k, v, mask, R, b_nd, alpha):
    """softmax(alpha·QKᵀ + relative bias + mask bias)·V at the scale given."""
    logits = alpha * q @ k.transpose(-1, -2) + relattn_bias(R, b_nd, k.shape[2])
    logits = logits + torch.where(mask[:, None], 0.0, NEG_BIAS)
    return torch.softmax(logits, dim=-1) @ v


class StandIn:
    """A kernel stand-in that records the head dim and scale it is called with."""

    def __init__(self):
        self.calls = []

    def fwd(self, q, k, v, mask, R, b_nd, alpha):
        self.calls.append((q.shape[-1], alpha))
        return _attention_at(q, k, v, mask, R, b_nd, alpha)

    def bwd(self, q, k, v, mask, R, b_nd, dO, alpha):
        self.calls.append((q.shape[-1], alpha))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v, R, b_nd)]
        out = _attention_at(leaves[0], leaves[1], leaves[2], mask, leaves[3], leaves[4], alpha)
        return tuple(x.contiguous() for x in torch.autograd.grad(out, leaves, dO))  # as the kernel's


@pytest.mark.parametrize("d,expect", [(16, 64), (32, 64), (64, 64), (96, 128), (200, 256), (320, 320), (384, 384),
                                      (448, 448), (500, 512), (512, 512), (513, 576), (640, 640), (1024, 1024),
                                      (4096, 4096)])
def test_kernel_d_is_the_next_multiple_of_64(d, expect):
    assert wa.kernel_d(d) == expect


@pytest.mark.parametrize("d", [0, 513, 1024])
def test_head_dims_past_the_kernels_raise_naming_themselves(d):
    """Only a head dim below 1 is past what the kernels take, and raises
    naming itself; the widths that raised before the streamed instance (past
    512) now run at the next multiple of 64."""
    if d < 1:
        with pytest.raises(ValueError, match=f"head dim {d} "):
            wa.kernel_d(d)
    else:
        assert wa.kernel_d(d) == -(-d // 64) * 64 >= d


@pytest.mark.parametrize("d", [16, 32, 96, 384, 520, 1024])
@pytest.mark.parametrize("muP", [True, False])
def test_padded_forward_equals_the_plain_version(d, muP):
    q, k, v, mask, R, b_nd = _inputs(d)
    kernel = StandIn()
    got = wa.padded_fwd(q, k, v, mask, R, b_nd, muP, kernel.fwd)
    expect = wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, muP)
    assert got.shape == expect.shape and got.is_contiguous()
    assert (got - expect).abs().max().item() <= TOL
    assert kernel.calls == [(wa.kernel_d(d), wa.attention_alpha(d, muP))]
    if wa.kernel_d(d) != d:  # the padded d's scale would be far off: the test can tell
        wrong = _attention_at(q, k, v, mask, R, b_nd, wa.attention_alpha(wa.kernel_d(d), muP))
        assert (wrong - expect).abs().max().item() > 100 * TOL


@pytest.mark.parametrize("d", [16, 32, 96, 384, 520, 1024])
def test_padded_backward_equals_the_plain_version(d):
    q, k, v, mask, R, b_nd = _inputs(d, seed=1)
    dO = torch.randn(q.shape, generator=torch.Generator().manual_seed(2))
    kernel = StandIn()
    got = wa.padded_bwd(q, k, v, mask, R, b_nd, dO, True, kernel.bwd)
    expect = wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True)
    for name, a, b in zip(("dq", "dk", "dv", "dR", "db_nd"), got, expect):
        assert a.shape == b.shape and a.is_contiguous(), name
        assert (a - b).abs().max().item() <= TOL * (1 + b.abs().max().item()), name
    assert kernel.calls == [(wa.kernel_d(d), wa.attention_alpha(d, True))]


@pytest.mark.parametrize("d", [16, 96])
def test_operators_count_the_unpadded_work(d):
    """The operators see the caller's unpadded tensors (the padding is inside
    their CUDA implementations), so their FLOP formulas count what the plain
    version's aten products count at that d."""
    q, k, v, mask, R, b_nd = _inputs(d)
    meta = [x.to("meta") for x in (q, k, v, mask, R, b_nd)]
    with FlopCounterMode(display=False) as on_card:
        out = torch.ops.vpt_torch.windowed_attention_fwd(*meta, True)
        torch.ops.vpt_torch.windowed_attention_bwd(*meta, meta[0], True)
    assert out.shape == q.shape
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    with FlopCounterMode(display=False) as plain:
        wa.windowed_attention_fwd_plain(leaves[0], leaves[1], leaves[2], mask, R.requires_grad_(True),
                                        b_nd.requires_grad_(True), True).sum().backward()
    assert on_card.get_total_flops() == plain.get_total_flops() == sum(wa.attention_flops(q, k, R, b_nd))


def _numpy_inputs(d, seed, B=2, H=2, t=8, maxlen=8, nbasis=10):
    rng = np.random.default_rng(seed)
    T = t + maxlen
    q = rng.normal(size=(B, H, t, d)).astype(np.float32)
    k = rng.normal(size=(B, H, T, d)).astype(np.float32)
    v = rng.normal(size=(B, H, T, d)).astype(np.float32)
    R = rng.normal(size=(B, H, t, nbasis)).astype(np.float32)
    b_nd = rng.normal(size=(nbasis, maxlen)).astype(np.float32)
    mask = rng.random((B, t, T)) > 0.3
    mask[..., -1] = True
    mask[0, 0] = False  # a fully masked row: uniform weights
    dO = rng.normal(size=(B, H, t, d)).astype(np.float32)
    return q, k, v, mask, R, b_nd, dO


@pytest.mark.parametrize("d", [640, 1024])
@pytest.mark.parametrize("muP", [True, False])
def test_plain_versions_past_512_match_vpt_tpu(d, muP):
    """B1's and B2's plain versions at head dims that raised on the card
    before the streamed instance, against vpt_tpu's XLA attention (the path
    its Pallas gate leaves such a d on) and its VJP."""
    q, k, v, mask, R, b_nd, dO = _numpy_inputs(d, seed=d)
    T = k.shape[2]
    m = jnp.asarray(mask)

    def jax_fn(q_, k_, v_, R_, b_):
        return jax_attention(q_, k_, v_, m, jax_relattn_bias(R_, b_, T), muP)

    expect, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v, R, b_nd)))
    expect_grads = vjp(jnp.asarray(dO))
    tq, tk, tv, tmask, tR, tb, tdO = (torch.from_numpy(x) for x in (q, k, v, mask, R, b_nd, dO))
    got = wa.windowed_attention_fwd_plain(tq, tk, tv, tmask, tR, tb, muP)
    ref = np.asarray(expect)
    assert np.abs(got.numpy() - ref).max() <= TOL * (1 + np.abs(ref).max())
    grads = wa.windowed_attention_bwd_plain(tq, tk, tv, tmask, tR, tb, tdO, muP)
    for name, a, b in zip(("dq", "dk", "dv", "dR", "db_nd"), grads, expect_grads):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert np.abs(a.numpy() - b).max() <= TOL * (1 + np.abs(b).max()), name


# a one-block policy at d = 1024: tests/test_torch_training.py's tiny config but the width and the heads
POLICY_KWARGS = dict(
    hidsize=1024,
    impala_width=1,
    impala_chans=[4, 8],
    img_shape=[32, 32, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=1,
    timesteps=4,
    attention_heads=1,
    attention_memory_size=8,
    recurrence_type="transformer",
    attention_mask_style="clipped_causal",
    use_pre_lstm_ln=False,
    obs_processing_width=32,
)
PI_KWARGS = {"temperature": 2.0}
PB, PT = 2, 4


def _close(name, got, ref):
    ref = np.asarray(ref, np.float64).reshape(got.shape)
    err = np.abs(got.detach().numpy().astype(np.float64) - ref).max()
    assert err <= max(2e-6, 1e-4 * np.abs(ref).max()), (name, err, np.abs(ref).max())


def _scaled_normal_(tensor, gain=1.0, generator=None):
    """A stand-in for the heads' orthogonal init: the same scale without the
    QR of a (8641, 1024) matrix, seconds on the CPU (both sides get the
    port's draw, so what is drawn does not matter to the comparison)."""
    return torch.nn.init.normal_(tensor, std=gain / tensor.shape[1] ** 0.5, generator=generator)


def test_d1024_policy_matches_vpt_tpu(monkeypatch):
    """The chunked forward and one BC step of a hidsize-1024, 1-head policy,
    which vpt_tpu serves and trains (its attention runs XLA past the Pallas
    gate's widths) and the port runs through B1 and B2 on the card."""
    monkeypatch.setattr(torch.nn.init, "orthogonal_", _scaled_normal_)
    hp_kw = dict(batch_size=PB, chunk_len=PT)
    pt = bc.BCTrainer(POLICY_KWARGS, PI_KWARGS, hp=bc.BCHyperparams(**hp_kw), device="cpu", seed=0)
    pt.init()
    assert pt.policy.cfg.hidsize // pt.policy.cfg.attention_heads == 1024
    # the port's draw into vpt_tpu's trainer (its own jitted init takes most of a minute on the CPU)
    jt = jax_bc.BCTrainer(POLICY_KWARGS, PI_KWARGS, hp=jax_bc.BCHyperparams(**hp_kw),
                          mesh=make_mesh(n_dp=1, devices=jax.devices()[:1]), seed=0)
    state0 = jt.initial_state(PB)
    shapes = jax.eval_shape(jt.policy.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3), jnp.uint8),
                            jnp.zeros((1, 1), bool), jt.initial_state(1))
    variables, report = state_dict_to_variables({k: v.numpy() for k, v in pt.policy.state_dict().items()},
                                                variables=shapes)
    assert not any(report.values()), report
    variables = jax.tree.map(np.asarray, variables)

    rng = np.random.default_rng(7)
    batch = {"frames": rng.integers(0, 256, (PB, PT, 32, 32, 3), dtype=np.uint8),
             "buttons": rng.integers(0, 8641, (PB, PT)).astype(np.int32),
             "camera": rng.integers(0, 121, (PB, PT)).astype(np.int32),
             "firsts": np.array([[True, False, False, False], [True, False, True, False]]),
             "mask": np.ones((PB, PT), bool)}

    def loss_fn(params):  # vpt_tpu's BC loss, as tests/test_torch_training.py builds it, and the forward's outputs
        o, _ = jt.policy.apply({"params": params, "stats": variables["stats"]}, jnp.asarray(batch["frames"]),
                               jnp.asarray(batch["firsts"]), state0)
        actions = {"buttons": jnp.asarray(batch["buttons"])[..., None], "camera": jnp.asarray(batch["camera"])[..., None]}
        logp = jax_dict_logprob(o["pi_logits"], actions, jt.head_specs)
        return -(logp * jnp.asarray(batch["mask"], jnp.float32)).sum() / (PB * PT), o

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))

    # the chunked forward
    with torch.no_grad():
        tb = pt.to_device(batch)
        out, _ = pt.policy(tb["frames"], tb["firsts"], pt.initial_state(PB))
    for k_, v_ in out["pi_logits"].items():
        _close(k_, v_, jout["pi_logits"][k_])
    _close("vpred", out["vpred"], jout["vpred"])

    # one BC step's loss and gradients
    theirs = variables_to_state_dict({"params": jax.tree.map(np.asarray, jgrads), "stats": variables["stats"]})
    pt.policy.zero_grad(set_to_none=True)
    nll, _ = pt.masked_nll(pt.to_device(batch), pt.initial_state(PB))
    loss = nll / (PB * PT)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    checked = 0
    for name, p_ in pt.policy.named_parameters():
        if p_.grad is not None:
            _close(name, p_.grad, theirs[name])
            checked += 1
    assert checked == len(list(pt.trainable_parameters()))
