"""Attention ops of the PyTorch port against vpt_tpu: masks, the banded
relative bias, the plain windowed attention, and kernel B1's wrapper.

On the CPU the B1 wrapper runs its plain version; it is held against the
XLA oracle (``windowed_attention`` + ``relattn_bias``) and against the Pallas
forward in interpret mode, at rtol 2e-4 / atol 2e-5 (float32 sums in another
order).  The CUDA kernel itself is held against the plain version in
tests/test_torch_kernels.py, which needs a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.ops import masks as jax_masks
from vpt_tpu.ops import pallas_attention_impl as impl
from vpt_tpu.ops.attention import merge_heads as jax_merge_heads
from vpt_tpu.ops.attention import split_heads as jax_split_heads
from vpt_tpu.ops.attention import windowed_attention as jax_attention
from vpt_tpu.ops.rel_bias import banded_bias_matrix as jax_banded
from vpt_tpu.ops.rel_bias import relattn_bias as jax_relattn_bias
from vpt_tpu_torch.ops import windowed_attention as wa
from vpt_tpu_torch.ops.attention import merge_heads, split_heads
from vpt_tpu_torch.ops.masks import band_diagonal_mask, clipped_causal_mask, initial_state_mask
from vpt_tpu_torch.ops.rel_bias import banded_bias_matrix, relattn_bias

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def interpret_mode():
    old = impl.INTERPRET
    impl.INTERPRET = True
    yield
    impl.INTERPRET = old


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(B=2, H=2, t=16, maxlen=16, d=128, nbasis=5, seed=0):
    rng = np.random.default_rng(seed)
    T = t + maxlen
    q = rng.normal(size=(B, H, t, d)).astype(np.float32)
    k = rng.normal(size=(B, H, T, d)).astype(np.float32)
    v = rng.normal(size=(B, H, T, d)).astype(np.float32)
    R = rng.normal(size=(B, H, t, nbasis)).astype(np.float32)
    b_nd = rng.normal(size=(nbasis, maxlen)).astype(np.float32)
    mask = rng.random((B, t, T)) > 0.3
    mask[..., -1] = True
    mask[0, 0] = False  # one fully masked row: uniform weights on both sides
    return q, k, v, R, b_nd, mask


@pytest.mark.parametrize("t,T,maxlen", [(4, 12, 8), (8, 8, 4), (1, 9, 8), (5, 5, None)])
def test_band_diagonal_mask(t, T, maxlen):
    np.testing.assert_array_equal(
        band_diagonal_mask(t, T, maxlen).numpy(), np.asarray(jax_masks.band_diagonal_mask(t, T, maxlen)))


@pytest.mark.parametrize("t,maxlen,per_step", [(4, 8, True), (4, 8, False), (8, 4, True), (1, 8, True)])
def test_clipped_causal_mask(t, maxlen, per_step):
    rng = np.random.default_rng(t * 10 + maxlen)
    B = 3
    first = rng.random((B, t)) < 0.3 if per_step else rng.random(B) < 0.5
    state_mask = rng.random((B, maxlen)) < 0.7
    m, s = clipped_causal_mask(_t(first), _t(state_mask), t, t + maxlen, maxlen)
    jm, js = jax_masks.clipped_causal_mask(jnp.asarray(first), jnp.asarray(state_mask), t, t + maxlen, maxlen)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(initial_state_mask(B, maxlen).numpy(),
                                  np.asarray(jax_masks.initial_state_mask(B, maxlen)))


@pytest.mark.parametrize("t,T", [(4, 12), (1, 9), (16, 32)])
def test_rel_bias(t, T):
    rng = np.random.default_rng(T)
    b_nd = rng.normal(size=(10, T - t)).astype(np.float32)
    R = rng.normal(size=(2, 3, t, 10)).astype(np.float32)
    np.testing.assert_array_equal(banded_bias_matrix(_t(b_nd), t, T).numpy(),
                                  np.asarray(jax_banded(jnp.asarray(b_nd), t, T)))
    np.testing.assert_allclose(relattn_bias(_t(R), _t(b_nd), T).numpy(),
                               np.asarray(jax_relattn_bias(jnp.asarray(R), jnp.asarray(b_nd), T)),
                               rtol=RTOL, atol=ATOL)


def test_split_merge_heads_head_major():
    x = np.random.default_rng(0).normal(size=(2, 5, 12)).astype(np.float32)
    np.testing.assert_array_equal(split_heads(_t(x), 3).numpy(), np.asarray(jax_split_heads(jnp.asarray(x), 3)))
    h = np.asarray(jax_split_heads(jnp.asarray(x), 3))
    np.testing.assert_array_equal(merge_heads(_t(h)).numpy(), np.asarray(jax_merge_heads(jnp.asarray(h))))


@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("use_rel", [True, False])
@pytest.mark.parametrize("muP", [True, False])
def test_plain_attention_matches_xla(use_mask, use_rel, muP):
    q, k, v, R, b_nd, mask = _inputs(d=64, seed=int(use_mask) + 2 * int(use_rel) + 4 * int(muP))
    mask = mask if use_mask else None
    R, b_nd = (R, b_nd) if use_rel else (None, None)
    got = wa.windowed_attention_fwd(_t(q), _t(k), _t(v), None if mask is None else _t(mask),
                                    None if R is None else _t(R), None if b_nd is None else _t(b_nd), muP)
    extra = jax_relattn_bias(jnp.asarray(R), jnp.asarray(b_nd), k.shape[2]) if use_rel else None
    expect = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           None if mask is None else jnp.asarray(mask), extra, muP)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_mask,use_rel,muP", [(True, True, True), (False, False, True), (True, True, False)])
def test_plain_b1_matches_pallas_interpret(interpret_mode, use_mask, use_rel, muP):
    q, k, v, R, b_nd, mask = _inputs(seed=7)
    mask = mask if use_mask else None
    R, b_nd = (R, b_nd) if use_rel else (None, None)
    expect = impl.dispatch(*(None if x is None else jnp.asarray(x) for x in (q, k, v, mask, R, b_nd)), muP,
                           require=True)
    got = wa.windowed_attention_fwd_plain(*(None if x is None else _t(x) for x in (q, k, v, mask, R, b_nd)), muP)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=RTOL, atol=ATOL)


def test_plain_attention_bf16_matches_xla():
    q, k, v, R, b_nd, mask = _inputs(d=64, seed=11)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    got = wa.windowed_attention_fwd(*bf, _t(mask), _t(R), _t(b_nd), True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in bf)
    expect = jax_attention(jq, jk, jv, jnp.asarray(mask),
                           jax_relattn_bias(jnp.asarray(R), jnp.asarray(b_nd), k.shape[2]), True)
    # one bf16 rounding of W and of the output apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect.astype(jnp.float32)), rtol=2e-2, atol=2e-2)


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor neither on the CPU nor on CUDA raises instead of taking the
    plain path, and the launch counter does not move."""
    before = wa.launches
    q = torch.empty((1, 1, 4, 64), device="meta")
    k = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        wa.windowed_attention_fwd(q, k, k, None, None, None, True)
    assert wa.launches == before
