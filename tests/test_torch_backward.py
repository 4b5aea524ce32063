"""Kernel B2's plain version (``windowed_attention_bwd_plain``) against the
JAX package's backward, and the CPU autograd of kernel B1's wrapper against
it.

  * against ``jax.vjp`` of ``pallas_attention_impl.dispatch(..., require=True)``
    with ``INTERPRET = True`` (the Pallas backward kernel and the XLA einsums
    of ``_bwd``), at d = 128, all five gradients, with and without mask and
    relative bias, muP on and off, with fully masked rows: rtol 2e-4,
    atol 2e-5 (float32 sums in another order);
  * at d = 64 (below the Pallas gate) against ``jax.grad`` of
    ``vpt_tpu.ops.attention.windowed_attention`` + ``relattn_bias``: the same
    tolerance;
  * in bfloat16 against the Pallas backward's bfloat16 gradients: rtol and
    atol 2e-2 (both sides compute in float32 from the same bf16 inputs and
    round dq, dk, dv to bf16 once; an entry may round the other way);
  * ``windowed_attention_fwd`` under CPU autograd against the plain backward:
    rtol 2e-4, atol 2e-5.
The CUDA kernel itself is held against the plain version in
tests/test_torch_kernels.py, which needs a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.ops import pallas_attention_impl as impl
from vpt_tpu.ops.attention import windowed_attention as jax_attention
from vpt_tpu.ops.rel_bias import relattn_bias as jax_relattn_bias
from vpt_tpu_torch.ops import windowed_attention as wa

RTOL, ATOL = 2e-4, 2e-5
NAMES = ("dq", "dk", "dv", "dR", "db_nd")


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


@pytest.fixture
def interpret_mode():
    old = impl.INTERPRET
    impl.INTERPRET = True
    yield
    impl.INTERPRET = old


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _inputs(B=2, H=2, t=16, maxlen=16, d=128, nbasis=10, seed=0):
    rng = np.random.default_rng(seed)
    T = t + maxlen
    q = rng.normal(size=(B, H, t, d)).astype(np.float32)
    k = rng.normal(size=(B, H, T, d)).astype(np.float32)
    v = rng.normal(size=(B, H, T, d)).astype(np.float32)
    R = rng.normal(size=(B, H, t, nbasis)).astype(np.float32)
    b_nd = rng.normal(size=(nbasis, maxlen)).astype(np.float32)
    mask = rng.random((B, t, T)) > 0.3
    mask[..., -1] = True
    mask[0, 0] = False  # fully masked rows: uniform weights, finite gradients
    mask[1, t - 1] = False
    dO = rng.normal(size=(B, H, t, d)).astype(np.float32)
    return q, k, v, mask, R, b_nd, dO


def _jax_grads(fn, q, k, v, R, b_nd, dO):
    """VJP of fn(q, k, v, R, b_nd) → (dq, dk, dv, dR, db_nd), None for absent inputs."""
    args = [jnp.asarray(x) for x in (q, k, v)]
    if R is not None:
        args += [jnp.asarray(R), jnp.asarray(b_nd)]
    out, vjp = jax.vjp(fn, *args)
    grads = list(vjp(jnp.asarray(dO).astype(out.dtype)))
    return grads + [None] * (5 - len(grads))


def _assert_grads(got, expect, rtol=RTOL, atol=ATOL):
    for name, g, e in zip(NAMES, got, expect):
        if e is None:
            assert g is None, name
            continue
        assert torch.isfinite(g.float()).all(), name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(e, np.float32), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("use_mask,use_rel,muP", [
    (True, True, True), (True, True, False), (False, True, True), (True, False, True), (False, False, False),
])
def test_plain_b2_matches_pallas_backward(interpret_mode, use_mask, use_rel, muP):
    q, k, v, mask, R, b_nd, dO = _inputs(seed=int(use_mask) + 2 * int(use_rel) + 4 * int(muP))
    mask = mask if use_mask else None
    R, b_nd = (R, b_nd) if use_rel else (None, None)
    jmask = None if mask is None else jnp.asarray(mask)

    def fn(q, k, v, R=None, b_nd=None):
        return impl.dispatch(q, k, v, jmask, R, b_nd, muP, require=True)

    expect = _jax_grads(fn, q, k, v, R, b_nd, dO)
    got = wa.windowed_attention_bwd_plain(*(_t(x) for x in (q, k, v, mask, R, b_nd, dO)), muP)
    _assert_grads(got, expect)


@pytest.mark.parametrize("use_mask,use_rel", [(True, True), (False, True), (True, False)])
def test_plain_b2_matches_xla_grad_at_d64(use_mask, use_rel):
    q, k, v, mask, R, b_nd, dO = _inputs(t=8, maxlen=12, d=64, seed=20 + int(use_mask) + 2 * int(use_rel))
    mask = mask if use_mask else None
    R, b_nd = (R, b_nd) if use_rel else (None, None)
    jmask = None if mask is None else jnp.asarray(mask)

    def fn(q, k, v, R=None, b_nd=None):
        extra = jax_relattn_bias(R, b_nd, k.shape[2]) if R is not None else None
        return jax_attention(q, k, v, jmask, extra, True)

    expect = _jax_grads(fn, q, k, v, R, b_nd, dO)
    # the wrapper on CPU tensors is the plain version
    got = wa.windowed_attention_bwd(*(_t(x) for x in (q, k, v, mask, R, b_nd, dO)), True)
    _assert_grads(got, expect)


def test_plain_b2_bf16_matches_pallas_backward(interpret_mode):
    q, k, v, mask, R, b_nd, dO = _inputs(seed=31)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v, dO)]
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in bf)

    def fn(q, k, v, R, b_nd):
        return impl.dispatch(q, k, v, jnp.asarray(mask), R, b_nd, True, require=True)

    out, vjp = jax.vjp(fn, jq, jk, jv, jnp.asarray(R), jnp.asarray(b_nd))
    expect = [None if g is None else np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    got = wa.windowed_attention_bwd_plain(bf[0], bf[1], bf[2], _t(mask), _t(R), _t(b_nd), bf[3], True)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    _assert_grads(got, expect, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("use_rel", [True, False])
def test_cpu_autograd_through_wrapper_equals_plain_backward(use_rel):
    q, k, v, mask, R, b_nd, dO = _inputs(t=5, maxlen=7, d=64, seed=40 + int(use_rel))
    R, b_nd = (R, b_nd) if use_rel else (None, None)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v, R, b_nd) if x is not None]
    if use_rel:
        out = wa.windowed_attention_fwd(leaves[0], leaves[1], leaves[2], _t(mask), leaves[3], leaves[4], True)
    else:
        out = wa.windowed_attention_fwd(leaves[0], leaves[1], leaves[2], _t(mask), None, None, True)
    auto = list(torch.autograd.grad(out, leaves, _t(dO))) + [None] * (5 - len(leaves))
    before = (wa.launches, wa.bwd_launches)
    got = wa.windowed_attention_bwd(*(_t(x) for x in (q, k, v, mask, R, b_nd, dO)), True)
    assert (wa.launches, wa.bwd_launches) == before  # the CPU path launches no kernel
    _assert_grads(got, [None if a is None else a.numpy() for a in auto])


def test_bwd_wrapper_never_falls_back_off_the_cpu():
    q = torch.empty((1, 1, 4, 64), device="meta")
    k = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        wa.windowed_attention_bwd(q, k, k, None, None, None, q, True)
