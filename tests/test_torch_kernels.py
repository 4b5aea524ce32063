"""Kernels B1 (csrc/windowed_attention_fwd.cu) and B2
(csrc/windowed_attention_bwd.cu) against their plain PyTorch versions on the
card.  These tests need CUDA and nvcc and skip elsewhere; the file imports
neither JAX nor vpt_tpu, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Every shape runs with mask and relative bias, with neither, and with the
bias alone (the inverse dynamics model's unmasked attention).

Tolerances.  B1: float32 rtol/atol 1e-4 (f32 sums in another order);
bfloat16 rtol/atol 3e-2 (the softmax weights and the output each round to
bf16, and a weight near a rounding boundary may round the other way).
B2, per gradient tensor, on max-abs error: float32 1e-4 * (1 + max|ref|)
(f32 sums over the keys or all rows in another order); bfloat16
3e-2 * (1 + max|ref|) (both sides compute in f32 from the same bf16 inputs
and round dq, dk, dv to bf16 once; an entry may round the other way)."""

import numpy as np
import pytest
import torch

from vpt_tpu_torch.ops import windowed_attention as wa
from vpt_tpu_torch.ops.masks import clipped_causal_mask


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1 and B2 have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (t, maxlen): the 2x chunk, the t=1 cache step, ragged sizes, T = 512; and
# the kernels' tile edges (64 query rows or keys a tile, 32 query rows in
# B2's key pass): one row past or short of a tile, a single row against 511
# keys of cache
SHAPES = [(128, 128), (1, 128), (37, 64), (128, 384), (63, 65), (65, 128), (1, 511)]
# the inverse dynamics model's attention: no mask, relative bias, 32 heads of
# d = 128, a 128-frame window after 128 cache keys, and an 8-frame window
# (T = 136, a key tile edge)
IDM_SHAPES = [(128, 128), (8, 128)]
# past the kernels' 512-key chunk: one key past it (T = 513), the IDM's long
# predict_actions call (512 frames after 128 state keys, T = 640), and three
# chunks with the longest band table (T = 1152)
LONG_SHAPES = [(1, 512), (512, 128), (640, 512)]
MASK_REL_CASES = [(True, True), (False, False), (True, False), (False, True)]


def _inputs(dev, B, H, t, maxlen, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    T = t + maxlen
    q = torch.randn((B, H, t, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, H, T, d), generator=g, device=dev).to(dtype)
    v = torch.randn((B, H, T, d), generator=g, device=dev).to(dtype)
    R = torch.randn((B, H, t, 10), generator=g, device=dev)
    b_nd = torch.randn((10, maxlen), generator=g, device=dev)
    rng = np.random.default_rng(seed)
    first = torch.from_numpy(rng.random((B, t)) < 4.0 / t).to(dev)
    state_mask = torch.from_numpy(rng.random((B, maxlen)) < 0.5).to(dev)
    mask, _ = clipped_causal_mask(first, state_mask, t, T, maxlen)
    return q, k, v, mask, R, b_nd


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192])
@pytest.mark.parametrize("t,maxlen", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask,use_rel,muP", [(True, True, True), (False, False, False), (False, True, True)])
def test_b1_kernel_matches_plain(cuda, d, t, maxlen, dtype, use_mask, use_rel, muP):
    q, k, v, mask, R, b_nd = _inputs(cuda, 2, 3, t, maxlen, d, getattr(torch, dtype), d + t)
    mask = mask if use_mask else None
    R, b_nd = (R, b_nd) if use_rel else (None, None)
    before = wa.launches
    got = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, muP)
    torch.cuda.synchronize()
    assert wa.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    expect = wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, muP)
    tol = 1e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), expect.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_b1_kernel_keeps_float32_accuracy_past_tf32(cuda):
    """q and k scaled by 8: the logits' products are large enough that one
    TF32 product (10-bit mantissa) misses the 1e-4 limit, as the plain
    version computed with TF32 shows; the kernel's split products meet it."""
    q, k, v, mask, R, b_nd = _inputs(cuda, 2, 4, 128, 128, 128, torch.float32, 11)
    q, k = 8 * q, 8 * k
    got = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
    expect = wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    assert (tf32 - expect).abs().max().item() > 1e-4
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_b1_kernel_fully_masked_row_is_uniform(cuda):
    q, k, v, mask, R, b_nd = _inputs(cuda, 1, 2, 8, 8, 64, torch.float32, 0)
    mask[:, 3] = False
    got = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
    torch.testing.assert_close(got[:, :, 3], v.mean(dim=2), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["head_dim", "band", "dtype", "contiguity", "alignment"])
def test_b1_kernel_rejects_what_it_does_not_cover(cuda, bad):
    q, k, v, mask, R, b_nd = _inputs(cuda, 1, 2, 8, 8, 64, torch.float32, 1)
    if bad == "head_dim":
        q = k = v = torch.zeros((1, 1, 4, 96), device=cuda)
        mask = R = b_nd = None
    elif bad == "band":  # the band table is held in shared memory whole: at most MAX_BAND offsets
        b_nd = torch.zeros((10, wa.MAX_BAND + 1), device=cuda)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "alignment":  # contiguous, but one float past a 16-byte boundary
        q = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape).copy_(q)
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)


def _b2_close(got, expect, dtype):
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for name, g, e in zip(("dq", "dk", "dv", "dR", "db_nd"), got, expect):
        if e is None:
            assert g is None, name
            continue
        assert g.dtype == e.dtype and g.shape == e.shape, name
        assert torch.isfinite(g).all(), name
        err = (g.float() - e.float()).abs().max().item()
        bound = tol * (1 + e.float().abs().max().item())
        assert err <= bound, (name, err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192])
@pytest.mark.parametrize("t,maxlen", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask,use_rel,muP", [(True, True, True), (False, False, False), (False, True, True)])
def test_b2_kernel_matches_plain(cuda, d, t, maxlen, dtype, use_mask, use_rel, muP):
    dtype = getattr(torch, dtype)
    q, k, v, mask, R, b_nd = _inputs(cuda, 2, 3, t, maxlen, d, dtype, d + t + 1)
    mask = mask if use_mask else None
    R, b_nd = (R, b_nd) if use_rel else (None, None)
    dO = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(t), device=cuda).to(dtype)
    before = wa.bwd_launches
    got = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, muP)
    torch.cuda.synchronize()
    assert wa.bwd_launches == before + 1
    _b2_close(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, muP), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("t,maxlen", IDM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["B1", "B2"])
def test_kernels_at_idm_shapes(cuda, t, maxlen, dtype, kernel):
    dtype = getattr(torch, dtype)
    q, k, v, _, R, b_nd = _inputs(cuda, 2, 32, t, maxlen, 128, dtype, t + 32)
    if kernel == "B1":
        got = wa.windowed_attention_fwd(q, k, v, None, R, b_nd, True)
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        torch.testing.assert_close(got.float(), wa.windowed_attention_fwd_plain(q, k, v, None, R, b_nd, True).float(),
                                   rtol=tol, atol=tol)
    else:
        dO = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(t), device=cuda).to(dtype)
        got = wa.windowed_attention_bwd(q, k, v, None, R, b_nd, dO, True)
        _b2_close(got, wa.windowed_attention_bwd_plain(q, k, v, None, R, b_nd, dO, True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192])
@pytest.mark.parametrize("t,maxlen", LONG_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask,use_rel", MASK_REL_CASES)
@pytest.mark.parametrize("kernel", ["B1", "B2"])
def test_kernels_past_key_chunk(cuda, d, t, maxlen, dtype, use_mask, use_rel, kernel):
    """T > 512: the keys go through the kernels in chunks of 512, with no
    routing to the plain version."""
    dtype = getattr(torch, dtype)
    q, k, v, mask, R, b_nd = _inputs(cuda, 2, 3, t, maxlen, d, dtype, d + t + 2)
    assert k.shape[2] > wa.KEY_CHUNK
    mask = mask if use_mask else None
    R, b_nd = (R, b_nd) if use_rel else (None, None)
    before = wa.launches, wa.bwd_launches
    if kernel == "B1":
        got = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
        torch.cuda.synchronize()
        assert (wa.launches, wa.bwd_launches) == (before[0] + 1, before[1])
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        torch.testing.assert_close(got.float(), wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True).float(),
                                   rtol=tol, atol=tol)
    else:
        dO = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(t), device=cuda).to(dtype)
        got = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
        torch.cuda.synchronize()
        assert (wa.launches, wa.bwd_launches) == (before[0], before[1] + 1)
        _b2_close(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True), dtype)


@pytest.mark.cuda
def test_kernels_fully_masked_rows_past_key_chunk(cuda):
    """A fully masked row over 1152 keys: uniform weights over all of them in
    B1, and B2's gradients as the plain backward's."""
    q, k, v, mask, R, b_nd = _inputs(cuda, 1, 2, 640, 512, 64, torch.float32, 3)
    mask[:, 3] = False
    mask[:, 600] = False
    got = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
    torch.testing.assert_close(got[:, :, 3], v.mean(dim=2), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True), rtol=1e-4, atol=1e-4)
    dO = torch.randn_like(q)
    got = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
    _b2_close(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True), torch.float32)


@pytest.mark.cuda
def test_b2_kernel_fully_masked_row(cuda):
    q, k, v, mask, R, b_nd = _inputs(cuda, 1, 2, 40, 8, 64, torch.float32, 2)
    mask[:, 3] = False
    mask[:, 35] = False
    dO = torch.randn_like(q)
    got = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
    _b2_close(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True), torch.float32)


@pytest.mark.cuda
def test_b2_kernel_keeps_float32_accuracy_past_tf32(cuda):
    """All five gradients at float32 accuracy with q and k scaled by 8 (see
    the B1 case above)."""
    q, k, v, mask, R, b_nd = _inputs(cuda, 2, 4, 128, 128, 128, torch.float32, 12)
    q, k = 8 * q, 8 * k
    dO = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(12), device=cuda)
    got = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
    _b2_close(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b2_kernel_bias_grads_are_deterministic(cuda, dtype):
    """d b_nd is summed over blocks in a fixed order, and dR within a row:
    two calls on the same inputs agree bit for bit."""
    q, k, v, mask, R, b_nd = _inputs(cuda, 4, 16, 128, 128, 128, getattr(torch, dtype), 13)
    dO = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(13), device=cuda).to(q.dtype)
    first = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
    second = wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
    torch.cuda.synchronize()
    assert torch.equal(first[4], second[4]) and torch.equal(first[3], second[3])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_autograd_through_kernels_matches_plain_forward(cuda, d):
    """windowed_attention_fwd under autograd on CUDA (B1 forward, B2
    backward) gives the plain forward's gradients in all five inputs."""
    q, k, v, mask, R, b_nd = _inputs(cuda, 2, 4, 64, 64, d, torch.float32, 5)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, R, b_nd)]
    g = torch.randn_like(q)
    f0, b0 = wa.launches, wa.bwd_launches
    out = wa.windowed_attention_fwd(leaves[0], leaves[1], leaves[2], mask, leaves[3], leaves[4], True)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (wa.launches, wa.bwd_launches) == (f0 + 1, b0 + 1)
    out = wa.windowed_attention_fwd_plain(leaves[0], leaves[1], leaves[2], mask, leaves[3], leaves[4], True)
    expect = torch.autograd.grad(out, leaves, g)
    _b2_close(got, expect, torch.float32)


@pytest.mark.cuda
def test_no_grad_launches_b1_alone(cuda):
    q, k, v, mask, R, b_nd = _inputs(cuda, 1, 2, 8, 8, 64, torch.float32, 6)
    q.requires_grad_(True)
    f0, b0 = wa.launches, wa.bwd_launches
    with torch.no_grad():
        out = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
    assert out.grad_fn is None and (wa.launches, wa.bwd_launches) == (f0 + 1, b0)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity"])
def test_b2_kernel_rejects_bad_output_grad(cuda, bad):
    q, k, v, mask, R, b_nd = _inputs(cuda, 1, 2, 8, 8, 64, torch.float32, 7)
    dO = torch.randn_like(q)
    if bad == "shape":
        dO = dO[:, :, :4].contiguous()
    elif bad == "dtype":
        dO = dO.bfloat16()
    else:
        dO = dO.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True)
