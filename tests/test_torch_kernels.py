"""Kernels B1 (csrc/windowed_attention_fwd.cu) and B2
(csrc/windowed_attention_bwd.cu) against their plain PyTorch versions, and
kernel C1 (csrc/conv3x3_fwd.cu) against float64 and cuDNN, on the
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

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vpt_tpu_torch.ops import conv
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
@pytest.mark.parametrize("d", [64, 128, 192, 256])
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
@pytest.mark.parametrize("bad", ["head_dim", "dtype", "contiguity", "alignment"])
def test_b1_kernel_rejects_what_it_does_not_cover(cuda, bad):
    """What the kernels do not take raises on CUDA, and nothing is routed
    elsewhere; a band table of any length is taken
    (test_kernels_take_the_wide_shapes)."""
    q, k, v, mask, R, b_nd = _inputs(cuda, 1, 2, 8, 8, 64, torch.float32, 1)
    if bad == "head_dim":  # every d is taken, but k's head dim must be q's
        k = torch.zeros(k.shape[:-1] + (128,), device=cuda)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "alignment":  # contiguous, but one float past a 16-byte boundary
        q = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape).copy_(q)
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)


# the shapes past the published models' that vpt_tpu's Pallas kernel takes
# too: hidsize 4096 at 16 heads' d = 256, a band table of 640 offsets
# (attention_memory_size - timesteps > 512, read from device memory), both
WIDE = [(256, 8), (64, 640), (256, 640)]


@pytest.mark.parametrize("d,bandsize", [(16, 8), (96, 8), (384, 8), (512, 8), (576, 8), (64, 8), (128, 512),
                                        (192, 1), (1024, 8), (4096, 8)] + WIDE)
def test_kernels_take_the_supported_head_dims_and_any_band(d, bandsize):
    """The check the wrappers make before a launch: any head dim (multiples
    of 64 whole, the rest zero-padded to the next; past 512 too, as
    vpt_tpu's attention takes them) and a band table of any length."""
    q, k, v = torch.zeros((1, 2, 4, d)), torch.zeros((1, 2, 12, d)), torch.zeros((1, 2, 12, d))
    R, b_nd = torch.zeros((1, 2, 4, 10)), torch.zeros((10, bandsize))
    wa._check(q, k, v, None, R, b_nd)


@pytest.mark.parametrize("d,bandsize", [(16, 8)] + WIDE)
def test_cpu_runs_every_shape_plain_and_uncounted(d, bandsize):
    """On the CPU every shape runs the plain version (the device decides,
    not the shape), the ones the kernels do not take included, and no
    launch is counted."""
    q, k, v, mask, R, _ = _inputs(torch.device("cpu"), 1, 2, 8, 8, d, torch.float32, 2)
    b_nd = torch.randn((10, bandsize), generator=torch.Generator().manual_seed(3))
    q.requires_grad_(True)
    counts = (wa.launches, wa.bwd_launches)
    out = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
    out.sum().backward()
    torch.testing.assert_close(out, wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True), rtol=0, atol=0)
    assert (wa.launches, wa.bwd_launches) == counts


@pytest.mark.cuda
@pytest.mark.parametrize("d,bandsize", WIDE)
@pytest.mark.parametrize("t", [8, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_take_the_wide_shapes(cuda, d, bandsize, t, dtype):
    """d = 256 and a 640-wide band table go through B1 and B2 (forward and
    autograd), against the plain version; with the band, T = t + 640 > 512,
    so the keys go in chunks too."""
    dtype = getattr(torch, dtype)
    q, k, v, mask, R, b_nd = _inputs(cuda, 2, 2, t, bandsize, d, dtype, d + bandsize + t)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, R, b_nd)]
    counts = (wa.launches, wa.bwd_launches)
    out = wa.windowed_attention_fwd(leaves[0], leaves[1], leaves[2], mask, leaves[3], leaves[4], True)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (wa.launches, wa.bwd_launches) == (counts[0] + 1, counts[1] + 1)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    plain = [x.clone().requires_grad_(True) for x in (q, k, v, R, b_nd)]
    expect_out = wa.windowed_attention_fwd_plain(plain[0], plain[1], plain[2], mask, plain[3], plain[4], True)
    torch.testing.assert_close(out.float(), expect_out.float(), rtol=tol, atol=tol)
    _b2_close(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, g.contiguous(), True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 96, 320, 384, 448, 512, 576, 640, 1024, 2048, 4096])
@pytest.mark.parametrize("t,maxlen", [(128, 128), (37, 64), (512, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_take_padded_and_wide_head_dims(cuda, d, t, maxlen, dtype):
    """Head dims that are no multiple of 64 (zero-padded to the next) and
    the multiples past 256 (the streamed instance: Q, K, V and dO 64
    columns at a time, shared memory the same at every d, accumulators past
    512 keys and past one query tile of B2's key pass in an f32 scratch) go
    through B1 and B2, forward and autograd, with mask and bias, past 512
    keys too."""
    dtype = getattr(torch, dtype)
    q, k, v, mask, R, b_nd = _inputs(cuda, 2, 2, t, maxlen, d, dtype, d + t)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, R, b_nd)]
    counts = (wa.launches, wa.bwd_launches)
    out = wa.windowed_attention_fwd(leaves[0], leaves[1], leaves[2], mask, leaves[3], leaves[4], True)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(6), device=cuda).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (wa.launches, wa.bwd_launches) == (counts[0] + 1, counts[1] + 1)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    expect = wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True)
    torch.testing.assert_close(out.float(), expect.float(), rtol=tol, atol=tol)
    _b2_close(got, wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, g.contiguous(), True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b1_b2_take_a_band_wider_than_the_keys(cuda, dtype):
    """A 640-wide band table at T = 256 keys (no chunks): the ≤ 512-key
    kernels read it from device memory."""
    dtype = getattr(torch, dtype)
    q, k, v, mask, R, _ = _inputs(cuda, 2, 4, 128, 128, 128, dtype, 11)
    b_nd = torch.randn((10, 640), generator=torch.Generator(device=cuda).manual_seed(12), device=cuda)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True).float(),
                               wa.windowed_attention_fwd_plain(q, k, v, mask, R, b_nd, True).float(),
                               rtol=tol, atol=tol)
    dO = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(13), device=cuda).to(dtype)
    _b2_close(wa.windowed_attention_bwd(q, k, v, mask, R, b_nd, dO, True),
              wa.windowed_attention_bwd_plain(q, k, v, mask, R, b_nd, dO, True), dtype)


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
@pytest.mark.parametrize("d", [64, 128, 192, 256])
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
@pytest.mark.parametrize("d", [64, 128, 192, 256])
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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [256, 640])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_instance_shared_memory_does_not_depend_on_d(cuda, T, dtype):
    """Every head dim past 256 runs the one streamed instance: its launches
    (B1, B2's two passes) take the same shared memory at d = 320 and 4096."""
    dtype = getattr(torch, dtype)
    at_320 = wa.launch_smem_bytes(T, 320, 10, 128, dtype)
    assert at_320 == wa.launch_smem_bytes(T, 4096, 10, 128, dtype)
    assert all(0 < n <= 232448 for n in at_320.values()), at_320


# Kernel C1 (ops/conv.py, csrc/conv3x3_fwd.cu), the f32 3x3 convolutions of
# the cells' Impala CNNs: (C_in, C_out, H = W) of the 4x IDM, the 2x and the
# 3x policy, at N = 2 frames.  C1 runs three TF32 products a multiply, so
# its error against float64 is held to that of cuDNN's f32 (TF32 off): at
# most twice it, and under a tenth of TF32's.
C1_SHAPES = [(128, 256, 128), (256, 256, 64), (256, 512, 64), (512, 512, 32), (512, 512, 16),
             (128, 128, 64), (128, 256, 64), (256, 256, 32), (256, 256, 16),
             (192, 192, 64), (192, 384, 64), (384, 384, 32), (384, 384, 16)]


def _conv_inputs(dev, n, c, k, hw, seed, bias=False, w_hw=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn((n, c, hw, w_hw or hw), generator=g, device=dev))
    w = torch.randn((k, c, 3, 3), generator=g, device=dev) / (3 * c ** 0.5)
    b = torch.randn((k,), generator=g, device=dev) if bias else None
    return x, w, b


@pytest.fixture
def cudnn_f32():
    """cuDNN's f32 convolutions with TF32 off, as the port runs f32."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


def _max_err(y, ref):
    return (y.double() - ref).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,hw", C1_SHAPES)
@pytest.mark.parametrize("bias", [False, True])
def test_c1_keeps_float32_accuracy_at_the_main_path_shapes(cuda, cudnn_f32, c, k, hw, bias):
    x, w, b = _conv_inputs(cuda, 2, c, k, hw, 0, bias)
    ref = torch.relu(F.conv2d(x.double(), w.double(), None if b is None else b.double(), padding=1))
    launches = conv.launches
    got = conv.conv3x3_fwd(x, w, b)
    assert conv.launches == launches + 1
    cudnn = torch.relu(F.conv2d(x, w, b, padding=1))
    torch.backends.cudnn.allow_tf32 = True
    tf32 = torch.relu(F.conv2d(x, w, b, padding=1))
    again = conv.conv3x3_fwd(x, w, b)  # nothing depends on the TF32 flag, and two calls agree bit for bit
    torch.backends.cudnn.allow_tf32 = False
    e_c1, e_cudnn, e_tf32 = _max_err(got, ref), _max_err(cudnn, ref), _max_err(tf32, ref)
    assert e_c1 <= 2 * e_cudnn and e_c1 < 0.1 * e_tf32, (e_c1, e_cudnn, e_tf32)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,hw", C1_SHAPES)
def test_c1_gradients_equal_cudnns_conv_then_relu(cuda, cudnn_f32, c, k, hw):
    """The Function's gradients against autograd of F.relu(F.conv2d(...)):
    its backward is the same cuDNN dgrad and wgrad on the gradient masked by
    the ReLU's output.  An output that rounds to the other sign of zero on
    C1 and cuDNN flips one ReLU decision; those positions take C1's decision
    on both sides (and must lie within rounding of zero)."""
    x, w, b = _conv_inputs(cuda, 2, c, k, hw, 1, bias=True)
    dy = torch.randn((2, k, hw, hw), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    out = conv.conv3x3_fwd(xs, ws, bs)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * dy).sum(), (xs, ws, bs))
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    pre = F.conv2d(xr, wr, br, padding=1)
    flips = (pre > 0) != (out > 0)
    if flips.any():
        assert pre.detach()[flips].abs().max().item() < 1e-5
    want = torch.autograd.grad((pre * (out > 0) * dy).sum(), (xr, wr, br))
    for g_got, g_want in zip(got, want):
        scale = g_want.abs().max().item()
        assert _max_err(g_got, g_want.double()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,h,w_", [(20, 40, 12, 12), (8, 70, 20, 20), (24, 100, 36, 20), (16, 32, 9, 4),
                                      (32, 200, 5, 256)])
@pytest.mark.parametrize("bias,relu", [(False, True), (True, False)])
def test_c1_takes_ragged_shapes(cuda, cudnn_f32, c, k, h, w_, bias, relu):
    """Channels that fill no whole chunk or tile, images that fill no whole
    pixel tile, the narrowest and widest rows: against float64 within
    1e-5 of the output's scale (the main path's error is ~1e-6 of it)."""
    x, w, b = _conv_inputs(cuda, 3, c, k, h, 3, bias, w_hw=w_)
    ref = F.conv2d(x.double(), w.double(), None if b is None else b.double(), padding=1)
    ref = torch.relu(ref) if relu else ref
    got = conv.conv3x3_fwd(x, w, b, relu)
    assert _max_err(got, ref) <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["bfloat16", "kernel", "width", "channels", "weight_device", "bias_shape"])
def test_c1_rejects_what_it_does_not_take(cuda, bad):
    x, w, b = _conv_inputs(cuda, 2, 16, 16, 8, 4, bias=True)
    if bad == "bfloat16":
        x = x.bfloat16()
    elif bad == "kernel":
        w = torch.randn((16, 16, 5, 5), device=cuda)
    elif bad == "width":
        x = x[..., :6]
    elif bad == "channels":
        x, w = x[:, :4], w[:, :4]
    elif bad == "weight_device":
        w = w.cpu()
    else:
        b = b[:8]
    with pytest.raises((ValueError, TypeError)):
        conv.conv3x3_fwd(x, w, b)
