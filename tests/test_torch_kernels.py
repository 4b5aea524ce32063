"""Kernel B1 (csrc/windowed_attention_fwd.cu) against its plain PyTorch
version on the card.  These tests need CUDA and nvcc and skip elsewhere;
the file imports neither JAX nor vpt_tpu, so on a machine with a card it
runs without the suite's conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tolerance: float32 rtol/atol 1e-4 (f32 sums in another order); bfloat16
rtol/atol 3e-2 (the softmax weights and the output each round to bf16, and
a weight near a rounding boundary may round the other way)."""

import numpy as np
import pytest
import torch

from vpt_tpu_torch.ops import windowed_attention as wa
from vpt_tpu_torch.ops.masks import clipped_causal_mask


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B1 has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
@pytest.mark.parametrize("t,maxlen", [(128, 128), (1, 128), (37, 64), (128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask,use_rel,muP", [(True, True, True), (False, False, False)])
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
def test_b1_kernel_fully_masked_row_is_uniform(cuda):
    q, k, v, mask, R, b_nd = _inputs(cuda, 1, 2, 8, 8, 64, torch.float32, 0)
    mask[:, 3] = False
    got = wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
    torch.testing.assert_close(got[:, :, 3], v.mean(dim=2), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["head_dim", "keys", "dtype", "contiguity"])
def test_b1_kernel_rejects_what_it_does_not_cover(cuda, bad):
    q, k, v, mask, R, b_nd = _inputs(cuda, 1, 2, 8, 8, 64, torch.float32, 1)
    if bad == "head_dim":
        q = k = v = torch.zeros((1, 1, 4, 96), device=cuda)
        mask = R = b_nd = None
    elif bad == "keys":
        k = v = torch.zeros((1, 2, 600, 64), device=cuda)
        mask = R = b_nd = None
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        wa.windowed_attention_fwd(q, k, v, mask, R, b_nd, True)
