"""The port's frame preparation against vpt_tpu's, on the CPU:
``resize_bilinear`` (the device resize, tensor ops) against
``resize_bilinear_jnp`` within 1e-3 on the 0-255 scale (float32 products and
sums in the same order) and within 1.0 of the cv2-exact ``resize_uint8_exact``
(as tests/test_agent.py holds the JAX one); the native host resize
(csrc/host_resize.cpp) bit-equal to the port's and vpt_tpu's
``resize_uint8_exact`` over a seeded fuzz of sizes."""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import numpy as np
import pytest
import torch

from vpt_tpu.ops.resize import resize_bilinear_jnp
from vpt_tpu.ops.resize import resize_uint8_exact as jax_resize_uint8_exact
from vpt_tpu_torch.ops import host_resize
from vpt_tpu_torch.ops.resize import resize_bilinear, resize_uint8_exact

CASES = [((360, 640, 3), (128, 128)), ((2, 3, 24, 32, 3), (20, 12)), ((9, 7, 3), (23, 17))]


@pytest.mark.parametrize("shape,size", CASES, ids=["640x360-to-128", "batched", "upscale"])
def test_resize_bilinear_matches_vpt_tpu(shape, size):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = resize_bilinear(torch.from_numpy(img), size)
    expect = np.asarray(resize_bilinear_jnp(img, size))
    w, h = size
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-3] + (h, w, shape[-1])
    assert np.abs(got.numpy() - expect).max() <= 1e-3


@pytest.mark.parametrize("shape,size", CASES, ids=["640x360-to-128", "batched", "upscale"])
def test_resize_bilinear_within_one_step_of_exact(shape, size):
    img = np.random.default_rng(1 + sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = resize_bilinear(torch.from_numpy(img).float(), size).numpy()
    flat = img.reshape((-1,) + shape[-3:])
    exact = np.stack([resize_uint8_exact(f, size) for f in flat]).reshape(got.shape)
    assert np.abs(got - exact).max() <= 1.0


def test_native_backend_builds_here():
    assert host_resize.backend() == "native", host_resize.load_error()
    assert host_resize.library_path().exists()


def test_native_resize_is_bit_equal_to_the_exact_resizes():
    rng = np.random.default_rng(7)
    sizes = [((360, 640), (128, 128))]
    for _ in range(24):
        src = tuple(int(x) for x in rng.integers(1, 80, 2))
        dst = tuple(int(x) for x in rng.integers(1, 80, 2))  # (w, h): downscales and upscales
        sizes.append((src, dst))
    for i, (src, dst) in enumerate(sizes):
        channels = (3,) if i % 2 == 0 else ()  # 3 channels, and (H, W) single-channel images
        img = rng.integers(0, 256, src + channels, dtype=np.uint8)
        got = host_resize.native_resize_u8(img, dst)
        assert got.shape == (dst[1], dst[0]) + channels
        np.testing.assert_array_equal(got, resize_uint8_exact(img, dst))
        np.testing.assert_array_equal(got, jax_resize_uint8_exact(img, dst))


def test_native_resize_falls_back_to_numpy_where_the_library_fails(monkeypatch):
    """The fallback is exact and says so: ``backend()`` is "numpy"."""
    monkeypatch.setattr(host_resize, "_lib", None)
    monkeypatch.setattr(host_resize, "_error", "OSError: no compiler")
    img = np.random.default_rng(2).integers(0, 256, (36, 64, 3), dtype=np.uint8)
    assert host_resize.backend() == "numpy"
    np.testing.assert_array_equal(host_resize.native_resize_u8(img, (16, 16)), resize_uint8_exact(img, (16, 16)))


@pytest.mark.parametrize("img,size", [(np.zeros((4, 4, 3), np.float32), (2, 2)), (np.zeros((4,), np.uint8), (2, 2)),
                                      (np.zeros((0, 4, 3), np.uint8), (2, 2)), (np.zeros((4, 4, 3), np.uint8), (0, 2))])
def test_native_resize_rejects_what_it_cannot_resize(img, size):
    """Checked before any pointer reaches the library."""
    with pytest.raises(ValueError):
        host_resize.native_resize_u8(img, size)
