"""Host pieces of the PyTorch port against vpt_tpu: mapping tables, the
camera quantizer, the action transformer, the cv2-exact resize and the
device-side action decode.  All comparisons are exact except the decoded
camera degrees (float32 on both sides, tolerance 1e-5)."""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import numpy as np
import pytest
import torch

from vpt_tpu.actions.device_decode import DeviceActionDecoder as JaxDecoder
from vpt_tpu.actions.device_decode import env_action_from_decoded as jax_env_action
from vpt_tpu.actions.mapping import CameraHierarchicalMapping as JaxMapping
from vpt_tpu.actions.quantizer import CameraQuantizer as JaxQuantizer
from vpt_tpu.actions.transformer import ActionTransformer as JaxTransformer
from vpt_tpu.ops.resize import resize_uint8_exact as jax_resize
from vpt_tpu_torch.actions import ActionTransformer, CameraHierarchicalMapping, CameraQuantizer
from vpt_tpu_torch.actions.device_decode import DeviceActionDecoder, env_action_from_decoded
from vpt_tpu_torch.config import ACTION_TRANSFORMER_KWARGS
from vpt_tpu_torch.ops.resize import resize_uint8_exact


@pytest.fixture(scope="module")
def mappers():
    return CameraHierarchicalMapping(n_camera_bins=11), JaxMapping(n_camera_bins=11)


@pytest.mark.parametrize("table", [
    "BUTTON_IDX_TO_FACTORED", "BUTTON_IDX_TO_CAMERA_META_OFF", "CAMERA_IDX_TO_FACTORED",
])
def test_mapping_tables_match_index_for_index(mappers, table):
    ours, ref = mappers
    np.testing.assert_array_equal(getattr(ours, table), getattr(ref, table))


def test_mapping_cardinalities(mappers):
    space = mappers[0].get_action_space_update()
    assert space["buttons"].eltype.n == 8641
    assert space["camera"].eltype.n == 121
    assert list(space) == list(mappers[1].get_action_space_update())


def test_from_factored_matches_on_random_presses(mappers):
    ours, ref = mappers
    rng = np.random.default_rng(0)
    ac = {
        "buttons": (rng.random((512, 20)) < 0.2).astype(np.int64),
        "camera": rng.integers(0, 11, (512, 2)),
    }
    a, b = ours.from_factored(ac), ref.from_factored(ac)
    for k in ("buttons", "camera"):
        np.testing.assert_array_equal(a[k], b[k])
    fa, fb = ours.to_factored(a), ref.to_factored(b)
    for k in ("buttons", "camera"):
        np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("scheme,mu", [("mu_law", 10.0), ("linear", 5.0)])
def test_quantizer_matches(scheme, mu):
    ours = CameraQuantizer(camera_maxval=10, camera_binsize=2, quantization_scheme=scheme, mu=mu)
    ref = JaxQuantizer(camera_maxval=10, camera_binsize=2, quantization_scheme=scheme, mu=mu)
    xy = np.random.default_rng(1).uniform(-15, 15, (256, 2))
    np.testing.assert_array_equal(ours.discretize(xy), ref.discretize(xy))
    bins = np.arange(11)
    np.testing.assert_array_equal(ours.undiscretize(bins), ref.undiscretize(bins))


def test_action_transformer_round_trip_matches():
    ours, ref = ActionTransformer(**ACTION_TRANSFORMER_KWARGS), JaxTransformer(**ACTION_TRANSFORMER_KWARGS)
    env = {"attack": np.array([1, 0]), "forward": np.array([0, 1]),
           "camera": np.array([[3.0, -2.0], [0.0, 9.5]])}
    a, b = ours.env2policy(env), ref.env2policy(env)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    pa, pb = ours.policy2env(a), ref.policy2env(b)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])


@pytest.mark.parametrize("src,dst", [
    ((360, 640, 3), (128, 128)),
    ((64, 64, 3), (64, 64)),
    ((37, 53, 3), (128, 96)),
    ((101, 211, 1), (17, 31)),
])
def test_resize_bit_exact(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, src, dtype=np.uint8)
    np.testing.assert_array_equal(resize_uint8_exact(img, dst), jax_resize(img, dst))


def test_device_decode_matches_jax():
    mapper = CameraHierarchicalMapping(n_camera_bins=11)
    transformer = ActionTransformer(**ACTION_TRANSFORMER_KWARGS)
    ref_mapper = JaxMapping(n_camera_bins=11)
    ref_q = JaxTransformer(**ACTION_TRANSFORMER_KWARGS).quantizer
    rng = np.random.default_rng(2)
    buttons = np.concatenate([rng.integers(0, 8641, 200), [0, 1, 8640]])
    camera = rng.integers(0, 121, buttons.shape[0])
    ours = DeviceActionDecoder(mapper, transformer.quantizer, torch.device("cpu")).decode(
        torch.from_numpy(buttons), torch.from_numpy(camera)).numpy()
    ref = np.asarray(JaxDecoder(ref_mapper, ref_q).decode(buttons, camera))
    np.testing.assert_array_equal(ours[:, :20], ref[:, :20])
    np.testing.assert_allclose(ours[:, 20:], ref[:, 20:], rtol=0, atol=1e-5)
    # the host decode path agrees as well
    host = transformer.policy2env(mapper.to_factored(
        {"buttons": buttons[:, None], "camera": camera[:, None]}))
    np.testing.assert_allclose(ours[:, 20:], host["camera"], atol=1e-5)
    a, b = env_action_from_decoded(ours), jax_env_action(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5)
