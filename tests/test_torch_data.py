"""The port's data plane against vpt_tpu's, on synthetic mp4 + jsonl fixtures
written with the JAX package's VideoWriter (as tests/test_data_loader.py):
json actions, every fixup branch of ``trajectory_steps`` (with and without
the recorder-version mouse scalers), the native video binding,
``SequenceDataLoader`` batches (and from a cursor of another stream
geometry, which both drop for the coarse trajectory cursor), and
``BCTrainer.train`` over a three-trajectory dataset.

Everything is compared exactly (the two packages drive the same native
library), except the per-step training losses: rtol 1e-5, atol 1e-6
(float32 sums in another order).  The tests skip where the native library
cannot be built (no libav)."""

import torch_cpu

import io
import json

import jax
import numpy as np
import pytest
import torch

from vpt_tpu.actions import json_actions as jax_json
from vpt_tpu.data import loader as jax_loader
from vpt_tpu.data import video as jax_video
from vpt_tpu_torch.actions import json_actions
from vpt_tpu_torch.data import loader, video
from vpt_tpu_torch.ops import host_resize

W, H = 128, 72  # small 16:9 video


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def native():
    try:
        video.build()  # the port's own copy first: built in a temp file and renamed, never seen half-written
    except RuntimeError as e:
        pytest.skip(f"native video library of the port cannot be built: {e}")
    if torch_cpu.jax_native_video() is None:
        pytest.skip(f"native video library of vpt_tpu unavailable (libav): {jax_video._lib_error}")


def _step(keys=(), dx=0.0, dy=0.0, buttons=(), new_buttons=(), hotbar=0, gui=False, x=0.0, y=0.0):
    return {
        "keyboard": {"keys": list(keys)},
        "mouse": {"x": x, "y": y, "dx": dx, "dy": dy, "buttons": list(buttons), "newButtons": list(new_buttons)},
        "hotbar": hotbar,
        "isGuiOpen": gui,
    }


def _write_fixture(path, name, steps, frame_fn=None):
    video_path, json_path = str(path / f"{name}.mp4"), str(path / f"{name}.jsonl")
    torch_cpu.jax_native_video()  # other test files write their datasets here too
    with jax_video.VideoWriter(video_path, W, H, fps=20) as w:
        for i in range(len(steps)):
            w.write(np.full((H, W, 3), (i * 10) % 255, np.uint8) if frame_fn is None else frame_fn(i))
    with open(json_path, "w") as f:
        for s in steps:
            f.write(json.dumps(s) + "\n")
    return video_path, json_path


def _same_action(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_json_action_to_env_action_matches_vpt_tpu():
    rng = np.random.default_rng(0)
    keys = list(jax_json.KEYBOARD_BUTTON_MAPPING) + ["key.keyboard.z"]
    steps = [_step()]
    for _ in range(40):
        steps.append(_step(keys=list(rng.choice(keys, rng.integers(0, 4), replace=False)),
                           dx=float(rng.choice([0.0, rng.normal() * 50])), dy=float(rng.choice([0.0, rng.normal() * 50])),
                           buttons=list(rng.choice([0, 1, 2], rng.integers(0, 3), replace=False))))
    for s in steps:
        ours, null = json_actions.json_action_to_env_action(s)
        theirs, jnull = jax_json.json_action_to_env_action(s)
        assert null == jnull and json_actions.parse_recorder_step(s) == jax_json.parse_recorder_step(s)
        _same_action(ours, theirs)
    ours, nulls = json_actions.json_actions_to_env_actions(steps)
    theirs, jnulls = jax_json.json_actions_to_env_actions(steps)
    np.testing.assert_array_equal(nulls, jnulls)
    for a, b in zip(ours, theirs):
        _same_action(a, b)


FIXUPS = {
    "null_skip": [_step(keys=["key.keyboard.w"]), _step(), _step(dx=10.0), _step(), _step(buttons=[0])],
    "stuck_attack": [_step(buttons=[0], new_buttons=[0]), _step(buttons=[0], dx=1.0),
                     _step(buttons=[0], new_buttons=[0], dx=1.0), _step(buttons=[0], dx=1.0)],
    "hotbar": [_step(dx=1.0, hotbar=0), _step(dx=1.0, hotbar=3), _step(dx=1.0, hotbar=3), _step(dy=2.0, hotbar=8)],
    "cursor": [_step(dx=1.0, gui=False, x=640.0, y=360.0), _step(dx=1.0, gui=True, x=640.0, y=360.0),
               _step(dx=1.0, gui=True, x=1270.0, y=10.0), _step(keys=["key.keyboard.e"], gui=True, x=-30.0, y=700.0)],
}


@pytest.mark.parametrize("fixup", sorted(FIXUPS))
@pytest.mark.parametrize("resolution", [(128, 128), (W, H)])
def test_trajectory_steps_match_vpt_tpu(native, tmp_path, fixup, resolution):
    rng = np.random.default_rng(len(fixup))
    frames = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in FIXUPS[fixup]]
    vp, jp = _write_fixture(tmp_path, fixup, FIXUPS[fixup], lambda i: frames[i])
    ours = list(loader.trajectory_steps(vp, jp, resolution=resolution))
    theirs = list(jax_loader.trajectory_steps(vp, jp, resolution=resolution))
    assert len(ours) == len(theirs) > 0
    for (f, a), (jf, ja) in zip(ours, theirs):
        np.testing.assert_array_equal(f, jf)
        _same_action(a, ja)


VERSIONED = [dict(_step(dx=dx, dy=-dx / 2, gui=gui, x=100.0, y=100.0), dataVersion=version)
             for dx, gui, version in ((40.0, True, "5.7"), (20.0, False, "6.7"), (16.0, True, "6.8"), (30.0, True, "1"),
                                      (12.0, True, "6.9"), (25.0, True, None))]


@pytest.mark.parametrize("apply", [False, True])
def test_version_scalers_match_vpt_tpu(native, tmp_path, apply):
    """``apply_version_scalers`` scales the GUI-open mouse deltas by their
    recorder version's scaler, as vpt_tpu's ``trajectory_steps`` (off: as
    they are)."""
    steps = [{k: v for k, v in s.items() if v is not None} for s in VERSIONED]
    vp, jp = _write_fixture(tmp_path, "versions", steps)
    assert loader.MINEREC_VERSION_SPECIFIC_SCALERS == jax_loader.MINEREC_VERSION_SPECIFIC_SCALERS
    ours = list(loader.trajectory_steps(vp, jp, apply_version_scalers=apply))
    theirs = list(jax_loader.trajectory_steps(vp, jp, apply_version_scalers=apply))
    assert len(ours) == len(theirs) == len(steps)
    for (f, a), (jf, ja) in zip(ours, theirs):
        np.testing.assert_array_equal(f, jf)
        _same_action(a, ja)
    plain = list(loader.trajectory_steps(vp, jp))
    moved = [not np.array_equal(a["camera"], b["camera"]) for (_, a), (_, b) in zip(ours, plain)]
    assert moved == ([True, False, True, False, True, False] if apply else [False] * len(steps))


def test_video_binding_matches_vpt_tpu(native, tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "v.mp4")
    with video.VideoWriter(path, W, H, fps=20) as w:  # the port's writer, read by both
        for _ in range(5):
            w.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    ours, theirs = video.VideoReader(path), jax_video.VideoReader(path)
    assert (ours.width, ours.height, ours.nframes) == (theirs.width, theirs.height, theirs.nframes)
    np.testing.assert_array_equal(ours.read(), theirs.read())
    emit = np.array([1, 0, 1, 1, 1], bool)
    got, batch = ours.read_batch(5, (64, 64), emit=emit)
    jgot, jbatch = theirs.read_batch(5, (64, 64), emit=emit)
    assert got == jgot == 4
    np.testing.assert_array_equal(batch[emit[:4].nonzero()[0]], jbatch[emit[:4].nonzero()[0]])
    ours.close()
    theirs.close()
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    np.testing.assert_array_equal(host_resize.native_resize_u8(img, (128, 128)),
                                  jax_video.native_resize_u8(img, (128, 128)))


def _dataset(path, n=3):
    for j in range(n):
        steps = [_step(dx=10.0 * ((i + j) % 7 + 1), keys=["key.keyboard.w"] if i % 3 == 0 else []) for i in range(7 + 3 * j)]
        steps[2] = _step()  # a null step, skipped
        _write_fixture(path, f"t{j}", steps, lambda i, j=j: np.full((H, W, 3), (40 * j + 9 * i) % 255, np.uint8))


def _collect(ld):
    try:
        return list(ld)
    finally:
        ld.close()


def test_sequence_loader_batches_match_vpt_tpu(native, tmp_path):
    _dataset(tmp_path)
    kw = dict(batch_size=2, chunk_len=4, n_epochs=2, seed=5, resolution=(32, 32))
    ours = _collect(loader.SequenceDataLoader(str(tmp_path), **kw))
    theirs = _collect(jax_loader.SequenceDataLoader(str(tmp_path), **kw))
    assert len(ours) == len(theirs) > 2
    for b, jb in zip(ours, theirs):
        for key in ("frames", "buttons", "camera", "firsts", "mask", "episode_ids"):
            np.testing.assert_array_equal(b[key], jb[key], err_msg=key)
    assert any(not b["mask"].all() for b in ours)  # a padded tail was exercised


@pytest.mark.parametrize("start_trajectory", [0, 3])
def test_cursor_of_another_geometry_falls_back_as_vpt_tpu(native, tmp_path, capsys, start_trajectory):
    """A resume cursor written at another stream geometry (shard 1 of 2 of
    two streams) given to an unsharded two-stream loader: both packages drop
    it for the coarse ``start_trajectory`` cursor and yield the same batches."""
    _dataset(tmp_path)
    kw = dict(chunk_len=4, n_epochs=2, seed=5, resolution=(32, 32))
    sharded = loader.SequenceDataLoader(str(tmp_path), batch_size=1, shard_id=1, num_shards=2, **kw)
    try:
        next(iter(sharded))
        state = sharded.state()
    finally:
        sharded.close()
    assert state["shard"] == [1, 2] and state["streams"][0][0] >= 0
    ours = _collect(loader.SequenceDataLoader(str(tmp_path), batch_size=2, resume_state=state,
                                              start_trajectory=start_trajectory, **kw))
    assert "coarse trajectory cursor" in capsys.readouterr().out
    theirs = _collect(jax_loader.SequenceDataLoader(str(tmp_path), batch_size=2, resume_state=state,
                                                    start_trajectory=start_trajectory, **kw))
    assert len(ours) == len(theirs) > 0
    for b, jb in zip(ours, theirs):
        for key in ("frames", "buttons", "camera", "firsts", "mask", "episode_ids"):
            np.testing.assert_array_equal(b[key], jb[key], err_msg=key)
    assert min(ours[0]["episode_ids"]) >= start_trajectory


def test_bc_train_losses_match_vpt_tpu(native, tmp_path):
    from vpt_tpu.checkpoint import save_weights as jax_save_weights
    from vpt_tpu.parallel.mesh import make_mesh
    from vpt_tpu.training import bc as jax_bc
    from vpt_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
    from vpt_tpu_torch.training import bc
    from vpt_tpu_torch.utils.metrics import MetricsLogger

    from test_torch_training import PI_KWARGS, TINY_KWARGS

    data = tmp_path / "data"
    data.mkdir()
    _dataset(data)
    hp_kw = dict(batch_size=2, chunk_len=4, epochs=1, learning_rate=1e-3, loss_report_rate=1)
    jt = jax_bc.BCTrainer(TINY_KWARGS, PI_KWARGS, hp=jax_bc.BCHyperparams(**hp_kw),
                          mesh=make_mesh(n_dp=1, devices=jax.devices()[:1]), seed=3)
    jt.init()
    weights = str(tmp_path / "init.weights")
    jax_save_weights(weights, jax.tree.map(np.asarray, jt.variables))
    pt = bc.BCTrainer(TINY_KWARGS, PI_KWARGS, hp=bc.BCHyperparams(**hp_kw), device="cpu", seed=3)
    report = pt.load_weights(weights)
    assert not report["unexpected"] and not report["missing"] and not report["shape_mismatch"], report

    jlog, plog = io.StringIO(), io.StringIO()
    jsteps = jt.train(str(data), str(tmp_path / "jax.weights"), metrics=JaxMetricsLogger(stream=jlog))
    psteps = pt.train(str(data), str(tmp_path / "port.weights"), metrics=MetricsLogger(stream=plog))
    jrows = [json.loads(line) for line in jlog.getvalue().splitlines()]
    prows = [json.loads(line) for line in plog.getvalue().splitlines()]
    assert psteps == jsteps == len(prows) == len(jrows) >= 3
    np.testing.assert_allclose([r["loss"] for r in prows], [r["loss"] for r in jrows], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose([r["grad_norm"] for r in prows], [r["grad_norm"] for r in jrows], rtol=1e-4)
    assert (tmp_path / "port.weights").exists()

    # evaluate: the same held-out NLL as vpt_tpu's over the trained weights' dataset
    ev, jev = pt.evaluate(str(data)), jt.evaluate(str(data))
    assert ev["frames"] == jev["frames"] and ev["batches"] == jev["batches"]
    np.testing.assert_allclose(ev["nll_per_frame"], jev["nll_per_frame"], rtol=1e-4)
