"""The port's IDM trainer (vpt_tpu_torch/training/idm.py) and the loader's
pseudo-label path against vpt_tpu's at a tiny config, from the same weights
(crossed with ``from_jax_variables``), on the CPU.

Tolerances (float32 sums in another order in the two frameworks):
  * factored targets, pseudo-label steps, loader batches: exact;
  * loss of each of three successive train steps rtol 1e-5, grad norm rtol
    1e-4 (as tests/test_torch_training.py); parameters after three steps
    within 3·lr of vpt_tpu's (Adam may move a pure-noise entry by lr a step);
  * held-out NLL rtol 1e-4, exact-match rates exact.
The data tests skip where the native video library cannot be built (no
libav)."""

import json

import jax
import numpy as np
import pytest
import torch

from vpt_tpu.actions.mapping import CameraHierarchicalMapping as JaxMapping
from vpt_tpu.checkpoint import save_model_parameters as jax_save_model_parameters
from vpt_tpu.checkpoint.torch_import import variables_to_state_dict
from vpt_tpu.data import loader as jax_loader
from vpt_tpu.parallel.mesh import make_mesh
from vpt_tpu.training import idm as jax_idm
from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
from vpt_tpu_torch.checkpoint import from_jax_variables
from vpt_tpu_torch.data import loader, video
from vpt_tpu_torch.training import idm

IDM_TINY = dict(
    hidsize=64,
    impala_width=1,
    impala_chans=[4, 8],
    img_shape=[32, 32, 4],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2,
    timesteps=8,
    attention_heads=4,
    attention_memory_size=16,
    recurrence_type="transformer",
    attention_mask_style="none",
    use_pre_lstm_ln=False,
    obs_processing_width=32,
    conv3d_params={"inchan": 3, "outchan": 4, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]},
)
PI_KWARGS = {"temperature": 1.0}
B, T = 2, 8
LR = 1e-3
W, H = 64, 36


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def _batches(seed=0):
    """Three window batches in the loader's format; the last has a padded tail."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(3):
        mask = np.ones((B, T), bool)
        if s == 2:
            mask[1, 5:] = False
        out.append({"frames": rng.integers(0, 256, (B, T, 32, 32, 3), dtype=np.uint8),
                    "buttons": rng.integers(0, 8641, (B, T)).astype(np.int32),
                    "camera": rng.integers(0, 121, (B, T)).astype(np.int32),
                    "firsts": np.zeros((B, T), bool), "mask": mask})
    return out


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _trainers(seed=0, **hp_kw):
    hp_kw = dict(dict(batch_size=B, window=T, learning_rate=LR), **hp_kw)
    jt = jax_idm.IDMTrainer(IDM_TINY, PI_KWARGS, hp=jax_idm.IDMHyperparams(**hp_kw),
                            mesh=make_mesh(n_dp=1, devices=jax.devices()[:1]), seed=seed)
    jt.init()
    pt = idm.IDMTrainer(IDM_TINY, PI_KWARGS, hp=idm.IDMHyperparams(**hp_kw), device="cpu", seed=seed)
    pt.init()
    pt.policy.load_state_dict(from_jax_variables(_host(jt.variables)), strict=True)
    return jt, pt


def test_factored_targets_match_vpt_tpu():
    rng = np.random.default_rng(0)
    buttons, camera = rng.integers(0, 8641, (3, 7)), rng.integers(0, 121, (3, 7))
    ours = idm.factored_targets(buttons, camera, CameraHierarchicalMapping(n_camera_bins=11))
    theirs = jax_idm.factored_targets(buttons, camera, JaxMapping(n_camera_bins=11))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert ours["buttons"].shape == (3, 7, 20) and ours["camera"].shape == (3, 7, 2)


def test_three_train_steps_match_vpt_tpu():
    jt, pt = _trainers()
    for i, batch in enumerate(_batches()):
        jloss, jnorm = jt.train_step(dict(batch))
        ploss, pnorm = pt.train_step(dict(batch))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5, err_msg=f"loss of step {i + 1}")
        np.testing.assert_allclose(float(pnorm), float(jnorm), rtol=1e-4, err_msg=f"grad norm of step {i + 1}")
    assert pt.step_count == 3
    after = variables_to_state_dict(_host(jt.variables))
    for name, p in pt.policy.state_dict().items():
        np.testing.assert_allclose(p.numpy(), np.asarray(after[name]).reshape(p.shape), rtol=0, atol=3 * LR,
                                   err_msg=name)
    # lastlayer is computed and discarded: no gradient reaches it, as in vpt_tpu (only the decay moves it)
    assert pt.policy.net.lastlayer.layer.weight.grad is None or not pt.policy.net.lastlayer.layer.weight.grad.any()


def test_train_step_takes_prepared_tensors():
    """train() feeds factored tensors from the prefetcher; the step is the same."""
    a, b = (idm.IDMTrainer(IDM_TINY, PI_KWARGS, hp=idm.IDMHyperparams(window=T), device="cpu", seed=1)
            for _ in range(2))
    batch = _batches(2)[0]
    prepared = {k: torch.from_numpy(np.asarray(v)) for k, v in a.prepare_batch(batch).items()}
    la, na = a.train_step(dict(batch))
    lb, nb = b.train_step(prepared)
    assert torch.equal(la, lb) and torch.equal(na, nb)


@pytest.fixture(scope="module")
def native():
    from vpt_tpu.data import video as jax_video

    try:
        video.build()
    except RuntimeError as e:
        pytest.skip(f"native video library of the port cannot be built: {e}")
    if not jax_video.native_available():
        pytest.skip(f"native video library of vpt_tpu unavailable (libav): {jax_video._lib_error}")


def _write_video(path, n, seed):
    rng = np.random.default_rng(seed)
    with video.VideoWriter(str(path), W, H, fps=20) as w:
        for _ in range(n):
            w.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))


def _write_rows(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _label(frame, **kw):
    action = {"attack": 0, "forward": 0, "camera": [0.0, 0.0]}
    action.update(kw)
    return {"frame": frame, "action": action}


def _same_steps(ours, theirs):
    assert len(ours) == len(theirs)
    for (f, a), (jf, ja) in zip(ours, theirs):
        np.testing.assert_array_equal(f, jf)
        assert a.keys() == ja.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(ja[k]), err_msg=k)


def test_pseudo_label_steps_match_vpt_tpu(native, tmp_path):
    """Null actions skipped, an unlabeled frame decoded but not emitted,
    format detection, and the recorder format through steps_for."""
    vp, jp, rec = tmp_path / "v.mp4", tmp_path / "v.jsonl", tmp_path / "rec.jsonl"
    _write_video(vp, 6, 0)
    _write_rows(jp, [_label(0, attack=1), _label(1), _label(2, camera=[0.0, 1.25]), _label(4, forward=1), _label(5)])
    _write_rows(rec, [{"keyboard": {"keys": ["key.keyboard.w"]}, "hotbar": 0, "isGuiOpen": False,
                       "mouse": {"x": 0.0, "y": 0.0, "dx": 0.0, "dy": 0.0, "buttons": [], "newButtons": []}}])
    assert loader._is_pseudo_label_file(str(jp)) and not loader._is_pseudo_label_file(str(rec))
    ours = list(loader.pseudo_label_steps(str(vp), str(jp), resolution=(32, 32)))
    assert len(ours) == 3
    _same_steps(ours, list(jax_loader.pseudo_label_steps(str(vp), str(jp), resolution=(32, 32))))
    for jsonl in (jp, rec):
        _same_steps(list(loader.steps_for(str(vp), str(jsonl), resolution=(32, 32))),
                    list(jax_loader.steps_for(str(vp), str(jsonl), resolution=(32, 32))))


def _pseudo_corpus(path):
    """Videos in one tree, labels in another; t2 stays unlabeled."""
    videos, labels = path / "videos", path / "labels"
    videos.mkdir()
    labels.mkdir()
    for j in range(3):
        _write_video(videos / f"t{j}.mp4", 11, j)
        if j < 2:
            _write_rows(labels / f"t{j}.jsonl", [_label(i, attack=i % 2, forward=1, camera=[0.0, float((i + j) % 3)])
                                                 for i in range(11)])
    return str(videos), str(labels)


def test_sequence_loader_labels_dir_matches_vpt_tpu(native, tmp_path):
    videos, labels = _pseudo_corpus(tmp_path)
    assert [j for _, j in loader._discover(videos, labels)] == [j for _, j in jax_loader._discover(videos, labels)]
    kw = dict(labels_dir=labels, batch_size=2, chunk_len=4, n_epochs=2, seed=0, resolution=(32, 32))
    ld, jld = loader.SequenceDataLoader(videos, **kw), jax_loader.SequenceDataLoader(videos, **kw)
    try:
        ours, theirs = list(ld), list(jld)
    finally:
        ld.close()
        jld.close()
    assert len(ours) == len(theirs) >= 4
    for b, jb in zip(ours, theirs):
        for key in ("frames", "buttons", "camera", "firsts", "mask", "episode_ids"):
            np.testing.assert_array_equal(b[key], jb[key], err_msg=key)
    assert any(not b["mask"].all() for b in ours)


def test_bc_cli_trains_on_pseudo_labels(native, tmp_path):
    from test_torch_training import PI_KWARGS as BC_PI_KWARGS
    from test_torch_training import TINY_KWARGS
    from vpt_tpu_torch.behavioural_cloning import main as bc_main
    from vpt_tpu_torch.checkpoint import save_model_parameters, save_weights
    from vpt_tpu_torch.training.bc import BCTrainer

    videos, labels = _pseudo_corpus(tmp_path)
    model, weights, out = (str(tmp_path / n) for n in ("p.model", "p.weights", "out.weights"))
    save_model_parameters(model, TINY_KWARGS, BC_PI_KWARGS)
    save_weights(weights, BCTrainer.from_files(model, device="cpu").policy)
    bc_main(["--data-dir", videos, "--labels-dir", labels, "--in-model", model, "--in-weights", weights,
             "--out-weights", out, "--batch-size", "2", "--chunk-len", "4", "--epochs", "1", "--device", "cpu"])
    trained = BCTrainer.from_files(model, out, device="cpu").policy.state_dict()
    start = BCTrainer.from_files(model, weights, device="cpu").policy.state_dict()
    assert any(not torch.equal(trained[k], start[k]) for k in start)


def _contractor_corpus(path, n=3, frames=11):
    keys = ["key.keyboard.w", "key.keyboard.a", "key.keyboard.s"]
    path.mkdir()
    for j in range(n):
        _write_video(path / f"t{j}.mp4", frames, 10 + j)
        _write_rows(path / f"t{j}.jsonl", [
            {"keyboard": {"keys": [keys[(i + j) % 3]]}, "hotbar": 0, "isGuiOpen": False,
             "mouse": {"x": 10.0, "y": 10.0, "dx": float(i % 3), "dy": 0.0, "buttons": [], "newButtons": []}}
            for i in range(frames)])
    return str(path)


def test_train_and_evaluate_match_vpt_tpu(native, tmp_path):
    """IDMTrainer.train over a contractor corpus against vpt_tpu's from the
    same weights, step by step, then the held-out evaluation of both; and
    python -m vpt_tpu_torch.inverse_dynamics_train end to end."""
    import io

    from vpt_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
    from vpt_tpu_torch.checkpoint import save_weights
    from vpt_tpu_torch.inverse_dynamics_train import main as train_main
    from vpt_tpu_torch.utils.metrics import MetricsLogger

    data = _contractor_corpus(tmp_path / "data")
    jt, pt = _trainers(epochs=1, loss_report_rate=1)
    model, init, out = (str(tmp_path / n) for n in ("idm.model", "init.weights", "out.weights"))
    jax_save_model_parameters(model, IDM_TINY, PI_KWARGS)
    save_weights(init, pt.policy)
    jlog, plog = io.StringIO(), io.StringIO()
    jsteps = jt.train(data, str(tmp_path / "jax.weights"), metrics=JaxMetricsLogger(stream=jlog))
    psteps = pt.train(data, str(tmp_path / "port.weights"), metrics=MetricsLogger(stream=plog))
    jrows = [json.loads(line) for line in jlog.getvalue().splitlines()]
    prows = [json.loads(line) for line in plog.getvalue().splitlines()]
    assert psteps == jsteps == len(prows) == len(jrows) >= 2
    np.testing.assert_allclose([r["loss"] for r in prows], [r["loss"] for r in jrows], rtol=1e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in prows], [r["grad_norm"] for r in jrows], rtol=1e-4)

    ev, jev = pt.evaluate(data), jt.evaluate(data)
    assert (ev["frames"], ev["batches"]) == (jev["frames"], jev["batches"]) and ev["frames"] > 0
    np.testing.assert_allclose(ev["nll_per_frame"], jev["nll_per_frame"], rtol=1e-4)
    assert ev["button_exact_match"] == jev["button_exact_match"]
    assert ev["camera_exact_match"] == jev["camera_exact_match"]

    trainer = train_main(["--data-dir", data, "--in-model", model, "--in-weights", init, "--out-weights", out,
                          "--val-dir", data, "--batch-size", "2", "--window", "8", "--epochs", "1", "--device", "cpu"])
    assert trainer.step_count == jsteps
    back = idm.IDMTrainer.from_files(model, out, device="cpu", hp=idm.IDMHyperparams(window=8))
    start = torch.load(init, weights_only=True)
    assert all(torch.equal(v, trainer.policy.state_dict()[k]) for k, v in back.policy.state_dict().items())
    assert any(not torch.equal(v, start[k]) for k, v in back.policy.state_dict().items())
