"""The port's tools (vpt_tpu_torch/tools/) against the JAX package's
tools/*.py, each loaded by path and run with ``sys.argv`` patched, on the
same tiny ``.model``/``.weights`` files and the same fixture data, on the
CPU; every port tool called in process through ``main(argv)``:

  * label_videos: the same jsonl rows for every video of a directory,
    written through a ``.tmp`` renamed on completion, finished videos
    skipped unless ``--no-resume``; ``label_frames`` takes frame batches
    from anywhere;
  * eval_loss: ``nll_per_frame`` within 1e-4 relative, the same frame and
    batch counts;
  * average_weights: the same tensors, exactly;
  * record_demonstrations: a recorded pair loads through the port's loader
    with the play's frames and actions, and a mid-run episode end starts a
    new pair (tests/test_record_demonstrations.py's cases, on the port's
    ``record``); the mock-env command writes the JAX tool's jsonl rows;
  * download_dataset: against a local HTTP server (no network), as
    tests/test_download_dataset.py holds the JAX tool;
  * bench_breakdown, bench_bc_breakdown and bench_dataplane run on the CPU
    and print their keys; ``--bakeoff`` raises without a reference checkout.

The video cases skip where the port's native video library cannot be built
(no libav).
"""

import http.server
import json
import os
import threading

import numpy as np
import pytest
import torch

import test_torch_entry_points as ep


@pytest.fixture(autouse=True, scope="module")
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    import torch

    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return ep.write_model_files(str(tmp_path_factory.mktemp("tools")))


def _rows(path):
    return [json.loads(line) for line in open(path)]


# ------------------------------------------------------------------ label_videos


def test_label_videos_equal_vpt_tpu_and_resume(files, tmp_path, capsys):
    from vpt_tpu_torch.tools import label_videos

    ep.native_video()
    videos = tmp_path / "videos"
    videos.mkdir()
    for i, n in enumerate((13, 6)):
        ep.write_recording(str(videos / f"v{i}"), n, seed=i)
    common = ["--model", files["idm.model"], "--weights", files["idm.weights"], "--video-dir", str(videos),
              "--n-frames", "8", "--stride", "4", "--window-batch", "2", "--no-strict-resolution"]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    label_videos.main(common + ["--out-dir", str(ours), "--device", "cpu"])
    ep.run_jax_tool("tools/label_videos.py", common + ["--out-dir", str(theirs)])
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == ["v0.jsonl", "v1.jsonl"]
    for name, n in (("v0.jsonl", 13), ("v1.jsonl", 6)):
        rows = _rows(ours / name)
        assert [r["frame"] for r in rows] == list(range(n))
        assert rows == _rows(theirs / name)

    capsys.readouterr()
    (ours / "v0.jsonl").write_text("kept\n")
    label_videos.main(common + ["--out-dir", str(ours), "--device", "cpu"])
    assert "(2 already done, 0 failed)" in capsys.readouterr().out
    assert (ours / "v0.jsonl").read_text() == "kept\n"
    label_videos.main(common + ["--out-dir", str(ours), "--no-resume", "--device", "cpu"])
    assert _rows(ours / "v0.jsonl") == _rows(theirs / "v0.jsonl")
    assert not list(ours.glob("*.tmp"))


def test_label_frames_is_the_streaming_labeler(files, tmp_path):
    """Frame batches from no video: the rows of StreamingIDMLabeler fed the
    same frames one by one, and no .tmp left."""
    from vpt_tpu_torch.agent import IDMAgent, StreamingIDMLabeler, action_jsonl_row
    from vpt_tpu_torch.checkpoint import load_model_parameters
    from vpt_tpu_torch.tools.label_videos import label_frames

    agent = IDMAgent(*load_model_parameters(files["idm.model"]), device="cpu")
    agent.load_weights(files["idm.weights"])
    frames = np.random.default_rng(4).integers(0, 255, (21, 64, 64, 3), dtype=np.uint8)
    out = str(tmp_path / "labels.jsonl")
    assert label_frames(agent, [frames[:5], frames[5:16], frames[16:]], out, 8, 4, 3) == 21
    labeler = StreamingIDMLabeler(agent, window=8, stride=4, window_batch=3)
    want = [lab for f in frames for lab in labeler.feed_resized(f)] + labeler.finish()
    assert _rows(out) == [{"frame": i, "action": action_jsonl_row(a)} for i, a in want]
    assert not os.path.exists(out + ".tmp")


# ------------------------------------------------------------------ eval_loss


def test_eval_loss_equals_vpt_tpu(files, tmp_path, capsys):
    from vpt_tpu_torch.tools import eval_loss

    ep.native_video()
    data = tmp_path / "data"
    data.mkdir()
    for i in range(8):  # a stream each: vpt_tpu's batch shards over the suite's 8 host devices
        ep.write_recording(str(data / f"traj{i}"), 9, seed=10 + i)
    argv = ["--in-model", files["policy.model"], "--in-weights", files["policy.weights"], "--data-dir", str(data),
            "--batch-size", "8", "--chunk-len", "4", "--max-batches", "2"]
    ours = eval_loss.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ours
    ep.run_jax_tool("tools/eval_loss.py", argv)
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (ours["frames"], ours["batches"]) == (theirs["frames"], theirs["batches"]) and ours["batches"] == 2
    np.testing.assert_allclose(ours["nll_per_frame"], theirs["nll_per_frame"], rtol=1e-4)


# ------------------------------------------------------------------ average_weights


def test_average_weights_equals_vpt_tpu_exactly(files, tmp_path):
    from vpt_tpu_torch.tools import average_weights

    base = torch.load(files["policy.weights"], weights_only=True)
    g = torch.Generator().manual_seed(0)
    paths = []
    for i in range(3):
        path = str(tmp_path / f"in{i}.weights")
        torch.save({k: v + torch.randn(v.shape, generator=g).to(v.dtype) if v.is_floating_point() else v
                    for k, v in base.items()}, path)
        paths.append(path)
    ours, theirs = str(tmp_path / "ours.weights"), str(tmp_path / "theirs.weights")
    average_weights.main([ours] + paths + ["--device", "cpu"])
    ep.run_jax_tool("tools/average_weights.py", [theirs] + paths)
    a, b = torch.load(ours, weights_only=True), torch.load(theirs, weights_only=True)
    assert a.keys() == b.keys() == base.keys()
    for k in a:  # the JAX tool writes a 0-d tensor as (1,) (np.ascontiguousarray); the port keeps its shape
        assert a[k].shape == base[k].shape and a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k].reshape(b[k].shape), b[k]), k


# ------------------------------------------------------------------ record_demonstrations


def _action(camera=(0.0, 0.0), **pressed):
    from vpt_tpu_torch.actions.json_actions import NOOP_ACTION

    a = dict(NOOP_ACTION, camera=np.asarray(camera, np.float64))
    for k, v in pressed.items():
        a[k.replace("hotbar_", "hotbar.")] = v
    return a


def test_recorded_pair_loads_through_the_ports_loader(tmp_path):
    from vpt_tpu_torch.actions.json_actions import NOOP_ACTION
    from vpt_tpu_torch.data.loader import trajectory_steps
    from vpt_tpu_torch.tools.record_demonstrations import record

    ep.native_video()
    script = [_action(forward=1), _action(forward=1, jump=1, camera=(3.0, -4.0)), _action(), _action(use=1),
              _action(hotbar_2=1), _action(sneak=1, camera=(0.0, 10.0))]
    frames = [np.full((360, 640, 3), 40 * i, np.uint8) for i in range(len(script))]

    class ScriptedAgent:
        batch_size = 1

        def __init__(self):
            self.t = 0

        def get_action(self, obs, first=None, **kw):
            self.t += 1
            return [script[self.t - 1]]

    class ScriptedEnv:
        def __init__(self):
            self.t = 0

        def reset(self):
            return {"pov": frames[0]}

        def step(self, action):
            self.t += 1
            return {"pov": frames[min(self.t, len(frames) - 1)]}, 0.0, False, {}

    taken = record(ScriptedAgent(), [ScriptedEnv()], len(script), str(tmp_path), prefix="scripted")
    assert len(taken[0]) == len(script) + 1  # the warm-up noop first
    assert not any(taken[0][0][k] for k in NOOP_ACTION if k != "camera")
    got = list(trajectory_steps(str(tmp_path / "scripted-0.mp4"), str(tmp_path / "scripted-0.jsonl")))
    assert not list(tmp_path.glob("scripted-0-ep*"))
    expected = [(i, a) for i, a in enumerate(script)
                if any(a[k] for k in NOOP_ACTION if k != "camera") or np.any(np.asarray(a["camera"]))]
    assert len(got) == len(expected)
    for (frame, action), (i, orig) in zip(got, expected):
        assert frame.shape == (128, 128, 3)
        for k in NOOP_ACTION:
            if k == "camera":
                np.testing.assert_array_equal(action["camera"], np.trunc(orig["camera"]).astype(np.int64))
            else:
                assert action[k] == orig[k], (i, k)


def test_mid_run_episode_ends_start_new_pairs(tmp_path):
    from vpt_tpu_torch.data.loader import trajectory_steps
    from vpt_tpu_torch.tools.record_demonstrations import record

    ep.native_video()

    class ForwardAgent:
        batch_size = 1

        def get_action(self, obs, first=None, **kw):
            return [_action(forward=1)]

    class EpisodicEnv:
        """Ends an episode every 3 steps."""

        def __init__(self):
            self.t = 0

        def reset(self):
            return {"pov": np.full((360, 640, 3), 7, np.uint8)}

        def step(self, action):
            self.t += 1
            return {"pov": np.full((360, 640, 3), 7, np.uint8)}, 0.0, self.t % 3 == 0, {}

    record(ForwardAgent(), [EpisodicEnv()], 7, str(tmp_path), prefix="epi")
    # 8 frames: the warm-up noop and 7 policy steps; the env ends episodes at
    # its steps 3 and 6 (after policy steps 2 and 5)
    assert sorted(p.stem for p in tmp_path.glob("epi-0*.jsonl")) == ["epi-0", "epi-0-ep1", "epi-0-ep2"]
    counts = [sum(1 for _ in trajectory_steps(str(tmp_path / f"{stem}.mp4"), str(tmp_path / f"{stem}.jsonl")))
              for stem in ("epi-0", "epi-0-ep1", "epi-0-ep2")]
    assert counts == [2, 3, 2]  # the warm-up noop is a null step the loader skips


def test_record_demonstrations_command_writes_the_jax_tools_rows(files, tmp_path):
    """The mock-env command, the agents made deterministic in both tools:
    the same jsonl rows, stream by stream."""
    from unittest import mock

    from vpt_tpu_torch.tools import record_demonstrations

    ep.native_video()
    common = ["--model", files["policy.model"], "--weights", files["policy.weights"], "--mock-env", "--steps", "3"]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    from vpt_tpu_torch import agent as port_agent

    with mock.patch.object(port_agent, "MineRLAgent", ep._deterministic(port_agent.MineRLAgent, [])):
        record_demonstrations.main(common + ["--out-dir", str(ours), "--device", "cpu"])
    import vpt_tpu.agent as jax_agent

    jax_tool = ep.load_script("tools/record_demonstrations.py", "jax_record_demonstrations")
    with mock.patch.object(jax_agent, "MineRLAgent", ep._deterministic(jax_agent.MineRLAgent, [])):
        jax_tool.main(files["policy.model"], files["policy.weights"], str(theirs), steps=3, mock_env=True)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == ["demo-0.jsonl", "demo-0.mp4"]
    rows, want = _rows(ours / "demo-0.jsonl"), _rows(theirs / "demo-0.jsonl")
    assert len(rows) == len(want) == 4
    for row, other in zip(rows, want):  # the camera's degrees are float32 in the port, float64 in vpt_tpu
        for key in ("dx", "dy"):
            np.testing.assert_allclose(row["mouse"].pop(key), other["mouse"].pop(key), rtol=1e-6)
        assert row == other


# ------------------------------------------------------------------ download_dataset


@pytest.fixture()
def corpus_server(tmp_path):
    """A tiny contractor-layout corpus served on 127.0.0.1; 'flaky.mp4'
    fails once with a 500, then succeeds."""
    docroot = tmp_path / "blob"
    (docroot / "8.0").mkdir(parents=True)
    for name in ("seg-a", "seg-b", "flaky"):
        (docroot / "8.0" / f"{name}.mp4").write_bytes(b"\x00" * 64 + name.encode())
        (docroot / "8.0" / f"{name}.jsonl").write_text(json.dumps({"keyboard": {"keys": []}}) + "\n")
    failures = {"/8.0/flaky.mp4": 1}

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(docroot), **kw)

        def do_GET(self):  # noqa: N802 (http.server's name)
            if failures.get(self.path, 0) > 0:
                failures[self.path] -= 1
                self.send_error(500, "flaky")
                return
            super().do_GET()

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", docroot
    finally:
        server.shutdown()


def _index(tmp_path, base_url, relpaths):
    path = tmp_path / "index.json"
    path.write_text(json.dumps({"basedir": base_url, "relpaths": relpaths}))
    return str(path)


def test_download_dataset_flat_resume_retry_and_failures(corpus_server, tmp_path, monkeypatch, capsys):
    from vpt_tpu_torch.tools import download_dataset as dd

    monkeypatch.setattr(dd.time, "sleep", lambda s: None)  # the backoff, not waited for
    base, docroot = corpus_server
    index = _index(tmp_path, base, ["8.0/seg-a", "8.0/seg-b", "8.0/flaky", "8.0/missing"])
    out = tmp_path / "data"
    dd.main(["--index", index, "--out-dir", str(out), "--workers", "2", "--retries", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"done": 3, "skipped": 0, "failed": 1}
    for name in ("seg-a", "seg-b", "flaky"):
        assert (out / f"{name}.mp4").read_bytes() == (docroot / "8.0" / f"{name}.mp4").read_bytes()
        assert (out / f"{name}.jsonl").exists()
    assert not list(out.glob("*.part"))
    assert "8.0/missing" in (out / "failed.txt").read_text()
    # resume: complete pairs are skipped; --relpath-filter and --limit select
    assert dd.download_dataset(index, str(out), relpath_filter="seg", limit=1) == {"done": 0, "skipped": 1,
                                                                                  "failed": 0}


def test_download_dataset_models_and_registry(corpus_server, tmp_path, monkeypatch, capsys):
    from vpt_tpu_torch.tools import download_dataset as dd

    jax_dd = ep.load_script("tools/download_dataset.py", "jax_download_dataset")

    assert dd.MODELS == jax_dd.MODELS and dd.INDEXES == jax_dd.INDEXES
    base, docroot = corpus_server
    (docroot / "m.model").write_bytes(b"model")
    (docroot / "m.weights").write_bytes(b"weights")
    monkeypatch.setitem(dd.MODELS, "local", (f"{base}/m.model", f"{base}/m.weights"))
    dd.main(["--models", "local", "--out-dir", str(tmp_path / "ckpt")])
    assert (tmp_path / "ckpt" / "m.weights").read_bytes() == b"weights"
    dd.main(["--models", "local", "--out-dir", str(tmp_path / "ckpt")])
    assert "skip" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown model"):
        dd.main(["--models", "nope", "--out-dir", str(tmp_path / "ckpt")])
    dd.main(["--list-models"])
    assert "4x-idm" in capsys.readouterr().out


# ------------------------------------------------------------------ bench tools


@pytest.fixture()
def small_foundation(monkeypatch):
    """The foundation config cut to 2 blocks of 2 heads and 16 steps, so
    the bench tools run at width 1 on the CPU."""
    from vpt_tpu_torch import config

    monkeypatch.setitem(config.FOUNDATION_POLICY_KWARGS, "n_recurrence_layers", 2)
    monkeypatch.setitem(config.FOUNDATION_POLICY_KWARGS, "attention_heads", 2)
    monkeypatch.setitem(config.FOUNDATION_POLICY_KWARGS, "timesteps", 16)
    monkeypatch.setitem(config.FOUNDATION_POLICY_KWARGS, "attention_memory_size", 32)


def test_bench_breakdown_prints_its_keys(small_foundation, capsys):
    from vpt_tpu_torch.tools import bench_breakdown

    out = bench_breakdown.main(["--width", "1", "--streams", "2", "--iters", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]).keys() == out.keys()
    for k in ("cnn_ms", "transformer_ms", "tail_ms", "sum_ms", "implied_fps", "cnn_gflops_per_step"):
        assert out[k] > 0, k
    assert out["cnn_share_of_h100_bf16_peak"] is None and out["device"] == "cpu"  # no card, no device figure
    assert out["share"].keys() == {"cnn", "transformer", "tail"}
    # the hand count at 2x and 64 streams, as the JAX tool's
    assert bench_breakdown.conv_gflops(2, 64)["gflops_per_step"] == pytest.approx(
        ep.load_script("tools/bench_breakdown.py", "jax_bench_breakdown").conv_gflops(2, 64)["gflops_per_step"])


def test_bench_bc_breakdown_prints_its_keys(small_foundation, capsys):
    from vpt_tpu_torch.tools import bench_bc_breakdown

    out = bench_bc_breakdown.main(["--width", "1", "--batch", "1", "--chunk", "2", "--iters", "1",
                                   "--compute-dtype", "float32", "--cnn-detail", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]).keys() == out.keys()
    for k in ("fwd_ms", "grad_ms", "step_ms", "optimizer_ms", "cnn_grad_ms", "transformer_grad_ms",
              "tail_loss_grad_ms", "gn_ln_grad_microbench_ms"):
        assert out[k] > 0, k
    assert {"backward_ms", "fps_implied", "component_sum_vs_grad"} <= out["derived"].keys()
    assert {"stack0_grad_ms", "pool2_fwd_ms", "gn1_grad_ms", "conv_block_16_128_fwd_ms"} <= out["cnn_detail"].keys()


def test_bench_dataplane_modes(capsys):
    from vpt_tpu_torch.tools import bench_dataplane

    ep.native_video()
    sweep = bench_dataplane.main(["--frames", "30", "--batches", "1", "16"])
    assert sweep["batch_1_frames"] == sweep["batch_16_frames"] > 0 and sweep["speedup"] > 0
    stages = bench_dataplane.main(["--frames", "30", "--stages"])
    assert stages["frames"] == 30 and stages["stage_ms_per_frame"].keys() == {"decode", "resize", "composite"}
    with pytest.raises(FileNotFoundError, match="reference-checkout"):
        bench_dataplane.main(["--bakeoff", "--reference-checkout", "/nonexistent"])
