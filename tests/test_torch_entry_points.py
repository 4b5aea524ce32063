"""The port's command-line entry points against vpt_tpu's, on the CPU at tiny
configs, each called in process through ``main(argv)``:

  * ``python -m vpt_tpu_torch.run_agent --mock-env``: its argmax actions,
    step by step on the same seeds' env streams, equal the root
    run_agent.py's on the same ``.model``/``.weights`` files (both agents'
    ``get_action`` made deterministic; float32 at one stream); the
    automatic groups and the SystemExits of ``--mesh-dp`` and ``--record``
    are the JAX script's;
  * ``python -m vpt_tpu_torch.run_inverse_dynamics_model``: print mode
    (``--jsonl-path``, ``--n-batches``, ``--metrics``) and streaming mode
    (``--stride``, ``--metrics``) write the same jsonl rows and print the
    same agreement summary as the root script on the same video;
    ``--out-video`` writes one annotated frame a label (needs libav and
    PIL);
  * ``python -m vpt_tpu_torch.tools.eval_agent``: a deterministic report's
    episodes and action statistics equal tools/eval_agent.py's, its mean
    value within 2e-3 (the policy parity tolerance), and ``--compare`` of two
    reports is the JAX tool's; without ``--weights`` the weights come from
    ``--seed``;
  * every entry point that runs a model raises without CUDA unless
    ``--device cpu`` is given.
"""

import torch_cpu

import importlib.util
import json
import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_KWARGS = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], img_shape=[64, 64, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    impala_kwargs={"post_pool_groups": 1}, n_recurrence_layers=2, timesteps=4,
    attention_heads=4, attention_memory_size=8, recurrence_type="transformer",
    attention_mask_style="clipped_causal", use_pre_lstm_ln=False,
    obs_processing_width=32,
)
PI_KWARGS = {"temperature": 2.0}
IDM_TINY_KWARGS = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], img_shape=[64, 64, 8],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    impala_kwargs={"post_pool_groups": 1}, n_recurrence_layers=2, timesteps=8,
    attention_heads=4, attention_memory_size=16, recurrence_type="transformer",
    attention_mask_style="none", use_pre_lstm_ln=False, obs_processing_width=32,
    conv3d_params={"inchan": 3, "outchan": 8, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]},
)
IDM_PI_KWARGS = {"temperature": 1.0}


def load_script(path, name):
    """A root script or tool of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_tool(path, argv):
    """``main()`` of a JAX tool with ``sys.argv`` patched, vpt_tpu's native
    video library loaded first where it can be."""
    torch_cpu.jax_native_video()
    module = load_script(path, "jax_" + os.path.basename(path)[:-3])
    with mock.patch.object(sys, "argv", [path] + list(argv)):
        return module.main()


def native_video():
    from vpt_tpu_torch.data import video

    try:
        video.build()
    except RuntimeError as e:
        pytest.skip(f"native video library of the port cannot be built: {e}")


def jax_native_video():
    """vpt_tpu's native video library, for a test that reaches it after
    ``native_video()``: libav is there, so a library that will not load is a
    failure, not a skip."""
    from vpt_tpu.data import video as jax_video

    lib = torch_cpu.jax_native_video()
    assert lib is not None, f"vpt_tpu's native video library does not load: {jax_video._lib_error}"
    return lib


def write_recording(base, n_frames, width=160, height=90, seed=0):
    """``base``.mp4 of random frames and ``base``.jsonl of contractor rows
    (keys, mouse moves, clicks, a GUI segment)."""
    from vpt_tpu_torch.data.video import VideoWriter

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n_frames, height, width, 3), dtype=np.uint8)
    with VideoWriter(base + ".mp4", width, height, fps=20) as w:
        for f in frames:
            w.write(f)
    keys = ["key.keyboard.w", "key.keyboard.a", "key.keyboard.space", "key.keyboard.s"]
    with open(base + ".jsonl", "w") as f:
        for i in range(n_frames):
            f.write(json.dumps({
                "mouse": {"x": 320.0 + i, "y": 180.0, "dx": float(i % 5 - 2), "dy": float(i % 3),
                          "buttons": [0] if i % 4 == 1 else [], "newButtons": [0] if i % 4 == 1 else []},
                "keyboard": {"keys": [keys[i % 4]] if i % 3 else []},
                "hotbar": (i // 5) % 9, "isGuiOpen": i % 11 == 10}) + "\n")
    return frames


def write_model_files(tmp):
    """The tiny policy's and IDM's ``.model``/``.weights`` under ``tmp``, the
    weights vpt_tpu's random initial ones; returns their paths by name."""
    from vpt_tpu.agent import IDMAgent as JaxIDMAgent
    from vpt_tpu.agent import MineRLAgent as JaxAgent
    from vpt_tpu_torch.checkpoint import from_jax_variables, save_model_parameters

    import torch

    out = {k: os.path.join(tmp, k) for k in ("policy.model", "policy.weights", "idm.model", "idm.weights")}
    ref = JaxAgent(policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS)
    ref._ensure_variables()
    save_model_parameters(out["policy.model"], TINY_KWARGS, PI_KWARGS)
    torch.save(from_jax_variables(jax.tree.map(np.asarray, ref.variables)), out["policy.weights"])
    idm = JaxIDMAgent(idm_net_kwargs=IDM_TINY_KWARGS, pi_head_kwargs=IDM_PI_KWARGS)
    idm._ensure_variables()
    save_model_parameters(out["idm.model"], IDM_TINY_KWARGS, IDM_PI_KWARGS)
    torch.save(from_jax_variables(jax.tree.map(np.asarray, idm.variables)), out["idm.weights"])
    out["dir"] = str(tmp)
    return out


@pytest.fixture(autouse=True, scope="module")
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    import torch

    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_model_files(str(tmp_path_factory.mktemp("entry_points")))


# ------------------------------------------------------------------ run_agent


def _deterministic(agent_cls, taken):
    """``agent_cls`` whose get_action takes the argmax and records it."""

    class Deterministic(agent_cls):
        def get_action(self, minerl_obs, first=None, stochastic=True):
            action = super().get_action(minerl_obs, first=first, stochastic=False)
            taken.append(action)
            return action

    return Deterministic


def test_run_agent_mock_env_actions_equal_vpt_tpu(files, capsys):
    from vpt_tpu_torch import run_agent

    ours, theirs = [], []
    with mock.patch.object(run_agent, "MineRLAgent", _deterministic(run_agent.MineRLAgent, ours)):
        stats = run_agent.main(["--model", files["policy.model"], "--weights", files["policy.weights"],
                                "--mock-env", "--steps", "4", "--device", "cpu"])
    jax_script = load_script("run_agent.py", "jax_run_agent")
    with mock.patch.object(jax_script, "MineRLAgent", _deterministic(jax_script.MineRLAgent, theirs)):
        jax_script.main(files["policy.model"], files["policy.weights"], mock_env=True, steps=4)
    assert stats["frames"] == 4 and stats["groups"] == 1 and stats["latency"]["steps"] == 4
    assert len(ours) == len(theirs) == 4
    for t, (a, b) in enumerate(zip(ours, theirs)):
        a, b = a[0], b[0]
        assert a.keys() == b.keys()
        for k in a:  # the camera's degrees undiscretized in float32 against float64
            np.testing.assert_allclose(np.asarray(a[k], np.float64), np.asarray(b[k], np.float64), rtol=0,
                                       atol=1e-6 if k == "camera" else 0, err_msg=f"step {t} {k}")
    printed = capsys.readouterr().out
    assert "frames/sec end-to-end" in printed and "step 0: pressed=" in printed


@pytest.mark.parametrize("streams,mesh_dp,groups", [(8, 0, 4), (4, 0, 2), (6, 0, 2), (3, 0, 1), (1, 0, 1),
                                                    (16, 2, 4), (8, 2, 4), (8, 4, 2), (6, 3, 2), (2, 2, 1)])
def test_run_agent_automatic_groups(streams, mesh_dp, groups):
    """The JAX script's rule (run_agent.py:69-77): 4, 2 or 1 groups, each
    group's streams dividing over the dp ranks, a group at least 2 streams."""
    from vpt_tpu_torch.run_agent import auto_groups

    assert auto_groups(streams, mesh_dp) == groups


@pytest.mark.parametrize("kw", [dict(mock_env=False, mesh_dp=2), dict(mock_env=True, record="x.mp4", groups=2),
                                dict(mock_env=True, streams=6, groups=2, mesh_dp=2)])
def test_run_agent_system_exits_are_the_jax_scripts(files, kw, monkeypatch):
    from vpt_tpu_torch import run_agent

    # a dp=2 group as under torchrun: the streams' check comes before any agent
    monkeypatch.setattr(run_agent.pmesh, "maybe_initialize_distributed", lambda device: True)
    monkeypatch.setattr(run_agent.pmesh, "make_mesh", lambda n_dp: object())
    jax_script = load_script("run_agent.py", "jax_run_agent")
    with pytest.raises(SystemExit) as theirs:
        jax_script.main(files["policy.model"], files["policy.weights"], **kw)
    with pytest.raises(SystemExit) as ours:
        run_agent.run_agent(files["policy.model"], files["policy.weights"], device="cpu", **kw)
    assert str(ours.value) == str(theirs.value)


def test_run_agent_mesh_dp_needs_torchrun(files, monkeypatch):
    from vpt_tpu_torch import run_agent

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node=2"):
        run_agent.main(["--model", files["policy.model"], "--weights", files["policy.weights"], "--mock-env",
                        "--streams", "4", "--mesh-dp", "2", "--device", "cpu"])


# ------------------------------------------------------------------ the IDM CLI


@pytest.fixture(scope="module")
def recording(files):
    native_video()
    base = os.path.join(files["dir"], "rec")
    frames = write_recording(base, 19)
    return base, frames


def _metrics_line(text):
    lines = [line for line in text.splitlines() if line.startswith("metrics:")]
    assert len(lines) == 1, text
    return json.loads(lines[0][len("metrics:"):])


@pytest.mark.parametrize("mode", ["print", "streaming"])
def test_idm_cli_rows_and_metrics_equal_vpt_tpu(files, recording, mode, capsys, tmp_path):
    from vpt_tpu_torch import run_inverse_dynamics_model as cli

    base, frames = recording
    ours, theirs = str(tmp_path / "ours.jsonl"), str(tmp_path / "theirs.jsonl")
    argv = ["--model", files["idm.model"], "--weights", files["idm.weights"], "--video-path", base + ".mp4",
            "--jsonl-path", base + ".jsonl", "--n-frames", "8", "--metrics", "--no-strict-resolution"]
    extra = ["--n-batches", "2"] if mode == "print" else ["--stride", "4", "--window-batch", "2"]
    n = cli.main(argv + extra + ["--out", ours, "--device", "cpu"])
    ours_metrics = _metrics_line(capsys.readouterr().out)
    jax_native_video()
    jax_script = load_script("run_inverse_dynamics_model.py", "jax_run_inverse_dynamics_model")
    jax_script.main(files["idm.model"], files["idm.weights"], base + ".mp4", base + ".jsonl",
                    2 if mode == "print" else None, 8, out=theirs, strict_resolution=False,
                    stride=4 if mode == "streaming" else None, window_batch=2, metrics=True)
    theirs_metrics = _metrics_line(capsys.readouterr().out)
    rows = [json.loads(line) for line in open(ours)]
    assert n == len(rows) == (16 if mode == "print" else len(frames))
    assert [r["frame"] for r in rows] == list(range(n))
    assert rows == [json.loads(line) for line in open(theirs)]
    assert ours_metrics == theirs_metrics and ours_metrics["frames"] == n


def test_idm_cli_default_batches_and_annotated_video(files, recording, tmp_path):
    """No --n-batches in print mode means the reference's 10 batches (here
    the whole 19 frames, in 3 batches of 8); --out-video writes each
    labeled frame, annotated, at the video's size."""
    from vpt_tpu_torch import run_inverse_dynamics_model as cli
    from vpt_tpu_torch.data.video import VideoReader

    pytest.importorskip("PIL")
    base, frames = recording
    out_video = str(tmp_path / "pred.mp4")
    n = cli.main(["--model", files["idm.model"], "--weights", files["idm.weights"], "--video-path", base + ".mp4",
                  "--n-frames", "8", "--out-video", out_video, "--no-strict-resolution", "--device", "cpu"])
    assert n == len(frames) and cli.PRINT_MODE_BATCHES == 10
    with VideoReader(out_video) as cap:
        assert (cap.width, cap.height) == (160, 90)
        written = 0
        while cap.read() is not None:
            written += 1
    assert written == len(frames)


def test_predict_batches_takes_frames_from_anywhere(files):
    """The print mode's device work on frame batches with no decode: the
    same rows as ``predict_actions`` on the batches in turn."""
    from vpt_tpu_torch.agent import IDMAgent, action_jsonl_row
    from vpt_tpu_torch.checkpoint import load_model_parameters
    from vpt_tpu_torch.run_inverse_dynamics_model import predict_batches

    def agent():
        a = IDMAgent(*load_model_parameters(files["idm.model"]), device="cpu")
        a.load_weights(files["idm.weights"])
        return a

    frames = np.random.default_rng(3).integers(0, 255, (2, 8, 90, 160, 3), dtype=np.uint8)
    rows = list(predict_batches(agent(), iter(frames)))
    direct, want = agent(), []
    for batch in frames:
        pred = direct.predict_actions(batch)
        want.extend(action_jsonl_row({k: v[0, i] for k, v in pred.items()}) for i in range(len(batch)))
    assert [i for i, _ in rows] == list(range(16))
    assert [r for _, r in rows] == want


# ------------------------------------------------------------------ eval_agent


EVAL_ARGS = ["--mock-env", "--episodes", "3", "--streams", "2", "--max-episode-steps", "4", "--deterministic",
             "--done-prob", "0.3", "--compute-dtype", "float32"]


def _strip_latency(report):
    return {k: v for k, v in report.items() if k not in ("latency", "mean_vpred", "seconds", "frames_per_sec")}


def test_eval_agent_report_and_compare_equal_vpt_tpu(files, tmp_path, capsys):
    from vpt_tpu_torch.tools import eval_agent

    weights = ["--model", files["policy.model"], "--weights", files["policy.weights"]]
    paths = {k: str(tmp_path / f"{k}.json") for k in ("ours0", "ours1", "theirs0")}
    ours = eval_agent.main(EVAL_ARGS + weights + ["--seed", "0", "--out", paths["ours0"], "--device", "cpu"])
    eval_agent.main(EVAL_ARGS + weights + ["--seed", "1", "--out", paths["ours1"], "--device", "cpu"])
    capsys.readouterr()
    run_jax_tool("tools/eval_agent.py", EVAL_ARGS + weights + ["--seed", "0", "--out", paths["theirs0"]])
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["episodes"] == theirs["episodes"] == 3
    assert _strip_latency(ours).keys() == _strip_latency(theirs).keys()
    assert _strip_latency(ours) == _strip_latency(theirs)
    assert abs(ours["mean_vpred"] - theirs["mean_vpred"]) <= 2e-3
    assert json.load(open(paths["ours0"])) == json.loads(json.dumps(ours))

    compared = eval_agent.main(["--compare", paths["ours0"], paths["ours1"], "--device", "cpu"])
    capsys.readouterr()
    run_jax_tool("tools/eval_agent.py", ["--compare", paths["ours0"], paths["ours1"]])
    assert compared == json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_agent_random_weights_come_from_the_seed(files):
    from vpt_tpu_torch.tools import eval_agent

    args = EVAL_ARGS + ["--model", files["policy.model"], "--device", "cpu"]
    a, b, c = (eval_agent.main(args + ["--seed", s]) for s in ("5", "5", "6"))
    assert a["episodes"] == b["episodes"] and a["mean_vpred"] == b["mean_vpred"]
    assert a["mean_vpred"] != c["mean_vpred"]
    with pytest.raises(SystemExit, match="only --mock-env"):
        eval_agent.main(["--episodes", "1", "--device", "cpu"])


# ------------------------------------------------------------------ devices


def _device_cases(files, tmp):
    os.makedirs(os.path.join(tmp, "videos"), exist_ok=True)
    open(os.path.join(tmp, "videos", "v.mp4"), "wb").close()
    policy = ["--model", files["policy.model"], "--weights", files["policy.weights"]]
    return {
        "run_agent": ("vpt_tpu_torch.run_agent", policy + ["--mock-env", "--steps", "1"]),
        "run_inverse_dynamics_model": ("vpt_tpu_torch.run_inverse_dynamics_model",
                                       ["--model", files["idm.model"], "--weights", files["idm.weights"],
                                        "--video-path", os.path.join(tmp, "videos", "v.mp4")]),
        "label_videos": ("vpt_tpu_torch.tools.label_videos",
                         ["--model", files["idm.model"], "--weights", files["idm.weights"],
                          "--video-dir", os.path.join(tmp, "videos"), "--out-dir", os.path.join(tmp, "labels")]),
        "eval_loss": ("vpt_tpu_torch.tools.eval_loss", ["--in-model", files["policy.model"], "--in-weights",
                                                        files["policy.weights"], "--data-dir", tmp]),
        "eval_agent": ("vpt_tpu_torch.tools.eval_agent", policy + ["--mock-env", "--episodes", "1"]),
        "average_weights": ("vpt_tpu_torch.tools.average_weights",
                            [os.path.join(tmp, "avg.weights"), files["policy.weights"], files["policy.weights"]]),
        "record_demonstrations": ("vpt_tpu_torch.tools.record_demonstrations",
                                  policy + ["--out-dir", os.path.join(tmp, "demos"), "--mock-env"]),
        "bench_breakdown": ("vpt_tpu_torch.tools.bench_breakdown", ["--streams", "1", "--iters", "1"]),
        "bench_bc_breakdown": ("vpt_tpu_torch.tools.bench_bc_breakdown", ["--batch", "1", "--chunk", "1"]),
    }


DEVICE_CASES = ["run_agent", "run_inverse_dynamics_model", "label_videos", "eval_loss", "eval_agent",
                "average_weights", "record_demonstrations", "bench_breakdown", "bench_bc_breakdown"]


@pytest.mark.parametrize("name", DEVICE_CASES)
def test_entry_point_needs_cuda_unless_told_cpu(files, tmp_path, monkeypatch, name):
    """No --device means CUDA: without a card the entry point raises before
    it runs anything, and never falls back to the CPU."""
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv = _device_cases(files, str(tmp_path))[name]
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        importlib.import_module(module).main(argv)
