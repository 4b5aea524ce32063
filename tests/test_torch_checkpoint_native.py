"""The port's native checkpoints and resume (vpt_tpu_torch/checkpoint/
native.py, averaging.py, the loader's cursor and the trainers' hooks), on
the CPU at tiny configs.

  * save/restore round trips, ``latest_step``, retention (``keep=2``, the
    case of tests/test_resume.py), the data state, and a save killed midway
    (its temporary directory is ignored);
  * averaging against vpt_tpu's on the same state_dicts: equal;
  * the loader's cursor: a loader resumed from ``state()`` yields exactly
    the batches an uninterrupted one yields after that point;
  * a BC and an IDM run stopped by SIGTERM after one step and resumed from
    the checkpoint it left: the same per-step losses (rtol 1e-6) and steps
    as an uninterrupted run, and the old SIGTERM handler back afterwards
    (these skip without libav, as tests/test_torch_data.py);
  * a PPO trainer restored from a checkpoint after one update: the same
    next collect and update as the uninterrupted trainer (rtol 1e-6), and
    ``train(resume=True)`` goes on from the snapshot's update count.
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import io
import json
import os
import signal

import numpy as np
import pytest
import torch

from vpt_tpu.checkpoint import averaging as jax_averaging
from vpt_tpu_torch.checkpoint import averaging, native
from vpt_tpu_torch.data import loader
from vpt_tpu_torch.utils.metrics import MetricsLogger

from test_torch_data import _collect, _dataset, native as native_lib  # noqa: F401  (a fixture)


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


# ------------------------------------------------------------- the module


def test_save_restore_round_trip(tmp_path):
    g = torch.Generator().manual_seed(3)
    variables = {"policy": {"w": torch.randn(3, 4, generator=g), "q": torch.tensor([1, -2], dtype=torch.int8)}}
    opt = {"state": {0: {"exp_avg": torch.ones(2)}}, "param_groups": [{"lr": 0.1, "params": [0]}]}
    extra = {"recurrent_state": [{"k": torch.zeros(2, 3), "state_mask": torch.ones(2, 3, dtype=torch.bool)}]}
    path = native.save_checkpoint(str(tmp_path), 7, variables, opt_state=opt, data_state={"streams": [[0, 2]]},
                                  rng_state={"sample": g.get_state()}, extra=extra)
    assert path == str(tmp_path / "step_7") and native.latest_step(str(tmp_path)) == 7
    payload, data_state = native.restore_checkpoint(str(tmp_path))
    assert data_state == {"streams": [[0, 2]]}
    for k, v in variables["policy"].items():
        assert torch.equal(payload["variables"]["policy"][k], v) and payload["variables"]["policy"][k].dtype == v.dtype
    assert torch.equal(payload["opt_state"]["state"][0]["exp_avg"], torch.ones(2))
    assert payload["opt_state"]["param_groups"] == opt["param_groups"]
    assert torch.equal(payload["rng_state"]["sample"], g.get_state())
    assert torch.equal(payload["extra"]["recurrent_state"][0]["state_mask"], torch.ones(2, 3, dtype=torch.bool))
    assert native.restore_checkpoint(str(tmp_path / "none")) == (None, None)


def test_checkpoint_retention_and_resave(tmp_path):
    for step in (1, 2, 3, 4, 5):
        native.save_checkpoint(str(tmp_path), step, {"w": torch.full((3,), float(step))}, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    native.save_checkpoint(str(tmp_path), 5, {"w": torch.full((3,), 9.0)}, keep=2)  # the same step again
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    assert torch.equal(native.restore_checkpoint(str(tmp_path))[0]["variables"]["w"], torch.full((3,), 9.0))
    payload, _ = native.restore_checkpoint(str(tmp_path), step=4)
    assert torch.equal(payload["variables"]["w"], torch.full((3,), 4.0))


def test_a_save_killed_midway_leaves_the_last_step(tmp_path):
    native.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    (tmp_path / ".tmp_step_2").mkdir()  # what a save of step 2 killed before its rename leaves
    (tmp_path / ".tmp_step_2" / "payload.pt").write_bytes(b"partial")
    assert native.latest_step(str(tmp_path)) == 1
    assert torch.equal(native.restore_checkpoint(str(tmp_path))[0]["variables"]["w"], torch.ones(2))
    native.save_checkpoint(str(tmp_path), 2, {"w": torch.zeros(2)})
    assert native.latest_step(str(tmp_path)) == 2 and not (tmp_path / ".tmp_step_2").exists()


def test_data_state_alone(tmp_path):
    native.save_data_state(str(tmp_path), 3, {"streams": [[1, 0]], "step_count": 3}, keep=2)
    native.save_data_state(str(tmp_path), 4, {"streams": [[1, 1]], "step_count": 4}, keep=2)
    assert native.restore_data_state(str(tmp_path)) == {"streams": [[1, 1]], "step_count": 4}
    assert native.restore_data_state(str(tmp_path), step=3)["step_count"] == 3
    assert native.restore_data_state(str(tmp_path / "none")) is None


def test_averaging_matches_vpt_tpu(tmp_path):
    rng = np.random.default_rng(0)
    sds = [{"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32),
            "n": np.array(7 + i, np.int64)} for i in range(3)]
    want = jax_averaging.average_state_dicts(sds)
    got = averaging.average_state_dicts([{k: torch.from_numpy(v) for k, v in sd.items()} for sd in sds])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    paths = []
    for i, sd in enumerate(sds):
        paths.append(str(tmp_path / f"{i}.weights"))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths[-1])
    np.testing.assert_array_equal(averaging.load_average(paths)["a"].numpy(), want["a"])
    with pytest.raises(ValueError):
        averaging.average_state_dicts([{"a": torch.ones(1)}, {"b": torch.ones(1)}])


# ------------------------------------------------------------ the loader


def test_loader_resumes_without_skip_or_repeat(native_lib, tmp_path):
    _dataset(tmp_path)
    kw = dict(batch_size=2, chunk_len=4, n_epochs=2, seed=5, resolution=(32, 32))
    whole = _collect(loader.SequenceDataLoader(str(tmp_path), **kw))
    assert len(whole) > 3
    for cut in (1, 2):
        first = loader.SequenceDataLoader(str(tmp_path), **kw)
        try:
            for _ in range(cut):
                next(first)
            cursor = json.loads(json.dumps(first.state()))  # as a checkpoint stores it
        finally:
            first.close()
        rest = _collect(loader.SequenceDataLoader(str(tmp_path), resume_state=cursor, **kw))
        assert len(rest) == len(whole) - cut
        for b, want in zip(rest, whole[cut:]):
            for key in ("frames", "buttons", "camera", "firsts", "mask", "episode_ids"):
                np.testing.assert_array_equal(b[key], want[key], err_msg=f"cut {cut}: {key}")


# ------------------------------------------------ trainers: stop and resume


class _StopAfter(MetricsLogger):
    """Logs to a buffer and sends this process SIGTERM after step ``n``, as
    a scheduler preempting the job would."""

    def __init__(self, n=None):
        self.buffer = io.StringIO()
        super().__init__(stream=self.buffer)
        self.n = n

    def log(self, **kw):
        super().log(**kw)
        if self.n is not None and kw.get("step") == self.n:
            os.kill(os.getpid(), signal.SIGTERM)

    def rows(self):
        return [json.loads(line) for line in self.buffer.getvalue().splitlines()]


def _stopped_and_resumed(make, tmp_path, data):
    """(rows of an uninterrupted run, rows of a run stopped after step 1,
    rows of its resumption, the two runs' final weights)."""
    calls = []
    old = signal.signal(signal.SIGTERM, lambda *a: calls.append(a))
    try:
        whole = make()
        log_whole = _StopAfter()
        steps = whole.train(data, str(tmp_path / "whole.weights"), metrics=log_whole)

        ckpt = str(tmp_path / "ckpt")
        stopped = make(checkpoint_dir=ckpt)
        log_stopped = _StopAfter(1)
        assert stopped.train(data, str(tmp_path / "stopped.weights"), metrics=log_stopped) == 1
        assert signal.getsignal(signal.SIGTERM) is not None and calls == []  # ours took the signal ...
        assert native.latest_step(ckpt) == 1

        resumed = make(checkpoint_dir=ckpt)
        log_resumed = _StopAfter()
        assert resumed.train(data, str(tmp_path / "resumed.weights"), metrics=log_resumed, resume_dir=ckpt) == steps
        handler = signal.getsignal(signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert handler is not old and handler.__name__ == "<lambda>"  # ... and gave the old handler back
    return log_whole.rows(), log_stopped.rows(), log_resumed.rows(), whole, resumed


def _check_resumed(rows_whole, rows_stopped, rows_resumed, whole, resumed):
    losses = [r["loss"] for r in rows_whole if "loss" in r]
    assert len(losses) >= 3
    assert [r["event"] for r in rows_stopped if "event" in r] == ["preempted"]
    got = [r["loss"] for r in rows_stopped if "loss" in r] + [r["loss"] for r in rows_resumed if "loss" in r]
    assert [r["step"] for r in rows_resumed if "loss" in r] == list(range(2, len(losses) + 1))
    np.testing.assert_allclose(got, losses, rtol=1e-6)
    for (name, a), b in zip(whole.policy.state_dict().items(), resumed.policy.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


def test_bc_run_stopped_and_resumed_equals_uninterrupted(native_lib, tmp_path):
    from vpt_tpu_torch.training import bc

    from test_torch_training import PI_KWARGS, TINY_KWARGS

    data = tmp_path / "data"
    data.mkdir()
    _dataset(data)

    def make(**hp):
        return bc.BCTrainer(TINY_KWARGS, PI_KWARGS, device="cpu", seed=3, hp=bc.BCHyperparams(
            batch_size=2, chunk_len=4, epochs=2, learning_rate=1e-3, loss_report_rate=1, **hp))

    rows = _stopped_and_resumed(make, tmp_path, str(data))
    _check_resumed(*rows)
    # the checkpoint carried a mid-trajectory cursor and the streams' recurrent state
    payload, data_state = native.restore_checkpoint(str(tmp_path / "ckpt"), step=1)
    assert [c[1] for c in data_state["streams"]] == [1, 1] and data_state["step_count"] == 1
    assert len(payload["extra"]["recurrent_state"]) == TINY_KWARGS["n_recurrence_layers"]


def test_idm_run_stopped_and_resumed_equals_uninterrupted(native_lib, tmp_path):
    from vpt_tpu_torch.training import idm

    from test_torch_idm import IDM_TINY_KWARGS, PI_KWARGS

    data = tmp_path / "data"
    data.mkdir()
    _dataset(data)

    def make(**hp):
        return idm.IDMTrainer(IDM_TINY_KWARGS, PI_KWARGS, device="cpu", seed=3, hp=idm.IDMHyperparams(
            batch_size=2, window=4, epochs=2, learning_rate=1e-3, loss_report_rate=1, **hp))

    _check_resumed(*_stopped_and_resumed(make, tmp_path, str(data)))


def test_ppo_resume_continues_exactly(tmp_path):
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.training import rl

    from test_torch_rl import PI_KWARGS, TINY_KWARGS

    hp = dict(rollout_len=6, n_minibatches=2, n_epochs=2, learning_rate=1e-3, kl_decay=0.9)

    def make():
        t = rl.PPOTrainer(TINY_KWARGS, PI_KWARGS, hp=rl.PPOHyperparams(**hp), device="cpu", seed=4)
        t.init()
        return t

    def envs(seed):
        return [MockMinecraftEnv(seed=seed + i, done_prob=0.1) for i in range(4)]

    whole = make()
    traj, _, _ = whole.collect(envs(0))
    whole.update(traj)
    ckpt = str(tmp_path / "ppo")
    whole.save_checkpoint(ckpt)

    resumed = make()
    assert resumed.resume(ckpt) and resumed.update_count == 1 and resumed.kl_coef == whole.kl_coef
    assert not make().resume(str(tmp_path / "none"))
    for t in (whole, resumed):
        t._group_states = None  # the env streams restart on resume; both go on from fresh envs
    got = [t.update(t.collect(envs(100))[0]) for t in (whole, resumed)]
    assert got[0].keys() == got[1].keys()
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], rtol=1e-6, atol=1e-9, err_msg=k)
    for (name, a), b in zip(whole.policy.state_dict().items(), resumed.policy.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(whole.sample_generator.get_state(), resumed.sample_generator.get_state())

    # train(): snapshots every update and goes on from the newest with resume=True
    t = make()
    t.train(envs(0), 1, checkpoint_dir=ckpt, checkpoint_every=1, metrics=MetricsLogger(stream=io.StringIO()))
    t = make()
    t.train(envs(0), 2, checkpoint_dir=ckpt, resume=True, metrics=MetricsLogger(stream=io.StringIO()))
    assert t.update_count == 2 and native.latest_step(ckpt) == 1
