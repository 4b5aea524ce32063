"""The port's episode evaluation harness (vpt_tpu_torch/agent/evaluation.py)
and frame annotation (data/annotate.py) against vpt_tpu's, on the CPU:

  * ``evaluate_episodes`` with ``stochastic=False`` on the port's MineRLAgent
    and on vpt_tpu's, on the same weights, envs and reward: the same
    episodes, returns and action statistics, exactly (argmax actions at a
    tiny config), and mean_vpred within 2e-3 (the policy parity tolerance);
  * the report's contract as tests/test_evaluation.py checks it, and
    ``compare_reports`` and ``_is_null_action`` equal to vpt_tpu's;
  * annotation: equal rows and equal pixels (PIL); the recording path
    skips where the native video library cannot be built (no libav).
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import json

import jax
import numpy as np
import pytest

from vpt_tpu.agent import MineRLAgent as JaxAgent
from vpt_tpu.agent import evaluation as jax_evaluation
from vpt_tpu.agent.rollout import MockMinecraftEnv as JaxMockEnv
from vpt_tpu_torch.agent import MineRLAgent, compare_reports, evaluate_episodes
from vpt_tpu_torch.agent import evaluation
from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
from vpt_tpu_torch.checkpoint import from_jax_variables, load_state_dict_report

TINY_KWARGS = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], img_shape=[64, 64, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    impala_kwargs={"post_pool_groups": 1}, n_recurrence_layers=2, timesteps=4,
    attention_heads=4, attention_memory_size=8, recurrence_type="transformer",
    attention_mask_style="clipped_causal", use_pre_lstm_ln=False,
    obs_processing_width=32,
)
PI_KWARGS = {"temperature": 2.0}


def _rewarding(base):
    class RewardingMockEnv(base):
        """+1 a step while 'forward' is pressed; episodes end at a fixed horizon."""

        def __init__(self, seed=0, horizon=7):
            super().__init__(seed=seed)
            self._horizon, self._n = horizon, 0

        def reset(self):
            self._n = 0
            return super().reset()

        def step(self, action):
            obs, _r, _d, info = super().step(action)
            self._n += 1
            return obs, float(action.get("forward", 0) == 1), self._n >= self._horizon, info

    return RewardingMockEnv


RewardingMockEnv = _rewarding(MockMinecraftEnv)
JaxRewardingMockEnv = _rewarding(JaxMockEnv)


@pytest.fixture(scope="module")
def agents():
    ref = JaxAgent(policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=2)
    ref._ensure_variables()
    port = MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=2)
    report = load_state_dict_report(port.policy, from_jax_variables(jax.tree.map(np.asarray, ref.variables)))
    assert not report["missing"] and not report["unexpected"]
    return ref, port


def test_deterministic_evaluation_matches_vpt_tpu(agents):
    ref, port = agents
    ref.reset()
    port.reset()
    ours = evaluate_episodes(port, [RewardingMockEnv(seed=i, horizon=5 + i) for i in range(2)], n_episodes=5,
                             max_episode_steps=6, stochastic=False)
    theirs = jax_evaluation.evaluate_episodes(ref, [JaxRewardingMockEnv(seed=i, horizon=5 + i) for i in range(2)],
                                              n_episodes=5, max_episode_steps=6, stochastic=False)
    assert ours["per_episode"] == theirs["per_episode"]
    assert ours["action_stats"] == theirs["action_stats"]
    for key in ("episodes", "mean_return", "std_return", "min_return", "max_return", "mean_length",
                "truncated_episodes", "steps"):
        assert ours[key] == theirs[key], key
    np.testing.assert_allclose(ours["mean_vpred"], theirs["mean_vpred"], rtol=2e-3, atol=2e-3)
    assert ours["latency"].keys() == theirs["latency"].keys()


def test_evaluate_episodes_report(agents):
    _, port = agents
    report = evaluate_episodes(port, [RewardingMockEnv(seed=i, horizon=7) for i in range(2)], n_episodes=5,
                               max_episode_steps=100)
    assert report["episodes"] == len(report["per_episode"]) == 5
    assert all(e["length"] == 7 for e in report["per_episode"]) and report["truncated_episodes"] == 0
    assert 0.0 <= report["mean_return"] <= 7.0 and report["mean_vpred"] is not None
    stats = report["action_stats"]
    assert 0.0 <= stats["null_action_rate"] <= 1.0 and 0.0 <= stats["camera_move_rate"] <= 1.0
    assert all(0.0 <= r <= 1.0 for r in stats["button_press_rate"].values())
    assert report["latency"]["p99_ms"] >= report["latency"]["p50_ms"] > 0
    json.dumps(report)


def test_evaluate_truncation_and_seeded_repeats():
    envs = [MockMinecraftEnv(seed=i) for i in range(2)]
    agent = MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=2, seed=3)
    report = evaluate_episodes(agent, envs, n_episodes=2, max_episode_steps=5)
    assert report["truncated_episodes"] == 2
    assert all(e["length"] == 5 and e["truncated"] for e in report["per_episode"])

    def run():
        ag = MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=2, seed=3)
        return evaluate_episodes(ag, [RewardingMockEnv(seed=i, horizon=6) for i in range(2)], n_episodes=4,
                                 max_episode_steps=50)

    a, b = run(), run()
    assert a["per_episode"] == b["per_episode"] and a["action_stats"] == b["action_stats"]


def test_compare_reports_and_null_action_match_vpt_tpu():
    rng = np.random.default_rng(0)
    a = {"per_episode": [{"return": float(x)} for x in rng.normal(size=6)]}
    b = {"per_episode": [{"return": float(x)} for x in rng.normal(1.0, size=5)]}
    assert compare_reports(a, b) == jax_evaluation.compare_reports(a, b)
    actions = [{"attack": np.array(0), "camera": np.array([0.0, 0.0])},
               {"attack": np.array(1), "camera": np.array([0.0, 0.0])},
               {"attack": np.array(0), "camera": np.array([0.0, -0.5])}]
    assert [evaluation._is_null_action(x) for x in actions] == [jax_evaluation._is_null_action(x) for x in actions]
    assert [evaluation._is_null_action(x) for x in actions] == [True, False, False]


def test_annotation_matches_vpt_tpu():
    pytest.importorskip("PIL")
    from vpt_tpu.data import annotate as jax_annotate
    from vpt_tpu_torch.data import annotate

    action = {"attack": np.array(1), "camera": np.array([1.25, -3.0])}
    recorded = {"attack": np.array(0), "camera": np.array([1.0, -2.0])}
    for rec in (None, recorded):
        assert annotate.action_rows(action, rec) == jax_annotate.action_rows(action, rec)
    frame = np.random.default_rng(0).integers(0, 256, (90, 160, 3), dtype=np.uint8)
    rows = annotate.action_rows(action)
    np.testing.assert_array_equal(annotate.annotate_frame(frame, rows), jax_annotate.annotate_frame(frame, rows))


def test_evaluation_recording(agents, tmp_path):
    pytest.importorskip("PIL")
    from vpt_tpu_torch.data import video

    try:
        video.build()
    except Exception as e:  # no libav or no g++: the recording path cannot run here
        pytest.skip(f"native video library of the port cannot be built: {e}")
    _, port = agents
    out = str(tmp_path / "eval.mp4")
    report = evaluate_episodes(port, [RewardingMockEnv(seed=i, horizon=5) for i in range(2)], n_episodes=2,
                               max_episode_steps=100, record_path=out)
    assert report["recording"] == out
    with video.VideoReader(out) as cap:
        n = 0
        while cap.read() is not None:
            n += 1
    assert n == report["steps"] // 2  # one frame of stream 0 a step
