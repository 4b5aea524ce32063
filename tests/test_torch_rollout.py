"""The port's rollout runtime (vpt_tpu_torch/agent/rollout.py) and the agent
methods the grouped runner uses, against vpt_tpu's on the CPU (as
tests/test_rollout_runner.py checks vpt_tpu's):

  * MockMinecraftEnv: frames and episode ends bit-equal to vpt_tpu's for the
    same seeds, pool and fresh-frame modes;
  * latency_stats and the on_step arity rule: equal to vpt_tpu's;
  * the runners: frame counts, resets, the pre-step observations given to
    on_step, per-group state isolation, a pending handle collected (never
    re-dispatched) across run() calls;
  * dispatch_action_with_state on initial_group_state: the same actions as
    dispatch_action on hidden_state, from the same seed;
  * predict_value: vpt_tpu's value on the same weights within 2e-3 (the
    policy parity tolerance of tests/test_torch_policy.py).
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import jax
import numpy as np
import pytest
import torch

from vpt_tpu.agent import MineRLAgent as JaxAgent
from vpt_tpu.agent import rollout as jax_rollout
from vpt_tpu_torch.agent import MineRLAgent
from vpt_tpu_torch.agent import rollout
from vpt_tpu_torch.agent.rollout import (
    BatchedRolloutRunner,
    GroupedRolloutRunner,
    MockMinecraftEnv,
    PipelinedRolloutRunner,
    latency_stats,
)
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


def _agent(batch_size, seed=0):
    return MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=batch_size,
                       seed=seed)


@pytest.mark.parametrize("seed,done_prob,fresh", [(0, 0.0, False), (3, 0.3, False), (7, 0.5, True)])
def test_mock_env_is_bit_equal_to_vpt_tpu(seed, done_prob, fresh):
    ours = MockMinecraftEnv(seed=seed, done_prob=done_prob, fresh_frames=fresh)
    theirs = jax_rollout.MockMinecraftEnv(seed=seed, done_prob=done_prob, fresh_frames=fresh)
    np.testing.assert_array_equal(ours.reset()["pov"], theirs.reset()["pov"])
    for step in range(30):
        a, b = ours.step({}), theirs.step({})
        assert a[0]["pov"].shape == (360, 640, 3) and a[0]["pov"].dtype == np.uint8
        np.testing.assert_array_equal(a[0]["pov"], b[0]["pov"], err_msg=f"step {step}")
        assert a[1:] == b[1:], step
        if a[2]:
            np.testing.assert_array_equal(ours.reset()["pov"], theirs.reset()["pov"])


def test_latency_stats_and_callback_arity_match_vpt_tpu():
    times = list(np.random.default_rng(0).uniform(0.005, 0.08, 57))
    assert latency_stats(times) == jax_rollout.latency_stats(times)
    assert latency_stats(times, env_hz=10.0) == jax_rollout.latency_stats(times, env_hz=10.0)
    assert latency_stats([]) == {}

    def two(actions, obs):
        pass

    cases = [lambda a: None, two, lambda *args: None, print, lambda a, b, c: None]
    assert [rollout._callback_arity(f) for f in cases] == [jax_rollout._callback_arity(f) for f in cases]


def test_batched_rollout_runner():
    agent = _agent(3)
    envs = [MockMinecraftEnv(seed=i, done_prob=0.3) for i in range(3)]
    runner = BatchedRolloutRunner(agent, envs)
    seen = []
    stats = runner.run(8, on_step=lambda a, o: seen.append((a, o)))
    assert stats["frames"] == 24 and stats["frames_per_sec"] > 0 and stats["latency"]["steps"] == 8
    assert len(seen) == 8 and len(seen[0][0]) == 3
    # on_step gets the observations the actions were computed from: the pre-step ones
    assert seen[0][1][0]["pov"] is not seen[1][1][0]["pov"] and seen[0][1][0]["pov"].shape == (360, 640, 3)
    assert runner.episode_steps.max() <= 8
    legacy = []
    runner.run(2, on_step=lambda actions: legacy.append(actions))
    assert len(legacy) == 2 and len(legacy[0]) == 3


def test_pipelined_rollout_runner():
    a, b = _agent(2), _agent(2, seed=1)
    b.policy.load_state_dict(a.policy.state_dict())  # one set of weights
    runner = PipelinedRolloutRunner(a, b, [MockMinecraftEnv(seed=i, done_prob=0.2) for i in range(2)],
                                    [MockMinecraftEnv(seed=10 + i, done_prob=0.2) for i in range(2)])
    stats = runner.run(6)
    assert stats["frames"] == 24 and stats["frames_per_sec"] > 0


def test_grouped_rollout_runner():
    agent = _agent(2)
    runner = GroupedRolloutRunner(agent, [MockMinecraftEnv(seed=i, done_prob=0.2) for i in range(6)], n_groups=3)
    stats = runner.run(5)
    assert stats["frames"] == 30 and stats["latency"]["steps"] == 5
    handles = [g["handle"] for g in runner.groups]
    assert all(h is not None for h in handles)
    runner.run(1)  # the pending handles are collected first, not dispatched again
    assert all(g["handle"] is not h for g, h in zip(runner.groups, handles))
    with pytest.raises(AssertionError):
        GroupedRolloutRunner(agent, [MockMinecraftEnv(seed=i) for i in range(6)], n_groups=2)


def test_grouped_runner_state_isolation():
    agent = _agent(2)
    runner = GroupedRolloutRunner(agent, [MockMinecraftEnv(seed=i) for i in range(4)], n_groups=2)
    runner.run(2)
    s0, s1 = runner.groups[0]["state"], runner.groups[1]["state"]
    assert s0 is not s1 and s0[0]["k"].data_ptr() != s1[0]["k"].data_ptr()
    assert any(not torch.equal(a["k"], b["k"]) for a, b in zip(s0, s1))


def test_dispatch_with_state_equals_dispatch_on_hidden_state():
    """One seed, one stream of observations: stepping an explicit group state
    gives the actions and values of stepping the agent's own hidden state,
    and leaves hidden_state alone."""
    a, b = _agent(2, seed=5), _agent(2, seed=5)
    hidden0 = [{k: v.clone() if torch.is_tensor(v) else v for k, v in blk.items()} for blk in b.hidden_state]
    state = b.initial_group_state()
    assert [blk["idx"] for blk in state] == [0, 0] and not state[0]["state_mask"].any()
    rng = np.random.default_rng(0)
    for step in range(5):
        obs = [{"pov": rng.integers(0, 256, (90, 160, 3), dtype=np.uint8)} for _ in range(2)]
        first = np.array([step == 0, step in (0, 3)])
        want = a.collect_action(a.dispatch_action(obs, first=first))
        handle, state = b.dispatch_action_with_state(obs, state, first=first)
        got = b.collect_action(handle)
        for x, y in zip(got, want):
            assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        np.testing.assert_array_equal(b._last_vpred, a._last_vpred)
    for blk, blk0 in zip(b.hidden_state, hidden0):
        assert all(torch.equal(blk[k], blk0[k]) if torch.is_tensor(blk[k]) else blk[k] == blk0[k] for k in blk)


def test_predict_value_matches_vpt_tpu():
    ref = JaxAgent(policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=2)
    ref._ensure_variables()
    port = _agent(2)
    report = load_state_dict_report(port.policy, from_jax_variables(jax.tree.map(np.asarray, ref.variables)))
    assert not report["missing"] and not report["unexpected"]
    rng = np.random.default_rng(1)
    for step in range(3):
        obs = [{"pov": rng.integers(0, 256, (90, 160, 3), dtype=np.uint8)} for _ in range(2)]
        first = np.array([step == 0, step == 0])
        got, want = port.predict_value(obs, first=first), ref.predict_value(obs, first=first)
        assert got.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    single = _agent(1)
    assert isinstance(single.predict_value({"pov": np.zeros((90, 160, 3), np.uint8)}), float)
