"""Batched rollout runtime: N parallel env streams through one agent
(counterpart of vpt_tpu/agent/rollout.py).

The runners overlap host work (frame resize, action decode, env stepping)
with the device step: ``dispatch_action`` enqueues a step on the card and
returns at once, and only ``collect_action``'s copy of the actions back to
the host waits for it.  ``MockMinecraftEnv`` stands in for the Java MineRL
env, so the runtime and its throughput run anywhere; its frames equal
vpt_tpu's for the same seed.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np


def latency_stats(step_seconds: List[float], env_hz: float = 20.0) -> dict:
    """Serving-latency percentiles over per-step wall times.

    ``realtime_factor`` is the margin against the recording rate the policy
    was trained at (20 Hz, reference README.md:311 — contractor video is
    20 fps): the p99 step must finish inside one 50 ms env tick for the
    agent to keep up with a live env.  >1 means real-time serving holds
    even at the tail."""
    if not step_seconds:
        return {}
    ms = np.asarray(step_seconds) * 1e3
    budget_ms = 1e3 / env_hz
    return {
        "steps": int(ms.size),
        "mean_ms": round(float(ms.mean()), 3),
        "p50_ms": round(float(np.percentile(ms, 50)), 3),
        "p90_ms": round(float(np.percentile(ms, 90)), 3),
        "p99_ms": round(float(np.percentile(ms, 99)), 3),
        "max_ms": round(float(ms.max()), 3),
        "realtime_factor_p99": round(budget_ms / float(np.percentile(ms, 99)), 3),
    }


class MockMinecraftEnv:
    """Synthetic stand-in for the MineRL env: 640×360 frames, accepts the
    standard action dict, episodes end with probability ``done_prob``.

    Frames cycle through a small pool made once from a fixed seed: fresh
    noise for every step (0.7 MB a frame) would make the env, which the
    framework does not own, a large share of a serving benchmark's host
    time.  ``fresh_frames=True`` draws fresh noise each step.
    """

    _POOL = None
    _POOL_SIZE = 24

    def __init__(self, seed: int = 0, done_prob: float = 0.0, fresh_frames: bool = False):
        self._rng = np.random.default_rng(seed)
        self._done_prob = done_prob
        self._fresh = fresh_frames
        self._t = seed  # desynchronize pool phase across streams
        if not fresh_frames and MockMinecraftEnv._POOL is None:
            pool_rng = np.random.default_rng(12345)
            MockMinecraftEnv._POOL = [
                pool_rng.integers(0, 255, (360, 640, 3), dtype=np.uint8)
                for _ in range(self._POOL_SIZE)
            ]

    def _frame(self):
        if self._fresh:
            return self._rng.integers(0, 255, (360, 640, 3), dtype=np.uint8)
        return MockMinecraftEnv._POOL[self._t % self._POOL_SIZE]

    def reset(self):
        self._t += 1
        return {"pov": self._frame()}

    def step(self, action):
        self._t += 1
        obs = {"pov": self._frame()}
        done = bool(self._rng.random() < self._done_prob)
        return obs, 0.0, done, {}


class PipelinedRolloutRunner:
    """Two stream groups pipelined against each other: while the device runs
    group A's step (and its result transfers back), the host steps group B's
    envs and prepares B's frames — hiding host/env/transfer latency behind
    device compute.  Needs two agents (independent recurrent state), which
    should hold the same weights.

    Semantics are identical to running each group with BatchedRolloutRunner —
    groups are independent sets of env streams.

    This wins when host/env work per step is comparable to device compute."""

    def __init__(self, agent_a, agent_b, envs_a: List, envs_b: List):
        assert agent_a.batch_size == len(envs_a) and agent_b.batch_size == len(envs_b)
        self.groups = [
            {"agent": agent_a, "envs": envs_a,
             "obs": [e.reset() for e in envs_a],
             "firsts": np.ones(len(envs_a), bool)},
            {"agent": agent_b, "envs": envs_b,
             "obs": [e.reset() for e in envs_b],
             "firsts": np.ones(len(envs_b), bool)},
        ]

    def _advance(self, g, actions):
        for i, (env, action) in enumerate(zip(g["envs"], actions)):
            obs, reward, done, info = env.step(action)
            if done:
                obs = env.reset()
                g["firsts"][i] = True
            else:
                g["firsts"][i] = False
            g["obs"][i] = obs

    def run(self, n_steps: int) -> dict:
        a, b = self.groups
        t0 = time.perf_counter()
        handle_a = a["agent"].dispatch_action(a["obs"], first=a["firsts"])
        total = 0
        for _ in range(n_steps):
            # device: B computes / A's result transfers — host: step A's envs
            handle_b = b["agent"].dispatch_action(b["obs"], first=b["firsts"])
            self._advance(a, a["agent"].collect_action(handle_a))
            total += len(a["envs"])
            handle_a = a["agent"].dispatch_action(a["obs"], first=a["firsts"])
            self._advance(b, b["agent"].collect_action(handle_b))
            total += len(b["envs"])
        a["agent"].collect_action(handle_a)
        dt = time.perf_counter() - t0
        return {"frames": total, "seconds": dt, "frames_per_sec": total / dt}


def _callback_arity(fn) -> int:
    """Number of positional args ``fn`` accepts (2 when it takes *args or
    can't be inspected), so ``run(on_step=...)`` also takes a
    single-argument ``on_step(actions)``."""
    import inspect

    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return 2
    if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
        return 2
    positional = [
        p for p in params
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ]
    return min(len(positional), 2)


class BatchedRolloutRunner:
    """Drives B envs with one batched agent, resetting streams on done."""

    def __init__(self, agent, envs: List):
        assert agent.batch_size == len(envs), (agent.batch_size, len(envs))
        self.agent = agent
        self.envs = envs
        self.obs = [env.reset() for env in envs]
        self.firsts = np.ones(len(envs), bool)
        self.episode_steps = np.zeros(len(envs), np.int64)

    def run(self, n_steps: int, on_step: Optional[Callable] = None) -> dict:
        """Step all streams n_steps times; returns throughput stats plus
        per-step serving-latency percentiles (``latency``).

        ``on_step(actions, obs)`` is called once per step with the sampled
        env actions and the observations they were computed FROM (the
        pre-step obs) — the pair a recorder or logger wants.  A
        single-argument callback (``on_step(actions)``) gets the actions
        alone: the arity is inspected once up front."""
        if on_step is not None and _callback_arity(on_step) == 1:
            one_arg = on_step
            on_step = lambda actions, obs: one_arg(actions)  # noqa: E731
        t0 = time.perf_counter()
        total = 0
        step_times = []
        for _ in range(n_steps):
            obs_before = list(self.obs)
            ts = time.perf_counter()
            actions = self.agent.get_action(self.obs, first=self.firsts)
            step_times.append(time.perf_counter() - ts)
            self.firsts[:] = False
            for i, (env, action) in enumerate(zip(self.envs, actions)):
                obs, reward, done, info = env.step(action)
                self.episode_steps[i] += 1
                if done:
                    obs = env.reset()
                    self.firsts[i] = True
                    self.episode_steps[i] = 0
                self.obs[i] = obs
            total += len(self.envs)
            if on_step is not None:
                on_step(actions, obs_before)
        dt = time.perf_counter() - t0
        return {
            "frames": total,
            "seconds": dt,
            "frames_per_sec": total / dt,
            "latency": latency_stats(step_times),
        }


class GroupedRolloutRunner:
    """One agent, G round-robin stream groups with explicit recurrent state.

    The serving latency chain per group is resize→H2D→device step→D2H.
    Independent groups break the chain: while group g's step runs on the
    card, the host collects, steps and re-dispatches the other groups.  One
    agent (batch_size = streams/G) means one set of weights on the card.

    Semantics equal running each group with its own BatchedRolloutRunner.
    """

    def __init__(self, agent, envs: List, n_groups: int = 4):
        assert len(envs) % n_groups == 0, (len(envs), n_groups)
        gb = len(envs) // n_groups
        assert agent.batch_size == gb, (
            f"agent.batch_size must equal streams/groups = {gb}, got {agent.batch_size}"
        )
        self.agent = agent
        self.groups = []
        for g in range(n_groups):
            genvs = envs[g * gb : (g + 1) * gb]
            self.groups.append(
                {
                    "envs": genvs,
                    "obs": [e.reset() for e in genvs],
                    "firsts": np.ones(gb, bool),
                    "state": agent.initial_group_state(),
                    "handle": None,
                }
            )

    def _advance(self, g, actions):
        for i, (env, action) in enumerate(zip(g["envs"], actions)):
            obs, reward, done, info = env.step(action)
            if done:
                obs = env.reset()
                g["firsts"][i] = True
            else:
                g["firsts"][i] = False
            g["obs"][i] = obs

    def run(self, n_steps: int) -> dict:
        agent = self.agent
        t0 = time.perf_counter()
        total = 0
        for g in self.groups:
            # a handle may be pending from a previous run(): its dispatched
            # observation is still the group's current obs (envs only advance
            # on collect), so it must be COLLECTED, never re-dispatched — a
            # re-dispatch would feed the same frame into the recurrent state
            # twice and drop one sampled action
            if g["handle"] is None:
                g["handle"], g["state"] = agent.dispatch_action_with_state(
                    g["obs"], g["state"], first=g["firsts"]
                )
        rotation_times = []
        for _ in range(n_steps):
            ts = time.perf_counter()
            for g in self.groups:
                self._advance(g, agent.collect_action(g["handle"]))
                total += len(g["envs"])
                g["handle"], g["state"] = agent.dispatch_action_with_state(
                    g["obs"], g["state"], first=g["firsts"]
                )
            # one full rotation advances every stream by one frame, and is
            # also each group's dispatch→collect action latency (a group's
            # result is collected one rotation after its dispatch)
            rotation_times.append(time.perf_counter() - ts)
        dt = time.perf_counter() - t0
        return {
            "frames": total,
            "seconds": dt,
            "frames_per_sec": total / dt,
            "latency": latency_stats(rotation_times),
        }
