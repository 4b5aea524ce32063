"""Episode evaluation harness: roll a policy for N episodes, report returns
(counterpart of vpt_tpu/agent/evaluation.py).

The reference ships no evaluation of any kind (its only signals are
run_agent.py's live window and the BC trainer's running loss print).  This
module rolls an agent over batched env streams (the serving runtime's
geometry) until ``n_episodes`` finish, and reports per-episode
returns/lengths plus aggregate action statistics and serving-latency
percentiles.

Works against any env with the MineRL step/reset contract (obs dict with
"pov"; ``step(action) -> (obs, reward, done, info)``), including
MockMinecraftEnv.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from vpt_tpu_torch.agent.rollout import latency_stats


def _is_null_action(action: Dict[str, np.ndarray]) -> bool:
    """True when no button is pressed and the camera does not move — the
    same notion of "null" the BC trainer skips (reference agent.py:166-188
    check_if_null: all buttons 0 and camera at the zero bin, which
    undiscretizes to exactly 0.0 degrees)."""
    for k, v in action.items():
        if k == "camera":
            if np.any(np.asarray(v, np.float64) != 0.0):
                return False
        elif np.any(np.asarray(v) != 0):
            return False
    return True


def evaluate_episodes(
    agent,
    envs: List,
    n_episodes: int,
    max_episode_steps: int = 2000,
    stochastic: bool = True,
    env_hz: float = 20.0,
    record_path: Optional[str] = None,
) -> dict:
    """Run ``envs`` (len == agent.batch_size) until ``n_episodes`` episodes
    complete; an episode still running at ``max_episode_steps`` is force-reset
    and reported with ``truncated: true``.

    Episodes are counted in completion order across streams, first
    ``n_episodes`` only, so the report is a fixed-size sample regardless of
    stream count.  Returns a JSON-ready report dict.

    ``record_path``: write stream 0's POV, annotated with its sampled action,
    to this mp4 (the qualitative companion to the return statistics — watch
    what the policy actually does at each eval point).
    """
    b = len(envs)
    assert b == agent.batch_size, (b, agent.batch_size)
    assert n_episodes > 0 and max_episode_steps > 0

    obs = [e.reset() for e in envs]
    recorder = None
    if record_path:
        from vpt_tpu_torch.data.annotate import action_rows, annotate_frame
        from vpt_tpu_torch.data.video import VideoWriter

        pov = obs[0]["pov"]
        writer = VideoWriter(record_path, pov.shape[1], pov.shape[0], fps=int(env_hz))
        recorder = (writer, annotate_frame, action_rows)
    firsts = np.ones(b, bool)
    ep_return = np.zeros(b, np.float64)
    ep_len = np.zeros(b, np.int64)
    vpred_sum, vpred_n = 0.0, 0

    episodes: List[dict] = []
    step_times: List[float] = []
    # action statistics over every step taken during the evaluation
    press_counts: Dict[str, int] = {}
    cam_abs_sum = np.zeros(2, np.float64)
    cam_moves = 0
    null_actions = 0
    total_steps = 0

    try:
        while len(episodes) < n_episodes:
            ts = time.perf_counter()
            actions = agent.get_action(obs, first=firsts, stochastic=stochastic)
            step_times.append(time.perf_counter() - ts)
            if recorder is not None:
                writer, annotate_frame, action_rows = recorder
                writer.write(annotate_frame(obs[0]["pov"], action_rows(actions[0])))
            vp = getattr(agent, "_last_vpred", None)
            if vp is not None:
                vpred_sum += float(np.sum(vp))
                vpred_n += int(np.size(vp))
            firsts[:] = False
            for i, (env, action) in enumerate(zip(envs, actions)):
                total_steps += 1
                cam = np.asarray(action["camera"], np.float64).reshape(-1)
                cam_abs_sum += np.abs(cam)
                if np.any(cam != 0.0):
                    cam_moves += 1
                if _is_null_action(action):
                    null_actions += 1
                for k, v in action.items():
                    if k != "camera" and np.any(np.asarray(v) != 0):
                        press_counts[k] = press_counts.get(k, 0) + 1

                o, reward, done, _info = env.step(action)
                ep_return[i] += float(reward)
                ep_len[i] += 1
                truncated = not done and ep_len[i] >= max_episode_steps
                if done or truncated:
                    if len(episodes) < n_episodes:
                        episodes.append(
                            {
                                "return": float(ep_return[i]),
                                "length": int(ep_len[i]),
                                "truncated": bool(truncated),
                            }
                        )
                    o = env.reset()
                    firsts[i] = True
                    ep_return[i] = 0.0
                    ep_len[i] = 0
                obs[i] = o
    finally:
        if recorder is not None:
            recorder[0].close()

    rets = np.asarray([e["return"] for e in episodes])
    lens = np.asarray([e["length"] for e in episodes])
    return {
        **({"recording": record_path} if record_path else {}),
        "episodes": len(episodes),
        "mean_return": float(rets.mean()),
        "std_return": float(rets.std()),
        "min_return": float(rets.min()),
        "max_return": float(rets.max()),
        "mean_length": float(lens.mean()),
        "truncated_episodes": int(sum(e["truncated"] for e in episodes)),
        "steps": int(total_steps),
        "mean_vpred": (vpred_sum / vpred_n) if vpred_n else None,
        "action_stats": {
            "button_press_rate": {
                k: round(c / total_steps, 4) for k, c in sorted(press_counts.items())
            },
            "camera_mean_abs_deg": [round(float(x / total_steps), 4) for x in cam_abs_sum],
            "camera_move_rate": round(cam_moves / total_steps, 4),
            "null_action_rate": round(null_actions / total_steps, 4),
        },
        "latency": latency_stats(step_times, env_hz=env_hz),
        "per_episode": episodes,
    }


def compare_reports(a: dict, b: dict) -> dict:
    """Delta summary between two evaluation reports (e.g. before/after an RL
    fine-tune): mean-return difference with a two-sample Welch t statistic so
    the caller can judge noise without scipy."""
    ra = np.asarray([e["return"] for e in a["per_episode"]], np.float64)
    rb = np.asarray([e["return"] for e in b["per_episode"]], np.float64)
    va, vb = ra.var(ddof=1) / ra.size, rb.var(ddof=1) / rb.size
    denom = float(np.sqrt(va + vb)) or float("nan")
    return {
        "mean_return_a": float(ra.mean()),
        "mean_return_b": float(rb.mean()),
        "delta": float(rb.mean() - ra.mean()),
        "welch_t": float((rb.mean() - ra.mean()) / denom) if denom == denom else None,
        "episodes": [int(ra.size), int(rb.size)],
    }
