"""Record agent play as contractor-format mp4+jsonl demonstration pairs, in
the PyTorch port (counterpart of the root tools/record_demonstrations.py):

    python -m vpt_tpu_torch.tools.record_demonstrations --model 2x.model --weights 2x.weights \\
        --out-dir demos/ --mock-env --streams 4 --steps 1200 [--prefix demo] [--device cuda]

The VPT data pipeline consumes "contractor data": a 640x360 mp4 and a
recorder jsonl with one step a frame (reference README.md:300-343,
data_loader.py:97).  This tool rolls a policy over batched env streams and
writes each stream as such a pair, so ``python -m
vpt_tpu_torch.behavioural_cloning --data-dir`` (and the IDM trainer) can
train on the agent's own play.

Each stream yields ``<prefix>-<i>.mp4`` + ``<prefix>-<i>.jsonl``, jsonl row
t holding the action taken at frame t; when a stream's env ends mid-run the
next episode starts a new pair (``<prefix>-<i>-ep<k>``), so no file stitches
two episodes.  Two format caveats come from the reference's fixups
(data_loader.py:64-103): a recording whose first step presses attack alone
is read back as "stuck attack" and stripped until the next fresh press
(each stream's first pair opens with a genuine warm-up noop step; later
episode pairs cannot, and warn instead), and sub-degree camera motion
truncates to whole degrees on parse.  Writing the videos needs libav; runs
on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import copy
import json
import os
import warnings
from argparse import ArgumentParser

from vpt_tpu_torch.actions.json_actions import NOOP_ACTION, RecorderJsonlWriter


def _presses_attack_only(env_action) -> bool:
    """True when the action holds attack and no other mouse button — the
    shape the loader's inherited stuck-attack heuristic strips if it is the
    first row of a recording (reference data_loader.py:64-95)."""
    import numpy as np

    def held(name):
        return bool(int(np.asarray(env_action.get(name, 0)).reshape(-1)[0]))

    return held("attack") and not held("use") and not held("pickItem")


class _StreamRecorder:
    """One stream's rolling mp4+jsonl pair, rolled over per episode."""

    def __init__(self, out_dir: str, prefix: str, index: int, w: int, h: int):
        from vpt_tpu_torch.data.video import VideoWriter

        self._VideoWriter = VideoWriter
        self._out_dir, self._prefix, self._index = out_dir, prefix, index
        self._w, self._h = w, h
        self.episode = 0
        self.frames_written = 0
        self._open()

    def _base(self) -> str:
        name = f"{self._prefix}-{self._index}"
        if self.episode:
            name += f"-ep{self.episode}"
        return os.path.join(self._out_dir, name)

    def _open(self):
        base = self._base()
        self._vw = self._VideoWriter(base + ".mp4", self._w, self._h, fps=20)
        self._jf = open(base + ".jsonl", "w")
        self._rec = RecorderJsonlWriter()
        self._episode_frames = 0

    def write(self, frame, env_action):
        if self._episode_frames == 0 and self.episode > 0 and _presses_attack_only(env_action):
            warnings.warn(
                f"stream {self._index} episode {self.episode}: first recorded "
                "action presses attack — the BC loader's stuck-attack heuristic "
                "will strip attack from this pair until the next fresh press "
                "(mid-run episodes can't be warmed with a noop step)"
            )
        self._vw.write(frame)
        self._jf.write(json.dumps(self._rec.step(env_action)) + "\n")
        self._episode_frames += 1
        self.frames_written += 1

    def rollover(self):
        """Close the current pair and start the next episode's."""
        self.close()
        self.episode += 1
        self._open()

    def close(self):
        self._vw.close()
        self._jf.close()
        if self._episode_frames == 0:
            # a rollover immediately before the run ended leaves an empty
            # pair — remove it rather than hand the loader a 0-frame mp4
            for ext in (".mp4", ".jsonl"):
                try:
                    os.remove(self._base() + ext)
                except OSError:
                    pass


def record(agent, envs, n_steps: int, out_dir: str, prefix: str = "demo") -> list:
    """Roll ``envs`` (len == agent.batch_size) for ``n_steps`` and write
    contractor-format mp4+jsonl pairs, one per stream episode.  Returns the
    per-stream lists of env actions taken (in order), for verification.

    Each stream opens with one genuine noop step (frame + jsonl row + env
    step) so the first policy action can never look like a stuck attack key
    to the loader's inherited heuristic; when an env ends mid-run the next
    episode starts a fresh ``<prefix>-<i>-ep<k>`` pair (the contractor format
    has no in-file episode markers).
    """
    from vpt_tpu_torch.agent.rollout import BatchedRolloutRunner

    os.makedirs(out_dir, exist_ok=True)
    runner = BatchedRolloutRunner(agent, envs)
    b = len(envs)
    h, w = runner.obs[0]["pov"].shape[:2]

    recs = [_StreamRecorder(out_dir, prefix, i, w, h) for i in range(b)]
    taken = [[] for _ in range(b)]

    # warm-up noop: a genuine env step recorded as frame 0 / row 0
    for i in range(b):
        noop = copy.deepcopy(NOOP_ACTION)
        recs[i].write(runner.obs[i]["pov"], noop)
        taken[i].append(noop)
        obs, _, done, _ = envs[i].step(noop)
        if done:  # vanishingly unlikely, but keep the invariants
            obs = envs[i].reset()
            runner.firsts[i] = True
            recs[i].rollover()
        runner.obs[i] = obs

    def on_step(actions, obs):
        for i in range(b):
            recs[i].write(obs[i]["pov"], actions[i])
            taken[i].append(actions[i])
            # the runner set firsts[i] when this action ended the episode:
            # the pair just written was the episode's last — roll the files
            if runner.firsts[i]:
                recs[i].rollover()

    try:
        runner.run(n_steps, on_step=on_step)
    finally:
        for rec in recs:
            rec.close()
    return taken


def record_main(model, weights, out_dir, steps=1200, streams=1, mock_env=False, prefix="demo", device=None):
    from vpt_tpu_torch.agent import MineRLAgent
    from vpt_tpu_torch.checkpoint import load_model_parameters

    policy_kwargs, pi_head_kwargs = load_model_parameters(model)
    agent = MineRLAgent(device=device, policy_kwargs=policy_kwargs, pi_head_kwargs=pi_head_kwargs,
                        batch_size=streams)
    agent.load_weights(weights)

    if mock_env:
        from vpt_tpu_torch.agent.rollout import MockMinecraftEnv

        envs = [MockMinecraftEnv(seed=i) for i in range(streams)]
    else:
        import gym  # noqa: F401
        import minerl  # noqa: F401
        from minerl.herobraine.env_specs.human_survival_specs import HumanSurvival

        from vpt_tpu_torch.agent.agent import ENV_KWARGS

        envs = [HumanSurvival(**ENV_KWARGS).make() for _ in range(streams)]

    taken = record(agent, envs, steps, out_dir, prefix=prefix)
    frames = [len(t) for t in taken]  # steps + 1 warm-up noop per stream
    print(f"recorded {streams} stream(s) x {frames[0]} frames ({sum(frames)} total) to {out_dir}/{prefix}-*.mp4/.jsonl")
    return taken


def main(argv=None):
    ap = ArgumentParser("Record agent play as contractor-format demonstrations.")
    ap.add_argument("--model", type=str, required=True)
    ap.add_argument("--weights", type=str, required=True)
    ap.add_argument("--out-dir", type=str, required=True)
    ap.add_argument("--steps", type=int, default=1200, help="Frames per stream (contractor segments are 5 min = 6000).")
    ap.add_argument("--streams", type=int, default=1)
    ap.add_argument("--mock-env", action="store_true")
    ap.add_argument("--prefix", type=str, default="demo")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return record_main(args.model, args.weights, args.out_dir, steps=args.steps, streams=args.streams,
                       mock_env=args.mock_env, prefix=args.prefix, device=args.device)


if __name__ == "__main__":
    main()
