"""Run the VPT policy in a MineRL environment, in the PyTorch port
(counterpart of the root run_agent.py; reference run_agent.py):

    python -m vpt_tpu_torch.run_agent --model M.model --weights M.weights \\
        [--mock-env --steps 100 --streams 8 --groups 0] [--mesh-dp N] [--record pov.mp4] [--device cuda]

Without MineRL, ``--mock-env`` drives the whole policy loop on synthetic
frames (``MockMinecraftEnv``).  ``--streams`` env streams are served in
``--groups`` round-robin groups through one agent (0 picks 4, 2 or 1 groups
as the JAX script does); more than one stream computes in bfloat16.
``--mesh-dp N`` serves the streams over N ranks under ``torchrun
--nproc_per_node=N`` (parallel/mesh.py): each rank its rows of every group,
the weights whole on every rank.  ``--record`` writes stream 0's POV with
the sampled action drawn on it (data/annotate.py, data/video.py: needs
libav and PIL).  Runs on CUDA unless ``--device cpu`` is given.
"""

from argparse import ArgumentParser

import numpy as np

from vpt_tpu_torch.agent import MineRLAgent
from vpt_tpu_torch.checkpoint import load_model_parameters
from vpt_tpu_torch.parallel import mesh as pmesh


def _make_recorder(path, height, width):
    """The annotated POV recorder: stream 0's observed frames with the
    sampled action drawn on them, through the native encoder (the headless
    stand-in for the reference's live ``env.render()`` window)."""
    from vpt_tpu_torch.data.annotate import action_rows, annotate_frame
    from vpt_tpu_torch.data.video import VideoWriter

    writer = VideoWriter(path, width, height, fps=20)
    frames = {"n": 0}

    def write(action, obs):
        writer.write(annotate_frame(obs["pov"], action_rows(action)))
        frames["n"] += 1

    write.frames = frames
    return write, writer


def auto_groups(streams: int, mesh_dp: int) -> int:
    """The groups ``--groups 0`` picks: 4 where they divide the streams, else
    2, else 1, each group's streams dividing over the dp ranks and a group
    holding at least 2 streams."""
    for g in (4, 2, 1):
        if streams % g == 0 and (streams // g) % max(mesh_dp, 1) == 0 and (g == 1 or streams >= 2 * g):
            return g
    return 1


def _serving_mesh(mesh_dp: int, mock_env: bool, device):
    """The dp mesh ``--mesh-dp`` asks for, or None."""
    if not mesh_dp:
        return None
    if not mock_env and mesh_dp > 1:
        raise SystemExit(
            "--mesh-dp > 1 needs a stream axis to shard: the interactive "
            "MineRL path drives ONE env.  Use --mock-env --streams N "
            "(N divisible by mesh-dp), or batch real envs via MineRLAgent "
            "directly."
        )
    if pmesh.maybe_initialize_distributed(device):
        return pmesh.make_mesh(n_dp=mesh_dp)
    if mesh_dp > 1:
        raise SystemExit(f"--mesh-dp {mesh_dp} serves over {mesh_dp} processes: launch with "
                         f"torchrun --nproc_per_node={mesh_dp}")
    return None


def _rank_envs(streams: int, groups: int, mesh):
    """This rank's env streams: its rows of each group, group by group."""
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv

    per_group = streams // groups
    rows = pmesh.local_rows(mesh, per_group)
    return [MockMinecraftEnv(seed=g * per_group + i) for g in range(groups) for i in range(rows.start, rows.stop)]


def run_agent(model, weights, mock_env=False, steps=100, streams=1, groups=0, show=True, mesh_dp=0, record=None,
              device=None):
    """Serve the policy; with ``mock_env`` returns the runner's statistics
    (frames, seconds, frames_per_sec, latency) and the groups it took."""
    policy_kwargs, pi_head_kwargs = load_model_parameters(model)
    mesh = _serving_mesh(mesh_dp, mock_env, device)

    if mock_env:
        from vpt_tpu_torch.agent.rollout import BatchedRolloutRunner, GroupedRolloutRunner

        if record and groups > 1:
            raise SystemExit(
                "--record taps the unpipelined runner's per-step callback; "
                "use it without --groups (or with --groups 1)."
            )
        if groups == 0:
            groups = 1 if record else auto_groups(streams, mesh_dp)
        if mesh_dp and (streams // groups) % mesh_dp != 0:
            raise SystemExit(
                f"streams/groups = {streams // groups} must divide over the "
                f"{mesh_dp}-device dp mesh; adjust --streams or --groups"
            )
        print(f"---Loading model (mock env, {streams} stream{'s' if streams > 1 else ''}, "
              f"{groups} group{'s' if groups > 1 else ''})---")
        agent = MineRLAgent(
            device=device,
            policy_kwargs=policy_kwargs,
            pi_head_kwargs=pi_head_kwargs,
            batch_size=streams // groups,
            compute_dtype="bfloat16" if streams > 1 else "float32",
            mesh=mesh,
        )
        agent.load_weights(weights)
        print("---Running mock rollout---")
        envs = _rank_envs(streams, groups, mesh)
        if groups > 1:
            stats = GroupedRolloutRunner(agent, envs, n_groups=groups).run(steps)
        else:
            runner = BatchedRolloutRunner(agent, envs)
            shown = {"n": 0}
            rec_write = rec_writer = None
            if record:
                pov = runner.obs[0]["pov"]
                rec_write, rec_writer = _make_recorder(record, pov.shape[0], pov.shape[1])

            def preview(actions, obs):
                a = actions[0] if isinstance(actions, list) else actions
                if rec_write is not None:
                    rec_write(a, obs[0])
                if show and shown["n"] < 3:
                    pressed = [k for k, v in a.items() if k != "camera" and v == 1]
                    print(f"step {shown['n']}: pressed={pressed} camera={np.round(a['camera'], 2)}")
                    shown["n"] += 1

            try:
                stats = runner.run(steps, on_step=preview)
            finally:
                if rec_writer is not None:
                    rec_writer.close()
                    print(f"recorded {rec_write.frames['n']} annotated frames to {record}")
        lat = stats.get("latency") or {}
        print(
            f"{stats['frames']} env frames in {stats['seconds']:.2f}s → "
            f"{stats['frames_per_sec']:.1f} frames/sec end-to-end"
            + (
                f" (step latency p50 {lat['p50_ms']:.1f} ms / p99 {lat['p99_ms']:.1f} ms, "
                f"{lat['realtime_factor_p99']:.2f}x the 20 Hz budget at p99)"
                if lat else ""
            )
        )
        return dict(stats, groups=groups)

    import gym  # noqa: F401
    import minerl  # noqa: F401  (registers MineRL envs)
    from minerl.herobraine.env_specs.human_survival_specs import HumanSurvival

    from vpt_tpu_torch.agent.agent import ENV_KWARGS

    env = HumanSurvival(**ENV_KWARGS).make()
    print("---Loading model---")
    agent = MineRLAgent(env, device=device, policy_kwargs=policy_kwargs, pi_head_kwargs=pi_head_kwargs, mesh=mesh)
    agent.load_weights(weights)

    print("---Launching MineRL environment (be patient)---")
    obs = env.reset()
    rec_write = rec_writer = None
    if record:
        pov = obs["pov"]
        rec_write, rec_writer = _make_recorder(record, pov.shape[0], pov.shape[1])
    try:
        while True:
            minerl_action = agent.get_action(obs)
            if rec_write is not None:
                rec_write(minerl_action, obs)
            obs, reward, done, info = env.step(minerl_action)
            env.render()
    finally:
        if rec_writer is not None:
            rec_writer.close()
            print(f"recorded {rec_write.frames['n']} annotated frames of gameplay to {record}")


def main(argv=None):
    parser = ArgumentParser("Run pretrained models on MineRL environment")
    parser.add_argument("--weights", type=str, required=True, help="Path to the '.weights' file to be loaded.")
    parser.add_argument("--model", type=str, required=True, help="Path to the '.model' file to be loaded.")
    parser.add_argument("--mock-env", action="store_true", help="Run on synthetic frames (no MineRL needed).")
    parser.add_argument("--steps", type=int, default=100, help="Mock-env step count.")
    parser.add_argument("--streams", type=int, default=1, help="Parallel env streams (batched rollout runtime).")
    parser.add_argument("--groups", type=int, default=0,
                        help="Pipelined stream groups (0 = auto; 1 disables pipelining).")
    parser.add_argument("--mesh-dp", type=int, default=0,
                        help="Serve the streams over N ranks under torchrun --nproc_per_node=N "
                             "(each rank its rows of every group; 0 = one process).")
    parser.add_argument("--record", type=str, default=None,
                        help="Write stream 0's POV with the sampled action overlaid to "
                             "this mp4 (headless replacement for the live render window).")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    return run_agent(args.model, args.weights, mock_env=args.mock_env, steps=args.steps, streams=args.streams,
                     groups=args.groups, mesh_dp=args.mesh_dp, record=args.record, device=args.device)


if __name__ == "__main__":
    main()
