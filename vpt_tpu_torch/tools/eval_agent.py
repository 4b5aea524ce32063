"""Evaluate a policy over N episodes, in the PyTorch port (counterpart of the
root tools/eval_agent.py): returns, lengths, action statistics.

    python -m vpt_tpu_torch.tools.eval_agent --mock-env --episodes 16 [--model X.model --weights X.weights] \\
        [--streams 8] [--max-episode-steps 500] [--deterministic] [--done-prob 0.01] [--seed 0] \\
        [--compute-dtype bfloat16] [--out report.json] [--record pov.mp4] [--device cuda]
    python -m vpt_tpu_torch.tools.eval_agent --compare before.json after.json

Rolls batched env streams through the serving runtime until ``--episodes``
finish (``evaluate_episodes``) and prints one JSON report: per-episode
returns and lengths, button press rates, camera movement, the null-action
rate, the mean value prediction and the serving latency's percentiles
against the 20 Hz env tick.  Without ``--weights`` the policy's weights are
random, drawn from ``--seed``.  Only ``--mock-env`` is wired as a command:
for real envs build them and call ``vpt_tpu_torch.agent.evaluate_episodes``.
``--record`` writes stream 0's annotated POV (needs libav and PIL).  Runs
on CUDA unless ``--device cpu`` is given.
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", type=str, default=None, help=".model file (optional; foundation defaults otherwise)")
    ap.add_argument("--weights", type=str, default=None, help=".weights file (optional; random init otherwise)")
    ap.add_argument("--mock-env", action="store_true", required=False)
    ap.add_argument("--episodes", type=int, default=16)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--max-episode-steps", type=int, default=500)
    ap.add_argument("--done-prob", type=float, default=0.01, help="mock env: per-step episode-end probability")
    ap.add_argument("--deterministic", action="store_true", help="argmax actions instead of sampling")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--out", type=str, default=None, help="also write the report to this path")
    ap.add_argument("--record", type=str, default=None,
                    help="save stream 0's annotated POV video of the evaluation here")
    ap.add_argument("--compare", nargs=2, metavar=("A_JSON", "B_JSON"),
                    help="compare two saved reports instead of running")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.compare:
        from vpt_tpu_torch.agent import compare_reports

        with open(args.compare[0]) as f:
            a = json.load(f)
        with open(args.compare[1]) as f:
            b = json.load(f)
        report = compare_reports(a, b)
        print(json.dumps(report))
        return report

    if not args.mock_env:
        raise SystemExit(
            "only --mock-env is wired as a CLI (the Java MineRL env and its "
            "task/reward choice are deployment-specific); for real envs call "
            "vpt_tpu_torch.agent.evaluate_episodes(agent, envs, ...) directly"
        )

    from vpt_tpu_torch.agent import MineRLAgent, evaluate_episodes
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv

    policy_kwargs = pi_head_kwargs = None
    if args.model:
        from vpt_tpu_torch.checkpoint import load_model_parameters

        policy_kwargs, pi_head_kwargs = load_model_parameters(args.model)
    agent = MineRLAgent(device=args.device, policy_kwargs=policy_kwargs, pi_head_kwargs=pi_head_kwargs,
                        batch_size=args.streams, seed=args.seed, compute_dtype=args.compute_dtype)
    if args.weights:
        agent.load_weights(args.weights)
    envs = [MockMinecraftEnv(seed=args.seed * 1000 + i, done_prob=args.done_prob) for i in range(args.streams)]
    report = evaluate_episodes(agent, envs, n_episodes=args.episodes, max_episode_steps=args.max_episode_steps,
                               stochastic=not args.deterministic, record_path=args.record)
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)
    return report


if __name__ == "__main__":
    main()
