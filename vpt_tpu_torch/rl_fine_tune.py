"""RL fine-tuning of a VPT policy with the PyTorch port: KL-anchored PPO
(training/rl.py; counterpart of the root rl_fine_tune.py).

    python -m vpt_tpu_torch.rl_fine_tune --in-model M.model --in-weights M.weights \\
        --out-weights OUT.weights --mock-env [--streams 8] [--updates 50] [--rollout-len 40] \\
        [--compute-dtype bfloat16] [--aux-phase-every 0] [--eval-every 0] \\
        [--checkpoint-dir DIR --checkpoint-every N [--resume]] [--device cuda] [--fsdp N] [--tp N]

``--mock-env`` runs the whole loop on synthetic frames with a demo reward (+1
per attack press), on machines without the Java MineRL env; without it the
streams are ``gym.make("MineRLBasaltFindCave-v0")`` envs.  ``--checkpoint-dir``
keeps snapshots (every ``--checkpoint-every`` updates, and on SIGTERM or
SIGINT); ``--resume`` goes on from the newest one there.  Runs on CUDA unless
``--device cpu`` is given.  Under ``torchrun`` every rank steps its own
``--streams`` env streams and the update runs over all the ranks' streams
(``--fsdp`` and ``--tp`` shard the policy and its anchor; the evaluation is
single-process, so under torchrun ``--eval-every`` is ignored, with a
notice, as the root CLI ignores it on multi-host launches).
"""

from argparse import ArgumentParser

from vpt_tpu_torch.parallel.mesh import cli_mesh, rank
from vpt_tpu_torch.training.rl import PPOHyperparams, PPOTrainer
from vpt_tpu_torch.utils.metrics import MetricsLogger


def demo_attack_reward(env_action, obs, reward, done):
    """Synthetic reward for --mock-env: +1 whenever attack is pressed."""
    return float(env_action["attack"])


def auto_collect_groups(streams: int) -> int:
    """Round-robin collection groups: 4, else 2, where they divide the
    streams with at least two streams a group; else 1."""
    for g in (4, 2):
        if streams % g == 0 and streams >= 2 * g:
            return g
    return 1


def main(in_model, in_weights, out_weights, mock_env=False, streams=8, updates=50, rollout_len=40,
         learning_rate=3e-5, kl_coef=0.2, compute_dtype="bfloat16", metrics_path=None, aux_phase_every=0,
         aux_epochs=4, beta_clone=1.0, collect_groups=0, eval_every=0, eval_episodes=8, eval_streams=4,
         eval_max_steps=500, eval_record_dir=None, device=None, checkpoint_dir=None, checkpoint_every=0,
         resume=False, fsdp=1, tp=1):
    hp = PPOHyperparams(
        rollout_len=rollout_len,
        learning_rate=learning_rate,
        kl_coef=kl_coef,
        n_minibatches=2 if streams % 2 == 0 else 1,
        n_collect_groups=collect_groups or auto_collect_groups(streams),
        aux_phase_every=aux_phase_every,
        aux_epochs=aux_epochs,
        beta_clone=beta_clone,
    )
    mesh = cli_mesh(device, fsdp=fsdp, tp=tp)
    trainer = PPOTrainer.from_files(in_model, in_weights, hp=hp, compute_dtype=compute_dtype, device=device,
                                    mesh=mesh)
    first_env = rank() * streams  # each rank's streams are envs of their own

    eval_envs = None
    if mock_env:
        from vpt_tpu_torch.agent.rollout import MockMinecraftEnv

        envs = [MockMinecraftEnv(seed=first_env + i) for i in range(streams)]
        reward_fn = demo_attack_reward
        if eval_every > 0:  # dedicated eval streams, with done_prob so that episodes end
            eval_envs = [MockMinecraftEnv(seed=10_000 + i, done_prob=0.02) for i in range(eval_streams)]
    else:
        import gym  # the Java MineRL env; only on hosts that have it

        envs = [gym.make("MineRLBasaltFindCave-v0") for _ in range(streams)]
        reward_fn = None  # the env's own reward
        if eval_every > 0:
            eval_envs = [gym.make("MineRLBasaltFindCave-v0") for _ in range(eval_streams)]
    if eval_envs is not None and mesh is not None:
        # evaluate() is single-process (episode lengths are data-dependent, so
        # the ranks' step counts diverge): skip it under torchrun
        print("---eval-every ignored on multi-host launches---")
        eval_envs = None

    print(f"---Running PPO: {streams} streams × {rollout_len} steps/update "
          f"({hp.n_collect_groups} collection group(s)), {updates} updates, KL anchor ρ₀={kl_coef}---")
    report = trainer.train(
        envs, updates, out_weights=out_weights, reward_fn=reward_fn, metrics=MetricsLogger(path=metrics_path),
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, resume=resume, eval_envs=eval_envs, eval_every=eval_every, eval_episodes=eval_episodes, eval_max_steps=eval_max_steps,
        eval_record_dir=eval_record_dir,
    )
    print(f"Done: {report}")
    return report


def parse_args(argv=None):
    parser = ArgumentParser("KL-anchored PPO fine-tuning of a VPT policy.")
    parser.add_argument("--in-model", required=True, type=str, help="Path to the .model file of the policy to fine-tune.")
    parser.add_argument("--in-weights", required=True, type=str, help="Path to the .weights file (also the frozen KL anchor).")
    parser.add_argument("--out-weights", required=True, type=str, help="Path where finetuned weights will be saved.")
    parser.add_argument("--mock-env", action="store_true", help="Use synthetic envs with the demo attack reward (no Java).")
    parser.add_argument("--streams", type=int, default=8, help="Parallel env streams (each rank's, under torchrun).")
    parser.add_argument("--updates", type=int, default=50, help="collect+update cycles.")
    parser.add_argument("--rollout-len", type=int, default=40, help="Steps collected per stream per update.")
    parser.add_argument("--learning-rate", type=float, default=3e-5)
    parser.add_argument("--kl-coef", type=float, default=0.2, help="Initial weight of KL(foundation ‖ policy).")
    parser.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    parser.add_argument("--metrics-path", type=str, default=None, help="Append JSONL metrics here.")
    parser.add_argument("--aux-phase-every", type=int, default=0,
                        help="PPG: run the auxiliary (value + clone-KL) phase every N updates (0 = plain PPO).")
    parser.add_argument("--aux-epochs", type=int, default=4, help="PPG: epochs over the buffered rollouts per aux phase.")
    parser.add_argument("--beta-clone", type=float, default=1.0,
                        help="PPG: weight of the KL that pins the policy during the aux phase.")
    parser.add_argument("--collect-groups", type=int, default=0,
                        help="Round-robin collection groups pipelining host work against device steps "
                             "(0 = auto: 4 or 2 where they divide the streams; 1 = serial).")
    parser.add_argument("--eval-every", type=int, default=0,
                        help="Evaluate on dedicated env streams before training and every N updates, "
                             "logging event=\"eval\" metric lines (0 = off).")
    parser.add_argument("--eval-episodes", type=int, default=8, help="Episodes per evaluation.")
    parser.add_argument("--eval-streams", type=int, default=4, help="Dedicated eval env streams.")
    parser.add_argument("--eval-max-steps", type=int, default=500,
                        help="Force-reset (truncate) eval episodes at this length.")
    parser.add_argument("--eval-record-dir", type=str, default=None,
                        help="Save an annotated POV video of each evaluation (eval-<update>.mp4) here.")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="Preemption-safe checkpoints here (policy + anchor + optimizer + anneal state).")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="Updates between checkpoints (0 = only on SIGTERM/SIGINT).")
    parser.add_argument("--resume", action="store_true", help="Continue from the newest checkpoint in --checkpoint-dir.")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    parser.add_argument("--fsdp", type=int, default=1, help="Ranks that shard the policy, its anchor and Adam's moments")
    parser.add_argument("--tp", type=int, default=1, help="Ranks that split the attention and MLP layers (tensor parallel)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(
        args.in_model, args.in_weights, args.out_weights, mock_env=args.mock_env, streams=args.streams,
        updates=args.updates, rollout_len=args.rollout_len, learning_rate=args.learning_rate, kl_coef=args.kl_coef,
        compute_dtype=args.compute_dtype, metrics_path=args.metrics_path, aux_phase_every=args.aux_phase_every,
        aux_epochs=args.aux_epochs, beta_clone=args.beta_clone, collect_groups=args.collect_groups,
        eval_every=args.eval_every, eval_episodes=args.eval_episodes, eval_streams=args.eval_streams,
        eval_max_steps=args.eval_max_steps, eval_record_dir=args.eval_record_dir, device=args.device,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every, resume=args.resume,
        fsdp=args.fsdp, tp=args.tp,
    )
