"""RL fine-tuning: PPO with a KL anchor to the frozen foundation policy
(counterpart of vpt_tpu/training/rl.py).

The VPT paper's third phase fine-tunes the behaviour-cloned policy with
reinforcement learning, regularized by a KL divergence to the frozen
pretrained policy so exploration does not destroy the prior (the published
"rl-from-foundation" checkpoints, reference README.md:63-79).  The reference
ships those checkpoints but no RL code; the JAX package supplies it, and this
module is its port to one device:

  * batched collection over N env streams at t=1 on the ring cache, as G
    round-robin stream groups: while the card steps one group, the host
    resizes frames and steps the envs of another;
  * recurrent PPO: the collected window is re-forwarded as one (B, T)
    chunk from the snapshot of each stream's state at the window's start, so
    the update runs the chunked path, kernel B1 forward and kernel B2
    backward on CUDA (ops/windowed_attention.py);
  * GAE(γ, λ) with episode resets from the ``first`` flags;
  * clipped-surrogate policy loss + value loss in EWMA-normalized return
    space (the value head's statistics folded once per collected batch) +
    KL(π₀ ‖ π_θ) to the anchor with a decaying coefficient; the anchor's
    logits are computed once per collected batch;
  * phasic policy gradient (Cobbe et al. 2021): an optional auxiliary phase
    that trains the value function hard while a KL to the pre-phase policy
    holds π in place, sharing the Adam state.

The optimizer is the JAX package's chain, clip → optional L2 → Adam
(``ClippedAdam`` of training/bc.py), over every parameter, the value head's
included.  Not ported yet: meshes and multi-process collection, checkpoints
and resume, remat.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from vpt_tpu_torch.actions import ActionTransformer
from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
from vpt_tpu_torch.checkpoint import load_model_parameters, load_state_dict_report, load_weights, save_weights
from vpt_tpu_torch.config import ACTION_TRANSFORMER_KWARGS, PolicyConfig
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.models.heads import (
    dict_entropy,
    dict_kl,
    dict_logprob,
    dict_sample,
    ewma_normalize,
    ewma_updated_stats,
    head_specs_from_space,
)
from vpt_tpu_torch.models.layers import init_parameters
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
from vpt_tpu_torch.models.transformer import ring_state_to_linear
from vpt_tpu_torch.ops.resize import resize_uint8_exact
from vpt_tpu_torch.spaces import DictType
from vpt_tpu_torch.training.bc import ClippedAdam
from vpt_tpu_torch.utils.metrics import MetricsLogger

EVAL_SEED = 1_000_003  # evaluation's sampling generator: EVAL_SEED + update_count


@dataclasses.dataclass
class PPOHyperparams:
    learning_rate: float = 3e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 5.0          # same clip as the BC phase
    gamma: float = 0.999                # long-horizon discount
    lam: float = 0.95                   # GAE
    clip_eps: float = 0.2               # PPO clipped-surrogate epsilon
    vf_coef: float = 0.5
    ent_coef: float = 0.0               # the KL anchor already regularizes
    kl_coef: float = 0.2                # ρ₀: weight of KL(π₀ ‖ π_θ)
    kl_decay: float = 0.9995            # ρ ← ρ·decay per update
    n_epochs: int = 3                   # PPO epochs per collected batch
    n_minibatches: int = 2              # stream-axis splits per epoch
    rollout_len: int = 40               # T steps collected per update
    normalize_advantages: bool = True
    # collection as G round-robin stream groups: host work (env stepping,
    # resize, action decode) of one group overlaps the card's step of another
    n_collect_groups: int = 1
    # phasic policy gradient: every ``aux_phase_every`` updates, run
    # ``aux_epochs`` of an auxiliary phase over the rollouts buffered since
    # the last one: value regression + beta_clone·KL to the pre-phase policy.
    # 0 = plain PPO.
    aux_phase_every: int = 0
    aux_epochs: int = 4
    beta_clone: float = 1.0
    # the anchor forward over a batch of more than this many frames runs in
    # stream-axis chunks (streams are independent given their initial state,
    # so the logits are the same); 0 disables chunking
    anchor_fwd_max_frames: int = 1024


def compute_gae(rewards, values, firsts, last_value, last_first, gamma: float, lam: float):
    """Generalized advantage estimation over (B, T) with episode boundaries.

    ``firsts[:, t]`` is True when step t begins a new episode (so no reward
    or value flows backward across t−1 → t).  ``last_value`` bootstraps the
    step after the window; ``last_first`` marks a boundary there.

    :returns: (advantages, returns), both (B, T) float32 tensors.
    """
    rewards, values, last_value = (torch.as_tensor(x).float() for x in (rewards, values, last_value))
    firsts, last_first = torch.as_tensor(firsts), torch.as_tensor(last_first)
    nonterm = 1.0 - torch.cat([firsts[:, 1:], last_first[:, None]], dim=1).float()
    next_values = torch.cat([values[:, 1:], last_value[:, None]], dim=1)
    deltas = rewards + gamma * next_values * nonterm - values
    advantages = torch.empty_like(deltas)
    adv = torch.zeros_like(last_value)
    for t in reversed(range(deltas.shape[1])):
        adv = deltas[:, t] + gamma * lam * nonterm[:, t] * adv
        advantages[:, t] = adv
    return advantages, advantages + values


def _select_rows(state: List[Dict[str, torch.Tensor]], rows) -> List[Dict[str, torch.Tensor]]:
    return [{k: v[rows] for k, v in blk.items()} for blk in state]


def _clone_state(state: List[Dict]) -> List[Dict]:
    return [{k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in blk.items()} for blk in state]


class _ShapedRewardEnv:
    """Env proxy applying the trainer's ``reward_fn`` so evaluation scores
    episodes under the reward PPO optimizes, not the env's own."""

    def __init__(self, env, reward_fn: Callable):
        self._env, self._reward_fn = env, reward_fn

    def reset(self):
        return self._env.reset()

    def step(self, action):
        obs, reward, done, info = self._env.step(action)
        return obs, self._reward_fn(action, obs, reward, done), done, info


class _TrainerEvalAgent:
    """The ``evaluate_episodes`` agent contract (``get_action`` over raw env
    obs, ``batch_size``, ``_last_vpred``) on a PPOTrainer's current policy:
    a fresh ring state and a sampling generator of its own, seeded
    ``EVAL_SEED + update_count``, so evaluation is reproducible and leaves
    the trainer's generators and streams as they were."""

    def __init__(self, trainer: "PPOTrainer", batch_size: int):
        self.trainer = trainer
        self.batch_size = batch_size
        self._generator = torch.Generator(device=trainer.device).manual_seed(EVAL_SEED + trainer.update_count)
        self._state = policy_initial_state(trainer.cfg, batch_size, ring=True, device=trainer.device)
        self._last_vpred = None

    @torch.inference_mode()
    def get_action(self, minerl_obs: List, first=None, stochastic: bool = True):
        t = self.trainer
        img = torch.from_numpy(t._resize(minerl_obs)).to(t.device)
        first = np.zeros(self.batch_size, bool) if first is None else np.asarray(first, bool)
        first = torch.from_numpy(first).to(t.device)
        out, self._state = t.policy(img[:, None], first[:, None], self._state)
        logits = {k: v[:, 0] for k, v in out["pi_logits"].items()}
        action = dict_sample(logits, t.head_specs, deterministic=not stochastic, generator=self._generator)
        self._last_vpred = out["vpred"][:, 0, 0].float().cpu().numpy()
        env_actions = t._agent_action_to_env({k: v.cpu().numpy() for k, v in action.items()})
        return [{k: v[i] for k, v in env_actions.items()} for i in range(self.batch_size)]


class PPOTrainer:
    """KL-anchored recurrent PPO over batched env streams, on one device.

    :param device: torch device; None means CUDA, which must then exist
    :param compute_dtype: "float32" or "bfloat16" (the parameters and Adam
        stay float32)
    :param seed: seeds the initial weights (drawn on the CPU, so every
        device starts from the same weights), the action sampling and the
        epochs' stream permutations (one generator each, on ``device``)
    """

    def __init__(
        self,
        policy_kwargs: Dict[str, Any],
        pi_head_kwargs: Dict[str, Any],
        hp: Optional[PPOHyperparams] = None,
        compute_dtype: str = "float32",
        seed: int = 0,
        device=None,
    ):
        self.hp = hp or PPOHyperparams()
        self.device = resolve_device(device)
        self.cfg = PolicyConfig.from_kwargs(dict(policy_kwargs)).replace(compute_dtype=compute_dtype)
        assert self.hp.rollout_len <= self.cfg.timesteps, (
            f"rollout_len {self.hp.rollout_len} exceeds the policy's chunk geometry timesteps={self.cfg.timesteps}"
        )
        self.temperature = float(pi_head_kwargs.get("temperature", 1.0))
        self.action_mapper = CameraHierarchicalMapping(n_camera_bins=11)
        self.action_transformer = ActionTransformer(**ACTION_TRANSFORMER_KWARGS)
        self.head_specs = head_specs_from_space(DictType(**self.action_mapper.get_action_space_update()))
        self._seed = seed
        self.sample_generator = torch.Generator(device=self.device).manual_seed(seed)
        self.perm_generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.policy: Optional[MinecraftAgentPolicy] = None
        self.anchor: Optional[MinecraftAgentPolicy] = None  # frozen foundation policy (π₀)
        self.optimizer: Optional[ClippedAdam] = None
        self.kl_coef = self.hp.kl_coef
        self.update_count = 0
        self._group_states = None  # per-group ring state (collection)
        self._aux_buffer: List[Dict[str, Any]] = []  # PPG: rollouts since the last aux phase

    # ------------------------------------------------------------------ setup

    def init(self) -> None:
        if self.policy is not None:
            return
        policy = MinecraftAgentPolicy(self.cfg, self.head_specs, self.temperature)
        init_parameters(policy, torch.Generator().manual_seed(self._seed))
        self.policy = policy.to(self.device)
        self.optimizer = ClippedAdam(self.policy.parameters(), self.hp)
        self.anchor = self._snapshot_anchor()

    def _snapshot_anchor(self) -> MinecraftAgentPolicy:
        """A copy of the current policy, not an alias: the optimizer steps
        the trainable parameters in place."""
        return copy.deepcopy(self.policy).requires_grad_(False)

    def load_weights(self, path: str) -> Dict[str, list]:
        """Load foundation weights into both the trainable policy and the
        frozen KL anchor."""
        self.init()
        report = load_state_dict_report(self.policy, load_weights(path))
        self.anchor = self._snapshot_anchor()
        return report

    @classmethod
    def from_files(cls, in_model: str, in_weights: Optional[str] = None, **kw) -> "PPOTrainer":
        policy_kwargs, pi_head_kwargs = load_model_parameters(in_model)
        trainer = cls(policy_kwargs, pi_head_kwargs, **kw)
        trainer.init()
        if in_weights:
            trainer.load_weights(in_weights)
        return trainer

    # ------------------------------------------------------------ collection

    @torch.inference_mode()
    def _act(self, img: np.ndarray, first: np.ndarray, state):
        """One t=1 step of a group: (packed (gb, 4) float32 [buttons, camera,
        logp, vpred], state after the step); the ring slot is written into
        ``state`` in place."""
        img_t = torch.from_numpy(img).to(self.device, non_blocking=True)
        first_t = torch.from_numpy(first).to(self.device, non_blocking=True)
        out, state = self.policy(img_t[:, None], first_t[:, None], state)
        logits = {k: v[:, 0] for k, v in out["pi_logits"].items()}
        action = dict_sample(logits, self.head_specs, generator=self.sample_generator)
        logp = dict_logprob(logits, action, self.head_specs)
        # joint action indices are below 2^24, exact in float32
        packed = torch.stack([action["buttons"][:, 0].float(), action["camera"][:, 0].float(), logp,
                              out["vpred"][:, 0, 0].float()], dim=1)
        return packed, state

    def _resize(self, obs_list) -> np.ndarray:
        res = (self.cfg.img_shape[1], self.cfg.img_shape[0])
        return np.stack([resize_uint8_exact(o["pov"], res) for o in obs_list])

    def collect(self, envs: List, obs: Optional[List] = None, firsts: Optional[np.ndarray] = None,
                reward_fn: Optional[Callable] = None):
        """Roll ``hp.rollout_len`` steps of every env stream; returns the
        trajectory buffer the update consumes, plus (obs, firsts) to thread
        into the next collect call (vpt_tpu's ``collect`` and
        ``_collect_grouped`` in one).

        The streams run as ``hp.n_collect_groups`` round-robin groups of
        consecutive streams: a group's step is queued on the card, and while
        it runs the host steps the envs of the group before it.  Group g owns
        stream rows [g·gb, (g+1)·gb); its window-start ring state, as the
        linear chunk layout, is rows [g·gb, (g+1)·gb) of ``initial_state``.

        :param reward_fn: optional ``f(env_action, obs, env_reward, done) ->
            float`` per stream, overriding the env's reward.
        """
        self.init()
        hp = self.hp
        G = max(1, hp.n_collect_groups)
        b, t_len = len(envs), hp.rollout_len
        assert b % G == 0, (b, G)
        gb = b // G
        if obs is None:
            obs = [e.reset() for e in envs]
            firsts = np.ones(b, bool)
            self._group_states = None
        if firsts is None:
            firsts = np.zeros(b, bool)
        firsts = np.asarray(firsts, bool).copy()
        if self._group_states is None:
            self._group_states = [policy_initial_state(self.cfg, gb, ring=True, device=self.device)
                                  for _ in range(G)]

        with torch.no_grad():  # window-start snapshots, outside inference mode: the update trains on them
            snapshots = [[ring_state_to_linear(blk) for blk in s] for s in self._group_states]
            initial_state = [{k: torch.cat([snap[i][k] for snap in snapshots]) for k in snapshots[0][i]}
                             for i in range(len(snapshots[0]))]

        buf = {
            "frames": np.zeros((b, t_len) + tuple(self.cfg.img_shape), np.uint8),
            "buttons": np.zeros((b, t_len), np.int64),
            "camera": np.zeros((b, t_len), np.int64),
            "logp_old": np.zeros((b, t_len), np.float32),
            "values": np.zeros((b, t_len), np.float32),
            "rewards": np.zeros((b, t_len), np.float32),
            "firsts": np.zeros((b, t_len), bool),
        }
        slices = [slice(g * gb, (g + 1) * gb) for g in range(G)]
        pending: List = [None] * G

        def dispatch(g: int, t: int):
            sl = slices[g]
            img = self._resize(obs[sl])
            buf["frames"][sl, t] = img
            buf["firsts"][sl, t] = firsts[sl]
            packed, self._group_states[g] = self._act(img, firsts[sl], self._group_states[g])
            pending[g] = (t, self._to_host(packed))

        def harvest(g: int):
            t, (packed, done_event) = pending[g]
            pending[g] = None
            if done_event is not None:
                done_event.synchronize()
            packed = packed.numpy()
            sl = slices[g]
            action = {"buttons": packed[:, 0:1].astype(np.int64), "camera": packed[:, 1:2].astype(np.int64)}
            buf["buttons"][sl, t] = action["buttons"][:, 0]
            buf["camera"][sl, t] = action["camera"][:, 0]
            buf["logp_old"][sl, t] = packed[:, 2]
            buf["values"][sl, t] = packed[:, 3]
            env_actions = self._agent_action_to_env(action)
            next_firsts = np.zeros(gb, bool)
            for i, env in enumerate(envs[sl]):
                env_action = {k: v[i] for k, v in env_actions.items()}
                ob, reward, done, _info = env.step(env_action)
                if reward_fn is not None:
                    reward = reward_fn(env_action, ob, reward, done)
                buf["rewards"][sl.start + i, t] = reward
                if done:
                    ob = env.reset()
                    next_firsts[i] = True
                obs[sl.start + i] = ob
            firsts[sl] = next_firsts

        for g in range(G):
            dispatch(g, 0)
        for t in range(t_len):
            for g in range(G):
                harvest(g)
                if t + 1 < t_len:
                    dispatch(g, t + 1)

        # bootstrap values, on a copy of each group's state (a step writes its ring slot in place)
        last_value = []
        for g in range(G):
            sl = slices[g]
            packed, _ = self._act(self._resize(obs[sl]), firsts[sl], _clone_state(self._group_states[g]))
            last_value.append(packed[:, 3].cpu().numpy())
        buf["last_value"] = np.concatenate(last_value)
        buf["last_first"] = firsts.copy()
        buf["initial_state"] = initial_state
        return buf, obs, firsts

    def _to_host(self, packed: torch.Tensor):
        """Start the copy of a step's packed output to the host; (host
        tensor, event to wait on, or None on the CPU)."""
        if self.device.type != "cuda":
            return packed, None
        host = packed.to("cpu", non_blocking=True)  # into pinned memory
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _agent_action_to_env(self, agent_action) -> Dict[str, np.ndarray]:
        factored = self.action_mapper.to_factored({k: np.asarray(v) for k, v in agent_action.items()})
        return self.action_transformer.policy2env(factored)

    # ------------------------------------------------------------- evaluation

    def evaluate(self, envs: List, n_episodes: int, max_episode_steps: int = 500,
                 reward_fn: Optional[Callable] = None, stochastic: bool = True,
                 record_path: Optional[str] = None) -> Dict:
        """Roll the current policy over dedicated eval envs until
        ``n_episodes`` finish; returns the ``evaluate_episodes`` report
        (per-episode returns/lengths, action statistics, latency).

        A fresh recurrent state and a generator seeded from ``update_count``
        alone: evaluating consumes none of the trainer's generators and
        touches none of its streams, so a run with ``eval_every`` set trains
        exactly as one without.  ``reward_fn`` (as in :meth:`collect`) scores
        episodes under the shaped reward PPO optimizes.
        """
        from vpt_tpu_torch.agent.evaluation import evaluate_episodes

        self.init()
        if reward_fn is not None:
            envs = [_ShapedRewardEnv(e, reward_fn) for e in envs]
        return evaluate_episodes(_TrainerEvalAgent(self, len(envs)), envs, n_episodes,
                                 max_episode_steps=max_episode_steps, stochastic=stochastic,
                                 record_path=record_path)

    # ---------------------------------------------------------------- update

    @torch.no_grad()
    def _logits(self, policy, frames, firsts, state) -> Dict[str, torch.Tensor]:
        out, _ = policy(frames, firsts, state)
        return out["pi_logits"]

    def _anchor_logits(self, frames, firsts, state) -> Dict[str, torch.Tensor]:
        """Anchor-policy (π₀) logits for the whole collected window.  Batches
        over ``hp.anchor_fwd_max_frames`` frames run in chunks of streams,
        the most that fit and divide B: each stream's rows and initial state
        slice independently, so the logits are the same."""
        b, t = frames.shape[:2]
        max_frames = self.hp.anchor_fwd_max_frames
        if max_frames <= 0 or b * t <= max_frames:
            return self._logits(self.anchor, frames, firsts, state)
        rows = max(1, max_frames // t)
        while b % rows:  # largest divisor of b that fits
            rows -= 1
        outs = [self._logits(self.anchor, frames[i:i + rows], firsts[i:i + rows],
                             _select_rows(state, slice(i, i + rows)))
                for i in range(0, b, rows)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _value_loss(self, out, returns) -> torch.Tensor:
        """Value regression in EWMA-normalized return space (reference:
        lib/scaled_mse_head.py:37-43)."""
        target = ewma_normalize(self.policy.value_head.normalizer.stats(), returns[..., None])
        return torch.mean((out["vpred_raw"].float() - target) ** 2)

    @torch.enable_grad()
    def _ppo_step(self, mb: Dict[str, torch.Tensor], state, kl_coef: float) -> Dict[str, torch.Tensor]:
        """One optimizer step of the PPO loss on a minibatch; returns its
        metrics as detached tensors."""
        hp = self.hp
        self.optimizer.zero_grad()
        out, _ = self.policy(mb["frames"], mb["firsts"], state)
        logits = out["pi_logits"]
        actions = {"buttons": mb["buttons"][..., None], "camera": mb["camera"][..., None]}
        logp = dict_logprob(logits, actions, self.head_specs)  # (B, T)
        log_ratio = logp - mb["logp_old"]
        ratio = torch.exp(log_ratio)
        adv = mb["adv"]
        pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - hp.clip_eps, 1.0 + hp.clip_eps) * adv).mean()
        v_loss = self._value_loss(out, mb["returns"])
        entropy = dict_entropy(logits, self.head_specs).mean()
        anchor_kl = dict_kl(mb["anchor_logits"], logits, self.head_specs).mean()
        total = pg + hp.vf_coef * v_loss - hp.ent_coef * entropy + kl_coef * anchor_kl
        total.backward()
        grad_norm = self.optimizer.step()
        return {
            "pg_loss": pg.detach(),
            "v_loss": v_loss.detach(),
            "entropy": entropy.detach(),
            "anchor_kl": anchor_kl.detach(),
            # E[(r−1) − log r] ≥ 0, the low-variance approx-KL(θ_old‖θ) estimator
            "approx_kl": torch.mean((ratio - 1.0) - log_ratio).detach(),
            "clip_frac": torch.mean((torch.abs(ratio - 1.0) > hp.clip_eps).float()),
            "grad_norm": grad_norm.detach(),
            "loss": total.detach(),
        }

    @torch.enable_grad()
    def _aux_step(self, mb: Dict[str, torch.Tensor], state) -> Dict[str, torch.Tensor]:
        """PPG auxiliary objective: value regression + β_clone·KL(π_old ‖ π_θ).

        π and V share the trunk, so the aux phase is how the value function
        trains hard without wrecking the policy: the clone KL pins π to its
        pre-phase snapshot.  The Adam state is the policy phase's."""
        self.optimizer.zero_grad()
        out, _ = self.policy(mb["frames"], mb["firsts"], state)
        v_loss = self._value_loss(out, mb["returns"])
        clone_kl = dict_kl(mb["old_logits"], out["pi_logits"], self.head_specs).mean()
        (v_loss + self.hp.beta_clone * clone_kl).backward()
        self.optimizer.step()
        return {"aux_v_loss": v_loss.detach(), "aux_clone_kl": clone_kl.detach()}

    def _aux_phase(self) -> Dict[str, float]:
        """Run ``aux_epochs`` over every rollout buffered since the last aux
        phase; clears the buffer.  Clone targets (π just before the phase)
        are computed once per rollout."""
        prepared = []
        for entry in self._aux_buffer:
            mb = {
                "frames": torch.from_numpy(entry["frames"]).to(self.device),
                "firsts": torch.from_numpy(entry["firsts"]).to(self.device),
                "returns": torch.from_numpy(entry["returns"]).to(self.device),
            }
            mb["old_logits"] = self._logits(self.policy, mb["frames"], mb["firsts"], entry["initial_state"])
            prepared.append((mb, entry["initial_state"]))
        self._aux_buffer = []
        aux = {"aux_v_loss": float("nan"), "aux_clone_kl": float("nan")}
        for _ in range(self.hp.aux_epochs):
            for mb, state in prepared:
                aux = self._aux_step(mb, state)
        return {k: float(v) for k, v in aux.items()}

    @torch.no_grad()
    def _fold_return_stats(self, returns: np.ndarray) -> None:
        """Fold the batch's return targets into the value head's EWMA stats
        once per collected batch (the reference's normalizer updates inside
        every loss call; once per batch keeps the target fixed across the
        PPO epochs)."""
        normalizer = self.policy.value_head.normalizer
        updated = ewma_updated_stats(normalizer.stats(), torch.from_numpy(returns[..., None]).to(self.device))
        for k, v in updated.items():
            getattr(normalizer, k).copy_(v)

    def update(self, traj: Dict[str, Any]) -> Dict[str, float]:
        """PPO epochs over one collected trajectory batch; returns the
        metrics of the last minibatch step, with the batch's mean reward and
        return and the decayed KL coefficient.

        Each epoch splits a permutation of the streams into
        ``hp.n_minibatches`` minibatches.  ``traj['initial_state']`` may lie
        on any device."""
        self.init()
        hp = self.hp
        dev = self.device
        b = traj["frames"].shape[0]
        assert b % hp.n_minibatches == 0, (b, hp.n_minibatches)

        adv, returns = compute_gae(traj["rewards"], traj["values"], traj["firsts"], traj["last_value"],
                                   traj["last_first"], hp.gamma, hp.lam)
        adv, returns = adv.numpy(), returns.numpy()
        if hp.normalize_advantages:
            adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        self._fold_return_stats(returns)

        def place(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

        initial_state = [{k: v.to(dev) for k, v in blk.items()} for blk in traj["initial_state"]]
        batch = {
            "frames": place(traj["frames"], torch.uint8),
            "firsts": place(traj["firsts"], torch.bool),
            "buttons": place(traj["buttons"], torch.int64),
            "camera": place(traj["camera"], torch.int64),
            "logp_old": place(traj["logp_old"], torch.float32),
            "adv": place(adv, torch.float32),
            "returns": place(returns, torch.float32),
        }
        batch["anchor_logits"] = self._anchor_logits(batch["frames"], batch["firsts"], initial_state)

        mb_size = b // hp.n_minibatches
        last = {}
        for _ in range(hp.n_epochs):
            perm = torch.randperm(b, generator=self.perm_generator, device=dev)
            for m in range(hp.n_minibatches):
                idx = perm[m * mb_size:(m + 1) * mb_size]
                mb = {k: ({h: x[idx] for h, x in v.items()} if isinstance(v, dict) else v[idx])
                      for k, v in batch.items()}
                last = self._ppo_step(mb, _select_rows(initial_state, idx), self.kl_coef)
        self.kl_coef *= hp.kl_decay
        self.update_count += 1
        metrics = {k: float(v) for k, v in last.items()}
        metrics.update(mean_reward=float(traj["rewards"].mean()), mean_return=float(returns.mean()),
                       kl_coef=self.kl_coef)
        if hp.aux_phase_every:
            # PPG: buffer this rollout (frames stay on the host; the returns
            # are the aux value targets) and run the auxiliary phase on schedule
            self._aux_buffer.append({
                "frames": traj["frames"],
                "firsts": traj["firsts"],
                "returns": returns.astype(np.float32),
                "initial_state": initial_state,
            })
            if self.update_count % hp.aux_phase_every == 0:
                metrics.update(self._aux_phase())
        return metrics

    # ------------------------------------------------------------------- run

    def train(
        self,
        envs: List,
        n_updates: int,
        out_weights: Optional[str] = None,
        reward_fn: Optional[Callable] = None,
        metrics: Optional[MetricsLogger] = None,
        eval_envs: Optional[List] = None,
        eval_every: int = 0,
        eval_episodes: int = 8,
        eval_max_steps: int = 500,
        eval_record_dir: Optional[str] = None,
    ) -> Dict[str, float]:
        """collect → update loop over persistent env streams until
        ``update_count`` reaches ``n_updates``; writes the weights to
        ``out_weights`` at the end.

        With ``eval_envs`` and ``eval_every`` > 0, rolls the current policy
        over those dedicated envs (never the training streams) before the
        first update and after every ``eval_every``-th, logging the
        :meth:`evaluate` report's summary as an ``event="eval"`` line."""
        self.init()
        metrics = metrics or MetricsLogger()
        obs, firsts = None, None
        start = time.time()
        frames = 0
        report: Dict[str, float] = {}

        def run_eval():
            rec = None
            if eval_record_dir:
                os.makedirs(eval_record_dir, exist_ok=True)
                rec = os.path.join(eval_record_dir, f"eval-{self.update_count:05d}.mp4")
            ev = self.evaluate(eval_envs, eval_episodes, max_episode_steps=eval_max_steps,
                               reward_fn=reward_fn, record_path=rec)
            metrics.log(event="eval", update=self.update_count, mean_return=ev["mean_return"],
                        std_return=ev["std_return"], mean_length=ev["mean_length"], episodes=ev["episodes"],
                        null_action_rate=ev["action_stats"]["null_action_rate"], mean_vpred=ev["mean_vpred"])
            return ev

        do_eval = bool(eval_envs) and eval_every > 0
        if do_eval and self.update_count == 0:
            run_eval()  # the baseline the later evaluations read against
        while self.update_count < n_updates:
            traj, obs, firsts = self.collect(envs, obs, firsts, reward_fn=reward_fn)
            report = self.update(traj)
            frames += traj["frames"].shape[0] * traj["frames"].shape[1]
            metrics.log(update=self.update_count - 1, frames_per_sec=frames / max(time.time() - start, 1e-9),
                        **report)
            if do_eval and self.update_count % eval_every == 0:
                report["eval_mean_return"] = run_eval()["mean_return"]
        if out_weights:
            save_weights(out_weights, self.policy)
        return report
