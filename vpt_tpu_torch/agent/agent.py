"""MineRLAgent: env-facing wrapper around the policy (counterpart of
vpt_tpu/agent/agent.py; reference agent.py).

One step serves ``batch_size`` env streams: the host resizes each frame
(cv2-bit-exact numpy), the device runs the policy at t=1 on the recurrent
state, samples the joint action, decodes it to the factored env space and
packs it with the value estimate into one (B, 23) array, which comes back to
the host in one copy.  ``dispatch_action`` enqueues a step and returns at
once; ``collect_action`` waits for it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from vpt_tpu_torch.actions import ActionTransformer, CameraHierarchicalMapping
from vpt_tpu_torch.actions.device_decode import DeviceActionDecoder, env_action_from_decoded
from vpt_tpu_torch.checkpoint import load_state_dict_report, load_weights
from vpt_tpu_torch.config import (
    ACTION_TRANSFORMER_KWARGS,
    FOUNDATION_PI_HEAD_KWARGS,
    FOUNDATION_POLICY_KWARGS,
    PolicyConfig,
)
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.models.heads import dict_sample, head_specs_from_space
from vpt_tpu_torch.models.layers import init_parameters
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
from vpt_tpu_torch.ops.resize import resize_uint8_exact
from vpt_tpu_torch.spaces import DictType

ENV_KWARGS = dict(  # reference: agent.py:47-54
    fov_range=[70, 70],
    frameskip=1,
    gamma_range=[2, 2],
    guiscale_range=[1, 1],
    resolution=[640, 360],
    cursor_size_range=[16.0, 16.0],
)

TARGET_ACTION_NAMES = {
    "ESC", "attack", "back", "camera", "drop", "forward",
    "hotbar.1", "hotbar.2", "hotbar.3", "hotbar.4", "hotbar.5",
    "hotbar.6", "hotbar.7", "hotbar.8", "hotbar.9",
    "inventory", "jump", "left", "pickItem", "right",
    "sneak", "sprint", "swapHands", "use",
}


def validate_env(env) -> None:
    """Check the MineRL env matches the recording setup (reference:
    agent.py:84-97).  No-op for envs without the expected attributes."""
    task = getattr(env, "task", None)
    if task is not None:
        for key, value in ENV_KWARGS.items():
            if key != "frameskip" and getattr(task, key, value) != value:
                raise ValueError(f"MineRL environment setting {key} does not match {value}")
    spaces_dict = getattr(getattr(env, "action_space", None), "spaces", None)
    if spaces_dict is not None and set(spaces_dict.keys()) != TARGET_ACTION_NAMES:
        raise ValueError(f"MineRL action space does not match. Expected actions {TARGET_ACTION_NAMES}")


class MineRLAgent:
    """Plays Minecraft from pixels with persistent recurrent state.

    :param device: torch device; None means CUDA, which must then exist
    :param policy_kwargs: raw ``.model`` kwargs (default: the published 2x
        foundation settings, reference agent.py:16-36)
    :param pi_head_kwargs: e.g. {"temperature": 2.0}
    :param batch_size: number of parallel env streams
    :param seed: seeds the random initial weights and the sampling generator
    :param compute_dtype: "float32" or "bfloat16"
    :param ring_cache: step on the rotating head-split cache (one slot
        written per step) instead of the linear cache
    """

    def __init__(
        self,
        env=None,
        device=None,
        policy_kwargs: Optional[Dict[str, Any]] = None,
        pi_head_kwargs: Optional[Dict[str, Any]] = None,
        batch_size: int = 1,
        seed: int = 0,
        compute_dtype: str = "float32",
        ring_cache: bool = True,
    ):
        if env is not None:
            validate_env(env)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.ring_cache = ring_cache
        self.action_mapper = CameraHierarchicalMapping(n_camera_bins=11)
        self.action_transformer = ActionTransformer(**ACTION_TRANSFORMER_KWARGS)
        policy_kwargs = dict(policy_kwargs or FOUNDATION_POLICY_KWARGS)
        pi_head_kwargs = dict(pi_head_kwargs or FOUNDATION_PI_HEAD_KWARGS)
        self.cfg = PolicyConfig.from_kwargs(policy_kwargs).replace(compute_dtype=compute_dtype)
        self.head_specs = head_specs_from_space(DictType(**self.action_mapper.get_action_space_update()))
        self.policy = MinecraftAgentPolicy(
            self.cfg, self.head_specs, float(pi_head_kwargs.get("temperature", 1.0)), device=self.device,
        ).eval()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        init_parameters(self.policy, self._generator)
        self.decoder = DeviceActionDecoder(self.action_mapper, self.action_transformer.quantizer, self.device)
        # cv2 (width, height) order from the model's (h, w, c) img_shape
        self._resolution = (self.cfg.img_shape[1], self.cfg.img_shape[0])
        self.hidden_state = policy_initial_state(self.cfg, batch_size, self.ring_cache, self.device)
        self._last_vpred = None

    def load_weights(self, path: str) -> None:
        """Load a reference ``.weights`` file (strict=False) and reset state."""
        report = load_state_dict_report(self.policy, load_weights(path))
        if report["unexpected"] or report["shape_mismatch"]:
            print(
                f"[vpt_tpu_torch] load_weights: ignored {len(report['unexpected'])} unexpected keys, "
                f"{len(report['shape_mismatch'])} shape mismatches"
            )
        self.reset()

    def reset(self) -> None:
        """Reset recurrent state for all streams (reference: agent.py:137-139)."""
        self.hidden_state = policy_initial_state(self.cfg, self.batch_size, self.ring_cache, self.device)

    def _env_obs_to_agent(self, minerl_obs) -> np.ndarray:
        """(list of) env obs → (B, 1, h, w, 3) uint8 frames at the model's resolution."""
        povs = minerl_obs if isinstance(minerl_obs, list) else [minerl_obs]
        return np.stack([resize_uint8_exact(o["pov"], self._resolution) for o in povs])[:, None]

    @torch.inference_mode()
    def _step(self, img: np.ndarray, first: np.ndarray, stochastic: bool, state):
        """One policy step on ``state``; returns the packed (B, 23) decoded
        action and value, and the state after the step."""
        img_t = torch.from_numpy(img).to(self.device, non_blocking=True)
        first_t = torch.from_numpy(first).to(self.device, non_blocking=True)
        out, state = self.policy(img_t, first_t, state)
        logits = {k: v[:, -1] for k, v in out["pi_logits"].items()}
        action = dict_sample(logits, self.head_specs, deterministic=not stochastic,
                             generator=self._generator)
        decoded = self.decoder.decode(action["buttons"][:, 0], action["camera"][:, 0])
        return torch.cat([decoded, out["vpred"][:, -1].float()], dim=1), state

    def _prepare(self, minerl_obs, first):
        img = self._env_obs_to_agent(minerl_obs)
        b = img.shape[0]
        if b != self.batch_size:
            raise ValueError(f"got {b} obs for batch_size {self.batch_size}")
        return img, np.zeros((b, 1), bool) if first is None else np.asarray(first, bool).reshape(b, 1)

    def dispatch_action(self, minerl_obs, first: Optional[np.ndarray] = None, stochastic: bool = True):
        """Enqueue one policy step and return a handle without waiting."""
        img, first = self._prepare(minerl_obs, first)
        packed, self.hidden_state = self._step(img, first, stochastic, self.hidden_state)
        return packed, isinstance(minerl_obs, list)

    def initial_group_state(self):
        """Fresh recurrent state for one ``batch_size``-wide stream group, for
        :meth:`dispatch_action_with_state` (GroupedRolloutRunner drives
        several groups through one agent)."""
        return policy_initial_state(self.cfg, self.batch_size, self.ring_cache, self.device)

    def dispatch_action_with_state(self, minerl_obs, state, first: Optional[np.ndarray] = None,
                                   stochastic: bool = True):
        """:meth:`dispatch_action` on the caller's recurrent state instead of
        ``hidden_state``; returns (handle, state after the step).  The ring
        cache's slot is written into ``state`` in place."""
        img, first = self._prepare(minerl_obs, first)
        packed, state = self._step(img, first, stochastic, state)
        return (packed, isinstance(minerl_obs, list)), state

    def collect_action(self, handle):
        """Wait for a dispatched step: one packed device→host copy, then the
        env-format action (a list of dicts iff the obs was a list)."""
        packed, as_list = handle
        packed = packed.cpu().numpy()
        self._last_vpred = packed[:, 22:23]
        env_action = env_action_from_decoded(packed)
        if as_list:
            return [{k: v[i] for k, v in env_action.items()} for i in range(self.batch_size)]
        return {k: v[0] for k, v in env_action.items()}

    def get_action(self, minerl_obs, first: Optional[np.ndarray] = None, stochastic: bool = True):
        """One policy step; returns a MineRL action dict (a list of dicts when
        the obs is a list)."""
        return self.collect_action(self.dispatch_action(minerl_obs, first, stochastic))

    def predict_value(self, minerl_obs, first: Optional[np.ndarray] = None):
        """Value estimate for the observation(s), the reference's
        MinecraftAgentPolicy.v (policy.py:330-339): a (B,) array, or a float
        at batch_size 1.  Takes a step: the hidden state advances."""
        self.get_action(minerl_obs, first=first, stochastic=True)
        return self._last_vpred[:, 0] if self.batch_size > 1 else float(self._last_vpred[0, 0])
