"""MineRLAgent: env-facing wrapper around the policy (counterpart of
vpt_tpu/agent/agent.py; reference agent.py).

One step serves ``batch_size`` env streams: the host resizes each frame
(cv2-bit-exact, in the native library of ops/host_resize.py on a pool of
``min(16, batch_size)`` threads), the device runs the policy at t=1 on the
recurrent state, samples the joint action, decodes it to the factored env
space and packs it with the value estimate into one (B, 23) array, which
comes back to the host in one copy.  With ``resize_on_device`` the raw
frames go to the card instead, and the step resizes them there
(``resize_bilinear``, float, at most 1 intensity step from the host path).
``dispatch_action`` enqueues a step and returns at once; ``collect_action``
waits for it.  With ``quantize_dense`` the trunk's dense layers serve int8
weights (ops/int8.py), derived from the float weights after their cast to
``params_dtype``.

With ``mesh`` (parallel/mesh.py) ``batch_size`` is the global stream count:
each rank serves its own B/(dp·fsdp) streams and their recurrent state, its
``get_action`` taking and returning those streams only, from weights that
are the same on every rank.  Stochastic sampling draws the whole batch's
noise from the shared seed and keeps the rank's rows
(``dict_sample_noise``), so the ranks together sample what one agent of the
global batch would.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from vpt_tpu_torch.actions import ActionTransformer, CameraHierarchicalMapping
from vpt_tpu_torch.actions.device_decode import DeviceActionDecoder, env_action_from_decoded
from vpt_tpu_torch.checkpoint import cast_params, load_state_dict_report, load_weights
from vpt_tpu_torch.config import (
    ACTION_TRANSFORMER_KWARGS,
    FOUNDATION_PI_HEAD_KWARGS,
    FOUNDATION_POLICY_KWARGS,
    PolicyConfig,
)
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.models.heads import dict_sample, dict_sample_noise, head_specs_from_space
from vpt_tpu_torch.models.layers import init_parameters
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
from vpt_tpu_torch.ops.host_resize import native_resize_u8
from vpt_tpu_torch.ops.int8 import quantized_model
from vpt_tpu_torch.ops.resize import resize_bilinear
from vpt_tpu_torch.parallel import mesh as pmesh
from vpt_tpu_torch.spaces import DictType
from vpt_tpu_torch.utils.profiling import count_h2d, span

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
    :param ring_cache: step a transformer policy on the rotating head-split
        cache (one slot written per step) instead of the linear cache;
        ignored for a ``none`` or LSTM policy, whose state is None or the
        ``{h, c}`` carries
    :param resize_on_device: send the raw env frames to the device and
        resize them inside the step (float bilinear, at most 1 intensity
        step from the cv2-exact host path), for a host that cannot keep up
    :param params_dtype: "float32", or "bfloat16" to store every parameter
        of two or more dims in bfloat16 for serving (``cast_params``)
    :param quantize_dense: serve the trunk's dense layers with int8 weights
        (per-output-channel scales) and int8 activations (per-row scales),
        quantized from the weights as ``params_dtype`` stores them
    :param mesh: a ``DeviceMesh`` of parallel/mesh.py: this rank serves its
        rows of the ``batch_size`` streams over (dp, fsdp) with the whole
        weights; ranks that differ only on pp, sp or tp serve the same rows,
        as replicas (vpt_tpu replicates over those axes)
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
        resize_on_device: bool = False,
        params_dtype: str = "float32",
        quantize_dense: bool = False,
        mesh=None,
    ):
        if env is not None:
            validate_env(env)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.global_batch_size = batch_size
        self._rows = pmesh.local_rows(mesh, batch_size)
        batch_size = self._rows.stop - self._rows.start  # this rank's streams
        self.batch_size = batch_size
        self.ring_cache = ring_cache
        self.resize_on_device = resize_on_device
        self.params_dtype = params_dtype
        self.quantize_dense = quantize_dense
        self._seed = seed
        self.action_mapper = CameraHierarchicalMapping(n_camera_bins=11)
        self.action_transformer = ActionTransformer(**ACTION_TRANSFORMER_KWARGS)
        policy_kwargs = dict(policy_kwargs or FOUNDATION_POLICY_KWARGS)
        pi_head_kwargs = dict(pi_head_kwargs or FOUNDATION_PI_HEAD_KWARGS)
        self.cfg = PolicyConfig.from_kwargs(policy_kwargs).replace(compute_dtype=compute_dtype)
        self.head_specs = head_specs_from_space(DictType(**self.action_mapper.get_action_space_update()))
        self.temperature = float(pi_head_kwargs.get("temperature", 1.0))
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.policy = self._maybe_quantize(self._float_policy(self._generator))
        self.decoder = DeviceActionDecoder(self.action_mapper, self.action_transformer.quantizer, self.device)
        # cv2 (width, height) order from the model's (h, w, c) img_shape
        self._resolution = (self.cfg.img_shape[1], self.cfg.img_shape[0])
        self.hidden_state = policy_initial_state(self.cfg, batch_size, self.ring_cache, self.device)
        self._last_vpred = None
        # the native resize releases the GIL, so the streams' frames resize in parallel
        self._resize_pool = ThreadPoolExecutor(max_workers=min(16, batch_size)) if batch_size > 1 else None

    def _float_policy(self, generator: torch.Generator) -> MinecraftAgentPolicy:
        """The float policy, its weights drawn from ``generator`` and cast to
        ``params_dtype``."""
        policy = MinecraftAgentPolicy(self.cfg, self.head_specs, self.temperature, device=self.device).eval()
        init_parameters(policy, generator)
        return cast_params(policy, self.params_dtype)

    def _maybe_quantize(self, policy: MinecraftAgentPolicy) -> MinecraftAgentPolicy:
        """The int8 serving twin of a float ``policy`` under ``quantize_dense``
        (``policy`` itself otherwise)."""
        if not self.quantize_dense:
            return policy
        cfg = self.cfg.replace(quantize_dense=True)
        return quantized_model(policy, lambda: MinecraftAgentPolicy(cfg, self.head_specs, self.temperature))

    def load_weights(self, path: str) -> None:
        """Load a reference ``.weights`` file (strict=False) and reset state.
        A quantized agent loads into a float policy and quantizes it again."""
        policy = self.policy
        if self.quantize_dense:  # the float layout back, drawn as at construction for what the file lacks
            policy = self._float_policy(torch.Generator(device=self.device).manual_seed(self._seed))
        report = load_state_dict_report(policy, load_weights(path))
        cast_params(policy, self.params_dtype)
        self.policy = self._maybe_quantize(policy)
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
        """(list of) env obs → (B, 1, h, w, 3) uint8 frames at the model's
        resolution, or the raw (B, 1, H, W, 3) frames with ``resize_on_device``."""
        povs = minerl_obs if isinstance(minerl_obs, list) else [minerl_obs]
        if self.resize_on_device:
            return np.stack([o["pov"] for o in povs])[:, None]
        if self._resize_pool is not None and len(povs) > 1:
            frames = list(self._resize_pool.map(lambda o: native_resize_u8(o["pov"], self._resolution), povs))
        else:
            frames = [native_resize_u8(o["pov"], self._resolution) for o in povs]
        return np.stack(frames)[:, None]

    def _agent_action_to_env(self, agent_action) -> Dict[str, np.ndarray]:
        """Joint-space action arrays {"buttons", "camera"} → the env's action
        dict (reference: agent.py:141-164)."""
        action = {"buttons": np.asarray(agent_action["buttons"]), "camera": np.asarray(agent_action["camera"])}
        return self.action_transformer.policy2env(self.action_mapper.to_factored(action))

    def _env_action_to_agent(self, minerl_action_transformed, check_if_null: bool = False):
        """Env action → joint-space action arrays (reference: agent.py:166-188);
        None for a null action (no button, camera at its zero bin) where
        ``check_if_null``."""
        minerl_action = self.action_transformer.env2policy(minerl_action_transformed)
        if check_if_null and np.all(minerl_action["buttons"] == 0) and np.all(
                minerl_action["camera"] == self.action_transformer.camera_zero_bin()):
            return None
        if minerl_action["camera"].ndim == 1:
            minerl_action = {k: v[None] for k, v in minerl_action.items()}
        return self.action_mapper.from_factored(minerl_action)

    @torch.inference_mode()
    def _step(self, img: np.ndarray, first: np.ndarray, stochastic: bool, state):
        """One policy step on ``state``; returns the packed (B, 23) decoded
        action and value, and the state after the step."""
        with span("vpt_torch.agent.upload"):
            img_t, first_t = torch.from_numpy(img), torch.from_numpy(first)
            count_h2d(img_t, first_t)
            img_t = img_t.to(self.device, non_blocking=True)
            first_t = first_t.to(self.device, non_blocking=True)
        if self.resize_on_device:
            with span("vpt_torch.agent.resize"):
                img_t = resize_bilinear(img_t, self._resolution)  # float32; the policy scales it as it does uint8
        out, state = self.policy(img_t, first_t, state)
        with span("vpt_torch.agent.sample"):
            logits = {k: v[:, -1] for k, v in out["pi_logits"].items()}
            noise = None
            if stochastic and self.mesh is not None:  # the global batch's draw, this rank's rows of it
                noise = dict_sample_noise(logits, self.head_specs, self._generator, self.global_batch_size,
                                          self._rows)
            action = dict_sample(logits, self.head_specs, deterministic=not stochastic,
                                 generator=self._generator, noise=noise)
            decoded = self.decoder.decode(action["buttons"][:, 0], action["camera"][:, 0])
            return torch.cat([decoded, out["vpred"][:, -1].float()], dim=1), state

    def _prepare(self, minerl_obs, first):
        with span("vpt_torch.agent.prep"):
            img = self._env_obs_to_agent(minerl_obs)
            b = img.shape[0]
            if b != self.batch_size:
                raise ValueError(f"got {b} obs for batch_size {self.batch_size}")
            return img, np.zeros((b, 1), bool) if first is None else np.asarray(first, bool).reshape(b, 1)

    def dispatch_action(self, minerl_obs, first: Optional[np.ndarray] = None, stochastic: bool = True):
        """Enqueue one policy step on ``hidden_state`` and return a handle
        without waiting."""
        handle, self.hidden_state = self.dispatch_action_with_state(
            minerl_obs, self.hidden_state, first, stochastic)
        return handle

    def initial_group_state(self):
        """Fresh recurrent state for one ``batch_size``-wide stream group, for
        :meth:`dispatch_action_with_state` (GroupedRolloutRunner drives
        several groups through one agent)."""
        return policy_initial_state(self.cfg, self.batch_size, self.ring_cache, self.device)

    def dispatch_action_with_state(self, minerl_obs, state, first: Optional[np.ndarray] = None,
                                   stochastic: bool = True):
        """Enqueue one policy step on the caller's recurrent state; returns
        (handle, state after the step).  The ring cache's slot is written
        into ``state`` in place."""
        with span("vpt_torch.agent.dispatch"):
            img, first = self._prepare(minerl_obs, first)
            packed, state = self._step(img, first, stochastic, state)
            return (packed, isinstance(minerl_obs, list)), state

    def collect_action(self, handle):
        """Wait for a dispatched step: one packed device→host copy, then the
        env-format action (a list of dicts iff the obs was a list)."""
        with span("vpt_torch.agent.collect"):
            packed, as_list = handle
            with span("vpt_torch.agent.download"):
                packed = packed.cpu().numpy()
            with span("vpt_torch.agent.unpack"):
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
