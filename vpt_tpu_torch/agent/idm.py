"""IDMAgent and StreamingIDMLabeler: label video with the actions the player
took (counterpart of vpt_tpu/agent/idm.py; reference
inverse_dynamics_model.py).

Frames are labeled in windows (the published IDM's is 128 frames) through
the unmasked inverse dynamics model; each window's forward runs kernel B1 in
every block on CUDA.  Windows are independent, so they stack on the batch
axis: ``predict_actions_batched`` labels B windows in one forward.
``dispatch_actions_batched`` enqueues that forward and the copy of its labels
to the host and returns at once; ``collect_actions`` waits for them, so the
host can decode the next frames meanwhile.

With ``quantize_dense`` the IDM's trunk dense layers serve int8 weights
(ops/int8.py), quantized at the first forward from the float weights as
``params_dtype`` stores them, and again after every ``load_weights``.

Frames are resized with the numpy cv2-exact ``resize_image`` on one thread,
as the JAX package's ``IDMAgent`` and labeler do; the policy agent and the
PPO collection use the native host resize (ops/host_resize.py).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from vpt_tpu_torch.actions import ActionTransformer, IDMActionMapping
from vpt_tpu_torch.checkpoint import cast_params, load_state_dict_report, load_weights
from vpt_tpu_torch.config import ACTION_TRANSFORMER_KWARGS, PolicyConfig
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.models.heads import dict_sample, head_specs_from_space
from vpt_tpu_torch.models.layers import init_parameters
from vpt_tpu_torch.models.policy import InverseActionPolicy, policy_initial_state
from vpt_tpu_torch.ops.int8 import quantized_model
from vpt_tpu_torch.ops.resize import resize_image
from vpt_tpu_torch.parallel import mesh as pmesh
from vpt_tpu_torch.spaces import DictType
from vpt_tpu_torch.utils.profiling import count_h2d, span

# Resolution the published IDM expects its source videos at (reference:
# run_inverse_dynamics_model.py:155 asserts 640x360 before labeling).
IDM_REQUIRED_RESOLUTION = (640, 360)


def action_jsonl_row(action: Dict[str, Any]) -> Dict[str, Any]:
    """One labeled action as plain lists, ready for
    ``json.dumps({"frame": i, "action": row})``: the on-disk schema that the
    loader's pseudo-label path reads back."""
    return {name: np.asarray(v).tolist() for name, v in action.items()}


class IDMAgent:
    """Predicts the actions a human took in a video (reference:
    inverse_dynamics_model.py:21-95).

    :param device: torch device; None means CUDA, which must then exist
    :param seed: seeds the random initial weights (drawn on the CPU, so every
        device starts from the same weights)
    :param compute_dtype: "float32" or "bfloat16"
    :param params_dtype: "float32", or "bfloat16" to store every parameter
        of two or more dims in bfloat16 (``cast_params``)
    :param quantize_dense: label with int8 trunk dense layers
    :param mesh: a ``DeviceMesh`` of parallel/mesh.py for batched labeling:
        every rank passes the same windows to ``predict_actions_batched``,
        labels its rows of them (dp, fsdp) and, with an sp axis, embeds its
        slice of each window's frames; every rank returns all the labels.
        Ranks that differ only on pp or tp label the same rows, as replicas
        (vpt_tpu replicates over those axes)
    """

    def __init__(self, idm_net_kwargs: Dict[str, Any], pi_head_kwargs: Dict[str, Any], device=None,
                 compute_dtype: str = "float32", seed: int = 0, params_dtype: str = "float32",
                 quantize_dense: bool = False, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params_dtype = params_dtype
        self.quantize_dense = quantize_dense
        self._seed = seed
        self.action_mapper = IDMActionMapping(n_camera_bins=11)
        self.action_transformer = ActionTransformer(**ACTION_TRANSFORMER_KWARGS)
        self.cfg = PolicyConfig.from_kwargs(dict(idm_net_kwargs)).replace(compute_dtype=compute_dtype)
        self.head_specs = head_specs_from_space(DictType(**self.action_mapper.get_action_space_update()))
        self.temperature = float(pi_head_kwargs.get("temperature", 1.0))
        self.policy = self._float_policy()
        self._quantized = False
        self.hidden_state = policy_initial_state(self.cfg, 1, device=self.device)

    def _float_policy(self) -> InverseActionPolicy:
        policy = InverseActionPolicy(self.cfg, self.head_specs, self.temperature)
        init_parameters(policy, torch.Generator().manual_seed(self._seed))
        return cast_params(policy.to(self.device).eval(), self.params_dtype)

    def _maybe_quantize(self) -> None:
        """Swap in the int8 serving twin of the float policy, once, under
        ``quantize_dense`` (called by every forward)."""
        if not self.quantize_dense or self._quantized:
            return
        cfg = self.cfg.replace(quantize_dense=True)
        self.policy = quantized_model(self.policy, lambda: InverseActionPolicy(cfg, self.head_specs, self.temperature))
        self._quantized = True

    def load_weights(self, path: str) -> None:
        """Load a reference ``.weights`` file (strict=False) and reset state.
        A quantized agent loads into a float policy and quantizes it again."""
        if self._quantized:  # the float layout back, drawn as at construction for what the file lacks
            self.policy, self._quantized = self._float_policy(), False
        report = load_state_dict_report(self.policy, load_weights(path))
        cast_params(self.policy, self.params_dtype)
        self._maybe_quantize()
        if report["unexpected"] or report["shape_mismatch"]:
            print(
                f"[vpt_tpu_torch] load_weights: ignored {len(report['unexpected'])} unexpected keys, "
                f"{len(report['shape_mismatch'])} shape mismatches"
            )
        self.reset()

    def reset(self) -> None:
        self.hidden_state = policy_initial_state(self.cfg, 1, device=self.device)

    def _video_obs_to_agent(self, video_frames) -> np.ndarray:
        size = (self.cfg.img_shape[1], self.cfg.img_shape[0])
        return np.stack([resize_image(frame, size) for frame in video_frames])[None]  # (1, N, h, w, 3)

    def _agent_action_to_env(self, action: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.action_transformer.policy2env(self.action_mapper.to_factored(action))

    def _forward(self, img: np.ndarray, state):
        """Argmax labels (reference policy.py:448-458) of a (B, N) window
        stack, and the state after it."""
        self._maybe_quantize()  # outside inference mode: the model outlives this call
        with torch.inference_mode():
            with span("vpt_torch.idm.upload"):
                img_t = torch.from_numpy(np.ascontiguousarray(img))
                if self.device.type == "cuda":  # from pinned memory, the copy waits for nothing queued before it
                    img_t = img_t.pin_memory()
                count_h2d(img_t)
                img_t = img_t.to(self.device, non_blocking=True)
            first = torch.zeros(img.shape[:2], dtype=torch.bool, device=self.device)
            action, state, _ = self.policy.predict(img_t, first, state, deterministic=True)
        return action, state

    def predict_actions(self, video_frames: np.ndarray) -> Dict[str, np.ndarray]:
        """Predict actions for (N, H, W, C) frames → MineRL action dict with
        (1, N) leading dims (reference: inverse_dynamics_model.py:74-95).

        The attention state is carried from call to call: with no mask, a
        window's queries also attend to the previous call's last ``maxlen``
        keys, so N frames attend over N + maxlen keys, any N."""
        action, self.hidden_state = self._forward(self._video_obs_to_agent(video_frames), self.hidden_state)
        return self._agent_action_to_env({k: v.cpu().numpy() for k, v in action.items()})

    def predict_actions_batched(self, windows: np.ndarray) -> Dict[str, np.ndarray]:
        """Label a stack of already-resized windows (B, N, h, w, 3) in one
        forward, each from a fresh zero state: its ``maxlen`` zero cache keys
        are attended as well, since nothing masks them.

        :returns: MineRL action dict with (B, N) leading dims.
        """
        return self.collect_actions(self.dispatch_actions_batched(windows))

    def dispatch_actions_batched(self, windows: np.ndarray):
        """Enqueue :meth:`predict_actions_batched`'s forward and the copy of
        its labels to the host; returns a handle for :meth:`collect_actions`
        without waiting for the device."""
        if self.mesh is not None:
            action = self._mesh_labels(windows)
        else:
            action, _ = self._forward(windows, policy_initial_state(self.cfg, windows.shape[0], device=self.device))
        if self.device.type != "cuda":
            return action, None
        host = {k: v.to("cpu", non_blocking=True) for k, v in action.items()}  # into pinned memory
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _mesh_labels(self, windows: np.ndarray) -> Dict[str, torch.Tensor]:
        """Argmax labels of a (B, N) window stack on the mesh: this rank's
        windows where B divides over the data ranks (every window on every
        rank otherwise), this rank's frames under sp (the CNN's share; the
        latents gathered for the blocks), the labels gathered whole."""
        from vpt_tpu_torch.parallel.model import SequenceParallelForward

        self._maybe_quantize()
        b = windows.shape[0]
        shard = b % pmesh.data_shard(self.mesh)[1] == 0
        rows = pmesh.local_rows(self.mesh, b) if shard else slice(0, b)
        with torch.inference_mode():
            img = torch.from_numpy(np.ascontiguousarray(windows[rows])).to(self.device)
            first = torch.zeros(img.shape[:2], dtype=torch.bool, device=self.device)
            state = policy_initial_state(self.cfg, img.shape[0], device=self.device)
            out, _ = SequenceParallelForward(self.policy, self.mesh)(img, first, state)
            action = dict_sample(out["pi_logits"], self.head_specs, deterministic=True)
            if pmesh.axis_size(self.mesh, "sp") > 1:
                action = {k: pmesh.all_gather_cat(v, pmesh.group(self.mesh, ("sp",)), dim=1) for k, v in action.items()}
            if shard:
                action = {k: pmesh.gather_rows(self.mesh, v) for k, v in action.items()}
        return action

    def collect_actions(self, handle) -> Dict[str, np.ndarray]:
        """Wait for a dispatched forward and decode its labels to the MineRL
        action dict."""
        action, done = handle
        with span("vpt_torch.labeler.wait"):
            if done is not None:
                done.synchronize()
        return self._agent_action_to_env({k: v.numpy() for k, v in action.items()})


class StreamingIDMLabeler:
    """Label arbitrarily long videos with overlap-stitched IDM windows.

    The IDM attends in both directions inside its window, so frames near a
    window's edge see context on one side only.  This labeler slides the
    window by ``stride`` <= ``window`` frames and emits each window's central
    labels: the window starting at s owns [s + lo, s + lo + stride) with
    lo = (window - stride) // 2, extended to index 0 for the first window.
    What the complete windows did not cover by the end is owned by one tail
    window of the last ``window`` frames.  ``stride == window`` is the
    reference CLI's disjoint windows.

    Ready windows are labeled ``window_batch`` at a time in one forward
    (:meth:`IDMAgent.dispatch_actions_batched`), at most ``max_inflight``
    forwards enqueued at once; the next frames are decoded while the device
    works.  A ragged last group runs at its own batch size: windows are
    independent, so padding it to ``window_batch`` (the JAX package's
    workaround for a second compile on the TPU) changes no label.

    Usage::

        labeler = StreamingIDMLabeler(agent, window=128, stride=64)
        for frame in frames:                     # raw (H, W, C) uint8
            for idx, action in labeler.feed(frame):
                ...                              # global index, env action
        for idx, action in labeler.finish():
            ...
    """

    def __init__(self, agent: IDMAgent, window: int = 128, stride: Optional[int] = None,
                 window_batch: int = 1, max_inflight: int = 1):
        stride = window if stride is None else stride
        assert 0 < stride <= window, (stride, window)
        assert window <= agent.cfg.timesteps, (
            f"window {window} exceeds the IDM's trained geometry timesteps={agent.cfg.timesteps}"
        )
        assert window_batch >= 1 and max_inflight >= 1
        self.agent = agent
        self.window = window
        self.stride = stride
        self.window_batch = window_batch
        self.max_inflight = max_inflight
        self._lo = (window - stride) // 2
        self._history = deque(maxlen=window)  # the last `window` resized frames
        self._next_win_start = 0              # start of the next window to cut
        self._n_fed = 0
        self._emitted = 0                     # next global index to emit
        self._pending = []                    # (win_start, (N, h, w, 3)) windows
        self._inflight = []                   # (group, handle), oldest first

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        shape = self.agent.cfg.img_shape
        return resize_image(frame, (shape[1], shape[0]))

    def _harvest_one(self, out):
        """Wait for the oldest in-flight group and emit its owned labels."""
        group, handle = self._inflight.pop(0)
        with span("vpt_torch.labeler.emit"):  # the wait for the forward (labeler.wait) inside
            actions = self.agent.collect_actions(handle)
            for row, (win_start, _) in enumerate(group):
                begin = max(self._emitted, 0 if win_start == 0 else win_start + self._lo)
                end = win_start + self._lo + self.stride
                out.extend((i, {k: v[row, i - win_start] for k, v in actions.items()}) for i in range(begin, end))
                self._emitted = max(self._emitted, end)

    def _label_pending(self, flush: bool = False):
        """Dispatch full window_batch groups (all pending ones when
        flushing); groups are harvested in order, so labels come out in
        order."""
        out = []
        while self._pending and (flush or len(self._pending) >= self.window_batch):
            group = self._pending[: self.window_batch]
            del self._pending[: self.window_batch]
            while len(self._inflight) >= self.max_inflight:
                self._harvest_one(out)
            with span("vpt_torch.labeler.stack"):
                windows = np.stack([w for _, w in group])
            handle = self.agent.dispatch_actions_batched(windows)
            self._inflight.append((group, handle))
        if flush:
            while self._inflight:
                self._harvest_one(out)
        return out

    def feed(self, frame: np.ndarray):
        """Add one raw frame; returns the labels that became final, as a list
        of (global frame index, MineRL action dict), in order."""
        return self.feed_resized(self._resize(frame))

    def feed_resized(self, frame: np.ndarray):
        """:meth:`feed` for a frame already at the agent's resolution (for
        callers that decode and resize in batches, ``VideoReader.read_batch``)."""
        expect = tuple(self.agent.cfg.img_shape[:2]) + (3,)
        assert frame.shape == expect, (
            f"feed_resized expects {expect} frames, got {frame.shape} (use feed() for raw video frames)"
        )
        self._history.append(frame)
        self._n_fed += 1
        while self._n_fed - self._next_win_start >= self.window:
            # the history holds exactly [n_fed - len(history), n_fed), which covers this window
            offset = self._next_win_start - (self._n_fed - len(self._history))
            with span("vpt_torch.labeler.cut"):
                frames = list(self._history)[offset: offset + self.window]
                self._pending.append((self._next_win_start, np.stack(frames)))
            self._next_win_start += self.stride
        return self._label_pending()

    def finish(self):
        """Flush the pending windows, then cover any remaining tail frames
        with one window of the last ``window`` frames."""
        out = self._label_pending(flush=True)
        if self._emitted < self._n_fed:
            with span("vpt_torch.labeler.stack"):
                tail = np.stack(self._history)[None]  # min(window, n_fed) frames
            tail_start = self._n_fed - tail.shape[1]
            actions = self.agent.predict_actions_batched(tail)
            out.extend((i, {k: v[0, i - tail_start] for k, v in actions.items()})
                       for i in range(self._emitted, self._n_fed))
            self._emitted = self._n_fed
        return out
