"""Behavioural-cloning training of the VPT policy (counterpart of
vpt_tpu/training/bc.py; reference behavioural_cloning.py).

Batches are B streams of T-step chunks; the recurrent state is carried
across a stream's consecutive chunks and detached after each step
(truncated backpropagation at chunk boundaries).  The optimizer is the JAX
package's chain: clip the global gradient norm, add the L2 weight decay to
the gradient, then Adam (torch ``clip_grad_norm_`` before
``Adam(weight_decay=...)``, which is L2, not AdamW).  The value head is left
exactly as it is: the loss is the masked action log-likelihood only, and the
value head's parameters are outside the optimizer, so neither Adam nor the
weight decay ever touches them.  On CUDA the attention of every block runs
kernel B1 forward and kernel B2 backward (ops/windowed_attention.py).

Hyperparameters default to the reference's (behavioural_cloning.py:25-40).
``remat`` and ``cnn_scan_chunks`` (config.py) trade recompute for memory, so
a card holds larger batches.  ``qat_dense`` trains against the int8-rounded
dense weights the ``quantize_dense`` serving graph will use (straight-through
gradients into the float master weights), in the train and the eval step.

Checkpoints (checkpoint/native.py): every ``hp.checkpoint_every`` steps, and
on SIGTERM or SIGINT (after which the run stops), ``train`` writes the
weights, the Adam state, the step count, the loader's cursor and the
streams' recurrent state and episode ids into ``hp.checkpoint_dir``;
``train(resume_dir=...)`` goes on from the newest one as if never stopped.
Every recurrence of the policy config trains: the transformer, the three
LSTM types (whose ``{h, c}`` carries are the streams' state) and ``none``
(no state: None passes through), and a batch-norm CNN, whose running
statistics stay as they are (models/layers.py ``BatchNorm``).
Not ported yet: multi-process and sharded training.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import queue
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
from vpt_tpu_torch.checkpoint import load_model_parameters, load_state_dict_report, load_weights, save_weights
from vpt_tpu_torch.checkpoint import native as native_ckpt
from vpt_tpu_torch.config import PolicyConfig
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.models.heads import dict_logprob, head_specs_from_space
from vpt_tpu_torch.models.layers import init_parameters, set_fake_quant
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
from vpt_tpu_torch.models.transformer import map_state
from vpt_tpu_torch.ops.int8 import qat_mask
from vpt_tpu_torch.spaces import DictType
from vpt_tpu_torch.utils.metrics import MetricsLogger
from vpt_tpu_torch.utils.profiling import compiled_flops

# the batch entries a step consumes, and their tensor types
TRAIN_KEYS = {"frames": torch.uint8, "buttons": torch.int64, "camera": torch.int64,
              "firsts": torch.bool, "mask": torch.bool}


@dataclasses.dataclass
class BCHyperparams:
    learning_rate: float = 0.000181   # reference: behavioural_cloning.py:37
    weight_decay: float = 0.039428    # reference: behavioural_cloning.py:38
    max_grad_norm: float = 5.0        # reference: behavioural_cloning.py:39
    epochs: int = 2                   # reference: behavioural_cloning.py:25
    batch_size: int = 8               # reference: behavioural_cloning.py:27
    chunk_len: int = 128              # sequence window (the reference trains T=1)
    loss_report_rate: int = 100       # reference: behavioural_cloning.py:35
    checkpoint_every: int = 0         # steps between mid-run checkpoints (0 = off)
    checkpoint_dir: Optional[str] = None


def batch_to_tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The step's entries of a host batch as CPU tensors of ``TRAIN_KEYS``' types."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dtype) for k, dtype in TRAIN_KEYS.items()}


class DevicePrefetcher:
    """Overlap the host→device copy of batch k+1 with step k.

    A background thread takes host batches from ``iterator``, copies the
    step's entries into pinned memory and from there to the device with
    non-blocking copies on a side stream, and records an event; ``__next__``
    makes the current stream wait on that event.  Other entries (episode
    ids) pass through on the host.  On the CPU it only converts to tensors.
    """

    _STOP = object()

    def __init__(self, iterator, device, depth: int = 2):
        self._device = torch.device(device)
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = threading.Event()

        def put(item):
            while not self._closed.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def run():
            try:
                for batch in iterator:
                    if self._closed.is_set():
                        break
                    put(self._place(batch))
            except Exception as e:  # raised on the consumer's side
                self._err = e
            finally:
                put(self._STOP)

        self._thread = threading.Thread(target=run, daemon=True, name="batch-prefetch")
        self._thread.start()

    def _place(self, batch):
        placed = batch_to_tensors(batch)
        event = None
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                placed = {k: v.pin_memory().to(self._device, non_blocking=True) for k, v in placed.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
        placed.update((k, v) for k, v in batch.items() if k not in placed)
        return placed, event

    def close(self) -> None:
        """Stop the thread where the consumer stops early: it takes no more
        batches from the iterator (close the loader behind it too)."""
        self._closed.set()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._STOP:
            if self._err is not None:
                raise self._err
            raise StopIteration
        placed, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for k in TRAIN_KEYS:
                placed[k].record_stream(stream)  # allocated on the side stream, used on this one
        return placed


def inject_episode_firsts(batch: Dict[str, np.ndarray], last_episode: np.ndarray, chunk_len: int) -> np.ndarray:
    """Mark a chunk's first step as an episode start when its stream moved to
    a new trajectory (the loader marks a trajectory's first chunk; the move
    between trajectories is visible only here).  Mutates ``batch['firsts']``;
    returns the new per-stream episode ids."""
    new_episode = batch["episode_ids"] != last_episode
    batch["firsts"] = batch["firsts"] | new_episode[:, None] & (np.arange(chunk_len)[None] == 0)
    return batch["episode_ids"]


class ClippedAdam:
    """clip → +wd·θ → Adam → −lr·update, the JAX package's optax chain
    (vpt_tpu/training/bc.py ``make_optimizer``; PPO's, training/rl.py, is the
    same chain): ``clip_grad_norm_`` over the parameters, then
    ``torch.optim.Adam`` with L2 weight decay.  ``hp`` is a BCHyperparams or
    a PPOHyperparams."""

    def __init__(self, params, hp):
        self.params: List[torch.nn.Parameter] = list(params)
        self.max_grad_norm = hp.max_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=hp.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=hp.weight_decay)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip and apply the gradients; returns their global norm before the clip."""
        for p in self.params:
            if p.grad is None:  # as in optax, a parameter the loss does not reach still decays
                p.grad = torch.zeros_like(p)
        norm = torch.nn.utils.clip_grad_norm_(self.params, self.max_grad_norm)
        self.adam.step()
        return norm


def make_optimizer(params, hp: BCHyperparams) -> ClippedAdam:
    return ClippedAdam(params, hp)


class StopRequest:
    """Set by SIGTERM or SIGINT while a ``stop_on_signals`` block runs."""

    requested = False


@contextlib.contextmanager
def stop_on_signals():
    """Within the block, SIGTERM and SIGINT only set the yielded
    ``StopRequest``, so a training loop can checkpoint and stop (a
    preempted job); the handlers in place before are restored after it.
    Off the main thread, where no handler can be set, nothing changes."""
    stop = StopRequest()

    def request(signum, frame):
        stop.requested = True

    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, request)
        except ValueError:  # not the main thread
            pass
    try:
        yield stop
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)


class CheckpointMixin:
    """Native checkpoints of a trainer with ``policy``, ``optimizer`` (a
    ``ClippedAdam``) and ``step_count``."""

    def save_checkpoint(self, directory: str, data_state: Optional[Dict] = None, extra: Any = None,
                        keep: int = 3) -> str:
        """Write ``directory/step_<step_count>``: the weights, the Adam
        state, ``data_state`` with the step count, and ``extra``."""
        self.init()
        return native_ckpt.save_checkpoint(
            directory, self.step_count, {"policy": self.policy.state_dict()},
            opt_state=self.optimizer.adam.state_dict(),
            data_state={**(data_state or {}), "step_count": self.step_count}, extra=extra, keep=keep)

    def restore_checkpoint(self, directory: str) -> Optional[Tuple[Dict, Any]]:
        """Load the newest checkpoint of ``directory`` into the trainer;
        returns its (data_state, extra), or None where there is none."""
        self.init()
        payload, data_state = native_ckpt.restore_checkpoint(directory)
        if payload is None:
            return None
        self.policy.load_state_dict(payload["variables"]["policy"], strict=True)
        self.optimizer.adam.load_state_dict(payload["opt_state"])
        self.step_count = int(data_state["step_count"])
        return data_state, payload.get("extra")


def step_flops(trainer, *step_args) -> Optional[float]:
    """FLOPs of one ``trainer.train_step(*step_args)`` (forward, backward and
    optimizer; ``utils.profiling.compiled_flops``), with the weights, the
    optimizer state and the step count put back afterwards."""
    trainer.init()
    weights = {k: v.detach().clone() for k, v in trainer.policy.state_dict().items()}
    adam = copy.deepcopy(trainer.optimizer.adam.state_dict())
    steps = trainer.step_count
    try:
        return compiled_flops(trainer.train_step, *step_args)
    finally:
        trainer.policy.load_state_dict(weights)
        trainer.optimizer.adam.load_state_dict(adam)
        trainer.optimizer.zero_grad()
        trainer.step_count = steps


class BCTrainer(CheckpointMixin):
    """Sequence-chunked BC fine-tuning on one device.

    :param device: torch device; None means CUDA, which must then exist
    :param seed: seeds the initial weights (drawn on the CPU, so every
        device starts from the same weights) and the loader's shuffle
    :param remat, cnn_scan_chunks: the config's memory options (config.py)
    :param qat_dense: quantization-aware training for int8 serving: the
        dense weights ``quantize_dense`` serves in int8 enter the forward
        fake-quantized
    """

    def __init__(
        self,
        policy_kwargs: Dict[str, Any],
        pi_head_kwargs: Dict[str, Any],
        hp: Optional[BCHyperparams] = None,
        compute_dtype: str = "float32",
        remat: bool = False,
        cnn_scan_chunks: int = 0,
        qat_dense: bool = False,
        seed: int = 0,
        device=None,
    ):
        self.hp = hp or BCHyperparams()
        self.device = resolve_device(device)
        self.cfg = PolicyConfig.from_kwargs(dict(policy_kwargs)).replace(
            compute_dtype=compute_dtype, remat=remat, cnn_scan_chunks=cnn_scan_chunks)
        self.temperature = float(pi_head_kwargs.get("temperature", 1.0))
        self.action_mapper = CameraHierarchicalMapping(n_camera_bins=11)
        self.head_specs = head_specs_from_space(DictType(**self.action_mapper.get_action_space_update()))
        self.qat_dense = qat_dense
        self._seed = seed
        self.policy: Optional[MinecraftAgentPolicy] = None
        self.optimizer: Optional[ClippedAdam] = None
        self.step_count = 0

    # ------------------------------------------------------------------ setup

    def init(self) -> None:
        if self.policy is not None:
            return
        policy = MinecraftAgentPolicy(self.cfg, self.head_specs, self.temperature)
        init_parameters(policy, torch.Generator().manual_seed(self._seed))
        if self.qat_dense:
            set_fake_quant(policy, self.qat_mask(policy))
        self.policy = policy.to(self.device)
        self.optimizer = make_optimizer(self.trainable_parameters(), self.hp)

    def qat_mask(self, policy: Optional[MinecraftAgentPolicy] = None) -> Dict[str, bool]:
        """{parameter name: True where int8 serving quantizes it}, from the
        ``quantize_dense`` policy's own layers (ops.int8.qat_mask)."""
        cfg = self.cfg.replace(quantize_dense=True)
        names = [n for n, _ in (policy or self.policy).named_parameters()]
        return qat_mask(lambda: MinecraftAgentPolicy(cfg, self.head_specs, self.temperature), names)

    def trainable_parameters(self) -> List[torch.nn.Parameter]:
        """Every parameter but the value head's."""
        return [p for name, p in self.policy.named_parameters() if not name.startswith("value_head.")]

    def load_weights(self, path: str) -> Dict[str, list]:
        self.init()
        return load_state_dict_report(self.policy, load_weights(path))

    @classmethod
    def from_files(cls, in_model: str, in_weights: Optional[str] = None, **kw) -> "BCTrainer":
        policy_kwargs, pi_head_kwargs = load_model_parameters(in_model)
        trainer = cls(policy_kwargs, pi_head_kwargs, **kw)
        trainer.init()
        if in_weights:
            trainer.load_weights(in_weights)
        return trainer

    def initial_state(self, batch_size: int):
        return policy_initial_state(self.cfg, batch_size, ring=False, device=self.device)

    # ------------------------------------------------------------------- step

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        if not isinstance(batch["frames"], torch.Tensor):
            batch = batch_to_tensors(batch)
        return {k: batch[k].to(self.device, dtype) for k, dtype in TRAIN_KEYS.items()}

    def masked_nll(self, batch: Dict[str, torch.Tensor], state):
        """(Σ −logp·mask, state_out) of one chunk."""
        out, state_out = self.policy(batch["frames"], batch["firsts"], state)
        actions = {"buttons": batch["buttons"][..., None], "camera": batch["camera"][..., None]}
        logp = dict_logprob(out["pi_logits"], actions, self.head_specs)  # (B, T)
        return -(logp * batch["mask"].float()).sum(), state_out

    def train_step(self, batch, state):
        """One optimizer step on a (B, T) batch (host numpy, or tensors from
        :class:`DevicePrefetcher`); returns (state, loss, grad_norm), the
        state detached."""
        self.init()
        batch = self.to_device(batch)
        self.optimizer.zero_grad()
        nll, state_out = self.masked_nll(batch, state)
        # normalised by B·T: at T=1 this is the reference's sum(-logprob)/BATCH_SIZE
        loss = nll / (batch["mask"].shape[0] * batch["mask"].shape[1])
        loss.backward()
        grad_norm = self.optimizer.step()
        self.step_count += 1
        return map_state(torch.Tensor.detach, state_out), loss.detach(), grad_norm

    def train_step_flops(self, batch, state) -> Optional[float]:
        """FLOPs of one :meth:`train_step` on ``batch`` from ``state``, which
        leaves the trainer as it was (None where nothing is counted)."""
        return step_flops(self, batch, state)

    # ------------------------------------------------------------- evaluation

    @torch.no_grad()
    def evaluate(self, data_dir: str, max_batches: Optional[int] = None,
                 labels_dir: Optional[str] = None) -> Dict[str, float]:
        """Held-out BC objective over a dataset directory: mask-weighted
        negative log-likelihood per frame.  The loader's partition of
        trajectories over streams depends on ``hp.batch_size``: compare runs
        at the same batch size."""
        from vpt_tpu_torch.data.loader import SequenceDataLoader

        self.init()
        hp = self.hp
        loader = SequenceDataLoader(data_dir, batch_size=hp.batch_size, chunk_len=hp.chunk_len, n_epochs=1,
                                    seed=self._seed, resolution=(self.cfg.img_shape[1], self.cfg.img_shape[0]),
                                    labels_dir=labels_dir)
        state = self.initial_state(hp.batch_size)
        last_episode = np.full(hp.batch_size, -1, np.int64)
        nll_sum, frames, n_batches = 0.0, 0.0, 0
        try:
            for batch in loader:
                last_episode = inject_episode_firsts(batch, last_episode, hp.chunk_len)
                placed = self.to_device(batch)
                nll, state = self.masked_nll(placed, state)
                nll_sum += float(nll)
                frames += float(batch["mask"].sum())
                n_batches += 1
                if max_batches and n_batches >= max_batches:
                    break
        finally:
            loader.close()
        return {"nll_per_frame": nll_sum / max(frames, 1.0), "frames": int(frames), "batches": n_batches}

    # -------------------------------------------------------------------- run

    def train(self, data_dir: str, out_weights: str, metrics: Optional[MetricsLogger] = None,
              labels_dir: Optional[str] = None, resume_dir: Optional[str] = None) -> int:
        """Fine-tune over a contractor dataset directory for ``hp.epochs`` (or,
        with ``labels_dir``, over its videos with the IDM pseudo-labels kept
        there), logging every ``hp.loss_report_rate`` steps, then write the
        weights to ``out_weights``.  With ``resume_dir``, go on from its
        newest checkpoint: weights, Adam state, step count, and each stream's
        loader cursor, recurrent state and episode id.  Returns the number
        of optimizer steps taken in all."""
        from vpt_tpu_torch.data.loader import SequenceDataLoader

        hp = self.hp
        self.init()
        metrics = metrics or MetricsLogger()
        state = self.initial_state(hp.batch_size)
        last_episode = np.full(hp.batch_size, -1, np.int64)
        resume_state = None
        restored = self.restore_checkpoint(resume_dir) if resume_dir else None
        if restored is not None:
            data_state, extra = restored
            resume_state = data_state
            last_episode = np.asarray(data_state["last_episode"], np.int64)
            state = map_state(lambda v: v.to(self.device), extra["recurrent_state"])
        loader = SequenceDataLoader(data_dir, batch_size=hp.batch_size, chunk_len=hp.chunk_len,
                                    n_epochs=hp.epochs, seed=self._seed,
                                    resolution=(self.cfg.img_shape[1], self.cfg.img_shape[0]), labels_dir=labels_dir,
                                    resume_state=resume_state)

        def with_episode_firsts(batches):
            # in the prefetch thread: the cursor is read per batch, so a
            # checkpoint records what was trained, not what was read ahead
            nonlocal last_episode
            for batch in batches:
                last_episode = inject_episode_firsts(batch, last_episode, hp.chunk_len)
                batch["n_valid"] = int(batch["mask"].sum())
                batch["cursor"] = {**loader.state(), "last_episode": last_episode.tolist()}
                yield batch

        start = time.time()
        loss_sum, frames_seen = 0.0, 0
        prefetcher = DevicePrefetcher(with_episode_firsts(loader), self.device)
        try:
            with stop_on_signals() as stop:
                for batch in prefetcher:
                    state, loss, grad_norm = self.train_step(batch, state)
                    loss_sum += float(loss)
                    frames_seen += batch["n_valid"]
                    if self.step_count % hp.loss_report_rate == 0:
                        dt = time.time() - start
                        metrics.log(step=self.step_count, loss=loss_sum / hp.loss_report_rate,
                                    grad_norm=float(grad_norm), frames_per_sec=frames_seen / max(dt, 1e-9),
                                    wall_time=dt)
                        loss_sum = 0.0
                    due = hp.checkpoint_every and self.step_count % hp.checkpoint_every == 0
                    if hp.checkpoint_dir and (due or stop.requested):
                        self.save_checkpoint(hp.checkpoint_dir, batch["cursor"], extra={"recurrent_state": state})
                    if stop.requested:
                        metrics.log(event="preempted", step=self.step_count)
                        break
        finally:
            prefetcher.close()
            loader.close()
        save_weights(out_weights, self.policy)
        return self.step_count
