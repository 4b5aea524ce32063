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
a card holds larger batches.  Not ported yet: mid-run checkpoints and resume,
multi-process and sharded training, and QAT (``qat_dense``).
"""

from __future__ import annotations

import copy
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
from vpt_tpu_torch.checkpoint import load_model_parameters, load_state_dict_report, load_weights, save_weights
from vpt_tpu_torch.config import PolicyConfig
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.models.heads import dict_logprob, head_specs_from_space
from vpt_tpu_torch.models.layers import init_parameters
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
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

        def run():
            try:
                for batch in iterator:
                    self._q.put(self._place(batch))
            except Exception as e:  # raised on the consumer's side
                self._err = e
            finally:
                self._q.put(self._STOP)

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


class BCTrainer:
    """Sequence-chunked BC fine-tuning on one device.

    :param device: torch device; None means CUDA, which must then exist
    :param seed: seeds the initial weights (drawn on the CPU, so every
        device starts from the same weights) and the loader's shuffle
    :param remat, cnn_scan_chunks: the config's memory options (config.py)
    """

    def __init__(
        self,
        policy_kwargs: Dict[str, Any],
        pi_head_kwargs: Dict[str, Any],
        hp: Optional[BCHyperparams] = None,
        compute_dtype: str = "float32",
        remat: bool = False,
        cnn_scan_chunks: int = 0,
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
        self.policy = policy.to(self.device)
        self.optimizer = make_optimizer(self.trainable_parameters(), self.hp)

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
        state_out = [{k: v.detach() for k, v in s.items()} for s in state_out]
        return state_out, loss.detach(), grad_norm

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
              labels_dir: Optional[str] = None) -> int:
        """Fine-tune over a contractor dataset directory for ``hp.epochs`` (or,
        with ``labels_dir``, over its videos with the IDM pseudo-labels kept
        there), logging every ``hp.loss_report_rate`` steps, then write the
        weights to ``out_weights``.  Returns the number of optimizer steps
        taken."""
        from vpt_tpu_torch.data.loader import SequenceDataLoader

        hp = self.hp
        self.init()
        metrics = metrics or MetricsLogger()
        loader = SequenceDataLoader(data_dir, batch_size=hp.batch_size, chunk_len=hp.chunk_len,
                                    n_epochs=hp.epochs, seed=self._seed,
                                    resolution=(self.cfg.img_shape[1], self.cfg.img_shape[0]), labels_dir=labels_dir)
        state = self.initial_state(hp.batch_size)
        last_episode = np.full(hp.batch_size, -1, np.int64)

        def with_episode_firsts(batches):
            nonlocal last_episode
            for batch in batches:
                last_episode = inject_episode_firsts(batch, last_episode, hp.chunk_len)
                batch["n_valid"] = int(batch["mask"].sum())
                yield batch

        start = time.time()
        loss_sum, frames_seen = 0.0, 0
        try:
            for batch in DevicePrefetcher(with_episode_firsts(loader), self.device):
                state, loss, grad_norm = self.train_step(batch, state)
                loss_sum += float(loss)
                frames_seen += batch["n_valid"]
                if self.step_count % hp.loss_report_rate == 0:
                    dt = time.time() - start
                    metrics.log(step=self.step_count, loss=loss_sum / hp.loss_report_rate,
                                grad_norm=float(grad_norm), frames_per_sec=frames_seen / max(dt, 1e-9),
                                wall_time=dt)
                    loss_sum = 0.0
        finally:
            loader.close()
        save_weights(out_weights, self.policy)
        return self.step_count
