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

On a mesh (``mesh=``, parallel/mesh.py; one process a device under
torchrun) the step equals the single-device step on the same global batch:
``hp.batch_size`` is the global batch, each rank loads its B/(dp·fsdp)
streams (the loader's shard), and ``train_step`` takes those local rows.
The model is wrapped by parallel/model.py: DDP over (dp, sp), FSDP2 when
fsdp > 1, the tensor-parallel plan when tp > 1, whole parameters on every
rank otherwise.  The loss of each rank is the mean over its own rows and
(under sp) its own time slice, so the data axes' gradient average is the
global mean's gradient; the global batch must divide evenly over the ranks.
The value head, which the loss never reaches, is outside DDP's reduction as
it is outside the optimizer.  Rank 0 writes the weights and checkpoints,
pulled whole from the shards by every rank together; every other rank
writes its own cursor and streams' state under ``<checkpoint_dir>/shard<p>``.
A stop signal on any rank stops every rank after a common checkpoint.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import queue
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
from vpt_tpu_torch.checkpoint import load_model_parameters, load_weights
from vpt_tpu_torch.checkpoint import native as native_ckpt
from vpt_tpu_torch.config import PolicyConfig
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.models.heads import dict_logprob, head_specs_from_space
from vpt_tpu_torch.models.layers import init_parameters, set_fake_quant
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
from vpt_tpu_torch.models.transformer import map_state
from vpt_tpu_torch.ops.int8 import qat_mask
from vpt_tpu_torch.parallel import mesh as pmesh
from vpt_tpu_torch.spaces import DictType
from vpt_tpu_torch.utils.metrics import MetricsLogger
from vpt_tpu_torch.utils.profiling import compiled_flops, count_h2d, span

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
        # tensor parallelism mixes plain and DTensor parameters, which one
        # multi-tensor update does not take: they go in a group each
        kinds = [[p for p in self.params if isinstance(p, torch.distributed.tensor.DTensor) == d] for d in (False, True)]
        groups = [{"params": ps} for ps in kinds if ps] if all(kinds) else self.params
        self.adam = torch.optim.Adam(groups, lr=hp.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=hp.weight_decay)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip and apply the gradients; returns their global norm before the clip."""
        with span("vpt_torch.bc.optimizer"):
            for p in self.params:
                if p.grad is None:  # as in optax, a parameter the loss does not reach still decays
                    p.grad = torch.zeros_like(p)
            norm = pmesh.clip_grad_norm_(self.params, self.max_grad_norm)  # torch's own for plain tensors
            self.adam.step()
            return norm

    def state_dict(self) -> Dict:
        """Adam's whole state in the single-device layout (one group in
        ``params`` order) on any mesh: a collective where it is sharded."""
        return pmesh.full_optimizer_state(self.adam, self.params)

    def load_state_dict(self, sd: Dict) -> None:
        pmesh.load_full_optimizer_state(self.adam, self.params, sd)


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
    ``ClippedAdam``), ``step_count`` and ``mesh`` (None on one device).  On
    a mesh the saves and loads are collectives: every rank pulls the whole
    weights and moments, rank 0 writes them, every rank reads them."""

    def full_weights(self) -> Dict[str, torch.Tensor]:
        """The policy's whole state_dict on the host (a collective on a mesh)."""
        self.init()
        return pmesh.full_state_dict(self.policy)

    def save_weights(self, path: str) -> None:
        """Write the ``.weights`` file from rank 0 (every rank calls it)."""
        weights = self.full_weights()
        if self._writer():
            torch.save(weights, path)

    def save_checkpoint(self, directory: str, data_state: Optional[Dict] = None, extra: Any = None,
                        keep: int = 3) -> Optional[str]:
        """Write ``directory/step_<step_count>``: the weights, the Adam
        state, ``data_state`` with the step count, and ``extra``; returns
        its path on the rank that writes (rank 0), else None."""
        weights = self.full_weights()
        opt = self.optimizer.state_dict()
        if not self._writer():
            return None
        return native_ckpt.save_checkpoint(
            directory, self.step_count, {"policy": weights}, opt_state=opt,
            data_state={**(data_state or {}), "step_count": self.step_count}, extra=extra, keep=keep)

    def restore_checkpoint(self, directory: str) -> Optional[Tuple[Dict, Any]]:
        """Load the newest checkpoint of ``directory`` into the trainer;
        returns its (data_state, extra), or None where there is none."""
        self.init()
        payload, data_state = native_ckpt.restore_checkpoint(directory)
        if payload is None:
            return None
        pmesh.load_full_state_dict(self.policy, payload["variables"]["policy"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.step_count = int(data_state["step_count"])
        return data_state, payload.get("extra")

    def load_weights_report(self, state_dict: Dict[str, torch.Tensor]) -> Dict[str, list]:
        """``load_state_dict_report`` of the policy, through its whole
        weights (on a mesh every rank loads the same file)."""
        return pmesh.load_weights_whole(self.policy, state_dict)

    def _wrap(self, policy, unused=()):
        """The trained model on ``self.mesh`` (parallel/model.py), or None."""
        if self.mesh is None:
            return None
        from vpt_tpu_torch.parallel.model import ParallelModel

        return ParallelModel(policy, self.mesh, unused=unused)

    def _forward(self, frames, firsts, state):
        """(heads' outputs, state_out) and the time slice they cover."""
        if self.model is None:
            out, state_out = self.policy(frames, firsts, state)
            return out, state_out, slice(None)
        out, state_out = self.model(frames, firsts, state)
        return out, state_out, self.model.time_slice(frames.shape[1])

    def _writer(self) -> bool:
        """Whether this process writes the weights and checkpoints: rank 0 of a mesh."""
        return self.mesh is None or pmesh.rank() == 0

    def _shard_writer(self) -> bool:
        """Whether this process keeps its own cursor under ``shard<rank>``."""
        return self.mesh is not None and pmesh.rank() > 0

    def _any_rank(self, flag: bool) -> bool:
        return flag if self.mesh is None else pmesh.any_rank([flag], self.device)[0]

    def _time_slice(self, steps: int) -> slice:
        return slice(None) if self.model is None else self.model.time_slice(steps)

    def _data_group(self):
        return pmesh.group(self.mesh, ("dp", "fsdp", "sp"))

    def _local_batch_size(self, batch_size: int) -> int:
        """This rank's streams of a global ``batch_size``."""
        rows = pmesh.local_rows(self.mesh, batch_size)
        return rows.stop - rows.start

    def _local_state(self, state):
        """A whole-width initial state → the rank's heads of it under tp."""
        from vpt_tpu_torch.parallel.tp import local_state

        return local_state(state, self.mesh, self.cfg.attention_heads)

    def _loader_shard(self, batch_size: int) -> Dict[str, int]:
        """The loader arguments of this rank's streams of a global batch."""
        index, count = pmesh.data_shard(self.mesh)
        return {"batch_size": self._local_batch_size(batch_size), "shard_id": index, "num_shards": count}

    def _sum_over_data(self, *values: float) -> List[float]:
        """Per-rank sums added over the data and sp axes (as they are on one device)."""
        if self.mesh is None:
            return list(values)
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        torch.distributed.all_reduce(t, group=self._data_group())
        return t.tolist()

    def _shard_dir(self, directory: str) -> str:
        """Where a rank other than 0 keeps its own cursor and state."""
        return os.path.join(directory, f"shard{pmesh.rank()}")

    def _global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean of the ranks' losses over the data and sp axes: the
        loss of the global batch (each rank's a mean over equal parts)."""
        return loss.detach() if self.mesh is None else pmesh.all_mean(loss, self._data_group())


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
    """Sequence-chunked BC fine-tuning on one device, or on a mesh.

    :param mesh: a ``DeviceMesh`` of parallel/mesh.py ``make_mesh`` (the
        process group started first); None trains on one device
    :param device: torch device; None means CUDA (the rank's own card under
        a process group), which must then exist
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
        mesh=None,
    ):
        self.hp = hp or BCHyperparams()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = None
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
        self.model = self._wrap(self.policy, unused=("value_head.",))
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
        return self.load_weights_report(load_weights(path))

    @classmethod
    def from_files(cls, in_model: str, in_weights: Optional[str] = None, **kw) -> "BCTrainer":
        policy_kwargs, pi_head_kwargs = load_model_parameters(in_model)
        trainer = cls(policy_kwargs, pi_head_kwargs, **kw)
        trainer.init()
        if in_weights:
            trainer.load_weights(in_weights)
        return trainer

    def initial_state(self, batch_size: int):
        """The zero state of this rank's streams of a global ``batch_size``
        (all of them on one device; the rank's heads of them under tp)."""
        return self._local_state(policy_initial_state(self.cfg, self._local_batch_size(batch_size), ring=False,
                                                      device=self.device))

    # ------------------------------------------------------------------- step

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        with span("vpt_torch.bc.to_device"):
            if not isinstance(batch["frames"], torch.Tensor):
                batch = batch_to_tensors(batch)
            count_h2d(*(batch[k] for k in TRAIN_KEYS))
            return {k: batch[k].to(self.device, dtype) for k, dtype in TRAIN_KEYS.items()}

    def masked_nll(self, batch: Dict[str, torch.Tensor], state):
        """(Σ −logp·mask, state_out) of one chunk (on a mesh under sp, of
        this rank's time slice)."""
        nll, state_out, _ = self._scored_nll(batch, state)
        return nll, state_out

    def _scored_nll(self, batch: Dict[str, torch.Tensor], state):
        """:meth:`masked_nll` and the number of (row, step) pairs it scored."""
        out, state_out, sl = self._forward(batch["frames"], batch["firsts"], state)
        actions = {"buttons": batch["buttons"][:, sl, None], "camera": batch["camera"][:, sl, None]}
        logp = dict_logprob(out["pi_logits"], actions, self.head_specs)  # (B, t)
        return -(logp * batch["mask"][:, sl].float()).sum(), state_out, logp.numel()

    def train_step(self, batch, state):
        """One optimizer step on a (B, T) batch (host numpy, or tensors from
        :class:`DevicePrefetcher`; on a mesh, this rank's rows); returns
        (state, loss, grad_norm), the state detached, the loss and the norm
        those of the global batch."""
        self.init()
        batch = self.to_device(batch)
        self.optimizer.zero_grad()
        with span("vpt_torch.bc.forward"):
            nll, state_out, n = self._scored_nll(batch, state)
            # normalised by B·T: at T=1 this is the reference's sum(-logprob)/BATCH_SIZE
            loss = nll / n
        with span("vpt_torch.bc.backward"):
            loss.backward()
            if self.model is not None:
                self.model.sync_grads()
        grad_norm = self.optimizer.step()
        self.step_count += 1
        return map_state(torch.Tensor.detach, state_out), self._global_loss(loss), grad_norm

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
        shard = self._loader_shard(hp.batch_size)
        loader = SequenceDataLoader(data_dir, chunk_len=hp.chunk_len, n_epochs=1, seed=self._seed,
                                    resolution=(self.cfg.img_shape[1], self.cfg.img_shape[0]),
                                    labels_dir=labels_dir, **shard)
        state = self.initial_state(hp.batch_size)
        last_episode = np.full(shard["batch_size"], -1, np.int64)
        nll_sum, frames, n_batches = 0.0, 0.0, 0
        try:
            for batch in _in_step(loader, self.device, self.mesh):
                last_episode = inject_episode_firsts(batch, last_episode, hp.chunk_len)
                placed = self.to_device(batch)
                nll, state, _ = self._scored_nll(placed, state)
                nll_sum += float(nll)
                frames += float(placed["mask"][:, self._time_slice(hp.chunk_len)].sum())
                n_batches += 1
                if max_batches and n_batches >= max_batches:
                    break
        finally:
            loader.close()
        nll_sum, frames = self._sum_over_data(nll_sum, frames)
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
        shard = self._loader_shard(hp.batch_size)
        state = self.initial_state(hp.batch_size)
        last_episode = np.full(shard["batch_size"], -1, np.int64)
        resume_state, start_trajectory = None, 0
        restored = self.restore_checkpoint(resume_dir) if resume_dir else None
        if restored is not None:
            resume_state, extra = restored
            if self._shard_writer():  # this rank's own cursor and streams, of the step rank 0 restored
                resume_state, extra = _shard_resume(self._shard_dir(resume_dir), resume_state)
            start_trajectory = int(resume_state.get("n_trajectories_dispatched", 0))
            saved = extra["recurrent_state"] if extra is not None else None
            if _same_streams(resume_state, shard) and _same_shapes(saved, state):
                last_episode = np.asarray(resume_state["last_episode"], np.int64)
                state = map_state(lambda v: v.to(self.device), saved)
            # else the streams were another run's (another batch size or world size): they start
            # afresh, and the loader from the coarse trajectory cursor
        loader = SequenceDataLoader(data_dir, chunk_len=hp.chunk_len, n_epochs=hp.epochs, seed=self._seed,
                                    resolution=(self.cfg.img_shape[1], self.cfg.img_shape[0]), labels_dir=labels_dir,
                                    start_trajectory=start_trajectory, resume_state=resume_state, **shard)

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
        if self.mesh is not None:  # loader start-up skew ends here, not in the first step's collective
            pmesh.barrier()
        try:
            with stop_on_signals() as stop:
                for batch in _in_step(prefetcher, self.device, self.mesh):
                    state, loss, grad_norm = self.train_step(batch, state)
                    loss_sum += float(loss)
                    frames_seen += batch["n_valid"]
                    if self.step_count % hp.loss_report_rate == 0:
                        dt = time.time() - start
                        metrics.log(step=self.step_count, loss=loss_sum / hp.loss_report_rate,
                                    grad_norm=float(grad_norm), frames_per_sec=frames_seen / max(dt, 1e-9),
                                    wall_time=dt)
                        loss_sum = 0.0
                    stop.requested = self._any_rank(stop.requested)  # a common snapshot
                    due = hp.checkpoint_every and self.step_count % hp.checkpoint_every == 0
                    if hp.checkpoint_dir and (due or stop.requested):
                        extra = {"recurrent_state": state}
                        self.save_checkpoint(hp.checkpoint_dir, batch["cursor"], extra=extra)
                        if self._shard_writer():
                            native_ckpt.save_checkpoint(self._shard_dir(hp.checkpoint_dir), self.step_count, {},
                                                        data_state=batch["cursor"], extra=extra)
                    if stop.requested:
                        metrics.log(event="preempted", step=self.step_count)
                        break
        finally:
            prefetcher.close()
            loader.close()
        self.save_weights(out_weights)
        return self.step_count


def _shard_resume(shard_dir: str, data_state: Dict) -> Tuple[Dict, Optional[Dict]]:
    """A rank's (data_state, extra) of the step rank 0 restored, from its
    own ``shard<rank>`` directory; where a run at another world size wrote
    none there, rank 0's trajectory and step counts and no extra (as
    vpt_tpu's trainers fall back)."""
    step = data_state["step_count"]
    if native_ckpt.restore_data_state(shard_dir, step) is None:
        return {k: data_state[k] for k in ("n_trajectories_dispatched", "step_count") if k in data_state}, None
    payload, own = native_ckpt.restore_checkpoint(shard_dir, step)
    return own, payload.get("extra")


def _same_streams(data_state: Dict, shard: Dict[str, int]) -> bool:
    """Whether a saved loader cursor is of this run's streams: as many, of
    the same shard."""
    return (len(data_state.get("streams") or []) == shard["batch_size"]
            and list(data_state.get("shard", [0, 1])) == [shard["shard_id"], shard["num_shards"]])


def _same_shapes(saved, fresh) -> bool:
    """Whether a saved recurrent state has the structure and shapes of this
    run's fresh one (tp keeps a rank's heads of it)."""
    if saved is None:
        return fresh is None
    (a, sa), (b, sb) = tree_flatten(saved), tree_flatten(fresh)
    shape = lambda x: tuple(x.shape) if isinstance(x, torch.Tensor) else type(x)  # noqa: E731
    return sa == sb and [shape(x) for x in a] == [shape(y) for y in b]


def _in_step(batches, device, mesh):
    """The batches of a loop every rank of the mesh runs in step: it ends
    for all where any rank's data ends (each rank's shard may end at another
    step).  Without a mesh, the batches as they are."""
    if mesh is None:
        yield from batches
        return
    it = iter(batches)
    while True:
        batch = next(it, None)
        if pmesh.any_rank([batch is None], device)[0]:
            return
        yield batch
