"""Inverse-dynamics-model training (counterpart of vpt_tpu/training/idm.py).

The reference ships a pre-trained IDM and no code that trains one; the JAX
package trains it, and so does this port:

    contractor mp4+jsonl ──IDMTrainer──▶ idm.weights
    unlabeled video ──StreamingIDMLabeler (that IDM)──▶ action jsonl
    video + pseudo-labels ──BCTrainer(labels_dir=...)──▶ policy.weights

How it differs from BC training (training/bc.py), all forced by the model:

  * the IDM attends in both directions inside its window (mask style
    "none"), so windows are independent examples: each starts from a fresh
    zero state, with ``firsts`` all False, exactly as the labeling forward;
  * the targets are the factored action space the IDM predicts (20 binary
    buttons and 2 camera bins of 11), converted from the loader's joint
    indices by ``CameraHierarchicalMapping.to_factored``'s tables, so they
    are exactly the labels BC trains on;
  * there is no value head.

The optimizer is BC's chain (clip → L2 → Adam, ``training.bc.ClippedAdam``)
at BC's fine-tuning values: the VPT paper publishes no IDM schedule.  On
CUDA the attention of every block runs kernel B1 forward and kernel B2
backward.  ``remat`` and ``cnn_scan_chunks`` (config.py) trade recompute
for memory; ``qat_dense`` trains against the int8-rounded dense weights of
the ``quantize_dense`` labeling graph, as BC's does.  Checkpoints and
resume are BC's (``hp.checkpoint_every``, ``hp.checkpoint_dir``,
``train(resume_dir=...)``, a snapshot on SIGTERM or SIGINT); windows start
from a fresh state, so the loader's cursor is all of the data state.

On a mesh (``mesh=``) the step equals the single-device step on the same
global batch, as BC's does (training/bc.py): ``hp.batch_size`` windows in
all, each rank loading and stepping its own, the model wrapped by
parallel/model.py (DDP, FSDP2, tensor parallelism, and sequence parallelism,
where each rank embeds its slice of the window, the conv3d reaching across
the slice's edges), rank 0 writing the weights and checkpoints and every
other rank its loader cursor under ``<checkpoint_dir>/shard<p>``.  DDP
leaves out ``lastlayer``, whose output the IDM discards.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping, IDMActionMapping
from vpt_tpu_torch.checkpoint import load_model_parameters, load_weights
from vpt_tpu_torch.checkpoint import native as native_ckpt
from vpt_tpu_torch.config import PolicyConfig
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.models.heads import dict_logprob, head_specs_from_space
from vpt_tpu_torch.models.layers import init_parameters, set_fake_quant
from vpt_tpu_torch.models.policy import InverseActionPolicy, policy_initial_state
from vpt_tpu_torch.ops.int8 import qat_mask
from vpt_tpu_torch.parallel import mesh as pmesh
from vpt_tpu_torch.spaces import DictType
from vpt_tpu_torch.training.bc import (
    TRAIN_KEYS,
    CheckpointMixin,
    DevicePrefetcher,
    _in_step,
    batch_to_tensors,
    make_optimizer,
    step_flops,
    stop_on_signals,
)
from vpt_tpu_torch.utils.metrics import MetricsLogger


@dataclasses.dataclass
class IDMHyperparams:
    # BC fine-tuning's optimizer values (training/bc.py): not a reference constant
    learning_rate: float = 0.000181
    weight_decay: float = 0.039428
    max_grad_norm: float = 5.0
    epochs: int = 2
    batch_size: int = 8
    window: int = 128  # frames per training example, at most the config's timesteps
    loss_report_rate: int = 100
    checkpoint_every: int = 0  # steps between mid-run checkpoints (0 = off)
    checkpoint_dir: Optional[str] = None


def factored_targets(buttons_joint: np.ndarray, camera_joint: np.ndarray,
                     mapper: CameraHierarchicalMapping) -> Dict[str, np.ndarray]:
    """Joint (...,) indices → the IDM's factored targets, through the joint
    mapping's own ``to_factored`` (so sub-threshold camera motion is nulled
    where the camera meta-button is off, as in the labels BC consumes)."""
    fac = mapper.to_factored({"buttons": np.asarray(buttons_joint)[..., None],
                              "camera": np.asarray(camera_joint)[..., None]})
    return {"buttons": fac["buttons"].astype(np.int32),   # (..., 20) in {0, 1}
            "camera": fac["camera"].astype(np.int32)}     # (..., 2) bins in [0, 11)


class IDMTrainer(CheckpointMixin):
    """Window-batched IDM training on one device, or on a mesh.

    :param mesh: a ``DeviceMesh`` of parallel/mesh.py; None trains on one device
    :param device: torch device; None means CUDA (the rank's own card under
        a process group), which must then exist
    :param seed: seeds the initial weights (drawn on the CPU, so every
        device starts from the same weights) and the loader's shuffle
    :param remat, cnn_scan_chunks: the config's memory options (config.py)
    :param qat_dense: quantization-aware training for int8 labeling
    """

    def __init__(self, idm_net_kwargs: Dict[str, Any], pi_head_kwargs: Dict[str, Any],
                 hp: Optional[IDMHyperparams] = None, compute_dtype: str = "float32", remat: bool = False,
                 cnn_scan_chunks: int = 0, qat_dense: bool = False, seed: int = 0, device=None, mesh=None):
        self.hp = hp or IDMHyperparams()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = None
        self.cfg = PolicyConfig.from_kwargs(dict(idm_net_kwargs)).replace(
            compute_dtype=compute_dtype, remat=remat, cnn_scan_chunks=cnn_scan_chunks)
        assert self.hp.window <= self.cfg.timesteps, (
            f"window {self.hp.window} exceeds the model geometry timesteps={self.cfg.timesteps}"
        )
        self.temperature = float(pi_head_kwargs.get("temperature", 1.0))
        # the factored space the IDM predicts, and the joint mapping whose
        # tables turn the loader's indices into it
        self.action_mapper = IDMActionMapping(n_camera_bins=11)
        self.joint_mapper = CameraHierarchicalMapping(n_camera_bins=11)
        self.head_specs = head_specs_from_space(DictType(**self.action_mapper.get_action_space_update()))
        self.qat_dense = qat_dense
        self._seed = seed
        self.policy: Optional[InverseActionPolicy] = None
        self.optimizer = None
        self.step_count = 0

    # ------------------------------------------------------------------ setup

    def init(self) -> None:
        if self.policy is not None:
            return
        policy = InverseActionPolicy(self.cfg, self.head_specs, self.temperature)
        init_parameters(policy, torch.Generator().manual_seed(self._seed))
        if self.qat_dense:
            set_fake_quant(policy, self.qat_mask(policy))
        self.policy = policy.to(self.device)
        self.model = self._wrap(self.policy, unused=("net.lastlayer.",))
        self.optimizer = make_optimizer(self.policy.parameters(), self.hp)

    def qat_mask(self, policy: Optional[InverseActionPolicy] = None) -> Dict[str, bool]:
        """{parameter name: True where int8 labeling quantizes it}, from the
        ``quantize_dense`` IDM's own layers (ops.int8.qat_mask)."""
        cfg = self.cfg.replace(quantize_dense=True)
        names = [n for n, _ in (policy or self.policy).named_parameters()]
        return qat_mask(lambda: InverseActionPolicy(cfg, self.head_specs, self.temperature), names)

    def load_weights(self, path: str) -> Dict[str, list]:
        """Warm-start from a ``.weights`` file (the published 4x IDM, or an
        earlier run's output)."""
        self.init()
        return self.load_weights_report(load_weights(path))

    @classmethod
    def from_files(cls, in_model: str, in_weights: Optional[str] = None, **kw) -> "IDMTrainer":
        net_kwargs, pi_head_kwargs = load_model_parameters(in_model)
        trainer = cls(net_kwargs, pi_head_kwargs, **kw)
        trainer.init()
        if in_weights:
            trainer.load_weights(in_weights)
        return trainer

    def initial_state(self, batch_size: int):
        """The zero state of this rank's windows of a global ``batch_size``."""
        return self._zero_state(self._local_batch_size(batch_size))

    def _zero_state(self, rows: int):
        return self._local_state(policy_initial_state(self.cfg, rows, device=self.device))

    # ------------------------------------------------------------------- step

    def prepare_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A loader batch (joint action indices) → the step's entries: frames,
        factored targets, all-False firsts and the mask."""
        targets = factored_targets(batch["buttons"], batch["camera"], self.joint_mapper)
        mask = np.asarray(batch["mask"]).astype(bool)
        return {"frames": batch["frames"], "buttons": targets["buttons"], "camera": targets["camera"],
                "firsts": np.zeros(mask.shape, bool), "mask": mask}

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """Host batches in either action format, or tensors already factored
        (from :class:`DevicePrefetcher`), on the trainer's device."""
        if np.ndim(batch["buttons"]) == 2:  # joint indices, as the loader yields them
            batch = self.prepare_batch(batch)
        if not isinstance(batch["frames"], torch.Tensor):
            batch = batch_to_tensors(batch)
        return {k: batch[k].to(self.device, dtype) for k, dtype in TRAIN_KEYS.items()}

    def logits(self, frames: torch.Tensor, state=None) -> Dict[str, torch.Tensor]:
        """The IDM's logits of a (B, T) window batch, each window from a
        fresh zero state (``state`` if given) with no episode starts."""
        return self._logits(frames, state)[0]

    def _logits(self, frames: torch.Tensor, state=None):
        """(logits, the time slice they cover): on a mesh under sp, this
        rank's slice of the window."""
        state = self._zero_state(frames.shape[0]) if state is None else state
        first = torch.zeros(frames.shape[:2], dtype=torch.bool, device=frames.device)
        out, _, sl = self._forward(frames, first, state)
        return out["pi_logits"], sl

    def masked_nll(self, batch: Dict[str, torch.Tensor], state=None):
        """(Σ −logp·mask, logits) of a window batch (on a mesh under sp, of
        this rank's time slice)."""
        nll, logits, _ = self._scored_nll(batch, state)
        return nll, logits

    def _scored_nll(self, batch: Dict[str, torch.Tensor], state=None):
        """:meth:`masked_nll` and the time slice it scored."""
        logits, sl = self._logits(batch["frames"], state)
        logp = dict_logprob(logits, {"buttons": batch["buttons"][:, sl], "camera": batch["camera"][:, sl]},
                            self.head_specs)
        return -(logp * batch["mask"][:, sl].float()).sum(), logits, sl

    def train_step(self, batch, state=None):
        """One optimizer step on a (B, T) window batch (host numpy with joint
        indices as the loader yields them, or factored tensors); returns
        (loss, grad_norm)."""
        self.init()
        batch = self.to_device(batch)
        self.optimizer.zero_grad()
        nll, logits, _ = self._scored_nll(batch, state)
        loss = nll / logits["camera"].shape[:2].numel()  # reference normalisation: B·T
        loss.backward()
        if self.model is not None:
            self.model.sync_grads()
        grad_norm = self.optimizer.step()
        self.step_count += 1
        return self._global_loss(loss), grad_norm

    def train_step_flops(self, batch, state=None) -> Optional[float]:
        """FLOPs of one :meth:`train_step`, which leaves the trainer as it
        was (None where nothing is counted)."""
        return step_flops(self, batch, state)

    # ------------------------------------------------------------- evaluation

    @torch.no_grad()
    def evaluate(self, data_dir: str, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Held-out NLL per frame and the exact-match rates of the argmax
        decode (all 20 buttons right; both camera bins right)."""
        from vpt_tpu_torch.data.loader import SequenceDataLoader

        self.init()
        loader = SequenceDataLoader(data_dir, chunk_len=self.hp.window, n_epochs=1, seed=self._seed,
                                    resolution=(self.cfg.img_shape[1], self.cfg.img_shape[0]),
                                    **self._loader_shard(self.hp.batch_size))
        nll, btn, cam, frames, n_batches = 0.0, 0.0, 0.0, 0.0, 0
        try:
            for batch in _in_step(loader, self.device, self.mesh):
                placed = self.to_device(batch)
                a, logits, sl = self._scored_nll(placed)
                mask = placed["mask"][:, sl].float()
                nll += float(a)
                btn += float(((logits["buttons"].argmax(-1) == placed["buttons"][:, sl]).all(-1) * mask).sum())
                cam += float(((logits["camera"].argmax(-1) == placed["camera"][:, sl]).all(-1) * mask).sum())
                frames += float(mask.sum())
                n_batches += 1
                if max_batches and n_batches >= max_batches:
                    break
        finally:
            loader.close()
        nll, btn, cam, frames = self._sum_over_data(nll, btn, cam, frames)
        frames = max(frames, 1.0)
        return {"nll_per_frame": nll / frames, "button_exact_match": btn / frames,
                "camera_exact_match": cam / frames, "frames": int(frames), "batches": n_batches}

    # -------------------------------------------------------------------- run

    def train(self, data_dir: str, out_weights: str, metrics: Optional[MetricsLogger] = None,
              resume_dir: Optional[str] = None) -> int:
        """Train over a contractor-labeled dataset directory (mp4 + jsonl
        pairs, BC's layout) for ``hp.epochs``, logging every
        ``hp.loss_report_rate`` steps, then write the weights to
        ``out_weights``.  With ``resume_dir``, go on from its newest
        checkpoint.  Returns the number of optimizer steps taken in all."""
        from vpt_tpu_torch.data.loader import SequenceDataLoader

        hp = self.hp
        self.init()
        metrics = metrics or MetricsLogger()
        restored = self.restore_checkpoint(resume_dir) if resume_dir else None
        resume_state = None if restored is None else restored[0]
        if restored is not None and self._shard_writer():  # this rank's own cursor, of the step rank 0 restored
            # where a run at another world size wrote none: rank 0's trajectory and step counts
            resume_state = (native_ckpt.restore_data_state(self._shard_dir(resume_dir), self.step_count)
                            or {k: resume_state[k] for k in ("n_trajectories_dispatched", "step_count")
                                if k in resume_state})
        loader = SequenceDataLoader(data_dir, chunk_len=hp.window, n_epochs=hp.epochs, seed=self._seed,
                                    resolution=(self.cfg.img_shape[1], self.cfg.img_shape[0]),
                                    start_trajectory=int((resume_state or {}).get("n_trajectories_dispatched", 0)),
                                    resume_state=resume_state, **self._loader_shard(hp.batch_size))

        def with_targets(batches):  # in the prefetch thread: the conversion overlaps the step
            for batch in batches:
                prepared = self.prepare_batch(batch)
                prepared["n_valid"] = int(prepared["mask"].sum())
                prepared["cursor"] = loader.state()
                yield prepared

        start = time.time()
        loss_sum, frames_seen = 0.0, 0
        prefetcher = DevicePrefetcher(with_targets(loader), self.device)
        if self.mesh is not None:
            pmesh.barrier()
        try:
            with stop_on_signals() as stop:
                for batch in _in_step(prefetcher, self.device, self.mesh):
                    loss, grad_norm = self.train_step(batch)
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
                        self.save_checkpoint(hp.checkpoint_dir, batch["cursor"])
                        if self._shard_writer():
                            native_ckpt.save_data_state(self._shard_dir(hp.checkpoint_dir), self.step_count,
                                                        {**batch["cursor"], "step_count": self.step_count})
                    if stop.requested:
                        metrics.log(event="preempted", step=self.step_count)
                        break
        finally:
            prefetcher.close()
            loader.close()
        self.save_weights(out_weights)
        return self.step_count
