"""Pipeline-parallel BC training of the full policy (counterpart of
vpt_tpu/training/pp_bc.py).

The policy's three split points (``embed`` → the recurrent blocks →
``heads_from_recurrent``) make one train step in which the block stack runs
as a GPipe pipeline over the mesh's pp ranks (parallel/pp.py): each rank
holds its stage's blocks only, stage 0 runs the CNN, every stage runs the
heads on the stack's output.  With dp > 1 beside pp (the JAX package's
``make_mesh(n_dp=..., n_pp=...)``) the rows split over dp: each of the dp
pipelines runs its share of the rows, and every gradient is averaged over
the stage's dp group before the clip and Adam, so the loss, the grad norm
and the step are the global batch's.  The published configs never need it (dp and
fsdp cover them); it is the geometry for much deeper stacks, and
``BCTrainer`` stays the default.

The step is ``BCTrainer``'s: the same loss, the same optimizer chain (the
clip's norm over every parameter of every stage), the value head outside
the optimizer.  Each stage backpropagates the loss divided by the stage
count, and the parameters every stage holds sum their gradients over the
stages; then every gradient is averaged over dp.  ``checkpoint_params`` gathers the standard state_dict (every
stage's blocks, ``merge_policy_params``), and ``load_weights`` takes one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
from vpt_tpu_torch.checkpoint import load_weights
from vpt_tpu_torch.config import PolicyConfig
from vpt_tpu_torch.device import resolve_device, torch_dtype
from vpt_tpu_torch.models.heads import dict_logprob, head_specs_from_space
from vpt_tpu_torch.models.layers import init_parameters
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
from vpt_tpu_torch.models.transformer import map_state
from vpt_tpu_torch.parallel import mesh as pmesh
from vpt_tpu_torch.parallel.pp import (
    PipelinedBlocks,
    merge_policy_params,
    split_policy_params,
    stage_blocks,
    sync_replicated_grads,
)
from vpt_tpu_torch.spaces import DictType
from vpt_tpu_torch.training.bc import BCHyperparams, ClippedAdam, TRAIN_KEYS, batch_to_tensors

BLOCKS = "net.recurrent_layer.blocks"


class PPBCTrainer:
    """Sequence-chunked BC with the transformer stack pipelined over ``pp``.

    :param mesh: a mesh of parallel/mesh.py over (pp, dp); fsdp, sp and tp
        must be 1
    :param n_micro: microbatches a step; must divide this rank's rows

    ``train_step`` takes this rank's rows (``parallel.mesh.local_batch``)
    and ``initial_state`` the global batch size, as ``BCTrainer``'s.
    """

    def __init__(self, policy_kwargs: Dict[str, Any], pi_head_kwargs: Dict[str, Any],
                 hp: Optional[BCHyperparams] = None, mesh=None, n_micro: int = 4, compute_dtype: str = "float32",
                 seed: int = 0, device=None):
        self.hp = hp or BCHyperparams()
        self.device = resolve_device(device)
        if mesh is None:
            raise ValueError("PPBCTrainer takes a mesh with a pp axis")
        for axis in ("fsdp", "sp", "tp"):
            if pmesh.axis_size(mesh, axis) > 1:
                raise ValueError(f"PPBCTrainer takes the pp and dp axes, not {axis}")
        self.mesh = mesh
        self.n_micro = n_micro
        self.cfg = PolicyConfig.from_kwargs(dict(policy_kwargs)).replace(compute_dtype=compute_dtype)
        if self.cfg.recurrence_type != "transformer":
            raise ValueError("the pipeline runs the transformer stack")
        self.n_block = self.cfg.n_recurrence_layers
        self.group = pmesh.group(mesh, ("pp",))
        self.dp_group = pmesh.group(mesh, ("dp",)) if pmesh.axis_size(mesh, "dp") > 1 else None
        self.stage, self.n_stages = dist.get_rank(self.group), dist.get_world_size(self.group)
        self.lo, self.hi = stage_blocks(self.n_block, self.stage, self.n_stages)
        self.temperature = float(pi_head_kwargs.get("temperature", 1.0))
        self.head_specs = head_specs_from_space(
            DictType(**CameraHierarchicalMapping(n_camera_bins=11).get_action_space_update()))
        self._seed = seed
        self.policy: Optional[MinecraftAgentPolicy] = None
        self.step_count = 0

    def init(self) -> None:
        if self.policy is not None:
            return
        policy = MinecraftAgentPolicy(self.cfg, self.head_specs, self.temperature)
        init_parameters(policy, torch.Generator().manual_seed(self._seed))
        layer = policy.net.recurrent_layer
        layer.blocks = torch.nn.ModuleList(list(layer.blocks)[self.lo:self.hi])  # this stage's blocks alone
        self.policy = policy.to(self.device)
        self.pipeline = PipelinedBlocks(self.policy.net.recurrent_layer.blocks, self.group, self.n_micro)
        self.replicated = [p for n, p in self.policy.named_parameters()
                           if not n.startswith(BLOCKS + ".") and not n.startswith("value_head.")]
        self.stage_params = list(self.policy.net.recurrent_layer.blocks.parameters())
        self.optimizer = ClippedAdam(self.replicated + self.stage_params, self.hp)

    def _global_name(self, name: str) -> str:
        """A local block parameter's name in the whole stack."""
        if not name.startswith(BLOCKS + "."):
            return name
        i, rest = name[len(BLOCKS) + 1:].split(".", 1)
        return f"{BLOCKS}.{self.lo + int(i)}.{rest}"

    def checkpoint_params(self) -> Dict[str, torch.Tensor]:
        """The standard state_dict (every stage's blocks; a collective over pp)."""
        self.init()
        local = {self._global_name(k): v.detach().cpu() for k, v in self.policy.state_dict().items()}
        parts: List[Dict] = [None] * self.n_stages
        dist.all_gather_object(parts, {k: v for k, v in local.items() if k.startswith(BLOCKS + ".")},
                               group=self.group)
        whole = {k: v for part in parts for k, v in part.items()}
        rest, stacked = split_policy_params({**local, **whole}, self.n_block)
        return merge_policy_params(rest, stacked, self.n_block, prefix=BLOCKS)

    def load_weights(self, path: str) -> None:
        """Load a standard ``.weights`` state_dict: the rest, and this stage's blocks."""
        self.init()
        rest, stacked = split_policy_params(load_weights(path), self.n_block)
        local = {f"{BLOCKS}.{i - self.lo}.{k}": v[i] for k, v in stacked.items() for i in range(self.lo, self.hi)}
        self.policy.load_state_dict({**rest, **local}, strict=True)

    def initial_state(self, batch_size: int):
        """This stage's blocks' zero state for this rank's rows of a global
        batch of ``batch_size``."""
        rows = pmesh.local_rows(self.mesh, batch_size)
        return policy_initial_state(self.cfg, rows.stop - rows.start, device=self.device)[self.lo:self.hi]

    def _clip_norm(self) -> torch.Tensor:
        """Clip every stage's gradients by the norm of all of them together."""
        stage_sq = _squared_norm(self.stage_params)
        dist.all_reduce(stage_sq, group=self.group)
        total = torch.sqrt(_squared_norm(self.replicated) + stage_sq)
        coef = torch.clamp(self.hp.max_grad_norm / (total + 1e-6), max=1.0)
        for p in self.optimizer.params:
            p.grad.mul_(coef)
        return total

    def _average_over_dp(self) -> None:
        """Average every gradient over the stage's dp group (a no-op at dp = 1)."""
        if self.dp_group is None:
            return
        n = dist.get_world_size(self.dp_group)
        for p in self.optimizer.params:
            dist.all_reduce(p.grad, group=self.dp_group)
            p.grad.div_(n)

    def train_step(self, batch, state):
        """One optimizer step on this rank's rows of a (B, T) batch from this
        stage's blocks' ``state``; returns (state, loss, grad_norm) as
        ``BCTrainer.train_step``, the loss and the norm the global batch's."""
        self.init()
        if not isinstance(batch["frames"], torch.Tensor):
            batch = batch_to_tensors(batch)
        batch = {k: batch[k].to(self.device, dtype) for k, dtype in TRAIN_KEYS.items()}
        b, t = batch["mask"].shape
        self.optimizer.zero_grad()
        if self.stage == 0:
            x = self.policy.embed(batch["frames"])
        else:  # only stage 0 reads the stack's input
            dtype = torch.float32 if self.cfg.use_pre_lstm_ln else torch_dtype(self.cfg.compute_dtype)
            x = torch.empty((b, t, self.cfg.hidsize), dtype=dtype, device=self.device)
        y, state_out = self.pipeline(x, batch["firsts"], state)
        out = self.policy.heads_from_recurrent(y)
        actions = {"buttons": batch["buttons"][..., None], "camera": batch["camera"][..., None]}
        logp = dict_logprob(out["pi_logits"], actions, self.head_specs)
        loss = -(logp * batch["mask"].float()).sum() / (b * t)
        (loss / self.n_stages).backward()
        sync_replicated_grads(self.replicated, self.group)
        for p in self.optimizer.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._average_over_dp()
        grad_norm = self._clip_norm()
        self.optimizer.adam.step()
        self.step_count += 1
        loss = loss.detach() if self.dp_group is None else pmesh.all_mean(loss, self.dp_group)
        return map_state(torch.Tensor.detach, state_out), loss, grad_norm


def _squared_norm(params) -> torch.Tensor:
    """The sum of the squared norms of the parameters' gradients."""
    return torch.stack([torch.linalg.vector_norm(p.grad) for p in params]).pow(2).sum()
