"""Pipeline parallelism for the residual recurrent block stack (counterpart of
vpt_tpu/parallel/pp.py).

GPipe fill–drain over the mesh's pp ranks: stage s holds blocks
[s·k, (s+1)·k) of the n_block = k·pp; the batch splits into ``n_micro``
microbatches of rows; stage s runs microbatch m once stage s−1 has sent it
(``dist.send``/``dist.recv``), so while it runs m, stage s−1 runs m+1.  Each
stage carries its own blocks' recurrent state, row by row, so episode resets
and truncated backpropagation are those of the sequential stack.  The last
stage's output goes to every stage with a differentiable all-reduce (the
others add zeros), so the heads and the loss run on every stage as the JAX
package's psum has them; the backward runs the same schedule in reverse:
the all-reduce first on every stage, then each stage receives its output's
gradient from the next stage and sends its input's to the one before.

The send and receive are autograd functions: ``_SendForward`` returns a
scalar that the all-reduce's input depends on (times zero), so that the
backward reaches every send, after the all-reduce, in reverse microbatch
order on every stage; ``_RecvForward`` hangs off a leaf scalar so that its
backward (the send of the input's gradient) runs.

The parameters outside the blocks (the CNN, the heads) are on every stage.
Each stage computes the whole loss and backpropagates it divided by the
stage count: the all-reduce's backward sums the stages' shares of the
output's gradient, and ``sync_replicated_grads`` sums the shares of those
parameters' gradients.

``split_policy_params``/``merge_policy_params`` turn a policy state_dict
into (the rest, the blocks' parameters stacked on a leading layer axis) and
back, the JAX package's checkpoint layout.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

BLOCK_KEY = re.compile(r"^(.*\.blocks)\.(\d+)\.(.+)$")


def split_policy_params(state_dict: Dict[str, torch.Tensor], n_block: int):
    """A policy state_dict → (every entry outside the blocks, {block-relative
    name: the n_block blocks' tensors stacked on a leading axis})."""
    rest, per_block = {}, {}
    for name, value in state_dict.items():
        m = BLOCK_KEY.match(name)
        if m is None or not m.group(1).endswith("recurrent_layer.blocks"):
            rest[name] = value
            continue
        per_block.setdefault(m.group(3), [None] * n_block)[int(m.group(2))] = value
    stacked = {k: torch.stack(v) for k, v in per_block.items()}
    return rest, stacked


def merge_policy_params(rest: Dict[str, torch.Tensor], stacked: Dict[str, torch.Tensor], n_block: int,
                        prefix: str = "net.recurrent_layer.blocks") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`split_policy_params`."""
    out = dict(rest)
    for k, v in stacked.items():
        for i in range(n_block):
            out[f"{prefix}.{i}.{k}"] = v[i]
    return out


class _SendForward(torch.autograd.Function):
    """Forward: send ``y`` to rank ``peer``; returns a zero scalar.  Backward:
    receive ``y``'s gradient from ``peer``."""

    @staticmethod
    def forward(ctx, y, peer, group):
        ctx.peer, ctx.group, ctx.shape, ctx.dtype = peer, group, y.shape, y.dtype
        dist.send(y.detach().contiguous(), dst=peer, group=group)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, grad):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=grad.device)
        dist.recv(g, src=ctx.peer, group=ctx.group)
        return g, None, None


class _RecvForward(torch.autograd.Function):
    """Forward: receive a tensor of ``shape`` from rank ``peer``.  Backward:
    send its gradient back.  ``anchor`` is a leaf scalar that makes autograd
    run the backward."""

    @staticmethod
    def forward(ctx, anchor, peer, group, shape, dtype):
        ctx.peer, ctx.group = peer, group
        x = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(x, src=peer, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), dst=ctx.peer, group=ctx.group)
        return torch.zeros((), dtype=grad.dtype, device=grad.device), None, None, None, None


class PipelinedBlocks:
    """This stage's blocks of a residual recurrent stack, run as a GPipe
    pipeline over ``group`` (the mesh's pp ranks, in stage order).

    :param blocks: the stage's consecutive blocks
    :param n_micro: microbatches a call; must divide the rows
    """

    def __init__(self, blocks: Sequence[nn.Module], group: dist.ProcessGroup, n_micro: int):
        self.blocks = list(blocks)
        self.group = group
        self.n_micro = n_micro
        self.stage = dist.get_rank(group)
        self.n_stages = dist.get_world_size(group)

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def __call__(self, x: torch.Tensor, first: torch.Tensor, state: Optional[List[Dict]]):
        """(B, T, E) stack input (used on stage 0), (B, T) episode starts and
        this stage's blocks' states → ((B, T, E) output of the whole stack on
        every stage, this stage's blocks' states after the chunk)."""
        b = x.shape[0]
        if b % self.n_micro:
            raise ValueError(f"{self.n_micro} microbatches do not divide {b} rows")
        mb = b // self.n_micro
        first_stage, last_stage = self.stage == 0, self.stage == self.n_stages - 1
        outs, sent, states = [], [], []
        for m in range(self.n_micro):
            rows = slice(m * mb, (m + 1) * mb)
            if first_stage:
                h = x[rows]
            else:
                anchor = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
                h = _RecvForward.apply(anchor, self._peer(self.stage - 1), self.group, (mb,) + tuple(x.shape[1:]),
                                       x.dtype)
            st = [{k: v[rows] if isinstance(v, torch.Tensor) else v for k, v in blk.items()} for blk in state]
            st_out = []
            for block, s in zip(self.blocks, st):
                h, s = block(h, first[rows], s)
                st_out.append(s)
            states.append(st_out)
            if last_stage:
                outs.append(h)
            else:
                sent.append(_SendForward.apply(h, self._peer(self.stage + 1), self.group))
        if last_stage:
            y = torch.cat(outs)
        else:  # zeros, tied to the sends so that the backward reaches them after the all-reduce
            y = torch.zeros((b,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            if sent and torch.is_grad_enabled():
                y = y + 0.0 * torch.stack(sent).sum()
        from torch.distributed.nn.functional import all_reduce

        y = all_reduce(y, group=self.group) if torch.is_grad_enabled() else _all_reduce(y, self.group)
        state_out = [{k: torch.cat([s[i][k] for s in states]) if isinstance(states[0][i][k], torch.Tensor)
                      else states[0][i][k] for k in states[0][i]} for i in range(len(self.blocks))]
        return y, state_out


def _all_reduce(y: torch.Tensor, group) -> torch.Tensor:
    y = y.clone()
    dist.all_reduce(y, group=group)
    return y


def stage_blocks(n_block: int, stage: int, n_stages: int) -> Tuple[int, int]:
    """[first, last) blocks of ``stage``."""
    if n_block % n_stages:
        raise ValueError(f"{n_block} blocks do not divide over {n_stages} pipeline stages")
    k = n_block // n_stages
    return stage * k, (stage + 1) * k


def sync_replicated_grads(params: Sequence[torch.nn.Parameter], group: dist.ProcessGroup) -> None:
    """Sum the gradients of the parameters every stage holds (the CNN, the
    heads) over the stages: each stage's loss is the whole loss, so each
    holds a share (the CNN's only on stage 0, the heads' on all)."""
    for p in params:
        if p.grad is None:  # the CNN's on every stage but the first
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad, group=group)
