"""Plain reference of a behavioural-cloning step (openai/Video-Pre-Training
behavioural_cloning.py, at a chunk of T steps): the masked negative
log-likelihood of the demonstrated actions over B·T, the gradient's global
norm clipped, L2 weight decay added to the gradient, then Adam.  The value
head is outside the optimizer: the loss never reaches it.

Adam is written out (m, v, bias corrections), as the published optimizer
computes it.  Rows of a batch may be run in blocks of rows to bound memory:
the loss is a sum over rows, so the blocks' gradients add up to the whole
batch's.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import model


def trainable(params: Dict[str, torch.Tensor]) -> List[str]:
    """The names the optimizer updates: every parameter but the value head's
    (the normaliser's buffers are the value head's too)."""
    return [n for n in params if not n.startswith("value_head.")]


def loss_and_grads(params, arch, batch: Dict[str, torch.Tensor], state, row_block: int):
    """(loss, {name: gradient}, state after) of one chunk, rows in blocks of
    ``row_block``; the state is detached."""
    names = trainable(params)
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    p = dict(params, **leaves)
    b, t = batch["buttons"].shape
    grads = {n: torch.zeros_like(params[n]) for n in names}
    total = 0.0
    state_out = [{k: [] for k in s} for s in state]
    for lo in range(0, b, row_block):
        rows = slice(lo, min(b, lo + row_block))
        sub = [{k: v[rows] for k, v in s.items()} for s in state]
        out, after = model.forward(p, arch, batch["frames"][rows], batch["firsts"][rows], sub)
        logp = model.action_logprob(out, batch["buttons"][rows], batch["camera"][rows])
        loss = -(logp * batch["mask"][rows].float()).sum() / (b * t)
        got = torch.autograd.grad(loss, [leaves[n] for n in names])
        for n, g in zip(names, got):
            grads[n] += g
        total += float(loss.detach())
        for s, a in zip(state_out, after):
            for k, v in a.items():
                s[k].append(v.detach())
        del out, logp, loss, got, after
    state_out = [{k: torch.cat(v) for k, v in s.items()} for s in state_out]
    return total, grads, state_out


class Adam:
    """clip the global norm → + weight_decay·θ → Adam(β1, β2, ε) → θ −= lr·update."""

    def __init__(self, hp: Dict[str, float]):
        self.lr = hp["learning_rate"]
        self.wd = hp["weight_decay"]
        self.max_norm = hp["max_grad_norm"]
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def clipped(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = min(1.0, self.max_norm / (float(norm) + 1e-6))
        return {n: g * scale for n, g in grads.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the clipped gradients (before
        the weight decay is added to them)."""
        self.t += 1
        taken = self.clipped(grads)
        for n, g in taken.items():
            theta = params[n]
            g = g + self.wd * theta
            m = self.m.get(n, torch.zeros_like(g)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(n, torch.zeros_like(g)) * self.b2 + (1 - self.b2) * g * g
            self.m[n], self.v[n] = m, v
            mhat = m / (1 - self.b1 ** self.t)
            vhat = v / (1 - self.b2 ** self.t)
            theta.sub_(self.lr * mhat / (torch.sqrt(vhat) + self.eps))
        return taken
