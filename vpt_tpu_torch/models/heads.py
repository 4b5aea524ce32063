"""Action heads and value head (counterpart of vpt_tpu/models/heads.py;
reference lib/action_head.py:136-260, lib/scaled_mse_head.py,
lib/normalize_ewma.py).

Weight-owning modules produce log-probability parameters; the distribution
math over them is plain functions driven by static ``HeadSpec`` metadata.
Numerics: temperature divides the raw logits, then a float32 log-softmax;
masked logits are LOG0 = -100; sampling is Gumbel-argmax.  Torch and JAX
random streams differ, so ``dict_sample`` takes an explicit
``torch.Generator`` and, for tests, injected uniform noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vpt_tpu_torch.spaces import Discrete, TensorType

LOG0 = -100.0


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """Shape metadata of one categorical sub-head: ``value_shape`` of one
    action value and its cardinality ``num_actions``."""

    key: str
    value_shape: Tuple[int, ...]
    num_actions: int = 0


def head_specs_from_space(ac_space) -> Tuple[HeadSpec, ...]:
    """DictType action space → ordered HeadSpecs (reference: make_action_head,
    lib/action_head.py:263-275).  Only Discrete eltypes are ported; the
    diagonal-gaussian head serves no published policy."""
    specs = []
    for key, ttype in ac_space.items():
        assert isinstance(ttype, TensorType), f"unsupported space for {key}: {ttype}"
        if not isinstance(ttype.eltype, Discrete):
            raise NotImplementedError(f"unsupported eltype for {key}: {ttype.eltype}")
        specs.append(HeadSpec(key=key, value_shape=tuple(ttype.shape), num_actions=ttype.eltype.n))
    return tuple(specs)


class CategoricalActionHead(nn.Module):
    """Linear → reshape → /temperature → (mask) → float32 log-softmax
    (reference: lib/action_head.py:136-174)."""

    def __init__(self, insize: int, spec: HeadSpec, temperature: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.spec = spec
        self.temperature = temperature
        self.dtype = dtype
        self.out_shape = tuple(spec.value_shape) + (spec.num_actions,)
        flat = 1
        for s in self.out_shape:
            flat *= s
        self.linear_layer = nn.Module()
        self.linear_layer.weight = nn.Parameter(torch.empty(flat, insize, device=device))
        self.linear_layer.bias = nn.Parameter(torch.empty(flat, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.orthogonal_(self.linear_layer.weight, gain=0.01, generator=generator)
        self.linear_layer.bias.zero_()

    def forward(self, x, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        x = F.linear(x.to(dt), self.linear_layer.weight.to(dt), self.linear_layer.bias.to(dt))
        x = x.reshape(x.shape[:-1] + self.out_shape) / self.temperature
        if mask is not None:
            x = torch.where(mask, x, torch.full((), LOG0, dtype=x.dtype, device=x.device))
        return F.log_softmax(x.float(), dim=-1)


class DictActionHead(nn.Module):
    """One sub-head per action-space key (reference: lib/action_head.py:223-260)."""

    def __init__(self, insize: int, specs: Tuple[HeadSpec, ...], temperature: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.specs = specs
        # sub-heads sit directly under the head, as the reference names them:
        # ``pi_head.buttons.linear_layer.weight``
        for s in specs:
            self.add_module(s.key, CategoricalActionHead(insize, s, temperature, dtype, device))

    def forward(self, x, mask: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        return {
            s.key: getattr(self, s.key)(x, mask=None if mask is None else mask.get(s.key))
            for s in self.specs
        }


def categorical_logprob(logits: torch.Tensor, actions: torch.Tensor, spec: HeadSpec) -> torch.Tensor:
    """Σ over value_shape of log p(action); actions (..., *value_shape) int."""
    picked = torch.gather(logits, -1, actions.long()[..., None])[..., 0]
    for _ in spec.value_shape:
        picked = picked.sum(dim=-1)
    return picked


def categorical_sample(logits: torch.Tensor, deterministic: bool = False,
                       generator: Optional[torch.Generator] = None,
                       uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-argmax (reference: lib/action_head.py:195-207).  ``uniform``
    (same shape as logits, in (0, 1)) replaces the generator's draw."""
    if deterministic:
        return torch.argmax(logits, dim=-1)
    if uniform is None:
        uniform = torch.rand(logits.shape, generator=generator, device=logits.device,
                             dtype=torch.float32)
    u = uniform.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def dict_logprob(logits: Dict[str, torch.Tensor], actions: Dict[str, torch.Tensor],
                 specs: Tuple[HeadSpec, ...]) -> torch.Tensor:
    return sum(categorical_logprob(logits[s.key], actions[s.key], s) for s in specs)


def dict_sample(logits: Dict[str, torch.Tensor], specs: Tuple[HeadSpec, ...],
                deterministic: bool = False, generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Sample every sub-head; ``noise`` maps a head key to injected uniforms."""
    return {
        s.key: categorical_sample(logits[s.key], deterministic, generator,
                                  None if noise is None else noise.get(s.key))
        for s in specs
    }


def ewma_mean_var(stats: Dict[str, torch.Tensor], epsilon: float = 1e-5):
    """Debiased (mean, var) from raw EWMA accumulators
    (reference: normalize_ewma.py:25-31, 57-60)."""
    debias = stats["debiasing_term"].clamp_min(epsilon)
    mean = stats["running_mean"] / debias
    mean_sq = stats["running_mean_sq"] / debias
    var = (mean_sq - mean ** 2).clamp_min(1e-2)
    return mean, var


class EwmaNormalizer(nn.Module):
    """The EWMA statistics the checkpoint stores as
    ``value_head.normalizer.{running_mean, running_mean_sq, debiasing_term}``."""

    def __init__(self, size: int, device=None):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(size, device=device))
        self.register_buffer("running_mean_sq", torch.zeros(size, device=device))
        self.register_buffer("debiasing_term", torch.zeros((), device=device))

    def stats(self) -> Dict[str, torch.Tensor]:
        return {
            "running_mean": self.running_mean,
            "running_mean_sq": self.running_mean_sq,
            "debiasing_term": self.debiasing_term,
        }


class ScaledMSEHead(nn.Module):
    """Linear value head in EWMA-normalised target space (reference:
    lib/scaled_mse_head.py).  Serving reads ``denormalize``; the statistics
    are updated only by training, which is not in this package yet."""

    def __init__(self, insize: int, output_size: int = 1, norm_axes: int = 2,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm_axes = norm_axes
        self.epsilon = epsilon
        self.dtype = dtype
        self.linear = nn.Module()
        self.linear.weight = nn.Parameter(torch.empty(output_size, insize, device=device))
        self.linear.bias = nn.Parameter(torch.empty(output_size, device=device))
        self.normalizer = EwmaNormalizer(output_size, device=device)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.orthogonal_(self.linear.weight, generator=generator)
        self.linear.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.linear.weight.to(dt), self.linear.bias.to(dt))

    def denormalize(self, x):
        mean, var = ewma_mean_var(self.normalizer.stats(), self.epsilon)
        shape = (1,) * self.norm_axes + tuple(mean.shape)
        return x.float() * torch.sqrt(var.reshape(shape)) + mean.reshape(shape)
