"""Action heads and value head (counterpart of vpt_tpu/models/heads.py;
reference lib/action_head.py:136-260, lib/scaled_mse_head.py,
lib/normalize_ewma.py).

Weight-owning modules produce log-probability parameters; the distribution
math over them is plain functions driven by static ``HeadSpec`` metadata.
Numerics: temperature divides the raw logits, then a float32 log-softmax;
masked logits are LOG0 = -100; sampling is Gumbel-argmax.  A ``Real``
action space gets a diagonal-gaussian head, whose parameters stack
[mean, log_std] on a last axis of 2 (reference lib/action_head.py:54-133).
Torch and JAX random streams differ, so ``dict_sample`` takes an explicit
``torch.Generator`` and, for tests, injected noise (uniforms for a
categorical head, standard normals for a gaussian one).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vpt_tpu_torch.spaces import Discrete, Real, TensorType

LOG0 = -100.0


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """Shape metadata of one sub-head: ``value_shape`` of one action value,
    its cardinality ``num_actions`` (categorical heads) and ``kind``,
    "categorical" or "gaussian"."""

    key: str
    value_shape: Tuple[int, ...]
    num_actions: int = 0
    kind: str = "categorical"


def head_specs_from_space(ac_space) -> Tuple[HeadSpec, ...]:
    """DictType action space → ordered HeadSpecs (reference: make_action_head,
    lib/action_head.py:263-275): Discrete eltypes become categorical heads,
    Real eltypes diagonal-gaussian ones."""
    specs = []
    for key, ttype in ac_space.items():
        assert isinstance(ttype, TensorType), f"unsupported space for {key}: {ttype}"
        if isinstance(ttype.eltype, Discrete):
            specs.append(HeadSpec(key=key, value_shape=tuple(ttype.shape), num_actions=ttype.eltype.n))
        elif isinstance(ttype.eltype, Real):
            assert len(ttype.shape) == 1, "Nontrivial shapes not yet implemented."
            specs.append(HeadSpec(key=key, value_shape=tuple(ttype.shape), kind="gaussian"))
        else:
            raise NotImplementedError(f"unsupported eltype for {key}: {ttype.eltype}")
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


class DiagGaussianActionHead(nn.Module):
    """Gaussian head: means from a linear layer, a learned log-std per
    dimension (reference: lib/action_head.py:54-133).  The output stacks
    [mean, log_std] on a last axis of 2."""

    def __init__(self, insize: int, spec: HeadSpec, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        n = spec.value_shape[0]
        self.linear_layer = nn.Module()
        self.linear_layer.weight = nn.Parameter(torch.empty(n, insize, device=device))
        self.linear_layer.bias = nn.Parameter(torch.empty(n, device=device))
        self.log_std = nn.Parameter(torch.empty(n, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.orthogonal_(self.linear_layer.weight, gain=0.01, generator=generator)
        self.linear_layer.bias.zero_()
        self.log_std.zero_()

    def forward(self, x, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        assert mask is None, "Can not use a mask in a gaussian action head"
        dt = self.dtype
        means = F.linear(x.to(dt), self.linear_layer.weight.to(dt), self.linear_layer.bias.to(dt))
        return torch.stack([means, self.log_std.to(dt).expand_as(means)], dim=-1)


class DictActionHead(nn.Module):
    """One sub-head per action-space key (reference: lib/action_head.py:223-260)."""

    def __init__(self, insize: int, specs: Tuple[HeadSpec, ...], temperature: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.specs = specs
        # sub-heads sit directly under the head, as the reference names them:
        # ``pi_head.buttons.linear_layer.weight``
        for s in specs:
            head = (DiagGaussianActionHead(insize, s, dtype, device) if s.kind == "gaussian"
                    else CategoricalActionHead(insize, s, temperature, dtype, device))
            self.add_module(s.key, head)

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


def categorical_entropy(logits: torch.Tensor, spec: HeadSpec) -> torch.Tensor:
    """−Σ p·log p, reduced over value_shape."""
    ent = -torch.sum(torch.exp(logits) * logits, dim=-1)
    for _ in spec.value_shape:
        ent = ent.sum(dim=-1)
    return ent


def categorical_kl(logits_q: torch.Tensor, logits_p: torch.Tensor, spec: HeadSpec) -> torch.Tensor:
    """KL(q ‖ p) = Σ exp(q)·(q − p), reduced over value_shape, keepdim on the
    last axis (reference: lib/action_head.py:209-220)."""
    kl = torch.sum(torch.exp(logits_q) * (logits_q - logits_p), dim=-1, keepdim=True)
    for _ in spec.value_shape:
        kl = kl.sum(dim=-2)
    return kl


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


LOG2PI = 1.8378770664093453  # log(2π)


def gaussian_logprob(pd: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """pd (..., n, 2) = [mean, log_std]; summed over n (reference:
    lib/action_head.py:86-95)."""
    mean, log_std = pd[..., 0], pd[..., 1]
    z = (actions - mean) / torch.exp(log_std)
    return -(0.5 * torch.sum(z ** 2 + LOG2PI, dim=-1) + torch.sum(log_std, dim=-1))


def gaussian_entropy(pd: torch.Tensor) -> torch.Tensor:
    return torch.sum(pd[..., 1] + 0.5 * (LOG2PI + 1.0), dim=-1)


def gaussian_sample(pd: torch.Tensor, deterministic: bool = False, generator: Optional[torch.Generator] = None,
                    normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + ε·exp(log_std), ε standard normal from ``generator`` unless
    ``normal`` (same shape as the mean) is given; the mean if deterministic."""
    mean, log_std = pd[..., 0], pd[..., 1]
    if deterministic:
        return mean
    if normal is None:
        normal = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + normal * torch.exp(log_std)


def gaussian_kl(pd_q: torch.Tensor, pd_p: torch.Tensor) -> torch.Tensor:
    """KL(q ‖ p) of two diagonal gaussians, keepdim on the last axis
    (reference: lib/action_head.py:114-133)."""
    mq, lq = pd_q[..., 0], pd_q[..., 1]
    mp, lp = pd_p[..., 0], pd_p[..., 1]
    kl = lp - lq + (torch.exp(lq) ** 2 + (mq - mp) ** 2) / (2.0 * torch.exp(lp) ** 2) - 0.5
    return torch.sum(kl, dim=-1, keepdim=True)


def dict_logprob(logits: Dict[str, torch.Tensor], actions: Dict[str, torch.Tensor],
                 specs: Tuple[HeadSpec, ...]) -> torch.Tensor:
    return sum(gaussian_logprob(logits[s.key], actions[s.key]) if s.kind == "gaussian"
               else categorical_logprob(logits[s.key], actions[s.key], s) for s in specs)


def dict_entropy(logits: Dict[str, torch.Tensor], specs: Tuple[HeadSpec, ...]) -> torch.Tensor:
    return sum(gaussian_entropy(logits[s.key]) if s.kind == "gaussian" else categorical_entropy(logits[s.key], s)
               for s in specs)


def dict_kl(logits_q: Dict[str, torch.Tensor], logits_p: Dict[str, torch.Tensor],
            specs: Tuple[HeadSpec, ...]) -> torch.Tensor:
    return sum(gaussian_kl(logits_q[s.key], logits_p[s.key]) if s.kind == "gaussian"
               else categorical_kl(logits_q[s.key], logits_p[s.key], s) for s in specs)


def dict_sample(logits: Dict[str, torch.Tensor], specs: Tuple[HeadSpec, ...],
                deterministic: bool = False, generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Sample every sub-head; ``noise`` maps a head key to injected noise
    (uniforms for a categorical head, standard normals for a gaussian one)."""
    out = {}
    for s in specs:
        n = None if noise is None else noise.get(s.key)
        sample = gaussian_sample if s.kind == "gaussian" else categorical_sample
        out[s.key] = sample(logits[s.key], deterministic, generator, n)
    return out


def dict_sample_noise(logits: Dict[str, torch.Tensor], specs: Tuple[HeadSpec, ...], generator: torch.Generator,
                      batch: int, rows: slice) -> Dict[str, torch.Tensor]:
    """The noise :func:`dict_sample` draws from ``generator`` for a batch of
    ``batch`` rows, of which ``logits`` hold ``rows``: drawn whole, in the
    same order, and cut to those rows.  Ranks that each hold some rows of a
    batch and share a generator's seed so sample what one process sampling
    the whole batch would."""
    noise = {}
    for s in specs:
        x = logits[s.key]
        if s.kind == "gaussian":
            mean = x[..., 0]
            noise[s.key] = torch.randn((batch,) + mean.shape[1:], generator=generator, device=x.device,
                                       dtype=mean.dtype)[rows]
        else:
            noise[s.key] = torch.rand((batch,) + x.shape[1:], generator=generator, device=x.device,
                                      dtype=torch.float32)[rows]
    return noise


def ewma_mean_var(stats: Dict[str, torch.Tensor], epsilon: float = 1e-5):
    """Debiased (mean, var) from raw EWMA accumulators
    (reference: normalize_ewma.py:25-31, 57-60)."""
    debias = stats["debiasing_term"].clamp_min(epsilon)
    mean = stats["running_mean"] / debias
    mean_sq = stats["running_mean_sq"] / debias
    var = (mean_sq - mean ** 2).clamp_min(1e-2)
    return mean, var


def ewma_normalize(stats: Dict[str, torch.Tensor], x: torch.Tensor, norm_axes: int = 2,
                   epsilon: float = 1e-5) -> torch.Tensor:
    mean, var = ewma_mean_var(stats, epsilon)
    shape = (1,) * norm_axes + tuple(mean.shape)
    return (x.float() - mean.reshape(shape)) / torch.sqrt(var.reshape(shape))


def ewma_denormalize(stats: Dict[str, torch.Tensor], x: torch.Tensor, norm_axes: int = 2,
                     epsilon: float = 1e-5) -> torch.Tensor:
    mean, var = ewma_mean_var(stats, epsilon)
    shape = (1,) * norm_axes + tuple(mean.shape)
    return x.float() * torch.sqrt(var.reshape(shape)) + mean.reshape(shape)


def ewma_updated_stats(stats: Dict[str, torch.Tensor], target: torch.Tensor, beta: float = 0.99999,
                       norm_axes: int = 2, per_element_update: bool = False) -> Dict[str, torch.Tensor]:
    """The stats after folding in a batch of targets (reference:
    normalize_ewma.py:33-55, as a function of the stats)."""
    x = target.float()
    axes = tuple(range(norm_axes))
    batch_mean = x.mean(dim=axes)
    batch_sq_mean = (x ** 2).mean(dim=axes)
    weight = beta
    if per_element_update:
        size = 1
        for a in axes:
            size *= x.shape[a]
        weight = beta ** size
    return {
        "running_mean": stats["running_mean"] * weight + batch_mean * (1.0 - weight),
        "running_mean_sq": stats["running_mean_sq"] * weight + batch_sq_mean * (1.0 - weight),
        "debiasing_term": stats["debiasing_term"] * weight + (1.0 - weight),
    }


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
    lib/scaled_mse_head.py, lib/normalize_ewma.py).  Serving reads
    ``denormalize``; BC leaves the statistics as they are, and PPO
    (training/rl.py) folds each collected batch's returns into them with
    ``ewma_updated_stats``.  ``loss`` and ``updated_stats`` are the
    reference's own API on the head's statistics, which they do not change
    (``updated_stats`` returns the new ones)."""

    def __init__(self, insize: int, output_size: int = 1, norm_axes: int = 2, beta: float = 0.99999,
                 epsilon: float = 1e-5, per_element_update: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.norm_axes = norm_axes
        self.beta = beta
        self.epsilon = epsilon
        self.per_element_update = per_element_update
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

    def normalize(self, x):
        return ewma_normalize(self.normalizer.stats(), x, self.norm_axes, self.epsilon)

    def denormalize(self, x):
        return ewma_denormalize(self.normalizer.stats(), x, self.norm_axes, self.epsilon)

    def loss(self, prediction, target):
        """MSE in normalised space (reference: scaled_mse_head.py:37-43)."""
        return ((prediction.float() - self.normalize(target)) ** 2).mean()

    def updated_stats(self, target) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(running_mean, running_mean_sq, debiasing_term) after folding in a
        batch of targets (reference: normalize_ewma.py:33-55, as a function
        of the head's statistics)."""
        new = ewma_updated_stats(self.normalizer.stats(), target, self.beta, self.norm_axes,
                                 self.per_element_update)
        return new["running_mean"], new["running_mean_sq"], new["debiasing_term"]
