"""Minecraft helpers (counterpart of vpt_tpu/utils/minecraft.py; reference
lib/minecraft_util.py): ``store_args``, the reference's recorder of
constructor arguments, and the normalised entropy of the categorical heads,
each head's entropy divided by the log of its number of available options
(masks respected), a diagnostic of the factored action space."""

from __future__ import annotations

import functools
import inspect
import math
from typing import Dict, Optional, Tuple

import torch

from vpt_tpu_torch.models.heads import HeadSpec


def store_args(method):
    """Store the arguments given to ``__init__`` as instance attributes."""
    argspec = inspect.getfullargspec(method)
    defaults = {}
    if argspec.defaults is not None:
        defaults = dict(zip(argspec.args[-len(argspec.defaults):], argspec.defaults))
    if argspec.kwonlydefaults is not None:
        defaults.update(argspec.kwonlydefaults)
    arg_names = argspec.args[1:]

    @functools.wraps(method)
    def wrapper(*positional_args, **keyword_args):
        self = positional_args[0]
        args = defaults.copy()
        for name, value in zip(arg_names, positional_args[1:]):
            args[name] = value
        args.update(keyword_args)
        self.__dict__.update(args)
        return method(*positional_args, **keyword_args)

    return wrapper


def norm_entropy_from_cat_logits(logits: torch.Tensor, spec: HeadSpec,
                                 mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalised entropy, counted entries) of one categorical head, summed
    over its value shape.  A masked entry divides by the log of its own
    count of available options; entries with a single option count for
    nothing (reference: lib/minecraft_util.py:37-59)."""
    entropy = -torch.sum(torch.exp(logits) * logits, dim=-1)
    if mask is not None:
        n = mask.sum(dim=-1).float()
        norm_entropy = torch.where(n == 1.0, 0.0, entropy / torch.log(n.clamp_min(2.0)))
        count = (n != 1.0).to(torch.int32)
    else:
        norm_entropy = entropy / math.log(float(logits.shape[-1]))
        count = torch.ones_like(norm_entropy, dtype=torch.int32)
    for _ in spec.value_shape:
        norm_entropy = norm_entropy.sum(dim=-1)
        count = count.sum(dim=-1)
    return norm_entropy, count


def norm_cat_entropy(logits: Dict[str, torch.Tensor], specs: Tuple[HeadSpec, ...],
                     masks: Optional[Dict[str, torch.Tensor]] = None):
    """Summed normalised entropy and entry counts over every categorical head."""
    masks = masks or {}
    total, counts = 0.0, 0
    for spec in specs:
        if spec.kind != "categorical":
            continue
        e, c = norm_entropy_from_cat_logits(logits[spec.key], spec, masks.get(spec.key))
        total = total + e
        counts = counts + c
    return total, counts
