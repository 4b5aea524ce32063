"""Faults planted in the program underneath a whole run, to show that the
comparison deciding ``correct`` fails a broken timed path (the CPU tests)
and to read, on the card, what each fault reads against the reference
(``control.py --mode fault:<name>``): the upper readings of a training
cell's limits.  Each fault patches one function of the port and returns a
function that takes the patch out again."""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _patch(owner, name: str, new) -> Callable[[], None]:
    old = owner.__dict__[name]
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def frozen_step() -> Callable[[], None]:
    """The optimizer step returns the weights unchanged (the gradient is
    still clipped, Adam never steps)."""
    from vpt_tpu_torch.training import bc

    def no_update(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return torch.nn.utils.clip_grad_norm_(self.params, self.max_grad_norm)

    return _patch(bc.ClippedAdam, "step", no_update)


def half_batch() -> Callable[[], None]:
    """The loss over the first half of the batch's rows, the mean taken
    over those (the state of the rest carried as the first half's)."""
    from vpt_tpu_torch.training import bc

    scored = bc.BCTrainer._scored_nll

    def half(self, batch, state):
        rows = batch["frames"].shape[0] // 2
        nll, state_out, n = scored(self, {k: v[:rows] for k, v in batch.items()},
                                   [{k: v[:rows] for k, v in s.items()} for s in state])
        return nll, [{k: torch.cat([v, v]) for k, v in s.items()} for s in state_out], n

    return _patch(bc.BCTrainer, "_scored_nll", half)


def decode_flip() -> Callable[[], None]:
    """The served env action's "attack" button flipped where it is decoded."""
    from vpt_tpu_torch.actions import device_decode

    decode = device_decode.DeviceActionDecoder.decode

    def altered(self, buttons, camera):
        out = decode(self, buttons, camera)
        out[:, 0] = 1 - out[:, 0]
        return out

    return _patch(device_decode.DeviceActionDecoder, "decode", altered)


def ring_stuck() -> Callable[[], None]:
    """The t=1 step returns its ring state unchanged: the slot index never
    advances, so every step overwrites the same slot."""
    from vpt_tpu_torch.models import transformer

    forward = transformer.MaskedAttention.forward

    def stuck(self, x, first, state):
        out, new = forward(self, x, first, state)
        return out, ({**new, "idx": state["idx"]} if "idx" in state else new)

    return _patch(transformer.MaskedAttention, "forward", stuck)


def label_flip() -> Callable[[], None]:
    """Every button label flipped where the labels are chosen."""
    from vpt_tpu_torch.models import policy

    sample = policy.dict_sample

    def altered(logits, specs, deterministic=False, generator=None, noise=None):
        out = sample(logits, specs, deterministic, generator, noise)
        out["buttons"] = 1 - out["buttons"]
        return out

    return _patch(policy, "dict_sample", altered)


def label_half() -> Callable[[], None]:
    """Half of a forward's windows given the other half's labels."""
    from vpt_tpu_torch.models import policy

    sample = policy.dict_sample

    def half(logits, specs, deterministic=False, generator=None, noise=None):
        out = sample(logits, specs, deterministic, generator, noise)
        b = out["buttons"].shape[0]
        return {k: torch.cat([v[: (b + 1) // 2]] * 2)[:b] for k, v in out.items()}

    return _patch(policy, "dict_sample", half)


FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {
    f.__name__: f for f in (frozen_step, half_batch, decode_flip, ring_stuck, label_flip, label_half)}
