"""Inputs made from a run's seed: the weights, handed to the program and to
the reference alike, and the traffic helpers the drivers share.

Weights are drawn on the device by one ``torch.Generator`` in one call and
shaped by the reference's parameter list (``reference.model.param_spec``):
the same seed gives the same weights, drawn again as often as needed, so
neither side keeps a copy for the other.  Traffic comes from numpy
generators on streams of their own, so weights and traffic do not share
draws.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference.model import Arch, param_spec

WEIGHTS, TRAFFIC, SAMPLE, FRAMES = range(4)  # the seed's independent streams


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def torch_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0] >> 1)


@torch.no_grad()
def make_weights(arch: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the graph, float32 on ``device``: one
    normal draw for all of them, each weight's rows scaled to their
    published fan-in norm."""
    spec = param_spec(arch)
    drawn = [(name, shape) for name, shape, init, _ in spec if init in ("normed", "randn")]
    total = sum(int(np.prod(shape)) for _, shape in drawn)
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=g, device=device)
    out, offset = {}, 0
    for name, shape, init, scale in spec:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = int(np.prod(shape))
            w = flat[offset:offset + n].view(shape)
            offset += n
            if init == "normed":
                rows = w.reshape(shape[0], -1)
                w = (rows * (scale / rows.norm(dim=1, keepdim=True))).view(shape)
            else:
                w = w * scale
            out[name] = w
    return out


def frame_pool(seed: int, count: int, shape, device) -> torch.Tensor:
    """``count`` distinct uint8 frames of ``shape`` drawn on ``device``: noise
    under a smooth gradient, so a resize and a convolution see structure."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, FRAMES))
    h, w, c = shape
    noise = torch.randint(0, 64, (count, h, w, c), generator=g, device=device, dtype=torch.int16)
    ramp = torch.linspace(0, 191, h, device=device)[:, None, None] * 0.5 + torch.linspace(0, 191, w, device=device)[
        None, :, None] * 0.5
    phase = torch.randint(0, 192, (count, 1, 1, c), generator=g, device=device, dtype=torch.int16)
    return ((ramp.to(torch.int16)[None] + phase) % 192 + noise).to(torch.uint8)


def pool_index(step: np.ndarray, stream: np.ndarray, count: int) -> np.ndarray:
    """Which pool frame stream ``stream`` shows at ``step``: a fixed
    permutation of the pool, so every stream walks all of it and no two
    consecutive frames repeat."""
    return (np.asarray(step, np.int64) * 7919 + np.asarray(stream, np.int64) * 104729) % count


def episode_starts(r: np.random.Generator, streams: int, steps: int, lengths, first_end) -> np.ndarray:
    """(streams, steps) bool, True where a stream starts an episode.  Each
    stream starts one at step 0; its first episode ends after
    ``first_end[b]`` steps (where the stream joined it), every later one
    lasts a length drawn uniformly from ``lengths`` (inclusive)."""
    lo, hi = lengths
    starts = np.zeros((streams, steps), bool)
    starts[:, 0] = True
    for b in range(streams):
        at = int(first_end[b])
        while at < steps:
            starts[b, at] = True
            at += int(r.integers(lo, hi + 1))
    return starts
