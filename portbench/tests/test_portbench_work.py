"""The yardstick's arithmetic: work.py's model FLOPs against torch's flop
counter on the plain reference, and B1's and B2's least time against
chip_smoke.py's formulas at PERF.md §6's shapes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs, work
from portbench.reference import model as ref_model
from portbench.tests import tiny


@pytest.mark.parametrize("kind", ["bc", "label"])
def test_forward_flops_match_the_flop_counter(kind):
    spec = tiny.spec(kind)
    arch = ref_model.arch_from_config(spec["config"])
    b, t = 2, 8
    params = inputs.make_weights(arch, 0, "cpu")
    frames = torch.zeros((b, t, *arch.img, arch.in_chans), dtype=torch.uint8)
    first = torch.zeros((b, t), dtype=torch.bool)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref_model.forward(params, arch, frames, first, ref_model.initial_state(arch, b))
    counted = counter.get_total_flops()
    keys = t + arch.maxlen
    # the counter takes the bias contraction over every key; the formula over the band's keys alone
    counted += arch.n_blocks * 2 * b * arch.heads * (work.band_pairs(t, keys, arch.maxlen) - t * keys) * ref_model.NBASIS
    if arch.idm:  # the IDM computes its lastlayer and discards it; the reference does not compute it
        counted += 2 * b * t * arch.hidsize ** 2
    assert work.forward_flops_per_frame(arch, keys) * b * t == pytest.approx(counted, rel=1e-12)


def test_published_models_flops():
    """45.3 GFLOP a trained 2x frame (3 forwards), 68.6 a frame through the 4x IDM."""
    import json

    from portbench import manifest

    bench = manifest.load()
    arch = {c: ref_model.arch_from_config(json.load(open(manifest.config_file(bench, c)))) for c in ("policy2x", "idm4x")}
    assert work.train_flops_per_frame(arch["policy2x"], 128) / 1e9 == pytest.approx(45.3, abs=0.05)
    assert work.forward_flops_per_frame(arch["idm4x"], 256) / 1e9 == pytest.approx(68.6, abs=0.05)


SHAPES = [  # PERF.md §6: 2x chunk, IDM, PPO minibatch, IDM long call
    (4, 16, 128, 256, 128, True), (4, 32, 128, 256, 128, False), (3, 32, 128, 256, 128, False),
    (4, 16, 64, 192, 128, True), (1, 32, 512, 640, 128, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_bounds_match_chip_smoke(shape, dtype):
    import chip_smoke

    B, H, t, T, d, masked = shape
    q = torch.empty((B, H, t, d), dtype=dtype, device="meta")
    k = torch.empty((B, H, T, d), dtype=dtype, device="meta")
    mask = torch.empty((B, t, T), dtype=torch.bool, device="meta") if masked else None
    R = torch.empty((B, H, t, 10), device="meta")
    b_nd = torch.empty((10, 128), device="meta")
    name = "float32" if dtype == torch.float32 else "bfloat16"
    dims = lambda x: list(x.shape) if x is not None else []  # noqa: E731
    b1 = work.b1_least_ms(dims(q), dims(k), dims(mask), dims(R), dims(b_nd), name)
    b2 = work.b2_least_ms(dims(q), dims(k), dims(mask), dims(R), dims(b_nd), name)
    assert b1 == pytest.approx(chip_smoke.b1_bound(q, k, k, mask, R, b_nd)[0], rel=1e-12)
    assert b2 == pytest.approx(chip_smoke.b2_bound(q, k, k, mask, R, b_nd)[0], rel=1e-12)
