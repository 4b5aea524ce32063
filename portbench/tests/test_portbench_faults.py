"""The comparison that decides ``correct`` fails a broken timed path: a
whole run at tiny widths on the CPU (the harness's look for a card skipped),
with one fault planted in the program underneath, reads ``correct`` false;
the same run without the fault reads true.  Each cell kind gets the faults
it can have: a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, an answer altered where it is
produced.  (No cell spans chips, so none can leave out an exchange.)"""

from __future__ import annotations

import pytest

from portbench import faults
from portbench.run import run_cell
from portbench.tests import tiny

SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


def _run(kind: str, trace: bool = False) -> dict:
    return run_cell(tiny.spec(kind), SEED, 2.0, trace, device="cpu")


@pytest.mark.parametrize("kind", ["bc", "serve", "label"])
def test_sound_runs_are_correct(kind):
    result = _run(kind)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("kind, fault, number", [
    ("bc", "frozen_step", "change_leaf_gap"),
    ("bc", "half_batch", "grad_leaf_gap"),
    ("serve", "decode_flip", "decode_mismatches"),
    ("serve", "ring_stuck", "logp_gap"),
    ("label", "label_flip", "label_logp_gap"),
    ("label", "label_half", "label_logp_gap"),
])
def test_a_planted_fault_reads_not_correct(kind, fault, number):
    undo = faults.FAULTS[fault]()
    try:
        result = _run(kind)
    finally:
        undo()
    assert not result["correct"]
    assert result["checks"][number]["value"] > result["checks"][number]["limit"], result["checks"]


def test_the_bfloat16_control_reads_far_above_the_program():
    """Serving in bfloat16 at tiny widths: the control (the reference with
    float8 products in the program's place) reads a log-probability gap
    several times the program's."""
    spec = tiny.spec("serve")
    spec["traffic"]["compute_dtype"] = "bfloat16"
    sound = run_cell(spec, SEED, 0.5, False, device="cpu")["checks"]["logp_gap"]["value"]
    control = run_cell(spec, SEED, 0.5, False, device="cpu", control=True)["checks"]["logp_gap"]["value"]
    assert control > 3 * sound > 0, (sound, control)


@pytest.mark.parametrize("kind", ["bc", "serve", "label"])
def test_traced_runs_check_the_same(kind):
    result = _run(kind, trace=True)
    assert result["correct"] and result["metrics"], result
