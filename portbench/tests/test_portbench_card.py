"""On the card, at each cell's own size: a sound run reads ``correct``, and
the cell's control (the precision one step below its configuration's in
the program's place: the program with TF32 on for float32, the reference
with float8 products for bfloat16) reads not correct.  Skips where there is no CUDA device.

    python -m pytest portbench/tests/test_portbench_card.py -q
"""

from __future__ import annotations

import pytest

from portbench import manifest
from portbench.run import run_cell

SEED = 3_000_000_017


def _cells():
    return [w["name"] for w in manifest.load()["workloads"]]


def _needs_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_cell_on_the_card(cell, control):
    _needs_card()
    result = run_cell(manifest.resolve(manifest.load(), cell), SEED, 3.0, False, control=control)
    assert result["correct"] != control, result["checks"]
