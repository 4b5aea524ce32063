"""Readings of a cell's comparison on several seeds in one process: what
the limits in ``portbench/cells/<cell>.json`` are set from (PERF.md).  The
benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 3] [--mode sound|control|fault:<name>]

``sound``: the program as its configuration states (the lower readings).
``control`` (the default): the precision one step below the
configuration's in the program's place: float32 cells run the program with
TF32 on; bfloat16 cells (serving) put the reference with float8 (e4m3)
products in the program's place.  ``fault:<name>``: a fault of
portbench/faults.py planted in the program.  Each seed prints one JSON line
of the compared numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults, manifest  # noqa: E402
from portbench.run import run_cell  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--mode", default="control")
    args = p.parse_args()
    spec = manifest.resolve(manifest.load(), args.workload)
    undo = faults.FAULTS[args.mode.split(":", 1)[1]]() if args.mode.startswith("fault:") else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            res = run_cell(spec, seed, args.seconds, False, control=args.mode == "control")
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": args.mode,
                              "checks": {k: c["value"] for k, c in res["checks"].items()},
                              "metrics": {k: m["value"] for k, m in res["metrics"].items()}}), flush=True)
    finally:
        if undo is not None:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
