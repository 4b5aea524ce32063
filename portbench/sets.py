"""Run one cell several times, one process a run, and read the spread of
its numbers: what the bounds in BENCHMARK.json are set from.

    python3 portbench/sets.py --workload <cell> --seeds 11,12,13 --seconds 30 [--trace 0] [--out FILE]

Each run is ``portbench/run.py``; its result line and the end of its
standard error go to ``--out`` (JSON lines).  The summary gives, for each
metric, its values, median and spread: the distance between the first
and third quartile (``statistics.quantiles(values, n=4)``) as a share of
the median; and each compared number's widest reading.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one(workload: str, seed: int, seconds: float, trace: int, extra=()) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", workload,
                           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace), *extra],
                          cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr": proc.stderr[-4000:]}


def summary(records) -> dict:
    metrics, checks = {}, {}
    for r in records:
        if r["result"] is None:
            continue
        for k, m in r["result"]["metrics"].items():
            metrics.setdefault(k, []).append(m["value"])
        for k, c in r["result"]["checks"].items():
            checks.setdefault(k, []).append(c["value"])
    return {
        "runs": len(records), "ok": sum(r["result"] is not None for r in records),
        "correct": sum(bool(r["result"] and r["result"]["correct"]) for r in records),
        "metrics": {k: {"values": v, "median": statistics.median(v), "spread": spread(v)} for k, v in metrics.items()},
        "checks_max": {k: max(v) for k, v in checks.items()},
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args()
    records = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = one(args.workload, seed, args.seconds, args.trace)
        records.append(rec)
        res = rec["result"]
        print(json.dumps({"seed": seed, "rc": rec["rc"], "wall_s": round(rec["wall_s"], 1),
                          "metrics": res and {k: m["value"] for k, m in res["metrics"].items()},
                          "correct": res and res["correct"],
                          "checks": res and {k: c["value"] for k, c in res["checks"].items()},
                          "peak": res and res["device"]["memory_peak_bytes"]}), flush=True)
        if res is None:
            print(rec["stderr"][-3000:], flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(json.dumps({"workload": args.workload, "summary": summary(records)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
