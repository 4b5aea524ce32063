"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m portbench.run ...                      (the same)

From the root of a checkout that holds ``vpt_tpu_torch`` and
``BENCHMARK.json``, on a machine with the CUDA devices the cell asks for.
Everything a cell is comes from files found by name (portbench/manifest.py):
its configuration, its traffic mix and the generator (``drivers/<driver>``)
that reads it, its limits, and one reader a per-layer metric.

A run: set-up (weights drawn on the device from the seed, the traffic made
from the seed, every shape the traffic uses warmed up), then with
``--trace 0`` a window of ``--seconds`` that gives the end-to-end metrics;
with ``--trace 1`` a short untimed-by-trace stretch (host spans, the step's
rate) and a profiled stretch (device busy time, kernels by operator) that
give the per-layer metrics.  Then the program's state is freed and the
plain reference (portbench/reference) recomputes a sample of what the timed
path produced; ``correct`` says whether every compared number is inside its
limit.  The compared numbers, each beside its limit, are the last lines on
standard error and the last key of the result; the result is the last line
on standard output.  No result is printed, and the exit code is not 0,
where CUDA or the cell's devices are missing, or where the process holds
JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up counts from here, the interpreter's first line of the run

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# build and kernel caches at fixed paths inside the checkout: only a checkout's first run fills them
# (the port builds its CUDA libraries into vpt_tpu_torch/build/, inside the checkout too)
_CACHE = ROOT / ".portbench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[_var] = str(_CACHE / _sub)

from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vpt_tpu")


def forbidden_modules() -> List[str]:
    """Modules in this process whose top-level name is JAX's or the JAX
    package's, compared whole (``vpt_tpu_torch`` is not ``vpt_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules if name.split(".")[0] in FORBIDDEN})


class Run:
    """One run of one cell: what the driver reads (configuration, traffic,
    limits, seed, mode) and what it reports back."""

    def __init__(self, spec: Dict, seed: int, seconds: float, trace: bool, device: str,
                 control: bool = False, started: float = STARTED, trace_ops=()):
        import torch

        from portbench.reference.model import arch_from_config

        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.limits = spec["cell"].get("limits", {})
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.control = control
        self.started = started
        self.arch = arch_from_config(self.config)
        self.e2e: Dict[str, float] = {}
        self.layer: Dict[str, object] = {}  # what the per-layer readers read
        self.checks: Dict[str, Tuple[float, float]] = {}
        self.setup_s: Optional[float] = None
        self.memory_peak_bytes = 0
        self.attempted = 0
        self.trace_data = None
        self.trace_ops = tuple(trace_ops)  # operators whose kernels the readers need, by call
        self.phases: List[Tuple[str, float]] = []  # set-up's parts, for the run's notes
        self._phase_start = started

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)

    def phase(self, name: str) -> None:
        """A part of set-up ends here (the device idle): noted on standard error."""
        self.sync()
        now = time.perf_counter()
        self.phases.append((name, now - self._phase_start))
        self._phase_start = now

    def setup_done(self) -> None:
        """Set-up ends here: every shape warmed, the device idle."""
        self.phase("warm-up")
        self.setup_s = time.perf_counter() - self.started
        print("portbench: set-up " + ", ".join(f"{n} {s:.2f} s" for n, s in self.phases), file=sys.stderr)

    def stretch(self, unit: Callable[[], int], kind: str) -> Dict[str, float]:
        """Drive ``unit`` (one call of the traffic; returns the work units it
        completed) through a stretch: the measured window ("window", for
        ``seconds``), or the trace run's untraced ("spans") or profiled
        ("traced") stretch of the traffic's ``trace_units`` calls.  Returns
        the units done, the seconds from the start to the last completion,
        and the calls made."""
        from portbench import trace as tr

        limit = self.traffic["trace_units"]
        with tr.profiled(kind == "traced") as prof:
            self.sync()
            t0 = time.perf_counter()
            last, done, calls = t0, 0, 0
            while (time.perf_counter() - t0 < self.seconds) if kind == "window" else calls < limit:
                got = unit()
                calls += 1
                if got:
                    done += got
                    last = time.perf_counter()
            self.sync()
        if kind == "traced":
            self.trace_data = tr.read(prof.get("path"), self.trace_ops)
        if self.cuda and kind != "traced":
            import torch

            self.memory_peak_bytes = max(self.memory_peak_bytes, torch.cuda.max_memory_allocated(self.device))
        return {"done": done, "seconds": last - t0, "calls": calls}

    def check(self, name: str, value: float) -> None:
        """Record a compared number beside its limit from the cell's file
        (a number the cell file has no limit for is held to 0)."""
        self.checks[name] = (float(value), float(self.limits.get(name, 0.0)))

    def free(self) -> None:
        """Release the program's device memory before the reference runs."""
        import gc

        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, package: Optional[Path] = None, started: float = STARTED) -> Dict:
    """Run one cell (``spec`` from manifest.resolve) and return its result
    line as a dict, ``checks`` last."""
    from portbench import manifest

    package = package or manifest.PACKAGE
    readers = {m["name"]: manifest.load_module(manifest.metric_file(m["name"], package), f"portbench_metric_{m['name']}")
               for m in spec["per_layer"]} if trace else {}
    ops = sorted({op for r in readers.values() for op in getattr(r, "OPS", ())})
    run = Run(spec, seed, seconds, trace, device, control, started, ops)
    driver = manifest.load_module(manifest.driver_file(spec["traffic"]["driver"], package),
                                  f"portbench_driver_{spec['traffic']['driver']}")
    driver.run(run)
    metrics: Dict[str, Dict] = {}
    if trace:
        for m in spec["per_layer"]:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            value = run.setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for v, lim in run.checks.values() if not v <= lim)
    device_info = {"platform": "gpu" if run.cuda else "cpu",
                   "kind": _device_name(run), "count": spec["workload"]["chips"],
                   "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": bool(run.checks) and failed == 0, "attempted": int(run.attempted), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and run.trace_data is not None:
        device_info["busy_s"] = run.trace_data.busy_s
        device_info["window_s"] = run.trace_data.window_s
        result["breakdown"] = run.trace_data.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return result


def _device_name(run: Run) -> str:
    if not run.cuda:
        return "cpu"
    import torch

    return torch.cuda.get_device_name(run.device)


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import manifest

    bench = manifest.load()
    spec = manifest.resolve(bench, args.workload)
    import torch

    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {', '.join(bad)} after the window; no result", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed} on {_power_limit()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
