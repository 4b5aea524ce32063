"""Nothing the benchmark runs loads JAX or the JAX package: the harness,
every driver, every metric reader and the reference are imported in a fresh
interpreter, and no module whose top-level name is exactly ``jax``,
``jaxlib``, ``flax`` or ``vpt_tpu`` may appear (``vpt_tpu_torch`` is the
port, whose name only begins with the JAX package's).  The reference
imports nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import manifest
from portbench.run import FORBIDDEN

PACKAGE = manifest.PACKAGE

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
before = set(sys.modules)
import portbench.run, portbench.manifest, portbench.sets, portbench.control
from portbench.reference import model, train, actions
for path in {files!r}:
    portbench.manifest.load_module(__import__("pathlib").Path(path), "probe_" + path.replace("/", "_"))
import vpt_tpu_torch.agent.agent, vpt_tpu_torch.agent.idm, vpt_tpu_torch.training.bc
print(json.dumps(sorted({{m.split(".")[0] for m in set(sys.modules) - before}})))
"""


def test_nothing_the_benchmark_runs_imports_jax():
    files = sorted(str(p) for d in ("drivers", "metrics") for p in (PACKAGE / d).glob("*.py"))
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(PACKAGE.parent), files=files)],
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in loaded and "vpt_tpu_torch" in loaded  # the probe saw the imports
    assert loaded.isdisjoint(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PACKAGE / "reference").glob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "contextlib", "itertools", "math", "dataclasses", "typing", "numpy", "torch", "portbench"}, (
            path, tops)
        assert not any(name.startswith("portbench.") and not name.startswith("portbench.reference")
                       for name in _imports(path)), path


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    from portbench.run import forbidden_modules

    for name in ("vpt_tpu_torch.models", "vpt_tpu_torchish", "jaxtyping", "jax.numpy", "vpt_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    assert [m for m in forbidden_modules() if m in ("jax", "vpt_tpu", "vpt_tpu_torch", "jaxtyping")] == ["jax", "vpt_tpu"]
