"""BENCHMARK.json resolves to files by name and keeps the contract's naming
rules; a cell, a traffic mix, a configuration and a per-layer metric are
added as new files and entries alone."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest

from portbench import manifest


def test_every_name_resolves_and_keeps_the_rules():
    bench = manifest.load()
    assert manifest.problems(bench) == []
    for w in bench["workloads"]:
        spec = manifest.resolve(bench, w["name"])
        assert spec["config"]["policy_kwargs"] and spec["traffic"]["driver"]
        assert spec["end_to_end"] and spec["per_layer"]


@pytest.mark.parametrize("key", ["end_to_end", "per_layer"])
def test_units_and_names(key):
    for m in manifest.load()[key]:
        assert manifest.NAME.match(m["name"]) and manifest.UNIT.match(m["unit"]), m


def test_each_per_layer_metric_moves_what_its_cells_report():
    bench = manifest.load()
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in manifest.end_to_end_of(bench, cell)}, (m["name"], cell)


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_config_and_metric_are_files_alone(tmp_path):
    root = manifest.PACKAGE.parent
    shutil.copytree(manifest.PACKAGE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")
    package = tmp_path / "portbench"
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a new configuration: the 1x policy; a new traffic mix and its cell; a new metric
    cfg = json.loads((package / "configs" / "policy2x.json").read_text())
    cfg["policy_kwargs"].update(hidsize=1024, impala_width=4)
    (package / "configs" / "policy1x.json").write_text(json.dumps(cfg))
    traffic = json.loads((package / "traffic" / "serve64_bf16.json").read_text())
    traffic["streams"] = 8
    (package / "traffic" / "serve8_bf16.json").write_text(json.dumps(traffic))
    (package / "cells" / "policy1x.serve8_bf16.json").write_text(json.dumps({"limits": {}}))
    (package / "metrics" / "serve_calls.serve.py").write_text("def read(run):\n    return None\n")
    bench["configs"].append({"name": "policy1x", "source": "https://github.com/openai/Video-Pre-Training",
                             "file": "portbench/configs/policy1x.json", "reduced": [], "why": "a throwaway"})
    bench["workloads"].append({"name": "policy1x.serve8_bf16", "config": "policy1x", "traffic": "serve8_bf16",
                               "chips": 1, "why": "a throwaway"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_fps":
            m["workloads"].append("policy1x.serve8_bf16")
    bench["per_layer"].append({"name": "serve_calls.serve", "unit": "1", "better": "higher", "source": "program_counter",
                               "layer": "agent", "moves": "serve_fps", "workloads": ["policy1x.serve8_bf16"]})
    assert manifest.problems(bench, package) == []
    spec = manifest.resolve(bench, "policy1x.serve8_bf16", package)
    assert spec["traffic"]["streams"] == 8 and spec["config"]["policy_kwargs"]["hidsize"] == 1024
    assert [m["name"] for m in spec["per_layer"]] == ["serve_calls.serve"]
    after = _digest(package)
    assert {k: v for k, v in after.items() if k in before} == before  # no file that was there changed
