"""BENCHMARK.json and the files it names, found by name:

* a configuration ``<config>``: ``portbench/configs/<config>.json``;
* a traffic mix ``<traffic>``: ``portbench/traffic/<traffic>.json``, whose
  ``driver`` names the generator ``portbench/drivers/<driver>.py`` that
  reads it;
* a cell ``<config>.<traffic>``: ``portbench/cells/<cell>.json``, the limits
  its comparison holds the program to;
* a per-layer metric ``<name>``: its reader ``portbench/metrics/<name>.py``.

A later change adds a cell, a configuration, a traffic mix or a metric by
adding such files and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config_file(bench: dict, config: str, package: Path = PACKAGE) -> Path:
    for c in bench["configs"]:
        if c["name"] == config:
            return Path(package).parent / c["file"]
    raise KeyError(f"BENCHMARK.json has no config {config!r}")


def traffic_file(traffic: str, package: Path = PACKAGE) -> Path:
    return Path(package) / "traffic" / f"{traffic}.json"


def cell_file(cell: str, package: Path = PACKAGE) -> Path:
    return Path(package) / "cells" / f"{cell}.json"


def metric_file(metric: str, package: Path = PACKAGE) -> Path:
    return Path(package) / "metrics" / f"{metric}.py"


def driver_file(driver: str, package: Path = PACKAGE) -> Path:
    return Path(package) / "drivers" / f"{driver}.py"


def resolve(bench: dict, name: str, package: Path = PACKAGE) -> Dict:
    """Everything one cell needs: its entry, configuration, traffic mix,
    limits, and the metrics it reports."""
    w = workload(bench, name)
    return {
        "workload": w,
        "config": _json(config_file(bench, w["config"], package)),
        "traffic": _json(traffic_file(w["traffic"], package)),
        "cell": _json(cell_file(name, package)),
        "end_to_end": end_to_end_of(bench, name),
        "per_layer": per_layer_of(bench, name),
    }


def end_to_end_of(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def per_layer_of(bench: dict, cell: str) -> List[dict]:
    e2e = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def load_module(path: Path, name: str):
    """Import a file by its path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def problems(bench: dict, package: Path = PACKAGE) -> List[str]:
    """What in BENCHMARK.json breaks the rules of names, units and files
    (empty when nothing does)."""
    out: List[str] = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[kind]]
        if len(set(names)) != len(names):
            out.append(f"{kind}: a name appears twice")
        out += [f"{kind}: bad name {n!r}" for n in names if not NAME.match(n)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
    for c in bench["configs"]:
        if not (Path(package).parent / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        out += [f"config {c['name']}: bad key {k!r}" for k in c["reduced"] if not NAME.match(k)]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"{w['name']}: bad {key} {w[key]!r}")
        if not traffic_file(w["traffic"], package).is_file():
            out.append(f"{w['name']}: no traffic file for {w['traffic']}")
        elif not driver_file(_json(traffic_file(w["traffic"], package))["driver"], package).is_file():
            out.append(f"{w['name']}: no driver for traffic {w['traffic']}")
        if not cell_file(w["name"], package).is_file():
            out.append(f"{w['name']}: no cell file")
        reports = {m["name"] for m in end_to_end_of(bench, w["name"])}
        if "setup_s" not in reports or len(reports) < 2:
            out.append(f"{w['name']}: reports setup_s and no other end-to-end metric")
        if not per_layer_of(bench, w["name"]):
            out.append(f"{w['name']}: reports no per-layer metric")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves {m['moves']!r}, which is no end-to-end metric")
        if not metric_file(m["name"], package).is_file():
            out.append(f"{m['name']}: no reader")
        for cell in m.get("workloads", []):
            if m["moves"] not in {x["name"] for x in end_to_end_of(bench, cell)}:
                out.append(f"{m['name']}: cell {cell} does not report {m['moves']}")
    return out

