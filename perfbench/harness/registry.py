"""Finding a cell's pieces by name, so that a new cell, configuration,
traffic mix or metric is a new file and an entry in BENCHMARK.json:

  BENCHMARK.json                    the cells and metrics
  perfbench/workloads/<cell>.json   its configuration, traffic and limits
  perfbench/configs/<config>.json   the configuration's sizes
  perfbench/traffic/<traffic>.json  the traffic mix's parameters and driver
  perfbench/drivers/<driver>.py     `run(ctx) -> Result`, one per kind of traffic
  perfbench/metrics/<metric>.py     `read(result) -> value or None`
  perfbench/rooflines/<fn>.py/.json one kernel function's work and kernel names
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parents[1]  # perfbench/
REPO = HERE.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(REPO)} is missing")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return _json(REPO / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def roofline_names(function: str) -> List[str]:
    return _json(HERE / "rooflines" / f"{function}.json")["kernels"]


def module(kind: str, name: str) -> ModuleType:
    """perfbench/<kind>/<name>.py, loaded by path (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(REPO)} is missing")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics a cell reports in its traced run: those that
    list it, or that list no cells and move a metric the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
