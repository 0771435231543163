"""The benchmark's data, found by name: ``BENCHMARK.json``'s cells and
metrics, a configuration's file, a traffic mix's file
(``traffic/<name>.json``) and a metric's reader (``metrics/<name>.py``).
A cell, a mix or a metric is added by adding files and entries; nothing
here names one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list the cell, and those that list none."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def reader(name: str, here: Path = HERE):
    """The module ``metrics/<name>.py``; its ``read(rec)`` gives the
    metric's value, or None where the run has nothing to read. A reader
    that needs more of the program than ``System.counters`` gives defines
    ``snapshot(system)``: the run calls it as the window opens and as it
    closes, and ``rec.before[name]`` / ``rec.after[name]`` hold what it
    returned."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
