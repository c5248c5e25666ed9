"""What one run knows, and the files it finds by name.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix. The configuration's file holds the flags the program and
the reference are built from; ``perfbench/traffic/<traffic>.json`` holds
the mix's parameters and its ``kind``, the module of ``perfbench/kinds``
that generates and drives it; ``perfbench/limits/<cell>.json`` holds the
limits of the numbers that decide ``correct``; and each per-layer metric
is read by ``perfbench/metrics/<metric>.py``. A new cell, configuration,
mix or metric is new files and new entries: no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def configuration(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    """{number: {"limit", and the readings it was set from}}; a number the
    run reads but this file does not name is not compared."""
    return load_json(BENCH / "limits" / f"{workload}.json")["numbers"]


def kind(name: str):
    return importlib.import_module(f"perfbench.kinds.{name}")


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """``read`` of perfbench/metrics/<metric>.py (metric names hold dots,
    so the file is loaded by its path)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, section: str) -> List[dict]:
    """The metrics of one section that this cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


@dataclasses.dataclass
class Run:
    """One run: its arguments, its cell's files and the device."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    flags: dict
    traffic: dict
    limits: dict
    device: Any
    t0: float
    # the system under test: the program, or for the harness's own checks
    # the reference in the program's place ("control") or the program
    # with a fault planted ("fault:<name>")
    side: str = "program"


@dataclasses.dataclass
class Result:
    """What a kind hands back: the end-to-end metrics, the numbers that
    decide ``correct``, the counts, and the readings for the per-layer
    metrics (``readings["trace"]`` is the traced window's summary)."""
    e2e: Dict[str, float]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    readings: Dict[str, Any] = dataclasses.field(default_factory=dict)
