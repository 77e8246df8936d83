"""The benchmark's definition, found by name: `BENCHMARK.json` at the root
of the checkout names the cells, each cell a configuration file and a
traffic file, and the metrics, each read by a module under
`bench/metrics/`: `<metric>.py`, or, for a metric named `<base>.<variant>`
without a file of its own, `<base>.py` (one quantity split by the
end-to-end metric it moves reads alike in every cell). A cell's
correctness limits sit in `bench/limits/<cell>.json`. Nothing here knows
any cell, configuration, traffic mix or metric by name, so a later change
adds one by adding files and entries."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict                 # the configuration file's contents
    traffic: dict                # the traffic file's contents
    limits: Dict[str, float]     # each compared number's limit
    update_tolerance: float      # harness.check's update_leaves_off tolerance
    end_to_end: List[dict]       # the metrics this cell reports with --trace 0
    per_layer: List[dict]        # ... and with --trace 1
    chips: int


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The workload `name` of BENCHMARK.json with its files read."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "bench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "bench" / "limits" / f"{name}.json") as f:
        lim = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)
                 and any(e["name"] == m["moves"] for e in e2e)]
    return Cell(name, config, traffic, lim["limits"], lim["update_tolerance"], e2e, per_layer,
                int(w["chips"]))


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The module whose read(ctx) gives the metric's value or None:
    bench/metrics/<metric>.py, else bench/metrics/<base>.py for a metric
    named <base>.<variant>. A metric with neither is an error."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    if not path.exists():
        path = root / "bench" / "metrics" / f"{metric.split('.', 1)[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader of the metric {metric!r} under bench/metrics/")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(metric: str, ctx, root: Path = ROOT) -> Optional[float]:
    return reader(metric, root).read(ctx)
