"""A cell as the harness runs it, found by name: its entry in
``BENCHMARK.json``, the configuration's file, the traffic mix's file
(``traffic/<traffic>.json``), the workload's file (``workloads/<cell>.json``:
the recipe the program applies, and the limits of its check) and the metrics it
reports.  Nothing here names a cell, a configuration or a metric: a later
change adds them as files and entries."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
JOBS = ("serve", "recover")


@dataclass
class Cell:
    name: str
    config: dict                  # the configuration's file: family, model sizes, source
    traffic: dict                 # the mix: job, batch, image size, pool, depth, ...
    workload: dict                # the recipe and the check's limits
    end_to_end: List[dict]        # BENCHMARK.json's entries this cell reports
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)  # per-layer name -> read(ctx)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or else every
    cell (an end-to-end metric, ``e2e_names`` None) or every cell that reports
    the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: dict = None, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    if traffic["job"] not in JOBS:
        raise SystemExit(f"{name}: unknown job {traffic['job']!r}")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, e2e_names)]
    readers = {m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                      f"metric_{m['name'].replace('.', '_')}").read
               for m in per_layer}
    return Cell(name, config, traffic, workload, e2e, per_layer, readers)
