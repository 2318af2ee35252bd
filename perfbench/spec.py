"""What `BENCHMARK.json` names, found by name among the benchmark's files:
a cell's entry, its configuration (`configs/<config>.json`), its traffic
mix (`workloads/<traffic>.json`) and each per-layer metric's reader
(`metrics/<name>.py`, a module with `read(run) -> float | None`)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's line of `workloads` in BENCHMARK.json
    config: dict
    traffic: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    return Cell(
        name=name, entry=entry,
        config=load_json(here / "configs" / f"{entry['config']}.json"),
        traffic=load_json(here / "workloads" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def reader(metric: str, here: Path = HERE) -> Callable:
    """The `read` function of `metrics/<metric>.py`."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], run,
                 here: Path = HERE) -> Dict[str, dict]:
    """Each metric's reading; a reader that finds nothing to read returns
    None and the metric is left out."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
