"""Find a cell's pieces by name: its configuration, traffic mix, metric
readers and reference, each a file of its own under ``benchmark/``."""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Any, Dict, List, Mapping, NamedTuple

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    workload: Dict[str, Any]     # the BENCHMARK.json entry
    config: Dict[str, Any]       # benchmark/configs/<config>.json
    traffic: Dict[str, Any]      # benchmark/traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _load_json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: Mapping, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(by_name)}")
    w = by_name[name]
    (entry,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    return Cell(
        name=name, workload=w, config=_load_json(root / entry["file"]),
        traffic=_load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def _module(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``benchmark/metrics/<name>.py``: its ``read(run)`` returns the
    metric's value, or None where the run holds nothing to read."""
    return _module("metrics", name).read


def reference(config: Mapping):
    """``benchmark/reference/<config's reference>.py``: its ``expected``
    works out a request's outputs at given points."""
    return _module("reference", config["reference"]).expected
