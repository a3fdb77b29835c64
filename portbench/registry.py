"""Finds what ``BENCHMARK.json`` names, by name, in files of its own:

- a configuration: ``configs/<config>.json`` (the file that the entry's
  ``file`` names), with ``model``, ``train`` and ``dataset`` sections;
- a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the
  general runner ``kinds/<kind>.py`` that reads its parameters;
- a cell's correctness limits and sample sizes: ``workloads/<cell>.json``;
- a per-layer metric's reader: ``metrics/<metric>.py``, whose
  ``read(ctx)`` returns the metric's value or None.

A later configuration, traffic mix, cell or metric is a new file and a new
entry; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from typing import Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config_path: pathlib.Path
    config: dict
    traffic: dict
    workload: dict  # limits and sample sizes
    chips: int
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: pathlib.Path, name: str, bench_dir: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its traffic and
    limits found under ``bench_dir``; raises KeyError or FileNotFoundError
    naming what is missing."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[entry["config"]]
    config_path = root / config_entry["file"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    return Cell(name=name, config_path=config_path, config=load_json(config_path),
                traffic=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
                workload=load_json(bench_dir / "workloads" / f"{name}.json"),
                chips=int(entry["chips"]), end_to_end=e2e, per_layer=per_layer)


def kind_module(kind: str):
    """The runner of a traffic kind: ``portbench.kinds.<kind>``."""
    return importlib.import_module(f"portbench.kinds.{kind}")


def metric_reader(name: str, bench_dir: pathlib.Path = HERE):
    """``read`` of ``metrics/<name>.py``, loaded from its file (a metric's
    name may hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_per_layer(metrics: List[dict], ctx: Dict,
                   bench_dir: pathlib.Path = HERE) -> Dict[str, Optional[float]]:
    """Each per-layer metric's value from its reader; a reader that finds
    nothing to read gives None, and the metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], bench_dir)(ctx)
        if value is not None:
            out[m["name"]] = float(value)
    return out
