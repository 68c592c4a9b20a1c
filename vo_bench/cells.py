"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py`` and
``stages/<stage>.py`` (:func:`vo_bench.judge.stage_files`) under this
folder. Adding a configuration, a traffic mix, a cell, a per-layer metric
or a stage of the comparison that decides ``correct`` adds files here and
entries in ``BENCHMARK.json`` (a stage: its file, and its limits in the
cells' files); nothing else changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    spec: dict  # workloads/<cell>.json: samples and limits of the comparison
    end_to_end: list  # BENCHMARK.json's end-to-end entries this cell reports
    per_layer: list  # BENCHMARK.json's per-layer entries this cell reports


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(cell: str, bench_file: Path = ROOT / "BENCHMARK.json", here: Path = HERE) -> Cell:
    """The cell named ``cell`` with its files; raises ``KeyError`` for a name
    ``BENCHMARK.json`` does not list."""
    bench = _load(bench_file)
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json lists no workload {cell!r}")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=cell,
        chips=int(entry["chips"]),
        config=_load(bench_file.parent / cfg["file"]),
        traffic=_load(here / "traffic" / f"{entry['traffic']}.json"),
        spec=_load(here / "workloads" / f"{cell}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, cell)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, cell)],
    )


def metric_reader(name: str, here: Path = HERE):
    """The module ``metrics/<name>.py``: ``read(data) -> float | None``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vo_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
