"""Find a cell's configuration, traffic mix and metric readers by the names
that BENCHMARK.json gives them.

  configuration  BENCHMARK.json's "file" of the entry named by the cell
  traffic mix    benchmark/traffic/<traffic>.json
  metric reader  benchmark/metrics/<metric name>.py, with read(run)

Nothing here lists cells, mixes or metrics: a new one is a new file and a
new entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
TRAFFIC_DIR = BENCH_DIR / "traffic"
METRICS_DIR = BENCH_DIR / "metrics"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: object  # read(run) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def load_reader(name: str):
    """The `read` function of benchmark/metrics/<name>.py."""
    path = METRICS_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries, cell: str) -> list[Metric]:
    return [Metric(e["name"], e["unit"], load_reader(e["name"]))
            for e in entries if cell in e.get("workloads", [cell])]


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((TRAFFIC_DIR / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config_name=cfg["name"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=_metrics(bench["end_to_end"], workload),
                per_layer=_metrics(bench["per_layer"], workload))
