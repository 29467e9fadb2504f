"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration, its traffic, its limits and the metrics it reports."""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> Dict:
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Optional[Dict]
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)

    def metrics(self, trace: bool) -> List[Dict]:
        """The metrics this cell reports: end-to-end ones untraced,
        per-layer ones traced; a metric without a ``workloads`` list is
        reported in every cell that reports what it moves."""
        if not trace:
            return [m for m in self.end_to_end
                    if self.name in m.get("workloads", [self.name])]
        e2e = {m["name"] for m in self.metrics(False)}
        return [m for m in self.per_layer
                if self.name in m.get("workloads", [self.name])
                and ("workloads" in m or m["moves"] in e2e)]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root / config["file"]) as f:
        cfg = json.load(f)
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() \
        else None
    return Cell(name, int(entry["chips"]), cfg,
                load_json("traffic", entry["traffic"]), limits,
                bench["end_to_end"], bench["per_layer"])


def reader(metric: str):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    mod = importlib.import_module(f"bench.metrics.{metric.replace('.', '_').replace('-', '_')}")
    return mod.read
