"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the model configuration as it is run;
- ``families/<family>.py``, named by the configuration's ``"family"``: the
  family's requests, its program entries and collates, and its reference
  forward and loss;
- ``flops/<flops>.py``, named by the configuration's ``"flops"``:
  operation and byte counts;
- ``traffic/<traffic>.json``: the traffic mix, parameters of a loop;
- ``loops/<loop>.py``, named by the mix's ``"loop"``: the loop (``Loop``)
  that drives the program with that traffic;
- ``checks/<cell>.json``: the limit of each number the correctness check
  compares, with the readings it was set from;
- ``metrics/<metric>.py``, or ``metrics/<name before the first dot>.py``:
  the metric's reader, ``read(ctx) -> float or None``.
A cell, configuration, family, traffic mix, loop or metric is added by
adding its files and its entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.parent.name + "_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    def __init__(self, bench_json: Optional[Path] = None, bench_dir: Path = BENCH_DIR):
        self.dir = Path(bench_dir)
        self.root = Path(bench_json).parent if bench_json else ROOT  # paths are relative to it
        self.spec = _json(self.root / "BENCHMARK.json" if bench_json is None else Path(bench_json))
        self._modules: Dict[Path, ModuleType] = {}

    def _load(self, path: Path) -> ModuleType:
        if path not in self._modules:
            self._modules[path] = _module(path)
        return self._modules[path]

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        path = self.dir / "checks" / f"{cell}.json"
        return {k: float(v["limit"]) for k, v in _json(path)["limits"].items()}

    def peaks(self) -> dict:
        return _json(self.dir / "lib" / "peaks.json")

    def flops(self, name: str) -> ModuleType:
        return self._load(self.dir / "flops" / f"{name}.py")

    def family(self, name: str) -> ModuleType:
        return self._load(self.dir / "families" / f"{name}.py")

    def loop(self, name: str) -> ModuleType:
        return self._load(self.dir / "loops" / f"{name}.py")

    def reader(self, metric: str) -> ModuleType:
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{metric.split('.')[0]}.py"
        return self._load(path)

    def metrics_of(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
        that list it, and those that list no cells (a per-layer metric of
        that kind only where the cell reports the metric it moves)."""
        if kind == "end_to_end":
            return [m for m in self.spec["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        e2e = {m["name"] for m in self.metrics_of(cell, "end_to_end")}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell]) and m["moves"] in e2e]
