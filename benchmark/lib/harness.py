"""One run of one cell: set-up, the measured window, the correctness check
and the result line.

``run_cell`` takes the device it is given; ``run.py`` gives it the card and
refuses to run without one. The tests give it the CPU, tiny widths and
faults of their own (``patch``).
"""

from __future__ import annotations

import json
import math
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

from benchmark.lib.registry import Registry

# top-level module names a run may not load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "tss_dprnn_tpu")


class Context:
    """What a metric reader reads: the cell, its configuration and traffic,
    the window's numbers (``stats``), the peaks, and in a traced run the
    trace (``trace``) over the stretch of ``stretch_s`` seconds that
    profiled the units ``units``."""

    def __init__(self, cell: str, config: dict, traffic: dict, stats: dict, peaks: dict,
                 stretch=None):
        self.cell, self.config, self.traffic, self.stats, self.peaks = (
            cell, config, traffic, stats, peaks)
        self.trace = None if stretch is None else stretch.trace
        self.stretch_s = 0.0 if stretch is None else stretch.seconds
        self.units: List[int] = [] if stretch is None else list(stretch.units)

    @property
    def profiled(self) -> List[dict]:
        """The records of the units the traced stretch covered."""
        records = self.stats.get("records", [])
        return [records[i] for i in self.units if i < len(records)]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def make_loop(registry: Registry, config: dict, traffic: dict, seed: int,
              device: torch.device, scratch: str):
    """The traffic's loop (``loops/<loop>.py``) over the configuration's
    family (``families/<family>.py``) and operation counts."""
    return registry.loop(traffic["loop"]).Loop(
        config, traffic, seed, device, scratch, registry.family(config["family"]),
        registry.flops(config["flops"]), registry.peaks())


def run_cell(registry: Registry, cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float, patch: Optional[Callable] = None,
             override: Optional[Callable[[dict, dict], None]] = None) -> dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced,
    ``notes``: the check's readings that no limit compares, and ``checks``
    last: each reading the cell's limits name, beside its limit). ``override(config, traffic)`` may change either in
    place (the tests' tiny sizes)."""
    cell = registry.cell(cell_name)
    config, traffic = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    if override is not None:
        override(config, traffic)
    peaks = registry.peaks()
    with tempfile.TemporaryDirectory(prefix="bench-") as scratch:
        loop = make_loop(registry, config, traffic, seed, device, scratch)
        loop.setup(trace, patch)
        setup_s = time.perf_counter() - started

        stretch = None
        if trace:
            from benchmark.lib.trace import Stretch
            stretch = Stretch(traffic["trace"]["start"], traffic["trace"]["units"], device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        stats = loop.window(seconds, stretch)
        if stretch is not None:
            stretch.close()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        stats.update(setup_s=setup_s, memory_peak_bytes=peak,
                     setup_phases=_phases(started, loop.phases))
        loop.free()
        checks = loop.check()
    _wait_for_threads()

    limits = registry.limits(cell_name)
    compared = {k: {"value": checks.get(k), "limit": lim} for k, lim in limits.items()}
    correct = all(c["value"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in compared.values())  # none missing
    notes = {k: v for k, v in checks.items() if k not in limits}

    ctx = Context(cell_name, config, traffic, stats, peaks, stretch)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(cell_name, kind):
        value = registry.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": stats["attempted"], "failed": stats["failed"],
              "metrics": metrics, "device": {"count": 1, "memory_peak_bytes": peak}}
    if stretch is not None and ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.stretch_s)
        result["breakdown"] = {"device_ops": ctx.trace.top_kernels(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["notes"] = notes
    result["checks"] = compared
    result["setup_phases"] = stats["setup_phases"]
    return result


def _phases(started: float, stamps: dict) -> dict:
    """Seconds of each set-up phase: from the process's start to the
    loop's, then each stamp from the one before."""
    out, last = {}, started
    for name, t in stamps.items():
        out["before_loop" if name == "start" else name] = t - last
        last = t
    return out


def result_line(result: dict, device: dict) -> Tuple[str, List[str]]:
    """The run's last line of standard output (the result with the card's
    ``device`` fields, ``checks`` last) and its last lines of standard
    error (the readings no limit compares, then each number compared beside
    its limit)."""
    result = dict(result)
    result.pop("setup_phases", None)
    checks = result.pop("checks")
    result["device"] = dict(device, **result["device"])
    result["checks"] = checks
    err = [f"reading {name} {v!r}" for name, v in result.get("notes", {}).items()]
    err += [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    return json.dumps(result), err


def _wait_for_threads(timeout: float = 5.0) -> None:
    """Wait for the training loader's prefetch thread (Python names it after
    its function, ``worker``), which ends once its consumer has closed."""
    deadline = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name.endswith("(worker)"):
            t.join(max(0.0, deadline - time.monotonic()))
