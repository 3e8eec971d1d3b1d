"""The traced run: ranges the benchmark opens around the program's layers,
a ``torch.profiler`` window over a steady stretch of the measured window,
and the reduction of its trace to intervals.

Ranges (``torch.profiler.record_function``, opened from the benchmark's
files only):
- ``bench.rnn``: every call of the model's ``RNNCore`` modules, forward, and
  in training backward too (full backward hooks: from the gradient of the
  module's output to the gradient of its input);
- ``bench.optimizer``: the trainer's ``optimizer.step`` (clip + Adam),
  wrapped on the instance;
- ``bench.loader``: the trainer's wait in the loader's ``next()``.

A device kernel belongs to a range when the host call that launched it (the
CUDA API event of the same correlation id) ran inside the range on the same
thread. The trace is written to a temporary file, read
back and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

RNN = "bench.rnn"
OPTIMIZER = "bench.optimizer"
LOADER = "bench.loader"
WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class _Open:
    """Ranges opened in one hook and closed in another, per thread."""

    def __init__(self, name: str):
        self.name = name
        self.stacks = threading.local()

    def enter(self, *_):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self.stacks.__dict__.setdefault("s", []).append(rf)

    def exit(self, *_):
        stack = self.stacks.__dict__.get("s")
        if stack:
            stack.pop().__exit__(None, None, None)


def instrument_modules(model: torch.nn.Module, cls, backward: bool) -> List:
    """``bench.rnn`` around every forward (and, with ``backward``, backward)
    call of the modules of class ``cls``; returns the hook handles."""
    fwd, bwd = _Open(RNN), _Open(RNN)
    handles = []
    for mod in model.modules():
        if isinstance(mod, cls):
            handles.append(mod.register_forward_pre_hook(fwd.enter))
            handles.append(mod.register_forward_hook(fwd.exit))
            if backward:
                handles.append(mod.register_full_backward_pre_hook(bwd.enter))
                handles.append(mod.register_full_backward_hook(bwd.exit))
    return handles


def wrap_call(obj, attr: str, name: str) -> None:
    """``obj.attr`` called inside the range ``name`` from now on."""
    inner = getattr(obj, attr)

    def ranged(*args, **kwargs):
        with torch.profiler.record_function(name):
            return inner(*args, **kwargs)

    setattr(obj, attr, ranged)


class Stretch:
    """Profiles units ``[start, start + count)`` of a window: the loop
    calls :meth:`unit` at each unit's start (the unit's index) and
    :meth:`close` after the window. ``trace`` then holds the reduced
    trace; ``units`` the indices profiled and ``seconds`` the host clock
    over them, from a synchronised start to a synchronised end."""

    def __init__(self, start: int, count: int, device: torch.device):
        self.start, self.count, self.device = start, count, device
        self.prof: Optional[torch.profiler.profile] = None
        self.window: Optional[torch.profiler.record_function] = None
        self.t0 = 0.0
        self.seconds = 0.0
        self.units: List[int] = []
        self.trace: Optional["Trace"] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self, index: int) -> None:
        if index == self.start and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.window = torch.profiler.record_function(WINDOW)
            self.window.__enter__()
            self.t0 = time.perf_counter()
        elif index == self.start + self.count:
            self._stop()
        if self.prof is not None and self.trace is None and self.start <= index:
            if index < self.start + self.count:
                self.units.append(index)

    def _stop(self) -> None:
        if self.prof is None or self.trace is not None:
            return
        self._sync()
        self.seconds = time.perf_counter() - self.t0
        self.window.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f))
        finally:
            os.unlink(path)
        self.prof = None

    def close(self) -> None:
        """Ends the stretch if the window ended inside it."""
        self._stop()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """A Chrome trace reduced to what the readers use (times in seconds)."""

    def __init__(self, doc: dict):
        events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
        launches = {}
        ranges: Dict[str, Dict[int, List[Tuple[float, float]]]] = defaultdict(
            lambda: defaultdict(list))
        self.host: List[Tuple[float, float, str, int]] = []
        self.kernels: List[Tuple[float, float, str, int]] = []
        for e in events:
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.kernels.append((ts, ts + dur, e.get("name", ""),
                                     (e.get("args") or {}).get("correlation", -1)))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (ts, e.get("tid"))
            if cat == "user_annotation":
                ranges[e.get("name", "")][e.get("tid")].append((ts, ts + dur))
            if cat in HOST_CATS:
                self.host.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
        self._launches = launches
        self._ranges = ranges
        win = [iv for ivs in ranges.get(WINDOW, {}).values() for iv in ivs]
        self.main_tid = next(iter(ranges.get(WINDOW, {})), None)
        self.window = (min(a for a, _ in win), max(b for _, b in win)) if win else None
        self.busy_intervals = _merge([(a, b) for a, b, _, _ in self.kernels])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) * 1e-6

    def in_range(self, name: str) -> float:
        """Seconds of device time of the kernels launched inside ``name``."""
        spans = {tid: sorted(ivs) for tid, ivs in self._ranges.get(name, {}).items()}
        starts = {tid: [a for a, _ in ivs] for tid, ivs in spans.items()}
        total = 0.0
        for a, b, _, corr in self.kernels:
            ts, tid = self._launches.get(corr, (None, None))
            if tid not in spans:
                continue
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and ts <= spans[tid][i][1]:
                total += b - a
        return total * 1e-6

    def has_range(self, name: str) -> bool:
        return bool(self._ranges.get(name))

    def top_kernels(self, n: int = 10) -> List[List]:
        by_name: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.kernels:
            by_name[name] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], us * 1e-6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time inside the window, summed by the innermost
        host event of the main thread running at each gap's middle."""
        if self.window is None:
            return []
        lo, hi = self.window
        edges = [(a, b) for a, b in self.busy_intervals if b > lo and a < hi]
        gaps, at = [], lo
        for a, b in edges:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < hi:
            gaps.append((at, hi))
        main = sorted((e for e in self.host if e[3] == self.main_tid and e[2] != WINDOW),
                      key=lambda e: (e[0], -e[1]))
        by_op: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[float, float, str, int]] = []  # nested events open at the sweep
        i = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (a + b)
            while i < len(main) and main[i][0] <= mid:
                while stack and stack[-1][1] < main[i][0]:
                    stack.pop()
                stack.append(main[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            by_op[stack[-1][2] if stack else "host python"] += b - a
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], us * 1e-6] for name, us in top]
