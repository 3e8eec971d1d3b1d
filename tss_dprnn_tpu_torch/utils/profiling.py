"""Profiling hooks (counterpart of ``tss_dprnn_tpu/utils/profiling.py``):
``torch.profiler`` traces and per-step timing.

Set ``profile_dir`` in the train config (the trainer traces epoch 1's train
loop) or call :func:`trace` directly; each process writes one Chrome trace,
``<log_dir>/rank<r>.pt.trace.json``, which Perfetto or ``chrome://tracing``
opens. On the card the trace holds the CUDA kernels (CUPTI) beside the host
ops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch


def trace_path(log_dir: str) -> str:
    """This process's trace file in ``log_dir``."""
    from tss_dprnn_tpu_torch.parallel import process_index

    return os.path.join(log_dir, f"rank{process_index()}.pt.trace.json")


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """A ``torch.profiler`` trace over the with-block, CPU activities and,
    with a card, CUDA ones, written to :func:`trace_path` at its end; a
    no-op (yielding None) when ``log_dir`` is empty."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(trace_path(log_dir))


class StepTimer:
    """Rolling per-step wall-clock times (ms); ``stop(device)`` waits for a
    CUDA device's queue first, so a step's time includes its kernels."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, device: Optional[torch.device] = None) -> float:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self.times) / max(len(self.times), 1)
