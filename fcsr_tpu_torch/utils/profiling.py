"""Lightweight profiling: phase timers and optional ``torch.profiler``
traces. Counterpart of ``fcsr_tpu/utils/profiling.py``.

The reference has no profiling beyond ad-hoc ``time.time`` around CSV loads
(ref: utils/data.py:57-61); the port needs per-phase wall-clock and an
escape hatch into the profiler for kernel-level traces.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

__all__ = ["PhaseTimer", "trace_if_enabled"]


class PhaseTimer:
    """Accumulating named-phase wall-clock timer (host clock: work queued
    on the card inside a phase is counted only where the phase waits for
    it).

    >>> t = PhaseTimer()
    >>> with t("train"):
    ...     ...
    >>> t.report()
    {'train': ...}
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace_if_enabled(out_dir: str = None):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a card is visible), written as a Chrome trace
    ``<out_dir>/fcsr_<pid>_<ns>.pt.trace.json``; gated on ``out_dir`` or
    ``FCSR_TRACE_DIR``, a no-op otherwise."""
    out_dir = out_dir or os.environ.get("FCSR_TRACE_DIR")
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        out_dir, f"fcsr_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
