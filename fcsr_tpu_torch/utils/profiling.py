"""Spans and counters of the port's CV runs, and optional ``torch.profiler``
traces. Counterpart of ``fcsr_tpu/utils/profiling.py``.

The reference has no profiling beyond ad-hoc ``time.time`` around CSV loads
(ref: utils/data.py:57-61). Here one recorder, ``PhaseTimer``, times named
phases on the host's clock. A pipeline entry opens a run (``cv_run``): a
``PhaseTimer`` held in a context variable, whose root span is ``cv_run``.
Inside it, the module-level ``span(name)`` (and ``phase(name)``, ``count``
and ``epoch_clock``) charge that run wherever the code sits, in the
pipeline or deep in a trainer loop; outside a run they do nothing but read
the variable (and ask whether a profiler records). Each span keeps its
name, start, end (``time.perf_counter``) and parent, by nesting.

On the card a ``phase`` span also records a pair of timing events on the
run's device, and an ``epoch_clock`` an event on each device's stream at
every epoch boundary. Nothing here waits for the device: an event pair is
resolved when the run's record is read (``recent_runs()``), after the run
has read its results back; a phase then counts the larger of its host
seconds and its events' (a phase may return with its work still queued),
an epoch its events' (on several devices the slowest one's).

Whenever a ``torch.profiler`` records, every span also opens a
``record_function("fcsr.<name>")`` range, inside a run or not, so the
spans sit in the trace on the profiler's own clock, around the ops and
kernels they launched. ``trace_if_enabled`` writes such a trace
(``FCSR_TRACE_DIR``); the CLI's ``train`` and ``predict`` commands run
under it.

A finished run's record (``recent_runs()``, the last ``RECENT_RUNS``):
``run`` (its id), ``entry``, ``spans`` ({name, parent, start, end,
seconds}, parent an index into the list), ``phases`` (seconds by name,
summed over a name's spans), ``counters`` and ``epoch_s`` (each epoch's
device seconds, in order).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import time
from typing import Dict, List, Optional

import torch

__all__ = ["PhaseTimer", "trace_if_enabled", "cv_run", "span", "phase",
           "count", "epoch_clock", "recent_runs", "RECENT_RUNS"]

RECENT_RUNS = 64        # finished runs whose records recent_runs() keeps

_RUN: contextvars.ContextVar = contextvars.ContextVar("fcsr_run",
                                                      default=None)
_RECENT = collections.deque(maxlen=RECENT_RUNS)
_IDS = itertools.count(1)
_NOTHING = contextlib.nullcontext()


def _profiler_records() -> bool:
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


def _elapsed_s(start, end) -> float:
    """Seconds between two recorded events; waits for ``end`` only where
    it has not run yet (a record read before its run's work has ended)."""
    if not end.query():
        end.synchronize()
    return start.elapsed_time(end) * 1e-3


class PhaseTimer:
    """Accumulating named-phase timer (host clock).

    >>> t = PhaseTimer()
    >>> with t("train"):
    ...     ...
    >>> t.report()
    {'train': ...}

    Each ``with t(name)`` is a span: its name, start, end and parent (the
    span open around it) are kept in ``spans``. With ``device`` a CUDA
    device, ``t(name, events=True)`` also records a pair of timing events
    on that device's current stream, resolved only when read
    (``record``)."""

    def __init__(self, device=None):
        self.totals: Dict[str, float] = {}
        self.spans: list = []          # [name, parent, start, end, events]
        self.counters: Dict[str, int] = {}
        self.chunks: list = []         # EpochClock events, or their seconds
        self._open: List[int] = []
        self._device = None
        if device is not None and torch.device(device).type == "cuda":
            self._device = torch.device(device)

    @contextlib.contextmanager
    def __call__(self, name: str, events: bool = False):
        rec = [name, self._open[-1] if self._open else None, 0.0, None,
               None]
        self._open.append(len(self.spans))
        self.spans.append(rec)
        ranged = None
        if _profiler_records():
            ranged = torch.profiler.record_function(f"fcsr.{name}")
            ranged.__enter__()
        pair = None
        if events and self._device is not None:
            pair = (_timing_event(), _timing_event())
            pair[0].record(torch.cuda.current_stream(self._device))
        rec[2] = time.perf_counter()
        try:
            yield
        finally:
            rec[3] = time.perf_counter()
            if pair is not None:
                pair[1].record(torch.cuda.current_stream(self._device))
                rec[4] = pair
            if ranged is not None:
                ranged.__exit__(None, None, None)
            self._open.pop()
            self.totals[name] = self.totals.get(name, 0.0) + rec[3] - rec[2]

    def report(self) -> Dict[str, float]:
        """Host seconds by name, summed over the name's spans."""
        return dict(self.totals)

    def record(self) -> dict:
        """``spans``, ``phases``, ``counters`` and ``epoch_s``, every event
        pair resolved (see the module's docstring)."""
        spans, phases = [], {}
        for name, parent, start, end, pair in self.spans:
            sec = end - start
            if pair is not None:
                sec = max(sec, _elapsed_s(*pair))
            spans.append({"name": name, "parent": parent, "start": start,
                          "end": end, "seconds": sec})
            phases[name] = phases.get(name, 0.0) + sec
        epoch_s = []
        for chunk in self.chunks:
            epoch_s.extend(chunk if isinstance(chunk, list)
                           else _epoch_seconds(chunk))
        return {"spans": spans, "phases": phases,
                "counters": dict(self.counters), "epoch_s": epoch_s}


class _Run:
    """A finished run: its timer, resolved into a record at the first
    read."""

    def __init__(self, entry: str, timer: PhaseTimer):
        self.id, self.entry, self._timer = next(_IDS), entry, timer
        self._record = None

    def record(self) -> dict:
        if self._record is None:
            self._record = {"run": self.id, "entry": self.entry,
                            **self._timer.record()}
            self._timer = None
        return self._record


@contextlib.contextmanager
def cv_run(entry: str, device=None):
    """Open a run of the pipeline entry ``entry``: a fresh ``PhaseTimer``
    (yielded) that ``span``, ``phase``, ``count`` and ``epoch_clock``
    charge until the block ends, inside the root span ``cv_run`` (a phase:
    with events on a CUDA ``device``). A run that ends without an
    exception is kept for ``recent_runs()``."""
    timer = PhaseTimer(device)
    token = _RUN.set(timer)
    try:
        with timer("cv_run", events=True):
            yield timer
    finally:
        _RUN.reset(token)
    _RECENT.append(_Run(entry, timer))


def span(name: str):
    """A span of the run in progress (host clock only); outside a run
    nothing, or only the profiler's range where a profiler records."""
    timer = _RUN.get()
    if timer is not None:
        return timer(name)
    if _profiler_records():
        return torch.profiler.record_function(f"fcsr.{name}")
    return _NOTHING


def phase(name: str):
    """A span that also records a pair of timing events on the run's
    device, where that is a card: a pipeline's phase, whose work may still
    be queued when the host leaves it."""
    timer = _RUN.get()
    if timer is not None:
        return timer(name, events=True)
    return span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the run's counter ``name`` (outside a run nothing)."""
    timer = _RUN.get()
    if timer is not None:
        timer.counters[name] = timer.counters.get(name, 0) + int(n)


class EpochClock:
    """A timing event at each epoch boundary of one chunk of epochs, on the
    current stream of each of ``devices``: ``mark()`` before the first
    epoch and after each one (E + 1 marks a chunk), ``close()`` once the
    host has read back what the chunk's last epoch wrote, so that every
    event has run. A chunk whose last events have not run by then (none
    should) is resolved when the run's record is read."""

    def __init__(self, timer: PhaseTimer, devices):
        self._timer = timer
        self._devices = list(dict.fromkeys(devices))
        self.events: List[list] = [[] for _ in self._devices]

    def mark(self) -> None:
        for dev, marks in zip(self._devices, self.events):
            ev = _timing_event()
            ev.record(torch.cuda.current_stream(dev))
            marks.append(ev)

    def close(self) -> None:
        if all(marks[-1].query() for marks in self.events if marks):
            self._timer.chunks.append(_epoch_seconds(self.events))
        else:
            self._timer.chunks.append(self.events)


class _NoClock:
    def mark(self) -> None:
        pass

    def close(self) -> None:
        pass


_NO_CLOCK = _NoClock()


def _epoch_seconds(events) -> List[float]:
    """Each epoch's seconds between consecutive marks, the slowest
    device's."""
    per = [[_elapsed_s(a, b) for a, b in zip(marks, marks[1:])]
           for marks in events]
    return [max(x) for x in zip(*per)]


def epoch_clock(devices):
    """An ``EpochClock`` of the run in progress over ``devices``; outside a
    run, or off the card, one that records nothing."""
    timer = _RUN.get()
    devices = [torch.device(d) for d in devices]
    if timer is None or not devices or any(d.type != "cuda"
                                           for d in devices):
        return _NO_CLOCK
    return EpochClock(timer, devices)


def recent_runs() -> List[dict]:
    """The records of the last ``RECENT_RUNS`` finished runs, oldest
    first."""
    return [run.record() for run in _RECENT]


@contextlib.contextmanager
def trace_if_enabled(out_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a card is visible), written as a Chrome trace
    ``<out_dir>/fcsr_<pid>_<ns>.pt.trace.json``; gated on ``out_dir`` or
    ``FCSR_TRACE_DIR``, a no-op otherwise. The spans of the block appear
    in it as ``fcsr.<name>`` ranges."""
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
