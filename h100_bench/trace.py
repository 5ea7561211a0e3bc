"""A profiled slice and its reduction: the device's busy time, idle share
and kernel count, its operations by time, and the idle gaps by what the
host was doing. Read from ``torch.profiler``'s CPU and CUDA activity
(CUPTI): device intervals are the kernels, copies and fills the trace
shows inside the slice, merged where they overlap. The profiler's own
buffer flushes stall the host, and the card idles behind them: idle time
under them is tracing's cost, not the program's, and leaves the window
(``profiler_s`` says how much)."""

from __future__ import annotations

import bisect

import torch

__all__ = ["profile", "reduce"]

MARK = "h100_bench.slice"
# host spans of the profiler itself (Kineto's overhead activities)
OVERHEAD = ("Buffer Flush", "Activity Buffer Request")


def profile(fn):
    """Run ``fn()`` under the profiler, bracketed by a host span; returns
    the profiler."""
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(MARK):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return prof


def _is_device(ev):
    """A kernel, copy or fill on the card (not a host span's mirror on
    the device's timeline)."""
    return ev.device_type == torch.autograd.DeviceType.CUDA and not (
        getattr(ev, "is_user_annotation", False) or ev.name == MARK)


def _merge(spans):
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _cut(intervals, spans):
    """Each interval's overlap with the merged, sorted ``spans``."""
    starts = [a for a, _ in spans]
    out = []
    for s, e in intervals:
        j, c = max(bisect.bisect_right(starts, s) - 1, 0), 0
        while j < len(spans) and spans[j][0] < e:
            c += max(0, min(e, spans[j][1]) - max(s, spans[j][0]))
            j += 1
        out.append(c)
    return out


def reduce(prof, top=10):
    """{window_s, busy_s, profiler_s, kernels, device_ops, idle_gaps} of
    the slice, or None where the trace holds no device activity."""
    events = list(prof.events())
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    marks = [e for e in host if e.name == MARK]
    if not marks:
        return None
    t0, t1 = marks[0].time_range.start, marks[0].time_range.end
    dev = [e for e in events if _is_device(e)
           and e.time_range.end > t0 and e.time_range.start < t1]
    if not dev:
        return None
    merged = _merge((max(e.time_range.start, t0), min(e.time_range.end, t1))
                    for e in dev)
    busy = sum(e - s for s, e in merged)
    flush = _merge((max(e.time_range.start, t0), min(e.time_range.end, t1))
                   for e in host if e.name in OVERHEAD
                   and e.time_range.end > t0 and e.time_range.start < t1)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [t0] + [x for s, e in merged for x in (s, e)] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    cut = _cut(idle, flush)
    gaps = sorted(((e - s - c, s, e) for (s, e), c in zip(idle, cut)
                   if e - s - c > 0), reverse=True)[:top]
    host = [e for e in host if e.name != MARK and e.name not in OVERHEAD]
    labelled = [[_host_label(host, s, e), d * 1e-6] for d, s, e in gaps]
    kernels = sum(1 for e in dev if not e.name.startswith(("Memcpy",
                                                           "Memset")))
    return {"window_s": (t1 - t0 - sum(cut)) * 1e-6, "busy_s": busy * 1e-6,
            "profiler_s": sum(cut) * 1e-6, "kernels": kernels,
            "device_ops": [[n, v * 1e-6] for n, v in ops],
            "idle_gaps": labelled}


def _host_label(host, start, end):
    """The innermost host span that covers most of [start, end)."""
    best, best_key = "host", None
    for e in host:
        s, t = e.time_range.start, e.time_range.end
        cover = min(t, end) - max(s, start)
        if cover <= 0:
            continue
        key = (cover, -(t - s))
        if best_key is None or key > best_key:
            best, best_key = e.name, key
    return best
