"""Device time of CUDA work with no host gaps between launches."""

from __future__ import annotations

import statistics
from typing import Callable, List, Sequence

import torch

__all__ = ["graph_ms"]


def graph_ms(fns: Sequence[Callable[[], object]], reps: int = 20,
             rounds: int = 5) -> List[float]:
    """Mean device ms per call of each of ``fns``: ``reps`` calls captured
    into one CUDA graph per function, the graphs replayed in turns (one
    round of each, ``rounds`` times), timed by CUDA events; the median
    over the rounds."""
    graphs = []
    for fn in fns:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graphs.append(graph)
    for graph in graphs:
        for _ in range(3):
            graph.replay()
    times: List[List[float]] = [[] for _ in fns]
    for _ in range(rounds):
        for graph, t in zip(graphs, times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                graph.replay()
            b.record()
            b.synchronize()
            t.append(a.elapsed_time(b) / (5 * reps))
    return [statistics.median(t) for t in times]
