"""A trainer's epoch (or validation pass) as one CUDA graph.

Counterpart of the JAX package's compiled training programs
(``fcsr_tpu/train/fast_loop.py:193-268``, ``fcsr_tpu/train/gat_loop.py:
408-541``, ``fcsr_tpu/train/generic_loop.py:116-245``,
``fcsr_tpu/train/gsr_loop.py:179-216``): where XLA compiles a
``lax.scan`` over an epoch's steps into one device program, the port
records the same launches once into a CUDA graph over static buffers and
replays it once per epoch, so the host pays one replay an epoch instead of
a wrapper call per launch.

The program runs once on the capture's own stream first (the lazy set-up:
libraries, plans, cached constants, cuBLAS and autograd state), then is
captured on that stream over the live buffers. Neither advances the live
state: the warm-up writes scratch copies (or, where a copy does not fit,
runs every step masked), a capture launches nothing, and the generators
the program draws dropout from are set back to where they stood before
the warm-up, then registered with the graph, so that each replay draws
what the eager epoch draws from their state and leaves them where the
eager epoch leaves them. Both leave the kernels' launch counts as they
were; each replay adds the launches the capture recorded
(``kernels/ops.py::recorded_launches``), so ``launch_counts()`` reads a
replayed epoch as the launches it makes. In a run (``utils/profiling.py``)
the capture is the span ``capture`` (``capture.warm``, ``capture.record``,
``capture.instantiate``).

There is no fallback: a capture that fails raises, naming its program,
and a capture under ``utils/debug.py::eager_debug`` (a synchronize after
every launch, which a capture forbids) is refused before it starts.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable

import numpy as np
import torch

from fcsr_tpu_torch.kernels import ops
from fcsr_tpu_torch.utils import profiling

__all__ = ["EpochGraph", "upload", "warm_up"]


class EpochGraph:
    """``program()`` captured as one CUDA graph on ``device``, after one
    ``warm()`` on the same stream; ``what`` names it in errors. The
    ``generators`` the two draw from are set back after the warm-up and
    registered with the graph; ``pool`` (another graph's ``pool()``) shares
    that graph's memory, for programs that replay one after the other.
    ``launches`` holds the kernels' launches of one replay, ``nodes`` the
    graph's nodes (every launch of the epoch, the library's included),
    ``warm_s``, ``capture_s`` and ``instantiate_s`` the host seconds of
    the warm-up (to its end on the device), the capture and the
    instantiation."""

    def __init__(self, what: str, device, program: Callable[[], object],
                 warm: Callable[[], object], generators=(), pool=None):
        if ops.SYNC_EACH_LAUNCH:
            raise RuntimeError(
                f"{what}: eager_debug() synchronises after every kernel "
                "launch, which a CUDA graph capture forbids; the trainers "
                "capture their epochs on the card, so train outside "
                "eager_debug() (the kernels' own checks run there too)")
        self.what = what
        self.device = torch.device(device)
        gens = [g for g in generators if g is not None]
        states = [g.get_state() for g in gens]
        stream = torch.cuda.Stream(self.device)
        # kept after the capture so that its nodes can be counted
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with ops.recorded_launches(), profiling.span("capture"):
                t0 = time.perf_counter()
                with profiling.span("capture.warm"):
                    stream.wait_stream(
                        torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(stream):
                        warm_up(warm, gens)
                    stream.synchronize()
                    # the warm-up's temporaries go back to the card before
                    # the capture takes its own pool (the MLP v1 state
                    # leaves no room for both)
                    torch.cuda.empty_cache()
                    for g in gens:
                        self.graph.register_generator_state(g)
                t1 = time.perf_counter()
                with profiling.span("capture.record"), \
                        ops.recorded_launches() as made:
                    with torch.cuda.graph(self.graph, pool=pool,
                                          stream=stream):
                        program()
                t2 = time.perf_counter()
                self.nodes = _node_count(self.graph)
                with profiling.span("capture.instantiate"):
                    self.graph.instantiate()
                t3 = time.perf_counter()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {what} failed: "
                               f"{e}") from e
        finally:
            _set_states(gens, states)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.launches = made
        self.warm_s, self.capture_s, self.instantiate_s = \
            t1 - t0, t2 - t1, t3 - t2

    def replay(self) -> None:
        """Launch the graph on the current stream (of its device: call under
        ``on_device``) and count its launches."""
        self.graph.replay()
        ops.add_launches(self.launches)

    def release(self) -> None:
        """Free the graph and its memory pool; it does not replay again."""
        self.graph.reset()


def warm_up(warm: Callable[[], object], generators=()) -> None:
    """``warm()``, then the ``generators`` set back to where they stood
    before it: a capture's warm-up takes none of the draws its replays
    make."""
    states = [g.get_state() for g in generators]
    try:
        warm()
    finally:
        _set_states(generators, states)


def _set_states(generators, states) -> None:
    for g, state in zip(generators, states):
        g.set_state(state)


def _node_count(graph) -> int:
    """The nodes of a captured (kept) graph, by libcuda's
    ``cuGraphGetNodes``."""
    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes returned {rc}")
    return count.value


def upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Copy the host array ``src`` into ``dst`` (a program's static input)
    without waiting on the device: on the card through pinned memory,
    which the copy holds until it has run."""
    host = torch.from_numpy(src)
    if dst.is_cuda:
        host = host.pin_memory()
    dst.copy_(host, non_blocking=True)
