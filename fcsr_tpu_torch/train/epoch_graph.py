"""A trainer's epoch (or validation pass) as one CUDA graph.

Counterpart of the JAX fast loops' chunk programs
(``fcsr_tpu/train/fast_loop.py:193-268``, ``fcsr_tpu/train/gat_loop.py:
499-541``): where XLA compiles a ``lax.scan`` over an epoch's steps into
one device program, the port records the same kernels' launches once into
a CUDA graph over static buffers and replays it once per epoch, so the
host pays one replay an epoch instead of a wrapper call per launch.

The program runs once on scratch copies of its buffers on the capture's
own stream first (the lazy set-up: libraries, plans, cached constants,
cuBLAS and autograd state), then is captured on that stream over the live
buffers. Neither advances the live state: the warm-up writes the scratch
copies, and a capture launches nothing. Both leave the kernels' launch
counts as they were; each replay adds the launches the capture recorded
(``kernels/ops.py::recorded_launches``), so ``launch_counts()`` reads a
replayed epoch as the launches it makes.

There is no fallback: a capture that fails raises, naming its program,
and a capture under ``utils/debug.py::eager_debug`` (a synchronize after
every launch, which a capture forbids) is refused before it starts.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from fcsr_tpu_torch.kernels import ops

__all__ = ["EpochGraph", "upload"]


class EpochGraph:
    """``program()`` captured as one CUDA graph on ``device``, after one
    ``warm()`` on the same stream; ``what`` names it in errors.
    ``launches`` holds the launches of one replay, ``warm_s``,
    ``capture_s`` and ``instantiate_s`` the host seconds of the warm-up
    (to its end on the device), the capture and the instantiation."""

    def __init__(self, what: str, device, program: Callable[[], object],
                 warm: Callable[[], object]):
        if ops.SYNC_EACH_LAUNCH:
            raise RuntimeError(
                f"{what}: eager_debug() synchronises after every kernel "
                "launch, which a CUDA graph capture forbids; the trainers "
                "capture their epochs on the card, so train outside "
                "eager_debug() (the kernels' own checks run there too)")
        self.what = what
        self.device = torch.device(device)
        stream = torch.cuda.Stream(self.device)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with ops.recorded_launches():
                t0 = time.perf_counter()
                stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(stream):
                    warm()
                stream.synchronize()
                t1 = time.perf_counter()
                with ops.recorded_launches() as made:
                    with torch.cuda.graph(self.graph, stream=stream):
                        program()
                        t2 = time.perf_counter()
                t3 = time.perf_counter()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {what} failed: "
                               f"{e}") from e
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


def upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Copy the host array ``src`` into ``dst`` (a program's static input)
    without waiting on the device: on the card through pinned memory,
    which the copy holds until it has run."""
    host = torch.from_numpy(src)
    if dst.is_cuda:
        host = host.pin_memory()
    dst.copy_(host, non_blocking=True)
