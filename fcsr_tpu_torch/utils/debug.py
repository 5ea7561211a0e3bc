"""Debug utilities. Counterpart of ``fcsr_tpu/utils/debug.py``.

The reference has no sanitizers (SURVEY §5); the PyTorch equivalents of
the JAX package's two scopes:

  * ``nan_debug()`` — scoped ``torch.autograd.set_detect_anomaly(True,
    check_nan=True)`` (the counterpart of ``jax_debug_nans``): a backward
    function that returns NaN raises, with the traceback of the forward
    op that made it.
  * ``eager_debug()`` — the counterpart of ``jax_disable_jit``: an error
    shows at the op that caused it. Inside the scope every hand-written
    kernel launch (``kernels/ops.py::Kernel``) is followed by a
    synchronize, and an asynchronous CUDA error raises at that launch,
    naming the kernel. Launch counts are unchanged.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["nan_debug", "eager_debug"]


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


@contextlib.contextmanager
def eager_debug(enable: bool = True):
    from fcsr_tpu_torch.kernels import ops

    old = ops.SYNC_EACH_LAUNCH
    ops.SYNC_EACH_LAUNCH = enable
    try:
        yield
    finally:
        ops.SYNC_EACH_LAUNCH = old
