"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
ctypes wrappers with launch counters, and the plain PyTorch version of
each (``PLAIN_OPS``); ``mode_ops`` picks the GSR step's namespace for
``core.mm_mode.MODE`` (the ``*_BF16`` ones under ``FCSR_MM_MODE=bf16``)."""

from fcsr_tpu_torch.kernels.ops import (KERNEL_OPS, KERNEL_OPS_BF16, KERNELS,
                                        PLAIN_OPS, PLAIN_OPS_BF16,
                                        launch_counts, mode_ops,
                                        reset_launch_counts)

__all__ = ["KERNEL_OPS", "KERNEL_OPS_BF16", "KERNELS", "PLAIN_OPS",
           "PLAIN_OPS_BF16", "launch_counts", "mode_ops",
           "reset_launch_counts"]
