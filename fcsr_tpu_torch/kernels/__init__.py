"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
ctypes wrappers with launch counters, and the plain PyTorch version of
each (``PLAIN_OPS``)."""

from fcsr_tpu_torch.kernels.ops import (KERNEL_OPS, KERNELS, PLAIN_OPS,
                                        launch_counts, reset_launch_counts)

__all__ = ["KERNEL_OPS", "KERNELS", "PLAIN_OPS", "launch_counts",
           "reset_launch_counts"]
