"""The data-path kernels: vectorized connectomes -> dense (normalized)
adjacency stacks and back, without a dense intermediate crossing to the
host.

Counterpart of ``fcsr_tpu/core/pallas_kernels.py``. Each function runs its
hand-written CUDA kernel (``kernels/csrc/triu.cu``) for tensors on the
card and the kernel's plain PyTorch version for tensors on the CPU; inputs
are taken as float32 (array-likes become CPU tensors).
"""

from __future__ import annotations

import numpy as np
import torch

from fcsr_tpu_torch.kernels import ops

__all__ = ["anti_vectorize_normalize", "vectorize_colmajor",
           "normalize_adj_batch"]


def _f32(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return x.to(torch.float32).contiguous()


def anti_vectorize_normalize(vectors, n: int, normalize: bool = True,
                             fill_diag: float = 0.0) -> torch.Tensor:
    """(B, V) row-major triu vectors -> (B, n, n) symmetric adjacencies,
    optionally degree-normalized in the same pass; entries beyond
    n(n-1)/2 are ignored. ``fill_diag`` (when not 0) sets the diagonal
    before normalization. Counterpart of
    ``fcsr_tpu.core.pallas_kernels.anti_vectorize_normalize``."""
    return ops.anti_vectorize_normalize(_f32(vectors), n, normalize,
                                        fill_diag)


def vectorize_colmajor(matrices) -> torch.Tensor:
    """(B, n, n) -> (B, n(n-1)/2) in the column-major order of
    ``core.vectorize.vectorize_batch`` (the submission order). Counterpart
    of ``fcsr_tpu.core.pallas_kernels.vectorize_colmajor_pallas``."""
    return ops.vectorize_colmajor(_f32(matrices))


def normalize_adj_batch(adjacencies) -> torch.Tensor:
    """(B, n, n) -> D^-1/2 A D^-1/2 with D from the row sums; a zero row
    sum gives 0, a negative one NaN. Unlike ``core.normalize.normalize_adj``
    it does not transpose (the two agree on symmetric input). Counterpart
    of ``fcsr_tpu.core.pallas_kernels.normalize_adj_pallas``."""
    return ops.normalize_adj_batch(_f32(adjacencies))
