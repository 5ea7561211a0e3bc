"""Adjacency normalization and padding primitives (torch, plus one host
numpy helper). Counterpart of ``fcsr_tpu/core/normalize.py``; every
function works on the trailing two axes, so leading batch axes broadcast.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["normalize_adj", "normalize_adj_np", "pad_hr_adj", "unpad",
           "fill_diagonal", "symmetric_normalize", "symmetrize"]


def normalize_adj_np(mx):
    """Host-numpy batched D^-1/2 A D^-1/2 with the inf->0 zero-degree
    guard, for the symmetric adjacencies of staging and the spectral
    precompute (where the transpose of ``normalize_adj`` cancels).
    Accepts (..., n, n); preserves the dtype class."""
    mx = np.asarray(mx)
    rowsum = mx.sum(axis=-1)
    with np.errstate(divide="ignore"):
        r = rowsum ** -0.5
    r[np.isinf(r)] = 0.0
    return mx * r[..., None, :] * r[..., :, None]


def normalize_adj(mx: torch.Tensor) -> torch.Tensor:
    """Degree normalization in the reference's exact operation order:
    scale columns by d^-1/2, transpose, scale columns again. The result is
    D^-1/2 A^T D^-1/2 with D from A's ROW sums — the transpose matters for
    the non-symmetric matrix of the spectral layer. A zero row sum gives 0
    (inf -> 0 guard); a negative row sum's NaN propagates."""
    rowsum = mx.sum(dim=-1)
    r = rowsum.pow(-0.5)
    r = torch.where(torch.isinf(r), torch.zeros_like(r), r)
    mx = mx * r[..., None, :]
    mx = mx.transpose(-1, -2)
    return mx * r[..., None, :]


def symmetric_normalize(a: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``D^-1/2 A D^-1/2`` with ``d = rowsum + eps`` (the GAT U-Net's
    normalisation; no zero-degree guard needed)."""
    r = (a.sum(dim=-1) + eps).pow(-0.5)
    return a * r[..., None, :] * r[..., :, None]


def fill_diagonal(m: torch.Tensor, value: float) -> torch.Tensor:
    """Out-of-place fill of the diagonal of the trailing two axes."""
    eye = torch.eye(m.shape[-1], dtype=torch.bool, device=m.device)
    return m.masked_fill(eye, value)


def symmetrize(m: torch.Tensor) -> torch.Tensor:
    """(M + M^T) / 2 over the trailing two axes."""
    return (m + m.transpose(-1, -2)) / 2


def pad_hr_adj(label: torch.Tensor, split: int) -> torch.Tensor:
    """Zero-pad by ``split`` on each side and set the diagonal to 1."""
    if split:
        label = torch.nn.functional.pad(label, (split, split, split, split))
    return fill_diagonal(label, 1.0)


def unpad(data: torch.Tensor, split: int) -> torch.Tensor:
    """Crop ``split`` rows/cols from every side."""
    if split == 0:
        return data
    return data[..., split:data.shape[-2] - split,
                split:data.shape[-1] - split]
