"""GSR-Net training configuration and the host spectral precompute."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from fcsr_tpu_torch.core.normalize import normalize_adj_np
from fcsr_tpu_torch.utils import host_cache

__all__ = ["GSRTrainConfig", "precompute_spectral"]


@dataclass(frozen=True)
class GSRTrainConfig:
    """Hyperparameters of the shipped GSR-Net run (the reference notebook's
    Args), with the JAX package's defaults. ``fused_adam`` selects the
    whole-step kernel path, the only trainer path the port has so far."""
    epochs: int = 200
    lr: float = 1e-4
    lmbda: float = 16.0
    lr_dim: int = 160
    hr_dim: int = 268
    hidden_dim: int = 268
    padding: int = 0
    ks: Tuple[float, ...] = (0.9, 0.7, 0.6, 0.5)
    fused_adam: bool = False


def precompute_spectral(lr_stack, hr_stack, lr_dim: int = 160,
                        padding: int = 0, a_norm=None):
    """Batched eigendecompositions hoisted out of the train loop, on host
    LAPACK (``np.linalg.eigh`` of the same float32 arrays as the JAX
    package, so the eigenvector signs — which change the model — agree).

    Returns (u_lr, u_hr_reduced): eigenvectors of normalize_adj(lr) per
    subject, and the first ``lr_dim`` eigenvector columns of the padded HR
    label with its diagonal set to 1. Disk-cached per dataset content
    (``utils/host_cache.py``)."""
    lr_np = np.asarray(lr_stack, dtype=np.float32)
    hr_np = np.asarray(hr_stack, dtype=np.float32)
    cache = host_cache.cache_path("spectral", (lr_np, hr_np),
                                  (lr_dim, padding))
    hit = host_cache.load(cache, ("u_lr", "u_hr_reduced"))
    if hit is not None:
        return hit
    if a_norm is None:
        a_norm = normalize_adj_np(lr_np)
    _, u_lr = np.linalg.eigh(np.asarray(a_norm, dtype=np.float32))
    if padding:
        hr_np = np.pad(hr_np, ((0, 0), (padding, padding),
                               (padding, padding)))
    else:
        hr_np = hr_np.copy()
    n = hr_np.shape[-1]
    hr_np[:, np.arange(n), np.arange(n)] = 1.0
    _, u_hr = np.linalg.eigh(hr_np)
    u_hr_reduced = u_hr[..., :, :lr_dim]
    host_cache.save(cache, u_lr=u_lr, u_hr_reduced=u_hr_reduced)
    return u_lr, u_hr_reduced
