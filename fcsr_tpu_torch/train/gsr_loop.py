"""GSR-Net training configuration, the host spectral precompute, and batched
inference / validation (counterparts of ``fcsr_tpu/train/gsr_loop.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from fcsr_tpu_torch.core.normalize import normalize_adj_np, unpad
from fcsr_tpu_torch.core.triu_kernels import normalize_adj_batch
from fcsr_tpu_torch.utils import host_cache

__all__ = ["GSRTrainConfig", "precompute_spectral", "predict_gsr",
           "evaluate_gsr"]


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


def predict_gsr(params, model, cfg: GSRTrainConfig, lr_stack) -> torch.Tensor:
    """Batched inference over a stack of LR connectomes -> (B, hr, hr)
    predictions on the model's device.

    ``params`` is a ``state_dict`` mapping (tensors or arrays) loaded into
    ``model`` first, or None to use the model as it is. The eigenvectors
    come from host LAPACK on the host-normalized stack (the signs both
    packages consume); on the device the staged LR stack is normalized by
    the ``normalize_adj_batch`` kernel and handed to the model."""
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    device = next(model.parameters()).device
    lr_np = np.ascontiguousarray(lr_stack, dtype=np.float32)
    _, u_lr = np.linalg.eigh(normalize_adj_np(lr_np))
    lr_dev = torch.from_numpy(lr_np).to(device)
    u_dev = torch.from_numpy(u_lr.astype(np.float32)).to(device)
    with torch.no_grad():
        pred = model(lr_dev, u_lr=u_dev,
                     a_norm=normalize_adj_batch(lr_dev))[0]
    return unpad(pred, cfg.padding)


def evaluate_gsr(params, model, cfg: GSRTrainConfig, lr_stack, hr_stack,
                 verbose: bool = False):
    """Validation pass mirroring the reference's ``test``: skip subjects
    whose LR or HR matrix is all zero, set the HR diagonal to 1 before
    comparing, report the mean of the per-sample MAE. Returns (mean_mae,
    preds, gts) with numpy stacks over the kept subjects."""
    lr_np = np.asarray(lr_stack)
    hr_np = np.asarray(hr_stack)
    keep = [i for i in range(len(lr_np))
            if lr_np[i].any() and hr_np[i].any()]
    lr_np, hr_np = lr_np[keep], hr_np[keep]

    preds = predict_gsr(params, model, cfg, lr_np).cpu().numpy()
    hr_eval = hr_np.copy()
    for m in hr_eval:
        np.fill_diagonal(m, 1.0)
    per_sample = np.abs(preds - hr_eval).mean(axis=(1, 2))
    if verbose:
        for e in per_sample:
            print(f"MAE: {e}")
        print(f"Test error MAE: {per_sample.mean()}")
    return float(per_sample.mean()), preds, hr_eval
