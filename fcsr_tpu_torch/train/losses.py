"""Loss functions of GSR-Net, the GAT U-Net and the MLP family (torch).
Counterpart of ``fcsr_tpu/train/losses.py``."""

from __future__ import annotations

import functools

import numpy as np
import torch

from fcsr_tpu_torch.core.vectorize import triu_indices_rowmajor

__all__ = ["l1", "gsr_composite_loss", "offdiag_mse_loss",
           "intermediate_recon_loss", "make_triu_mse_criterion",
           "pack_triu_targets"]


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error, ``nn.L1Loss`` semantics."""
    return torch.mean(torch.abs(a - b))


def gsr_composite_loss(pred, net_outs, start_gcn_outs, gsr_weights,
                       u_hr_reduced, hr, lmbda: float):
    """``lmbda * L1(net_outs, start_gcn_outs) + L1(W_gsr, U_hr[:, :lr])
    + L1(pred, hr)``; returns (loss, reconstruction_mae)."""
    recon = l1(pred, hr)
    loss = (lmbda * l1(net_outs, start_gcn_outs)
            + l1(gsr_weights, u_hr_reduced)
            + recon)
    return loss, recon


def _zero_diag(m: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(m.shape[-1], dtype=torch.bool, device=m.device)
    return m.masked_fill(eye, 0.0)


def offdiag_mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE with the diagonal zeroed in both operands: the mean runs over
    all n^2 entries, not n (n - 1). Leading axes are kept (one value per
    matrix)."""
    return ((_zero_diag(pred) - _zero_diag(target)) ** 2).mean(dim=(-2, -1))


def intermediate_recon_loss(a_hist, a_recon_hist_reversed):
    """Sum of the off-diagonal MSEs between the down-path adjacencies and
    the reversed up-path reconstructions."""
    total = 0.0
    for a, a_recon in zip(a_hist, a_recon_hist_reversed):
        total = total + offdiag_mse_loss(a, a_recon)
    return total


@functools.lru_cache(maxsize=16)
def make_triu_mse_criterion(n_out: int):
    """The dense-matrix MSE of a prediction ``M = sym(scatter(v))`` (zero
    diagonal) against a symmetric target ``T``, computed in triangle-vector
    space:

        mean((M - T)^2) over n^2 entries
          = (2 * sum((v - triu(T))^2) + sum(diag(T)^2)) / (B * n^2)

    The criterion takes ``pred`` as (B, L) row-major triangle vectors and
    ``target`` as dense (B, n, n) matrices or as rows packed by
    ``pack_triu_targets``, (B, L + n) = [triu(T), diag(T)]. It equals the
    matrix MSE up to float reassociation (tested) and runs under
    ``torch.vmap``, as the trainers call it once per fold."""
    rows, cols = triu_indices_rowmajor(n_out)
    m = len(rows)
    index = {}

    def indices(device):
        if device not in index:
            index[device] = tuple(
                torch.from_numpy(a.astype(np.int64)).to(device)
                for a in (rows, cols, np.arange(n_out)))
        return index[device]

    def criterion(pred_vec, target):
        b = target.shape[0]
        if target.dim() == 2:                       # packed [triu, diag]
            t_vec, t_diag = target[:, :m], target[:, m:]
        else:
            r, c, d = indices(target.device)
            t_vec, t_diag = target[:, r, c], target[:, d, d]
        sq = torch.sum((pred_vec - t_vec) ** 2)
        return (2.0 * sq + torch.sum(t_diag ** 2)) / (b * n_out * n_out)

    return criterion


def pack_triu_targets(hr_mats) -> np.ndarray:
    """(N, n, n) symmetric targets -> (N, L + n) packed ``[row-major triu,
    diagonal]`` rows for ``make_triu_mse_criterion`` (numpy, on the host)."""
    hr_mats = np.asarray(hr_mats)
    n = hr_mats.shape[-1]
    rows, cols = triu_indices_rowmajor(n)
    didx = np.arange(n)
    return np.concatenate([hr_mats[:, rows, cols],
                           hr_mats[:, didx, didx]], axis=1)
