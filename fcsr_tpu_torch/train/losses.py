"""Loss functions of GSR-Net and the GAT U-Net (torch)."""

from __future__ import annotations

import torch

__all__ = ["l1", "gsr_composite_loss", "offdiag_mse_loss",
           "intermediate_recon_loss"]


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
