"""GSR-Net loss functions (torch)."""

from __future__ import annotations

import torch

__all__ = ["l1", "gsr_composite_loss"]


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
