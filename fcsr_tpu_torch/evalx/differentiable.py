"""Differentiable graph metrics and GSRLoss, in torch.

Counterpart of ``fcsr_tpu/evalx/differentiable.py``: the reference's cheap
centrality approximations for auxiliary losses (distinct from the
NetworkX-faithful evaluation in centrality.py). Each takes one (n, n)
matrix or a stack (..., n, n); fixed iteration counts and no
data-dependent control flow, so autograd differentiates them.
"""

from __future__ import annotations

import torch

from fcsr_tpu_torch.train.losses import l1

__all__ = ["betweenness_approx", "eigenvector_power", "pagerank_diff",
           "gsr_loss", "evaluate_model_mae"]


def _eye_like(adj):
    n = adj.shape[-1]
    return torch.eye(n, dtype=adj.dtype, device=adj.device)


def betweenness_approx(adj, num_iter: int = 10):
    """Matrix-power betweenness approximation: centrality_i = row sum of
    (A + I)^k over the total sum."""
    dist = torch.linalg.matrix_power(adj + _eye_like(adj), num_iter)
    return dist.sum(dim=-1) / dist.sum(dim=(-2, -1))[..., None]


def eigenvector_power(adj, num_iter: int = 100):
    """Power-iteration eigenvector centrality with L2 normalization."""
    a = adj + _eye_like(adj)
    x = torch.ones(adj.shape[:-1] + (1,), dtype=adj.dtype, device=adj.device)
    for _ in range(num_iter):
        x = a @ x
        x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    return x[..., 0]


def pagerank_diff(adj, alpha: float = 0.85, num_iter: int = 100):
    """Differentiable PageRank: row-normalize with a 1e-9 clamp, then a
    fixed count of power steps."""
    n = adj.shape[-1]
    a = adj / torch.clamp(adj.sum(dim=-1, keepdim=True), min=1e-9)
    teleport = torch.full(adj.shape[:-1], 1.0 / n, dtype=adj.dtype,
                          device=adj.device)
    rank = teleport
    for _ in range(num_iter):
        rank = alpha * (a.transpose(-2, -1) @ rank[..., None])[..., 0] \
            + (1 - alpha) * teleport
    return rank


def gsr_loss(input_adj, target_adj):
    """GSRLoss: the mean over the (B, n, n) batch of the average L1
    distance between {BC-approx, EC, PageRank, adjacency} of prediction
    and target (every sample has as many entries, so each term's mean over
    the batch is its L1 over the stack)."""
    return (l1(betweenness_approx(input_adj), betweenness_approx(target_adj))
            + l1(eigenvector_power(input_adj), eigenvector_power(target_adj))
            + l1(pagerank_diff(input_adj), pagerank_diff(target_adj))
            + l1(input_adj, target_adj)) / 4.0


def evaluate_model_mae(preds, targets):
    """Plain mean |pred - target| over stacked matrices."""
    return float(l1(torch.as_tensor(preds), torch.as_tensor(targets)))
