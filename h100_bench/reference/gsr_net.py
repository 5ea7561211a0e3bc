"""GSR-Net (Isallari & Rekik, MLMI 2020) in plain PyTorch, float32, as a
function of a ``state_dict``-named parameter mapping.

Graph U-Net on identity features (its 'GCN' blocks are Linear layers that
ignore the adjacency, so the branch is the same for every subject; pools
keep ``round(k n)`` nodes by ``sigmoid(score / 100)``, ties to the lower
index), the spectral layer ``b = W U_lr^T``, ``f = fill_diag(|b X|, 1)``,
``A = D^-1/2 f^T D^-1/2`` (degrees from f's rows), ``Z = |fill_diag(
sym(A A^T), 1)|``, two GCNs ``A (Z G1)``, ``A (H1 G2)``, and the output
``|fill_diag(sym(H2), 1)|``. Loss: ``lmbda L1(net, start) + L1(W,
U_hr[:, :n]) + L1(pred, hr)``; optimizer: Adam (b1 0.9, b2 0.999, eps
1e-8) per sample. Departures from the published code: none in the
mathematics; the eigenvectors are data, computed on the host
(``common.spectral_bases``), as the published code's ``eigh`` needs no
gradient.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import topk_desc

__all__ = ["param_spec", "pool_sizes", "unet", "tail", "sample_loss",
           "adam_steps", "predict", "fold_mae"]

B1, B2, EPS = 0.9, 0.999, 1e-8


def pool_sizes(n, ks):
    sizes = []
    for k in ks:
        n = max(1, int(round(k * n)))
        sizes.append(n)
    return tuple(sizes)


def param_spec(lr_dim, hr_dim, hidden_dim, n_levels):
    """[(name, shape, init, scale)]: ``init`` "normal" (std ``scale``) or
    "uniform" (bound ``scale``), the published initialisers: nn.Linear's
    1/sqrt(fan_in) for the U-Net, N(0, 1) for the spectral weights,
    Xavier-uniform for the GCNs."""
    n, m, h = lr_dim, hr_dim, hidden_dim
    spec = [("layer.weights", (m, n), "normal", 1.0)]

    def lin(name, fan_in, out):
        b = 1.0 / fan_in ** 0.5
        spec.extend([(f"net.{name}.proj.weight", (out, fan_in), "uniform", b),
                     (f"net.{name}.proj.bias", (out,), "uniform", b)])
    lin("start_gcn", n, m)
    lin("bottom_gcn", m, m)
    lin("end_gcn", 2 * m, m)
    for i in range(n_levels):
        lin(f"down_gcns.{i}", m, m)
    for i in range(n_levels):
        lin(f"up_gcns.{i}", m, m)
    for i in range(n_levels):
        lin(f"pools.{i}", m, 1)
    spec.append(("gc1.weight", (m, h), "uniform", (6.0 / (m + h)) ** 0.5))
    spec.append(("gc2.weight", (h, m), "uniform", (6.0 / (h + m)) ** 0.5))
    return spec


def _lin(P, name, x):
    return F.linear(x, P[f"net.{name}.proj.weight"],
                    P[f"net.{name}.proj.bias"])


def unet(P, ks, lr_dim):
    """(net_outs (n, m), start_gcn_outs (n, m), the pools' least top-k
    margin)."""
    x = torch.eye(lr_dim, dtype=torch.float32,
                  device=P["layer.weights"].device)
    x = _lin(P, "start_gcn", x)
    start = x
    downs, idxs, margin = [], [], float("inf")
    for i, k in enumerate(pool_sizes(lr_dim, ks)):
        x = _lin(P, f"down_gcns.{i}", x)
        downs.append(x)
        scores = torch.sigmoid(_lin(P, f"pools.{i}", x).squeeze(-1) / 100.0)
        vals, idx, gap = topk_desc(scores, k)
        margin = min(margin, float(gap.detach()))
        x = x[idx] * vals[:, None]
        idxs.append(idx)
    x = _lin(P, "bottom_gcn", x)
    L = len(ks)
    for i in range(L):
        up = L - 1 - i
        x = x.new_zeros(downs[up].shape).index_copy(0, idxs[up], x)
        x = _lin(P, f"up_gcns.{i}", x) + downs[up]
    x = _lin(P, "end_gcn", torch.cat([x, start], dim=1))
    return x, start, margin


def _fill_diag(m, value):
    eye = torch.eye(m.shape[-1], dtype=torch.bool, device=m.device)
    return m.masked_fill(eye, value)


def _sym(m):
    return (m + m.transpose(-1, -2)) / 2


def _normalize_t(mx):
    """D^-1/2 A^T D^-1/2, D from A's row sums, a zero degree giving 0."""
    r = mx.sum(dim=-1).pow(-0.5)
    r = torch.where(torch.isinf(r), torch.zeros_like(r), r)
    return (mx * r[..., None, :]).transpose(-1, -2) * r[..., None, :]


def tail(P, net, u_lr):
    """The spectral layer and the GCN decoder for a batch of subjects'
    U_lr (B, n, n): predictions (B, m, m)."""
    n = u_lr.shape[-1]
    b = P["layer.weights"] @ u_lr.transpose(-1, -2)
    adj = _normalize_t(_fill_diag((b @ net[:n]).abs(), 1.0))
    z = _fill_diag(_sym(adj @ adj.transpose(-1, -2)), 1.0).abs()
    h1 = adj @ (z @ P["gc1.weight"])
    h2 = adj @ (h1 @ P["gc2.weight"])
    return _fill_diag(_sym(h2), 1.0).abs()


def sample_loss(P, ks, lmbda, u_lr, u_hr, hr):
    """One subject's loss (a 0-d tensor)."""
    net, start, _ = unet(P, ks, u_lr.shape[-1])
    pred = tail(P, net, u_lr[None])[0]
    return (lmbda * (net - start).abs().mean()
            + (P["layer.weights"] - u_hr).abs().mean()
            + (pred - hr).abs().mean())


def adam_steps(P0, ks, lmbda, lr, samples):
    """Adam over ``samples`` [(u_lr, u_hr, hr)], one step each, from the
    parameters ``P0`` (not changed). Returns (losses, the first gradient
    by name, the parameters after the last step by name)."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, g1 = [], None
    for t, (u_lr, u_hr, hr) in enumerate(samples, start=1):
        leaves = {k: x.requires_grad_() for k, x in P.items()}
        loss = sample_loss(leaves, ks, lmbda, u_lr, u_hr, hr)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = grads
        with torch.no_grad():
            for k in P:
                g = grads[k]
                m[k] = B1 * m[k] + (1 - B1) * g
                v2[k] = B2 * v2[k] + (1 - B2) * g * g
                step = lr * (m[k] / (1 - B1 ** t)) / (
                    torch.sqrt(v2[k] / (1 - B2 ** t)) + EPS)
                P[k] = P[k].detach() - step
    return losses, g1, P


@torch.no_grad()
def predict(P, ks, u_lr, block=56):
    """(predictions (B, m, m), the U-Net's top-k margin) of the
    parameters ``P`` for the subjects' U_lr (B, n, n), in blocks."""
    net, _, margin = unet(P, ks, u_lr.shape[-1])
    return torch.cat([tail(P, net, u_lr[s:s + block])
                      for s in range(0, len(u_lr), block)]), margin


@torch.no_grad()
def fold_mae(P, ks, u_lr, hr):
    """Mean over the subjects of mean |pred - label|, the label's diagonal
    set to 1 (the published ``test``)."""
    pred, _ = predict(P, ks, u_lr)
    return float((pred - _fill_diag(hr, 1.0)).abs().mean(dim=(-2, -1))
                 .double().mean())
