"""The "unet-transformer" GAT Graph-U-Net (reference repo
``unet-transformer.py:503-524``) in plain PyTorch, float32, as a function
of a ``state_dict``-named mapping: evaluation, and training's first steps.

Input: the raw LR adjacency and its SVD node features (the top ``dim``
left singular vectors of ``D^-1/2 (A + I) D^-1/2``, ``d = rowsum +
1e-5``, by host LAPACK in float64). Down path: dense masked multi-head
GAT (PyG ``GATConv``: LeakyReLU(0.2) logits over existing edges and
self-loops, softmax over the sources, concatenated heads + bias), ReLU,
then a pool keeping ``max(2, int(k n))`` nodes by ``sigmoid(x w + b)``
(ties to the lower index), the kept rows scaled by their scores, the
pooled adjacency renormalised; a 2-head bottom GAT; up path: unpool, GAT,
ReLU, ``relu(X X^T)`` as the level's reconstruction; upsampler
``relu(S S^T)``, ``S = softmax(Linear(n -> m)(X^T)^T)``. Loss: off-
diagonal MSE of the prediction plus the levels' off-diagonal MSEs between
the down path's adjacencies and the reconstructions. Training: AdamW
(0.9, 0.999, 1e-8, decoupled weight decay), one step per subject;
inverted dropout keeps an entry where a uniform draw is ``>= p``, the
draws of a step's folds made together, site by site in the forward's
order, from ``torch.Generator`` seeded with the run's seed (the stream
the configuration's seed states). Departures: none in the mathematics.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import topk_desc

__all__ = ["dims", "pool_sizes", "param_spec", "node_features", "forward",
           "losses_and_maes", "dropout_sites", "keep_masks", "dropper",
           "adamw_steps"]

B1, B2, EPS = 0.9, 0.999, 1e-8


def dims(dim, ks):
    out = [dim]
    for k in ks:
        out.append(int(out[-1] / k))
    return out


def pool_sizes(n, ks):
    sizes = []
    for k in ks:
        n = max(2, int(k * n))
        sizes.append(n)
    return tuple(sizes)


def _layers(dim, ks, heads):
    """(state_dict prefix, in, out, heads) in forward order."""
    L, d = len(ks), dims(dim, ks)
    out = [(f"down_gcns.{i}.gat", d[i], d[i + 1], heads) for i in range(L)]
    out.append(("bottom_gcn.gat", d[-1], d[-1], 2))
    out += [(f"up_gcns.{i}.gat", d[L - i], d[L - i - 1], heads)
            for i in range(L)]
    return out


def param_spec(n_nodes, m_nodes, dim, ks, heads):
    """[(name, shape, init, scale)]: Xavier-uniform (bound ``scale``) or
    zeros, the published initialisers."""
    spec = []

    def xavier(fan_in, fan_out):
        return (6.0 / (fan_in + fan_out)) ** 0.5
    for pre, d_in, d_out, h in _layers(dim, ks, heads):
        dh = d_out // h
        spec += [(f"{pre}.lin.weight", (h * dh, d_in), "uniform",
                  xavier(d_in, h * dh)),
                 (f"{pre}.att_src", (1, h, dh), "uniform", xavier(h, dh)),
                 (f"{pre}.att_dst", (1, h, dh), "uniform", xavier(h, dh)),
                 (f"{pre}.bias", (h * dh,), "zeros", 0.0)]
    d = dims(dim, ks)
    for i in range(len(ks)):
        spec += [(f"pools.{i}.proj.weight", (1, d[i + 1]), "uniform",
                  xavier(d[i + 1], 1)),
                 (f"pools.{i}.proj.bias", (1,), "zeros", 0.0)]
    spec += [("upsampler.upsample_mlp.weight", (m_nodes, n_nodes), "uniform",
              xavier(n_nodes, m_nodes)),
             ("upsampler.upsample_mlp.bias", (m_nodes,), "zeros", 0.0)]
    return spec


def node_features(lr, dim):
    """(B, n, dim) float32 SVD features of the raw (B, n, n) stack."""
    a = np.asarray(lr, np.float64) + np.eye(lr.shape[-1])
    r = (a.sum(axis=-1) + 1e-5) ** -0.5
    a = a * r[..., None, :] * r[..., :, None]
    u, _, _ = np.linalg.svd(a)
    return u[..., :, :dim].astype(np.float32)


def _sym_norm(a, eps=1e-5):
    r = (a.sum(dim=-1) + eps).pow(-0.5)
    return a * r[..., None, :] * r[..., :, None]


def _no_drop(t):
    return t


def _gat(P, pre, heads, adj, x, drop=_no_drop):
    w = P[f"{pre}.lin.weight"]
    n, width = adj.shape[-1], w.shape[0]
    h = (x @ w.T).reshape(*x.shape[:-1], heads, width // heads)
    a_src = (h * P[f"{pre}.att_src"]).sum(-1)
    a_dst = (h * P[f"{pre}.att_dst"]).sum(-1)
    logits = a_src[..., None, :, :] + a_dst[..., :, None, :]
    logits = torch.where(logits >= 0, logits, 0.2 * logits)
    mask = ((adj != 0) | torch.eye(n, dtype=torch.bool,
                                   device=adj.device))[..., None]
    alpha = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-2)
    alpha = drop(alpha.masked_fill(~mask, 0.0))
    out = torch.einsum("...ijh,...jhd->...ihd", alpha, h)
    return out.reshape(*x.shape[:-1], width) + P[f"{pre}.bias"]


def forward(P, lr, x, ks, heads, drop=_no_drop):
    """(predictions (B, m, m), down-path adjacencies, reconstructions in
    up order, each subject's least top-k margin (B,)) for raw LR (B, n, n)
    and features (B, n, dim); ``drop`` applies training's dropout at each
    site in turn (``dropper``; default none: evaluation)."""
    n = lr.shape[-1]
    a = _sym_norm(lr + torch.eye(n, dtype=lr.dtype, device=lr.device))
    layers = _layers(x.shape[-1], ks, heads)
    L = len(ks)
    hist, idxs, recons = [], [], []
    margin = torch.full(lr.shape[:-2], float("inf"), device=lr.device)
    for i, k in enumerate(pool_sizes(n, ks)):
        pre, _, _, h = layers[i]
        x = torch.relu(_gat(P, pre, h, a, x, drop))
        hist.append(a)
        scores = torch.sigmoid(F.linear(drop(x), P[f"pools.{i}.proj.weight"],
                                        P[f"pools.{i}.proj.bias"]))[..., 0]
        vals, idx, gap = topk_desc(scores, k)
        margin = torch.minimum(margin, gap)
        x = torch.take_along_dim(x, idx[..., None], dim=-2) * vals[..., None]
        a = torch.take_along_dim(torch.take_along_dim(
            a, idx[..., :, None], dim=-2), idx[..., None, :], dim=-1)
        a = _sym_norm(a)
        idxs.append(idx)
    pre, _, _, h = layers[L]
    x = torch.relu(_gat(P, pre, h, a, x, drop))
    for i in range(L):
        up = L - 1 - i
        a = hist[up]
        x = x.new_zeros(*x.shape[:-2], a.shape[-1], x.shape[-1]).scatter(
            -2, idxs[up][..., None].expand_as(x), x)
        pre, _, _, h = layers[L + 1 + i]
        x = torch.relu(_gat(P, pre, h, a, x, drop))
        recons.append(torch.relu(x @ x.transpose(-1, -2)))
    s = F.linear(x.transpose(-1, -2), P["upsampler.upsample_mlp.weight"],
                 P["upsampler.upsample_mlp.bias"]).transpose(-1, -2)
    s = torch.softmax(s, dim=-1)
    return torch.relu(s @ s.transpose(-1, -2)), hist, recons, margin


def _offdiag_mse(a, b):
    eye = torch.eye(a.shape[-1], dtype=torch.bool, device=a.device)
    return ((a.masked_fill(eye, 0.0) - b.masked_fill(eye, 0.0)) ** 2
            ).mean(dim=(-2, -1))


def loss_of(pred, hr, hist, recons):
    """Each subject's training loss (B,)."""
    loss = _offdiag_mse(pred, hr)
    for a, r in zip(hist, recons[::-1]):
        loss = loss + _offdiag_mse(a, r)
    return loss


@torch.no_grad()
def losses_and_maes(P, lr, x, hr, ks, heads, block=28):
    """Each subject's (loss, off-diagonal MAE over m (m - 1) entries,
    top-k margin), and the predictions, in blocks of subjects."""
    out = [[], [], [], []]
    for s in range(0, len(lr), block):
        pred, hist, recons, margin = forward(P, lr[s:s + block],
                                             x[s:s + block], ks, heads)
        h = hr[s:s + block]
        m = pred.shape[-1]
        eye = torch.eye(m, dtype=torch.bool, device=pred.device)
        mae = (pred - h).abs().masked_fill(eye, 0.0).sum((-2, -1)) \
            / (m * (m - 1))
        for acc, val in zip(out, (loss_of(pred, h, hist, recons), mae,
                                  margin, pred)):
            acc.append(val)
    return tuple(torch.cat(acc) for acc in out)


def dropout_sites(n, dim, ks, heads):
    """The shapes one subject's training forward drops, in its order:
    each down layer's attention (n_i, n_i, heads) and its pool's input
    (n_i, d_i+1), the bottom layer's attention (2 heads), each up layer's
    attention."""
    d, rows, L = dims(dim, ks), [n] + list(pool_sizes(n, ks)), len(ks)
    sites = []
    for i in range(L):
        sites += [(rows[i], rows[i], heads), (rows[i], d[i + 1])]
    sites.append((rows[L], rows[L], 2))
    sites += [(rows[L - 1 - i], rows[L - 1 - i], heads) for i in range(L)]
    return sites


def keep_masks(gen, n_folds, sites, p):
    """One training step's keep masks, (n_folds, *site) for each site:
    one uniform draw over the fold stack a site, kept where ``>= p``."""
    return [torch.rand((n_folds, *s), generator=gen, device=gen.device)
            >= p for s in sites]


def dropper(masks, p):
    """Inverted dropout by ``masks`` in turn (one a site)."""
    it = iter(masks)
    return lambda t: t * next(it) * (1.0 / (1.0 - p))


def adamw_steps(P0, samples, drops, ks, heads, lr, wd):
    """AdamW over ``samples`` [(lr (1, n, n), x (1, n, dim), hr (1, m,
    m))], one step each under dropout ``drops[s]``, from ``P0`` (not
    changed). Returns (losses, the first gradient by name, the parameters
    after the last step by name)."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, g1 = [], None
    for t, ((lr_i, x_i, hr_i), drop) in enumerate(zip(samples, drops),
                                                  start=1):
        leaves = {k: x.requires_grad_() for k, x in P.items()}
        pred, hist, recons, _ = forward(leaves, lr_i, x_i, ks, heads, drop)
        loss = loss_of(pred, hr_i, hist, recons).sum()
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(P[k]) if g is None else g
                 for k, g in grads.items()}
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = grads
        with torch.no_grad():
            for k in P:
                g = grads[k]
                m[k] = B1 * m[k] + (1 - B1) * g
                v2[k] = B2 * v2[k] + (1 - B2) * g * g
                step = lr * ((m[k] / (1 - B1 ** t)) / (
                    torch.sqrt(v2[k] / (1 - B2 ** t)) + EPS) + wd * P[k])
                P[k] = P[k].detach() - step
    return losses, g1, P
