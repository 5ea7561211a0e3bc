"""GAT Graph-U-Net + learned upsampler (the "unet-transformer" family) in
PyTorch. Counterpart of ``fcsr_tpu/models/gat_unet.py``: dense masked
multi-head attention with PyG ``GATConv`` semantics, a learned top-k pool
that keeps ``max(2, int(k * n))`` nodes (truncation, unlike GSR-Net's
rounding) and re-normalises the pooled adjacency, and a Linear + softmax
upsampler. This is the unfused model on ``torch.matmul`` (the JAX model
computes it outside any kernel); the fused step is ``models/fused_gat.py``.

Parameter names follow the reference's ``state_dict``
(``down_gcns.{i}.gat.lin.weight`` (heads * d_head, in), ``...gat.att_src``
(1, heads, d_head), ``pools.{i}.proj.weight``, ``upsampler.upsample_mlp``),
so ``iox/weights.py`` maps the JAX parameters onto them directly. Inputs
may carry leading batch axes: every subject of a batch shares the weights.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fcsr_tpu_torch.core.normalize import symmetric_normalize
from fcsr_tpu_torch.iox.weights import gat_dims
from fcsr_tpu_torch.models.gsr import topk_desc
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["DenseGAT", "GATPool", "GATUnpool", "GraphUpsampler",
           "GATGraphUnet", "gat_pool_sizes", "gat_dims", "svd_node_features",
           "reconstruct_adjacency", "symmetric_normalize"]


def gat_pool_sizes(n: int, ks: Sequence[float]) -> Tuple[int, ...]:
    """``max(2, int(k * n))`` per level: (80, 40, 20) for n = 160 and
    ks = (0.5, 0.5, 0.5)."""
    sizes = []
    for k in ks:
        n = max(2, int(k * n))
        sizes.append(n)
    return tuple(sizes)


def svd_node_features(a_norm: torch.Tensor, dim: int) -> torch.Tensor:
    """Top-``dim`` left singular vectors of the normalized adjacency. Pure
    data: the trainers precompute it on the host (``train/gat_loop.py``)."""
    u, _, _ = torch.linalg.svd(a_norm)
    return u[..., :, :dim]


def reconstruct_adjacency(x: torch.Tensor) -> torch.Tensor:
    """``relu(X X^T)``."""
    return torch.relu(torch.matmul(x, x.transpose(-1, -2)))


def _xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int, generator):
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def _dropout(x, p: float, train: bool, generator):
    """Inverted dropout from an explicit generator (keep when u >= p)."""
    if not train or p <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep * (1.0 / (1.0 - p))


class DenseGAT(nn.Module):
    """Dense masked multi-head GAT layer: glorot-init projection and
    attention vectors, LeakyReLU(0.2) logits (slope 1 at exactly 0, as the
    JAX model), softmax over the existing-edge + self-loop neighbourhood,
    attention dropout, concatenated heads + bias."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 4,
                 dropout: float = 0.0, negative_slope: float = 0.2,
                 generator=None):
        super().__init__()
        self.heads, self.d_head = heads, out_dim // heads
        self.dropout, self.negative_slope = dropout, negative_slope
        self.generator = None
        width = heads * self.d_head
        self.lin = nn.Linear(in_dim, width, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, self.d_head))
        self.att_dst = nn.Parameter(torch.empty(1, heads, self.d_head))
        self.bias = nn.Parameter(torch.zeros(width))
        _xavier_uniform_(self.lin.weight, in_dim, width, generator)
        _xavier_uniform_(self.att_src, heads, self.d_head, generator)
        _xavier_uniform_(self.att_dst, heads, self.d_head, generator)

    def forward(self, adj, x, train: bool = False):
        n = adj.shape[-1]
        h = self.lin(x).reshape(*x.shape[:-1], self.heads, self.d_head)
        a_src = (h * self.att_src).sum(-1)                  # (..., n, heads)
        a_dst = (h * self.att_dst).sum(-1)
        # alpha_ij = leakyrelu(att_src . h_j + att_dst . h_i), softmax over
        # the source nodes j of each target i
        logits = a_src[..., None, :, :] + a_dst[..., :, None, :]
        logits = torch.where(logits >= 0, logits,
                             self.negative_slope * logits)
        mask = (adj != 0) | torch.eye(n, dtype=torch.bool, device=adj.device)
        mask = mask[..., None]
        logits = logits.masked_fill(~mask, float("-inf"))
        alpha = torch.softmax(logits, dim=-2)
        alpha = alpha.masked_fill(~mask, 0.0)
        alpha = _dropout(alpha, self.dropout, train, self.generator)
        out = torch.einsum("...ijh,...jhd->...ihd", alpha, h)
        return out.reshape(*x.shape[:-1], self.heads * self.d_head) + self.bias


class _GATBlock(nn.Module):
    """Holds one ``DenseGAT`` as ``.gat`` (the reference's module nesting,
    which gives the ``state_dict`` its names)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.gat = DenseGAT(*args, **kwargs)

    def forward(self, adj, x, train: bool = False):
        return self.gat(adj, x, train=train)


class GATPool(nn.Module):
    """Learned top-k pool: dropout on the scores' input, the kept rows
    scaled by their scores, the pooled adjacency re-normalized."""

    def __init__(self, k_out: int, in_dim: int, dropout: float = 0.0,
                 generator=None):
        super().__init__()
        self.k_out, self.dropout = k_out, dropout
        self.generator = None
        self.proj = nn.Linear(in_dim, 1)
        _xavier_uniform_(self.proj.weight, in_dim, 1, generator)
        with torch.no_grad():
            self.proj.bias.zero_()

    def forward(self, adj, x, train: bool = False):
        z = _dropout(x, self.dropout, train, self.generator)
        scores = torch.sigmoid(self.proj(z).squeeze(-1))
        values, idx = topk_desc(scores, self.k_out)
        x_p = torch.take_along_dim(x, idx[..., None], dim=-2) \
            * values[..., None]
        a_p = torch.take_along_dim(
            torch.take_along_dim(adj, idx[..., :, None], dim=-2),
            idx[..., None, :], dim=-1)
        return symmetric_normalize(a_p), x_p, idx


class GATUnpool(nn.Module):
    """Scatter the pooled rows back to their pre-pool slots."""

    def forward(self, adj, x, idx):
        new_x = x.new_zeros(*x.shape[:-2], adj.shape[-1], x.shape[-1])
        return adj, new_x.scatter(-2, idx[..., None].expand_as(x), x)


class GraphUpsampler(nn.Module):
    """Linear(n -> m) on X^T, row softmax, ``relu(X X^T)``."""

    def __init__(self, n_nodes: int, m_nodes: int, generator=None):
        super().__init__()
        self.upsample_mlp = nn.Linear(n_nodes, m_nodes)
        _xavier_uniform_(self.upsample_mlp.weight, n_nodes, m_nodes,
                         generator)
        with torch.no_grad():
            self.upsample_mlp.bias.zero_()

    def forward(self, x):
        x_up = self.upsample_mlp(x.transpose(-1, -2)).transpose(-1, -2)
        return reconstruct_adjacency(torch.softmax(x_up, dim=-1))


class GATGraphUnet(nn.Module):
    """The full GAT U-Net. ``forward(a_raw, x=None, train=False)`` takes a
    raw (n, n) adjacency (or a batch); self-loops and the normalization
    happen inside, ``x`` (the SVD features) may be precomputed. Returns
    (a_upsampled, a_history, a_recon_history).

    ``skip=True`` keeps the reference's constraint: the per-level widths
    grow as ``int(dim / k)``, so the skip additions only fit when every
    ``k`` is 1. ``device`` defaults to CUDA and raises without a card unless
    the caller passes ``device="cpu"``; ``seed`` seeds the explicit
    generator of the initialisation; dropout draws from ``set_generator``'s
    generator (the default one if unset)."""

    def __init__(self, ks=(0.5, 0.5, 0.5), n_nodes=160, m_nodes=268, dim=16,
                 heads=4, drop_p=0.01, skip=False, device=DEFAULT_DEVICE,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        self.ks = tuple(ks)
        self.n_nodes, self.m_nodes, self.dim = n_nodes, m_nodes, dim
        self.heads, self.drop_p, self.skip = heads, drop_p, skip
        L = len(self.ks)
        dims = gat_dims(dim, self.ks)
        sizes = gat_pool_sizes(n_nodes, self.ks)
        self.down_gcns = nn.ModuleList(
            _GATBlock(dims[i], dims[i + 1], heads=heads, dropout=drop_p,
                      generator=gen) for i in range(L))
        # the up path runs in reverse level order
        self.up_gcns = nn.ModuleList(
            _GATBlock(dims[L - i], dims[L - i - 1], heads=heads,
                      dropout=drop_p, generator=gen) for i in range(L))
        self.pools = nn.ModuleList(
            GATPool(sizes[i], dims[i + 1], dropout=drop_p, generator=gen)
            for i in range(L))
        self.unpools = nn.ModuleList(GATUnpool() for _ in self.ks)
        self.bottom_gcn = _GATBlock(dims[-1], dims[-1], heads=2,
                                    dropout=drop_p, generator=gen)
        self.upsampler = GraphUpsampler(n_nodes, m_nodes, generator=gen)
        self.to(dev)

    def set_generator(self, generator) -> None:
        """The generator every dropout of the model draws from."""
        for mod in self.modules():
            if isinstance(mod, (DenseGAT, GATPool)):
                mod.generator = generator

    def forward(self, a_raw, x: Optional[torch.Tensor] = None,
                train: bool = False):
        n = a_raw.shape[-1]
        a = symmetric_normalize(
            a_raw + torch.eye(n, dtype=a_raw.dtype, device=a_raw.device))
        if x is None:
            x = svd_node_features(a, self.dim)
        a_history, a_recon_history = [], []
        indices, down_outs = [], []
        org_x = x
        L = len(self.ks)
        for i in range(L):
            x = torch.relu(self.down_gcns[i](a, x, train=train))
            a_history.append(a)
            down_outs.append(x)
            a, x, idx = self.pools[i](a, x, train=train)
            indices.append(idx)
        x = torch.relu(self.bottom_gcn(a, x, train=train))
        for i in range(L):
            up = L - i - 1
            a, x = self.unpools[i](a_history[up], x, indices[up])
            x = torch.relu(self.up_gcns[i](a, x, train=train))
            a_recon_history.append(reconstruct_adjacency(x))
            if self.skip:
                x = x + down_outs[up]
        if self.skip:
            x = x + org_x
        return self.upsampler(x), tuple(a_history), tuple(a_recon_history)
