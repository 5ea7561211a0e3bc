"""GSR-Net in PyTorch: Graph U-Net encoder + spectral super-resolution +
GCN decoder. Counterpart of ``fcsr_tpu/models/gsr.py``; this is the
evaluation forward (the training step runs ``models/fused_step.py``).

Parameter names follow the reference's ``state_dict``
(``net.start_gcn.proj.weight``, ``layer.weights``, ``gc1.weight``, ...),
so ``iox/weights.py`` maps JAX parameters onto them directly. Inputs may
carry leading batch axes: the U-Net branch is subject-independent (its
input features are the identity and its 'GCN' blocks ignore the
adjacency), so it runs once and the spectral tail broadcasts over the batch.

With its parameters and inputs cast to bf16 (the fold-parallel runner's
``compute_dtype="bf16"``, ``train/fast_loop.py``) the model computes what
the JAX package's ``GSRNet`` computes with bf16 parameters (traced with
``jax.make_jaxpr`` at 20 -> 32): the U-Net in bf16, every product's and
every sum's output rounded to bf16 (a product and then its bias, each
rounded), the pool's score by XLA's bf16 rule (``pool_scores_bf16``) and
top-k over the bf16 scores; the GSR layer and the GCNs promote their
operands and compute fp32 products with fp32 outputs
(``preferred_element_type=float32``): bf16 x bf16 (``W U^T``) on the card
by the ``bgemm_bf16`` kernel, the rest fp32 products of the promoted
values. Cotangents follow by autograd: bf16 where the value is bf16.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fcsr_tpu_torch.core.normalize import (fill_diagonal, normalize_adj,
                                           symmetrize)
from fcsr_tpu_torch.kernels import ops
from fcsr_tpu_torch.kernels.ops import pool_scores, rows_contiguous
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["GSRLayer", "GraphConvolution", "GCN", "GraphPool", "GraphUnpool",
           "GraphUnet", "GSRNet", "pool_sizes", "topk_desc",
           "pool_scores_bf16", "matmul_f32"]


def pool_sizes(n: int, ks: Sequence[float]) -> Tuple[int, ...]:
    """Static node counts after each pooling level, with Python's banker's
    rounding (``int(round(k * n))``): (144, 101, 61, 30) for n=160,
    ks=(0.9, 0.7, 0.6, 0.5)."""
    sizes = []
    for k in ks:
        n = max(1, int(round(k * n)))
        sizes.append(n)
    return tuple(sizes)


def topk_desc(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest scores along the last axis, in
    descending order with ties to the LOWER index (lax.top_k's order;
    ``torch.topk`` does not promise a tie order)."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(scores, -1, idx), idx


_BF16 = torch.bfloat16


def _bf16(x):
    return x.to(_BF16)


class _PoolScoresBF16(torch.autograd.Function):
    """XLA's bf16 ``sigmoid(logits / 100)`` on the CPU, op by op, each
    result rounded to bf16: q = x / 100, e = exp(-q), d = 1 + e,
    s = 1 / d; its adjoint ``g s (1 - s) / 100`` likewise (the JAX
    package's jaxpr: ``mul`` by ``s * (1 - s)``, then ``div`` by 100).
    Checked against jitted JAX over every finite bf16 value below 3000 in
    magnitude: equal but where XLA flushes a denormal quotient to zero."""

    @staticmethod
    def forward(ctx, logits, div):
        q = logits / div                       # fp32 quotient, rounded
        s = _bf16(1.0 / _bf16(1.0 + _bf16(torch.exp(-q.float())).float())
                  .float())
        ctx.save_for_backward(_bf16(s * _bf16(1.0 - s)))
        ctx.div = div
        return s

    @staticmethod
    def backward(ctx, g):
        (ds,) = ctx.saved_tensors
        return (g * ds) / ctx.div, None


def pool_scores_bf16(logits, div=100.0):
    """The pool's scores from bf16 logits, as the JAX package's
    ``GraphPool`` computes them in bf16 (``_PoolScoresBF16``)."""
    return _PoolScoresBF16.apply(logits, div)


class _ProductF32(torch.autograd.Function):
    """a @ b of two bf16 operands with an fp32 output (XLA's dot with
    ``preferred_element_type=float32``): on the card the ``bgemm_bf16``
    kernel, on the CPU an fp32 product of the bf16 values (exact
    products, fp32 sums). Adjoints: fp32 products of the fp32 cotangent
    with the other operand, rounded to bf16 (the transposed dot's output,
    then the operand's dtype)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if not a.is_cuda:
            return torch.matmul(a.float(), b.float())
        out = ops.bgemm_bf16(rows_contiguous(a.float()[None]),
                             rows_contiguous(b.float()[None]))
        return out[0]

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        return (_bf16(torch.matmul(ct, b.float().transpose(-1, -2))),
                _bf16(torch.matmul(a.float().transpose(-1, -2), ct)))


def matmul_f32(a, b):
    """``jnp.matmul(a, b, preferred_element_type=float32)``: fp32 operands
    as ``torch.matmul``; a bf16 operand beside an fp32 one promoted (its
    cotangent rounded back to bf16); two 2-D bf16 operands by
    ``_ProductF32``."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.dtype == _BF16 and b.dtype == _BF16 and a.dim() == b.dim() == 2:
        return _ProductF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


class _Linear(nn.Linear):
    """nn.Linear with torch's default uniform(-1/sqrt(fan_in), ...) init
    for weight and bias, drawn from an explicit generator. In bf16 the
    product and the bias add are rounded each (XLA's ``dot`` then ``add``;
    ``F.linear`` would round once)."""

    def __init__(self, in_dim, out_dim, generator):
        super().__init__(in_dim, out_dim)
        bound = 1.0 / in_dim ** 0.5
        with torch.no_grad():
            nn.init.uniform_(self.weight, -bound, bound, generator=generator)
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def forward(self, x):
        if x.dtype == _BF16:
            return torch.matmul(x, self.weight.transpose(0, 1)) + self.bias
        return super().forward(x)


class GCN(nn.Module):
    """The reference's Graph-U-Net 'GCN' block: a Linear layer that
    receives the adjacency and ignores it."""

    def __init__(self, in_dim, out_dim, generator=None):
        super().__init__()
        self.proj = _Linear(in_dim, out_dim, generator)

    def forward(self, adj, x):
        del adj
        return self.proj(x)


class GraphPool(nn.Module):
    """Top-k node pooling with a learned score; ``k_out`` kept nodes."""

    def __init__(self, k_out, in_dim, generator=None):
        super().__init__()
        self.k_out = k_out
        self.proj = _Linear(in_dim, 1, generator)

    def forward(self, adj, x):
        logits = self.proj(x).squeeze(-1)
        scores = (pool_scores_bf16(logits) if logits.dtype == _BF16
                  else pool_scores(logits))
        values, idx = topk_desc(scores, self.k_out)
        new_x = x[idx, :] * values[:, None]
        new_adj = adj[..., idx, :][..., :, idx]
        return new_adj, new_x, idx


class GraphUnpool(nn.Module):
    """Scatter pooled features back to their pre-pool node slots."""

    def forward(self, adj, x, idx):
        new_x = x.new_zeros((adj.shape[-1], x.shape[1]))
        new_x[idx] = x
        return adj, new_x


class GraphUnet(nn.Module):
    """start GCN -> (down GCN + pool) x L -> bottom GCN ->
    (unpool + up GCN + skip-add) x L -> concat with the start-GCN output ->
    end GCN. Returns (net_outs, start_gcn_outs)."""

    def __init__(self, ks, in_dim, out_dim, dim=268, generator=None):
        super().__init__()
        self.ks = tuple(ks)
        sizes = pool_sizes(in_dim, ks)
        # registration order = the reference's init draw order
        self.start_gcn = GCN(in_dim, dim, generator)
        self.bottom_gcn = GCN(dim, dim, generator)
        self.end_gcn = GCN(2 * dim, out_dim, generator)
        self.down_gcns = nn.ModuleList(
            GCN(dim, dim, generator) for _ in ks)
        self.up_gcns = nn.ModuleList(
            GCN(dim, dim, generator) for _ in ks)
        self.pools = nn.ModuleList(
            GraphPool(sizes[i], dim, generator)
            for i in range(len(ks)))
        self.unpools = nn.ModuleList(GraphUnpool() for _ in ks)

    def forward(self, adj, x):
        adj_ms, indices_list, down_outs = [], [], []
        x = self.start_gcn(adj, x)
        start_gcn_outs = x
        org_x = x
        for i in range(len(self.ks)):
            x = self.down_gcns[i](adj, x)
            adj_ms.append(adj)
            down_outs.append(x)
            adj, x, idx = self.pools[i](adj, x)
            indices_list.append(idx)
        x = self.bottom_gcn(adj, x)
        for i in range(len(self.ks)):
            up_idx = len(self.ks) - i - 1
            adj, idx = adj_ms[up_idx], indices_list[up_idx]
            adj, x = self.unpools[i](adj, x, idx)
            x = self.up_gcns[i](adj, x)
            x = x + down_outs[up_idx]
        x = torch.cat([x, org_x], dim=1)
        x = self.end_gcn(adj, x)
        return x, start_gcn_outs


class GSRLayer(nn.Module):
    """Spectral super-resolution layer in its collapsed exact form:
    ``b = W U^T``, ``f_d = fill_diag(|b f|, 1)``, ``adj = normalize(f_d)``,
    ``z = |fill_diag(sym(adj adj^T), 1)|``. ``u_lr`` (eigenvectors of the
    normalized LR adjacency) is data; pass it precomputed by the host."""

    def __init__(self, hr_dim, lr_dim, generator=None):
        super().__init__()
        self.lr_dim = lr_dim
        self.weights = nn.Parameter(torch.empty(hr_dim, lr_dim))
        with torch.no_grad():
            nn.init.normal_(self.weights, 0.0, 1.0, generator=generator)

    def forward(self, adj_lr, x, u_lr: Optional[torch.Tensor] = None):
        if u_lr is None:
            _, u_lr = torch.linalg.eigh(adj_lr)
        b_small = matmul_f32(self.weights, u_lr.transpose(-1, -2))
        f_d = matmul_f32(b_small, x[: self.lr_dim]).abs()
        f_d = fill_diagonal(f_d, 1.0)
        adj = normalize_adj(f_d)
        x_out = matmul_f32(adj, adj.transpose(-1, -2))
        x_out = fill_diagonal(symmetrize(x_out), 1.0)
        return adj, x_out.abs()


class GraphConvolution(nn.Module):
    """Dense GCN layer ``adj @ (x @ W)`` with Xavier-uniform init; W is
    stored (in, out) as in the reference."""

    def __init__(self, in_features, out_features, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight, generator=generator)

    def forward(self, x, adj):
        return matmul_f32(adj, matmul_f32(x, self.weight))


class GSRNet(nn.Module):
    """Full GSR-Net. ``forward(lr, u_lr=None, a_norm=None)`` takes one LR
    adjacency (lr_dim, lr_dim) or a batch (B, lr_dim, lr_dim) and returns
    (prediction, net_outs, start_gcn_outs, layer_outputs).

    ``device`` defaults to CUDA and raises without a card unless the
    caller passes ``device="cpu"``; ``seed`` seeds the explicit generator
    of the initialisation."""

    def __init__(self, ks=(0.9, 0.7, 0.6, 0.5), lr_dim=160, hr_dim=268,
                 hidden_dim=268, device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        # build on the host so the explicit CPU generator drives every
        # draw, then move: the same weights on every device
        self.ks = tuple(ks)
        self.lr_dim, self.hr_dim, self.hidden_dim = lr_dim, hr_dim, hidden_dim
        self.layer = GSRLayer(hr_dim, lr_dim, gen)
        # the U-Net width is tied to hr_dim: the composite loss compares
        # net_outs (width out_dim) with start_gcn_outs (width dim)
        self.net = GraphUnet(ks, lr_dim, hr_dim, dim=hr_dim, generator=gen)
        self.gc1 = GraphConvolution(hr_dim, hidden_dim, gen)
        self.gc2 = GraphConvolution(hidden_dim, hr_dim, gen)
        self.to(dev)

    def forward(self, lr, u_lr=None, a_norm=None):
        eye = torch.eye(self.lr_dim, dtype=lr.dtype, device=lr.device)
        adj = normalize_adj(lr) if a_norm is None else a_norm
        net_outs, start_gcn_outs = self.net(adj, eye)
        outputs, z = self.layer(adj, net_outs, u_lr=u_lr)
        hidden1 = self.gc1(z, outputs)
        hidden2 = self.gc2(hidden1, outputs)
        z = fill_diagonal(symmetrize(hidden2), 1.0)
        return z.abs(), net_outs, start_gcn_outs, outputs
