"""The GAT U-Net's fused training step — forward, hand-written backward and
masked AdamW — and its fused validation forward, over a leading fold axis F.

Counterpart of ``fcsr_tpu/models/fused_gat.py``, whose two Mosaic kernels
hold one subject's whole step in VMEM and differentiate their own body. On
the card the step is a sequence of hand-written kernels over device memory
(``kernels/csrc/gat.cu`` and the GSR step's ``bgemm_f32``, ``rank_select``,
``gather_rows``, ``scatter_rows``, ``pool_logits_bwd``): per GAT layer a
projection and ``gat_attention`` (masked multi-head softmax, dropout, the
head's product, bias, relu), per pool the scores' product, one
``rank_select`` launch that ranks and gathers the kept rows, and
``gat_pool_adj``; the upsampler's ``col_softmax``; the
``offdiag_mse`` losses, which also give each product's cotangent; then every
adjoint written out (``gat_attention_bwd``, ``col_softmax_bwd``, the row
scatter / gather) and one ``adamw_masked`` launch over the flat (F, P)
buffers. Dropout masks come from a counter-based Philox generator keyed by
per-fold seeds and are never stored: the attention kernels draw theirs,
and each pool's mask is drawn inside its two products
(``philox_drop_logits``: the masked input and its scores;
``philox_drop_outer``: the masked input adjoint). ``philox_keep_mask``
dumps any mask (``draw_masks``).

As in ``fused_step.py`` the step is written once over an op namespace:
``gat_train_step_fused`` / ``gat_val_fused`` use ``kernels.KERNEL_OPS``
(kernels for CUDA tensors, the plain version for CPU tensors),
``gat_train_step_plain`` / ``gat_val_plain`` always ``kernels.PLAIN_OPS``.
``gat_step_loss`` is the same loss as ordinary differentiable PyTorch, the
oracle the hand-written gradients are held to.

Parameters travel as one flat (F, P) buffer per fold in the canonical leaf
order (``GATLayout``; ``iox.weights.gat_leaf_names``). ``batched_chain``
keeps the JAX flag: its only visible effect is the softmax shift (the row's
maximum over all heads instead of per head), a reassociation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Sequence, Tuple

import torch

from fcsr_tpu_torch.iox.weights import (gat_dims, gat_layer_specs,
                                        gat_leaf_names, gat_leaf_shapes)
from fcsr_tpu_torch.kernels.ops import (KERNEL_OPS, PLAIN_OPS,
                                        gat_attention_math,
                                        gat_pool_adj_plain)
from fcsr_tpu_torch.models.gat_unet import gat_pool_sizes
from fcsr_tpu_torch.models.gsr import topk_desc
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, check_on_device

__all__ = ["ADAM_B1", "ADAM_B2", "GATLayout", "gat_dims", "gat_step_loss",
           "gat_train_step_fused", "gat_train_step_plain", "gat_val_fused",
           "gat_val_plain", "gat_value_and_grads", "draw_masks"]

# One source for the AdamW betas: the update's moments and the bias
# corrections 1 - b^t that the trainer ships in ``scalars`` must use the
# same values.
ADAM_B1 = 0.9
ADAM_B2 = 0.999

_layer_specs = gat_layer_specs


def _mask_shapes(dim: int, ks: Sequence[float], n_nodes: int, heads: int):
    """(name, per-head count, (rows, cols)) of every dropout mask, in the
    order the step consumes them; a mask's place in this list is its
    ``mask_id`` in the generator's counter."""
    L = len(ks)
    dims = gat_dims(dim, ks)
    sizes = (n_nodes,) + gat_pool_sizes(n_nodes, ks)
    shapes = []
    for i in range(L):
        shapes.append((f"att_down_{i}", heads, (sizes[i], sizes[i])))
        shapes.append((f"pool_{i}", 1, (sizes[i], dims[i + 1])))
    shapes.append(("att_bottom", 2, (sizes[L], sizes[L])))
    for i in range(L):
        up = L - i - 1
        shapes.append((f"att_up_{i}", heads, (sizes[up], sizes[up])))
    return shapes


def _att_mask_name(module: str) -> str:
    """``down_gcns_1`` -> ``att_down_1``, ``bottom_gcn`` -> ``att_bottom``."""
    return "att_" + module.replace("_gcns", "").replace("_gcn", "")


@lru_cache(maxsize=16)
def _check_widths(dim, ks, heads):
    for name, _, out_d, h in _layer_specs(int(dim), tuple(ks), int(heads)):
        if out_d % h:
            raise ValueError(
                f"GAT level '{name}' has width {out_d} not divisible by "
                f"its head count {h}; pick dim/ks so every level width "
                f"int(dim/k...) is a multiple of heads (and the bottom "
                f"width a multiple of 2)")


def _offdiag_mse(pred, target):
    """Mean over all n^2 entries of the squared difference with the
    diagonal zeroed (``train.losses.offdiag_mse_loss``; the models do not
    import the trainers)."""
    eye = torch.eye(pred.shape[-1], dtype=torch.bool, device=pred.device)
    return ((pred - target).masked_fill(eye, 0.0) ** 2).mean(dim=(-2, -1))


@dataclass(frozen=True)
class GATLayout:
    """Offsets of the step's leaves in one flat (P,) vector per fold."""
    dim: int
    ks: Tuple[float, ...]
    heads: int
    n_nodes: int
    m_nodes: int

    @cached_property
    def names(self):
        return gat_leaf_names(len(self.ks))

    @cached_property
    def shapes(self):
        return gat_leaf_shapes(self.dim, self.ks, self.heads, self.n_nodes,
                               self.m_nodes)

    @cached_property
    def size(self) -> int:
        return sum(r * c for r, c in self.shapes)

    def views(self, flat: torch.Tensor, batch: int = None) -> dict:
        """name -> (F, r, c) view into a contiguous (F, P) buffer; with
        ``batch`` a (1, P) buffer is expanded to that many folds (batch
        stride 0: every subject of a batch reads one model)."""
        if flat.dim() != 2 or flat.shape[1] != self.size \
                or not flat.is_contiguous():
            raise ValueError(f"expected a contiguous (F, {self.size}) "
                             f"buffer, got {tuple(flat.shape)}")
        out, off = {}, 0
        for name, (r, c) in zip(self.names, self.shapes):
            v = flat[:, off:off + r * c].view(flat.shape[0], r, c)
            if batch is not None and flat.shape[0] == 1:
                v = v.expand(batch, r, c)
            out[name] = v
            off += r * c
        return out


# ---------------------------------------------------------------------------
# the plain loss: ordinary differentiable PyTorch
# ---------------------------------------------------------------------------

def gat_step_loss(leaves, a0, x0, hr, *, dim: int, ks: Sequence[float],
                  n_nodes: int, m_nodes: int, heads: int,
                  intermediate_losses: bool = True, drop_p: float = 0.0,
                  drop_masks=None, batched_chain: bool = False,
                  return_pred: bool = False):
    """The GAT U-Net's training loss as a differentiable function of the
    canonical leaf list: 2-D leaves with ``a0`` (n, n) the normalized
    (A + I) adjacency, ``x0`` (n, dim) the node features and ``hr`` (m, m)
    give a scalar; a leading fold axis on everything gives one loss per
    fold. ``drop_masks`` (optional) maps a mask name (``_mask_shapes``) to
    its keep masks, (count, rows, cols) per fold. The kept indices carry no
    gradient; the kept scores do."""
    del m_nodes
    squeeze = leaves[0].dim() == 2
    if squeeze:
        leaves = [t[None] for t in leaves]
        a0, x0, hr = a0[None], x0[None], hr[None]
        if drop_masks is not None:
            drop_masks = {k: m[None] for k, m in drop_masks.items()}
    L = len(ks)
    sizes = gat_pool_sizes(n_nodes, ks)
    specs = _layer_specs(dim, ks, heads)
    lv = {name: leaves[4 * j:4 * j + 4]
          for j, (name, _, _, _) in enumerate(specs)}
    k = 4 * len(specs)
    pools = [leaves[k + 2 * i:k + 2 * i + 2] for i in range(L)]
    uw, ub = leaves[k + 2 * L:k + 2 * L + 2]
    scale = 1.0 / (1.0 - drop_p)

    def layer(name, a, x):
        w, asrc, adst, b = lv[name]
        m = None if drop_masks is None else drop_masks.get(
            _att_mask_name(name))
        y, _ = gat_attention_math(
            torch.matmul(x, w), asrc, adst, b, a,
            None if m is None else (m, scale), batched_chain)
        return y

    a, x = a0, x0
    a_hist, kept = [], []
    for i in range(L):
        x = layer(f"down_gcns_{i}", a, x)
        a_hist.append(a)
        z = x
        pm = None if drop_masks is None else drop_masks.get(f"pool_{i}")
        if pm is not None:
            z = x * pm[:, 0] * scale
        pw, pb = pools[i]
        scores = torch.sigmoid((torch.matmul(z, pw) + pb).squeeze(-1))
        vals, idx = topk_desc(scores, sizes[i])
        kept.append(idx)
        x = torch.take_along_dim(x, idx[..., None], dim=1) * vals[..., None]
        a = gat_pool_adj_plain(a, idx)
    x = layer("bottom_gcn", a, x)
    recon = []
    for i in range(L):
        up = L - i - 1
        xu = x.new_zeros(x.shape[0], a_hist[up].shape[-1], x.shape[-1])
        x = xu.scatter(1, kept[up][..., None].expand_as(x), x)
        x = layer(f"up_gcns_{i}", a_hist[up], x)
        recon.append(torch.relu(torch.matmul(x, x.transpose(1, 2))))
    # the upsampler in (feat, m) layout: softmax over the features of each
    # column, then relu(Q^T Q)
    q = torch.softmax(torch.matmul(x.transpose(1, 2), uw) + ub, dim=1)
    pred = torch.relu(torch.matmul(q.transpose(1, 2), q))
    loss = _offdiag_mse(pred, hr)
    if intermediate_losses:
        for l in range(L):
            loss = loss + _offdiag_mse(a_hist[l], recon[L - 1 - l])
    if squeeze:
        loss, pred = loss[0], pred[0]
    return (loss, pred) if return_pred else loss


def draw_masks(seeds, *, dim: int, ks: Sequence[float], n_nodes: int,
               heads: int, drop_p: float):
    """Every keep mask the step draws under ``seeds`` (F, 2) int32, as
    ``gat_step_loss`` takes them: name -> (F, count, rows, cols) of 0 / 1
    (``philox_keep_mask`` dumps what the kernels regenerate)."""
    return {name: KERNEL_OPS.philox_keep_mask(seeds, j, count, rows, cols,
                                              drop_p)
            for j, (name, count, (rows, cols)) in enumerate(
                _mask_shapes(dim, ks, n_nodes, heads))}


# ---------------------------------------------------------------------------
# the step over an op namespace: forward, adjoints, AdamW
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Spec:
    dim: int
    ks: Tuple[float, ...]
    n_nodes: int
    m_nodes: int
    heads: int
    intermediate: bool
    drop_p: float
    batched_chain: bool

    @cached_property
    def mask_ids(self):
        return {name: j for j, (name, _, _) in enumerate(_mask_shapes(
            self.dim, self.ks, self.n_nodes, self.heads))}


def _forward(ops, P, a0, x0, hr, spec: _Spec, seeds, train: bool):
    """The U-Net forward and its loss terms. Returns (vals, res): ``vals``
    (F, 1 + L) = [mse(pred, hr), the L intermediate reconstruction MSEs]
    (one column without them) and the residuals of the backward; with
    ``train=False`` dropout is off, no attention is kept and ``res`` holds
    only the prediction's product ``g_pred``."""
    L = len(spec.ks)
    F = a0.shape[0]
    sizes = gat_pool_sizes(spec.n_nodes, spec.ks)
    ids = spec.mask_ids
    drop_p = spec.drop_p if train else 0.0
    scale = 1.0 / (1.0 - drop_p)
    bg = ops.bgemm

    def layer(mod, a, x):
        h = bg(x, P[f"{mod}.w"])
        y, alpha = ops.gat_attention(
            h, P[f"{mod}.att_src"], P[f"{mod}.att_dst"], P[f"{mod}.bias"],
            a, seeds, ids[_att_mask_name(mod)], drop_p, spec.batched_chain,
            need_alpha=train)
        return y, (x, h, y, alpha)

    res = {"down": [], "pool": [], "up": [], "a_hist": []}
    a, x = a0, x0
    for i in range(L):
        x, rec = layer(f"down_gcns_{i}", a, x)
        res["down"].append(rec)
        res["a_hist"].append(a)
        if drop_p > 0:       # the mask drawn inside the scores' product
            z, logits = ops.philox_drop_logits(
                x, P[f"pools_{i}.kernel"], P[f"pools_{i}.bias"], seeds,
                ids[f"pool_{i}"], drop_p, scale)
        else:
            z = x
            logits = bg(x, P[f"pools_{i}.kernel"],
                        bias=P[f"pools_{i}.bias"])
        s, idx, vals, slot, pre, xp = ops.rank_select(logits.view(F, -1),
                                                      sizes[i], 1.0, src=x)
        a = ops.gat_pool_adj(a, idx)
        res["pool"].append((z, s, idx, vals, slot, pre))
        x = xp
    x, res["bottom"] = layer("bottom_gcn", a, x)
    recon = []
    for i in range(L):
        up = L - i - 1
        xu = ops.scatter_rows(x, res["pool"][up][4])
        x, rec = layer(f"up_gcns_{i}", res["a_hist"][up], xu)
        res["up"].append(rec)
        if spec.intermediate:
            recon.append(bg(x, x, tb=True))                  # X X^T, raw
    y = bg(x, P["upsampler.kernel"], ta=True, bias=P["upsampler.bias"])
    q = ops.col_softmax(y)                                   # (F, feat, m)
    g_pred = bg(q, q, ta=True)                               # Q^T Q, raw
    vals = torch.empty(F, 1 + (L if spec.intermediate else 0),
                       dtype=torch.float32, device=a0.device)
    res["q"], res["g_pred"] = q, g_pred
    res["ct_pred"] = ops.offdiag_mse(g_pred, hr, vals, 0, grad=train)
    res["ct_recon"] = [None] * L
    if spec.intermediate:
        for l in range(L):
            i = L - 1 - l
            res["ct_recon"][i] = ops.offdiag_mse(
                recon[i], res["a_hist"][l], vals, 1 + l, grad=train)
    return vals, res


def _backward(ops, P, G, res, spec: _Spec, seeds):
    """Every adjoint of ``_forward``; writes each leaf's gradient into its
    view of ``G``. The pooled adjacencies depend on the data and on the
    selection only, so no gradient flows through them."""
    L = len(spec.ks)
    ids = spec.mask_ids
    drop_p = spec.drop_p
    scale = 1.0 / (1.0 - drop_p)
    bg = ops.bgemm

    def layer_bwd(mod, rec, g_y, need_input=True):
        x_in, h, y, alpha = rec
        g_h = ops.gat_attention_bwd(
            g_y, y, alpha, h, P[f"{mod}.att_src"], P[f"{mod}.att_dst"],
            seeds, ids[_att_mask_name(mod)], drop_p, G[f"{mod}.att_src"],
            G[f"{mod}.att_dst"], G[f"{mod}.bias"])
        bg(x_in, g_h, ta=True, out=G[f"{mod}.w"])
        return bg(g_h, P[f"{mod}.w"], tb=True) if need_input else None

    q = res["q"]
    x_fin = res["up"][-1][2]
    g_y = ops.col_softmax_bwd(bg(q, res["ct_pred"]), q)
    bg(x_fin, g_y, out=G["upsampler.kernel"])
    bg(None, g_y, out=G["upsampler.bias"])
    g_x = bg(P["upsampler.kernel"], g_y, tb=True)
    for i in reversed(range(L)):
        up = L - i - 1
        rec = res["up"][i]
        if spec.intermediate:
            g_x = bg(res["ct_recon"][i], rec[2], add=g_x)
        g_xu = layer_bwd(f"up_gcns_{i}", rec, g_x)
        g_x = ops.gather_rows(g_xu, res["pool"][up][2])
    g_x = layer_bwd("bottom_gcn", res["bottom"], g_x)
    for i in reversed(range(L)):
        z, s, _, vals, slot, pre = res["pool"][i]
        gl = ops.pool_logits_bwd(g_x, pre, slot, s, 1.0)
        gl = gl.view(gl.shape[0], -1, 1)
        bg(z, gl, ta=True, out=G[f"pools_{i}.kernel"])
        bg(None, gl, out=G[f"pools_{i}.bias"])
        if drop_p > 0:
            g_z = ops.philox_drop_outer(gl, P[f"pools_{i}.kernel"], seeds,
                                        ids[f"pool_{i}"], drop_p, scale)
        else:
            g_z = bg(gl, P[f"pools_{i}.kernel"], tb=True)
        g_y = ops.scatter_rows(g_x, slot, vals, g_z)
        g_x = layer_bwd(f"down_gcns_{i}", res["down"][i], g_y,
                        need_input=i > 0)


def _spec_and_layout(dim, ks, n_nodes, m_nodes, heads, intermediate_losses,
                     drop_p, batched_chain):
    return _spec_and_layout_cached(dim, tuple(ks), n_nodes, m_nodes, heads,
                                   intermediate_losses, drop_p, batched_chain)


@lru_cache(maxsize=16)
def _spec_and_layout_cached(dim, ks, n_nodes, m_nodes, heads,
                            intermediate_losses, drop_p, batched_chain):
    _check_widths(dim, ks, heads)
    if not 0.0 <= drop_p < 1.0:
        raise ValueError(f"drop_p must be in [0, 1), got {drop_p}")
    return (_Spec(int(dim), ks, int(n_nodes), int(m_nodes), int(heads),
                  bool(intermediate_losses), float(drop_p),
                  bool(batched_chain)),
            GATLayout(int(dim), ks, int(heads), int(n_nodes), int(m_nodes)))


def _check_data(what, F, spec, a0, x0, hr, seeds=None):
    n, m = spec.n_nodes, spec.m_nodes
    for name, t, shape in (("a0", a0, (n, n)), ("x0", x0, (n, spec.dim)),
                           ("hr", hr, (m, m))):
        if tuple(t.shape) != (F,) + shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {(F,) + shape}")
    if spec.drop_p > 0 and (seeds is None
                            or tuple(seeds.shape) != (F, 2)
                            or seeds.dtype != torch.int32):
        raise ValueError(f"{what}: drop_p > 0 needs int32 seeds of shape "
                         f"({F}, 2)")


def gat_value_and_grads(ops, p, a0, x0, hr, seeds=None, *, dim, ks, n_nodes,
                        m_nodes, heads, intermediate_losses=True,
                        drop_p=0.0, batched_chain=False):
    """(vals, g): the step's loss terms (F, 1 + L) and the flat (F, P)
    gradient of their sum, by the hand-written adjoints over ``ops``."""
    spec, layout = _spec_and_layout(dim, ks, n_nodes, m_nodes, heads,
                                    intermediate_losses, drop_p,
                                    batched_chain)
    _check_data("gat step", p.shape[0], spec, a0, x0, hr, seeds)
    g = torch.empty_like(p)
    P = layout.views(p)
    vals, res = _forward(ops, P, a0.contiguous(), x0.contiguous(),
                         hr.contiguous(), spec, seeds, train=True)
    _backward(ops, P, layout.views(g), res, spec, seeds)
    return vals, g


def _step_with_ops(ops, p, m, v, a0, x0, hr, scalars, seeds, b1, b2, eps,
                   wd, **kw):
    _check_widths(kw["dim"], tuple(kw["ks"]), kw["heads"])
    F = p.shape[0]
    for name, t in (("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p has "
                             f"{tuple(p.shape)}")
    if tuple(scalars.shape) != (F, 4):
        raise ValueError(f"scalars has shape {tuple(scalars.shape)}, "
                         f"expected {(F, 4)}")
    vals, g = gat_value_and_grads(ops, p, a0, x0, hr, seeds, **kw)
    p2, m2, v2, loss = ops.adamw_masked(p, m, v, g, scalars, vals, b1, b2,
                                        eps, wd)
    return loss, p2, m2, v2


def gat_train_step_fused(p, m, v, a0, x0, hr, scalars, seeds=None, *,
                         dim: int, ks: Sequence[float], n_nodes: int,
                         m_nodes: int, heads: int,
                         intermediate_losses: bool = True,
                         drop_p: float = 0.0, b1: float = ADAM_B1,
                         b2: float = ADAM_B2, eps: float = 1e-8,
                         wd: float = 0.01, batched_chain: bool = False,
                         device=DEFAULT_DEVICE):
    """One fold-batched GAT U-Net training step on one subject per fold:
    forward, hand-written backward and the masked AdamW update.

    ``p``, ``m``, ``v``: (F, P) float32 flat buffers in ``GATLayout``
    order; ``a0`` (F, n, n) the normalized (A + I) adjacencies, ``x0``
    (F, n, dim) the node features, ``hr`` (F, m, m); ``scalars`` (F, 4) =
    [ok, lr, 1 - b1^t, 1 - b2^t] per fold, read on the device (ok = 0
    leaves the fold's p, m, v unchanged); ``seeds`` (F, 2) int32 key the
    dropout masks (unused at ``drop_p = 0``). Returns (loss (F,), p', m',
    v'); the loss is not multiplied by ok.

    On ``device="cuda"`` (the default) every tensor must be on the card
    and the step launches only the hand-written kernels; ``device="cpu"``
    runs their plain versions."""
    check_on_device("gat_train_step_fused", device, p, m, v, a0, x0, hr,
                    scalars, *(() if seeds is None else (seeds,)))
    return _step_with_ops(
        KERNEL_OPS, p, m, v, a0, x0, hr, scalars, seeds, b1, b2, eps, wd,
        dim=dim, ks=ks, n_nodes=n_nodes, m_nodes=m_nodes, heads=heads,
        intermediate_losses=intermediate_losses, drop_p=drop_p,
        batched_chain=batched_chain)


def gat_train_step_plain(p, m, v, a0, x0, hr, scalars, seeds=None, *,
                         b1: float = ADAM_B1, b2: float = ADAM_B2,
                         eps: float = 1e-8, wd: float = 0.01, **kw):
    """The same step in plain PyTorch on any device (the reference the
    CUDA kernels are held to), drawing the same dropout masks."""
    return _step_with_ops(PLAIN_OPS, p, m, v, a0, x0, hr, scalars, seeds,
                          b1, b2, eps, wd, **kw)


def _val_with_ops(ops, p, a0, x0, hr, *, dim, ks, n_nodes, m_nodes, heads,
                  intermediate_losses=True, batched_chain=False):
    spec, layout = _spec_and_layout(dim, ks, n_nodes, m_nodes, heads,
                                    intermediate_losses, 0.0, batched_chain)
    B = a0.shape[0]
    if p.dim() == 1:
        p = p[None]
    if p.shape[0] not in (1, B):
        raise ValueError(f"{p.shape[0]} models for {B} subjects: pass one "
                         f"model or one per subject")
    _check_data("gat validation", B, spec, a0, x0, hr)
    hr = hr.contiguous()
    vals, res = _forward(ops, layout.views(p, batch=B), a0.contiguous(),
                         x0.contiguous(), hr, spec, None, train=False)
    mae = torch.empty(B, 1, dtype=torch.float32, device=a0.device)
    ops.offdiag_mae(res["g_pred"], hr, mae, 0)
    loss = vals[:, 0]
    for j in range(1, vals.shape[1]):
        loss = loss + vals[:, j]
    return loss, mae[:, 0]


def gat_val_fused(p, a0, x0, hr, *, dim: int, ks: Sequence[float],
                  n_nodes: int, m_nodes: int, heads: int,
                  intermediate_losses: bool = True,
                  batched_chain: bool = False, device=DEFAULT_DEVICE):
    """Validation forwards (dropout off, no gradient) of a batch of B
    subjects on the step's forward kernels: (loss (B,), mae (B,)), the
    training objective and the off-diagonal mean absolute error over all
    m^2 entries. ``p`` is one model, (P,) or (1, P), read by every subject
    (batch stride 0 on each weight operand, so one launch serves the
    batch), or one model per subject (B, P).

    On ``device="cuda"`` (the default) every tensor must be on the card;
    ``device="cpu"`` runs the kernels' plain versions."""
    check_on_device("gat_val_fused", device, p, a0, x0, hr)
    return _val_with_ops(KERNEL_OPS, p, a0, x0, hr, dim=dim, ks=ks,
                         n_nodes=n_nodes, m_nodes=m_nodes, heads=heads,
                         intermediate_losses=intermediate_losses,
                         batched_chain=batched_chain)


def gat_val_plain(p, a0, x0, hr, **kw):
    """``gat_val_fused`` in plain PyTorch on any device."""
    return _val_with_ops(PLAIN_OPS, p, a0, x0, hr, **kw)
