"""The whole GSR-Net training step — U-Net forward, spectral tail value and
gradient, the lmbda * L1(net, start) term, the hand-written U-Net
adjoints and the masked Adam update — over a leading fold axis F.

Counterpart of ``fcsr_tpu/models/fused_step.py::train_step_fused``, which
runs the step as ONE Mosaic kernel holding p, m and v for all folds in
VMEM. An H100 block has at most 227 KB of shared memory, so on the card
the step is a short sequence of hand-written kernels over device memory
(``kernels/csrc``): ``bgemm_f32`` for every product, ``rank_select``
(one launch per pool: scores, ranks and the gathered rows) and the row
gather/scatter helpers of unpooling and the adjoints, the ``tail_*`` and
``sym_*`` elementwise passes and ``l1_term`` for the tail, and one
``adam_masked`` launch over the flat (F, P) buffers.

Top-k pooling is a rank-select that yields INDICES (rank = compare-sum,
ties to the lower index), so pooling is a gather and unpooling a scatter;
both are exact, unlike the one-hot matmuls the TPU kernel needed.

The step is written once over an ``ops`` namespace: ``train_step_fused``
uses ``kernels.ops.mode_ops()`` (kernels for CUDA tensors, the plain
version for CPU tensors), ``train_step_plain`` always the plain versions
(the reference the kernels are held to on the card). The namespace
follows ``core.mm_mode.MODE``: IEEE fp32 products in the compensated modes
(``KERNEL_OPS``), single-pass bf16 products and the rounding instances of
the pool, row and bias kernels under ``FCSR_MM_MODE=bf16``
(``KERNEL_OPS_BF16``), where the JAX package runs every in-kernel product
through ``mm_bf16``. The map from each launch to the JAX line it stands
for is beside ``unet_forward`` and ``unet_backward`` (the tail's in
``fused_tail.py``).

The JAX package's other fused entry points are the same launches behind
their own signatures and gradient contracts (``jax.custom_vjp`` there,
``torch.autograd.Function`` here): ``unet_fused_fwdbwd`` (forward keeping
the residuals, hand-written adjoints), ``unet_fused_fwdonly`` (the forward
kernels, backward by autograd over a rematerialised plain forward),
``unet_fused`` (the backward launches the forward again, then the
adjoints), ``gsr_step_loss_fused`` (the step without its Adam launch; value
and every gradient in the forward, scaled in the backward) and
``step_value_and_grad_fused`` (the same over a ``state_dict``).
``unet_forward_rankselect`` and ``step_loss_pure`` are their oracle in
ordinary differentiable PyTorch.

Entry points take the U-Net's parameters as a mapping of leaf tensors
under ``iox.weights.leaf_names`` — Linear kernels (in, out) with
``end_gcn`` in halves, biases (1, out) — which is what
``FlatLayout.views`` gives for a flat buffer, uncopied. 2-D leaves are one
model, a leading axis F a fold batch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fcsr_tpu_torch.iox.weights import (TAIL_NAMES, leaf_names,
                                        leaf_tensors_to_state,
                                        state_to_leaf_tensors)
from fcsr_tpu_torch.core import mm_mode
from fcsr_tpu_torch.kernels.ops import mode_ops, pool_scores, rows_contiguous
from fcsr_tpu_torch.models.fused_tail import _tail_loss, tail_value_and_grad
from fcsr_tpu_torch.models.gsr import pool_sizes, topk_desc
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, check_on_device

__all__ = ["leaf_specs", "FlatLayout", "unet_forward", "unet_backward",
           "step_value_and_grads", "step_with_ops", "train_step_fused",
           "train_step_plain", "adam_scalars", "unet_forward_rankselect",
           "step_loss_pure", "unet_fused", "unet_fused_fwdonly",
           "unet_fused_fwdbwd", "gsr_step_loss_fused",
           "step_value_and_grad_fused", "HIDDEN_REFUSAL"]


def leaf_specs(lr_dim: int, hr_dim: int, n_levels: int,
               hidden_dim: Optional[int] = None
               ) -> List[Tuple[str, Tuple[int, int]]]:
    """(name, shape) of the training kernels' 34 leaves (at 4 levels), in
    the JAX kernel's order (``_unet_leaf_shapes(tail=True)``): Linear
    kernels as (in, out) with ``end_gcn`` split in halves, biases staged
    (1, out), then the tail's w_gsr (hr, lr), w1 (hr, h) and w2 (h, hr),
    h = ``hidden_dim`` (default ``hr_dim``, the only width the JAX
    kernels' out-shapes take)."""
    n, m = lr_dim, hr_dim
    h = m if hidden_dim is None else hidden_dim
    tail = {"layer.weights": (m, n), "gc1.weight": (m, h),
            "gc2.weight": (h, m)}

    def shape(name):
        kind, _, module = name.partition(":")
        pool = module.startswith("pools_")
        if kind == "w":
            return (n, m) if module == "start_gcn" else (m, 1 if pool else m)
        if kind == "b":
            return (1, 1 if pool else m)
        return tail[name]

    return [(name, shape(name)) for name in leaf_names(n_levels)]


@dataclass(frozen=True)
class FlatLayout:
    """Offsets of the kernel leaves in one flat (P,) vector per fold;
    ``hidden_dim`` (None: ``hr_dim``) is the decoder's width, gc1's
    columns and gc2's rows."""
    lr_dim: int
    hr_dim: int
    n_levels: int
    hidden_dim: Optional[int] = None

    def __post_init__(self):
        if self.hidden_dim is None:
            object.__setattr__(self, "hidden_dim", self.hr_dim)

    @property
    def specs(self):
        return leaf_specs(self.lr_dim, self.hr_dim, self.n_levels,
                          self.hidden_dim)

    @property
    def shapes(self):
        return [shape for _, shape in self.specs]

    @property
    def size(self) -> int:
        return sum(r * c for _, (r, c) in self.specs)

    def views(self, flat: torch.Tensor) -> dict:
        """name -> (F, r, c) view into a contiguous (F, P) buffer."""
        if flat.dim() != 2 or flat.shape[1] != self.size \
                or not flat.is_contiguous():
            raise ValueError(f"expected a contiguous (F, {self.size}) "
                             f"buffer, got {tuple(flat.shape)}")
        out, off = {}, 0
        for name, (r, c) in self.specs:
            out[name] = flat[:, off:off + r * c].view(flat.shape[0], r, c)
            off += r * c
        return out


def unet_forward(ops, W, B, sizes):
    """U-Net forward on the leaf views ``W``/``B`` (name -> (F, r, c)).
    Returns (net, x0, residuals) with the per-level residuals the
    backward consumes.

    Each launch against ``fcsr_tpu/models/fused_step.py::_unet_fwd_math``
    (what its ``mm`` rounds under ``FCSR_MM_MODE=bf16``, which the
    ``*_bf16`` ops round too): ``add_bias`` is ``lin(start_gcn, eye)``
    (:361-364: eye exact, W rounded, b added in fp32); each level's first
    ``bgemm`` is ``lin(down)`` (:373, x and W rounded, b not), its second
    the pool logits ``mm(d, w_pool) + mm(ones, b_pool)`` (:379-380, the
    bias rounded too: ``bias_operand``); ``rank_select`` is the score
    (fp32, :381-382), ``_topk_projection`` (:383) and the products
    ``mm(P, s)``, ``mm(P, d)`` (:384-386: kept scores and rows rounded),
    ``x = pre * ks`` (:387, exact); ``lin(bottom)`` (:390); per level up,
    ``scatter_rows`` is ``mm(P^T, x)`` (:394, the rows rounded) and the
    ``bgemm`` ``lin(up) + d`` (:396-397); the last two are ``lin(end_gcn,
    [x, x0])`` split at hr (:399-400). 3 + 3 L products (15 at L = 4),
    L pools and L scatters."""
    L = len(sizes)
    bg = ops.bgemm
    x0 = ops.add_bias(W["w:start_gcn"], B["b:start_gcn"])   # I W + b
    x = x0
    res = {"d": [], "s": [], "idx": [], "vals": [], "slot": [], "pre": [],
           "pooled": [], "xu": [None] * L}
    for i in range(L):
        d = bg(x, W[f"w:down_gcns_{i}"], bias=B[f"b:down_gcns_{i}"])
        logits = bg(d, W[f"w:pools_{i}"], bias=B[f"b:pools_{i}"],
                    bias_operand=True)
        s, idx, vals, slot, pre, x = ops.rank_select(
            logits.view(d.shape[0], -1), sizes[i], src=d)
        for key, val in zip(("d", "s", "idx", "vals", "slot", "pre",
                             "pooled"), (d, s, idx, vals, slot, pre, x)):
            res[key].append(val)
    x = bg(x, W["w:bottom_gcn"], bias=B["b:bottom_gcn"])
    for i in range(L):
        up = L - i - 1
        res["xu"][up] = ops.scatter_rows(x, res["slot"][up])
        x = bg(res["xu"][up], W[f"w:up_gcns_{i}"], bias=B[f"b:up_gcns_{i}"],
               add=res["d"][up])
    res["xf"] = x
    net = bg(x, W["w:end_gcn_a"], bias=B["b:end_gcn"])
    net = bg(x0, W["w:end_gcn_b"], add=net, out=net)
    return net, x0, res


def unet_backward(ops, W, GW, GB, x0, res, ct_net, ct_start, ad=False):
    """Hand-written U-Net adjoints (the JAX package's ``_unet_bwd_math``)
    against the forward's residuals; writes every U-Net weight and bias
    gradient into the views ``GW``/``GB``.

    Each launch against ``fcsr_tpu/models/fused_step.py``: every
    ``bgemm`` of a weight or input gradient is a product with both
    operands rounded under bf16; every ``bgemm(None, g)`` is ``colsum(g) =
    mm(ones, g)`` (:417-418, a column sum of bf16(g)). End (:421-425):
    dWa, dWb, db, g_x, g_org (+ ct_start, :465-466). Per level up
    (:431-437): dW_up, db_up, g_xu, and ``gather_rows`` is ``mm(P, g_xu)``
    (:437, the rows rounded). Bottom (:440-442): dW, db, g_p. Per level
    down (:446-464): ``pool_bwd_pair`` is ``g_d = mm(P^T, g_p * ks)``
    (:453, :455, the scaled rows rounded; g_skip added here, :460) and
    ``g_logits`` from ``g_ks = mm(g_p * pre, ones)`` and ``mm(P^T, g_ks)``
    (:454, :456: each product g_p * pre rounded before the row sum, the
    sum rounded) times ``s (1 - s) / 100`` in fp32 (:457); then dW_pool,
    db_pool (:458-459), the rank-1 ``mm(g_logits, w_pool^T)`` into g_d
    (:460), dW_down, db_down and g_p (:462-464), at level 0 written as
    dW_start = g_p + g_org + ct_start (:467-468, unrounded) and db_start
    (:469). 9 + 9 L products (45 at L = 4; with the forward's 15 and the
    tail's 19 the step's 79), L pairs and L gathers.

    ``ad`` (the bf16 mode's ``unet_fused`` and ``step_value_and_grad_fused``,
    whose JAX kernels differentiate the forward with ``jax.vjp``): the
    same adjoints rounded where that autodiff rounds them (PERF.md):
    each bias gradient but the pools' an fp32 column sum of the unrounded
    cotangent (``colsum_f32``; the pools' bias is a product's operand,
    :380), the pair's dot a sum of unrounded products (``pool_bwd_pair_ad``,
    :387), and dW_start = mm(I, g_x0) (:361, rounded), its bias the sum of
    the unrounded g_x0."""
    L = len(res["d"])
    bg = ops.bgemm

    def bias_grad(g, out):
        if ad:
            return ops.colsum_f32(g, out=out)
        return bg(None, g, out=out)

    pair = ops.pool_bwd_pair_ad if ad else ops.pool_bwd_pair
    xf = res["xf"]
    bg(xf, ct_net, ta=True, out=GW["w:end_gcn_a"])
    bg(x0, ct_net, ta=True, out=GW["w:end_gcn_b"])
    bias_grad(ct_net, GB["b:end_gcn"])
    g = bg(ct_net, W["w:end_gcn_a"], tb=True)
    g_org = bg(ct_net, W["w:end_gcn_b"], tb=True, add=ct_start)
    g_skip = [None] * L
    for i in reversed(range(L)):
        up = L - i - 1
        g_skip[up] = g
        bg(res["xu"][up], g, ta=True, out=GW[f"w:up_gcns_{i}"])
        bias_grad(g, GB[f"b:up_gcns_{i}"])
        g_xu = bg(g, W[f"w:up_gcns_{i}"], tb=True)
        g = ops.gather_rows(g_xu, res["idx"][up])
    bg(res["pooled"][L - 1], g, ta=True, out=GW["w:bottom_gcn"])
    bias_grad(g, GB["b:bottom_gcn"])
    g_p = bg(g, W["w:bottom_gcn"], tb=True)
    for i in reversed(range(L)):
        # the unpool of g_p (scaled by the kept scores, plus the skip) and
        # the adjoint to the logits in one launch: both read g_p by slot
        g_d, g_logits = pair(g_p, res["pre"][i], res["slot"][i], res["s"][i],
                             res["vals"][i], g_skip[i])
        gl = g_logits.view(g_logits.shape[0], -1, 1)
        bg(res["d"][i], gl, ta=True, out=GW[f"w:pools_{i}"])
        bg(None, gl, out=GB[f"b:pools_{i}"])
        g_d = bg(gl, W[f"w:pools_{i}"], tb=True, add=g_d, out=g_d)
        x_in = x0 if i == 0 else res["pooled"][i - 1]
        bg(x_in, g_d, ta=True, out=GW[f"w:down_gcns_{i}"])
        bias_grad(g_d, GB[f"b:down_gcns_{i}"])
        if i > 0:
            g_p = bg(g_d, W[f"w:down_gcns_{i}"], tb=True)
        elif ad:
            # g_x0 = g_p + g_org + ct_start; dW_start = mm(I, g_x0)
            g_x0 = bg(g_d, W[f"w:down_gcns_{i}"], tb=True, add=g_org)
            ops.colsum_f32(g_x0, out=GB["b:start_gcn"])
            bg(_identity(x0.shape[0], x0.shape[1], x0.device), g_x0,
               out=GW["w:start_gcn"])
        else:
            # start_gcn's input is the identity: dW = g_p + g_org + ct_start
            bg(g_d, W[f"w:down_gcns_{i}"], tb=True, add=g_org,
               out=GW["w:start_gcn"])
    if not ad:
        bg(None, GW["w:start_gcn"], out=GB["b:start_gcn"])


@functools.lru_cache(maxsize=8)
def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=device)


def _identity(F: int, n: int, device) -> torch.Tensor:
    """(F, n, n) identity matrices (one, broadcast over the folds)."""
    return _eye(n, device).expand(F, n, n)


def step_value_and_grads(ops, P, G, u_lr, u_hr, hr, sizes, lmbda,
                         loss=None, recon=None, ad=False):
    """Value and every gradient of the step's loss over the op namespace
    ``ops``: U-Net forward, lmbda * L1(net, start), the tail's value and
    gradients, the U-Net adjoints. ``P`` and ``G`` map leaf names to
    (F, r, c) tensors; every gradient is written into its ``G`` tensor.
    With ``loss`` and ``recon`` (F,) the tail's last loss term also writes
    the step's loss and recon into them (no launch of their own). ``ad``:
    the U-Net adjoints rounded as autodiff rounds them (``unet_backward``).
    Returns the loss terms (F, 3) = [lmbda * L1, recon, spectral]."""
    w_start = P["w:start_gcn"]
    F, lr_dim, hr_dim = w_start.shape
    vals = torch.empty(F, 3, dtype=torch.float32, device=w_start.device)
    net, x0, res = unet_forward(ops, P, P, sizes)
    # lmbda * L1(net, start): value into vals[:, 0], sign adjoints
    g_l1, neg_g_l1 = ops.l1_term(net, x0, vals, 0, lmbda,
                                 lmbda / (lr_dim * hr_dim), True, neg=True)
    _, _, _, ct_net = tail_value_and_grad(
        ops, P["layer.weights"], P["gc1.weight"], P["gc2.weight"], net,
        u_lr, u_hr, hr, vals, g_wgsr=G["layer.weights"],
        g_w1=G["gc1.weight"], g_w2=G["gc2.weight"], g_f_add=g_l1, loss=loss,
        recon=recon)
    unet_backward(ops, P, G, G, x0, res, ct_net, neg_g_l1, ad)
    return vals


def step_with_ops(ops, p, m, v, u_lr, u_hr, hr, scalars, ks, lr_dim,
                  hr_dim, lmbda, lr, b1, b2, eps):
    """The training step over the op namespace ``ops`` (see the module
    docstring); arguments as ``train_step_fused``."""
    F = p.shape[0]
    layout = FlatLayout(lr_dim, hr_dim, len(ks))
    if p.dim() != 2 or p.shape[1] != layout.size:
        raise ValueError(
            f"p has shape {tuple(p.shape)}, the step's layout (F, "
            f"{layout.size}): {HIDDEN_REFUSAL}")
    for name, t in (("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p has "
                             f"{tuple(p.shape)}")
    _check_data(F, lr_dim, hr_dim, u_lr, u_hr, hr)
    if tuple(scalars.shape) != (F, 3):
        raise ValueError(f"scalars has shape {tuple(scalars.shape)}, "
                         f"expected {(F, 3)}")
    g = torch.empty_like(p)
    vals = step_value_and_grads(ops, layout.views(p), layout.views(g), u_lr,
                                u_hr, hr, pool_sizes(lr_dim, ks), lmbda)
    p2, m2, v2, loss, recon = ops.adam_masked(p, m, v, g, scalars, vals, lr,
                                              b1, b2, eps)
    return loss, recon, p2, m2, v2


# why the step with its Adam update (#9) and the step's loss (#8) take
# only hidden_dim == hr_dim, as the JAX package's kernels do
HIDDEN_REFUSAL = (
    "the whole-step kernels take the decoder at hidden_dim == hr_dim only: "
    "the JAX package's fix the tail's gradients d w1 / d w2 at (hr, hr) "
    "(fcsr_tpu/models/fused_step.py:344-347) and fail at any other width. "
    "tail_loss_fused, step_value_and_grad_fused and the fused_tail trainer "
    "modes take any hidden_dim")


def _check_data(F, lr_dim, hr_dim, u_lr, u_hr, hr):
    for name, t, shape in (("u_lr", u_lr, (lr_dim, lr_dim)),
                           ("u_hr", u_hr, (hr_dim, lr_dim)),
                           ("hr", hr, (hr_dim, hr_dim))):
        if tuple(t.shape) != (F,) + shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(F,) + shape}")


def train_step_fused(p, m, v, u_lr, u_hr, hr, scalars, ks: Sequence[float],
                     lr_dim: int, hr_dim: int, lmbda: float, lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     device=DEFAULT_DEVICE):
    """One fold-batched GSR training step — forward, backward and the
    masked Adam update.

    ``p``, ``m``, ``v``: (F, P) float32 flat buffers in ``FlatLayout``
    order; ``u_lr`` (F, lr, lr), ``u_hr`` (F, hr, lr), ``hr`` (F, hr, hr);
    ``scalars`` (F, 3) = [ok, 1 - b1^t, 1 - b2^t] per fold (ok = 0 leaves
    the fold's p, m, v unchanged). Returns (loss (F,), recon (F,), p', m',
    v'); loss and recon are multiplied by ok.

    On ``device="cuda"`` (the default) every tensor must be on the card
    and the step launches only the hand-written kernels; ``device="cpu"``
    runs their plain versions. w1 and w2 are (hr, hr): a buffer of another
    hidden width is refused before any launch (``HIDDEN_REFUSAL``)."""
    check_on_device("train_step_fused", device, p, m, v, u_lr, u_hr, hr,
                    scalars)
    return step_with_ops(mode_ops(), p, m, v, u_lr, u_hr, hr, scalars,
                         tuple(ks), lr_dim, hr_dim, lmbda, lr, b1, b2, eps)


def train_step_plain(p, m, v, u_lr, u_hr, hr, scalars, ks: Sequence[float],
                     lr_dim: int, hr_dim: int, lmbda: float, lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """The same step in plain PyTorch on any device (the reference the
    CUDA kernels are held to)."""
    return step_with_ops(mode_ops(plain=True), p, m, v, u_lr, u_hr, hr,
                         scalars,
                         tuple(ks), lr_dim, hr_dim, lmbda, lr, b1, b2, eps)


def adam_scalars(t: np.ndarray, ok: np.ndarray, b1: float = 0.9,
                 b2: float = 0.999):
    """(F, 3) float32 step scalars and the new step counts from the
    per-fold counts ``t`` and validity ``ok`` (both (F,) float32):
    t_eff = max(t + ok, 1), [ok, 1 - b1^t_eff, 1 - b2^t_eff]."""
    t = np.asarray(t, np.float32)
    ok = np.asarray(ok, np.float32)
    t_new = t + ok
    t_eff = np.maximum(t_new, np.float32(1.0))
    scal = np.stack([ok, np.float32(1.0) - np.float32(b1) ** t_eff,
                     np.float32(1.0) - np.float32(b2) ** t_eff], axis=1)
    return scal.astype(np.float32), t_new


# ---------------------------------------------------------------------------
# the plain oracle: the rank-select U-Net and the step's loss as ordinary
# differentiable PyTorch
# ---------------------------------------------------------------------------

def unet_forward_rankselect(net_params, ks: Sequence[float], lr_dim: int,
                            idx=None):
    """Graph U-Net forward on identity features as differentiable PyTorch
    (``torch.matmul``, top-k as a stable sort with ties to the lower index,
    pooling a gather, unpooling a scatter): (net_outs, start_gcn_outs) for
    2-D leaves or a fold batch. The kept indices carry no gradient; the
    kept scores do. ``idx`` (one (F, k) index tensor per level) replaces
    the selection, so a backward can differentiate the selection a forward
    made. Under ``FCSR_MM_MODE=bf16`` the products are ``mm_mode.mm``
    and the one-hot products ``mm_mode.round_through``, differentiable as
    the JAX package differentiates its ``_unet_fwd_math``."""
    W = net_params
    sizes = pool_sizes(lr_dim, ks)
    if mm_mode.check_mode() == "bf16":
        return _unet_forward_bf16(W, sizes, idx)
    L = len(sizes)
    x0 = W["w:start_gcn"] + W["b:start_gcn"]                  # I W + b
    x = x0
    downs, kept = [], []
    for i in range(L):
        d = torch.matmul(x, W[f"w:down_gcns_{i}"]) + W[f"b:down_gcns_{i}"]
        logits = torch.matmul(d, W[f"w:pools_{i}"]) + W[f"b:pools_{i}"]
        scores = pool_scores(logits.squeeze(-1))
        if idx is None:
            vals, ix = topk_desc(scores, sizes[i])
        else:
            ix = idx[i].long().reshape(scores.shape[:-1] + (sizes[i],))
            vals = torch.gather(scores, -1, ix)
        x = torch.take_along_dim(d, ix[..., None], dim=-2) * vals[..., None]
        downs.append(d)
        kept.append(ix)
    x = torch.matmul(x, W["w:bottom_gcn"]) + W["b:bottom_gcn"]
    for i in range(L):
        up = L - i - 1
        xu = torch.zeros_like(downs[up]).scatter(
            -2, kept[up][..., None].expand_as(x), x)
        x = (torch.matmul(xu, W[f"w:up_gcns_{i}"]) + W[f"b:up_gcns_{i}"]
             + downs[up])
    net = (torch.matmul(x, W["w:end_gcn_a"])
           + torch.matmul(x0, W["w:end_gcn_b"]) + W["b:end_gcn"])
    return net, x0


def _unet_forward_bf16(W, sizes, idx):
    """``unet_forward_rankselect`` in the bf16 mode: the JAX package's
    ``_unet_fwd_math`` (fused_step.py:361-401) with ``mm`` its ``mm_bf16``
    and each product with a one-hot or ones matrix a ``round_through``
    (a broadcast bias first expanded, so each element's cotangent is
    rounded before the rows are summed)."""
    mm, rt = mm_mode.mm, mm_mode.round_through
    L = len(sizes)
    x0 = rt(W["w:start_gcn"]) + W["b:start_gcn"]           # mm(I, W) + b
    x = x0
    downs, kept = [], []
    for i in range(L):
        d = mm(x, W[f"w:down_gcns_{i}"]) + W[f"b:down_gcns_{i}"]
        b_pool = W[f"b:pools_{i}"].expand(d.shape[:-1] + (1,))
        logits = mm(d, W[f"w:pools_{i}"]) + rt(b_pool)
        scores = pool_scores(logits.squeeze(-1))
        if idx is None:
            vals, ix = topk_desc(scores, sizes[i])
        else:
            ix = idx[i].long().reshape(scores.shape[:-1] + (sizes[i],))
            vals = torch.gather(scores, -1, ix)
        pre = rt(torch.take_along_dim(d, ix[..., None], dim=-2))
        x = pre * rt(vals)[..., None]
        downs.append(d)
        kept.append(ix)
    x = mm(x, W["w:bottom_gcn"]) + W["b:bottom_gcn"]
    for i in range(L):
        up = L - i - 1
        xu = torch.zeros_like(downs[up]).scatter(
            -2, kept[up][..., None].expand_as(x), rt(x))
        x = (mm(xu, W[f"w:up_gcns_{i}"]) + W[f"b:up_gcns_{i}"]
             + downs[up])
    w_end = torch.cat([W["w:end_gcn_a"], W["w:end_gcn_b"]], dim=-2)
    net = mm(torch.cat([x, x0], dim=-1), w_end) + W["b:end_gcn"]
    return net, x0


def step_loss_pure(params, a_norm, hr, u_lr, u_hr, ks: Sequence[float],
                   lr_dim: int, lmbda: float):
    """The step's loss as differentiable PyTorch of the leaf mapping
    ``params`` (``leaf_names`` with the tail): (loss, recon), per fold for
    a batch. ``a_norm`` is unused (the U-Net never consumes it)."""
    del a_norm
    net, start = unet_forward_rankselect(params, ks, lr_dim)
    tail, recon = _tail_loss(params["layer.weights"], params["gc1.weight"],
                             params["gc2.weight"], net, u_lr, u_hr, hr)
    loss = lmbda * (net - start).abs().mean(dim=(-2, -1)) + tail
    return loss, recon


# ---------------------------------------------------------------------------
# the fused entry points
# ---------------------------------------------------------------------------

_RES_LISTS = ("d", "s", "idx", "vals", "slot", "pre", "pooled", "xu")


def _pack_res(x0, res):
    return [x0, res["xf"]] + [t for key in _RES_LISTS for t in res[key]]


def _unpack_res(tensors, L):
    x0, xf, rest = tensors[0], tensors[1], tensors[2:]
    res = {key: list(rest[j * L:(j + 1) * L])
           for j, key in enumerate(_RES_LISTS)}
    res["xf"] = xf
    return x0, res


def _stage(what, device, params, names, data=()):
    """The leaves ``names`` of ``params`` and the ``data`` tensors as the
    kernels take them: on ``device``, with a leading fold axis and dense
    rows. Returns (leaves, data, squeeze) where ``squeeze`` says the inputs
    were one 2-D model."""
    missing = [n for n in names if n not in params]
    if missing:
        raise KeyError(f"{what}: parameter leaves missing: {missing}")
    leaves = [params[n] for n in names]
    check_on_device(what, device, *leaves, *data)
    squeeze = params[names[0]].dim() == 2
    out = []
    for t in leaves + list(data):
        if squeeze:
            t = t[None] if t.dim() == 2 else t.reshape(1, 1, -1)
        elif t.dim() == 2:                                   # (F, out) bias
            t = t[:, None, :]
        out.append(rows_contiguous(t))
    return out[:len(leaves)], out[len(leaves):], squeeze


def _unet_grads(leaves, names, x0, res, ct_net, ct_start, ad=False):
    """The hand-written adjoints (``ad``: rounded as autodiff rounds them)
    into a fresh flat buffer; returns its leaf views in ``names`` order."""
    W = dict(zip(names, leaves))
    F, lr_dim, hr_dim = W["w:start_gcn"].shape
    layout = FlatLayout(lr_dim, hr_dim, len(res["d"]))
    G = layout.views(torch.empty(F, layout.size, dtype=torch.float32,
                                 device=x0.device))
    unet_backward(mode_ops(), W, G, G, x0, res, ct_net.contiguous(),
                  ct_start.contiguous(), ad)
    return tuple(G[n] for n in names)


class _UnetFused(torch.autograd.Function):
    """(net, start) by the forward kernels; the backward runs the
    hand-written adjoints against the forward's residuals — kept
    (``unet_fused_fwdbwd``) or, with ``keep=False``, recomputed by
    launching the forward again (``unet_fused``; in the bf16 mode rounded
    as the JAX kernel's ``jax.vjp`` rounds them)."""

    @staticmethod
    def forward(ctx, sizes, keep, *leaves):
        names = leaf_names(len(sizes), tail=False)
        W = dict(zip(names, leaves))
        net, x0, res = unet_forward(mode_ops(), W, W, sizes)
        ctx.sizes, ctx.keep, ctx.n_leaves = sizes, keep, len(leaves)
        ctx.save_for_backward(*leaves, *(_pack_res(x0, res) if keep else ()))
        return net, x0

    @staticmethod
    def backward(ctx, ct_net, ct_start):
        saved = ctx.saved_tensors
        leaves = saved[:ctx.n_leaves]
        names = leaf_names(len(ctx.sizes), tail=False)
        if ctx.keep:
            x0, res = _unpack_res(saved[ctx.n_leaves:], len(ctx.sizes))
        else:
            W = dict(zip(names, leaves))
            _, x0, res = unet_forward(mode_ops(), W, W, ctx.sizes)
        ad = not ctx.keep and mm_mode.check_mode() == "bf16"
        return (None, None) + _unet_grads(leaves, names, x0, res, ct_net,
                                          ct_start, ad)


class _UnetFusedFwdOnly(torch.autograd.Function):
    """(net, start) by the forward kernels; the backward is autograd over
    the plain forward, rematerialised on the rows the kernels kept."""

    @staticmethod
    def forward(ctx, ks, sizes, *leaves):
        names = leaf_names(len(sizes), tail=False)
        W = dict(zip(names, leaves))
        net, x0, res = unet_forward(mode_ops(), W, W, sizes)
        ctx.ks, ctx.n_leaves = ks, len(leaves)
        ctx.save_for_backward(*leaves, *res["idx"])
        return net, x0

    @staticmethod
    def backward(ctx, ct_net, ct_start):
        saved = ctx.saved_tensors
        names = leaf_names(len(ctx.ks), tail=False)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_()
                      for t in saved[:ctx.n_leaves]]
            W = dict(zip(names, leaves))
            outs = unet_forward_rankselect(W, ctx.ks,
                                           W["w:start_gcn"].shape[-2],
                                           idx=saved[ctx.n_leaves:])
            grads = torch.autograd.grad(outs, leaves, (ct_net, ct_start))
        return (None, None) + grads


def _unet_entry(what, fn, head, net_params, ks, lr_dim, hr_dim, device):
    ks = tuple(ks)
    names = leaf_names(len(ks), tail=False)
    leaves, _, squeeze = _stage(what, device, net_params, names)
    if tuple(leaves[0].shape[1:]) != (lr_dim, hr_dim):
        raise ValueError(f"{what}: w:start_gcn is {tuple(leaves[0].shape)}, "
                         f"expected (..., {lr_dim}, {hr_dim})")
    net, start = fn.apply(*head, *leaves)
    return (net[0], start[0]) if squeeze else (net, start)


def unet_fused_fwdbwd(net_params, ks: Sequence[float], lr_dim: int,
                      hr_dim: int, device=DEFAULT_DEVICE):
    """Differentiable U-Net (net_outs, start_gcn_outs) whose forward and
    backward both run on the hand-written kernels: the forward keeps each
    level's residuals, the backward is the hand-written adjoints.

    On ``device="cuda"`` (the default) every leaf must be on the card;
    ``device="cpu"`` runs the kernels' plain versions."""
    sizes = pool_sizes(lr_dim, ks)
    return _unet_entry("unet_fused_fwdbwd", _UnetFused, (sizes, True),
                       net_params, ks, lr_dim, hr_dim, device)


def unet_fused(net_params, ks: Sequence[float], lr_dim: int, hr_dim: int,
               device=DEFAULT_DEVICE):
    """As ``unet_fused_fwdbwd`` but keeping only the leaves: the backward
    launches the forward kernels again for the residuals, then the
    adjoints (the rematerialising backward kernel of the JAX package,
    which takes ``jax.vjp`` of its forward: in the bf16 mode the adjoints
    round where that autodiff rounds, ``unet_backward(ad=True)``)."""
    sizes = pool_sizes(lr_dim, ks)
    return _unet_entry("unet_fused", _UnetFused, (sizes, False), net_params,
                       ks, lr_dim, hr_dim, device)


def unet_fused_fwdonly(net_params, ks: Sequence[float], lr_dim: int,
                       hr_dim: int, device=DEFAULT_DEVICE):
    """Differentiable U-Net whose forward runs on the hand-written kernels
    and whose backward is autograd over ``unet_forward_rankselect``.

    The kernels' products and ``torch.matmul`` may round a pooling score
    differently, so at an exact tie the two could keep different rows.
    The backward therefore does not select again: it differentiates the
    plain forward on the rows the forward kernels kept."""
    sizes = pool_sizes(lr_dim, ks)
    return _unet_entry("unet_fused_fwdonly", _UnetFusedFwdOnly,
                       (tuple(ks), sizes), net_params, ks, lr_dim, hr_dim,
                       device)


class _StepLossFused(torch.autograd.Function):
    """(loss, recon), each (F,), of the whole step; the forward computes
    and keeps the flat gradient, the backward scales it."""

    @staticmethod
    def forward(ctx, sizes, lmbda, u_lr, u_hr, hr, *leaves):
        names = leaf_names(len(sizes))
        P = dict(zip(names, leaves))
        F, lr_dim, hr_dim = P["w:start_gcn"].shape
        layout = FlatLayout(lr_dim, hr_dim, len(sizes))
        g = torch.empty(F, layout.size, dtype=torch.float32, device=hr.device)
        loss, recon = (torch.empty(F, dtype=torch.float32, device=hr.device)
                       for _ in range(2))
        step_value_and_grads(mode_ops(), P, layout.views(g), u_lr, u_hr, hr,
                             sizes, lmbda, loss, recon)
        ctx.mark_non_differentiable(recon)
        ctx.save_for_backward(g)
        ctx.layout = layout
        return loss, recon

    @staticmethod
    def backward(ctx, ct_loss, ct_recon):
        (g,) = ctx.saved_tensors
        scaled = ctx.layout.views(g * ct_loss[:, None])
        return (None,) * 5 + tuple(scaled.values())


def gsr_step_loss_fused(net_params, w_gsr, w1, w2, u_lr, u_hr, hr,
                        ks: Sequence[float], lr_dim: int, hr_dim: int,
                        lmbda: float, device=DEFAULT_DEVICE):
    """(loss, recon) of the full GSR training step — U-Net, spectral tail,
    decoder and all three loss terms — with the value and every gradient
    computed by the step's kernels in the forward (the training step
    without its Adam launch). Differentiable in (net_params, w_gsr, w1,
    w2); u_lr, u_hr and hr are data; ``recon`` is a metric and carries no
    gradient. 2-D inputs give scalars, a fold batch one value per fold.
    w1 and w2 are (hr, hr): another hidden width is refused before any
    launch (``HIDDEN_REFUSAL``).

    On ``device="cuda"`` (the default) every tensor must be on the card;
    ``device="cpu"`` runs the kernels' plain versions."""
    square = (hr_dim, hr_dim)
    if w1.shape[-2:] != square or w2.shape[-2:] != square:
        raise ValueError(f"gsr_step_loss_fused: w1 is {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}: {HIDDEN_REFUSAL}")
    ks = tuple(ks)
    params = dict(net_params)
    params.update(zip(TAIL_NAMES, (w_gsr, w1, w2)))
    leaves, data, squeeze = _stage("gsr_step_loss_fused", device, params,
                                   leaf_names(len(ks)), (u_lr, u_hr, hr))
    _check_data(leaves[0].shape[0], lr_dim, hr_dim, *data)
    loss, recon = _StepLossFused.apply(pool_sizes(lr_dim, ks), float(lmbda),
                                       *data, *leaves)
    return (loss[0], recon[0]) if squeeze else (loss, recon)


def step_value_and_grad_fused(params, u_lr, u_hr, hr, ks: Sequence[float],
                              lr_dim: int, hr_dim: int, hidden_dim: int,
                              lmbda: float, device=DEFAULT_DEVICE):
    """(loss, recon, grads) of the whole step over a GSR-Net ``state_dict``
    mapping of tensors (one model, or every tensor with a leading fold
    axis); ``grads`` carries the same names and shapes. The same launches
    as ``gsr_step_loss_fused``; the parameters are copied into the
    kernels' layout first, so this is an entry point for checks, not for a
    training loop. The JAX kernel takes ``jax.value_and_grad`` of the
    step's loss: in the bf16 mode the U-Net adjoints round where that
    autodiff rounds (``unet_backward(ad=True)``). Any ``hidden_dim``: it
    must be ``gc1.weight``'s width, and the gradients take the
    parameters' shapes, as the JAX kernel's do."""
    width = params["gc1.weight"].shape[-1]
    if hidden_dim != width:
        raise ValueError(f"step_value_and_grad_fused: hidden_dim is "
                         f"{hidden_dim}, gc1.weight is "
                         f"{tuple(params['gc1.weight'].shape)}")
    ks = tuple(ks)
    names = leaf_names(len(ks))
    with torch.no_grad():
        leaves, data, squeeze = _stage(
            "step_value_and_grad_fused", device,
            state_to_leaf_tensors(params), names, (u_lr, u_hr, hr))
        F = leaves[0].shape[0]
        _check_data(F, lr_dim, hr_dim, *data)
        layout = FlatLayout(lr_dim, hr_dim, len(ks), hidden_dim)
        G = layout.views(torch.empty(F, layout.size, dtype=torch.float32,
                                     device=leaves[0].device))
        loss, recon = (torch.empty(F, dtype=torch.float32,
                                   device=leaves[0].device) for _ in range(2))
        step_value_and_grads(mode_ops(), dict(zip(names, leaves)), G, *data,
                             pool_sizes(lr_dim, ks), lmbda, loss, recon,
                             ad=mm_mode.check_mode() == "bf16")
        grads = leaf_tensors_to_state(G)
    if squeeze:
        return loss[0], recon[0], {k: g[0] for k, g in grads.items()}
    return loss, recon, grads
