"""The GSR spectral tail — GSRLayer (collapsed form) -> gc1 -> gc2 ->
symmetrize/diag/abs -> L1(pred, hr) + L1(w_gsr, u_hr) — with hand-written
adjoints for w_gsr, w1, w2 and the U-Net output f.

Counterpart of ``fcsr_tpu/models/fused_tail.py::_tail_loss``, whose
gradients the TPU kernels take by in-kernel AD with the ideal matmul
adjoints. Here the adjoints are written out: |.| -> sign (+1 at 0),
fill-diagonal -> zero the diagonal, symmetrize -> (G + G^T) / 2, and the
transposing ``normalize_adj`` through its row-sum rsqrt.

``tail_value_and_grad`` is written once over an ``ops`` namespace: with
``kernels.ops.mode_ops()`` it launches the CUDA kernels for CUDA tensors
(the training step's path), with ``mode_ops(plain=True)`` it is the plain
PyTorch version; both follow ``core.mm_mode.MODE``. Every tensor carries a
leading fold axis F. Under ``FCSR_MM_MODE=bf16`` each of its 19 products
is the JAX tail's ``mm`` (``fused_tail.py:51-58``) or one of that ``mm``'s
ideal adjoints, which the JAX kernel's in-kernel ``value_and_grad`` takes:
both operands rounded, cotangents included; the elementwise passes stay
fp32, as there.

``tail_loss_fused`` is the tail as an entry point of its own (counterpart
of ``fcsr_tpu/models/fused_tail.py::tail_loss_fused``, a ``custom_vjp``
around one TPU kernel): a ``torch.autograd.Function`` whose forward
launches the tail's kernels once for the value and all four gradients and
whose backward scales the kept gradients by the upstream cotangent.
``tail_loss_reference`` is its oracle: autograd over the tail written as
ordinary differentiable PyTorch.
"""

from __future__ import annotations

import torch

from fcsr_tpu_torch.core.normalize import (fill_diagonal, normalize_adj,
                                           symmetrize)
from fcsr_tpu_torch.core import mm_mode
from fcsr_tpu_torch.kernels.ops import mode_ops, rows_contiguous
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, check_on_device

__all__ = ["tail_value_and_grad", "tail_loss", "tail_loss_grads",
           "tail_loss_fused", "tail_loss_reference"]


def tail_value_and_grad(ops, w_gsr, w1, w2, f, u_lr, u_hr, hr, vals,
                        g_wgsr=None, g_w1=None, g_w2=None, g_f_add=None,
                        loss=None, recon=None, with_l1=True):
    """Tail forward and backward over (F, ...) tensors: w_gsr (hr, lr),
    w1 (hr, h), w2 (h, hr) at any hidden width h (the JAX kernel takes
    ``hidden = w1.shape[1]``), f (lr, hr), u_lr (lr, lr), u_hr (hr, lr),
    hr (hr, hr).

    Writes the fold's recon and spectral terms into ``vals[:, 1]`` and
    ``vals[:, 2]`` ((F, 3) float32) and the weight gradients into
    ``g_wgsr``/``g_w1``/``g_w2`` (allocated when None). With ``loss`` (F,)
    the spectral term's launch also writes the loss entry point's scalars
    (``ops.l1_term``): the tail's ``recon + spectral``, or with
    ``with_l1`` the whole step's (``vals[:, 0]`` written before), and
    ``recon`` when given. Returns (g_wgsr, g_w1, g_w2, g_f) where ``g_f``
    already includes ``g_f_add``.
    """
    m, n = w_gsr.shape[1], w_gsr.shape[2]
    bg = ops.bgemm
    # forward: one mm of fcsr_tpu/models/fused_tail.py each (line)
    b_small = bg(w_gsr, u_lr, tb=True)                  # W U^T      :51
    t = bg(b_small, f)                                  # b f        :52
    adj, r = ops.tail_normalize(t)                      #            :53-54
    xo = bg(adj, adj, tb=True)                          # adj adj^T  :55
    z = ops.sym_abs_fill(xo)                            #            :56
    h1p = bg(z, w1)                                     #            :57
    h1 = bg(adj, h1p)                                   #            :57
    h2p = bg(h1, w2)                                    #            :58
    h2 = bg(adj, h2p)                                   #            :58
    pred = ops.sym_abs_fill(h2)
    g_pred = ops.l1_term(pred, hr, vals, 1, 1.0, 1.0 / (m * m), False)
    g_spec = ops.l1_term(w_gsr, u_hr, vals, 2, 1.0, 1.0 / (m * n), False,
                         loss=loss, recon=recon, with_l1=with_l1)
    # backward, in-kernel value_and_grad there: each product one of mm's
    # ideal adjoints (mosaic_mm.py:115-117) of the forward's product on
    # the line named; where an operand feeds two products, the adjoints'
    # sum (``add=``, fp32)
    g_h2 = ops.sym_sign_grad(g_pred, h2, 0.5)
    g_adj = bg(g_h2, h2p, tb=True)                      # :58
    g_h2p = bg(adj, g_h2, ta=True)                      # :58
    g_w2 = bg(h1, g_h2p, ta=True, out=g_w2)             # :58
    g_h1 = bg(g_h2p, w2, tb=True)                       # :58
    g_adj = bg(g_h1, h1p, tb=True, add=g_adj, out=g_adj)    # :57
    g_h1p = bg(adj, g_h1, ta=True)                      # :57
    g_w1 = bg(z, g_h1p, ta=True, out=g_w1)              # :57
    g_z = bg(g_h1p, w1, tb=True)                        # :57
    # x_out = adj adj^T: d adj = (G + G^T) adj with G = d x_out; the
    # factor 2 of the symmetric G folds into sym_sign_grad's c = 1
    g_xo2 = ops.sym_sign_grad(g_z, xo, 1.0)
    g_adj = bg(g_xo2, adj, add=g_adj, out=g_adj)        # :55 (both)
    g_t = ops.tail_normalize_bwd(g_adj, t, r)
    g_bs = bg(g_t, f, tb=True)                          # :52
    g_f = bg(b_small, g_t, ta=True, add=g_f_add)        # :52
    g_wgsr = bg(g_bs, u_lr, add=g_spec, out=g_wgsr)     # :51
    return g_wgsr, g_w1, g_w2, g_f


def _batched(*xs):
    return [x[None] if x.dim() == 2 else x for x in xs]


def tail_loss_grads(w_gsr, w1, w2, f, u_lr, u_hr, hr):
    """Plain PyTorch (loss, recon, (g_wgsr, g_w1, g_w2, g_f)) for one
    subject (2-D inputs) or a fold batch, in the reference's signature."""
    squeeze = w_gsr.dim() == 2
    args = _batched(w_gsr, w1, w2, f, u_lr, u_hr, hr)
    vals = torch.zeros(args[0].shape[0], 3, dtype=torch.float32,
                       device=w_gsr.device)
    grads = tail_value_and_grad(mode_ops(plain=True), *args, vals)
    loss, recon = vals[:, 1] + vals[:, 2], vals[:, 1]
    if squeeze:
        return loss[0], recon[0], tuple(g[0] for g in grads)
    return loss, recon, grads


def tail_loss(w_gsr, w1, w2, f, u_lr, u_hr, hr):
    """Plain PyTorch (loss, recon) of the tail."""
    loss, recon, _ = tail_loss_grads(w_gsr, w1, w2, f, u_lr, u_hr, hr)
    return loss, recon


def _tail_loss(w_gsr, w1, w2, f, u_lr, u_hr, hr):
    """The tail as ordinary differentiable PyTorch (``mm_mode.mm``:
    ``torch.matmul`` in the compensated modes), over 2-D inputs or a fold
    batch: (loss, recon), per fold for a batch."""
    mm = mm_mode.mm
    b_small = mm(w_gsr, u_lr.transpose(-1, -2))
    f_d = fill_diagonal(mm(b_small, f).abs(), 1.0)
    adj = normalize_adj(f_d)
    x_out = mm(adj, adj.transpose(-1, -2))
    x_out = fill_diagonal(symmetrize(x_out), 1.0).abs()
    h1 = mm(adj, mm(x_out, w1))
    h2 = mm(adj, mm(h1, w2))
    pred = fill_diagonal(symmetrize(h2), 1.0).abs()
    recon = (pred - hr).abs().mean(dim=(-2, -1))
    spectral = (w_gsr - u_hr).abs().mean(dim=(-2, -1))
    return recon + spectral, recon


def tail_loss_reference(w_gsr, w1, w2, f, u_lr, u_hr, hr):
    """(loss, recon, (g_wgsr, g_w1, g_w2, g_f)) by autograd over the plain
    tail — the oracle the hand-written adjoints are held to. For a fold
    batch the gradients are those of each fold's own loss."""
    leaves = [t.detach().requires_grad_() for t in (w_gsr, w1, w2, f)]
    loss, recon = _tail_loss(*leaves, u_lr, u_hr, hr)
    grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), recon.detach(), grads


class _TailLossFused(torch.autograd.Function):
    """loss (F,) of the tail; the forward computes and keeps the four
    gradients, the backward scales them."""

    @staticmethod
    def forward(ctx, w_gsr, w1, w2, f, u_lr, u_hr, hr):
        vals = torch.empty(w_gsr.shape[0], 3, dtype=torch.float32,
                           device=w_gsr.device)
        loss = torch.empty(w_gsr.shape[0], dtype=torch.float32,
                           device=w_gsr.device)
        grads = tail_value_and_grad(mode_ops(), w_gsr, w1, w2, f, u_lr, u_hr,
                                    hr, vals, loss=loss, with_l1=False)
        ctx.save_for_backward(*grads)
        return loss

    @staticmethod
    def backward(ctx, ct):
        ct = ct[:, None, None]
        return tuple(ct * g for g in ctx.saved_tensors) + (None, None, None)


def tail_loss_fused(w_gsr, w1, w2, f, u_lr, u_hr, hr,
                    device=DEFAULT_DEVICE):
    """Tail loss ``recon + spectral`` whose value and gradients come from
    one pass over the tail's kernels. Differentiable in (w_gsr, w1, w2, f);
    u_lr, u_hr and hr are data. 2-D inputs give a scalar, a fold batch
    (F, ...) one loss per fold.

    On ``device="cuda"`` (the default) every tensor must be on the card and
    only the hand-written kernels run; ``device="cpu"`` runs their plain
    versions."""
    args = (w_gsr, w1, w2, f, u_lr, u_hr, hr)
    check_on_device("tail_loss_fused", device, *args)
    squeeze = w_gsr.dim() == 2
    args = [rows_contiguous(t) for t in _batched(*args)]
    loss = _TailLossFused.apply(*args)
    return loss[0] if squeeze else loss
