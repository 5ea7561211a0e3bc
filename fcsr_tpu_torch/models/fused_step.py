"""The whole GSR-Net training step — U-Net forward, spectral tail value and
gradient, the lmbda * L1(net, start) term, the hand-written U-Net
adjoints and the masked Adam update — over a leading fold axis F.

Counterpart of ``fcsr_tpu/models/fused_step.py::train_step_fused``, which
runs the step as ONE Mosaic kernel holding p, m and v for all folds in
VMEM. An H100 block has at most 227 KB of shared memory, so on the card
the step is a short sequence of hand-written kernels over device memory
(``kernels/csrc``): ``bgemm_f32`` for every product, ``rank_select`` and
its row gather/scatter helpers for top-k pooling, the ``tail_*`` and
``sym_*`` elementwise passes and ``l1_term`` for the tail, and one
``adam_masked`` launch over the flat (F, P) buffers.

Top-k pooling is a rank-select that yields INDICES (rank = compare-sum,
ties to the lower index), so pooling is a gather and unpooling a scatter;
both are exact, unlike the one-hot matmuls the TPU kernel needed.

The step is written once over an ``ops`` namespace: ``train_step_fused``
uses ``kernels.KERNEL_OPS`` (kernels for CUDA tensors, the plain version
for CPU tensors), ``train_step_plain`` always uses ``kernels.PLAIN_OPS``
(the reference the kernels are held to on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from fcsr_tpu_torch.iox.weights import lin_names
from fcsr_tpu_torch.kernels.ops import KERNEL_OPS, PLAIN_OPS
from fcsr_tpu_torch.models.fused_tail import tail_value_and_grad
from fcsr_tpu_torch.models.gsr import pool_sizes
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["leaf_specs", "FlatLayout", "unet_forward", "unet_backward",
           "step_with_ops", "train_step_fused", "train_step_plain",
           "adam_scalars"]


def leaf_specs(lr_dim: int, hr_dim: int, n_levels: int
               ) -> List[Tuple[str, Tuple[int, int]]]:
    """(name, shape) of the training kernels' 34 leaves (at 4 levels), in
    the JAX kernel's order (``_unet_leaf_shapes(tail=True)``): Linear
    kernels as (in, out) with ``end_gcn`` split in halves, biases staged
    (1, out), then the tail's w_gsr, w1, w2."""
    n, m, L = lr_dim, hr_dim, n_levels
    names = lin_names(L)
    wshape = {"start_gcn": (n, m), "bottom_gcn": (m, m)}
    specs = []
    for name in names[:-1]:
        shape = wshape.get(name, (m, 1) if name.startswith("pools_")
                           else (m, m))
        specs.append((f"w:{name}", shape))
    specs += [("w:end_gcn_a", (m, m)), ("w:end_gcn_b", (m, m))]
    for name in names:
        specs.append((f"b:{name}", (1, 1) if name.startswith("pools_")
                      else (1, m)))
    specs += [("layer.weights", (m, n)), ("gc1.weight", (m, m)),
              ("gc2.weight", (m, m))]
    return specs


@dataclass(frozen=True)
class FlatLayout:
    """Offsets of the kernel leaves in one flat (P,) vector per fold."""
    lr_dim: int
    hr_dim: int
    n_levels: int

    @property
    def specs(self):
        return leaf_specs(self.lr_dim, self.hr_dim, self.n_levels)

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
    backward consumes."""
    L = len(sizes)
    bg = ops.bgemm
    x0 = ops.add_bias(W["w:start_gcn"], B["b:start_gcn"])   # I W + b
    x = x0
    res = {"d": [], "s": [], "idx": [], "vals": [], "slot": [], "pre": [],
           "pooled": [], "xu": [None] * L}
    for i in range(L):
        d = bg(x, W[f"w:down_gcns_{i}"], bias=B[f"b:down_gcns_{i}"])
        logits = bg(d, W[f"w:pools_{i}"], bias=B[f"b:pools_{i}"])
        s, idx, vals, slot = ops.rank_select(logits.view(d.shape[0], -1),
                                             sizes[i])
        pre, x = ops.gather_rows(d, idx, vals)
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


def unet_backward(ops, W, GW, GB, x0, res, ct_net, ct_start):
    """Hand-written U-Net adjoints (the JAX package's ``_unet_bwd_math``)
    against the forward's residuals; writes every U-Net weight and bias
    gradient into the views ``GW``/``GB``."""
    L = len(res["d"])
    bg = ops.bgemm
    xf = res["xf"]
    bg(xf, ct_net, ta=True, out=GW["w:end_gcn_a"])
    bg(x0, ct_net, ta=True, out=GW["w:end_gcn_b"])
    bg(None, ct_net, out=GB["b:end_gcn"])
    g = bg(ct_net, W["w:end_gcn_a"], tb=True)
    g_org = bg(ct_net, W["w:end_gcn_b"], tb=True, add=ct_start)
    g_skip = [None] * L
    for i in reversed(range(L)):
        up = L - i - 1
        g_skip[up] = g
        bg(res["xu"][up], g, ta=True, out=GW[f"w:up_gcns_{i}"])
        bg(None, g, out=GB[f"b:up_gcns_{i}"])
        g_xu = bg(g, W[f"w:up_gcns_{i}"], tb=True)
        g = ops.gather_rows(g_xu, res["idx"][up])
    bg(res["pooled"][L - 1], g, ta=True, out=GW["w:bottom_gcn"])
    bg(None, g, out=GB["b:bottom_gcn"])
    g_p = bg(g, W["w:bottom_gcn"], tb=True)
    for i in reversed(range(L)):
        slot = res["slot"][i]
        g_d = ops.scatter_rows(g_p, slot, res["vals"][i], g_skip[i])
        g_logits = ops.pool_logits_bwd(g_p, res["pre"][i], slot, res["s"][i])
        gl = g_logits.view(g_logits.shape[0], -1, 1)
        bg(res["d"][i], gl, ta=True, out=GW[f"w:pools_{i}"])
        bg(None, gl, out=GB[f"b:pools_{i}"])
        g_d = bg(gl, W[f"w:pools_{i}"], tb=True, add=g_d, out=g_d)
        x_in = x0 if i == 0 else res["pooled"][i - 1]
        bg(x_in, g_d, ta=True, out=GW[f"w:down_gcns_{i}"])
        bg(None, g_d, out=GB[f"b:down_gcns_{i}"])
        if i > 0:
            g_p = bg(g_d, W[f"w:down_gcns_{i}"], tb=True)
        else:
            # start_gcn's input is the identity: dW = g_p + g_org + ct_start
            bg(g_d, W[f"w:down_gcns_{i}"], tb=True, add=g_org,
               out=GW["w:start_gcn"])
    bg(None, GW["w:start_gcn"], out=GB["b:start_gcn"])


def step_with_ops(ops, p, m, v, u_lr, u_hr, hr, scalars, ks, lr_dim,
                  hr_dim, lmbda, lr, b1, b2, eps):
    """The training step over the op namespace ``ops`` (see the module
    docstring); arguments as ``train_step_fused``."""
    F = p.shape[0]
    layout = FlatLayout(lr_dim, hr_dim, len(ks))
    for name, t in (("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p has "
                             f"{tuple(p.shape)}")
    for name, t, shape in (("u_lr", u_lr, (lr_dim, lr_dim)),
                           ("u_hr", u_hr, (hr_dim, lr_dim)),
                           ("hr", hr, (hr_dim, hr_dim)),
                           ("scalars", scalars, (3,))):
        if tuple(t.shape) != (F,) + shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(F,) + shape}")
    P = layout.views(p)
    g = torch.empty_like(p)
    G = layout.views(g)
    vals = torch.empty(F, 3, dtype=torch.float32, device=p.device)

    net, x0, res = unet_forward(ops, P, P, pool_sizes(lr_dim, ks))
    # lmbda * L1(net, start): value into vals[:, 0], sign adjoints
    g_l1, neg_g_l1 = ops.l1_term(net, x0, vals, 0, lmbda,
                                 lmbda / (lr_dim * hr_dim), True, neg=True)
    _, _, _, ct_net = tail_value_and_grad(
        ops, P["layer.weights"], P["gc1.weight"], P["gc2.weight"], net,
        u_lr, u_hr, hr, vals, g_wgsr=G["layer.weights"],
        g_w1=G["gc1.weight"], g_w2=G["gc2.weight"], g_f_add=g_l1)
    unet_backward(ops, P, G, G, x0, res, ct_net, neg_g_l1)
    p2, m2, v2, loss, recon = ops.adam_masked(p, m, v, g, scalars, vals, lr,
                                              b1, b2, eps)
    return loss, recon, p2, m2, v2


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
    runs their plain versions."""
    dev = resolve_device(device)
    for t in (p, m, v, u_lr, u_hr, hr, scalars):
        if t.device.type != dev.type:
            raise ValueError(f"train_step_fused(device={device!r}) got a "
                             f"tensor on {t.device}")
    return step_with_ops(KERNEL_OPS, p, m, v, u_lr, u_hr, hr, scalars,
                         tuple(ks), lr_dim, hr_dim, lmbda, lr, b1, b2, eps)


def train_step_plain(p, m, v, u_lr, u_hr, hr, scalars, ks: Sequence[float],
                     lr_dim: int, hr_dim: int, lmbda: float, lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """The same step in plain PyTorch on any device (the reference the
    CUDA kernels are held to)."""
    return step_with_ops(PLAIN_OPS, p, m, v, u_lr, u_hr, hr, scalars,
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
