"""The spectral-norm residual MLP (``SpectralResMLP``) of the reference
repo's ``training_template.ipynb``, with no residual block (``n_layers``
0, the shipped default), in plain PyTorch float32 as a function of named
tensors (the notebook's ``state_dict`` names); its training step as
``utils/training.py:95-145`` makes it.

Input: the LR matrix's strict upper triangle, row-major (L_in = n (n - 1)
/ 2). Model: ``spectral_norm(Linear(L_in, H))``, ``BatchNorm1d(H)``,
``Dropout(0.1)``, ``LeakyReLU(0.01)``, ``spectral_norm(Linear(H,
L_out))``, sigmoid; the vector scattered row-major into the upper
triangle of an (m, m) matrix and mirrored (zero diagonal). Spectral norm
as ``torch.nn.utils.spectral_norm`` computes it: in training one power
iteration, ``v = normalize(W^T u)``, ``u = normalize(W v)`` (eps 1e-12),
without gradient, the pair kept; in evaluation the stored pair; ``sigma
= u . (W v)`` with gradient through W. BatchNorm is torch's own
(``F.batch_norm``: momentum 0.1, eps 1e-5, the running variance
unbiased). Loss: the MSE over the m^2 entries of the matrices. A
training step: ``clip_grad_norm_(1.0)`` and ``torch.optim.AdamW(lr,
weight_decay)`` (written out as its single-tensor step; betas 0.9, 0.999,
eps 1e-8); each epoch ``ReduceLROnPlateau(mode="min", patience,
threshold rel, factor)`` on the validation loss, the best validation
state restored at the end, training stopped once the rate falls below
``stop_lr``.

Departures from the reference repo:

- the initial weights (kernels, SN's u and v) are the benchmark's, drawn
  from ``--seed`` and handed to both sides, not torch's module inits;
- dropout keeps an entry where a uniform draw is ``< 1 - p`` and scales
  it by ``1 / (1 - p)``: the draws are the program's (one (F, B, H)
  uniform draw a training step from a ``torch.Generator`` seeded with the
  run's seed, ``keep_masks``), not ``nn.Dropout``'s Bernoulli stream;
- AdamW's bias corrections ``1 - beta^t`` are float32 powers of the
  float32 betas on the device (``bias_corrections``), as the program and
  the JAX package's optax compute them; ``torch.optim.AdamW`` computes
  them in double. At t = 1 the float32 ``1 - 0.999`` is 1.29e-5 below
  1e-3, which makes every update 6.4e-6 smaller (3.3e-6 at t = 3): with
  torch's own corrections each leaf's update norm parts from the
  program's by that much on every seed, under the rounding compared;
- the plateau rule is replayed in float32 (``plateau_replay``), as the
  program keeps it on the device; torch's scheduler compares Python
  doubles, which may decide a comparison within a float32 rounding of the
  threshold the other way.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["param_spec", "stat_spec", "triangle", "to_matrix", "forward",
           "matrix_mse", "keep_masks", "bias_corrections", "adamw_steps",
           "evaluate", "plateau_replay"]

SN_EPS = 1e-12
BN_MOMENTUM, BN_EPS = 0.1, 1e-5
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
LEAKY = 0.01
SN = ("input_layer.1", "output_layer.0")
BN = "input_layer.2"


def param_spec(n_in, n_out, hidden):
    """[(name, shape, init, scale)] of the trained tensors: the SN
    kernels Xavier-uniform (bound ``scale``), biases zeros, BatchNorm's
    weight ones."""
    l_in, l_out = n_in * (n_in - 1) // 2, n_out * (n_out - 1) // 2

    def xavier(a, b):
        return (6.0 / (a + b)) ** 0.5
    return [("input_layer.1.weight_orig", (hidden, l_in), "uniform",
             xavier(l_in, hidden)),
            ("input_layer.1.bias", (hidden,), "zeros", 0.0),
            ("input_layer.2.weight", (hidden,), "ones", 1.0),
            ("input_layer.2.bias", (hidden,), "zeros", 0.0),
            ("output_layer.0.weight_orig", (l_out, hidden), "uniform",
             xavier(hidden, l_out)),
            ("output_layer.0.bias", (l_out,), "zeros", 0.0)]


def stat_spec(n_in, n_out, hidden):
    """[(name, shape, init)] of the statistics: SN's u and v unit normals,
    BatchNorm's running mean zeros and variance ones."""
    l_in, l_out = n_in * (n_in - 1) // 2, n_out * (n_out - 1) // 2
    return [("input_layer.1.weight_u", (hidden,), "unit_normal"),
            ("input_layer.1.weight_v", (l_in,), "unit_normal"),
            ("input_layer.2.running_mean", (hidden,), "zeros"),
            ("input_layer.2.running_var", (hidden,), "ones"),
            ("output_layer.0.weight_u", (l_out,), "unit_normal"),
            ("output_layer.0.weight_v", (hidden,), "unit_normal")]


def triangle(mats):
    """(B, n, n) -> (B, n (n - 1) / 2): the strict upper triangle,
    row-major."""
    n = mats.shape[-1]
    r, c = torch.triu_indices(n, n, 1, device=mats.device)
    return mats[..., r, c]


def to_matrix(vec, n):
    """(B, L) row-major triangle vectors -> (B, n, n) symmetric matrices
    with a zero diagonal."""
    r, c = torch.triu_indices(n, n, 1, device=vec.device)
    out = vec.new_zeros(*vec.shape[:-1], n, n)
    out[..., r, c] = vec
    return out + out.transpose(-1, -2)


def _sn_weight(w, u, v, train):
    """(W / sigma, u, v) as ``spectral_norm`` makes them."""
    if train:
        with torch.no_grad():
            v = F.normalize(torch.mv(w.t(), u), dim=0, eps=SN_EPS)
            u = F.normalize(torch.mv(w, v), dim=0, eps=SN_EPS)
    sigma = torch.dot(u, torch.mv(w, v))
    return w / sigma, u, v


def forward(P, S, x, train, keep=None, p_drop=0.1):
    """(predictions (B, L_out) in [0, 1], new statistics) of triangle
    vectors x (B, L_in). ``train``: one power iteration a layer, the
    batch's moments and dropout by ``keep`` (B, H); else the stored
    statistics. The new statistics are fresh tensors; ``S`` is not
    changed."""
    new = {}
    w, new[f"{SN[0]}.weight_u"], new[f"{SN[0]}.weight_v"] = _sn_weight(
        P[f"{SN[0]}.weight_orig"], S[f"{SN[0]}.weight_u"],
        S[f"{SN[0]}.weight_v"], train)
    h = F.linear(x, w, P[f"{SN[0]}.bias"])
    mean = S[f"{BN}.running_mean"].clone()
    var = S[f"{BN}.running_var"].clone()
    h = F.batch_norm(h, mean, var, P[f"{BN}.weight"], P[f"{BN}.bias"],
                     training=train, momentum=BN_MOMENTUM, eps=BN_EPS)
    new[f"{BN}.running_mean"], new[f"{BN}.running_var"] = mean, var
    if train and keep is not None:
        h = torch.where(keep, h / (1.0 - p_drop), 0.0)
    h = F.leaky_relu(h, LEAKY)
    w, new[f"{SN[1]}.weight_u"], new[f"{SN[1]}.weight_v"] = _sn_weight(
        P[f"{SN[1]}.weight_orig"], S[f"{SN[1]}.weight_u"],
        S[f"{SN[1]}.weight_v"], train)
    return torch.sigmoid(F.linear(h, w, P[f"{SN[1]}.bias"])), new


def matrix_mse(pred_vec, hr):
    """The MSE over the (B, m, m) entries of the predicted matrices."""
    return ((to_matrix(pred_vec, hr.shape[-1]) - hr) ** 2).mean()


def keep_masks(gen, n_folds, batch, hidden, p_drop, steps):
    """The program's keep masks of ``steps`` training steps, (n_folds,
    batch, hidden) each: one uniform draw over the fold stack a step, kept
    where ``< 1 - p_drop``."""
    return [torch.rand((n_folds, batch, hidden), generator=gen,
                       device=gen.device) < 1.0 - p_drop
            for _ in range(steps)]


def bias_corrections(t, device):
    """(1 - B1^t, 1 - B2^t) of step ``t`` as float32 tensors on
    ``device``: float32 powers of the float32 betas."""
    te = torch.tensor(float(t), dtype=torch.float32, device=device)
    return 1.0 - B1 ** te, 1.0 - B2 ** te


def adamw_steps(P0, S0, batches, keeps, lr, wd, clip=1.0, p_drop=0.1):
    """One model's training steps over ``batches`` [(x (B, L_in), hr (B, m,
    m))], dropout by ``keeps[s]``, from ``P0`` / ``S0`` (not changed):
    ``clip_grad_norm_`` then ``torch.optim.AdamW``'s single-tensor step
    (decay ``p (1 - lr wd)``, ``p - lr / bc1 * m / (sqrt(v) / sqrt(bc2) +
    eps)``) with the bias corrections of ``bias_corrections``. Returns
    (losses, the first step's clipped gradient by name, the parameters and
    the statistics after the last step)."""
    P = {k: v.detach().clone().requires_grad_() for k, v in P0.items()}
    S = {k: v.detach().clone() for k, v in S0.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, g1 = [], None
    for t, ((x, hr), keep) in enumerate(zip(batches, keeps), start=1):
        for p in P.values():
            p.grad = None
        pred, S = forward(P, S, x, True, keep, p_drop)
        loss = matrix_mse(pred, hr)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(P.values()), clip,
                                       foreach=False)
        if g1 is None:
            g1 = {k: v.grad.detach().clone() for k, v in P.items()}
        bc1, bc2 = bias_corrections(t, x.device)
        with torch.no_grad():
            for k, p in P.items():
                g = p.grad
                p.mul_(1.0 - lr * wd)
                m[k].lerp_(g, 1.0 - B1)
                v2[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                denom = v2[k].sqrt() / bc2.sqrt() + ADAM_EPS
                p.sub_(lr / bc1 * (m[k] / denom))
        losses.append(float(loss.detach()))
    return losses, g1, {k: v.detach() for k, v in P.items()}, S


@torch.no_grad()
def evaluate(P, S, x, hr, block=64):
    """Each subject's MSE over the m^2 entries and off-diagonal MAE over
    the m (m - 1), in evaluation mode, in blocks of subjects."""
    m = hr.shape[-1]
    off = ~torch.eye(m, dtype=torch.bool, device=hr.device)
    mse, mae = [], []
    for s in range(0, len(x), block):
        pred = to_matrix(forward(P, S, x[s:s + block], False)[0], m)
        d = pred - hr[s:s + block]
        mse.append((d ** 2).mean((-2, -1)))
        mae.append(d.abs().masked_fill(~off, 0.0).sum((-2, -1))
                   / (m * (m - 1)))
    return torch.cat(mse), torch.cat(mae)


def plateau_replay(val, lr0, patience, threshold, factor, stop_lr,
                   epochs):
    """The learning rate after each epoch of a fold whose validation
    losses were ``val``, by ``ReduceLROnPlateau(mode="min",
    threshold_mode="rel")`` in float32, and the epochs the fold should
    have run (it stops after the epoch whose rate falls below
    ``stop_lr``)."""
    f32 = np.float32
    lr, best, bad = f32(lr0), f32(np.inf), 0
    shrink, fac, stop = f32(1.0 - threshold), f32(factor), f32(stop_lr)
    lrs = []
    for e, loss in enumerate(val):
        loss = f32(loss)
        if loss < f32(best * shrink):
            best, bad = loss, 0
        else:
            bad += 1
        if bad > patience:
            lr, bad = f32(lr * fac), 0
        lrs.append(lr)
        if lr < stop:
            return lrs, e + 1
    return lrs, epochs
