"""The port's v2 MLP (``models/mlp.py::SpectralResMLP``) and its
fold-parallel trainer (``train/generic_loop.py::_FoldTrainer``) against
the benchmark's plain reference (``h100_bench/reference/mlp_v2.py``), on
the CPU at 20 -> 32 nodes, hidden 12, two folds, seeded random weights:
the forward pass in both modes, and the first three training steps
(losses, the clipped gradient by leaf, the updated parameters, the
BatchNorm and spectral-norm statistics), at dropout 0 and at 0.1 with the
masks drawn alike.

Both sides compute the same equations in float32 with other summation
orders (the reference uses torch's own BatchNorm, spectral norm's
``mv`` / ``dot``, ``clip_grad_norm_`` and ``torch.optim.AdamW``'s step
written out, its bias corrections in float32 as the trainer's), so each
comparison has a tolerance, given with its reason."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench.reference import mlp_v2 as ref  # noqa: E402
from fcsr_tpu_torch.data import synthesize_teacher_connectomes  # noqa: E402
from fcsr_tpu_torch.iox.weights import mlp_state_to_flat  # noqa: E402
from fcsr_tpu_torch.models.mlp import SpectralResMLP  # noqa: E402
from fcsr_tpu_torch.train import generic_loop  # noqa: E402
from fcsr_tpu_torch.train.losses import (make_triu_mse_criterion,  # noqa: E402
                                         pack_triu_targets)

N_IN, N_OUT, HIDDEN, F, B = 20, 32, 12, 2, 4
LR, WD, SEED = 0.01, 0.01, 1234


@pytest.fixture(scope="module")
def data():
    lr, hr = synthesize_teacher_connectomes(2 * 3 * B, lr_dim=N_IN,
                                            hr_dim=N_OUT, seed=5)
    return torch.from_numpy(lr), torch.from_numpy(hr)


def _weights(seed=11):
    """Named (F, ...) initial tensors: random parameters (biases and
    BatchNorm's too, so that every leaf is exercised) and statistics
    (unit u, v; a random positive running variance)."""
    gen = torch.Generator().manual_seed(seed)
    P = {name: 0.5 * torch.randn((F, *shape), generator=gen)
         for name, shape, _, _ in ref.param_spec(N_IN, N_OUT, HIDDEN)}
    S = {}
    for name, shape, kind in ref.stat_spec(N_IN, N_OUT, HIDDEN):
        x = torch.randn((F, *shape), generator=gen)
        if kind == "unit_normal":
            x = x / x.norm(dim=-1, keepdim=True)
        elif kind == "ones":
            x = 0.5 + x.abs()
        S[name] = x
    return P, S


def _trainer(data, P, S, dropout):
    """The trainer as ``run_mlp_cv`` builds it, fold f on samples
    ``[f * 3 B, (f + 1) * 3 B)``."""
    lr, hr = data
    model = SpectralResMLP(N_IN, N_OUT, HIDDEN, 0, dropout=dropout,
                           output="vector", device="meta")
    x = ref.triangle(lr).reshape(F, 3 * B, -1)
    y = torch.from_numpy(pack_triu_targets(hr.numpy())).reshape(
        F, 3 * B, -1)
    flats = [mlp_state_to_flat({k: v[f].numpy() for k, v in
                                (P | S).items()}) for f in range(F)]
    p, s = (torch.from_numpy(np.stack(a)) for a in zip(*flats))
    return generic_loop._FoldTrainer(
        model, p, s, x, y, x[:, :B], y[:, :B], SEED, B,
        make_triu_mse_criterion(N_OUT), 1.0, WD, torch.device("cpu"))


def _named(tr, flat_p, flat_s):
    """Each fold's tensors by name, copied (the trainer's buffers change
    in place)."""
    return [{k: v.detach().clone() for k, v in generic_loop.fold_state(
        tr.model, flat_p, flat_s, f).items()} for f in range(F)]


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_reference(data, train):
    """At dropout 0: predictions within 1e-5 of the largest (products of
    190 and 12 terms summed in other orders; the random weights make
    pre-activations of tens, whose float32 rounding the sigmoid keeps; 5e-6
    here); in
    training the new statistics too (u, v to 1e-6: unit vectors; the
    BatchNorm moments to 1e-5 of their largest: the program takes the
    variance as ``mean(x^2) - mean^2``, torch in two passes)."""
    P, S = _weights()
    tr = _trainer(data, P, S, 0.0)
    x = tr.x_tr[:, :B]
    pred, new = tr.model.fold_forward(tr.pv, tr.sv, x, train)
    states = _named(tr, tr.p, tr.s)
    for f in range(F):
        want, want_s = ref.forward({k: v[f] for k, v in P.items()},
                                   {k: v[f] for k, v in S.items()}, x[f],
                                   train)
        scale = want.abs().max()
        assert (pred[f] - want).abs().max() <= 1e-5 * scale
        if not train:
            continue
        got_s = generic_loop.fold_state(
            tr.model, tr.p, torch.cat([new[k].reshape(F, -1) for k in new],
                                      dim=1), f)
        for k, v in want_s.items():
            tol = 1e-6 if "weight_" in k else 1e-5 * float(v.abs().max())
            assert (got_s[k] - v).abs().max() <= tol, k
    assert all(torch.equal(states[f][k], S[k][f]) for f in range(F)
               for k in S)          # a forward leaves the buffers alone


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_first_three_steps_match_the_reference(data, dropout):
    """Three fold-batched steps against three ``clip_grad_norm_`` +
    ``AdamW`` steps a fold, the dropout masks drawn alike (one (F, B, H)
    uniform draw a step from a generator seeded as the trainer's)."""
    lr, hr = data
    P, S = _weights()
    tr = _trainer(data, P, S, dropout)
    gen = torch.Generator().manual_seed(SEED)
    keeps = ref.keep_masks(gen, F, B, HIDDEN, dropout, 3)
    ok, rate = torch.ones(F), torch.full((F,), LR)
    losses, g1 = [], None
    for s in range(3):
        idx = torch.arange(s * B, (s + 1) * B).expand(F, -1)
        losses.append(tr.step(idx, ok, rate))
        if g1 is None:
            g1 = _named(tr, tr.g, tr.s)
    after = _named(tr, tr.p, tr.s)
    x = ref.triangle(lr).reshape(F, 3 * B, -1)
    y = hr.reshape(F, 3 * B, N_OUT, N_OUT)
    for f in range(F):
        batches = [(x[f, s * B:(s + 1) * B], y[f, s * B:(s + 1) * B])
                   for s in range(3)]
        want_l, want_g, want_p, want_s = ref.adamw_steps(
            {k: v[f] for k, v in P.items()}, {k: v[f] for k, v in S.items()},
            batches, [k[f] for k in keeps], LR, WD, 1.0, dropout)
        # losses: float32 sums of ~500 squares in other orders
        np.testing.assert_allclose([float(v[f]) for v in losses], want_l,
                                   rtol=2e-6)
        # the clipped gradient: each leaf within 2e-5 of the largest
        # entry of any leaf (float32 sums; the input layer's bias, which
        # BatchNorm cancels, has a gradient of rounding alone on both
        # sides: 1e-5 of that largest)
        top = max(float(g.abs().max()) for g in want_g.values())
        for k, g in want_g.items():
            assert (g1[f][k] - g).abs().max() <= 2e-5 * top, k
        # the parameters' change after three steps, by leaf: within 1e-4
        # of the reference's change in norm (Adam divides each entry's
        # gradient by its own size, so an entry near rounding moves
        # either way); the input kernel within 1e-2 (its entries fed by
        # inputs nearly constant over a batch of 4 take gradients near
        # rounding: 3e-3 here); the input bias, whose every step is
        # rounding, only within the 6 lr that three steps of each side
        # can part it
        P0 = {k: v[f] for k, v in P.items()}
        for k, p in want_p.items():
            if k == "input_layer.1.bias":
                assert (after[f][k] - p).abs().max() <= 6 * LR
                continue
            tol = 1e-2 if k == "input_layer.1.weight_orig" else 1e-4
            want = p - P0[k]
            assert (after[f][k] - P0[k] - want).norm() <= tol * want.norm(), k
        # the statistics after three steps, each within its tolerance of
        # its largest entry: the output layer's u and v 1e-5, the input
        # layer's 1e-3 (its kernel's entries near rounding), the running
        # variance 1e-5; the running mean also carries that bias's steps
        # of rounding, 0.1 of step 2's (the sides up to 2 lr apart) and
        # of step 3's (4 lr): 0.1 (0.9 * 2 + 4) lr more
        for k, v in want_s.items():
            tol = 1e-3 if k.startswith("input_layer.1") else 1e-5
            tol *= float(v.abs().max())
            if k.endswith("running_mean"):
                tol += ref.BN_MOMENTUM * (0.9 * 2 + 4) * LR
            assert (after[f][k] - v).abs().max() <= tol, k


def test_first_update_takes_the_trainers_bias_corrections(data):
    """One step at dropout 0: the output layer's update norms within 1e-6
    of the reference's (float32 sums in other orders: up to 1.6e-7 here).
    The reference takes AdamW's bias corrections 1 - beta^t as float32
    powers of the float32 betas, as the trainer does; ``torch.optim.
    AdamW`` takes them in double, which makes every update 6.4e-6 smaller
    (6.2e-6-6.8e-6 here) and fails this."""
    lr, hr = data
    P, S = _weights()
    tr = _trainer(data, P, S, 0.0)
    tr.step(torch.arange(B).expand(F, -1), torch.ones(F),
            torch.full((F,), LR))
    after = _named(tr, tr.p, tr.s)
    x = ref.triangle(lr).reshape(F, 3 * B, -1)
    y = hr.reshape(F, 3 * B, N_OUT, N_OUT)
    keep = torch.ones(B, HIDDEN, dtype=torch.bool)
    for f in range(F):
        P0 = {k: v[f] for k, v in P.items()}
        _, _, want, _ = ref.adamw_steps(
            P0, {k: v[f] for k, v in S.items()}, [(x[f, :B], y[f, :B])],
            [keep], LR, WD, 1.0, 0.0)
        for k in ("output_layer.0.weight_orig", "output_layer.0.bias"):
            got = (after[f][k] - P0[k]).double().norm()
            ref_norm = (want[k] - P0[k]).double().norm()
            assert abs(got - ref_norm) <= 1e-6 * ref_norm, k
