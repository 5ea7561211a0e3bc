"""The port's generic trainer (train/generic_loop.py) and the MLP losses
(train/losses.py) against the JAX package on the CPU, at the tiny 20 -> 32
configuration (hidden 26, one residual block; v1 hidden 26), inputs from
numpy seeds, initial weights carried across by ``mlp_flax_to_state``, at
dropout 0 (the port's dropout masks are not JAX's threefry bits).

Tolerances, as the JAX package's own test of ``SpectralResMLP`` sets them
(``tests/test_mlp_models.py``): control decisions (epochs run, the
learning-rate schedule) exactly; training losses rtol 2e-5 (+1e-7);
validation losses rtol 2e-2 (+5e-4); best states by their eval-mode
predictions, 5e-3. The model has directions of exactly zero gradient
(pre-BatchNorm biases, the radial scale of a spectral-norm kernel) along
which AdamW walks on float noise, differently in any two programs; the
training loss does not see them, the running statistics do. v1's training
losses take rtol 2e-4 and its predictions 2e-2 of their scale: its
pre-BatchNorm bias drifts by up to lr per step (0.02 here) and its
BatchNorm's ``mean(x^2) - mean^2`` rounds with it. The runs against the
JAX package take the shipped learning rate, 0.01: at 0.05 Adam's steps
along those directions change the rounding of later epochs enough that,
for some inits, a plateau decision lands within that noise of its
threshold and the two runs part (measured: 3 of 6 inits), in either
package against itself as well. The criterion is held to
1e-6 relative, the update to ``adamw_masked``'s plain version and the
fold-parallel trainer to the sequential one exactly (the fold axis changes
no summation order on the CPU), the clip to optax's to 1e-6 relative, and
dropout's keep rate to 6 binomial standard deviations.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from fcsr_tpu.core.vectorize import triu_indices_rowmajor
from fcsr_tpu.data.synthetic import synthesize_teacher_connectomes
from fcsr_tpu.models import mlp as jmlp
from fcsr_tpu.train import generic_loop as jgl
from fcsr_tpu.train import losses as jlosses
from fcsr_tpu_torch.iox.weights import mlp_flax_to_state
from fcsr_tpu_torch.kernels.ops import adamw_masked_plain
from fcsr_tpu_torch.models import mlp as tmlp
from fcsr_tpu_torch.train import generic_loop as tgl
from fcsr_tpu_torch.train import losses as tlosses

N_IN, N_OUT, HIDDEN = 20, 32, 26
# the shipped learning rate, and a plateau schedule that decays every
# second epoch and stops at epoch 7 of 14
KW = dict(num_epochs=14, lr=0.01, batch_size=8, patience=1,
          plateau_threshold=0.5, plateau_factor=0.05, seed=5,
          control_chunk_epochs=5)
V1_KW = dict(num_epochs=6, lr=0.01, batch_size=8, seed=5,
             control_chunk_epochs=5)


@pytest.fixture(scope="module")
def data():
    lr, hr = synthesize_teacher_connectomes(40, lr_dim=N_IN, hr_dim=N_OUT,
                                            seed=3)[:2]
    r, c = triu_indices_rowmajor(N_IN)
    return lr, hr, lr[:, r, c], jlosses.pack_triu_targets(hr)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(variant):
    if variant == "v2":
        return (jmlp.SpectralResMLP(num_nodes_input=N_IN,
                                    num_nodes_output=N_OUT,
                                    num_hidden=HIDDEN, n_layers=1,
                                    dropout=0.0, output="vector"),
                tmlp.SpectralResMLP(N_IN, N_OUT, HIDDEN, 1, dropout=0.0,
                                    output="vector", device="cpu"))
    return (jmlp.SuperResMLP(input_size=N_IN * N_IN,
                             output_size=N_OUT * N_OUT, hidden_dim=HIDDEN,
                             n_layers=1, dropout=0.0),
            tmlp.SuperResMLP(N_IN * N_IN, N_OUT * N_OUT, HIDDEN, 1,
                             dropout=0.0, device="cpu"))


def _init(jm, seed=0):
    return _np(jm.init({"params": jax.random.PRNGKey(seed),
                        "dropout": jax.random.PRNGKey(100 + seed)},
                       np.zeros((2, N_IN, N_IN), np.float32)))


RUNS = {"v2-device": ("v2", dict(host_control=False)),
        "v2-host": ("v2", dict(host_control=True)),
        "v2-validate2": ("v2", dict(validate_every=2)),
        "v1-device": ("v1", dict())}


@pytest.fixture(scope="module")
def runs(data):
    """{run: (JAX result, port result, JAX model, port model, inputs)},
    from the same initial weights."""
    lr, hr, x, y = data
    out = {}
    for name, (variant, extra) in RUNS.items():
        jm, tm = _models(variant)
        v0 = _init(jm)
        if variant == "v2":
            xs, ys, kw = x, y, dict(KW)
            j_crit, t_crit = (jlosses.make_triu_mse_criterion(N_OUT),
                              tlosses.make_triu_mse_criterion(N_OUT))
        else:
            xs, ys, kw = lr, hr, dict(V1_KW)
            j_crit, t_crit = jgl.mse_criterion, tgl.mse_criterion
        kw.update(extra)
        j = jgl.train_model(jm, v0, xs[:30], ys[:30], xs[30:], ys[30:],
                            criterion=j_crit, **kw)
        t = tgl.train_model(tm, mlp_flax_to_state(v0), xs[:30], ys[:30],
                            xs[30:], ys[30:], criterion=t_crit, device="cpu",
                            **kw)
        out[name] = (j, t, jm, tm, xs[30:])
    return out


@pytest.mark.parametrize("dense", [False, True], ids=["packed", "dense"])
def test_triu_mse_criterion_matches_jax_and_matrix_mse(data, dense):
    _, hr, _, y = data
    rng = np.random.default_rng(0)
    L = N_OUT * (N_OUT - 1) // 2
    pred = rng.random((6, L)).astype(np.float32)
    target = hr[:6] if dense else y[:6]
    got = float(tlosses.make_triu_mse_criterion(N_OUT)(
        torch.from_numpy(pred), torch.from_numpy(np.array(target))))
    want = float(jlosses.make_triu_mse_criterion(N_OUT)(pred, target))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    m = np.zeros((6, N_OUT, N_OUT), np.float32)
    r, c = np.triu_indices(N_OUT, 1)
    m[:, r, c] = pred
    m = m + m.transpose(0, 2, 1)
    mse = float(tgl.mse_criterion(torch.from_numpy(m),
                                  torch.from_numpy(hr[:6])))
    np.testing.assert_allclose(got, mse, rtol=1e-6)
    np.testing.assert_allclose(mse, float(jgl.mse_criterion(m, hr[:6])),
                               rtol=1e-6)
    # under vmap, one value per fold, as the trainers call it
    per_fold = torch.vmap(tlosses.make_triu_mse_criterion(N_OUT))(
        torch.from_numpy(pred).reshape(2, 3, L),
        torch.from_numpy(np.array(target)).reshape(2, 3, *target.shape[1:]))
    assert per_fold.shape == (2,)


def test_pack_triu_targets_matches_jax(data):
    _, hr, _, y = data
    np.testing.assert_array_equal(tlosses.pack_triu_targets(hr), y)


@pytest.mark.parametrize("name", list(RUNS))
def test_train_model_matches_jax(runs, name):
    (jth, jvh, jlh, jbest), (th, vh, lh, best), jm, tm, x_va = runs[name]
    variant = RUNS[name][0]
    assert len(th) == len(jth) and len(vh) == len(jvh)
    assert lh == [float(a) for a in jlh]
    np.testing.assert_allclose(th, jth, rtol=2e-5 if variant == "v2"
                               else 2e-4, atol=1e-7)
    np.testing.assert_allclose(vh, jvh, rtol=2e-2, atol=5e-4)
    want = np.asarray(jm.apply(jbest, x_va, train=False))
    got = tm.predict(best, torch.from_numpy(np.array(x_va))).numpy()
    if variant == "v2":
        np.testing.assert_allclose(got, want, atol=5e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


def test_runs_decay_and_stop_early(runs):
    """The plateau settings decay the rate and stop the v2 runs before
    their last epoch; validate_every=2 validates every second epoch and
    the last."""
    (_, _, lh, _) = runs["v2-device"][1]
    assert len(set(lh)) > 2 and lh[-1] < 1e-5
    assert len(runs["v2-device"][1][0]) < KW["num_epochs"]
    th, vh = runs["v2-validate2"][1][:2]
    assert len(vh) == (len(th) + 1) // 2 or len(vh) == len(th) // 2 + 1


def test_host_and_device_control_agree(runs):
    """The host loop keeps Python floats, the device loop float32 tensors:
    the same decisions and learning rates up to float32, losses and best
    states to the tolerances above (after a decay the host's rate, float32
    of a float64 product, and the device's, a float32 product, can part in
    the last bit)."""
    (th, vh, lh, best), (th2, vh2, lh2, best2) = (runs["v2-device"][1],
                                                  runs["v2-host"][1])
    assert len(th) == len(th2) and len(vh) == len(vh2)
    np.testing.assert_allclose(lh, lh2, rtol=1e-6)
    np.testing.assert_allclose(th, th2, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(vh, vh2, rtol=2e-2, atol=5e-4)
    tm, x_va = runs["v2-device"][3], torch.from_numpy(runs["v2-device"][4])
    np.testing.assert_allclose(tm.predict(best, x_va).numpy(),
                               tm.predict(best2, x_va).numpy(), atol=5e-3)


def test_train_model_folds_equals_sequential(data):
    """Three folds trained together against three ``train_model`` runs from
    the same inits and seeds. Fold 1 validates on noise, so its plateau
    and early stop run apart from the others': the control state is per
    fold. Held to the JAX test's tolerances; on the CPU the two are equal
    bit for bit."""
    _, _, x, y = data
    _, tm = _models("v2")
    folds = [(np.arange(0, 30), np.arange(30, 40)),
             (np.arange(10, 40), np.arange(0, 10)),
             (np.r_[0:10, 20:40], np.arange(10, 20))]
    seeds = [5, 6, 7]
    tr_idx = np.stack([tr for tr, _ in folds])
    va_idx = np.stack([va for _, va in folds])
    y_va = y[va_idx].copy()
    y_va[1] = np.random.default_rng(0).random(y_va[1].shape)
    p0, s0 = tm.init_flat([0, 1, 2], "cpu")
    kw = {k: v for k, v in KW.items() if k != "seed"}
    kw["lr"] = 0.05          # the port against itself: no rounding apart
    crit = tlosses.make_triu_mse_criterion(N_OUT)
    par, (bp, bs) = tgl.train_model_folds(
        tm, (p0.clone(), s0.clone()), x[tr_idx], y[tr_idx], x[va_idx], y_va,
        seeds=seeds, criterion=crit, return_stacked=True, device="cpu", **kw)
    assert bp.shape == p0.shape and bs.shape == s0.shape
    lengths = set()
    for j, (tr, va) in enumerate(folds):
        th, vh, lh, best = tgl.train_model(
            tm, (p0[j].clone(), s0[j].clone()), x[tr], y[tr], x[va], y_va[j],
            seed=seeds[j], criterion=crit, device="cpu", **kw)
        thp, vhp, lhp, bestp = par[j]
        assert len(thp) == len(th) and len(vhp) == len(vh)
        lengths.add(len(thp))
        np.testing.assert_allclose(thp, th, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(lhp, lh, rtol=1e-6)
        np.testing.assert_allclose(vhp, vh, rtol=2e-2, atol=5e-4)
        x_va = torch.from_numpy(x[va])
        np.testing.assert_allclose(tm.predict(bestp, x_va).numpy(),
                                   tm.predict(best, x_va).numpy(), atol=5e-3)
        assert thp == th and vhp == vh
        for k in best:
            assert torch.equal(bestp[k], best[k]), k
    assert len(lengths) > 1 or len({tuple(p[2]) for p in par}) > 1


def test_train_model_folds_matches_jax(data):
    """The port's fold-parallel trainer against the JAX package's (its
    vmapped control program) from the same three inits, at the tolerances
    above; ``TrainState`` keeps the JAX package's fields."""
    _, _, x, y = data
    jm, tm = _models("v2")
    folds = [(np.arange(0, 30), np.arange(30, 40)),
             (np.arange(10, 40), np.arange(0, 10)),
             (np.r_[0:10, 20:40], np.arange(10, 20))]
    inits = [_init(jm, j) for j in range(3)]
    stack = jax.tree_util.tree_map(lambda *a: np.stack(a), *inits)
    tr_idx = np.stack([tr for tr, _ in folds])
    va_idx = np.stack([va for _, va in folds])
    kw = {k: v for k, v in KW.items() if k != "seed"}
    args = (x[tr_idx], y[tr_idx], x[va_idx], y[va_idx])
    want = jgl.train_model_folds(
        jm, stack, *args, seeds=[5, 6, 7],
        criterion=jlosses.make_triu_mse_criterion(N_OUT), **kw)
    got = tgl.train_model_folds(
        tm, {k: np.stack([mlp_flax_to_state(v)[k] for v in inits])
             for k in mlp_flax_to_state(inits[0])}, *args, seeds=[5, 6, 7],
        criterion=tlosses.make_triu_mse_criterion(N_OUT), device="cpu", **kw)
    for j, ((th, vh, lh, best), (jth, jvh, jlh, jbest)) in enumerate(
            zip(got, want)):
        assert len(th) == len(jth) and len(vh) == len(jvh)
        assert lh == [float(a) for a in jlh]
        np.testing.assert_allclose(th, jth, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(vh, jvh, rtol=2e-2, atol=5e-4)
        x_va = x[folds[j][1]]
        np.testing.assert_allclose(
            tm.predict(best, torch.from_numpy(x_va)).numpy(),
            np.asarray(jm.apply(jbest, x_va, train=False)), atol=5e-3)
    assert set(tgl.TrainState.__dataclass_fields__) == set(
        jgl.TrainState.__dataclass_fields__)


def _trainer(data, F=3, dropout=0.0, seed=5):
    _, _, x, y = data
    tm = tmlp.SpectralResMLP(N_IN, N_OUT, HIDDEN, 1, dropout=dropout,
                             output="vector", device="cpu")
    p, s = tm.init_flat(list(range(F)), "cpu")
    idx = np.stack([np.arange(30) + 3 * f for f in range(F)]) % 40
    return tgl._FoldTrainer(tm, p, s, x[idx], y[idx], x[idx[:, :6]],
                            y[idx[:, :6]], seed, 8,
                            tlosses.make_triu_mse_criterion(N_OUT), 1.0,
                            0.01, torch.device("cpu"))


def test_masked_step_is_adamw_masked_plain(data):
    """One step with fold 1 masked: the update is ``adamw_masked``'s plain
    version on the clipped gradient with [ok, lr, 1 - 0.9^t, 1 - 0.999^t]
    (bit for bit); the masked fold's parameters, moments, statistics and
    step count stay as they were; the clipped gradient is optax's
    ``clip_by_global_norm(1.0)`` of the fold's gradient."""
    tr = _trainer(data)
    p0, m0, v0, s0 = (t.clone() for t in (tr.p, tr.m, tr.v, tr.s))
    idx = torch.arange(8).repeat(3, 1)
    ok = torch.tensor([1.0, 0.0, 1.0])
    lr = torch.tensor([0.01, 0.02, 0.03])
    # the unclipped gradient of the same step, by autograd on copies
    pp = p0.clone().requires_grad_()
    pred, _ = tr.model.fold_forward(tr.model.layout.params.views(pp),
                                    tr.model.layout.stats.views(s0.clone()),
                                    tr.x_tr[tr.folds, idx], True)
    torch.vmap(tlosses.make_triu_mse_criterion(N_OUT))(
        pred, tr.y_tr[tr.folds, idx]).sum().backward()
    raw = pp.grad.clone()
    loss = tr.step(idx, ok, lr)
    assert loss.shape == (3,)
    t = torch.ones(3)              # optax's bias corrections in float32
    scal = torch.stack([ok, lr, 1 - 0.9 ** t, 1 - 0.999 ** t], dim=-1)
    want = adamw_masked_plain(p0, m0, v0, tr.g, scal, loss[:, None], 0.9,
                              0.999, 1e-8, 0.01)
    for got, w in zip((tr.p, tr.m, tr.v), want[:3]):
        assert torch.equal(got, w)
    for got, before in ((tr.p, p0), (tr.m, m0), (tr.v, v0), (tr.s, s0)):
        assert torch.equal(got[1], before[1])
    assert not torch.equal(tr.s[0], s0[0])
    assert tr.t.tolist() == [1.0, 0.0, 1.0]
    for f in (0, 2):
        clipped = optax.clip_by_global_norm(1.0).update(
            [raw[f].numpy()], optax.EmptyState())[0][0]
        np.testing.assert_allclose(tr.g[f].numpy(), clipped, rtol=1e-6,
                                   atol=1e-9)


def test_dropout_keep_rate_and_scale(data):
    """At 0.1 the kept share lies within 6 binomial standard deviations of
    0.9 and every kept entry is x / 0.9; the masks come from the seeded
    generator (the same seed, the same masks); evaluation and rate 0 are
    the identity; a trainer at 0.1 is reproducible from its seed."""
    x = torch.ones(3, 64, 1000)
    gen = torch.Generator().manual_seed(1)
    y = tmlp.dropout_fold(x, 0.1, True, gen)
    kept = y != 0
    n = kept.numel()
    assert abs(kept.float().mean().item() - 0.9) < 6 * np.sqrt(
        0.9 * 0.1 / n)
    assert torch.all(y[kept] == torch.tensor(1.0) / 0.9)
    assert torch.equal(y, tmlp.dropout_fold(
        x, 0.1, True, torch.Generator().manual_seed(1)))
    assert tmlp.dropout_fold(x, 0.1, False, gen) is x
    assert tmlp.dropout_fold(x, 0.0, True, gen) is x
    idx = torch.arange(8).repeat(3, 1)
    ok, lr = torch.ones(3), torch.full((3,), 0.01)
    a, b, c = (_trainer(data, dropout=d, seed=sd)
               for d, sd in ((0.1, 5), (0.1, 5), (0.0, 5)))
    la, lb, lc = (t.step(idx, ok, lr) for t in (a, b, c))
    assert torch.equal(la, lb) and torch.equal(a.p, b.p)
    assert not torch.equal(la, lc)


def test_run_without_finite_validation_keeps_final_state(data):
    """No finite validation loss: both loops return the final state, not
    the initial one."""
    _, _, x, y = data
    _, tm = _models("v2")
    p0, s0 = tm.init_flat([0], "cpu")
    y_nan = np.full_like(y[30:], np.nan)
    out = [tgl.train_model(tm, (p0.clone(), s0.clone()), x[:30], y[:30],
                           x[30:], y_nan, num_epochs=3, lr=0.01,
                           batch_size=8,
                           criterion=tlosses.make_triu_mse_criterion(N_OUT),
                           host_control=host, device="cpu")
           for host in (False, True)]
    init = tmlp.SpectralResMLP(N_IN, N_OUT, HIDDEN, 1, device="cpu",
                               seed=0).state_dict()
    for (th, vh, lh, best) in out:
        assert len(th) == 3 and np.isnan(vh).all()
        assert not torch.equal(best["input_layer.1.weight_orig"],
                               init["input_layer.1.weight_orig"])
    for k in out[0][3]:
        assert torch.equal(out[0][3][k], out[1][3][k]), k
