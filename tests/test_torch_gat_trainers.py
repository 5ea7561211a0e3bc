"""The port's GAT trainers (train/gat_loop.py) against the JAX package on
the CPU (the pipelines and the command line are in
``test_torch_gat_pipeline_cli.py``), at the tiny config (20 -> 32 nodes,
dim 4, ks = (0.5, 0.5), heads 2) and ``drop_p = 0``, from the JAX models'
own initial weights carried through ``iox/weights.py``.

Tolerances: loss histories 1e-5 (a dozen AdamW steps of fp32 sums in another
order); trained parameters 1e-4, the upsampler's bias apart: its gradient
is an exact zero in exact arithmetic (a softmax ignores a shift of its
column), so AdamW normalises rounding noise into steps of up to lr there,
in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.data.datamodule import kfold_indices as j_kfold
from fcsr_tpu.train import gat_loop as jgl
from fcsr_tpu_torch.iox.weights import gat_flax_to_state, gat_state_to_flat
from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig, init_gat,
                                           predict_gat, predict_gat_folds,
                                           predict_gat_folds_mae, train_gat,
                                           train_gat_folds_parallel)

TINY = dict(ks=(0.5, 0.5), n_nodes=20, m_nodes=32, dim=4, heads=2,
            drop_p=0.0)
NOISE_LEAF = "upsampler.upsample_mlp.bias"
SEED = 42


def _sparse_stack(rng, count, n, density):
    m = rng.random((count, n, n)) * (rng.random((count, n, n)) < density)
    m = np.triu(m, k=1)
    return (m + m.transpose(0, 2, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(7)
    # 7 subjects in 2 folds: ragged (4 + 3), so one padded no-op step
    return (_sparse_stack(rng, 7, 20, 0.5), _sparse_stack(rng, 7, 32, 1.0),
            j_kfold(7, 2, seed=SEED))


def _jax_flat0(cfg, seed, n_folds):
    """The JAX trainer's own per-fold inits, in the port's flat layout."""
    model = cfg.model()
    flats = []
    for j in range(n_folds):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed + j))
        v = model.init({"params": k1, "dropout": k2},
                       jnp.eye(cfg.n_nodes, dtype=jnp.float32) * 0.5)
        flats.append(gat_state_to_flat(gat_flax_to_state(
            jax.tree_util.tree_map(np.asarray, v))))
    return np.stack(flats)


def _assert_runs_agree(got, want, atol_hist=1e-5, atol_p=1e-4):
    (g_vars, g_hists), (w_vars, w_hists) = got, want
    assert len(g_hists) == len(w_hists)
    for gh, wh in zip(g_hists, w_hists):
        for key in ("train", "val", "lr"):
            assert len(gh[key]) == len(wh[key]), key
            np.testing.assert_allclose(gh[key], wh[key], atol=atol_hist,
                                       rtol=1e-6, err_msg=key)
    for gv, wv in zip(g_vars, w_vars):
        assert sorted(gv) == sorted(wv)
        for k in gv:
            if k != NOISE_LEAF:
                np.testing.assert_allclose(gv[k], wv[k], atol=atol_p,
                                           err_msg=k)


_MODES = {"unfused-device": ({}, False), "unfused-host": ({}, True),
          "fused-device": (dict(fused_step=True), False),
          "fused-host": (dict(fused_step=True), True)}


@pytest.fixture(scope="module")
def runs(dataset):
    """{mode: (port run, JAX run)}, each (best state_dicts, histories), 3
    epochs over the 2 ragged folds."""
    lr, hr, folds = dataset
    out = {}
    for mode, (flags, host) in _MODES.items():
        j_cfg = jgl.GATTrainConfig(epochs=3, **TINY, **flags)
        _, j_vars, j_hists = jgl.train_gat_folds_parallel(
            j_cfg, lr, hr, folds, seed=SEED, host_control=host)
        j_vars = [gat_flax_to_state(jax.tree_util.tree_map(np.asarray, v))
                  for v in j_vars]
        _, t_vars, t_hists = train_gat_folds_parallel(
            GATTrainConfig(epochs=3, **TINY, **flags), lr, hr, folds,
            seed=SEED, host_control=host, device="cpu",
            flat0=_jax_flat0(j_cfg, SEED, len(folds)))
        out[mode] = ((t_vars, t_hists), (j_vars, j_hists))
    return out


@pytest.mark.parametrize("mode", list(_MODES))
def test_fold_parallel_trainer_matches_jax(runs, mode):
    got, want = runs[mode]
    assert all(len(h["train"]) == 3 for h in got[1])
    _assert_runs_agree(got, want)


@pytest.mark.parametrize("a,b", [("unfused-device", "unfused-host"),
                                 ("fused-device", "fused-host"),
                                 ("fused-device", "unfused-device")])
def test_trainer_modes_agree_with_each_other(runs, a, b):
    """Host and on-device control are trajectory-identical at drop_p = 0
    (the same shuffle plans); the fused step tracks the autograd path."""
    _assert_runs_agree(runs[a][0], runs[b][0],
                       atol_hist=0 if a[:5] == b[:5] else 1e-6,
                       atol_p=0 if a[:5] == b[:5] else 1e-4)


def test_fused_val_off_equals_fused_val_on(dataset, runs):
    lr, hr, folds = dataset
    cfg = GATTrainConfig(epochs=3, fused_step=True, fused_val=False, **TINY)
    _, t_vars, t_hists = train_gat_folds_parallel(
        cfg, lr, hr, folds, seed=SEED, device="cpu",
        flat0=_jax_flat0(jgl.GATTrainConfig(**TINY), SEED, 2))
    _assert_runs_agree((t_vars, t_hists), runs["fused-device"][0],
                       atol_hist=1e-6, atol_p=1e-6)


def test_batched_chain_tracks_per_head(dataset, runs):
    lr, hr, folds = dataset
    cfg = GATTrainConfig(epochs=3, fused_step=True, fused_batched_chain=True,
                         **TINY)
    _, t_vars, t_hists = train_gat_folds_parallel(
        cfg, lr, hr, folds, seed=SEED, device="cpu",
        flat0=_jax_flat0(jgl.GATTrainConfig(**TINY), SEED, 2))
    _assert_runs_agree((t_vars, t_hists), runs["fused-device"][0],
                       atol_hist=1e-6)


def test_default_init_is_one_fresh_model_per_fold(dataset):
    lr, hr, folds = dataset
    cfg = GATTrainConfig(epochs=1, lr=0.0, weight_decay=0.0, **TINY)
    model, best, hists = train_gat_folds_parallel(cfg, lr, hr, folds,
                                                  seed=5, device="cpu")
    for j in range(2):
        fresh = cfg.model(device="cpu", seed=5 + j).state_dict()
        for k, v in fresh.items():
            np.testing.assert_array_equal(best[j][k], v.numpy())
    assert not np.array_equal(best[0]["pools.0.proj.weight"],
                              best[1]["pools.0.proj.weight"])
    assert isinstance(model, torch.nn.Module)


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
def test_plateau_decay_and_early_stop_match_jax(dataset, host):
    """patience 0 and a threshold no epoch can meet: the lr decays every
    epoch from the second on, and the fold stops once it is below 1e-5.
    Host control multiplies and compares in Python floats, on-device
    control in float32, so the two may stop one epoch apart; each path
    follows its JAX counterpart."""
    lr, hr, folds = dataset
    kw = dict(epochs=8, patience=0, plateau_threshold=0.5, **TINY)
    _, j_vars, j_hists = jgl.train_gat_folds_parallel(
        jgl.GATTrainConfig(**kw), lr, hr, folds, seed=SEED,
        host_control=host)
    _, t_vars, t_hists = train_gat_folds_parallel(
        GATTrainConfig(**kw), lr, hr, folds, seed=SEED, host_control=host,
        device="cpu", flat0=_jax_flat0(jgl.GATTrainConfig(**kw), SEED, 2))
    j_vars = [gat_flax_to_state(jax.tree_util.tree_map(np.asarray, v))
              for v in j_vars]
    _assert_runs_agree((t_vars, t_hists), (j_vars, j_hists))
    for h in t_hists:
        assert 3 <= len(h["lr"]) <= 4 < 8            # stopped early
        assert h["lr"][0] == pytest.approx(1e-3) and h["lr"][-1] < 1e-5
        np.testing.assert_allclose(h["lr"][1], 1e-4, rtol=1e-6)


def test_best_state_is_kept_not_the_last(dataset):
    """A learning rate that blows the loss up after the first epoch: the
    returned weights are the best epoch's, not the final ones."""
    lr, hr, folds = dataset
    cfg = GATTrainConfig(epochs=3, lr=0.5, **TINY)
    for host in (True, False):
        model, best, hists = train_gat_folds_parallel(
            cfg, lr, hr, folds, seed=SEED, host_control=host, device="cpu")
        for j, (tr, va) in enumerate(folds):
            k_best = int(np.argmin(hists[j]["val"]))
            again = train_gat_folds_parallel(
                GATTrainConfig(epochs=k_best + 1, lr=0.5, **TINY), lr, hr,
                folds, seed=SEED, host_control=host, device="cpu")[1]
            for k in best[j]:
                np.testing.assert_array_equal(best[j][k], again[j][k])


def test_train_gat_matches_jax(dataset):
    lr, hr, folds = dataset
    tr, va = folds[0]
    j_cfg = jgl.GATTrainConfig(epochs=3, **TINY)
    j_model, variables, tx, opt = jgl.init_gat(j_cfg,
                                               jax.random.PRNGKey(SEED))
    state0 = gat_flax_to_state(jax.tree_util.tree_map(np.asarray, variables))
    j_vars, _, j_hist = jgl.train_gat(variables, opt, j_model, tx, j_cfg,
                                      lr[tr], hr[tr], lr[va], hr[va],
                                      seed=SEED)
    cfg = GATTrainConfig(epochs=3, **TINY)
    model, opt_state = init_gat(cfg, 0, "cpu")
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in state0.items()})
    t_vars, opt_state, t_hist = train_gat(model, opt_state, cfg, lr[tr],
                                          hr[tr], lr[va], hr[va], seed=SEED)
    j_state = gat_flax_to_state(jax.tree_util.tree_map(np.asarray, j_vars))
    _assert_runs_agree(([t_vars], [t_hist]), ([j_state], [j_hist]))
    assert opt_state["t"] == 3 * len(tr)
    assert float(opt_state["v"].abs().max()) > 0
    for k, v in model.state_dict().items():          # the best weights
        np.testing.assert_array_equal(v.numpy(), t_vars[k])
    # predictions of the trained model against the JAX package's
    want = np.asarray(jgl.predict_gat(j_vars, j_model, j_cfg, lr[va]))
    got = predict_gat(t_vars, model, cfg, lr[va])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    torch.testing.assert_close(predict_gat(None, model, cfg, lr[va]), got)


def test_train_gat_equals_one_fold_of_the_parallel_trainer(dataset, runs):
    """``train_gat`` on fold 0 from the same weights is the fold-parallel
    host-control run's fold 0 (the shared shuffle seed is seed + 0)."""
    lr, hr, folds = dataset
    tr, va = folds[0]
    cfg = GATTrainConfig(epochs=3, **TINY)
    model, opt_state = init_gat(cfg, 0, "cpu")
    flat0 = _jax_flat0(jgl.GATTrainConfig(**TINY), SEED, 1)
    from fcsr_tpu_torch.iox.weights import gat_flat_to_state
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           gat_flat_to_state(flat0[0],
                                             cfg.layout.shapes).items()})
    t_vars, _, t_hist = train_gat(model, opt_state, cfg, lr[tr], hr[tr],
                                  lr[va], hr[va], seed=SEED)
    p_vars, p_hists = runs["unfused-host"][0]
    _assert_runs_agree(([t_vars], [t_hist]), ([p_vars[0]], [p_hists[0]]),
                       atol_hist=1e-7, atol_p=1e-6)


def test_fold_predictions_and_mae(dataset, runs):
    """``predict_gat_folds`` pads ragged folds; ``predict_gat_folds_mae``
    divides by m (m - 1) and averages over a fold's true size."""
    lr, hr, folds = dataset
    best = runs["unfused-device"][0][0]
    cfg = GATTrainConfig(**TINY)
    model = cfg.model(device="cpu")
    from fcsr_tpu_torch.train.gat_loop import precompute_gat_features
    lr_d, hr_d = torch.from_numpy(lr), torch.from_numpy(hr)
    x_d = torch.from_numpy(precompute_gat_features(lr, 4))
    va_len = max(len(va) for _, va in folds)
    va_idx = np.zeros((2, va_len), np.int64)
    for j, (_, va) in enumerate(folds):
        va_idx[j, :len(va)] = va
    preds = predict_gat_folds(model, best, lr_d, x_d, va_idx)
    assert preds.shape == (2, va_len, 32, 32)
    maes = predict_gat_folds_mae(model, best, lr_d, x_d, va_idx, hr_d,
                                 [len(va) for _, va in folds])
    off = ~np.eye(32, dtype=bool)
    for j, (_, va) in enumerate(folds):
        single = predict_gat(best[j], model, cfg, lr[va]).numpy()
        np.testing.assert_allclose(preds[j, :len(va)].numpy(), single,
                                   atol=1e-6)
        want = np.abs(single[:, off] - hr[va][:, off]).mean()
        np.testing.assert_allclose(float(maes[j]), want, rtol=1e-5)


def test_dropout_trained_mae_band(dataset):
    """At drop_p = 0.3 the fused trainer (the kernels' counter-based masks)
    and the autograd trainer (torch's generator) are two streams of one
    stochastic process: their trained validation losses agree within a band
    that a wrong keep rate or a missing 1 / (1 - p) would leave."""
    lr, hr, folds = dataset
    vals = {}
    for fused in (False, True):
        cfg = GATTrainConfig(**{**TINY, "drop_p": 0.3}, epochs=3,
                             fused_step=fused)
        _, _, hists = train_gat_folds_parallel(cfg, lr, hr, folds, seed=SEED,
                                               device="cpu")
        vals[fused] = np.array([h["val"][-1] for h in hists])
        assert all(np.isfinite(h["train"]).all() for h in hists)
    rel = np.abs(vals[True] - vals[False]) / np.abs(vals[False])
    assert np.all(rel < 0.25), (vals, rel)


def test_fused_dropout_run_is_reproducible_and_seeded(dataset):
    lr, hr, folds = dataset
    cfg = GATTrainConfig(**{**TINY, "drop_p": 0.3}, epochs=2, fused_step=True)
    runs_ = [train_gat_folds_parallel(cfg, lr, hr, folds, seed=s,
                                      device="cpu", flat0=_jax_flat0(
                                          jgl.GATTrainConfig(**TINY), 0, 2))
             for s in (1, 1, 2)]
    assert runs_[0][2] == runs_[1][2]
    assert runs_[0][2][0]["train"] != runs_[2][2][0]["train"]
