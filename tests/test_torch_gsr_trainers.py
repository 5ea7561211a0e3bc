"""Every way the port trains GSR-Net against the JAX package, on the CPU
at the tiny size (20 -> 32 nodes, ks=(0.9, 0.7)): the fold-parallel
``GSRFoldRunner`` in each mode against the JAX runner in the same mode
(Pallas interpret mode) and the modes against each other; the parity
trainer (``make_train_fn``, ``train_gsr_fold``, ``run_gsr_cv``) against
its JAX counterpart step by step; padding; the command line.

Tolerances: bf16x3 against fp32 products over a handful of Adam steps move
a loss by up to 1e-4 and a parameter by up to 1e-5 (lr = 1e-4, so one
step moves a parameter by at most ~1e-4); two modes of the port differ
only in the order of fp32 sums and stay within 1e-5 / 1e-6.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from fcsr_tpu.pipelines import run_gsr_cv as j_run_gsr_cv
from fcsr_tpu.train import GSRTrainConfig as JConfig
from fcsr_tpu.train import init_gsr as j_init_gsr
from fcsr_tpu.train import precompute_spectral as j_spectral
from fcsr_tpu.train.fast_loop import GSRFoldRunner as JRunner
from fcsr_tpu.train.gsr_loop import make_train_fn as j_make_train_fn
from fcsr_tpu_torch import cli, pipelines
from fcsr_tpu_torch.data import (kfold_indices,
                                 synthesize_teacher_connectomes,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.iox import load_state
from fcsr_tpu_torch.iox.weights import flax_to_state, state_to_flat
from fcsr_tpu_torch.train import (GSRFoldRunner, GSRTrainConfig, init_gsr,
                                  make_train_fn, precompute_spectral,
                                  train_gsr_fold, trainer_mode)

KS = (0.9, 0.7)
TINY = dict(lr_dim=20, hr_dim=32, hidden_dim=32, ks=KS)
MODES = {
    "unfused": {},
    "fused_tail": dict(fused_tail=True),
    "fused_tail_unet": dict(fused_tail=True, fused_unet=True),
    "fused_tail_unet_bwd": dict(fused_tail=True, fused_unet=True,
                                fused_unet_bwd=True),
    "fused_step": dict(fused_step=True),
    "fused_adam": dict(fused_adam=True),
}
NEW_MODES = [m for m in MODES if m != "fused_adam"]


def _data(n, seed=2, **kw):
    return synthesize_teacher_connectomes(n, lr_dim=20, hr_dim=32, seed=seed,
                                          **kw)


def _flat_from_jax(jr, flat):
    return np.stack([state_to_flat(flax_to_state(jax.tree_util.tree_map(
        np.asarray, jr.unravel(flat[j])))) for j in range(flat.shape[0])])


def _runner(mode, epochs=2, n=5, **kw):
    lr, hr = _data(n)
    cfg = GSRTrainConfig(epochs=epochs, **TINY, **MODES[mode])
    return GSRFoldRunner(cfg, lr, hr, kfold_indices(n, 2, seed=42),
                         device="cpu", **kw)


@pytest.mark.parametrize("mode", NEW_MODES)
def test_trainer_mode_matches_jax_runner(mode):
    """2 epochs over 2 folds of 3 and 2 subjects (one masked step per
    epoch), from the JAX runner's initial weights."""
    lr, hr = _data(5)
    folds = kfold_indices(5, 2, seed=42)
    jr = JRunner(JConfig(epochs=2, **TINY, **MODES[mode]), lr, hr, folds)
    j_p, j_loss, j_err = jr.train()
    j_mae, _ = jr.evaluate()
    r = GSRFoldRunner(GSRTrainConfig(epochs=2, **TINY, **MODES[mode]), lr,
                      hr, folds, flat0=_flat_from_jax(jr, jr.flat0),
                      device="cpu")
    assert r.mode == mode and r.tr_valid.sum() < r.tr_valid.size
    p, loss, err = r.train()
    mae, _ = r.evaluate()
    np.testing.assert_allclose(loss, np.asarray(j_loss), atol=1e-4)
    np.testing.assert_allclose(err, np.asarray(j_err), atol=1e-4)
    np.testing.assert_allclose(p.numpy(), _flat_from_jax(jr, j_p), atol=1e-5)
    np.testing.assert_allclose(mae, np.asarray(j_mae), atol=1e-5)


@pytest.fixture(scope="module")
def mode_runs():
    """(p, loss_hist, err_hist, val MAE) of 3 epochs in every mode, from
    the same initial weights."""
    out = {}
    for mode in MODES:
        r = _runner(mode, epochs=3)
        p, lh, eh = r.train()
        out[mode] = (p, lh, eh, r.evaluate()[0])
    return out


def test_fused_step_trainer_is_bit_equal_to_fused_adam(mode_runs):
    """The JAX package pins the two bit-exact on the CPU; the port's pair
    shares every launch but the loss scalars' and ends in the same
    ``adam_masked``."""
    a, b = mode_runs["fused_step"], mode_runs["fused_adam"]
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", [m for m in NEW_MODES if m != "fused_step"])
def test_trainer_modes_agree_with_fused_adam(mode_runs, mode):
    got, want = mode_runs[mode], mode_runs["fused_adam"]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], atol=1e-6)
    assert np.all(got[1][:, -1] < got[1][:, 0])            # it trains


@pytest.mark.parametrize("mode", sorted(MODES))
def test_masked_step_leaves_state_untouched_in_every_mode(mode):
    r = _runner(mode)
    rng = np.random.default_rng(0)
    p = r.flat0.clone()
    m = torch.from_numpy(rng.normal(0, 1e-3, p.shape).astype(np.float32))
    v = torch.from_numpy(np.abs(rng.normal(0, 1e-3, p.shape))
                         .astype(np.float32))
    scal = torch.tensor([[1.0, 1 - 0.9 ** 3, 1 - 0.999 ** 3],
                         [0.0, 1 - 0.9, 1 - 0.999]])
    loss, err, p2, m2, v2 = r._step(p, m, v, 0, scal)
    for new, old in ((p2, p), (m2, m), (v2, v)):
        assert torch.equal(new[1], old[1])
        assert not torch.equal(new[0], old[0])
    assert float(loss[1]) == 0.0 and float(err[1]) == 0.0
    assert float(loss[0]) > 0.0 and not loss.requires_grad
    # the padded slot of the shorter fold does not count: its epoch mean
    # is over its own two steps, and its step count stays behind
    state, lh, _ = r._run_chunk(r.fresh_state(), 1)
    assert sorted(state[3].tolist()) == [2.0, 3.0]
    np.testing.assert_array_equal(state[3], r.tr_valid.sum(axis=1))
    assert np.isfinite(lh).all()


def test_trainer_mode_follows_the_jax_precedence():
    every = dict(fused_tail=True, fused_unet=True, fused_unet_bwd=True)
    for kw, want in [
            ({}, "unfused"),
            (dict(fused_unet=True, fused_unet_bwd=True), "unfused"),
            (dict(fused_tail=True, fused_unet_bwd=True), "fused_tail"),
            (dict(fused_tail=True, fused_unet=True), "fused_tail_unet"),
            (every, "fused_tail_unet_bwd"),
            (dict(fused_step=True, **every), "fused_step"),
            (dict(fused_adam=True, fused_step=True, **every), "fused_adam")]:
        assert trainer_mode(GSRTrainConfig(**kw)) == want
    for name, kw in MODES.items():
        assert trainer_mode(GSRTrainConfig(**kw)) == name


def test_config_keeps_the_jax_fields_and_refuses_bf16():
    """The JAX config's fields and defaults; ``compute_dtype="bf16"`` is
    accepted (the unfused runner's bf16 step, tests/test_torch_bf16_step.py),
    a mistyped dtype still refused."""
    j_fields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(GSRTrainConfig)}
    assert t_fields == j_fields
    assert GSRTrainConfig(compute_dtype="bf16").compute_dtype == "bf16"
    with pytest.raises(ValueError, match="compute_dtype"):
        GSRTrainConfig(compute_dtype="f16")


@pytest.mark.parametrize("mode", [m for m in MODES if m != "unfused"])
def test_fused_modes_refuse_padding(mode):
    lr, hr = _data(5)
    cfg = GSRTrainConfig(padding=2, lr_dim=20, hr_dim=36, hidden_dim=36,
                         ks=KS, **MODES[mode])
    with pytest.raises(ValueError, match="padding != 0 is not supported by "
                                         "the fused kernel paths"):
        GSRFoldRunner(cfg, lr, hr, kfold_indices(5, 2, seed=42),
                      device="cpu")


def test_unfused_trainer_with_padding_matches_jax():
    """padding=2: the model works at 36 nodes, the loss and the MAE on the
    32-node crop."""
    lr, hr = _data(5)
    folds = kfold_indices(5, 2, seed=42)
    kw = dict(epochs=2, padding=2, lr_dim=20, hr_dim=36, hidden_dim=36, ks=KS)
    jr = JRunner(JConfig(**kw), lr, hr, folds)
    j_p, j_loss, j_err = jr.train()
    j_mae, j_preds = jr.evaluate()
    r = GSRFoldRunner(GSRTrainConfig(**kw), lr, hr, folds,
                      flat0=_flat_from_jax(jr, jr.flat0), device="cpu")
    p, loss, err = r.train()
    mae, preds = r.evaluate()
    assert tuple(preds.shape) == (2, 3, 32, 32)
    np.testing.assert_allclose(loss, np.asarray(j_loss), atol=1e-4)
    np.testing.assert_allclose(err, np.asarray(j_err), atol=1e-4)
    np.testing.assert_allclose(p.numpy(), _flat_from_jax(jr, j_p), atol=1e-5)
    np.testing.assert_allclose(mae, np.asarray(j_mae), atol=1e-5)
    np.testing.assert_allclose(preds.numpy(), np.asarray(j_preds), atol=1e-5)


# ---------------------------------------------------------------------------
# the parity trainer
# ---------------------------------------------------------------------------

def _model_from_jax(cfg, seed=0, device="cpu"):
    """``init_gsr`` of the port carrying the JAX package's initial weights
    for the same seed."""
    model, optimizer = init_gsr(cfg, seed, device)
    j_cfg = JConfig(**{f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(JConfig)})
    _, params, _, _ = j_init_gsr(j_cfg, jax.random.PRNGKey(seed))
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                           flax_to_state(jax.tree_util.tree_map(
                               np.asarray, params)).items()})
    return model, optimizer


def test_parity_trainer_matches_jax_step_by_step():
    """make_train_fn(per_step=True): every step's loss and error over 2
    epochs of 4 subjects, then the parameters."""
    lr, hr = _data(4)
    cfg = GSRTrainConfig(epochs=2, **TINY)
    j_cfg = JConfig(epochs=2, **TINY)
    j_model, j_params, tx, opt_state = j_init_gsr(j_cfg,
                                                  jax.random.PRNGKey(0))
    u_lr, u_hr = j_spectral(lr, hr, lr_dim=20)
    t_u_lr, t_u_hr = precompute_spectral(lr, hr, lr_dim=20)
    np.testing.assert_array_equal(t_u_lr, np.asarray(u_lr))
    j_params, _, j_loss, j_err = j_make_train_fn(
        j_model, tx, j_cfg, per_step=True)(
        j_params, opt_state, lr, hr, np.asarray(u_lr, np.float32),
        np.asarray(u_hr, np.float32))
    model, optimizer = _model_from_jax(cfg)
    stacks = [torch.from_numpy(np.asarray(a, np.float32))
              for a in (lr, hr, t_u_lr, t_u_hr)]
    loss, err = make_train_fn(model, optimizer, cfg, per_step=True)(*stacks)
    assert tuple(loss.shape) == tuple(err.shape) == (2, 4)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), atol=1e-5)
    np.testing.assert_allclose(err.numpy(), np.asarray(j_err), atol=1e-5)
    want = flax_to_state(jax.tree_util.tree_map(np.asarray, j_params))
    for k, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k], atol=1e-6, err_msg=k)
    # the epoch means of train_gsr_fold are the per-step rows' means
    model2, optimizer2 = _model_from_jax(cfg)
    hist = train_gsr_fold(model2, optimizer2, cfg, lr, hr)
    np.testing.assert_allclose(hist["loss"], loss.numpy().mean(1), rtol=1e-6)
    np.testing.assert_allclose(hist["error"], err.numpy().mean(1), rtol=1e-6)
    for k, t in model2.state_dict().items():
        assert torch.equal(t, model.state_dict()[k])


def test_parity_trainer_equals_the_unfused_fold_runner():
    """One fold of the fold-parallel unfused trainer is the parity
    trainer's update sequence (the JAX package's clean-CV equivalence)."""
    lr, hr = _data(5)
    folds = kfold_indices(5, 2, seed=42)
    cfg = GSRTrainConfig(epochs=2, **TINY)
    r = GSRFoldRunner(cfg, lr, hr, folds, device="cpu")
    p, loss, _ = r.train()
    for j, (tr, _) in enumerate(folds):
        model, optimizer = init_gsr(cfg, j, "cpu")
        hist = train_gsr_fold(model, optimizer, cfg, lr[tr], hr[tr])
        np.testing.assert_allclose(hist["loss"], loss[j], atol=1e-5)
        flat = state_to_flat({k: t.numpy()
                              for k, t in model.state_dict().items()})
        np.testing.assert_allclose(p[j].numpy(), flat, atol=1e-6)


@pytest.fixture(scope="module")
def cv_data():
    lr, hr, lt = _data(8, seed=5, n_test=2)
    return {"lr_train": lr, "hr_train": hr, "lr_test": lt}


@pytest.mark.parametrize("reset", [False, True], ids=["carryover", "reset"])
def test_run_gsr_cv_matches_jax(cv_data, monkeypatch, reset):
    """Fold MAEs, test predictions and final parameters of 2 folds x 2
    epochs, the model carried across the folds or reset per fold."""
    monkeypatch.setattr(pipelines, "init_gsr", _model_from_jax)
    j_res = j_run_gsr_cv(cv_data, JConfig(epochs=2, ks=KS), splits=2,
                         reset_per_fold=reset)
    t_res = pipelines.run_gsr_cv(cv_data, GSRTrainConfig(epochs=2, ks=KS),
                                 splits=2, reset_per_fold=reset,
                                 device="cpu")
    assert set(j_res) <= set(t_res) and t_res["cfg"].hr_dim == 32
    np.testing.assert_allclose(t_res["fold_maes"], j_res["fold_maes"],
                               atol=1e-5)
    assert abs(t_res["mean_mae"] - j_res["mean_mae"]) <= 1e-5
    np.testing.assert_allclose(t_res["test_preds"].numpy(),
                               j_res["test_preds"], atol=1e-5)
    want = flax_to_state(jax.tree_util.tree_map(np.asarray, j_res["params"]))
    for k, v in t_res["params"].items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, err_msg=k)
    for key in ("n_train_steps", "n_eval_forwards"):
        assert t_res[key] == j_res[key]
    assert sorted(t_res["timings"]) == ["eval", "spectral", "train"]


def test_run_gsr_cv_carryover_and_reset_differ(cv_data):
    cfg = GSRTrainConfig(epochs=2, ks=KS)
    carry = pipelines.run_gsr_cv(cv_data, cfg, splits=2, full_metrics=True,
                                 device="cpu")
    reset = pipelines.run_gsr_cv(cv_data, cfg, splits=2,
                                 reset_per_fold=True, device="cpu")
    # fold 0 of reset mode starts from the carried model's one init
    np.testing.assert_allclose(carry["fold_maes"][0], reset["fold_maes"][0],
                               atol=1e-6)
    assert abs(carry["fold_maes"][1] - reset["fold_maes"][1]) > 1e-6
    assert tuple(carry["test_preds"].shape) == (2, 32, 32)
    # full_metrics scores each fold with the metric suite
    assert len(carry["fold_metrics"]) == 2 and reset["fold_metrics"] == []
    assert all(len(m) == 8 and np.isfinite(list(m.values())).all()
               for m in carry["fold_metrics"])


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    lr, hr, lt = _data(6, seed=1, n_test=3)
    d = tmp_path_factory.mktemp("kaggle")
    write_kaggle_csvs({"lr_train": lr, "hr_train": hr, "lr_test": lt},
                      str(d), nan_frac=0.01)
    return str(d)


@pytest.mark.parametrize("flags,mode", [
    ([], "parity"), (["--reset-per-fold"], "parity"),
    (["--fast"], "unfused"), (["--fast", "--fused-tail"], "fused_tail"),
    (["--fused"], "fused_adam")], ids=lambda x: "_".join(x).strip("-")
    if isinstance(x, list) else x)
def test_cli_train_gsr_in_every_mode(csv_dir, tmp_path, capsys, monkeypatch,
                                     flags, mode):
    seen = []
    real = pipelines.run_gsr_cv_fast

    def spy(data, cfg, **kw):
        seen.append(trainer_mode(cfg))
        return real(data, cfg, **kw)

    monkeypatch.setattr(pipelines, "run_gsr_cv_fast", spy)
    out_dir = str(tmp_path / "out")
    rc = cli.main(["train", "gsr", *flags, "--epochs", "1", "--splits", "2",
                   "--data-dir", csv_dir, "--out-dir", out_dir, "--device",
                   "cpu"])
    assert rc == 0
    assert seen == ([] if mode == "parity" else [mode])
    out = capsys.readouterr().out.splitlines()
    report = json.loads(out[0])
    assert len(report["fold_maes"]) == 2 and np.isfinite(report["mean_mae"])
    assert ("spectral" in report["timings"]) == (mode == "parity")
    assert sorted(os.listdir(out_dir)) == ["gsr_params.npz",
                                           "submission.csv"]
    state = load_state(os.path.join(out_dir, "gsr_params.npz"))
    assert state["layer.weights"].shape == (32, 20)
    with open(os.path.join(out_dir, "submission.csv")) as f:
        assert sum(1 for _ in f) == 1 + 3 * 32 * 31 // 2


def test_cli_notes_flags_that_change_nothing(csv_dir, tmp_path, capsys):
    base = ["--epochs", "1", "--splits", "2", "--data-dir", csv_dir,
            "--out-dir", str(tmp_path / "o"), "--device", "cpu"]
    assert cli.main(["train", "gsr", "--fused-tail", "--checkpoint",
                     str(tmp_path / "ck.npz"), *base]) == 0
    err = capsys.readouterr().err
    assert "--fused-tail changes nothing on the parity trainer" in err
    assert "--checkpoint changes nothing on the parity trainer" in err
    assert not os.path.exists(tmp_path / "ck.npz")
    assert cli.main(["train", "gsr", "--fast", "--reset-per-fold",
                     "--verbose", *base]) == 0
    err = capsys.readouterr().err
    assert "--reset-per-fold changes nothing" in err
    assert "--verbose changes nothing" in err
