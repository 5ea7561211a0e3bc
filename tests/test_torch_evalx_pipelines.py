"""The pipelines' ``full_metrics`` path and the command line's
``--full-metrics`` / ``--eval-backend`` at the tiny 20 -> 32 size on the
CPU: the port's ``fold_metrics`` against the JAX pipelines' from the same
CSVs and initial weights, ``eval_metrics.json`` as the JAX command line
writes it, and the networkx backend named where it is missing.

Tolerance: the trainers agree to 1e-5 on the predictions (their own parity
bound), and every fold metric but PCC moves by far less: within 1e-6 of
the JAX pipeline's (1e-8 seen). PCC divides by the predictions' spread,
which is small after a few epochs: a change of at most d in each
prediction moves it by at most about 2 d / std(pred), so it is held to
2e-5 / std(pred) of the fold.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fcsr_tpu.data import io as j_io
from fcsr_tpu.pipelines import run_gat_cv_fast as j_run_gat_cv_fast
from fcsr_tpu.pipelines import run_gsr_cv_fast as j_run_gsr_cv_fast
from fcsr_tpu.train import GSRTrainConfig as JConfig
from fcsr_tpu.train import gat_loop as jgl
from fcsr_tpu_torch import cli, pipelines
from fcsr_tpu_torch.data import (kfold_indices, load_dataset,
                                 synthesize_teacher_connectomes,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.evalx import evaluate_pair_stacks
from fcsr_tpu_torch.iox.weights import (flax_to_state, gat_flax_to_state,
                                        gat_state_to_flat, state_to_flat)
from fcsr_tpu_torch.train import (GATTrainConfig, GSRTrainConfig,
                                  evaluate_gsr, evaluate_gsr_folds,
                                  predict_gat)

KS = (0.9, 0.7)
SEED = 42
KEYS = {"mae", "pcc", "js_distance", "kl_weights", "mae_betweenness",
        "mae_eigenvector", "mae_pagerank", "mae_core_periphery"}


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    lr, hr, lt = synthesize_teacher_connectomes(6, lr_dim=20, hr_dim=32,
                                                seed=1, n_test=3)
    d = tmp_path_factory.mktemp("kaggle_evalx")
    write_kaggle_csvs({"lr_train": lr, "hr_train": hr, "lr_test": lt},
                      str(d), nan_frac=0.01)
    return str(d)


def _folds(n):
    return kfold_indices(n, 2, seed=SEED)


def _assert_fold_metrics_match(ours, theirs, fold_preds):
    assert len(ours) == len(theirs) == len(fold_preds)
    for j, (a, b) in enumerate(zip(ours, theirs)):
        assert set(a) == set(b) == KEYS
        rows, cols = np.triu_indices(fold_preds[j].shape[-1], 1)
        spread = float(np.std(fold_preds[j][:, rows, cols]))
        for k in KEYS:
            tol = 2e-5 / spread if k == "pcc" else 1e-6
            assert np.isfinite(a[k]) and abs(a[k] - b[k]) <= tol, (j, k)


def test_run_gsr_cv_fast_full_metrics_matches_jax(csv_dir):
    data = j_io.load_dataset(csv_dir, cache=False)
    j_res = j_run_gsr_cv_fast(data, JConfig(epochs=3, fused_adam=True, ks=KS),
                              splits=2, full_metrics=True)
    jr = j_res["runner"]
    flat0 = np.stack([state_to_flat(flax_to_state(jax.tree_util.tree_map(
        np.asarray, jr.unravel(jr.flat0[j])))) for j in range(2)])
    t_res = pipelines.run_gsr_cv_fast(
        load_dataset(csv_dir, cache=False, device="cpu"),
        GSRTrainConfig(epochs=3, fused_adam=True, ks=KS), splits=2,
        full_metrics=True, flat0=flat0, device="cpu")
    np.testing.assert_allclose(t_res["fold_maes"], j_res["fold_maes"],
                               atol=1e-5)
    _, outs = evaluate_gsr_folds(t_res["cfg"], t_res["runner"])
    _assert_fold_metrics_match(t_res["fold_metrics"], j_res["fold_metrics"],
                               [preds for preds, _ in outs])


def _jax_gat_flat0(cfg, n_folds):
    model = cfg.model()
    flats = []
    for j in range(n_folds):
        k1, k2 = jax.random.split(jax.random.PRNGKey(SEED + j))
        v = model.init({"params": k1, "dropout": k2},
                       jnp.eye(cfg.n_nodes, dtype=jnp.float32) * 0.5)
        flats.append(gat_state_to_flat(gat_flax_to_state(
            jax.tree_util.tree_map(np.asarray, v))))
    return np.stack(flats)


def test_run_gat_cv_fast_full_metrics_matches_jax(csv_dir):
    """The fused step on both sides; with ``full_metrics`` the fold MAEs
    are taken on the host from the pulled predictions, as JAX does."""
    kw = dict(ks=(0.5, 0.5), dim=4, heads=2, drop_p=0.0, epochs=2,
              fused_step=True)
    j_res = j_run_gat_cv_fast(j_io.load_dataset(csv_dir, cache=False),
                              jgl.GATTrainConfig(**kw), splits=2, seed=SEED,
                              full_metrics=True)
    t_res = pipelines.run_gat_cv_fast(
        load_dataset(csv_dir, cache=False, device="cpu"),
        GATTrainConfig(**kw), splits=2, seed=SEED, full_metrics=True,
        flat0=_jax_gat_flat0(j_res["cfg"], 2), device="cpu")
    np.testing.assert_allclose(t_res["fold_maes"], j_res["fold_maes"],
                               atol=1e-5)
    lr = load_dataset(csv_dir, cache=False, device="cpu")["lr_train"]
    preds = [predict_gat(v, t_res["model"], t_res["cfg"], lr[va]).numpy()
             for v, (_, va) in zip(t_res["variables_per_fold"],
                                   _folds(6))]
    _assert_fold_metrics_match(t_res["fold_metrics"], j_res["fold_metrics"],
                               preds)
    plain = pipelines.run_gat_cv_fast(
        load_dataset(csv_dir, cache=False, device="cpu"),
        GATTrainConfig(**kw), splits=2, seed=SEED,
        flat0=_jax_gat_flat0(j_res["cfg"], 2), device="cpu")
    assert plain["fold_metrics"] == []
    # the host MAE of the pulled predictions equals the device MAE
    np.testing.assert_allclose(t_res["fold_maes"], plain["fold_maes"],
                               atol=1e-6)


def test_per_fold_pipelines_score_each_fold(csv_dir):
    """``run_gsr_cv`` scores each fold's kept subjects with the labels'
    diagonal at 1, ``run_gat_cv`` each fold's raw labels: the same dicts
    as the metric suite over those stacks."""
    data = load_dataset(csv_dir, cache=False, device="cpu")
    cfg = GSRTrainConfig(epochs=1, ks=KS)
    res = pipelines.run_gsr_cv(data, cfg, splits=2, full_metrics=True,
                               device="cpu")
    assert len(res["fold_metrics"]) == 2
    _, preds, gts = evaluate_gsr(None, res["model"], res["cfg"],
                                 data["lr_train"][_folds(6)[1][1]],
                                 data["hr_train"][_folds(6)[1][1]])
    assert res["fold_metrics"][1] == evaluate_pair_stacks(gts, preds,
                                                          device="cpu")
    gat = pipelines.run_gat_cv(
        data, splits=2, seed=SEED, full_metrics=True, device="cpu",
        cfg=GATTrainConfig(ks=(0.5, 0.5), dim=4, heads=2, drop_p=0.0,
                           epochs=1))
    assert len(gat["fold_metrics"]) == 2
    assert all(set(m) == KEYS for m in gat["fold_metrics"])


@pytest.mark.parametrize("family,flags", [("gsr", ["--fused"]),
                                          ("gat", ["--fast"])])
def test_cli_full_metrics_writes_eval_metrics_json(csv_dir, tmp_path, capsys,
                                                   family, flags):
    out = str(tmp_path / "out")
    assert cli.main(["train", family, *flags, "--full-metrics", "--epochs",
                     "1", "--splits", "2", "--data-dir", csv_dir,
                     "--out-dir", out, "--device", "cpu"]
                    + (["--dim", "4"] if family == "gat" else [])) == 0
    assert "metrics written" in capsys.readouterr().out
    with open(os.path.join(out, "eval_metrics.json")) as f:
        metrics = json.load(f)
    assert len(metrics) == 2
    assert all(set(m) == KEYS and all(np.isfinite(list(m.values())))
               for m in metrics)


def test_cli_networkx_backend(csv_dir, tmp_path, capsys, monkeypatch):
    """``--eval-backend networkx`` scores the folds with networkx; where
    networkx is missing it fails with an ImportError naming it, before any
    training; without ``--full-metrics`` it changes nothing and says so."""
    argv = ["train", "gsr", "--fused", "--epochs", "1", "--splits", "2",
            "--data-dir", csv_dir, "--device", "cpu", "--eval-backend",
            "networkx"]
    out = str(tmp_path / "nx")
    assert cli.main(argv + ["--full-metrics", "--out-dir", out]) == 0
    with open(os.path.join(out, "eval_metrics.json")) as f:
        nx_metrics = json.load(f)
    dev = str(tmp_path / "dev")
    assert cli.main(argv[:-2] + ["--full-metrics", "--out-dir", dev]) == 0
    with open(os.path.join(dev, "eval_metrics.json")) as f:
        dev_metrics = json.load(f)
    for a, b in zip(nx_metrics, dev_metrics):
        for k in KEYS:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-4, err_msg=k)
    capsys.readouterr()
    assert cli.main(argv + ["--out-dir", str(tmp_path / "none")]) == 0
    assert "--eval-backend changes nothing" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "none" / "eval_metrics.json")

    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ImportError, match="networkx"):
        cli.main(argv + ["--full-metrics", "--out-dir", out])
    for run in (pipelines.run_gsr_cv_fast, pipelines.run_gsr_cv,
                pipelines.run_gat_cv, pipelines.run_gat_cv_fast):
        with pytest.raises(ImportError, match="networkx"):
            run({"lr_train": None, "hr_train": None}, full_metrics=True,
                eval_backend="networkx", device="cpu")
