"""The port's GAT pipelines (``run_gat_cv``, ``run_gat_cv_fast``) and
``train gat`` on tiny Kaggle-format CSVs (20 -> 32 nodes) against the JAX
package on the CPU, and what the command line and the entry points still
refuse. Tolerances: fold MAEs, histories and test predictions 1e-5 (a few
AdamW steps of fp32 sums in another order)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.data import io as j_io
from fcsr_tpu.data.datamodule import kfold_indices as j_kfold
from fcsr_tpu.pipelines import run_gat_cv_fast as j_run_gat_cv_fast
from fcsr_tpu.train import gat_loop as jgl
from fcsr_tpu_torch import cli
from fcsr_tpu_torch.data import (load_dataset,
                                 synthesize_teacher_connectomes,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.iox import load_arrays
from fcsr_tpu_torch.iox.weights import gat_flax_to_state, gat_state_to_flat
from fcsr_tpu_torch.kernels import launch_counts
from fcsr_tpu_torch.parallel import virtual_batch_mesh
from fcsr_tpu_torch.pipelines import (_fit_cfg_to_data, run_gat_cv,
                                      run_gat_cv_fast)
from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig, init_gat,
                                           predict_gat,
                                           train_gat_folds_parallel)

TINY = dict(ks=(0.5, 0.5), n_nodes=20, m_nodes=32, dim=4, heads=2,
            drop_p=0.0)
SEED = 42


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


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(7)

    def stack(n):
        m = np.triu(rng.random((7, n, n)), k=1)
        return (m + m.transpose(0, 2, 1)).astype(np.float32)
    return stack(20), stack(32), j_kfold(7, 2, seed=SEED)


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    lr, hr, lt = synthesize_teacher_connectomes(6, lr_dim=20, hr_dim=32,
                                                seed=1, n_test=3)
    d = tmp_path_factory.mktemp("kaggle_gat")
    write_kaggle_csvs({"lr_train": lr, "hr_train": hr, "lr_test": lt},
                      str(d), nan_frac=0.01)
    return str(d)


def test_run_gat_cv_fast_matches_jax_pipeline(csv_dir):
    """The same CSVs through both pipelines with the fused step (the JAX
    side in Pallas interpret mode): fold MAEs and test predictions 1e-5,
    histories 1e-5. The configs keep their default 160 / 268 dims: both
    pipelines fit them to the data."""
    kw = dict(ks=(0.5, 0.5), dim=4, heads=2, drop_p=0.0, epochs=2,
              fused_step=True)
    j_res = j_run_gat_cv_fast(j_io.load_dataset(csv_dir, cache=False),
                              jgl.GATTrainConfig(**kw), splits=2, seed=SEED)
    flat0 = _jax_flat0(j_res["cfg"], SEED, 2)
    t_res = run_gat_cv_fast(load_dataset(csv_dir, cache=False, device="cpu"),
                            GATTrainConfig(**kw), splits=2, seed=SEED,
                            flat0=flat0, device="cpu")
    assert set(j_res) - {"model"} <= set(t_res)
    assert (t_res["cfg"].n_nodes, t_res["cfg"].m_nodes) == (20, 32)
    np.testing.assert_allclose(t_res["fold_maes"], j_res["fold_maes"],
                               atol=1e-5)
    assert abs(t_res["mean_mae"] - j_res["mean_mae"]) <= 1e-5
    for th, jh in zip(t_res["histories"], j_res["histories"]):
        for key in ("train", "val", "lr"):
            np.testing.assert_allclose(th[key], jh[key], atol=1e-5)
    preds = t_res["test_preds"]
    assert isinstance(preds, torch.Tensor) and tuple(preds.shape) == (3, 32,
                                                                      32)
    np.testing.assert_allclose(preds.numpy(), np.asarray(j_res["test_preds"]),
                               atol=1e-5)
    assert sorted(t_res["variables"]) == sorted(
        t_res["model"].state_dict())


def test_run_gat_cv_is_the_per_fold_trainer(csv_dir):
    data = load_dataset(csv_dir, cache=False, device="cpu")
    cfg = GATTrainConfig(ks=(0.5, 0.5), dim=4, heads=2, drop_p=0.0, epochs=2)
    res = run_gat_cv(data, splits=2, seed=SEED, cfg=cfg, device="cpu")
    fast = run_gat_cv_fast(data, cfg, splits=2, seed=SEED, host_control=True,
                           device="cpu")
    # one fold after the other from seed + j == all folds together
    np.testing.assert_allclose(res["fold_maes"], fast["fold_maes"],
                               atol=1e-6)
    for a, b in zip(res["histories"], fast["histories"]):
        np.testing.assert_allclose(a["val"], b["val"], atol=1e-6)
    assert len(res["variables_per_fold"]) == 2
    assert tuple(res["test_preds"].shape) == (3, 32, 32)


def test_fit_cfg_to_data_handles_both_families():
    lr, hr = np.zeros((1, 20, 20)), np.zeros((1, 32, 32))
    cfg = _fit_cfg_to_data(GATTrainConfig(), lr, hr)
    assert (cfg.n_nodes, cfg.m_nodes, cfg.dim) == (20, 32, 16)
    same = GATTrainConfig(n_nodes=20, m_nodes=32)
    assert _fit_cfg_to_data(same, lr, hr) is same


def _read_submission(path):
    with open(path) as f:
        assert f.readline().strip() == "ID,Predicted"
    table = np.loadtxt(path, delimiter=",", skiprows=1)
    np.testing.assert_array_equal(table[:, 0], np.arange(1, len(table) + 1))
    return table[:, 1].astype(np.float32)


@pytest.mark.parametrize("flags", [["--fast", "--fused"], ["--fast"], []],
                         ids=["fast-fused", "fast", "per-fold"])
def test_cli_train_gat_writes_colmajor_submission(csv_dir, tmp_path, capsys,
                                                  flags):
    out = tmp_path / "out"
    before = launch_counts()
    rc = cli.main(["train", "gat", *flags, "--epochs", "2", "--splits", "2",
                   "--dim", "4", "--data-dir", csv_dir, "--out-dir",
                   str(out), "--device", "cpu"])
    assert rc == 0
    assert launch_counts() == before         # the CPU launches no kernel
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[0])
    assert len(report["fold_maes"]) == 2
    assert np.isfinite(report["fold_maes"]).all()
    assert report["mean_mae"] == pytest.approx(np.mean(report["fold_maes"]))
    params = load_arrays(str(out / "gat_params.npz"))
    cfg = GATTrainConfig(n_nodes=20, m_nodes=32, dim=4)
    model = cfg.model(device="cpu")
    assert sorted(params) == sorted(model.state_dict())
    # the submission is the column-major vectorization of the last fold's
    # predictions of the test set
    data = load_dataset(csv_dir, cache=False, device="cpu")
    preds = predict_gat(params, model, cfg, data["lr_test"]).numpy()
    j, i = np.tril_indices(32, -1)
    got = _read_submission(str(out / "submission.csv"))
    assert got.shape == (3 * 32 * 31 // 2,)
    np.testing.assert_allclose(got, preds[:, i, j].reshape(-1), atol=1e-6)


def test_cli_defaults_to_the_card(csv_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "gat", "--fast", "--fused", "--epochs", "1",
                  "--data-dir", csv_dir, "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gat_folds_parallel(GATTrainConfig(**TINY), np.zeros((2, 20, 20)),
                                 np.zeros((2, 32, 32)), [([0], [1])])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_gat(GATTrainConfig(**TINY))


@pytest.mark.parametrize("argv,what", [
    (["train", "gat", "--multichip"], "--multichip"),
    (["train", "gsr", "--multichip"], "--multichip")])
def test_cli_refuses_what_is_not_ported(capsys, argv, what, csv_dir,
                                        tmp_path):
    """Nothing of ``train gat`` / ``train gsr`` is refused any more:
    ``--multichip`` runs (on the CPU, the one-device mesh) and writes its
    submission."""
    out = tmp_path / "out"
    extra = ["--dim", "4"] if argv[1] == "gat" else []
    assert cli.main(argv + extra + ["--epochs", "1", "--splits", "2",
                                    "--data-dir", csv_dir, "--out-dir",
                                    str(out), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert what not in err and "not available" not in err
    assert (out / "submission.csv").exists()


@pytest.mark.parametrize("flags", [["--fast", "--full-metrics"],
                                   ["--eval-backend", "networkx"],
                                   ["--full-metrics", "--eval-backend",
                                    "networkx"]])
def test_cli_train_gat_runs_the_metric_suite(csv_dir, tmp_path, flags):
    """``train gat`` with the flags the metric suite's port lifted: each
    fold scored into ``eval_metrics.json`` with ``--full-metrics``."""
    out = tmp_path / "out"
    assert cli.main(["train", "gat", *flags, "--epochs", "1", "--splits",
                     "2", "--dim", "4", "--data-dir", csv_dir, "--out-dir",
                     str(out), "--device", "cpu"]) == 0
    scored = "--full-metrics" in flags
    assert (out / "eval_metrics.json").exists() == scored
    if scored:
        metrics = json.loads((out / "eval_metrics.json").read_text())
        assert len(metrics) == 2
        assert all(len(m) == 8 and np.isfinite(list(m.values())).all()
                   for m in metrics)


def test_entry_points_refuse_what_is_not_ported(dataset):
    lr, hr, folds = dataset
    data = {"lr_train": lr, "hr_train": hr, "lr_test": None}
    cfg = GATTrainConfig(epochs=1, **TINY)
    mesh = virtual_batch_mesh(2, "cpu")
    with pytest.raises(ValueError, match="on-device control"):
        train_gat_folds_parallel(cfg, lr, hr, folds, mesh=mesh,
                                 host_control=True)
    # the mesh= and multichip= refusals are lifted: both run
    _, best, hists = train_gat_folds_parallel(cfg, lr, hr, folds, mesh=mesh)
    assert len(best) == len(hists) == len(folds)
    res = run_gat_cv_fast(data, cfg, multichip=True, device="cpu")
    assert np.isfinite(res["fold_maes"]).all()
    for run in (run_gat_cv_fast, run_gat_cv):
        with pytest.raises(ValueError, match="unknown eval_backend"):
            run(data, cfg=cfg, full_metrics=True, eval_backend="gpu",
                device="cpu")
    bad = GATTrainConfig(epochs=1, **{**TINY, "dim": 3})
    with pytest.raises(ValueError, match="not divisible"):
        train_gat_folds_parallel(bad, lr, hr, folds, device="cpu")
