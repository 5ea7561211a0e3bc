"""The MLP family's data plans, pipeline and command line: the port's
``data/datamodule.py``, ``pipelines.run_mlp_cv`` and ``train mlp`` against
the JAX package on the CPU, at the tiny 20 -> 32 configuration.

Tolerances: the data plans are bit-equal (numpy, the same generators).
``run_mlp_cv`` runs both packages at dropout 0 (each package's model
classes wrapped to it; neither pipeline takes a dropout), the port from the
JAX package's own per-fold inits (``flat0``): epochs run and learning-rate
schedules exactly; v2's fold MAEs rtol 2e-3 and test predictions 5e-3, as
the JAX test of ``SpectralResMLP``'s best states (its zero-gradient
directions walk on float noise and reach the eval-mode running
statistics); v1's fold MAEs rtol 2e-2 and test predictions 2e-2 of their
scale (its pre-BatchNorm bias walks by up to lr a step). The command
line's submission parses back, through the JAX package's CSV reader, to
the JAX package's column-major vectorization of the predictions, exactly.
"""

import functools
import inspect
import json
import sys

import jax
import numpy as np
import pytest
import torch

import fcsr_tpu.models.mlp as jmlp
from fcsr_tpu import pipelines as j_pipelines
from fcsr_tpu.core.vectorize import vectorize_batch as j_vectorize_batch
from fcsr_tpu.data import datamodule as jdm
from fcsr_tpu.data import io as j_io
from fcsr_tpu_torch import cli
from fcsr_tpu_torch import pipelines as t_pipelines
from fcsr_tpu_torch.data import datamodule as tdm
from fcsr_tpu_torch.data import (synthesize_teacher_connectomes,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.iox.weights import mlp_flax_to_state, mlp_state_to_flat
from fcsr_tpu_torch.kernels import launch_counts
from fcsr_tpu_torch.models import mlp as tmlp

N_IN, N_OUT = 20, 32


@pytest.mark.parametrize("fn,args", [
    ("kfold_indices", (11, 3, 7)),
    ("contiguous_window_folds", (167, 3, 0.33, 42)),
    ("contiguous_window_folds", (40, 4, 0.2, 3)),
    ("train_val_split", (167, 0.33, 42)),
    ("train_val_split", (10, 0.2, 0)),
    ("epoch_permutations", (9, 4, 5, True)),
    ("epoch_permutations", (9, 4, 5, False)),
])
def test_data_plans_are_the_jax_packages(fn, args):
    got, want = getattr(tdm, fn)(*args), getattr(jdm, fn)(*args)
    flat = lambda x: [np.asarray(a) for a in (
        x if isinstance(x, np.ndarray) else
        [b for pair in x for b in (pair if isinstance(pair, tuple)
                                   else (pair,))])]
    assert len(flat(got)) == len(flat(want))
    for a, b in zip(flat(got), flat(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scheme", ["kfold", "window", "holdout"])
def test_connectome_datamodule_is_the_jax_packages(scheme):
    rng = np.random.default_rng(0)
    data = {"lr_train": rng.random((12, 4, 4)),
            "hr_train": rng.random((12, 5, 5)), "lr_test": None}
    got = tdm.ConnectomeDataModule.from_arrays(data, scheme, k=3, p_val=0.25,
                                               seed=1)
    want = jdm.ConnectomeDataModule.from_arrays(data, scheme, k=3,
                                                p_val=0.25, seed=1)
    assert got.n_folds == want.n_folds
    for g, w in zip(got.iter_folds(), want.iter_folds()):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown split scheme"):
        tdm.ConnectomeDataModule.from_arrays(data, "loo")


@pytest.fixture(scope="module")
def dataset():
    lr, hr, lt = synthesize_teacher_connectomes(30, lr_dim=N_IN,
                                                hr_dim=N_OUT, seed=3,
                                                n_test=5)
    return {"lr_train": lr, "hr_train": hr, "lr_test": lt}


@pytest.fixture
def no_dropout(monkeypatch):
    """Both packages' pipelines build their models at dropout 0."""
    for mod, names in ((jmlp, ("SpectralResMLP", "SuperResMLP")),
                       (t_pipelines, ("SpectralResMLP", "SuperResMLP"))):
        for name in names:
            monkeypatch.setattr(mod, name, functools.partial(
                getattr(mod, name), dropout=0.0))


def _jax_flat0(variant, hidden, seeds):
    """The JAX pipeline's per-fold inits, in the port's flat layout."""
    if variant == "v2":
        m = jmlp.SpectralResMLP(num_nodes_input=N_IN, num_nodes_output=N_OUT,
                                num_hidden=hidden, n_layers=0)
    else:
        m = jmlp.SuperResMLP(input_size=N_IN * N_IN,
                             output_size=N_OUT * N_OUT, hidden_dim=hidden,
                             n_layers=1)
    flats = [mlp_state_to_flat(mlp_flax_to_state(jax.tree_util.tree_map(
        np.asarray, m.init({"params": jax.random.PRNGKey(s),
                            "dropout": jax.random.PRNGKey(100 + s)},
                           np.zeros((2, N_IN, N_IN), np.float32)))))
        for s in seeds]
    return tuple(np.stack(x) for x in zip(*flats))


@pytest.mark.parametrize("variant,hidden", [("v2", 26), ("v1", 40)])
def test_run_mlp_cv_matches_jax(dataset, no_dropout, variant, hidden):
    kw = dict(num_epochs=6, batch_size=8, variant=variant, hidden=hidden)
    want = j_pipelines.run_mlp_cv(dataset, **kw)
    got = t_pipelines.run_mlp_cv(dataset, **kw, device="cpu",
                                 flat0=_jax_flat0(variant, hidden,
                                                  [42, 43, 44]))
    for (th, vh, lh), (jth, jvh, jlh) in zip(got["histories"],
                                             want["histories"]):
        assert len(th) == len(jth) and len(vh) == len(jvh)
        assert lh == [float(a) for a in jlh]
    if variant == "v2":
        np.testing.assert_allclose(got["fold_maes"], want["fold_maes"],
                                   rtol=2e-3)
        np.testing.assert_allclose(got["test_preds"].numpy(),
                                   want["test_preds"], atol=5e-3)
    else:
        np.testing.assert_allclose(got["fold_maes"], want["fold_maes"],
                                   rtol=2e-2)
        np.testing.assert_allclose(
            got["test_preds"].numpy(), want["test_preds"], rtol=0,
            atol=2e-2 * np.abs(want["test_preds"]).max())
    assert got["mean_mae"] == pytest.approx(np.mean(got["fold_maes"]))
    assert got["fold_metrics"] == []
    # the fold MAE is the off-diagonal MAE of the matrix predictions
    tr, va = tdm.contiguous_window_folds(30, 3, 0.33, 42)[-1]
    x = dataset["lr_train"][va]
    if variant == "v2":
        x = x[:, *np.triu_indices(N_IN, 1)]
    pred = got["model"].predict(got["variables"], torch.from_numpy(x))
    off = ~np.eye(N_OUT, dtype=bool)
    mae = np.abs(pred.numpy()[:, off] - dataset["hr_train"][va][:, off]).mean()
    np.testing.assert_allclose(got["fold_maes"][-1], mae, rtol=1e-5)


def test_run_mlp_cv_sequential_path_equals_fold_parallel(dataset,
                                                        no_dropout):
    """``fold_parallel=False`` (the path of unequal folds and ``verbose``)
    trains the folds one after the other: at dropout 0 the same results,
    bit for bit on the CPU."""
    kw = dict(num_epochs=3, batch_size=8, hidden=26, device="cpu")
    a = t_pipelines.run_mlp_cv(dataset, **kw)
    b = t_pipelines.run_mlp_cv(dataset, fold_parallel=False, **kw)
    assert a["fold_maes"] == b["fold_maes"]
    assert a["histories"] == b["histories"]
    assert torch.equal(a["test_preds"], b["test_preds"])


def test_run_mlp_cv_is_seeded(dataset):
    """At the shipped dropout 0.1 a run is reproducible from its seed (the
    masks come from seeded generators) and differs from another seed's."""
    kw = dict(num_epochs=2, batch_size=8, hidden=26, device="cpu")
    a, b = (t_pipelines.run_mlp_cv(dataset, **kw) for _ in range(2))
    c = t_pipelines.run_mlp_cv(dataset, seed=7, **kw)
    assert a["fold_maes"] == b["fold_maes"]
    assert torch.equal(a["test_preds"], b["test_preds"])
    assert a["fold_maes"] != c["fold_maes"]


def test_run_mlp_cv_full_metrics(dataset):
    got = t_pipelines.run_mlp_cv(dataset, num_epochs=1, batch_size=8,
                                 hidden=26, full_metrics=True, device="cpu")
    assert len(got["fold_metrics"]) == 3
    for m in got["fold_metrics"]:
        assert len(m) == 8 and np.isfinite(list(m.values())).all()


def test_run_mlp_cv_keeps_the_jax_parameter_order(dataset, monkeypatch):
    """The JAX package's parameters lead the port's in the same order (the
    port adds ``flat0`` and ``device``); an unknown variant or eval backend
    is refused, and "networkx" without networkx names it, before any
    training."""
    j = list(inspect.signature(j_pipelines.run_mlp_cv).parameters)
    t = list(inspect.signature(t_pipelines.run_mlp_cv).parameters)
    assert t[:len(j)] == j and t[len(j):] == ["flat0", "device"]
    with pytest.raises(ValueError, match="unknown MLP variant"):
        t_pipelines.run_mlp_cv(dataset, variant="v3", device="cpu")
    with pytest.raises(ValueError, match="unknown eval_backend"):
        t_pipelines.run_mlp_cv(dataset, eval_backend="gpu", device="cpu")
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ImportError, match="networkx"):
        t_pipelines.run_mlp_cv(dataset, full_metrics=True,
                               eval_backend="networkx", device="cpu")


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    lr, hr, lt = synthesize_teacher_connectomes(9, lr_dim=N_IN, hr_dim=N_OUT,
                                                seed=1, n_test=3)
    d = tmp_path_factory.mktemp("kaggle_mlp")
    write_kaggle_csvs({"lr_train": lr, "hr_train": hr, "lr_test": lt},
                      str(d), nan_frac=0.01)
    return str(d)


@pytest.mark.parametrize("flags", [[], ["--full-metrics"],
                                   ["--variant", "v1"]],
                         ids=["v2", "v2-full-metrics", "v1"])
def test_cli_train_mlp_writes_colmajor_submission(csv_dir, tmp_path, capsys,
                                                  monkeypatch, flags):
    """``train mlp`` on Kaggle CSVs writes the column-major submission of
    the last fold's test predictions, and eval_metrics.json with
    --full-metrics; no weights file, as the JAX package's command. The
    command has no --hidden (neither has the JAX package's): v1's run here
    reaches the pipeline with hidden 40 instead of 10 000."""
    seen = {}

    def run(*args, **kw):
        if kw.get("variant") == "v1":
            kw["hidden"] = 40
        seen.update(t_pipelines_run(*args, **kw))
        return seen

    t_pipelines_run = t_pipelines.run_mlp_cv
    monkeypatch.setattr(t_pipelines, "run_mlp_cv", run)
    out = tmp_path / "out"
    before = launch_counts()
    assert cli.main(["train", "mlp", *flags, "--epochs", "2", "--batch-size",
                     "4", "--data-dir", csv_dir, "--out-dir", str(out),
                     "--device", "cpu"]) == 0
    assert launch_counts() == before         # the CPU launches no kernel
    report = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert len(report["fold_maes"]) == 3 and np.isfinite(
        report["fold_maes"]).all()
    scored = "--full-metrics" in flags
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["submission.csv"] + (["eval_metrics.json"] if scored else []))
    got = j_io.load_csv_vectors(str(out / "submission.csv")).reshape(-1)
    want = np.asarray(j_vectorize_batch(seen["test_preds"].numpy()))
    assert got.shape == (3 * N_OUT * (N_OUT - 1) // 2,)
    np.testing.assert_array_equal(got, want.reshape(-1))
    if scored:
        metrics = json.loads((out / "eval_metrics.json").read_text())
        assert len(metrics) == 3
        assert all(len(m) == 8 and np.isfinite(list(m.values())).all()
                   for m in metrics)


@pytest.mark.parametrize("argv", [["train", "gsr", "--multichip"],
                                  ["train", "gat", "--fast", "--multichip"]])
def test_cli_still_refuses_multichip(argv, capsys):
    """``train gsr`` / ``train gat`` take ``--multichip`` (fold sharding,
    implying --fast); ``train mlp`` still refuses it."""
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    assert args.multichip is True
    # `train mlp` has no --multichip, in either package's parser
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "mlp", "--multichip", "--device", "cpu"])
    assert e.value.code == 2
    assert "unrecognized arguments: --multichip" in capsys.readouterr().err


def test_mlp_entry_points_default_to_the_card(csv_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "mlp", "--epochs", "1", "--data-dir", csv_dir,
                  "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmlp.SpectralResMLP(N_IN, N_OUT, 26)
    data = {"lr_train": np.zeros((6, N_IN, N_IN)),
            "hr_train": np.zeros((6, N_OUT, N_OUT))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pipelines.run_mlp_cv(data, num_epochs=1)
