"""The CSV-to-submission path as a whole, at the tiny 20 -> 32 size on the
CPU: the same CSVs and the same initial weights through the JAX package's
``run_gsr_cv_fast`` (``fused_adam``, Pallas interpret mode) and the
port's; checkpoint resume; the command line, what it refuses and the
metric suite's commands it runs (the other trainer modes' commands are in
``test_torch_gsr_trainers.py``)."""

import inspect
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from fcsr_tpu import pipelines as j_pipelines
from fcsr_tpu.data import io as j_io
from fcsr_tpu.iox import save_prediction as j_save_prediction
from fcsr_tpu.pipelines import run_gsr_cv_fast as j_run
from fcsr_tpu.train import GSRTrainConfig as JConfig
from fcsr_tpu_torch import cli, pipelines as t_pipelines
from fcsr_tpu_torch.data import (kfold_indices, load_dataset,
                                 synthesize_teacher_connectomes,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.iox import (load_arrays, load_params, load_state,
                                save_prediction)
from fcsr_tpu_torch.iox.weights import flax_to_state, state_to_flat
from fcsr_tpu_torch.models import GSRNet
from fcsr_tpu_torch.pipelines import _fit_cfg_to_data, run_gsr_cv_fast
from fcsr_tpu_torch.train import (GSRFoldRunner, GSRTrainConfig,
                                  evaluate_gsr, evaluate_gsr_folds,
                                  predict_gsr, train_gsr_folds_parallel)
from fcsr_tpu_torch.utils.reproducibility import set_seed

KS = (0.9, 0.7)
TINY = dict(lr_dim=20, hr_dim=32, hidden_dim=32, ks=KS)


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    lr, hr, lt = synthesize_teacher_connectomes(6, lr_dim=20, hr_dim=32,
                                                seed=1, n_test=3)
    d = tmp_path_factory.mktemp("kaggle")
    write_kaggle_csvs({"lr_train": lr, "hr_train": hr, "lr_test": lt},
                      str(d), nan_frac=0.01)
    return str(d)


@pytest.fixture(scope="module")
def both_runs(csv_dir):
    """(JAX result, port result) of 2 folds x 3 epochs on the same CSVs;
    the port starts from the JAX runner's initial weights, carried over
    by iox/weights.py."""
    data = j_io.load_dataset(csv_dir, cache=False)
    # the config keeps its default dims: both pipelines fit them to the data
    j_res = j_run(data, JConfig(epochs=3, fused_adam=True, ks=KS), splits=2)
    jr = j_res["runner"]
    flat0 = np.stack([state_to_flat(flax_to_state(jax.tree_util.tree_map(
        np.asarray, jr.unravel(jr.flat0[j])))) for j in range(2)])
    t_res = run_gsr_cv_fast(
        load_dataset(csv_dir, cache=False, device="cpu"),
        GSRTrainConfig(epochs=3, fused_adam=True, ks=KS), splits=2,
        flat0=flat0, device="cpu")
    return j_res, t_res


def test_pipeline_matches_jax_run_gsr_cv_fast(both_runs):
    """fold MAEs and test predictions within 1e-5 (bf16x3 vs fp32 products
    over 9 Adam steps), loss history within 1e-4."""
    j_res, t_res = both_runs
    assert set(j_res) <= set(t_res)                  # the same result keys
    assert t_res["cfg"].lr_dim == 20 and t_res["cfg"].hidden_dim == 32
    np.testing.assert_allclose(t_res["fold_maes"], j_res["fold_maes"],
                               atol=1e-5)
    assert abs(t_res["mean_mae"] - j_res["mean_mae"]) <= 1e-5
    np.testing.assert_allclose(t_res["loss_hist"],
                               np.asarray(j_res["loss_hist"]), atol=1e-4)
    preds = t_res["test_preds"]
    assert isinstance(preds, torch.Tensor) and tuple(preds.shape) == (3, 32,
                                                                      32)
    np.testing.assert_allclose(preds.numpy(), j_res["test_preds"], atol=1e-5)
    for key in ("n_train_steps", "n_eval_forwards"):
        assert t_res[key] == j_res[key]
    assert t_res["fold_metrics"] == [] and len(t_res["params_per_fold"]) == 2
    assert t_res["params"] is t_res["params_per_fold"][-1]


@pytest.mark.parametrize("ordering", ["colmajor", "rowmajor"])
def test_submission_files_match_jax(both_runs, tmp_path, ordering):
    j_res, t_res = both_runs
    j_path, t_path = tmp_path / "j.csv", tmp_path / "t.csv"
    j_save_prediction(j_res["test_preds"], str(j_path), ordering=ordering)
    save_prediction(t_res["test_preds"], str(t_path), ordering=ordering)
    j_lines = j_path.read_text().splitlines()
    t_lines = t_path.read_text().splitlines()
    assert t_lines[0] == j_lines[0] == "ID,Predicted"
    assert len(t_lines) == len(j_lines) == 1 + 3 * 32 * 31 // 2
    j_tab = np.array([ln.split(",") for ln in j_lines[1:]], dtype=np.float64)
    t_tab = np.array([ln.split(",") for ln in t_lines[1:]], dtype=np.float64)
    np.testing.assert_array_equal(t_tab[:, 0], j_tab[:, 0])
    assert [ln.split(",")[0] for ln in t_lines[1:4]] == ["1", "2", "3"]
    np.testing.assert_allclose(t_tab[:, 1], j_tab[:, 1], atol=1e-5, rtol=0)


def test_predict_and_evaluate_gsr_match_jax(both_runs, csv_dir):
    from fcsr_tpu.train import evaluate_gsr as j_evaluate
    j_res, t_res = both_runs
    data = load_dataset(csv_dir, cache=False, device="cpu")
    lr, hr = data["lr_train"].copy(), data["hr_train"].copy()
    lr[1] = 0.0                                  # an all-zero subject: skipped
    j_mae, j_preds, j_gts = j_evaluate(j_res["params"], j_res["model"],
                                       j_res["cfg"], lr, hr)
    mae, preds, gts = evaluate_gsr(t_res["params"], t_res["model"],
                                   t_res["cfg"], lr, hr)
    assert preds.shape == (5, 32, 32) and abs(mae - j_mae) <= 1e-5
    np.testing.assert_allclose(preds, j_preds, atol=1e-5)
    np.testing.assert_array_equal(gts, j_gts)
    again = predict_gsr(None, t_res["model"], t_res["cfg"], lr[[0, 2]])
    np.testing.assert_array_equal(again.numpy(), preds[:2])


def _tiny_runner(epochs=4, n=7, **kw):
    lr, hr = synthesize_teacher_connectomes(n, lr_dim=20, hr_dim=32, seed=2)
    cfg = GSRTrainConfig(epochs=epochs, fused_adam=True, **TINY)
    return GSRFoldRunner(cfg, lr, hr, kfold_indices(n, 2, seed=42),
                         device="cpu", **kw)


def test_checkpointed_run_equals_straight_run(tmp_path):
    p_ref, l_ref, e_ref = _tiny_runner().train()
    ck = str(tmp_path / "ck.npz")
    p, lh, eh = _tiny_runner().train(checkpoint_path=ck, checkpoint_every=3)
    assert torch.equal(p, p_ref)
    np.testing.assert_array_equal(lh, l_ref)
    np.testing.assert_array_equal(eh, e_ref)
    blob = load_arrays(ck)
    assert int(blob["epoch"]) == 4 and blob["loss_hist"].shape == (2, 4)
    assert os.listdir(tmp_path) == ["ck.npz"]
    # a finished run's checkpoint restores without training again
    r = _tiny_runner()
    r._run_chunk = None
    p_again, l_again, _ = r.train(checkpoint_path=ck)
    assert torch.equal(p_again, p_ref)
    np.testing.assert_array_equal(l_again, l_ref)


def test_resume_after_interrupt_is_bit_equal(tmp_path):
    p_ref, l_ref, e_ref = _tiny_runner().train()
    first = _tiny_runner()
    state, lh, eh = first._run_chunk(first.fresh_state(), 1)
    ck = str(tmp_path / "ck.npz")
    first.save_checkpoint(ck, state, 1, lh, eh)
    second = _tiny_runner()                     # a fresh process stand-in
    p, l_hist, e_hist = second.train(checkpoint_path=ck, checkpoint_every=2)
    assert torch.equal(p, p_ref)
    np.testing.assert_array_equal(l_hist, l_ref)
    np.testing.assert_array_equal(e_hist, e_ref)
    # the blob is self-describing: its last fold loads as a model state
    state = load_params(ck)
    want = second.params_per_fold()[-1]
    assert sorted(state) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(state[k], want[k])


@pytest.mark.parametrize("what", ["epochs", "folds", "data", "weights"])
def test_foreign_checkpoint_is_discarded_with_a_warning(tmp_path, what):
    ck = str(tmp_path / "ck.npz")
    other = {"epochs": dict(epochs=3), "folds": dict(n=8),
             "data": dict(), "weights": dict(init_seed=5)}[what]
    r = _tiny_runner(**other)
    if what == "data":
        lr, hr = synthesize_teacher_connectomes(7, lr_dim=20, hr_dim=32,
                                                seed=9)
        r = GSRFoldRunner(r.cfg, lr, hr, r.folds, device="cpu")
    r.train(checkpoint_path=ck)
    mine = _tiny_runner()
    assert mine.fingerprint != r.fingerprint
    assert mine.fingerprint == _tiny_runner().fingerprint
    p_ref, l_ref, _ = _tiny_runner().train()
    with pytest.warns(UserWarning, match="fingerprint mismatch"):
        p, lh, _ = mine.train(checkpoint_path=ck, checkpoint_every=2)
    assert torch.equal(p, p_ref)
    np.testing.assert_array_equal(lh, l_ref)
    assert str(load_arrays(ck)["fingerprint"]) == mine.fingerprint


def test_train_gsr_folds_parallel_and_evaluate_folds():
    lr, hr = synthesize_teacher_connectomes(7, lr_dim=20, hr_dim=32, seed=2)
    cfg = GSRTrainConfig(epochs=2, fused_adam=True, **TINY)
    folds = kfold_indices(7, 2, seed=42)
    model, states, lh, eh, runner = train_gsr_folds_parallel(
        cfg, lr, hr, folds, device="cpu")
    assert isinstance(model, GSRNet) and len(states) == 2
    assert lh.shape == eh.shape == (2, 2)
    maes, outs = evaluate_gsr_folds(cfg, runner)
    assert len(maes) == 2 and [p.shape[0] for p, _ in outs] == [4, 3]
    for j, (preds, gts) in enumerate(outs):
        assert (np.diagonal(gts, axis1=1, axis2=2) == 1).all()
        np.testing.assert_allclose(np.abs(preds - gts).mean(), maes[j],
                                   atol=1e-6)
        one = predict_gsr(states[j], model, cfg, lr[folds[j][1]])
        np.testing.assert_allclose(one.numpy(), preds, atol=1e-6)
    assert evaluate_gsr_folds(cfg, runner, pull_preds=False)[1] == []


def test_fit_cfg_and_pipeline_refusals(monkeypatch):
    cfg = GSRTrainConfig(fused_adam=True)
    lr, hr = np.zeros((2, 20, 20)), np.zeros((2, 32, 32))
    fit = _fit_cfg_to_data(cfg, lr, hr)
    assert (fit.lr_dim, fit.hr_dim, fit.hidden_dim) == (20, 32, 32)
    assert _fit_cfg_to_data(fit, lr, hr) is fit
    data = {"lr_train": lr, "hr_train": hr}
    # multichip=True is no longer refused: on the CPU its mesh is the CPU
    seen = {}

    def stop(*args, **kw):
        seen.update(kw)
        raise RuntimeError("stop before training")
    with monkeypatch.context() as m:
        m.setattr(t_pipelines, "train_gsr_folds_parallel", stop)
        with pytest.raises(RuntimeError, match="stop before training"):
            run_gsr_cv_fast(data, cfg, splits=2, multichip=True,
                            device="cpu")
    assert seen["mesh"].devices == (torch.device("cpu"),)
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ImportError, match="networkx"):
        run_gsr_cv_fast(data, cfg, full_metrics=True,
                        eval_backend="networkx", device="cpu")


PIPELINES = ("run_gsr_cv_fast", "run_gsr_cv", "run_gat_cv",
             "run_gat_cv_fast")


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_keeps_the_jax_parameter_order(name):
    """The JAX package's parameters, ``eval_backend`` included, lead the
    port's in the same order (the port adds ``flat0`` / ``device`` after
    them), so a positional call binds the same parameters in both."""
    j_params = inspect.signature(getattr(j_pipelines, name)).parameters
    t_params = inspect.signature(getattr(t_pipelines, name)).parameters
    assert list(t_params)[:len(j_params)] == list(j_params)
    assert t_params["eval_backend"].default == "device" \
        == j_params["eval_backend"].default


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_refuses_networkx_eval_backend_by_name(name, monkeypatch):
    """Where networkx is missing, ``eval_backend="networkx"`` with
    ``full_metrics`` is an ImportError naming it, by keyword and
    positionally at the JAX package's position; an unknown backend is a
    ValueError. Both are refused before any training."""
    run = getattr(t_pipelines, name)
    data = {"lr_train": np.zeros((2, 20, 20)),
            "hr_train": np.zeros((2, 32, 32))}
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ImportError, match="networkx"):
        run(data, full_metrics=True, eval_backend="networkx", device="cpu")
    j_params = list(inspect.signature(getattr(j_pipelines, name)).parameters
                    .values())
    upto = [p.name for p in j_params].index("eval_backend")
    args = [data] + [True if p.name == "full_metrics" else p.default
                     for p in j_params[1:upto]] + ["networkx"]
    kw = {} if "full_metrics" in [p.name for p in j_params[:upto]] \
        else {"full_metrics": True}
    with pytest.raises(ImportError, match="networkx"):
        run(*args, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown eval_backend"):
        run(data, eval_backend="gpu", device="cpu")


def test_set_seed_seeds_the_global_generators():
    import random
    g = set_seed(7)
    a = (random.random(), np.random.rand(), torch.rand(1).item(),
         torch.rand(1, generator=g).item())
    g = set_seed(7)
    b = (random.random(), np.random.rand(), torch.rand(1).item(),
         torch.rand(1, generator=g).item())
    assert a == b


def test_cli_train_then_predict(csv_dir, tmp_path, capsys):
    out_dir, ck = str(tmp_path / "out"), str(tmp_path / "ck.npz")
    rc = cli.main(["train", "gsr", "--fused", "--epochs", "2", "--splits",
                   "2", "--data-dir", csv_dir, "--out-dir", out_dir,
                   "--checkpoint", ck, "--device", "cpu"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert len(report["fold_maes"]) == 2 and "train" in report["timings"]
    assert sorted(os.listdir(out_dir)) == ["gsr_params.npz",
                                           "submission.csv"]
    state = load_state(os.path.join(out_dir, "gsr_params.npz"))
    for k, v in load_params(ck).items():
        np.testing.assert_array_equal(state[k], v)
    # predict from the checkpoint and from the params file: the same CSV
    # as the trainer's own row-major submission
    subs = []
    for params in (ck, os.path.join(out_dir, "gsr_params.npz")):
        sub = str(tmp_path / f"sub{len(subs)}.csv")
        assert cli.main(["predict", "--params", params, "--data-dir",
                         csv_dir, "--out", sub, "--ordering", "rowmajor",
                         "--device", "cpu"]) == 0
        subs.append(open(sub).read())
    assert subs[0] == subs[1] == open(os.path.join(out_dir,
                                                   "submission.csv")).read()
    assert subs[0].count("\n") == 1 + 3 * 32 * 31 // 2
    col = str(tmp_path / "col.csv")
    assert cli.main(["predict", "--params", ck, "--data-dir", csv_dir,
                     "--out", col, "--ordering", "colmajor", "--device",
                     "cpu"]) == 0
    assert open(col).read() != subs[0]
    assert "(3 subjects, colmajor)" in capsys.readouterr().out


def test_cli_submit_dry_run(tmp_path, capsys):
    assert cli.main(["submit", "--csv", str(tmp_path / "none.csv")]) == 2
    path = tmp_path / "s.csv"
    path.write_text("ID,Predicted\n1,0.5\n")
    assert cli.main(["submit", "--csv", str(path), "-m", "two words",
                     "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "kaggle competitions submit" in out and "'two words'" in out


@pytest.mark.parametrize("argv,missing", [
    (["train", "gsr", "--multichip"], "fcsr_tpu/parallel"),
    (["train", "gat", "--fused", "--multichip"], "fcsr_tpu/parallel"),
    (["train", "gsr", "--fused", "--multichip"], "fcsr_tpu/parallel"),
    (["train", "gsr", "--fast", "--fused-tail", "--multichip"],
     "fcsr_tpu/parallel"),
])
def test_cli_refuses_what_is_not_ported(argv, missing, capsys, csv_dir,
                                        monkeypatch):
    """--multichip is no longer refused: every form reaches the
    fold-parallel trainer with a mesh of the port's ``parallel`` (the
    module the JAX package's ``missing`` one is ported to); on the CPU the
    one-CPU mesh."""
    seen = {}

    def stop(*args, **kw):
        seen.update(kw)
        raise RuntimeError("stop before training")
    for name in ("train_gsr_folds_parallel", "train_gat_folds_parallel"):
        monkeypatch.setattr(t_pipelines, name, stop)
    with pytest.raises(RuntimeError, match="stop before training"):
        cli.main(argv + ["--data-dir", csv_dir, "--device", "cpu"])
    err = capsys.readouterr().err
    assert "not available" not in err
    mesh = seen["mesh"]
    assert type(mesh).__module__.startswith(
        missing.replace("fcsr_tpu", "fcsr_tpu_torch").replace("/", "."))
    assert mesh.devices == (torch.device("cpu"),)


@pytest.mark.parametrize("argv,scored", [
    (["evaluate"], False),
    (["train", "gsr", "--full-metrics"], True),
    (["train", "gsr", "--fast", "--eval-backend", "networkx"], False),
    (["train", "gsr", "--fused", "--full-metrics"], True),
    (["train", "gsr", "--fused", "--eval-backend", "networkx"], False),
])
def test_cli_runs_the_metric_suite(argv, scored, csv_dir, tmp_path, capsys):
    """The commands the metric suite's port lifted: ``evaluate`` writes
    ``results_fold_0.txt``; ``--full-metrics`` writes ``eval_metrics.json``
    (one dict a fold); ``--eval-backend networkx`` alone changes nothing
    and says so."""
    out = tmp_path / "out"
    if argv[0] == "evaluate":
        rng = np.random.default_rng(0)
        gt = np.triu(rng.random((2, 12, 12)), 1)
        np.savez(tmp_path / "gt.npz", gt=gt + gt.transpose(0, 2, 1))
        np.savez(tmp_path / "pred.npz", pred=0.9 * (gt + gt.transpose(0, 2,
                                                                      1)))
        argv = argv + ["--gt", str(tmp_path / "gt.npz"), "--pred",
                       str(tmp_path / "pred.npz")]
    else:
        argv = argv + ["--epochs", "1", "--splits", "2", "--data-dir",
                       csv_dir]
    assert cli.main(argv + ["--out-dir", str(out), "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    if argv[0] == "evaluate":
        lines = (out / "results_fold_0.txt").read_text().splitlines()
        assert [ln.split(": ")[0] for ln in lines[:3]] == [
            "MAE", "PCC", "Jensen-Shannon Distance"] and len(lines) == 8
        return
    assert (out / "eval_metrics.json").exists() == scored
    if scored:
        metrics = json.loads((out / "eval_metrics.json").read_text())
        assert len(metrics) == 2 and len(metrics[0]) == 8
    else:
        assert "--eval-backend changes nothing" in captured.err


def test_cli_parser_keeps_the_jax_flags():
    """Every option of the JAX package's parser exists in the port's, which
    adds only --device."""
    from fcsr_tpu.cli import build_parser as j_build

    def options(parser, prefix=""):
        out = set()
        for action in parser._actions:
            if action.choices and isinstance(action.choices, dict):
                for name, sub in action.choices.items():
                    out |= options(sub, f"{prefix}{name} ")
            else:
                out |= {prefix + o for o in action.option_strings}
        return out

    j_opts, t_opts = options(j_build()), options(cli.build_parser())
    assert j_opts <= t_opts
    assert {o.split()[-1] for o in t_opts - j_opts} == {"--device"}


def test_cli_and_entry_points_default_to_the_card(csv_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "gsr", "--fused", "--epochs", "1", "--data-dir",
                  csv_dir])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_dataset(csv_dir, cache=False)
