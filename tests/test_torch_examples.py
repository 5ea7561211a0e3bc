"""The port's example drivers (``python -m fcsr_tpu_torch.examples.*``):
each parses and shows its options, as tests/test_examples.py holds the
JAX package's, and all four run end to end on the CPU at a tiny size,
writing the JAX scripts' artifacts. Their full-width runs on the card are
``chip_smoke.py`` phase 10."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ["train_gsr", "train_template", "unet_transformer",
            "three_fold_vis"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_help(name):
    proc = subprocess.run(
        [sys.executable, "-m", f"fcsr_tpu_torch.examples.{name}", "--help"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage" in proc.stdout.lower()
    assert ("--device" in proc.stdout) == (name != "three_fold_vis")


def test_examples_run_tiny_on_cpu(tmp_path):
    """train_gsr --fast, train_template and unet_transformer on tiny CSVs,
    then three_fold_vis over their runs: every artifact the JAX scripts
    write, and weights files the JAX package's layout reads back."""
    import jax

    from fcsr_tpu.iox import load_pytree as j_load_pytree
    from fcsr_tpu.train import GSRTrainConfig as JCfg
    from fcsr_tpu.train import init_gsr as j_init_gsr
    from fcsr_tpu_torch.data import (synthesize_teacher_connectomes,
                                     write_kaggle_csvs)
    from fcsr_tpu_torch.examples import (three_fold_vis, train_gsr,
                                         train_template, unet_transformer)
    from fcsr_tpu_torch.iox import flax_to_state, load_pytree
    from fcsr_tpu_torch.iox.weights import mlp_flax_to_state

    data = str(tmp_path / "data")
    lr, hr, lr_test = synthesize_teacher_connectomes(9, lr_dim=20, hr_dim=32,
                                                     seed=1, n_test=3)
    write_kaggle_csvs({"lr_train": lr, "hr_train": hr, "lr_test": lr_test},
                      data)
    out = {k: str(tmp_path / k) for k in ("gsr", "mlp", "unet", "vis")}
    common = ["--data-dir", data, "--device", "cpu", "--epochs", "2"]

    gsr = train_gsr.main(["--fast", "--splits", "2", "--out-dir",
                          out["gsr"], *common])
    assert sorted(os.listdir(out["gsr"])) == [
        "gsr_net_trained.msgpack", "loss.png", "submission.csv"]
    path = os.path.join(out["gsr"], "gsr_net_trained.msgpack")
    _, template, _, _ = j_init_gsr(JCfg(lr_dim=20, hr_dim=32, hidden_dim=32),
                                   jax.random.PRNGKey(0))
    back = flax_to_state(jax.tree_util.tree_map(
        np.asarray, j_load_pytree(template, path)))
    for k, v in gsr["params"].items():
        np.testing.assert_array_equal(back[k], v)
    rows = Path(out["gsr"], "submission.csv").read_text().splitlines()
    assert rows[0] == "ID,Predicted" and len(rows) == 1 + 3 * 32 * 31 // 2

    mlp = train_template.main(["--k-folds", "3", "--out-dir", out["mlp"],
                               *common])
    assert sorted(os.listdir(out["mlp"])) == [
        "eval_metrics.json", "loss.png", "model.msgpack", "submission.csv"]
    saved = mlp_flax_to_state(load_pytree(os.path.join(out["mlp"],
                                                       "model.msgpack")))
    assert sorted(saved) == sorted(mlp["variables"])
    for k, v in mlp["variables"].items():
        np.testing.assert_array_equal(saved[k], v.numpy())

    unet_transformer.main(["--splits", "2", "--dim", "4", "--out-dir",
                           out["unet"], *common])
    assert sorted(os.listdir(out["unet"])) == [
        "eval_metrics.json", "loss.png", "submission.csv"]
    with open(os.path.join(out["unet"], "eval_metrics.json")) as f:
        assert len(json.load(f)) == 2

    assert three_fold_vis.main(["--runs", out["mlp"], out["gsr"],
                                out["unet"], "--out-dir", out["vis"]]) == 0
    assert len(list(Path(out["vis"]).glob("compare_*.png"))) == 8
