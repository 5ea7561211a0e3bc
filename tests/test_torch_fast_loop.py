"""The port's fold-parallel trainer against the JAX package's fused_adam
GSRFoldRunner, and the port's import and device guards (CPU)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fcsr_tpu.data import load_or_synthesize as j_load
from fcsr_tpu.train import GSRTrainConfig as JConfig
from fcsr_tpu.train.fast_loop import GSRFoldRunner as JRunner
from fcsr_tpu.train.fast_loop import _pad_plans as j_pad_plans
from fcsr_tpu.train.fast_loop import stage_dataset as j_stage
from fcsr_tpu_torch.data import kfold_indices
from fcsr_tpu_torch.iox.weights import flax_to_state, state_to_flat
from fcsr_tpu_torch.models.fused_step import train_step_fused
from fcsr_tpu_torch.models.gsr import GSRNet
from fcsr_tpu_torch.train import GSRFoldRunner, GSRTrainConfig
from fcsr_tpu_torch.train.fast_loop import _pad_plans, stage_dataset

REPO = Path(__file__).resolve().parents[1]
TINY = dict(lr_dim=20, hr_dim=32, hidden_dim=32, ks=(0.9, 0.7))


def _tiny_data(n=6):
    d = j_load(None, n_train=n, n_test=1, seed=3)
    return (d["lr_train"][:, :20, :20].copy(),
            d["hr_train"][:, :32, :32].copy())


def test_trainer_matches_jax_fused_adam_runner():
    """2 folds, 3 epochs, initial weights carried from the JAX runner's
    flat0: loss history within 1e-4, val MAE within 1e-5 (bf16x3 vs fp32
    products over 9 Adam steps)."""
    lr, hr = _tiny_data()
    folds = kfold_indices(6, 2, seed=42)
    jr = JRunner(JConfig(epochs=3, fused_adam=True, **TINY), lr, hr, folds)
    _, j_loss, j_err = jr.train()
    j_mae, _ = jr.evaluate()
    flat0 = np.stack([state_to_flat(flax_to_state(jax.tree_util.tree_map(
        np.asarray, jr.unravel(jr.flat0[j])))) for j in range(2)])
    r = GSRFoldRunner(GSRTrainConfig(epochs=3, fused_adam=True, **TINY),
                      lr, hr, folds, flat0=flat0, device="cpu")
    _, loss, err = r.train()
    mae, preds = r.evaluate()
    assert loss.shape == (2, 3) and tuple(preds.shape) == (2, 3, 32, 32)
    np.testing.assert_allclose(loss, np.asarray(j_loss), atol=1e-4)
    np.testing.assert_allclose(err, np.asarray(j_err), atol=1e-4)
    np.testing.assert_allclose(mae, np.asarray(j_mae), atol=1e-5)
    j_un, _ = jr.evaluate(jr.flat0)
    un, _ = r.evaluate(r.flat0)
    np.testing.assert_allclose(un, np.asarray(j_un), atol=1e-5)


def test_chunked_training_equals_single_shot():
    lr, hr = _tiny_data(5)
    folds = kfold_indices(5, 2, seed=42)     # unequal folds: masked steps
    cfg = GSRTrainConfig(epochs=3, fused_adam=True, **TINY)
    a = GSRFoldRunner(cfg, lr, hr, folds, device="cpu")
    b = GSRFoldRunner(cfg, lr, hr, folds, device="cpu")
    pa, la, ea = a.train()
    pb, lb, eb = b.train(chunk_epochs=2)
    assert torch.equal(pa, pb)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ea, eb)
    assert a.tr_valid.sum() < a.tr_valid.size      # padding was exercised
    assert np.all(la[:, -1] < la[:, 0])            # it trains
    states = a.params_per_fold()
    assert len(states) == 2 and "layer.weights" in states[0]


def test_default_init_is_gsrnet_per_fold_seed():
    lr, hr = _tiny_data()
    folds = kfold_indices(6, 2, seed=42)
    r = GSRFoldRunner(GSRTrainConfig(epochs=1, fused_adam=True, **TINY), lr,
                      hr, folds, init_seed=5, device="cpu")
    for j in range(2):
        sd = GSRNet(TINY["ks"], 20, 32, 32, device="cpu",
                    seed=5 + j).state_dict()
        want = state_to_flat({k: v.numpy() for k, v in sd.items()})
        np.testing.assert_array_equal(r.flat0[j].numpy(), want)


def test_runner_refusals():
    lr, hr = _tiny_data()
    folds = kfold_indices(6, 2, seed=42)
    with pytest.raises(ValueError, match="padding"):
        GSRFoldRunner(GSRTrainConfig(fused_adam=True, padding=2, **TINY),
                      lr, hr, folds, device="cpu")
    # without a fused flag the runner is the unfused trainer, no refusal
    assert GSRFoldRunner(GSRTrainConfig(**TINY), lr, hr, folds,
                         device="cpu").mode == "unfused"
    # a decoder narrower than hr_dim trains in the unfused mode (the
    # fused_tail modes too), as in the JAX package
    narrow = GSRFoldRunner(GSRTrainConfig(lr_dim=20, hr_dim=32,
                                          hidden_dim=16, ks=TINY["ks"]),
                           lr, hr, folds, device="cpu")
    assert narrow.mode == "unfused" and narrow.layout.hidden_dim == 16
    assert dict(narrow.layout.specs)["gc1.weight"] == (32, 16)
    r = GSRFoldRunner(GSRTrainConfig(epochs=1, fused_adam=True, **TINY), lr,
                      hr, folds, device="cpu")
    with pytest.raises(RuntimeError, match="before train"):
        r.evaluate()
    with pytest.raises(ValueError, match="flat0"):
        GSRFoldRunner(GSRTrainConfig(epochs=1, fused_adam=True, **TINY), lr,
                      hr, folds, flat0=np.zeros((2, 7)), device="cpu")


def test_pad_plans_and_staging_match_jax():
    lr, hr = _tiny_data(7)
    folds = kfold_indices(7, 3, seed=42)
    for which in (0, 1):
        for a, b in zip(_pad_plans(folds, which), j_pad_plans(folds, which)):
            np.testing.assert_array_equal(a, b)
    cfg = GSRTrainConfig(fused_adam=True, **TINY)
    got = stage_dataset(cfg, lr, hr, torch.device("cpu"))
    want = j_stage(JConfig(**TINY), lr, hr)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_imports_no_jax_and_no_fcsr_tpu():
    code = (
        "import sys, torch\n"
        "import fcsr_tpu_torch, fcsr_tpu_torch.kernels.build\n"
        "import fcsr_tpu_torch.iox, fcsr_tpu_torch.train.fast_loop\n"
        "import fcsr_tpu_torch.cli, fcsr_tpu_torch.pipelines\n"
        "import fcsr_tpu_torch.native, fcsr_tpu_torch.data.device_pipeline\n"
        "import chip_smoke\n"
        "chip_smoke.kernel_cases(torch.device('cpu'))\n"
        "fcsr_tpu_torch.cli.build_parser()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'pandas', 'sklearn', 'fcsr_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    lr, hr = _tiny_data()
    folds = kfold_indices(6, 2, seed=42)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GSRNet(TINY["ks"], 20, 32, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GSRFoldRunner(GSRTrainConfig(fused_adam=True, **TINY), lr, hr, folds)
    z = torch.zeros(1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_step_fused(z, z, z, z, z, z, z, TINY["ks"], 20, 32, 16.0, 1e-4)
