"""End-to-end pipeline: k-fold CV training -> validation -> test-set
predictions, from a dataset dict to a result dict.

Counterpart of ``fcsr_tpu/pipelines.py`` for GSR-Net: ``run_gsr_cv`` (the
reference-faithful parity trainer, one model carried across the folds) and
``run_gsr_cv_fast`` (a fresh model per fold, all folds trained together, in
the mode the configuration's ``fused_*`` flags pick). The per-fold
topology metrics (``evalx``), the other model families and multi-device
fold sharding are not ported yet and are refused by name.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from fcsr_tpu_torch.data.datamodule import kfold_indices
from fcsr_tpu_torch.train.fast_loop import (evaluate_gsr_folds,
                                            train_gsr_folds_parallel)
from fcsr_tpu_torch.train.gsr_loop import (GSRTrainConfig, evaluate_gsr,
                                           init_gsr, precompute_spectral,
                                           predict_gsr, train_gsr_fold)
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["run_gsr_cv", "run_gsr_cv_fast"]

_NO_EVALX = ("full_metrics=True needs the port of fcsr_tpu/evalx (the "
             "topology metric suite), which is not ported yet")


def _fit_cfg_to_data(cfg: GSRTrainConfig, lr_all, hr_all) -> GSRTrainConfig:
    """Re-derive the config's node dims from the loaded dataset when they
    differ (reduced-size CSV sets carry other resolutions than 160 / 268);
    keeps the reference's hidden_dim == hr_dim coupling."""
    lr_dim = int(lr_all.shape[-1])
    hr_dim = int(hr_all.shape[-1])
    if (cfg.lr_dim, cfg.hr_dim) == (lr_dim, hr_dim):
        return cfg
    return dataclasses.replace(cfg, lr_dim=lr_dim, hr_dim=hr_dim,
                               hidden_dim=hr_dim)


def run_gsr_cv_fast(data: Dict[str, np.ndarray],
                    cfg: Optional[GSRTrainConfig] = None,
                    splits: int = 3, seed: int = 42, init_seed: int = 0,
                    full_metrics: bool = False,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_every: Optional[int] = None,
                    multichip: bool = False, flat0=None,
                    device=DEFAULT_DEVICE):
    """Clean CV (a fresh model per fold) with all folds trained together
    as one fold-batched step per sample, then each fold's validation MAE
    and the last fold's predictions of the test set.

    Returns the JAX package's result dict: ``fold_maes``, ``mean_mae``,
    ``fold_metrics`` (empty), ``params`` / ``params_per_fold`` (state_dict
    mappings of numpy arrays), ``runner``, ``model``, ``cfg``,
    ``test_preds`` (a tensor on ``device``, or None without ``lr_test``),
    ``loss_hist``, ``timings`` and the step / forward counts. ``flat0``
    optionally gives the folds' initial weights (``GSRFoldRunner``)."""
    if multichip:
        raise NotImplementedError(
            "multichip=True needs the port of fcsr_tpu/parallel (fold "
            "sharding over torch.distributed), which is not ported yet")
    if full_metrics:
        raise NotImplementedError(_NO_EVALX)

    cfg = cfg or GSRTrainConfig(fused_adam=True)
    lr_all = np.asarray(data["lr_train"], dtype=np.float32)
    hr_all = np.asarray(data["hr_train"], dtype=np.float32)
    cfg = _fit_cfg_to_data(cfg, lr_all, hr_all)
    folds = kfold_indices(len(lr_all), splits, seed=seed)

    t0 = time.perf_counter()
    model, params_per_fold, loss_hist, err_hist, runner = \
        train_gsr_folds_parallel(cfg, lr_all, hr_all, folds,
                                 init_seed=init_seed,
                                 checkpoint_path=checkpoint_path,
                                 checkpoint_every=checkpoint_every,
                                 flat0=flat0, device=device)
    t_train = time.perf_counter() - t0

    t0 = time.perf_counter()
    fold_maes, _ = evaluate_gsr_folds(cfg, runner, pull_preds=False)
    t_eval = time.perf_counter() - t0

    test_preds = None
    if data.get("lr_test") is not None:
        test_preds = predict_gsr(params_per_fold[-1], model, cfg,
                                 data["lr_test"])

    return {
        "fold_maes": fold_maes,
        "mean_mae": float(np.mean(fold_maes)),
        "fold_metrics": [],
        "params": params_per_fold[-1],
        "params_per_fold": params_per_fold,
        "runner": runner,
        "model": model,
        "cfg": cfg,
        "test_preds": test_preds,
        "loss_hist": loss_hist,
        "timings": {"train": t_train, "eval": t_eval},
        "n_train_steps": sum(len(tr) for tr, _ in folds) * cfg.epochs,
        "n_eval_forwards": sum(len(va) for _, va in folds),
    }


def run_gsr_cv(data: Dict[str, np.ndarray],
               cfg: Optional[GSRTrainConfig] = None,
               splits: int = 5, seed: int = 42, init_seed: int = 0,
               reset_per_fold: bool = False, full_metrics: bool = False,
               verbose: bool = False, device=DEFAULT_DEVICE):
    """K-fold cross-validated GSR-Net training with the parity trainer
    (per-sample sequential Adam, ``train/gsr_loop.py``).

    Faithful quirk: the reference builds the model and the optimizer once
    and keeps training the same weights, with the same Adam state, across
    the folds (so later folds see data that was validation before) —
    ``reset_per_fold=False`` replicates that; ``True`` starts fold j from a
    fresh ``GSRNet(seed=init_seed + j)`` and a fresh optimizer.

    Returns the JAX package's result dict: ``fold_maes``, ``mean_mae``,
    ``fold_metrics`` (empty), ``params`` (the last model's state_dict as
    numpy arrays), ``model``, ``cfg``, ``test_preds`` (a tensor on
    ``device``, or None without ``lr_test``), ``timings`` and the step /
    forward counts."""
    if full_metrics:
        raise NotImplementedError(_NO_EVALX)

    cfg = cfg or GSRTrainConfig()
    lr_all = np.asarray(data["lr_train"], dtype=np.float32)
    hr_all = np.asarray(data["hr_train"], dtype=np.float32)
    cfg = _fit_cfg_to_data(cfg, lr_all, hr_all)
    folds = kfold_indices(len(lr_all), splits, seed=seed)
    model, optimizer = init_gsr(cfg, init_seed, device)

    # every spectral precompute in one batched shot (the folds take slices)
    t0 = time.perf_counter()
    u_lr_all, u_hr_all = precompute_spectral(lr_all, hr_all,
                                             lr_dim=cfg.lr_dim,
                                             padding=cfg.padding)
    t_spectral = time.perf_counter() - t0

    fold_maes = []
    t_train = t_eval = 0.0
    for j, (tr, va) in enumerate(folds):
        if reset_per_fold:
            model, optimizer = init_gsr(cfg, init_seed + j, device)
        t0 = time.perf_counter()
        train_gsr_fold(model, optimizer, cfg, lr_all[tr], hr_all[tr],
                       spectral=(u_lr_all[tr], u_hr_all[tr]),
                       verbose=verbose)
        t_train += time.perf_counter() - t0
        t0 = time.perf_counter()
        mae, _, _ = evaluate_gsr(None, model, cfg, lr_all[va], hr_all[va],
                                 verbose=verbose)
        fold_maes.append(mae)
        t_eval += time.perf_counter() - t0

    test_preds = None
    if data.get("lr_test") is not None:
        test_preds = predict_gsr(None, model, cfg, data["lr_test"])

    return {
        "fold_maes": fold_maes,
        "mean_mae": float(np.mean(fold_maes)),
        "fold_metrics": [],
        "params": {k: t.detach().cpu().numpy()
                   for k, t in model.state_dict().items()},
        "model": model,
        "cfg": cfg,
        "test_preds": test_preds,
        "timings": {"spectral": t_spectral, "train": t_train,
                    "eval": t_eval},
        "n_train_steps": sum(len(tr) for tr, _ in folds) * cfg.epochs,
        "n_eval_forwards": sum(len(va) for _, va in folds),
    }
