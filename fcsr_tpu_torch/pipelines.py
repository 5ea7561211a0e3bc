"""End-to-end pipelines: k-fold CV training -> validation -> test-set
predictions, from a dataset dict to a result dict.

Counterpart of ``fcsr_tpu/pipelines.py``. GSR-Net: ``run_gsr_cv`` (the
reference-faithful parity trainer, one model carried across the folds) and
``run_gsr_cv_fast`` (a fresh model per fold, all folds trained together, in
the mode the configuration's ``fused_*`` flags pick). GAT U-Net:
``run_gat_cv`` (a fresh model per fold, one fold after the other) and
``run_gat_cv_fast`` (all folds together; ``cfg.fused_step`` puts the step
on the CUDA kernels). The per-fold topology metrics (``evalx``), the MLP
family and multi-device fold sharding are not ported yet and are refused
by name.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from fcsr_tpu_torch.data.datamodule import kfold_indices
from fcsr_tpu_torch.train.fast_loop import (evaluate_gsr_folds,
                                            train_gsr_folds_parallel)
from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig, init_gat,
                                           precompute_gat_features,
                                           predict_gat,
                                           predict_gat_folds_mae, train_gat,
                                           train_gat_folds_parallel)
from fcsr_tpu_torch.train.gsr_loop import (GSRTrainConfig, evaluate_gsr,
                                           init_gsr, precompute_spectral,
                                           predict_gsr, train_gsr_fold)
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["run_gsr_cv", "run_gsr_cv_fast", "run_gat_cv", "run_gat_cv_fast"]

_NO_EVALX = ("full_metrics=True needs the port of fcsr_tpu/evalx (the "
             "topology metric suite), which is not ported yet")
_NO_NETWORKX = ("eval_backend='networkx' needs the port of fcsr_tpu/evalx "
                "(the topology metric suite), which is not ported yet")
_NO_PARALLEL = ("multichip=True needs the port of fcsr_tpu/parallel (fold "
                "sharding over torch.distributed), which is not ported yet")


def _check_eval_backend(eval_backend: str):
    """The JAX package's ``eval_backend``: "device" runs here; "networkx"
    waits for the port of evalx."""
    if eval_backend == "networkx":
        raise NotImplementedError(_NO_NETWORKX)
    if eval_backend != "device":
        raise ValueError(f"unknown eval_backend: {eval_backend!r} "
                         "(expected 'device' or 'networkx')")


def _fit_cfg_to_data(cfg, lr_all, hr_all):
    """Re-derive the config's node dims from the loaded dataset when they
    differ (reduced-size CSV sets carry other resolutions than 160 / 268).
    A GSR config keeps the reference's hidden_dim == hr_dim coupling; a GAT
    config carries ``n_nodes`` / ``m_nodes``."""
    lr_dim = int(lr_all.shape[-1])
    hr_dim = int(hr_all.shape[-1])
    if hasattr(cfg, "n_nodes"):
        if (cfg.n_nodes, cfg.m_nodes) == (lr_dim, hr_dim):
            return cfg
        return dataclasses.replace(cfg, n_nodes=lr_dim, m_nodes=hr_dim)
    if (cfg.lr_dim, cfg.hr_dim) == (lr_dim, hr_dim):
        return cfg
    return dataclasses.replace(cfg, lr_dim=lr_dim, hr_dim=hr_dim,
                               hidden_dim=hr_dim)


def run_gsr_cv_fast(data: Dict[str, np.ndarray],
                    cfg: Optional[GSRTrainConfig] = None,
                    splits: int = 3, seed: int = 42, init_seed: int = 0,
                    full_metrics: bool = False, eval_backend: str = "device",
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
        raise NotImplementedError(_NO_PARALLEL)
    if full_metrics:
        raise NotImplementedError(_NO_EVALX)
    _check_eval_backend(eval_backend)

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
               reset_per_fold: bool = False, eval_backend: str = "device",
               full_metrics: bool = False, verbose: bool = False,
               device=DEFAULT_DEVICE):
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
    _check_eval_backend(eval_backend)

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


def _fold_maes_on_device(model, cfg, best_vars, lr_all, hr_all, folds, dev):
    """Each fold's validation off-diagonal MAE from one staging of the
    stacks; only (F,) scalars come back."""
    lr_d = torch.from_numpy(lr_all).to(dev)
    hr_d = torch.from_numpy(hr_all).to(dev)
    x_d = torch.from_numpy(precompute_gat_features(lr_all, cfg.dim)).to(dev)
    va_len = max(len(va) for _, va in folds)
    va_idx = np.zeros((len(folds), va_len), np.int64)
    for j, (_, va) in enumerate(folds):
        va_idx[j, :len(va)] = np.asarray(va)
    maes = predict_gat_folds_mae(model, best_vars, lr_d, x_d, va_idx, hr_d,
                                 [len(va) for _, va in folds])
    return [float(m) for m in maes.cpu().numpy()]


def run_gat_cv(data: Dict[str, np.ndarray], splits: int = 3, seed: int = 42,
               cfg: Optional[GATTrainConfig] = None,
               full_metrics: bool = False, eval_backend: str = "device",
               verbose: bool = False, device=DEFAULT_DEVICE):
    """The GAT Graph-U-Net's k-fold pipeline, one fold after the other: a
    fresh model per fold (seed + j), intermediate-loss training under the
    host's plateau schedule (``train_gat``), then each fold's validation
    MAE and the last fold's predictions of the test set.

    Returns ``model``, ``variables`` (the last fold's best state_dict as
    numpy arrays), ``variables_per_fold``, ``cfg``, ``fold_maes``,
    ``mean_mae``, ``fold_metrics`` (empty), ``histories``, ``test_preds``
    (a tensor on ``device``, or None without ``lr_test``), ``timings``."""
    if full_metrics:
        raise NotImplementedError(_NO_EVALX)
    _check_eval_backend(eval_backend)
    dev = resolve_device(device)
    cfg = cfg or GATTrainConfig()
    lr_all = np.ascontiguousarray(data["lr_train"], dtype=np.float32)
    hr_all = np.ascontiguousarray(data["hr_train"], dtype=np.float32)
    cfg = _fit_cfg_to_data(cfg, lr_all, hr_all)
    folds = kfold_indices(len(lr_all), splits, seed=seed)

    histories, best_vars = [], []
    model = None
    t0 = time.perf_counter()
    for j, (tr, va) in enumerate(folds):
        model, opt = init_gat(cfg, seed + j, dev)
        variables, opt, hist = train_gat(model, opt, cfg, lr_all[tr],
                                         hr_all[tr], lr_all[va], hr_all[va],
                                         seed=seed + j, verbose=verbose)
        histories.append(hist)
        best_vars.append(variables)
    t_train = time.perf_counter() - t0

    t0 = time.perf_counter()
    fold_maes = _fold_maes_on_device(model, cfg, best_vars, lr_all, hr_all,
                                     folds, dev)
    t_predict = time.perf_counter() - t0
    test_preds = None
    if data.get("lr_test") is not None:
        test_preds = predict_gat(best_vars[-1], model, cfg, data["lr_test"])
    return {"model": model, "variables": best_vars[-1],
            "variables_per_fold": best_vars, "cfg": cfg,
            "fold_maes": fold_maes, "mean_mae": float(np.mean(fold_maes)),
            "fold_metrics": [], "histories": histories,
            "test_preds": test_preds,
            "timings": {"train": t_train, "predict": t_predict}}


def run_gat_cv_fast(data: Dict[str, np.ndarray],
                    cfg: Optional[GATTrainConfig] = None, splits: int = 3,
                    seed: int = 42, full_metrics: bool = False,
                    eval_backend: str = "device", verbose: bool = False,
                    host_control: bool = False,
                    multichip: bool = False, flat0=None,
                    device=DEFAULT_DEVICE):
    """Fold-parallel GAT CV: all folds trained together
    (``train_gat_folds_parallel``; the plateau scheduler, best state and
    early stop run on the device unless ``host_control``), then each fold's
    validation MAE and the last fold's predictions of the test set. The
    same result dict as ``run_gat_cv``. ``flat0`` optionally gives the
    folds' initial weights (``GATLayout`` order)."""
    if multichip:
        raise NotImplementedError(_NO_PARALLEL)
    if full_metrics:
        raise NotImplementedError(_NO_EVALX)
    _check_eval_backend(eval_backend)
    dev = resolve_device(device)
    cfg = cfg or GATTrainConfig()
    lr_all = np.ascontiguousarray(data["lr_train"], dtype=np.float32)
    hr_all = np.ascontiguousarray(data["hr_train"], dtype=np.float32)
    cfg = _fit_cfg_to_data(cfg, lr_all, hr_all)
    folds = kfold_indices(len(lr_all), splits, seed=seed)

    t0 = time.perf_counter()
    model, best_vars, histories = train_gat_folds_parallel(
        cfg, lr_all, hr_all, folds, seed=seed, verbose=verbose,
        host_control=host_control, flat0=flat0, device=dev)
    t_train = time.perf_counter() - t0

    t0 = time.perf_counter()
    fold_maes = _fold_maes_on_device(model, cfg, best_vars, lr_all, hr_all,
                                     folds, dev)
    t_predict = time.perf_counter() - t0
    test_preds = None
    if data.get("lr_test") is not None:
        test_preds = predict_gat(best_vars[-1], model, cfg, data["lr_test"])
    return {"model": model, "variables": best_vars[-1],
            "variables_per_fold": best_vars, "cfg": cfg,
            "fold_maes": fold_maes, "mean_mae": float(np.mean(fold_maes)),
            "fold_metrics": [], "histories": histories,
            "test_preds": test_preds,
            "timings": {"train": t_train, "predict": t_predict}}
