"""End-to-end pipelines: k-fold CV training -> validation -> test-set
predictions, from a dataset dict to a result dict.

Counterpart of ``fcsr_tpu/pipelines.py``. GSR-Net: ``run_gsr_cv`` (the
reference-faithful parity trainer, one model carried across the folds) and
``run_gsr_cv_fast`` (a fresh model per fold, all folds trained together, in
the mode the configuration's ``fused_*`` flags pick). GAT U-Net:
``run_gat_cv`` (a fresh model per fold, one fold after the other) and
``run_gat_cv_fast`` (all folds together; ``cfg.fused_step`` puts the step
on the CUDA kernels). The MLP family: ``run_mlp_cv`` (all folds together
when their sizes agree, else one after the other). With ``full_metrics``
each pipeline also scores every fold's validation predictions with the
metric suite (``evalx``, ``eval_backend`` "device" or "networkx") into
``fold_metrics``. With ``multichip=True`` the fast GSR and GAT pipelines
shard the fold axis over the first ``min(cards, splits)`` cards
(``parallel/mesh.py``; with ``device="cpu"`` over the one CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from fcsr_tpu_torch.core.vectorize import triu_indices_rowmajor
from fcsr_tpu_torch.data.datamodule import (contiguous_window_folds,
                                            kfold_indices)
from fcsr_tpu_torch.evalx.report import print_metrics, require_networkx
from fcsr_tpu_torch.train.fast_loop import (evaluate_gsr_folds,
                                            train_gsr_folds_parallel)
from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig, init_gat,
                                           precompute_gat_features,
                                           predict_gat, predict_gat_folds,
                                           predict_gat_folds_mae,
                                           stage_lr_cached, train_gat,
                                           train_gat_folds_parallel)
from fcsr_tpu_torch.models.mlp import SpectralResMLP, SuperResMLP
from fcsr_tpu_torch.parallel.mesh import batch_mesh
from fcsr_tpu_torch.train.generic_loop import (mse_criterion, train_model,
                                               train_model_folds)
from fcsr_tpu_torch.train.gsr_loop import (GSRTrainConfig, evaluate_gsr,
                                           init_gsr, precompute_spectral,
                                           predict_gsr, train_gsr_fold)
from fcsr_tpu_torch.train.losses import (make_triu_mse_criterion,
                                         pack_triu_targets)
from fcsr_tpu_torch.utils import profiling
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from fcsr_tpu_torch.utils.transfer import stage_cached

__all__ = ["run_gsr_cv", "run_gsr_cv_fast", "run_mlp_cv", "run_gat_cv",
           "run_gat_cv_fast"]

def _fold_mesh(multichip: bool, splits: int, device):
    """The mesh ``multichip`` asks for: the first ``min(cards, splits)``
    cards (surplus cards would only hold fully masked padding folds), or
    the one CPU with ``device="cpu"``; None without ``multichip``."""
    if not multichip:
        return None
    dev = resolve_device(device)
    if dev.type != "cuda":
        return batch_mesh([dev])
    return batch_mesh([torch.device("cuda", i) for i in
                       range(min(torch.cuda.device_count(), splits))])


def _run_device(device):
    """The card a run's phases are timed on by events, or None (the CPU,
    or no card visible: the entry raises on its own there)."""
    dev = torch.device(device)
    return dev if dev.type == "cuda" and torch.cuda.is_available() else None


PHASES = ("stage", "train", "fold_eval", "test_predict")


def _stage_and_train():
    """The phases ``stage`` and ``train`` of a fast entry, for its
    fold-parallel trainer to enter around its construction and its
    training."""
    return profiling.phase("stage"), profiling.phase("train")


def _phase_timings(timer, legacy: str) -> Dict[str, float]:
    """A fast entry's ``timings``: the host seconds of its phases and of
    its graphs' captures, and the fold evaluation again under the name
    the entry has always given it (``legacy``)."""
    rep = timer.report()
    out = {k: rep.get(k, 0.0) for k in PHASES + ("capture",)}
    out[legacy] = out["fold_eval"]
    return out


def _check_eval_backend(eval_backend: str, full_metrics: bool):
    """The JAX package's ``eval_backend``, checked before any training: an
    unknown name is a ValueError, and "networkx" for the metric suite
    needs the networkx package (an ImportError naming it)."""
    if eval_backend not in ("device", "networkx"):
        raise ValueError(f"unknown eval_backend: {eval_backend!r} "
                         "(expected 'device' or 'networkx')")
    if full_metrics and eval_backend == "networkx":
        require_networkx()


def _fold_metrics(fold_outs, eval_backend, verbose, device):
    """The metric suite over each fold's (preds, gts) stacks."""
    return [print_metrics(gts, preds, fold_i=j, backend=eval_backend,
                          write_file=False, verbose=verbose, device=device)
            for j, (preds, gts) in enumerate(fold_outs)]


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
    ``fold_metrics`` (each fold's metric dict with ``full_metrics``, else
    empty), ``params`` / ``params_per_fold`` (state_dict
    mappings of numpy arrays), ``runner``, ``model``, ``cfg``,
    ``test_preds`` (a tensor on ``device``, or None without ``lr_test``),
    ``loss_hist``, ``timings`` and the step / forward counts. ``flat0``
    optionally gives the folds' initial weights (``GSRFoldRunner``).
    ``multichip=True`` shards the fold axis over the local cards (every
    fold's math unchanged)."""
    _check_eval_backend(eval_backend, full_metrics)
    with profiling.cv_run("run_gsr_cv_fast", _run_device(device)) as timer:
        mesh = _fold_mesh(multichip, splits, device)
        cfg = cfg or GSRTrainConfig(fused_adam=True)
        lr_all = np.asarray(data["lr_train"], dtype=np.float32)
        hr_all = np.asarray(data["hr_train"], dtype=np.float32)
        cfg = _fit_cfg_to_data(cfg, lr_all, hr_all)
        folds = kfold_indices(len(lr_all), splits, seed=seed)
        model, params_per_fold, loss_hist, err_hist, runner = \
            train_gsr_folds_parallel(cfg, lr_all, hr_all, folds,
                                     init_seed=init_seed,
                                     checkpoint_path=checkpoint_path,
                                     checkpoint_every=checkpoint_every,
                                     flat0=flat0, device=device, mesh=mesh,
                                     phases=_stage_and_train())
        with profiling.phase("fold_eval"):
            fold_maes, fold_outs = evaluate_gsr_folds(
                cfg, runner, pull_preds=full_metrics)
        fold_metrics = []
        if full_metrics:
            with profiling.span("fold_metrics"):
                fold_metrics = _fold_metrics(fold_outs, eval_backend, False,
                                             device)
        test_preds = None
        with profiling.phase("test_predict"):
            if data.get("lr_test") is not None:
                test_preds = predict_gsr(params_per_fold[-1], model, cfg,
                                         data["lr_test"])

    return {
        "fold_maes": fold_maes,
        "mean_mae": float(np.mean(fold_maes)),
        "fold_metrics": fold_metrics,
        "params": params_per_fold[-1],
        "params_per_fold": params_per_fold,
        "runner": runner,
        "model": model,
        "cfg": cfg,
        "test_preds": test_preds,
        "loss_hist": loss_hist,
        "timings": _phase_timings(timer, "eval"),
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
    ``fold_metrics`` (with ``full_metrics``), ``params`` (the last model's
    state_dict as numpy arrays), ``model``, ``cfg``, ``test_preds`` (a
    tensor on ``device``, or None without ``lr_test``), ``timings`` and the
    step / forward counts."""
    _check_eval_backend(eval_backend, full_metrics)
    with profiling.cv_run("run_gsr_cv") as timer:
        cfg = cfg or GSRTrainConfig()
        lr_all = np.asarray(data["lr_train"], dtype=np.float32)
        hr_all = np.asarray(data["hr_train"], dtype=np.float32)
        cfg = _fit_cfg_to_data(cfg, lr_all, hr_all)
        folds = kfold_indices(len(lr_all), splits, seed=seed)
        model, optimizer = init_gsr(cfg, init_seed, device)

        # every spectral precompute in one batched shot (the folds take
        # slices)
        with profiling.span("stage"):
            u_lr_all, u_hr_all = precompute_spectral(lr_all, hr_all,
                                                     lr_dim=cfg.lr_dim,
                                                     padding=cfg.padding)

        fold_maes, fold_metrics = [], []
        for j, (tr, va) in enumerate(folds):
            if reset_per_fold:
                model, optimizer = init_gsr(cfg, init_seed + j, device)
            with profiling.span("train"):
                train_gsr_fold(model, optimizer, cfg, lr_all[tr], hr_all[tr],
                               spectral=(u_lr_all[tr], u_hr_all[tr]),
                               verbose=verbose)
            with profiling.span("fold_eval"):
                mae, preds, gts = evaluate_gsr(None, model, cfg, lr_all[va],
                                               hr_all[va], verbose=verbose)
                fold_maes.append(mae)
                if full_metrics:
                    fold_metrics.append(print_metrics(
                        gts, preds, fold_i=j, backend=eval_backend,
                        write_file=False, verbose=verbose, device=device))

        test_preds = None
        with profiling.span("test_predict"):
            if data.get("lr_test") is not None:
                test_preds = predict_gsr(None, model, cfg, data["lr_test"])

    rep = timer.report()
    return {
        "fold_maes": fold_maes,
        "mean_mae": float(np.mean(fold_maes)),
        "fold_metrics": fold_metrics,
        "params": {k: t.detach().cpu().numpy()
                   for k, t in model.state_dict().items()},
        "model": model,
        "cfg": cfg,
        "test_preds": test_preds,
        "timings": {"spectral": rep["stage"], "train": rep.get("train", 0.0),
                    "eval": rep.get("fold_eval", 0.0)},
        "n_train_steps": sum(len(tr) for tr, _ in folds) * cfg.epochs,
        "n_eval_forwards": sum(len(va) for _, va in folds),
    }


def _stage_val(cfg, lr_all, folds, dev):
    """The LR stack and its node features on ``dev``, and the folds'
    validation subjects padded to one length, (F, va_len)."""
    lr_d = stage_lr_cached(lr_all, dev)
    x_d = torch.from_numpy(precompute_gat_features(lr_all, cfg.dim)).to(dev)
    va_len = max(len(va) for _, va in folds)
    va_idx = np.zeros((len(folds), va_len), np.int64)
    for j, (_, va) in enumerate(folds):
        va_idx[j, :len(va)] = np.asarray(va)
    return lr_d, x_d, va_idx


def _fold_maes_on_device(model, cfg, best_vars, lr_all, hr_all, folds, dev):
    """Each fold's validation off-diagonal MAE from one staging of the
    stacks; only (F,) scalars come back."""
    lr_d, x_d, va_idx = _stage_val(cfg, lr_all, folds, dev)
    hr_d = stage_cached(hr_all, dev)
    maes = predict_gat_folds_mae(model, best_vars, lr_d, x_d, va_idx, hr_d,
                                 [len(va) for _, va in folds])
    return [float(m) for m in maes.cpu().numpy()]


def _gat_fold_eval(model, cfg, best_vars, lr_all, hr_all, folds, dev,
                   full_metrics, eval_backend, verbose):
    """(fold_maes, fold_metrics). Without ``full_metrics`` only the (F,)
    MAEs come back from the device; with it every fold's predictions come
    back, its off-diagonal MAE is taken on the host and the metric suite
    scores them, as in the JAX package."""
    if not full_metrics:
        return _fold_maes_on_device(model, cfg, best_vars, lr_all, hr_all,
                                    folds, dev), []
    preds_f = predict_gat_folds(model, best_vars,
                                *_stage_val(cfg, lr_all, folds, dev))
    preds_f = preds_f.cpu().numpy()
    fold_maes, fold_outs = [], []
    for j, (_, va) in enumerate(folds):
        preds, gts = preds_f[j, :len(va)], hr_all[va]
        off = ~np.eye(gts.shape[-1], dtype=bool)
        fold_maes.append(float(np.abs(preds[:, off] - gts[:, off]).mean()))
        fold_outs.append((preds, gts))
    return fold_maes, _fold_metrics(fold_outs, eval_backend, verbose, dev)


def _mlp_fold_mae(variant, pred, target):
    """A fold's validation MAE on the device: over the triangle vectors for
    v2 (which equals the off-diagonal matrix MAE: each off-diagonal pair
    counts twice in both sums), over the off-diagonal entries for v1."""
    if variant != "v1":
        return (pred - target[:, :pred.shape[-1]]).abs().mean()
    n = pred.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=pred.device)
    return (pred - target).abs().masked_fill(eye, 0.0).sum() \
        / (pred.shape[0] * n * (n - 1))


def run_mlp_cv(data: Dict[str, np.ndarray], k_folds: int = 3,
               p_val: float = 0.33, num_epochs: int = 100, lr: float = 0.01,
               batch_size: int = 32, n_layers: int = 0,
               hidden: Optional[int] = None, seed: int = 42,
               variant: str = "v2",
               full_metrics: bool = False, eval_backend: str = "device",
               fold_parallel: bool = True,
               verbose: bool = False, flat0=None, device=DEFAULT_DEVICE):
    """The MLP family's k-fold pipeline: contiguous-window folds over one
    permutation, MSE + AdamW + plateau schedule, best-state restore, each
    fold's validation MAE, then the last fold's predictions of the test
    set.

    ``variant="v2"`` is the shipped ``SpectralResMLP``, trained in
    triangle-vector space (``make_triu_mse_criterion`` on packed targets)
    and predicting matrices through ``anti_vectorize_normalize``;
    ``variant="v1"`` the dense ``SuperResMLP`` (hidden 10 000, at least one
    hidden block) on matrices. Fold j starts from seed ``seed + j``, or
    from row j of ``flat0`` = (p (F, P), s (F, S)) in the model's
    ``MLPLayout``. The folds train together (``train_model_folds``) when
    their sizes agree and neither ``verbose`` nor ``fold_parallel=False``
    asks otherwise; else one after the other (``train_model``).

    Returns ``model`` (the prediction model's configuration, on the meta
    device: its weights are ``variables``, for ``model.predict``),
    ``variables`` (the last fold's best state_dict, tensors on
    ``device``), ``variables_per_fold`` (every fold's), ``fold_metrics``
    (each fold's metric dict with ``full_metrics``), ``fold_maes``,
    ``mean_mae``, ``histories`` (each fold's train / val / lr lists),
    ``test_preds`` (a tensor on ``device``, or None without ``lr_test``)
    and ``timings`` (the fast entries' phases and ``capture``, with the
    fold evaluation also as ``eval`` and the test predictions as
    ``predict``)."""
    _check_eval_backend(eval_backend, full_metrics)
    dev = resolve_device(device)
    with profiling.cv_run("run_mlp_cv", _run_device(dev)) as timer:
        with profiling.phase("stage"):
            lr_all = np.asarray(data["lr_train"], dtype=np.float32)
            hr_all = np.asarray(data["hr_train"], dtype=np.float32)
            n_in, n_out = lr_all.shape[-1], hr_all.shape[-1]
            folds = contiguous_window_folds(len(lr_all), k_folds, p_val,
                                            seed=seed)
            if variant == "v1":
                model = SuperResMLP(n_in * n_in, n_out * n_out,
                                    hidden or 10000, max(1, n_layers),
                                    device="meta")
                model_train = model
                x_all, y_all = lr_all, hr_all
                criterion = mse_criterion
            elif variant == "v2":
                hidden = hidden or (n_in + n_out) // 2
                model = SpectralResMLP(n_in, n_out, hidden, n_layers,
                                       device="meta")
                model_train = SpectralResMLP(n_in, n_out, hidden, n_layers,
                                             output="vector", device="meta")
                r_in, c_in = triu_indices_rowmajor(n_in)
                x_all = lr_all[:, r_in, c_in]                # (N, L_in)
                y_all = pack_triu_targets(hr_all)            # (N, L_out + n)
                criterion = make_triu_mse_criterion(n_out)
            else:
                raise ValueError(f"unknown MLP variant: {variant!r}")
            seeds = [seed + j for j in range(len(folds))]
            if flat0 is None:
                p0, s0 = model.init_flat(seeds, dev)
            else:
                p0, s0 = (torch.from_numpy(np.ascontiguousarray(
                    a, np.float32)).to(dev) for a in flat0)
            sizes = {(len(tr), len(va)) for tr, va in folds}
            together = fold_parallel and not verbose and len(sizes) == 1 \
                and len(folds) > 1
            if together:
                tr_idx = np.stack([tr for tr, _ in folds])
                va_idx = np.stack([va for _, va in folds])
                stacks = (x_all[tr_idx], y_all[tr_idx], x_all[va_idx],
                          y_all[va_idx])
        kw = dict(num_epochs=num_epochs, lr=lr, batch_size=batch_size,
                  criterion=criterion, device=dev)

        if together:
            # the stacks' upload and the trainer's buffers are staging
            results = train_model_folds(model_train, (p0, s0), *stacks,
                                        seeds=seeds,
                                        phases=_stage_and_train(), **kw)
            del stacks
        else:
            with profiling.phase("train"):
                results = [train_model(model_train, (p0[j], s0[j]),
                                       x_all[tr], y_all[tr], x_all[va],
                                       y_all[va], seed=seeds[j],
                                       verbose=verbose, **kw)
                           for j, (tr, va) in enumerate(folds)]
        del p0, s0
        with profiling.phase("fold_eval"):
            maes, fold_outs = [], []
            for (tr, va), (*_, best) in zip(folds, results):
                x_va, y_va = (torch.from_numpy(np.ascontiguousarray(
                    a[va])).to(dev) for a in (x_all, y_all))
                maes.append(_mlp_fold_mae(
                    variant, model_train.predict(best, x_va), y_va))
                if full_metrics:
                    fold_outs.append((
                        model.predict(best, x_va).cpu().numpy(), hr_all[va]))
            fold_maes = [float(m) for m in torch.stack(maes).cpu().numpy()]
            fold_metrics = (_fold_metrics(fold_outs, eval_backend, verbose,
                                          dev) if full_metrics else [])
        with profiling.phase("test_predict"):
            best = results[-1][3]
            test_preds = None
            if data.get("lr_test") is not None:
                lr_test = np.asarray(data["lr_test"], dtype=np.float32)
                x_test = lr_test if variant == "v1" \
                    else lr_test[:, r_in, c_in]
                test_preds = model.predict(best, torch.from_numpy(
                    np.ascontiguousarray(x_test)).to(dev))
    timings = _phase_timings(timer, "eval")
    timings["predict"] = timings["test_predict"]
    return {"model": model, "variables": best,
            "variables_per_fold": [r[3] for r in results],
            "fold_metrics": fold_metrics,
            "fold_maes": fold_maes, "mean_mae": float(np.mean(fold_maes)),
            "histories": [tuple(r[:3]) for r in results],
            "test_preds": test_preds, "timings": timings}


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
    ``mean_mae``, ``fold_metrics`` (each fold's metric dict with
    ``full_metrics``, else empty), ``histories``, ``test_preds`` (a tensor
    on ``device``, or None without ``lr_test``), ``timings``."""
    _check_eval_backend(eval_backend, full_metrics)
    with profiling.cv_run("run_gat_cv") as timer:
        dev = resolve_device(device)
        cfg = cfg or GATTrainConfig()
        lr_all = np.ascontiguousarray(data["lr_train"], dtype=np.float32)
        hr_all = np.ascontiguousarray(data["hr_train"], dtype=np.float32)
        cfg = _fit_cfg_to_data(cfg, lr_all, hr_all)
        folds = kfold_indices(len(lr_all), splits, seed=seed)

        histories, best_vars = [], []
        model = None
        with profiling.span("train"):
            for j, (tr, va) in enumerate(folds):
                model, opt = init_gat(cfg, seed + j, dev)
                variables, opt, hist = train_gat(
                    model, opt, cfg, lr_all[tr], hr_all[tr], lr_all[va],
                    hr_all[va], seed=seed + j, verbose=verbose)
                histories.append(hist)
                best_vars.append(variables)

        with profiling.span("fold_eval"):
            fold_maes, fold_metrics = _gat_fold_eval(
                model, cfg, best_vars, lr_all, hr_all, folds, dev,
                full_metrics, eval_backend, verbose)
        test_preds = None
        with profiling.span("test_predict"):
            if data.get("lr_test") is not None:
                test_preds = predict_gat(best_vars[-1], model, cfg,
                                         data["lr_test"])
    rep = timer.report()
    return {"model": model, "variables": best_vars[-1],
            "variables_per_fold": best_vars, "cfg": cfg,
            "fold_maes": fold_maes, "mean_mae": float(np.mean(fold_maes)),
            "fold_metrics": fold_metrics, "histories": histories,
            "test_preds": test_preds,
            "timings": {"train": rep["train"], "predict": rep["fold_eval"]}}


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
    folds' initial weights (``GATLayout`` order). ``multichip=True``
    shards the fold axis over the local cards (on-device control)."""
    _check_eval_backend(eval_backend, full_metrics)
    dev = resolve_device(device)
    with profiling.cv_run("run_gat_cv_fast", _run_device(dev)) as timer:
        mesh = _fold_mesh(multichip, splits, dev)
        cfg = cfg or GATTrainConfig()
        lr_all = np.ascontiguousarray(data["lr_train"], dtype=np.float32)
        hr_all = np.ascontiguousarray(data["hr_train"], dtype=np.float32)
        cfg = _fit_cfg_to_data(cfg, lr_all, hr_all)
        folds = kfold_indices(len(lr_all), splits, seed=seed)
        model, best_vars, histories = train_gat_folds_parallel(
            cfg, lr_all, hr_all, folds, seed=seed, verbose=verbose,
            host_control=host_control, mesh=mesh, flat0=flat0, device=dev,
            phases=_stage_and_train())
        with profiling.phase("fold_eval"):
            fold_maes, fold_metrics = _gat_fold_eval(
                model, cfg, best_vars, lr_all, hr_all, folds, dev,
                full_metrics, eval_backend, verbose)
        test_preds = None
        with profiling.phase("test_predict"):
            if data.get("lr_test") is not None:
                test_preds = predict_gat(best_vars[-1], model, cfg,
                                         data["lr_test"])
    return {"model": model, "variables": best_vars[-1],
            "variables_per_fold": best_vars, "cfg": cfg,
            "fold_maes": fold_maes, "mean_mae": float(np.mean(fold_maes)),
            "fold_metrics": fold_metrics, "histories": histories,
            "test_preds": test_preds,
            "timings": _phase_timings(timer, "predict")}
