"""Command-line interface of the port.

The parser of ``fcsr_tpu/cli.py`` plus ``--device``:

    python -m fcsr_tpu_torch train gsr --data-dir data     # parity trainer
    python -m fcsr_tpu_torch train gsr --fast [--fused-tail] --splits 3
    python -m fcsr_tpu_torch train gsr --fused --data-dir data --splits 3
    python -m fcsr_tpu_torch train gsr --multichip --fused  # folds on cards
    python -m fcsr_tpu_torch train gat [--fast] [--fused] [--multichip]
    python -m fcsr_tpu_torch train mlp [--variant v1] --k-folds 3
    python -m fcsr_tpu_torch train gsr --fused --full-metrics  # + evalx
    python -m fcsr_tpu_torch evaluate --gt gt.npz --pred pred.npz --fold 0
    python -m fcsr_tpu_torch predict --params ck.npz --out sub.csv
    python -m fcsr_tpu_torch predict --params gsr_net_trained.msgpack
    python -m fcsr_tpu_torch submit  --csv submission.csv -m "message"

Commands run on the card; ``--device cpu`` runs the kernels' plain PyTorch
versions on the host. Synthetic data is substituted when the Kaggle CSVs
are not in ``--data-dir``. ``--full-metrics`` scores every fold with the
metric suite into ``<out-dir>/eval_metrics.json``; ``--eval-backend
networkx`` and ``evaluate --backend networkx`` need the networkx package.
``--multichip`` (implies ``--fast``) shards the folds over the local cards.
No flag is dropped silently. With ``FCSR_TRACE_DIR`` set, ``train`` and
``predict`` write a ``torch.profiler`` Chrome trace there, the run's spans
(``fcsr.<name>``, ``utils/profiling.py``) in it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

__all__ = ["main", "build_parser"]

PARAMS_FILE = "gsr_params.npz"
GAT_PARAMS_FILE = "gat_params.npz"


def _add_common(p):
    p.add_argument("--data-dir", default="data")
    p.add_argument("--out-dir", default="outputs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--full-metrics", action="store_true")
    p.add_argument("--eval-backend", default="device",
                   choices=["device", "networkx"])
    p.add_argument("--verbose", action="store_true")
    _add_device(p)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch version "
                        "of every kernel on the host")


def build_parser():
    ap = argparse.ArgumentParser(prog="fcsr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="train a model family with CV")
    trs = tr.add_subparsers(dest="family", required=True)

    g = trs.add_parser("gsr")
    _add_common(g)
    g.add_argument("--splits", type=int, default=5)
    g.add_argument("--epochs", type=int, default=200)
    g.add_argument("--lr", type=float, default=1e-4)
    g.add_argument("--lmbda", type=float, default=16.0)
    g.add_argument("--multichip", action="store_true",
                   help="shard the fold axis over the local cards, at most "
                        "one per fold (implies --fast)")
    g.add_argument("--fast", action="store_true",
                   help="fold-parallel clean-CV trainer: a fresh model per "
                        "fold, all folds trained together")
    g.add_argument("--reset-per-fold", action="store_true",
                   help="fresh model per fold (the reference keeps "
                        "training one model across folds; --fast and "
                        "--fused always start fresh)")
    g.add_argument("--checkpoint", default=None,
                   help="(--fast / --fused) checkpoint file for exact "
                        "mid-training save/resume: the port's npz blob "
                        "(`predict --params` reads it too), or the JAX "
                        "package's msgpack resume blob where the file is "
                        "one or a new path ends in .msgpack (either "
                        "package resumes the other's run)")
    g.add_argument("--checkpoint-every", type=int, default=None)
    g.add_argument("--fused-tail", action="store_true",
                   help="with --fast: the spectral layer, decoder and loss "
                        "segment, value and gradients, on the hand-written "
                        "CUDA kernels (identical math)")
    g.add_argument("--fused", action="store_true",
                   help="run the whole training step (forward, backward "
                        "and Adam) on the hand-written CUDA kernels "
                        "(implies --fast; identical math up to float "
                        "reassociation)")

    m = trs.add_parser("mlp")
    _add_common(m)
    m.add_argument("--k-folds", type=int, default=3)
    m.add_argument("--p-val", type=float, default=0.33)
    m.add_argument("--epochs", type=int, default=100)
    m.add_argument("--lr", type=float, default=0.01)
    m.add_argument("--n-layers", type=int, default=0)
    m.add_argument("--batch-size", type=int, default=32)
    m.add_argument("--variant", default="v2", choices=["v1", "v2"])

    a = trs.add_parser("gat")
    _add_common(a)
    a.add_argument("--fast", action="store_true",
                   help="fold-parallel trainer: all folds trained together, "
                        "the plateau schedule and early stop on the device")
    a.add_argument("--fused", action="store_true",
                   help="run each training step and the validation forwards "
                        "on the hand-written CUDA kernels (implies --fast)")
    a.add_argument("--multichip", action="store_true",
                   help="shard the fold axis over the local cards, at most "
                        "one per fold (implies --fast)")
    a.add_argument("--splits", type=int, default=3)
    a.add_argument("--epochs", type=int, default=100)
    a.add_argument("--lr", type=float, default=1e-3)
    a.add_argument("--dim", type=int, default=16)

    ev = sub.add_parser("evaluate", help="run the metric suite on npz stacks")
    ev.add_argument("--gt", required=True)
    ev.add_argument("--pred", required=True)
    ev.add_argument("--fold", type=int, default=0)
    ev.add_argument("--backend", default="device",
                    choices=["device", "networkx"])
    ev.add_argument("--out-dir", default=".")
    _add_device(ev)

    pr = sub.add_parser("predict",
                        help="load GSR-Net weights and write a submission")
    pr.add_argument("--params", required=True,
                    help="the JAX package's msgpack params file (as its "
                         "train pipelines / examples and the port's "
                         "examples write it, e.g. gsr_net_trained.msgpack), "
                         "or an npz file: a model state (as `train gsr` "
                         f"writes to <out-dir>/{PARAMS_FILE}) or a trainer "
                         "checkpoint (its last fold's weights)")
    pr.add_argument("--data-dir", default="data")
    pr.add_argument("--out", default="submission.csv")
    pr.add_argument("--ordering", default="rowmajor",
                    choices=["rowmajor", "colmajor"])
    pr.add_argument("--seed", type=int, default=42)
    _add_device(pr)

    from fcsr_tpu_torch.iox.submission import DEFAULT_COMPETITION
    sm = sub.add_parser("submit",
                        help="submit a written CSV to the Kaggle challenge")
    sm.add_argument("--csv", default="submission.csv")
    sm.add_argument("--message", "-m", default="fcsr_tpu_torch submission")
    sm.add_argument("--competition", default=DEFAULT_COMPETITION)
    sm.add_argument("--dry-run", action="store_true",
                    help="print the kaggle CLI command instead of running it")

    return ap


def _write_fold_metrics(args, result):
    """``<out-dir>/eval_metrics.json``: the per-fold metric dicts of a
    ``--full-metrics`` run, as the JAX package's command line writes
    them."""
    if result.get("fold_metrics"):
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "eval_metrics.json")
        with open(path, "w") as f:
            json.dump(result["fold_metrics"], f, indent=2)
        print(f"metrics written: {path}")


def _load_stack(path):
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[z.files[0]]
    return np.load(path)


def _train_gat(args):
    """`train gat`: the GAT U-Net's CV run, one fold after the other, or
    with --fast / --fused / --multichip all folds together; writes the last
    fold's best weights and the column-major submission."""
    from fcsr_tpu_torch.data import load_or_synthesize
    from fcsr_tpu_torch.iox import save_prediction, save_state
    from fcsr_tpu_torch.pipelines import run_gat_cv, run_gat_cv_fast
    from fcsr_tpu_torch.train.gat_loop import GATTrainConfig
    from fcsr_tpu_torch.utils.reproducibility import set_seed

    set_seed(args.seed)
    data = load_or_synthesize(args.data_dir, seed=args.seed,
                              device=args.device)
    cfg = GATTrainConfig(epochs=args.epochs, lr=args.lr, dim=args.dim,
                         fused_step=args.fused)
    if args.fast or args.fused or args.multichip:
        result = run_gat_cv_fast(data, cfg, splits=args.splits,
                                 seed=args.seed,
                                 full_metrics=args.full_metrics,
                                 eval_backend=args.eval_backend,
                                 verbose=args.verbose,
                                 multichip=args.multichip,
                                 device=args.device)
    else:
        result = run_gat_cv(data, splits=args.splits, seed=args.seed,
                            cfg=cfg, full_metrics=args.full_metrics,
                            eval_backend=args.eval_backend,
                            verbose=args.verbose, device=args.device)
    print(json.dumps({"fold_maes": result["fold_maes"],
                      "mean_mae": result["mean_mae"],
                      "timings": result["timings"]}))
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, GAT_PARAMS_FILE)
    save_state(result["variables"], path)
    print(f"params written: {path}")
    if result["test_preds"] is not None:
        # the unet-transformer notebook emits the column-major ordering
        path = os.path.join(args.out_dir, "submission.csv")
        save_prediction(result["test_preds"], path, ordering="colmajor")
        print(f"submission written: {path}")
    _write_fold_metrics(args, result)
    return 0


def _train_mlp(args):
    """`train mlp`: the MLP family's CV run (v2, or --variant v1), all
    folds together; writes the column-major submission, and with
    --full-metrics eval_metrics.json (no weights file, as the JAX
    package's command writes none)."""
    from fcsr_tpu_torch.data import load_or_synthesize
    from fcsr_tpu_torch.iox import save_prediction
    from fcsr_tpu_torch.pipelines import run_mlp_cv
    from fcsr_tpu_torch.utils.reproducibility import set_seed

    set_seed(args.seed)
    data = load_or_synthesize(args.data_dir, seed=args.seed,
                              device=args.device)
    result = run_mlp_cv(data, k_folds=args.k_folds, p_val=args.p_val,
                        num_epochs=args.epochs, lr=args.lr,
                        batch_size=args.batch_size, n_layers=args.n_layers,
                        seed=args.seed, variant=args.variant,
                        full_metrics=args.full_metrics,
                        eval_backend=args.eval_backend,
                        verbose=args.verbose, device=args.device)
    print(json.dumps({"fold_maes": result["fold_maes"],
                      "mean_mae": result["mean_mae"],
                      "timings": result["timings"]}))
    if result["test_preds"] is not None:
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "submission.csv")
        save_prediction(result["test_preds"], path, ordering="colmajor")
        print(f"submission written: {path}")
    _write_fold_metrics(args, result)
    return 0


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cmd in ("train", "predict"):
        # FCSR_TRACE_DIR: a Chrome trace of the command, its spans in it
        from fcsr_tpu_torch.utils.profiling import trace_if_enabled
        with trace_if_enabled():
            return _run(args)
    return _run(args)


def _run(args):
    if args.cmd == "train" and args.family == "gat":
        return _train_gat(args)
    if args.cmd == "train" and args.family == "mlp":
        return _train_mlp(args)

    if args.cmd == "train":
        from fcsr_tpu_torch.data import load_or_synthesize
        from fcsr_tpu_torch.iox import save_prediction, save_state
        from fcsr_tpu_torch.pipelines import run_gsr_cv, run_gsr_cv_fast
        from fcsr_tpu_torch.train import GSRTrainConfig
        from fcsr_tpu_torch.utils.reproducibility import set_seed

        set_seed(args.seed)
        fast = args.fast or args.fused or args.multichip
        # no silent flag drop
        notes = [("--verbose", args.verbose and fast,
                  "the fast / fused path (the epoch histories are in the "
                  "result)"),
                 ("--reset-per-fold", args.reset_per_fold and fast,
                  "the fast / fused path (every fold trains a fresh "
                  "model)"),
                 ("--checkpoint", args.checkpoint and not fast,
                  "the parity trainer (pass --fast or --fused)"),
                 ("--fused-tail", args.fused_tail and not fast,
                  "the parity trainer (pass --fast)"),
                 ("--eval-backend", args.eval_backend != "device"
                  and not args.full_metrics,
                  "a run without --full-metrics")]
        for flag, on, where in notes:
            if on:
                print(f"note: {flag} changes nothing on {where}",
                      file=sys.stderr)
        data = load_or_synthesize(args.data_dir, seed=args.seed,
                                  device=args.device)
        cfg = GSRTrainConfig(epochs=args.epochs, lr=args.lr,
                             lmbda=args.lmbda, fused_tail=args.fused_tail,
                             fused_adam=args.fused)
        if fast:
            result = run_gsr_cv_fast(
                data, cfg, splits=args.splits, seed=args.seed,
                full_metrics=args.full_metrics,
                eval_backend=args.eval_backend,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                multichip=args.multichip, device=args.device)
        else:
            result = run_gsr_cv(data, cfg, splits=args.splits,
                                seed=args.seed,
                                reset_per_fold=args.reset_per_fold,
                                eval_backend=args.eval_backend,
                                full_metrics=args.full_metrics,
                                verbose=args.verbose, device=args.device)
        print(json.dumps({"fold_maes": result["fold_maes"],
                          "mean_mae": result["mean_mae"],
                          "timings": result["timings"]}))
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, PARAMS_FILE)
        save_state(result["params"], path)
        print(f"params written: {path}")
        if result["test_preds"] is not None:
            # the GSR notebook emits the row-major submission ordering
            path = os.path.join(args.out_dir, "submission.csv")
            save_prediction(result["test_preds"], path, ordering="rowmajor")
            print(f"submission written: {path}")
        _write_fold_metrics(args, result)
        return 0

    if args.cmd == "predict":
        from fcsr_tpu_torch.data import load_or_synthesize
        from fcsr_tpu_torch.iox import load_params, save_prediction
        from fcsr_tpu_torch.models import GSRNet
        from fcsr_tpu_torch.train import GSRTrainConfig, predict_gsr
        from fcsr_tpu_torch.utils import profiling

        params = load_params(args.params)
        hr_dim, lr_dim = params["layer.weights"].shape
        cfg = GSRTrainConfig(lr_dim=lr_dim, hr_dim=hr_dim,
                             hidden_dim=params["gc1.weight"].shape[1])
        model = GSRNet(cfg.ks, cfg.lr_dim, cfg.hr_dim, cfg.hidden_dim,
                       device=args.device)
        data = load_or_synthesize(args.data_dir, seed=args.seed,
                                  device=args.device)
        with profiling.span("test_predict"):
            preds = predict_gsr(params, model, cfg, data["lr_test"])
        save_prediction(preds, args.out, ordering=args.ordering)
        print(f"submission written: {args.out} "
              f"({preds.shape[0]} subjects, {args.ordering})")
        return 0

    if args.cmd == "evaluate":
        from fcsr_tpu_torch.evalx.report import print_metrics
        os.makedirs(args.out_dir, exist_ok=True)
        print_metrics(_load_stack(args.gt), _load_stack(args.pred),
                      fold_i=args.fold, backend=args.backend,
                      out_dir=args.out_dir, device=args.device)
        return 0

    if args.cmd == "submit":
        from fcsr_tpu_torch.iox.submission import kaggle_submit
        if not os.path.exists(args.csv):
            print(f"no such file: {args.csv}", file=sys.stderr)
            return 2
        return kaggle_submit(args.csv, args.message,
                             competition=args.competition,
                             dry_run=args.dry_run)

    return 1


if __name__ == "__main__":
    sys.exit(main())
