"""GSR-Net k-fold training driver — the script form of the reference's
``training_gsr.ipynb`` (Args config in cell-4, fold loop in cell-6,
row-major submission in cell-7); the port's ``examples/train_gsr.py``.

Usage:
    python -m fcsr_tpu_torch.examples.train_gsr [--data-dir data]
        [--splits 5] [--fast] [--out-dir outputs/gsr] [--device cuda]

Writes ``gsr_net_trained.msgpack`` (the last fold's weights in the JAX
package's flax layout: ``python -m fcsr_tpu predict`` and ``python -m
fcsr_tpu_torch predict`` both read it), ``submission.csv`` (row-major),
``loss.png`` (with ``--fast``) and ``eval_metrics.json`` (with
``--full-metrics``).
"""

import argparse
import json
import os

from fcsr_tpu_torch.examples._common import (add_device, save_loss_png,
                                             setup_runtime)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fcsr_tpu_torch.examples.train_gsr")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--out-dir", default="outputs/gsr")
    ap.add_argument("--splits", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--full-metrics", action="store_true")
    ap.add_argument("--eval-backend", default="device",
                    choices=["device", "networkx"])
    add_device(ap)
    args = ap.parse_args(argv)
    dev = setup_runtime(args.device)

    from fcsr_tpu_torch.data import load_or_synthesize
    from fcsr_tpu_torch.iox import save_prediction, save_pytree, state_to_flax
    from fcsr_tpu_torch.pipelines import run_gsr_cv, run_gsr_cv_fast
    from fcsr_tpu_torch.train import GSRTrainConfig
    from fcsr_tpu_torch.utils import set_seed

    set_seed(42)
    data = load_or_synthesize(args.data_dir, device=dev)
    cfg = GSRTrainConfig(epochs=args.epochs)

    runner = run_gsr_cv_fast if args.fast else run_gsr_cv
    result = runner(data, cfg, splits=args.splits,
                    full_metrics=args.full_metrics,
                    eval_backend=args.eval_backend, device=dev)

    os.makedirs(args.out_dir, exist_ok=True)
    print("fold MAEs:", result["fold_maes"], "mean:", result["mean_mae"])
    if result.get("fold_metrics"):
        # eval_metrics.json: what three_fold_vis consumes (and the
        # reference's own artifact, outputs/*/eval_metrics.json)
        with open(os.path.join(args.out_dir, "eval_metrics.json"),
                  "w") as f:
            json.dump(result["fold_metrics"], f, indent=2)
    save_pytree(state_to_flax(result["params"]),
                os.path.join(args.out_dir, "gsr_net_trained.msgpack"))
    if "loss_hist" in result:
        save_loss_png(result["loss_hist"][0].tolist(),
                      os.path.join(args.out_dir, "loss.png"),
                      title="GSR-Net fold-0 training loss")
    if result["test_preds"] is not None:
        # the GSR notebook flattens with np.triu_indices (row-major)
        save_prediction(result["test_preds"],
                        os.path.join(args.out_dir, "submission.csv"),
                        ordering="rowmajor")
    print("artifacts in", args.out_dir)
    return result


if __name__ == "__main__":
    main()
