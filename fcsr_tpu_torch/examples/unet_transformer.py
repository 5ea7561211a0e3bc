"""GAT Graph-U-Net 3-fold CV driver — the script form of the reference's
``unet-transformer.py`` __main__ (ref: unet-transformer.py:478-541):
KFold(3, shuffle, seed 42), fresh model per fold, intermediate
reconstruction losses, per-fold full metric report; the port's
``examples/unet_transformer.py``. Writes ``eval_metrics.json``,
``loss.png`` and ``submission.csv`` (column-major)."""

import argparse
import json
import os

from fcsr_tpu_torch.examples._common import (add_device, save_loss_png,
                                             setup_runtime)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fcsr_tpu_torch.examples.unet_transformer")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--out-dir", default="outputs/unet")
    ap.add_argument("--splits", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--eval-backend", default="device",
                    choices=["device", "networkx"])
    add_device(ap)
    args = ap.parse_args(argv)
    dev = setup_runtime(args.device)

    from fcsr_tpu_torch.data import load_or_synthesize
    from fcsr_tpu_torch.iox import save_prediction
    from fcsr_tpu_torch.pipelines import run_gat_cv
    from fcsr_tpu_torch.train.gat_loop import GATTrainConfig
    from fcsr_tpu_torch.utils import set_seed

    set_seed(42)
    data = load_or_synthesize(args.data_dir, device=dev)
    cfg = GATTrainConfig(epochs=args.epochs, dim=args.dim)
    result = run_gat_cv(data, splits=args.splits, cfg=cfg,
                        full_metrics=True, eval_backend=args.eval_backend,
                        device=dev)

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "eval_metrics.json"), "w") as f:
        json.dump(result["fold_metrics"], f, indent=2)
    save_loss_png(result["histories"][-1]["train"],
                  os.path.join(args.out_dir, "loss.png"),
                  val_hist=result["histories"][-1]["val"],
                  title="GAT U-Net training loss")
    if result["test_preds"] is not None:
        save_prediction(result["test_preds"],
                        os.path.join(args.out_dir, "submission.csv"),
                        ordering="colmajor")
    print("artifacts in", args.out_dir)
    return result


if __name__ == "__main__":
    main()
