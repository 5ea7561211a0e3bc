"""Spectral-norm residual MLP training driver — the script form of
``training_template.ipynb`` (3 contiguous-window folds, MSE + AdamW +
plateau LR, per-fold full metric suite, column-major submission); the
port's ``examples/train_template.py``.

Writes ``eval_metrics.json``, ``loss.png``, ``model.msgpack`` (the last
fold's variables in the JAX package's flax layout) and ``submission.csv``
(column-major).
"""

import argparse
import json
import os

from fcsr_tpu_torch.examples._common import (add_device, save_loss_png,
                                             setup_runtime)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fcsr_tpu_torch.examples.train_template")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--out-dir", default="outputs/mlp")
    ap.add_argument("--k-folds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--eval-backend", default="device",
                    choices=["device", "networkx"])
    add_device(ap)
    args = ap.parse_args(argv)
    dev = setup_runtime(args.device)

    from fcsr_tpu_torch.data import load_or_synthesize
    from fcsr_tpu_torch.iox import (mlp_state_to_flax, save_prediction,
                                    save_pytree)
    from fcsr_tpu_torch.pipelines import run_mlp_cv
    from fcsr_tpu_torch.utils import set_seed

    set_seed(42)
    data = load_or_synthesize(args.data_dir, device=dev)
    result = run_mlp_cv(data, k_folds=args.k_folds, p_val=0.33,
                        num_epochs=args.epochs, full_metrics=True,
                        eval_backend=args.eval_backend, device=dev)

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "eval_metrics.json"), "w") as f:
        json.dump(result["fold_metrics"], f, indent=2)
    tr_h, va_h, _ = result["histories"][-1]
    save_loss_png(tr_h, os.path.join(args.out_dir, "loss.png"),
                  val_hist=va_h, title="SpectralResMLP training loss")
    state = {k: v.detach().cpu().numpy()
             for k, v in result["variables"].items()}
    save_pytree(mlp_state_to_flax(state),
                os.path.join(args.out_dir, "model.msgpack"))
    if result["test_preds"] is not None:
        save_prediction(result["test_preds"],
                        os.path.join(args.out_dir, "submission.csv"),
                        ordering="colmajor")
    print("artifacts in", args.out_dir)
    return result


if __name__ == "__main__":
    main()
