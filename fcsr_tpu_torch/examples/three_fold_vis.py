"""Cross-model 3-fold comparison plots — the script form of the
reference's ``3fold_vis.ipynb``: reads each model's per-fold
``eval_metrics.json`` (as the other example drivers write it) and emits
grouped bar charts per metric (needs matplotlib); the port's
``examples/three_fold_vis.py``."""

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fcsr_tpu_torch.examples.three_fold_vis")
    ap.add_argument("--runs", nargs="+", default=["outputs/mlp",
                                                  "outputs/gsr",
                                                  "outputs/unet"],
                    help="run dirs containing eval_metrics.json")
    ap.add_argument("--out-dir", default="outputs/vis")
    args = ap.parse_args(argv)

    from fcsr_tpu_torch.evalx.plots import save_fold_comparison

    per_model = {}
    for run in args.runs:
        path = os.path.join(run, "eval_metrics.json")
        if not os.path.exists(path):
            print(f"skipping {run}: no eval_metrics.json")
            continue
        key = os.path.basename(run.rstrip("/"))
        if key in per_model:  # two runs sharing a leaf name: keep both
            key = run.rstrip("/").replace(os.sep, "_")
        with open(path) as f:
            per_model[key] = json.load(f)

    if not per_model:
        print("nothing to plot")
        return 1
    paths = save_fold_comparison(per_model, args.out_dir)
    print("wrote", len(paths), "plots to", args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
