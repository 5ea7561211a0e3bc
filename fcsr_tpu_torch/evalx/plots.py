"""Plot artifacts matching the reference's outputs (loss.png per run,
3-fold comparison bars from 3fold_vis.ipynb). Counterpart of
``fcsr_tpu/evalx/plots.py``; matplotlib is imported inside the functions
that draw."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

__all__ = ["save_loss_curve", "save_fold_comparison"]

_METRIC_LABELS = {
    "mae": "MAE",
    "pcc": "PCC",
    "js_distance": "Jensen-Shannon distance",
    "kl_weights": "KL (weight dist.)",
    "mae_betweenness": "MAE betweenness",
    "mae_eigenvector": "MAE eigenvector",
    "mae_pagerank": "MAE PageRank",
    "mae_core_periphery": "MAE core-periphery",
}


def save_loss_curve(train_hist: Sequence[float], path: str,
                    val_hist: Sequence[float] = None,
                    title: str = "training loss"):
    """loss.png equivalent (ref: outputs/*/loss.png)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(train_hist, label="train")
    if val_hist is not None:
        ax.plot(val_hist, label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_fold_comparison(per_model_fold_metrics: Dict[str, List[dict]],
                         out_dir: str, metrics: Sequence[str] = None):
    """Per-metric grouped bar plots across models and folds
    (ref: 3fold_vis.ipynb). ``per_model_fold_metrics`` maps model name ->
    list of per-fold metric dicts (as returned by evaluate_pair_stacks).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    metrics = metrics or list(_METRIC_LABELS)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for metric in metrics:
        fig, ax = plt.subplots(figsize=(7, 4))
        models = list(per_model_fold_metrics)
        n_folds = max(len(v) for v in per_model_fold_metrics.values())
        width = 0.8 / max(len(models), 1)
        xs = np.arange(n_folds)
        for mi, name in enumerate(models):
            vals = [fm.get(metric, float("nan"))
                    for fm in per_model_fold_metrics[name]]
            ax.bar(xs[: len(vals)] + mi * width, vals, width, label=name)
        ax.set_xticks(xs + width * (len(models) - 1) / 2)
        ax.set_xticklabels([f"fold {i + 1}" for i in range(n_folds)])
        ax.set_title(_METRIC_LABELS.get(metric, metric))
        ax.legend()
        fig.tight_layout()
        path = os.path.join(out_dir, f"compare_{metric}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        paths.append(path)
    return paths
