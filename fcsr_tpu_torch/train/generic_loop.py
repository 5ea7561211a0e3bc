"""The plateau learning-rate scheduler shared by the trainers. Counterpart
of ``fcsr_tpu/train/generic_loop.py::PlateauScheduler``; the MLP trainer of
that file is not ported yet."""

from __future__ import annotations

__all__ = ["PlateauScheduler"]


class PlateauScheduler:
    """``torch.optim.lr_scheduler.ReduceLROnPlateau(mode='min')`` semantics
    in Python floats: relative-threshold improvement tracking, ``patience``
    bad epochs, then a multiplicative ``factor`` decay."""

    def __init__(self, lr: float, patience: int = 10, factor: float = 0.1,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 min_lr: float = 0.0):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        if self.threshold_mode == "rel":
            return metric < self.best * (1.0 - self.threshold)
        return metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr
