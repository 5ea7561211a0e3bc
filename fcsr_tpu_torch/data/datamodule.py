"""Split schemes and batch planning over stacked connectome arrays.

Counterpart of ``fcsr_tpu/data/datamodule.py``; numpy only, and every
function returns what the JAX package's does, bit for bit (tested):

  * sklearn-style shuffled K-fold — ``kfold_indices``;
  * contiguous validation windows over one shared permutation (the MLP
    family's folds) — ``contiguous_window_folds``;
  * one shuffled train/validation split — ``train_val_split``;
  * per-epoch sample orders drawn on the host — ``epoch_permutations``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["kfold_indices", "contiguous_window_folds", "train_val_split",
           "epoch_permutations", "ConnectomeDataModule"]


def kfold_indices(n: int, k: int, seed: Optional[int] = 42,
                  shuffle: bool = True) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, val_idx) per fold, identical to sklearn's
    ``KFold(n_splits=k, shuffle=shuffle, random_state=seed).split(range(n))``:
    shuffle ``arange(n)`` with ``RandomState(seed)``, carve contiguous
    validation windows of ``n//k`` (+1 for the first ``n%k`` folds), and
    emit both index sets sorted."""
    indices = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(indices)
    fold_sizes = np.full(k, n // k, dtype=int)
    fold_sizes[: n % k] += 1
    folds = []
    start = 0
    for size in fold_sizes:
        stop = start + size
        val = np.sort(indices[start:stop])
        train = np.sort(np.concatenate([indices[:start], indices[stop:]]))
        folds.append((train, val))
        start = stop
    return folds


def contiguous_window_folds(n: int, k: int, p_val: float, seed: int = 42
                            ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One permutation of ``range(n)`` from ``np.random.default_rng(seed)``;
    fold ``j`` validates on its window ``[j * val_size, (j + 1) *
    val_size)``, ``val_size = int(n * p_val)``, and trains on the rest in
    permutation order. Every fold has the same sizes."""
    indices = np.random.default_rng(seed).permutation(n)
    val_size = int(n * p_val)
    folds = []
    for j in range(k):
        lo, hi = j * val_size, (j + 1) * val_size
        val = indices[lo:hi]
        train = np.concatenate([indices[:lo], indices[hi:]])
        folds.append((train, val))
    return folds


def train_val_split(n: int, p_val: float = 0.2,
                    seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """One shuffled split: the first ``int(n * (1 - p_val))`` entries of a
    permutation train, the rest validate."""
    indices = np.random.default_rng(seed).permutation(n)
    split = int(n * (1 - p_val))
    return indices[:split], indices[split:]


def epoch_permutations(n: int, num_epochs: int, seed: int = 0,
                       shuffle: bool = True) -> np.ndarray:
    """(num_epochs, n) int32 sample orders, one permutation per epoch from
    ``np.random.default_rng(seed)`` (``arange(n)`` each epoch without
    ``shuffle``)."""
    if not shuffle:
        return np.broadcast_to(np.arange(n, dtype=np.int32),
                               (num_epochs, n)).copy()
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n).astype(np.int32)
                     for _ in range(num_epochs)])


@dataclass
class ConnectomeDataModule:
    """Stacked (N, n, n) arrays and the folds of one split scheme
    ("kfold", "window" or "holdout")."""

    lr_train: np.ndarray
    hr_train: np.ndarray
    lr_test: Optional[np.ndarray] = None
    folds: List[Tuple[np.ndarray, np.ndarray]] = field(default_factory=list)

    @classmethod
    def from_arrays(cls, data: Dict[str, np.ndarray], scheme: str = "kfold",
                    k: int = 3, p_val: float = 0.33, seed: int = 42):
        n = data["lr_train"].shape[0]
        if scheme == "kfold":
            folds = kfold_indices(n, k, seed=seed)
        elif scheme == "window":
            folds = contiguous_window_folds(n, k, p_val, seed=seed)
        elif scheme == "holdout":
            folds = [train_val_split(n, p_val, seed=seed)]
        else:
            raise ValueError(f"unknown split scheme: {scheme}")
        return cls(lr_train=data["lr_train"], hr_train=data["hr_train"],
                   lr_test=data.get("lr_test"), folds=folds)

    @property
    def n_folds(self) -> int:
        return len(self.folds)

    def fold_arrays(self, j: int):
        """(lr_tr, hr_tr, lr_val, hr_val) stacks of fold j."""
        tr, va = self.folds[j]
        return (self.lr_train[tr], self.hr_train[tr],
                self.lr_train[va], self.hr_train[va])

    def iter_folds(self) -> Iterator[Tuple[np.ndarray, ...]]:
        for j in range(self.n_folds):
            yield self.fold_arrays(j)
