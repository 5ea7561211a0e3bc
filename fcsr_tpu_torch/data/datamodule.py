"""K-fold split planning over stacked connectome arrays."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["kfold_indices"]


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
