"""Dataset loading: the seeded synthetic teacher set and its npz cache.

Ingest of the real Kaggle CSVs (``lr_train.csv`` / ``hr_train.csv`` /
``lr_test.csv``) is not ported yet; a data directory that holds them
raises instead of being silently replaced by synthetic data.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = ["has_real_csvs", "load_or_synthesize"]


def has_real_csvs(data_dir: Optional[str]) -> bool:
    """True iff ``data_dir`` holds the Kaggle CSVs (``lr_train.csv``)."""
    return bool(data_dir) and os.path.exists(
        os.path.join(data_dir, "lr_train.csv"))


def load_or_synthesize(data_dir: Optional[str] = None,
                       n_train: int = 167, n_test: int = 112,
                       seed: int = 42) -> Dict[str, np.ndarray]:
    """The seeded teacher dataset ``{lr_train, hr_train, lr_test}``,
    cached as ``<data_dir>/fcsr_synth2_teacher_<seed>_<n_train>_<n_test>.npz``
    when ``data_dir`` is given (the same file the JAX package writes)."""
    if has_real_csvs(data_dir):
        raise NotImplementedError(
            f"{data_dir} holds the Kaggle CSVs; CSV ingest (data/io.py "
            "load_dataset and core/vectorize) comes with a later slice of "
            "the port — use the JAX package to train on them")

    cache_path = None
    if data_dir:
        cache_path = os.path.join(
            data_dir, f"fcsr_synth2_teacher_{seed}_{n_train}_{n_test}.npz")
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                return {k: z[k] for k in z.files}

    from fcsr_tpu_torch.data.synthetic import synthesize_teacher_connectomes
    lr, hr, lr_test = synthesize_teacher_connectomes(n_train, seed=seed,
                                                     n_test=n_test)
    out = {"lr_train": lr, "hr_train": hr, "lr_test": lr_test}
    if cache_path:
        try:
            os.makedirs(data_dir, exist_ok=True)
            np.savez(cache_path, **out)
        except OSError:
            pass
    return out
