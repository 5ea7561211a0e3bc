"""Dataset I/O: CSV ingestion, npz caching, dense-matrix materialization,
and the seeded synthetic teacher set.

Counterpart of ``fcsr_tpu/data/io.py``. The challenge ships vectorized
connectomes as CSVs (``lr_train.csv`` / ``hr_train.csv`` /
``lr_test.csv``); the whole dataset is anti-vectorized as one batched
kernel call (``core.triu_kernels.anti_vectorize_normalize`` on the chosen
device) and cached as ``.npz`` beside the CSVs. No pandas: the native
parser (``native/``) reads the files, else a numpy parser.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from fcsr_tpu_torch.core.triu_kernels import anti_vectorize_normalize
from fcsr_tpu_torch.native import fast_csv_available, read_csv_float32
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

LR_DIM = 160
HR_DIM = 268

__all__ = ["load_csv_vectors", "load_dataset", "load_or_synthesize",
           "has_real_csvs", "matrix_size_for", "write_kaggle_csvs",
           "LR_DIM", "HR_DIM"]


def has_real_csvs(data_dir: Optional[str]) -> bool:
    """The substitution rule: True iff ``load_or_synthesize(data_dir)``
    loads the Kaggle CSVs (``lr_train.csv`` is there) instead of
    synthesizing."""
    return bool(data_dir) and os.path.exists(
        os.path.join(data_dir, "lr_train.csv"))


def _parse_csv_numpy(csv_path: str, skip_first: bool) -> np.ndarray:
    """Header dropped, blank lines skipped, empty fields and NaN -> 0."""
    rows = []
    with open(csv_path) as f:
        f.readline()
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split(",")[1 if skip_first else 0:]
            rows.append(np.asarray([x.strip() or "nan" for x in fields],
                                   dtype=np.float64))
    data = np.stack(rows).astype(np.float32)
    return np.nan_to_num(data, nan=0.0)


def load_csv_vectors(csv_path: str, native: Optional[bool] = None
                     ) -> np.ndarray:
    """CSV of vectorized connectomes -> (N, V) float32; drops a leading
    ID / index column (header ``""``, ``"Unnamed: 0"`` or ``"ID"``) and
    maps NaN and empty cells to 0.

    ``native``: None takes the native multi-threaded parser when it can be
    built and the numpy parser otherwise; True / False force one."""
    with open(csv_path) as f:
        header = f.readline().strip().split(",")
    skip_first = header[0].strip().strip('"') in ("", "Unnamed: 0", "ID")

    if native is None:
        native = fast_csv_available()
    if native:
        return read_csv_float32(csv_path, skip_first)
    return _parse_csv_numpy(csv_path, skip_first)


def _to_matrices(vectors: np.ndarray, size: int, device) -> np.ndarray:
    """Batched anti-vectorize (row-major, as the reference's data path) to
    dense (N, size, size) float32 on the host, through the kernel on
    ``device``."""
    staged = torch.from_numpy(
        np.ascontiguousarray(vectors, dtype=np.float32)).to(device)
    return anti_vectorize_normalize(staged, size,
                                    normalize=False).cpu().numpy()


def matrix_size_for(vec_len: int) -> int:
    """Node count n with n(n-1)/2 == vec_len (12720 -> 160, 35778 -> 268);
    inferring it from the row length lets reduced-size CSV sets run the
    same ingestion code."""
    n = int(round((1 + (1 + 8 * vec_len) ** 0.5) / 2))
    if n * (n - 1) // 2 != vec_len:
        raise ValueError(
            f"row length {vec_len} is not a strict-upper-triangle length")
    return n


_CSV_NAMES = ("lr_train.csv", "hr_train.csv", "lr_test.csv")


def _csv_fingerprint(data_dir: str) -> str:
    """Size + mtime fingerprint of the source CSVs: it invalidates the npz
    cache when a CSV is edited or replaced.

    A partial CSV set fails here with the missing files named:
    ``has_real_csvs`` triggers on ``lr_train.csv`` alone, and synthesizing
    silently next to real data would be worse."""
    missing = [n for n in _CSV_NAMES
               if not os.path.exists(os.path.join(data_dir, n))]
    if missing:
        raise FileNotFoundError(
            f"{data_dir} has lr_train.csv but is missing "
            f"{', '.join(missing)} — the Kaggle set needs all of "
            f"{', '.join(_CSV_NAMES)}")
    parts = []
    for name in _CSV_NAMES:
        st = os.stat(os.path.join(data_dir, name))
        parts.append(f"{name}:{st.st_size}:{int(st.st_mtime)}")
    return "|".join(parts)


def load_dataset(data_dir: str, cache: bool = True,
                 device=DEFAULT_DEVICE) -> Dict[str, np.ndarray]:
    """Load {lr_train, hr_train, lr_test} as dense stacked host arrays
    ((N, 160, 160), (N, 268, 268), (M, 160, 160) for the real files; the
    sizes come from the row lengths).

    Caches the arrays in ``<data_dir>/fcsr_cache.npz``, fingerprinted
    against the CSVs' size and mtime: a stale cache is regenerated, not
    served. On a cache miss the anti-vectorize runs on ``device``."""
    cache_path = os.path.join(data_dir, "fcsr_cache.npz")
    fp = _csv_fingerprint(data_dir)
    if cache and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            if "_fingerprint" in z.files and str(z["_fingerprint"]) == fp:
                return {k: z[k] for k in z.files if k != "_fingerprint"}
    dev = resolve_device(device)
    vecs = {name[:-4]: load_csv_vectors(os.path.join(data_dir, name))
            for name in _CSV_NAMES}
    lr_dim = matrix_size_for(vecs["lr_train"].shape[1])
    hr_dim = matrix_size_for(vecs["hr_train"].shape[1])
    if vecs["lr_test"].shape[1] != vecs["lr_train"].shape[1]:
        raise ValueError("lr_test.csv row length differs from lr_train.csv")
    out = {
        "lr_train": _to_matrices(vecs["lr_train"], lr_dim, dev),
        "hr_train": _to_matrices(vecs["hr_train"], hr_dim, dev),
        "lr_test": _to_matrices(vecs["lr_test"], lr_dim, dev),
    }
    if cache:
        try:
            np.savez_compressed(cache_path, _fingerprint=fp, **out)
        except OSError:
            pass
    return out


def write_kaggle_csvs(data: Dict[str, np.ndarray], out_dir: str,
                      nan_frac: float = 0.001, seed: int = 0) -> None:
    """Write a dataset dict as Kaggle-schema CSVs that ``load_dataset``
    ingests: one row per subject, a leading 1-based ``ID`` column, the
    strict upper triangle in ROW-MAJOR order, and a seeded sprinkle of NaN
    cells for the NaN -> 0 rule. The same files as the JAX package's
    ``write_kaggle_csvs`` writes for the same arguments."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    for name in _CSV_NAMES:
        mats = np.asarray(data[name[:-4]], dtype=np.float32)
        n = mats.shape[-1]
        iu = np.triu_indices(n, k=1)
        vecs = mats[:, iu[0], iu[1]].astype(np.float64)
        if nan_frac > 0:
            mask = rng.random(vecs.shape) < nan_frac
            vecs[mask] = np.nan
        header = "ID," + ",".join(f"v{j}" for j in range(vecs.shape[1]))
        ids = np.arange(1, len(vecs) + 1, dtype=np.float64)[:, None]
        np.savetxt(os.path.join(out_dir, name),
                   np.concatenate([ids, vecs], axis=1),
                   delimiter=",", header=header, comments="", fmt="%.9g")


def load_or_synthesize(data_dir: Optional[str] = None,
                       n_train: int = 167, n_test: int = 112,
                       seed: int = 42,
                       device=DEFAULT_DEVICE) -> Dict[str, np.ndarray]:
    """The Kaggle CSVs of ``data_dir`` when present (``load_dataset`` on
    ``device``), else the seeded teacher dataset ``{lr_train, hr_train,
    lr_test}``, cached as
    ``<data_dir>/fcsr_synth2_teacher_<seed>_<n_train>_<n_test>.npz`` when
    ``data_dir`` is given (the same file the JAX package writes). Only the
    CSV branch touches ``device``."""
    if has_real_csvs(data_dir):
        return load_dataset(data_dir, device=device)

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
