"""Symmetric-matrix <-> upper-triangular-vector transforms (torch).

Counterpart of ``fcsr_tpu/core/vectorize.py``. The reference pipeline uses
three orderings of the strict upper triangle, and submission correctness
depends on pairing them exactly as it does:

  1. *column-major* ``vectorize``: columns in order, within each column the
     rows above the diagonal (pairs sorted by ``(col, row)``). With
     ``include_diagonal`` the first sub-diagonal element ``(col+1, col)``
     follows each column's block.
  2. *row-major* ``anti_vectorize``: ``triu_indices`` order (pairs sorted by
     ``(row, col)``). 1. and 2. are NOT inverses of each other: the
     challenge CSVs are read row-major and the submissions written
     column-major, on purpose.
  3. *row-major flatten* ``vectorize_rowmajor``: the GSR notebook's
     submission order.

The index maps are numpy arrays built once per size; the transforms are
torch gathers and scatters on whatever device the input lies on, and
accept array-likes as well as tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["vec_len", "triu_indices_colmajor", "triu_indices_rowmajor",
           "vectorize", "vectorize_rowmajor", "anti_vectorize",
           "vectorize_batch", "anti_vectorize_batch", "MatrixVectorizer"]


def vec_len(n: int, include_diagonal: bool = False,
            ordering: str = "rowmajor") -> int:
    """Length of the vectorized form of an n x n symmetric matrix. With
    ``include_diagonal`` the orderings differ: column-major interleaves one
    sub-diagonal element per column but the last (n - 1 extras), row-major
    appends all n diagonal entries."""
    base = n * (n - 1) // 2
    if not include_diagonal:
        return base
    if ordering == "colmajor":
        return base + n - 1
    if ordering == "rowmajor":
        return base + n
    raise ValueError(f"unknown ordering {ordering!r}")


@functools.lru_cache(maxsize=None)
def triu_indices_colmajor(n: int, include_diagonal: bool = False):
    """(rows, cols) int32 of the strict upper triangle in column-major
    order; with ``include_diagonal`` the pair ``(col+1, col)`` follows each
    column's block."""
    rows, cols = [], []
    for col in range(n):
        rows.extend(range(col))
        cols.extend([col] * col)
        if include_diagonal and col + 1 < n:
            rows.append(col + 1)
            cols.append(col)
    return np.asarray(rows, dtype=np.int32), np.asarray(cols, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def triu_indices_rowmajor(n: int):
    """(rows, cols) int32 of the strict upper triangle in ``triu_indices``
    order."""
    r, c = np.triu_indices(n, k=1)
    return r.astype(np.int32), c.astype(np.int32)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def vectorize_batch(matrices, include_diagonal: bool = False):
    """(..., n, n) -> (..., L) column-major vectorize as one gather."""
    matrices = _tensor(matrices)
    rows, cols = triu_indices_colmajor(matrices.shape[-1], include_diagonal)
    return matrices[..., _index(rows, matrices.device),
                    _index(cols, matrices.device)]


def vectorize(matrix, include_diagonal: bool = False):
    """Column-major vectorize of one symmetric matrix -> 1-D tensor."""
    return vectorize_batch(matrix, include_diagonal)


def vectorize_rowmajor(matrix, include_diagonal: bool = False):
    """Row-major (``triu_indices``) flatten; ``include_diagonal`` appends
    the n diagonal entries."""
    matrix = _tensor(matrix)
    rows, cols = triu_indices_rowmajor(matrix.shape[-1])
    v = matrix[..., _index(rows, matrix.device), _index(cols, matrix.device)]
    if include_diagonal:
        v = torch.cat([v, torch.diagonal(matrix, dim1=-2, dim2=-1)], dim=-1)
    return v


def anti_vectorize_batch(vectors, matrix_size: int,
                         include_diagonal: bool = False):
    """(..., L) -> (..., n, n) symmetric matrices via one scatter and a
    transpose. Trailing entries beyond the required length are ignored;
    with ``include_diagonal`` entries m .. m + n - 1 fill the diagonal."""
    vectors = _tensor(vectors)
    n = matrix_size
    rows, cols = triu_indices_rowmajor(n)
    m = n * (n - 1) // 2
    out = vectors.new_zeros(vectors.shape[:-1] + (n, n))
    out[..., _index(rows, vectors.device),
        _index(cols, vectors.device)] = vectors[..., :m]
    out = out + out.transpose(-1, -2)
    if include_diagonal:
        didx = torch.arange(n, device=vectors.device)
        out[..., didx, didx] = vectors[..., m:m + n]
    return out


def anti_vectorize(vector, matrix_size: int, include_diagonal: bool = False):
    """Row-major anti-vectorize: 1-D vector -> symmetric matrix, zero
    diagonal unless ``include_diagonal``."""
    return anti_vectorize_batch(_tensor(vector)[None], matrix_size,
                                include_diagonal)[0]


class MatrixVectorizer:
    """The reference class's surface over the functional transforms; takes
    and returns numpy arrays."""

    @staticmethod
    def vectorize(matrix, include_diagonal: bool = False):
        return vectorize(matrix, include_diagonal).cpu().numpy()

    @staticmethod
    def anti_vectorize(vector, matrix_size: int,
                       include_diagonal: bool = False):
        return anti_vectorize(np.asarray(vector, dtype=np.float32),
                              matrix_size, include_diagonal).cpu().numpy()
