"""Kaggle submission writer.

Counterpart of ``fcsr_tpu/iox/submission.py``. Two vectorization orderings
coexist in the reference and give different CSVs; pick the one the
consuming pipeline expects:

  * ``ordering="colmajor"`` — ``MatrixVectorizer.vectorize`` order (the
    MLP / GAT paths). For predictions on the card this is the
    ``vectorize_colmajor`` kernel, and only the (B, L) vectors come to the
    host.
  * ``ordering="rowmajor"`` — the ``triu_indices`` flatten of the GSR
    notebook, a torch gather (``core.vectorize.vectorize_rowmajor``).

The file is ``ID,Predicted`` with IDs from 1, written without pandas;
values carry 9 significant digits, which parse back to the same float32.
As pandas' ``to_csv`` (the JAX package's writer), a NaN is an empty field
and ±inf is ``inf`` / ``-inf``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from fcsr_tpu_torch.core.triu_kernels import vectorize_colmajor
from fcsr_tpu_torch.core.vectorize import vectorize_rowmajor

__all__ = ["submission_frame", "save_prediction", "kaggle_submit",
           "DEFAULT_COMPETITION"]

# the challenge both entry notebooks of the reference submit to
DEFAULT_COMPETITION = "dgl-2025-brain-graph-super-resolution-challenge"

_ROWS_PER_WRITE = 1 << 18


def _vectorize(preds, ordering: str) -> np.ndarray:
    if not isinstance(preds, torch.Tensor):
        preds = torch.from_numpy(np.asarray(preds, dtype=np.float32))
    if ordering == "colmajor":
        return vectorize_colmajor(preds).cpu().numpy()
    if ordering == "rowmajor":
        return vectorize_rowmajor(preds).cpu().numpy()
    raise ValueError(f"unknown ordering: {ordering}")


def submission_frame(preds, ordering: str = "colmajor"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, n, n) predictions (tensor on any device, or array) -> the two
    columns of the submission: 1-based int64 ``ID`` and float32
    ``Predicted``, subject after subject."""
    flat = _vectorize(preds, ordering).astype(np.float32).reshape(-1)
    return np.arange(1, len(flat) + 1, dtype=np.int64), flat


def save_prediction(preds, output_file: str, ordering: str = "colmajor"
                    ) -> np.ndarray:
    """Write the submission CSV (atomically); returns the flattened
    prediction vector."""
    ids, flat = submission_frame(preds, ordering)
    tmp = f"{output_file}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("ID,Predicted\n")
        for s in range(0, len(flat), _ROWS_PER_WRITE):
            vals = flat[s:s + _ROWS_PER_WRITE].tolist()
            f.write("".join([f"{i},{v:.9g}\n" if v == v else f"{i},\n"
                             for i, v in enumerate(vals, s + 1)]))
    os.replace(tmp, output_file)
    return flat


def kaggle_submit(csv_path: str, message: str,
                  competition: str = DEFAULT_COMPETITION,
                  dry_run: bool = False) -> int:
    """Submit a written CSV to the Kaggle challenge through the ``kaggle``
    command-line tool, which needs ``~/.kaggle/kaggle.json`` on the host.
    ``dry_run=True`` (or a missing tool) prints the exact command instead,
    to be run where the credentials live. Returns the tool's exit code (0
    on success or dry run)."""
    import shlex
    import shutil
    import subprocess

    cmd = ["kaggle", "competitions", "submit", "-c", competition,
           "-f", csv_path, "-m", message]
    if dry_run or shutil.which("kaggle") is None:
        print("kaggle CLI not invoked"
              + (" (dry run)" if dry_run else " (CLI not installed)")
              + "; run:\n  " + shlex.join(cmd))
        return 0
    return subprocess.call(cmd)
