"""Device-resident ingestion pipeline.

Counterpart of ``fcsr_tpu/data/device_pipeline.py``: CSV (native parser)
-> transfer of the RAW VECTORS (half the bytes of dense matrices) ->
``anti_vectorize_normalize`` materializes the dense stacks on the card,
the LR stacks degree-normalized in the same launch when asked. The host
path (``data/io.py``) remains for what feeds host LAPACK.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from fcsr_tpu_torch.core.triu_kernels import anti_vectorize_normalize
from fcsr_tpu_torch.data.io import load_csv_vectors, matrix_size_for
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["ingest_vectors_to_device", "load_dataset_device"]


def ingest_vectors_to_device(vectors: np.ndarray, n: int,
                             normalize: bool = False,
                             device=DEFAULT_DEVICE) -> torch.Tensor:
    """(B, V) host vectors -> (B, n, n) dense stacks on ``device``; only
    the vectors cross the host-device link."""
    staged = torch.from_numpy(
        np.ascontiguousarray(vectors, dtype=np.float32)).to(
            resolve_device(device))
    return anti_vectorize_normalize(staged, n, normalize=normalize)


def load_dataset_device(data_dir: str, normalize_lr: bool = False,
                        device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """Kaggle CSVs -> {lr_train, hr_train, lr_test} as tensors on
    ``device``; with ``normalize_lr`` the LR stacks come out
    degree-normalized (what GSRNet consumes), in the same kernel pass."""
    dev = resolve_device(device)
    out = {}
    for name, norm in (("lr_train", normalize_lr), ("hr_train", False),
                       ("lr_test", normalize_lr)):
        vecs = load_csv_vectors(os.path.join(data_dir, f"{name}.csv"))
        out[name] = ingest_vectors_to_device(
            vecs, matrix_size_for(vecs.shape[1]), normalize=norm, device=dev)
    return out
