"""Checkpoints as ``.npz`` archives of plain numpy arrays (no pickle).

Counterpart of ``fcsr_tpu/iox/checkpoint.py``, whose files are flax
msgpack; the port writes its own format:

* a model *state*: the reference's ``state_dict`` names
  (``layer.weights``, ``net.start_gcn.proj.weight``, ...) -> float32
  arrays;
* a trainer *resume blob*: the flat fold-batched ``p``, ``m``, ``v``, the
  per-fold step counts ``t``, ``epoch``, the run ``fingerprint``, both
  histories, and the leaf dims ``lr_dim``, ``hr_dim``, ``n_levels`` that
  make the file self-describing (``train/fast_loop.py`` writes and reads
  it).

Every write goes to a temporary file and is installed by an atomic
replace, so an interrupted write never leaves a partial checkpoint.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np

__all__ = ["save_arrays", "load_arrays", "save_state", "load_state",
           "load_params"]


def save_arrays(path: str, **arrays) -> None:
    """Atomically write ``arrays`` as one npz archive at ``path``."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def save_state(state: Mapping[str, object], path: str) -> None:
    """Write a model state (``state_dict`` names -> tensors or arrays)."""
    save_arrays(path, **{
        k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                      dtype=np.float32)
        for k, v in state.items()})


def load_state(path: str) -> Dict[str, np.ndarray]:
    """Read a model state written by ``save_state``."""
    state = load_arrays(path)
    if "layer.weights" not in state:
        raise ValueError(f"{path} holds no GSR-Net state (no layer.weights)")
    return state


def load_params(path: str) -> Dict[str, np.ndarray]:
    """A model state from either kind of file: a state archive as it is,
    or the LAST fold's parameters of a trainer resume blob (the fold whose
    model the pipeline predicts the test set with)."""
    from fcsr_tpu_torch.iox.weights import flat_to_state
    from fcsr_tpu_torch.models.fused_step import FlatLayout

    blob = load_arrays(path)
    if "fingerprint" not in blob:
        return load_state(path)
    layout = FlatLayout(int(blob["lr_dim"]), int(blob["hr_dim"]),
                        int(blob["n_levels"]))
    return flat_to_state(blob["p"][-1], layout.shapes)
