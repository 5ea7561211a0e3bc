"""Checkpoints as ``.npz`` archives of plain numpy arrays (no pickle), and
the JAX package's flax msgpack files.

Counterpart of ``fcsr_tpu/iox/checkpoint.py``, whose files are flax
msgpack: ``save_pytree`` / ``load_pytree`` write and read those (the
port's own coder, ``iox/msgpack.py``). The port's own files are npz:

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
           "load_params", "save_pytree", "load_pytree", "is_msgpack"]


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def save_arrays(path: str, **arrays) -> None:
    """Atomically write ``arrays`` as one npz archive at ``path``."""
    _atomic_write(path, lambda f: np.savez(f, **arrays))


def save_pytree(tree, path: str) -> None:
    """Atomically write ``tree`` (dicts, lists, scalars, numpy arrays or
    tensors) as the JAX package's ``save_pytree`` does: flax's
    ``to_bytes`` bytes, which ``fcsr_tpu.iox.load_pytree`` reads."""
    from fcsr_tpu_torch.iox.msgpack import pack_pieces, to_state_dict
    pieces = pack_pieces(to_state_dict(tree), in_place=True)
    _atomic_write(path, lambda f: f.writelines(pieces))


def load_pytree(path: str):
    """The tree of a flax msgpack file (flax's ``msgpack_restore``: nested
    dicts of numpy arrays; lists and tuples come back as ``{"0": ...}``
    dicts, since no template restores them)."""
    from fcsr_tpu_torch.iox.msgpack import msgpack_restore
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def is_msgpack(path: str) -> bool:
    """Whether ``path`` holds msgpack (a map header: fixmap, map16 or
    map32) rather than an npz archive (a zip, ``PK\\x03\\x04``)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return False
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return True
    raise ValueError(f"{path} is neither an npz archive nor a flax msgpack "
                     "file")


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
    """A GSR-Net state from any of three kinds of file: the JAX package's
    flax msgpack variables (as its ``train gsr`` and examples write them),
    a state archive as it is, or the LAST fold's parameters of a trainer
    resume blob (the fold whose model the pipeline predicts the test set
    with)."""
    from fcsr_tpu_torch.iox.weights import flat_to_state, flax_to_state
    from fcsr_tpu_torch.models.fused_step import FlatLayout

    if is_msgpack(path):
        tree = load_pytree(path)
        params = tree.get("params") if isinstance(tree, dict) else None
        if not isinstance(params, dict) or "layer" not in params:
            raise ValueError(f"{path} holds no GSR-Net variables (no "
                             "params/layer)")
        return flax_to_state(tree)
    blob = load_arrays(path)
    if "fingerprint" not in blob:
        return load_state(path)
    layout = FlatLayout(int(blob["lr_dim"]), int(blob["hr_dim"]),
                        int(blob["n_levels"]))
    return flat_to_state(blob["p"][-1], layout.shapes)
