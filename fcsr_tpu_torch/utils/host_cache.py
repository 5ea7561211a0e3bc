"""Disk cache for host-LAPACK preprocessing artifacts (the GSR spectral
bases). They are pure functions of the dataset content, so a fresh process
reads one npz instead of redoing the batched ``eigh``.

Keys are content hashes (blake2b over shape + dtype + bytes). Disable with
``FCSR_NO_SPECTRAL_CACHE=1``, relocate with ``FCSR_SPECTRAL_CACHE_DIR``
(default ``~/.cache/fcsr_spectral``). The same file layout as the JAX
package's cache, so the two share hits.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

__all__ = ["cache_path", "load", "save"]


def cache_path(kind: str, arrays, extra=()):
    """Cache file path for artifact ``kind`` keyed by the CONTENT of
    ``arrays`` plus the hashable config tuple ``extra`` — or None when
    caching is disabled or the cache dir cannot be created."""
    if os.environ.get("FCSR_NO_SPECTRAL_CACHE") == "1":
        return None
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(memoryview(a).cast("B"))
    h.update(repr(tuple(extra)).encode())
    root = os.environ.get(
        "FCSR_SPECTRAL_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "fcsr_spectral"))
    try:
        os.makedirs(root, exist_ok=True)
    except OSError:
        return None
    return os.path.join(root, f"{kind}_{h.hexdigest()}.npz")


def load(path, names):
    """Tuple of the named arrays from ``path``, or None on any miss
    (no path, missing file, unreadable/partial file — recompute then)."""
    if path is None or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return tuple(z[n] for n in names)
    except (OSError, KeyError, ValueError):
        return None


def save(path, **arrays):
    """Atomically install ``arrays`` at ``path`` (best-effort: a failed
    write just means the next process recomputes)."""
    if path is None:
        return
    # np.savez appends .npz to names that lack it; a per-writer tmp name
    # keeps two processes from installing each other's partial write
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError:
        pass
