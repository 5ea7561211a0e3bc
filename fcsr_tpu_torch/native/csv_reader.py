"""ctypes binding of the native CSV parser (``fast_csv.cpp``).

The shared library is built with ``g++`` at first use into
``<cache root>/native_<source hash>/`` (``kernels/build.py::cache_root``:
``build/fcsr_tpu_torch/`` at the repository root by default, the
directory the CUDA kernels build into as well), never beside the source.
Callers guard with ``fast_csv_available()`` and take the numpy parser of
``data/io.py`` when there is no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["fast_csv_available", "read_csv_float32"]

_SRC = Path(__file__).resolve().with_name("fast_csv.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> Path:
    """The library's path; the directory name embeds the source's hash, so
    an edited source rebuilds instead of loading a stale binary."""
    from fcsr_tpu_torch.kernels.build import cache_root
    tag = hashlib.blake2b(_SRC.read_bytes(), digest_size=8).hexdigest()
    return cache_root() / f"native_{tag}" / "libfcsr_csv.so"


def _build(lib_path: Path) -> bool:
    # generic -O3 (no -march=native): the parser is strtod / memory bound
    tmp = lib_path.with_name(f"{lib_path.name}.tmp{os.getpid()}")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(_SRC), "-o", str(tmp)]
    try:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.fcsr_csv_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.fcsr_csv_dims.restype = ctypes.c_int
        lib.fcsr_csv_read.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64]
        lib.fcsr_csv_read.restype = ctypes.c_int
        _lib = lib
        return _lib


def fast_csv_available() -> bool:
    """True iff the native parser is built (building it now if needed)."""
    return _load() is not None


def read_csv_float32(path: str, skip_first_col: bool) -> np.ndarray:
    """Parse a numeric CSV (header row dropped) into (rows, cols) float32;
    NaN and empty fields become 0. Raises RuntimeError if the native
    library is unavailable or parsing fails."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native CSV library unavailable")
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.fcsr_csv_dims(os.fsencode(path), int(skip_first_col),
                           ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise RuntimeError(f"fcsr_csv_dims failed ({rc}) for {path}")
    out = np.empty((rows.value, cols.value), dtype=np.float32)
    rc = lib.fcsr_csv_read(os.fsencode(path), int(skip_first_col),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           rows.value, cols.value)
    if rc != 0:
        raise RuntimeError(f"fcsr_csv_read failed ({rc}) for {path}")
    return out
