"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` compiles on its own into a shared library with a plain
C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``),
all sources at once in parallel, into ``<cache root>/<key>/``: the root is
``build/fcsr_tpu_torch/`` at the repository root unless
``FCSR_KERNEL_CACHE_DIR`` or ``utils.compile_cache.enable_persistent_cache``
names another, and a fresh directory of this process's own with
``FCSR_NO_COMPILE_CACHE=1`` (nothing reused). ``<key>`` hashes the sources
and the flags, so an edited source rebuilds and an unchanged one loads
what is there. Nothing is built at import time: the first kernel launch
builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "build_dir", "cache_root", "load_library", "build_all",
           "BUILD_INFO"]

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("bgemm", "bgemm_bf16", "rank_select", "tail", "adam", "triu",
           "gat")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# filled by build_all: per-source ptxas reports (chip_smoke.py writes
# them to ptxas.log)
BUILD_INFO: Dict[str, object] = {}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _key() -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()


# the cache root set by utils.compile_cache.enable_persistent_cache
CACHE_ROOT = None
_FRESH = {}


def cache_root() -> Path:
    """Where built libraries are kept: a fresh directory of this process
    under ``build/fcsr_tpu_torch/nocache/`` with ``FCSR_NO_COMPILE_CACHE=1``,
    else ``CACHE_ROOT``, ``FCSR_KERNEL_CACHE_DIR`` or
    ``<repo>/build/fcsr_tpu_torch``, the first that is set."""
    default = CSRC.parents[2] / "build" / "fcsr_tpu_torch"
    if os.environ.get("FCSR_NO_COMPILE_CACHE") == "1":
        if os.getpid() not in _FRESH:
            _FRESH[os.getpid()] = default / "nocache" / (
                f"{os.getpid()}-{time.time_ns()}")
        return _FRESH[os.getpid()]
    root = CACHE_ROOT or os.environ.get("FCSR_KERNEL_CACHE_DIR")
    return Path(root) if root else default


def build_dir() -> Path:
    """``<cache root>/<source hash>``."""
    return cache_root() / _key()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from fcsr_tpu_torch/kernels/csrc at first use")
    return nvcc


def build_all() -> Dict[str, Path]:
    """Compile every missing library, all sources in parallel; returns the
    library paths by source name. Raises with nvcc's output on failure."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"libfcsr_{name}.so" for name in SOURCES}
    todo = [name for name, path in libs.items() if not path.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"libfcsr_{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    reports = {}
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (rc {proc.returncode})\n{log}")
            continue
        os.replace(tmp, libs[name])
    BUILD_INFO["ptxas"] = reports
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return libs


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of source ``name``, building all sources first if
    any library is missing."""
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            for src, path in paths.items():
                if src not in _LIBS:
                    lib = ctypes.CDLL(str(path))
                    lib.fcsr_error_string.argtypes = [ctypes.c_int]
                    lib.fcsr_error_string.restype = ctypes.c_char_p
                    _LIBS[src] = lib
        return _LIBS[name]
