"""Where the port keeps what it builds (counterpart of
``fcsr_tpu/utils/compile_cache.py``, which points JAX at a persistent XLA
compilation cache).

The port's warm start is its build cache: the CUDA kernels
(``kernels/build.py``, one library per source, keyed by the sources'
hash) and the CSV parser (``native/csv_reader.py``) are compiled once
and loaded by later processes from ``build/fcsr_tpu_torch/`` at the
repository root. ``enable_persistent_cache`` names that directory, or
another, as the JAX function names its cache:

* ``FCSR_KERNEL_CACHE_DIR``: another cache root (the counterpart of
  ``JAX_COMPILATION_CACHE_DIR``);
* ``FCSR_NO_COMPILE_CACHE=1``: no cache, every process builds into a
  fresh directory of its own (to measure a first build).

Call it before the first kernel launch: a library already loaded stays
loaded from where it was built.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["enable_persistent_cache"]


def enable_persistent_cache(cache_dir: Optional[str] = None
                            ) -> Optional[str]:
    """Point the build at ``cache_dir`` (else ``FCSR_KERNEL_CACHE_DIR``,
    else the repository's ``build/fcsr_tpu_torch``) and return it, made;
    ``None`` with ``FCSR_NO_COMPILE_CACHE=1``, where nothing is reused.
    Idempotent."""
    from fcsr_tpu_torch.kernels import build
    if os.environ.get("FCSR_NO_COMPILE_CACHE") == "1":
        return None
    if cache_dir is not None:
        build.CACHE_ROOT = str(cache_dir)
    root = build.cache_root()
    root.mkdir(parents=True, exist_ok=True)
    return str(root)
