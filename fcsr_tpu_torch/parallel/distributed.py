"""Multi-process bootstrap over ``torch.distributed``. Counterpart of
``fcsr_tpu/parallel/distributed.py``.

One machine needs nothing beyond the ``('batch',)`` mesh of its cards
(``parallel/mesh.py``). Several processes (several hosts, or one process
per card) join one process group: each loads its own shard of the
subjects (``host_shard_slice``), and the data-parallel steps sum their
mesh gradients across the group with ``all_reduce``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["maybe_initialize_distributed", "host_shard_slice",
           "group_size", "group_rank"]


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device=DEFAULT_DEVICE) -> bool:
    """Join a process group when multi-process arguments or env are
    present; a no-op (returns False) for a single-process run. Env
    fallbacks: ``FCSR_COORDINATOR`` (``host:port`` of rank 0),
    ``FCSR_NUM_PROCESSES``, ``FCSR_PROCESS_ID`` (default 0); or
    ``FCSR_DISTRIBUTED=1``, which reads the group from the environment
    ``torchrun`` sets (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``). The backend is ``nccl`` for the card and
    ``gloo`` when ``device`` is the CPU."""
    coordinator = coordinator or os.environ.get("FCSR_COORDINATOR")
    num_processes = num_processes or _env_int("FCSR_NUM_PROCESSES")
    process_id = process_id if process_id is not None \
        else _env_int("FCSR_PROCESS_ID")
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"

    if coordinator and num_processes:
        dist.init_process_group(backend=backend,
                                init_method=f"tcp://{coordinator}",
                                world_size=num_processes,
                                rank=process_id or 0)
        return True
    if os.environ.get("FCSR_DISTRIBUTED") == "1":
        dist.init_process_group(backend=backend, init_method="env://")
        return True
    return False


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def group_size() -> int:
    """Processes in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def group_rank() -> int:
    """This process's rank in the process group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def host_shard_slice(n: int) -> slice:
    """This process's contiguous slice of an n-sample dataset: each
    process loads only its shard, and the cards of its mesh split that."""
    pid, count = group_rank(), group_size()
    per = -(-n // count)
    lo = min(pid * per, n)
    hi = min(lo + per, n)
    return slice(lo, hi)
