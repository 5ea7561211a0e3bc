"""Structured training observability. Counterpart of
``fcsr_tpu/utils/logging.py``.

The reference logs via print/tqdm postfix and ad-hoc JSON dumps
(SURVEY §5). ``MetricLogger`` appends one JSON object per event to a
``.jsonl`` file (cheap, greppable, plottable) and mirrors to stdout when
verbose.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["MetricLogger"]


class MetricLogger:
    """One JSON record per ``log(event, **fields)``: ``event``, ``t`` (s
    since the logger was made) and the fields. A field with ``.item()``
    (a tensor, a numpy scalar) is written as a float: for a tensor on the
    card that read waits for the card to finish the work queued before it,
    so log outside the hot loop or pass host numbers."""

    def __init__(self, path: Optional[str] = None, verbose: bool = False):
        self.path = path
        self.verbose = verbose
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # truncate previous run
            open(path, "w").close()

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.time() - self._t0, 3),
               **{k: (float(v) if hasattr(v, "item") else v)
                  for k, v in fields.items()}}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.verbose:
            print(json.dumps(rec))
        return rec
