"""Bounded liveness probe of the card (counterpart of
``fcsr_tpu/utils/probe.py``).

A long run (a bench, a sweep) calls ``require_live_device()`` first, so a
card that does not answer becomes a quick exit that names it instead of a
hang: one tiny product and a synchronize on a thread, waited for in 30 s
slices with a heartbeat on stderr, within ``FCSR_BENCH_PROBE_TIMEOUT``
seconds (120 by default).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import torch

__all__ = ["require_live_device"]


def _probe_op(device) -> None:
    x = torch.ones(64, 64, device=device)
    (x @ x).sum().item()                       # waits for the device


def _card_name(device) -> str:
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True,
            timeout=5)
        name = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        name = ""
    return f"{device} ({name})" if name else str(device)


def require_live_device(timeout_s: float = None, device="cuda") -> str:
    """Block until one operation on ``device`` completes and return the
    card's name; ``SystemExit`` naming the card if it does not within
    ``timeout_s`` (``FCSR_BENCH_PROBE_TIMEOUT``, 120 s by default), or if
    the operation fails. Waits on the one probe the whole time: a card
    that recovers completes it."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("FCSR_BENCH_PROBE_TIMEOUT", "120"))
    done, failed = threading.Event(), []

    def probe():
        try:
            _probe_op(device)
        except Exception as e:                 # reported by the caller
            failed.append(e)
        done.set()

    threading.Thread(target=probe, daemon=True).start()
    t0 = time.monotonic()
    while not done.wait(timeout=min(30.0, timeout_s)):
        waited = time.monotonic() - t0
        if waited >= timeout_s:
            raise SystemExit(
                f"device probe on {_card_name(device)} did not complete "
                f"within {timeout_s:g} s: the card does not answer")
        print(f"[probe] device op still pending after {waited:.0f} s "
              f"(waiting up to {timeout_s:g} s)...", file=sys.stderr,
              flush=True)
    if failed:
        raise SystemExit(f"device probe on {_card_name(device)} failed: "
                         f"{failed[0]}")
    return _card_name(device)
