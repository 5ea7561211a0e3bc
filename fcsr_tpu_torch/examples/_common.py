"""Shared set-up of the example drivers: the ``--device`` option, the
kernels built up front on the card (the JAX scripts set a persistent XLA
compile cache instead; the port keeps built kernels under
``build/fcsr_tpu_torch/``), and the loss curve."""

from __future__ import annotations

import sys

from fcsr_tpu_torch.cli import _add_device as add_device

__all__ = ["add_device", "setup_runtime", "save_loss_png"]


def setup_runtime(device):
    """The resolved device; on the card, every kernel library built (or
    found built) before the run starts, so a build failure shows first."""
    from fcsr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from fcsr_tpu_torch.kernels.build import build_all
        build_all()
    return dev


def save_loss_png(train_hist, path: str, val_hist=None,
                  title: str = "training loss") -> bool:
    """``loss.png`` through ``evalx.plots.save_loss_curve``; where
    matplotlib is not installed, a note on stderr instead (the run's other
    artifacts are written all the same). Returns whether it was written."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"note: {path} not written: matplotlib is not installed",
              file=sys.stderr)
        return False
    from fcsr_tpu_torch.evalx.plots import save_loss_curve
    save_loss_curve(train_hist, path, val_hist=val_hist, title=title)
    return True
