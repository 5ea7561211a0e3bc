"""The epochs' share of the window's CV runs: the sum of every epoch's
seconds between its boundary events (``epoch_s``) over the sum of the
runs' ``cv_run`` seconds. A share of epoch wall time on the device's
clock, not of device busy time: the card's waits inside an epoch count
as epoch."""

from h100_bench.program_runs import epoch_seconds, window


def read(ctx):
    epochs, runs = epoch_seconds(ctx), window(ctx)
    if not epochs or not runs:
        return None
    return 100.0 * sum(epochs) / sum(r["phases"]["cv_run"] for r in runs)
