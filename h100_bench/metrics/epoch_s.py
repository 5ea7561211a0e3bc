"""Median seconds of a training epoch on the device's clock: between the
program's timing events at consecutive epoch boundaries (on several
devices the slowest one's), over every epoch of the window's runs. An
epoch's interval includes the card's waits on the host inside it (a
graph's launch)."""

import statistics

from h100_bench.program_runs import epoch_seconds


def read(ctx):
    epochs = epoch_seconds(ctx)
    return statistics.median(epochs) if epochs else None
