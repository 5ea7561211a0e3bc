"""Seconds a CV run spends making its CUDA graphs, by the program's own
spans: each run's ``capture`` spans (an ``EpochGraph``'s warm-up, capture
and instantiation) summed, averaged over the window's runs. Nothing where
a run made no graph (off the card) or the program keeps no records."""

from h100_bench.program_runs import mean_phase


def read(ctx):
    return mean_phase(ctx, "capture")
