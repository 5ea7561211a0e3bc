"""Seconds a CV run spends predicting the test set (the program's span
``test_predict``), averaged over the window's runs."""

from h100_bench.program_runs import mean_phase


def read(ctx):
    return mean_phase(ctx, "test_predict")
