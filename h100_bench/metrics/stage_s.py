"""Seconds a CV run spends staging (the program's span ``stage``: the
trainer's construction, host precompute, uploads, weights), averaged over
the window's runs."""

from h100_bench.program_runs import mean_phase


def read(ctx):
    return mean_phase(ctx, "stage")
