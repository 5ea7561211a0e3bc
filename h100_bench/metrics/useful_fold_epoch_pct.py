"""GAT's fold-epochs in which a fold still trained, as a share of those
run: a fold that has stopped runs masked to the end of its control chunk
(the program's counters ``fold_epochs_active``, ``fold_epochs_run``,
summed over the window's runs)."""

from h100_bench.program_runs import window


def read(ctx):
    runs = window(ctx)
    if runs is None or any("fold_epochs_run" not in r["counters"]
                           for r in runs):
        return None
    ran = sum(r["counters"]["fold_epochs_run"] for r in runs)
    active = sum(r["counters"]["fold_epochs_active"] for r in runs)
    return 100.0 * active / ran if ran else None
