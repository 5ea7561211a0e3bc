"""The program's own records of the window's CV runs
(``fcsr_tpu_torch/utils/profiling.py::recent_runs``: each run's span
seconds, counters and epochs' device seconds), for the readers of its
spans and counters (``metrics/*.py`` of source ``program_span``)."""

import statistics


def window(ctx):
    """The last ``len(ctx.runs)`` records: the window's runs, after the
    warm-up run's record (neither the profiled slice nor the check goes
    through a pipeline entry). None where fewer than ``len(ctx.runs) + 1``
    records exist, or the program keeps none."""
    from fcsr_tpu_torch.utils import profiling
    recent = getattr(profiling, "recent_runs", None)
    n = len(ctx.runs)
    if recent is None or not n:
        return None
    runs = recent()
    return runs[-n:] if len(runs) >= n + 1 else None


def mean_phase(ctx, name):
    """The mean seconds of the phase ``name`` a run of the window."""
    runs = window(ctx)
    if runs is None or any(name not in r["phases"] for r in runs):
        return None
    return statistics.mean(r["phases"][name] for r in runs)


def epoch_seconds(ctx):
    """Every epoch's device seconds over the window's runs, or None."""
    runs = window(ctx)
    if runs is None:
        return None
    return [s for r in runs for s in r["epoch_s"]] or None


READERS = ("stage_s", "test_predict_s", "epoch_s", "train_busy_pct",
           "useful_fold_epoch_pct")


def main(argv):
    """One traced run of a cell (``harness.run_cell``), then what the
    readers of the program's records give in its window, and how those
    records agree with the harness's own clocks: the result line, then a
    line ``{"program_runs": ...}``.

        python3 h100_bench/program_runs.py --workload gsr_net.cv3 \\
            --seed 2718281829 [--seconds 50]
    """
    import argparse
    import json
    import sys
    import time

    from h100_bench import harness
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seen = {}
    real = harness._metric_reader

    def reader(name):
        read = real(name)

        def keep(ctx):
            seen["ctx"] = ctx
            return read(ctx)
        return keep
    harness._metric_reader = reader
    cell, cfg, mix, manifest = harness.load_cell(args.workload)
    result, _ = harness.run_cell(cell, cfg, mix, manifest, args.seed,
                                 args.seconds, 1, time.perf_counter(),
                                 device=args.device)
    print(json.dumps(result), flush=True)
    ctx = seen["ctx"]
    gat = cfg["family"] == "gat"
    values = {name + (".gat" if gat else ""): real(name)(ctx)
              for name in READERS if gat or name != "useful_fold_epoch_pct"}
    runs = window(ctx) or []
    kids = [sum(s["seconds"] for s in r["spans"] if s["parent"] == 0)
            / r["phases"]["cv_run"] for r in runs]
    spy = [sum(sum(g) for g in r.get("graphs", [])) for r in ctx.runs]
    capture = [r["phases"].get("capture", 0.0) for r in runs]
    print(json.dumps({"program_runs": values,
                      "phases_over_cv_run": kids,
                      "cv_run_mean_s": statistics.mean(
                          r["phases"]["cv_run"] for r in runs)
                      if runs else None,
                      "harness_cv_run_s": ctx.window_s / len(ctx.runs),
                      "capture_over_graph_spy": [
                          c / s - 1 if s else None
                          for c, s in zip(capture, spy)],
                      "epochs_timed": [len(r["epoch_s"]) for r in runs],
                      "phases_mean_s": {
                          k: statistics.mean(r["phases"].get(k, 0.0)
                                             for r in runs)
                          for k in (runs[0]["phases"] if runs else ())},
                      "counters": [r["counters"] for r in runs]}),
          flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
