"""Readings for the limits of ``correct`` (see ``PERF.md``): runs of a
cell through the harness's own ``run_cell`` (set-up, warm-up, a window of
one CV run, the check), all in one process; sound runs, the
configuration's control and the planted faults. Prints one JSON line per
run.

    python3 h100_bench/readings.py --workload gsr_net.cv3 --seeds 1,2,3 \\
        [--control bf16 --control-seeds 7,8,9] \\
        [--faults frozen_step,half_batch,altered_answer --fault-seeds 4,5,6]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench import harness  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal on the program's plain paths")
    args = ap.parse_args(argv)
    cell, cfg, mix, manifest = harness.load_cell(args.workload)
    plan = [(s, None, None) for s in _seeds(args.seeds)]
    plan += [(s, args.control, None) for s in _seeds(args.control_seeds)]
    plan += [(s, None, f) for f in args.faults.split(",") if f
             for s in _seeds(args.fault_seeds)]
    for seed, control, fault in plan:
        t0 = time.perf_counter()
        try:
            result, lines = harness.run_cell(
                cell, cfg, mix, manifest, seed, 0.0, 0, t0,
                device=args.device, control=control, fault=fault,
                min_runs=1)
        except SystemExit as e:
            print(f"readings: {e}", file=sys.stderr)
            return 2
        notes = [json.loads(x[len("notes "):]) for x in lines
                 if x.startswith("notes ")]
        line = json.dumps({
            "workload": args.workload, "seed": seed, "control": control,
            "fault": fault, "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "notes": notes[0] if notes else None,
            "values": {k: v["value"] for k, v in result["checks"].items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
