"""The generic harness: one cell of ``BENCHMARK.json`` run once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell names a configuration (``configs/<config>.json``, whose
``family`` names ``families/<family>.py``) and a traffic mix
(``traffic/<mix>.json``); each per-layer metric is read by
``metrics/<metric>.py`` (a metric split by cells, ``<quantity>.<part>``,
falls back to ``metrics/<quantity>.py``). Set-up makes the inputs and the
initial weights from the seed and warms the cell's shapes; the window runs
whole CV runs back to back; then the program's outputs are compared with
the plain reference, and the last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fcsr_tpu")

__all__ = ["main", "load_cell", "forbidden_modules", "run_cell"]


def forbidden_modules():
    """Loaded modules whose top-level name, taken whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(workload):
    """(cell, configuration file, traffic mix, manifest) by name."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"({', '.join(sorted(cells))})")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, cfg, mix, manifest


def quantity(name):
    """What a metric measures: its name up to the first dot (``mfu.gat``
    is the GAT cells' ``mfu``)."""
    return name.split(".")[0]


# the end-to-end metrics, by quantity: the benchmark's own host clocks
END_TO_END = {"cv_run_s": lambda ctx: ctx.window_s / len(ctx.runs),
              "setup_s": lambda ctx: ctx.setup_s}


def cell_metrics(manifest, kind, cell):
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports
    (an entry without ``workloads``: every cell)."""
    return [m for m in manifest[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def _metric_reader(name):
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{quantity(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _cache_env():
    """Every cache of the program at a fixed path inside the checkout:
    the CUDA kernels' build and the host LAPACK results."""
    os.environ.setdefault("FCSR_KERNEL_CACHE_DIR",
                          str(ROOT / "build" / "fcsr_tpu_torch"))
    os.environ.setdefault("FCSR_SPECTRAL_CACHE_DIR",
                          str(ROOT / "build" / "h100_bench" / "host_cache"))


def _probe(device, timeout=120.0):
    """A card that does not answer fails fast instead of hanging: one
    small product waited for on a thread."""
    import torch
    done = threading.Event()

    def op():
        x = torch.ones(64, 64, device=device)
        (x @ x).sum().item()
        done.set()
    threading.Thread(target=op, daemon=True).start()
    if not done.wait(timeout):
        raise SystemExit(f"the card did not answer within {timeout:.0f} s")


class _GraphSpy:
    """Collects the (warm-up, capture, instantiate) seconds each CUDA
    graph the program makes counts for itself, by standing in for the
    program's ``EpochGraph`` in the trainer modules that make them."""

    def __init__(self):
        from fcsr_tpu_torch.train import epoch_graph, fast_loop, gat_loop
        self.made = []
        spy = self

        class Recorded(epoch_graph.EpochGraph):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                spy.made.append((self.warm_s, self.capture_s,
                                 self.instantiate_s))
        self._mods = (fast_loop, gat_loop)
        self._real = epoch_graph.EpochGraph
        for mod in self._mods:
            mod.EpochGraph = Recorded

    def take(self):
        out, self.made = self.made, []
        return out

    def close(self):
        for mod in self._mods:
            mod.EpochGraph = self._real


def run_cell(cell, cfg, mix, manifest, seed, seconds, trace, t0,
             device="cuda", control=None, fault=None, min_runs=None):
    """One run of ``cell``: returns (result dict, check lines), or raises
    SystemExit without a result. ``control``, ``fault`` and ``min_runs``
    serve the limits' readings (``readings.py``) and the tests; the
    command passes none of them."""
    _cache_env()
    import torch
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
            raise SystemExit(f"{cell['name']} needs {cell['chips']} CUDA "
                             f"card(s); torch sees "
                             f"{torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
        _probe(device)
    else:
        device = torch.device(device)
    try:
        import fcsr_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        raise SystemExit(f"the program is not in this checkout: {e}")
    family = importlib.import_module(f"h100_bench.families.{cfg['family']}")
    on_card = device.type == "cuda"

    inst = family.Cell(cfg, mix, seed, device, control=control, fault=fault)
    inst.warm()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spy = _GraphSpy() if trace else None
    min_runs = int(mix["min_runs"] if min_runs is None else min_runs)

    t_w0 = time.perf_counter()
    setup_s = t_w0 - t0
    print(f"setup {setup_s!r} s", file=sys.stderr, flush=True)
    runs = []
    while True:
        last = None            # the previous run's result freed first
        r0 = time.perf_counter()
        last = inst.run_once()
        rec = inst.record(last)
        rec["run_s"] = time.perf_counter() - r0
        print(f"run {len(runs)}: {rec['run_s']!r} s, epochs "
              f"{rec['epochs']}", file=sys.stderr, flush=True)
        if spy is not None:
            rec["graphs"] = spy.take()
        runs.append(rec)
        if time.perf_counter() - t_w0 >= seconds and len(runs) >= min_runs:
            break
    window_s = time.perf_counter() - t_w0
    if spy is not None:
        spy.close()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    outputs = inst.take_outputs(last)
    last = None
    gc.collect()
    ctx = SimpleNamespace(runs=runs, window_s=window_s, setup_s=setup_s,
                          flops=sum(inst.run_flops(r) for r in runs),
                          slice=None, work={})
    if trace:
        from h100_bench import trace as tracing
        prof, ctx.work = inst.profile_slice(tracing.profile)
        ctx.slice = tracing.reduce(prof)
        del prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = inst.check(outputs)
    inst.close()
    print(f"reference check {time.perf_counter() - t_check!r} s",
          file=sys.stderr, flush=True)
    limits = cfg["check_limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in values.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        metrics, missing = {}, []
        for m in cell_metrics(manifest, "per_layer", cell):
            value = _metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
            elif on_card:
                missing.append(m["name"])
        if missing:
            # listed for this cell, so its reader has to find something
            raise SystemExit(f"{cell['name']}: no reading for "
                             f"{', '.join(missing)}")
    else:
        metrics = {m["name"]: {"value": END_TO_END[quantity(m["name"])](ctx),
                               "unit": m["unit"]}
                   for m in cell_metrics(manifest, "end_to_end", cell)}
    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": torch.cuda.get_device_name(device) if on_card
                else device.type,
                "count": int(cell["chips"]) if on_card else 1,
                "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(runs),
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": dev_info}
    if trace and ctx.slice:
        dev_info["busy_s"] = ctx.slice["busy_s"]
        dev_info["window_s"] = ctx.slice["window_s"]
        result["breakdown"] = {"device_ops": ctx.slice["device_ops"],
                               "idle_gaps": ctx.slice["idle_gaps"]}
    result["checks"] = checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    if getattr(inst, "notes", None):
        lines.insert(0, f"notes {json.dumps(inst.notes)}")
    return result, lines


def main(argv, t0):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-on-cpu", action="store_true",
                    help="run on the CPU (a rehearsal: no device metric)")
    args = ap.parse_args(argv)
    cell, cfg, mix, manifest = load_cell(args.workload)
    try:
        result, lines = run_cell(
            cell, cfg, mix, manifest, args.seed, args.seconds, args.trace,
            t0, device="cpu" if args.rehearse_on_cpu else "cuda")
    except SystemExit as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0
