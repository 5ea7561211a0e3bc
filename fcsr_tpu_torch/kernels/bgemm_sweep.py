"""Every dense plan of a product kernel at every dense census signature,
timed on the card:

    python -m fcsr_tpu_torch.kernels.bgemm_sweep [--bf16] [--out sweep.json]

``bgemm_f32`` over the full-width GSR and GAT steps, or with ``--bf16``
``bgemm_bf16`` over the full-width GSR step of ``FCSR_MM_MODE=bf16``. For
each signature whose product takes the dense path, each (tile, split-K)
plan the kernel has is launched through ``ops.bgemm_forced`` (or
``bgemm_bf16_forced``) and timed in a CUDA graph; the line shows the plan
the kernel picks (``bgemm_path`` / ``bgemm_bf16_path``) beside the
fastest, and the end the steps' sums under both. The numbers are what the
host-side cost models in ``csrc/bgemm.cu`` and ``csrc/bgemm_bf16.cu`` are
fitted to. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from fcsr_tpu_torch.kernels import ops
from fcsr_tpu_torch.kernels.census import (gat_step_census, gsr_step_census,
                                           replay)
from fcsr_tpu_torch.utils.timing import graph_ms

SPLITS = (1, 2, 4)


def _kernel(bf16: bool):
    """(tiles, forced launch, picked launch, path) of the kernel swept."""
    if bf16:
        return (ops.bgemm_bf16_tiles(), ops.bgemm_bf16_forced,
                ops.bgemm_bf16, ops.bgemm_bf16_path)
    return ops.bgemm_tiles(), ops.bgemm_forced, ops.bgemm, ops.bgemm_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true",
                    help="sweep bgemm_bf16 over the bf16 GSR step")
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bgemm_sweep needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    tiles, forced, picked_fn, path_of = _kernel(args.bf16)
    steps = ((("gsr", gsr_step_census(dev, ops=ops.KERNEL_OPS_BF16)),)
             if args.bf16 else (("gsr", gsr_step_census(dev)),
                                ("gat", gat_step_census(dev))))
    g = torch.Generator(device=dev).manual_seed(5)
    rows, seen = [], {}
    for step, census in steps:
        picked_sum = best_sum = 0.0
        for prod, n in census.signatures().items():
            if min(prod.M, prod.N) == 1 or prod.K <= 1:
                continue
            if prod not in seen:
                operands = replay(prod, census.layouts[prod], g, dev)
                call = dict(ta=prod.ta, tb=prod.tb, bias=operands["bias"],
                            add=operands["add"])
                a, b = operands["a"], operands["b"]
                times = {}
                for t in range(len(tiles)):
                    for s in SPLITS:
                        if s <= (prod.K + 31) // 32:
                            times[f"{t}/{s}"] = graph_ms([
                                lambda: forced(t, s, a, b, **call)])[0]
                picked = graph_ms([lambda: picked_fn(a, b, **call)])[0]
                best = min(times, key=times.get)
                seen[prod] = (picked, times[best])
                rows.append({"step": step, "signature": prod.label(),
                             "F": prod.F, "M": prod.M, "N": prod.N,
                             "K": prod.K, "launches": n,
                             "path": path_of(a, b, **call),
                             "picked_ms": picked, "best": best,
                             "times": times})
                print(f"{step} {prod.label():32s} x{n}  picked "
                      f"{rows[-1]['path']}: {picked:.4f} ms; best "
                      f"{tiles[int(best.split('/')[0])]} split "
                      f"{best.split('/')[1]}: {times[best]:.4f} ms",
                      flush=True)
            picked_sum += n * seen[prod][0]
            best_sum += n * seen[prod][1]
        print(f"{step} step, dense products: picked plans {picked_sum:.4f} "
              f"ms, fastest plans {best_sum:.4f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernel": "bgemm_bf16" if args.bf16 else "bgemm_f32",
                       "tiles": tiles, "card": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
