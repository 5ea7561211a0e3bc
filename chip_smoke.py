#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``fcsr_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``fcsr_tpu_torch/kernels/csrc``
(nvcc, at first use), then:

1. prints the environment (``nvidia-smi`` name and power limit, torch and
   CUDA versions, the build time) with TF32 switched off;
2. holds every kernel against its plain PyTorch version on the card at the
   shapes of the main path, and times both (CUDA events, median);
3. runs one full-width fold-batched training step (F = 3) on the kernels
   and on the plain path from the same weights and compares loss, recon,
   p', m' and v' (one fold masked: it must come through bit-unchanged),
   counts the step's FLOPs, bytes and launches, and profiles 10 steps
   (per-kernel device time into ``chiprun_out/profile_step.txt``);
4. drives the main path: the seeded 167-subject teacher dataset, 3 folds,
   ``GSRFoldRunner(GSRTrainConfig(fused_adam=True))`` at full width for 4
   epochs (two ``chunk_epochs=2`` launches) and ``evaluate()``, with every
   kernel's launch count read from that run; and a tiny 2-fold run on the
   card against the same run on the host.

Any failure exits non-zero before the result. The last three lines are the
per-kernel JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or fcsr_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W):
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3
F, LR, HR, KS = 3, 160, 268, (0.9, 0.7, 0.6, 0.5)
EPOCHS = 4                   # main-path epochs, run as two chunks of 2


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean ms per call of ``reps`` calls,
    by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Mean device ms per call with no host gaps between launches: ``reps``
    calls captured into one CUDA graph, replayed and timed by CUDA events.
    (``cuda_ms`` of the eager call includes the host's launch cost.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5) / reps


def bound(flops: float, nbytes: float):
    """(ms, bound_by): the larger of flops / fp32 peak and bytes / HBM."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def scale_of(x) -> float:
    if isinstance(x, (tuple, list)):
        return max(scale_of(t) for t in x)
    return max(1.0, float(x.abs().max()))


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version at main-path shapes
# ---------------------------------------------------------------------------

def kernel_cases(dev):
    """(name, kernel call, plain call, rel tolerance, flops, bytes,
    library call or None) per kernel, at main-path shapes (F = 3 folds,
    160 -> 268 nodes)."""

    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.models.gsr import pool_sizes

    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    cases = []
    m = HR
    f4 = 4.0 * F

    # bgemm: the step's most common product, 268 x 268 x 268 + bias
    a, b, bias = rnd(F, m, m), rnd(F, m, m), rnd(F, 1, m)
    cases.append(("bgemm_f32",
                  lambda: K.bgemm(a, b, bias=bias),
                  lambda: P.bgemm(a, b, bias=bias), 1e-5,
                  2.0 * F * m * m * m, f4 * (3 * m * m + m),
                  lambda: torch.baddbmm(bias, a, b)))

    # rank_select at level 0 (160 -> 144) with constructed exact ties
    n0, k0 = LR, pool_sizes(LR, KS)[0]
    logits = rnd(F, n0, scale=100.0)
    logits[:, 10:20] = logits[:, 30:31]           # a 10-way tie
    logits[:, 100] = logits[:, 5]
    cases.append(("rank_select", lambda: K.rank_select(logits, k0),
                  lambda: P.rank_select(logits, k0), 1e-6,
                  float(F * n0 * n0), f4 * (3 * n0 + 2 * k0), None))

    s, idx, vals, slot = K.rank_select(logits, k0)
    d = rnd(F, n0, m)
    cases.append(("gather_rows", lambda: K.gather_rows(d, idx, vals),
                  lambda: P.gather_rows(d, idx, vals), 0.0,
                  float(F * k0 * m), f4 * (3 * k0 * m + 2 * k0), None))
    gp, skip = rnd(F, k0, m), rnd(F, n0, m)
    cases.append(("scatter_rows",
                  lambda: K.scatter_rows(gp, slot, vals, skip),
                  lambda: P.scatter_rows(gp, slot, vals, skip), 1e-6,
                  2.0 * F * n0 * m, f4 * (k0 * m + 2 * n0 * m + k0 + n0),
                  None))
    pre = rnd(F, k0, m)
    cases.append(("pool_logits_bwd",
                  lambda: K.pool_logits_bwd(gp, pre, slot, s),
                  lambda: P.pool_logits_bwd(gp, pre, slot, s), 1e-5,
                  2.0 * F * k0 * m, f4 * (2 * k0 * m + 3 * n0), None))
    flat = rnd(F, 2 * LR * m + m)
    w = flat[:, :LR * m].view(F, LR, m)
    bb = flat[:, LR * m:LR * m + m].view(F, 1, m)
    cases.append(("add_bias", lambda: K.add_bias(w, bb),
                  lambda: P.add_bias(w, bb), 0.0,
                  float(F * LR * m), f4 * (2 * LR * m + m),
                  lambda: torch.add(w, bb)))

    t = rnd(F, m, m, scale=0.1)
    adj, r = K.tail_normalize(t)
    cases.append(("tail_normalize", lambda: K.tail_normalize(t),
                  lambda: P.tail_normalize(t), 1e-5,
                  3.0 * F * m * m, f4 * (2 * m * m + m), None))
    gadj = rnd(F, m, m)
    cases.append(("tail_normalize_bwd",
                  lambda: K.tail_normalize_bwd(gadj, t, r),
                  lambda: P.tail_normalize_bwd(gadj, t, r), 1e-5,
                  9.0 * F * m * m, f4 * (3 * m * m + m), None))
    x = rnd(F, m, m)
    cases.append(("sym_abs_fill", lambda: K.sym_abs_fill(x),
                  lambda: P.sym_abs_fill(x), 0.0,
                  2.0 * F * m * m, f4 * 2 * m * m, None))
    gz = rnd(F, m, m)
    cases.append(("sym_sign_grad", lambda: K.sym_sign_grad(gz, x, 0.5),
                  lambda: P.sym_sign_grad(gz, x, 0.5), 0.0,
                  5.0 * F * m * m, f4 * 3 * m * m, None))
    pred, hr = rnd(F, m, m), rnd(F, m, m)
    vk = torch.zeros(F, 3, device=dev)
    vp = torch.zeros(F, 3, device=dev)
    cases.append(("l1_term",
                  lambda: (K.l1_term(pred, hr, vk, 1, 1.0, 1.0 / (m * m),
                                     False), vk[:, 1]),
                  lambda: (P.l1_term(pred, hr, vp, 1, 1.0, 1.0 / (m * m),
                                     False), vp[:, 1]), 1e-6,
                  3.0 * F * m * m, f4 * (3 * m * m + 1), None))

    from fcsr_tpu_torch.models.fused_step import FlatLayout
    n_p = FlatLayout(LR, HR, len(KS)).size
    pp, gg = rnd(F, n_p), rnd(F, n_p, scale=1e-2)
    mm_, vv = rnd(F, n_p, scale=1e-3), rnd(F, n_p, scale=1e-3).abs()
    scal = torch.tensor([[1.0, 1 - 0.9 ** 5, 1 - 0.999 ** 5]] * F,
                        device=dev)
    scal[2, 0] = 0.0                               # one masked fold
    terms = rnd(F, 3).abs()
    args = (pp, mm_, vv, gg, scal, terms, 1e-4, 0.9, 0.999, 1e-8)
    cases.append(("adam_masked", lambda: K.adam_masked(*args),
                  lambda: P.adam_masked(*args), 0.0,
                  12.0 * F * n_p, f4 * 7 * n_p, None))
    return cases


def check_kernels(dev):
    """Phase 2; returns {name: record} for the JSON line."""

    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P

    records = {}
    for name, kern, plain, tol, flops, nbytes, lib in kernel_cases(dev):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_err(got, want)
        limit = tol * scale_of(want)
        ok = err <= limit
        if name == "rank_select":   # indices and slots exactly
            ok = ok and torch.equal(got[1], want[1]) \
                and torch.equal(got[3], want[3])
        if not ok:
            fail(f"kernel {name} disagrees with its plain version "
                 f"(max|err| {err:.3e}, limit {limit:.1e})")
        ms, plain_ms = device_ms(kern), device_ms(plain)
        lib_ms = device_ms(lib) if lib is not None else None
        host_ms = cuda_ms(kern)
        b_ms, b_by = bound(flops, nbytes)
        print(f"  {name:20s} max|err| {err:.3e} (limit {limit:.1e}) ok  "
              f"kernel {ms:.4f} ms (eager from Python {host_ms:.4f})  "
              f"plain {plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})"
              + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else ""),
              flush=True)
        records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": lib_ms}

    # bgemm: every transpose combination and the step's other shapes
    g = torch.Generator(device="cpu").manual_seed(1)
    shapes = [(LR, HR, HR), (HR, HR, LR), (30, HR, HR), (HR, HR, 536),
              (61, 1, HR), (HR, 1, 101), (101, HR, 1), (1, HR, 144)]
    for (M, N, Kd) in shapes:
        for ta in (False, True):
            for tb in (False, True):
                a = torch.randn(F, *((Kd, M) if ta else (M, Kd)),
                                generator=g).to(dev)
                b = torch.randn(F, *((N, Kd) if tb else (Kd, N)),
                                generator=g).to(dev)
                add = torch.randn(F, M, N, generator=g).to(dev)
                got = K.bgemm(a, b, ta, tb, add=add)
                want = P.bgemm(a, b, ta, tb, add=add)
                ones = K.bgemm(None, b, tb=tb)
                err = max(max_err(got, want),
                          max_err(ones, P.bgemm(None, b, tb=tb)))
                if err > 1e-5 * max(scale_of(want), float(Kd)):
                    fail(f"bgemm {M}x{N}x{Kd} ta={ta} tb={tb}: err {err}")
                opa = a.transpose(1, 2) if ta else a
                opb = b.transpose(1, 2) if tb else b
                k_ms = device_ms(lambda: K.bgemm(a, b, ta, tb))
                t_ms = device_ms(lambda: torch.matmul(opa, opb))
                print(f"    bgemm {M:3d}x{N:3d}x{Kd:3d} ta={int(ta)} "
                      f"tb={int(tb)}: kernel {k_ms:.4f} ms, torch.matmul "
                      f"{t_ms:.4f} ms, max|err| {err:.2e}")
    print(f"  bgemm_f32 transpose/shape sweep ok ({len(shapes) * 4} cases)")
    return records


# ---------------------------------------------------------------------------
# phase 3: one full-width fold-batched step, kernels vs plain
# ---------------------------------------------------------------------------

def check_step(dev, data):

    from fcsr_tpu_torch.iox.weights import state_to_flat
    from fcsr_tpu_torch.models.fused_step import (train_step_fused,
                                                  train_step_plain)
    from fcsr_tpu_torch.models.gsr import GSRNet
    from fcsr_tpu_torch.train.fast_loop import stage_dataset
    from fcsr_tpu_torch.train.gsr_loop import GSRTrainConfig

    cfg = GSRTrainConfig(fused_adam=True)
    a_norm, hr, u_lr, u_hr = stage_dataset(
        cfg, data["lr_train"][:F], data["hr_train"][:F], dev)
    flat = np.stack([state_to_flat({k: v.numpy() for k, v in GSRNet(
        device="cpu", seed=j).state_dict().items()}) for j in range(F)])
    p = torch.from_numpy(flat).to(dev)
    rng = np.random.default_rng(0)
    m = torch.from_numpy(
        rng.normal(0, 1e-3, flat.shape).astype(np.float32)).to(dev)
    v = torch.from_numpy(
        np.abs(rng.normal(0, 1e-3, flat.shape)).astype(np.float32)).to(dev)
    scal = torch.tensor([[1.0, 1 - 0.9 ** 3, 1 - 0.999 ** 3],
                         [1.0, 1 - 0.9 ** 7, 1 - 0.999 ** 7],
                         [0.0, 1 - 0.9 ** 2, 1 - 0.999 ** 2]], device=dev)
    args = (p, m, v, u_lr, u_hr, hr, scal, KS, LR, HR, 16.0, 1e-4)
    got = train_step_fused(*args, device=dev)
    want = train_step_plain(*args)
    torch.cuda.synchronize()
    # relative to max(1, max|plain|): fp32 products summed in another
    # order than cuBLAS's, chained through ~20 products per pass
    names = ("loss", "recon", "p'", "m'", "v'")
    tols = (1e-5, 1e-5, 1e-6, 1e-5, 1e-5)
    for name, a, b, tol in zip(names, got, want, tols):
        err = max_err(a, b)
        limit = tol * scale_of(b)
        print(f"  step {name:5s} max|err| {err:.3e} (limit {limit:.1e})")
        if not err <= limit:
            fail(f"full-width step: {name} disagrees with the plain path")
    for a, b in ((got[2], p), (got[3], m), (got[4], v)):
        if not torch.equal(a[2], b[2]):
            fail("masked fold's state changed")
    print(f"  step loss {got[0].tolist()} recon {got[1].tolist()}")
    flops, nbytes, launches = count_step(args)
    b_ms, b_by = bound(flops, nbytes)
    state_bytes = 4.0 * p.numel() * 7 + 4.0 * (u_lr.numel() + u_hr.numel()
                                               + hr.numel())
    print(f"  step work: {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.2f} MB moved "
          f"by its {sum(launches.values())} launches {launches}; bound "
          f"{b_ms:.4f} ms ({b_by}); p,m,v,g and data alone "
          f"{state_bytes / 1e6:.2f} MB = {state_bytes / PEAK_BYTES * 1e3:.4f}"
          f" ms")

    def run_kernels():
        return train_step_fused(*args, device=dev)

    def run_plain():
        return train_step_plain(*args)

    k_dev, p_dev = device_ms(run_kernels, reps=5), device_ms(run_plain,
                                                             reps=5)
    k_host, p_host = cuda_ms(run_kernels, reps=5), cuda_ms(run_plain, reps=5)
    print(f"  full-width step (F={F}): kernels {k_host:.3f} ms eager, "
          f"{k_dev:.3f} ms device (CUDA graph); plain {p_host:.3f} ms eager, "
          f"{p_dev:.3f} ms device")
    return args, k_host


def count_step(args):
    """(flops, bytes, launches by kernel) of one kernel-path step: 2MNK
    per product, and each kernel's inputs read once and outputs written
    once, tallied by wrapping the step's op namespace."""
    from types import SimpleNamespace

    from fcsr_tpu_torch.kernels import KERNEL_OPS
    from fcsr_tpu_torch.models.fused_step import step_with_ops

    tally = {"flops": 0.0, "bytes": 0.0, "launches": {}}

    def nbytes(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, (tuple, list)):
            return sum(nbytes(t) for t in x)
        return 0

    def wrap(name, fn):
        def counted(*a, **kw):
            ins = nbytes(list(a)) + nbytes([v for k, v in kw.items()
                                            if k != "out"])
            out = fn(*a, **kw)
            tally["bytes"] += ins + nbytes(out)
            tally["launches"][name] = tally["launches"].get(name, 0) + 1
            if name == "bgemm":
                b = a[1]
                tb = kw.get("tb", a[3] if len(a) > 3 else False)
                k_dim = b.shape[2] if tb else b.shape[1]
                tally["flops"] += 2.0 * out.numel() * k_dim
            return out
        return counted

    ops = SimpleNamespace(**{k: wrap(k, v)
                             for k, v in vars(KERNEL_OPS).items()})
    step_with_ops(ops, *args, 0.9, 0.999, 1e-8)
    return tally["flops"], tally["bytes"], tally["launches"]


def profile_steps(args, dev, eager_ms, path):
    """torch.profiler over 10 eager steps: device time by kernel, written
    to ``path``, and the device's busy share of the eager step."""
    from torch.profiler import ProfilerActivity, profile

    from fcsr_tpu_torch.models.fused_step import train_step_fused

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            train_step_fused(*args, device=dev)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=15)
    dev_ms = sum(e.self_device_time_total for e in averages) / 10 / 1e3
    with open(path, "w") as f:
        f.write(table)
    print(f"  profile: {dev_ms:.3f} ms of device time per step, "
          f"{100 * dev_ms / eager_ms:.1f}% of the {eager_ms:.3f} ms eager "
          f"step; table in {path}")
    for e in sorted(averages, key=lambda e: -e.self_device_time_total):
        if e.self_device_time_total > 0:
            print(f"    {e.key[:60]:60s} {e.self_device_time_total / 10:9.1f}"
                  f" us/step  {e.count // 10:3d} launches/step")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def run_main_path(dev, data, epochs: int):

    from fcsr_tpu_torch import (GSRFoldRunner, GSRTrainConfig,
                                kfold_indices)
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    n = len(data["lr_train"])
    folds = kfold_indices(n, 3, seed=42)
    cfg = GSRTrainConfig(fused_adam=True, epochs=epochs)
    t0 = time.perf_counter()
    runner = GSRFoldRunner(cfg, data["lr_train"], data["hr_train"], folds,
                           device=dev)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    untrained, _ = runner.evaluate(runner.flat0)

    reset_launch_counts()
    t0 = time.perf_counter()
    _, loss_hist, err_hist = runner.train(chunk_epochs=2)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    counts = launch_counts()
    maes, preds = runner.evaluate()
    torch.cuda.synchronize()

    steps = runner.tr_idx.shape[1] * epochs
    print(f"  stage {t_stage:.2f} s; train {t_train:.2f} s = "
          f"{t_train / epochs:.3f} s/epoch, {1e3 * t_train / steps:.3f} "
          f"ms/step ({steps} fold-batched steps)")
    for j in range(len(folds)):
        print(f"  fold {j} loss {loss_hist[j].tolist()} "
              f"recon {err_hist[j].tolist()}")
    print(f"  val MAE untrained {untrained.tolist()} trained "
          f"{maes.tolist()}")
    print(f"  launches on the main path: {counts}")
    if not (np.isfinite(loss_hist).all() and np.isfinite(maes).all()
            and bool(torch.isfinite(preds).all())):
        fail("non-finite loss, MAE or prediction")
    if tuple(preds.shape[-2:]) != (HR, HR):
        fail(f"prediction shape {tuple(preds.shape)}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    return counts


def check_tiny_trainer(dev, data):
    """A 2-fold, 3-epoch run at 20 -> 32 nodes on the card against the same
    run on the host (plain versions), from the same initial weights."""
    from fcsr_tpu_torch import GSRFoldRunner, GSRTrainConfig, kfold_indices

    lr = data["lr_train"][:6, :20, :20].copy()
    hr = data["hr_train"][:6, :32, :32].copy()
    folds = kfold_indices(6, 2, seed=42)
    cfg = GSRTrainConfig(lr_dim=20, hr_dim=32, hidden_dim=32, ks=(0.9, 0.7),
                         epochs=3, fused_adam=True)
    host = GSRFoldRunner(cfg, lr, hr, folds, device="cpu")
    card = GSRFoldRunner(cfg, lr, hr, folds, flat0=host.flat0.numpy(),
                         device=dev)
    _, lh_h, _ = host.train()
    _, lh_c, _ = card.train()
    m_h, _ = host.evaluate()
    m_c, _ = card.evaluate()
    d_loss = float(np.abs(lh_h - lh_c).max())
    d_mae = float(np.abs(m_h - m_c).max())
    print(f"  tiny trainer card vs host: max|d loss| {d_loss:.2e} "
          f"(limit 1e-4), max|d MAE| {d_mae:.2e} (limit 1e-5)")
    if not (d_loss <= 1e-4 and d_mae <= 1e-5):
        fail("tiny trainer on the card disagrees with the host run")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the card only")
    sys.path.insert(0, HERE)
    try:
        import fcsr_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"fcsr_tpu_torch is not importable next to chip_smoke.py: {e}")
    from fcsr_tpu_torch.kernels import KERNELS
    from fcsr_tpu_torch.kernels.build import BUILD_INFO, build_all

    # phase 1: environment and build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    dev = torch.device("cuda")
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        for name, log in BUILD_INFO.get("ptxas", {}).items():
            f.write(f"=== {name}.cu\n{log}\n")

    t0 = time.perf_counter()
    from fcsr_tpu_torch.data import load_or_synthesize
    data = load_or_synthesize(None, n_train=167, n_test=112, seed=42)
    print(f"teacher dataset synthesized in {time.perf_counter() - t0:.1f} s",
          flush=True)

    print("phase 2: kernels vs plain at main-path shapes", flush=True)
    records = check_kernels(dev)
    print("phase 3: one full-width step, kernels vs plain", flush=True)
    step_args, eager_ms = check_step(dev, data)
    profile_steps(step_args, dev, eager_ms,
                  os.path.join(OUT_DIR, "profile_step.txt"))
    print("phase 4: main path", flush=True)
    counts = run_main_path(dev, data, EPOCHS)
    check_tiny_trainer(dev, data)

    if "jax" in sys.modules or any(k == "fcsr_tpu" or k.startswith("fcsr_tpu.")
                                   for k in sys.modules):
        fail("JAX or fcsr_tpu was imported")
    kernels = []
    for name, k in KERNELS.items():
        rec = {"name": name, "route": "cuda",
               "source": f"fcsr_tpu_torch/kernels/csrc/{k.source}.cu",
               "replaces": k.replaces, "launches": counts.get(name, 0)}
        rec.update(records.get(name, {}))
        kernels.append(rec)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
