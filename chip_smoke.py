#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``fcsr_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``fcsr_tpu_torch/kernels/csrc``
(nvcc, at first use), then:

1. prints the environment (``nvidia-smi`` name and power limit, torch and
   CUDA versions, the build time) with TF32 switched off;
2. holds every kernel against its plain PyTorch version on the card at the
   shapes of the main path, and times both (CUDA graphs, in turns, with
   the library call where there is one);
   ``anti_vectorize_normalize`` in each form of its plan (the copy and
   the normalised cluster) at the CSV path's shapes, at 2-268 and 1300
   nodes and at 65 537 matrices, with trailing entries, a diagonal fill
   and the row-sum guard (``check_triu_kernels``), then timed at the CSV
   path's three shapes, warm and with L2 flushed (``triu_times``, which
   also times an older tree); ``vectorize_colmajor`` bit-equal to its
   plain version at 2-1300 nodes and at 65 537 and 131 073 matrices (past
   the grid's y extent), on non-symmetric
   inputs with -0.0 and NaN entries, run to run and graphed
   (``check_colmajor``), then timed at the predict command's shape and
   beside it, warm and cold, with the library call (``triu_times``);
   ``tail_normalize_bwd`` also at other widths and fold counts,
   bit-equal run to run and over its rows per band, and ``add_bias`` on
   the step's views and on views 1-3 floats off 16 bytes; the two cluster
   reductions beyond their record (``check_tail_reductions``):
   ``tail_normalize`` at the adjoint's widths,
   on a zero row and an inf entry, ``l1_term`` at the step's three call
   signatures (the ``FlatLayout`` leaf view among them) and on views 1-3
   floats off 16 bytes, with exact ties, and at the last term with the
   loss scalars it writes (bit-equal to its terms in ``adam_masked``'s
   order); the pool (``check_pools``):
   ``rank_select``'s one launch that ranks and gathers at every pool of
   both steps x F 3 / 56 with ties and NaN scores, every output equal to
   the plain version's, bit-equal run to run and in a CUDA graph, and the
   backward's ``gather_rows`` there, then per-pool times
   (``pool_times``, which also times an older tree); the pool's backward
   rows (``check_pool_bwd``): the unpool ``scatter_rows`` (the forward's,
   and the GAT backward's with scale and addend), ``pool_logits_bwd`` and
   the GSR backward's ``pool_bwd_pair`` at every pool of both steps (the
   forward scatter also at F 56), exact (the logits' adjoint within 1e-5,
   the pair's equal to the standalone launch's bits), bit-equal run to
   run and graphed, then per-pool times (``pool_bwd_times``, which also
   times an older tree); the score rule (``check_pool_scores``): the
   kernel's, the plain pool's, a GSRNet ``GraphPool``'s and
   ``unet_forward_rankselect``'s scores bit-equal from the same logits;
   the symmetric pair (``check_sym_tiles``): ``sym_abs_fill`` and
   ``sym_sign_grad`` (c 0.5 and 1) at the GSR tail's and odd widths, on
   the 16- and the 4-byte path, bit-equal to the plain version (NaN where
   NaN), run to run and graphed, bitwise symmetric, then their times
   (``sym_times``, which also times an older tree); for
   ``bgemm_f32`` every distinct product signature of the full-width GSR
   and GAT steps (their census, ``kernels/census.py``), replayed with the
   step's operand layouts: the path the kernel takes, its error, two
   launches bit-equal, and its time beside one library call's, both in
   CUDA graphs timed in turns, summed over each step's launches;
3. runs one full-width fold-batched training step (F = 3) on the kernels
   and on the plain path from the same weights and compares loss, recon,
   p', m' and v' (one fold masked: it must come through bit-unchanged),
   counts the step's FLOPs, bytes and launches (106: one ``rank_select``
   per pool, 4 ``gather_rows``, 4 ``scatter_rows``, 4 ``pool_bwd_pair``),
   and profiles 10 steps (per-kernel device time into
   ``chiprun_out/profile_step.txt``, with the pool kernels' device
   launches; the GAT step's of phase 7 into ``profile_gat_step.txt``);
4. drives the trainer path: the seeded 167-subject teacher dataset, 3
   folds, ``GSRFoldRunner(GSRTrainConfig(fused_adam=True))`` at full width
   for 2 epochs (two ``chunk_epochs=1`` launches, each epoch one replay of
   the epoch's CUDA graph, its capture's seconds printed) and
   ``evaluate()``, with every step kernel's launch count read from that
   run (counted through the replays), and ``evaluate()``'s ms and
   synchronising calls a call (``evaluate_times``: 3 folds in one
   vmapped forward); a tiny 2-fold run on the card against the same run
   on the host; the folds as one vmapped call at 20 -> 32 nodes (the
   unfused GSR step in fp32 and bf16, ``evaluate``, the unfused GAT step
   and validation) on the card against the CPU (``check_fold_batched``,
   ``BATCHED_TOL``); the phase's peak device memory;
5. drives the CSV-to-submission path at full width through the command
   line: the teacher set written as the three Kaggle CSVs (NaN cells
   included), ``train gsr --fused`` (2 epochs, 3 folds, a checkpoint) and
   ``predict --ordering colmajor`` in-process on the card, with the
   launch counts of that run; then checks the ingested stacks, the device
   ingest, both submission files and an interrupted-and-resumed run
   against the straight one, and prints the path's stage times;
6. drives every other way of training GSR-Net at full width: each fused
   entry point (``tail_loss_fused``, ``unet_fused``, ``unet_fused_fwdonly``,
   ``unet_fused_fwdbwd``, ``gsr_step_loss_fused``,
   ``step_value_and_grad_fused``) at F = 3 against autograd over its plain
   PyTorch version (value and gradients), with its launches and times;
   the loss entry points' launches (27, 105, 105: the loss scalars come
   out of the spectral ``l1_term`` launch) and their loss and recon bit
   for bit against their loss terms, then their device, eager and host
   times per call (``entry_point_times``, which also times an older
   tree); one epoch over 3 folds of ``GSRFoldRunner`` in each mode
   (unfused, ``fused_tail``, ``+ fused_unet``, ``+ fused_unet_bwd``,
   ``fused_step``) through its epoch graph, with the launch counts of
   each run through the replays (``MODE_LAUNCHES`` a step), ``fused_step``
   bit-equal to ``fused_adam`` from the same weights; and the parity
   trainer (``train gsr`` with no flag, 2 folds x 1 epoch, an epoch graph
   per fold) through the command line on phase 5's CSVs; the phase's peak
   device memory;
7. drives the GAT U-Net family at its shipped width (n = 160, m = 268,
   dim 16, ks (0.5, 0.5, 0.5), 4 / 2 heads, F = 3): each of its eleven
   kernels against its plain version at every shape the step uses, at
   drop_p 0, 0.01 and 0.3 with the masks the counter-based generator draws,
   and the generator's keep rate against a binomial bound (the keep mask's
   bound from the integer work of its draws as compiled, ``philox_sass``,
   beside the parent's count); ``philox_keep_mask`` bit-equal to its plain
   version at the keep-rate shape, every mask ``draw_masks`` dumps and an
   odd plane, under edge seeds, alone and applied to x one float off 16
   bytes (``check_keep_mask``), then timed (``keep_mask_times``, which also
   times an older tree);
   the two cluster
   kernels beyond that (``check_gat_reductions``): ``gat_attention_bwd``
   at every layer shape and F = 1 / 3 and at n 1000 / 4096 x d 128, the
   off-diagonal losses at n 37-3500 x F 1 / 3 / 56, each bit-equal over
   two launches and in a CUDA graph, with their times beside those of
   the three-stage adjoint they replaced; the two forward kernels beyond
   that (``check_gat_forward``): ``gat_attention`` at every layer shape x
   drop_p x both softmax shifts x F = 1 / 3 / 56 and at n 1000 / 4096 x
   d 128, ``gat_pool_adj`` at the step's pools x F = 3 / 56 and k 1000,
   bit-equal and graphed, with per-layer times at F = 3 and 56 beside the
   kernels they replaced; the pool's dropout inside its products
   (``check_pool_dropout``): ``philox_drop_logits`` and
   ``philox_drop_outer`` at the step's pools and at (4096, 128), edge
   seeds, bit-equal to the two-launch pairs they replaced and to their
   plain versions (the logits within 1e-5), eager and graphed, then timed
   beside the pairs (``pool_dropout_times``, which also times an older
   tree); ``col_softmax`` and its adjoint ``col_softmax_bwd`` at R 16
   (F 3 / 56), 64 and 200, both forms of their plan, within 1e-6 and
   bit-equal run to run and graphed, then timed beside ``torch.softmax``
   and ``torch._softmax_backward_data`` (``col_softmax_times``,
   ``col_softmax_bwd_times``, which also time an older tree); one
   fused step against the plain step and against autograd over the plain
   loss (loss, 36 gradients, p', m', v'), eager and as one CUDA graph,
   with 7 ``gat_attention_bwd``, 7 ``gat_attention``, 3
   ``gat_pool_adj``, 3 ``rank_select``, 3 ``gather_rows``, 6
   ``scatter_rows``, 3 ``pool_logits_bwd``, 3 ``philox_drop_logits``, 3
   ``philox_drop_outer`` and no ``philox_keep_mask`` device launches in
   its profile (83 launches); the fused validation forward (37 launches, no
   ``gather_rows``, 3 ``scatter_rows``) and its profile
   (``profile_gat_val.txt``);
   ``train_gat_folds_parallel(fused_step=True)`` on the teacher set (3
   folds, 2 epochs at drop_p = 0.01, its epoch and validation graphs
   replayed, the launch counts of that run), one epoch fused against one
   unfused, each through its graphs; and ``train gat --fast --fused``,
   ``--fast`` and the per-fold trainer through the command line on phase
   5's CSVs (every one through its epoch and validation graphs), each
   column-major submission parsed back;
8. drives the metric suite (``evalx``) on the card: phase 4's fold stacks
   (``evaluate_gsr_folds(pull_preds=True)``, 3 folds of 55-56 pairs at
   268 nodes), fold 0 in float64 and float32 (the precisions agree
   outside the betweenness pass; the betweenness gap is printed), its
   first 8 pairs on the card against the CPU path (float64 within 1e-9,
   float32 within 3e-5, core-periphery equal); the seconds per stack of
   56 and 112 pairs (folds 0 and 1, as ``evaluate`` sees them) in both
   precisions by CUDA events, with the time of each part (BC, EC, PR,
   k-core, KL) and the iterations and host syncs of its loops; then
   ``train gsr --fused --full-metrics`` on phase 5's CSVs (106 launches a
   step, ``eval_metrics.json`` with 3 folds x 8 finite metrics, its launch
   counts in the JSON line), ``evaluate --gt --pred`` on ``.npz`` stacks
   (``results_fold_0.txt`` against the in-process dict) and, where
   networkx is absent, ``--eval-backend networkx`` failing with an
   ImportError that names it (where it is present, its backend against
   the card on 4 pairs);
9. drives the MLP family at full width (v2: 12 720 -> 214 -> 35 778; v1:
   25 600 -> 10 000 -> 71 824, 974 M parameters a fold): ``adamw_masked``
   at v2's 3 x 10 414 992, out of place against plain and in place
   against out of place, bit for bit, timed in turns beside
   ``torch._fused_adamw_`` (one rate, no mask), and in place at v1's 3 x
   974 341 824 against plain on a slice of each fold (``check_adamw_inplace``);
   one step of each variant on the kernels against the same step on the
   plain versions, bit for bit (v2 at F = 3 with a masked fold, v1 at F =
   1), then both steps at F = 3 eager, as one CUDA graph and profiled
   (``check_mlp_steps``; ``profile_mlp_v2.txt``, ``profile_mlp_v1.txt``);
   the slice's main path, ``run_mlp_cv`` for the shipped 100 epochs on the
   teacher set through its epoch and validation graphs (one
   ``adamw_masked`` launch a step counted through the replays, the test
   predictions' matrix scatter), its MAEs beside the untrained model's
   and the mean target's; and ``train mlp`` and ``train mlp --variant v1
   --epochs 2``
   on phase 5's CSVs, each column-major submission parsed back, with
   v1's peak device memory;
10. the JAX package's files and the last modules: decodes the JAX
   package's trained GSR-Net file (``outputs/gsr/gsr_net_trained.msgpack``)
   with the port's msgpack coder and encodes it again, byte for byte
   (this machine has no flax: the coder's only check here); runs
   ``predict --params`` on that file over the teacher set's 112 test
   subjects in both orderings on the card and with ``--device cpu``
   (predictions within 1e-4, both wall times, the launches of
   ``normalize_adj_batch`` and ``vectorize_colmajor``); runs
   ``python -m fcsr_tpu_torch.examples.train_gsr --fast --splits 3
   --epochs 2`` (in process, its artifacts listed) and ``predict`` on the
   ``gsr_net_trained.msgpack`` it wrote, which must reproduce its
   ``submission.csv``; runs ``GraphSAGEUpsampler(64, 268, n_layers=2)``
   over the 112 x 160 test stack on the card and the CPU (logits within
   1e-4 of their scale; after the 0.2 threshold a mismatch only within
   1e-5 of it; both times); and draws the ``lift`` dataset, whose sha256
   must be the one the CPU tests pin;
11. the fold-sharded trainers and the data-parallel steps
   (``fcsr_tpu_torch/parallel``): ``train gsr --multichip --fused`` and
   ``train gat --multichip --fused`` (2 epochs, 3 folds, drop_p 0.01 for
   GAT) on phase 5's CSVs, on this machine's one-card mesh, with fold MAEs
   and submission.csv bit-equal to the runs without ``--multichip``; the
   full-width ``fused_adam`` GSRFoldRunner on a 3-shard (F = 1 a shard)
   and a 2-shard mesh (3 folds padded to 4) of the one card against the
   F = 3 run, a graph per shard (bit-equal: the shards' products are
   planned for the 3 real folds; 106 launches a shard step through the
   replays, s/epoch of each); ``make_sharded_batch_step`` (full width, batch
   8 on 4 shards) under an NCCL process group of one process started by
   ``maybe_initialize_distributed`` on 127.0.0.1, and
   ``make_sharded_generic_step`` (MLP v2 at its published widths, batch
   32 on 2 shards, BatchNorm moments and dropout of the whole batch)
   against their single-device steps (parameters and running statistics
   within 2e-5);
12. ``FCSR_MM_MODE=bf16``, the single-pass bf16 products: (a)
   ``bgemm_bf16`` against its plain version (the exact products of the
   same bf16 values summed in fp32) at every signature of the bf16 GSR
   step's census (dense, matrix-vector, column sums, rank-1; 79
   launches), two launches bit-equal, on the dense path under every
   (variant, split-K) plan (without split-K the variants bit-equal to
   each other), timed beside the plain version and
   ``torch.bmm(a16, b16, out_dtype=torch.float32)`` with and without the
   casts, eager and by the host's microseconds a call, summed by class;
   with ``FCSR_BGEMM_BF16_PARENT=<dir>`` (an earlier tree's
   ``bgemm_bf16.cu`` and the headers it includes) that kernel is built
   too and timed in the same turns; the rounding instances
   ``rank_select_bf16``, ``gather_rows_bf16``, ``scatter_rows_bf16``,
   ``pool_bwd_pair_bf16`` and ``pool_bwd_pair_bf16_ad`` (exact, the
   logits' adjoint within 1e-5) at every GSR pool and ``add_bias_bf16``
   (exact); (b) phase 3's step in the bf16 mode, kernels against plain
   (``BF16_STEP_TOLS``), 106 launches, its device time as one CUDA graph
   beside the fp32 step's in turns; (b2) ``unet_fused`` and
   ``step_value_and_grad_fused`` in bf16 (the autodiff-shaped adjoints):
   at 20 -> 32 the card against the CPU, at full width beside autograd
   over the plain bf16 version (``check_bf16_ad_entry_points``), the
   loss entry points #4, #8, #10 timed alone in fp32 and in bf16
   (``entry_point_times``), and both step graphs under torch.profiler,
   their kernels and the gaps between them read from the chrome trace by
   kernel function (``step_graph_gaps``, which also runs against an older
   tree; ``graph_trace_summary`` reads a saved trace); (c) the full-width
   ``fused_adam`` runner (3 folds, 2 epochs) in fp32 and in bf16 from the
   same weights, ``fused_step`` and a 3-shard mesh in bf16 bit-equal to
   it, s/epoch and val MAE beside the untrained MAE; (d)
   ``FCSR_MM_MODE=bf16 python -m fcsr_tpu_torch train gsr --fused`` on
   phase 5's CSVs in a process of its own, bit-equal to the same command in
   process; (e) the unfused runner with ``compute_dtype="bf16"`` (1 epoch,
   beside fp32 unfused); (f) ``utils.probe.require_live_device``;
13. ``hidden_dim != hr_dim`` and the JAX fast loop's resume blob: (a)
   ``tail_loss_fused`` (#4) and ``step_value_and_grad_fused`` (#10) at
   decoder widths 134 and 536 against autograd over their plain versions
   (values 1e-5 relative, gradients 1e-4 of their scale, 27 / 105
   launches), the tail's device ms a call at 268, 134 and 536, every
   product signature of the two that the 268-wide step lacks checked and
   timed beside the library call (``check_product``), and at 536 in the
   bf16 mode #4 on the kernels against its plain version and its new
   ``bgemm_bf16`` signatures (``check_bf16_product``); (b) the
   ``fused_tail_unet_bwd`` runner at 536 for 2 epochs and the unfused one
   at 134 for 1 (s/epoch, ms a step in the loop and on the device,
   launches a step, val MAE beside the untrained MAE); (c) the 536 run and a ``fused_adam`` run at
   268, each interrupted after epoch 1 with its ``.msgpack`` blob and
   resumed by a fresh runner, bit-equal to the straight run, and the
   encode and decode ms of the 37 MB blob; (d) the ``fused_adam`` and
   ``fused_step`` runners, #9 and #8 refusing width 134 before any launch;
14. the chunk programs as CUDA graphs, at full width: (a) every GSR
   trainer mode (1 epoch; ``fused_adam`` and ``fused_step`` 2, in fp32
   and in bf16) through its epoch graphs twice (s/epoch with and without
   the capture) and then step by step from Python on the same runner,
   bit for bit, with the same launches counted
   through the replays (``MODE_LAUNCHES`` a step), the capture's
   warm-up, capture and instantiate seconds, and ``fused_step`` bit-equal
   to ``fused_adam``; (b) ``fused_adam`` s/epoch through the graph and
   from Python, 3 passes each in turns; (c) 3- and 2-shard meshes of the
   card, a graph per shard, bit-equal to the unsharded run, s/epoch with
   and without the capture; (d) a ``.msgpack`` resume into the same
   runner's captured buffers, bit-equal; (e) the fused GAT trainer (2
   epochs, drop_p 0.01, device control) through its epoch and validation
   graphs against a trainer from Python, bit for bit, then 3 timed passes
   of each in turns; the phase's peak device memory;
15. the last three chunk programs as CUDA graphs, at full width, each
   against the same trainer from Python (``_stay_eager``) bit for bit,
   with the launches counted through the replays, the graphs' nodes,
   warm-up, capture and instantiate seconds, the device ms a step (an
   epoch graph's replay by CUDA events over its steps), s/epoch through
   the graph and from Python in passes in turns and the peak device
   memory: (0) the unfused GAT step, the folds one vmapped call, at
   F = 1 and F = 3: nodes and device ms a step, the capture's seconds,
   s/epoch through the graph and eager, F = 3's nodes a step within 10%
   of F = 1's (``gat_unfused_fold_counts``); (a) the unfused GAT trainer
   (the shipped config, drop_p 0.01,
   3 folds), 2 epochs under device control and 1 more under host control,
   the dropout generator's state after each run equal; (b) ``run_mlp_cv``
   with its defaults for 2 epochs (v2) and with ``variant="v1"`` for 1,
   one ``adamw_masked`` a step; (c) the parity trainer
   (``train_gsr_fold``, the first fold, 2 epochs, ``OptaxAdam``) and
   its distance from the same run with torch's Adam, with and without
   ``capturable``, from Python, and its epoch alone as one graph
   (``parity_epoch_ms``); then at 20 -> 32 nodes on the card against the
   CPU, steps within 1e-5 and parameters within 1e-6
   (``check_parity_tiny``);
   ``step_graph_ms`` gives every trainer's epoch graph alone (run alone).

Any failure exits non-zero before the result. The last three lines are the
per-kernel JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or fcsr_tpu.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
# phase 5's CSVs and submissions (a few hundred MB), removed when phase 9 ends
WORK_DIR = os.path.join(OUT_DIR, "smoke_csv_path")

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W):
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # bf16 on the tensor cores (dense)
PEAK_BYTES = 3.35e12         # HBM3
F, LR, HR, KS = 3, 160, 268, (0.9, 0.7, 0.6, 0.5)
EPOCHS = 2                   # trainer-path epochs, run as two chunks of 1
N_TRAIN, N_TEST = 167, 112   # subjects of the challenge's train / test set
TRIU = ("anti_vectorize_normalize", "vectorize_colmajor",
        "normalize_adj_batch")
# launches of one fold-batched GSR step, and of its pool kernels: each
# pool one rank_select launch that also gathers, each level's backward
# one gather and one pool_bwd_pair (the unpool and the logits' adjoint),
# each forward unpool one scatter
STEP_LAUNCHES = 106
STEP_POOL_LAUNCHES = {"rank_select": 4, "gather_rows": 4, "scatter_rows": 4,
                      "pool_bwd_pair": 4, "pool_logits_bwd": 0}
# launches of one GAT step at drop_p 0.01 (as many as at drop_p 0: each
# pool's dropout is drawn inside its two products) and of one validation
# pass
GAT_STEP_LAUNCHES, GAT_VAL_LAUNCHES = 83, 37
# the GAT U-Net's kernels (phase 7): no GSR-Net path launches them
GAT_NEW = ("gat_attention", "gat_attention_bwd", "philox_drop_logits",
           "philox_drop_outer", "gat_pool_adj", "col_softmax",
           "col_softmax_bwd", "offdiag_mse", "offdiag_mae", "adamw_masked")
# the GSR backward takes the logits' adjoint in pool_bwd_pair: only the
# GAT U-Net launches it alone; the keep mask alone is drawn by draw_masks
# and the keep-rate experiment's counterpart, on no trainer path
GAT_ONLY = GAT_NEW + ("pool_logits_bwd", "philox_keep_mask")
# the bf16 mode's kernels (phase 12): the product and the rounding instances
# of the pool, row and bias kernels; no fp32 path launches them
BF16_KERNELS = ("bgemm_bf16", "rank_select_bf16", "gather_rows_bf16",
                "scatter_rows_bf16", "pool_bwd_pair_bf16", "add_bias_bf16")
# the bf16 mode's autodiff-shaped pair: only unet_fused and
# step_value_and_grad_fused launch it (phase 12, check_bf16_ad_entry_points)
BF16_ONLY = BF16_KERNELS + ("pool_bwd_pair_bf16_ad",)


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
    from fcsr_tpu_torch.utils.timing import graph_ms
    return graph_ms([fn], reps)[0]


def bound(flops: float, nbytes: float, int_clocks: float = 0.0,
          peak_flops: float = PEAK_FP32_FLOPS):
    """(ms, bound_by): the largest of flops / ``peak_flops`` (fp32 outside
    the tensor cores unless given), bytes / HBM and ``int_clocks`` SM
    clocks of integer issue spread over every SM at its highest clock
    (``philox_clocks``)."""
    t_ops = flops / peak_flops
    if int_clocks:
        sms, hz = sm_clock()
        t_ops = max(t_ops, int_clocks / (sms * hz))
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# Integer issue per SM and clock on compute capability 9.0 (NVIDIA's
# arithmetic-throughput table for CUDA: 64 32-bit integer multiply-adds, 64
# adds, shifts and logic ops): IMAD runs on the FMA pipe, LOP3, IADD3 and
# VIADD on the ALU pipe, 64 lanes a clock each; the SM's four schedulers
# issue 128 lanes a clock in all
FMA_LANES, ALU_LANES, ISSUE_LANES = 64, 64, 128
_INT = {}


def sm_clock():
    """(SMs, the SM's highest clock in Hz: nvidia-smi clocks.max.sm)."""
    if "clock" not in _INT:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _INT["clock"] = (sms, mhz * 1e6)
    return _INT["clock"]


# The draw as compiled before the keep mask's per-plane kernel (its
# grid-stride body drew one element an iteration, the key schedule and
# 64-bit index divisions inside): instructions a draw by pipe (IMAD FMA
# pipe, LOP3 / IADD3 / VIADD ALU pipe, all) and the body's others a draw,
# measured on an H100 by philox_sass (PERF.md Findings)
PARENT_DRAW = {"fma": 18.0, "alu": 34.0, "all": 52.0, "other": 96.0}


def philox_sass():
    """Instructions of one Philox-4x32-10 draw as compiled, by pipe: from
    ``cuobjdump -sass`` of the built gat library, the body of
    ``philox_keep_mask_kernel``'s loop over its planes (its longest
    backward branch; of the 16-byte instance ``<4>`` where there is one),
    the draw's own instructions counted: the IMADs by the two Philox
    multipliers (FMA pipe), the XORs (LOP3 0x96 / 0x3c) and the key
    schedule's adds (IADD3 / VIADD of a multiple of a Weyl constant; ALU
    pipe); divided by the draws the body holds (the instance's template
    argument, one for a body without one; a draw takes 8-24 IMADs by the
    multipliers, or the count fails). Returns (per draw {"fma", "alu", "all",
    "other"}, the body's counts by (draw or other, opcode), draws in the
    body); the listing goes to ``chiprun_out/philox_keep_mask.sass``."""
    import re
    from fcsr_tpu_torch.kernels.build import build_all

    if "sass" in _INT:
        return _INT["sass"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(build_all()["gat"])],
                          capture_output=True, text=True, check=True).stdout
    parts = re.split(r"Function : (\S+)", text)
    bodies = {parts[i]: parts[i + 1] for i in range(1, len(parts), 2)
              if "philox_keep_mask_kernel" in parts[i]}
    name = next((k for k in bodies if "philox_keep_mask_kernelILi4E" in k),
                next(iter(bodies)))
    body = bodies[name]
    m = re.search(r"philox_keep_mask_kernelILi(\d+)E", name)
    draws = int(m.group(1)) if m else 1
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "philox_keep_mask.sass"), "w") as f:
        f.write(f"Function : {name}\n{body}")
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
        r"([^;]*);", body)]
    loops = [(int(m.group(1), 16), a) for a, op, rest in ins
             if op.startswith("BRA")
             for m in [re.search(r"0x([0-9a-f]+)", rest)]
             if m and int(m.group(1), 16) < a]
    lo, hi = max(loops, key=lambda l: l[1] - l[0])
    weyl = {(j * w) & 0xFFFFFFFF for w in (0x9E3779B9, 0xBB67AE85)
            for j in range(1, 10)}

    def imm(rest):
        return {(-int(h, 16) if sgn else int(h, 16)) & 0xFFFFFFFF
                for sgn, h in re.findall(r"(-?)0x([0-9a-f]+)", rest)}
    hist, muls = {}, 0
    for a, op, rest in ins:
        if not lo <= a <= hi:
            continue
        mul = op.startswith("IMAD") and bool(
            imm(rest) & {0xD2511F53, 0xCD9E8D57})
        muls += mul
        kind = ("draw" if mul or (op.startswith("LOP3") and re.search(
            r"0x(96|3c)\b", rest)) or (op.startswith(("IADD3", "VIADD"))
                                        and imm(rest) & weyl) else "other")
        hist[(kind, op)] = hist.get((kind, op), 0) + 1
    if not 8 * draws <= muls <= 24 * draws:
        fail(f"philox_sass: {muls} Philox products in {name}'s loop, not "
             f"8-24 for each of its {draws} draws")
    fma = sum(c for (kind, op), c in hist.items()
              if kind == "draw" and op.startswith("IMAD"))
    total = sum(c for (kind, _), c in hist.items() if kind == "draw")
    other = sum(c for (kind, _), c in hist.items() if kind == "other")
    per = {"fma": fma / draws, "alu": (total - fma) / draws,
           "all": total / draws, "other": other / draws}
    _INT["sass"] = (per, hist, draws)
    old = PARENT_DRAW
    print(f"    Philox-4x32-10 draw as compiled ({name}, {draws} draws a "
          f"loop body): {per['fma']:g} IMAD (FMA pipe), {per['alu']:g} LOP3 "
          f"/ IADD3 / VIADD (ALU pipe), {per['all']:g} in all, "
          f"{per['other']:g} other a draw: {philox_clocks(1):.4f} SM clocks "
          f"a draw; the parent's {old['fma']:g} / {old['alu']:g} / "
          f"{old['all']:g}, {old['other']:g} other: "
          f"{philox_clocks(1, old):.4f}", flush=True)
    return _INT["sass"]


def philox_clocks(draws: int, per=None) -> float:
    """SM clocks of integer issue for ``draws`` Philox draws as compiled:
    per draw the most of its IMADs over the FMA pipe's lanes, its ALU
    instructions over the ALU pipe's and all of them over the SM's issue
    (``philox_sass``; ``per``: another count, as ``PARENT_DRAW``)."""
    per = per or philox_sass()[0]
    return draws * max(per["fma"] / FMA_LANES, per["alu"] / ALU_LANES,
                       per["all"] / ISSUE_LANES)


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
    """(name, kernel call, plain call, rel tolerance (or one per output),
    flops, bytes,
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

    # the pool at level 0 (160 -> 144), one launch: scores, ranks and the
    # gathered rows, with constructed exact ties and a NaN score. Bytes:
    # the logits and the k0 kept source rows read, s, slot, idx, vals,
    # pre and x written
    n0, k0 = LR, pool_sizes(LR, KS)[0]
    logits = rnd(F, n0, scale=100.0)
    logits[:, 10:20] = logits[:, 30:31]           # a 10-way tie
    logits[:, 100] = logits[:, 5]
    with_nan = logits.clone()
    with_nan[1, 7] = float("nan")
    d = rnd(F, n0, m)
    cases.append(("rank_select", lambda: K.rank_select(with_nan, k0, src=d),
                  lambda: P.rank_select(with_nan, k0, src=d), 0.0,
                  float(F * (n0 * n0 + k0 * m)),
                  f4 * (3 * n0 + 2 * k0 + 3 * k0 * m), None))

    s, idx, vals, slot = K.rank_select(logits, k0)
    # the backward's gather (unscaled) and its one library call, with the
    # int64 index made once, outside the timed call
    gx, idx64 = rnd(F, n0, m), idx.long()[..., None]
    cases.append(("gather_rows", lambda: K.gather_rows(gx, idx),
                  lambda: P.gather_rows(gx, idx), 0.0,
                  0.0, f4 * (2 * k0 * m + k0),
                  lambda: torch.take_along_dim(gx, idx64, 1)))
    # the unpool and the pool's adjoints at level 0 (144 kept of 160 rows
    # of 268): the forward's scatter (the GSR step's 4 launches), the
    # logits' adjoint alone (the GAT step's form) and the GSR backward's
    # pair; a scatter and the pair's g_d exactly, the adjoint's dot to
    # 1e-5 (another sum order)
    gp, skip = rnd(F, k0, m), rnd(F, n0, m)
    cases.append(("scatter_rows", lambda: K.scatter_rows(gp, slot),
                  lambda: P.scatter_rows(gp, slot), 0.0,
                  0.0, f4 * (k0 * m + n0 * m + n0), None))
    pre = rnd(F, k0, m)
    cases.append(("pool_logits_bwd",
                  lambda: K.pool_logits_bwd(gp, pre, slot, s),
                  lambda: P.pool_logits_bwd(gp, pre, slot, s), 1e-5,
                  2.0 * F * k0 * m, f4 * (2 * k0 * m + 3 * n0), None))
    cases.append(("pool_bwd_pair",
                  lambda: K.pool_bwd_pair(gp, pre, slot, s, vals, skip),
                  lambda: P.pool_bwd_pair(gp, pre, slot, s, vals, skip),
                  (0.0, 1e-5), 2.0 * F * (k0 * m + n0 * m),
                  f4 * (2 * k0 * m + 2 * n0 * m + 3 * n0 + k0), None))
    from fcsr_tpu_torch.models.fused_step import FlatLayout
    layout = FlatLayout(LR, HR, len(KS))
    leaves = layout.views(rnd(F, layout.size))     # the step's own views
    w, bb = leaves["w:start_gcn"], leaves["b:start_gcn"]
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

    n_p = layout.size
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

    # the data-path kernels at the CSV path's shapes: ingest of the 167
    # HR training vectors, and the 112 test subjects' predictions / LR
    # stack. Bytes: what the function must move (the vector entries it
    # reads or writes, the dense stack once).
    L = HR * (HR - 1) // 2
    vec = rnd(N_TRAIN, L).abs()
    cases.append(("anti_vectorize_normalize",
                  lambda: K.anti_vectorize_normalize(vec, HR, False),
                  lambda: P.anti_vectorize_normalize(vec, HR, False), 0.0,
                  0.0, 4.0 * N_TRAIN * (L + HR * HR), None))
    preds = rnd(N_TEST, HR, HR)
    col_idx = _colmajor_flat_index(HR, dev)
    cases.append(("vectorize_colmajor",
                  lambda: K.vectorize_colmajor(preds),
                  lambda: P.vectorize_colmajor(preds), 0.0,
                  0.0, 4.0 * N_TEST * 2 * L,
                  lambda: preds.flatten(1).index_select(1, col_idx)))
    lr = rnd(N_TEST, LR, LR).abs()
    cases.append(("normalize_adj_batch",
                  lambda: K.normalize_adj_batch(lr),
                  lambda: P.normalize_adj_batch(lr), 1e-6,
                  3.0 * N_TEST * LR * LR, 4.0 * N_TEST * 2 * LR * LR, None))
    return cases


def _colmajor_flat_index(n, dev):
    """Flat index i * n + j of the strict upper triangle walked column by
    column: the one-call equivalent of ``vectorize_colmajor`` is
    ``m.flatten(1).index_select(1, idx)``."""
    j, i = np.tril_indices(n, -1)
    return torch.from_numpy((i * n + j).astype(np.int64)).to(dev)


# anti_vectorize_normalize beyond its record: the CSV path's three
# launches (B, n), the CPU tests' tile-run sizes, a large n, and batches
# past the grid's y extent of 65 535 matrices
TRIU_CSV_SHAPES = ((N_TRAIN, LR), (N_TRAIN, HR), (N_TEST, LR))
ANTIVEC_SIZES = (2, 3, 31, 32, 33, 64, LR, HR)
ANTIVEC_LARGE = (2, 1300)
ANTIVEC_PAST_GRID_Y = 65537
# the copy's output rows beside n = 268's 1 072 bytes: rows of a multiple
# of 32 bytes (256, 264 with 16-byte rows, 272) at the CSV path's B
ANTIVEC_ROW_SIZES = (256, 264, 272)


def _antivec_vectors(B, n, g, dev, extra=0, pad=0):
    """(B, m + extra) vectors in [0, 1) with -0.0 entries: a view of rows
    ``pad`` floats longer (trailing entries, a row stride past them)."""
    m = n * (n - 1) // 2
    buf = torch.rand(B, m + extra + pad, generator=g)
    buf[:, ::7] = -0.0
    return buf.to(dev)[:, :m + extra]


def check_triu_kernels(dev):
    """The data-path kernels beyond their main record.
    ``anti_vectorize_normalize`` in both forms of its plan (the copy, the
    normalised cluster), each with and without 16-byte stores, at the CSV
    path's shapes, the tile-run sizes 2 to 268 with trailing entries and a
    longer row stride, n 1300 / 1301 and 65 537 matrices (past the grid's
    y extent), with and without a diagonal fill: the copy bit-equal to the
    plain version (-0.0 entries made +0.0), the normalised form within
    1e-6, each bit-equal run to run and graphed; then ``triu_times``.
    ``vectorize_colmajor`` as ``check_colmajor`` says; ``normalize_adj_batch``
    at small odd sizes, and the guard (a zero row sum gives 0, a negative
    one NaN) in both normalising kernels."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import antivec_plan

    g = torch.Generator(device="cpu").manual_seed(2)

    def same(name, got, want, tol):
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            fail(f"{name}: NaN pattern differs from the plain version")
        err = max_err(torch.nan_to_num(got), torch.nan_to_num(want))
        limit = tol * scale_of(torch.nan_to_num(want))
        if not err <= limit:
            fail(f"{name}: max|err| {err:.3e} above {limit:.1e}")
        return err

    props = torch.cuda.get_device_properties(dev)
    cases = [(B, n, 0, 0, 0.0) for B, n in TRIU_CSV_SHAPES]
    cases += [(3, n, 7, 5, fill) for n in ANTIVEC_SIZES for fill in (0.0,
                                                                     1.0)]
    cases += [ANTIVEC_LARGE + (7, 5, 0.0), (2, ANTIVEC_LARGE[1] + 1, 7, 5,
                                           1.0)]
    cases += [(ANTIVEC_PAST_GRID_Y, 3, 7, 5, 0.0),
              (ANTIVEC_PAST_GRID_Y, 4, 0, 0, 1.0)]
    forms, worst = set(), 0.0
    for B, n, extra, pad, fill in cases:
        v = _antivec_vectors(B, n, g, dev, extra, pad)
        for norm in (False, True):
            kern = lambda: K.anti_vectorize_normalize(v, n, norm, fill)
            got, again = kern(), kern()
            want = P.anti_vectorize_normalize(v, n, norm, fill)
            graphed = _graph_outputs(kern)
            plan = antivec_plan(B, n, norm,
                                props.shared_memory_per_block_optin,
                                props.multi_processor_count)
            forms.add((plan.form, plan.vec))
            label = (f"anti_vectorize_normalize B={B} n={n} norm={int(norm)}"
                     f" fill={fill} form {plan.form}")
            err = same(label, got, want, 1e-6 if norm else 0.0)
            worst = max(worst, err)
            if not norm and not torch.equal(_bits(got), _bits(want)):
                fail(f"{label}: not bit-equal to the plain version")
            if not (torch.equal(_bits(got), _bits(again))
                    and torch.equal(_bits(got), _bits(graphed))):
                fail(f"{label}: two launches or the graphed launch differ")
    if forms != {(f, v) for f in (0, 1) for v in (False, True)}:
        fail(f"anti_vectorize_normalize: (form, 16-byte) {sorted(forms)} "
             "ran, not all four")
    print(f"  anti_vectorize_normalize: {len(cases)} shapes x normalize 0 / 1"
          f", (form, 16-byte) {sorted(forms)}: the copy bit-equal, "
          f"normalised max|err| "
          f"{worst:.2e}, bit-equal run to run and graphed", flush=True)
    check_colmajor(dev, g)
    for n in (2, 3, 33, LR, HR):
        a = torch.rand(5, n, n, generator=g).to(dev)
        same(f"normalize_adj_batch n={n}", K.normalize_adj_batch(a),
             P.normalize_adj_batch(a), 1e-6)
    # the guard: row 1 sums to zero, row 2 to a negative number
    for n in (33, 70):
        v = torch.rand(3, n * (n - 1) // 2, generator=g)
        dense = P.anti_vectorize_normalize(v, n, False)
        dense[:, 1, :] = 0.0
        dense[:, :, 1] = 0.0
        dense[:, 2, 5] = dense[:, 5, 2] = -4.0 * n
        rows, cols = np.triu_indices(n, 1)
        v = dense[:, rows, cols].contiguous().to(dev)
        dense = dense.to(dev)
        for name, got, want in (
                ("anti_vectorize_normalize",
                 K.anti_vectorize_normalize(v, n, True),
                 P.anti_vectorize_normalize(v, n, True)),
                ("normalize_adj_batch", K.normalize_adj_batch(dense),
                 P.normalize_adj_batch(dense))):
            same(f"{name} guard n={n}", got, want, 1e-6)
            if not (bool((got[:, 1, 3] == 0).all())
                    and bool(torch.isnan(got[:, 2]).all())
                    and bool(torch.isfinite(got[:, 3, 4]).all())):
                fail(f"{name}: zero row sum must give 0, a negative one NaN")
    print("  data-path kernels: shapes, odd sizes, trailing entries, "
          "diagonal fill and the zero / negative row-sum guard ok")
    triu_times(dev)


# vectorize_colmajor beyond its record: every tile shape (one partial
# tile, 31 / 32 / 33 columns, several tiles, the CSV path's widths, a
# large n), an odd batch whose last block holds one matrix, and batches
# past the grid's y extent (65 535 pairs of matrices) at a small n; timed
# at the predict command's shape and beside it
COLMAJOR_SIZES = (2, 3, 31, 32, 33, 64, LR, HR, 1300)
COLMAJOR_PAST_GRID_Y = ((65537, 3), (65537, 33), (131073, 3))
COLMAJOR_TIMES = ((N_TEST, HR), (N_TRAIN, HR), (N_TEST, LR))


def _colmajor_mats(B, n, g, dev):
    """(B, n, n) matrices, not symmetric, with -0.0 and NaN entries (one
    NaN with a payload) on both sides of the diagonal."""
    mats = torch.randn(B, n, n, generator=g)
    flat = mats.view(B, -1)
    flat[:, ::5] = -0.0
    flat[:, 3::11] = float("nan")
    flat[:, 1::17] = torch.tensor(0x7FC00ABC, dtype=torch.int32).view(
        torch.float32)
    return mats.to(dev)


def check_colmajor(dev, g):
    """``vectorize_colmajor`` (a block per upper tile and pair of
    matrices) bit for bit against its plain version at every
    ``COLMAJOR_SIZES`` width (B 5: the last block one matrix) and at
    65 537 and 131 073 matrices (the last past the grid's y extent), on
    non-symmetric inputs with -0.0 and NaN entries; two launches and a
    graphed launch bit-equal."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import colmajor_plan

    cases = [(5, n) for n in COLMAJOR_SIZES] + list(COLMAJOR_PAST_GRID_Y)
    for B, n in cases:
        mats = _colmajor_mats(B, n, g, dev)
        kern = lambda: K.vectorize_colmajor(mats)
        got, again = kern(), kern()
        graphed = _graph_outputs(kern)
        want = P.vectorize_colmajor(mats)
        torch.cuda.synchronize()
        label = f"vectorize_colmajor B={B} n={n} {colmajor_plan(B, n)}"
        if not torch.equal(_bits(got), _bits(want)):
            fail(f"{label}: not bit-equal to the plain version")
        if not (torch.equal(_bits(got), _bits(again))
                and torch.equal(_bits(got), _bits(graphed))):
            fail(f"{label}: two launches or the graphed launch differ")
        del mats, got, again, graphed, want
    print(f"  vectorize_colmajor: {len(cases)} shapes (n {COLMAJOR_SIZES}, "
          f"B x n {COLMAJOR_PAST_GRID_Y}), -0.0 and NaN entries: bit-equal "
          "to the plain version, run to run and graphed", flush=True)


def cold_ms(fn, reps: int = 11) -> float:
    """Device ms of one call with nothing of its inputs in L2: before each
    call 256 MB (five times the H100's 50 MB L2) are written, which also
    keeps the device busy while the host launches the call; the median
    over ``reps`` calls by CUDA events."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                        device=torch.cuda.current_device())
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del flush
    return statistics.median(times)


def triu_times(dev):
    """``anti_vectorize_normalize`` at the CSV path's three shapes, at
    normalize 0 and 1: device ms per launch in a CUDA graph, in turns with
    its plain version (v, 8.5-24 MB, stays in L2 across the graph's
    launches), and cold (``cold_ms``: L2 flushed before each launch, as
    the CSV path's one launch a command finds it), beside its bound (v
    read once, B n^2 floats written; normalised also 3 B n^2 FLOPs);
    eager ms and host us per call (``_eager_and_host``); then the copy at
    ``ANTIVEC_ROW_SIZES``, warm and cold; then ``colmajor_times``. It
    calls only the public wrappers, so it also times an older tree of the
    port (load this file by path with that tree's root as the working
    directory). Returns {(B, n, normalize): (ms, cold ms, eager ms, host
    us, plain ms)} and ``colmajor_times``'s records."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device="cpu").manual_seed(11)
    out = {}
    for B, n in TRIU_CSV_SHAPES:
        m = n * (n - 1) // 2
        v = torch.rand(B, m, generator=g).to(dev)
        for norm in (False, True):
            kern = lambda: K.anti_vectorize_normalize(v, n, norm)
            k_ms, p_ms = graph_ms(
                [kern, lambda: P.anti_vectorize_normalize(v, n, norm)])
            cold = cold_ms(kern)
            eager, host = _eager_and_host(kern)
            b_ms, b_by = bound(3.0 * B * n * n if norm else 0.0,
                               4.0 * B * (m + n * n))
            print(f"    anti_vectorize_normalize B={B} n={n} normalize="
                  f"{int(norm)}: {k_ms:.5f} ms per launch (plain {p_ms:.5f},"
                  f" bound {b_ms:.5f} {b_by}), cold {cold:.5f}; {eager:.5f} "
                  f"ms eager, host {host:.3f} us", flush=True)
            out[(B, n, norm)] = (k_ms, cold, eager, host, p_ms)
    B = N_TRAIN
    for n in ANTIVEC_ROW_SIZES:
        m = n * (n - 1) // 2
        v = torch.rand(B, m, generator=g).to(dev)
        kern = lambda: K.anti_vectorize_normalize(v, n, False)
        k_ms = graph_ms([kern])[0]
        cold = cold_ms(kern)
        b_ms, _ = bound(0.0, 4.0 * B * (m + n * n))
        print(f"    anti_vectorize_normalize B={B} n={n} normalize=0 (rows "
              f"of {4 * n} bytes): {k_ms:.5f} ms per launch, cold "
              f"{cold:.5f} (bound {b_ms:.5f} bytes)", flush=True)
        out[(B, n, False)] = (k_ms, cold, None, None, None)
    out.update(colmajor_times(dev))
    return out


def colmajor_times(dev):
    """``vectorize_colmajor`` at ``COLMAJOR_TIMES``: device ms per launch
    in a CUDA graph, in turns with its plain version and the library call
    (``index_select`` of the flat upper-triangle index), cold
    (``cold_ms``), eager ms and host us per call, beside its bound (the
    strict upper triangle read once, B n (n - 1) / 2 floats written). It
    calls only the public wrapper, so it also times an older tree (or one
    whose ``triu.cu`` was edited: load this file by path with that tree's
    root as the working directory). Returns {("colmajor", B, n): (ms,
    cold ms, eager ms, host us, plain ms, library ms)}."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device="cpu").manual_seed(13)
    out = {}
    for B, n in COLMAJOR_TIMES:
        mats = torch.rand(B, n, n, generator=g).to(dev)
        idx = _colmajor_flat_index(n, dev)
        kern = lambda: K.vectorize_colmajor(mats)
        k_ms, p_ms, l_ms = graph_ms(
            [kern, lambda: P.vectorize_colmajor(mats),
             lambda: mats.flatten(1).index_select(1, idx)])
        cold = cold_ms(kern)
        eager, host = _eager_and_host(kern)
        b_ms, b_by = bound(0.0, 8.0 * B * (n * (n - 1) // 2))
        print(f"    vectorize_colmajor B={B} n={n}: {k_ms:.5f} ms per launch "
              f"(plain {p_ms:.5f}, library {l_ms:.5f}, bound {b_ms:.5f} "
              f"{b_by}), cold {cold:.5f}; {eager:.5f} ms eager, host "
              f"{host:.3f} us", flush=True)
        out[("colmajor", B, n)] = (k_ms, cold, eager, host, p_ms, l_ms)
    return out


# (F, m) of the tail adjoint beyond its main record: odd and wider widths,
# one fold to five; 1000 and 3500 need more than 48 KB of shared memory per
# band, and 3500 more than the card has at 8 and 4 rows (the kernel halves
# its rows per band to 2)
TAIL_BWD_SHAPES = tuple((nf, m) for m in (37, HR, 300) for nf in (1, 3, 5)) \
    + ((1, 1000), (1, 3500))


def check_band_kernels(dev):
    """The two launch-floor redesigns beyond their main record.
    ``tail_normalize_bwd`` at every ``TAIL_BWD_SHAPES`` entry against its
    plain version (within 1e-5 of the largest entry), two launches
    bit-equal, and the widths that need more than 48 KB of shared memory
    timed in a CUDA graph (their launches captured, as a step's would be).
    ``add_bias`` exact on the step's own ``FlatLayout`` views (16-byte
    aligned: checked) and on views 1-3 floats off 16 bytes, each timed in
    turns with ``torch.add``."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.models.fused_step import FlatLayout
    from fcsr_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device="cpu").manual_seed(3)
    for nf, m in TAIL_BWD_SHAPES:
        t = (torch.randn(nf, m, m, generator=g) * 0.1).to(dev)
        gadj = torch.randn(nf, m, m, generator=g).to(dev)
        _, r = K.tail_normalize(t)
        got = [K.tail_normalize_bwd(gadj, t, r) for _ in range(2)]
        want = P.tail_normalize_bwd(gadj, t, r)
        torch.cuda.synchronize()
        err, limit = max_err(got[0], want), 1e-5 * scale_of(want)
        if not err <= limit:
            fail(f"tail_normalize_bwd F={nf} m={m}: max|err| {err:.3e} above "
                 f"{limit:.1e}")
        if not torch.equal(got[0], got[1]):
            fail(f"tail_normalize_bwd F={nf} m={m}: two launches differ")
        print(f"    tail_normalize_bwd F={nf} m={m}: max|err| {err:.2e} "
              f"(limit {limit:.1e}), bit-equal", flush=True)
        if m >= 1000:
            ms, = graph_ms([lambda: K.tail_normalize_bwd(gadj, t, r)])
            print(f"    tail_normalize_bwd F={nf} m={m}: {ms:.4f} ms in a "
                  f"CUDA graph", flush=True)

    layout = FlatLayout(LR, HR, len(KS))
    flat = torch.randn(F, layout.size, generator=g).to(dev)
    leaves = layout.views(flat)
    views = [("FlatLayout w:start_gcn + b:start_gcn", leaves["w:start_gcn"],
              leaves["b:start_gcn"])]
    if any(v.data_ptr() % 16 for _, *vs in views for v in vs) \
            or flat.stride(0) % 4:
        fail("add_bias: the step's views are not 16-byte aligned")
    buf = torch.randn(F, LR * HR + HR + 3, generator=g).to(dev)
    for off in (1, 2, 3):
        views.append((f"views {off} float(s) off 16 bytes",
                      buf[:, off:off + LR * HR].view(F, LR, HR),
                      buf[:, off + LR * HR:off + LR * HR + HR]
                      .view(F, 1, HR)))
    for label, w, b in views:
        got = [K.add_bias(w, b) for _ in range(2)]
        torch.cuda.synchronize()
        if not (torch.equal(got[0], P.add_bias(w, b))
                and torch.equal(got[0], got[1])):
            fail(f"add_bias on {label}: not exact")
        k_ms, l_ms = graph_ms([lambda: K.add_bias(w, b),
                               lambda: torch.add(w, b)])
        print(f"    add_bias {label}: exact, bit-equal; kernel {k_ms:.4f} ms,"
              f" torch.add {l_ms:.4f} ms", flush=True)


def _nan_aware_err(got, want):
    """max|err| over the entries where neither is NaN, or inf when the
    two disagree on where NaN is."""
    nan = torch.isnan(want)
    if not torch.equal(nan, torch.isnan(got)):
        return float("inf")
    return max_err(got[~nan], want[~nan])


def _same(got, want, bits: bool = False) -> bool:
    """Equal entry for entry, NaN where NaN (any NaN payload); ``bits``:
    the same float32 bits too (-0.0 is not +0.0)."""
    nan = torch.isnan(want)
    if not torch.equal(nan, torch.isnan(got)):
        return False
    if bits:
        got, want = _bits(got), _bits(want)
    return torch.equal(got[~nan], want[~nan])


def _bits(t):
    """A float32 tensor's bits (int32), so two launches compare bit for
    bit, NaN payloads included; other tensors as they are."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _check_norm(label, got, want):
    """tail_normalize's (adj, r) against the plain version: within 1e-5 of
    the largest finite entry, NaN where the plain version has NaN."""
    for name, a, b in (("adj", got[0], want[0]), ("r", got[1], want[1])):
        fin = b[torch.isfinite(b)]
        err = _nan_aware_err(a, b)
        limit = 1e-5 * scale_of(fin if fin.numel() else b.new_ones(1))
        if not err <= limit:
            fail(f"tail_normalize {label}: {name} max|err| {err:.3e} above "
                 f"{limit:.1e}")
    return _nan_aware_err(got[0], want[0])


def check_tail_reductions(dev):
    """The two cluster kernels beyond their main record.

    ``tail_normalize`` at every ``TAIL_BWD_SHAPES`` entry under the plan
    its wrapper takes (adj and r within 1e-5 of the largest entry, two
    launches bit-equal), on inputs with an all-zero off-diagonal row and
    with an inf entry (NaN exactly where the plain version has it); the
    widths past 48 KB of shared memory per block timed in a CUDA graph.

    ``l1_term`` at the step's three call signatures (net / x0 with sign(0)
    = 0 and the negation, pred / hr, the ``FlatLayout`` leaf view
    ``layer.weights`` / u_hr), on operands 1-3 floats off 16 bytes, all
    with exact ties a == b: grad and neg exact, the value within 1e-6
    relative, two launches bit-equal, each timed in turns with the plain
    version; at slot 2 also with the loss scalars: ``loss`` bit-equal to
    ``vals[0] + (vals[1] + vals[2])`` of the launch's own ``vals`` (and
    without ``with_l1`` to ``vals[1] + vals[2]``, a NaN in slot 0 unread),
    ``recon`` to ``vals[1]``, the gradient unchanged."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import l1_term_plan, tail_normalize_plan
    from fcsr_tpu_torch.models.fused_step import FlatLayout
    from fcsr_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device="cpu").manual_seed(4)
    smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    for nf, m in TAIL_BWD_SHAPES:
        t = rnd(nf, m, m, scale=0.1)
        got = [K.tail_normalize(t) for _ in range(2)]
        err = _check_norm(f"F={nf} m={m}", got[0], P.tail_normalize(t))
        if not (torch.equal(got[0][0], got[1][0])
                and torch.equal(got[0][1], got[1][1])):
            fail(f"tail_normalize F={nf} m={m}: two launches differ")
        plan = tail_normalize_plan(m, True, smem)
        line = (f"    tail_normalize F={nf} m={m} (16 x {plan.rows} rows, "
                f"{'staged' if plan.staged else 'chunks of %d' % plan.chunk}): "
                f"max|err| {err:.2e}, bit-equal")
        if m >= 1000:
            ms, = graph_ms([lambda: K.tail_normalize(t)])
            line += f", {ms:.4f} ms in a CUDA graph"
        print(line, flush=True)

    m = HR
    t = rnd(F, m, m, scale=0.1)
    t[1, 5, :] = 0.0                        # an all-zero off-diagonal row
    _check_norm("with a zero row", K.tail_normalize(t), P.tail_normalize(t))
    t[2, 7, 9] = float("inf")               # r_7 = 0, adj[9, 7] NaN
    _check_norm("with an inf entry", K.tail_normalize(t),
                P.tail_normalize(t))
    print("    tail_normalize: zero row and inf entry as the plain version",
          flush=True)

    layout = FlatLayout(LR, HR, len(KS))
    leaves = layout.views(rnd(F, layout.size))

    def tie(a, b):               # exact ties on every 7th row, 5th column
        b = b.clone()
        b[:, ::7, ::5] = a[:, ::7, ::5]
        return b

    net = rnd(F, LR, HR)
    pred = rnd(F, HR, HR)
    wg = leaves["layer.weights"]
    cases = [("net / x0", net, tie(net, rnd(F, LR, HR)), 0, 16.0,
              16.0 / (LR * HR), True, True),
             ("pred / hr", pred, tie(pred, rnd(F, HR, HR)), 1, 1.0,
              1.0 / (HR * HR), False, False),
             ("layer.weights / u_hr", wg, tie(wg, rnd(F, HR, LR)), 2, 1.0,
              1.0 / (HR * LR), False, False)]
    for off in (1, 2, 3):
        n = HR * LR
        ba, bb = rnd(F, n + 4), rnd(F, n + 4)
        a = ba[:, off:off + n].view(F, HR, LR)
        cases.append((f"views {off} float(s) off 16 bytes", a,
                      tie(a, bb[:, off:off + n].view(F, HR, LR)), 2, 1.0,
                      1.0 / n, False, False))
    for i, (label, a, b, slot, vs, gs, zs, neg) in enumerate(cases):
        if l1_term_plan(a, b).vec != (i < 3):
            fail(f"l1_term {label}: 16-byte path {l1_term_plan(a, b)}")
        vk = [torch.zeros(F, 3, device=dev) for _ in range(2)]
        got = [K.l1_term(a, b, v, slot, vs, gs, zs, neg) for v in vk]
        vp = torch.zeros(F, 3, device=dev)
        want = P.l1_term(a, b, vp, slot, vs, gs, zs, neg)
        torch.cuda.synchronize()
        got0 = got[0] if neg else (got[0],)
        want0 = want if neg else (want,)
        if not all(torch.equal(x, y) for x, y in zip(got0, want0)):
            fail(f"l1_term {label}: gradient not exact")
        rel = float(((vk[0][:, slot].double() - vp[:, slot].double()).abs()
                     / vp[:, slot].double().abs()).max())
        if not rel <= 1e-6:
            fail(f"l1_term {label}: value off by {rel:.2e} relative")
        got1 = got[1] if neg else (got[1],)
        if not (torch.equal(vk[0], vk[1])
                and all(torch.equal(x, y) for x, y in zip(got0, got1))):
            fail(f"l1_term {label}: two launches differ")
        k_ms, p_ms = graph_ms(
            [lambda: K.l1_term(a, b, vk[0], slot, vs, gs, zs, neg),
             lambda: P.l1_term(a, b, vp, slot, vs, gs, zs, neg)])
        print(f"    l1_term {label} ({l1_term_plan(a, b)}): grad exact, "
              f"value {rel:.1e} relative, bit-equal; kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms", flush=True)
        if slot == 2:
            _check_l1_loss(label, K, a, b, gs, got0[0])


def _check_l1_loss(label, K, a, b, gs, grad):
    """``l1_term``'s slot-2 launch with the loss scalars, against its own
    ``vals`` summed in ``adam_masked``'s order: slots 0 and 1 preset to 1
    and 2^-24, slot 0 NaN without ``with_l1`` (it must not be read)."""
    dev = a.device
    for with_l1 in (True, False):
        vals = torch.tensor([[1.0, 2.0 ** -24, 0.0]] * F, device=dev)
        if not with_l1:
            vals[:, 0] = float("nan")
        loss, recon = torch.empty(F, device=dev), torch.empty(F, device=dev)
        got = K.l1_term(a, b, vals, 2, 1.0, gs, False, loss=loss,
                        recon=recon, with_l1=with_l1)
        tail = vals[:, 1] + vals[:, 2]
        want = vals[:, 0] + tail if with_l1 else tail
        torch.cuda.synchronize()
        if not (torch.equal(_bits(loss), _bits(want))
                and torch.equal(_bits(recon), _bits(vals[:, 1]))
                and torch.equal(got, grad)):
            fail(f"l1_term {label} with_l1={with_l1}: loss {loss.tolist()} "
                 f"recon {recon.tolist()}, not {want.tolist()} and "
                 f"{vals[:, 1].tolist()} (or the gradient moved)")
    print(f"    l1_term {label}: loss and recon bit-equal to its vals in "
          "adam_masked's order, with_l1 1 / 0", flush=True)


# (n, k, cols, div) of every pool of the two steps: GSR-Net's four (rows
# of 268, scores / 100; n 101 and 61 are not multiples of 4) and the GAT
# U-Net's three (rows of 32 / 64 / 128, scores / 1)
GSR_POOLS = ((160, 144, HR, 100.0), (144, 101, HR, 100.0),
             (101, 61, HR, 100.0), (61, 30, HR, 100.0))
GAT_POOLS = ((160, 80, 32, 1.0), (80, 40, 64, 1.0), (40, 20, 128, 1.0))
# (n, k, cols, div, F) off the steps: the widest fold (two passes over the
# nodes) and rows of widths that take 4-byte accesses
POOL_WIDE = ((1024, 1000, 30, 100.0, 1), (300, 129, 7, 1.0, F))


def _pool_logits(g, nf, n, div, dev):
    """Scores over the sigmoid's range with exact ties; the caller adds
    NaN scores where it wants them."""
    logits = torch.randn(nf, n, generator=g, device=dev) * (
        100.0 if div == 100.0 else 3.0)
    logits[:, 3:7] = logits[:, 9:10]              # a 5-way tie
    logits[:, n - 1] = logits[:, 0]               # a tie across the row
    return logits


def check_pools(dev):
    """Phase 2, the pool: ``rank_select``'s one launch (scores, ranks and
    the gathered rows) at every pool of both steps x F (3, 56), with exact
    ties and NaN scores: s, idx, vals, slot, pre and x equal to the plain
    version's entry for entry (NaN where NaN), two launches bit-equal, one
    launch captured in a CUDA graph bit-equal, the rank-only launch equal
    to the fused one's indices; ``gather_rows`` (the backward's, and with
    a scale) at the same pools, exact and graphed. Then ``pool_times``."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import gather_rows_plan, rank_select_plan

    smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    g = torch.Generator(device=dev).manual_seed(8)
    names = ("s", "idx", "vals", "slot", "pre", "x")
    cases = [pool + (nf,) for pool in GSR_POOLS + GAT_POOLS
             for nf in (F, 56)] + list(POOL_WIDE)
    for n, k, cols, div, nf in cases:
        logits = _pool_logits(g, nf, n, div, dev)
        logits[0, 1] = float("nan")
        logits[nf - 1, n - 2:] = float("nan")    # NaN among the last
        src = torch.randn(nf, n, cols, generator=g, device=dev)
        call = lambda logits=logits, src=src, k=k, div=div: \
            K.rank_select(logits, k, div, src=src)
        got = [call(), call()]
        graphed = _graph_outputs(call)
        bare = K.rank_select(logits, k, div)
        want = P.rank_select(logits, k, div, src=src)
        torch.cuda.synchronize()
        plan = rank_select_plan(nf, n, k, cols, smem)
        label = (f"rank_select {n} -> {k} x {cols} F={nf} div={div:g} "
                 f"({plan.bands} bands of {plan.rows} rows, "
                 f"{plan.lanes} lanes per node, "
                 f"{16 if plan.vec else 4}-byte rows)")
        bad = [nm for nm, a, b in zip(names, got[0], want)
               if not _same(a, b)]
        if bad:
            fail(f"{label}: {bad} differ from the plain version")
        if not all(torch.equal(_bits(a), _bits(b)) and torch.equal(
                _bits(a), _bits(c)) for a, b, c in zip(got[0], got[1],
                                                       graphed)):
            fail(f"{label}: two launches or the graphed launch differ")
        if not all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(got[0][:4], bare)):
            fail(f"{label}: the rank-only launch differs")
        idx, vals = got[0][1], got[0][2]
        gx = torch.randn(nf, n, cols, generator=g, device=dev)
        gplan = gather_rows_plan(nf, k, cols)
        outs = (K.gather_rows(gx, idx), K.gather_rows(gx, idx, vals),
                _graph_outputs(lambda gx=gx, idx=idx: K.gather_rows(
                    gx, idx)))
        plains = (P.gather_rows(gx, idx), P.gather_rows(gx, idx, vals))
        torch.cuda.synchronize()
        if not (torch.equal(outs[0], plains[0])
                and all(_same(a, b) for a, b in zip(outs[1], plains[1]))
                and torch.equal(outs[0], outs[2])):
            fail(f"gather_rows {n} -> {k} x {cols} F={nf}: differs from "
                 "the plain version or in a graph")
        print(f"    {label}: every output exact, bit-equal, graphed; "
              f"gather_rows ({gplan.bands} bands of {gplan.rows} rows, "
              f"{gplan.threads} threads) exact, scaled exact, graphed",
              flush=True)
    print(f"  pools ok: {len(cases)} cases (7 pools x F 3 / 56, 2 wide)",
          flush=True)
    pool_times(dev)


def pool_times(dev):
    """Device ms per launch in a CUDA graph at every pool of both steps
    (GSR-Net's at F = 3, the GAT U-Net's at F = 3 and the validation's
    56): the forward pool (this tree's one ``rank_select`` launch, or an
    older tree's ``rank_select`` + ``gather_rows``) beside its plain
    version and bound, and the backward's ``gather_rows`` beside
    ``torch.take_along_dim`` and its plain version. It calls only those two
    kernel ops and detects the older contract, so it also times an older
    tree of the port: load this file by path with that tree's root as the
    working directory. Returns {(n, k, cols, F): (pool ms, gather ms)}."""
    import inspect

    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    fused = "src" in inspect.signature(K.rank_select).parameters
    g = torch.Generator(device=dev).manual_seed(9)
    shapes, calls = [], []
    for n, k, cols, div in GSR_POOLS + GAT_POOLS:
        for nf in ((F,) if div == 100.0 else (F, 56)):
            logits = _pool_logits(g, nf, n, div, dev)
            src = torch.randn(nf, n, cols, generator=g, device=dev)
            gx = torch.randn(nf, n, cols, generator=g, device=dev)
            idx = K.rank_select(logits, k, div)[1]
            idx64 = idx.long()[..., None]
            if fused:
                def pool(logits=logits, src=src, k=k, div=div):
                    return K.rank_select(logits, k, div, src=src)
            else:
                def pool(logits=logits, src=src, k=k, div=div):
                    _, ix, vals, _ = K.rank_select(logits, k, div)
                    return K.gather_rows(src, ix, vals)

            def plain(logits=logits, src=src, k=k, div=div):
                _, ix, vals, _ = P.rank_select(logits, k, div)
                return P.gather_rows(src, ix, vals)
            shapes.append((n, k, cols, nf))
            calls += [pool, plain, lambda gx=gx, idx=idx: K.gather_rows(
                          gx, idx),
                      lambda gx=gx, idx64=idx64: torch.take_along_dim(
                          gx, idx64, 1),
                      lambda gx=gx, idx=idx: P.gather_rows(gx, idx)]
    ms = graph_ms(calls)
    print("  pools per level, device ms per launch in a CUDA graph ("
          + ("one rank_select launch per pool" if fused else
             "rank_select + gather_rows per pool") + "):", flush=True)
    out = {}
    for j, (n, k, cols, nf) in enumerate(shapes):
        p_ms, pp_ms, g_ms, lib_ms, gp_ms = ms[5 * j:5 * j + 5]
        pb, pby = bound(float(nf * (n * n + k * cols)),
                        4.0 * nf * (3 * n + 2 * k + 3 * k * cols))
        gb, gby = bound(0.0, 4.0 * nf * (2 * k * cols + k))
        print(f"    {n:3d} -> {k:3d} x {cols:3d} F={nf:2d}: pool {p_ms:.4f} "
              f"(plain {pp_ms:.4f}, bound {pb:.5f} {pby}); backward "
              f"gather_rows {g_ms:.4f} (take_along_dim {lib_ms:.4f}, plain "
              f"{gp_ms:.4f}, bound {gb:.5f} {gby})", flush=True)
        out[(n, k, cols, nf)] = (p_ms, g_ms)
    return out


def _pool_level(g, nf, n, k, cols, div, dev):
    """One pool level's backward inputs on the card: the slots of a
    ``rank_select`` over ``_pool_logits`` (k kept, the rest -1), its
    scores and kept scores, and random rows g (k x cols), pre and an
    addend (n x cols)."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K

    s, _, vals, slot = K.rank_select(_pool_logits(g, nf, n, div, dev), k,
                                     div)
    rows = lambda r: torch.randn(nf, r, cols, generator=g, device=dev)
    return dict(g=rows(k), pre=rows(k), add=rows(n), slot=slot, s=s,
                vals=vals)


def check_pool_bwd(dev):
    """Phase 2, the unpool and the pool's adjoints (``scatter_rows``,
    ``pool_logits_bwd``, ``pool_bwd_pair``) at every pool of both steps at
    F = 3 (every form at every pool), the forward scatter also at F = 56,
    and rows of 30 and 7 floats (4-byte accesses): each scatter and the
    pair's g_d equal to the plain version's, the pair's logits adjoint
    equal to the standalone launch's bits and within 1e-5 of the plain
    version's largest entry; two launches and a graphed launch
    bit-equal. Then ``pool_bwd_times``."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import scatter_rows_plan

    g = torch.Generator(device=dev).manual_seed(10)
    cases = [pool + (nf,) for pool in GSR_POOLS + GAT_POOLS
             for nf in (F, 56)] + list(POOL_WIDE)
    worst = 0.0
    for n, k, cols, div, nf in cases:
        lv = _pool_level(g, nf, n, k, cols, div, dev)
        G, pre, add, slot, s, vals = (lv[key] for key in (
            "g", "pre", "add", "slot", "s", "vals"))
        calls = {"scatter": lambda: K.scatter_rows(G, slot)}
        plains = {"scatter": P.scatter_rows(G, slot)}
        if nf == F or (n, k, cols, div, nf) in POOL_WIDE:
            scale = 1.0 / div
            calls.update(
                scatter_scaled=lambda: K.scatter_rows(G, slot, vals, add),
                logits_bwd=lambda: K.pool_logits_bwd(G, pre, slot, s, scale),
                pair=lambda: K.pool_bwd_pair(G, pre, slot, s, vals, add,
                                             scale))
            plains.update(
                scatter_scaled=P.scatter_rows(G, slot, vals, add),
                logits_bwd=P.pool_logits_bwd(G, pre, slot, s, scale),
                pair=P.pool_bwd_pair(G, pre, slot, s, vals, add, scale))
        plan = scatter_rows_plan(nf, n, cols)
        label = (f"{k:4d} -> {n:4d} rows x {cols:3d} F={nf:2d} "
                 f"({plan.bands} bands of {plan.rows} rows, {plan.threads} "
                 f"threads, {plan.lanes} lanes a row, "
                 f"{16 if plan.vec else 4}-byte rows)")
        for form, call in calls.items():
            got = [call(), call(), _graph_outputs(call)]
            torch.cuda.synchronize()
            outs = [o if isinstance(o, tuple) else (o,) for o in got]
            if not all(torch.equal(_bits(a), _bits(b)) and torch.equal(
                    _bits(a), _bits(c)) for a, b, c in zip(*outs)):
                fail(f"{form} {label}: two launches or the graphed launch "
                     "differ")
            want = plains[form]
            if form == "logits_bwd":
                err = max_err(got[0], want)
                worst = max(worst, err / scale_of(want))
                if not err <= 1e-5 * scale_of(want):
                    fail(f"{form} {label}: max|err| {err:.3e}")
            elif form == "pair":
                if not torch.equal(got[0][0], want[0]):
                    fail(f"pool_bwd_pair {label}: g_d differs from the "
                         "plain scatter")
                if not torch.equal(_bits(got[0][1]),
                                   _bits(calls["logits_bwd"]())):
                    fail(f"pool_bwd_pair {label}: g_logits differs from "
                         "the standalone launch")
            elif not torch.equal(got[0], want):
                fail(f"{form} {label}: differs from the plain version")
        print(f"    {label}: {', '.join(calls)} ok (exact; logits "
              "adjoint within 1e-5, the pair's equal to the standalone's); "
              "bit-equal, graphed", flush=True)
    print(f"  pool backward ok: {len(cases)} cases, worst logits adjoint "
          f"err / max {worst:.2e}", flush=True)
    pool_bwd_times(dev)


def pool_bwd_times(dev):
    """Device ms per launch in a CUDA graph at every pool of both steps:
    the forward's ``scatter_rows`` (GSR-Net's at F = 3, the GAT U-Net's at
    F = 3 and the validation's 56), the GSR backward's pair (this tree's
    one ``pool_bwd_pair`` launch, or an older tree's ``scatter_rows`` +
    ``pool_logits_bwd``), the GAT backward's scaled ``scatter_rows`` and
    ``pool_logits_bwd``, each beside its plain version and bound. It calls
    only those kernel ops and detects the older contract, so it also times
    an older tree of the port: load this file by path with that tree's
    root as the working directory. Returns {(n, k, cols, F): {form:
    ms}}."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    fused = hasattr(K, "pool_bwd_pair")
    g = torch.Generator(device=dev).manual_seed(11)
    rows, calls = [], []
    for n, k, cols, div in GSR_POOLS + GAT_POOLS:
        for nf in ((F,) if div == 100.0 else (F, 56)):
            lv = _pool_level(g, nf, n, k, cols, div, dev)
            G, pre, add, slot, s, vals = (lv[key] for key in (
                "g", "pre", "add", "slot", "s", "vals"))
            f4 = 4.0 * nf
            forms = [("scatter", lambda G=G, slot=slot: K.scatter_rows(
                          G, slot), lambda G=G, slot=slot: P.scatter_rows(
                          G, slot), bound(0.0, f4 * (k * cols + n * cols
                                                     + n)))]
            if nf == F and div == 100.0:
                if fused:
                    def pair(G=G, pre=pre, slot=slot, s=s, vals=vals,
                             add=add):
                        return K.pool_bwd_pair(G, pre, slot, s, vals, add)
                else:
                    def pair(G=G, pre=pre, slot=slot, s=s, vals=vals,
                             add=add):
                        return (K.scatter_rows(G, slot, vals, add),
                                K.pool_logits_bwd(G, pre, slot, s))
                forms.append(("pair", pair, lambda G=G, pre=pre, slot=slot,
                              s=s, vals=vals, add=add: (
                                  P.scatter_rows(G, slot, vals, add),
                                  P.pool_logits_bwd(G, pre, slot, s)),
                              bound(2.0 * nf * (k + n) * cols,
                                    f4 * (2 * k * cols + 2 * n * cols
                                          + 3 * n + k))))
            elif nf == F:
                forms += [
                    ("scatter_scaled", lambda G=G, slot=slot, vals=vals,
                     add=add: K.scatter_rows(G, slot, vals, add),
                     lambda G=G, slot=slot, vals=vals, add=add:
                     P.scatter_rows(G, slot, vals, add),
                     bound(2.0 * nf * n * cols,
                           f4 * (k * cols + 2 * n * cols + k + n))),
                    ("logits_bwd", lambda G=G, pre=pre, slot=slot, s=s:
                     K.pool_logits_bwd(G, pre, slot, s, 1.0),
                     lambda G=G, pre=pre, slot=slot, s=s:
                     P.pool_logits_bwd(G, pre, slot, s, 1.0),
                     bound(2.0 * nf * k * cols,
                           f4 * (2 * k * cols + 3 * n)))]
            for form, kern, plain, b in forms:
                rows.append(((n, k, cols, nf), form, b))
                calls += [kern, plain]
    ms = graph_ms(calls)
    print("  pool backward rows, device ms per launch in a CUDA graph ("
          + ("the GSR pair one pool_bwd_pair launch" if fused else
             "the GSR pair scatter_rows + pool_logits_bwd") + "):",
          flush=True)
    out = {}
    for j, (shape, form, (b_ms, b_by)) in enumerate(rows):
        n, k, cols, nf = shape
        print(f"    {k:3d} -> {n:3d} x {cols:3d} F={nf:2d} {form:14s} "
              f"{ms[2 * j]:.4f} (plain {ms[2 * j + 1]:.4f}, bound "
              f"{b_ms:.5f} {b_by})", flush=True)
        out.setdefault(shape, {})[form] = ms[2 * j]
    return out


class _Sigmoids(torch.overrides.TorchFunctionMode):
    """Records the output of every ``torch.sigmoid`` call under it."""

    def __init__(self):
        super().__init__()
        self.out = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        result = func(*args, **(kwargs or {}))
        if func is torch.sigmoid:
            self.out.append(result)
        return result


def _apart_logits(nf, n, dev):
    """(nf, n) logits at GSR-Net's scale, mostly ones whose scores on the
    card differ under the true quotient logits / 100 and the product
    logits * fl32(0.01), with a tie among them."""
    rng = np.random.default_rng(12)
    cand = torch.from_numpy((rng.standard_normal(40 * nf * n) * 300.0)
                            .astype(np.float32)).to(dev)
    prod = torch.sigmoid(cand * float(np.float32(0.01)))
    true = torch.sigmoid(cand / torch.full_like(cand, 100.0))
    apart = cand[prod != true]
    logits = torch.cat([apart, cand])[:nf * n].reshape(nf, n).contiguous()
    logits[:, 5] = logits[:, 2]
    return logits


def check_pool_scores(dev):
    """Phase 2, the score rule on the card: from the same logits (mostly
    ones where the true quotient rounds apart), the ``rank_select``
    kernel's s, its plain version's, a GSRNet's first ``GraphPool`` and
    ``unet_forward_rankselect``'s first level score every node with the
    same bits, sigmoid(logits * fl32(0.01)) (XLA's form of the JAX
    package's logits / 100)."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.models.fused_step import (leaf_specs,
                                                  unet_forward_rankselect)
    from fcsr_tpu_torch.models.gsr import GSRNet

    n, k = GSR_POOLS[0][:2]
    logits = _apart_logits(F, n, dev)
    true = torch.sigmoid(logits / torch.full_like(logits, 100.0))
    paths = {"rank_select": K.rank_select(logits, k)[0],
             "plain rank_select": P.rank_select(logits, k)[0]}
    # the model's pool, its logits made the first feature exactly
    pool = GSRNet(device=dev, seed=0).net.pools[0]
    with torch.no_grad():
        pool.proj.weight.zero_()
        pool.proj.weight[0, 0] = 1.0
        pool.proj.bias.zero_()
        rec = _Sigmoids()
        with rec:
            for row in logits:
                x = torch.ones(n, pool.proj.in_features, device=dev)
                x[:, 0] = row
                pool(torch.eye(n, device=dev), x)
        paths["GSRNet GraphPool"] = torch.stack(rec.out)
        # one level on 2 features whose pool logits are the given ones
        W = {name: torch.zeros((F,) + shape, device=dev)
             for name, shape in leaf_specs(n, 2, 1)}
        W["w:start_gcn"][..., 0] = logits
        W["w:start_gcn"][..., 1] = 1.0
        W["w:down_gcns_0"][:] = torch.eye(2, device=dev)
        W["w:pools_0"][:, 0, 0] = 1.0
        rec = _Sigmoids()
        with rec:
            unet_forward_rankselect(W, (k / n,), n)
        paths["unet_forward_rankselect"] = rec.out[0]
    torch.cuda.synchronize()
    want = paths["rank_select"]
    bad = [name for name, t in paths.items()
           if not torch.equal(_bits(t), _bits(want))]
    if bad:
        fail(f"pool scores on the card: {bad} differ from the kernel's")
    print(f"  pool scores: {', '.join(paths)} bit-equal on {F} x {n} logits"
          f"; {int((want != true).sum())} of them differ from the true "
          "quotient's sigmoid", flush=True)


# the symmetric pair's cases (tests/test_torch_sym_tiles.py's shapes):
# the GSR tail's (F, m), one fold, widths off 4 and off the tile edge
SYM_SHAPES = ((3, HR), (1, HR), (3, 270), (3, 33), (3, 32), (2, 33))


def _sym_inputs(nf, m, seed, dev, off=0):
    """``ops.sym_check_inputs`` (the CPU tests' draw, with zeros, -0.0,
    x_ij = -x_ji, NaN and +-inf) on the card; ``off`` > 0: views that many
    floats into a buffer (off 16 bytes)."""
    from fcsr_tpu_torch.kernels.ops import sym_check_inputs

    def put(a):
        buf = torch.empty(a.size + off, device=dev)
        view = buf[off:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        return view
    return tuple(put(a) for a in sym_check_inputs(nf, m, seed))


def check_sym_tiles(dev):
    """Phase 2, the symmetric pair (``sym_abs_fill``, ``sym_sign_grad`` at
    c = 0.5 and 1) at every ``SYM_SHAPES`` entry, on 16-byte-aligned
    operands (the 16-byte path where m % 4 == 0) and on views 1 float off
    16 bytes (the 4-byte path): each output bit-equal to the plain
    version's (NaN where NaN), two launches bit-equal, a graphed launch
    equal to an eager one, and bitwise symmetric; then ``sym_times``."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import sym_tiles_plan

    paths = set()
    for nf, m in SYM_SHAPES:
        for off in (0, 1):
            x, g = _sym_inputs(nf, m, 5, dev, off)
            vec = sym_tiles_plan(nf, m, off == 0).vec
            paths.add(vec)
            calls = [("sym_abs_fill", lambda: K.sym_abs_fill(x),
                      lambda: P.sym_abs_fill(x))]
            for c in (0.5, 1.0):
                calls.append((f"sym_sign_grad c={c}",
                              lambda c=c: K.sym_sign_grad(g, x, c),
                              lambda c=c: P.sym_sign_grad(g, x, c)))
            for name, kern, plain in calls:
                got, again, want = kern(), kern(), plain()
                graphed = _graph_outputs(kern)
                torch.cuda.synchronize()
                label = (f"{name} ({nf}, {m}, {m}) "
                         f"{'16' if vec else '4'}-byte")
                if not _same(got, want, bits=True):
                    fail(f"{label}: differs from the plain version")
                if not torch.equal(_bits(got), _bits(again)):
                    fail(f"{label}: two launches differ")
                if not torch.equal(_bits(got), _bits(graphed)):
                    fail(f"{label}: the graphed launch differs")
                if not _same(got, got.transpose(1, 2), bits=True):
                    fail(f"{label}: not bitwise symmetric")
    if paths != {True, False}:
        fail("check_sym_tiles: both the 16- and the 4-byte path must run")
    print(f"  sym_abs_fill, sym_sign_grad (c 0.5, 1): {len(SYM_SHAPES)} "
          "shapes x 16- / 4-byte operands bit-equal to the plain version "
          "(zeros, -0.0, x_ij = -x_ji, NaN, +-inf), run to run and graphed,"
          " bitwise symmetric", flush=True)
    sym_times(dev)


def sym_times(dev):
    """``sym_abs_fill`` and ``sym_sign_grad`` (c = 0.5) at the GSR tail's
    3 x 268 x 268: device ms per launch in a CUDA graph, each in turns
    with its plain version, beside its bound; then the eager call from
    Python: ms per call of 200 back to back by CUDA events (the median of
    11 rounds), and the host's us per call by its clock (the least of 21
    rounds of 500 calls; the device, 6x faster, never holds it back). It
    calls only those kernel ops, so it also times an older tree of the
    port: load this file by path with that tree's root as the working
    directory. Returns {name: (ms, eager ms, host us)}."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    rng = np.random.default_rng(8)
    x, g = (torch.from_numpy(rng.standard_normal((F, HR, HR)).astype(
        np.float32)).to(dev) for _ in range(2))
    nbytes = 4.0 * F * HR * HR
    forms = (("sym_abs_fill", lambda: K.sym_abs_fill(x),
              lambda: P.sym_abs_fill(x), bound(2.0 * F * HR * HR,
                                               2 * nbytes)),
             ("sym_sign_grad", lambda: K.sym_sign_grad(g, x, 0.5),
              lambda: P.sym_sign_grad(g, x, 0.5),
              bound(5.0 * F * HR * HR, 3 * nbytes)))
    ms = graph_ms([fn for _, kern, plain, _ in forms
                   for fn in (kern, plain)])
    out = {}
    for j, (name, kern, _, (b_ms, b_by)) in enumerate(forms):
        eager, host = _eager_and_host(kern, 21, 500)
        print(f"  {name} at {F} x {HR}^2: {ms[2 * j]:.5f} ms per launch "
              f"(plain {ms[2 * j + 1]:.5f}, bound {b_ms:.5f} {b_by}); "
              f"{eager:.5f} ms per eager call, host {host:.3f} us",
              flush=True)
        out[name] = (ms[2 * j], eager, host)
    return out


def _eager_and_host(fn, rounds=11, calls=200):
    """(eager ms per call of ``calls`` back to back by CUDA events, the
    median of ``rounds`` rounds; the host's us per call by its clock, the
    least of ``rounds`` rounds of ``calls`` calls: the device, several
    times faster, never holds it back)."""
    eager = cuda_ms(fn, reps=calls, rounds=rounds)
    host = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return eager, min(host)


def check_product(prod, layout, g, dev):
    """One census signature replayed on the card: its path, the kernel
    against the plain version (within 1e-5 x max(scale, K)), two launches
    bit-equal, and the kernel against one library call for the same
    function, both in CUDA graphs timed in turns. Returns (kernel ms,
    library ms, bound ms)."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.census import replay
    from fcsr_tpu_torch.kernels.ops import (bgemm_forced, bgemm_path,
                                            bgemm_tiles)
    from fcsr_tpu_torch.utils.timing import graph_ms

    ta, tb, F = prod.ta, prod.tb, prod.F
    ops = replay(prod, layout, g, dev)
    a, b, bias, add, alias = (ops[k] for k in ("a", "b", "bias", "add",
                                                "alias"))

    def launch(acc=None):
        if alias:          # add is out: the step accumulates in place
            return K.bgemm(a, b, ta, tb, bias=bias, add=acc, out=acc)
        return K.bgemm(a, b, ta, tb, bias=bias, add=add)

    got = [launch(None if add is None else add.clone()) for _ in range(2)]
    want = P.bgemm(a, b, ta, tb, bias=bias, add=add)
    torch.cuda.synchronize()
    err = max_err(got[0], want)
    limit = 1e-5 * max(scale_of(want), float(prod.K))
    if not err <= limit:
        fail(f"bgemm {prod.label()}: max|err| {err:.3e} above {limit:.1e}")
    if not torch.equal(got[0], got[1]):
        fail(f"bgemm {prod.label()}: two launches differ")
    plans = 0
    if min(prod.M, prod.N) > 1 and prod.K > 1:     # the dense path's plans
        for tile in range(len(bgemm_tiles())):
            for split in (1, 2, 4):
                p_err = max_err(bgemm_forced(tile, split, a, b, ta, tb,
                                             bias=bias, add=add), want)
                plans += 1
                if not p_err <= limit:
                    fail(f"bgemm {prod.label()} tile {tile} split {split}: "
                         f"max|err| {p_err:.3e} above {limit:.1e}")
    op_a = torch.ones(F, 1, prod.K, device=dev) if a is None else (
        a.transpose(1, 2) if ta else a)
    op_b = b.transpose(1, 2) if tb else b
    acc_k = None if add is None else add.clone()
    acc_l = None if add is None else add.clone()
    if add is not None:     # bias + add has no one-call form: add alone
        lib = (lambda: acc_l.baddbmm_(op_a, op_b)) if alias else (
            lambda: torch.baddbmm(add, op_a, op_b))
    elif bias is not None:
        lib = lambda: torch.baddbmm(bias, op_a, op_b)
    else:
        lib = lambda: torch.matmul(op_a, op_b)
    k_ms, l_ms = graph_ms([lambda: launch(acc_k), lib])   # in turns
    b_ms, b_by = bound(prod.flops, prod.nbytes)
    path = bgemm_path(a, b, ta, tb, bias=bias, add=add)
    print(f"    bgemm {prod.label():34s} {path:58s} kernel {k_ms:.4f} ms, "
          f"library {l_ms:.4f} ms ({k_ms / l_ms:.2f}x), bound {b_ms:.5f} ms "
          f"({b_by}), max|err| {err:.2e}, bit-equal"
          + (f", all {plans} plans within the limit" if plans else ""),
          flush=True)
    return k_ms, l_ms, b_ms


def check_products(dev):
    """Phase 2's product sweep: every distinct ``bgemm`` signature of the
    full-width GSR and GAT steps (their census on the card) replayed with
    the census's operand layouts by ``check_product``. Returns the steps'
    sums of kernel and library ms weighted by launches, for the JSON
    line."""
    from fcsr_tpu_torch.kernels.census import gat_step_census, gsr_step_census

    from fcsr_tpu_torch.kernels.ops import bgemm_path

    sq = torch.empty(F, HR, HR, device=dev)
    print(f"  bgemm_f32 record ({HR}^3 + bias): "
          f"{bgemm_path(sq, sq, bias=torch.empty(F, 1, HR, device=dev))}")
    g = torch.Generator(device=dev).manual_seed(1)
    timed, out = {}, {"signatures": 0, "worst_vs_library": 0.0}
    for step, census in (("gsr", gsr_step_census(dev)),
                         ("gat", gat_step_census(dev))):
        sigs = census.signatures()
        print(f"  bgemm_f32 over the {step.upper()} step's census: "
              f"{len(census.products)} launches, {len(sigs)} signatures, "
              f"{census.flops / 1e9:.4f} GFLOP", flush=True)
        sums = [0.0, 0.0, 0.0]
        for prod, n in sigs.items():
            if prod not in timed:
                timed[prod] = check_product(prod, census.layouts[prod], g,
                                            dev)
            for i, t in enumerate(timed[prod]):
                sums[i] += n * t
        print(f"  {step.upper()} step: bgemm_f32 {sums[0]:.4f} ms over its "
              f"{len(census.products)} launches, the same library calls "
              f"{sums[1]:.4f} ms, bound {sums[2]:.5f} ms", flush=True)
        out[f"{step}_step_ms"], out[f"{step}_step_library_ms"] = sums[:2]
        out[f"{step}_step_bound_ms"] = sums[2]
    out["signatures"] = len(timed)
    out["worst_vs_library"] = max(k / l for k, l, _ in timed.values())
    print(f"  bgemm_f32: {len(timed)} signatures checked and timed; worst "
          f"kernel / library {out['worst_vs_library']:.2f}x", flush=True)
    return out


def check_kernels(dev):
    """Phase 2; returns {name: record} for the JSON line. Kernel, plain
    version and library call are timed in turns (CUDA graphs)."""

    from fcsr_tpu_torch.utils.timing import graph_ms

    records = {}
    for name, kern, plain, tol, flops, nbytes, lib in kernel_cases(dev):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if name == "rank_select":   # every output exactly, NaN where NaN
            err = max(_nan_aware_err(a, b) for a, b in zip(got, want))
            limit = 0.0
            ok = all(_same(a, b) for a, b in zip(got, want))
        elif isinstance(tol, tuple):    # a tolerance for each output
            errs = [max_err(a, b) for a, b in zip(got, want)]
            limits = [t * scale_of(b) for t, b in zip(tol, want)]
            ok = all(e <= lim for e, lim in zip(errs, limits))
            err, limit = max(errs), max(limits)
        else:
            err = max_err(got, want)
            limit = tol * scale_of(want)
            ok = err <= limit
        if not ok:
            fail(f"kernel {name} disagrees with its plain version "
                 f"(max|err| {err:.3e}, limit {limit:.1e})")
        ms, plain_ms, *lib_ms = graph_ms(
            [kern, plain] + ([lib] if lib is not None else []))
        lib_ms = lib_ms[0] if lib_ms else None
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

    records["bgemm_f32"].update(check_products(dev))
    check_triu_kernels(dev)
    check_band_kernels(dev)
    check_tail_reductions(dev)
    check_pools(dev)
    check_pool_bwd(dev)
    check_pool_scores(dev)
    check_sym_tiles(dev)
    return records


# ---------------------------------------------------------------------------
# phase 3: one full-width fold-batched step, kernels vs plain
# ---------------------------------------------------------------------------

def step_inputs(dev, data):
    """Arguments of one full-width fold-batched ``train_step_fused`` (F = 3
    GSRNet weights from seeds 0-2, small Adam moments, the third fold
    masked) on the first F subjects of ``data``. Calls only public
    entry points, so it also runs against an older tree of the port."""
    from fcsr_tpu_torch.iox.weights import state_to_flat
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
    return (p, m, v, u_lr, u_hr, hr, scal, KS, LR, HR, 16.0, 1e-4)


def check_step(dev, data):

    from fcsr_tpu_torch.models.fused_step import (train_step_fused,
                                                  train_step_plain)

    args = step_inputs(dev, data)
    p, m, v, u_lr, u_hr, hr = args[:6]
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
    if sum(launches.values()) != STEP_LAUNCHES or any(
            launches.get(k, 0) != c for k, c in STEP_POOL_LAUNCHES.items()):
        fail(f"the step launches {launches}: not {STEP_LAUNCHES} with "
             f"{STEP_POOL_LAUNCHES}")
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
    """(flops, bytes, launches by kernel) of one kernel-path step, by the
    census of its op namespace (``kernels/census.py``)."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS
    from fcsr_tpu_torch.kernels.census import census_of
    from fcsr_tpu_torch.models.fused_step import step_with_ops

    census = census_of(lambda ops: step_with_ops(ops, *args, 0.9, 0.999,
                                                 1e-8), KERNEL_OPS)
    return census.flops, census.bytes, census.launches


def count_gat_step(step_args, kw):
    """``count_step`` of one fused GAT step."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS
    from fcsr_tpu_torch.kernels.census import census_of
    from fcsr_tpu_torch.models.fused_gat import _step_with_ops

    census = census_of(lambda ops: _step_with_ops(
        ops, *step_args, 0.9, 0.999, 1e-8, 0.01, **kw), KERNEL_OPS)
    return census.flops, census.bytes, census.launches


def profile_steps(step, eager_ms, path):
    """torch.profiler over 10 eager calls of ``step``: device time by
    kernel, written to ``path``, and the device's busy share of the eager
    step. Returns the profiler's averages by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=15)
    # device events only: an aten op's self device time is its kernels'
    device = [e for e in averages if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in device) / 10 / 1e3
    with open(path, "w") as f:
        f.write(table)
    print(f"  profile: {dev_ms:.3f} ms of device time per step, "
          f"{100 * dev_ms / eager_ms:.1f}% of the {eager_ms:.3f} ms eager "
          f"step; table in {path}")
    for e in sorted(device, key=lambda e: -e.self_device_time_total):
        if e.self_device_time_total > 0:
            print(f"    {e.key[:60]:60s} {e.self_device_time_total / 10:9.1f}"
                  f" us/step  {e.count // 10:3d} launches/step")
    return averages


def profile_launches(step, eager_ms, path, wanted, what, attempts=3):
    """``profile_steps`` of ``step``, and the device launches per step of
    each kernel in ``wanted`` (a name fragment of the profiler's key ->
    launches) over its 10 steps (the profiler can drop the first step's
    first few launches: rounded). The card's profiler at times loses a
    share of a window's events (every kernel short by about a tenth of
    its launches, device time short alike): a window whose counts differ
    is profiled again, up to ``attempts`` windows, and the check fails if
    none has the counts. Returns the averages of the window that had
    them."""
    for attempt in range(1, attempts + 1):
        averages = profile_steps(step, eager_ms, path)
        off = []
        for name, want in wanted.items():
            got = sum(e.count for e in averages if name in e.key
                      and e.self_device_time_total > 0) / 10
            print(f"  {what}: {name} {got:g} device launches per step "
                  f"({want} wanted)")
            if round(got) != want:
                off.append(f"{name} {got:g} (not {want})")
        if not off:
            return averages
        print(f"  {what}: profile window {attempt} of {attempts} has other "
              f"counts: {', '.join(off)}", flush=True)
    fail(f"{what}: device launches per step {', '.join(off)} in each of "
         f"{attempts} profile windows")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def run_main_path(dev, data, epochs: int):

    from fcsr_tpu_torch import (GSRFoldRunner, GSRTrainConfig,
                                kfold_indices)
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.train import evaluate_gsr_folds

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
    _, loss_hist, err_hist = runner.train(chunk_epochs=1)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    counts = launch_counts()
    maes, preds = runner.evaluate()
    torch.cuda.synchronize()
    evaluate_times(runner)

    steps = runner.tr_idx.shape[1] * epochs
    print(f"  stage {t_stage:.2f} s; train {t_train:.2f} s = "
          f"{t_train / epochs:.3f} s/epoch, {1e3 * t_train / steps:.3f} "
          f"ms/step ({steps} fold-batched steps) through the epoch graph, "
          f"its capture included ({capture_note(runner)})")
    for j in range(len(folds)):
        print(f"  fold {j} loss {loss_hist[j].tolist()} "
              f"recon {err_hist[j].tolist()}")
    print(f"  val MAE untrained {untrained.tolist()} trained "
          f"{maes.tolist()}")
    counts = {k: c for k, c in counts.items()
              if k not in TRIU + GAT_ONLY + BF16_ONLY}
    print(f"  launches on the trainer path: {counts}")
    if not (np.isfinite(loss_hist).all() and np.isfinite(maes).all()
            and bool(torch.isfinite(preds).all())):
        fail("non-finite loss, MAE or prediction")
    if tuple(preds.shape[-2:]) != (HR, HR):
        fail(f"prediction shape {tuple(preds.shape)}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        fail(f"kernels never launched on the trainer path: {missing}")
    _, fold_outs = evaluate_gsr_folds(cfg, runner, pull_preds=True)
    runner.release_graphs()
    return counts, fold_outs


def evaluate_times(runner, reps: int = 5):
    """Phase 4: ``GSRFoldRunner.evaluate`` at full width (3 folds, one
    forward vmapped over them on the padded validation plan): ms a call,
    warm, by the host clock around a synchronised call, and the
    synchronising calls one call makes (torch's sync debug mode)."""
    import warnings

    runner.evaluate()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.evaluate()
        torch.cuda.synchronize()
        times.append(round(1e3 * (time.perf_counter() - t0), 3))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner.evaluate()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("Synchronization debug mode is a prototype
    # feature ...") is not a synchronisation
    syncs = [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
             for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"  evaluate() at full width ({runner.n_folds} folds x "
          f"{runner.va_idx.shape[1]} validation slots, one vmapped forward): "
          f"{times} ms a call, {len(syncs)} synchronising call(s) a call "
          f"{syncs} [{smi_line()}]", flush=True)


# the batched calls at 20 -> 32 nodes, card against CPU: fp32 to this
# fraction of each quantity's scale (sums in other orders); bf16 to the
# bf16 runner's 1e-3 (a product's bf16 rounding may flip)
BATCHED_TOL = {"f32": 1e-5, "bf16": 1e-3}


def check_fold_batched(dev, data):
    """Phase 4: the folds as one vmapped call at 20 -> 32 nodes (F = 3),
    on the card against the same call on the CPU from the same weights:
    the unfused GSR step's loss, error and gradients in fp32 and in bf16
    (the bf16 product W U^T on ``bgemm_bf16``, the folds its batch axis),
    ``evaluate``'s MAEs and predictions, the unfused GAT step's losses and
    gradient (drop_p 0) and its validation (``BATCHED_TOL``)."""
    from fcsr_tpu_torch import GSRFoldRunner, GSRTrainConfig, kfold_indices
    from fcsr_tpu_torch.kernels.ops import plan_folds
    from fcsr_tpu_torch.train import gat_loop

    lr = data["lr_train"][:9, :20, :20].copy()
    hr = data["hr_train"][:9, :32, :32].copy()
    folds = kfold_indices(9, 3, seed=42)
    worst = {}
    for dtype in ("f32", "bf16"):
        outs = {}
        for d in ("cpu", dev):
            cfg = GSRTrainConfig(epochs=1, compute_dtype=dtype, lr_dim=20,
                                 hr_dim=32, hidden_dim=32, ks=(0.9, 0.7))
            r = GSRFoldRunner(cfg, lr, hr, folds, device=d)
            P = {k: t.requires_grad_()
                 for k, t in r.layout.views(r.flat0.clone()).items()}
            with plan_folds(3):
                loss, err = r.shards[0].loss(P, 0)
            grads = torch.autograd.grad(loss.sum(), list(P.values()))
            maes, preds = r.evaluate(r.flat0)
            outs[str(d)] = [loss.detach(), err.detach(), *grads,
                            torch.from_numpy(maes), preds]
        worst[f"GSR {dtype}"] = (max(
            max_err(a, b.cpu()) / max(scale_of(a), 1e-30)
            for a, b in zip(outs["cpu"], outs[str(dev)])),
            BATCHED_TOL[dtype])
    cfg = gat_loop.GATTrainConfig(epochs=1, drop_p=0.0, ks=(0.5, 0.5),
                                  n_nodes=20, m_nodes=32, dim=4, heads=2)
    outs = {}
    for d in ("cpu", dev):
        tr = gat_loop._FoldTrainer(cfg, lr, hr, folds, 42, d)
        i = torch.tensor([0, 2, 5], device=d)
        scal = torch.tensor([[1.0, 1e-3, 1.0]] * 3, device=d)
        p0 = tr.p.clone()
        loss, _, m1, _ = tr._unfused_step(p0, torch.zeros_like(p0),
                                          torch.zeros_like(p0), i, scal)
        with torch.no_grad():
            outs[str(d)] = [loss, m1, *tr._validate(p0)]
    worst["GAT f32"] = (max(max_err(a, b.cpu()) / max(scale_of(a), 1e-30)
                            for a, b in zip(outs["cpu"], outs[str(dev)])),
                        BATCHED_TOL["f32"])
    print("  the folds as one vmapped call, 20 -> 32 nodes, card vs CPU, "
          "max|diff| / scale (limit): " + "; ".join(
              f"{k} {e:.2e} ({t:g})" for k, (e, t) in worst.items()),
          flush=True)
    bad = [k for k, (e, t) in worst.items() if not e <= t]
    if bad:
        fail(f"the batched calls on the card disagree with the CPU: {bad}")


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


# ---------------------------------------------------------------------------
# phase 5: Kaggle CSVs in, submission.csv out, through the command line
# ---------------------------------------------------------------------------

def _expected_stacks(data, nan_frac, seed):
    """What ``load_dataset`` must return for ``write_kaggle_csvs(data,
    nan_frac, seed)``: the teacher stacks with both mirror entries of every
    NaN cell at 0 (the writer's mask, drawn again), and the cell count."""
    rng = np.random.default_rng(seed)
    out, n_nan = {}, 0
    for name in ("lr_train", "hr_train", "lr_test"):
        mats = np.asarray(data[name], np.float32)
        n = mats.shape[-1]
        iu = np.triu_indices(n, k=1)
        vecs = mats[:, iu[0], iu[1]]
        mask = rng.random(vecs.shape) < nan_frac
        n_nan += int(mask.sum())
        vecs[mask] = 0.0
        dense = np.zeros_like(mats)
        dense[:, iu[0], iu[1]] = vecs
        out[name] = dense + dense.transpose(0, 2, 1)
    return out, n_nan


def _read_submission(path, n_rows):
    """The ``Predicted`` column of a submission file as float32, after
    checking its header, line count and 1-based IDs."""
    with open(path) as f:
        header = f.readline().strip()
    if header != "ID,Predicted":
        fail(f"{path}: header {header!r}")
    table = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64)
    if table.shape != (n_rows, 2):
        fail(f"{path}: {table.shape[0]} rows after the header, expected "
             f"{n_rows}")
    if not np.array_equal(table[:, 0], np.arange(1, n_rows + 1)):
        fail(f"{path}: IDs are not 1..{n_rows}")
    return table[:, 1].astype(np.float32)


def run_csv_path(dev, data):
    """Phase 5; returns the launch counts of the two command-line runs."""
    from fcsr_tpu_torch import cli
    from fcsr_tpu_torch.data import (ingest_vectors_to_device,
                                     kfold_indices, load_csv_vectors,
                                     load_dataset, load_dataset_device,
                                     matrix_size_for, write_kaggle_csvs)
    from fcsr_tpu_torch.iox import load_arrays, load_params, save_prediction
    from fcsr_tpu_torch.kernels import (PLAIN_OPS, launch_counts,
                                        reset_launch_counts)
    from fcsr_tpu_torch.models import GSRNet
    from fcsr_tpu_torch.train import (GSRFoldRunner, GSRTrainConfig,
                                      predict_gsr)

    csv_dir = os.path.join(WORK_DIR, "data")
    out_dir = os.path.join(WORK_DIR, "out")
    ck = os.path.join(WORK_DIR, "ck.npz")
    sub_col = os.path.join(WORK_DIR, "sub_colmajor.csv")
    nan_frac, nan_seed = 0.001, 0
    t0 = time.perf_counter()
    write_kaggle_csvs(data, csv_dir, nan_frac=nan_frac, seed=nan_seed)
    sizes = {n: os.path.getsize(os.path.join(csv_dir, n)) / 1e6
             for n in sorted(os.listdir(csv_dir))}
    print(f"  teacher set written as Kaggle CSVs in "
          f"{time.perf_counter() - t0:.1f} s: {sizes} MB", flush=True)

    # the path itself, through the entry points a user calls
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["train", "gsr", "--fused", "--epochs", "2", "--splits",
                   "3", "--data-dir", csv_dir, "--out-dir", out_dir,
                   "--checkpoint", ck])
    torch.cuda.synchronize()
    t_train_cli = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc2 = cli.main(["predict", "--params", ck, "--data-dir", csv_dir,
                    "--out", sub_col, "--ordering", "colmajor"])
    torch.cuda.synchronize()
    t_predict_cli = time.perf_counter() - t0
    counts = launch_counts()
    if rc != 0 or rc2 != 0:
        fail(f"command line returned {rc} (train), {rc2} (predict)")
    print(f"  `train gsr --fused` {t_train_cli:.1f} s, `predict` "
          f"{t_predict_cli:.1f} s; launches on the CSV path: {counts}",
          flush=True)
    counts = {k: c for k, c in counts.items()
              if k not in GAT_ONLY + BF16_ONLY}
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        fail(f"kernels never launched on the CSV path: {missing}")

    # ingest: exact where no NaN was written, 0 where one was
    want, n_nan = _expected_stacks(data, nan_frac, nan_seed)
    if n_nan == 0:
        fail("no NaN cell was written")
    cached = load_dataset(csv_dir, device=dev)          # the CLI's npz cache
    t0 = time.perf_counter()
    fresh = load_dataset(csv_dir, cache=False, device=dev)
    t_load = time.perf_counter() - t0
    for name, arr in want.items():
        for what, got in (("cached", cached), ("parsed", fresh)):
            if got[name].dtype != np.float32 \
                    or not np.array_equal(got[name], arr):
                fail(f"load_dataset ({what}) {name} differs from the teacher "
                     "set with its NaN cells at 0")
    print(f"  load_dataset: 3 stacks equal the teacher set exactly, "
          f"{n_nan} NaN cells hold 0 ({t_load:.2f} s uncached)")

    # stage times of the path, each ending in a synchronize
    t_parse, t_ingest = 0.0, 0.0
    for name in ("lr_train", "hr_train", "lr_test"):
        t0 = time.perf_counter()
        vecs = load_csv_vectors(os.path.join(csv_dir, f"{name}.csv"))
        t1 = time.perf_counter()
        dense = ingest_vectors_to_device(vecs, matrix_size_for(
            vecs.shape[1]), device=dev)
        torch.cuda.synchronize()
        t_parse += t1 - t0
        t_ingest += time.perf_counter() - t1
        if not np.array_equal(dense.cpu().numpy(), want[name]):
            fail(f"ingest_vectors_to_device {name} differs")
    on_card = load_dataset_device(csv_dir, device=dev)
    on_card_n = load_dataset_device(csv_dir, normalize_lr=True, device=dev)
    for name, arr in want.items():
        if not np.array_equal(on_card[name].cpu().numpy(), arr):
            fail(f"load_dataset_device {name} differs from load_dataset")
    for name in ("lr_train", "lr_test"):
        ref = PLAIN_OPS.normalize_adj_batch(torch.from_numpy(want[name]))
        err = max_err(on_card_n[name].cpu(), ref)
        if not err <= 1e-6:
            fail(f"load_dataset_device(normalize_lr) {name}: err {err:.2e}")
    if not np.array_equal(on_card_n["hr_train"].cpu().numpy(),
                          want["hr_train"]):
        fail("load_dataset_device(normalize_lr) changed hr_train")

    # both submission files against the plain vectorization of the same
    # predictions (the checkpoint's last fold on the ingested test set)
    cfg = GSRTrainConfig(fused_adam=True, epochs=2, lr_dim=LR, hr_dim=HR,
                         hidden_dim=HR)
    model = GSRNet(cfg.ks, cfg.lr_dim, cfg.hr_dim, cfg.hidden_dim,
                   device=dev)
    params = load_params(ck)
    t0 = time.perf_counter()
    preds = predict_gsr(params, model, cfg, fresh["lr_test"])
    torch.cuda.synchronize()
    t_predict = time.perf_counter() - t0
    if tuple(preds.shape) != (N_TEST, HR, HR) \
            or not bool(torch.isfinite(preds).all()):
        fail(f"test predictions: shape {tuple(preds.shape)} or non-finite")
    t0 = time.perf_counter()
    save_prediction(preds, os.path.join(WORK_DIR, "sub_timed.csv"),
                    ordering="colmajor")
    t_write = time.perf_counter() - t0
    n_rows = N_TEST * HR * (HR - 1) // 2
    rows, cols = np.triu_indices(HR, 1)
    plain = {"colmajor": PLAIN_OPS.vectorize_colmajor(preds.cpu()),
             "rowmajor": preds.cpu()[:, rows, cols]}
    for path, ordering in ((sub_col, "colmajor"),
                           (os.path.join(out_dir, "submission.csv"),
                            "rowmajor")):
        got = _read_submission(path, n_rows)
        ref = plain[ordering].reshape(-1).numpy()
        err = float(np.abs(got.astype(np.float64) - ref).max())
        print(f"  {os.path.basename(path)} ({ordering}): 1 + {n_rows} "
              f"lines, max|parsed - plain vectorization| {err:.1e}")
        if err != 0.0:
            fail(f"{path} does not parse back to the plain {ordering} "
                 "vectorization of the predictions")
    print(f"  stage times at full width ({N_TRAIN} train + {N_TEST} test "
          f"subjects): CSV parse {t_parse:.2f} s, ingest (copy + kernel) "
          f"{t_ingest:.3f} s, predict {N_TEST} subjects {t_predict:.2f} s, "
          f"write submission {t_write:.2f} s")

    # a run interrupted after epoch 1 and resumed must end bit-equal to
    # the command line's straight 2-epoch run
    folds = kfold_indices(N_TRAIN, 3, seed=42)
    first = GSRFoldRunner(cfg, fresh["lr_train"], fresh["hr_train"], folds,
                          device=dev)
    state, lh, eh = first._run_chunk(first.fresh_state(), 1)
    ck2 = os.path.join(WORK_DIR, "ck_resume.npz")
    first.save_checkpoint(ck2, state, 1, lh, eh)
    second = GSRFoldRunner(cfg, fresh["lr_train"], fresh["hr_train"], folds,
                           device=dev)
    p_resumed, loss_resumed, _ = second.train(checkpoint_path=ck2,
                                              checkpoint_every=1)
    straight = load_arrays(ck)
    if int(straight["epoch"]) != 2 or not np.array_equal(
            p_resumed.cpu().numpy(), straight["p"]) or not np.array_equal(
            loss_resumed, straight["loss_hist"]):
        fail("resumed run (1 + 1 epochs) differs from the 2-epoch run")
    print("  resume: 1 + 1 epochs end bit-equal to the straight 2-epoch run "
          f"(loss {loss_resumed[:, -1].tolist()})")
    return counts


# ---------------------------------------------------------------------------
# phase 6: the fused entry points and every other trainer mode
# ---------------------------------------------------------------------------

STEP_KERNELS = ("bgemm_f32", "rank_select", "gather_rows", "scatter_rows",
                "pool_bwd_pair", "add_bias", "tail_normalize",
                "tail_normalize_bwd", "sym_abs_fill", "sym_sign_grad",
                "l1_term", "adam_masked")
TAIL_KERNELS = ("bgemm_f32", "tail_normalize", "tail_normalize_bwd",
                "sym_abs_fill", "sym_sign_grad", "l1_term")
# the forward pools gather in their rank_select launch: no gather_rows
UNET_FWD_KERNELS = ("bgemm_f32", "rank_select", "scatter_rows", "add_bias")
# own-kernel launches per call of the loss entry points and per step of
# each trainer mode: the loss scalars come out of the spectral term's
# l1_term launch, with no launch of their own
ENTRY_LAUNCHES = {"tail_loss_fused": 27, "gsr_step_loss_fused": 105,
                  "step_value_and_grad_fused": 105}
MODE_LAUNCHES = {"unfused": 1, "fused_tail": 28, "fused_tail_unet": 52,
                 "fused_tail_unet_bwd": 105, "fused_step": 106,
                 "fused_adam": STEP_LAUNCHES}
# the kernels each trainer mode must launch (the flat Adam of every mode is
# one adam_masked launch)
MODE_KERNELS = {
    "unfused": ("adam_masked",),
    "fused_tail": TAIL_KERNELS + ("adam_masked",),
    "fused_tail_unet": tuple(dict.fromkeys(
        TAIL_KERNELS + UNET_FWD_KERNELS + ("adam_masked",))),
    "fused_tail_unet_bwd": STEP_KERNELS,
    "fused_step": STEP_KERNELS,
}
MODE_FLAGS = {
    "unfused": {},
    "fused_tail": dict(fused_tail=True),
    "fused_tail_unet": dict(fused_tail=True, fused_unet=True),
    "fused_tail_unet_bwd": dict(fused_tail=True, fused_unet=True,
                                fused_unet_bwd=True),
    "fused_step": dict(fused_step=True),
    "fused_adam": dict(fused_adam=True),
}


def _nonzero(counts):
    return {k: c for k, c in counts.items() if c}


def check_entry_points(dev, step_args):
    """Each fused entry point at F = 3 and full width against autograd over
    its plain PyTorch version: values to 1e-5 relative, every gradient to
    1e-4 of the plain gradient's largest entry (fp32 sums in another order
    than cuBLAS's through ~20 chained products); launches and times of the
    forward and of forward + backward, the loss entry points' launches
    ``ENTRY_LAUNCHES``; then their loss and recon bit for bit against the
    loss terms (``_check_entry_losses``) and their times
    (``entry_point_times``)."""
    from fcsr_tpu_torch.iox.weights import (leaf_names,
                                            leaf_tensors_to_state)
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.models import fused_step as fs
    from fcsr_tpu_torch.models.fused_tail import (_tail_loss,
                                                  tail_loss_fused)

    p, _, _, u_lr, u_hr, hr = step_args[:6]
    layout = fs.FlatLayout(LR, HR, len(KS))
    net_names = leaf_names(len(KS), tail=False)
    tail_names = ("layer.weights", "gc1.weight", "gc2.weight")
    g = torch.Generator(device="cpu").manual_seed(6)
    ct = torch.tensor([2.5, 1.0, -0.5], device=dev)
    ct_net = torch.randn(F, LR, HR, generator=g).to(dev)
    ct_start = torch.randn(F, LR, HR, generator=g).to(dev)
    with torch.no_grad():
        f0, _ = fs.unet_forward_rankselect(layout.views(p), KS, LR)

    def leaves():
        """Leaf views of a fresh copy of the flat weights, as the trainer
        hands them over, each an autograd leaf."""
        return {k: t.requires_grad_()
                for k, t in layout.views(p.clone()).items()}

    def unet_case(fn):
        def fused(P):
            net, start = fn({k: P[k] for k in net_names}, KS, LR, HR,
                            device=dev)
            return (net, start), (net * ct_net).sum() + (start
                                                         * ct_start).sum()

        def plain(P):
            net, start = fs.unet_forward_rankselect(P, KS, LR)
            return (net, start), (net * ct_net).sum() + (start
                                                         * ct_start).sum()
        return fused, plain, net_names

    def tail_fused(P):
        loss = tail_loss_fused(*[P[k] for k in tail_names], P["f"], u_lr,
                               u_hr, hr, device=dev)
        return (loss,), (ct * loss).sum()

    def tail_plain(P):
        loss, _ = _tail_loss(*[P[k] for k in tail_names], P["f"], u_lr, u_hr,
                             hr)
        return (loss,), (ct * loss).sum()

    def step_fused(P):
        loss, recon = fs.gsr_step_loss_fused(
            {k: P[k] for k in net_names}, *[P[k] for k in tail_names], u_lr,
            u_hr, hr, KS, LR, HR, 16.0, device=dev)
        if recon.requires_grad:
            fail("gsr_step_loss_fused: recon carries a gradient")
        return (loss, recon), (ct * loss).sum()

    def step_plain(P):
        loss, recon = fs.step_loss_pure(P, None, hr, u_lr, u_hr, KS, LR,
                                        16.0)
        return (loss, recon.detach()), (ct * loss).sum()

    cases = [("tail_loss_fused", tail_fused, tail_plain,
              tail_names + ("f",)),
             ("unet_fused", *unet_case(fs.unet_fused)),
             ("unet_fused_fwdonly", *unet_case(fs.unet_fused_fwdonly)),
             ("unet_fused_fwdbwd", *unet_case(fs.unet_fused_fwdbwd)),
             ("gsr_step_loss_fused", step_fused, step_plain,
              tuple(leaf_names(len(KS))))]
    entry_outs = {}
    for name, fused, plain, wrt in cases:
        def run(fn, backward=True):
            P = leaves()
            P["f"] = f0.clone().requires_grad_()
            outs, objective = fn(P)
            grads = torch.autograd.grad(objective, [P[k] for k in wrt]) \
                if backward else ()
            return [o.detach() for o in outs], grads

        reset_launch_counts()
        run(fused, backward=False)
        fwd_counts = _nonzero(launch_counts())
        reset_launch_counts()
        outs, grads = run(fused)
        all_counts = _nonzero(launch_counts())
        w_outs, w_grads = run(plain)
        torch.cuda.synchronize()
        v_err = max(max_err(a, b) / scale_of(b) for a, b in zip(outs, w_outs))
        g_err = max(max_err(a, b) / max(float(b.abs().max()), 1e-3)
                    for a, b in zip(grads, w_grads))
        ms = [device_ms(lambda: run(fused, backward=False), reps=3),
              device_ms(lambda: run(fused), reps=3),
              device_ms(lambda: run(plain), reps=3),
              cuda_ms(lambda: run(fused), reps=3)]
        print(f"  {name:20s} value rel err {v_err:.2e} (limit 1e-5), worst "
              f"gradient err / max {g_err:.2e} (limit 1e-4, {len(grads)} "
              f"gradients); device ms fwd {ms[0]:.3f}, fwd+bwd {ms[1]:.3f} "
              f"(eager {ms[3]:.3f}), plain fwd+bwd {ms[2]:.3f}; launches "
              f"fwd {sum(fwd_counts.values())} {fwd_counts}, fwd+bwd "
              f"{sum(all_counts.values())} {all_counts}", flush=True)
        if not (v_err <= 1e-5 and g_err <= 1e-4):
            fail(f"{name} disagrees with autograd over its plain version")
        if not all_counts:
            fail(f"{name} launched no kernel")
        if name in ENTRY_LAUNCHES and (sum(fwd_counts.values())
                                       != ENTRY_LAUNCHES[name]):
            fail(f"{name} launches {sum(fwd_counts.values())} kernels, not "
                 f"{ENTRY_LAUNCHES[name]}")
        entry_outs[name] = outs

    # step_value_and_grad_fused: the same launches over a state_dict
    with torch.no_grad():
        state = leaf_tensors_to_state(layout.views(p.clone()))
        state = {k: t.contiguous() for k, t in state.items()}
    reset_launch_counts()
    loss, recon, grads = fs.step_value_and_grad_fused(
        state, u_lr, u_hr, hr, KS, LR, HR, HR, 16.0, device=dev)
    counts = _nonzero(launch_counts())
    P = leaves()
    w_loss, w_recon = fs.step_loss_pure(P, None, hr, u_lr, u_hr, KS, LR, 16.0)
    w_grads = leaf_tensors_to_state(dict(zip(P, torch.autograd.grad(
        w_loss.sum(), list(P.values())))))
    torch.cuda.synchronize()
    v_err = max(max_err(loss, w_loss.detach()) / scale_of(w_loss.detach()),
                max_err(recon, w_recon.detach()))
    g_err = max(max_err(grads[k], w) / max(float(w.abs().max()), 1e-3)
                for k, w in w_grads.items())
    ms = device_ms(lambda: fs.step_value_and_grad_fused(
        state, u_lr, u_hr, hr, KS, LR, HR, HR, 16.0, device=dev), reps=3)
    print(f"  step_value_and_grad_fused value err {v_err:.2e} (limit 1e-5), "
          f"worst gradient err / max {g_err:.2e} (limit 1e-4, {len(grads)} "
          f"state_dict gradients); device ms {ms:.3f}; launches "
          f"{sum(counts.values())} {counts}", flush=True)
    if not (v_err <= 1e-5 and g_err <= 1e-4) or sorted(grads) != sorted(
            state):
        fail("step_value_and_grad_fused disagrees with its plain version")
    if sum(counts.values()) != ENTRY_LAUNCHES["step_value_and_grad_fused"]:
        fail(f"step_value_and_grad_fused launches {sum(counts.values())} "
             "kernels, not "
             f"{ENTRY_LAUNCHES['step_value_and_grad_fused']}")
    entry_outs["step_value_and_grad_fused"] = [loss, recon]
    _check_entry_losses(dev, p, u_lr, u_hr, hr, f0, entry_outs)
    entry_point_times(dev)


def _check_entry_losses(dev, p, u_lr, u_hr, hr, f0, entry_outs):
    """The loss entry points' scalars on the card, bit for bit: the terms
    ``vals`` of the same launches run directly (``tail_value_and_grad``,
    ``step_value_and_grads``), the loss summed from them in
    ``adam_masked``'s order (the tail's ``vals[1] + vals[2]`` with a NaN
    in the slot it must not read), recon ``vals[1]``, and each entry
    point's outputs equal to the direct run's."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS
    from fcsr_tpu_torch.models import fused_step as fs
    from fcsr_tpu_torch.models.fused_tail import tail_value_and_grad
    from fcsr_tpu_torch.models.gsr import pool_sizes

    layout = fs.FlatLayout(LR, HR, len(KS))
    with torch.no_grad():
        P = layout.views(p.clone())
        tail = [P[k] for k in ("layer.weights", "gc1.weight", "gc2.weight")]
        vals = torch.full((F, 3), float("nan"), device=dev)
        t_loss = torch.empty(F, device=dev)
        tail_value_and_grad(KERNEL_OPS, *tail, f0, u_lr, u_hr, hr, vals,
                            loss=t_loss, with_l1=False)
        t_want = vals[:, 1] + vals[:, 2]
        G = layout.views(torch.empty(F, layout.size, device=dev))
        s_loss, s_recon = torch.empty(F, device=dev), torch.empty(F,
                                                                 device=dev)
        svals = fs.step_value_and_grads(KERNEL_OPS, P, G, u_lr, u_hr, hr,
                                        pool_sizes(LR, KS), 16.0, s_loss,
                                        s_recon)
        s_want = svals[:, 0] + (svals[:, 1] + svals[:, 2])
    torch.cuda.synchronize()
    same = lambda x, y: torch.equal(_bits(x), _bits(y))
    checks = [("tail_loss_fused's terms", same(t_loss, t_want)),
              ("the step's terms", same(s_loss, s_want)
               and same(s_recon, svals[:, 1])),
              ("tail_loss_fused", same(entry_outs["tail_loss_fused"][0],
                                       t_loss))]
    for name in ("gsr_step_loss_fused", "step_value_and_grad_fused"):
        got_loss, got_recon = entry_outs[name]
        checks.append((name, same(got_loss, s_loss)
                       and same(got_recon, s_recon)))
    bad = [name for name, ok in checks if not ok]
    if bad:
        fail(f"loss scalars not bit-equal to the loss terms: {bad} (tail "
             f"{t_loss.tolist()} vs {t_want.tolist()}, step "
             f"{s_loss.tolist()} vs {s_want.tolist()})")
    print(f"  loss entry points: loss and recon bit-equal to their terms in "
          f"adam_masked's order (tail {t_loss.tolist()}, step "
          f"{s_loss.tolist()})", flush=True)


def _entry_inputs(dev):
    """Seeded full-width inputs of the loss entry points at F = 3: the flat
    weights of three GSRNet inits, an orthonormal u_lr, u_hr and a
    symmetric hr."""
    from fcsr_tpu_torch.iox.weights import state_to_flat
    from fcsr_tpu_torch.models.gsr import GSRNet

    flat = np.stack([state_to_flat({k: v.numpy() for k, v in GSRNet(
        KS, LR, HR, HR, device="cpu", seed=j).state_dict().items()})
        for j in range(F)])
    g = torch.Generator(device="cpu").manual_seed(12)
    u_lr = torch.linalg.qr(torch.randn(F, LR, LR, generator=g))[0]
    u_hr = torch.randn(F, HR, LR, generator=g)
    hr = torch.rand(F, HR, HR, generator=g)
    hr = (hr + hr.transpose(1, 2)) / 2
    return [t.contiguous().to(dev) for t in (torch.from_numpy(flat), u_lr,
                                             u_hr, hr)]


def entry_point_times(dev):
    """The loss entry points #4, #8 and #10 (forward only) at F = 3 and
    full width on seeded inputs (``_entry_inputs``): launches, device ms
    per call (three calls in a CUDA graph), eager ms per call and the
    host's us per call (``_eager_and_host``, 5 rounds of 20 calls). It
    calls only the public entry points, so it also times an older tree
    (load this file by path with that tree's root as the working
    directory). Returns {name: (launches, ms, eager ms, host us)}."""
    from fcsr_tpu_torch.iox.weights import leaf_names, leaf_tensors_to_state
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.models import fused_step as fs
    from fcsr_tpu_torch.models.fused_tail import tail_loss_fused

    p, u_lr, u_hr, hr = _entry_inputs(dev)
    P = fs.FlatLayout(LR, HR, len(KS)).views(p)
    net = {k: P[k] for k in leaf_names(len(KS), tail=False)}
    tail = [P[k] for k in ("layer.weights", "gc1.weight", "gc2.weight")]
    with torch.no_grad():
        f0, _ = fs.unet_forward_rankselect(P, KS, LR)
        state = {k: t.contiguous()
                 for k, t in leaf_tensors_to_state(P).items()}
    calls = {
        "tail_loss_fused": lambda: tail_loss_fused(
            *tail, f0, u_lr, u_hr, hr, device=dev),
        "gsr_step_loss_fused": lambda: fs.gsr_step_loss_fused(
            net, *tail, u_lr, u_hr, hr, KS, LR, HR, 16.0, device=dev),
        "step_value_and_grad_fused": lambda: fs.step_value_and_grad_fused(
            state, u_lr, u_hr, hr, KS, LR, HR, HR, 16.0, device=dev)}
    out = {}
    with torch.no_grad():
        for name, call in calls.items():
            reset_launch_counts()
            call()
            torch.cuda.synchronize()
            launches = sum(launch_counts().values())
            ms = device_ms(call, reps=3)
            eager, host = _eager_and_host(call, rounds=5, calls=20)
            print(f"    {name}: {launches} launches, {ms:.4f} ms device, "
                  f"{eager:.4f} ms eager, host {host:.1f} us per call",
                  flush=True)
            out[name] = (launches, ms, eager, host)
    return out


def run_trainer_modes(dev, data):
    """One full-width epoch over 3 folds in every fold-parallel mode, all
    from the same initial weights. Returns the launch counts summed over
    the five new modes."""
    from fcsr_tpu_torch import (GSRFoldRunner, GSRTrainConfig,
                                kfold_indices)
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    folds = kfold_indices(len(data["lr_train"]), 3, seed=42)
    total, runs = {}, {}
    scal = torch.tensor([[1.0, 1 - 0.9, 1 - 0.999]] * len(folds), device=dev)
    for mode, flags in MODE_FLAGS.items():
        runner = GSRFoldRunner(GSRTrainConfig(epochs=1, **flags),
                               data["lr_train"], data["hr_train"], folds,
                               device=dev)
        if runner.mode != mode:
            fail(f"config {flags} runs mode {runner.mode}")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        p, loss_hist, err_hist = runner.train()
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        counts = _nonzero(launch_counts())
        maes, _ = runner.evaluate()
        steps = runner.tr_idx.shape[1]
        runs[mode] = (p, loss_hist, err_hist, maes)
        per_step = {k: round(c / steps, 2) for k, c in counts.items()}
        # the step alone, without the host's gaps: one CUDA graph of it
        p0, m0, v0, _ = runner.fresh_state()
        dev_ms = device_ms(lambda: runner._step(p0, m0, v0, 0, scal), reps=3)
        print(f"  {mode:20s} {t_train:.3f} s/epoch, "
              f"{1e3 * t_train / steps:.3f} ms/step in the loop (the epoch "
              f"graph, {capture_note(runner)}), "
              f"{dev_ms:.3f} ms/step device; loss "
              f"{loss_hist[:, 0].tolist()} recon {err_hist[:, 0].tolist()} "
              f"val MAE {maes.tolist()}; {sum(counts.values()) / steps:.1f} "
              f"launches/step {per_step}", flush=True)
        if not (np.isfinite(loss_hist).all() and np.isfinite(maes).all()):
            fail(f"{mode}: non-finite loss or MAE")
        runner.release_graphs()
        if sum(counts.values()) != MODE_LAUNCHES[mode] * steps:
            fail(f"{mode}: {sum(counts.values())} launches in {steps} "
                 f"steps, not {MODE_LAUNCHES[mode]} a step")
        if mode == "fused_adam":
            continue
        missing = [k for k in MODE_KERNELS[mode] if not counts.get(k)]
        extra = [k for k in counts if k not in MODE_KERNELS[mode]]
        if missing or extra:
            fail(f"{mode}: kernels of its path never launched: {missing}; "
                 f"kernels off its path launched: {extra}")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c

    ref = runs["fused_adam"]
    got = runs["fused_step"]
    if not (torch.equal(got[0], ref[0])
            and np.array_equal(got[1], ref[1])
            and np.array_equal(got[2], ref[2])):
        fail("fused_step is not bit-equal to fused_adam")
    print("  fused_step == fused_adam bit for bit (parameters, loss and "
          f"recon histories after {steps} steps)")
    # the other modes reach the same gradient by sums in another order;
    # Adam's first steps are lr * g / |g|, so a near-zero gradient entry of
    # either sign moves a parameter by up to 2 lr per step: the parameters
    # are reported, the epoch's loss and the val MAE are held to 1e-3
    for mode in ("fused_tail_unet_bwd", "fused_tail_unet", "fused_tail",
                 "unfused"):
        got = runs[mode]
        d_p = float((got[0] - ref[0]).abs().max())
        d_loss = float(np.abs(got[1] - ref[1]).max())
        d_mae = float(np.abs(got[3] - ref[3]).max())
        print(f"  {mode:20s} vs fused_adam: max|d loss| {d_loss:.2e} (limit "
              f"1e-3), max|d MAE| {d_mae:.2e} (limit 1e-3), max|d p| "
              f"{d_p:.2e}")
        if not (d_loss <= 1e-3 and d_mae <= 1e-3):
            fail(f"{mode} disagrees with fused_adam after one epoch")
    return total


def run_parity_cli(dev, csv_dir):
    """The reference-faithful trainer through the command line: `train gsr`
    with no flag, 2 folds x 1 epoch on the CSVs of phase 5 (one model
    carried across the folds, per-sample Adam). Returns its launch
    counts."""
    from fcsr_tpu_torch import cli
    from fcsr_tpu_torch.iox import load_state
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    out_dir = os.path.join(WORK_DIR, "out_parity")
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["train", "gsr", "--epochs", "1", "--splits", "2",
                   "--data-dir", csv_dir, "--out-dir", out_dir])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    counts = _nonzero(launch_counts())
    if rc != 0:
        fail(f"`train gsr` returned {rc}")
    state = load_state(os.path.join(out_dir, "gsr_params.npz"))
    sub = _read_submission(os.path.join(out_dir, "submission.csv"),
                           N_TEST * HR * (HR - 1) // 2)
    if tuple(state["layer.weights"].shape) != (HR, LR) \
            or not all(np.isfinite(v).all() for v in state.values()) \
            or not np.isfinite(sub).all():
        fail("`train gsr`: parameters or submission malformed")
    print(f"  `train gsr` (parity trainer, {N_TRAIN} per-sample steps) "
          f"{t_cli:.1f} s; launches {counts}", flush=True)
    if not counts.get("normalize_adj_batch"):
        fail("the parity path never launched normalize_adj_batch")
    return counts


# ---------------------------------------------------------------------------
# phase 7: the GAT U-Net family
# ---------------------------------------------------------------------------

GAT_KS, GAT_DIM, GAT_HEADS = (0.5, 0.5, 0.5), 16, 4
GAT_KW = dict(dim=GAT_DIM, ks=GAT_KS, n_nodes=LR, m_nodes=HR, heads=GAT_HEADS)
# (n, heads, d_head) of the seven GAT layers at the shipped width
GAT_LAYER_SHAPES = ((160, 4, 8), (80, 4, 16), (40, 4, 32), (20, 2, 64),
                    (40, 4, 16), (80, 4, 8), (160, 4, 4))
# every kernel the fused GAT trainer must launch (training at drop_p > 0
# and the fused validation forwards)
GAT_PATH = GAT_NEW + ("bgemm_f32", "rank_select", "gather_rows",
                      "scatter_rows", "pool_logits_bwd")


def _gat_seeds(dev, n):
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(n, 2),
                                         dtype=np.int64).astype(np.int32)
                            ).to(dev)


def _sparse_adj(g, n, dev, density=0.3):
    """(F, n, n) symmetric non-negative adjacency with real zeros, so the
    attention mask is exercised."""
    m = torch.rand(F, n, n, generator=g) * (torch.rand(F, n, n, generator=g)
                                            < density)
    m = torch.triu(m, 1)
    return (m + m.transpose(1, 2)).to(dev)


def gat_attention_ops(nf, n, H, d):
    """Operations of one gat_attention call: s and t once per node and
    head (2 d each), per pair ~12 for the logit, its softmax and dropout,
    and 2 d for the product (alpha keep) @ h."""
    return nf * H * (2.0 * n * n * d + 12.0 * n * n + 4.0 * n * d)


def gat_kernel_cases(dev):
    """One record case per new kernel at the top level's shape (F = 3,
    n = 160, 4 heads of 8), as ``kernel_cases``."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.models.fused_gat import GATLayout

    g = torch.Generator(device="cpu").manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    cases = []
    f4 = 4.0 * F
    n, H, d = GAT_LAYER_SHAPES[0]
    HD = H * d
    seeds = _gat_seeds(dev, F)
    h, asrc, adst = rnd(F, n, HD), rnd(F, H, d), rnd(F, H, d)
    bias, a = rnd(F, 1, HD, scale=0.1), _sparse_adj(g, n, dev)
    p = 0.01
    att = lambda ops: ops.gat_attention(h, asrc, adst, bias, a, seeds, 0, p)
    cases.append(("gat_attention", lambda: att(K), lambda: att(P), 1e-5,
                  gat_attention_ops(F, n, H, d),
                  f4 * (2 * n * HD + 3 * HD + n * n + H * n * n) + 8.0 * F,
                  None))
    y, alpha = att(K)
    gy = rnd(F, n, HD)

    def att_bwd(ops):
        outs = (torch.empty(F, H, d, device=dev),
                torch.empty(F, H, d, device=dev),
                torch.empty(F, 1, HD, device=dev))
        return (ops.gat_attention_bwd(gy, y, alpha, h, asrc, adst, seeds, 0,
                                      p, *outs),) + outs
    cases.append(("gat_attention_bwd", lambda: att_bwd(K),
                  lambda: att_bwd(P), 1e-5,
                  F * H * n * (8.0 * n * d + 12.0 * n),
                  f4 * (4 * n * HD + 5 * HD + H * n * n) + 8.0 * F, None))
    # the keep-rate experiment's mask, bound by the draws' integer work: no
    # flops, the Philox draws' SM clocks of integer issue (as compiled, by
    # pipe)
    s4 = _gat_seeds(dev, 4)
    cases.append(("philox_keep_mask",
                  lambda: K.philox_keep_mask(s4, 0, 4, 256, 256, 0.1),
                  lambda: P.philox_keep_mask(s4, 0, 4, 256, 256, 0.1), 0.0,
                  (0.0, philox_clocks(16 * 256 * 256)),
                  4.0 * 16 * 256 * 256 + 32.0, None))
    # the pool's dropout inside its products at the first pool (F = 3,
    # 160 x 32, drop_p 0.01): z and g_z bit-equal to the plain version, the
    # logits (gemv_dot's sum order, not the library product's) within 1e-5
    x, gl, w, b, es = _pool_drop_inputs(n, HD, 11, dev)
    s99 = 1.0 / 0.99
    nc = F * n * HD
    cases.append(("philox_drop_logits",
                  lambda: K.philox_drop_logits(x, w, b, es, 1, 0.01, s99),
                  lambda: P.philox_drop_logits(x, w, b, es, 1, 0.01, s99),
                  (0.0, 1e-5), (2.0 * nc, philox_clocks(nc)),
                  4.0 * (2 * nc + F * n + F * HD + F) + 8.0 * F, None))
    cases.append(("philox_drop_outer",
                  lambda: K.philox_drop_outer(gl, w, es, 1, 0.01, s99),
                  lambda: P.philox_drop_outer(gl, w, es, 1, 0.01, s99),
                  0.0, (2.0 * nc, philox_clocks(nc)),
                  4.0 * (nc + F * n + F * HD) + 8.0 * F, None))
    k = n // 2
    idx = torch.stack([torch.randperm(n, generator=g)[:k]
                       for _ in range(F)]).to(torch.int32).to(dev)
    aw = rnd(F, n, n).abs()
    cases.append(("gat_pool_adj", lambda: K.gat_pool_adj(aw, idx),
                  lambda: P.gat_pool_adj(aw, idx), 1e-6,
                  3.0 * F * k * k, f4 * (2 * k * k + k), None))
    yy = rnd(F, GAT_DIM, HR)
    cases.append(("col_softmax", lambda: K.col_softmax(yy),
                  lambda: P.col_softmax(yy), 1e-6, 4.0 * F * GAT_DIM * HR,
                  f4 * 2 * GAT_DIM * HR, lambda: torch.softmax(yy, 1)))
    q, gq = K.col_softmax(yy), rnd(F, GAT_DIM, HR)
    cases.append(("col_softmax_bwd", lambda: K.col_softmax_bwd(gq, q),
                  lambda: P.col_softmax_bwd(gq, q), 1e-6,
                  4.0 * F * GAT_DIM * HR, f4 * 3 * GAT_DIM * HR,
                  lambda: torch._softmax_backward_data(gq, q, 1,
                                                       torch.float32)))
    G, T = rnd(F, HR, HR), rnd(F, HR, HR).abs()
    vk, vp = torch.zeros(F, 4, device=dev), torch.zeros(F, 4, device=dev)
    cases.append(("offdiag_mse",
                  lambda: (K.offdiag_mse(G, T, vk, 0), vk[:, 0]),
                  lambda: (P.offdiag_mse(G, T, vp, 0), vp[:, 0]), 1e-6,
                  8.0 * F * HR * HR, f4 * (3 * HR * HR + 1), None))

    def mae(ops, vals):
        ops.offdiag_mae(G, T, vals, 1)
        return vals[:, 1]
    cases.append(("offdiag_mae", lambda: mae(K, vk), lambda: mae(P, vp),
                  1e-6, 3.0 * F * HR * HR, f4 * (2 * HR * HR + 1), None))
    n_p = GATLayout(GAT_DIM, GAT_KS, GAT_HEADS, LR, HR).size
    pp, gg = rnd(F, n_p), rnd(F, n_p, scale=1e-2)
    mm_, vv = rnd(F, n_p, scale=1e-3), rnd(F, n_p, scale=1e-3).abs()
    scal = torch.tensor([[1.0, 1e-3, 1 - 0.9 ** 5, 1 - 0.999 ** 5]] * F,
                        device=dev)
    scal[2, 0] = 0.0
    terms = rnd(F, 4).abs()
    args = (pp, mm_, vv, gg, scal, terms, 0.9, 0.999, 1e-8, 0.01)
    cases.append(("adamw_masked", lambda: K.adamw_masked(*args),
                  lambda: P.adamw_masked(*args), 0.0, 15.0 * F * n_p,
                  f4 * 7 * n_p, None))
    return cases


def _bound_of(ops, nbytes):
    """``bound`` of a case's ops, flops or (flops, SM clocks of integer
    issue) where the kernel draws Philox words, and bytes."""
    flops, int_clocks = ops if isinstance(ops, tuple) else (ops, 0.0)
    return bound(flops, nbytes, int_clocks)


def check_gat_kernels(dev):
    """Phase 7.1: records of the GAT family's eleven kernels, then every
    shape the step uses at drop_p 0, 0.01 and 0.3 (the plain versions draw
    the very masks the kernels draw). Records are timed as phase 2's are,
    in turns."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    records = {}
    for name, kern, plain, tol, flops, nbytes, lib in gat_kernel_cases(dev):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if isinstance(tol, tuple):      # a tolerance for each output
            errs = [max_err(a, b) for a, b in zip(got, want)]
            limits = [t * scale_of(b) for t, b in zip(tol, want)]
            ok = all(e <= lim for e, lim in zip(errs, limits))
            err, limit = max(errs), max(limits)
        else:
            err = max_err(got, want)
            limit = tol * scale_of(want)
            ok = err <= limit
        if not ok:
            fail(f"kernel {name} disagrees with its plain version "
                 f"(max|err| {err:.3e}, limit {limit:.1e})")
        ms, plain_ms, *lib_ms = graph_ms(
            [kern, plain] + ([lib] if lib is not None else []))
        lib_ms = lib_ms[0] if lib_ms else None
        b_ms, b_by = _bound_of(flops, nbytes)
        print(f"  {name:20s} max|err| {err:.3e} (limit {limit:.1e}) ok  "
              f"kernel {ms:.4f} ms (eager from Python {cuda_ms(kern):.4f})  "
              f"plain {plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})"
              + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else ""),
              flush=True)
        records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": lib_ms}

    g = torch.Generator(device="cpu").manual_seed(4)
    seeds = _gat_seeds(dev, F)
    worst = 0.0
    for li, (n, H, d) in enumerate(GAT_LAYER_SHAPES):
        HD = H * d
        h = torch.randn(F, n, HD, generator=g).to(dev)
        asrc = torch.randn(F, H, d, generator=g).to(dev)
        adst = torch.randn(F, H, d, generator=g).to(dev)
        bias = (0.1 * torch.randn(F, 1, HD, generator=g)).to(dev)
        a = _sparse_adj(g, n, dev)
        gy = torch.randn(F, n, HD, generator=g).to(dev)
        for p in (0.0, 0.01, 0.3):
            for shift in (False, True):
                yk, ak = K.gat_attention(h, asrc, adst, bias, a, seeds, li,
                                         p, shift)
                yp, ap = P.gat_attention(h, asrc, adst, bias, a, seeds, li,
                                         p, shift)
                err = max(max_err(yk, yp) / scale_of(yp), max_err(ak, ap))
                worst = max(worst, err)
                if not err <= 1e-5:
                    fail(f"gat_attention n={n} heads={H} d={d} p={p} "
                         f"global_shift={shift}: err {err:.2e}")
            outs = []
            for ops in (K, P):
                gp = (torch.empty(F, H, d, device=dev),
                      torch.empty(F, H, d, device=dev),
                      torch.empty(F, 1, HD, device=dev))
                outs.append((ops.gat_attention_bwd(gy, yp, ap, h, asrc, adst,
                                                   seeds, li, p, *gp),) + gp)
            for got, want in zip(*outs):
                err = max_err(got, want) / scale_of(want)
                worst = max(worst, err)
                if not err <= 1e-5:
                    fail(f"gat_attention_bwd n={n} heads={H} d={d} p={p}: "
                         f"err {err:.2e}")
        k_ms = device_ms(lambda: K.gat_attention(h, asrc, adst, bias, a,
                                                 seeds, li, 0.01))
        kb_ms = device_ms(lambda: K.gat_attention_bwd(
            gy, yp, ap, h, asrc, adst, seeds, li, 0.01, *gp))
        print(f"    gat_attention n={n:3d} heads={H} d_head={d:2d}: forward "
              f"{k_ms:.4f} ms, backward {kb_ms:.4f} ms")
    # pool: scores without GSR's / 100, square gather, its adjoint, dropout
    for n, D in ((160, 32), (80, 64), (40, 128)):
        k = n // 2
        logits = torch.randn(F, n, generator=g).to(dev) * 30.0
        logits[:, 3:6] = 40.0                    # saturated sigmoid: a tie
        x = torch.randn(F, n, D, generator=g).to(dev)
        got = K.rank_select(logits, k, 1.0, src=x)
        want = P.rank_select(logits, k, 1.0, src=x)
        if not all(_same(a, b) for a, b in zip(got, want)):
            fail(f"rank_select(div=1) n={n} with its rows disagrees")
        s, idx, vals, slot = got[:4]
        a = torch.rand(F, n, n, generator=g).to(dev)
        err = max_err(K.gat_pool_adj(a, idx), P.gat_pool_adj(a, idx))
        gx = torch.randn(F, k, D, generator=g).to(dev)
        pre = torch.randn(F, k, D, generator=g).to(dev)
        err = max(err, max_err(K.pool_logits_bwd(gx, pre, slot, s, 1.0),
                               P.pool_logits_bwd(gx, pre, slot, s, 1.0)))
        for p in (0.01, 0.3):
            if not torch.equal(
                    K.philox_keep_mask(seeds, 1, 1, n, D, p, x, 1 / (1 - p)),
                    P.philox_keep_mask(seeds, 1, 1, n, D, p, x, 1 / (1 - p))):
                fail(f"philox_keep_mask applied to ({n}, {D}) differs")
        worst = max(worst, err)
        if not err <= 1e-5:
            fail(f"pool kernels n={n}: err {err:.2e}")
    n_keep = check_keep_mask(dev, g)
    for n in (268, 160, 80, 40):
        G = torch.randn(F, n, n, generator=g).to(dev)
        T = torch.rand(F, n, n, generator=g).to(dev)
        vk, vp = torch.zeros(F, 4, device=dev), torch.zeros(F, 4, device=dev)
        err = max_err(K.offdiag_mse(G, T, vk, 2), P.offdiag_mse(G, T, vp, 2))
        K.offdiag_mae(G, T, vk, 3)
        P.offdiag_mae(G, T, vp, 3)
        err = max(err, max_err(vk, vp))
        worst = max(worst, err)
        if not err <= 1e-6:
            fail(f"offdiag losses n={n}: err {err:.2e}")
    print(f"  shape sweep ok: 7 attention shapes x drop_p (0, 0.01, 0.3) x "
          f"both softmax shifts with their backward, 3 pools, {n_keep} keep "
          f"masks, 4 loss sizes; worst err / scale {worst:.2e}")
    return records


def check_keep_mask(dev, g):
    """``philox_keep_mask`` bit-equal to its plain version at the keep-rate
    shape, every mask ``draw_masks`` dumps at the shipped GAT config (F =
    3) and an odd plane (the 4-byte path), mask id its place in that list,
    drop_p 0.01 and 0.3, under random and edge seeds, alone and applied to
    x (with its scale) from an aligned buffer and from a view one float off
    16 bytes (the 4-byte path). Returns the number of masks checked."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.models.fused_gat import _mask_shapes

    shapes = (((4, 4, 256, 256),)
              + tuple((F, h, r, c) for _, h, (r, c) in
                      _mask_shapes(GAT_DIM, GAT_KS, LR, GAT_HEADS))
              + ((F, 2, 7, 9),))
    checked = 0
    for mask_id, (nf, heads, rows, cols) in enumerate(shapes):
        n = nf * heads * rows * cols
        flat = torch.randn(n + 1, generator=g).to(dev)
        for edge in (False, True):
            seeds = _gat_seeds(dev, nf)
            if edge:
                seeds[0] = torch.tensor(EDGE_SEEDS, dtype=torch.int32)
            for p in (0.01, 0.3):
                args = (seeds, mask_id, heads, rows, cols, p)
                forms = [("mask", ())] + [
                    (f"applied to x {off} float(s) off 16 bytes",
                     (flat[off:off + n].view(nf, heads, rows, cols),
                      1 / (1 - p))) for off in (0, 1)]
                for what, extra in forms:
                    if not torch.equal(K.philox_keep_mask(*args, *extra),
                                       P.philox_keep_mask(*args, *extra)):
                        fail(f"philox_keep_mask ({nf}, {heads}, {rows}, "
                             f"{cols}) p={p} edge seeds={edge} {what}: "
                             "kernel and plain bits differ")
                    checked += 1
    return checked


# philox_keep_mask's timed shapes (F, heads, rows, cols): the keep-rate
# experiment's, the shipped GAT config's largest and smallest attention
# masks at F = 3 (att_down_0, att_bottom) and a pool mask (pool_0), the
# last also applied to x with its scale
KEEP_MASK_SHAPES = ((4, 4, 256, 256), (F, 4, LR, LR), (F, 2, 20, 20),
                    (F, 1, LR, 32))


def keep_mask_times(dev):
    """``philox_keep_mask`` at ``KEEP_MASK_SHAPES`` and applied to x (with
    its scale) at the pool mask's: device ms per launch in a CUDA graph, in
    turns with the plain version, beside its bound by this build's count of
    a draw's instructions and by the parent's (``PARENT_DRAW``), the share
    against the lower; eager ms and host us per call. It calls only
    ``philox_keep_mask``, so it also times an older tree (load this file by
    path with that tree's root as the working directory). Returns {label:
    (ms, eager ms, host us, plain ms)}."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device="cpu").manual_seed(13)
    cases = []
    for nf, H, r, c in KEEP_MASK_SHAPES:
        seeds = _gat_seeds(dev, nf)
        args = (seeds, 0, H, r, c, 0.1)
        n = nf * H * r * c
        cases.append((f"({nf}, {H}, {r}, {c})", n, 4.0 * n + 8.0 * nf,
                      lambda a=args: K.philox_keep_mask(*a),
                      lambda a=args: P.philox_keep_mask(*a)))
    x = torch.randn(nf, H, r, c, generator=g).to(dev)
    args = (seeds, 1, H, r, c, 0.01, x, 1 / 0.99)
    cases.append((f"({nf}, {H}, {r}, {c}) applied to x", n,
                  8.0 * n + 8.0 * nf, lambda: K.philox_keep_mask(*args),
                  lambda: P.philox_keep_mask(*args)))
    ms = graph_ms([fn for case in cases for fn in case[3:]])
    out = {}
    for i, (label, draws, nbytes, kern, _) in enumerate(cases):
        k_ms, p_ms = ms[2 * i], ms[2 * i + 1]
        b_ms, b_by = bound(0.0, nbytes, philox_clocks(draws))
        old_ms, old_by = bound(0.0, nbytes,
                               philox_clocks(draws, PARENT_DRAW))
        eager, host = _eager_and_host(kern)
        print(f"    philox_keep_mask {label}: {k_ms:.5f} ms per launch "
              f"(plain {p_ms:.5f}); bound {b_ms:.6f} ({b_by}), by the "
              f"parent's count {old_ms:.6f} ({old_by}): "
              f"{100 * min(b_ms, old_ms) / k_ms:.0f}% of the lower; "
              f"{eager:.5f} ms eager, host {host:.3f} us", flush=True)
        out[label] = (k_ms, eager, host, p_ms)
    return out


def run_keep_rate(dev):
    """Phase 7.1a, the keep-rate experiment's counterpart (the path of
    ``tools/experiments/gat_dropout_keeprate.py``'s ``mask_kernel``, whose
    port ``philox_keep_mask`` no trainer path launches): the generator's
    keep rate as the TPU experiment measured its own, (256, 256) x 4
    heads x 4 seeds per p, inside a 4-sigma binomial bound, every mask
    bit-equal to the plain version's. Returns the launch counts of this
    run (counts set to 0 just before it)."""
    from fcsr_tpu_torch.kernels import (KERNEL_OPS as K, PLAIN_OPS as P,
                                        launch_counts, reset_launch_counts)

    s4 = _gat_seeds(dev, 4)
    reset_launch_counts()
    for p in (0.01, 0.1, 0.5):
        mask = K.philox_keep_mask(s4, 0, 4, 256, 256, p)
        if not torch.equal(mask, P.philox_keep_mask(s4, 0, 4, 256, 256, p)):
            fail(f"philox_keep_mask p={p}: kernel and plain bits differ")
        rate = float(mask.mean())
        sigma = (p * (1 - p) / mask.numel()) ** 0.5
        print(f"    keep rate at drop_p={p}: {rate:.6f} (expected "
              f"{1 - p:.2f}, 4 sigma = {4 * sigma:.6f}) over "
              f"{mask.numel()} draws")
        if not abs(rate - (1 - p)) < 4 * sigma + 1e-6:
            fail(f"keep rate {rate} at drop_p={p} outside the binomial bound")
    counts = _nonzero(launch_counts())
    if counts != {"philox_keep_mask": 3}:
        fail(f"the keep-rate run launched {counts}")
    return counts


# the GAT pools' dropout: the step's three pool inputs (n, c) at F = 3 and
# a wide one that takes many blocks, under the edge seeds
POOL_DROP_SHAPES = ((160, 32), (80, 64), (40, 128), (4096, 128))
EDGE_SEEDS = (-2 ** 31, 2 ** 31 - 1)
# col_softmax: the step's (F = 3) and the validation pass's (F = 56)
# upsampler, a `--dim 64` run's and one past the registers (y read again)
COL_SOFTMAX_SHAPES = ((F, 16, HR), (56, 16, HR), (F, 64, HR), (F, 200, HR))


def _pool_drop_inputs(n, c, seed, dev):
    """x (F, n, c), gl (F, n, 1) and a pool's w (F, c, 1), b (F, 1, 1) as
    views into a flat (F, P) buffer (as the step hands them over), and the
    edge seeds."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    flat = t(F, 3 + c + 1)
    seeds = torch.tensor([EDGE_SEEDS] * F, dtype=torch.int32, device=dev)
    return (t(F, n, c), t(F, n, 1), flat[:, 3:3 + c].view(F, c, 1),
            flat[:, 3 + c:].view(F, 1, 1), seeds)


def _pool_drop_pairs(K, x, gl, w, b, seeds, p):
    """The two launches each form replaced: ``philox_keep_mask`` then the
    scores' ``bgemm``, and the rank-1 ``bgemm`` then ``philox_keep_mask``."""
    F_, n, c = x.shape
    s = 1.0 / (1.0 - p)

    def fwd():
        z = K.philox_keep_mask(seeds, 1, 1, n, c, p, x, s)
        return z, K.bgemm(z, w, bias=b)
    return fwd, lambda: K.philox_keep_mask(seeds, 1, 1, n, c, p,
                                           K.bgemm(gl, w, tb=True), s)


def check_pool_dropout(dev):
    """Phase 7.1d: the pool's dropout drawn inside its two products.
    ``philox_drop_logits`` and ``philox_drop_outer`` at the step's three
    pools and at (4096, 128), drop_p 0.01 and 0.3, seeds (-2^31, 2^31 -
    1): bit-equal to the two-launch pairs on the card (``philox_keep_mask``
    then ``bgemm``; ``bgemm`` rank-1 then ``philox_keep_mask``), eagerly
    and in a CUDA graph, and to their plain versions, but for the logits:
    those sum in gemv_dot's order, not the library product's, and are held
    to 1e-5 of their scale, as ``bgemm_f32`` is; then
    ``pool_dropout_times``."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import (philox_drop_logits_plan,
                                            philox_drop_outer_plan)

    worst = 0.0
    for n, c in POOL_DROP_SHAPES:
        x, gl, w, b, seeds = _pool_drop_inputs(n, c, n + c, dev)
        for p in (0.01, 0.3):
            s = 1.0 / (1.0 - p)
            fwd = lambda: K.philox_drop_logits(x, w, b, seeds, 1, p, s)
            bwd = lambda: K.philox_drop_outer(gl, w, seeds, 1, p, s)
            pair_f, pair_b = _pool_drop_pairs(K, x, gl, w, b, seeds, p)
            for name, kern, plain, pair in (
                    ("philox_drop_logits", fwd,
                     lambda: P.philox_drop_logits(x, w, b, seeds, 1, p, s),
                     pair_f),
                    ("philox_drop_outer", bwd,
                     lambda: P.philox_drop_outer(gl, w, seeds, 1, p, s),
                     pair_b)):
                got, want, old = kern(), plain(), pair()
                graphed = _graph_outputs(kern)
                torch.cuda.synchronize()
                if torch.is_tensor(got):        # the adjoint: one output
                    got, want, old, graphed = [got], [want], [old], [graphed]
                for what, other in (("its plain version", want),
                                    ("the two-launch pair", old),
                                    ("its graphed launch", graphed)):
                    ok = [torch.equal(_bits(a), _bits(e))
                          for a, e in zip(got, other)]
                    if other is want and len(ok) == 2:   # the logits
                        err = max_err(got[1], want[1])
                        ok[1] = err <= 1e-5 * scale_of(want[1])
                        worst = max(worst, err / scale_of(want[1]))
                    if not all(ok):
                        fail(f"{name} ({F}, {n}, {c}) drop_p {p}: not "
                             f"bit-equal to {what}")
        plan = philox_drop_outer_plan(F, n, c, True)
        print(f"    pool dropout ({F}, {n}, {c}): philox_drop_logits ("
              f"{philox_drop_logits_plan(F, n, c)} blocks x {F}) and "
              f"philox_drop_outer ({plan.blocks} blocks x {F}, {plan.vec} "
              "columns a thread) bit-equal to the two-launch pairs, eager "
              "and graphed, and to plain (the logits within 1e-5: worst "
              f"err / scale {worst:.2e}) at drop_p 0.01 / 0.3", flush=True)
    pool_dropout_times(dev)


def pool_dropout_times(dev):
    """The pool's dropout at the step's three pools (F = 3, drop_p 0.01):
    device ms per call in a CUDA graph of each one-launch form and of the
    two-launch pair it replaced, in turns, with eager ms and host us per
    call. It calls only kernel ops, so it also times an older tree of the
    port (load this file by path with that tree's root as the working
    directory), where only the pairs exist. Returns {label: (ms, eager
    ms, host us)}."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K
    from fcsr_tpu_torch.utils.timing import graph_ms

    new = hasattr(K, "philox_drop_logits")
    calls = []
    for n, c in POOL_DROP_SHAPES[:3]:
        x, gl, w, b, seeds = _pool_drop_inputs(n, c, n + c, dev)
        s = 1.0 / 0.99
        pair_f, pair_b = _pool_drop_pairs(K, x, gl, w, b, seeds, 0.01)
        calls += [(f"keep_mask + bgemm ({n}, {c})", pair_f),
                  (f"bgemm rank-1 + keep_mask ({n}, {c})", pair_b)]
        if new:
            calls += [(f"philox_drop_logits ({n}, {c})",
                       lambda x=x, w=w, b=b, seeds=seeds:
                       K.philox_drop_logits(x, w, b, seeds, 1, 0.01, s)),
                      (f"philox_drop_outer ({n}, {c})",
                       lambda gl=gl, w=w, seeds=seeds:
                       K.philox_drop_outer(gl, w, seeds, 1, 0.01, s))]
    ms = graph_ms([fn for _, fn in calls])
    out = {}
    for (label, fn), t in zip(calls, ms):
        eager, host = _eager_and_host(fn)
        print(f"    {label}: {t:.5f} ms per call in a graph, {eager:.5f} "
              f"ms eager, host {host:.3f} us", flush=True)
        out[label] = (t, eager, host)
    return out


def check_col_softmax(dev):
    """Phase 7.1e: ``col_softmax`` and its adjoint ``col_softmax_bwd`` at
    every ``COL_SOFTMAX_SHAPES`` entry (each form of their plan) within
    1e-6 of their plain versions' scale and bit-equal run to run and
    graphed; then ``col_softmax_times`` and ``col_softmax_bwd_times``."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import col_softmax_plan

    g = torch.Generator(device="cpu").manual_seed(9)
    forms = set()
    for nf, R, C in COL_SOFTMAX_SHAPES:
        y = (torch.randn(nf, R, C, generator=g) * 4.0).to(dev)
        g_q = torch.randn(nf, R, C, generator=g).to(dev)
        q = P.col_softmax(y)
        plan = col_softmax_plan(nf, R)
        forms.add(plan.form)
        for name, kern, plain in (
                ("col_softmax", lambda: K.col_softmax(y),
                 lambda: P.col_softmax(y)),
                ("col_softmax_bwd", lambda: K.col_softmax_bwd(g_q, q),
                 lambda: P.col_softmax_bwd(g_q, q))):
            got, again, want = kern(), kern(), plain()
            graphed = _graph_outputs(kern)
            torch.cuda.synchronize()
            err = max_err(got, want)
            label = (f"{name} ({nf}, {R}, {C}), form {plan.form}, "
                     f"{plan.warps} warps")
            if not err <= 1e-6 * scale_of(want):
                fail(f"{label}: max|err| {err:.3e} above 1e-6")
            if not (torch.equal(_bits(got), _bits(again))
                    and torch.equal(_bits(got), _bits(graphed))):
                fail(f"{label}: two launches or the graphed launch differ")
            print(f"    {label}: max|err| {err:.2e}, bit-equal run to run "
                  "and graphed", flush=True)
    if forms != {0, 1}:
        fail(f"col_softmax: forms {sorted(forms)} ran, not both")
    col_softmax_times(dev)
    col_softmax_bwd_times(dev)


def col_softmax_times(dev):
    """``col_softmax`` at the step's (3, 16, 268), the validation pass's
    (56, 16, 268) and a `--dim 64` run's (3, 64, 268): device ms per
    launch in a CUDA graph in turns with ``torch.softmax`` over the same
    axis and the plain version, beside its bound; eager ms and host us
    per call, and where the wrapper's host time goes at the step's shape
    (``_host_profile``). It calls only ``col_softmax``, so it also times an
    older tree. Returns {shape: (ms, eager ms, host us, softmax ms)}."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device="cpu").manual_seed(10)
    out = {}
    for nf, R, C in COL_SOFTMAX_SHAPES[:3]:
        y = torch.randn(nf, R, C, generator=g).to(dev)
        k_ms, lib_ms, p_ms = graph_ms([lambda: K.col_softmax(y),
                                       lambda: torch.softmax(y, 1),
                                       lambda: P.col_softmax(y)])
        eager, host = _eager_and_host(lambda: K.col_softmax(y))
        b_ms, b_by = bound(4.0 * nf * R * C, 8.0 * nf * R * C)
        print(f"    col_softmax ({nf}, {R}, {C}): {k_ms:.5f} ms per launch "
              f"(torch.softmax {lib_ms:.5f}, plain {p_ms:.5f}, bound "
              f"{b_ms:.5f} {b_by}); {eager:.5f} ms eager, host {host:.3f} "
              "us", flush=True)
        out[(nf, R, C)] = (k_ms, eager, host, lib_ms)
        if (nf, R) == (F, 16):
            _host_profile(lambda: K.col_softmax(y), 2000,
                          f"col_softmax ({nf}, {R}, {C})")
    return out


def col_softmax_bwd_times(dev):
    """``col_softmax_bwd`` at ``col_softmax_times``' three shapes: device
    ms per launch in a CUDA graph in turns with
    ``torch._softmax_backward_data`` over the same axis and the plain
    version, beside its bound (q and g_q read, g_y written); eager ms and
    host us per call. It calls only ``col_softmax`` and
    ``col_softmax_bwd``, so it also times an older tree. Returns {shape:
    (ms, eager ms, host us, library ms, plain ms)}."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device="cpu").manual_seed(12)
    out = {}
    for nf, R, C in COL_SOFTMAX_SHAPES[:3]:
        q = K.col_softmax(torch.randn(nf, R, C, generator=g).to(dev))
        g_q = torch.randn(nf, R, C, generator=g).to(dev)
        kern = lambda: K.col_softmax_bwd(g_q, q)
        k_ms, lib_ms, p_ms = graph_ms(
            [kern, lambda: torch._softmax_backward_data(g_q, q, 1,
                                                        torch.float32),
             lambda: P.col_softmax_bwd(g_q, q)])
        eager, host = _eager_and_host(kern)
        b_ms, b_by = bound(4.0 * nf * R * C, 12.0 * nf * R * C)
        print(f"    col_softmax_bwd ({nf}, {R}, {C}): {k_ms:.5f} ms per "
              f"launch (torch._softmax_backward_data {lib_ms:.5f}, plain "
              f"{p_ms:.5f}, bound {b_ms:.5f} {b_by}); {eager:.5f} ms eager, "
              f"host {host:.3f} us", flush=True)
        out[(nf, R, C)] = (k_ms, eager, host, lib_ms, p_ms)
    return out


# the three-stage gat_attention_bwd that the cluster kernel replaced, per
# layer at F = 3, drop_p = 0.01: device ms in a CUDA graph (PERF.md
# Findings; NVIDIA H100 80GB HBM3, 700.00 W)
GAT_BWD_THREE_STAGE_MS = {(160, 4, 8): 0.0960, (80, 4, 16): 0.0422,
                          (40, 4, 32): 0.0252, (20, 2, 64): 0.0202,
                          (40, 4, 16): 0.0213, (80, 4, 8): 0.0358,
                          (160, 4, 4): 0.0770}
# beyond the shipped widths: (n, heads, d_head), F = 1
GAT_BWD_WIDE = ((1000, 2, 128), (4096, 1, 128))
OFFDIAG_NS = (268, 160, 80, 40, 37, 1000, 3500)
OFFDIAG_FS = (1, 3, 56)


def _graph_outputs(fn):
    """``fn()``'s outputs from one replay of a CUDA graph that captured
    one call (after a warm-up call on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_gat_reductions(dev):
    """Phase 7.1b: the two cluster kernels of gat.cu beyond their record.

    ``gat_attention_bwd`` at every GAT layer shape x drop_p (0, 0.01, 0.3)
    at F = 1 and 3, and at n 1000 / 4096 x d 128 (F = 1): g_h and the
    three parameter gradients within 1e-5 of their scale, two launches
    bit-equal, one launch captured in a CUDA graph bit-equal to the eager
    one; per layer its device ms (F = 3, drop_p = 0.01) beside the
    three-stage kernel's and the plain version's.

    ``offdiag_mse`` (with and without the cotangent) and ``offdiag_mae`` at
    every ``OFFDIAG_NS`` x ``OFFDIAG_FS``: values and cotangent within 1e-6
    of the plain version, two launches bit-equal, the value without the
    cotangent bit-equal to the value with it, one launch of each captured
    in a CUDA graph; at 268^2 (F = 3, the step's) and F = 56 (validation)
    their device ms beside the plain version's."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import (gat_attention_bwd_plan,
                                            offdiag_plan)
    from fcsr_tpu_torch.utils.timing import graph_ms

    smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    worst = 0.0
    shapes = [(s, nf, p) for s in GAT_LAYER_SHAPES for nf in (1, 3)
              for p in (0.0, 0.01, 0.3)]
    shapes += [(s, 1, p) for s in GAT_BWD_WIDE for p in (0.0, 0.3)]
    for li, ((n, H, d), nf, p) in enumerate(shapes):
        HD = H * d
        h, asrc, adst = rnd(nf, n, HD), rnd(nf, H, d), rnd(nf, H, d)
        if n >= 1000:
            # on a dyadic grid, so s and t are exact in any summation
            # order: leaky's slope jumps at z = 0, and over millions of
            # pairs a last-bit difference in z (the plain version sums in
            # torch's order, the kernel in feature order) flips a few
            h, asrc, adst = (torch.round(4 * x) / 16 for x in (h, asrc, adst))
        bias = rnd(nf, 1, HD, scale=0.1)
        m = torch.rand(nf, n, n, generator=g, device=dev)
        m = torch.triu(m * (m < 0.3), 1)
        a = m + m.transpose(1, 2)
        seeds = _gat_seeds(dev, nf)
        y, alpha = P.gat_attention(h, asrc, adst, bias, a, seeds, li, p)
        gy = rnd(nf, n, HD)

        def bwd(ops):
            outs = (torch.empty(nf, H, d, device=dev),
                    torch.empty(nf, H, d, device=dev),
                    torch.empty(nf, 1, HD, device=dev))
            return (ops.gat_attention_bwd(gy, y, alpha, h, asrc, adst, seeds,
                                          li, p, *outs),) + outs
        got = [bwd(K), bwd(K)]
        want = bwd(P)
        graphed = _graph_outputs(lambda: bwd(K))
        torch.cuda.synchronize()
        errs = [max_err(x, w) / scale_of(w) for x, w in zip(got[0], want)]
        err = max(errs)
        worst = max(worst, err)
        plan = gat_attention_bwd_plan(n, H, d, nf, smem)
        label = (f"gat_attention_bwd n={n} heads={H} d={d} F={nf} p={p} "
                 f"({plan.cluster} x {plan.rows} rows, "
                 f"{'staged' if plan.staged else 'chunks of %d' % plan.chunk})")
        if not err <= 1e-5:
            fail(f"{label}: err / scale (g_h, g_att_src, g_att_dst, g_bias) "
                 f"{', '.join('%.2e' % e for e in errs)} above 1e-5")
        if not (_equal(got[0], got[1]) and _equal(got[0], graphed)):
            fail(f"{label}: two launches or the graphed launch differ")
        line = f"    {label}: err / scale {err:.2e}, bit-equal, graphed"
        if (n, H, d) in GAT_BWD_THREE_STAGE_MS and nf == F and p == 0.01:
            k_ms, p_ms = graph_ms([lambda: bwd(K), lambda: bwd(P)])
            line += (f"; kernel {k_ms:.4f} ms (three stages: "
                     f"{GAT_BWD_THREE_STAGE_MS[(n, H, d)]:.4f}), plain "
                     f"{p_ms:.4f} ms")
        elif n >= 1000 and p > 0:
            k_ms, = graph_ms([lambda: bwd(K)], reps=3)
            line += f"; kernel {k_ms:.4f} ms"
        print(line, flush=True)
        del y, alpha, got, want, graphed

    for n in OFFDIAG_NS:
        for nf in OFFDIAG_FS:
            G = rnd(nf, n, n)
            T = torch.rand(nf, n, n, generator=g, device=dev)
            vk = [torch.zeros(nf, 4, device=dev) for _ in range(3)]
            vp = torch.zeros(nf, 4, device=dev)
            gk = [K.offdiag_mse(G, T, v, 0) for v in vk[:2]]
            K.offdiag_mse(G, T, vk[2], 0, grad=False)
            for v in vk:
                K.offdiag_mae(G, T, v, 1)
            gp = P.offdiag_mse(G, T, vp, 0)
            P.offdiag_mae(G, T, vp, 1)

            def both():
                v = torch.zeros(nf, 4, device=dev)
                return K.offdiag_mse(G, T, v, 0), K.offdiag_mae(G, T, v, 1), v
            gr = _graph_outputs(both)
            torch.cuda.synchronize()
            err = max(max_err(gk[0], gp), max_err(vk[0], vp))
            worst = max(worst, err)
            plan = offdiag_plan(nf, n, smem)
            label = (f"offdiag_mse / mae n={n} F={nf} ({plan.cluster} blocks "
                     f"x {plan.per_block} tiles, {plan.stages} at a time)")
            if not err <= 1e-6:
                fail(f"{label}: max|err| {err:.2e} above 1e-6")
            if not (torch.equal(gk[0], gk[1]) and torch.equal(vk[0], vk[1])
                    and torch.equal(vk[0], vk[2]) and torch.equal(gk[0], gr[0])
                    and torch.equal(vk[0][:, :2], gr[2][:, :2])):
                fail(f"{label}: launches, the grad-less value or the graphed "
                     "launch differ")
            line = f"    {label}: max|err| {err:.2e}, bit-equal, graphed"
            if n == HR and nf in (F, 56):
                ms = graph_ms([lambda: K.offdiag_mse(G, T, vk[0], 0),
                               lambda: P.offdiag_mse(G, T, vp, 0),
                               lambda: K.offdiag_mae(G, T, vk[0], 1),
                               lambda: P.offdiag_mae(G, T, vp, 1),
                               lambda: K.offdiag_mse(G, T, vk[0], 0, False)])
                line += (f"; offdiag_mse {ms[0]:.4f} ms (plain {ms[1]:.4f}, "
                         f"no cotangent {ms[4]:.4f}), offdiag_mae "
                         f"{ms[2]:.4f} ms (plain {ms[3]:.4f})")
            print(line, flush=True)
            del G, T, gk, gp, gr
    print(f"  gat.cu cluster reductions ok: {len(shapes)} backward cases, "
          f"{len(OFFDIAG_NS) * len(OFFDIAG_FS)} loss cases; worst err "
          f"{worst:.2e}", flush=True)


# gat_attention and gat_pool_adj before their redesign (one block per
# attention row, one block per fold), device ms per launch in a CUDA graph
# from ``gat_forward_times`` run against the tree before the redesign, the
# mean of two runs (PERF.md Findings; NVIDIA H100 80GB HBM3, 700.00 W)
GAT_FWD_BEFORE_MS = {
    (160, 4, 8, 3): 0.0217, (80, 4, 16, 3): 0.0105, (40, 4, 32, 3): 0.0073,
    (20, 2, 64, 3): 0.0083, (40, 4, 16, 3): 0.0055, (80, 4, 8, 3): 0.0078,
    (160, 4, 4, 3): 0.0122,
    (160, 4, 8, 56): 0.2938, (80, 4, 16, 56): 0.1258, (40, 4, 32, 56): 0.0633,
    (20, 2, 64, 56): 0.0182, (40, 4, 16, 56): 0.0364, (80, 4, 8, 56): 0.0777,
    (160, 4, 4, 56): 0.1544}
GAT_POOL_BEFORE_MS = {(160, 80, 3): 0.0094, (80, 40, 3): 0.0042,
                      (40, 20, 3): 0.0026, (160, 80, 56): 0.0096,
                      (80, 40, 56): 0.0043, (40, 20, 56): 0.0027}
# beyond the shipped widths: (n, heads, d_head), F = 1
GAT_FWD_WIDE = ((1000, 2, 128), (4096, 1, 128))
GAT_STEP_POOLS = tuple((n, n // 2, nf) for n in (160, 80, 40)
                       for nf in (F, 56))
GAT_POOL_CASES = GAT_STEP_POOLS + ((300, 129, 1), (2000, 1000, F))


def _graph_adj(g, nf, n, dev):
    m = torch.rand(nf, n, n, generator=g, device=dev)
    m = torch.triu(m * (m < 0.3), 1)
    return m + m.transpose(1, 2)


def gat_forward_times(dev):
    """Device ms per launch in a CUDA graph, beside the plain version and
    the bound: ``gat_attention`` at each GAT layer shape at the step's
    F = 3 (drop_p 0.01, alpha kept) and the validation's F = 56 (no
    dropout, no alpha), ``gat_pool_adj`` at the step's three pools at
    F = 3 and 56. It calls only the two kernel ops, whose contract
    predates their redesign, so it also times an older tree of the port:
    load this file by path with that tree's root as the working
    directory."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    for nf, p in ((F, 0.01), (56, 0.0)):
        kept = nf == F
        calls = []
        for n, H, d in GAT_LAYER_SHAPES:
            args = (rnd(nf, n, H * d), rnd(nf, H, d) / d ** 0.5,
                    rnd(nf, H, d) / d ** 0.5, 0.1 * rnd(nf, 1, H * d),
                    _graph_adj(g, nf, n, dev), _gat_seeds(dev, nf), 0, p)
            calls.append(tuple(
                lambda ops=ops, args=args: ops.gat_attention(
                    *args, need_alpha=kept) for ops in (K, P)))
        ms = graph_ms([c[0] for c in calls] + [c[1] for c in calls])
        L = len(calls)
        print(f"  gat_attention per layer at F = {nf} ("
              + ("drop_p 0.01, alpha kept" if kept else
                 "validation: no dropout, no alpha") + "), device ms in a "
              "CUDA graph:", flush=True)
        for (n, H, d), k_ms, p_ms in zip(GAT_LAYER_SHAPES, ms[:L], ms[L:]):
            before = GAT_FWD_BEFORE_MS.get((n, H, d, nf))
            b_ms, b_by = bound(gat_attention_ops(nf, n, H, d),
                               4.0 * nf * (2 * n * H * d + 3 * H * d + n * n
                                           + (H * n * n if kept else 0)))
            print(f"    n={n:3d} heads={H} d={d:2d} F={nf:2d}: "
                  f"kernel {k_ms:.4f} ms (PR 8's kernel: {before:.4f}), "
                  f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})",
                  flush=True)
        before = sum(GAT_FWD_BEFORE_MS[(n, H, d, nf)]
                     for n, H, d in GAT_LAYER_SHAPES)
        print(f"    seven layers at F = {nf}: {sum(ms[:L]):.4f} ms (PR 8's "
              f"kernel: {before:.4f})", flush=True)
    calls = []
    for n, k, nf in GAT_STEP_POOLS:
        a = torch.rand(nf, n, n, generator=g, device=dev)
        idx = torch.stack([torch.randperm(n, generator=g, device=dev)[:k]
                           for _ in range(nf)]).to(torch.int32)
        calls.append(tuple(lambda ops=ops, a=a, idx=idx: ops.gat_pool_adj(
            a, idx) for ops in (K, P)))
    ms = graph_ms([c[0] for c in calls] + [c[1] for c in calls])
    L = len(calls)
    for (n, k, nf), k_ms, p_ms in zip(GAT_STEP_POOLS, ms[:L], ms[L:]):
        b_ms, b_by = bound(3.0 * nf * k * k, 4.0 * nf * (2 * k * k + k))
        print(f"    gat_pool_adj {n} -> {k} F={nf}: kernel {k_ms:.4f} ms "
              f"(PR 8's kernel: {GAT_POOL_BEFORE_MS[(n, k, nf)]:.4f}), plain "
              f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)


def check_gat_forward(dev):
    """Phase 7.1c: the two kernels of the GAT forward beyond their record.

    ``gat_attention`` at every GAT layer shape x drop_p (0, 0.01, 0.3) x
    both softmax shifts x F (1, 3, 56), and at n 1000 / 4096 x d 128
    (F = 1, both shifts, drop_p 0 / 0.3): y within 1e-5 of its scale and
    alpha within 1e-6 of the plain version, two launches bit-equal, y
    without alpha bit-equal to y with it, one launch per shape and F
    captured in a CUDA graph; ``gat_attention_bwd`` still matches on the
    kernel's alpha. ``gat_pool_adj`` at the step's three pools x F (3, 56)
    and at k 129 and 1000: within 1e-6 of its scale, bit-equal, graphed.
    ``philox_keep_mask`` at the step's three pool masks, bit-equal. Then
    ``gat_forward_times``."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS as K, PLAIN_OPS as P
    from fcsr_tpu_torch.kernels.ops import (gat_attention_plan,
                                            gat_pool_adj_plan)
    from fcsr_tpu_torch.utils.timing import graph_ms

    smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    g = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    worst_y = worst_a = 0.0
    cases = [(s, nf, p, shift) for s in GAT_LAYER_SHAPES for nf in (1, F, 56)
             for p in (0.0, 0.01, 0.3) for shift in (False, True)]
    cases += [(s, 1, p, shift) for s in GAT_FWD_WIDE for p in (0.0, 0.3)
              for shift in (False, True)]
    for ci, ((n, H, d), nf, p, shift) in enumerate(cases):
        HD = H * d
        # attention vectors at the model's initial scale (glorot over d):
        # O(1) logits, as in the step
        h, asrc, adst = rnd(nf, n, HD), rnd(nf, H, d), rnd(nf, H, d)
        asrc, adst = asrc / d ** 0.5, adst / d ** 0.5
        if n >= 1000:
            # on a dyadic grid, so s and t are exact in any summation
            # order and alpha's error is the denominators' alone
            h, asrc, adst = (torch.round(4 * x) / 16 for x in (h, asrc, adst))
        bias = rnd(nf, 1, HD, scale=0.1)
        a = _graph_adj(g, nf, n, dev)
        seeds = _gat_seeds(dev, nf)
        args = (h, asrc, adst, bias, a, seeds, ci % 7, p, shift)
        call = lambda ops, alpha=True, args=args: ops.gat_attention(
            *args, need_alpha=alpha)
        got = [call(K), call(K)]
        bare = call(K, False)
        want = call(P)
        graphed = None
        if p == 0.3 and not shift:
            graphed = _graph_outputs(lambda: call(K))
        torch.cuda.synchronize()
        plan = gat_attention_plan(n, H, d, nf, shift, smem)
        how = "staged" if plan.staged else f"chunks of {plan.chunk}"
        label = (f"gat_attention n={n} heads={H} d={d} F={nf} p={p} "
                 f"global_shift={shift} ({plan.rows} rows x {plan.bands} "
                 f"bands, {how}, group {plan.group})")
        err_y = max_err(got[0][0], want[0]) / scale_of(want[0])
        err_a = max_err(got[0][1], want[1])
        worst_y, worst_a = max(worst_y, err_y), max(worst_a, err_a)
        if not (err_y <= 1e-5 and err_a <= 1e-6):
            fail(f"{label}: y err / scale {err_y:.2e} (limit 1e-5), alpha "
                 f"max|err| {err_a:.2e} (limit 1e-6)")
        if not (_equal(got[0], got[1]) and torch.equal(got[0][0], bare[0])
                and bare[1] is None
                and (graphed is None or _equal(got[0], graphed))):
            fail(f"{label}: two launches, y without alpha or the graphed "
                 "launch differ")
        if nf == F and not shift:
            # the adjoint on the kernel's y and alpha against the plain
            # adjoint on the same (each side's own y could put an entry
            # near 0 on two sides of relu's kink)
            gy = rnd(nf, n, HD)
            outs = []
            y_, al_ = got[0]
            for ops in (K, P):
                gp = (torch.empty(nf, H, d, device=dev),
                      torch.empty(nf, H, d, device=dev),
                      torch.empty(nf, 1, HD, device=dev))
                outs.append((ops.gat_attention_bwd(gy, y_, al_, h, asrc,
                                                   adst, seeds, ci % 7, p,
                                                   *gp),) + gp)
            err_b = max(max_err(x, w) / scale_of(w) for x, w in zip(*outs))
            if not err_b <= 1e-5:
                fail(f"{label}: gat_attention_bwd on the kernel's alpha "
                     f"err / scale {err_b:.2e} above 1e-5")
        if n >= 1000 and p > 0 and not shift:
            k_ms, = graph_ms([lambda: call(K)], reps=3)
            label += f"; kernel {k_ms:.4f} ms"
        print(f"    {label}: y err / scale {err_y:.2e}, alpha err "
              f"{err_a:.2e}, bit-equal" + (", graphed" if graphed else ""),
              flush=True)
        del got, bare, want, graphed

    worst_p = 0.0
    for n, k, nf in GAT_POOL_CASES:
        a = torch.rand(nf, n, n, generator=g, device=dev)
        idx = torch.stack([torch.randperm(n, generator=g, device=dev)[:k]
                           for _ in range(nf)]).to(torch.int32)
        got = [K.gat_pool_adj(a, idx), K.gat_pool_adj(a, idx)]
        want = P.gat_pool_adj(a, idx)
        graphed = _graph_outputs(lambda: K.gat_pool_adj(a, idx))
        torch.cuda.synchronize()
        plan = gat_pool_adj_plan(nf, n, k, smem)
        err = max_err(got[0], want) / scale_of(want)
        worst_p = max(worst_p, err)
        label = (f"gat_pool_adj {n} -> {k} F={nf} ({plan.bands} bands of "
                 f"{plan.rows} rows)")
        if not err <= 1e-6:
            fail(f"{label}: err / scale {err:.2e} above 1e-6")
        if not (torch.equal(got[0], got[1]) and torch.equal(got[0], graphed)):
            fail(f"{label}: two launches or the graphed launch differ")
        if (n, k, nf) not in GAT_STEP_POOLS:
            k_ms, p_ms = graph_ms([lambda: K.gat_pool_adj(a, idx),
                                   lambda: P.gat_pool_adj(a, idx)], reps=3)
            b_ms, b_by = bound(3.0 * nf * k * k, 4.0 * nf * (2 * k * k + k))
            label += (f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                      f"{b_ms:.5f} ms ({b_by})")
        print(f"    {label}: err / scale {err:.2e}, bit-equal, graphed",
              flush=True)
    print(f"  GAT forward kernels ok: {len(cases)} attention cases (worst y "
          f"err / scale {worst_y:.2e}, alpha err {worst_a:.2e}), "
          f"{len(GAT_POOL_CASES)} pool cases (worst {worst_p:.2e})",
          flush=True)
    gat_forward_times(dev)


def _gat_step_inputs(dev, data):
    """Full-width step inputs for F = 3 folds: three fresh models, small
    random moments, the first three teacher subjects, one masked fold."""
    from fcsr_tpu_torch.iox.weights import gat_state_to_flat
    from fcsr_tpu_torch.models.gat_unet import (GATGraphUnet,
                                                symmetric_normalize)
    from fcsr_tpu_torch.train.gat_loop import precompute_gat_features

    flat = np.stack([gat_state_to_flat({k: v.numpy() for k, v in GATGraphUnet(
        device="cpu", seed=j).state_dict().items()}) for j in range(F)])
    rng = np.random.default_rng(0)
    # zero-initialised biases would leave relu kinks exactly at 0
    p = torch.from_numpy(flat + rng.normal(0, 0.02, flat.shape).astype(
        np.float32)).to(dev)
    m = torch.from_numpy(
        rng.normal(0, 1e-4, flat.shape).astype(np.float32)).to(dev)
    v = torch.from_numpy(
        np.abs(rng.normal(0, 1e-6, flat.shape)).astype(np.float32)).to(dev)
    lr = np.ascontiguousarray(data["lr_train"][:F], dtype=np.float32)
    lr_d = torch.from_numpy(lr).to(dev)
    a0 = symmetric_normalize(lr_d + torch.eye(LR, device=dev))
    x0 = torch.from_numpy(precompute_gat_features(lr, GAT_DIM)).to(dev)
    hr = torch.from_numpy(np.ascontiguousarray(
        data["hr_train"][:F], dtype=np.float32)).to(dev)
    scal = torch.tensor([[1.0, 1e-3, 1 - 0.9 ** 3, 1 - 0.999 ** 3],
                         [1.0, 1e-4, 1 - 0.9 ** 7, 1 - 0.999 ** 7],
                         [0.0, 1e-3, 1 - 0.9 ** 2, 1 - 0.999 ** 2]],
                        device=dev)
    return p, m, v, a0, x0, hr, scal, _gat_seeds(dev, F)


def gat_step_snapshot(dev, path):
    """One full-width fused GAT step at drop_p 0.01 on ``_gat_step_inputs``
    (the teacher set's first three subjects, seeded models): loss, p', m'
    and v' written to ``path`` (.npz). It calls only the step's entry
    point, so it also runs on an older tree of the port (load this file by
    path with that tree's root as the working directory);
    ``compare_gat_snapshots`` then holds two trees' steps to each other."""
    from fcsr_tpu_torch.data import load_or_synthesize
    from fcsr_tpu_torch.models.fused_gat import gat_train_step_fused

    data = load_or_synthesize(None, n_train=N_TRAIN, n_test=N_TEST, seed=42)
    out = gat_train_step_fused(*_gat_step_inputs(dev, data), device=dev,
                               drop_p=0.01, **GAT_KW)
    np.savez(path, **{k: t.cpu().numpy()
                      for k, t in zip(("loss", "p", "m", "v"), out)})


def compare_gat_snapshots(a, b, limit=1e-5):
    """Each array of two ``gat_step_snapshot`` files: max |a - b| over the
    largest |b| (relative to 1e-30); fails above ``limit``."""
    a, b = np.load(a), np.load(b)
    rel = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max()
                    / max(float(np.abs(b[k]).max()), 1e-30)) for k in b}
    print(f"  GAT step at drop_p 0.01, one tree against the other: max "
          f"|d| / max |.| {rel} (limit {limit})", flush=True)
    if not max(rel.values()) <= limit:
        fail("the two trees' GAT steps differ")
    return rel


def _host_profile(fn, reps, what="the eager step"):
    """Where the host's time per eager call of ``what`` goes: cProfile over
    ``reps`` calls, the six functions with the most time of their own (and
    ``torch.cuda.current_stream``, which every launch calls)."""
    import cProfile
    import pstats

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    total = stats.total_tt
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:6]
    # the launch wrapper asks PyTorch for the current stream at every call
    rows += [kv for kv in stats.stats.items()
             if kv[0][2] == "current_stream" and kv not in rows]
    print(f"  host profile of {what}: {1e6 * wall:.2f} us per call by "
          f"the wall clock ({reps} calls), {1e6 * total / reps:.2f} us under "
          f"cProfile; own time and cumulative time per call:", flush=True)
    for (path, line, name), (_, ncalls, tt, ct, _) in rows:
        print(f"    {os.path.basename(path)}:{line}({name}): "
              f"{1e6 * tt / reps:.2f} us own, {1e6 * ct / reps:.2f} us "
              f"cumulative, {ncalls // reps} calls", flush=True)


def check_gat_step(dev, data):
    """Phase 7.2 and 7.3: one full-width fused step on the kernels against
    the plain step and against autograd over the plain loss, at drop_p 0,
    0.01 and 0.3; then the fused validation forward."""
    from fcsr_tpu_torch.kernels import (KERNEL_OPS, launch_counts,
                                        reset_launch_counts)
    from fcsr_tpu_torch.models import fused_gat as fg

    p, m, v, a0, x0, hr, scal, seeds = _gat_step_inputs(dev, data)
    layout = fg.GATLayout(GAT_DIM, GAT_KS, GAT_HEADS, LR, HR)
    for drop_p in (0.0, 0.01, 0.3):
        kw = dict(drop_p=drop_p, **GAT_KW)
        reset_launch_counts()
        got = fg.gat_train_step_fused(p, m, v, a0, x0, hr, scal, seeds,
                                      device=dev, **kw)
        counts = _nonzero(launch_counts())
        want = fg.gat_train_step_plain(p, m, v, a0, x0, hr, scal, seeds,
                                       **kw)
        torch.cuda.synchronize()
        errs = []
        for name, a, b, tol in zip(("loss", "p'", "m'", "v'"), got, want,
                                   (1e-5, 1e-6, 1e-5, 1e-5)):
            err = max_err(a, b)
            errs.append(f"{name} {err:.2e}")
            if not err <= tol * scale_of(b):
                fail(f"GAT step drop_p={drop_p}: {name} disagrees with the "
                     f"plain step (err {err:.3e})")
        for a, b in ((got[1], p), (got[2], m), (got[3], v)):
            if not torch.equal(a[2], b[2]):
                fail("GAT step: the masked fold's state changed")
        # the hand-written adjoints against autograd over the plain loss,
        # fed the masks the kernels drew
        _, g = fg.gat_value_and_grads(KERNEL_OPS, p, a0, x0, hr, seeds, **kw)
        masks = None if drop_p == 0 else fg.draw_masks(
            seeds, dim=GAT_DIM, ks=GAT_KS, n_nodes=LR, heads=GAT_HEADS,
            drop_p=drop_p)
        pp = p.clone().requires_grad_()
        loss = fg.gat_step_loss(list(layout.views(pp).values()), a0, x0, hr,
                                drop_masks=masks, **kw)
        loss.sum().backward()
        torch.cuda.synchronize()
        largest = float(pp.grad.abs().max())
        g_err = max(max_err(a, b) for a, b in zip(
            layout.views(g).values(), layout.views(pp.grad).values()))
        v_err = max_err(got[0], loss.detach())
        print(f"  GAT step drop_p={drop_p}: kernels vs plain step "
              f"{', '.join(errs)}; vs autograd: loss {v_err:.2e}, worst of 36 "
              f"gradients {g_err:.2e} = {g_err / largest:.2e} of the largest "
              f"entry (limit 1e-4); {sum(counts.values())} launches {counts}",
              flush=True)
        if not (v_err <= 1e-5 and g_err <= 1e-4 * largest):
            fail(f"GAT step drop_p={drop_p} disagrees with autograd over "
                 "the plain loss")
    print(f"  GAT step loss {got[0].tolist()}")

    kw = dict(drop_p=0.01, **GAT_KW)
    run_k = lambda: fg.gat_train_step_fused(p, m, v, a0, x0, hr, scal, seeds,
                                            device=dev, **kw)
    run_p = lambda: fg.gat_train_step_plain(p, m, v, a0, x0, hr, scal, seeds,
                                            **kw)

    def run_autograd():
        pp = p.clone().requires_grad_()
        fg.gat_step_loss(list(layout.views(pp).values()), a0, x0, hr,
                         **GAT_KW).sum().backward()
    k_dev, p_dev = device_ms(run_k, reps=5), device_ms(run_p, reps=5)
    k_eager = cuda_ms(run_k, reps=5)
    print(f"  full-width GAT step (F={F}, drop_p=0.01): kernels "
          f"{k_eager:.3f} ms eager, {k_dev:.3f} ms device "
          f"(CUDA graph); plain step {cuda_ms(run_p, reps=5):.3f} ms eager, "
          f"{p_dev:.3f} ms device; autograd over the plain loss (no dropout, "
          f"no AdamW) {device_ms(run_autograd, reps=5):.3f} ms device")
    flops, nbytes, launches = count_gat_step((p, m, v, a0, x0, hr, scal,
                                              seeds), kw)
    b_ms, b_by = bound(flops, nbytes)
    print(f"  GAT step work: {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.2f} MB "
          f"moved by its {sum(launches.values())} launches {launches}; bound "
          f"{b_ms:.4f} ms ({b_by})")

    # the adjoint is one launch per layer; each pool one rank_select launch
    # that also gathers; the backward's three gathers; the unpool forward
    # and backward, the logits' adjoint apart from it
    profile_launches(run_k, k_eager, os.path.join(
        OUT_DIR, "profile_gat_step.txt"), {
        "gat_attention_bwd": 7, "gat_attention_kernel": 7, "gat_pool_adj": 3,
        "rank_select_kernel": 3, "gather_rows_kernel": 3,
        "scatter_rows_kernel": 6, "pool_logits_bwd_kernel": 3,
        "pool_bwd_pair_kernel": 0, "philox_drop_logits_kernel": 3,
        "philox_drop_outer_kernel": 3, "philox_keep_mask_kernel": 0},
        "GAT step")
    if sum(launches.values()) != GAT_STEP_LAUNCHES or (
            launches.get("scatter_rows"), launches.get("pool_logits_bwd"),
            launches.get("pool_bwd_pair", 0),
            launches.get("philox_drop_logits"),
            launches.get("philox_drop_outer"),
            launches.get("philox_keep_mask", 0)) != (6, 3, 0, 3, 3, 0):
        fail(f"the GAT step launches {launches}: not {GAT_STEP_LAUNCHES} "
             "with 6 scatter_rows, 3 pool_logits_bwd, 3 philox_drop_logits, "
             "3 philox_drop_outer and no philox_keep_mask")
    _host_profile(run_k, 100)

    # validation: one model read by a fold's 56 subjects
    from fcsr_tpu_torch.models.gat_unet import symmetric_normalize
    from fcsr_tpu_torch.train.gat_loop import precompute_gat_features
    B = 56
    lr = np.ascontiguousarray(data["lr_train"][:B], dtype=np.float32)
    a0v = symmetric_normalize(torch.from_numpy(lr).to(dev)
                              + torch.eye(LR, device=dev))
    x0v = torch.from_numpy(precompute_gat_features(lr, GAT_DIM)).to(dev)
    hrv = torch.from_numpy(np.ascontiguousarray(
        data["hr_train"][:B], dtype=np.float32)).to(dev)
    reset_launch_counts()
    got = fg.gat_val_fused(p[:1], a0v, x0v, hrv, device=dev, **GAT_KW)
    counts = _nonzero(launch_counts())
    want = fg.gat_val_plain(p[:1], a0v, x0v, hrv, **GAT_KW)
    torch.cuda.synchronize()
    errs = [max_err(a, b) for a, b in zip(got, want)]
    v_k = device_ms(lambda: fg.gat_val_fused(p[:1], a0v, x0v, hrv,
                                             device=dev, **GAT_KW), reps=3)
    v_p = device_ms(lambda: fg.gat_val_plain(p[:1], a0v, x0v, hrv, **GAT_KW),
                    reps=3)
    print(f"  gat_val_fused ({B} subjects, one model): loss err "
          f"{errs[0]:.2e}, MAE err {errs[1]:.2e} (limit 1e-5); "
          f"{sum(counts.values())} launches {counts}; kernels {v_k:.3f} ms "
          f"device, plain {v_p:.3f} ms device per fold")
    if not max(errs) <= 1e-5 or not bool(torch.isfinite(got[0]).all()):
        fail("gat_val_fused disagrees with its plain version")
    if sum(counts.values()) != GAT_VAL_LAUNCHES or counts.get("gather_rows"):
        fail(f"gat_val_fused launches {counts}: not {GAT_VAL_LAUNCHES}, "
             "with no gather_rows")
    run_v = lambda: fg.gat_val_fused(p[:1], a0v, x0v, hrv, device=dev,
                                     **GAT_KW)
    profile_launches(run_v, cuda_ms(run_v, reps=3),
                     os.path.join(OUT_DIR, "profile_gat_val.txt"), {
                         "gat_attention_kernel": 7, "gat_pool_adj": 3,
                         "rank_select_kernel": 3, "gather_rows_kernel": 0,
                         "scatter_rows_kernel": 3}, "GAT validation")


def run_gat_trainer(dev, data):
    """Phase 7.4: the GAT main path. ``train_gat_folds_parallel`` with the
    fused step on the teacher set, 3 folds, 2 epochs at the shipped
    drop_p = 0.01 (launch counts read from this run); then one epoch fused
    against one epoch unfused at drop_p = 0 from the same weights. Returns
    the launch counts of the main run."""
    from fcsr_tpu_torch import kfold_indices
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.pipelines import _fold_maes_on_device
    from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig, _FoldTrainer,
                                               train_gat_folds_parallel)

    lr_all = np.ascontiguousarray(data["lr_train"], dtype=np.float32)
    hr_all = np.ascontiguousarray(data["hr_train"], dtype=np.float32)
    folds = kfold_indices(len(lr_all), 3, seed=42)
    cfg = GATTrainConfig(epochs=2, fused_step=True)
    model, init_vars, _ = train_gat_folds_parallel(
        GATTrainConfig(epochs=0, fused_step=True), lr_all, hr_all, folds,
        seed=42, device=dev)
    untrained = _fold_maes_on_device(model, cfg, init_vars, lr_all, hr_all,
                                     folds, dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    model, best, hists = train_gat_folds_parallel(cfg, lr_all, hr_all, folds,
                                                  seed=42, device=dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    counts = _nonzero(launch_counts())
    trained = _fold_maes_on_device(model, cfg, best, lr_all, hr_all, folds,
                                   dev)
    steps = max(len(tr) for tr, _ in folds)
    print(f"  train_gat_folds_parallel(fused_step) 3 folds x 2 epochs at "
          f"drop_p=0.01: {t_train:.2f} s with staging and the SVD features, "
          f"{steps} fold-batched steps per epoch")
    for j, h in enumerate(hists):
        print(f"  fold {j} train {h['train']} val {h['val']} lr {h['lr']}")
    print(f"  val MAE untrained {untrained} trained {trained}")
    print(f"  launches on the GAT trainer path: {counts}")
    if not (all(np.isfinite(h["train"]).all() and np.isfinite(h["val"]).all()
                and len(h["val"]) == 2 for h in hists)
            and np.isfinite(trained).all()):
        fail("GAT trainer: non-finite loss or MAE, or a short history")
    missing = [k for k in GAT_PATH if not counts.get(k)]
    if missing:
        fail(f"kernels never launched on the GAT trainer path: {missing}")

    # an epoch and a validation pass on their own, then fused against
    # unfused at drop_p = 0 from the same weights
    lr_t = torch.full((3,), 1e-3, device=dev)
    active = torch.ones(3, device=dev)
    res = {}
    for mode, flags in (("fused", dict(fused_step=True)), ("unfused", {})):
        c = GATTrainConfig(epochs=1, drop_p=0.0, **flags)
        tr = _FoldTrainer(c, lr_all, hr_all, folds, 42, dev,
                          fused=c.fused_step)
        order, valid = tr.draw_epoch_plan()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        tr_loss = tr.epoch(order, valid, lr_t, active)
        torch.cuda.synchronize()
        t_epoch = time.perf_counter() - t0
        n_step = sum(launch_counts().values())
        reset_launch_counts()
        t0 = time.perf_counter()
        vloss, vmae = tr.validate()
        torch.cuda.synchronize()
        t_val = time.perf_counter() - t0
        n_val = sum(launch_counts().values())
        res[mode] = (tr_loss.cpu().numpy(), vloss.cpu().numpy(),
                     vmae.cpu().numpy())
        graphed = f", the graphs' {capture_note(tr)} included" \
            if tr._graphs else ""
        tr.release_graphs()
        print(f"  {mode:8s} epoch {t_epoch:.3f} s = "
              f"{1e3 * t_epoch / steps:.3f} ms/step in the loop "
              f"({n_step / steps:.1f} own-kernel launches/step); validation "
              f"pass {1e3 * t_val:.2f} ms ({n_val} own-kernel launches"
              f"{graphed}); "
              f"train {res[mode][0].tolist()} val {res[mode][1].tolist()} "
              f"val MAE {res[mode][2].tolist()}", flush=True)
    d = [float(np.abs(a - b).max()) for a, b in zip(res["fused"],
                                                    res["unfused"])]
    print(f"  fused vs unfused after one epoch (drop_p=0): max|d train loss| "
          f"{d[0]:.2e}, |d val loss| {d[1]:.2e}, |d val MAE| {d[2]:.2e} "
          f"(limit 1e-4)")
    if not max(d) <= 1e-4:
        fail("the fused GAT epoch disagrees with the unfused one")
    return counts


def run_gat_cli(dev, csv_dir):
    """Phase 7.5: `train gat` through the command line on phase 5's CSVs,
    fused (the path a user runs; its launch counts are returned), then
    --fast and the per-fold trainer; each column-major submission parsed
    back against the plain vectorization of the written weights'
    predictions."""
    from fcsr_tpu_torch import cli
    from fcsr_tpu_torch.data import load_dataset
    from fcsr_tpu_torch.iox import load_arrays
    from fcsr_tpu_torch.kernels import (PLAIN_OPS, launch_counts,
                                        reset_launch_counts)
    from fcsr_tpu_torch.train.gat_loop import GATTrainConfig, predict_gat

    data = load_dataset(csv_dir, device=dev)
    cfg = GATTrainConfig()
    model = cfg.model(device=dev)
    n_rows = N_TEST * HR * (HR - 1) // 2
    main_counts = None
    for flags, epochs, splits in ((["--fast", "--fused"], "2", "3"),
                                  (["--fast"], "1", "3"), ([], "1", "2")):
        out_dir = os.path.join(WORK_DIR, "out_gat" + "".join(flags))
        reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["train", "gat", *flags, "--epochs", epochs,
                       "--splits", splits, "--data-dir", csv_dir,
                       "--out-dir", out_dir])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        counts = _nonzero(launch_counts())
        if rc != 0:
            fail(f"`train gat {' '.join(flags)}` returned {rc}")
        params = load_arrays(os.path.join(out_dir, "gat_params.npz"))
        preds = predict_gat(params, model, cfg, data["lr_test"])
        got = _read_submission(os.path.join(out_dir, "submission.csv"),
                               n_rows)
        ref = PLAIN_OPS.vectorize_colmajor(preds.cpu()).reshape(-1).numpy()
        err = float(np.abs(got.astype(np.float64) - ref).max())
        print(f"  `train gat {' '.join(flags)}` ({splits} folds x {epochs} "
              f"epochs) {t_cli:.1f} s; submission.csv 1 + {n_rows} lines, "
              f"max|parsed - plain column-major vectorization| {err:.1e}; "
              f"launches {counts}", flush=True)
        if err != 0.0 or not np.isfinite(got).all():
            fail("`train gat`: the submission does not parse back to the "
                 "column-major vectorization of the predictions")
        if main_counts is None:
            main_counts = counts
            missing = [k for k in GAT_PATH + ("vectorize_colmajor",)
                       if not counts.get(k)]
            if missing:
                fail(f"`train gat --fast --fused` never launched: {missing}")
    return main_counts

# ---------------------------------------------------------------------------
# phase 8: the metric suite on the card
# ---------------------------------------------------------------------------

TOPO_KEYS = ("mae_betweenness", "mae_eigenvector", "mae_pagerank",
             "mae_core_periphery", "kl_weights")
METRIC_KEYS = ("mae", "pcc", "js_distance") + TOPO_KEYS
# results_fold_{i}.txt: each metric's label, in the reference's order
RESULT_LINES = (("MAE: ", "mae"), ("PCC: ", "pcc"),
                ("Jensen-Shannon Distance: ", "js_distance"),
                ("Average KL Divergence on weight distributions: ",
                 "kl_weights"),
                ("Average MAE betweenness centrality: ", "mae_betweenness"),
                ("Average MAE eigenvector centrality: ", "mae_eigenvector"),
                ("Average MAE PageRank centrality: ", "mae_pagerank"),
                ("Average MAE core-periphery structure: ",
                 "mae_core_periphery"))
# the suite's parts, as evalx/report.py::_topo_rows calls them, and the
# batched loops (evalx/centrality.py) each runs
SUITE_LOOPS = {"BC": ("dijkstra", "brandes_sigma", "brandes_delta"),
               "EC": ("eigenvector",), "PR": ("pagerank",),
               "k-core": ("kcore", "kcore_peel"), "KL": ()}


def events_s(fn):
    """(fn(), seconds) of one call by CUDA events, the end event waited
    for on the host."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b) / 1e3


def _check_metric_dict(label, m):
    if set(m) != set(METRIC_KEYS) \
            or not all(np.isfinite(m[k]) for k in METRIC_KEYS):
        fail(f"{label}: metric dict {m}")


def suite_breakdown(dev, gts, preds, precision):
    """Seconds of each part of the device backend's pass over the stacks
    (the chunks evaluate_pair_stacks takes; CUDA events around each part,
    which ends on the host at its loops' last condition), with the
    iterations and host syncs of its loops."""
    from fcsr_tpu_torch.evalx import centrality as C
    from fcsr_tpu_torch.evalx import metrics as M
    from fcsr_tpu_torch.evalx.report import _device_chunks

    parts = {
        "BC": lambda w, p, m, dt: C.betweenness_centrality(w, p, dtype=dt),
        "EC": lambda w, p, m, dt: C.eigenvector_centrality(
            w, return_converged=True),
        "PR": lambda w, p, m, dt: C.pagerank(w, return_converged=True),
        "k-core": lambda w, p, m, dt: C.weighted_kcore_scores(w),
        "KL": lambda w, p, m, dt: M.weight_histogram_kl(w[m:], w[:m]),
    }
    secs = dict.fromkeys(parts, 0.0)
    C.reset_loop_counts()
    n_chunks = 0
    for w, piv, m, dtype in _device_chunks(
            np.asarray(gts, np.float64), np.asarray(preds, np.float64), 42,
            precision, dev):
        n_chunks += 1
        for name, fn in parts.items():
            secs[name] += events_s(lambda: fn(w, piv, m, dtype))[1]
    loops = C.loop_counts()
    return secs, {name: {k: loops.get(k, {"iterations": 0, "syncs": 0})
                         for k in names}
                  for name, names in SUITE_LOOPS.items()}, n_chunks


def _read_results(path):
    """{metric: value} of a results_fold_{i}.txt, after checking its
    labels and their order."""
    with open(path) as f:
        lines = f.read().splitlines()
    if len(lines) != len(RESULT_LINES):
        fail(f"{path}: {len(lines)} lines")
    out = {}
    for line, (label, key) in zip(lines, RESULT_LINES):
        if not line.startswith(label):
            fail(f"{path}: {line!r} where {label!r} belongs")
        out[key] = float(line[len(label):])
    return out


def run_metric_suite(dev, fold_outs, csv_dir):
    """Phase 8: the metric suite on phase 4's fold stacks (3 folds of 55-56
    pairs at 268 nodes) on the card, in both precisions and against the
    port's CPU path; its seconds per stack at the `evaluate` scale (folds 0
    and 1, 112 pairs) with their breakdown; `train gsr --fused
    --full-metrics` and `evaluate` through the command line. Returns the
    launch counts of the `train` run."""
    import importlib.util

    from fcsr_tpu_torch import cli
    from fcsr_tpu_torch.data import kfold_indices
    from fcsr_tpu_torch.evalx import centrality as C
    from fcsr_tpu_torch.evalx import evaluate_pair_stacks
    from fcsr_tpu_torch.evalx.report import _global_metrics
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    preds0, gts0 = fold_outs[0]
    if tuple(preds0.shape[1:]) != (HR, HR) or len(fold_outs) != 3:
        fail(f"fold stacks {[p.shape for p, _ in fold_outs]}")
    m64, t64 = events_s(lambda: evaluate_pair_stacks(gts0, preds0,
                                                     device=dev))
    m32, t32 = events_s(lambda: evaluate_pair_stacks(
        gts0, preds0, precision="float32", device=dev))
    _check_metric_dict("fold 0 float64", m64)
    _check_metric_dict("fold 0 float32", m32)
    gap = {k: m32[k] - m64[k] for k in METRIC_KEYS}
    print(f"  fold 0 ({len(preds0)} pairs) on the card, first call: float64 "
          f"{t64:.3f} s {m64}; float32 {t32:.3f} s; float32 - float64 "
          f"{gap}", flush=True)
    # precision governs the betweenness pass and the KL's arithmetic only:
    # EC / PageRank run in float64 from the same float32 stacks, k-core
    # and the host metrics do not depend on it. The betweenness gap
    # depends on the stacks: near-zero weights make near-tied shortest
    # paths that float32's 1e-5 tie rule joins (as the JAX package's)
    if any(gap[k] != 0.0 for k in ("mae_eigenvector", "mae_pagerank",
                                    "mae_core_periphery", "mae", "pcc",
                                    "js_distance")) \
            or max(abs(gap[k]) for k in TOPO_KEYS) > 3e-5:
        fail("float32 against float64: the betweenness and KL gaps over "
             "3e-5, or another metric unequal")
    for precision, limit in (("float64", 1e-9), ("float32", 3e-5)):
        card = evaluate_pair_stacks(gts0[:8], preds0[:8], precision=precision,
                                    device=dev)
        host, t_host = events_s(lambda: evaluate_pair_stacks(
            gts0[:8], preds0[:8], precision=precision, device="cpu"))
        d_host = max(abs(card[k] - host[k]) for k in METRIC_KEYS)
        print(f"  first 8 pairs, card vs CPU ({t_host:.2f} s) {precision}: "
              f"max|d| {d_host:.2e} (limit {limit:.0e}), core-periphery "
              f"{card['mae_core_periphery']} vs "
              f"{host['mae_core_periphery']}", flush=True)
        if d_host > limit or card["mae_core_periphery"] \
                != host["mae_core_periphery"]:
            fail(f"the metric suite ({precision}) on the card disagrees with "
                 "the CPU path")

    # the `evaluate` scale: folds 0 and 1, as evaluate sees them
    gts = np.concatenate([fold_outs[0][1], fold_outs[1][1]])
    preds = np.concatenate([fold_outs[0][0], fold_outs[1][0]])
    smi = smi_line()
    for precision in ("float64", "float32"):
        times = {}
        for label, g, p in ((str(len(gts0)), gts0, preds0),
                            (str(len(gts)), gts, preds)):
            times[label] = [events_s(lambda: evaluate_pair_stacks(
                g, p, precision=precision, device=dev))[1]
                for _ in range(2)]
        secs, loops, n_chunks = suite_breakdown(dev, gts, preds, precision)
        t0 = time.perf_counter()
        _global_metrics(np.asarray(gts, np.float64),
                        np.asarray(preds, np.float64))
        secs["host MAE / PCC / JSD"] = time.perf_counter() - t0
        rest = min(times[str(len(gts))]) - sum(secs.values())
        print(f"  {precision}: seconds per stack (two calls each) "
              f"{times}; {len(gts)} pairs by part over {n_chunks} "
              f"chunk(s): " + ", ".join(f"{k} {v:.4f} s"
                                        for k, v in secs.items())
              + f" (sum {sum(secs.values()):.4f} s; the rest of the "
              f"faster call, staging and conversions, {rest:.4f} s); loops "
              f"{loops}; card {smi}", flush=True)

    # the command line: every fold scored after a fused run on the CSVs
    out_dir = os.path.join(WORK_DIR, "out_metrics")
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["train", "gsr", "--fused", "--full-metrics", "--epochs",
                   "2", "--splits", "3", "--data-dir", csv_dir, "--out-dir",
                   out_dir])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    counts = _nonzero(launch_counts())
    if rc != 0:
        fail(f"`train gsr --fused --full-metrics` returned {rc}")
    steps = 2 * max(len(tr) for tr, _ in kfold_indices(N_TRAIN, 3, seed=42))
    per_step = sum(counts.get(k, 0) for k in STEP_KERNELS) / steps
    with open(os.path.join(out_dir, "eval_metrics.json")) as f:
        fold_metrics = json.load(f)
    print(f"  `train gsr --fused --full-metrics` (3 folds x 2 epochs) "
          f"{t_cli:.1f} s; {per_step} launches a step; eval_metrics.json "
          f"{fold_metrics}", flush=True)
    if per_step != STEP_LAUNCHES:
        fail(f"{per_step} launches a step, not {STEP_LAUNCHES}")
    if len(fold_metrics) != 3:
        fail(f"eval_metrics.json holds {len(fold_metrics)} folds")
    for j, m in enumerate(fold_metrics):
        _check_metric_dict(f"eval_metrics.json fold {j}", m)

    gt_path = os.path.join(WORK_DIR, "gt.npz")
    pred_path = os.path.join(WORK_DIR, "pred.npz")
    np.savez(gt_path, gt=gts0)
    np.savez(pred_path, pred=preds0)
    ev_dir = os.path.join(WORK_DIR, "out_evaluate")
    rc = cli.main(["evaluate", "--gt", gt_path, "--pred", pred_path,
                   "--out-dir", ev_dir])
    if rc != 0:
        fail(f"`evaluate` returned {rc}")
    written = _read_results(os.path.join(ev_dir, "results_fold_0.txt"))
    d_file = max(abs(written[k] - m64[k]) for k in METRIC_KEYS)
    print(f"  `evaluate --gt --pred` ({len(gts0)} pairs): "
          f"results_fold_0.txt in the reference's 8 lines, max|file - "
          f"in-process| {d_file:.1e} (limit 1e-12)", flush=True)
    if d_file > 1e-12:
        fail("`evaluate` wrote other values than the in-process pass")

    if importlib.util.find_spec("networkx") is None:
        for argv in (["train", "gsr", "--fused", "--full-metrics",
                      "--eval-backend", "networkx", "--epochs", "1",
                      "--data-dir", csv_dir, "--out-dir", out_dir],
                     ["evaluate", "--gt", gt_path, "--pred", pred_path,
                      "--backend", "networkx", "--out-dir", ev_dir]):
            try:
                cli.main(argv)
            except ImportError as e:
                if "networkx" not in str(e):
                    fail(f"`{' '.join(argv[:2])}` with networkx missing: "
                         f"{e!r} does not name networkx")
                print(f"  `{' '.join(argv[:2])} ... networkx` without "
                      f"networkx: ImportError({str(e)!r})")
            else:
                fail(f"`{' '.join(argv[:2])}` ran the networkx backend "
                     "without networkx")
    else:
        nx_m, t_nx = events_s(lambda: evaluate_pair_stacks(
            gts0[:4], preds0[:4], backend="networkx"))
        dev_m = evaluate_pair_stacks(gts0[:4], preds0[:4], device=dev)
        rel = max(abs(dev_m[k] - nx_m[k]) / max(abs(nx_m[k]), 1e-300)
                  for k in METRIC_KEYS)
        print(f"  networkx is installed here: the networkx backend on 4 "
              f"pairs ({t_nx:.1f} s) vs the card's float64, max relative "
              f"|d| {rel:.2e} (limit 2e-4)", flush=True)
        if rel > 2e-4:
            fail("the card's metric suite disagrees with networkx")
    C.reset_loop_counts()
    return counts


# ---------------------------------------------------------------------------
# phase 9: the MLP family
# ---------------------------------------------------------------------------

MLP_EPOCHS = 100            # the shipped `train mlp` run
MLP_V1_EPOCHS = 2           # v1 at full width, cut to 2 epochs
MLP_V2_P, MLP_V1_P = 10_414_992, 974_341_824   # parameters per fold
MLP_V1_HIDDEN = 10_000     # v1's hidden width (the JAX package's default)
MLP_CHECK_SLICE = 1 << 20   # elements per fold held to plain at v1's size
ADAMW_BYTES = 28            # p, m, v, g read and p, m, v written, float32


def _adamw_inputs(F, P, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randn(F, P, device=dev, generator=g)
    m = torch.randn(F, P, device=dev, generator=g).mul_(1e-2)
    v = torch.rand(F, P, device=dev, generator=g).mul_(1e-3)
    grad = torch.randn(F, P, device=dev, generator=g)
    # fold 1 masked, the others at other rates and steps
    scal = torch.tensor([[1.0, 1e-2, 1 - 0.9, 1 - 0.999],
                         [0.0, 1e-2, 1 - 0.9, 1 - 0.999],
                         [1.0, 1e-3, 1 - 0.9 ** 7, 1 - 0.999 ** 7]][:F],
                        device=dev)
    return p, m, v, grad, scal, torch.ones(F, 1, device=dev)


def check_adamw_inplace(dev):
    """Phase 9.1: ``adamw_masked`` at the MLP trainer's shapes. At v2's (3 x
    10 414 992) the out-of-place form against its plain version and the
    in-place form against the out-of-place one, bit for bit, then both
    timed in turns beside the plain version and ``torch._fused_adamw_``
    (one rate, no mask: not the same function, so no library time); at
    v1's (3 x 974 341 824, which only the in-place form fits) the
    in-place form against the plain version on the first 2^20 entries of
    each fold, bit for bit, and timed. Returns the printed rows."""
    from fcsr_tpu_torch.kernels import PLAIN_OPS, KERNEL_OPS as K
    from fcsr_tpu_torch.utils.timing import graph_ms

    hp = (0.9, 0.999, 1e-8, 0.01)
    rows = {}
    F = 3
    p, m, v, g, scal, vals = _adamw_inputs(F, MLP_V2_P, dev, 9)
    oop = K.adamw_masked(p, m, v, g, scal, vals, *hp)
    plain = PLAIN_OPS.adamw_masked(p, m, v, g, scal, vals, *hp)
    bufs = [t.clone() for t in (p, m, v)]
    inp = K.adamw_masked(*bufs, g, scal, vals, *hp, inplace=True)
    torch.cuda.synchronize()
    same_plain = all(torch.equal(a, b) for a, b in zip(oop, plain))
    same_forms = all(torch.equal(a, b) for a, b in zip(oop, inp)) and all(
        a.data_ptr() == b.data_ptr() for a, b in zip(inp[:3], bufs))
    masked = all(torch.equal(a[1], b[1]) for a, b in zip(inp[:3], (p, m, v)))
    print(f"  adamw_masked at v2's {F} x {MLP_V2_P}: out of place == plain "
          f"{same_plain}, in place == out of place {same_forms}, masked "
          f"fold unchanged {masked}", flush=True)
    if not (same_plain and same_forms and masked):
        fail("adamw_masked: the in-place and out-of-place forms and the "
             "plain version disagree at v2's shape")
    del oop, plain, inp
    fns = [lambda: K.adamw_masked(p, m, v, g, scal, vals, *hp),
           lambda: K.adamw_masked(*bufs, g, scal, vals, *hp, inplace=True),
           lambda: PLAIN_OPS.adamw_masked(p, m, v, g, scal, vals, *hp)]
    ps, gs = list(bufs[0].clone().unbind(0)), list(g.unbind(0))
    ms_, vs = list(bufs[1].clone().unbind(0)), list(bufs[2].clone().unbind(0))
    steps = [torch.ones((), device=dev) for _ in range(F)]
    fused = getattr(torch, "_fused_adamw_", None)
    if fused is not None:
        fns.append(lambda: fused(ps, gs, ms_, vs, [], steps, lr=1e-2,
                                 beta1=0.9, beta2=0.999, weight_decay=0.01,
                                 eps=1e-8, amsgrad=False, maximize=False))
    times = graph_ms(fns, reps=10)
    b_ms, b_by = bound(0.0, ADAMW_BYTES * F * MLP_V2_P)
    rows["v2"] = dict(ms=times[0], ms_inplace=times[1], plain_ms=times[2],
                      bound_ms=b_ms, fused_adamw_ms=(times[3] if fused
                                                     else None))
    print(f"  adamw_masked at v2's shape: out of place {times[0]:.4f} ms, in "
          f"place {times[1]:.4f} ms, plain {times[2]:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}); torch._fused_adamw_ over the 3 folds "
          "(one rate, no mask, not the same function) "
          + (f"{times[3]:.4f} ms" if fused else "not in this torch"),
          flush=True)
    del p, m, v, g, bufs, ps, gs, ms_, vs, fns
    torch.cuda.empty_cache()

    p, m, v, g, scal, vals = _adamw_inputs(F, MLP_V1_P, dev, 10)
    sl = slice(0, MLP_CHECK_SLICE)
    before = [t[:, sl].clone() for t in (p, m, v, g)]
    K.adamw_masked(p, m, v, g, scal, vals, *hp, inplace=True)
    want = PLAIN_OPS.adamw_masked(*before, scal, vals, *hp)
    torch.cuda.synchronize()
    same = all(torch.equal(a[:, sl], b) for a, b in zip((p, m, v), want))
    ms = graph_ms([lambda: K.adamw_masked(p, m, v, g, scal, vals, *hp,
                                          inplace=True)], reps=2)[0]
    b_ms, b_by = bound(0.0, ADAMW_BYTES * F * MLP_V1_P)
    rows["v1"] = dict(ms_inplace=ms, bound_ms=b_ms)
    print(f"  adamw_masked in place at v1's {F} x {MLP_V1_P} (4 buffers of "
          f"{F * MLP_V1_P * 4 / 1e9:.1f} GB): == plain on the first "
          f"{MLP_CHECK_SLICE} entries of each fold {same}; {ms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}), {100 * b_ms / ms:.0f}% of it", flush=True)
    if not same:
        fail("adamw_masked in place disagrees with its plain version at "
             "v1's shape")
    del p, m, v, g, before, want
    torch.cuda.empty_cache()
    return rows


def _mlp_setup(variant, data, F, dev):
    """The full-width training model, its fold stacks (the teacher set's
    contiguous-window folds) and a trainer from fresh inits."""
    from fcsr_tpu_torch.data import contiguous_window_folds
    from fcsr_tpu_torch.models.mlp import SpectralResMLP, SuperResMLP
    from fcsr_tpu_torch.train.generic_loop import _FoldTrainer, mse_criterion
    from fcsr_tpu_torch.train.losses import (make_triu_mse_criterion,
                                             pack_triu_targets)

    lr = np.asarray(data["lr_train"], np.float32)
    hr = np.asarray(data["hr_train"], np.float32)
    if variant == "v2":
        model = SpectralResMLP(LR, HR, (LR + HR) // 2, output="vector",
                               device="meta")
        r, c = np.triu_indices(LR, 1)
        x, y = lr[:, r, c], pack_triu_targets(hr)
        crit = make_triu_mse_criterion(HR)
    else:
        model = SuperResMLP(LR * LR, HR * HR, MLP_V1_HIDDEN, 1,
                            device="meta")
        x, y, crit = lr, hr, mse_criterion
    folds = contiguous_window_folds(len(lr), 3, 0.33, seed=42)[:F]
    tr = np.stack([a for a, _ in folds])
    va = np.stack([b for _, b in folds])
    p, s = model.init_flat([42 + j for j in range(F)], dev)
    return _FoldTrainer(model, p, s, x[tr], y[tr], x[va], y[va], 42, 32,
                        crit, 1.0, 0.01, dev)


def _fingerprint(t):
    """(sum of the float32 bit patterns as int64, sum in float64, the first
    entries): two buffers with the same fingerprint are taken as equal bit
    for bit (one entry that differs changes the first sum), without a
    second copy of a v1-sized buffer."""
    return (int(t.view(torch.int32).sum(dtype=torch.int64)),
            float(t.sum(dtype=torch.float64)),
            t.reshape(-1)[:MLP_CHECK_SLICE].clone())


def _same_fingerprint(a, b):
    return a[0] == b[0] and a[1] == b[1] and torch.equal(a[2], b[2])


def check_mlp_steps(dev, data):
    """Phase 9.2: one full-width training step of each variant on the
    kernels (``KERNEL_OPS``) against the same step on the plain versions
    (``PLAIN_OPS``) from the same state and the same dropout draws: loss,
    clipped gradient, p, m, v and the statistics bit for bit (the update
    is IEEE with no FMA; everything else is the same PyTorch code),
    compared by ``_fingerprint``. v2 at F = 3 with fold 1 masked, v1 at
    F = 1 (the plain update's temporaries for 3 folds would not fit). Then
    each variant's step at F = 3 timed eager and as one CUDA graph and
    profiled (its device launches; ``adamw_masked`` once). Returns the
    step numbers by variant."""
    from torch.autograd import DeviceType

    from fcsr_tpu_torch.kernels import (KERNEL_OPS, PLAIN_OPS, launch_counts,
                                        reset_launch_counts)

    for variant, F in (("v2", 3), ("v1", 1)):
        tr = _mlp_setup(variant, data, F, dev)
        idx = torch.arange(32, device=dev).repeat(F, 1)
        ok = torch.tensor([1.0, 0.0, 1.0][:F], device=dev)
        lr = torch.full((F,), 0.01, device=dev)
        bufs = (tr.p, tr.m, tr.v, tr.s, tr.t)
        state = [t.clone() for t in bufs]
        masked_before = [t[1].clone() for t in bufs[:4]] if F > 1 else None
        results = []
        for ops in (KERNEL_OPS, PLAIN_OPS):
            for buf, saved in zip(bufs, state):
                buf.copy_(saved)
            tr.gen.manual_seed(42)
            tr.ops = ops
            reset_launch_counts()
            loss = tr.step(idx, ok, lr)
            torch.cuda.synchronize()
            results.append(([loss.clone()] + [_fingerprint(t) for t in (
                tr.g, tr.p, tr.m, tr.v, tr.s)], _nonzero(launch_counts())))
        (k, k_counts), (pl, p_counts) = results
        same = [torch.equal(k[0], pl[0])] + [
            _same_fingerprint(a, b) for a, b in zip(k[1:], pl[1:])]
        moved = not _same_fingerprint(k[2], _fingerprint(state[0]))
        masked = F == 1 or all(torch.equal(a[1], b) for a, b in zip(
            bufs[:4], masked_before))
        print(f"  {variant} step (F = {F}, full width): kernels vs plain, "
              f"loss / g / p / m / v / stats bit-equal {same}; masked fold "
              f"unchanged {masked}; launches {k_counts} vs {p_counts}; loss "
              f"{k[0].tolist()}", flush=True)
        if not (all(same) and moved and masked) \
                or k_counts != {"adamw_masked": 1} or p_counts:
            fail(f"the {variant} MLP step on the kernels disagrees with the "
                 "step on the plain versions")
        del tr, bufs, state, results, k, pl, masked_before
        torch.cuda.empty_cache()

    out = {}
    for variant in ("v2", "v1"):
        tr = _mlp_setup(variant, data, 3, dev)
        tr.gen = None            # a graph draws from the default generator
        idx = torch.arange(32, device=dev).repeat(3, 1)
        ok, lr = (torch.ones(3, device=dev), torch.full((3,), 0.01,
                                                        device=dev))
        step = lambda: tr.step(idx, ok, lr)
        reps = 10 if variant == "v2" else 2
        eager = cuda_ms(step, reps=reps, rounds=3)
        graph = device_ms(step, reps=reps)
        averages = profile_launches(
            step, eager, os.path.join(OUT_DIR, f"profile_mlp_{variant}.txt"),
            {"adamw_masked": 1}, f"MLP {variant} step")
        launches = sum(e.count for e in averages
                       if e.device_type == DeviceType.CUDA) / 10
        out[variant] = dict(eager_ms=eager, graph_ms=graph,
                            launches=launches)
        print(f"  {variant} step (F = 3): {eager:.3f} ms eager, {graph:.3f} "
              f"ms on the device as one CUDA graph, {launches:g} device "
              "launches a step (kernels, copies, fills), 1 of them "
              "adamw_masked", flush=True)
        del tr, step
        torch.cuda.empty_cache()
    return out


def _mlp_reference_maes(data, folds, dev):
    """Each fold's validation MAE of its untrained model (the pipeline's
    inits) and of the mean training target."""
    from fcsr_tpu_torch.models.mlp import SpectralResMLP
    from fcsr_tpu_torch.train.generic_loop import fold_state
    from fcsr_tpu_torch.train.losses import pack_triu_targets

    model = SpectralResMLP(LR, HR, (LR + HR) // 2, output="vector",
                           device="meta")
    p, s = model.init_flat([42 + j for j in range(len(folds))], dev)
    lr = np.asarray(data["lr_train"], np.float32)
    y = torch.from_numpy(pack_triu_targets(np.asarray(
        data["hr_train"], np.float32))).to(dev)[:, :HR * (HR - 1) // 2]
    r, c = np.triu_indices(LR, 1)
    x = torch.from_numpy(np.ascontiguousarray(lr[:, r, c])).to(dev)
    untrained, mean = [], []
    for j, (tr, va) in enumerate(folds):
        pred = model.predict(fold_state(model, p, s, j), x[va])
        untrained.append(float((pred - y[va]).abs().mean()))
        mean.append(float((y[tr].mean(0) - y[va]).abs().mean()))
    return untrained, mean


def run_mlp_main_path(dev, data):
    """Phase 9.3: the slice's main path, ``run_mlp_cv`` with the JAX
    package's defaults (v2 at full width, 3 folds of 112 / 55 subjects,
    100 epochs, batch 32) on the teacher set; its launch counts, times and
    MAEs (beside the untrained model's and the mean target's)."""
    from fcsr_tpu_torch.data import contiguous_window_folds
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.pipelines import run_mlp_cv

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = run_mlp_cv(data, num_epochs=MLP_EPOCHS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _nonzero(launch_counts())
    epochs = max(len(h[0]) for h in result["histories"])
    steps = epochs * 4
    t = result["timings"]
    folds = contiguous_window_folds(len(data["lr_train"]), 3, 0.33, seed=42)
    untrained, mean = _mlp_reference_maes(data, folds, dev)
    print(f"  run_mlp_cv (v2, 3 folds, {MLP_EPOCHS} epochs): {wall:.2f} s "
          f"(train {t['train']:.2f}, eval {t['eval']:.3f}, predict "
          f"{t['predict']:.3f}); epochs run {[len(h[0]) for h in result['histories']]}"
          f"; {t['train'] / epochs:.4f} s/epoch, {1e3 * t['train'] / steps:.2f}"
          f" ms per step in the loop (validation included); launches "
          f"{counts}", flush=True)
    print(f"  fold MAEs {result['fold_maes']}, mean {result['mean_mae']:.5f}; "
          f"untrained {np.mean(untrained):.5f} {untrained}; mean training "
          f"target {np.mean(mean):.5f} {mean}; final lrs "
          f"{[h[2][-1] for h in result['histories']]}", flush=True)
    preds = result["test_preds"]
    if counts.get("adamw_masked") != steps or not counts.get(
            "anti_vectorize_normalize"):
        fail(f"run_mlp_cv launched {counts}: not one adamw_masked per step "
             f"({steps}) and the matrix scatter for the test predictions")
    if not (np.isfinite(result["fold_maes"]).all()
            and result["mean_mae"] < np.mean(untrained)
            and tuple(preds.shape) == (N_TEST, HR, HR)
            and bool(torch.isfinite(preds).all())):
        fail("run_mlp_cv: non-finite or untrained-level MAEs, or bad test "
             "predictions")
    return counts


def run_mlp_cli(dev, csv_dir):
    """Phase 9.4: `train mlp` (v2, its defaults) and `train mlp --variant
    v1 --epochs 2` through the command line on phase 5's CSVs, each
    column-major submission parsed back against the plain vectorization of
    the run's test predictions; v1's peak device memory. Returns the
    launch counts of both runs."""
    from fcsr_tpu_torch import cli, pipelines
    from fcsr_tpu_torch.kernels import (PLAIN_OPS, launch_counts,
                                        reset_launch_counts)

    run = pipelines.run_mlp_cv
    seen = {}

    def capture(*args, **kw):
        seen.update(run(*args, **kw))
        return seen

    n_rows = N_TEST * HR * (HR - 1) // 2
    total = {}
    pipelines.run_mlp_cv = capture
    try:
        for flags in ([], ["--variant", "v1", "--epochs",
                           str(MLP_V1_EPOCHS)]):
            out_dir = os.path.join(WORK_DIR, "out_mlp" + "".join(flags))
            seen.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(["train", "mlp", *flags, "--data-dir", csv_dir,
                           "--out-dir", out_dir])
            torch.cuda.synchronize()
            t_cli = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            counts = _nonzero(launch_counts())
            if rc != 0:
                fail(f"`train mlp {' '.join(flags)}` returned {rc}")
            got = _read_submission(os.path.join(out_dir, "submission.csv"),
                                   n_rows)
            ref = PLAIN_OPS.vectorize_colmajor(
                seen["test_preds"].cpu()).reshape(-1).numpy()
            err = float(np.abs(got.astype(np.float64) - ref).max())
            epochs = max(len(h[0]) for h in seen["histories"])
            t = seen["timings"]
            print(f"  `train mlp {' '.join(flags)}`: {t_cli:.1f} s (train "
                  f"{t['train']:.2f} s, {epochs} epochs run, "
                  f"{t['train'] / epochs:.3f} s/epoch, "
                  f"{1e3 * t['train'] / (4 * epochs):.2f} ms per step in the "
                  f"loop); fold MAEs {seen['fold_maes']}; peak device memory "
                  f"{peak:.2f} GB; submission.csv 1 + {n_rows} lines, "
                  f"max|parsed - plain column-major vectorization| "
                  f"{err:.1e}; launches {counts}", flush=True)
            if err != 0.0 or not np.isfinite(got).all():
                fail("`train mlp`: the submission does not parse back to the "
                     "column-major vectorization of the predictions")
            if counts.get("adamw_masked") != 4 * epochs \
                    or not counts.get("vectorize_colmajor"):
                fail(f"`train mlp {' '.join(flags)}` launched {counts}")
            if os.listdir(out_dir) != ["submission.csv"]:
                fail(f"`train mlp` wrote {os.listdir(out_dir)}")
            for k, c in counts.items():
                total[k] = total.get(k, 0) + c
            seen.clear()
    finally:
        pipelines.run_mlp_cv = run
    return total


# ---------------------------------------------------------------------------
# phase 10: the JAX package's files and the last modules
# ---------------------------------------------------------------------------

JAX_GSR_FILE = os.path.join(HERE, "outputs", "gsr", "gsr_net_trained.msgpack")
# sha256 of load_or_synthesize(None, flavor="lift") (keys in order, each
# as name, shape, dtype and bytes): tests/test_torch_synthetic_lift.py
LIFT_SHA256 = \
    "6a59b7836ef1776df61a91ff9fdcbcacb3aa5b41ce9d8426a5faf9e0c989b3da"
# the JAX package's GraphSAGEUpsampler has no default width: this phase's
UPSAMPLE_HIDDEN, UPSAMPLE_LAYERS, UPSAMPLE_THRESHOLD = 64, 2, 0.2
EXAMPLE_EPOCHS, EXAMPLE_SPLITS = 2, 3


def check_msgpack_fixture():
    """10a: the JAX package's GSR-Net file decoded and encoded again by the
    port's coder, byte for byte; the least of 5 timed runs of each."""
    from fcsr_tpu_torch.iox.msgpack import (msgpack_restore,
                                            msgpack_serialize, to_bytes)
    with open(JAX_GSR_FILE, "rb") as f:
        raw = f.read()
    dec, enc = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        tree = msgpack_restore(raw)
        t1 = time.perf_counter()
        out = msgpack_serialize(tree)
        enc.append(time.perf_counter() - t1)
        dec.append(t1 - t0)
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(tree)
    same = out == raw and to_bytes(tree) == raw
    print(f"  {os.path.relpath(JAX_GSR_FILE, HERE)}: {len(raw)} bytes, "
          f"{len(leaves)} arrays; decode {1e3 * min(dec):.2f} ms, encode "
          f"{1e3 * min(enc):.2f} ms (least of 5); re-encoded bytes equal "
          f"the file's: {same}", flush=True)
    if not same:
        fail("the msgpack coder does not write the JAX package's file back "
             "byte for byte")
    if not all(isinstance(a, np.ndarray) and a.flags.writeable
               and a.dtype == np.float32 for a in leaves):
        fail("the decoded GSR-Net leaves are not writable float32 arrays")


def _p10_predict(args, device):
    """`predict` through the command line; (wall s, launch counts)."""
    from fcsr_tpu_torch import cli
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["predict", *args, "--device", device])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"`predict {' '.join(args)} --device {device}` returned {rc}")
    return wall, _nonzero(launch_counts())


def run_predict_msgpack(work):
    """10b: `predict --params <the JAX package's file>` over the teacher
    set's 112 test subjects, in both orderings, on the card and with
    --device cpu. Returns the card runs' launch counts."""
    from fcsr_tpu_torch.data import load_or_synthesize

    data_dir = os.path.join(work, "data")
    load_or_synthesize(data_dir, n_train=N_TRAIN, n_test=N_TEST, seed=42)
    n_rows = N_TEST * HR * (HR - 1) // 2
    total = {}
    for ordering in ("rowmajor", "colmajor"):
        got = {}
        for device in ("cuda", "cpu"):
            out = os.path.join(work, f"predict_{ordering}_{device}.csv")
            wall, counts = _p10_predict(
                ["--params", JAX_GSR_FILE, "--data-dir", data_dir, "--out",
                 out, "--ordering", ordering], device)
            got[device] = (_read_submission(out, n_rows), wall, counts)
            os.remove(out)
        (card, t_card, counts), (host, t_host, host_counts) = \
            got["cuda"], got["cpu"]
        err = float(np.abs(card.astype(np.float64) - host).max())
        print(f"  predict --params {os.path.basename(JAX_GSR_FILE)} "
              f"--ordering {ordering}: card {t_card:.2f} s, --device cpu "
              f"{t_host:.2f} s (each parse, predict of 112 subjects and "
              f"the {n_rows}-line write); max|card - cpu| {err:.2e} "
              f"(limit 1e-4); card launches {counts}", flush=True)
        if not (np.isfinite(card).all() and err <= 1e-4):
            fail(f"predict ({ordering}): card and CPU disagree ({err:.2e}) "
                 "or non-finite predictions")
        if host_counts or not counts.get("normalize_adj_batch") or \
                counts.get("vectorize_colmajor", 0) != (ordering == "colmajor"):
            fail(f"predict ({ordering}) launched {counts} on the card, "
                 f"{host_counts} on the CPU")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
    return total


def run_gsr_example(work):
    """10c: the GSR example (`python -m fcsr_tpu_torch.examples.train_gsr
    --fast --splits 3 --epochs 2`, in process, on the teacher set), then
    `predict` on the gsr_net_trained.msgpack it wrote: the two
    submissions must agree. Returns the launch counts of both runs."""
    import importlib.util

    from fcsr_tpu_torch.examples import train_gsr
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    data_dir = os.path.join(work, "data")
    out_dir = os.path.join(work, "example_gsr")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = train_gsr.main(["--fast", "--splits", str(EXAMPLE_SPLITS),
                             "--epochs", str(EXAMPLE_EPOCHS), "--data-dir",
                             data_dir, "--out-dir", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _nonzero(launch_counts())
    steps = result["runner"].tr_idx.shape[1] * EXAMPLE_EPOCHS
    files = sorted(os.listdir(out_dir))
    want = ["gsr_net_trained.msgpack", "submission.csv"]
    if importlib.util.find_spec("matplotlib") is not None:
        want = sorted(want + ["loss.png"])
    print(f"  examples.train_gsr --fast --splits {EXAMPLE_SPLITS} --epochs "
          f"{EXAMPLE_EPOCHS}: {wall:.1f} s (train "
          f"{result['timings']['train']:.2f} s, {steps} fold-batched steps "
          f"in the JAX package's default (unfused) mode); fold MAEs "
          f"{result['fold_maes']}; wrote {files}; launches {counts}",
          flush=True)
    if files != want:
        fail(f"the GSR example wrote {files}, not {want}")
    if counts.get("adam_masked") != steps or \
            not counts.get("normalize_adj_batch"):
        fail(f"the GSR example launched {counts}: not one adam_masked per "
             f"step ({steps}) and normalize_adj_batch for its predictions")
    if not np.isfinite(result["fold_maes"]).all():
        fail("the GSR example's fold MAEs are not finite")

    n_rows = N_TEST * HR * (HR - 1) // 2
    out = os.path.join(work, "predict_example.csv")
    t_pred, pred_counts = _p10_predict(
        ["--params", os.path.join(out_dir, "gsr_net_trained.msgpack"),
         "--data-dir", data_dir, "--out", out], "cuda")
    example = os.path.join(out_dir, "submission.csv")
    with open(example, "rb") as f, open(out, "rb") as g:
        identical = f.read() == g.read()
    err = float(np.abs(_read_submission(out, n_rows).astype(np.float64)
                       - _read_submission(example, n_rows)).max())
    print(f"  predict --params <example>/gsr_net_trained.msgpack: "
          f"{t_pred:.2f} s; max|predict - example submission| {err:.2e}, "
          f"files identical: {identical}; launches {pred_counts}",
          flush=True)
    if err > 1e-6:
        fail("predict on the example's msgpack does not reproduce the "
             f"example's submission.csv ({err:.2e})")
    for k, c in pred_counts.items():
        counts[k] = counts.get(k, 0) + c
    return counts


def run_upsampler(dev, data):
    """10d: GraphSAGEUpsampler(64, 268, n_layers=2) over the 112 x 160 test
    stack (degree-normalized on the host, the GCN layers' ``a_norm``) on
    the card and on the CPU, from the same seeded weights."""
    from fcsr_tpu_torch.core.normalize import normalize_adj
    from fcsr_tpu_torch.models import GraphSAGEUpsampler

    a = normalize_adj(torch.from_numpy(np.ascontiguousarray(
        data["lr_test"])))
    runs = []
    for where in (dev, torch.device("cpu")):
        model = GraphSAGEUpsampler(UPSAMPLE_HIDDEN, HR,
                                   n_layers=UPSAMPLE_LAYERS,
                                   threshold=UPSAMPLE_THRESHOLD,
                                   device=where, seed=0)
        x = a.to(where)
        with torch.no_grad():
            logits, out = model.logits(x).cpu(), model(x).cpu()
            if where.type == "cuda":
                ms = cuda_ms(lambda: model(x), reps=10, rounds=3)
            else:
                ms = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    model(x)
                    ms.append(1e3 * (time.perf_counter() - t0))
                ms = min(ms)
        runs.append((logits, out, ms))
    (lc, oc, ms_card), (lh, oh, ms_host) = runs
    scale = float(lh.abs().max())
    err = float((lc - lh).abs().max())
    score = torch.sigmoid(lh)
    differ = oc != oh
    off = float((score[differ] - UPSAMPLE_THRESHOLD).abs().max()) \
        if bool(differ.any()) else 0.0
    print(f"  GraphSAGEUpsampler(hidden {UPSAMPLE_HIDDEN}, {UPSAMPLE_LAYERS} "
          f"layers, {LR} -> {HR}) over {tuple(a.shape)}: a forward "
          f"{ms_card:.3f} ms on the card (eager, CUDA events, median of 3 x "
          f"10 calls), {ms_host:.1f} ms on the CPU (least of 3); "
          f"max|card - cpu| logits "
          f"{err:.2e} of scale {scale:.3e} (limit 1e-4 of it); "
          f"{int(differ.sum())} thresholded entries differ, the farthest "
          f"{off:.2e} from {UPSAMPLE_THRESHOLD} (limit 1e-5); share kept "
          f"{float((oc > 0).float().mean()):.4f}, of the CPU's scores "
          f"within 1e-5 of the threshold "
          f"{float(((score - UPSAMPLE_THRESHOLD).abs() <= 1e-5).float().mean()):.2e}",
          flush=True)
    if not (tuple(oc.shape) == (N_TEST, HR, HR) and torch.isfinite(lc).all()
            and err <= 1e-4 * scale and off <= 1e-5):
        fail("GraphSAGEUpsampler: card and CPU disagree")
    if not bool(((oc == 0) | (oc > UPSAMPLE_THRESHOLD)).all()):
        fail("GraphSAGEUpsampler: an output survives below the threshold")


def check_lift_dataset():
    """10e: the lift dataset's sha256 against the CPU tests' pin."""
    import hashlib

    from fcsr_tpu_torch.data import load_or_synthesize

    t0 = time.perf_counter()
    data = load_or_synthesize(None, flavor="lift")
    t_draw = time.perf_counter() - t0
    h = hashlib.sha256()
    for name in ("lr_train", "hr_train", "lr_test"):
        arr = np.ascontiguousarray(data[name])
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(memoryview(arr).cast("B"))
    print(f"  lift dataset drawn in {t_draw:.2f} s: sha256 {h.hexdigest()} "
          f"(pinned {LIFT_SHA256})", flush=True)
    if h.hexdigest() != LIFT_SHA256:
        fail("the lift dataset differs from the one the CPU tests pin")


def run_phase10(dev, data, work):
    """Phase 10; returns the launch counts of its command-line runs."""
    t0 = time.perf_counter()
    check_msgpack_fixture()
    counts = run_predict_msgpack(work)
    for k, c in run_gsr_example(work).items():
        counts[k] = counts.get(k, 0) + c
    run_upsampler(dev, data)
    check_lift_dataset()
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 11: the fold-sharded trainers and the data-parallel steps
# ---------------------------------------------------------------------------

def _cli_json(argv):
    """``cli.main(argv)`` in process: (return code, its JSON report)."""
    import contextlib
    import io

    from fcsr_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("  | " + out.strip().replace("\n", "\n  | "), flush=True)
    return rc, json.loads(out.strip().splitlines()[0])


def run_multichip_cli(csv_dir, smi):
    """Phase 11 (a) and (c): `train gsr --multichip --fused` and `train gat
    --multichip --fused` (2 epochs, 3 folds; on this one-card machine the
    mesh is the card) against the same commands without --multichip: fold
    MAEs and submission.csv bit-equal. Returns the --multichip runs'
    launch counts."""
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    counts = {}
    for family in ("gsr", "gat"):
        runs = {}
        for flags in (["--fused"], ["--multichip", "--fused"]):
            out_dir = os.path.join(WORK_DIR, f"p11_{family}_{len(flags)}")
            reset_launch_counts()
            t0 = time.perf_counter()
            rc, report = _cli_json(["train", family, *flags,
                                    "--epochs", "2", "--splits", "3",
                                    "--data-dir", csv_dir, "--out-dir",
                                    out_dir])
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            c = _nonzero(launch_counts())
            if rc != 0:
                fail(f"`train {family} {' '.join(flags)}` returned {rc}")
            with open(os.path.join(out_dir, "submission.csv"), "rb") as f:
                runs[len(flags)] = (report["fold_maes"], f.read())
            print(f"  `train {family} {' '.join(flags)}` {t:.1f} s, "
                  f"launches {c} [{smi}]", flush=True)
            if len(flags) == 2:
                for k, n in c.items():
                    counts[k] = counts.get(k, 0) + n
        same_maes = runs[1][0] == runs[2][0]
        same_sub = runs[1][1] == runs[2][1]
        print(f"  {family}: --multichip fold MAEs {runs[2][0]} "
              f"{'==' if same_maes else '!='} {runs[1][0]}; submission.csv "
              f"{'identical' if same_sub else 'DIFFERS'}", flush=True)
        if not (same_maes and same_sub):
            fail(f"`train {family} --multichip --fused` differs from "
                 "`--fused` on the one-card mesh")
    return counts


def run_sharded_runner(dev, data, smi):
    """Phase 11 (b): the full-width fused_adam GSRFoldRunner (3 folds of the
    teacher set, 2 epochs) on a 3-shard (F = 1 a shard) and a 2-shard mesh
    (3 folds padded to 4) of the one card, against the unsharded F = 3 run:
    every shard's launches are planned for the 3 real folds
    (``ops.plan_folds``: the products' tile and split-K), so parameters,
    histories and val MAEs must be bit-equal. Returns the sharded runs'
    launch counts."""
    from fcsr_tpu_torch import GSRFoldRunner, GSRTrainConfig, kfold_indices
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.parallel import virtual_batch_mesh

    n = len(data["lr_train"])
    folds = kfold_indices(n, 3, seed=42)
    cfg = GSRTrainConfig(fused_adam=True, epochs=EPOCHS)
    runs, counts = {}, {}
    for shards in (None, 3, 2):
        mesh = None if shards is None else virtual_batch_mesh(shards, dev)
        runner = GSRFoldRunner(cfg, data["lr_train"], data["hr_train"],
                               folds, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        p, loss, err = runner.train()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        c = _nonzero(launch_counts())
        maes, _ = runner.evaluate()
        steps = runner.tr_idx.shape[1] * EPOCHS * len(runner.shards)
        if sum(c.values()) != STEP_LAUNCHES * steps:
            fail(f"sharded runner ({shards} shards): {sum(c.values())} "
                 f"launches in {steps} shard steps, not {STEP_LAUNCHES} each")
        runs[shards] = (p.cpu().numpy(), loss, err, maes)
        label = "unsharded F = 3" if shards is None else \
            f"{shards} shards x F = {runner.shards[0].n_folds}"
        print(f"  fused_adam runner, {label}: {t / EPOCHS:.3f} s/epoch "
              f"({1e3 * t / steps:.3f} ms a shard step; the epoch graphs, "
              f"{capture_note(runner)}), val MAE {maes.tolist()} [{smi}]",
              flush=True)
        runner.release_graphs()
        if shards is not None:
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
    for shards in (3, 2):
        d = [float(np.abs(a - b).max()) for a, b in zip(runs[None],
                                                         runs[shards])]
        print(f"  {shards} shards vs unsharded: max|d| params {d[0]:.3e}, "
              f"loss history {d[1]:.3e}, recon {d[2]:.3e}, val MAE "
              f"{d[3]:.3e} (bit-equal required)", flush=True)
        if max(d) != 0.0 or not np.isfinite(runs[shards][0]).all():
            fail(f"the {shards}-shard fused_adam runner is not bit-equal to "
                 "the unsharded run")
    return counts


def run_data_parallel_steps(dev, data, smi):
    """Phase 11 (d) and (e): make_sharded_batch_step (full-width GSR-Net,
    batch 8 on a 4-shard mesh of the card) under an NCCL process group of
    one process (maybe_initialize_distributed on 127.0.0.1), so the
    gradients' and the loss's all_reduce run on the card, and
    make_sharded_generic_step (MLP v2 at its published widths, batch 32 on
    2 shards; its BatchNorm moments all_reduced too), each against the
    single-device step from the same weights, 2 steps: parameters (and
    the running statistics) within 2e-5."""
    import socket

    import torch.distributed as dist

    from fcsr_tpu_torch.models.mlp import SpectralResMLP
    from fcsr_tpu_torch.parallel import (make_sharded_batch_step,
                                         make_sharded_generic_step,
                                         maybe_initialize_distributed,
                                         virtual_batch_mesh)
    from fcsr_tpu_torch.train import (GSRTrainConfig, gsr_composite_loss,
                                      init_gsr, precompute_spectral)
    from fcsr_tpu_torch.train.losses import (make_triu_mse_criterion,
                                             pack_triu_targets)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not maybe_initialize_distributed(f"127.0.0.1:{port}", 1, 0):
        fail("maybe_initialize_distributed did not start the group")
    try:
        lr = np.asarray(data["lr_train"][:8], np.float32)
        hr = np.asarray(data["hr_train"][:8], np.float32)
        u_lr, u_hr = (np.asarray(u, np.float32) for u in
                      precompute_spectral(lr, hr, lr_dim=LR))
        cfg = GSRTrainConfig()
        single, opt1 = init_gsr(cfg, seed=1, device=dev)
        model, opt2 = init_gsr(cfg, seed=1, device=dev)
        t = [torch.from_numpy(a).to(dev) for a in (lr, hr, u_lr, u_hr)]
        step = make_sharded_batch_step(model, opt2,
                                       virtual_batch_mesh(4, dev))
        ms_single, ms_sharded = [], []
        for _ in range(2):          # the first call of each starts up
            t0 = time.perf_counter()
            loss1 = 0.0
            for j in range(8):
                pred, net, start, _ = single(t[0][j], u_lr=t[2][j])
                loss1 = loss1 + gsr_composite_loss(
                    pred, net, start, single.layer.weights, t[3][j],
                    t[1][j], cfg.lmbda)[0] / 8
            opt1.zero_grad()
            loss1.backward()
            opt1.step()
            torch.cuda.synchronize()
            ms_single.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            loss2, _ = step(lr, hr, u_lr, u_hr)
            torch.cuda.synchronize()
            ms_sharded.append(1e3 * (time.perf_counter() - t0))
        d = max(max_err(a.detach(), b.detach()) for a, b in
                zip(single.parameters(), model.parameters()))
        dl = abs(float(loss1) - float(loss2))
        print(f"  make_sharded_batch_step, 4 shards x 2 subjects, NCCL "
              f"group of 1 ({dist.get_backend()}), 2 steps: loss "
              f"{float(loss2):.6f}, |d loss| {dl:.2e}, max|d param| {d:.2e} "
              f"(limit 2e-5); ms a step {[round(x, 1) for x in ms_sharded]}"
              f", single {[round(x, 1) for x in ms_single]} [{smi}]",
              flush=True)
        if not (d <= 2e-5 and dl <= 2e-5):
            fail("make_sharded_batch_step disagrees with the single step")

        r, c = np.triu_indices(LR, 1)
        x = np.ascontiguousarray(data["lr_train"][:32][:, r, c], np.float32)
        y = pack_triu_targets(data["hr_train"][:32]).astype(np.float32)
        crit = make_triu_mse_criterion(HR)
        mlp, twin = (SpectralResMLP(LR, HR, (LR + HR) // 2, 0,
                                    output="vector", device=dev, seed=5)
                     for _ in range(2))
        o1 = torch.optim.SGD(mlp.parameters(), lr=0.01)
        gstep = make_sharded_generic_step(
            twin, torch.optim.SGD(twin.parameters(), lr=0.01),
            virtual_batch_mesh(2, dev), crit)
        xs, ys = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        for _ in range(2):
            mlp.train()
            want = crit(mlp(xs), ys)
            o1.zero_grad()
            want.backward()
            o1.step()
            got = gstep(x, y)
        torch.cuda.synchronize()
        a = dict(mlp.named_parameters()) | dict(mlp.named_buffers())
        b = dict(twin.named_parameters()) | dict(twin.named_buffers())
        errs = {k: max_err(a[k].detach(), b[k].detach()) for k in a}
        worst = max(errs, key=errs.get)
        dl = abs(float(want) - float(got))
        print(f"  make_sharded_generic_step, MLP v2 {x.shape[1]} -> "
              f"{(LR + HR) // 2} -> {y.shape[1] - HR}, 2 steps of batch 32 "
              f"on 2 shards: |d loss| {dl:.2e}, max|d| {errs[worst]:.2e} "
              f"({worst}; running stats "
              f"{max(v for k, v in errs.items() if 'running' in k):.2e}) "
              f"(limit 2e-5) [{smi}]", flush=True)
        if not (max(errs.values()) <= 2e-5 and dl <= 2e-5):
            fail("make_sharded_generic_step disagrees with the single step")
    finally:
        dist.destroy_process_group()


def run_phase11(dev, data, csv_dir, smi):
    """Phase 11; returns the launch counts of its sharded runs."""
    t0 = time.perf_counter()
    counts = run_multichip_cli(csv_dir, smi)
    for k, c in run_sharded_runner(dev, data, smi).items():
        counts[k] = counts.get(k, 0) + c
    run_data_parallel_steps(dev, data, smi)
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 12: FCSR_MM_MODE=bf16, the single-pass bf16 products
# ---------------------------------------------------------------------------

# the launches of one GSR step in the bf16 mode
BF16_STEP_LAUNCHES = {"bgemm_bf16": 79, "rank_select_bf16": 4,
                      "gather_rows_bf16": 4, "scatter_rows_bf16": 4,
                      "pool_bwd_pair_bf16": 4, "add_bias_bf16": 1,
                      "tail_normalize": 1, "tail_normalize_bwd": 1,
                      "sym_abs_fill": 2, "sym_sign_grad": 2, "l1_term": 3,
                      "adam_masked": 1}
# kernels against plain in the bf16 step, relative to max(1, max|plain|):
# loss, recon, p', m', v'. The fp32 sums of a product take another order
# than the plain version's, and where a sum lands beside a bf16 rounding
# edge the next operand rounds the other way: a gradient entry moves by
# one bf16 step, m' (0.1 g) the most (2.3e-6 on the card's first run)
BF16_STEP_TOLS = (1e-5, 1e-5, 1e-6, 1e-4, 1e-5)


class mm_mode_set:
    """``core.mm_mode.MODE`` set to ``mode`` inside the block."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        from fcsr_tpu_torch.core import mm_mode
        self.old, mm_mode.MODE = mm_mode.MODE, self.mode

    def __exit__(self, *exc):
        from fcsr_tpu_torch.core import mm_mode
        mm_mode.MODE = self.old


def _bf16_library(op_a, op_b):
    """The library's bf16 product with an fp32 output,
    ``torch.bmm(a16, b16, out_dtype=torch.float32)``, on the fp32
    operands (the two casts included) and on operands cast before."""
    a16, b16 = op_a.to(torch.bfloat16), op_b.to(torch.bfloat16)
    return (lambda: torch.bmm(op_a.to(torch.bfloat16),
                              op_b.to(torch.bfloat16),
                              out_dtype=torch.float32),
            lambda: torch.bmm(a16, b16, out_dtype=torch.float32))


# FCSR_BGEMM_BF16_PARENT: a directory holding an earlier tree's
# bgemm_bf16.cu with the headers it includes, built beside this tree's
# kernel so that phase 12 times the two in turns in one call (unset: this
# tree's kernel alone)
PARENT_ENV = "FCSR_BGEMM_BF16_PARENT"
# the bf16 product's signature classes, in print order
BF16_CLASSES = ("dense", "matrix-vector", "column sum", "rank-1")


def parent_bgemm_bf16():
    """The earlier ``bgemm_bf16`` that ``FCSR_BGEMM_BF16_PARENT`` names,
    built with the port's nvcc flags into ``build/``, as a launcher with
    ``ops.bgemm_bf16``'s arguments (no launch count); None when the
    variable is unset."""
    import ctypes

    from fcsr_tpu_torch.kernels.build import NVCC_FLAGS, _nvcc
    from fcsr_tpu_torch.kernels.ops import KERNELS, _bgemm_args

    src = os.environ.get(PARENT_ENV)
    if not src:
        return None
    lib_path = os.path.join(HERE, "build", "libparent_bgemm_bf16.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib_path,
                           os.path.join(src, "bgemm_bf16.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"the parent bgemm_bf16 does not build:\n{proc.stdout[-3000:]}")
    fn = ctypes.CDLL(lib_path).fcsr_bgemm_bf16
    fn.argtypes = list(KERNELS["bgemm_bf16"].argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(a, b, ta=False, tb=False, bias=None, add=None, out=None,
               bias_operand=False):
        out, args = _bgemm_args(a, b, ta, tb, bias, add, out)
        err = fn(*args, 0, int(bias_operand and bias is not None),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"the parent bgemm_bf16 failed to launch: error {err}")
        return out
    print(f"  parent bgemm_bf16 built from {src}", flush=True)
    return launch


def bf16_class(prod) -> str:
    return ("column sum" if prod.ones else "matrix-vector"
            if min(prod.M, prod.N) == 1 else "rank-1" if prod.K <= 1
            else "dense")


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds to issue one call of ``fn`` (no synchronize
    inside the window; the queue drained before it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def check_bf16_product(prod, layout, g, dev, parent=None):
    """One census signature of the bf16 step replayed on the card:
    ``bgemm_bf16`` against its plain version (the exact products of the
    same bf16 values summed in fp32 in another order: within 1e-5 x
    max(scale, K)), two launches bit-equal, and on the dense path every
    (tile, split-K) plan the same way (without split-K the tiles bit-equal
    to each other, and to ``parent`` where given: each output sums the same
    k16 steps in the same order). Then its time beside the plain
    version's, the library's bf16 product with an fp32 output with and
    without the casts of the operands (the product alone: bias and add
    have no one-call form there) and ``parent``'s, in CUDA graphs timed in
    turns, and eager (CUDA events over eager calls) with the host's
    microseconds to issue a call. The pool logits' bias (N = 1) is a
    product's operand, rounded. Returns a dict of ms by column."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS_BF16 as K
    from fcsr_tpu_torch.kernels import PLAIN_OPS_BF16 as P
    from fcsr_tpu_torch.kernels.census import replay
    from fcsr_tpu_torch.kernels.ops import bgemm_bf16_forced, bgemm_bf16_tiles
    from fcsr_tpu_torch.utils.timing import graph_ms

    ta, tb, F_ = prod.ta, prod.tb, prod.F
    ops = replay(prod, layout, g, dev)
    a, b, bias, add, alias = (ops[k] for k in ("a", "b", "bias", "add",
                                                "alias"))
    bo = bias is not None and prod.N == 1

    def launch(acc=None, fn=K.bgemm):
        if alias:
            return fn(a, b, ta, tb, bias=bias, add=acc, out=acc,
                      bias_operand=bo)
        return fn(a, b, ta, tb, bias=bias, add=add, bias_operand=bo)

    def plain():
        return P.bgemm(a, b, ta, tb, bias=bias, add=add, bias_operand=bo)

    got = [launch(None if add is None else add.clone()) for _ in range(2)]
    want = plain()
    torch.cuda.synchronize()
    err = max_err(got[0], want)
    limit = 1e-5 * max(scale_of(want), float(prod.K))
    if not err <= limit:
        fail(f"bgemm_bf16 {prod.label()}: max|err| {err:.3e} above "
             f"{limit:.1e}")
    if not torch.equal(got[0], got[1]):
        fail(f"bgemm_bf16 {prod.label()}: two launches differ")
    plans = ""
    if bf16_class(prod) == "dense":
        unsplit = None
        worst = 0.0
        for t in range(len(bgemm_bf16_tiles())):
            for s in (1, 2, 4):
                runs = [bgemm_bf16_forced(t, s, a, b, ta, tb, bias=bias,
                                          add=add) for _ in range(2)]
                torch.cuda.synchronize()
                e = max_err(runs[0], want)
                worst = max(worst, e)
                if not (e <= limit and torch.equal(runs[0], runs[1])):
                    fail(f"bgemm_bf16 {prod.label()} plan {t}/{s}: max|err| "
                         f"{e:.3e} (limit {limit:.1e}) or two launches "
                         "differ")
                if s == 1:
                    unsplit = runs[0] if unsplit is None else unsplit
                    if not torch.equal(runs[0], unsplit):
                        fail(f"bgemm_bf16 {prod.label()}: tile {t} without "
                             "split-K differs from tile 0")
        plans = f", every plan within {worst:.2e}"
        if parent is not None:
            same = torch.equal(launch(None if add is None else add.clone(),
                                      parent), unsplit)
            plans += (", split 1 bit-equal to the parent" if same else
                      ", split 1 NOT bit-equal to the parent")
    op_a = torch.ones(F_, 1, prod.K, device=dev) if a is None else (
        a.transpose(1, 2) if ta else a)
    op_b = b.transpose(1, 2) if tb else b
    lib_cast, lib = _bf16_library(op_a, op_b)
    acc = None if add is None else add.clone()
    fns = {"kernel": lambda: launch(acc), "plain": plain,
           "library": lib_cast, "library_no_casts": lib}
    if parent is not None:
        acc_p = None if add is None else add.clone()
        fns["parent"] = lambda: launch(acc_p, parent)
    t = dict(zip(fns, graph_ms(list(fns.values()))))
    t["eager"] = cuda_ms(fns["kernel"])
    t["host_us"] = host_us(fns["kernel"])
    if parent is not None:
        t["parent_eager"] = cuda_ms(fns["parent"])
        t["parent_host_us"] = host_us(fns["parent"])
    t["bound"], b_by = bound(prod.flops, prod.nbytes,
                             peak_flops=PEAK_BF16_FLOPS)
    par = (f", parent {t['parent']:.4f} (eager {t['parent_eager']:.4f})"
           if parent is not None else "")
    print(f"    bgemm_bf16 {prod.label():34s} kernel {t['kernel']:.4f} ms "
          f"(eager {t['eager']:.4f}, host {t['host_us']:.1f} us){par}, "
          f"plain {t['plain']:.4f}, library {t['library']:.4f} with the "
          f"casts / {t['library_no_casts']:.4f} without, bound "
          f"{t['bound']:.5f} ms ({b_by}), max|err| {err:.2e}, bit-equal"
          f"{plans}", flush=True)
    return t


def check_bf16_products(dev, smi):
    """Phase 12 (a), the product: every distinct signature of the
    full-width GSR step's census in the bf16 mode (79 launches: the dense
    products, the column sums, the pool logits' matrix-vector products and
    their rank-1 adjoints) by ``check_bf16_product`` (every plan of the
    dense ones; the parent kernel of ``FCSR_BGEMM_BF16_PARENT`` timed in
    the same turns where given), summed over the step's launches by class;
    then the record: 268 x 268 x 268 + bias at F = 3. Returns the JSON
    record of ``bgemm_bf16``."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS_BF16 as K
    from fcsr_tpu_torch.kernels import PLAIN_OPS_BF16 as P
    from fcsr_tpu_torch.kernels.census import gsr_step_census
    from fcsr_tpu_torch.kernels.ops import bgemm_bf16_path
    from fcsr_tpu_torch.utils.timing import graph_ms

    census = gsr_step_census(dev, ops=K)
    sigs = census.signatures()
    print(f"  bgemm_bf16 over the bf16 GSR step's census: "
          f"{len(census.products)} launches, {len(sigs)} signatures, "
          f"{census.flops / 1e9:.4f} GFLOP [{smi}]", flush=True)
    if len(census.products) != BF16_STEP_LAUNCHES["bgemm_bf16"]:
        fail(f"the bf16 step has {len(census.products)} products")
    parent = parent_bgemm_bf16()
    g = torch.Generator(device=dev).manual_seed(3)
    sums, by_class = {}, {}
    for prod, n in sigs.items():
        t = check_bf16_product(prod, census.layouts[prod], g, dev, parent)
        row = by_class.setdefault(bf16_class(prod), {"launches": 0})
        row["launches"] += n
        for k, v in t.items():
            sums[k] = sums.get(k, 0.0) + n * v
            row[k] = row.get(k, 0.0) + n * v

    def line(t):
        par = (f", parent {t['parent']:.4f} (eager {t['parent_eager']:.4f}, "
               f"host {t['parent_host_us']:.1f} us)" if "parent" in t else "")
        return (f"kernel {t['kernel']:.4f} ms (eager {t['eager']:.4f}, host "
                f"{t['host_us']:.1f} us){par}, plain {t['plain']:.4f}, "
                f"library {t['library']:.4f} / {t['library_no_casts']:.4f} "
                f"(with / without the casts), bound {t['bound']:.5f} ms")
    for cls in BF16_CLASSES:
        print(f"  bgemm_bf16 {cls}: {by_class[cls]['launches']} launches, "
              f"{line(by_class[cls])}", flush=True)
    print(f"  bf16 GSR step: bgemm_bf16 over its {len(census.products)} "
          f"launches: {line(sums)} [{smi}]", flush=True)
    if parent is not None and not (by_class["dense"]["kernel"]
                                   < by_class["dense"]["parent"]):
        print("  NOTE: the dense class is not faster than the parent's",
              flush=True)

    gen = torch.Generator(device="cpu").manual_seed(0)
    a, b = (torch.randn(F, HR, HR, generator=gen).to(dev) for _ in range(2))
    bias = torch.randn(F, 1, HR, generator=gen).to(dev)
    got, want = K.bgemm(a, b, bias=bias), P.bgemm(a, b, bias=bias)
    err = max_err(got, want)
    if not err <= 1e-5 * max(scale_of(want), HR):
        fail(f"bgemm_bf16 {HR}^3: max|err| {err:.3e}")
    lib_cast, lib = _bf16_library(a, b)
    ms, plain_ms, lc_ms, l_ms = graph_ms([
        lambda: K.bgemm(a, b, bias=bias), lambda: P.bgemm(a, b, bias=bias),
        lib_cast, lib])
    b_ms, b_by = bound(2.0 * F * HR ** 3, 4.0 * F * (3 * HR * HR + HR),
                       peak_flops=PEAK_BF16_FLOPS)
    path = bgemm_bf16_path(a, b, bias=bias)
    print(f"  bgemm_bf16 record {HR}^3 + bias ({path}): {ms:.4f} ms, plain "
          f"{plain_ms:.4f}, library {lc_ms:.4f} / "
          f"{l_ms:.4f} (with / without the casts), bound {b_ms:.5f} ms "
          f"({b_by}), max|err| {err:.2e} [{smi}]", flush=True)
    dense = by_class["dense"]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lc_ms,
            "library_ms_no_casts": l_ms, "gsr_step_ms": sums["kernel"],
            "gsr_step_plain_ms": sums["plain"],
            "gsr_step_library_ms": sums["library"],
            "gsr_step_bound_ms": sums["bound"],
            "gsr_step_dense_ms": dense["kernel"],
            "gsr_step_dense_parent_ms": dense.get("parent"),
            "gsr_step_parent_ms": sums.get("parent"),
            "signatures": len(sigs)}


def check_bf16_variants(dev, smi):
    """Phase 12 (a), the rounding instances: at every GSR pool (F = 3,
    ties and a NaN score) ``rank_select_bf16`` (every output exact, NaN
    where NaN), ``gather_rows_bf16`` and ``scatter_rows_bf16`` exact,
    ``pool_bwd_pair_bf16`` and its autodiff-shaped instance
    ``pool_bwd_pair_bf16_ad`` (g_d exact, the logits' adjoint within 1e-5:
    its dot sums the products in another order), each bit-equal over
    two launches; ``add_bias_bf16`` on the step's views exact. Times at
    the first pool. Returns their JSON records."""
    from fcsr_tpu_torch.kernels import KERNEL_OPS_BF16 as K
    from fcsr_tpu_torch.kernels import PLAIN_OPS_BF16 as P
    from fcsr_tpu_torch.models.fused_step import FlatLayout
    from fcsr_tpu_torch.utils.timing import graph_ms

    gen = torch.Generator(device="cpu").manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    f4, m = 4.0 * F, HR
    records = {}
    for level, (n, k, cols, div) in enumerate(GSR_POOLS):
        logits = rnd(F, n, scale=100.0)
        logits[:, 2:8] = logits[:, 9:10]              # a 6-way tie
        logits[1, 7] = float("nan")
        d, gx, skip = rnd(F, n, m), rnd(F, n, m), rnd(F, n, m)
        gp, pre = rnd(F, k, m), rnd(F, k, m)
        s, idx, vals, slot = K.rank_select(logits, k)
        cases = [
            ("rank_select_bf16", lambda: K.rank_select(logits, k, src=d),
             lambda: P.rank_select(logits, k, src=d), 0.0,
             float(F * (n * n + k * m)), f4 * (3 * n + 2 * k + 3 * k * m)),
            ("gather_rows_bf16", lambda: K.gather_rows(gx, idx),
             lambda: P.gather_rows(gx, idx), 0.0,
             float(F * k * m), f4 * (2 * k * m + k)),
            ("scatter_rows_bf16", lambda: K.scatter_rows(gp, slot),
             lambda: P.scatter_rows(gp, slot), 0.0,
             float(F * k * m), f4 * (k * m + n * m + n)),
            ("pool_bwd_pair_bf16",
             lambda: K.pool_bwd_pair(gp, pre, slot, s, vals, skip),
             lambda: P.pool_bwd_pair(gp, pre, slot, s, vals, skip),
             (0.0, 1e-5), 2.0 * F * (2 * k * m + n * m),
             f4 * (2 * k * m + 2 * n * m + 3 * n + k)),
            ("pool_bwd_pair_bf16_ad",
             lambda: K.pool_bwd_pair_ad(gp, pre, slot, s, vals, skip),
             lambda: P.pool_bwd_pair_ad(gp, pre, slot, s, vals, skip),
             (0.0, 1e-5), 2.0 * F * (2 * k * m + n * m),
             f4 * (2 * k * m + 2 * n * m + 3 * n + k))]
        for name, kern, plain, tol, flops, nbytes in cases:
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            if not all(_same(x, y, bits=True) for x, y in zip(
                    got if isinstance(got, tuple) else (got,),
                    again if isinstance(again, tuple) else (again,))):
                fail(f"{name} at pool {level}: two launches differ")
            if isinstance(tol, tuple):     # NaN where a score is NaN
                errs = [_nan_aware_err(x, y) for x, y in zip(got, want)]
                ok = all(e <= t * scale_of(y[~torch.isnan(y)]) for e, t, y
                         in zip(errs, tol, want))
                err = max(errs)
            elif isinstance(got, tuple):
                err = max(_nan_aware_err(x, y) for x, y in zip(got, want))
                ok = all(_same(x, y) for x, y in zip(got, want))
            else:
                err = max_err(got, want)
                ok = err == 0.0
            if not ok:
                fail(f"{name} at pool {level} ({n} -> {k}) disagrees with "
                     f"its plain version (max|err| {err:.3e})")
            if level == 0:
                ms, plain_ms = graph_ms([kern, plain])
                b_ms, b_by = bound(flops, nbytes)
                records[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "library_ms": None}
                print(f"  {name:20s} pool 0 ({n} -> {k} x {m}): max|err| "
                      f"{err:.2e}, kernel {ms:.4f} ms, plain {plain_ms:.4f}"
                      f", bound {b_ms:.5f} ms ({b_by}) [{smi}]", flush=True)
        print(f"  bf16 pool {level} ({n} -> {k}): the four kernels agree "
              "with their plain versions, bit-equal run to run", flush=True)
    layout = FlatLayout(LR, HR, len(KS))
    leaves = layout.views(rnd(F, layout.size))
    w, bb = leaves["w:start_gcn"], leaves["b:start_gcn"]
    got, want = K.add_bias(w, bb), P.add_bias(w, bb)
    err = max_err(got, want)
    if err != 0.0 or not torch.equal(got, K.add_bias(w, bb)):
        fail(f"add_bias_bf16 disagrees with its plain version ({err:.3e})")
    ms, plain_ms = graph_ms([lambda: K.add_bias(w, bb),
                             lambda: P.add_bias(w, bb)])
    b_ms, b_by = bound(float(F * LR * m), f4 * (2 * LR * m + m))
    records["add_bias_bf16"] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": None}
    print(f"  add_bias_bf16 ({LR} x {m}, the step's views): exact, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f}, bound {b_ms:.5f} ms ({b_by})"
          f" [{smi}]", flush=True)
    return records


def check_bf16_step(dev, step_args, smi):
    """Phase 12 (b): one full-width fold-batched step (F = 3, phase 3's
    state, one fold masked) in the bf16 mode on the kernels against the
    same step on the plain versions; its launches (106: 79 ``bgemm_bf16``,
    the pool, row and bias kernels' bf16 instances, the tail's and Adam's
    kernels as in fp32); the masked fold's state bit-unchanged; the bf16
    and the fp32 step as CUDA graphs timed in turns (fp32, bf16, bf16,
    fp32), the bf16 step eager and profiled (device time by kernel into
    ``profile_step_bf16.txt`` in ``OUT_DIR``). Returns the bf16 step's
    device ms."""
    from fcsr_tpu_torch.kernels import (KERNEL_OPS_BF16, launch_counts,
                                        reset_launch_counts)
    from fcsr_tpu_torch.kernels.census import census_of
    from fcsr_tpu_torch.models.fused_step import (step_with_ops,
                                                  train_step_fused,
                                                  train_step_plain)
    from fcsr_tpu_torch.utils.timing import graph_ms

    p, m, v = step_args[:3]
    with mm_mode_set("bf16"):
        reset_launch_counts()
        got = train_step_fused(*step_args, device=dev)
        torch.cuda.synchronize()
        launched = _nonzero(launch_counts())
        want = train_step_plain(*step_args)
    f32 = train_step_fused(*step_args, device=dev)
    torch.cuda.synchronize()
    names = ("loss", "recon", "p'", "m'", "v'")
    for name, a, b, c, tol in zip(names, got, want, f32, BF16_STEP_TOLS):
        err, limit = max_err(a, b), tol * scale_of(b)
        print(f"  bf16 step {name:5s} kernels vs plain max|err| {err:.3e} "
              f"(limit {limit:.1e}); bf16 vs fp32 kernels "
              f"{max_err(a, c):.3e}", flush=True)
        if not err <= limit:
            fail(f"full-width bf16 step: {name} disagrees with the plain "
                 "path")
    masked = step_args[6][:, 0] == 0
    for a, b in ((got[2], p), (got[3], m), (got[4], v)):
        if not torch.equal(a[masked], b[masked]):
            fail("bf16 step: the masked fold's state changed")
    census = census_of(lambda ops: step_with_ops(ops, *step_args, 0.9,
                                                 0.999, 1e-8),
                       KERNEL_OPS_BF16)
    if launched != BF16_STEP_LAUNCHES or census.launches != {
            "bgemm" if k == "bgemm_bf16" else k.replace("_bf16", ""): c
            for k, c in BF16_STEP_LAUNCHES.items()}:
        fail(f"the bf16 step launches {launched} (census "
             f"{census.launches}), not {BF16_STEP_LAUNCHES}")

    def step32():
        return train_step_fused(*step_args, device=dev)

    def step16():
        with mm_mode_set("bf16"):
            return train_step_fused(*step_args, device=dev)

    a32, a16, b16, b32 = graph_ms([step32, step16, step16, step32], reps=5)
    with mm_mode_set("bf16"):
        eager = cuda_ms(step16, reps=5)
        profile_steps(step16, eager, os.path.join(OUT_DIR,
                                                  "profile_step_bf16.txt"))
    b_ms, b_by = bound(census.flops, census.bytes)
    print(f"  bf16 step: {sum(launched.values())} launches {launched}; "
          f"{census.flops / 1e9:.4f} GFLOP, {census.bytes / 1e6:.2f} MB; "
          f"device {a16:.4f} / {b16:.4f} ms as one CUDA graph (fp32 step "
          f"{a32:.4f} / {b32:.4f} in the same turns), eager {eager:.3f} ms; "
          f"loss {got[0].tolist()} [{smi}]", flush=True)
    return (a16 + b16) / 2


def _ad_entry_points(dev, leaves, data, ks, lr, hr_dim, ct):
    """(net, start, #5's gradients, loss, recon, #10's gradients) of
    ``unet_fused`` and ``step_value_and_grad_fused`` in the bf16 mode on
    ``dev``, from the leaf mapping ``leaves`` (F-batched), the step's data
    (u_lr, u_hr, hr) and the U-Net's cotangents ``ct``; and the launches
    of each."""
    from fcsr_tpu_torch.iox.weights import (leaf_names,
                                            leaf_tensors_to_state,
                                            state_to_leaf_tensors)
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.models import fused_step as fs

    net_names = leaf_names(len(ks), tail=False)
    with mm_mode_set("bf16"):
        P = {k: t.detach().clone().requires_grad_() for k, t in
             leaves.items()}
        reset_launch_counts()
        net, start = fs.unet_fused({k: P[k] for k in net_names}, ks, lr,
                                   hr_dim, device=dev)
        g5 = torch.autograd.grad((net, start), [P[k] for k in net_names], ct)
        c5 = _nonzero(launch_counts())
        state = leaf_tensors_to_state({k: t.detach() for k, t in
                                       leaves.items()})
        reset_launch_counts()
        loss, recon, gr = fs.step_value_and_grad_fused(
            state, *data, ks, lr, hr_dim, hr_dim, 16.0, device=dev)
        c10 = _nonzero(launch_counts())
        gl = state_to_leaf_tensors(gr)
        g10 = [gl[k].reshape(leaves[k].shape) for k in leaf_names(len(ks))]
    return (net.detach(), start.detach(), g5, loss, recon, g10), (c5, c10)


def _rel(got, want) -> float:
    """max |got - want| / max |want| over pairs of tensors (of their own
    scale each)."""
    return max(max_err(a.detach().cpu(), b.detach().cpu())
               / max(float(b.detach().abs().max()), 1e-12)
               for a, b in zip(got, want))


def check_bf16_ad_entry_points(dev, step_args, smi):
    """Phase 12 (b2): ``unet_fused`` (#5) and ``step_value_and_grad_fused``
    (#10) in the bf16 mode, whose backward is ``unet_backward(ad=True)``
    (the adjoints rounded where the JAX kernels' autodiff rounds them).
    At the CPU tests' size (20 -> 32, ks (0.9, 0.7), F = 2, seeded
    weights) the kernels against the same entry points on the CPU (their
    plain versions, held to the JAX package's autodiff in
    ``tests/test_torch_bf16_step.py``): values and gradients within 1e-5
    of their scale. At full width (F = 3, phase 3's weights) their
    distance to autograd over the plain bf16 version
    (``unet_forward_rankselect`` and ``step_loss_pure`` under the mode:
    ``mm_mode.mm``'s ideal adjoints, ``round_through``) is printed beside
    the hand-written adjoints' (``unet_fused_fwdbwd``,
    ``gsr_step_loss_fused``) and held only to be finite: there the
    kernels' fp32 sums take other orders than cuBLAS's, and where one
    lands beside a bf16 rounding edge the next product's operand rounds
    the other way (2^-8 of a term), which moves #10's gradients by up to
    2e-2 of a leaf's largest entry (PERF.md). Each backward launches
    ``pool_bwd_pair_bf16_ad`` once a level and the fp32 column sums
    (``bgemm_f32``, a = None) for the biases. Returns the launch
    counts."""
    from fcsr_tpu_torch.iox.weights import leaf_names
    from fcsr_tpu_torch.models import fused_step as fs

    counts = {}

    def count(what, c, levels):
        print(f"  {what} bf16 launches: {c}", flush=True)
        if c.get("pool_bwd_pair_bf16_ad") != levels or not c.get(
                "bgemm_f32") or c.get("pool_bwd_pair_bf16"):
            fail(f"{what} in the bf16 mode did not take the autodiff-shaped "
                 "adjoints")
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n

    # the CPU tests' size: the card against the CPU
    n, m, ks, f2 = 20, 32, (0.9, 0.7), 2
    rng = np.random.default_rng(12)
    layout = fs.FlatLayout(n, m, len(ks))
    flat = torch.from_numpy(rng.normal(0, 0.2, (f2, layout.size)).astype(
        np.float32))
    data = [torch.from_numpy(rng.normal(0, s_, shape).astype(np.float32))
            for s_, shape in ((0.3, (f2, n, n)), (0.3, (f2, m, n)),
                              (1.0, (f2, m, m)))]
    ct = [torch.from_numpy(rng.normal(size=(f2, n, m)).astype(np.float32))
          for _ in range(2)]
    (want, _), (got, c) = (_ad_entry_points(
        d, layout.views(flat.to(d)), [t.to(d) for t in data], ks, n, m,
        tuple(t.to(d) for t in ct)) for d in (torch.device("cpu"), dev))
    for what, ci in zip(("unet_fused", "step_value_and_grad_fused"), c):
        count(what, ci, len(ks))
    for what, sl in (("unet_fused", slice(0, 3)),
                     ("step_value_and_grad_fused", slice(3, 6))):
        pairs = [(a, b) for x, y in zip(got[sl], want[sl])
                 for a, b in (zip(x, y) if isinstance(x, (list, tuple))
                              else [(x, y)])]
        err = _rel(*zip(*pairs))
        print(f"  {what} (bf16, autodiff-shaped adjoints) at 20 -> 32, F = "
              f"2: card vs CPU {err:.2e} of the scale (limit 1e-5) "
              f"[{smi}]", flush=True)
        if not err <= 1e-5:
            fail(f"{what} in the bf16 mode: the card disagrees with the CPU")

    # full width: against autograd over the plain bf16 version
    p, _, _, u_lr, u_hr, hr = step_args[:6]
    layout = fs.FlatLayout(LR, HR, len(KS))
    names = leaf_names(len(KS))
    net_names = leaf_names(len(KS), tail=False)
    g = torch.Generator(device="cpu").manual_seed(8)
    ct = tuple(torch.randn(F, LR, HR, generator=g).to(dev) for _ in range(2))
    got, c = _ad_entry_points(dev, layout.views(p), (u_lr, u_hr, hr), KS,
                              LR, HR, ct)
    for what, ci in zip(("unet_fused", "step_value_and_grad_fused"), c):
        count(what, ci, len(KS))
    with mm_mode_set("bf16"):
        Q = {k: t.requires_grad_() for k, t in layout.views(p.clone()).items()}
        want5 = fs.unet_forward_rankselect(Q, KS, LR)
        g5 = torch.autograd.grad(want5, [Q[k] for k in net_names], ct)
        hand = fs.unet_fused_fwdbwd({k: Q[k] for k in net_names}, KS, LR, HR,
                                    device=dev)
        g7 = torch.autograd.grad(hand, [Q[k] for k in net_names], ct)
        loss_p, recon_p = fs.step_loss_pure(Q, None, hr, u_lr, u_hr, KS, LR,
                                            16.0)
        g10 = torch.autograd.grad(loss_p.sum(), [Q[k] for k in names])
        loss8, _ = fs.gsr_step_loss_fused(
            {k: Q[k] for k in net_names}, Q["layer.weights"],
            Q["gc1.weight"], Q["gc2.weight"], u_lr, u_hr, hr, KS, LR, HR,
            16.0, device=dev)
        g8 = torch.autograd.grad(loss8.sum(), [Q[k] for k in names])
    for what, vals, want, grads, gwant, ref, ref_name in (
            ("unet_fused", got[:2], want5, got[2], g5, g7,
             "unet_fused_fwdbwd"),
            ("step_value_and_grad_fused", got[3:5], (loss_p, recon_p),
             got[5], g10, g8, "gsr_step_loss_fused")):
        err, g_err = _rel(vals, want), _rel(grads, gwant)
        print(f"  {what} (bf16) at full width vs autograd over the plain "
              f"bf16 version: values {err:.2e}, gradients {g_err:.2e} of a "
              f"leaf's largest entry; the hand-written adjoints ({ref_name})"
              f" {_rel(ref, gwant):.2e} [{smi}]", flush=True)
        if not all(bool(torch.isfinite(t).all()) for t in
                   list(vals) + list(grads)):
            fail(f"{what} in the bf16 mode: non-finite values or gradients")
    return counts


def _kernel_name(name: str) -> str:
    """A trace's kernel name without its namespaces, arguments and
    template arguments: the kernel's function."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].strip()


def graph_trace_summary(path, first="add_bias_kernel", label=None):
    """The kernels of a chrome trace of CUDA graph replays of the GSR
    step (``step_graph_gaps`` writes them): split into replays at each
    launch of ``first`` (the step's first kernel) and kept whole where a
    replay has the most common kernel count; per replay the device span
    from its first kernel's start to its last one's end, the kernels'
    summed time and the gaps between them; per kernel function (templates
    merged) its time and the gaps before it. Prints medians over the
    replays and returns (span, kernels, gaps, {function: (us, gap us,
    launches)}). Reads only the file, so it also runs on the CPU over a
    trace an earlier card run left."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = sorted((e for e in events if e.get("cat") == "kernel"),
                  key=lambda e: e["ts"])
    starts = [i for i, e in enumerate(kern) if first in e["name"]]
    reps = [kern[i:j] for i, j in zip(starts, starts[1:] + [len(kern)])]
    if not reps:
        print(f"  {path}: no replay found", flush=True)
        return None
    n = statistics.mode(len(r) for r in reps)
    reps = [r for r in reps if len(r) == n]
    med = statistics.median
    spans, busy, gaps, by_fn = [], [], [], {}
    for r, ks in enumerate(reps):
        spans.append(ks[-1]["ts"] + ks[-1]["dur"] - ks[0]["ts"])
        busy.append(sum(e["dur"] for e in ks))
        gs = [0.0] + [max(0.0, b["ts"] - (a["ts"] + a["dur"]))
                      for a, b in zip(ks, ks[1:])]
        gaps.append(sum(gs))
        for e, gap in zip(ks, gs):
            row = by_fn.setdefault(_kernel_name(e["name"]),
                                   [[0.0, 0.0, 0] for _ in reps])[r]
            row[0] += e["dur"]
            row[1] += gap
            row[2] += 1
    table = {k: (med([x[0] for x in v]), med([x[1] for x in v]), v[0][2])
             for k, v in by_fn.items()}
    print(f"  {label or path}: {len(reps)} whole replays of {n} kernels; "
          f"span {med(spans):.1f} us, kernels {med(busy):.1f} us, gaps "
          f"{med(gaps):.1f} us (medians)", flush=True)
    for k, (us, gap, cnt) in sorted(table.items(), key=lambda x: -x[1][0]):
        print(f"    {k[:40]:40s} {us:7.1f} us in {cnt:3d} launches, gaps "
              f"before them {gap:5.1f} us", flush=True)
    return med(spans), med(busy), med(gaps), table


def step_graph_gaps(dev, data, smi, tag=""):
    """The fp32 and the bf16 GSR step (``step_inputs``) each captured as one
    CUDA graph and replayed 5 times under torch.profiler; each chrome trace
    (``trace_step_<mode><tag>.json`` in ``OUT_DIR``) read by
    ``graph_trace_summary``: span, kernels and the gaps between them, by
    kernel function. Calls only public entry points, so it also runs
    against an older tree of the port (``tag`` names its traces).
    Returns {mode: summary}."""
    from torch.profiler import ProfilerActivity, profile

    from fcsr_tpu_torch.models.fused_step import train_step_fused

    args = step_inputs(dev, data)
    out = {}
    for label, mode in (("fp32", "bf16x3_concat"), ("bf16", "bf16")):
        with mm_mode_set(mode):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    train_step_fused(*args, device=dev)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                train_step_fused(*args, device=dev)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                graph.replay()
            torch.cuda.synchronize()
        path = os.path.join(OUT_DIR, f"trace_step_{label}{tag}.json")
        prof.export_chrome_trace(path)
        out[label] = graph_trace_summary(
            path, label=f"{label} step as one CUDA graph{tag} [{smi}]")
    return out


def run_bf16_runner(dev, data, smi):
    """Phase 12 (c), the bf16 mode's main path: the full-width
    ``fused_adam`` GSRFoldRunner (3 folds of the teacher set, 2 epochs) in
    fp32 and in bf16 from the same weights, then ``fused_step`` and a
    3-shard mesh of the card in bf16, which must be bit-equal to the bf16
    ``fused_adam`` run; s/epoch and val MAE beside the untrained MAE.
    Every bf16 kernel must launch in the bf16 ``fused_adam`` run (106 a
    step). Returns the bf16 runs' launch counts and the MAEs."""
    from fcsr_tpu_torch import GSRFoldRunner, GSRTrainConfig, kfold_indices
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.parallel import virtual_batch_mesh

    folds = kfold_indices(len(data["lr_train"]), 3, seed=42)
    runs, counts, untrained = {}, {}, None
    for label, mode, kw, shards in (
            ("fp32 fused_adam", "bf16x3_concat", dict(fused_adam=True), None),
            ("bf16 fused_adam", "bf16", dict(fused_adam=True), None),
            ("bf16 fused_step", "bf16", dict(fused_step=True), None),
            ("bf16 fused_adam, 3 shards", "bf16", dict(fused_adam=True), 3)):
        with mm_mode_set(mode):
            runner = GSRFoldRunner(
                GSRTrainConfig(epochs=EPOCHS, **kw), data["lr_train"],
                data["hr_train"], folds, device=dev,
                mesh=None if shards is None else virtual_batch_mesh(shards,
                                                                    dev))
            if untrained is None:
                untrained, _ = runner.evaluate(runner.flat0)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            p, loss, err = runner.train()
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            c = _nonzero(launch_counts())
            maes, _ = runner.evaluate()
        steps = runner.tr_idx.shape[1] * EPOCHS * len(runner.shards)
        runs[label] = (p.cpu().numpy(), loss, err, maes)
        print(f"  {label}: {t / EPOCHS:.3f} s/epoch ({1e3 * t / steps:.3f} "
              f"ms a step), val MAE {maes.tolist()}, {sum(c.values())} "
              f"launches [{smi}]", flush=True)
        if not (np.isfinite(loss).all() and np.isfinite(maes).all()):
            fail(f"{label}: non-finite loss or MAE")
        if mode == "bf16":
            if sum(c.values()) != STEP_LAUNCHES * steps:
                fail(f"{label}: {sum(c.values())} launches in {steps} "
                     f"steps, not {STEP_LAUNCHES} each")
            for k, n in c.items():
                counts[k] = counts.get(k, 0) + n
        if label == "bf16 fused_adam":
            missing = [k for k in BF16_KERNELS if not c.get(k)]
            if missing or c.get("bgemm_f32"):
                fail(f"the bf16 main path launched {c}")
    base = runs["bf16 fused_adam"]
    for label in ("bf16 fused_step", "bf16 fused_adam, 3 shards"):
        d = max(float(np.abs(a - b).max()) for a, b in zip(base,
                                                           runs[label]))
        print(f"  {label} vs bf16 fused_adam: max|d| {d:.3e} (bit-equal "
              "required)", flush=True)
        if d != 0.0:
            fail(f"{label} is not bit-equal to bf16 fused_adam")
    m32, m16, m0 = (float(np.mean(x)) for x in (
        runs["fp32 fused_adam"][3], base[3], untrained))
    print(f"  val MAE after {EPOCHS} epochs: fp32 {m32:.6f}, bf16 {m16:.6f} "
          f"({m16 / m32 - 1:+.3%}), untrained {m0:.6f} [{smi}]", flush=True)
    if not m16 < m0:
        fail("the bf16 runner did not train")
    return counts


def run_bf16_cli(csv_dir, smi):
    """Phase 12 (d): ``FCSR_MM_MODE=bf16 python -m fcsr_tpu_torch train gsr
    --fused`` (2 epochs, 3 folds, phase 5's CSVs) in a subprocess, against
    the same command in process with ``mm_mode.MODE = "bf16"``: fold MAEs
    and submission.csv bit-equal. Returns the in-process run's launch
    counts."""
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    argv = ["train", "gsr", "--fused", "--epochs", "2", "--splits", "3",
            "--data-dir", csv_dir]
    sub_dir = os.path.join(WORK_DIR, "p12_cli_env")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fcsr_tpu_torch", *argv, "--out-dir",
         sub_dir], cwd=HERE, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, FCSR_MM_MODE="bf16"))
    t_sub = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
        fail(f"`FCSR_MM_MODE=bf16 python -m fcsr_tpu_torch train gsr "
             f"--fused` returned {proc.returncode}")
    sub = json.loads(proc.stdout.strip().splitlines()[0])
    in_dir = os.path.join(WORK_DIR, "p12_cli_in")
    with mm_mode_set("bf16"):
        reset_launch_counts()
        t0 = time.perf_counter()
        rc, report = _cli_json(argv + ["--out-dir", in_dir])
        torch.cuda.synchronize()
        t_in = time.perf_counter() - t0
        counts = _nonzero(launch_counts())
    if rc != 0:
        fail(f"`train gsr --fused` in the bf16 mode returned {rc}")
    same = []
    for d in (sub_dir, in_dir):
        with open(os.path.join(d, "submission.csv"), "rb") as f:
            same.append(f.read())
    print(f"  `FCSR_MM_MODE=bf16 python -m fcsr_tpu_torch train gsr --fused` "
          f"{t_sub:.1f} s (a process of its own), in process {t_in:.1f} s; "
          f"fold MAEs {sub['fold_maes']} / {report['fold_maes']}; "
          f"submission.csv {'identical' if same[0] == same[1] else 'DIFFERS'}"
          f"; launches {counts} [{smi}]", flush=True)
    if sub["fold_maes"] != report["fold_maes"] or same[0] != same[1]:
        fail("the bf16 command in its own process differs from the same "
             "command in process")
    if not counts.get("bgemm_bf16") or counts.get("bgemm_f32"):
        fail("`train gsr --fused` in the bf16 mode did not run on bgemm_bf16")
    return counts


def run_bf16_unfused(dev, data, smi):
    """Phase 12 (e): the unfused GSRFoldRunner with
    ``compute_dtype="bf16"`` at full width, 1 epoch over 3 folds, beside
    the fp32 unfused run from the same weights: s/epoch, val MAE, and the
    GSR layer's bf16 x bf16 -> fp32 product on ``bgemm_bf16`` (one launch
    a step, the folds its batch axis). Returns its launch counts."""
    from fcsr_tpu_torch import GSRFoldRunner, GSRTrainConfig, kfold_indices
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    folds = kfold_indices(len(data["lr_train"]), 3, seed=42)
    out = {}
    for dtype in ("f32", "bf16"):
        runner = GSRFoldRunner(GSRTrainConfig(epochs=1, compute_dtype=dtype),
                               data["lr_train"], data["hr_train"], folds,
                               device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        _, loss, _ = runner.train()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        c = _nonzero(launch_counts())
        maes, _ = runner.evaluate()
        out[dtype] = (maes, c)
        print(f"  unfused compute_dtype={dtype!r}: {t:.2f} s/epoch, val MAE "
              f"{maes.tolist()}, launches {c} [{smi}]", flush=True)
        if not (np.isfinite(loss).all() and np.isfinite(maes).all()):
            fail(f"unfused compute_dtype={dtype!r}: non-finite loss or MAE")
    steps = runner.tr_idx.shape[1]
    c16 = out["bf16"][1]
    if c16.get("bgemm_bf16") != steps:
        fail(f"unfused bf16: {c16.get('bgemm_bf16')} bgemm_bf16 launches, "
             f"not one a step ({steps})")
    return c16


def run_phase12(dev, data, step_args, csv_dir, smi):
    """Phase 12: (a) the bf16 kernels against their plain versions, (b) the
    bf16 step, (b2) the autodiff-shaped entry points, the loss entry
    points timed alone in both modes and the step graphs' gaps, (c) the
    bf16 runner, (d) the bf16 command line, (e) the unfused
    ``compute_dtype="bf16"`` runner, (f) the liveness probe. Returns (JSON
    records, launch counts)."""
    from fcsr_tpu_torch.utils.probe import require_live_device

    t0 = time.perf_counter()
    records = {"bgemm_bf16": check_bf16_products(dev, smi)}
    records.update(check_bf16_variants(dev, smi))
    check_bf16_step(dev, step_args, smi)
    ad_counts = check_bf16_ad_entry_points(dev, step_args, smi)
    print(f"  the loss entry points alone, fp32 then bf16 [{smi}]:",
          flush=True)
    entry_point_times(dev)
    with mm_mode_set("bf16"):
        entry_point_times(dev)
    step_graph_gaps(dev, data, smi)
    counts = run_bf16_runner(dev, data, smi)
    for k, n in ad_counts.items():
        counts[k] = counts.get(k, 0) + n
    for c in (run_bf16_cli(csv_dir, smi), run_bf16_unfused(dev, data, smi)):
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n
    t1 = time.perf_counter()
    name = require_live_device(timeout_s=60)
    print(f"  require_live_device: {name} answered in "
          f"{time.perf_counter() - t1:.3f} s", flush=True)
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)
    return records, counts


# ---------------------------------------------------------------------------
# phase 13: hidden_dim != hr_dim and the JAX fast loop's resume blob
# ---------------------------------------------------------------------------

# decoder widths beside hr = 268: half and twice it (134 rows are 8-byte,
# not 16-byte, multiples: the products' 4-byte copy path)
HIDDEN_WIDTHS = (134, 536)
TAIL_NAMES = ("layer.weights", "gc1.weight", "gc2.weight")


def _hidden_inputs(dev, h):
    """``_entry_inputs`` at decoder width ``h``: the flat weights of three
    ``GSRNet(hidden_dim=h)`` inits in the h-wide ``FlatLayout``, the same
    u_lr, u_hr and hr."""
    from fcsr_tpu_torch.iox.weights import state_to_flat
    from fcsr_tpu_torch.models.gsr import GSRNet

    flat = np.stack([state_to_flat({k: v.numpy() for k, v in GSRNet(
        KS, LR, HR, h, device="cpu", seed=j).state_dict().items()})
        for j in range(F)])
    _, u_lr, u_hr, hr = _entry_inputs(dev)
    return torch.from_numpy(flat).to(dev), u_lr, u_hr, hr


def _hidden_censuses(ops, views, f0, u_lr, u_hr, hr, h):
    """The censuses of #4 (``tail_value_and_grad`` on the trainer's leaf
    views, as ``tail_loss_fused`` hands them over) and of #10 (the step's
    value and gradients on the leaves ``step_value_and_grad_fused`` stages
    from a state_dict) over ``ops``."""
    from fcsr_tpu_torch.iox.weights import (leaf_names,
                                            leaf_tensors_to_state,
                                            state_to_leaf_tensors)
    from fcsr_tpu_torch.kernels.census import census_of
    from fcsr_tpu_torch.models import fused_step as fs
    from fcsr_tpu_torch.models.fused_tail import tail_value_and_grad
    from fcsr_tpu_torch.models.gsr import pool_sizes

    vals = torch.empty(F, 3, device=hr.device)
    tail = census_of(lambda o: tail_value_and_grad(
        o, *[views[k] for k in TAIL_NAMES], f0, u_lr, u_hr, hr, vals), ops)
    names = leaf_names(len(KS))
    state = {k: t.contiguous() for k, t in leaf_tensors_to_state(
        views).items()}
    leaves, data, _ = fs._stage("census", hr.device,
                                state_to_leaf_tensors(state), names,
                                (u_lr, u_hr, hr))
    layout = fs.FlatLayout(LR, HR, len(KS), h)
    G = layout.views(torch.empty(F, layout.size, device=hr.device))
    step = census_of(lambda o: fs.step_value_and_grads(
        o, dict(zip(names, leaves)), G, *data, pool_sizes(LR, KS), 16.0), ops)
    return tail, step


def check_hidden_entry_points(dev, smi):
    """Phase 13 (a): #4 (``tail_loss_fused``) and #10
    (``step_value_and_grad_fused``) at decoder widths 134 and 536 (F = 3,
    full width) against autograd over their plain versions, as phase 6
    holds them at 268 (values 1e-5 relative, gradients 1e-4 of the plain
    gradient's largest entry, 27 / 105 launches); the tail's device ms per
    call at 268, 134 and 536; every product signature of the two that the
    268-wide step does not have, checked and timed beside the library call
    (``check_product``); then at 536 under ``FCSR_MM_MODE=bf16``: #4 on
    the bf16 kernels against the same launches on their plain versions
    (the loss within 1e-5 relative; the gradients printed and held finite:
    a sum that lands beside a bf16 rounding edge rounds the next product's
    operand the other way, PERF.md) and its new ``bgemm_bf16``
    signatures (``check_bf16_product``). Returns the JSON line's
    additions for ``bgemm_f32``."""
    from fcsr_tpu_torch.core import mm_mode
    from fcsr_tpu_torch.iox.weights import leaf_tensors_to_state
    from fcsr_tpu_torch.kernels import (KERNEL_OPS, KERNEL_OPS_BF16,
                                        PLAIN_OPS_BF16, launch_counts,
                                        reset_launch_counts)
    from fcsr_tpu_torch.kernels.census import gsr_step_census
    from fcsr_tpu_torch.models import fused_step as fs
    from fcsr_tpu_torch.models.fused_tail import (_tail_loss,
                                                  tail_loss_fused,
                                                  tail_value_and_grad)

    ct = torch.tensor([2.5, 1.0, -0.5], device=dev)
    dims = dict(F=F, lr_dim=LR, hr_dim=HR, ks=KS)
    # the signatures #4, #10 and the step already have at hidden == hr
    mode_ops = {"fp32": KERNEL_OPS, "bf16": KERNEL_OPS_BF16}
    known = {mode: set(gsr_step_census(dev, ops=ops, **dims).signatures())
             for mode, ops in mode_ops.items()}
    g = torch.Generator(device=dev).manual_seed(13)
    timed = {}
    for h in (HR,) + HIDDEN_WIDTHS:
        p, u_lr, u_hr, hr = _hidden_inputs(dev, h)
        layout = fs.FlatLayout(LR, HR, len(KS), h)
        views = layout.views(p)
        with torch.no_grad():
            f0, _ = fs.unet_forward_rankselect(views, KS, LR)
            tail_args = [views[k] for k in TAIL_NAMES] + [f0, u_lr, u_hr,
                                                          hr]
            tail_ms = device_ms(lambda: tail_loss_fused(*tail_args,
                                                        device=dev), reps=3)
        if h == HR:
            print(f"  #4 tail_loss_fused at hidden {h}: {tail_ms:.4f} ms "
                  f"device a call [{smi}]", flush=True)
            for mode, prods in known.items():
                with mm_mode_set("bf16" if mode == "bf16" else mm_mode.MODE), \
                        torch.no_grad():
                    for census in _hidden_censuses(mode_ops[mode], views, f0,
                                                   u_lr, u_hr, hr, h):
                        prods.update(census.signatures())
            continue

        def run4(fused):
            P = {k: t.requires_grad_() for k, t in
                 layout.views(p.clone()).items() if k in TAIL_NAMES}
            f = f0.clone().requires_grad_()
            args = [P[k] for k in TAIL_NAMES] + [f, u_lr, u_hr, hr]
            loss = (tail_loss_fused(*args, device=dev) if fused
                    else _tail_loss(*args)[0])
            grads = torch.autograd.grad((ct * loss).sum(),
                                        [P[k] for k in TAIL_NAMES] + [f])
            return loss.detach(), grads

        reset_launch_counts()
        with torch.no_grad():
            tail_loss_fused(*tail_args, device=dev)
        c4 = sum(launch_counts().values())
        loss, grads = run4(True)
        w_loss, w_grads = run4(False)
        torch.cuda.synchronize()
        v4 = max_err(loss, w_loss) / scale_of(w_loss)
        g4 = max(max_err(a, b) / max(float(b.abs().max()), 1e-3)
                 for a, b in zip(grads, w_grads))
        # #10 over a state_dict of the same weights
        with torch.no_grad():
            state = {k: t.contiguous() for k, t in
                     leaf_tensors_to_state(layout.views(p.clone())).items()}

        def call10():
            return fs.step_value_and_grad_fused(
                state, u_lr, u_hr, hr, KS, LR, HR, h, 16.0, device=dev)
        reset_launch_counts()
        loss10, recon10, grads10 = call10()
        c10 = sum(launch_counts().values())
        P = {k: t.requires_grad_() for k, t in layout.views(p.clone()).items()}
        w10, w_recon = fs.step_loss_pure(P, None, hr, u_lr, u_hr, KS, LR, 16.0)
        w_grads10 = leaf_tensors_to_state(dict(zip(P, torch.autograd.grad(
            w10.sum(), list(P.values())))))
        torch.cuda.synchronize()
        v10 = max(max_err(loss10, w10.detach()) / scale_of(w10.detach()),
                  max_err(recon10, w_recon.detach()))
        g10 = max(max_err(grads10[k], w) / max(float(w.abs().max()), 1e-3)
                  for k, w in w_grads10.items())
        with torch.no_grad():
            ms10 = device_ms(call10, reps=3)
        print(f"  hidden {h}: #4 {tail_ms:.4f} ms device a call, {c4} "
              f"launches, value rel err {v4:.2e} (limit 1e-5), worst "
              f"gradient err / max {g4:.2e} (limit 1e-4); #10 {ms10:.4f} ms "
              f"device, {c10} launches, value err {v10:.2e}, gradients "
              f"{g10:.2e}; gc1 {tuple(grads10['gc1.weight'].shape)} "
              f"[{smi}]", flush=True)
        if not (v4 <= 1e-5 and g4 <= 1e-4 and v10 <= 1e-5 and g10 <= 1e-4):
            fail(f"#4 / #10 at hidden {h} disagree with autograd over their "
                 "plain versions")
        if (c4, c10) != (ENTRY_LAUNCHES["tail_loss_fused"],
                         ENTRY_LAUNCHES["step_value_and_grad_fused"]):
            fail(f"#4 / #10 at hidden {h} launch {c4} / {c10} kernels")
        if grads10["gc2.weight"].shape != (F, h, HR):
            fail(f"#10 at hidden {h}: gc2's gradient is "
                 f"{tuple(grads10['gc2.weight'].shape)}")
        # the product signatures the 268-wide step never had
        with torch.no_grad():
            for census in _hidden_censuses(KERNEL_OPS, views, f0, u_lr,
                                           u_hr, hr, h):
                for prod in census.signatures():
                    if prod not in known["fp32"] and prod not in timed:
                        timed[prod] = check_product(
                            prod, census.layouts[prod], g, dev)
        if h != max(HIDDEN_WIDTHS):
            continue
        # the same tail on the bf16 products
        with mm_mode_set("bf16"), torch.no_grad():
            outs = []
            for ops in (KERNEL_OPS_BF16, PLAIN_OPS_BF16):
                vals = torch.zeros(F, 3, device=dev)
                grads = tail_value_and_grad(ops, *tail_args, vals)
                outs.append((vals[:, 1] + vals[:, 2], grads))
            torch.cuda.synchronize()
            v16 = max_err(outs[0][0], outs[1][0]) / scale_of(outs[1][0])
            g16 = _rel(outs[0][1], outs[1][1])
            ms16 = device_ms(lambda: tail_loss_fused(*tail_args, device=dev),
                             reps=3)
            print(f"  hidden {h}, bf16: #4 {ms16:.4f} ms device a call, "
                  f"kernels vs plain: loss rel err {v16:.2e} (limit 1e-5), "
                  f"gradients {g16:.2e} of their scale [{smi}]", flush=True)
            if not (v16 <= 1e-5 and all(bool(torch.isfinite(t).all())
                                        for t in outs[0][1])):
                fail(f"#4 at hidden {h} in bf16 disagrees with its plain "
                     "version")
            known16 = known["bf16"]
            for census in _hidden_censuses(KERNEL_OPS_BF16, views, f0, u_lr,
                                           u_hr, hr, h):
                for prod in census.signatures():
                    if prod not in known16:
                        known16.add(prod)
                        check_bf16_product(prod, census.layouts[prod], g, dev)
    worst = max(k / l for k, l, _ in timed.values())
    print(f"  bgemm_f32: {len(timed)} signatures new at hidden "
          f"{HIDDEN_WIDTHS}, checked and timed; worst kernel / library "
          f"{worst:.2f}x, kernel {sum(k for k, _, _ in timed.values()):.4f} "
          f"ms, library {sum(l for _, l, _ in timed.values()):.4f} ms, "
          f"bound {sum(b for _, _, b in timed.values()):.5f} ms over one "
          f"launch each [{smi}]", flush=True)
    return {"hidden_signatures": len(timed),
            "hidden_worst_vs_library": worst}


def _train_counted(runner, **kw):
    """``runner.train(**kw)`` with the launch counts set to 0 just before
    and read just after: (p, loss, err, seconds, counts)."""
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    p, loss, err = runner.train(**kw)
    torch.cuda.synchronize()
    return (p, loss, err, time.perf_counter() - t0,
            _nonzero(launch_counts()))


def _add(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def run_hidden_runners(dev, data, work, smi):
    """Phase 13 (b) and (c) on the teacher set's 3 folds at full width:
    the ``fused_tail_unet_bwd`` runner at hidden 536 for 2 epochs and the
    unfused one at 134 for 1 (s/epoch, ms a step in the loop and on the
    device as one CUDA graph, launches a step, val MAE beside the
    untrained MAE); then the 536 run and a
    ``fused_adam`` run at 268, each interrupted after epoch 1 with its
    ``.msgpack`` blob (the JAX fast loop's) and resumed by a fresh runner,
    bit-equal to the straight run; the encode and decode ms of the 268
    blob. Returns the runs' launch counts."""
    from fcsr_tpu_torch import GSRFoldRunner, GSRTrainConfig, kfold_indices
    from fcsr_tpu_torch.iox.checkpoint import (load_resume_msgpack,
                                               save_resume_msgpack)
    from fcsr_tpu_torch.iox.msgpack import msgpack_restore, pack_pieces

    folds = kfold_indices(len(data["lr_train"]), 3, seed=42)
    scal = torch.tensor([[1.0, 1 - 0.9, 1 - 0.999]] * len(folds), device=dev)
    total, straight = {}, {}

    def runner(cfg):
        return GSRFoldRunner(cfg, data["lr_train"], data["hr_train"], folds,
                             device=dev)

    narrow, wide = HIDDEN_WIDTHS
    for mode, h, epochs in (("fused_tail_unet_bwd", wide, EPOCHS),
                            ("unfused", narrow, 1)):
        cfg = GSRTrainConfig(epochs=epochs, hidden_dim=h, **MODE_FLAGS[mode])
        r = runner(cfg)
        untrained, _ = r.evaluate(r.flat0)
        p, loss, err, t, c = _train_counted(r)
        maes, _ = r.evaluate()
        steps = r.tr_idx.shape[1] * epochs
        # the step alone, without the host's gaps: one CUDA graph of it
        p0, m0, v0, _ = r.fresh_state()
        dev_ms = device_ms(lambda: r._step(p0, m0, v0, 0, scal), reps=3)
        print(f"  {mode} at hidden {h}: {t / epochs:.3f} s/epoch, "
              f"{1e3 * t / steps:.3f} ms a step in the loop, {dev_ms:.3f} "
              f"ms a step on the device, "
              f"{sum(c.values()) / steps:.1f} launches a step {c}; val MAE "
              f"{float(np.mean(maes)):.6f} (untrained "
              f"{float(np.mean(untrained)):.6f}) [{smi}]", flush=True)
        if not (np.isfinite(loss).all() and np.isfinite(maes).all()):
            fail(f"{mode} at hidden {h}: non-finite loss or MAE")
        if sum(c.values()) != MODE_LAUNCHES[mode] * steps or (
                set(c) != set(MODE_KERNELS[mode])):
            fail(f"{mode} at hidden {h} launched {c} in {steps} steps")
        if epochs == EPOCHS and not np.mean(maes) < np.mean(untrained):
            fail(f"{mode} at hidden {h} did not train")
        _add(total, c)
        straight[cfg] = (p, loss, err)

    for mode, h in (("fused_tail_unet_bwd", wide), ("fused_adam", HR)):
        cfg = GSRTrainConfig(epochs=EPOCHS, hidden_dim=h, **MODE_FLAGS[mode])
        if cfg not in straight:
            p, loss, err, _, c = _train_counted(runner(cfg))
            _add(total, c)
            straight[cfg] = (p, loss, err)
        path = os.path.join(work, f"{mode}_{h}.msgpack")
        first = runner(cfg)
        state, lh, eh = first._run_chunk(first.fresh_state(), 1)
        first.save_checkpoint(path, state, 1, lh, eh)
        p, loss, err, _, c = _train_counted(runner(cfg), checkpoint_path=path,
                                            checkpoint_every=1)
        _add(total, c)
        want = straight[cfg]
        same = (torch.equal(p, want[0]) and np.array_equal(loss, want[1])
                and np.array_equal(err, want[2]))
        print(f"  {mode} at hidden {h}: resumed from the .msgpack blob after "
              f"epoch 1 by a fresh runner, bit-equal to the straight run: "
              f"{same}", flush=True)
        if not same:
            fail(f"{mode} at hidden {h}: the msgpack resume is not exact")
    # the full-width blob (3 folds of 1 023 496 parameters, p, m and v)
    blob = load_resume_msgpack(path)
    pieces = pack_pieces(blob)
    raw = b"".join(pieces)
    enc = min(_wall_ms(lambda: b"".join(pack_pieces(blob)))
              for _ in range(3))
    dec = min(_wall_ms(lambda: msgpack_restore(raw)) for _ in range(3))
    t0 = time.perf_counter()
    save_resume_msgpack(os.path.join(work, "copy.msgpack"), *blob["state"],
                        blob["epoch"], blob["fingerprint"], blob["loss_hist"],
                        blob["err_hist"])
    write = 1e3 * (time.perf_counter() - t0)
    print(f"  the 268-wide blob: {len(raw) / 1e6:.2f} MB, encode "
          f"{enc:.2f} ms, decode {dec:.2f} ms, written to disk in "
          f"{write:.2f} ms (host) [{smi}]", flush=True)
    if os.path.getsize(path) != len(raw):
        fail("the msgpack blob does not re-encode to its own bytes")
    return total


def _wall_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def check_hidden_refusals(dev, data):
    """Phase 13 (d): ``fused_adam`` and ``fused_step`` runners at hidden
    134, ``train_step_fused`` (#9) on a 134-wide buffer and
    ``gsr_step_loss_fused`` (#8) with a 134-wide w1 each raise a
    ValueError, and no kernel launches."""
    from fcsr_tpu_torch import GSRFoldRunner, GSRTrainConfig, kfold_indices
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.models import fused_step as fs

    h = HIDDEN_WIDTHS[0]
    p, u_lr, u_hr, hr = _hidden_inputs(dev, h)
    views = fs.FlatLayout(LR, HR, len(KS), h).views(p)
    net = {k: t for k, t in views.items() if k not in TAIL_NAMES}
    folds = kfold_indices(len(data["lr_train"]), 3, seed=42)
    scal = torch.tensor([[1.0, 0.1, 0.001]] * F, device=dev)
    calls = {
        "fused_adam runner": lambda: GSRFoldRunner(
            GSRTrainConfig(hidden_dim=h, fused_adam=True), data["lr_train"],
            data["hr_train"], folds, device=dev),
        "fused_step runner": lambda: GSRFoldRunner(
            GSRTrainConfig(hidden_dim=h, fused_step=True), data["lr_train"],
            data["hr_train"], folds, device=dev),
        "train_step_fused": lambda: fs.train_step_fused(
            p, p.clone(), p.clone(), u_lr, u_hr, hr, scal, KS, LR, HR, 16.0,
            1e-4, device=dev),
        "gsr_step_loss_fused": lambda: fs.gsr_step_loss_fused(
            net, *[views[k] for k in TAIL_NAMES], u_lr, u_hr, hr, KS, LR, HR,
            16.0, device=dev)}
    torch.cuda.synchronize()
    reset_launch_counts()
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            if "hidden_dim == hr_dim only" not in str(e):
                fail(f"{name} at hidden {h} raised another error: {e}")
        else:
            fail(f"{name} at hidden {h} did not refuse")
    launched = _nonzero(launch_counts())
    print(f"  hidden {h}: {', '.join(calls)} refused with a ValueError, "
          f"launches {launched or 'none'}", flush=True)
    if launched:
        fail("a refused whole-step call launched kernels")


def run_phase13(dev, data, work, smi):
    """Phase 13: hidden_dim != hr_dim and the JAX fast loop's resume blob.
    Returns (JSON line additions for ``bgemm_f32``, launch counts)."""
    t0 = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    record = check_hidden_entry_points(dev, smi)
    counts = run_hidden_runners(dev, data, work, smi)
    check_hidden_refusals(dev, data)
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)
    return record, counts


# ---------------------------------------------------------------------------
# phase 14: the chunk programs as CUDA graphs
# ---------------------------------------------------------------------------

# (label, FCSR_MM_MODE, trainer mode, epochs) of the graph-against-eager
# runs: every GSR mode in fp32, the two whole-step modes in bf16 too
GRAPH_RUNS = tuple(
    (mode, "bf16x3_concat", mode,
     EPOCHS if mode in ("fused_adam", "fused_step") else 1)
    for mode in ("fused_adam", "fused_step", "fused_tail_unet_bwd",
                 "fused_tail_unet", "fused_tail", "unfused")) + tuple(
    (f"bf16 {mode}", "bf16", mode, EPOCHS)
    for mode in ("fused_adam", "fused_step"))
GRAPH_PASSES = 3        # timed passes each of graph and eager, in turns


def captured_graphs(trainer) -> list:
    """The CUDA graphs a GSR runner or a GAT trainer holds (every shard's)."""
    graphs = []
    for part in getattr(trainer, "shards", None) or [trainer]:
        held = [part.graph] if hasattr(part, "graph") else \
            list(part._graphs.values())
        graphs.extend(g for g in held if g is not None)
    return graphs


def capture_note(trainer) -> str:
    return graphs_note(captured_graphs(trainer))


def graphs_note(graphs) -> str:
    """The graphs' count, nodes and warm-up / capture / instantiate
    seconds."""
    warm, cap, inst = (sum(getattr(g, a) for g in graphs)
                       for a in ("warm_s", "capture_s", "instantiate_s"))
    return (f"{len(graphs)} graph(s), {sum(g.nodes for g in graphs)} nodes "
            f"{[g.nodes for g in graphs]}: warm-up {warm:.3f} s, capture "
            f"{cap:.3f} s, instantiate {inst:.3f} s")


def peak_note() -> str:
    return (f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
            f" GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
            "reserved")


def _same_train(a, b) -> bool:
    return (torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and np.array_equal(a[2], b[2]))


def check_graph_modes(dev, data, smi):
    """Phase 14 (a): each of ``GRAPH_RUNS`` at full width (3 folds of the
    teacher set) through its epoch graphs twice (the second ``train()``
    without the capture) and then, on the same runner, step by step from
    Python (``_stay_eager``): parameters and histories bit for bit, the
    launches counted through the replays equal to the
    eager run's and to ``MODE_LAUNCHES`` a step; ``fused_step`` bit-equal
    to ``fused_adam`` in both product modes. Returns (the runs, the fp32
    ``fused_adam`` runner, the graph runs' launch counts)."""
    from fcsr_tpu_torch import GSRFoldRunner, GSRTrainConfig, kfold_indices

    folds = kfold_indices(len(data["lr_train"]), 3, seed=42)
    runs, total, keep = {}, {}, None
    for label, mm, mode, epochs in GRAPH_RUNS:
        with mm_mode_set(mm):
            runner = GSRFoldRunner(
                GSRTrainConfig(epochs=epochs, **MODE_FLAGS[mode]),
                data["lr_train"], data["hr_train"], folds, device=dev)
            *graphed, t_g, c_g = _train_counted(runner)
            note = capture_note(runner)
            *again, t_a, _ = _train_counted(runner)
            runner._stay_eager()
            *eager, t_e, c_e = _train_counted(runner)
        steps = runner.tr_idx.shape[1] * epochs
        same = _same_train(graphed, eager) and _same_train(again, eager)
        print(f"  {label:20s} graph {t_g / epochs:.3f} s/epoch with its "
              f"capture ({note}), {t_a / epochs:.4f} in a second train() "
              f"without it, eager {t_e / epochs:.3f} s/epoch; "
              f"{sum(c_g.values()) / steps:.1f} launches a step counted "
              f"through the replays (eager {sum(c_e.values()) / steps:.1f}"
              f"); graph == eager bit for bit (both graphed runs): {same} "
              f"[{smi}]", flush=True)
        if not same:
            fail(f"{label}: the graphed run is not bit-equal to the eager "
                 "run")
        if c_g != c_e or sum(c_g.values()) != MODE_LAUNCHES[mode] * steps:
            fail(f"{label}: {c_g} launches through the replays, {c_e} "
                 f"eager, in {steps} steps")
        _add(total, c_g)
        runs[label] = graphed
        if label == "fused_adam":
            keep = runner
            keep._stay_eager(False)
        else:
            runner.release_graphs()
    for a, b in (("fused_step", "fused_adam"),
                 ("bf16 fused_step", "bf16 fused_adam")):
        same = _same_train(runs[a], runs[b])
        print(f"  {a} == {b} bit for bit through the graphs: {same}",
              flush=True)
        if not same:
            fail(f"{a} is not bit-equal to {b}")
    return runs, keep, total


def graph_eager_passes(label, run_graph, run_eager, epochs, smi,
                       eager_passes: int = GRAPH_PASSES):
    """``GRAPH_PASSES`` timed passes of ``run_graph`` and ``eager_passes``
    of ``run_eager`` (each ``epochs`` epochs), in turns: their s/epoch."""
    times = {"graph": [], "eager": []}
    for i in range(GRAPH_PASSES):
        for kind, run in (("graph", run_graph), ("eager", run_eager)):
            if kind == "eager" and i >= eager_passes:
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) / epochs)
    g, e = times["graph"], times["eager"]
    print(f"  {label}: s/epoch in {len(g)} / {len(e)} passes, in turns: "
          f"graph {[round(x, 4) for x in g]} (spread "
          f"{max(g) / min(g) - 1:.1%}), eager {[round(x, 4) for x in e]} "
          f"(spread {max(e) / min(e) - 1:.1%}); eager / graph "
          f"{statistics.median(e) / statistics.median(g):.1f}x [{smi}]",
          flush=True)
    return times


def check_graph_meshes(dev, data, want, smi):
    """Phase 14 (c): the fp32 ``fused_adam`` runner on 3- and 2-shard
    meshes of the card (a graph per shard, each shard's replay issued
    before any is waited on): bit-equal to the unsharded graphed run
    ``want``, 106 launches a shard step through the replays; s/epoch with
    the capture and in a second run without it. Returns their counts."""
    from fcsr_tpu_torch import GSRFoldRunner, GSRTrainConfig, kfold_indices
    from fcsr_tpu_torch.parallel import virtual_batch_mesh

    folds = kfold_indices(len(data["lr_train"]), 3, seed=42)
    total = {}
    for shards in (3, 2):
        runner = GSRFoldRunner(GSRTrainConfig(epochs=EPOCHS, fused_adam=True),
                               data["lr_train"], data["hr_train"], folds,
                               device=dev,
                               mesh=virtual_batch_mesh(shards, dev))
        *got, t1, c = _train_counted(runner)
        *again, t2, _ = _train_counted(runner)
        steps = runner.tr_idx.shape[1] * EPOCHS * shards
        same = _same_train(got, want) and _same_train(again, want)
        print(f"  {shards} shards x F = {runner.shards[0].n_folds}: "
              f"{t1 / EPOCHS:.3f} s/epoch with the capture "
              f"({capture_note(runner)}), {t2 / EPOCHS:.4f} without; "
              f"{sum(c.values()) / steps:.1f} launches a shard step; "
              f"bit-equal to unsharded: {same} [{smi}]", flush=True)
        if not same:
            fail(f"the {shards}-shard graphed runner is not bit-equal to the "
                 "unsharded one")
        if sum(c.values()) != STEP_LAUNCHES * steps:
            fail(f"{shards} shards: {sum(c.values())} launches in {steps} "
                 "shard steps")
        _add(total, c)
        runner.release_graphs()
    return total


def check_graph_resume(runner, want, work):
    """Phase 14 (d): epoch 1 of the fp32 ``fused_adam`` runner written as
    the JAX fast loop's ``.msgpack`` blob, then resumed by the same runner
    (the state copied into the buffers its graphs read): bit-equal to the
    straight graphed run. Returns the resumed run's counts."""
    path = os.path.join(work, "p14_fused_adam.msgpack")
    state, lh, eh = runner._run_chunk(runner.fresh_state(), 1)
    runner.save_checkpoint(path, state, 1, lh, eh)
    *got, _, counts = _train_counted(runner, checkpoint_path=path,
                                     checkpoint_every=1)
    same = _same_train(got, want)
    print(f"  fused_adam resumed from its .msgpack blob after epoch 1 "
          f"into its captured buffers: bit-equal to the straight run: "
          f"{same}", flush=True)
    if not same:
        fail("the graphed msgpack resume is not exact")
    return counts


def check_gat_graphs(dev, data, smi):
    """Phase 14 (e): the fused GAT trainer (the shipped config, drop_p
    0.01, 3 folds) for 2 epochs under device control through its epoch
    and validation graphs, against a trainer of the same seed step by
    step from Python: best states and histories bit for bit, the same
    launches (83 a step and 111 a validation pass) counted through the
    replays; then s/epoch of both in passes. Returns the graphed run's
    counts."""
    from fcsr_tpu_torch import kfold_indices
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig, _FoldTrainer,
                                               _run_device_control)

    lr_all = np.ascontiguousarray(data["lr_train"], dtype=np.float32)
    hr_all = np.ascontiguousarray(data["hr_train"], dtype=np.float32)
    folds = kfold_indices(len(lr_all), 3, seed=42)
    cfg = GATTrainConfig(epochs=EPOCHS, fused_step=True)
    trainers, res = {}, {}
    for kind in ("graph", "eager"):
        tr = _FoldTrainer(cfg, lr_all, hr_all, folds, 42, dev, fused=True)
        if kind == "eager":
            tr._stay_eager()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        best, hists = _run_device_control(tr, cfg, False, 25)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        res[kind] = (np.stack(best), hists, t, _nonzero(launch_counts()))
        trainers[kind] = tr
    steps = trainers["graph"].tr_len
    want = EPOCHS * (GAT_STEP_LAUNCHES * steps + GAT_VAL_LAUNCHES * 3)
    same = (np.array_equal(res["graph"][0], res["eager"][0])
            and res["graph"][1] == res["eager"][1])
    n = [sum(res[k][3].values()) for k in ("graph", "eager")]
    print(f"  GAT fused, drop_p {cfg.drop_p}, {EPOCHS} epochs: graph "
          f"{res['graph'][2] / EPOCHS:.3f} s/epoch with its captures "
          f"({capture_note(trainers['graph'])}), eager "
          f"{res['eager'][2] / EPOCHS:.3f}; launches {n[0]} through the "
          f"replays, {n[1]} eager ({want} wanted); graph == eager bit for "
          f"bit: {same} [{smi}]", flush=True)
    if not same:
        fail("the graphed GAT trainer is not bit-equal to the eager one")
    if n != [want, want] or res["graph"][3] != res["eager"][3]:
        fail(f"GAT launches {res['graph'][3]} / {res['eager'][3]}")
    graph_eager_passes(
        "GAT fused", lambda: _run_device_control(trainers["graph"], cfg,
                                                 False, 25),
        lambda: _run_device_control(trainers["eager"], cfg, False, 25),
        EPOCHS, smi)
    trainers["graph"].release_graphs()
    return res["graph"][3]


def run_phase14(dev, data, work, smi):
    """Phase 14: the chunk programs as CUDA graphs at full width. Returns
    the graphed runs' launch counts."""
    t0 = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    runs, runner, counts = check_graph_modes(dev, data, smi)
    want = runs["fused_adam"]

    def graph_pass():
        runner._stay_eager(False)
        runner.train()

    def eager_pass():
        runner._stay_eager()
        runner.train()
    graph_eager_passes("fused_adam", graph_pass, eager_pass, EPOCHS, smi)
    runner._stay_eager(False)
    _add(counts, check_graph_meshes(dev, data, want, smi))
    _add(counts, check_graph_resume(runner, want, work))
    runner.release_graphs()
    _add(counts, check_gat_graphs(dev, data, smi))
    print(f"  phase 14: {peak_note()} [{smi}]", flush=True)
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 15: the last three chunk programs as CUDA graphs
# ---------------------------------------------------------------------------

PARITY_FOLD = 0         # the parity trainer's fold (of 3) in phase 15


class _TrainerHook:
    """Inside: every ``cls`` built runs from Python on the card
    (``_stay_eager``) if ``eager``, and every ``EpochGraph`` built is kept
    in ``graphs`` (a trainer may release its graphs before it returns)."""

    def __init__(self, cls, eager: bool):
        self.cls, self.eager, self.graphs = cls, eager, []

    def __enter__(self):
        from fcsr_tpu_torch.train.epoch_graph import EpochGraph

        self._inits = (self.cls.__init__, EpochGraph.__init__)
        init, graph_init = self._inits
        hook = self

        def trainer(obj, *a, **kw):
            init(obj, *a, **kw)
            if hook.eager:
                obj._stay_eager()

        def graph(obj, *a, **kw):
            graph_init(obj, *a, **kw)
            hook.graphs.append(obj)
        self.cls.__init__, EpochGraph.__init__ = trainer, graph
        return self

    def __exit__(self, *exc):
        from fcsr_tpu_torch.train.epoch_graph import EpochGraph

        self.cls.__init__, EpochGraph.__init__ = self._inits
        return False


def trainer_graph(trainer, name: str = "epoch"):
    """The trainer's captured ``name`` graph; fails where there is none."""
    graph = trainer._graphs.get(name)
    if graph is None:
        fail(f"{type(trainer).__module__}: no {name} graph was captured")
    return graph


def replay_ms(graph, steps: int, reps: int = 3) -> float:
    """Device ms a step of an epoch graph: the median of ``reps`` replays
    (one launch each, so the events time the device) by CUDA events, over
    its ``steps``. The replays advance the trainer's state and count no
    launch."""
    if graph is None:
        return float("nan")
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) / steps


def _gat_setup(data):
    from fcsr_tpu_torch import kfold_indices

    lr_all = np.ascontiguousarray(data["lr_train"], dtype=np.float32)
    hr_all = np.ascontiguousarray(data["hr_train"], dtype=np.float32)
    return lr_all, hr_all, kfold_indices(len(lr_all), 3, seed=42)


def _parity_setup(data):
    """The parity trainer's fold: its (lr, hr) stacks and their spectra."""
    from fcsr_tpu_torch import kfold_indices
    from fcsr_tpu_torch.train.gsr_loop import precompute_spectral

    lr_all = np.asarray(data["lr_train"], np.float32)
    hr_all = np.asarray(data["hr_train"], np.float32)
    tr = kfold_indices(len(lr_all), 3, seed=42)[PARITY_FOLD][0]
    lr, hr = lr_all[tr], hr_all[tr]
    return lr, hr, precompute_spectral(lr, hr, lr_dim=LR)


def parity_epoch_ms(dev, lr, hr, spectral):
    """The parity trainer's epoch (``make_train_fn``'s program over the
    fold's stacks, ``OptaxAdam`` from ``init_gsr``) as one CUDA graph:
    (device ms a step, nodes a step)."""
    from fcsr_tpu_torch.train.epoch_graph import EpochGraph
    from fcsr_tpu_torch.train.gsr_loop import (GSRTrainConfig, init_gsr,
                                               make_train_fn)

    cfg = GSRTrainConfig()
    model, opt = init_gsr(cfg, seed=0, device=dev)
    pt = make_train_fn(model, opt, cfg)
    stacks = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
              for a in (lr, hr, *spectral)]
    res = torch.zeros(2, len(lr), device=dev)
    g = EpochGraph("the parity GSR-Net epoch", dev,
                   lambda: pt._epoch(stacks, res[0], res[1]),
                   lambda: pt._warm(stacks, 2))
    out = (replay_ms(g, len(lr)), g.nodes / len(lr))
    g.release()
    return out


def step_graph_ms(dev, data, smi):
    """Phase 15 (0): each trainer's epoch as one CUDA graph, its device ms
    a step (``replay_ms``) and its nodes a step: the unfused GAT epoch
    (drop_p 0.01, 3 folds), the MLP v2 and v1 epochs (3 folds, batches
    32, 32, 32, 16) and the parity epoch (the first fold, ``OptaxAdam``).
    Returns {trainer: ms a step}."""
    from fcsr_tpu_torch.train.gat_loop import GATTrainConfig, _FoldTrainer

    out = {}
    lr_all, hr_all, folds = _gat_setup(data)
    tr = _FoldTrainer(GATTrainConfig(), lr_all, hr_all, folds, 42, dev)
    tr.epoch(*tr.draw_epoch_plan(), torch.full((3,), 1e-3, device=dev),
             torch.ones(3, device=dev))
    g = trainer_graph(tr)
    out["GAT unfused"] = (replay_ms(g, tr.tr_len),
                          getattr(g, "nodes", 0) / tr.tr_len)
    tr.release_graphs()
    for variant in ("v2", "v1"):
        tr = _mlp_setup(variant, data, 3, dev)
        perms = np.stack([np.random.default_rng(j).permutation(tr.n)
                          for j in range(3)])
        tr.epoch(perms, torch.full((3,), 0.01, device=dev),
                 torch.ones(3, device=dev))
        g = trainer_graph(tr)
        steps = len(tr.batches)
        out[f"MLP {variant}"] = (replay_ms(g, steps),
                                 getattr(g, "nodes", 0) / steps)
        tr.release_graphs()
        del tr, g
        torch.cuda.empty_cache()
    out["parity"] = parity_epoch_ms(dev, *_parity_setup(data))
    for k, (ms, nodes) in out.items():
        print(f"  {k} epoch as one graph: {ms:.3f} ms a step on the device, "
              f"{nodes:.0f} nodes a step [{smi}]", flush=True)
    return {k: ms for k, (ms, _) in out.items()}


def check_gat_unfused_graphs(dev, data, smi):
    """Phase 15 (a): the unfused GAT trainer (the shipped config: drop_p
    0.01, 3 folds) through its epoch and validation graphs, 2 epochs under
    device control then 1 more under host control, against a trainer of
    the same seed from Python: best states, histories and the dropout
    generator's state bit for bit, the same (own-kernel) launches; then
    s/epoch in passes (eager: 1) and the device ms a step."""
    from dataclasses import replace

    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig, _FoldTrainer,
                                               _run_device_control,
                                               _run_host_control)

    lr_all, hr_all, folds = _gat_setup(data)
    cfg = GATTrainConfig(epochs=EPOCHS)
    one = replace(cfg, epochs=1)
    if cfg.fused_step or cfg.drop_p != 0.01:
        fail(f"the shipped GAT config is not the unfused one: {cfg}")
    trainers, res = {}, {}
    for kind in ("graph", "eager"):
        torch.cuda.reset_peak_memory_stats()
        tr = _FoldTrainer(cfg, lr_all, hr_all, folds, 42, dev)
        if kind == "eager":
            tr._stay_eager()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        best, hists = _run_device_control(tr, cfg, False, 25)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        best_h, hists_h = _run_host_control(tr, one, False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res[kind] = ((np.stack(best), hists, np.stack(best_h), hists_h,
                      tr.gen.get_state()), t1 - t0, t2 - t1,
                     _nonzero(launch_counts()), peak_note())
        trainers[kind] = tr
    (got, t_dev, t_host, counts, peak), want = res["graph"], res["eager"][0]
    same = [np.array_equal(got[0], want[0]) and got[1] == want[1],
            np.array_equal(got[2], want[2]) and got[3] == want[3],
            torch.equal(got[4], want[4])]
    tr = trainers["graph"]
    print(f"  GAT unfused, drop_p {cfg.drop_p}, 3 folds x {tr.tr_len} "
          f"steps: graph {t_dev / EPOCHS:.3f} s/epoch under device control "
          f"with its captures ({capture_note(tr)}), {t_host:.3f} s for 1 "
          f"more under host control; eager {res['eager'][1] / EPOCHS:.3f} "
          f"and {res['eager'][2]:.3f}; own-kernel launches {counts} through "
          f"the replays, {res['eager'][3]} eager; graph == eager bit for "
          f"bit (device control, host control, generator): {same}; {peak} "
          f"(eager: {res['eager'][4]}) [{smi}]", flush=True)
    if not all(same):
        fail("the graphed unfused GAT trainer is not bit-equal to the eager "
             "one")
    if counts != res["eager"][3]:
        fail(f"unfused GAT launches {counts} / {res['eager'][3]}")
    graph_eager_passes("GAT unfused (1 epoch a pass, device control)",
                       lambda: _run_device_control(tr, one, False, 25),
                       lambda: _run_device_control(trainers["eager"], one,
                                                   False, 25), 1, smi,
                       eager_passes=1)
    ms = replay_ms(trainer_graph(tr), tr.tr_len)
    val_ms = replay_ms(trainer_graph(tr, "validation"), 1)
    print(f"  GAT unfused: {ms:.3f} ms a step on the device (the epoch "
          f"graph's replay), {val_ms:.3f} ms a validation pass [{smi}]",
          flush=True)
    tr.release_graphs()
    return counts


def _mlp_result(result):
    """What phase 15 compares of a ``run_mlp_cv`` result, without a copy
    of v1's best state: histories, MAEs, each best leaf's fingerprint and
    the test predictions."""
    return (result["histories"], result["fold_maes"],
            [_fingerprint(v) for v in result["variables"].values()],
            result["test_preds"].clone())


def check_mlp_graphs(dev, data, smi):
    """Phase 15 (b): ``run_mlp_cv`` with its defaults for 2 epochs (v2)
    and ``variant="v1"`` for 1, through the epoch and validation graphs
    and with every trainer from Python: histories, MAEs, best states (by
    ``_fingerprint``) and test predictions bit for bit, one
    ``adamw_masked`` a step through the replays as eagerly; peak memory;
    then s/epoch of a trainer of the same config in passes and its
    device ms a step. Returns the graphed runs' counts."""
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.pipelines import run_mlp_cv
    from fcsr_tpu_torch.train import generic_loop

    total = {}
    for variant, epochs in (("v2", EPOCHS), ("v1", 1)):
        res = {}
        for kind in ("graph", "eager"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with _TrainerHook(generic_loop._FoldTrainer,
                              kind == "eager") as hook:
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                result = run_mlp_cv(data, num_epochs=epochs, variant=variant,
                                    device=dev)
                torch.cuda.synchronize()
                t = time.perf_counter() - t0
            res[kind] = (_mlp_result(result), t, result["timings"]["train"],
                         _nonzero(launch_counts()), peak_note(), hook.graphs)
            del result
        (got, t, t_train, counts, peak, graphs), want = (res["graph"],
                                                         res["eager"][0])
        same = [got[0] == want[0], got[1] == want[1],
                all(_same_fingerprint(a, b) for a, b in zip(got[2], want[2])),
                torch.equal(got[3], want[3])]
        steps = 4 * epochs
        print(f"  MLP {variant} run_mlp_cv, {epochs} epoch(s): {t:.2f} s "
              f"(train {t_train:.3f}, {t_train / epochs:.4f} s/epoch with "
              f"its captures: {graphs_note(graphs)}); eager "
              f"{res['eager'][1]:.2f}"
              f" s (train {res['eager'][2] / epochs:.4f} s/epoch); launches "
              f"{counts} through the replays, {res['eager'][3]} eager; graph"
              f" == eager bit for bit (histories, MAEs, best state, test "
              f"predictions): {same}; graph {peak}, eager {res['eager'][4]} "
              f"[{smi}]", flush=True)
        if not all(same):
            fail(f"MLP {variant}: the graphed run is not bit-equal to the "
                 "eager one")
        if counts != res["eager"][3] or counts.get("adamw_masked") != steps:
            fail(f"MLP {variant}: launches {counts} / {res['eager'][3]}, "
                 f"not one adamw_masked in each of {steps} steps")
        _add(total, counts)
        del res, got, want, graphs
        torch.cuda.empty_cache()

        tr = _mlp_setup(variant, data, 3, dev)
        rngs = [np.random.default_rng(42 + j) for j in range(3)]

        def run(eager, tr=tr, rngs=rngs, epochs=epochs):
            tr._stay_eager(eager)
            generic_loop._device_control(tr, rngs, epochs, 0.01,
                                         lambda e: True, 10, 1e-4, 0.1,
                                         1e-5, 25)
        run(False)                      # the capture, untimed
        graph_eager_passes(f"MLP {variant} trainer ({epochs} epoch(s) a "
                           "pass, device control)", lambda: run(False),
                           lambda: run(True), epochs, smi)
        tr._stay_eager(False)
        ms = replay_ms(trainer_graph(tr), len(tr.batches))
        print(f"  MLP {variant}: {ms:.3f} ms a step on the device (the epoch"
              f" graph's replay, batches {[b - a for a, b in tr.batches]}) "
              f"[{smi}]", flush=True)
        tr.release_graphs()
        del tr, run
        torch.cuda.empty_cache()
    return total


def gat_unfused_fold_counts(dev, data, smi):
    """Phase 15 (0): the unfused GAT step, the folds one vmapped call, at
    F = 1 and F = 3 (the shipped config, drop_p 0.01, the first F folds):
    its epoch graph's nodes and device ms a step, the graph's warm-up /
    capture / instantiate seconds, and s/epoch through the graph and
    eager in passes. F = 3's nodes a step must stay within 10% of F = 1's:
    the fold axis runs inside each launch, not beside it. Returns the
    graphs' launch counts (none of the port's own)."""
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.train.gat_loop import GATTrainConfig, _FoldTrainer

    lr_all, hr_all, folds = _gat_setup(data)
    nodes, counts = {}, {}
    for n in (1, 3):
        pair = [_FoldTrainer(GATTrainConfig(), lr_all, hr_all, folds[:n], 42,
                             dev) for _ in range(2)]
        pair[1]._stay_eager()
        lr_t = torch.full((n,), 1e-3, device=dev)
        active = torch.ones(n, device=dev)

        def run(tr):
            tr.epoch(*tr.draw_epoch_plan(), lr_t, active)
        reset_launch_counts()
        run(pair[0])                                 # warm-up and capture
        torch.cuda.synchronize()
        _add(counts, _nonzero(launch_counts()))
        g = trainer_graph(pair[0])
        steps = pair[0].tr_len
        nodes[n] = g.nodes / steps
        ms = replay_ms(g, steps)
        print(f"  GAT unfused, F = {n}: {nodes[n]:.0f} nodes a step, "
              f"{ms:.3f} ms a step on the device (the epoch graph's "
              f"replay, {steps} steps), {graphs_note([g])} [{smi}]",
              flush=True)
        graph_eager_passes(f"GAT unfused, F = {n} (1 epoch a pass)",
                           lambda: run(pair[0]), lambda: run(pair[1]), 1,
                           smi, eager_passes=1)
        for tr in pair:
            tr.release_graphs()
    ratio = nodes[3] / nodes[1]
    print(f"  GAT unfused nodes a step, F = 3 / F = 1: {ratio:.3f} (limit "
          f"1.1)", flush=True)
    if not ratio <= 1.1:
        fail(f"the unfused GAT step's graph grows with the fold count: "
             f"{nodes}")
    return counts


def check_parity_tiny(dev, smi):
    """Phase 15 (c'): the parity trainer at 20 -> 32 nodes (2 epochs of 4
    subjects, ``OptaxAdam`` from ``init_gsr``), on the card through its
    epoch graph against the same run on the CPU: every step's loss and
    error within 1e-5, the parameters within 1e-6 (the CPU run's
    tolerances against the JAX package)."""
    from fcsr_tpu_torch.data import synthesize_teacher_connectomes
    from fcsr_tpu_torch.train import gsr_loop

    lr, hr = synthesize_teacher_connectomes(4, lr_dim=20, hr_dim=32, seed=2)
    cfg = gsr_loop.GSRTrainConfig(epochs=2, lr_dim=20, hr_dim=32,
                                  hidden_dim=32, ks=(0.9, 0.7))
    spectral = gsr_loop.precompute_spectral(lr, hr, lr_dim=20)
    runs = []
    for d in ("cpu", dev):
        model, opt = gsr_loop.init_gsr(cfg, 0, d)
        stacks = [torch.from_numpy(np.asarray(a, np.float32)).to(d)
                  for a in (lr, hr, *spectral)]
        runs.append(([h.cpu() for h in gsr_loop.make_train_fn(
            model, opt, cfg, per_step=True)(*stacks)],
            [t.detach().cpu() for t in model.parameters()]))
    d_loss = max_err(runs[0][0], runs[1][0])
    d_p = max_err(runs[0][1], runs[1][1])
    print(f"  parity trainer at 20 -> 32, card (graph) vs CPU: max|d step "
          f"loss / error| {d_loss:.2e} (limit 1e-5), max|d param| "
          f"{d_p:.2e} (limit 1e-6) [{smi}]", flush=True)
    if not (d_loss <= 1e-5 and d_p <= 1e-6):
        fail("the parity trainer on the card disagrees with the CPU run")


def check_parity_graphs(dev, data, smi):
    """Phase 15 (c): the parity trainer (``train_gsr_fold``, the first
    fold, 2 epochs, ``OptaxAdam`` from ``init_gsr``) through its epoch
    graph against the same trainer from Python: parameters, histories and
    Adam's state bit for bit; its distance from the same run with a
    torch's Adam (with and without ``capturable``) from Python; s/epoch in
    passes; peak memory."""
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fcsr_tpu_torch.train import gsr_loop

    lr, hr, spectral = _parity_setup(data)
    cfg = gsr_loop.GSRTrainConfig(epochs=EPOCHS)
    res = {}
    for kind in ("graph", "eager"):
        torch.cuda.reset_peak_memory_stats()
        model, opt = gsr_loop.init_gsr(cfg, seed=0, device=dev)
        with _TrainerHook(gsr_loop._ParityTrainer, kind == "eager") as hook:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            hist = gsr_loop.train_gsr_fold(model, opt, cfg, lr, hr,
                                           spectral=spectral)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        res[kind] = ([x.detach().clone() for x in model.parameters()]
                     + [x.clone() for st in opt.state.values()
                        for x in st.values()], hist, t,
                     _nonzero(launch_counts()), peak_note(), hook.graphs)
    (got, hist, t, counts, peak, graphs), want = res["graph"], res["eager"]
    same = (all(torch.equal(a, b) for a, b in zip(got, want[0]))
            and all(np.array_equal(hist[k], want[1][k]) for k in hist))
    # the same run with torch's Adam, without capturable=True (its bias
    # correction in Python floats) and with it, from Python
    stacks = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
              for a in (lr, hr, *spectral)]
    dist = []
    for capturable in (False, True):
        model, opt = gsr_loop.init_gsr(cfg, seed=0, device=dev)
        pt = gsr_loop.make_train_fn(model, opt, cfg)
        # past the card's check: this run stays eager
        pt.optimizer = torch.optim.Adam(
            model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            capturable=capturable)
        pt._stay_eager()
        old = pt(*stacks)[0].cpu().numpy()
        dist.append(
            f"torch Adam{' capturable' if capturable else ''}: max|d epoch "
            f"loss| {float(np.abs(old - hist['loss']).max()):.2e}, max|d "
            f"param| / scale " + format(max(
                max_err(a, b.detach()) / max(scale_of(b.detach()), 1e-30)
                for a, b in zip(got, model.parameters())), ".2e"))
    print(f"  parity trainer ({len(lr)} subjects, {EPOCHS} epochs): graph "
          f"{t / EPOCHS:.3f} s/epoch with its capture ({graphs_note(graphs)})"
          f", eager {want[2] / EPOCHS:.3f}; own-kernel launches {counts} / "
          f"{want[3]}; graph == eager bit for bit (parameters, Adam's state,"
          f" histories): {same}; graph {peak}, eager {want[4]}; OptaxAdam "
          f"(loss {hist['loss'].tolist()}) against {'; '.join(dist)} "
          f"[{smi}]", flush=True)
    if not same:
        fail("the graphed parity trainer is not bit-equal to the eager one")
    if counts != want[3]:
        fail(f"parity launches {counts} / {want[3]}")
    one = gsr_loop.GSRTrainConfig(epochs=1)
    captures = []

    def run(eager):
        model, opt = gsr_loop.init_gsr(one, seed=0, device=dev)
        with _TrainerHook(gsr_loop._ParityTrainer, eager) as hook:
            gsr_loop.train_gsr_fold(model, opt, one, lr, hr,
                                    spectral=spectral)
        captures.extend(sum(getattr(g, a) for a in (
            "warm_s", "capture_s", "instantiate_s")) for g in hook.graphs)
    times = graph_eager_passes(
        "parity trainer (1 epoch a pass, a capture in each graph pass)",
        lambda: run(False), lambda: run(True), 1, smi)
    ms, nodes = parity_epoch_ms(dev, lr, hr, spectral)
    print(f"  parity trainer: graph passes without their captures "
          f"{[round(t - c, 4) for t, c in zip(times['graph'], captures)]}"
          f" s/epoch (captures {[round(c, 3) for c in captures]} s); "
          f"{ms:.3f} ms a step on the device (the epoch as one graph, "
          f"{nodes:.0f} nodes a step) [{smi}]", flush=True)
    return counts


def run_phase15(dev, data, smi):
    """Phase 15: the unfused GAT, MLP and parity trainers through their
    epoch graphs at full width. Returns the graphed runs' launch counts."""
    t0 = time.perf_counter()
    counts = gat_unfused_fold_counts(dev, data, smi)
    _add(counts, check_gat_unfused_graphs(dev, data, smi))
    _add(counts, check_mlp_graphs(dev, data, smi))
    torch.cuda.reset_peak_memory_stats()
    _add(counts, check_parity_graphs(dev, data, smi))
    check_parity_tiny(dev, smi)
    print(f"  phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


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
    # bf16 products (phase 12's unfused bf16 runner) sum in fp32, as XLA's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    data = load_or_synthesize(None, n_train=N_TRAIN, n_test=N_TEST, seed=42)
    print(f"teacher dataset synthesized in {time.perf_counter() - t0:.1f} s",
          flush=True)

    print("phase 2: kernels vs plain at main-path shapes", flush=True)
    records = check_kernels(dev)
    print("phase 3: one full-width step, kernels vs plain", flush=True)
    step_args, eager_ms = check_step(dev, data)
    from fcsr_tpu_torch.models.fused_step import train_step_fused
    profile_launches(
        lambda: train_step_fused(*step_args, device=dev), eager_ms,
        os.path.join(OUT_DIR, "profile_step.txt"),
        {f"{k}_kernel": c for k, c in STEP_POOL_LAUNCHES.items()},
        "GSR step")
    print("phase 4: trainer path", flush=True)
    torch.cuda.reset_peak_memory_stats()
    counts, fold_outs = run_main_path(dev, data, EPOCHS)
    check_tiny_trainer(dev, data)
    check_fold_batched(dev, data)
    print(f"  phase 4: {peak_note()} [{smi}]", flush=True)
    print("phase 5: Kaggle CSVs to submission.csv through the command line",
          flush=True)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    try:
        csv_counts = run_csv_path(dev, data)
        print("phase 6: fused entry points and every other trainer mode",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        check_entry_points(dev, step_args)
        mode_counts = run_trainer_modes(dev, data)
        parity_counts = run_parity_cli(dev, os.path.join(WORK_DIR, "data"))
        print(f"  phase 6: {peak_note()} [{smi}]", flush=True)
        print("phase 7: the GAT U-Net family", flush=True)
        records.update(check_gat_kernels(dev))
        keep_counts = run_keep_rate(dev)
        keep_mask_times(dev)
        check_gat_reductions(dev)
        check_gat_forward(dev)
        check_pool_dropout(dev)
        check_col_softmax(dev)
        check_gat_step(dev, data)
        gat_counts = run_gat_trainer(dev, data)
        gat_cli_counts = run_gat_cli(dev, os.path.join(WORK_DIR, "data"))
        print("phase 8: the metric suite on the card", flush=True)
        metric_counts = run_metric_suite(dev, fold_outs,
                                         os.path.join(WORK_DIR, "data"))
        print("phase 9: the MLP family", flush=True)
        check_adamw_inplace(dev)
        check_mlp_steps(dev, data)
        mlp_counts = run_mlp_main_path(dev, data)
        mlp_cli_counts = run_mlp_cli(dev, os.path.join(WORK_DIR, "data"))
        print("phase 10: the JAX package's files and the last modules",
              flush=True)
        p10_counts = run_phase10(dev, data, os.path.join(WORK_DIR, "p10"))
        print("phase 11: the fold-sharded trainers and the data-parallel "
              "steps", flush=True)
        torch.cuda.reset_peak_memory_stats()
        p11_counts = run_phase11(dev, data, os.path.join(WORK_DIR, "data"),
                                 smi)
        print(f"  phase 11: {peak_note()} [{smi}]", flush=True)
        print("phase 12: FCSR_MM_MODE=bf16, single-pass bf16 products",
              flush=True)
        p12_records, p12_counts = run_phase12(
            dev, data, step_args, os.path.join(WORK_DIR, "data"), smi)
        records.update(p12_records)
        print("phase 13: hidden_dim != hr_dim and the JAX fast loop's "
              "resume blob", flush=True)
        p13_record, p13_counts = run_phase13(
            dev, data, os.path.join(WORK_DIR, "p13"), smi)
        records["bgemm_f32"].update(p13_record)
        print("phase 14: the chunk programs as CUDA graphs", flush=True)
        p14_counts = run_phase14(dev, data, os.path.join(WORK_DIR, "p14"),
                                 smi)
        print("phase 15: the last three chunk programs as CUDA graphs",
              flush=True)
        p15_counts = run_phase15(dev, data, smi)
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)

    if "jax" in sys.modules or any(k == "fcsr_tpu" or k.startswith("fcsr_tpu.")
                                   for k in sys.modules):
        fail("JAX or fcsr_tpu was imported")
    kernels = []
    for name, k in KERNELS.items():
        rec = {"name": name, "route": "cuda",
               "source": f"fcsr_tpu_torch/kernels/csrc/{k.source}.cu",
               "replaces": k.replaces,
               "launches": sum(c.get(name, 0) for c in (
                   counts, csv_counts, mode_counts, parity_counts,
                   gat_counts, gat_cli_counts, keep_counts,
                   metric_counts, mlp_counts, mlp_cli_counts, p10_counts,
                   p11_counts, p12_counts, p13_counts, p14_counts,
                   p15_counts))}
        rec.update(records.get(name, {}))
        kernels.append(rec)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
