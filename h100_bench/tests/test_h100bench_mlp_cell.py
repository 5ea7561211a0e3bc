"""The MLP cell (``mlp_v2.cv3``) at a tiny size (20 -> 32 nodes, hidden
26, batches of 4, 27 subjects, the program's plain paths on the CPU): the
result line's shape, ``correct`` true for a sound run, and false once the
timed path is broken underneath (the planted faults); on a card the same
through the kernels and the epoch graphs, and the TF32 control (on the
CPU TF32 does not exist, so the control is tested on the card only).
Also the reader of ``graph_capture_s.mlp`` against a recorded run.

    python -m pytest h100_bench/tests -q           # CPU
    python -m pytest h100_bench/tests -q -m cuda   # on the card
"""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402
from fcsr_tpu_torch.utils import profiling  # noqa: E402

CELL = "mlp_v2.cv3"
SEED = 2 ** 31 + 4242
FAULTS = ["frozen_step", "half_batch", "altered_answer", "wrong_lr",
          "stale_schedule", "stale_power_iteration"]


def tiny():
    """The cell at 20 -> 32 nodes, 60 epochs at a rate that makes every
    fold's plateau rule decay its rate (the program's schedule is
    ``run_mlp_cv``'s own: patience 10, threshold 1e-4)."""
    cell, cfg, mix, manifest = harness.load_cell(CELL)
    cfg["published"].update(n_in=20, n_out=32, hidden=26, batch_size=4,
                            epochs=60, lr=0.05)
    # at this size the first gradient's and the first steps' gaps lie
    # within 2x of the full size's limits on the CPU (grad 1.0e-5, loss
    # 8.0e-6), and the statistics after three steps 1-2% from the
    # reference's (the input layer's bias, which BatchNorm cancels, takes
    # Adam steps of +-lr on a gradient that is rounding alone, on both
    # sides with other signs); the update's number 3.5e-6 (the full
    # size's limit 5e-6); the planted faults read 0.18 and more
    cfg["check_limits"].update(step_loss_gap=1e-4, grad_norm_gap=1e-4,
                               update_norm_gap=3e-5, stats_gap=0.05)
    mix.update(n_train=27, n_test=4)
    return cell, cfg, mix, manifest


def run_tiny(device="cpu", trace=0, **kw):
    cell, cfg, mix, manifest = tiny()
    return harness.run_cell(cell, cfg, mix, manifest, SEED, 0.0, trace,
                            time.perf_counter(), device=device, **kw)


def test_the_cell_finds_its_files():
    """The cell's configuration, family, traffic and limits by name, and a
    reader for each of its per-layer metrics."""
    cell, cfg, mix, manifest = harness.load_cell(CELL)
    assert cfg["family"] == "mlp" and cell["chips"] == 1
    assert mix["splits"] == 3 and mix["min_runs"] >= 2
    assert cfg["reduced"] == [] and cfg["check_limits"] and all(
        float(v) >= 0 for v in cfg["check_limits"].values())
    reported = {m["name"] for m in harness.cell_metrics(
        manifest, "end_to_end", cell)}
    # runs spread 3.2% between processes, past the GSR cells' 2.5%: the
    # cell takes the wider bound (PERF.md, section 2)
    assert reported == {"cv_run_s.gat", "setup_s"}
    layers = harness.cell_metrics(manifest, "per_layer", cell)
    assert len(layers) == 10 and all(m["moves"] in reported and
                                     m["name"].endswith(".mlp")
                                     for m in layers)
    for m in layers:
        assert harness._metric_reader(m["name"])(SimpleNamespace(
            runs=[], window_s=0.0, flops=0, slice=None, work={})) is None


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_prints_the_result_line(trace):
    result, lines = run_tiny(trace=trace)
    line = json.loads(json.dumps(result))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 2
    names = {"cv_run_s.gat", "setup_s"} if not trace else {
        "stage_s.mlp", "test_predict_s.mlp", "useful_fold_epoch_pct.mlp",
        "mfu.mlp"}
    assert names <= set(line["metrics"])
    if trace:
        # every fold trains in every epoch it runs at this size
        assert line["metrics"]["useful_fold_epoch_pct.mlp"]["value"] == 100
    assert set(line["checks"]) == {
        "step_loss_gap", "grad_norm_gap", "update_norm_gap", "stats_gap",
        "fold_mae_gap", "best_val_gap", "test_pred_gap",
        "trained_mae_ratio", "control_mismatch", "unmoved_leaf_share"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    assert lines[-1].startswith("check ")


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_the_check(fault):
    result, _ = run_tiny(fault=fault, min_runs=1)
    assert result["correct"] is False


def test_faults_are_undone():
    """A planted fault's patches are put back when its run ends: a sound
    run after it is correct."""
    run_tiny(fault="stale_power_iteration", min_runs=1)
    result, _ = run_tiny(min_runs=1)
    assert result["correct"] is True


def test_graph_capture_reader_reads_the_capture_spans(monkeypatch):
    """The reader takes the window's records (the last ``len(ctx.runs)``,
    after a warm-up record) and averages their ``capture`` phase; nothing
    where a run made no graph or the program keeps no records."""
    read = harness._metric_reader("graph_capture_s.mlp")
    recs = [{"phases": {"cv_run": 3.0, "capture": 0.1 * (k + 1)}}
            for k in range(4)]
    monkeypatch.setattr(profiling, "recent_runs", lambda: list(recs))
    ctx = SimpleNamespace(runs=[{}] * 3)
    assert read(ctx) == pytest.approx((0.2 + 0.3 + 0.4) / 3)
    recs[2] = {"phases": {"cv_run": 3.0}}
    assert read(ctx) is None
    monkeypatch.delattr(profiling, "recent_runs")
    assert read(ctx) is None


def test_graph_capture_reader_on_a_recorded_run():
    """A real window's records on the CPU hold no ``capture`` span (the
    CPU makes no graph): the reader gives nothing, as the harness then
    leaves it off a CPU line."""
    result, _ = run_tiny(trace=1)
    assert "graph_capture_s.mlp" not in result["metrics"]
    assert harness._metric_reader("graph_capture_s.mlp")(
        SimpleNamespace(runs=[{}] * 2)) is None


@pytest.mark.cuda
def test_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, lines = run_tiny(device="cuda", trace=1)
    assert result["correct"] is True, lines
    assert result["device"]["platform"] == "gpu"
    listed = [m["name"] for m in harness.cell_metrics(
        harness.load_cell(CELL)[3], "per_layer", {"name": CELL})]
    assert set(listed) <= set(result["metrics"])
    result, _ = run_tiny(device="cuda", control="tf32", min_runs=1)
    assert result["correct"] is False
    for fault in FAULTS:
        result, _ = run_tiny(device="cuda", fault=fault, min_runs=1)
        assert result["correct"] is False, fault


@pytest.mark.parametrize("leaf, caught", [
    ("input_layer.1.weight_orig", False),
    ("output_layer.0.weight_orig", True)])
def test_update_number_leaves_out_the_leaves_batchnorm_feeds(
        monkeypatch, leaf, caught):
    """``update_norm_gap`` judges the leaves BatchNorm does not feed: the
    input layer's kernel and bias take a gradient centred over the batch,
    whose small entries the program's one-pass variance leaves at rounding
    and Adam moves by +-lr either way. A tenth more change in the input
    kernel shows in the notes alone; in the output kernel it fails the
    check."""
    from h100_bench.families import mlp
    real = mlp.Cell.take_outputs

    def take_outputs(self, res):
        out = real(self, res)
        for dp in out["dp"]:
            dp[leaf] *= 1.1
        return out
    monkeypatch.setattr(mlp.Cell, "take_outputs", take_outputs)
    result, lines = run_tiny(min_runs=1)
    notes = json.loads(next(x for x in lines
                            if x.startswith("notes "))[len("notes "):])
    check = result["checks"]["update_norm_gap"]
    assert (check["value"] > check["limit"]) is caught
    assert result["correct"] is not caught
    assert min(notes["bn_fed_update_gap"]) >= (0.0 if caught else 0.05)
    assert not set(notes["worst_update_leaf"]) & set(mlp.BN_FED)
