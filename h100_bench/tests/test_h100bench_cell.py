"""A whole run of a cell at a tiny size (20 -> 32 nodes, 12 subjects, the
program's plain paths on the CPU): the result line's shape, ``correct``
true for a sound run, and false once the timed path is broken underneath
(the planted faults) or computed in the configuration's lower precision
(the control). On a card the same runs go through the CUDA kernels and
the epoch graphs.

    python -m pytest h100_bench/tests -q           # CPU
    python -m pytest h100_bench/tests -q -m cuda   # on the card
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402

CELLS = {"gsr": "gsr_net.cv3", "gat": "gat_unet.cv3"}
CONTROL = {"gsr": "bf16", "gat": "tf32"}
SEED = 2 ** 31 + 4242


def tiny(family):
    """The family's cell at 20 -> 32 nodes with a learning rate that
    trains in 30 epochs."""
    cell, cfg, mix, manifest = harness.load_cell(CELLS[family])
    pub = cfg["published"]
    if family == "gsr":
        pub.update(lr_dim=20, hr_dim=32, hidden_dim=32, epochs=40, lr=3e-3)
        # 12 subjects at 20 -> 32 cut the MAE to 0.32-0.50 of the untrained
        # model's on the CPU (the full size: 0.12-0.20); a state left
        # unchanged still reads 1
        cfg["check_limits"]["trained_mae_ratio"] = 0.8
    else:
        pub.update(n_nodes=20, m_nodes=32, dim=4, heads=2, epochs=30,
                   lr=1e-2)
    mix.update(n_train=12, n_test=4)
    return cell, cfg, mix, manifest


def run_tiny(family, device="cpu", trace=0, **kw):
    cell, cfg, mix, manifest = tiny(family)
    result, lines = harness.run_cell(cell, cfg, mix, manifest, SEED, 0.0,
                                     trace, time.perf_counter(),
                                     device=device, **kw)
    return result, lines


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("family", ["gsr", "gat"])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_prints_the_result_line(family, trace):
    result, lines = run_tiny(family, trace=trace)
    line = json.loads(json.dumps(result))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 2
    part = "" if family == "gsr" else ".gat"
    names = {"cv_run_s" + part, "setup_s"} if not trace else {
        "fold_eval_s" + part, "mfu" + part}
    assert names <= set(line["metrics"])
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert lines[-1].startswith("check ")
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


FAULTS = [(family, fault) for family in ("gsr", "gat")
          for fault in ("frozen_step", "half_batch", "altered_answer")]
FAULTS += [("gat", "stale_schedule"), ("gat", "wrong_lr")]


@pytest.mark.parametrize("family,fault", FAULTS)
def test_planted_fault_fails_the_check(family, fault):
    result, _ = run_tiny(family, fault=fault, min_runs=1)
    assert result["correct"] is False


def test_gsr_control_fails_the_check():
    """The program's one-pass bf16 products (``FCSR_MM_MODE=bf16``),
    emulated by its plain path on the CPU."""
    result, _ = run_tiny("gsr", control="bf16", min_runs=1)
    assert result["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gsr", "gat"])
def test_on_the_card(family):
    _card()
    result, lines = run_tiny(family, device="cuda", trace=1)
    assert result["correct"] is True, lines
    assert result["device"]["platform"] == "gpu"
    result, _ = run_tiny(family, device="cuda", control=CONTROL[family],
                         min_runs=1)
    assert result["correct"] is False
    for fam, fault in FAULTS:
        if fam == family:
            result, _ = run_tiny(family, device="cuda", fault=fault,
                                 min_runs=1)
            assert result["correct"] is False, fault


@pytest.mark.parametrize("flag", ["--control=tf32", "--fault=frozen_step",
                                  "--min-runs=1"])
def test_the_command_takes_no_check_option(flag):
    """A measured run cannot plant a fault, switch the control on or end
    after one run: the command has no such option."""
    with pytest.raises(SystemExit) as e:
        harness.main(["--workload", "gat_unet.cv3", "--seed", "1",
                      "--seconds", "0", flag], time.perf_counter())
    assert e.value.code == 2


def test_readings_go_through_the_harness(monkeypatch, capsys):
    """``readings.py`` reads each number through ``run_cell``: a sound
    run, and a planted fault that fails it."""
    from h100_bench import readings
    small = tiny("gat")
    monkeypatch.setattr(harness, "load_cell", lambda name: small)
    assert readings.main(["--workload", "gat_unet.cv3", "--seeds",
                          str(SEED), "--faults", "wrong_lr",
                          "--fault-seeds", str(SEED + 1),
                          "--device", "cpu"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["fault"], r["correct"]) for r in rows] == [
        (None, True), ("wrong_lr", False)]
    assert {"step_loss_gap", "update_norm_gap"} <= set(
        rows[0]["values"])


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell, cfg, mix, manifest = tiny("gsr")
    with pytest.raises(SystemExit):
        harness.run_cell(cell, cfg, mix, manifest, SEED, 0.0, 0,
                         time.perf_counter(), device="cuda")
