"""The readers of the program's spans and counters (``metrics/stage_s.py``,
``test_predict_s.py``, ``epoch_s.py``, ``train_busy_pct.py``,
``useful_fold_epoch_pct.py``) on a synthetic ``recent_runs()`` and a
synthetic window: each gives its number from the window's records alone,
and nothing where the records are too few or the program keeps none.

    python -m pytest h100_bench/tests -q
"""

import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402
from fcsr_tpu_torch.utils import profiling  # noqa: E402

READERS = ["stage_s", "test_predict_s", "epoch_s", "train_busy_pct",
           "useful_fold_epoch_pct"]


def _record(k, gat=True):
    """A run's record whose numbers all grow with ``k``."""
    rec = {"run": k, "entry": "run_gat_cv_fast",
           "phases": {"cv_run": 10.0 + k, "stage": 0.5 + k,
                      "test_predict": 0.25 + k},
           "counters": {}, "spans": [],
           "epoch_s": [0.1 * (k + 1), 0.2 * (k + 1), 0.4 * (k + 1)]}
    if gat:
        rec["counters"] = {"fold_epochs_run": 150,
                           "fold_epochs_active": 100 + k}
    return rec


def _ctx(n):
    return SimpleNamespace(runs=[{"run_s": 1.0}] * n, window_s=1.0,
                           flops=0, slice=None, work={})


@pytest.fixture
def records(monkeypatch):
    """Five records: a warm-up's, and a window of ``_ctx(3)`` preceded by
    one more; each reader must read only the last three."""
    recs = [_record(k) for k in range(5)]
    monkeypatch.setattr(profiling, "recent_runs", lambda: list(recs))
    return recs


def _expected(name, window):
    epochs = [s for r in window for s in r["epoch_s"]]
    if name == "stage_s":
        return statistics.mean(r["phases"]["stage"] for r in window)
    if name == "test_predict_s":
        return statistics.mean(r["phases"]["test_predict"] for r in window)
    if name == "epoch_s":
        return statistics.median(epochs)
    if name == "train_busy_pct":
        return 100.0 * sum(epochs) / sum(r["phases"]["cv_run"]
                                         for r in window)
    c = [r["counters"] for r in window]
    return 100.0 * sum(x["fold_epochs_active"] for x in c) / sum(
        x["fold_epochs_run"] for x in c)


@pytest.mark.parametrize("name", READERS)
def test_reader_takes_exactly_the_window(records, name):
    read = harness._metric_reader(name)
    got = read(_ctx(3))
    assert got == pytest.approx(_expected(name, records[-3:]))
    # any other window gives another number: the records are the last n
    assert got != pytest.approx(_expected(name, records[-4:-1]))
    assert got != pytest.approx(_expected(name, records[:3]))


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_nothing_from_too_few_records(records, name):
    read = harness._metric_reader(name)
    assert read(_ctx(4)) is not None
    # the window and no warm-up record before it: not the window's runs
    assert read(_ctx(5)) is None
    assert read(_ctx(6)) is None
    assert read(_ctx(0)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_nothing_where_the_program_keeps_no_records(
        monkeypatch, name):
    # a program without spans (the benchmark also runs an older tree)
    monkeypatch.delattr(profiling, "recent_runs", raising=False)
    assert harness._metric_reader(name)(_ctx(2)) is None


@pytest.mark.parametrize("name", READERS)
def test_gat_names_share_the_reader(records, name):
    assert harness._metric_reader(f"{name}.gat")(_ctx(3)) == \
        harness._metric_reader(name)(_ctx(3))


def test_useful_fold_epochs_need_the_gat_counters(monkeypatch):
    recs = [_record(k, gat=False) for k in range(4)]
    monkeypatch.setattr(profiling, "recent_runs", lambda: recs)
    assert harness._metric_reader("useful_fold_epoch_pct")(_ctx(3)) is None
    assert harness._metric_reader("epoch_s")(_ctx(3)) is not None


def test_runs_without_epoch_times_give_no_epoch_metrics(monkeypatch):
    # off the card a run records no epoch events
    recs = [dict(_record(k), epoch_s=[]) for k in range(4)]
    monkeypatch.setattr(profiling, "recent_runs", lambda: recs)
    assert harness._metric_reader("epoch_s")(_ctx(3)) is None
    assert harness._metric_reader("train_busy_pct")(_ctx(3)) is None
    assert harness._metric_reader("stage_s")(_ctx(3)) == pytest.approx(2.5)


def test_readers_read_a_real_run_on_the_cpu():
    """The program's own records of tiny CV runs, read as a window of
    two after a first run."""
    from fcsr_tpu_torch import pipelines
    from fcsr_tpu_torch.data import synthesize_teacher_connectomes
    from fcsr_tpu_torch.train.gat_loop import GATTrainConfig
    lr, hr, lt = synthesize_teacher_connectomes(7, lr_dim=20, hr_dim=32,
                                                seed=3, n_test=2)
    cfg = GATTrainConfig(ks=(0.5, 0.5), n_nodes=20, m_nodes=32, dim=4,
                         heads=2, drop_p=0.0, epochs=2)
    for _ in range(3):
        pipelines.run_gat_cv_fast({"lr_train": lr, "hr_train": hr,
                                   "lr_test": lt}, cfg, splits=2,
                                  device="cpu")
    ctx = _ctx(2)
    for name in ("stage_s", "test_predict_s"):
        assert harness._metric_reader(name)(ctx) > 0
    assert harness._metric_reader("useful_fold_epoch_pct")(ctx) == 100.0
    # no epoch events off the card
    assert harness._metric_reader("epoch_s")(ctx) is None
