"""The port's spans and counters (``fcsr_tpu_torch/utils/profiling.py``):
one record per CV run with the ``cv_run`` tree under one naming, the
``timings`` keys, the ``fcsr.*`` ranges in a ``torch.profiler`` trace,
nothing outside a run, the bounded list of runs, GAT's and the MLP
trainer's fold-epoch counters and loop spans. On the card
(``cuda``-marked): the epoch boundary events, the capture span against
the graph's own counters, and no host wait added."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from fcsr_tpu_torch import pipelines
from fcsr_tpu_torch.data import synthesize_teacher_connectomes
from fcsr_tpu_torch.train import GSRFoldRunner, GSRTrainConfig
from fcsr_tpu_torch.train import gat_loop
from fcsr_tpu_torch.train.gat_loop import GATTrainConfig
from fcsr_tpu_torch.utils import profiling
from fcsr_tpu_torch.utils.profiling import PhaseTimer

GSR_CFG = GSRTrainConfig(epochs=3, lr_dim=20, hr_dim=32, hidden_dim=32,
                         ks=(0.9, 0.7), fused_adam=True)
GAT_CFG = GATTrainConfig(ks=(0.5, 0.5), n_nodes=20, m_nodes=32, dim=4,
                         heads=2, drop_p=0.0, epochs=3)
PHASES = {"stage", "train", "fold_eval", "test_predict"}
GSR_LOOP = {"plan", "load_state", "epochs", "history_read", "state_out"}
GAT_LOOP = {"plan", "epoch", "control_read", "history_read"}
MLP_KW = dict(k_folds=2, num_epochs=3, batch_size=2, hidden=6)


@pytest.fixture(scope="module")
def data():
    lr, hr, lt = synthesize_teacher_connectomes(7, lr_dim=20, hr_dim=32,
                                                seed=3, n_test=2)
    return {"lr_train": lr, "hr_train": hr, "lr_test": lt}


def _one_run(fn):
    """``fn()``'s result and the one record it left."""
    before = profiling.recent_runs()
    res = fn()
    runs = profiling.recent_runs()
    assert len(runs) == min(len(before) + 1, profiling.RECENT_RUNS)
    assert runs[-1]["run"] not in {r["run"] for r in before}
    return res, runs[-1]


def _children(rec, parent):
    return [s for s in rec["spans"] if s["parent"] == parent]


def _subtree_names(rec, root):
    names, todo = set(), [root]
    while todo:
        i = todo.pop()
        for j, s in enumerate(rec["spans"]):
            if s["parent"] == i:
                names.add(s["name"])
                todo.append(j)
    return names


def _check_tree(rec, entry, loop):
    spans = rec["spans"]
    assert rec["entry"] == entry
    assert spans[0]["name"] == "cv_run" and spans[0]["parent"] is None
    assert sum(s["name"] == "cv_run" for s in spans) == 1
    kids = _children(rec, 0)
    assert {s["name"] for s in kids} == PHASES
    total = sum(s["seconds"] for s in kids)
    assert abs(total - spans[0]["seconds"]) <= 0.05 * spans[0]["seconds"]
    train = next(i for i, s in enumerate(spans) if s["name"] == "train")
    assert loop <= _subtree_names(rec, train)
    for s in spans:
        assert s["start"] <= s["end"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start"] <= s["start"] and s["end"] <= p["end"]
    # phases: each name's spans summed; on the CPU no epoch events
    assert rec["phases"]["cv_run"] == spans[0]["seconds"]
    assert rec["epoch_s"] == []


def test_gsr_fast_run_leaves_one_record_with_the_phase_tree(data):
    res, rec = _one_run(lambda: pipelines.run_gsr_cv_fast(
        data, GSR_CFG, splits=2, device="cpu"))
    _check_tree(rec, "run_gsr_cv_fast", GSR_LOOP)
    # one chunk: one of each loop span
    for name in GSR_LOOP:
        assert sum(s["name"] == name for s in rec["spans"]) == 1


def test_gat_fast_run_leaves_one_record_with_the_phase_tree(data):
    res, rec = _one_run(lambda: pipelines.run_gat_cv_fast(
        data, GAT_CFG, splits=2, device="cpu"))
    _check_tree(rec, "run_gat_cv_fast", GAT_LOOP)
    # a plan and an epoch span per epoch, one control read per chunk
    n = sum(s["name"] == "epoch" for s in rec["spans"])
    assert n == 3 == sum(s["name"] == "plan" for s in rec["spans"])
    assert sum(s["name"] == "control_read" for s in rec["spans"]) == 1


@pytest.mark.parametrize("entry,legacy", [("run_gsr_cv_fast", "eval"),
                                          ("run_gat_cv_fast", "predict")])
def test_fast_timings_keep_their_key_and_gain_the_phases(data, entry,
                                                         legacy):
    cfg = GSR_CFG if entry == "run_gsr_cv_fast" else GAT_CFG
    res, rec = _one_run(lambda: getattr(pipelines, entry)(
        data, cfg, splits=2, device="cpu"))
    t = res["timings"]
    assert set(t) == PHASES | {"capture", legacy}
    assert t[legacy] == t["fold_eval"]
    assert t["capture"] == 0.0                 # nothing is captured here
    for name in PHASES:
        # host seconds; on the CPU the record's are the same
        assert t[name] == pytest.approx(rec["phases"][name])


def test_gsr_fast_eval_stays_the_evaluation_alone(data):
    """With the metric suite, GSR's ``eval`` (and ``fold_eval``) times the
    fold evaluation alone, as it always has; the suite is the span
    ``fold_metrics`` beside it."""
    res, rec = _one_run(lambda: pipelines.run_gsr_cv_fast(
        data, GSR_CFG, splits=2, full_metrics=True, device="cpu"))
    kids = _children(rec, 0)
    assert [s["name"] for s in kids] == ["stage", "train", "fold_eval",
                                         "fold_metrics", "test_predict"]
    total = sum(s["seconds"] for s in kids)
    assert abs(total - rec["phases"]["cv_run"]) \
        <= 0.05 * rec["phases"]["cv_run"]
    t = res["timings"]
    assert t["eval"] == t["fold_eval"] == pytest.approx(
        rec["phases"]["fold_eval"])
    assert len(res["fold_metrics"]) == 2


def test_other_entries_name_their_phases_alike(data):
    res, rec = _one_run(lambda: pipelines.run_gsr_cv(
        data, dataclasses.replace(GSR_CFG, fused_adam=False, epochs=1),
        splits=2, device="cpu"))
    assert rec["entry"] == "run_gsr_cv"
    assert {s["name"] for s in _children(rec, 0)} == PHASES
    assert sorted(res["timings"]) == ["eval", "spectral", "train"]
    assert res["timings"]["spectral"] == rec["phases"]["stage"]
    assert res["timings"]["eval"] == rec["phases"]["fold_eval"]


def test_spans_sit_in_the_profiler_trace_as_they_nest(data):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, rec = _one_run(lambda: pipelines.run_gsr_cv_fast(
            data, GSR_CFG, splits=2, device="cpu"))
    ranges = {}
    for ev in prof.events():
        if ev.name.startswith("fcsr."):
            ranges.setdefault(ev.name[5:], []).append(
                (ev.time_range.start, ev.time_range.end))
    names = {s["name"] for s in rec["spans"]}
    assert set(ranges) == names
    for name, seen in ranges.items():
        assert len(seen) == sum(s["name"] == name for s in rec["spans"])
    for s in rec["spans"]:
        if s["parent"] is None:
            continue
        (a, b), = ranges[s["name"]]
        (pa, pb), = ranges[rec["spans"][s["parent"]]["name"]]
        assert pa <= a and b <= pb, s["name"]


def test_outside_a_run_spans_record_nothing():
    n = len(profiling.recent_runs())
    with profiling.span("plan"), profiling.phase("stage"):
        profiling.count("fold_epochs_run")
        clock = profiling.epoch_clock(["cpu"])
        clock.mark()
        clock.close()
    assert len(profiling.recent_runs()) == n
    assert profiling._RUN.get() is None
    # and a span is the profiler's range only while one records
    assert profiling.span("plan") is profiling.span("epoch")


def test_recent_runs_keeps_the_last_64():
    first = None
    for i in range(profiling.RECENT_RUNS + 6):
        with profiling.cv_run(f"test_{i}"):
            with profiling.span("stage"):
                profiling.count("things", 2)
        if first is None:
            first = profiling.recent_runs()[-1]["run"]
    runs = profiling.recent_runs()
    assert len(runs) == profiling.RECENT_RUNS == 64
    ids = [r["run"] for r in runs]
    assert ids == sorted(ids) and ids[0] > first
    assert runs[-1]["entry"] == f"test_{profiling.RECENT_RUNS + 5}"
    assert runs[-1]["counters"] == {"things": 2}
    assert [s["name"] for s in runs[-1]["spans"]] == ["cv_run", "stage"]


def test_a_run_that_raises_is_not_kept():
    n = profiling.recent_runs()[-1:]
    with pytest.raises(KeyError):
        with profiling.cv_run("fails"):
            raise KeyError("x")
    assert profiling.recent_runs()[-1:] == n
    assert profiling._RUN.get() is None


def test_phase_timer_keeps_each_span_and_its_parent():
    t = PhaseTimer()
    with t("a"):
        with t("b"):
            pass
        with t("b"):
            pass
    with t("c"):
        pass
    assert [(s[0], s[1]) for s in t.spans] == [("a", None), ("b", 0),
                                               ("b", 0), ("c", None)]
    rec = t.record()
    assert rec["phases"]["b"] == pytest.approx(
        sum(s["seconds"] for s in rec["spans"] if s["name"] == "b"))
    assert t.report() == {k: pytest.approx(v)
                          for k, v in rec["phases"].items()}


def test_gat_counts_its_useful_fold_epochs(data):
    """Folds that stop early run masked to the chunk's end: the record
    counts the fold-epochs run and those the folds trained in, which are
    the histories' lengths."""
    cfg = dataclasses.replace(GAT_CFG, epochs=6, patience=0,
                              plateau_factor=0.01, plateau_threshold=0.9)
    res, rec = _one_run(lambda: pipelines.run_gat_cv_fast(
        data, cfg, splits=2, device="cpu"))
    c = rec["counters"]
    trained = sum(len(h["train"]) for h in res["histories"])
    assert c["fold_epochs_active"] == trained
    assert c["fold_epochs_run"] == 6 * 2 > trained


def test_mlp_run_leaves_one_record_with_the_phase_tree(data):
    """``run_mlp_cv`` names its phases as the fast entries do, its control
    loop as GAT's: a plan per chunk, an epoch span per epoch, one read per
    chunk and one of the history."""
    res, rec = _one_run(lambda: pipelines.run_mlp_cv(data, **MLP_KW,
                                                     device="cpu"))
    _check_tree(rec, "run_mlp_cv", GAT_LOOP)
    count = {n: sum(s["name"] == n for s in rec["spans"]) for n in GAT_LOOP}
    assert count == {"plan": 1, "epoch": 3, "control_read": 1,
                     "history_read": 1}
    # staging is two spans: the pipeline's own and the trainer's
    # construction inside train_model_folds
    assert sum(s["name"] == "stage" for s in rec["spans"]) == 2


def test_mlp_timings_keep_their_keys_and_gain_the_phases(data):
    res, rec = _one_run(lambda: pipelines.run_mlp_cv(data, **MLP_KW,
                                                     device="cpu"))
    t = res["timings"]
    assert set(t) == PHASES | {"capture", "eval", "predict"}
    assert t["eval"] == t["fold_eval"] and t["predict"] == t["test_predict"]
    assert t["capture"] == 0.0                 # nothing is captured here
    for name in PHASES:
        assert t[name] == pytest.approx(rec["phases"][name])
    assert len(res["variables_per_fold"]) == 2
    assert res["variables_per_fold"][-1] is res["variables"]


def test_mlp_counts_its_fold_epochs(data, monkeypatch):
    """Device control: the fold-epochs run are the epochs run times the
    folds, those active the histories' epochs; a fold that stops early
    runs masked to the chunk's end."""
    from fcsr_tpu_torch.train import generic_loop
    seen = []

    def validate(tr):
        # fold 0 improves every epoch, fold 1 never after its first
        seen.append(1)
        return torch.tensor([1.0 / len(seen), 1.0])
    real = generic_loop._device_control

    def control(tr, rngs, epochs, lr0, flag, patience, *rest):
        # patience 0: fold 1's rate falls tenfold an epoch to the stop
        return real(tr, rngs, epochs, lr0, flag, 0, *rest)
    monkeypatch.setattr(generic_loop._FoldTrainer, "validate", validate)
    monkeypatch.setattr(generic_loop, "_device_control", control)
    res, rec = _one_run(lambda: pipelines.run_mlp_cv(
        data, **dict(MLP_KW, num_epochs=8), device="cpu"))
    c = rec["counters"]
    epochs = [len(h[0]) for h in res["histories"]]
    assert epochs[0] == 8 > epochs[1]
    assert c["fold_epochs_active"] == sum(epochs)
    assert c["fold_epochs_run"] == 8 * 2


def test_mlp_host_control_names_its_epochs_alike(data):
    """``train_model(host_control=True)`` in a run: per epoch a plan, an
    epoch and a control read; one fold-epoch run and active an epoch."""
    from fcsr_tpu_torch.models.mlp import SpectralResMLP
    from fcsr_tpu_torch.train.generic_loop import train_model
    from fcsr_tpu_torch.train.losses import (make_triu_mse_criterion,
                                             pack_triu_targets)
    model = SpectralResMLP(20, 32, 6, 0, output="vector", device="meta")
    p, s = model.init_flat([0], "cpu")
    r, c = np.triu_indices(20, 1)
    x, y = data["lr_train"][:, r, c], pack_triu_targets(data["hr_train"])
    with profiling.cv_run("test_mlp_host"):
        hists = train_model(model, (p[0], s[0]), x[:5], y[:5], x[5:], y[5:],
                            num_epochs=2, batch_size=2,
                            criterion=make_triu_mse_criterion(32),
                            host_control=True, device="cpu")
    rec = profiling.recent_runs()[-1]
    count = {n: sum(s["name"] == n for s in rec["spans"])
             for n in ("plan", "epoch", "control_read")}
    assert count == {"plan": 2, "epoch": 2, "control_read": 2}
    assert len(hists[0]) == 2
    assert rec["counters"] == {"fold_epochs_run": 2, "fold_epochs_active": 2}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the events and the graphs run on "
                    "the card only")


@pytest.mark.cuda
def test_epoch_events_and_capture_counters_on_card(data, monkeypatch):
    """A runner of two chunks of E epochs in a run: E + 1 boundary events
    a chunk, each complete when read; 2 E epoch times; the capture span's
    seconds are the graph's own warm-up, capture and instantiation
    (within 1%)."""
    _need_card()
    seen = []

    class Event(torch.cuda.Event):
        def elapsed_time(self, end):
            seen.append(self.query() and end.query())
            return super().elapsed_time(end)
    made = []

    def timing_event():
        made.append(Event(enable_timing=True))
        return made[-1]
    monkeypatch.setattr(profiling, "_timing_event", timing_event)
    E = 3
    cfg = dataclasses.replace(GSR_CFG, epochs=2 * E)
    with profiling.cv_run("test_chunks"):
        runner = GSRFoldRunner(cfg, data["lr_train"], data["hr_train"],
                               [(np.arange(4), np.arange(4, 7))] * 2,
                               device="cuda")
        # the boundary events are read after each chunk's history read
        n_read = []
        close = profiling.EpochClock.close

        def counting_close(self):
            n_read.append(len(seen))
            close(self)
            n_read[-1] = len(seen) - n_read[-1]
        monkeypatch.setattr(profiling.EpochClock, "close", counting_close)
        runner.train(chunk_epochs=E)
        graph = runner.shards[0].graph
    # the marks alone: a run opened without a device times no phase
    assert len(made) == 2 * (E + 1)
    assert n_read == [E, E] and all(seen)
    rec = profiling.recent_runs()[-1]
    assert len(rec["epoch_s"]) == 2 * E and min(rec["epoch_s"]) > 0
    own = graph.warm_s + graph.capture_s + graph.instantiate_s
    assert rec["phases"]["capture"] == pytest.approx(own, rel=0.01)
    assert sum(s["name"] == "capture" for s in rec["spans"]) == 1
    runner.release_graphs()


@pytest.mark.cuda
def test_gat_times_each_epoch_it_runs_on_card(data):
    """Two control chunks of GAT: one device time an epoch run (the
    chunk's first mark after its first plan), the fold-epochs run are the
    epochs times the folds, and the step graph's replays the epochs times
    the steps."""
    _need_card()
    cfg = dataclasses.replace(GAT_CFG, epochs=4)
    with profiling.cv_run("test_gat_chunks"):
        gat_loop.train_gat_folds_parallel(
            cfg, data["lr_train"], data["hr_train"],
            [(np.arange(4), np.arange(4, 7))] * 2, control_chunk_epochs=2,
            device="cuda")
    rec = profiling.recent_runs()[-1]
    assert len(rec["epoch_s"]) == 4 and min(rec["epoch_s"]) > 0
    assert rec["counters"]["fold_epochs_run"] == 4 * 2
    # the step graph replayed once a step: 4 epochs of 4 steps
    assert rec["counters"]["gat_step_replays"] == 4 * 4
    assert sum(s["name"] == "control_read" for s in rec["spans"]) == 2


@pytest.mark.cuda
def test_mlp_times_each_epoch_and_its_captures_on_card(data):
    """An MLP run on the card: one device time an epoch, the fold-epochs
    run, and two captures (the epoch and the validation graphs) whose
    spans' seconds are the run's ``capture`` timing."""
    _need_card()
    res, rec = _one_run(lambda: pipelines.run_mlp_cv(
        data, **dict(MLP_KW, num_epochs=4), device="cuda"))
    assert len(rec["epoch_s"]) == 4 and min(rec["epoch_s"]) > 0
    assert rec["counters"]["fold_epochs_run"] == 4 * 2
    assert sum(s["name"] == "capture" for s in rec["spans"]) == 2
    assert res["timings"]["capture"] == pytest.approx(
        rec["phases"]["capture"])


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["run_gsr_cv_fast", "run_gat_cv_fast",
                                   "run_mlp_cv"])
def test_spans_add_no_host_wait_on_card(data, monkeypatch, entry):
    """The host waits of one CV run (synchronize calls, reads to the host)
    with the spans, counters and events, and with all of them replaced by
    nothing: the same counts."""
    _need_card()
    if entry == "run_mlp_cv":
        def run(data, cfg, splits, device):
            return pipelines.run_mlp_cv(data, **MLP_KW, device=device)
        cfg = None
    else:
        cfg = GSR_CFG if entry == "run_gsr_cv_fast" else GAT_CFG
        run = getattr(pipelines, entry)
    calls = []

    def counted(owner, name):
        real = getattr(owner, name)

        def wrapper(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        monkeypatch.setattr(owner, name, wrapper)
    for owner, name in ((torch.cuda, "synchronize"),
                        (torch.cuda.Event, "synchronize"),
                        (torch.cuda.Stream, "synchronize"),
                        (torch.Tensor, "cpu"), (torch.Tensor, "item"),
                        (torch.Tensor, "__float__")):
        counted(owner, name)
    run(data, cfg, splits=2, device="cuda")        # builds and warms
    calls.clear()
    run(data, cfg, splits=2, device="cuda")
    traced = sorted(calls)

    @contextlib.contextmanager
    def bare_run(entry, device=None):
        yield PhaseTimer()
    monkeypatch.setattr(profiling, "cv_run", bare_run)
    monkeypatch.setattr(profiling, "span",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(profiling, "phase",
                        lambda name: contextlib.nullcontext())
    calls.clear()
    run(data, cfg, splits=2, device="cuda")
    assert traced == sorted(calls) and traced
