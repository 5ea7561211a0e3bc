"""The trainers' epoch programs (``train/fast_loop.py``, ``train/gat_loop.py``)
over static buffers, at the tiny size (20 -> 32 nodes).

On the CPU each program runs step by step, the path every CPU test takes:
here it is held bit for bit to the per-step loop it replaced (each GSR
mode, the GAT fused and unfused steps at drop_p 0 and with a seed table),
through a second ``train()`` on one runner, chunking and both resume
formats. The launch counter that survives replays and the refusal to
capture under ``eager_debug`` need no card. On the card (``cuda``-marked,
skipped here) every mode's graphed run is held bit for bit to its eager
run and two virtual shards to the unsharded run. The JAX package is held
to these trainers by ``test_torch_fast_loop.py``,
``test_torch_gsr_trainers.py`` and ``test_torch_gat_trainers.py``, whose
runs take the same programs.
"""

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.data import kfold_indices, synthesize_teacher_connectomes
from fcsr_tpu_torch.kernels import ops
from fcsr_tpu_torch.models.fused_gat import gat_train_step_fused
from fcsr_tpu_torch.models.fused_step import adam_scalars
from fcsr_tpu_torch.parallel import virtual_batch_mesh
from fcsr_tpu_torch.train import GSRFoldRunner, GSRTrainConfig
from fcsr_tpu_torch.train import gat_loop
from fcsr_tpu_torch.train.epoch_graph import EpochGraph
from fcsr_tpu_torch.utils.debug import eager_debug

KS = (0.9, 0.7)
TINY = dict(lr_dim=20, hr_dim=32, hidden_dim=32, ks=KS)
MODES = {
    "unfused": {},
    "unfused_bf16": dict(compute_dtype="bf16"),
    "fused_tail": dict(fused_tail=True),
    "fused_tail_unet": dict(fused_tail=True, fused_unet=True),
    "fused_tail_unet_bwd": dict(fused_tail=True, fused_unet=True,
                                fused_unet_bwd=True),
    "fused_step": dict(fused_step=True),
    "fused_adam": dict(fused_adam=True),
}
GAT_TINY = dict(ks=(0.5, 0.5), n_nodes=20, m_nodes=32, dim=4, heads=2)


def _data(n=7, seed=2):
    return synthesize_teacher_connectomes(n, lr_dim=20, hr_dim=32, seed=seed)


def _runner(mode, epochs=3, device="cpu", **kw):
    lr, hr = _data()
    cfg = GSRTrainConfig(epochs=epochs, **TINY, **MODES[mode])
    return GSRFoldRunner(cfg, lr, hr, kfold_indices(7, 3, seed=42),
                         device=device, **kw)


def _same_run(a, b):
    """Two ``train()`` results bit-equal: parameters and both histories."""
    return (torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and np.array_equal(a[2], b[2]))


def _per_step_chunk(r, state, epochs):
    """The loop the epoch program replaced: every step of every epoch
    from Python through ``_step``, the state threaded from step to step,
    then the epoch means of the per-step loss and recon."""
    p, m, v, t = state
    n_steps = r.tr_idx.shape[1]
    losses, errs = [], []
    for _ in range(epochs):
        for s in range(n_steps):
            scal, t = adam_scalars(t, r.tr_valid[:, s])
            loss, err, p, m, v = r._step(p, m, v, s, torch.from_numpy(scal))
            losses.append(loss)
            errs.append(err)
    denom = np.maximum(r.tr_valid.sum(axis=1), 1.0)

    def means(xs):
        steps = torch.stack(xs).numpy()
        sums = np.ascontiguousarray(
            steps.T.reshape(-1, epochs, n_steps)).sum(axis=2)
        return sums / denom[:, None]
    return (p, m, v, t), means(losses), means(errs)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gsr_epoch_program_equals_the_per_step_loop(mode):
    """2 epochs (1 in bf16, slow on the CPU) over 3 folds of 5 / 5 / 4
    subjects (a masked slot in the short fold) in every mode: the program
    over the shards' static buffers gives the per-step loop's p, m, v,
    step counts and histories bit for bit, and hands back a copy of its
    buffers, not the buffers."""
    r = _runner(mode)
    epochs = 1 if mode == "unfused_bf16" else 2
    want = _per_step_chunk(r, r.fresh_state(), epochs)
    state, lh, eh = r._run_chunk(r.fresh_state(), epochs)
    for got, ref in zip(state[:3], want[0][:3]):
        assert torch.equal(got, ref)
    np.testing.assert_array_equal(state[3], want[0][3])
    np.testing.assert_array_equal(lh, want[1])
    np.testing.assert_array_equal(eh, want[2])
    bufs = r.shards[0].bufs
    assert state[0].data_ptr() != bufs["p"].data_ptr()
    assert torch.equal(state[0], bufs["p"])


@pytest.mark.parametrize("mode", ["fused_adam", "fused_tail_unet_bwd",
                                  "unfused"])
def test_gsr_train_twice_and_chunked_equal_a_fresh_run(mode):
    """A second ``train()`` on one runner copies the fresh state into the
    buffers the first run left behind; one chunk per epoch equals one
    chunk of all epochs; each is bit-equal to a fresh runner's run, whose
    result the later runs leave untouched."""
    ref = _runner(mode).train()
    kept = tuple(x.clone() if isinstance(x, torch.Tensor) else x.copy()
                 for x in ref)
    r = _runner(mode)
    assert _same_run(r.train(chunk_epochs=1), ref)
    assert _same_run(r.train(), ref)
    assert _same_run(r.train(chunk_epochs=2), ref)
    assert _same_run(ref, kept)


@pytest.mark.parametrize("suffix", [".npz", ".msgpack"])
def test_gsr_resume_into_used_buffers(tmp_path, suffix):
    """A blob written after epoch 1 by another runner, resumed by a runner
    whose buffers hold a whole earlier run: bit-equal to the straight
    run, in the port's ``.npz`` and in the JAX fast loop's msgpack blob."""
    ref = _runner("fused_adam").train()
    first = _runner("fused_adam")
    state, lh, eh = first._run_chunk(first.fresh_state(), 1)
    path = str(tmp_path / f"ck{suffix}")
    first.save_checkpoint(path, state, 1, lh, eh)
    r = _runner("fused_adam")
    r.train()
    assert _same_run(r.train(checkpoint_path=path, checkpoint_every=1), ref)


def test_gsr_mesh_program_equals_unsharded():
    """2 virtual shards of the CPU (3 folds padded to 4), each its own
    program over its own buffers, run shard after shard: bit-equal to the
    unsharded runner, chunked or not."""
    ref = _runner("fused_adam").train()
    r = _runner("fused_adam", mesh=virtual_batch_mesh(2, "cpu"))
    assert [sh.bufs["p"].shape[0] for sh in r.shards] == [2, 2]
    assert _same_run(r.train(chunk_epochs=2), ref)
    assert _same_run(r.train(), ref)


# ---------------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------------

def _gat_trainer(drop_p, fused, device="cpu", epochs=2):
    lr, hr = _data(10, seed=3)
    cfg = gat_loop.GATTrainConfig(epochs=epochs, drop_p=drop_p,
                                  fused_step=fused, **GAT_TINY)
    return cfg, lr, hr, gat_loop._FoldTrainer(
        cfg, lr, hr, kfold_indices(10, 3, seed=42), 42, device,
        fused=fused)


def _gat_per_step_epoch(tr, state, order, valid, lr_t, active_t, seeds):
    """The GAT epoch as the trainer ran it step by step before: the step
    scalars from the counts, each step through the step entry point (or
    the unfused autograd step), then the folds' mean losses."""
    p, m, v, t = state
    cfg = tr.cfg
    order_d = torch.from_numpy(np.ascontiguousarray(order.T)).long()
    ok = torch.from_numpy(np.ascontiguousarray(valid.T)) * active_t
    t_new = t + torch.cumsum(ok, dim=0)
    te = t_new.clamp(min=1.0)
    if tr.fused:
        scal = torch.stack([ok, lr_t.expand_as(ok), 1.0 - 0.9 ** te,
                            1.0 - 0.999 ** te], dim=-1).contiguous()
    else:
        scal = torch.stack([ok, lr_t.expand_as(ok), te], dim=-1)
    seeds = None if seeds is None else torch.from_numpy(seeds)
    losses = []
    for s in range(tr.tr_len):
        i = order_d[s]
        if tr.fused:
            loss, p, m, v = gat_train_step_fused(
                p, m, v, tr.a0_d[i], tr.x_d[i], tr.hr_d[i], scal[s],
                None if seeds is None else seeds[s], drop_p=cfg.drop_p,
                wd=cfg.weight_decay, device="cpu", **cfg.kernel_kwargs)
        else:
            loss, p, m, v = tr._unfused_step(p, m, v, i, scal[s])
        losses.append(loss)
    total = (torch.stack(losses) * ok).T.contiguous().sum(1)
    return (p, m, v, t_new[-1]), total / ok.sum(0).clamp(min=1.0)


@pytest.mark.parametrize("drop_p,fused", [(0.0, True), (0.01, True),
                                          (0.0, False)])
def test_gat_epoch_program_equals_the_per_step_loop(drop_p, fused):
    """Two epochs (fold 2 inactive and a lower lr in the second) through
    ``_FoldTrainer.epoch`` against the per-step loop from the same state,
    order and seed table: loss, p, m, v and step counts bit for bit; the
    validation program against ``_validate`` on the same weights."""
    cfg, _, _, tr = _gat_trainer(drop_p, fused)
    state = tuple(tr.bufs[k].clone() for k in ("p", "m", "v", "t"))
    rng = np.random.default_rng(5)
    for lr, active in ((1e-3, [1.0, 1.0, 1.0]), (1e-4, [1.0, 1.0, 0.0])):
        order, valid = tr.draw_epoch_plan()
        seeds = tr.draw_seeds()
        if fused and drop_p > 0:
            assert seeds.shape == (tr.tr_len, 3, 2)
        lr_t = torch.full((3,), lr, dtype=torch.float32)
        active_t = torch.tensor(active, dtype=torch.float32)
        state, want = _gat_per_step_epoch(tr, state, order, valid, lr_t,
                                          active_t, seeds)
        got = tr.epoch(order, valid, lr_t, active_t, seeds)
        assert torch.equal(got, want)
        for k, x in zip(("p", "m", "v", "t"), state):
            assert torch.equal(tr.bufs[k], x), k
        vloss, vmae = tr.validate()
        with torch.no_grad():
            ref = tr._validate(state[0])
        assert torch.equal(vloss, ref[0]) and torch.equal(vmae, ref[1])


@pytest.mark.parametrize("drop_p", [0.0, 0.01])
def test_gat_trainer_through_the_programs_is_repeatable(drop_p):
    """``train_gat_folds_parallel`` twice, under device and host control
    and on 2 virtual shards: bit-equal runs (the programs leave no state
    behind that a fresh trainer lacks)."""
    lr, hr = _data(10, seed=3)
    folds = kfold_indices(10, 3, seed=42)
    cfg = gat_loop.GATTrainConfig(epochs=3, drop_p=drop_p, fused_step=True,
                                  **GAT_TINY)
    runs = [gat_loop.train_gat_folds_parallel(
        cfg, lr, hr, folds, seed=42, device="cpu", control_chunk_epochs=2,
        **kw) for kw in ({}, {}, dict(mesh=virtual_batch_mesh(2, "cpu")))]
    host = gat_loop.train_gat_folds_parallel(cfg, lr, hr, folds, seed=42,
                                             device="cpu", host_control=True)
    for other in runs[1:] + [host]:
        for a, b in zip(other[2], runs[0][2]):
            # the host loop keeps lr in Python floats, the device loop in
            # float32 (no decay in 3 epochs: a decayed rate would differ in
            # its last bit, and the parameters after it)
            assert a["train"] == b["train"] and a["val"] == b["val"]
            np.testing.assert_array_equal(np.float32(a["lr"]),
                                          np.float32(b["lr"]))
        for a, b in zip(other[1], runs[0][1]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# launch counts across replays, and the refusal under eager_debug
# ---------------------------------------------------------------------------

class _Replays:
    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


def test_replays_count_the_launches_the_capture_recorded():
    """``recorded_launches`` hands back what was launched inside and sets
    every count back, also when the body raises; each replay adds the
    recorded launches once."""
    ops.reset_launch_counts()
    try:
        ops.KERNELS["adam_masked"].launches = 5
        with ops.recorded_launches() as made:
            ops.KERNELS["adam_masked"].launches += 2
            ops.KERNELS["bgemm_f32"].launches += 79
        assert made == {"adam_masked": 2, "bgemm_f32": 79}
        counts = ops.launch_counts()
        assert counts["adam_masked"] == 5 and counts["bgemm_f32"] == 0
        with pytest.raises(ValueError):
            with ops.recorded_launches() as lost:
                ops.KERNELS["l1_term"].launches += 3
                raise ValueError("a failed capture")
        assert lost == {"l1_term": 3}
        assert ops.launch_counts()["l1_term"] == 0
        graph = EpochGraph.__new__(EpochGraph)
        graph.graph, graph.launches = _Replays(), made
        for _ in range(3):
            graph.replay()
        counts = ops.launch_counts()
        assert graph.graph.n == 3
        assert counts["adam_masked"] == 5 + 3 * 2
        assert counts["bgemm_f32"] == 3 * 79
        assert sum(counts.values()) == 5 + 3 * 81
        ops.add_launches({"gather_rows": 4})
        assert ops.launch_counts()["gather_rows"] == 4
    finally:
        ops.reset_launch_counts()


def test_capture_is_refused_under_eager_debug():
    """A synchronize after every launch cannot be captured: the capture
    is refused before it touches a device, naming the program; outside
    ``eager_debug`` the flag is off again."""
    ran = []
    with eager_debug():
        with pytest.raises(RuntimeError, match="eager_debug"):
            EpochGraph("the fused_adam epoch", "cuda",
                       lambda: ran.append("program"),
                       lambda: ran.append("warm"))
    assert ran == [] and not ops.SYNC_EACH_LAUNCH


def test_cpu_runner_runs_the_program_under_eager_debug():
    """On the CPU nothing is captured, so ``eager_debug`` changes
    nothing: the same bits as without it."""
    ref = _runner("fused_adam", epochs=1).train()
    with eager_debug():
        got = _runner("fused_adam", epochs=1).train()
    assert _same_run(got, ref)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels and the graphs run on "
                    "the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_graph_equals_eager_on_card(mode):
    """Each mode's runner through its epoch graphs against the same runner
    step by step from Python (``_stay_eager``), 3 epochs: bit-equal, with
    the same launches counted through the replays."""
    _need_card()
    r = _runner(mode, device="cuda")
    ops.reset_launch_counts()
    graphed = r.train()
    counts = ops.launch_counts()
    assert r.shards[0].graph is not None
    r._stay_eager()
    ops.reset_launch_counts()
    eager = r.train()
    assert ops.launch_counts() == counts
    assert _same_run(graphed, eager)
    r.release_graphs()
    assert r.shards[0].graph is None


@pytest.mark.cuda
def test_two_virtual_shards_equal_unsharded_on_card():
    """The fused_adam runner on 2 virtual shards of the card (3 folds
    padded to 4), one graph per shard: bit-equal to the unsharded run."""
    _need_card()
    ref = _runner("fused_adam", device="cuda").train()
    r = _runner("fused_adam", mesh=virtual_batch_mesh(2, "cuda"))
    assert _same_run(r.train(), ref)
    assert all(sh.graph is not None for sh in r.shards)


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.01])
def test_gat_graph_equals_eager_on_card(drop_p):
    """The fused GAT trainer's epoch and validation graphs against the
    same trainer from Python, 2 epochs from the same state: bit-equal."""
    _need_card()
    runs = []
    for eager in (False, True):
        _, _, _, tr = _gat_trainer(drop_p, True, device="cuda")
        if eager:
            tr._stay_eager()
        lr_t = torch.full((3,), 1e-3, device="cuda")
        active = torch.ones(3, device="cuda")
        out = []
        for _ in range(2):
            out.append(tr.epoch(*tr.draw_epoch_plan(), lr_t, active))
            out.extend(tr.validate())
        assert bool(tr._graphs) != eager
        runs.append([x.cpu() for x in out] + [tr.p.cpu()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_failed_capture_raises_naming_the_mode(monkeypatch):
    """A step that cannot be captured (a host synchronize inside) makes
    ``train()`` raise, naming the mode; nothing trains in its place."""
    _need_card()
    from fcsr_tpu_torch.train import fast_loop

    step = fast_loop._FoldShard.step

    def syncing(self, *a, **kw):
        out = step(self, *a, **kw)
        float(out[0].sum())
        return out
    monkeypatch.setattr(fast_loop._FoldShard, "step", syncing)
    with pytest.raises(RuntimeError, match="fused_adam epoch"):
        _runner("fused_adam", device="cuda").train()
