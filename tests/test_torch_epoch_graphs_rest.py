"""The last three trainers' epoch programs over static buffers, at the tiny
size (20 -> 32 nodes): the unfused GAT trainer (``train/gat_loop.py``,
2 levels), the MLP trainer (``train/generic_loop.py``, narrow widths) and
the GSR parity trainer (``train/gsr_loop.py::make_train_fn``).

On the CPU each program runs step by step, the path every CPU test takes:
here each is held bit for bit to the loop it replaced, written out below
(the per-step GAT epoch, the MLP epoch that uploaded its order and called
``step`` from Python, the parity trainer's nested loop), under both
controls, on 2 CPU shards, chunked and run twice. The warm-ups before a
capture (the MLP's masked epoch, the parity trainer's steps set back)
leave the state and the generator as they were, and the card path's
check refuses a non-capturable optimizer; neither needs a card. On the
card (``cuda``-marked, skipped here) each trainer's graphs are held bit
for bit to its eager run, the dropout draws of two epochs included. The
JAX package is held to these trainers by ``test_torch_gat_trainers.py``,
``test_torch_mlp_trainer.py``, ``test_torch_mlp_pipeline.py`` and
``test_torch_gsr_trainers.py``, whose runs take the same programs.
"""

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.core.normalize import unpad
from fcsr_tpu_torch.data import kfold_indices, synthesize_teacher_connectomes
from fcsr_tpu_torch.models import mlp as tmlp
from fcsr_tpu_torch.parallel import virtual_batch_mesh
from fcsr_tpu_torch.train import GSRTrainConfig, gat_loop
from fcsr_tpu_torch.train import generic_loop as tgl
from fcsr_tpu_torch.train import gsr_loop
from fcsr_tpu_torch.train.epoch_graph import warm_up
from fcsr_tpu_torch.train.losses import (gsr_composite_loss,
                                         make_triu_mse_criterion,
                                         pack_triu_targets)

GAT_TINY = dict(ks=(0.5, 0.5), n_nodes=20, m_nodes=32, dim=4, heads=2)
GSR_TINY = dict(lr_dim=20, hr_dim=32, hidden_dim=32, ks=(0.9, 0.7))
N_IN, N_OUT, HIDDEN = 20, 32, 26


def _data(n, seed):
    return synthesize_teacher_connectomes(n, lr_dim=N_IN, hr_dim=N_OUT,
                                          seed=seed)


# ---------------------------------------------------------------------------
# GAT, unfused step
# ---------------------------------------------------------------------------

def _gat_per_step_run_epoch(self):
    """The unfused GAT epoch as the trainer ran it from Python: the step
    scalars, each autograd step threaded through p, m, v, then the folds'
    mean losses, read from and written to the loaded buffers."""
    b = self.bufs
    ok = b["valid"] * b["active"]
    t_new = b["t"] + torch.cumsum(ok, dim=0)
    scal = torch.stack([ok, b["lr"].expand_as(ok), t_new.clamp(min=1.0)],
                       dim=-1)
    p, m, v = b["p"], b["m"], b["v"]
    losses = []
    for s in range(self.tr_len):
        loss, p, m, v = self._unfused_step(p, m, v, b["order"][s], scal[s])
        losses.append(loss)
    for name, x in (("p", p), ("m", m), ("v", v), ("t", t_new[-1])):
        b[name].copy_(x)
    total = (torch.stack(losses) * ok).T.contiguous().sum(1)
    b["loss"].copy_(total / ok.sum(0).clamp(min=1.0))


@torch.no_grad()
def _gat_python_validate(self):
    return self._validate(self.p)


def _gat_runs(drop_p, device="cpu", **kw):
    lr, hr = _data(10, 3)
    cfg = gat_loop.GATTrainConfig(epochs=2, drop_p=drop_p, **GAT_TINY)
    return gat_loop.train_gat_folds_parallel(
        cfg, lr, hr, kfold_indices(10, 3, seed=42), seed=42, device=device,
        **kw)


def _same_gat(a, b):
    for x, y in zip(a[2], b[2]):
        assert x == y
    for x, y in zip(a[1], b[1]):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("control", ["device", "host", "2 shards"])
@pytest.mark.parametrize("drop_p", [0.0, 0.01])
def test_gat_unfused_programs_equal_the_python_loop(monkeypatch, drop_p,
                                                    control):
    """``train_gat_folds_parallel`` with the unfused step (the shipped
    default), 2 epochs, through its epoch and validation programs against
    the same run with each epoch and validation pass from Python, under
    device control, host control and on 2 CPU shards (3 folds padded to
    4): best states and histories bit for bit."""
    kw = {"device": {}, "host": dict(host_control=True),
          "2 shards": dict(mesh=virtual_batch_mesh(2, "cpu"))}[control]
    got = _gat_runs(drop_p, **kw)
    monkeypatch.setattr(gat_loop._FoldTrainer, "run_epoch",
                        _gat_per_step_run_epoch)
    monkeypatch.setattr(gat_loop._FoldTrainer, "validate",
                        _gat_python_validate)
    _same_gat(got, _gat_runs(drop_p, **kw))


def test_gat_unfused_chunked_and_repeated_equal_a_fresh_run():
    """One host read per epoch against one per run, and a second run in
    the same process: bit-equal at drop_p 0.01."""
    ref = _gat_runs(0.01)
    _same_gat(_gat_runs(0.01, control_chunk_epochs=1), ref)
    _same_gat(_gat_runs(0.01), ref)


def test_train_gat_runs_the_programs():
    """``train_gat`` (one fold, host control, the unfused step) through the
    programs against its epochs from Python: the same best state, moments
    and history."""
    lr, hr = _data(10, 3)
    cfg = gat_loop.GATTrainConfig(epochs=2, **GAT_TINY)
    runs = []
    for patch in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if patch:
                mp.setattr(gat_loop._FoldTrainer, "run_epoch",
                           _gat_per_step_run_epoch)
                mp.setattr(gat_loop._FoldTrainer, "validate",
                           _gat_python_validate)
            model, opt = gat_loop.init_gat(cfg, seed=1, device="cpu")
            runs.append(gat_loop.train_gat(model, opt, cfg, lr[:7], hr[:7],
                                           lr[7:], hr[7:], seed=1))
    (va, oa, ha), (vb, ob, hb) = runs
    assert ha == hb and oa["t"] == ob["t"] == 14.0
    assert torch.equal(oa["m"], ob["m"]) and torch.equal(oa["v"], ob["v"])
    for k in va:
        np.testing.assert_array_equal(va[k], vb[k])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _python_epoch(self, perms, lr, active):
    """The MLP epoch as the trainer ran it from Python: a fresh order
    tensor, a step per full batch, then the ragged remainder."""
    order = torch.from_numpy(np.ascontiguousarray(perms)).to(self.dev).long()
    bs = self.batch_size
    n_full = self.n // bs
    losses = [self.step(order[:, b * bs:(b + 1) * bs], active, lr)
              for b in range(n_full)]
    if self.n % bs:
        losses.append(self.step(order[:, n_full * bs:], active, lr))
    return torch.stack(losses)


@torch.no_grad()
def _python_validate(self):
    pred, _ = self.model.fold_forward(self.pv, self.sv, self.x_va, False)
    return self.crit(pred, self.y_va)


@pytest.fixture(scope="module")
def mlp_data():
    lr, hr = _data(40, 3)
    r, c = np.triu_indices(N_IN, 1)
    return lr, hr, lr[:, r, c], pack_triu_targets(hr).astype(np.float32)


def _mlp(variant):
    if variant == "v2":
        return tmlp.SpectralResMLP(N_IN, N_OUT, HIDDEN, 1, dropout=0.1,
                                   output="vector", device="cpu")
    return tmlp.SuperResMLP(N_IN * N_IN, N_OUT * N_OUT, HIDDEN, 1,
                            dropout=0.1, device="cpu")


def _mlp_inputs(variant, data):
    lr, hr, x, y = data
    if variant == "v2":
        return x, y, make_triu_mse_criterion(N_OUT)
    return lr, hr, tgl.mse_criterion


MLP_KW = dict(num_epochs=5, lr=0.05, batch_size=8, patience=1,
              plateau_threshold=0.5, plateau_factor=0.05, seed=5,
              control_chunk_epochs=2)


def _train_model(variant, data, **kw):
    tm = _mlp(variant)
    x, y, crit = _mlp_inputs(variant, data)
    p, s = tm.init_flat([0], "cpu")
    return tgl.train_model(tm, (p, s), x[:30], y[:30], x[30:], y[30:],
                           criterion=crit, device="cpu",
                           **dict(MLP_KW, **kw))


def _same_mlp(a, b):
    assert a[:3] == b[:3]
    for k in a[3]:
        assert torch.equal(a[3][k], b[3][k]), k


@pytest.mark.parametrize("variant,control", [
    ("v2", "device"), ("v2", "host"), ("v1", "device"), ("v1", "host")])
def test_mlp_programs_equal_the_python_loop(monkeypatch, mlp_data, variant,
                                            control):
    """``train_model`` at dropout 0.1, 5 epochs (a decay, validation every
    epoch), through the epoch and validation programs against the same
    run with each epoch from Python: histories and best state bit for
    bit."""
    kw = dict(host_control=control == "host")
    got = _train_model(variant, mlp_data, **kw)
    monkeypatch.setattr(tgl._FoldTrainer, "epoch", _python_epoch)
    monkeypatch.setattr(tgl._FoldTrainer, "validate", _python_validate)
    _same_mlp(got, _train_model(variant, mlp_data, **kw))


def test_mlp_folds_program_chunked_and_repeated(monkeypatch, mlp_data):
    """``train_model_folds`` (3 folds, validation every second epoch)
    through the programs: equal to the Python loop, to one host read per
    epoch and to a second run."""
    _, _, x, y = mlp_data
    idx = np.stack([np.arange(30) + 3 * f for f in range(3)]) % 40
    va = (idx[:, :10] + 30) % 40

    def run(**kw):
        tm = _mlp("v2")
        p, s = tm.init_flat([0, 1, 2], "cpu")
        return tgl.train_model_folds(
            tm, (p, s), x[idx], y[idx], x[va], y[va], seeds=[5, 6, 7],
            criterion=make_triu_mse_criterion(N_OUT), validate_every=2,
            device="cpu", **{k: v for k, v in dict(MLP_KW, **kw).items()
                             if k != "seed"})
    ref = run()
    for other in (run(control_chunk_epochs=1), run()):
        for a, b in zip(other, ref):
            _same_mlp(a, b)
    monkeypatch.setattr(tgl._FoldTrainer, "epoch", _python_epoch)
    monkeypatch.setattr(tgl._FoldTrainer, "validate", _python_validate)
    for a, b in zip(run(), ref):
        _same_mlp(a, b)


def _fold_trainer(variant, data, seed=5):
    x, y, crit = _mlp_inputs(variant, data)
    tm = _mlp(variant)
    p, s = tm.init_flat([0, 1, 2], "cpu")
    idx = np.stack([np.arange(30) + 3 * f for f in range(3)]) % 40
    return tgl._FoldTrainer(tm, p, s, x[idx], y[idx], x[idx[:, :6]],
                            y[idx[:, :6]], seed, 8, crit, 1.0, 0.01,
                            torch.device("cpu"))


@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_mlp_masked_warm_up_leaves_state_and_generator(mlp_data, variant):
    """The capture's warm-up (``warm_up`` over the epoch program on
    ``masked_bufs``, then the validation program) after a trained epoch:
    p, m, v, the step counts, the statistics and the generator's state
    bit-unchanged, the loaded order and lr untouched; the next epoch then
    equals the one a trainer without the warm-up runs."""
    trainers = [_fold_trainer(variant, mlp_data) for _ in range(2)]
    perms = np.stack([np.random.default_rng(j).permutation(30)
                      for j in range(3)])
    lr, active = torch.full((3,), 0.05), torch.ones(3)
    for tr in trainers:
        tr.epoch(perms, lr, active)
    tr = trainers[0]
    before = [x.clone() for x in (tr.p, tr.m, tr.v, tr.t, tr.s,
                                  tr.bufs["order"], tr.bufs["lr"])]
    gen = tr.gen.get_state()
    masked = tr.masked_bufs()
    assert not masked["active"].any()
    assert masked["loss"].data_ptr() != tr.bufs["loss"].data_ptr()

    def warm():
        tr._epoch_program(masked)
        with torch.no_grad():
            tr._val_program(masked)
    warm_up(warm, [tr.gen])
    assert masked["loss"].abs().sum() > 0
    for a, b in zip(before, (tr.p, tr.m, tr.v, tr.t, tr.s,
                             tr.bufs["order"], tr.bufs["lr"])):
        assert torch.equal(a, b)
    assert torch.equal(tr.gen.get_state(), gen)
    got, want = (t.epoch(perms[:, ::-1], lr, active) for t in trainers)
    assert torch.equal(got, want) and torch.equal(tr.p, trainers[1].p)


# ---------------------------------------------------------------------------
# the GSR parity trainer
# ---------------------------------------------------------------------------

def _parity_stacks(n=5):
    lr, hr = _data(n, 2)
    u_lr, u_hr = gsr_loop.precompute_spectral(lr, hr, lr_dim=N_IN)
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in (lr, hr, u_lr, u_hr)]


def _python_train_fn(model, optimizer, cfg, per_step, stacks):
    """The parity trainer as it ran from Python: every subject of every
    epoch, one Adam step each, the losses stacked at the end."""
    lr_stack, hr_stack, u_lr, u_hr_red = stacks
    n = lr_stack.shape[0]
    losses, errs = [], []
    for _ in range(cfg.epochs):
        for i in range(n):
            pred, net_outs, start_outs, _ = model(lr_stack[i], u_lr=u_lr[i])
            loss, err = gsr_composite_loss(
                unpad(pred, cfg.padding), net_outs, start_outs,
                model.layer.weights, u_hr_red[i], hr_stack[i], cfg.lmbda)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
            errs.append(err.detach())
    loss_hist = torch.stack(losses).view(cfg.epochs, n)
    err_hist = torch.stack(errs).view(cfg.epochs, n)
    if per_step:
        return loss_hist, err_hist
    return loss_hist.mean(1), err_hist.mean(1)


def _same_parity(a, b):
    (ma, ha), (mb, hb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(ha, hb))
    for (k, x), (_, y) in zip(ma.state_dict().items(),
                              mb.state_dict().items()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("per_step", [False, True])
def test_parity_program_equals_the_python_loop(per_step):
    """``make_train_fn`` (2 epochs over 5 subjects) against the nested
    loop it replaced, from the same model and Adam: the histories (per
    epoch or per step) and the parameters bit for bit."""
    cfg = GSRTrainConfig(epochs=2, **GSR_TINY)
    stacks = _parity_stacks()
    model, opt = gsr_loop.init_gsr(cfg, seed=3, device="cpu")
    got = (model, gsr_loop.make_train_fn(model, opt, cfg, per_step)(*stacks))
    model, opt = gsr_loop.init_gsr(cfg, seed=3, device="cpu")
    _same_parity(got, (model, _python_train_fn(model, opt, cfg, per_step,
                                               stacks)))


def test_parity_epochs_in_two_calls_and_after_a_warm_up():
    """One ``train_fn`` of 1 epoch called twice (the second call on the
    optimizer state the first left) equals one call of 2 epochs; the
    capture's warm-up (2 steps, then the parameters and Adam's state set
    back) before each call changes nothing."""
    stacks = _parity_stacks()
    cfg2 = GSRTrainConfig(epochs=2, **GSR_TINY)
    cfg1 = GSRTrainConfig(epochs=1, **GSR_TINY)
    model, opt = gsr_loop.init_gsr(cfg2, seed=3, device="cpu")
    ref = (model, gsr_loop.make_train_fn(model, opt, cfg2, True)(*stacks))
    model, opt = gsr_loop.init_gsr(cfg1, seed=3, device="cpu")
    train_fn = gsr_loop.make_train_fn(model, opt, cfg1, True)
    hists = []
    for _ in range(2):
        train_fn._warm(stacks, 2)
        assert all(p.grad is None for p in model.parameters())
        hists.append(train_fn(*stacks))
    _same_parity(ref, (model, tuple(torch.cat(h) for h in zip(*hists))))


def test_card_path_refuses_a_non_capturable_optimizer():
    """The check the card path makes before it trains: ``OptaxAdam``, and
    Adam or AdamW with ``capturable=True``, pass; Adam without it or
    another optimizer is refused with a ValueError that says how to build
    one; ``init_gsr`` builds the card's optimizer (``OptaxAdam``) on the
    CPU too, and the CPU trains with any optimizer."""
    model = GSRTrainConfig(**GSR_TINY).model(device="cpu")
    params = list(model.parameters())
    for opt in (torch.optim.Adam(params, capturable=True),
                torch.optim.AdamW(params, capturable=True),
                gsr_loop.OptaxAdam(params, lr=1e-4)):
        gsr_loop._check_capturable(opt)
    for opt in (torch.optim.Adam(params), torch.optim.SGD(params, lr=0.1)):
        with pytest.raises(ValueError, match="capturable=True"):
            gsr_loop._check_capturable(opt)
    _, opt = gsr_loop.init_gsr(GSRTrainConfig(**GSR_TINY), device="cpu")
    assert type(opt) is gsr_loop.OptaxAdam
    gsr_loop.make_train_fn(model, torch.optim.Adam(params),
                           GSRTrainConfig(**GSR_TINY))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs run on the card only")


@pytest.mark.cuda
def test_gat_unfused_graph_equals_eager_on_card():
    """The unfused GAT trainer at drop_p 0.01 through its epoch and
    validation graphs against the same trainer from Python, 2 epochs from
    the same state: losses, parameters, dropout draws (the generator's
    state after each epoch) bit for bit."""
    _need_card()
    lr, hr = _data(10, 3)
    cfg = gat_loop.GATTrainConfig(epochs=2, drop_p=0.01, **GAT_TINY)
    runs = []
    for eager in (False, True):
        tr = gat_loop._FoldTrainer(cfg, lr, hr, kfold_indices(10, 3, seed=42),
                                   42, "cuda")
        if eager:
            tr._stay_eager()
        lr_t = torch.full((3,), 1e-3, device="cuda")
        active = torch.ones(3, device="cuda")
        out, gens = [], []
        for _ in range(2):
            out.append(tr.epoch(*tr.draw_epoch_plan(), lr_t, active))
            out.extend(tr.validate())
            gens.append(tr.gen.get_state())
        assert bool(tr._graphs) != eager
        runs.append(([x.cpu() for x in out] + [tr.p.cpu()], gens))
        tr.release_graphs()
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_mlp_graph_equals_eager_on_card(mlp_data, variant):
    """The MLP trainer at dropout 0.1 through its epoch and validation
    graphs against the same trainer from Python, 2 epochs under device
    control: histories, best state and the generator bit for bit, one
    ``adamw_masked`` a step through the replays."""
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts

    _need_card()
    x, y, crit = _mlp_inputs(variant, mlp_data)
    idx = np.stack([np.arange(30) + 3 * f for f in range(3)]) % 40
    runs = []
    for eager in (False, True):
        tm = _mlp(variant)
        p, s = tm.init_flat([0, 1, 2], "cuda")
        tr = tgl._FoldTrainer(tm, p, s, x[idx], y[idx], x[idx[:, :6]],
                              y[idx[:, :6]], 5, 8, crit, 1.0, 0.01,
                              torch.device("cuda"))
        if eager:
            tr._stay_eager()
        reset_launch_counts()
        rngs = [np.random.default_rng(j) for j in range(3)]
        hists, _, bp, bs = tgl._device_control(
            tr, rngs, 2, 0.05, lambda e: True, 1, 0.5, 0.05, 1e-5, 2)
        assert launch_counts()["adamw_masked"] == 2 * len(tr.batches)
        assert bool(tr._graphs) != eager
        runs.append((hists, bp.cpu(), bs.cpu(), tr.gen.get_state()))
        tr.release_graphs()
    (ha, pa, sa, ga), (hb, pb, sb, gb) = runs
    assert ha == hb and torch.equal(pa, pb) and torch.equal(sa, sb)
    assert torch.equal(ga, gb)


@pytest.mark.cuda
def test_parity_graph_equals_eager_on_card():
    """The parity trainer (``OptaxAdam`` from ``init_gsr``) through its
    epoch graph against the same trainer from Python, 2 epochs: per-step
    histories and parameters bit for bit; a non-capturable Adam is refused
    before anything trains."""
    _need_card()
    cfg = GSRTrainConfig(epochs=2, **GSR_TINY)
    stacks = [t.cuda() for t in _parity_stacks()]
    runs = []
    for eager in (False, True):
        model, opt = gsr_loop.init_gsr(cfg, seed=3, device="cuda")
        assert type(opt) is gsr_loop.OptaxAdam
        train_fn = gsr_loop.make_train_fn(model, opt, cfg, True)
        if eager:
            train_fn._stay_eager()
        hists = train_fn(*stacks)
        assert (train_fn.graph is None) == eager
        runs.append((model, tuple(h.cpu() for h in hists)))
    _same_parity(*runs)
    model = cfg.model(device="cuda")
    with pytest.raises(ValueError, match="capturable=True"):
        gsr_loop.make_train_fn(model, torch.optim.Adam(model.parameters()),
                               cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("trainer", ["gat", "mlp", "parity"])
def test_failed_capture_raises_naming_the_trainer(monkeypatch, mlp_data,
                                                  trainer):
    """A step that cannot be captured (a host read inside) makes the
    trainer raise, naming it; nothing trains in its place."""
    _need_card()

    def syncing(step):
        def wrapped(*a, **kw):
            out = step(*a, **kw)
            float(torch.as_tensor(out[0]).detach().sum())
            return out
        return wrapped
    if trainer == "gat":
        monkeypatch.setattr(gat_loop._FoldTrainer, "_unfused_step",
                            syncing(gat_loop._FoldTrainer._unfused_step))
        with pytest.raises(RuntimeError, match="unfused GAT epoch"):
            _gat_runs(0.01, device="cuda")
    elif trainer == "mlp":
        monkeypatch.setattr(tgl._FoldTrainer, "step",
                            syncing(tgl._FoldTrainer.step))
        with pytest.raises(RuntimeError, match="MLP epoch"):
            tm = _mlp("v2")
            x, y, crit = _mlp_inputs("v2", mlp_data)
            tgl.train_model(tm, tm.init_flat([0], "cuda"), x[:30], y[:30],
                            x[30:], y[30:], criterion=crit, device="cuda",
                            **MLP_KW)
    else:
        monkeypatch.setattr(gsr_loop, "gsr_composite_loss",
                            syncing(gsr_composite_loss))
        cfg = GSRTrainConfig(epochs=1, **GSR_TINY)
        model, opt = gsr_loop.init_gsr(cfg, device="cuda")
        with pytest.raises(RuntimeError, match="parity GSR-Net epoch"):
            gsr_loop.make_train_fn(model, opt, cfg)(
                *[t.cuda() for t in _parity_stacks()])
