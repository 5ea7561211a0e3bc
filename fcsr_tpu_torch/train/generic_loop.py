"""Generic batched training loop (the MLP family). Counterpart of
``fcsr_tpu/train/generic_loop.py``: AdamW (optax's, the decay inside the
step), ReduceLROnPlateau (torch semantics), a per-fold global-norm clip,
validation every ``validate_every`` epochs, best-validation restore and an
early stop once the learning rate falls below ``min_lr_stop``.

Every run trains F folds together (``train_model`` is F = 1) on flat
buffers: parameters p (F, P) and statistics s (F, S) (BatchNorm running
mean / var, spectral-norm u / v) in the model's ``MLPLayout``. One step is
autograd over the model's ``fold_forward`` (all folds in one batched pass,
the gradient accumulated straight into a flat (F, P) buffer), the per-fold
global-norm clip in place (optax's: g below the norm, else (g / |g|) *
clip_norm), then one ``ops.adamw_masked`` launch over the (F, P) buffers
with ``scal[f] = [active, lr, 1 - 0.9^t, 1 - 0.999^t]`` that updates p, m
and v in place (v1 at full width holds 11.7 GB per copy of its three
folds' parameters). An epoch is the full batches of a per-fold shuffle and
then the ragged remainder as its own step, so BatchNorm sees the reference
loader's batches; its training loss is the mean of its batch losses.

An epoch is one program over static buffers (the (F, n) sample order,
each fold's lr and active flag, the (steps, F) batch losses), as the JAX
package's ``train_epoch_full`` is one compiled scan
(``fcsr_tpu/train/generic_loop.py:116-131``), and a validation pass a
second one (the (F,) losses). On the card each is captured once per
trainer as a CUDA graph (``train/epoch_graph.py``; the validation graph
in the epoch graph's memory pool) and replayed once an epoch; on the CPU
the same programs run step by step. The warm-up before a capture runs on
the live state with every step masked (``active`` 0), which leaves p, m,
v, the step counts and the statistics as they were (v1 at full width has
no room for scratch copies), and the dropout generator is set back after
it and registered with the graph.

Control runs on the device by default: the plateau scheduler, the best
state (parameters and statistics) and the early-stop mask are float32
tensors, with one host read per ``control_chunk_epochs`` epochs;
``host_control=True`` keeps the per-epoch host loop in Python floats. In
a run (``utils/profiling.py``) both loops are the spans ``plan`` (the
host's permutations), ``epoch`` (an epoch's enqueue and its control ops),
``control_read`` (the chunk's read; an epoch's on the host loop) and, on
the device, ``history_read``, with a timing event at each epoch boundary
of a chunk and the counters ``fold_epochs_run`` / ``fold_epochs_active``
(the fold-epochs run, and those a fold trained in). The
shuffle plans come from ``np.random.default_rng(seed)`` in the JAX
package's sequence. Dropout masks come from a ``torch.Generator`` seeded
with the run's (first) seed, not from JAX's threefry keys: at dropout > 0
runs agree with the JAX package in distribution only; at dropout 0 they
agree with it run for run (tested).
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from fcsr_tpu_torch.iox.weights import mlp_leaves_to_state, mlp_state_to_flat
from fcsr_tpu_torch.kernels.ops import KERNEL_OPS
from fcsr_tpu_torch.train.epoch_graph import EpochGraph, upload as _upload
from fcsr_tpu_torch.utils import profiling
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["PlateauScheduler", "TrainState", "mse_criterion", "train_model",
           "train_model_folds", "fold_state"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class PlateauScheduler:
    """``torch.optim.lr_scheduler.ReduceLROnPlateau(mode='min')`` semantics
    in Python floats: relative-threshold improvement tracking, ``patience``
    bad epochs, then a multiplicative ``factor`` decay."""

    def __init__(self, lr: float, patience: int = 10, factor: float = 0.1,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 min_lr: float = 0.0):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        if self.threshold_mode == "rel":
            return metric < self.best * (1.0 - self.threshold)
        return metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr


@dataclass
class TrainState:
    variables: dict          # state_dict mapping (torch names)
    opt_state: dict          # {"m", "v": flat (P,) moments, "t": steps}


def mse_criterion(pred, target):
    return torch.mean((pred - target) ** 2)


def fold_state(model, p, s, j: int):
    """Fold j of flat (F, P) / (F, S) buffers as a state_dict of views."""
    layout = model.layout
    return mlp_leaves_to_state(
        {k: v[j] for k, v in layout.params.views(p).items()},
        {k: v[j] for k, v in layout.stats.views(s).items()})


def _on(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)


def _flat_buffers(model, variables, n_folds: int, dev, stacked: bool = True):
    """(p (F, P), s (F, S)) float32 on ``dev`` from a (p, s) pair (tensors
    already there, float32 and contiguous, are trained in place) or a
    state_dict mapping, whose leaves carry a leading fold axis if
    ``stacked``."""
    layout = model.layout
    if isinstance(variables, (tuple, list)):
        p, s = (_on(x, dev).reshape(n_folds, -1) for x in variables)
    else:
        host = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                              else v) for k, v in variables.items()}
        if not stacked:
            host = {k: v[None] for k, v in host.items()}
        flats = [mlp_state_to_flat({k: v[j] for k, v in host.items()})
                 for j in range(n_folds)]
        p, s = (torch.from_numpy(np.stack(x)).to(dev) for x in zip(*flats))
    if p.shape != (n_folds, layout.params.size) \
            or s.shape != (n_folds, layout.stats.size):
        raise ValueError(f"variables give {tuple(p.shape)} parameters and "
                         f"{tuple(s.shape)} statistics; the model needs "
                         f"{(n_folds, layout.params.size)} and "
                         f"{(n_folds, layout.stats.size)}")
    return p.contiguous(), s.contiguous()


class _FoldTrainer:
    """The state of F folds trained together and the step, epoch and
    validation passes over it, the two passes programs over static buffers
    (``bufs``), each one CUDA graph on the card. ``ops`` picks the
    update's op namespace (``KERNEL_OPS``: the kernel for CUDA tensors,
    the plain version for CPU ones)."""

    def __init__(self, model, p, s, x_tr, y_tr, x_va, y_va, seed: int,
                 batch_size: int, criterion: Callable, clip_norm: float,
                 weight_decay: float, dev):
        self.model, self.dev = model, dev
        self.p, self.s = p, s
        self.F = F = p.shape[0]
        self.m, self.v, self.g = (torch.zeros_like(p) for _ in range(3))
        self.t = torch.zeros(F, dtype=torch.float32, device=dev)
        layout = model.layout
        self.pv = layout.params.views(p)
        for view, grad in zip(self.pv.values(),
                              layout.params.views(self.g).values()):
            view.requires_grad_()
            view.grad = grad
        self.sv = layout.stats.views(s)
        self.x_tr, self.y_tr = _on(x_tr, dev), _on(y_tr, dev)
        self.x_va, self.y_va = _on(x_va, dev), _on(y_va, dev)
        self.n = self.x_tr.shape[1]
        self.batch_size = batch_size
        self.folds = torch.arange(F, device=dev)[:, None]
        self.crit = torch.vmap(criterion)
        self.clip_norm, self.wd = float(clip_norm), float(weight_decay)
        self.gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.ops = KERNEL_OPS
        # an epoch's batches: the full ones, then the ragged remainder
        bs = batch_size
        self.batches = [(b * bs, (b + 1) * bs) for b in range(self.n // bs)]
        if self.n % bs:
            self.batches.append((self.n - self.n % bs, self.n))

        # the programs' static buffers (a graph reads and writes fixed
        # addresses) beside the state: an epoch's (F, n) sample order, each
        # fold's lr and active flag, the outputs
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(*shape, dtype=dtype, device=dev)
        self.bufs = dict(order=zeros(F, self.n, dtype=torch.int64),
                         lr=zeros(F), active=zeros(F),
                         loss=zeros(len(self.batches), F), vloss=zeros(F))
        self._graphs = {}
        self._eager = False

    def step(self, idx, ok, lr):
        """One step of every fold on its samples ``idx`` (F, B) (long, on
        the device), with ``ok`` (F,) (1 where the fold trains) and ``lr``
        (F,) float32 on the device; returns the (F,) batch losses. Nothing
        is read back to the host."""
        x, y = self.x_tr[self.folds, idx], self.y_tr[self.folds, idx]
        pred, new = self.model.fold_forward(self.pv, self.sv, x, True,
                                            self.gen)
        loss = self.crit(pred, y)
        self.g.zero_()
        with warnings.catch_warnings():
            # the leaves are strided views of p, their gradients the same
            # views of g: the sums land in g in place
            warnings.filterwarnings("ignore", "grad and param do not obey")
            loss.sum().backward()
        norm = torch.linalg.vector_norm(self.g, dim=1)
        clip = norm >= self.clip_norm
        self.g.div_(torch.where(clip, norm, 1.0)[:, None])
        if self.clip_norm != 1.0:
            self.g.mul_(torch.where(clip, self.clip_norm, 1.0)[:, None])
        self.t += ok
        te = self.t.clamp(min=1.0)
        scal = torch.stack([ok, lr, 1.0 - ADAM_B1 ** te,
                            1.0 - ADAM_B2 ** te], dim=-1)
        loss = loss.detach()
        self.ops.adamw_masked(self.p, self.m, self.v, self.g, scal,
                              loss[:, None], ADAM_B1, ADAM_B2, ADAM_EPS,
                              self.wd, inplace=True)
        if new:
            torch.where(ok[:, None] > 0,
                        torch.cat([t.reshape(self.F, -1)
                                   for t in new.values()], dim=1),
                        self.s, out=self.s)
        return loss

    def _epoch_program(self, b: dict) -> None:
        """The epoch program over the buffers ``b`` (``bufs``' keys): a step
        per batch of ``b["order"]`` with ``b["active"]`` and ``b["lr"]``,
        the state updated in place, the batch losses into ``b["loss"]``."""
        torch.stack([self.step(b["order"][:, lo:hi], b["active"], b["lr"])
                     for lo, hi in self.batches], out=b["loss"])

    def _val_program(self, b: dict) -> None:
        pred, _ = self.model.fold_forward(self.pv, self.sv, self.x_va, False)
        b["vloss"].copy_(self.crit(pred, self.y_va))

    def _run(self, name: str, program) -> None:
        """``program(bufs)``: on the card the replay of its graph (captured
        at first use after a warm-up with every step masked, the dropout
        generator set back after it; validation in the epoch graph's
        pool), on the CPU the program itself."""
        if self._eager or self.dev.type != "cuda":
            program(self.bufs)
            return
        graph = self._graphs.get(name)
        if graph is None:
            masked = self.masked_bufs()
            epoch = self._graphs.get("epoch")
            graph = self._graphs[name] = EpochGraph(
                f"the MLP {name} ({self.F} folds)", self.dev,
                lambda: program(self.bufs), lambda: program(masked),
                generators=(self.gen,),
                pool=None if epoch is None else epoch.graph.pool())
        graph.replay()

    def masked_bufs(self) -> dict:
        """The warm-up's buffers: ``bufs`` with every fold inactive (each
        step masked) and scratch outputs."""
        b = self.bufs
        return dict(b, active=torch.zeros_like(b["active"]),
                    loss=b["loss"].clone(), vloss=b["vloss"].clone())

    def epoch(self, perms, lr, active):
        """One epoch of every fold: ``perms`` (F, n) sample orders (host
        ints), ``lr`` and ``active`` (F,) float32 on the device. Returns
        the (steps, F) batch losses on the device."""
        b = self.bufs
        _upload(b["order"], np.ascontiguousarray(perms, dtype=np.int64))
        b["lr"].copy_(lr)
        b["active"].copy_(active)
        self._run("epoch", self._epoch_program)
        return b["loss"].clone()

    @torch.no_grad()
    def validate(self):
        """Each fold's validation loss, (F,) on the device."""
        self._run("validation", self._val_program)
        return self.bufs["vloss"].clone()

    def _stay_eager(self, eager: bool = True) -> None:
        """Run every later epoch and validation pass from Python on the
        card too (``eager=False``: through the graphs again): the
        yardstick the graphs are held to, bit for bit."""
        self._eager = eager

    def release_graphs(self) -> None:
        """Free the captured programs and their memory."""
        for graph in self._graphs.values():
            graph.release()
        self._graphs = {}


def _log_epochs(hists, flags, lr0, verbose, logger):
    """The device-control path's per-epoch report, after the run."""
    train_hist, val_hist, lr_hist = hists
    vi = 0
    for e, tr in enumerate(train_hist):
        vloss = val_hist[vi] if flags[e] else None
        cur = lr_hist[vi] if flags[e] else (lr_hist[vi - 1] if vi else lr0)
        vi += int(bool(flags[e]))
        if logger is not None:
            logger.log("epoch", epoch=e + 1, train_loss=tr, val_loss=vloss,
                       lr=cur)
        if verbose:
            print(f"epoch {e + 1}: train {tr:.6f} val "
                  f"{vloss if vloss is not None else float('nan'):.6f} "
                  f"lr {cur:.2e}")


def _device_control(tr: _FoldTrainer, rngs, num_epochs, lr0, validate_flag,
                    patience, thr, factor, min_lr_stop, chunk_epochs):
    """The JAX package's on-device control, the plateau scheduler's logic
    vectorized over the folds in float32 tensors; one host read per chunk
    of epochs (have all folds stopped?) and one at the end. Returns the
    per-fold histories, the validate flags and the selected (p, s): the
    best validation state, or the final one where no loss was finite."""
    F, dev = tr.F, tr.dev
    stop_lr = float(np.float32(min_lr_stop))        # compared in float32
    lr = torch.full((F,), lr0, dtype=torch.float32, device=dev)
    active = torch.ones(F, dtype=torch.float32, device=dev)
    sbest = torch.full((F,), float("inf"), dtype=torch.float32, device=dev)
    nbad = torch.zeros(F, dtype=torch.int32, device=dev)
    bval = sbest.clone()
    inf = sbest.clone()
    bp, bs = tr.p.clone(), tr.s.clone()
    parts, flags = [], []
    done = 0
    while done < num_epochs:
        chunk = min(chunk_epochs, num_epochs - done)
        clock = profiling.epoch_clock([dev])
        with profiling.span("plan"):
            perms = np.stack([np.stack([rng.permutation(tr.n)
                                        for _ in range(chunk)])
                              for rng in rngs])
        clock.mark()
        for e in range(chunk):
            with profiling.span("epoch"):
                do_val = validate_flag(done + e)
                tr_loss = tr.epoch(perms[:, e], lr, active).mean(0)
                vloss = tr.validate() if do_val else inf
                upd = (active > 0) & do_val
                is_better = vloss < sbest * (1.0 - thr)
                sbest2 = torch.where(is_better, vloss, sbest)
                nbad2 = torch.where(is_better, 0, nbad + 1)
                decay = nbad2 > patience
                lr2 = torch.where(decay, lr * factor, lr)
                nbad2 = torch.where(decay, 0, nbad2)
                sbest = torch.where(upd, sbest2, sbest)
                nbad = torch.where(upd, nbad2, nbad)
                lr2 = torch.where(upd, lr2, lr)
                improved = upd & (vloss < bval)
                bval = torch.where(improved, vloss, bval)
                torch.where(improved[:, None], tr.p, bp, out=bp)
                torch.where(improved[:, None], tr.s, bs, out=bs)
                # ``active`` at the epoch's start: the epochs the fold ran
                parts.append(torch.stack([tr_loss, vloss, lr2, active]))
                active = torch.where(upd & (lr2 < stop_lr), 0.0, active)
                lr = lr2
                flags.append(do_val)
            clock.mark()
        done += chunk
        with profiling.span("control_read"):
            still_active = float(active.max())  # one read per chunk
        clock.close()
        if still_active == 0.0:
            break
    finite = torch.isfinite(bval)[:, None]
    torch.where(finite, bp, tr.p, out=bp)
    torch.where(finite, bs, tr.s, out=bs)
    with profiling.span("history_read"):
        hist = torch.stack(parts).cpu().numpy()     # (epochs, 4, F)
    profiling.count("fold_epochs_run", hist.shape[0] * F)
    profiling.count("fold_epochs_active", int((hist[:, 3] > 0).sum()))
    flags = np.asarray(flags, dtype=bool)
    hists = []
    for j in range(F):
        on = hist[:, 3, j] > 0
        von = on & flags
        hists.append(([float(x) for x in hist[on, 0, j]],
                      [float(x) for x in hist[von, 1, j]],
                      [float(x) for x in hist[von, 2, j]]))
    return hists, flags, bp, bs


def _host_control(tr: _FoldTrainer, rng, num_epochs, lr0, validate_flag,
                  patience, thr, factor, min_lr_stop, verbose, logger):
    """The JAX package's per-epoch host loop for one run (F = 1): the
    scheduler in Python floats, one host read per epoch; the best state is
    copied on the device. Returns the histories and the selected (p, s)."""
    dev = tr.dev
    scheduler = PlateauScheduler(lr0, patience=patience, factor=factor,
                                 threshold=thr)
    cur_lr = lr0
    one = torch.ones(1, dtype=torch.float32, device=dev)
    train_hist, val_hist, lr_hist = [], [], []
    best_val = float("inf")
    bp = bs = None
    vloss = None
    for epoch in range(num_epochs):
        clock = profiling.epoch_clock([dev])
        with profiling.span("plan"):
            perm = rng.permutation(tr.n)
        clock.mark()
        with profiling.span("epoch"):
            validate = validate_flag(epoch)
            lr_t = torch.full((1,), cur_lr, dtype=torch.float32, device=dev)
            losses = tr.epoch(perm[None], lr_t, one)[:, 0]
            if validate:
                losses = torch.cat([losses, tr.validate()])
        clock.mark()
        with profiling.span("control_read"):
            packed = losses.cpu().numpy()       # one read per epoch
        clock.close()
        profiling.count("fold_epochs_run")
        profiling.count("fold_epochs_active")
        n_steps = len(packed) - int(validate)
        train_hist.append(float(np.mean(packed[:n_steps].tolist())))
        if validate:
            vloss = float(packed[-1])
            val_hist.append(vloss)
            cur_lr = scheduler.step(vloss)
            lr_hist.append(cur_lr)
            if vloss < best_val:
                best_val = vloss
                if bp is None:
                    bp, bs = tr.p.clone(), tr.s.clone()
                else:
                    bp.copy_(tr.p)
                    bs.copy_(tr.s)
            if cur_lr < min_lr_stop:
                break
        vloss_log = vloss if validate and val_hist else None
        if logger is not None:
            logger.log("epoch", epoch=epoch + 1, train_loss=train_hist[-1],
                       val_loss=vloss_log, lr=cur_lr)
        if verbose:
            print(f"epoch {epoch + 1}: train {train_hist[-1]:.6f} val "
                  f"{vloss_log if vloss_log is not None else float('nan'):.6f}"
                  f" lr {cur_lr:.2e}")
    if bp is None:
        bp, bs = tr.p, tr.s
    return (train_hist, val_hist, lr_hist), bp, bs


def _validate_flag(validate_every: int, num_epochs: int):
    return lambda epoch: ((epoch + 1) % validate_every == 0
                          or (epoch + 1) == num_epochs)


def train_model(model, variables, lr_train, hr_train, lr_val, hr_val,
                num_epochs: int = 100, lr: float = 0.01,
                batch_size: int = 32, validate_every: int = 1,
                patience: int = 10, plateau_threshold: float = 1e-4,
                plateau_factor: float = 0.1, clip_norm: float = 1.0,
                weight_decay: float = 0.01,
                criterion: Callable = mse_criterion,
                min_lr_stop: float = 1e-5, seed: int = 0,
                verbose: bool = False, logger=None,
                host_control: bool = False,
                control_chunk_epochs: int = 25, device=DEFAULT_DEVICE):
    """Train one model of ``models/mlp.py`` from ``variables`` (its
    state_dict mapping, or a flat (p, s) pair) on (N, ...) train /
    validation stacks; returns (train_hist, val_hist, lr_hist,
    best_variables), the best validation state as a state_dict of tensors
    on ``device`` (the final state if no validation loss was finite)."""
    dev = resolve_device(device)
    p, s = _flat_buffers(model, variables, 1, dev, stacked=False)
    tr = _FoldTrainer(model, p, s, _on(lr_train, dev)[None],
                      _on(hr_train, dev)[None], _on(lr_val, dev)[None],
                      _on(hr_val, dev)[None], seed, batch_size, criterion,
                      clip_norm, weight_decay, dev)
    rng = np.random.default_rng(seed)
    flag = _validate_flag(validate_every, num_epochs)
    if host_control:
        hists, bp, bs = _host_control(
            tr, rng, num_epochs, lr, flag, patience, plateau_threshold,
            plateau_factor, min_lr_stop, verbose, logger)
    else:
        (hists,), flags, bp, bs = _device_control(
            tr, [rng], num_epochs, lr, flag, patience, plateau_threshold,
            plateau_factor, min_lr_stop, max(1, int(control_chunk_epochs)))
        if verbose or logger is not None:
            _log_epochs(hists, flags, lr, verbose, logger)
    tr.release_graphs()
    return (*hists, fold_state(model, bp, bs, 0))


def train_model_folds(model, variables_stack, lr_train_f, hr_train_f,
                      lr_val_f, hr_val_f, seeds,
                      num_epochs: int = 100, lr: float = 0.01,
                      batch_size: int = 32, validate_every: int = 1,
                      patience: int = 10, plateau_threshold: float = 1e-4,
                      plateau_factor: float = 0.1, clip_norm: float = 1.0,
                      weight_decay: float = 0.01,
                      criterion: Callable = mse_criterion,
                      min_lr_stop: float = 1e-5,
                      control_chunk_epochs: int = 25,
                      return_stacked: bool = False, device=DEFAULT_DEVICE,
                      phases=None):
    """Train F folds of one model configuration together under on-device
    control: ``variables_stack`` is a state_dict mapping whose leaves carry
    a leading fold axis, or a flat (p (F, P), s (F, S)) pair (tensors on
    the device, float32 and contiguous, are trained in place and become
    the returned stack); ``*_f`` are (F, n, ...) stacks of equal sizes
    across folds; ``seeds[j]`` drives fold j's shuffle plans, ``seeds[0]``
    the dropout generator. Per fold it equals ``train_model`` with
    ``seed=seeds[j]`` up to float reassociation (at dropout 0).

    Returns F ``(train_hist, val_hist, lr_hist, best_variables)`` tuples
    (state_dicts of views into the selected stack); with
    ``return_stacked`` also the selected (p, s) stack: ``(results, (p,
    s))``. ``phases``: two context managers, entered around the trainer's
    construction and around the training (a pipeline's phases)."""
    dev = resolve_device(device)
    F = len(seeds)
    stage, train = phases or (contextlib.nullcontext(),) * 2
    with stage:
        p, s = _flat_buffers(model, variables_stack, F, dev)
        tr = _FoldTrainer(model, p, s, lr_train_f, hr_train_f, lr_val_f,
                          hr_val_f, seeds[0], batch_size, criterion,
                          clip_norm, weight_decay, dev)
    rngs = [np.random.default_rng(sd) for sd in seeds]
    with train:
        hists, _, bp, bs = _device_control(
            tr, rngs, num_epochs, lr,
            _validate_flag(validate_every, num_epochs), patience,
            plateau_threshold, plateau_factor, min_lr_stop,
            max(1, int(control_chunk_epochs)))
        tr.release_graphs()
    del tr
    results = [(*h, fold_state(model, bp, bs, j)) for j, h in enumerate(hists)]
    return (results, (bp, bs)) if return_stacked else results
