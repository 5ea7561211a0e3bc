"""Training loops of the GAT Graph-U-Net family. Counterpart of
``fcsr_tpu/train/gat_loop.py``.

One training step is one subject (batch size 1). The SVD node features are
pure data and are precomputed once with host LAPACK. ``train_gat`` trains a
single fold; ``train_gat_folds_parallel`` trains every CV fold together,
one fold-batched step per subject position: masked no-op steps pad ragged
fold sizes, each fold has its own plateau-decayed learning rate, step count
and early-stop flag. With ``cfg.fused_step`` the step runs on the
hand-written CUDA kernels (``models/fused_gat.py``), and with
``cfg.fused_val`` the validation forwards do too; otherwise the step is
autograd over the ``GATGraphUnet`` module, every fold in one call of
``torch.func.vmap`` over ``functional_call`` (the JAX trainer vmaps its
fold programs), and a literal flat AdamW.

The control loop (plateau scheduler, best-state snapshot, early stop at
lr < 1e-5) runs on the device by default, in float32 tensors with one
host read per ``control_chunk_epochs`` epochs; ``host_control=True`` keeps
the per-epoch host loop in Python floats. Both keep the BEST validation
loss (the reference kept the worst). With a ``mesh`` the fold axis is
sharded over its placements (``_ShardedTrainer``), with no collective: a
real fold's trajectory is the unsharded run's (the fused step's dropout
too; the unfused module draws its masks from a generator per shard).
With ``drop_p > 0`` the card's generator is not the JAX package's, so
trajectories are stochastically equivalent only; at ``drop_p = 0`` every
mode agrees with its JAX counterpart (tested).

An epoch is one program per shard, fused step or not, as the JAX
trainer's ``run_chunk`` is one compiled scan of either step (``fcsr_tpu/
train/gat_loop.py:408-447``, ``:499-541``): the step scalars from the
step counts, then the epoch's steps over static buffers (p, m, v, t, the
(L, F) order and validity, each fold's lr and active flag, the (L, F, 2)
seed table of the fused step), the subjects gathered on the device from
the order; the validation forwards (fused or the module's, as
``val_all``, ``:450-491``) are a second program. On the card each is
captured once per trainer as a CUDA graph (``train/epoch_graph.py``) and
replayed once an epoch, each shard's issued before any is waited on; the
unfused step's dropout draws from the shard's ``torch.Generator``, which
each graph registers, so a replay draws what the eager epoch draws and
leaves the generator where it leaves it. On the CPU the same programs run
step by step. The host still draws each epoch's order and seeds from the
same generators in the same sequence and copies them into the buffers.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap

from fcsr_tpu_torch.iox.weights import (gat_flat_to_state,
                                        gat_leaf_tensors_to_state,
                                        gat_state_to_flat)
from fcsr_tpu_torch.kernels.ops import plan_folds
from fcsr_tpu_torch.models.fused_gat import (ADAM_B1, ADAM_B2, GATLayout,
                                             _check_widths,
                                             gat_train_step_fused,
                                             gat_val_fused)
from fcsr_tpu_torch.models.gat_unet import GATGraphUnet, symmetric_normalize
from fcsr_tpu_torch.train.epoch_graph import EpochGraph, upload as _upload
from fcsr_tpu_torch.train.generic_loop import PlateauScheduler
from fcsr_tpu_torch.train.losses import (intermediate_recon_loss,
                                         offdiag_mse_loss)
from fcsr_tpu_torch.utils import host_cache
from fcsr_tpu_torch.utils.device import (DEFAULT_DEVICE, on_device,
                                         resolve_device)
from fcsr_tpu_torch.utils.transfer import stage_cached

__all__ = ["GATTrainConfig", "init_gat", "precompute_gat_features",
           "stage_lr_cached", "train_gat", "train_gat_folds_parallel",
           "adamw_flat_update",
           "predict_gat", "predict_gat_folds", "predict_gat_folds_mae",
           "unet_loss"]

STOP_LR = 1e-5   # a fold stops once its learning rate has decayed below
_WARM_STEPS = 2  # steps the warm-up before an epoch's capture runs
_PREDICT_BATCH = 64     # subjects per forward of predict_gat (bounds the
                        # (batch, n, n, heads) attention tensors)


@dataclass(frozen=True)
class GATTrainConfig:
    """The shipped unet-transformer run."""
    ks: Tuple[float, ...] = (0.5, 0.5, 0.5)
    n_nodes: int = 160
    m_nodes: int = 268
    dim: int = 16
    heads: int = 4
    drop_p: float = 0.01
    skip: bool = False
    epochs: int = 100
    lr: float = 1e-3
    patience: int = 10
    plateau_threshold: float = 1e-2
    plateau_factor: float = 0.1
    intermediate_losses: bool = True
    weight_decay: float = 0.01
    # shapes the JAX package's compiled scan only; kept so that configs
    # carry over, without effect here (on the card an epoch of either step
    # is one CUDA graph)
    scan_unroll: int = 1
    # run each training step (forward, backward, masked AdamW) on the
    # hand-written CUDA kernels in the fold-parallel trainer. Same math as
    # the autograd path up to float reassociation (tested at drop_p = 0);
    # dropout comes from the kernels' own counter-based generator.
    fused_step: bool = False
    # take the attention softmax's shift over all heads of a row instead of
    # per head inside the fused step (the visible effect of the JAX
    # package's single-chain layout): identical up to reassociation
    fused_batched_chain: bool = False
    # with fused_step, also run the validation forwards (loss and
    # off-diagonal MAE) on the kernels, one batch of subjects per fold
    fused_val: bool = True

    def model(self, device=DEFAULT_DEVICE, seed: int = 0) -> GATGraphUnet:
        return GATGraphUnet(ks=self.ks, n_nodes=self.n_nodes,
                            m_nodes=self.m_nodes, dim=self.dim,
                            heads=self.heads, drop_p=self.drop_p,
                            skip=self.skip, device=device, seed=seed)

    @property
    def layout(self) -> GATLayout:
        return GATLayout(self.dim, tuple(self.ks), self.heads, self.n_nodes,
                         self.m_nodes)

    @property
    def kernel_kwargs(self) -> dict:
        return dict(dim=self.dim, ks=tuple(self.ks), n_nodes=self.n_nodes,
                    m_nodes=self.m_nodes, heads=self.heads,
                    intermediate_losses=self.intermediate_losses,
                    batched_chain=self.fused_batched_chain)


def init_gat(cfg: GATTrainConfig, seed: int = 0, device=DEFAULT_DEVICE):
    """(model, opt_state): a ``GATGraphUnet`` initialised from ``seed`` on
    ``device`` and a fresh AdamW state ``{"m", "v", "t"}`` over the flat
    parameter vector (``GATLayout`` order). The learning rate is not part
    of the state: the plateau schedule hands it to every step."""
    model = cfg.model(device=device, seed=seed)
    dev = next(model.parameters()).device
    zeros = torch.zeros(cfg.layout.size, dtype=torch.float32, device=dev)
    return model, {"m": zeros, "v": zeros.clone(), "t": 0.0}


_FEATURE_CACHE: dict = {}


def stage_lr_cached(lr_np, device=None):
    """An LR stack on ``device``, copied once per process and dataset
    (``utils/transfer.py::stage_cached``): the fold-parallel trainer, its
    validation and the prediction pass share one copy, as the JAX
    package's stage it."""
    return stage_cached(np.ascontiguousarray(lr_np, dtype=np.float32), device)


def precompute_gat_features(lr_stack, dim: int) -> np.ndarray:
    """(N, n, dim) float32 SVD node features of the normalized (A + I)
    adjacencies: the top-``dim`` left singular vectors, by host LAPACK in
    float64 (one-shot preprocessing; singular-vector signs are LAPACK's,
    the same call as the JAX package makes, so the two agree). Memoized per
    (dataset content, dim) in-process and on disk (``utils/host_cache.py``)."""
    lr_host = np.ascontiguousarray(lr_stack)
    h = hashlib.sha1(memoryview(lr_host).cast("B"))
    h.update(str(lr_host.shape).encode())
    h.update(str(lr_host.dtype).encode())
    key = (h.hexdigest(), int(dim))
    hit = _FEATURE_CACHE.get(key)
    if hit is not None:
        return hit
    path = host_cache.cache_path("gatfeat", (lr_host,), (int(dim),))
    disk = host_cache.load(path, ("features",))
    if disk is not None:
        feats = disk[0]
    else:
        lr_np = np.asarray(lr_host, dtype=np.float64)
        n = lr_np.shape[-1]
        a = lr_np + np.eye(n)
        d = a.sum(axis=-1) + 1e-5
        r = d ** -0.5
        a = a * r[..., None, :] * r[..., :, None]
        u, _, _ = np.linalg.svd(a)
        feats = u[..., :, :dim].astype(np.float32)
        host_cache.save(path, features=feats)
    if len(_FEATURE_CACHE) >= 8:
        _FEATURE_CACHE.pop(next(iter(_FEATURE_CACHE)))
    _FEATURE_CACHE[key] = feats
    return feats


def unet_loss(pred, target, a_hist, a_recon_hist,
              intermediate_losses: bool = True):
    """Off-diagonal MSE + the intermediate reconstruction MSEs (the up
    path's reconstructions against the down path's adjacencies, reversed)."""
    loss = offdiag_mse_loss(pred, target)
    if intermediate_losses:
        loss = loss + intermediate_recon_loss(a_hist, a_recon_hist[::-1])
    return loss


def adamw_flat_update(g, p, m, v, t, lr, b1=ADAM_B1, b2=ADAM_B2, eps=1e-8,
                      wd=0.01):
    """optax.adamw's update on a flat parameter vector: (step, m', v') with
    the decoupled weight decay folded into the step."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * (g * g)
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    step = lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p)
    return step, m, v


def _offdiag_mae_all(pred, target):
    """Mean over all m^2 entries of |pred - target| with the diagonal
    zeroed (the validation metric; ``predict_gat_folds_mae`` divides by
    m (m - 1) instead)."""
    eye = torch.eye(pred.shape[-1], dtype=torch.bool, device=pred.device)
    return (pred - target).abs().masked_fill(eye, 0.0).mean(dim=(-2, -1))


def _fold_flat0(cfg: GATTrainConfig, seeds) -> np.ndarray:
    """(F, P) initial weights, fold j a fresh model from ``seeds[j]``."""
    return np.stack([gat_state_to_flat(
        {k: t.numpy() for k, t in cfg.model(
            device="cpu", seed=s).state_dict().items()}) for s in seeds])


def _seed_table(rng, steps: int, folds: int) -> np.ndarray:
    """An epoch's dropout seeds, (steps, folds, 2) int32."""
    return rng.integers(-2 ** 31, 2 ** 31, size=(steps, folds, 2),
                        dtype=np.int64).astype(np.int32)


def _pad_val_plan(sets):
    """(F, V) int64 subject indices and float32 weights of ragged
    validation sets, each padded with subject 0 at weight 0 (V at least
    1)."""
    V = max([len(s) for s in sets] + [1])
    idx = np.zeros((len(sets), V), np.int64)
    valid = np.zeros((len(sets), V), np.float32)
    for j, s in enumerate(sets):
        idx[j, :len(s)] = np.asarray(s, np.int64)
        valid[j, :len(s)] = 1.0
    return idx, valid


def _state_to_device(variables, dev):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(dev)
            for k, v in variables.items()}


class _FoldTrainer:
    """State and the two device programs (one epoch of steps, one
    validation pass) of the fold-parallel trainer, over static buffers
    (``bufs``), each one CUDA graph on the card. Under a mesh it
    holds one placement's block of folds: ``fold_lo`` is its first fold's
    index (fold j's host generator is seeded ``seed + j``) and ``tr_len``
    the whole run's steps per epoch."""

    def __init__(self, cfg: GATTrainConfig, lr_all, hr_all, folds, seed: int,
                 device, flat0=None, fused: bool = False, fold_lo: int = 0,
                 tr_len: int = None):
        _check_widths(cfg.dim, tuple(cfg.ks), cfg.heads)
        self.cfg, self.fused, self.fold_lo = cfg, fused, fold_lo
        self.dev = dev = resolve_device(device)
        self.layout = cfg.layout
        lr_np = np.ascontiguousarray(lr_all, dtype=np.float32)
        hr_np = np.ascontiguousarray(hr_all, dtype=np.float32)
        self.lr_d = stage_lr_cached(lr_np, dev)
        self.hr_d = stage_cached(hr_np, dev)
        self.x_d = torch.from_numpy(
            precompute_gat_features(lr_np, cfg.dim)).to(dev)
        eye = torch.eye(cfg.n_nodes, dtype=torch.float32, device=dev)
        self.a0_d = symmetric_normalize(self.lr_d + eye)
        self.model = cfg.model(device=dev, seed=seed)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.model.set_generator(self.gen)
        self.n_folds = F = len(folds)
        if flat0 is None:
            flat0 = _fold_flat0(cfg, [seed + j for j in range(F)])
        flat0 = np.ascontiguousarray(flat0, dtype=np.float32)
        if flat0.shape != (F, self.layout.size):
            raise ValueError(f"flat0 has shape {flat0.shape}, expected "
                             f"{(F, self.layout.size)}")
        self.tr_sets = [np.asarray(tr, dtype=np.int32) for tr, _ in folds]
        self.va_sets = [torch.from_numpy(np.asarray(va, dtype=np.int64)
                                         ).to(dev) for _, va in folds]
        # the unfused validation's padded (F, V) plan and its weights, as
        # the JAX trainer's val_all takes them
        va_idx, va_valid = _pad_val_plan([va for _, va in folds])
        self.va_idx = torch.from_numpy(va_idx).to(dev)
        self.va_valid = torch.from_numpy(va_valid).to(dev)
        self.tr_len = L = tr_len or max(max(len(s) for s in self.tr_sets),
                                        1)
        self.rngs = [np.random.default_rng(seed + fold_lo + j)
                     for j in range(F)]
        self.seed_rng = np.random.default_rng([seed, 0x5EED])
        self.active0 = np.ones(F, np.float32)

        # the programs' static buffers (a graph reads and writes fixed
        # addresses): the state (p, m, v, step counts t), an epoch's inputs
        # (the (L, F) order and validity, each fold's lr and active flag,
        # the (L, F, 2) seed table) and the outputs
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(*shape, dtype=dtype, device=dev)
        p = torch.from_numpy(flat0).to(dev)
        self.bufs = dict(
            p=p, m=torch.zeros_like(p), v=torch.zeros_like(p), t=zeros(F),
            order=zeros(L, F, dtype=torch.int64), valid=zeros(L, F),
            lr=zeros(F), active=zeros(F),
            seeds=zeros(L, F, 2, dtype=torch.int32)
            if fused and cfg.drop_p > 0 else None,
            loss=zeros(F), vloss=zeros(F), vmae=zeros(F))
        self._graphs = {}
        self._eager = False

    @property
    def p(self):
        return self.bufs["p"]

    @property
    def m(self):
        return self.bufs["m"]

    @property
    def v(self):
        return self.bufs["v"]

    @property
    def t(self):
        return self.bufs["t"]

    def draw_epoch_plan(self):
        """One epoch's per-fold shuffled, padded index plan, from each
        fold's own host generator (seed + j), as (order, valid) (F, L)."""
        order = np.zeros((self.n_folds, self.tr_len), np.int32)
        valid = np.zeros((self.n_folds, self.tr_len), np.float32)
        for j, s in enumerate(self.tr_sets):
            if len(s):
                order[j, :len(s)] = s[self.rngs[j].permutation(len(s))]
                valid[j, :len(s)] = 1.0
        return order, valid

    def _sample_loss(self, state, lr, x, hr, train: bool = True):
        """One fold's loss of the module over its subjects (a leading
        subject axis gives one per subject), and its prediction; the
        trainer maps it over the folds with ``torch.func.vmap``, as the
        JAX trainer vmaps its fold programs."""
        pred, a_hist, a_recon = functional_call(
            self.model, gat_leaf_tensors_to_state(state), (lr, x),
            {"train": train})
        return unet_loss(pred, hr, a_hist, a_recon,
                         self.cfg.intermediate_losses), pred

    def _unfused_step(self, p0, m, v, i, scal):
        """Autograd over the module, every fold in one vmapped call (each
        fold's dropout masks drawn apart from the generator), then the
        literal flat AdamW, masked by ok."""
        cfg = self.cfg
        p = p0.detach().requires_grad_()
        # the folds' subjects gathered by the index tensor at once: indexing
        # by one of its entries would read it back to the host
        loss, _ = vmap(self._sample_loss, randomness="different")(
            self.layout.views(p), self.lr_d[i], self.x_d[i], self.hr_d[i])
        (g,) = torch.autograd.grad(loss.sum(), p)
        ok, lr = scal[:, 0:1], scal[:, 1:2]
        step, m_new, v_new = adamw_flat_update(
            g, p0, m, v, scal[:, 2:3], lr, wd=cfg.weight_decay)
        on = ok > 0
        return (loss.detach(), p0 - ok * step, torch.where(on, m_new, m),
                torch.where(on, v_new, v))

    def draw_seeds(self):
        """One epoch's dropout seed table, (tr_len, F, 2) int32, or None
        where the step draws no mask. Masked padding steps draw seeds too:
        the stream advances."""
        if not (self.fused and self.cfg.drop_p > 0):
            return None
        return _seed_table(self.seed_rng, self.tr_len, self.n_folds)

    def load_epoch(self, order, valid, lr_t, active_t, seeds=None):
        """Copy one epoch's inputs into the static buffers without waiting
        on the device: the (F, L) host ``order`` and ``valid``, the (F,)
        device tensors ``lr_t`` and ``active_t``, the seed table (or
        None)."""
        b = self.bufs
        _upload(b["order"], np.ascontiguousarray(order.T, np.int64))
        _upload(b["valid"], np.ascontiguousarray(valid.T, np.float32))
        b["lr"].copy_(lr_t)
        b["active"].copy_(active_t)
        if seeds is not None:
            _upload(b["seeds"], np.ascontiguousarray(seeds, np.int32))

    def epoch_step(self, p, m, v, i, scal, seeds):
        """One fold-batched step on the subjects ``i`` (F,): (loss, p', m',
        v')."""
        cfg = self.cfg
        if self.fused:
            return gat_train_step_fused(
                p, m, v, self.a0_d[i], self.x_d[i], self.hr_d[i], scal,
                seeds, drop_p=cfg.drop_p, wd=cfg.weight_decay,
                device=self.dev, **cfg.kernel_kwargs)
        return self._unfused_step(p, m, v, i, scal)

    def _epoch_program(self, b: dict, n_steps: int = None) -> None:
        """The epoch program over the buffers ``b`` (``bufs``' keys): the
        step scalars from the step counts, validity, lr and active flags,
        ``n_steps`` (default ``tr_len``) fold-batched steps in the order
        ``b["order"]``, p, m, v and t advanced in place, each fold's mean
        training loss into ``b["loss"]``."""
        ok = b["valid"] * b["active"]                            # (L, F)
        t_new = b["t"] + torch.cumsum(ok, dim=0)
        te = t_new.clamp(min=1.0)
        lr = b["lr"].expand_as(ok)
        if self.fused:
            # [ok, lr, 1 - b1^t, 1 - b2^t] per step and fold
            scal = torch.stack([ok, lr, 1.0 - ADAM_B1 ** te,
                                1.0 - ADAM_B2 ** te], dim=-1).contiguous()
        else:
            scal = torch.stack([ok, lr, te], dim=-1)
        seeds = b["seeds"]
        p, m, v = b["p"], b["m"], b["v"]
        losses = []
        for s in range(self.tr_len if n_steps is None else n_steps):
            loss, p, m, v = self.epoch_step(
                p, m, v, b["order"][s], scal[s],
                None if seeds is None else seeds[s])
            losses.append(loss)
        for name, x in (("p", p), ("m", m), ("v", v), ("t", t_new[-1])):
            b[name].copy_(x)
        # each fold's steps summed along a contiguous row: the sum does not
        # depend on how many folds lie beside it
        ok = ok[:len(losses)]
        total = (torch.stack(losses) * ok).T.contiguous().sum(1)
        torch.div(total, ok.sum(0).clamp(min=1.0), out=b["loss"])

    def _val_program(self, b: dict) -> None:
        vloss, vmae = self._validate(b["p"])
        b["vloss"].copy_(vloss)
        b["vmae"].copy_(vmae)

    def _run(self, name: str, program, **warm) -> None:
        """``program(bufs)``: on the card the replay of its graph (captured
        at first use after a warm-up on scratch copies of the buffers, the
        dropout generator set back after it), on the CPU the program
        itself."""
        if self._eager or self.dev.type != "cuda":
            program(self.bufs)
            return
        graph = self._graphs.get(name)
        if graph is None:
            scratch = {k: None if x is None else x.clone()
                       for k, x in self.bufs.items()}
            graph = self._graphs[name] = EpochGraph(
                f"the {'fused' if self.fused else 'unfused'} GAT {name} "
                f"(folds {self.fold_lo}-{self.fold_lo + self.n_folds - 1})",
                self.dev, lambda: program(self.bufs),
                lambda: program(scratch, **warm), generators=(self.gen,))
        graph.replay()

    def run_epoch(self) -> None:
        """One epoch over the loaded inputs (``load_epoch``)."""
        self._run("epoch", self._epoch_program,
                  n_steps=min(_WARM_STEPS, self.tr_len))

    def epoch(self, order, valid, lr_t, active_t, seeds=None):
        """One epoch over every fold: ``tr_len`` fold-batched steps.
        ``lr_t`` and ``active_t`` are (F,) float32 tensors on the device;
        ``seeds`` the epoch's seed table (default: drawn here). Returns
        each fold's mean training loss (F,). Nothing is read back to the
        host."""
        with on_device(self.dev):
            self.load_epoch(order, valid, lr_t, active_t,
                            self.draw_seeds() if seeds is None else seeds)
            self.run_epoch()
            return self.bufs["loss"].clone()

    @torch.no_grad()
    def validate(self):
        """Each fold's mean validation loss and off-diagonal MAE, (F,)
        tensors on the device: one batch of subjects per fold, the fused
        forwards or the module's."""
        with on_device(self.dev):
            self._run("validation", self._val_program)
            return self.bufs["vloss"].clone(), self.bufs["vmae"].clone()

    def _validate(self, p):
        """Each fold's mean validation loss and off-diagonal MAE: the fused
        forwards fold by fold over its own subjects, or the module's over
        the padded (F, V) plan in one call vmapped over the folds, the
        padding weighted out (``val_all``)."""
        cfg = self.cfg
        if not (self.fused and cfg.fused_val):
            idx, w = self.va_idx, self.va_valid
            hr = self.hr_d[idx]
            loss, pred = vmap(self._sample_loss, in_dims=(0, 0, 0, 0, None))(
                self.layout.views(p), self.lr_d[idx], self.x_d[idx], hr,
                False)
            denom = w.sum(1).clamp(min=1.0)
            return ((loss * w).sum(1) / denom,
                    (_offdiag_mae_all(pred, hr) * w).sum(1) / denom)
        vloss, vmae = [], []
        for f, idx in enumerate(self.va_sets):
            if idx.numel() == 0:
                vloss.append(p.new_zeros(()))
                vmae.append(p.new_zeros(()))
                continue
            loss, mae = gat_val_fused(
                p[f:f + 1], self.a0_d[idx], self.x_d[idx], self.hr_d[idx],
                device=self.dev, **cfg.kernel_kwargs)
            vloss.append(loss.mean())
            vmae.append(mae.mean())
        return torch.stack(vloss), torch.stack(vmae)

    def _stay_eager(self, eager: bool = True) -> None:
        """Run every later epoch and validation pass from Python on the
        card too (``eager=False``: through the graphs again): the
        yardstick the graphs are held to, bit for bit."""
        self._eager = eager

    def release_graphs(self) -> None:
        """Free the captured programs and their memory."""
        with on_device(self.dev):
            for graph in self._graphs.values():
                graph.release()
        self._graphs = {}

    def states(self, flat: np.ndarray):
        shapes = self.layout.shapes
        return [gat_flat_to_state(row, shapes) for row in flat]


class _ShardedTrainer:
    """The fold-parallel trainer with its fold axis sharded over a mesh:
    the folds padded to a multiple of the mesh size with empty no-op folds
    (inactive from the start), each placement a ``_FoldTrainer`` over its
    contiguous block, each epoch run shard after shard under each
    shard's device and planned as for the real folds
    (``ops.plan_folds``). It has ``_FoldTrainer``'s interface over the
    padded folds, with the per-fold tensors on the first placement. The
    dropout seed table is drawn once per epoch, for the real folds, and
    sliced to the shards, so every real fold draws the masks it draws in
    the unsharded run."""

    def __init__(self, cfg: GATTrainConfig, lr_all, hr_all, folds, seed: int,
                 mesh, flat0=None, fused: bool = False):
        self.cfg, self.fused = cfg, fused
        self.n_real = len(folds)
        n_pad = (-self.n_real) % mesh.size
        self.n_folds = F = self.n_real + n_pad
        if flat0 is None:
            flat0 = _fold_flat0(cfg, [seed + j for j in range(F)])
        elif len(flat0) == self.n_real < F:
            flat0 = np.concatenate([np.asarray(flat0, np.float32), _fold_flat0(
                cfg, [seed + j for j in range(self.n_real, F)])])
        empty = np.zeros(0, np.int32)
        folds = list(folds) + [(empty, empty)] * n_pad
        tr_len = max(max(len(tr) for tr, _ in folds), 1)
        per = F // mesh.size
        self.shards = []
        for i, dev in enumerate(mesh.devices):
            lo = i * per
            with on_device(dev):
                self.shards.append(_FoldTrainer(
                    cfg, lr_all, hr_all, folds[lo:lo + per], seed, dev,
                    flat0=flat0[lo:lo + per],
                    fused=fused, fold_lo=lo, tr_len=tr_len))
        self.dev = self.shards[0].dev
        self.model = self.shards[0].model
        self.layout = cfg.layout
        self.tr_len = tr_len
        self.seed_rng = np.random.default_rng([seed, 0x5EED])
        self.active0 = (np.arange(F) < self.n_real).astype(np.float32)

    @property
    def p(self):
        return torch.cat([sh.p.to(self.dev) for sh in self.shards])

    def _slices(self):
        lo = 0
        for sh in self.shards:
            yield sh, slice(lo, lo + sh.n_folds)
            lo += sh.n_folds

    def draw_epoch_plan(self):
        plans = [sh.draw_epoch_plan() for sh in self.shards]
        return (np.concatenate([o for o, _ in plans]),
                np.concatenate([v for _, v in plans]))

    def epoch(self, order, valid, lr_t, active_t):
        seeds = None
        if self.fused and self.cfg.drop_p > 0:
            seeds = np.zeros((self.tr_len, self.n_folds, 2), np.int32)
            seeds[:, :self.n_real] = _seed_table(self.seed_rng, self.tr_len,
                                                 self.n_real)
        # every shard's epoch issued before any is waited on
        for sh, f in self._slices():
            with on_device(sh.dev), plan_folds(self.n_real):
                sh.load_epoch(order[f], valid[f], lr_t[f].to(sh.dev),
                              active_t[f].to(sh.dev),
                              None if seeds is None else seeds[:, f])
                sh.run_epoch()
        return torch.cat([sh.bufs["loss"].to(self.dev)
                          for sh in self.shards])

    def validate(self):
        parts = [sh.validate() for sh in self.shards]
        return tuple(torch.cat([x[k].to(self.dev) for x in parts])
                     for k in range(2))

    def _stay_eager(self, eager: bool = True) -> None:
        for sh in self.shards:
            sh._stay_eager(eager)

    def release_graphs(self) -> None:
        for sh in self.shards:
            sh.release_graphs()

    def states(self, flat: np.ndarray):
        return self.shards[0].states(flat)


def _run_host_control(tr: _FoldTrainer, cfg: GATTrainConfig, verbose: bool):
    """The per-epoch host loop: scheduler, best state and early stop in
    Python floats, one small read per epoch (and the parameters only when
    some fold improved). Returns (best flat per fold, histories)."""
    F = tr.n_folds
    schedulers = [PlateauScheduler(cfg.lr, patience=cfg.patience,
                                   factor=cfg.plateau_factor,
                                   threshold=cfg.plateau_threshold)
                  for _ in range(F)]
    cur_lr = np.full(F, cfg.lr, dtype=np.float32)
    active = np.ones(F, dtype=np.float32)
    best_val = np.full(F, np.inf)
    best_flat = [None] * F
    hists = [{"train": [], "val": [], "lr": []} for _ in range(F)]
    for epoch in range(cfg.epochs):
        order, valid = tr.draw_epoch_plan()
        tr_loss = tr.epoch(order, valid, torch.from_numpy(cur_lr).to(tr.dev),
                           torch.from_numpy(active).to(tr.dev))
        v_loss, v_mae = tr.validate()
        packed = torch.cat([tr_loss, v_loss, v_mae]).cpu().numpy()
        tr_loss, v_loss, v_mae = packed[:F], packed[F:2 * F], packed[2 * F:]
        improved = [bool(active[j]) and v_loss[j] < best_val[j]
                    for j in range(F)]
        flat_now = tr.p.cpu().numpy() if any(improved) else None
        for j in range(F):
            if not active[j]:
                continue
            hists[j]["train"].append(float(tr_loss[j]))
            hists[j]["val"].append(float(v_loss[j]))
            new_lr = schedulers[j].step(float(v_loss[j]))
            cur_lr[j] = new_lr
            hists[j]["lr"].append(float(new_lr))
            if improved[j]:
                best_val[j] = v_loss[j]
                best_flat[j] = flat_now[j].copy()
            if new_lr < STOP_LR:
                active[j] = 0.0
        if verbose:
            print(f"epoch {epoch + 1}: train {tr_loss.round(6)} val "
                  f"{v_loss.round(6)} val_mae {v_mae.round(6)} lr {cur_lr}")
        if not active.any():
            break
    final = tr.p.cpu().numpy()
    return [final[j] if best_flat[j] is None else best_flat[j]
            for j in range(F)], hists


def _run_device_control(tr: _FoldTrainer, cfg: GATTrainConfig, verbose: bool,
                        chunk_epochs: int):
    """Scheduler, best state and early stop as float32 tensors on the
    device, the scheduler's exact logic vectorized over the folds; one host
    read per chunk of epochs (have all folds stopped?) and one at the end."""
    F, dev = tr.n_folds, tr.dev
    thr, patience, factor = (cfg.plateau_threshold, cfg.patience,
                             cfg.plateau_factor)
    stop_lr = float(np.float32(STOP_LR))        # compared in float32
    lr = torch.full((F,), cfg.lr, dtype=torch.float32, device=dev)
    active = torch.from_numpy(tr.active0).to(dev)
    sbest = torch.full((F,), float("inf"), dtype=torch.float32, device=dev)
    nbad = torch.zeros(F, dtype=torch.int32, device=dev)
    bval = sbest.clone()
    bflat = tr.p.clone()
    parts = []
    done = 0
    while done < cfg.epochs:
        chunk = min(chunk_epochs, cfg.epochs - done)
        for _ in range(chunk):
            order, valid = tr.draw_epoch_plan()
            tr_loss = tr.epoch(order, valid, lr, active)
            vloss, _ = tr.validate()
            act = active > 0
            is_better = vloss < sbest * (1.0 - thr)
            sbest2 = torch.where(is_better, vloss, sbest)
            nbad2 = torch.where(is_better, torch.zeros_like(nbad), nbad + 1)
            decay = nbad2 > patience
            lr2 = torch.where(decay, lr * factor, lr)
            nbad2 = torch.where(decay, torch.zeros_like(nbad), nbad2)
            sbest = torch.where(act, sbest2, sbest)
            nbad = torch.where(act, nbad2, nbad)
            lr2 = torch.where(act, lr2, lr)
            improved = act & (vloss < bval)
            bval = torch.where(improved, vloss, bval)
            bflat = torch.where(improved[:, None], tr.p, bflat)
            # ``active`` at the epoch's START: exactly the epochs the host
            # loop records for the fold
            parts.append(torch.stack([tr_loss, vloss, lr2, active]))
            active = torch.where(act & (lr2 < stop_lr),
                                 torch.zeros_like(active), active)
            lr = lr2
        done += chunk
        still_active = float(active.max())
        if verbose:
            print(f"epochs {done}: active={still_active > 0}")
        if still_active == 0.0:
            break
    hist = torch.stack(parts).cpu().numpy() if parts \
        else np.zeros((0, 4, F), np.float32)              # (E, 4, F)
    bval_np, bflat_np = bval.cpu().numpy(), bflat.cpu().numpy()
    final_np = tr.p.cpu().numpy()
    hists, best = [], []
    for j in range(F):
        on = hist[:, 3, j] > 0
        hists.append({"train": [float(x) for x in hist[on, 0, j]],
                      "val": [float(x) for x in hist[on, 1, j]],
                      "lr": [float(x) for x in hist[on, 2, j]]})
        # a fold that never improved returns its final parameters
        best.append(bflat_np[j] if np.isfinite(bval_np[j]) else final_np[j])
    return best, hists


def train_gat_folds_parallel(cfg: GATTrainConfig, lr_all, hr_all, folds,
                             seed: int = 42, verbose: bool = False,
                             host_control: bool = False,
                             control_chunk_epochs: int = 25, mesh=None,
                             flat0=None, device=DEFAULT_DEVICE):
    """All CV folds trained together (see the module docstring), with the
    single-fold ``train_gat`` semantics per fold and per-fold seeds
    ``seed + j``. ``flat0`` (F, P) optionally gives the folds' initial
    weights in ``GATLayout`` order (default: a fresh model from seed + j
    per fold). ``mesh`` (``parallel/mesh.py``) shards the fold axis over
    its placements (``_ShardedTrainer``; on-device control only), in place
    of ``device``. Returns (model, best state_dict per fold as numpy
    arrays, histories), for the real folds."""
    if mesh is not None:
        if host_control:
            raise ValueError("mesh= requires on-device control "
                             "(host_control=False)")
        tr = _ShardedTrainer(cfg, lr_all, hr_all, folds, seed, mesh,
                             flat0=flat0, fused=cfg.fused_step)
    else:
        tr = _FoldTrainer(cfg, lr_all, hr_all, folds, seed, device,
                          flat0=flat0, fused=cfg.fused_step)
    if host_control:
        best, hists = _run_host_control(tr, cfg, verbose)
    else:
        best, hists = _run_device_control(tr, cfg, verbose,
                                          max(1, int(control_chunk_epochs)))
    tr.release_graphs()
    n = len(folds)
    return tr.model, tr.states(np.stack(best[:n])), hists[:n]


def train_gat(model: GATGraphUnet, opt_state, cfg: GATTrainConfig, lr_train,
              hr_train, lr_val, hr_val, seed: int = 0,
              verbose: bool = False):
    """One fold's full training run with per-epoch validation, plateau
    decay, best-state restore and early stop at lr < 1e-5, under host
    control, by autograd over the module (never the fused step), its
    epoch and validation pass each one CUDA graph on the card. Starts
    from ``model``'s weights and ``opt_state`` (``init_gat``), on the
    model's device; loads the best weights into ``model``. Returns (best
    state_dict as numpy arrays, opt_state, {"train", "val", "lr"})."""
    dev = next(model.parameters()).device
    n_tr, n_va = len(lr_train), len(lr_val)
    lr_all = np.concatenate([np.asarray(lr_train, np.float32),
                             np.asarray(lr_val, np.float32)])
    hr_all = np.concatenate([np.asarray(hr_train, np.float32),
                             np.asarray(hr_val, np.float32)])
    folds = [(np.arange(n_tr), n_tr + np.arange(n_va))]
    flat0 = gat_state_to_flat({k: t.detach().cpu().numpy()
                               for k, t in model.state_dict().items()})[None]
    tr = _FoldTrainer(cfg, lr_all, hr_all, folds, seed, dev, flat0=flat0,
                      fused=False)
    tr.m.copy_(opt_state["m"].reshape(1, -1))
    tr.v.copy_(opt_state["v"].reshape(1, -1))
    tr.t.fill_(float(opt_state["t"]))
    best, hists = _run_host_control(tr, cfg, verbose)
    variables = tr.states(np.stack(best))[0]
    model.load_state_dict(_state_to_device(variables, dev))
    return (variables, {"m": tr.m[0], "v": tr.v[0], "t": float(tr.t[0])},
            hists[0])


@torch.no_grad()
def predict_gat(variables, model: GATGraphUnet, cfg: GATTrainConfig,
                lr_stack):
    """(N, m, m) predictions of ``variables`` (a state_dict mapping; None
    takes the model's own weights) for an (N, n, n) stack, on the model's
    device."""
    dev = next(model.parameters()).device
    lr_np = np.ascontiguousarray(lr_stack, dtype=np.float32)
    x = torch.from_numpy(precompute_gat_features(lr_np, cfg.dim)).to(dev)
    lr_d = stage_lr_cached(lr_np, dev)
    state = dict(model.state_dict()) if variables is None \
        else _state_to_device(variables, dev)
    return torch.cat([
        functional_call(model, state, (lr_d[s:s + _PREDICT_BATCH],
                                       x[s:s + _PREDICT_BATCH]))[0]
        for s in range(0, len(lr_d), _PREDICT_BATCH)])


@torch.no_grad()
def predict_gat_folds(model: GATGraphUnet, best_vars, lr_d, x_d, va_idx):
    """Every fold's validation predictions, (F, va_len, m, m): fold j's
    weights on the subjects ``va_idx[j]`` (ragged folds padded by the
    caller) of the staged stacks ``lr_d`` / ``x_d``, in one forward
    vmapped over the folds' stacked weights, as the JAX package's one
    program."""
    dev = lr_d.device
    idx = torch.as_tensor(np.asarray(va_idx), dtype=torch.long, device=dev)
    states = [_state_to_device(v, dev) for v in best_vars]
    stacked = {k: torch.stack([st[k] for st in states]) for k in states[0]}
    return vmap(lambda st, lr, x: functional_call(model, st, (lr, x))[0])(
        stacked, lr_d[idx], x_d[idx])


@torch.no_grad()
def predict_gat_folds_mae(model: GATGraphUnet, best_vars, lr_d, x_d, va_idx,
                          hr_d, va_len):
    """Every fold's validation off-diagonal MAE, (F,) on the device: the
    mean over a fold's true ``va_len[j]`` subjects of
    ``sum |pred - gt| off / (m (m - 1))``; the predictions stay on the
    device."""
    preds = predict_gat_folds(model, best_vars, lr_d, x_d, va_idx)
    idx = torch.as_tensor(np.asarray(va_idx), dtype=torch.long,
                          device=lr_d.device)
    m = preds.shape[-1]
    eye = torch.eye(m, dtype=torch.bool, device=preds.device)
    per = (preds - hr_d[idx]).abs().masked_fill(eye, 0.0).sum((-2, -1)) \
        / (m * (m - 1))
    lens = torch.as_tensor(np.asarray(va_len), dtype=torch.float32,
                           device=preds.device)
    valid = torch.arange(per.shape[1], device=preds.device)[None, :] \
        < lens[:, None]
    return per.masked_fill(~valid, 0.0).sum(1) / lens
