"""Fold-parallel GSR-Net trainer, in every mode of the JAX package's.

Counterpart of ``fcsr_tpu/train/fast_loop.py::GSRFoldRunner``: k-fold CV
trains one fresh model per fold, all folds together as one fold-batched
step per sample. Shorter folds pad their per-epoch sample sequence with
masked no-op steps, so each fold's update sequence is exactly its own.

The configuration picks the step (``trainer_mode``):

* ``fused_adam``: ``models/fused_step.py::train_step_fused``, forward,
  backward and the masked Adam on the hand-written kernels;
* ``fused_step``: ``gsr_step_loss_fused`` for the loss and the gradient,
  then the flat Adam;
* ``fused_tail`` with ``fused_unet`` and ``fused_unet_bwd``:
  ``unet_fused_fwdbwd`` and ``tail_loss_fused`` — with ``fused_unet``
  alone ``unet_fused_fwdonly``, with neither the plain U-Net — joined by
  ``lmbda * L1(net, start)`` in plain PyTorch;
* no flag: the unfused model (``models/gsr.py::GSRNet``, ``torch.matmul``)
  under autograd, every fold in one call of ``torch.func.vmap`` over
  ``functional_call`` (the JAX runner vmaps its fold program); with
  ``compute_dtype="bf16"`` its parameters (a bf16 copy of the fp32 master
  weights), a_norm and u_lr in bf16, as the JAX package's unfused step
  casts them (``fcsr_tpu/train/fast_loop.py:131-152``): the model then
  computes what the JAX ``GSRNet`` computes in bf16 (``models/gsr.py``),
  the loss on fp32, and the gradient reaches the master weights through
  the cast (bf16 values). The other modes ignore ``compute_dtype``, as
  there.

All but ``fused_adam`` take the gradient by autograd through the entry
point's own backward and end in one ``adam_masked`` launch on the flat
buffers (its plain version on the CPU), so ``fused_step`` and
``fused_adam`` give the same bits.

Layout: p, m and v are one flat float32 (F, P) buffer each, leaf after
leaf in the kernels' order, in every mode. The per-step data (a_norm,
u_lr, u_hr, hr of each fold's sample) is gathered once at staging into
(S, F, ...) stacks, and the per-fold Adam scalars of a whole chunk are
planned on the host.

With a checkpoint path the chunked state (p, m, v, step counts, epoch,
histories) is written as a resume blob between chunks and a later run of
the same configuration, folds and data resumes from it exactly. The blob
is the port's ``.npz``, or the JAX fast loop's msgpack blob where the file
at the path already is one or the path is new and ends in ``.msgpack``
(``checkpoint_format``): p, m and v in that loop's ravel order and its
fingerprint (``jax_fingerprint``), so either package resumes the other's
run.

The decoder's hidden width ``cfg.hidden_dim`` may differ from ``hr_dim``
in the unfused and the three ``fused_tail`` modes, as in the JAX package;
``fused_step`` and ``fused_adam`` refuse it before staging, as the JAX
kernels fail there (``models.fused_step.HIDDEN_REFUSAL``).

With a ``mesh`` (``parallel/mesh.py``) the fold axis is sharded over its
placements, the production multi-device path: the folds are padded to a
multiple of the mesh size with fully masked no-op folds, and each
placement runs its contiguous block of folds as the runner above does on
one device (its own staged data, its own step, under its own device),
shard after shard within each epoch, its kernels planned as for the real
fold count (``ops.plan_folds``), so every fold is bit-equal to the
unsharded run. No collective is needed. Histories, MAEs and parameters
come back for the real folds only.

An epoch is one program per shard, as the JAX runner's chunk is one
compiled scan over epochs of a scan over samples
(``fcsr_tpu/train/fast_loop.py:193-268``): the S slots' steps over static
buffers (p, m, v, the epoch's (S, F, 3) Adam scalars, the (S, F) loss and
recon). On the card it is captured once per runner as a CUDA graph
(``train/epoch_graph.py``) under the shard's device and fold plan, and
replayed once an epoch, each shard's replay issued before any is waited
on; on the CPU the same program runs step by step. Nothing else chooses
between the two: a capture that fails raises, naming the mode. A state
given to a chunk (``fresh_state``, a restored blob, a second ``train``)
is copied into the captured buffers, never put in their place.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import warnings
from typing import List

import numpy as np
import torch
from torch.func import functional_call, vmap

from fcsr_tpu_torch.core.normalize import (fill_diagonal, normalize_adj_np,
                                           unpad)
from fcsr_tpu_torch.iox.checkpoint import (is_msgpack, load_arrays,
                                           load_resume_msgpack, save_arrays,
                                           save_resume_msgpack)
from fcsr_tpu_torch.iox.weights import (flat_from_flax_ravel, flat_to_state,
                                        flat_to_flax_ravel,
                                        leaf_tensors_to_state, state_to_flat)
from fcsr_tpu_torch.kernels.ops import KERNEL_OPS, plan_folds
from fcsr_tpu_torch.models.fused_step import (HIDDEN_REFUSAL, FlatLayout,
                                              adam_scalars,
                                              gsr_step_loss_fused,
                                              train_step_fused,
                                              unet_forward_rankselect,
                                              unet_fused_fwdbwd,
                                              unet_fused_fwdonly)
from fcsr_tpu_torch.models.fused_tail import tail_loss_fused
from fcsr_tpu_torch.models.gsr import GSRNet
from fcsr_tpu_torch.train.epoch_graph import EpochGraph
from fcsr_tpu_torch.train.gsr_loop import GSRTrainConfig, precompute_spectral
from fcsr_tpu_torch.train.losses import gsr_composite_loss
from fcsr_tpu_torch.utils import profiling
from fcsr_tpu_torch.utils.device import (DEFAULT_DEVICE, on_device,
                                         resolve_device)

__all__ = ["adam_flat_update", "trainer_mode", "checkpoint_format",
           "stage_dataset", "GSRFoldRunner", "train_gsr_folds_parallel",
           "evaluate_gsr_folds"]

B1, B2, EPS = 0.9, 0.999, 1e-8
# the slots the warm-up before an epoch's capture runs on scratch buffers
_WARM_SLOTS = 2


def adam_flat_update(g, m, v, t, lr, b1=B1, b2=B2, eps=EPS):
    """torch.optim.Adam update on a flat parameter vector: returns
    (step, m', v') with ``p' = p - step``."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * (g * g)
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    step = lr * mhat / (torch.sqrt(vhat) + eps)
    return step, m, v


def trainer_mode(cfg: GSRTrainConfig) -> str:
    """The step the fold-parallel trainer runs for ``cfg``, by the JAX
    package's precedence: ``fused_adam`` over ``fused_step`` over the
    ``fused_tail`` family (``fused_unet_bwd`` counts only with
    ``fused_unet``, ``fused_unet`` only with ``fused_tail``) over
    ``unfused``."""
    if cfg.fused_adam:
        return "fused_adam"
    if cfg.fused_step:
        return "fused_step"
    if cfg.fused_tail:
        if cfg.fused_unet:
            return ("fused_tail_unet_bwd" if cfg.fused_unet_bwd
                    else "fused_tail_unet")
        return "fused_tail"
    return "unfused"


def checkpoint_format(path: str) -> str:
    """The resume blob's format at ``path``: "msgpack" (the JAX fast
    loop's) where the file is one, or where there is no file and the path
    ends in ``.msgpack``; else "npz" (the port's)."""
    if os.path.exists(path):
        return "msgpack" if is_msgpack(path) else "npz"
    return "msgpack" if path.endswith(".msgpack") else "npz"


def _pad_plans(folds, which: int, pad_to: int = None):
    """(F, L) padded index + validity arrays for fold element ``which``
    (0 = train indices, 1 = val indices)."""
    sets = [np.asarray(f[which], dtype=np.int32) for f in folds]
    max_len = pad_to or max(len(s) for s in sets)
    idxs, valids = [], []
    for s in sets:
        pad = max_len - len(s)
        idxs.append(np.concatenate([s, np.zeros(pad, np.int32)]))
        valids.append(np.concatenate([np.ones(len(s), np.float32),
                                      np.zeros(pad, np.float32)]))
    return np.stack(idxs), np.stack(valids)


def stage_dataset(cfg: GSRTrainConfig, lr_all, hr_all, device):
    """Host precompute (normalized adjacency + spectral bases) and one
    transfer to ``device``: returns float32 tensors (a_norm, hr, u_lr,
    u_hr_reduced)."""
    lr_np = np.asarray(lr_all, dtype=np.float32)
    hr_np = np.asarray(hr_all, dtype=np.float32)
    a_norm = normalize_adj_np(lr_np).astype(np.float32)
    u_lr, u_hr = precompute_spectral(lr_np, hr_np, lr_dim=cfg.lr_dim,
                                     padding=cfg.padding, a_norm=a_norm)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device)
                 for a in (a_norm, hr_np, u_lr, u_hr))


class _FoldShard:
    """One placement's contiguous block of folds ``[lo, hi)``: its per-step
    (S, F, ...) data stacks on its device, the step of the runner's mode
    over (F, P) buffers, and its epoch program over static buffers."""

    def __init__(self, runner: "GSRFoldRunner", lo: int, hi: int, device,
                 data):
        self.cfg, self.mode, self.layout = runner.cfg, runner.mode, \
            runner.layout
        self.lo, self.hi, self.n_folds = lo, hi, hi - lo
        self.device = device
        # per-step (S, F, ...) stacks: step s of fold f trains on sample
        # tr_idx[f, s]; a view per step, no gather inside the loop
        plan = torch.from_numpy(runner.tr_idx[lo:hi].T.astype(np.int64)).to(
            device)
        a_norm, hr, u_lr, u_hr = data
        self._steps = tuple(x[plan] for x in (u_lr, u_hr, hr))
        # only the unfused model is handed the adjacency (and ignores it);
        # the folds' parameters are swapped into one module per call (the
        # unfused step's and every mode's evaluation)
        self._a_norm_steps = a_norm[plan] if self.mode == "unfused" \
            else None
        self._module = runner._model(device=device)
        # the evaluation's padded (F, V) validation plan and its weights
        self._va_idx = torch.from_numpy(
            runner.va_idx[lo:hi].astype(np.int64)).to(device)
        self._va_valid = torch.from_numpy(runner.va_valid[lo:hi]).to(device)
        self._no_vals = torch.zeros(self.n_folds, 3, dtype=torch.float32,
                                    device=device)
        # the epoch program's static buffers (a graph reads and writes
        # fixed addresses): the state, the epoch's Adam scalars, the
        # per-step loss and recon
        S, F = plan.shape[0], self.n_folds

        def zeros(*shape):
            return torch.zeros(*shape, dtype=torch.float32, device=device)
        self.bufs = dict(p=zeros(F, self.layout.size),
                         m=zeros(F, self.layout.size),
                         v=zeros(F, self.layout.size), scal=zeros(S, F, 3),
                         loss=zeros(S, F), err=zeros(S, F))
        self.graph = None

    def loss(self, P, s: int):
        """(loss, err), each (F,), of step ``s`` for the leaf mapping ``P``
        in this runner's mode, differentiable in the leaves."""
        cfg = self.cfg
        u_lr, u_hr, hr = (x[s] for x in self._steps)
        if self.mode == "fused_step":
            return gsr_step_loss_fused(
                P, P["layer.weights"], P["gc1.weight"], P["gc2.weight"],
                u_lr, u_hr, hr, cfg.ks, cfg.lr_dim, cfg.hr_dim, cfg.lmbda,
                device=self.device)
        if self.mode == "unfused":
            cast = (lambda t: t.to(torch.bfloat16)) \
                if cfg.compute_dtype == "bf16" else (lambda t: t)
            params = {k: cast(t) for k, t in
                      leaf_tensors_to_state(P).items()}
            return vmap(self._unfused_loss)(
                params, cast(self._a_norm_steps[s]), cast(u_lr), u_hr, hr)
        if self.mode == "fused_tail_unet_bwd":
            net, start = unet_fused_fwdbwd(P, cfg.ks, cfg.lr_dim, cfg.hr_dim,
                                           device=self.device)
        elif self.mode == "fused_tail_unet":
            net, start = unet_fused_fwdonly(P, cfg.ks, cfg.lr_dim,
                                            cfg.hr_dim, device=self.device)
        else:
            net, start = unet_forward_rankselect(P, cfg.ks, cfg.lr_dim)
        w = P["layer.weights"]
        tail = tail_loss_fused(w, P["gc1.weight"], P["gc2.weight"], net,
                               u_lr, u_hr, hr, device=self.device)
        loss = cfg.lmbda * (net - start).abs().mean(dim=(1, 2)) + tail
        # reconstruction error = tail minus the spectral term
        err = tail - (w - u_hr).abs().mean(dim=(1, 2))
        return loss, err

    def _unfused_loss(self, params, a_norm, u_lr, u_hr, hr):
        """One fold's (loss, err) of the unfused model, its parameters and
        inputs cast as the mode casts them; ``loss`` maps it over the
        folds with ``torch.func.vmap``, as the JAX runner vmaps its
        ``fold_train``."""
        pred, net, start, _ = functional_call(
            self._module, params, (a_norm,),
            {"u_lr": u_lr, "a_norm": a_norm})
        return gsr_composite_loss(
            unpad(pred.float(), self.cfg.padding), net.float(), start.float(),
            params["layer.weights"].float(), u_hr, hr, self.cfg.lmbda)

    def _predict(self, params, a_norm, u_lr):
        return functional_call(self._module, params, (a_norm,),
                               {"u_lr": u_lr, "a_norm": a_norm})[0]

    @torch.no_grad()
    def evaluate(self, flat, data):
        """(MAE (F,), predictions (F, V, hr, hr)) of the shard's first F
        folds, their parameters the rows of ``flat`` (F, P), over the
        staged ``data``: on the padded (F, V) validation plan with its
        weights, one forward vmapped over the folds (the parameters views
        of ``flat``), as the JAX runner's ``eval_all``; a subject's MAE is
        against its label with the diagonal set to 1, a fold's the
        weighted mean of its subjects'."""
        a_norm, hr, u_lr, _ = data
        idx, valid = self._va_idx[:len(flat)], self._va_valid[:len(flat)]
        params = leaf_tensors_to_state(self.layout.views(flat.contiguous()))
        pred = unpad(vmap(self._predict)(params, a_norm[idx], u_lr[idx]),
                     self.cfg.padding)
        per = (pred - fill_diagonal(hr[idx], 1.0)).abs().mean(dim=(-2, -1))
        return (per * valid).sum(1) / valid.sum(1).clamp(min=1.0), pred

    def step(self, p, m, v, s: int, scal):
        """One fold-batched step on sample slot ``s``: (loss, err, p', m',
        v') with loss and err multiplied by the folds' validity."""
        cfg = self.cfg
        if self.mode == "fused_adam":
            u_lr, u_hr, hr = (x[s] for x in self._steps)
            return train_step_fused(
                p, m, v, u_lr, u_hr, hr, scal, cfg.ks, cfg.lr_dim,
                cfg.hr_dim, cfg.lmbda, cfg.lr, B1, B2, EPS,
                device=self.device)
        # the leaf views of p are the autograd leaves: the gradient comes
        # back leaf by leaf and is laid out flat for the one Adam launch
        P = {k: t.requires_grad_() for k, t in self.layout.views(p).items()}
        loss, err = self.loss(P, s)
        grads = torch.autograd.grad(loss.sum(), list(P.values()))
        g = torch.cat([x.reshape(self.n_folds, -1) for x in grads], dim=1)
        p, m, v, _, _ = KERNEL_OPS.adam_masked(p, m, v, g, scal,
                                               self._no_vals, cfg.lr, B1,
                                               B2, EPS)
        ok = scal[:, 0]
        return loss.detach() * ok, err.detach() * ok, p, m, v

    def epoch(self, b: dict, slots: range) -> None:
        """The epoch program: the steps of ``slots`` over the buffers ``b``
        (``bufs``' keys), each from the last one's p, m and v with the
        scalars ``b["scal"][s]``; their loss and recon land in
        ``b["loss"][s]`` and ``b["err"][s]``, the last p, m and v in
        ``b``'s (the steps return fresh tensors)."""
        p, m, v = b["p"], b["m"], b["v"]
        losses, errs = [], []
        for s in slots:
            loss, err, p, m, v = self.step(p, m, v, s, b["scal"][s])
            losses.append(loss)
            errs.append(err)
        for name, x in (("p", p), ("m", m), ("v", v)):
            b[name].copy_(x)
        torch.stack(losses, out=b["loss"][slots.start:slots.stop])
        torch.stack(errs, out=b["err"][slots.start:slots.stop])

    def prepare(self, eager: bool) -> None:
        """Capture the epoch's graph where ``run_epoch`` replays one (on
        the card, not ``eager``) and none is there yet, after a warm-up of
        ``_WARM_SLOTS`` steps on scratch copies of the buffers."""
        if eager or self.device.type != "cuda" or self.graph is not None:
            return
        slots = range(self.bufs["loss"].shape[0])
        scratch = {k: t.clone() for k, t in self.bufs.items()}
        self.graph = EpochGraph(
            f"the {self.mode} epoch of folds {self.lo}-{self.hi - 1}",
            self.device, lambda: self.epoch(self.bufs, slots),
            lambda: self.epoch(scratch, slots[:_WARM_SLOTS]))

    def run_epoch(self, eager: bool) -> None:
        """One epoch over ``bufs``: on the card the replay of its graph
        (captured by ``prepare``), on the CPU or ``eager`` the program
        itself, step by step from Python."""
        if eager or self.device.type != "cuda":
            self.epoch(self.bufs, range(self.bufs["loss"].shape[0]))
            return
        self.graph.replay()

    def release_graph(self) -> None:
        if self.graph is not None:
            self.graph.release()
        self.graph = None


class GSRFoldRunner:
    """Stage once, train/evaluate all folds together on one device, or on
    the placements of ``mesh``.

    ``flat0`` optionally gives the initial parameters, (F, P) in the
    kernels' flat order (``iox/weights.py``); by default fold j starts
    from ``GSRNet(seed=init_seed + j)``, padding folds included. ``device``
    defaults to CUDA and raises without a card unless the caller passes
    ``device="cpu"``; a ``mesh`` gives the placements instead.

    With a mesh the state (p, m, v) is a list of each placement's (F_i, P)
    block; ``flat0`` is the whole padded stack on the first placement."""

    def __init__(self, cfg: GSRTrainConfig, lr_all, hr_all, folds,
                 init_seed: int = 0, flat0=None, device=DEFAULT_DEVICE,
                 mesh=None):
        self.mode = trainer_mode(cfg)
        if cfg.padding and self.mode != "unfused":
            # the fused kernels compute the loss at hr_dim without the
            # unfused branch's unpad() crop
            raise ValueError(
                "padding != 0 is not supported by the fused kernel paths "
                "(fused_step/fused_tail/fused_adam); use the unfused "
                "trainer (all fused flags False) for padded configs")
        if cfg.hidden_dim != cfg.hr_dim and self.mode in ("fused_step",
                                                         "fused_adam"):
            raise ValueError(f"trainer mode {self.mode} at hidden_dim "
                             f"{cfg.hidden_dim} != hr_dim {cfg.hr_dim}: "
                             f"{HIDDEN_REFUSAL}")
        self.cfg = cfg
        self.folds = folds
        self.n_folds = len(folds)
        self.mesh = mesh
        placements = (list(mesh.devices) if mesh is not None
                      else [resolve_device(device)])
        self.device = placements[0]
        if cfg.compute_dtype == "bf16" and self.mode == "unfused" and any(
                torch.device(d).type == "cuda" for d in placements):
            # the bf16 products sum in fp32, as XLA's do
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        # padding folds: every train and validation slot masked, so each
        # is a no-op; the padded count shapes the state
        n_pad = (-self.n_folds) % len(placements)
        self._n_total = self.n_folds + n_pad
        self.layout = FlatLayout(cfg.lr_dim, cfg.hr_dim, len(cfg.ks),
                                 cfg.hidden_dim)
        self.data = stage_dataset(cfg, lr_all, hr_all, self.device)
        pad_folds = list(folds) + [(np.zeros(1, np.int32),) * 2] * n_pad
        self.tr_idx, self.tr_valid = _pad_plans(pad_folds, 0)
        self.va_idx, self.va_valid = _pad_plans(pad_folds, 1)
        self.tr_valid[self.n_folds:] = 0.0
        self.va_valid[self.n_folds:] = 0.0
        if flat0 is None:
            flat0 = np.stack([self._init_flat(init_seed + j)
                              for j in range(self._n_total)])
        flat0 = torch.as_tensor(np.asarray(flat0, np.float32))
        if flat0.shape[0] == self.n_folds < self._n_total:
            flat0 = torch.cat([flat0, torch.from_numpy(np.stack([
                self._init_flat(init_seed + j)
                for j in range(self.n_folds, self._n_total)]))])
        if tuple(flat0.shape) != (self._n_total, self.layout.size):
            raise ValueError(f"flat0 must be ({self.n_folds}, "
                             f"{self.layout.size}), got {tuple(flat0.shape)}")
        self.flat0 = flat0.to(self.device).contiguous()
        self.flat_trained = None
        self.fingerprint = self._fingerprint(lr_all, hr_all, flat0)
        self.jax_fingerprint = self._jax_fingerprint(lr_all, hr_all,
                                                     init_seed)
        staged = {self.device: self.data}
        per = self._n_total // len(placements)
        self.shards = []
        for i, dev in enumerate(placements):
            if dev not in staged:
                staged[dev] = tuple(x.to(dev) for x in self.data)
            with on_device(dev):
                self.shards.append(_FoldShard(self, i * per, (i + 1) * per,
                                              dev, staged[dev]))
        self._staged = staged
        self._eager = False

    def _fingerprint(self, lr_all, hr_all, flat0) -> str:
        """Hash of config + fold plan + initial weights + dataset content
        (+ the padded fold count where the mesh pads). Stored in resume
        blobs, so a file from another run at the same path (other epochs,
        folds, seed, data or mesh padding) is detected and discarded
        instead of restored."""
        h = hashlib.blake2b(digest_size=8)
        h.update(repr(self.cfg).encode())
        if self._n_total != self.n_folds:
            h.update(repr(self._n_total).encode())
        return self._hash_plan(h, (lr_all, hr_all, flat0))

    def _jax_fingerprint(self, lr_all, hr_all, init_seed) -> str:
        """The JAX runner's fingerprint (``fcsr_tpu/train/fast_loop.py:
        402-420``), which its msgpack blobs carry: config, ``init_seed``
        (not the initial weights), the padded fold count, fold plan and
        dataset content. The configs' reprs are equal field for field."""
        h = hashlib.blake2b(digest_size=8)
        h.update(repr(self.cfg).encode())
        h.update(repr(init_seed).encode())
        h.update(repr(self._n_total).encode())
        return self._hash_plan(h, (lr_all, hr_all))

    def _hash_plan(self, h, arrays) -> str:
        """``h`` over the fold plan (int64 bytes) and then each array
        (float32 shape and bytes); its hex digest."""
        for tr, va in self.folds:
            h.update(np.asarray(tr, np.int64).tobytes())
            h.update(np.asarray(va, np.int64).tobytes())
        for a in arrays:
            a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    def _model(self, seed: int = 0, device="cpu") -> GSRNet:
        cfg = self.cfg
        return GSRNet(cfg.ks, cfg.lr_dim, cfg.hr_dim, cfg.hidden_dim,
                      device=device, seed=seed)

    def _init_flat(self, seed: int) -> np.ndarray:
        state = {k: t.numpy() for k, t in
                 self._model(seed).state_dict().items()}
        return state_to_flat(state)

    def _blocks(self, x) -> list:
        """Each shard's block of a fold-stacked state buffer."""
        return list(x) if isinstance(x, (list, tuple)) else [x]

    def _split(self, x) -> list:
        """A whole (F_total, ...) host array or tensor as each shard's
        block on its placement."""
        x = torch.as_tensor(x)
        return [x[sh.lo:sh.hi].to(sh.device).contiguous()
                for sh in self.shards]

    def _state(self, blocks):
        """One tensor on one device, each shard's block under a mesh."""
        return list(blocks) if self.mesh is not None else blocks[0]

    def _gather(self, x) -> torch.Tensor:
        """The whole fold stack of a state buffer on the first placement."""
        blocks = self._blocks(x)
        if len(blocks) == 1:
            return blocks[0]
        return torch.cat([b.to(self.device) for b in blocks])

    def fresh_state(self):
        """(params, adam_m, adam_v, step counts) over folds; the counts
        stay on the host, where the chunk's Adam scalars are planned."""
        p = self._split(self.flat0)
        return (self._state([b.clone() for b in p]),
                self._state([torch.zeros_like(b) for b in p]),
                self._state([torch.zeros_like(b) for b in p]),
                np.zeros(self._n_total, np.float32))

    def _step(self, p, m, v, s: int, scal):
        """One fold-batched step of a one-device runner (its only shard),
        from Python: the eager yardstick of a step."""
        with on_device(self.device):
            return self.shards[0].step(p, m, v, s, scal)

    def _stay_eager(self, eager: bool = True) -> None:
        """Run every later epoch step by step from Python on the card too
        (``eager=False``: through the graphs again): the yardstick the
        graphs are held to, bit for bit."""
        self._eager = eager

    def release_graphs(self) -> None:
        """Free the shards' captured epochs and their memory; a later
        epoch captures them again."""
        for sh in self.shards:
            with on_device(sh.device):
                sh.release_graph()

    def _run_chunk(self, state, epochs: int):
        """``epochs`` epochs from ``state``: (state after them, loss and
        recon epoch means (F_total, epochs)). The state is copied into the
        shards' static buffers and the one returned is a copy of them;
        each epoch copies its slice of the chunk's Adam scalars in, runs
        each shard's epoch (on the card one replay of its graph, every
        shard's issued before any is waited on) and copies the per-step
        loss and recon into the chunk's history on the device, read once
        at the end. In a run (``utils/profiling.py``) its steps are spans
        and each shard's stream gets a timing event at every epoch
        boundary, read after the history."""
        t = state[3]
        n_steps = self.tr_idx.shape[1]
        with profiling.span("plan"):
            scal = np.empty((epochs, n_steps, self._n_total, 3), np.float32)
            for e in range(epochs):
                for s in range(n_steps):
                    scal[e, s], t = adam_scalars(t, self.tr_valid[:, s], B1,
                                                 B2)
        hists = []
        with profiling.span("load_state"):
            for i, sh in enumerate(self.shards):
                with on_device(sh.device):
                    for name, x in zip("pmv", state[:3]):
                        sh.bufs[name].copy_(self._blocks(x)[i])
                    hists.append((torch.from_numpy(
                        scal[:, :, sh.lo:sh.hi].copy()).to(sh.device),
                        torch.empty(epochs, 2, n_steps, sh.n_folds,
                                    device=sh.device)))
        clock = profiling.epoch_clock([sh.device for sh in self.shards])
        with profiling.span("epochs"):
            # each shard's launches planned as for the unsharded run's
            # folds: a fold's bits are that run's. Every graph is captured
            # before the first boundary: an epoch's time is its own.
            for sh, (table, _) in zip(self.shards, hists):
                with on_device(sh.device), plan_folds(self.n_folds):
                    sh.bufs["scal"].copy_(table[0])
                    sh.prepare(self._eager)
            clock.mark()
            for e in range(epochs):
                for sh, (table, hist) in zip(self.shards, hists):
                    with on_device(sh.device), plan_folds(self.n_folds):
                        if e:
                            sh.bufs["scal"].copy_(table[e])
                        sh.run_epoch(self._eager)
                        hist[e, 0].copy_(sh.bufs["loss"])
                        hist[e, 1].copy_(sh.bufs["err"])
                clock.mark()
        with profiling.span("history_read"):
            # (epochs, 2, S, F_total); each fold's steps summed along a
            # contiguous row, so its sum does not depend on how many folds
            # lie beside it
            steps = np.concatenate([h.cpu().numpy() for _, h in hists],
                                   axis=3)
            clock.close()
        denom = np.maximum(self.tr_valid.sum(axis=1), 1.0)

        def epoch_means(k):
            per = steps[:, k].reshape(epochs * n_steps, -1)
            sums = np.ascontiguousarray(
                per.T.reshape(-1, epochs, n_steps)).sum(axis=2)
            return sums / denom[:, None]

        with profiling.span("state_out"):
            state = tuple(self._state([sh.bufs[name].clone()
                                       for sh in self.shards])
                          for name in "pmv") + (t,)
        return state, epoch_means(0), epoch_means(1)

    def _dims(self):
        lay = self.layout
        return lay.lr_dim, lay.hr_dim, lay.n_levels, lay.hidden_dim

    def save_checkpoint(self, path: str, state, epoch: int, loss_hist,
                        err_hist, fmt: str = None) -> None:
        """Write the resume blob of ``state`` (the whole padded fold stack)
        after ``epoch`` epochs; the histories are the real folds'. ``fmt``
        "npz" or "msgpack" (default: ``checkpoint_format(path)``)."""
        p, m, v = (self._gather(x).cpu().numpy() for x in state[:3])
        t = np.asarray(state[3], np.float32)
        loss_hist = np.asarray(loss_hist, np.float32)[:self.n_folds]
        err_hist = np.asarray(err_hist, np.float32)[:self.n_folds]
        if (fmt or checkpoint_format(path)) == "msgpack":
            p, m, v = (flat_to_flax_ravel(x, *self._dims())
                       for x in (p, m, v))
            save_resume_msgpack(path, p, m, v, t, epoch,
                                self.jax_fingerprint, loss_hist, err_hist)
            return
        lr_dim, hr_dim, n_levels, hidden_dim = self._dims()
        save_arrays(path, p=p, m=m, v=v, t=t, epoch=np.int64(epoch),
                    fingerprint=np.str_(self.fingerprint),
                    loss_hist=loss_hist, err_hist=err_hist,
                    lr_dim=np.int64(lr_dim), hr_dim=np.int64(hr_dim),
                    n_levels=np.int64(n_levels),
                    hidden_dim=np.int64(hidden_dim))

    def _restore(self, path: str, fmt: str):
        """(state, epochs done, loss_hist, err_hist) from this run's blob
        at ``path`` (``fmt`` "npz" or "msgpack"), or None after discarding
        another run's with the warning of the package that writes it."""
        if fmt == "msgpack":
            blob = load_resume_msgpack(path)
            ok = blob["fingerprint"] == self.jax_fingerprint
            what = "config/folds/dataset"
        else:
            blob = load_arrays(path)
            ok = str(blob.get("fingerprint")) == self.fingerprint
            what = "config/folds/dataset/mesh"
        if ok and int(blob["epoch"]) <= self.cfg.epochs:
            if fmt == "msgpack":
                p, m, v, t = blob["state"]
                p, m, v = (flat_from_flax_ravel(x, *self._dims())
                           for x in (p, m, v))
            else:
                p, m, v, t = (blob[k] for k in ("p", "m", "v", "t"))
            state = tuple(self._state(self._split(x)) for x in (p, m, v)) \
                + (np.asarray(t, np.float32),)
            return (state, int(blob["epoch"]),
                    np.asarray(blob["loss_hist"], np.float32),
                    np.asarray(blob["err_hist"], np.float32))
        warnings.warn(
            f"checkpoint {path} is from a different run ({what} "
            "fingerprint mismatch) — discarding it and training from "
            "scratch")
        os.remove(path)
        return None

    def train(self, checkpoint_path: str = None,
              checkpoint_every: int = None, chunk_epochs: int = None):
        """Full training run, as repeated launches of ``chunk_epochs``
        epochs (default: one chunk of ``cfg.epochs``); trajectory-identical
        either way. Returns (trained flat params (F, P) of the real folds,
        on the first placement, loss_hist (F, E), err_hist (F, E)).

        With ``checkpoint_path`` the state is written there every
        ``checkpoint_every`` epochs (default ``chunk_epochs``, else a tenth
        of the run) and the run resumes from the file if it holds this
        run's fingerprint; another run's file is discarded with a
        warning. The file's format is ``checkpoint_format``'s, fixed when
        the run starts."""
        chunk = chunk_epochs or self.cfg.epochs
        fmt = None
        if checkpoint_path is not None:
            chunk = checkpoint_every or chunk_epochs or \
                max(1, self.cfg.epochs // 10)
            fmt = checkpoint_format(checkpoint_path)
        state = self.fresh_state()
        losses, errs = [], []
        done = 0
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            restored = self._restore(checkpoint_path, fmt)
            if restored is not None:
                state, done, lh, eh = restored
                losses, errs = [lh], [eh]
        while done < self.cfg.epochs:
            n = min(chunk, self.cfg.epochs - done)
            state, lh, eh = self._run_chunk(state, n)
            losses.append(lh[:self.n_folds])
            errs.append(eh[:self.n_folds])
            done += n
            if checkpoint_path is not None:
                self.save_checkpoint(checkpoint_path, state, done,
                                     np.concatenate(losses, axis=1),
                                     np.concatenate(errs, axis=1), fmt)
        self.flat_trained = state[0]
        return (self._gather(state[0])[:self.n_folds],
                np.concatenate(losses, axis=1).astype(np.float32),
                np.concatenate(errs, axis=1).astype(np.float32))

    def evaluate(self, flat=None):
        """Validation MAE per real fold (the label's diagonal set to 1),
        and their (F, V, hr, hr) predictions over the padded val plan, on
        the first placement. ``flat`` is a fold stack (real or padded
        folds) or a state's per-shard blocks. Each shard evaluates its
        real folds in one forward on its placement (``_FoldShard.
        evaluate``) and its MAEs are read once."""
        if flat is None:
            if self.flat_trained is None:
                raise RuntimeError(
                    "GSRFoldRunner.evaluate() called before train(); pass "
                    "params explicitly (e.g. runner.flat0) or train first")
            flat = self.flat_trained
        blocks = self._blocks(flat)
        maes, preds = [], []
        for i, sh in enumerate(self.shards):
            n = min(sh.hi, self.n_folds) - sh.lo
            if n <= 0:
                continue
            block = blocks[i][:n] if len(blocks) == len(self.shards) > 1 \
                else blocks[0][sh.lo:sh.lo + n]
            with on_device(sh.device):
                mae, pred = sh.evaluate(block.detach().to(sh.device),
                                        self._staged[sh.device])
                maes.append(mae.cpu().numpy())
            preds.append(pred.to(self.device))
        return np.concatenate(maes).astype(np.float32), torch.cat(preds)

    def params_per_fold(self) -> List[dict]:
        """The trained parameters of each real fold as a state_dict of
        numpy arrays."""
        flat = self._gather(self.flat_trained)
        return [flat_to_state(flat[j].cpu().numpy(), self.layout.shapes)
                for j in range(self.n_folds)]


def train_gsr_folds_parallel(cfg: GSRTrainConfig, lr_all, hr_all, folds,
                             init_seed: int = 0,
                             checkpoint_path: str = None,
                             checkpoint_every: int = None, flat0=None,
                             device=DEFAULT_DEVICE, mesh=None,
                             phases=None):
    """Train one fresh GSR-Net per fold, all folds together (with ``mesh``
    the folds sharded over its placements). Returns (model, per-fold
    state_dict list, loss_hist (F, epochs), err_hist (F, epochs), runner),
    for the real folds; the runner keeps the staged data on the device
    for the evaluation that follows, and ``model`` is a GSRNet of the
    run's shape on the run's (first) device to load any fold's state
    into. ``phases``: two context managers, entered around the runner's
    construction and around the training (a pipeline's phases)."""
    stage, train = phases or (contextlib.nullcontext(),) * 2
    with stage:
        runner = GSRFoldRunner(cfg, lr_all, hr_all, folds,
                               init_seed=init_seed, flat0=flat0,
                               device=device, mesh=mesh)
    with train:
        _, loss_hist, err_hist = runner.train(
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every)
        runner.release_graphs()
        model = runner._model(device=runner.device)
        params = runner.params_per_fold()
    return model, params, loss_hist, err_hist, runner


def evaluate_gsr_folds(cfg: GSRTrainConfig, runner: GSRFoldRunner,
                       pull_preds: bool = True):
    """All folds' validation passes. Returns (fold_maes, per-fold
    (preds, gts) numpy pairs over each fold's own validation subjects —
    empty unless ``pull_preds``); the labels' diagonal is set to 1, as the
    reference's test() compares them."""
    maes, preds_d = runner.evaluate()
    fold_maes = [float(m) for m in maes]
    outs = []
    if pull_preds:
        preds_np = preds_d.cpu().numpy()
        hr_np = runner.data[1].cpu().numpy()
        for j, (_, va) in enumerate(runner.folds):
            gts = hr_np[np.asarray(va)].copy()
            for m in gts:
                np.fill_diagonal(m, 1.0)
            outs.append((preds_np[j, :len(va)], gts))
    return fold_maes, outs
