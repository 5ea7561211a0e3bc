"""GSR-Net training configuration, the host spectral precompute, the
parity trainer and batched inference / validation (counterparts of
``fcsr_tpu/train/gsr_loop.py``).

The parity trainer (``init_gsr``, ``make_train_fn``, ``train_gsr_fold``)
replicates the reference's update order exactly: one model, one
``torch.optim.Adam``, one optimizer step per subject, subjects in fixed
order each epoch. It is the unfused model (``torch.matmul``) under
autograd; the fold-parallel trainers are in ``train/fast_loop.py``. Where
the JAX package returns new parameters and optimizer state, the port
updates the model and the optimizer in place.

Where the JAX package jits the whole run (``fcsr_tpu/train/gsr_loop.py:
179-216``), an epoch over a fold's subjects is one program over the
stacks the trainer is handed: on the card one CUDA graph
(``train/epoch_graph.py``), captured at the call's first epoch and
released at its end (a fold of another size is another program), on the
CPU the same program step by step. A graph needs an optimizer that keeps
its step count on the card: ``init_gsr`` builds Adam with
``capturable=True`` on a CUDA device (its bias correction in float32 on
the card, as optax computes it), and the trainer refuses any other
optimizer there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from fcsr_tpu_torch.core.normalize import normalize_adj_np, unpad
from fcsr_tpu_torch.core.triu_kernels import normalize_adj_batch
from fcsr_tpu_torch.models.gsr import GSRNet
from fcsr_tpu_torch.train.epoch_graph import EpochGraph
from fcsr_tpu_torch.train.losses import gsr_composite_loss
from fcsr_tpu_torch.utils import host_cache
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["GSRTrainConfig", "init_gsr", "precompute_spectral",
           "make_train_fn", "train_gsr_fold", "predict_gsr", "evaluate_gsr"]


@dataclass(frozen=True)
class GSRTrainConfig:
    """Hyperparameters of the shipped GSR-Net run (the reference notebook's
    Args), with the JAX package's defaults and flags. The ``fused_*``
    flags pick the fold-parallel trainer's step (``train/fast_loop.py``);
    the parity trainer ignores them."""
    epochs: int = 200
    lr: float = 1e-4
    lmbda: float = 16.0
    lr_dim: int = 160
    hr_dim: int = 268
    hidden_dim: int = 268
    padding: int = 0
    ks: Tuple[float, ...] = (0.9, 0.7, 0.6, 0.5)
    # the spectral tail's value and gradients from one pass over its
    # kernels (models/fused_tail.py::tail_loss_fused)
    fused_tail: bool = False
    # with fused_tail: the U-Net forward on the kernels too, its backward
    # by autograd (models/fused_step.py::unet_fused_fwdonly)
    fused_unet: bool = False
    # with fused_unet: the U-Net backward as the hand-written adjoints
    # (unet_fused_fwdbwd); ignored without fused_unet
    fused_unet_bwd: bool = False
    # the whole step's value and gradients by its kernels
    # (gsr_step_loss_fused), then the flat Adam; takes precedence over the
    # three flags above
    fused_step: bool = False
    # the step including the masked Adam update (train_step_fused); takes
    # precedence over every other flag
    fused_adam: bool = False
    # "bf16": the fold-parallel runner's unfused step in bf16 (parameters,
    # a_norm and u_lr cast, as the JAX package's); every other trainer
    # accepts and ignores it, as there
    compute_dtype: str = "f32"

    def __post_init__(self):
        if self.compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype must be 'f32' or 'bf16', got "
                             f"{self.compute_dtype!r}")

    def model(self, device=DEFAULT_DEVICE, seed: int = 0) -> GSRNet:
        return GSRNet(ks=self.ks, lr_dim=self.lr_dim, hr_dim=self.hr_dim,
                      hidden_dim=self.hidden_dim, device=device, seed=seed)


def init_gsr(cfg: GSRTrainConfig, seed: int = 0, device=DEFAULT_DEVICE):
    """(model, optimizer): a GSR-Net initialised from ``seed`` on
    ``device`` and the reference's optimizer, Adam with b1 = 0.9,
    b2 = 0.999, eps = 1e-8; on a CUDA device ``capturable`` (its step
    count on the card), which the parity trainer's epoch graph needs."""
    model = cfg.model(device=device, seed=seed)
    cuda = next(model.parameters()).is_cuda
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 capturable=cuda)
    return model, optimizer


def precompute_spectral(lr_stack, hr_stack, lr_dim: int = 160,
                        padding: int = 0, a_norm=None):
    """Batched eigendecompositions hoisted out of the train loop, on host
    LAPACK (``np.linalg.eigh`` of the same float32 arrays as the JAX
    package, so the eigenvector signs — which change the model — agree).

    Returns (u_lr, u_hr_reduced): eigenvectors of normalize_adj(lr) per
    subject, and the first ``lr_dim`` eigenvector columns of the padded HR
    label with its diagonal set to 1. Disk-cached per dataset content
    (``utils/host_cache.py``)."""
    lr_np = np.asarray(lr_stack, dtype=np.float32)
    hr_np = np.asarray(hr_stack, dtype=np.float32)
    cache = host_cache.cache_path("spectral", (lr_np, hr_np),
                                  (lr_dim, padding))
    hit = host_cache.load(cache, ("u_lr", "u_hr_reduced"))
    if hit is not None:
        return hit
    if a_norm is None:
        a_norm = normalize_adj_np(lr_np)
    _, u_lr = np.linalg.eigh(np.asarray(a_norm, dtype=np.float32))
    if padding:
        hr_np = np.pad(hr_np, ((0, 0), (padding, padding),
                               (padding, padding)))
    else:
        hr_np = hr_np.copy()
    n = hr_np.shape[-1]
    hr_np[:, np.arange(n), np.arange(n)] = 1.0
    _, u_hr = np.linalg.eigh(hr_np)
    u_hr_reduced = u_hr[..., :, :lr_dim]
    host_cache.save(cache, u_lr=u_lr, u_hr_reduced=u_hr_reduced)
    return u_lr, u_hr_reduced


_WARM_STEPS = 2  # subjects the warm-up before an epoch's capture trains


def _check_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Refuse an optimizer the parity trainer's epoch graph cannot hold:
    on the card it must be ``torch.optim.Adam`` or ``AdamW`` built with
    ``capturable=True`` (whose state the warm-up before a capture can set
    back to its initial zeros)."""
    if type(optimizer) in (torch.optim.Adam, torch.optim.AdamW) and all(
            g.get("capturable") for g in optimizer.param_groups):
        return
    raise ValueError(
        f"the parity trainer replays each epoch as one CUDA graph on the "
        f"card and cannot hold a {type(optimizer).__name__} without "
        f"capturable=True there; build it as torch.optim.Adam(model."
        f"parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, "
        f"capturable=True), as init_gsr does on a CUDA device")


class _ParityTrainer:
    """``make_train_fn``'s trainer: ``cfg.epochs`` replays of the epoch
    program (one step per subject in order) over the stacks it is
    called with. ``graph`` keeps the last call's capture (released) for
    its launches and seconds."""

    def __init__(self, model: GSRNet, optimizer: torch.optim.Optimizer,
                 cfg: GSRTrainConfig, per_step: bool):
        self.model, self.optimizer = model, optimizer
        self.cfg, self.per_step = cfg, per_step
        self.dev = next(model.parameters()).device
        if self.dev.type == "cuda":
            _check_capturable(optimizer)
        self.graph = None
        self._eager = False

    def _epoch(self, stacks, loss_out, err_out, n_steps: int = None):
        """The epoch program: one Adam step per subject of ``stacks`` (the
        first ``n_steps``), the steps' loss and error into ``loss_out`` and
        ``err_out``."""
        model, optimizer, cfg = self.model, self.optimizer, self.cfg
        lr_stack, hr_stack, u_lr, u_hr_red = stacks
        losses, errs = [], []
        for i in range(len(lr_stack) if n_steps is None else n_steps):
            pred, net_outs, start_outs, _ = model(lr_stack[i], u_lr=u_lr[i])
            loss, err = gsr_composite_loss(
                unpad(pred, cfg.padding), net_outs, start_outs,
                model.layer.weights, u_hr_red[i], hr_stack[i], cfg.lmbda)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
            errs.append(err.detach())
        torch.stack(losses, out=loss_out)
        torch.stack(errs, out=err_out)

    def _warm(self, stacks, n_steps: int):
        """``n_steps`` steps on the live model and optimizer, then both set
        back: the parameters and any earlier state copied back in place,
        the state the steps made (Adam's and AdamW's first step makes it)
        zeroed, as their first step finds it."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        saved = [p.detach().clone() for p in params]
        state = {p: {k: v.clone() for k, v in self.optimizer.state[p].items()
                     if torch.is_tensor(v)}
                 for p in params if p in self.optimizer.state}
        scratch = torch.empty(2, n_steps, device=self.dev)
        self._epoch(stacks, scratch[0], scratch[1], n_steps)
        with torch.no_grad():
            for p, x in zip(params, saved):
                p.copy_(x)
                p.grad = None
            for p in params:
                for k, v in self.optimizer.state[p].items():
                    if not torch.is_tensor(v):
                        continue
                    if p in state:
                        v.copy_(state[p][k])
                    else:
                        v.zero_()

    def __call__(self, lr_stack, hr_stack, u_lr, u_hr_red):
        cfg, dev = self.cfg, self.dev
        stacks = (lr_stack, hr_stack, u_lr, u_hr_red)
        n = lr_stack.shape[0]
        loss_hist = torch.zeros(cfg.epochs, n, device=dev)
        err_hist = torch.zeros(cfg.epochs, n, device=dev)
        out = torch.zeros(2, n, device=dev)        # the program's outputs
        graph = None
        try:
            for e in range(cfg.epochs):
                if self._eager or dev.type != "cuda":
                    self._epoch(stacks, out[0], out[1])
                else:
                    if graph is None:
                        graph = self.graph = EpochGraph(
                            f"the parity GSR-Net epoch ({n} subjects)", dev,
                            lambda: self._epoch(stacks, out[0], out[1]),
                            lambda: self._warm(stacks, min(_WARM_STEPS, n)))
                    graph.replay()
                loss_hist[e].copy_(out[0])
                err_hist[e].copy_(out[1])
        finally:
            if graph is not None:
                graph.release()
        if self.per_step:
            return loss_hist, err_hist
        return loss_hist.mean(1), err_hist.mean(1)

    def _stay_eager(self, eager: bool = True) -> None:
        """Run every later epoch from Python on the card too
        (``eager=False``: through a graph again): the yardstick the graph
        is held to, bit for bit."""
        self._eager = eager


def make_train_fn(model: GSRNet, optimizer: torch.optim.Optimizer,
                  cfg: GSRTrainConfig, per_step: bool = False):
    """The whole-run trainer ``train_fn(lr_stack, hr_stack, u_lr,
    u_hr_red)``: ``cfg.epochs`` passes over the subjects in their given
    order, one Adam step per subject — the reference's sequential update
    order — each pass one CUDA graph on the card. It updates ``model`` and
    ``optimizer`` in place and returns (loss_hist, err_hist) as tensors on
    the model's device: per-epoch means (epochs,), or with ``per_step``
    every step's values (epochs, n_subjects). On the card ``optimizer``
    must be capturable (``_check_capturable``, ``init_gsr``): else this
    raises a ``ValueError``."""
    return _ParityTrainer(model, optimizer, cfg, per_step)


def train_gsr_fold(model: GSRNet, optimizer: torch.optim.Optimizer,
                   cfg: GSRTrainConfig, lr_stack, hr_stack, spectral=None,
                   verbose: bool = False):
    """Train ``model`` in place on one fold's stacked arrays; returns the
    history dict {"loss", "error"} of per-epoch means (numpy)."""
    device = next(model.parameters()).device
    lr_np = np.asarray(lr_stack, dtype=np.float32)
    hr_np = np.asarray(hr_stack, dtype=np.float32)
    if spectral is None:
        spectral = precompute_spectral(lr_np, hr_np, lr_dim=cfg.lr_dim,
                                       padding=cfg.padding)
    stacks = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
              for a in (lr_np, hr_np, *spectral)]
    loss_hist, err_hist = make_train_fn(model, optimizer, cfg)(*stacks)
    history = {"loss": loss_hist.cpu().numpy(),
               "error": err_hist.cpu().numpy()}
    if verbose:
        for e in range(cfg.epochs):
            print(f"Epoch: {e + 1}, Loss: {history['loss'][e]:.6f}, "
                  f"Error (MAE): {history['error'][e]:.6f}")
    return history


def predict_gsr(params, model, cfg: GSRTrainConfig, lr_stack) -> torch.Tensor:
    """Batched inference over a stack of LR connectomes -> (B, hr, hr)
    predictions on the model's device.

    ``params`` is a ``state_dict`` mapping (tensors or arrays) loaded into
    ``model`` first, or None to use the model as it is. The eigenvectors
    come from host LAPACK on the host-normalized stack (the signs both
    packages consume); on the device the staged LR stack is normalized by
    the ``normalize_adj_batch`` kernel and handed to the model."""
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    device = next(model.parameters()).device
    lr_np = np.ascontiguousarray(lr_stack, dtype=np.float32)
    _, u_lr = np.linalg.eigh(normalize_adj_np(lr_np))
    lr_dev = torch.from_numpy(lr_np).to(device)
    u_dev = torch.from_numpy(u_lr.astype(np.float32)).to(device)
    with torch.no_grad():
        pred = model(lr_dev, u_lr=u_dev,
                     a_norm=normalize_adj_batch(lr_dev))[0]
    return unpad(pred, cfg.padding)


def evaluate_gsr(params, model, cfg: GSRTrainConfig, lr_stack, hr_stack,
                 verbose: bool = False):
    """Validation pass mirroring the reference's ``test``: skip subjects
    whose LR or HR matrix is all zero, set the HR diagonal to 1 before
    comparing, report the mean of the per-sample MAE. Returns (mean_mae,
    preds, gts) with numpy stacks over the kept subjects."""
    lr_np = np.asarray(lr_stack)
    hr_np = np.asarray(hr_stack)
    keep = [i for i in range(len(lr_np))
            if lr_np[i].any() and hr_np[i].any()]
    lr_np, hr_np = lr_np[keep], hr_np[keep]

    preds = predict_gsr(params, model, cfg, lr_np).cpu().numpy()
    hr_eval = hr_np.copy()
    for m in hr_eval:
        np.fill_diagonal(m, 1.0)
    per_sample = np.abs(preds - hr_eval).mean(axis=(1, 2))
    if verbose:
        for e in per_sample:
            print(f"MAE: {e}")
        print(f"Test error MAE: {per_sample.mean()}")
    return float(per_sample.mean()), preds, hr_eval
