"""MLP super-resolution baselines (torch). Counterpart of
``fcsr_tpu/models/mlp.py``.

* ``SuperResMLP`` (v1): flatten(n_in^2) -> [Linear, ``TorchBatchNorm``,
  dropout, ReLU] x n_layers -> Linear(n_out^2) -> (B, n_out, n_out), not
  symmetrised.
* ``SpectralResMLP`` (v2): the row-major triangle gather (L_in) ->
  ``SNDense``, ``TorchBatchNorm``, dropout, LeakyReLU(0.01) -> n residual
  blocks, each ending in ``leaky(y + residual)`` -> ``SNDense``(L_out) and a
  sigmoid. ``output="vector"`` returns the (B, L_out) vector (the trainer's
  form); ``output="matrix"`` scatters it row-major into the upper triangle
  and mirrors it through ``ops.anti_vectorize_normalize(normalize=False)``:
  the ``triu.cu`` kernel on the card, its plain version on the CPU.

The math lives in functions over a leading fold axis F (``fold_forward``),
written as the JAX package's, term by term. They read the leaves of a flat
parameter buffer (F, P) and a flat statistics buffer (F, S) by their flax
names (``MLPLayout``; a Dense kernel is (in, out)): the fold-parallel
trainer (``train/generic_loop.py``) runs them on its buffers, and each
``nn.Module`` runs them at F = 1 on its own tensors, which carry the
reference's torch names (``iox/weights.py``). Random draws (inits and
dropout masks) come from explicit ``torch.Generator``s.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fcsr_tpu_torch.core.vectorize import triu_indices_rowmajor
from fcsr_tpu_torch.iox.weights import (mlp_entries, mlp_leaves_to_state,
                                        mlp_state_to_leaves)
from fcsr_tpu_torch.kernels import ops
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["FlatSpec", "MLPLayout", "TorchBatchNorm", "SNDense",
           "SuperResMLP", "SpectralResMLP", "batch_norm_fold",
           "sn_dense_fold", "dropout_fold", "sharded_batch"]

BN_MOMENTUM = 0.9   # flax's sense: running <- 0.9 running + 0.1 batch
BN_EPS = 1e-5
SN_EPS = 1e-12
LEAKY_SLOPE = 0.01

# The data-parallel shard this thread computes (``sharded_batch``), or
# None: BatchNorm then normalises by the whole batch's moments and dropout
# takes its slice of the whole batch's draw, so a sharded step equals the
# single-device one
_BATCH_SHARD = threading.local()


@contextlib.contextmanager
def sharded_batch(shard):
    """Run this thread's ``fold_forward`` calls as one shard of a batch
    split over devices. ``shard.moments(x)`` returns (n, mean, mean of
    squares) over the whole batch for this shard's x (F, b, H), and
    ``shard.uniform(x)`` this shard's slice of a whole-batch uniform draw
    of x's shape (``parallel/mesh.py::make_sharded_generic_step``)."""
    _BATCH_SHARD.ctx = shard
    try:
        yield
    finally:
        _BATCH_SHARD.ctx = None


class FlatSpec:
    """Named leaves laid end to end in a flat (F, size) float32 buffer."""

    def __init__(self, leaves: Sequence[Tuple[str, Tuple[int, ...]]]):
        self.shapes = {name: tuple(shape) for name, shape in leaves}
        self.offsets = {}
        size = 0
        for name, shape in leaves:
            self.offsets[name] = size
            size += math.prod(shape)
        self.size = size

    def views(self, buf):
        """(F, size) tensor or array -> {leaf: (F, *shape) view}."""
        F = buf.shape[0]
        return {name: buf[:, o:o + math.prod(shape)].reshape(F, *shape)
                for (name, shape), o in zip(self.shapes.items(),
                                            self.offsets.values())}


class MLPLayout(NamedTuple):
    params: FlatSpec
    stats: FlatSpec


# ---------------------------------------------------------------------------
# the layers, over a leading fold axis
# ---------------------------------------------------------------------------

def _matvec(k, x):
    """(F, a, b) @ (F, b) -> (F, a), as products summed over b: a batched
    matrix-vector product's summation order depends on F on the CPU, and
    a fold's result must not."""
    return (k * x[:, None, :]).sum(-1)


def _l2n(w, eps):
    return w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True),
                           min=eps)


def sn_dense_fold(x, kernel, bias, u, v, update: bool, eps: float = SN_EPS):
    """Dense layer under torch's legacy ``spectral_norm`` with one power
    iteration. x (F, B, in), kernel (F, in, out), bias (F, out), u (F, out),
    v (F, in). Training (``update``): ``v = l2n(K u)``, ``u = l2n(K^T v)``
    without gradient; otherwise the stored pair. ``sigma = u . (K^T v)``
    with gradient through K; returns (x @ (K / sigma) + bias, u, v)."""
    if update:
        with torch.no_grad():
            v = _l2n(_matvec(kernel, u), eps)
            u = _l2n(_matvec(kernel.transpose(-1, -2), v), eps)
    sigma = (u * _matvec(kernel.transpose(-1, -2), v)).sum(-1)
    return (torch.matmul(x, kernel / sigma[:, None, None])
            + bias[:, None, :]), u, v


def batch_norm_fold(x, scale, bias, mean_r, var_r, train: bool,
                    momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
    """The JAX package's ``TorchBatchNorm`` over x (F, B, H): in training
    the batch's mean and ``mean(x^2) - mean^2`` normalise, and the running
    statistics take ``momentum`` of themselves plus the rest of the batch
    mean and of the unbiased variance ``var * n / max(n - 1, 1)``; in
    evaluation the running statistics normalise. On a data-parallel shard
    (``sharded_batch``) the moments and n are the whole batch's. Returns
    (y, mean', var')."""
    if train:
        shard = getattr(_BATCH_SHARD, "ctx", None)
        if shard is None:
            n = x.shape[1]
            mean = torch.mean(x, dim=1)
            meansq = torch.mean(torch.square(x), dim=1)
        else:
            n, mean, meansq = shard.moments(x)
        var = meansq - torch.square(mean)
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            mean_r = momentum * mean_r + (1 - momentum) * mean
            var_r = momentum * var_r + (1 - momentum) * unbiased
    else:
        mean, var = mean_r, var_r
    inv = torch.rsqrt(var + eps)
    y = (x - mean[:, None]) * inv[:, None] * scale[:, None] + bias[:, None]
    return y, mean_r, var_r


def dropout_fold(x, rate: float, train: bool, generator=None):
    """flax's ``nn.Dropout``: keep where ``u < 1 - rate`` and scale the kept
    entries by ``1 / (1 - rate)``; the identity out of training or at rate
    0. The uniforms come from ``generator`` (the device's default when
    None), or on a data-parallel shard from its slice of the whole
    batch's draw."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shard = getattr(_BATCH_SHARD, "ctx", None)
    u = (torch.rand(x.shape, generator=generator, device=x.device)
         if shard is None else shard.uniform(x))
    mask = u < keep
    return torch.where(mask, x / keep, 0.0)


def _leaky(x):
    return torch.nn.functional.leaky_relu(x, LEAKY_SLOPE)


# ---------------------------------------------------------------------------
# initialisation of flat buffers
# ---------------------------------------------------------------------------

def _init_leaf(view, kind, arg, gen):
    if kind == "uniform":
        view.uniform_(-arg, arg, generator=gen)
    elif kind == "unit_normal":
        view.normal_(generator=gen)
        view.div_(torch.linalg.vector_norm(view))
    else:
        view.fill_(arg)


def _init_flat(model, seeds: Sequence[int], device):
    """(p (F, P), s (F, S)) for the F folds, fold j drawn from a generator
    on ``device`` seeded with ``seeds[j]``, leaf after leaf in layout
    order (parameters, then statistics). ``device="meta"`` allocates
    nothing."""
    dev = torch.device(device)
    layout = model.layout
    F = len(seeds)
    p = torch.empty(F, layout.params.size, dtype=torch.float32, device=dev)
    s = torch.empty(F, layout.stats.size, dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return p, s
    inits = model.leaf_inits()
    with torch.no_grad():
        for j, seed in enumerate(seeds):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            for spec, buf in ((layout.params, p), (layout.stats, s)):
                for name, view in spec.views(buf[j:j + 1]).items():
                    _init_leaf(view[0], *inits[name], gen)
    return p, s


class _Leaves(nn.Module):
    """Holds one layer's tensors under their torch names (the layer's math
    is the model's ``fold_forward``)."""


class _FoldModel(nn.Module):
    """What both MLPs share: the flat layout, the seeded init, and the
    module forward (``fold_forward`` at F = 1 on the module's own tensors,
    which updates its statistics in training)."""

    variant: str
    n_layers: int

    def _build(self, device, seed):
        """Register the parameters and buffers (from ``_init_flat`` with
        ``seed``) under their torch names."""
        dev = resolve_device(device)
        p, s = _init_flat(self, [seed], dev)
        layout = self.layout
        state = mlp_leaves_to_state(
            {k: v[0] for k, v in layout.params.views(p).items()},
            {k: v[0] for k, v in layout.stats.views(s).items()})
        params, stats = mlp_entries(self.variant, self.n_layers)
        for _, tname, _ in params:
            mod, leaf = self._owner(tname)
            mod.register_parameter(leaf, nn.Parameter(
                state[tname].contiguous()))
        for _, tname in stats:
            mod, leaf = self._owner(tname)
            mod.register_buffer(leaf, state[tname].contiguous())
        self.generator = (torch.Generator(device=dev).manual_seed(seed)
                          if dev.type != "meta" else None)

    def _owner(self, tname: str):
        path, leaf = tname.rsplit(".", 1)
        return self.get_submodule(path), leaf

    @property
    def layout(self) -> MLPLayout:
        params, stats = mlp_entries(self.variant, self.n_layers)
        shapes = self.leaf_shapes()
        return MLPLayout(FlatSpec([(k, shapes[k]) for k, _, _ in params]),
                         FlatSpec([(k, shapes[k]) for k, _ in stats]))

    def init_flat(self, seeds: Sequence[int], device=DEFAULT_DEVICE):
        """Fresh (p (F, P), s (F, S)) buffers, fold j from seed
        ``seeds[j]``: what the module itself holds when built with that
        seed on that device."""
        return _init_flat(self, seeds, resolve_device(device))

    def _forward_state(self, state, x, train: bool, generator=None):
        """``fold_forward`` at F = 1 on a state_dict mapping: (prediction,
        new statistics, the mapping's statistics tensors by leaf)."""
        p_leaves, s_leaves = mlp_state_to_leaves(state)
        pred, new = self.fold_forward(
            {k: v[None] for k, v in p_leaves.items()},
            {k: v[None] for k, v in s_leaves.items()}, x[None], train,
            generator)
        return pred[0], new, s_leaves

    @torch.no_grad()
    def predict(self, variables, x):
        """Evaluation-mode forward of the weights ``variables`` (a
        state_dict mapping of tensors on x's device, as the trainers
        return) on x (B, ...); the module's own tensors are not read."""
        return self._forward_state(variables, x, False)[0]

    def set_generator(self, generator) -> None:
        """The generator the module's dropout draws from."""
        self.generator = generator

    def forward(self, x):
        pred, new, stats = self._forward_state(
            dict(self.named_parameters()) | dict(self.named_buffers()), x,
            self.training, self.generator)
        if self.training:
            with torch.no_grad():
                for k, v in new.items():
                    stats[k].copy_(v[0])
        return pred


class TorchBatchNorm(nn.Module):
    """BatchNorm with the JAX package's formula (``batch_norm_fold``), not
    ``nn.BatchNorm1d``'s: parameters ``weight`` / ``bias``, buffers
    ``running_mean`` / ``running_var``. Input (..., features); leading axes
    are the batch."""

    def __init__(self, features: int, momentum: float = BN_MOMENTUM,
                 epsilon: float = BN_EPS, device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("running_mean", torch.zeros(features, device=dev))
        self.register_buffer("running_var", torch.ones(features, device=dev))

    def forward(self, x):
        feat = x.shape[-1]
        y, mean, var = batch_norm_fold(
            x.reshape(1, -1, feat), self.weight[None], self.bias[None],
            self.running_mean[None], self.running_var[None], self.training,
            self.momentum, self.epsilon)
        if self.training:
            with torch.no_grad():
                self.running_mean.copy_(mean[0])
                self.running_var.copy_(var[0])
        return y.reshape(x.shape)


class SNDense(nn.Module):
    """Linear under torch's legacy ``spectral_norm`` (``sn_dense_fold``):
    ``weight_orig`` (out, in) with a xavier-uniform init, ``bias`` zeros,
    buffers ``weight_u`` (out,) and ``weight_v`` (in,) drawn as unit
    normals from a generator seeded with ``seed``. Training runs one power
    iteration and stores (u, v); evaluation takes sigma from the stored
    pair."""

    def __init__(self, in_features: int, features: int, eps: float = SN_EPS,
                 device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        gen = torch.Generator(device=dev).manual_seed(seed)
        bound = math.sqrt(6.0 / (in_features + features))
        self.weight_orig = nn.Parameter(torch.empty(
            features, in_features, device=dev).uniform_(-bound, bound,
                                                        generator=gen))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        for name, n in (("weight_u", features), ("weight_v", in_features)):
            w = torch.empty(n, device=dev).normal_(generator=gen)
            self.register_buffer(name, w / torch.linalg.vector_norm(w))

    def forward(self, x):
        y, u, v = sn_dense_fold(
            x.reshape(1, -1, x.shape[-1]), self.weight_orig.T[None],
            self.bias[None], self.weight_u[None], self.weight_v[None],
            self.training, self.eps)
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u[0])
                self.weight_v.copy_(v[0])
        return y.reshape(*x.shape[:-1], y.shape[-1])


class SuperResMLP(_FoldModel):
    """v1, the dense-matrix MLP: ``Dense_{i}`` (torch-Linear init, uniform
    +-1/sqrt(fan_in) for weight and bias) and ``TorchBatchNorm_{i}`` for i
    < n_layers, then ``Dense_{n_layers}`` to ``output_size``; the output is
    reshaped to (B, h, h), h = sqrt(output_size). ``device="meta"`` builds
    the configuration without weights."""

    variant = "v1"

    def __init__(self, input_size: int, output_size: int, hidden_dim: int,
                 n_layers: int = 1, dropout: float = 0.1,
                 device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.hidden_dim, self.n_layers, self.dropout = (hidden_dim, n_layers,
                                                        dropout)
        self.widths = [input_size] + [hidden_dim] * n_layers
        for i in range(n_layers + 1):
            setattr(self, f"Dense_{i}", _Leaves())
            if i < n_layers:
                setattr(self, f"TorchBatchNorm_{i}", _Leaves())
        self._build(device, seed)

    def leaf_shapes(self) -> Dict[str, Tuple[int, ...]]:
        out = {}
        for i, w in enumerate(self.widths):
            o = self.hidden_dim if i < self.n_layers else self.output_size
            out.update({f"Dense_{i}.kernel": (w, o), f"Dense_{i}.bias": (o,)})
            if i < self.n_layers:
                out.update({f"TorchBatchNorm_{i}.{k}": (o,)
                            for k in ("scale", "bias", "mean", "var")})
        return out

    def leaf_inits(self):
        out = {}
        for i, w in enumerate(self.widths):
            bound = 1.0 / math.sqrt(w)
            out[f"Dense_{i}.kernel"] = out[f"Dense_{i}.bias"] = (
                "uniform", bound)
            if i < self.n_layers:
                out.update({f"TorchBatchNorm_{i}.scale": ("fill", 1.0),
                            f"TorchBatchNorm_{i}.bias": ("fill", 0.0),
                            f"TorchBatchNorm_{i}.mean": ("fill", 0.0),
                            f"TorchBatchNorm_{i}.var": ("fill", 1.0)})
        return out

    def fold_forward(self, P, S, x, train: bool, generator=None):
        """P / S: {leaf: (F, ...)}; x (F, B, n, n) or (F, B, n^2) ->
        ((F, B, h, h), new statistics)."""
        F, B = x.shape[:2]
        h = x.reshape(F, B, -1)
        new = {}
        for i in range(self.n_layers):
            h = torch.matmul(h, P[f"Dense_{i}.kernel"]) \
                + P[f"Dense_{i}.bias"][:, None, :]
            bn = f"TorchBatchNorm_{i}"
            h, new[f"{bn}.mean"], new[f"{bn}.var"] = batch_norm_fold(
                h, P[f"{bn}.scale"], P[f"{bn}.bias"], S[f"{bn}.mean"],
                S[f"{bn}.var"], train)
            h = torch.relu(dropout_fold(h, self.dropout, train, generator))
        last = f"Dense_{self.n_layers}"
        h = torch.matmul(h, P[f"{last}.kernel"]) \
            + P[f"{last}.bias"][:, None, :]
        side = math.isqrt(self.output_size)
        return h.reshape(F, B, side, side), (new if train else dict(S))


class SpectralResMLP(_FoldModel):
    """v2, the spectral-norm residual MLP on row-major triangle vectors:
    modules ``input_layer`` (1: ``SNDense``, 2: ``TorchBatchNorm``),
    ``residual_blocks.{i}`` (0, 1) and ``output_layer`` (0), as the
    reference notebook names them. Input: dense (B, n_in, n_in) or
    vectorized (B, L_in) rows. ``device="meta"`` builds the configuration
    without weights."""

    variant = "v2"

    def __init__(self, num_nodes_input: int = 160,
                 num_nodes_output: int = 268,
                 num_hidden: int = (160 + 268) // 2, n_layers: int = 0,
                 dropout: float = 0.1, output: str = "matrix",
                 device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        if output not in ("matrix", "vector"):
            raise ValueError(f"unknown output: {output!r}")
        self.num_nodes_input, self.num_nodes_output = (num_nodes_input,
                                                       num_nodes_output)
        self.num_hidden, self.n_layers, self.dropout = (num_hidden, n_layers,
                                                        dropout)
        self.output = output
        self.l_in = num_nodes_input * (num_nodes_input - 1) // 2
        self.l_out = num_nodes_output * (num_nodes_output - 1) // 2
        # the reference's module nesting (its Flatten at input_layer.0 holds
        # no tensor)
        self.input_layer = nn.Sequential(nn.Identity(), _Leaves(), _Leaves())
        self.residual_blocks = nn.ModuleList(
            nn.Sequential(_Leaves(), _Leaves()) for _ in range(n_layers))
        self.output_layer = nn.Sequential(_Leaves())
        self._index = {}
        self._build(device, seed)

    def _denses(self):
        h = self.num_hidden
        return ([("input_dense", self.l_in, h)]
                + [(f"res_dense_{i}", h, h) for i in range(self.n_layers)]
                + [("output_dense", h, self.l_out)])

    def leaf_shapes(self) -> Dict[str, Tuple[int, ...]]:
        out = {}
        for name, i, o in self._denses():
            out.update({f"{name}.kernel": (i, o), f"{name}.bias": (o,),
                        f"{name}.u": (o,), f"{name}.v": (i,)})
        for name in ["input_bn"] + [f"res_bn_{i}"
                                    for i in range(self.n_layers)]:
            out.update({f"{name}.{k}": (self.num_hidden,)
                        for k in ("scale", "bias", "mean", "var")})
        return out

    def leaf_inits(self):
        out = {}
        for name, i, o in self._denses():
            bound = math.sqrt(6.0 / (i + o))       # xavier uniform
            out.update({f"{name}.kernel": ("uniform", bound),
                        f"{name}.bias": ("fill", 0.0),
                        f"{name}.u": ("unit_normal", None),
                        f"{name}.v": ("unit_normal", None)})
        for name in ["input_bn"] + [f"res_bn_{i}"
                                    for i in range(self.n_layers)]:
            out.update({f"{name}.scale": ("fill", 1.0),
                        f"{name}.bias": ("fill", 0.0),
                        f"{name}.mean": ("fill", 0.0),
                        f"{name}.var": ("fill", 1.0)})
        return out

    def gather_input(self, x):
        """(F, B, n, n) dense -> (F, B, L_in) row-major triangle vectors;
        (F, B, L_in) vectors pass through."""
        if x.dim() == 3:
            return x
        if x.device not in self._index:
            r, c = triu_indices_rowmajor(self.num_nodes_input)
            self._index[x.device] = tuple(
                torch.from_numpy(a.astype(np.int64)).to(x.device)
                for a in (r, c))
        r, c = self._index[x.device]
        return x[..., r, c]

    def _block(self, P, S, new, dense, bn, h, train, generator):
        y, new[f"{dense}.u"], new[f"{dense}.v"] = sn_dense_fold(
            h, P[f"{dense}.kernel"], P[f"{dense}.bias"], S[f"{dense}.u"],
            S[f"{dense}.v"], train)
        y, new[f"{bn}.mean"], new[f"{bn}.var"] = batch_norm_fold(
            y, P[f"{bn}.scale"], P[f"{bn}.bias"], S[f"{bn}.mean"],
            S[f"{bn}.var"], train)
        return _leaky(dropout_fold(y, self.dropout, train, generator))

    def fold_forward(self, P, S, x, train: bool, generator=None,
                     output: Optional[str] = None):
        """P / S: {leaf: (F, ...)}; x (F, B, n, n) or (F, B, L_in) ->
        (prediction, new statistics): (F, B, L_out) vectors, or with
        ``output`` (default: the module's) "matrix" (F, B, n_out, n_out)
        symmetric matrices with a zero diagonal."""
        new = {}
        h = self._block(P, S, new, "input_dense", "input_bn",
                        self.gather_input(x), train, generator)
        for i in range(self.n_layers):
            y = self._block(P, S, new, f"res_dense_{i}", f"res_bn_{i}", h,
                            train, generator)
            h = _leaky(y + h)
        v, new["output_dense.u"], new["output_dense.v"] = sn_dense_fold(
            h, P["output_dense.kernel"], P["output_dense.bias"],
            S["output_dense.u"], S["output_dense.v"], train)
        v = torch.sigmoid(v)
        stats = new if train else dict(S)
        if (output or self.output) == "vector":
            return v, stats
        F, B, L = v.shape
        n = self.num_nodes_output
        mats = ops.anti_vectorize_normalize(v.reshape(F * B, L), n,
                                            normalize=False)
        return mats.reshape(F, B, n, n), stats
