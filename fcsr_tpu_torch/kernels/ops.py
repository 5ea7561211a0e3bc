"""Python wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

A wrapper takes its plain version only when the tensors it is given lie
on the CPU; for CUDA tensors it launches its kernel (on the current stream,
which must be the operands' device's) or raises — there is no fallback.
Each kernel counts its launches (``launch_counts``), so a run can show
that it went through the kernels.

The GSR step's products follow ``core.mm_mode.MODE`` (``mode_ops``): IEEE
fp32 (``bgemm_f32``) in the compensated modes, single-pass bf16 products
(``bgemm_bf16``, with the ``*_bf16`` instances of the pool, row and bias
kernels, which round what the JAX package's one-hot products round) under
``FCSR_MM_MODE=bf16``.

All tensors are float32 (int32 for indices). The training-step kernels
carry a leading fold axis F; shapes use n for a node count entering a
pooling level, k for the nodes it keeps, m for the feature width. The
data-path kernels (``triu.cu``) carry a leading subject axis B over n x n
adjacencies and their strict-upper-triangle vectors.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from fcsr_tpu_torch.kernels.build import load_library

__all__ = ["KERNELS", "KERNEL_OPS", "PLAIN_OPS", "KERNEL_OPS_BF16",
           "PLAIN_OPS_BF16", "mode_ops", "launch_counts",
           "bgemm_path", "bgemm_forced", "bgemm_tiles", "bgemm_bf16_path",
           "bgemm_bf16_forced", "bgemm_bf16_tiles", "plan_folds",
           "reset_launch_counts", "rows_contiguous", "philox_words",
           "bits_to_keep", "gat_attention_math"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


# set by ``utils/debug.py::eager_debug``: every launch is followed by a
# synchronize, so an asynchronous CUDA error raises at the launch that
# caused it
SYNC_EACH_LAUNCH = False


# The fold count the launches of this context are planned for (0: each
# launch's own): set by ``plan_folds``
_PLAN_FOLDS = contextvars.ContextVar("plan_folds", default=0)


@contextlib.contextmanager
def plan_folds(n: int):
    """Plan every launch inside as for ``n`` folds where the plan sets a
    fold's summation order (the product's tile and split-K, the attention
    kernels' bands and clusters, the off-diagonal losses' cluster): a
    shard of a fold-sharded run then gives each fold the bits of the
    unsharded run over ``n`` folds. The launch itself covers the
    operands' folds."""
    token = _PLAN_FOLDS.set(int(n))
    try:
        yield
    finally:
        _PLAN_FOLDS.reset(token)


def _check_after_launch(name: str) -> None:
    try:
        torch.cuda.synchronize()
    except RuntimeError as e:
        raise RuntimeError(f"CUDA kernel {name} failed after its launch: "
                           f"{e}") from e


class Kernel:
    """One CUDA entry point: its library, C signature and launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on the current stream; ``device`` is where the wrapper's
        operands lie, which must be the current device (``on_device``)."""
        if self._fn is None:
            lib = load_library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = list(self.argtypes) + [_P]
            fn.restype = _I
            self._fn = fn
            self._err = lib.fcsr_error_string
        stream = torch.cuda.current_stream()
        if stream.device != device:
            raise RuntimeError(
                f"CUDA kernel {self.name}: operands on {device}, current "
                f"device {stream.device}; launch under "
                "torch.cuda.device(<the operands' device>)")
        err = self._fn(*args, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"{self._err(err).decode()}")
        self.launches += 1
        if SYNC_EACH_LAUNCH:
            _check_after_launch(self.name)


# the TPU kernel these replace: train_step_fused's pallas_call
_STEP = "fcsr_tpu/models/fused_step.py:925"
# the three data-path TPU kernels, by their pallas_call lines
_TRIU = "fcsr_tpu/core/pallas_kernels.py"
# gat_train_step_fused's pallas_call (gat_val_fused's is :547)
_GAT_STEP = "fcsr_tpu/models/fused_gat.py:497"
KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("bgemm_f32", "bgemm", "fcsr_bgemm_f32",
           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _LL, _I, _LL, _I, _LL, _LL, _I, _LL, _I, _I], _STEP),
    Kernel("bgemm_bf16", "bgemm_bf16", "fcsr_bgemm_bf16",
           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _LL, _I, _LL, _I, _LL, _LL, _I, _LL, _I, _I, _I], _STEP),
    Kernel("rank_select", "rank_select", "fcsr_rank_select",
           [_P] * 8 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _I], _STEP),
    Kernel("gather_rows", "rank_select", "fcsr_gather_rows",
           [_P] * 5 + [_I] * 8, _STEP),
    Kernel("scatter_rows", "rank_select", "fcsr_scatter_rows",
           [_P] * 5 + [_I] * 9, _STEP),
    Kernel("pool_logits_bwd", "rank_select", "fcsr_pool_logits_bwd",
           [_P] * 5 + [_I] * 4 + [_F] + [_I] * 5, _STEP),
    Kernel("pool_bwd_pair", "rank_select", "fcsr_pool_bwd_pair",
           [_P] * 8 + [_I] * 4 + [_F] + [_I] * 5, _STEP),
    Kernel("add_bias", "rank_select", "fcsr_add_bias",
           [_P, _LL, _P, _LL, _P, _I, _I, _I], _STEP),
    # FCSR_MM_MODE=bf16: the same kernels rounding what the JAX package's
    # one-hot products round (rank_select.cu's RND instances)
    Kernel("rank_select_bf16", "rank_select", "fcsr_rank_select_bf16",
           [_P] * 8 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _I], _STEP),
    Kernel("gather_rows_bf16", "rank_select", "fcsr_gather_rows_bf16",
           [_P] * 5 + [_I] * 8, _STEP),
    Kernel("scatter_rows_bf16", "rank_select", "fcsr_scatter_rows_bf16",
           [_P] * 5 + [_I] * 9, _STEP),
    Kernel("pool_bwd_pair_bf16", "rank_select", "fcsr_pool_bwd_pair_bf16",
           [_P] * 8 + [_I] * 4 + [_F] + [_I] * 5, _STEP),
    Kernel("add_bias_bf16", "rank_select", "fcsr_add_bias_bf16",
           [_P, _LL, _P, _LL, _P, _I, _I, _I], _STEP),
    # the pair as the JAX package's autodiff of its bf16 forward rounds it
    # (unet_fused and step_value_and_grad_fused in the bf16 mode: the
    # jax.vjp inside unet_fused's backward kernel, and :970's)
    Kernel("pool_bwd_pair_bf16_ad", "rank_select",
           "fcsr_pool_bwd_pair_bf16_ad",
           [_P] * 8 + [_I] * 4 + [_F] + [_I] * 5,
           "fcsr_tpu/models/fused_step.py:178"),
    Kernel("tail_normalize", "tail", "fcsr_tail_normalize",
           [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I], _STEP),
    Kernel("tail_normalize_bwd", "tail", "fcsr_tail_normalize_bwd",
           [_P, _P, _P, _P, _I, _I], _STEP),
    Kernel("sym_abs_fill", "tail", "fcsr_sym_abs_fill",
           [_P, _P, _I, _I, _I], _STEP),
    Kernel("sym_sign_grad", "tail", "fcsr_sym_sign_grad",
           [_P, _P, _F, _P, _I, _I, _I], _STEP),
    Kernel("l1_term", "tail", "fcsr_l1_term",
           [_P, _LL, _P, _LL, _I, _F, _F, _I, _P, _I, _P, _P, _P, _P, _I,
            _I, _I, _I, _I], _STEP),
    Kernel("adam_masked", "adam", "fcsr_adam_masked",
           [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL,
            _F, _F, _F, _F, _F, _F], _STEP),
    Kernel("anti_vectorize_normalize", "triu",
           "fcsr_anti_vectorize_normalize",
           [_P, _LL, _P, _I, _I, _F, _I, _I, _I, _I], _TRIU + ":113"),
    Kernel("vectorize_colmajor", "triu", "fcsr_vectorize_colmajor",
           [_P, _P, _I, _I], _TRIU + ":166"),
    Kernel("normalize_adj_batch", "triu", "fcsr_normalize_adj_batch",
           [_P, _P, _I, _I], _TRIU + ":191"),
    Kernel("gat_attention", "gat", "fcsr_gat_attention",
           [_P, _P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I,
            _I, _F, _F, _I, _I, _I, _I], _GAT_STEP),
    Kernel("gat_attention_bwd", "gat", "fcsr_gat_attention_bwd",
           [_P, _P, _P, _P, _P, _LL, _P, _LL, _P, _P, _P, _LL, _P, _LL,
            _P, _LL, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I],
           _GAT_STEP),
    Kernel("philox_keep_mask", "gat", "fcsr_philox_keep_mask",
           [_P, _P, _P, _I, _I, _LL, _I, _I, _I, _F, _F],
           "tools/experiments/gat_dropout_keeprate.py:32"),
    Kernel("gat_pool_adj", "gat", "fcsr_gat_pool_adj",
           [_P, _P, _P, _I, _I, _I, _F, _I, _I], _GAT_STEP),
    Kernel("philox_drop_logits", "gat", "fcsr_philox_drop_logits",
           [_P, _P, _LL, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F],
           _GAT_STEP),
    Kernel("philox_drop_outer", "gat", "fcsr_philox_drop_outer",
           [_P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F],
           _GAT_STEP),
    Kernel("col_softmax", "gat", "fcsr_col_softmax",
           [_P, _P, _I, _I, _I, _I, _I], _GAT_STEP),
    Kernel("col_softmax_bwd", "gat", "fcsr_col_softmax_bwd",
           [_P, _P, _P, _I, _I, _I, _I, _I], _GAT_STEP),
    Kernel("offdiag_mse", "gat", "fcsr_offdiag_mse",
           [_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I], _GAT_STEP),
    Kernel("offdiag_mae", "gat", "fcsr_offdiag_mae",
           [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I],
           "fcsr_tpu/models/fused_gat.py:547"),
    Kernel("adamw_masked", "gat", "fcsr_adamw_masked",
           [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _LL,
            _F, _F, _F, _F, _F, _F], _GAT_STEP),
)}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(device, *tensors, dtype=torch.float32):
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"tensor of {t.dtype}, expected {dtype}")


def _contig(*tensors):
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel operand must be contiguous")


def _rows_contig(t: torch.Tensor):
    """(F, r, c) with unit column stride and row stride c (any batch
    stride): a view into a flat (F, P) buffer qualifies."""
    if t.dim() != 3 or (t.shape[2] > 1 and t.stride(2) != 1) \
            or (t.shape[1] > 1 and t.stride(1) != t.shape[2]):
        raise ValueError("operand rows must be contiguous")


def _folds_contig(t: torch.Tensor) -> bool:
    """Each fold slice t[f] is contiguous (any batch stride), read from
    the strides without making a view."""
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def rows_contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the product kernel takes it — unit column stride and dense
    rows over the trailing two axes — copied only if it is not (a leaf view
    of a flat buffer passes through)."""
    if (t.shape[-1] == 1 or t.stride(-1) == 1) \
            and (t.shape[-2] == 1 or t.stride(-2) == t.shape[-1]):
        return t
    return t.contiguous()


def _asign(x):
    """Adjoint sign of |x| as the reference differentiates it (+1 at 0)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _eye_mask(m, device):
    return torch.eye(m, dtype=torch.bool, device=device)


def _take_rows(src, index):
    """src[f, index[f, r], :] for int32 ``index`` (F, r)."""
    return torch.take_along_dim(src, index.long()[..., None], dim=1)


# ---------------------------------------------------------------------------
# bgemm_f32
# ---------------------------------------------------------------------------

def bgemm_plain(a, b, ta=False, tb=False, bias=None, add=None, out=None,
                bias_operand=False):
    """op(a) @ op(b) [+ bias row] [+ add]; ``a=None`` is a row of ones
    (a column sum of op(b)). One product per fold: a batched product's
    summation order depends on the fold count on the CPU, and a fold's
    result must not (a fold-sharded run equals the unsharded one).
    ``bias_operand`` (the bias is a product's operand in the JAX package)
    changes nothing in fp32."""
    B = b.transpose(-1, -2) if tb else b
    if a is None:
        A = torch.ones(B.shape[0], 1, B.shape[1], dtype=B.dtype,
                       device=B.device)
    else:
        A = a.transpose(-1, -2) if ta else a
    c = torch.stack([torch.matmul(A[f], B[f]) for f in range(B.shape[0])])
    if bias is not None:
        c = c + bias.reshape(c.shape[0], 1, c.shape[2])
    if add is not None:
        c = c + add
    if out is None:
        return c
    out.copy_(c)
    return out


def bgemm(a, b, ta=False, tb=False, bias=None, add=None, out=None,
          bias_operand=False):
    """Batched fp32 product ``op(a) @ op(b) [+ bias] [+ add]`` over the
    leading fold axis. Operands are (F, rows, cols) with contiguous rows
    and any batch stride; ``a=None`` is a row of ones; ``bias`` is (F, 1, N)
    or (F, N); ``add`` may be ``out`` (accumulate). ``bias_operand`` marks
    a bias the JAX package adds as a product with a column of ones (the
    pool logits'): an fp32 product takes it as it is."""
    if not b.is_cuda:
        return bgemm_plain(a, b, ta, tb, bias, add, out)
    out, args = _bgemm_args(a, b, ta, tb, bias, add, out)
    KERNELS["bgemm_f32"](b.device, *args, _PLAN_FOLDS.get())
    return out


def colsum_f32_plain(g, out=None):
    return bgemm_plain(None, g, out=out)


def colsum_f32(g, out=None):
    """Column sums of ``g`` (F, M, N) in fp32 into (F, 1, N): the fp32
    product kernel's column-sum path (``bgemm(None, g)``) in every product
    mode, for the bias gradients the JAX package's autodiff sums
    unrounded."""
    return bgemm(None, g, out=out)


def _bf16(x):
    """``x`` rounded to bf16 (round to nearest even), as fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bgemm_bf16_plain(a, b, ta=False, tb=False, bias=None, add=None,
                     out=None, bias_operand=False):
    """``bgemm_plain`` over operands rounded to bf16 (and the bias too with
    ``bias_operand``): the exact products of bf16 values, summed in fp32
    (TF32 off), then bias and add in fp32."""
    if bias is not None and bias_operand:
        bias = _bf16(bias)
    return bgemm_plain(None if a is None else _bf16(a), _bf16(b), ta, tb,
                       bias, add, out)


def bgemm_bf16(a, b, ta=False, tb=False, bias=None, add=None, out=None,
               bias_operand=False):
    """``bgemm`` with single-pass bf16 products (FCSR_MM_MODE=bf16): each
    operand rounded to bf16, the products summed in fp32 on the tensor
    cores; bias and add in fp32, the bias rounded too where it is a
    product's operand in the JAX package (``bias_operand``). The operands
    are the fp32 tensors ``bgemm`` takes. The dense path's split-K (which
    sets a fold's summation order) is planned for the fold count of
    ``plan_folds`` where one is set, else for the operands' own, so a
    fold-sharded run keeps the unsharded run's bits."""
    if not b.is_cuda:
        return bgemm_bf16_plain(a, b, ta, tb, bias, add, out, bias_operand)
    out, args = _bgemm_args(a, b, ta, tb, bias, add, out)
    KERNELS["bgemm_bf16"](b.device, *args, _PLAN_FOLDS.get(),
                          int(bias_operand and bias is not None))
    return out


def _bgemm_args(a, b, ta, tb, bias, add, out):
    """(out, the C entry point's arguments without the stream), after the
    wrapper's checks; allocates ``out`` when it is None."""
    F = b.shape[0]
    K, N = (b.shape[2], b.shape[1]) if tb else (b.shape[1], b.shape[2])
    if a is None:
        M = 1
    else:
        M, Ka = (a.shape[2], a.shape[1]) if ta else (a.shape[1], a.shape[2])
        if Ka != K or a.shape[0] != F:
            raise ValueError(f"bgemm shape mismatch {tuple(a.shape)} "
                             f"{tuple(b.shape)} ta={ta} tb={tb}")
    if out is None:
        out = torch.empty(F, M, N, dtype=torch.float32, device=b.device)
    if bias is not None:
        bias = bias.reshape(F, 1, N) if bias.dim() == 2 else bias
    _check(b.device, a, b, bias, add, out)
    for t in (a, b, add, out):
        if t is not None:
            _rows_contig(t)
    if tuple(out.shape) != (F, M, N) or (add is not None
                                         and tuple(add.shape) != (F, M, N)):
        raise ValueError("bgemm output shape mismatch")
    if bias is not None and (bias.shape[-1] != N or bias.stride(2) != 1):
        raise ValueError("bgemm bias must be a contiguous row of length N")
    return out, (
        _ptr(a), _ptr(b), _ptr(bias), _ptr(add), _ptr(out),
        F, M, N, K, int(ta), int(tb),
        0 if a is None else a.stride(0), 0 if a is None else a.stride(1),
        b.stride(0), b.stride(1),
        0 if bias is None else bias.stride(0),
        0 if add is None else add.stride(0),
        0 if add is None else add.stride(1),
        out.stride(0), out.stride(1))


_BGEMM_CLASSES = {1: "vector, a warp per output along k",
                  2: "vector, lanes along the outputs, k over 8 warps",
                  3: "elementwise rank-1"}


# the product kernels' other C entry points (plan, tile table, a launch
# with the dense plan forced), all returning int: ``bgemm.cu``'s
# (``fcsr_bgemm_f32_*``) and ``bgemm_bf16.cu``'s (``fcsr_bgemm_bf16_*``)
BGEMM_EXTRA = {
    "fcsr_bgemm_f32_plan": [_P, _P] + [_I] * 6 + [_LL, _I, _LL, _I],
    "fcsr_bgemm_f32_tile": [_I],
    "fcsr_bgemm_f32_forced": [_I] + KERNELS["bgemm_f32"].argtypes[:-1]
    + [_P],
    "fcsr_bgemm_bf16_plan": [_P, _P] + [_I] * 6 + [_LL, _I, _LL, _I],
    "fcsr_bgemm_bf16_tile": [_I],
    "fcsr_bgemm_bf16_forced": [_I] + KERNELS["bgemm_bf16"].argtypes[:-2]
    + [_I, _P],
}


def _bgemm_lib(kernel="bgemm_f32"):
    """The library of ``kernel`` with its extra entry points declared."""
    lib = load_library(KERNELS[kernel].source)
    prefix = "fcsr_" + kernel + "_"
    for symbol, argtypes in BGEMM_EXTRA.items():
        if symbol.startswith(prefix):
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = _I
    return lib


def _path(kernel, a, b, ta, tb, bias, add, out):
    out, args = _bgemm_args(a, b, ta, tb, bias, add, out)
    lib = _bgemm_lib(kernel)
    folds = _PLAN_FOLDS.get() or args[5]
    code = getattr(lib, f"fcsr_{kernel}_plan")(*args[:2], folds, *args[6:13],
                                               *args[13:15])
    if code < 0:
        raise RuntimeError(f"{kernel}: no CUDA device for the plan")
    if code // 10000:
        return _BGEMM_CLASSES[code // 10000], code
    return None, code


def _copies(code):
    return (f"{16 if code // 1000 % 2 else 4}/"
            f"{16 if code // 2000 % 2 else 4}-byte copies")


def bgemm_path(a, b, ta=False, tb=False, bias=None, add=None, out=None):
    """The path the product kernel takes for these CUDA operands (nothing
    launches; the plan of ``plan_folds`` folds inside that context): its
    shape class, and for the dense path the tile, the split-K cluster size
    and the copy width of each operand."""
    cls, code = _path("bgemm_f32", a, b, ta, tb, bias, add, out)
    if cls:
        return cls
    bm, bn, tm, tn, kg = bgemm_tiles()[(code // 10) % 10]
    return (f"dense {bm}x{bn} ({tm}x{tn} per thread, {kg} warp groups over "
            f"k), split-K {code % 10}, {_copies(code)}")


def bgemm_bf16_path(a, b, ta=False, tb=False, bias=None, add=None,
                    out=None):
    """``bgemm_path`` of ``bgemm_bf16``."""
    cls, code = _path("bgemm_bf16", a, b, ta, tb, bias, add, out)
    if cls:
        return cls
    bm, bn, bk, stages = bgemm_bf16_tiles()[(code // 10) % 10]
    return (f"dense {bm}x{bn} (4 warps of mma.sync m16n8k16, {bk}-deep "
            f"slices in a {stages}-stage ring), split-K {code % 10}, "
            f"{_copies(code)}")


def _tiles(kernel, decode):
    lib, tiles = _bgemm_lib(kernel), []
    tile = getattr(lib, f"fcsr_{kernel}_tile")
    while tile(len(tiles)) >= 0:
        tiles.append(decode(tile(len(tiles))))
    return tiles


def bgemm_tiles():
    """The fp32 dense path's tiles as (bm, bn, tm, tn, kg), in table
    order."""
    return _tiles("bgemm_f32", lambda c: (c // 1000000, c // 1000 % 1000,
                                          c // 100 % 10, c // 10 % 10,
                                          c % 10))


def bgemm_bf16_tiles():
    """The bf16 dense path's variants as (bm, bn, slice depth, ring
    stages), in table order."""
    return _tiles("bgemm_bf16", lambda c: (c // 1000000, c // 10000 % 100,
                                           c // 100 % 100, c % 100))


def _forced(kernel, tile, split, a, b, ta, tb, bias, add, out, *extra):
    out, args = _bgemm_args(a, b, ta, tb, bias, add, out)
    stream = torch.cuda.current_stream()
    if stream.device != b.device:
        raise RuntimeError(f"{kernel} forced: operands on {b.device}, "
                           f"current device {stream.device}")
    err = getattr(_bgemm_lib(kernel), f"fcsr_{kernel}_forced")(
        tile * 10 + split, *args, *extra, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} (tile {tile}, split {split}) failed "
                           f"to launch: error {err}")
    return out


def bgemm_forced(tile, split, a, b, ta=False, tb=False, bias=None,
                 add=None, out=None):
    """``bgemm`` on the card with the dense path's tile (an index into the
    kernel's tile table) and split-K cluster size forced, for measuring
    every plan against the one the kernel picks. Counts no launch; shapes
    that take another path launch as usual."""
    return _forced("bgemm_f32", tile, split, a, b, ta, tb, bias, add, out)


def bgemm_bf16_forced(tile, split, a, b, ta=False, tb=False, bias=None,
                      add=None, out=None, bias_operand=False):
    """``bgemm_forced`` of ``bgemm_bf16`` (tiles: ``bgemm_bf16_tiles``)."""
    return _forced("bgemm_bf16", tile, split, a, b, ta, tb, bias, add, out,
                   int(bias_operand and bias is not None))


# ---------------------------------------------------------------------------
# rank_select and the row helpers of pooling / unpooling
# ---------------------------------------------------------------------------

SEL_MAX_N = 1024       # rank_select's most scores per fold
SEL_THREADS = 512      # its threads per block
SEL_MIN_ROWS = 4       # the fewest kept rows a band is planned with ...
SEL_MAX_ROWS = 64      # ... and the most (4 per warp of the pool)
# the most lanes a node's compares are split over: each doubling halves
# a lane's compare chain but adds a shuffle step to every pass
SEL_MAX_LANES = 4


class SelectPlan(NamedTuple):
    """rank_select's launch: ``bands`` blocks per fold of ``threads``
    threads, each ranking all n scores (a node's compares split over
    ``lanes`` lanes) and gathering ``rows`` kept rows; 16-byte row
    accesses when ``vec``; ``smem`` bytes of shared memory per block."""
    bands: int
    rows: int
    threads: int
    lanes: int
    vec: bool
    smem: int


class GatherPlan(NamedTuple):
    """gather_rows' launch: ``bands`` blocks per fold of ``threads``
    threads, a warp per row of the band's ``rows``; 16-byte accesses when
    ``vec``."""
    bands: int
    rows: int
    threads: int
    vec: bool


class RowPlan(NamedTuple):
    """The launch of the row kernels (``scatter_rows``,
    ``pool_logits_bwd``, ``pool_bwd_pair``): ``bands`` blocks per fold of
    ``threads`` threads, each taking ``rows`` output rows, a group of
    ``lanes`` lanes per row; 16-byte accesses when ``vec``."""
    bands: int
    rows: int
    threads: int
    lanes: int
    vec: bool


ROW_MAX_THREADS = 256  # the row kernels' most threads per block ...
ROW_MAX_LANES = 128    # ... and lanes per row (4 warps)


def _row_bands(F: int, k: int):
    """(bands, rows) of k rows per fold: about one wave of blocks over the
    card's SMS (``SMS // F`` bands per fold), within ``SEL_MIN_ROWS`` and
    ``SEL_MAX_ROWS`` rows each."""
    rows = -(-k // max(1, SMS // max(1, F)))
    rows = min(k, SEL_MAX_ROWS, max(SEL_MIN_ROWS, rows))
    return -(-k // rows), rows


def _rank_lanes(n: int, threads: int) -> int:
    """Lanes per node for the rank's compares: the most, up to
    ``SEL_MAX_LANES``, that still cover every node in one pass (a power of
    two dividing a warp); 1 where one pass cannot cover them."""
    fit = max(1, min(SEL_MAX_LANES, threads // n))
    return 1 << (fit.bit_length() - 1)


@functools.lru_cache(maxsize=None)
def rank_select_plan(F: int, n: int, k: int, cols: int, smem_optin: int,
                     aligned: bool = True) -> SelectPlan:
    """The launch of ``rank_select`` for F folds keeping k of n scores and
    gathering rows of ``cols`` floats (0: rank only) on a card whose blocks
    may opt in to ``smem_optin`` bytes of shared memory (``aligned``: the
    source rows start on 16 bytes, as ``torch.empty`` gives them). Bands
    of 4-64 kept rows spread a fold over the card (``_row_bands``); every
    block ranks all n scores itself, so no block waits on another. The
    block holds the keys and scores (n rounded up to 4) and the kept nodes
    with their scores: 16 KB at n = k = 1024, within the 48 KB a block
    has without opting in."""
    if not 0 < k <= n <= SEL_MAX_N:
        raise ValueError(f"rank_select needs 0 < k <= n <= {SEL_MAX_N} "
                         f"(n={n}, k={k})")
    smem = 4 * (2 * (-(-n // 4) * 4) + 2 * k)
    if smem > min(smem_optin, 48 * 1024):
        raise ValueError(f"rank_select: n = {n}, k = {k} needs {smem} bytes "
                         f"of shared memory, above {smem_optin}")
    lanes = _rank_lanes(n, SEL_THREADS)
    if cols <= 0:
        return SelectPlan(1, k, SEL_THREADS, lanes, False, smem)
    bands, rows = _row_bands(F, k)
    return SelectPlan(bands, rows, SEL_THREADS, lanes,
                      aligned and cols % 4 == 0, smem)


@functools.lru_cache(maxsize=None)
def gather_rows_plan(F: int, k: int, cols: int,
                     aligned: bool = True) -> GatherPlan:
    """The launch of ``gather_rows`` for F folds of k rows of ``cols``
    floats (``aligned``: source and outputs start on 16 bytes): the pool's
    bands (``_row_bands``), a warp per row up to 8 warps."""
    bands, rows = _row_bands(F, k)
    return GatherPlan(bands, rows, 32 * min(rows, 8),
                      aligned and cols % 4 == 0)


@functools.lru_cache(maxsize=None)
def scatter_rows_plan(F: int, n: int, cols: int,
                      aligned: bool = True) -> RowPlan:
    """The launch of the row kernels for F folds of n output rows of
    ``cols`` floats (``aligned``: every row operand starts on 16 bytes, as
    ``torch.empty`` gives them): 16-byte accesses where ``cols % 4 ==
    0``; a group of lanes per row, the fewest (a power of two) that give
    each lane at most one vector of the row, up to ``ROW_MAX_LANES`` (on
    the card a lane per vector beat a warp per row whose lanes load
    several); the pool's bands (``_row_bands``) cut to the rows one pass
    of ``ROW_MAX_THREADS`` threads covers, and at least a warp's worth of
    rows."""
    if F < 1 or n < 1 or cols < 1:
        raise ValueError(f"scatter_rows_plan needs F, n, cols >= 1 "
                         f"(F={F}, n={n}, cols={cols})")
    vec = aligned and cols % 4 == 0
    vectors = cols // 4 if vec else cols
    lanes = min(ROW_MAX_LANES, 1 << (vectors - 1).bit_length())
    rows = _row_bands(F, n)[1]
    rows = max(1, min(rows, ROW_MAX_THREADS // lanes), min(n, 32 // lanes))
    threads = 32 * -(-rows * lanes // 32)
    return RowPlan(-(-n // rows), rows, threads, lanes, vec)


def _row_plan(F, n, cols, *tensors) -> RowPlan:
    return scatter_rows_plan(F, n, cols, all(
        t.data_ptr() % 16 == 0 for t in tensors if t is not None))


def pool_scores(logits, div=100.0):
    """The pool's scores ``sigmoid(logits * r)``, r = 1 / div rounded to
    fp32: the JAX package writes ``sigmoid(logits / div)``, and XLA
    computes a division by a constant as a product with its fp32
    reciprocal (eager division would round differently at times). The
    plain pool, ``GraphPool`` and ``unet_forward_rankselect`` take their
    scores here, and the ``rank_select`` kernel computes the same. On
    the CPU the rows are padded to a multiple of 64 for the sigmoid:
    torch's CPU sigmoid takes a vectorised path for whole blocks and a
    scalar one for the tail, which may differ in the last bit, so a
    score's bits would otherwise depend on the rows beside it (on the
    fold count)."""
    x = logits * float(np.float32(1.0) / np.float32(div))
    n = x.shape[-1]
    pad = -n % 64
    if not pad or x.device.type != "cpu":
        return torch.sigmoid(x)
    return torch.sigmoid(torch.nn.functional.pad(x, (0, pad)))[
        ..., :n].contiguous()


def rank_select_plain(logits, k, div=100.0, src=None, rnd=False):
    """(s, idx, vals, slot): s = ``pool_scores(logits, div)`` (F, n); idx
    (F, k) int32 of the top-k scores in descending order with ties to the
    lower index (NaN scores last); vals = s[idx]; slot (F, n) int32 = rank if
    kept else -1. ``div`` is 100 in GSR-Net's pool and 1 in the GAT
    U-Net's. With ``src`` (F, n, m) also (pre, x): pre = src[idx] and
    x = pre * vals, the pooled rows. ``rnd``: vals and pre rounded to bf16
    (the bf16 mode's one-hot products), s as it is."""
    s = pool_scores(logits, div)
    key = torch.where(torch.isnan(s), float("-inf"), s)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = order[:, :k].to(torch.int32)
    vals = torch.gather(s, 1, idx.long())
    if rnd:
        vals = _bf16(vals)
    slot = torch.full(s.shape, -1, dtype=torch.int32, device=s.device)
    ranks = torch.arange(k, dtype=torch.int32, device=s.device)
    slot.scatter_(1, idx.long(), ranks.expand(s.shape[0], k).contiguous())
    if src is None:
        return s, idx, vals, slot
    return (s, idx, vals, slot) + gather_rows_plain(src, idx, vals, rnd)


def rank_select_bf16_plain(logits, k, div=100.0, src=None):
    return rank_select_plain(logits, k, div, src, rnd=True)


def rank_select(logits, k, div=100.0, src=None, rnd=False):
    """The pool in one launch (``rank_select_plan``): scores, ranks and,
    given ``src``, the gathered and scaled rows, as ``rank_select_plain``
    returns them; n up to 1024. ``rnd``: the ``rank_select_bf16``
    instance."""
    if not logits.is_cuda:
        return rank_select_plain(logits, k, div, src, rnd)
    _check(logits.device, logits, src)
    _contig(logits, src)
    F, n = logits.shape
    cols = 0
    if src is not None:
        if src.dim() != 3 or tuple(src.shape[:2]) != (F, n):
            raise ValueError(f"rank_select: src {tuple(src.shape)} is not "
                             f"({F}, {n}, cols)")
        cols = src.shape[2]
    plan = rank_select_plan(F, n, k, cols, _smem_optin(logits.device.index),
                            src is None or src.data_ptr() % 16 == 0)
    dev = logits.device
    s = torch.empty(F, n, dtype=torch.float32, device=dev)
    idx = torch.empty(F, k, dtype=torch.int32, device=dev)
    vals = torch.empty(F, k, dtype=torch.float32, device=dev)
    slot = torch.empty(F, n, dtype=torch.int32, device=dev)
    pre = x = None
    if src is not None:
        pre = torch.empty(F, k, cols, dtype=torch.float32, device=dev)
        x = torch.empty_like(pre)
    KERNELS["rank_select_bf16" if rnd else "rank_select"](
        logits.device, _ptr(logits),
                           _ptr(src) if cols else None, _ptr(s), _ptr(idx),
                           _ptr(vals), _ptr(slot), _ptr(pre), _ptr(x), F, n, k,
                           cols, float(div), plan.bands, plan.rows,
                           plan.threads, plan.lanes, int(plan.vec))
    return (s, idx, vals, slot) if src is None else (s, idx, vals, slot,
                                                     pre, x)


def rank_select_bf16(logits, k, div=100.0, src=None):
    return rank_select(logits, k, div, src, rnd=True)


def gather_rows_plain(src, idx, scale=None, rnd=False):
    out = _take_rows(src, idx)
    if rnd:
        out = _bf16(out)
    if scale is None:
        return out
    return out, out * scale[..., None]


def gather_rows_bf16_plain(src, idx, scale=None):
    return gather_rows_plain(src, idx, scale, rnd=True)


def gather_rows(src, idx, scale=None, rnd=False):
    """Pooling as a gather: ``src[f, idx[f, r], :]`` (F, k, m); with
    ``scale`` (F, k) also returns the rows scaled by it. One launch of
    bands of rows, a warp per row (``gather_rows_plan``). ``rnd``: the
    rows rounded to bf16 (``gather_rows_bf16``)."""
    if not src.is_cuda:
        return gather_rows_plain(src, idx, scale, rnd)
    _check(src.device, src, scale)
    _check(src.device, idx, dtype=torch.int32)
    _contig(src, idx, scale)
    F, n, m = src.shape
    k = idx.shape[1]
    out = torch.empty(F, k, m, dtype=torch.float32, device=src.device)
    scaled = None if scale is None else torch.empty_like(out)
    plan = gather_rows_plan(F, k, m, src.data_ptr() % 16 == 0)
    KERNELS["gather_rows_bf16" if rnd else "gather_rows"](
        src.device, _ptr(src), _ptr(idx), _ptr(scale), _ptr(out),
        _ptr(scaled), F, n, k, m, plan.bands, plan.rows, plan.threads,
        int(plan.vec))
    return out if scale is None else (out, scaled)


def gather_rows_bf16(src, idx, scale=None):
    return gather_rows(src, idx, scale, rnd=True)


def scatter_rows_plain(src, slot, scale=None, add=None, rnd=False):
    sel = (slot >= 0)[..., None]
    at = slot.clamp(min=0)
    rows = _take_rows(src, at)
    if scale is not None:
        rows = rows * torch.take_along_dim(scale, at.long(), dim=1)[..., None]
    if rnd:
        rows = _bf16(rows)
    out = torch.where(sel, rows, torch.zeros((), dtype=src.dtype,
                                             device=src.device))
    return out if add is None else out + add


def scatter_rows_bf16_plain(src, slot, scale=None, add=None):
    return scatter_rows_plain(src, slot, scale, add, rnd=True)


def scatter_rows(src, slot, scale=None, add=None, rnd=False):
    """Unpooling as a scatter: row p of the (F, n, m) result is
    ``src[f, slot[f, p]] * scale[f, slot]`` where ``slot >= 0``, else 0,
    plus ``add[f, p]``. One launch of bands of rows
    (``scatter_rows_plan``), equal to the plain version bit for bit.
    ``rnd``: each scattered (scaled) row rounded to bf16 before the
    addend (``scatter_rows_bf16``)."""
    if not src.is_cuda:
        return scatter_rows_plain(src, slot, scale, add, rnd)
    _check(src.device, src, scale, add)
    _check(src.device, slot, dtype=torch.int32)
    _contig(src, slot, scale, add)
    F, k, m = src.shape
    n = slot.shape[1]
    out = torch.empty(F, n, m, dtype=torch.float32, device=src.device)
    plan = _row_plan(F, n, m, src, add, out)
    KERNELS["scatter_rows_bf16" if rnd else "scatter_rows"](
        src.device, _ptr(src), _ptr(slot), _ptr(scale), _ptr(add), _ptr(out),
        F, n, k, m, plan.bands, plan.rows, plan.threads, plan.lanes,
        int(plan.vec))
    return out


def scatter_rows_bf16(src, slot, scale=None, add=None):
    return scatter_rows(src, slot, scale, add, rnd=True)


def pool_logits_bwd_plain(g, pre, slot, s, scale=1.0 / 100.0, rnd=False,
                          ad=False):
    prod = g * pre
    dot = (_bf16(prod) if rnd and not ad else prod).sum(-1)
    g_s = torch.where(slot >= 0,
                      torch.take_along_dim(dot, slot.clamp(min=0).long(), 1),
                      torch.zeros((), dtype=g.dtype, device=g.device))
    if rnd:
        g_s = _bf16(g_s)
    if ad:
        return g_s * (s * (1.0 - s)) * scale
    return g_s * s * (1.0 - s) * scale


def _check_pool_bwd(g, pre, slot, s, *more):
    _check(g.device, g, pre, s, *more)
    _check(g.device, slot, dtype=torch.int32)
    _contig(g, pre, slot, s, *more)
    F, k, m = g.shape
    n = slot.shape[1]
    if tuple(pre.shape) != (F, k, m) or tuple(s.shape) != (F, n):
        raise ValueError(f"pool adjoint: pre {tuple(pre.shape)}, s "
                         f"{tuple(s.shape)} do not match g {tuple(g.shape)}"
                         f" and slot {tuple(slot.shape)}")
    return F, n, k, m


def pool_logits_bwd(g, pre, slot, s, scale=1.0 / 100.0):
    """Adjoint of the pooled rows ``pre * s[idx]`` w.r.t. the pooling
    logits: (F, n), ``<g, pre>`` of the node's kept row times
    ``s (1 - s) scale`` (0 times that for dropped nodes); ``scale`` is
    1 / div of the forward's ``rank_select``. One launch of the row
    kernels' bands; the dot's sum order is the fused pair's."""
    if not g.is_cuda:
        return pool_logits_bwd_plain(g, pre, slot, s, scale)
    F, n, k, m = _check_pool_bwd(g, pre, slot, s)
    out = torch.empty(F, n, dtype=torch.float32, device=g.device)
    plan = _row_plan(F, n, m, g, pre)
    KERNELS["pool_logits_bwd"](g.device, _ptr(g), _ptr(pre), _ptr(slot),
                               _ptr(s), _ptr(out), F, n, k, m, float(scale),
                               plan.bands, plan.rows, plan.threads, plan.lanes,
                               int(plan.vec))
    return out


def pool_bwd_pair_plain(g, pre, slot, s, vals, add, scale=1.0 / 100.0,
                        rnd=False, ad=False):
    return (scatter_rows_plain(g, slot, vals, add, rnd),
            pool_logits_bwd_plain(g, pre, slot, s, scale, rnd, ad))


def pool_bwd_pair_bf16_plain(g, pre, slot, s, vals, add, scale=1.0 / 100.0):
    return pool_bwd_pair_plain(g, pre, slot, s, vals, add, scale, rnd=True)


def pool_bwd_pair_bf16_ad_plain(g, pre, slot, s, vals, add,
                                scale=1.0 / 100.0):
    return pool_bwd_pair_plain(g, pre, slot, s, vals, add, scale, rnd=True,
                               ad=True)


def pool_bwd_pair(g, pre, slot, s, vals, add, scale=1.0 / 100.0, rnd=False,
                  ad=False):
    """The GSR backward's two adjoints of a pool level in one launch,
    each kept row of ``g`` read once: (``scatter_rows(g, slot, vals,
    add)``, ``pool_logits_bwd(g, pre, slot, s, scale)``), the first bit
    for bit and the second with the standalone launch's bits. ``rnd``
    (``pool_bwd_pair_bf16``): the scaled rows rounded to bf16 before the
    addend, the dot a sum of bf16-rounded products, rounded before it is
    scaled, as the JAX package's bf16 one-hot products give them in its
    hand-written adjoints (``fused_step.py:451-460``). ``ad`` with ``rnd``
    (``pool_bwd_pair_bf16_ad``): the dot as the JAX package's autodiff of
    its bf16 forward takes it (``fused_step.py:384-387``): a sum of the
    unrounded products, rounded, then times ``s (1 - s)`` and ``scale``."""
    if not g.is_cuda:
        return pool_bwd_pair_plain(g, pre, slot, s, vals, add, scale, rnd,
                                   ad)
    F, n, k, m = _check_pool_bwd(g, pre, slot, s, vals, add)
    if tuple(vals.shape) != (F, k) or tuple(add.shape) != (F, n, m):
        raise ValueError(f"pool_bwd_pair: vals {tuple(vals.shape)}, add "
                         f"{tuple(add.shape)} do not match g "
                         f"{tuple(g.shape)} and slot {tuple(slot.shape)}")
    g_d = torch.empty(F, n, m, dtype=torch.float32, device=g.device)
    g_logits = torch.empty(F, n, dtype=torch.float32, device=g.device)
    plan = _row_plan(F, n, m, g, pre, add, g_d)
    name = "pool_bwd_pair" + ("_bf16" if rnd else "") + ("_ad" if ad else "")
    KERNELS[name](
        g.device, _ptr(g), _ptr(pre), _ptr(slot), _ptr(s), _ptr(vals),
        _ptr(add), _ptr(g_d), _ptr(g_logits), F, n, k, m, float(scale),
        plan.bands, plan.rows, plan.threads, plan.lanes, int(plan.vec))
    return g_d, g_logits


def pool_bwd_pair_bf16(g, pre, slot, s, vals, add, scale=1.0 / 100.0):
    return pool_bwd_pair(g, pre, slot, s, vals, add, scale, rnd=True)


def pool_bwd_pair_bf16_ad(g, pre, slot, s, vals, add, scale=1.0 / 100.0):
    return pool_bwd_pair(g, pre, slot, s, vals, add, scale, rnd=True, ad=True)


def add_bias_plain(x, bias, rnd=False):
    return (_bf16(x) if rnd else x) + bias.reshape(x.shape[0], 1, x.shape[2])


def add_bias_bf16_plain(x, bias):
    return add_bias_plain(x, bias, rnd=True)


def add_bias(x, bias, rnd=False):
    """``x + bias`` row-broadcast: x (F, r, c), bias (F, 1, c); both may
    be views into a flat buffer (16-byte accesses where x, bias and their
    batch strides are 16-byte aligned, else 4-byte). ``rnd``
    (``add_bias_bf16``): x rounded to bf16 first, the JAX bf16 mode's
    ``eye @ W + b``."""
    if not x.is_cuda:
        return add_bias_plain(x, bias, rnd)
    _check(x.device, x, bias)
    _rows_contig(x)
    F, r, c = x.shape
    bias = bias.reshape(F, 1, c) if bias.dim() == 2 else bias
    if bias.stride(2) != 1:
        raise ValueError("bias row must be contiguous")
    out = torch.empty(F, r, c, dtype=torch.float32, device=x.device)
    KERNELS["add_bias_bf16" if rnd else "add_bias"](
        x.device, _ptr(x), x.stride(0), _ptr(bias), bias.stride(0), _ptr(out),
        F, r, c)
    return out


def add_bias_bf16(x, bias):
    return add_bias(x, bias, rnd=True)


# ---------------------------------------------------------------------------
# tail_elementwise
# ---------------------------------------------------------------------------

def _fill_diag_abs(t):
    eye = _eye_mask(t.shape[-1], t.device)
    return torch.where(eye, torch.ones((), dtype=t.dtype, device=t.device),
                       t.abs())


def tail_normalize_plain(t):
    fd = _fill_diag_abs(t)
    r = fd.sum(-1).pow(-0.5)
    r = torch.where(torch.isinf(r), torch.zeros_like(r), r)
    adj = (fd * r[:, None, :]).transpose(-1, -2) * r[:, None, :]
    return adj, r


# The two cluster kernels of tail.cu (tail_normalize, l1_term) run a
# thread-block cluster per fold; their wrappers plan the launch here, on
# the host, from shapes, pointers and the card's shared-memory limit.
MAX_CLUSTER = 16        # the card's largest (non-portable) cluster
NORM_MAX_M = 12 * 1024  # tail_normalize's widest m
L1_MAX_N = 2 ** 31 - 4  # l1_term's longest fold (int offsets)
L1_THREADS = 256        # l1_term's threads per block ...
L1_GROUPS = 4           # ... and the groups of 4 elements each aims for


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    """Bytes of shared memory a block may opt in to on card ``index`` (the
    limit tail.cu checks a plan against)."""
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


class NormPlan(NamedTuple):
    """tail_normalize's launch: ``rows`` rows for each of the 16 blocks
    of a fold; ``chunk`` columns staged at a time (``chunk == m``: the
    rows staged once, ``staged``), in tiles of row stride ``ld``; 16-byte
    copies when ``vec``; ``smem`` bytes of shared memory per block."""
    rows: int
    chunk: int
    ld: int
    staged: bool
    vec: bool
    smem: int


def tail_normalize_plan(m: int, aligned: bool, smem_optin: int) -> NormPlan:
    """The launch of ``tail_normalize`` at width m (``aligned``: T starts
    on 16 bytes, as ``torch.empty`` gives it) on a card whose blocks may
    opt in to ``smem_optin`` bytes of shared memory. Each of the 16
    blocks of a fold holds r for all m rows and a tile of its rows: all m
    columns where they fit (T read from memory once; 16-byte copies and a
    row stride of 4 (mod 32) where m % 4 == 0 and T is aligned, else an
    odd stride), else the widest even chunk (its rows summed from memory,
    then staged chunk by chunk for the writes)."""
    rows = -(-m // MAX_CLUSTER)
    vec = aligned and m % 4 == 0
    ld = m + (4 - m % 32) % 32 if vec else m | 1
    if 4 * (m + rows * ld) <= smem_optin:
        return NormPlan(rows, m, ld, True, vec, 4 * (m + rows * ld))
    chunk = (smem_optin // 4 - m) // rows - 1
    chunk -= chunk % 2
    if chunk < 2:
        raise ValueError(f"tail_normalize: m = {m} too large for "
                         f"{smem_optin} bytes of shared memory")
    return NormPlan(rows, chunk, chunk + 1, False, False,
                    4 * (m + rows * (chunk + 1)))


def tail_normalize(t):
    """(adj, r) for T (F, m, m): f_d = fill_diag(|T|, 1),
    r = rowsum(f_d)^-1/2 with inf -> 0, adj = D^-1/2 f_d^T D^-1/2.
    One launch, a cluster of 16 blocks per fold exchanging r in
    distributed shared memory; m up to 12 288 (on an H100 the rows are
    staged once up to m ~950, in column chunks past that)."""
    if not t.is_cuda:
        return tail_normalize_plain(t)
    _check(t.device, t)
    _contig(t)
    F, m, _ = t.shape
    if m > NORM_MAX_M:
        raise ValueError(f"tail_normalize: m = {m} above {NORM_MAX_M}")
    plan = tail_normalize_plan(m, t.data_ptr() % 16 == 0,
                               _smem_optin(t.device.index))
    adj = torch.empty_like(t)
    r = torch.empty(F, m, dtype=torch.float32, device=t.device)
    KERNELS["tail_normalize"](t.device, _ptr(t), _ptr(adj), _ptr(r), F, m,
                              MAX_CLUSTER, plan.rows, plan.chunk, plan.ld,
                              int(plan.vec))
    return adj, r


def tail_normalize_bwd_plain(g_adj, t, r):
    fd = _fill_diag_abs(t)
    gT = g_adj.transpose(-1, -2)
    fdT = fd.transpose(-1, -2)
    g_r = ((gT * fd * r[:, None, :]).sum(-1)
           + (g_adj * r[:, None, :] * fdT).sum(-1))
    g_rs = g_r * -0.5 * (r * r * r)
    g_fd = gT * r[:, :, None] * r[:, None, :] + g_rs[:, :, None]
    eye = _eye_mask(t.shape[-1], t.device)
    return torch.where(eye, torch.zeros((), dtype=t.dtype, device=t.device),
                       g_fd * _asign(t))


def tail_normalize_bwd(g_adj, t, r):
    """dT for ``tail_normalize`` given d adj (m up to ~11 600: each of the
    kernel's row bands stages its rows and columns in shared memory)."""
    if not t.is_cuda:
        return tail_normalize_bwd_plain(g_adj, t, r)
    _check(t.device, g_adj, t, r)
    _contig(g_adj, t, r)
    F, m, _ = t.shape
    g_t = torch.empty_like(t)
    KERNELS["tail_normalize_bwd"](t.device, _ptr(g_adj), _ptr(t), _ptr(r),
                                  _ptr(g_t), F, m)
    return g_t


def _sym(x):
    return (x + x.transpose(-1, -2)) / 2


def sym_abs_fill_plain(x):
    return _fill_diag_abs(_sym(x))


# sym_abs_fill and sym_sign_grad (tail.cu) run a block of 256 threads per
# pair of mirrored SYM_TILE x SYM_TILE tiles (tail.cu's SYM_T; 32 was best
# or tied in a sweep on an H100, PERF.md)
SYM_TILE = 32
SYM_MAX_F = 65535        # the grid's y extent


class SymPlan(NamedTuple):
    """The launch of ``sym_abs_fill`` / ``sym_sign_grad``: ``grid`` =
    (``pairs``, F) blocks, each owning the tile pair (ti, tj), (tj, ti),
    ti <= tj (``sym_pair``); 16-byte accesses when ``vec``."""
    pairs: int
    grid: tuple
    vec: bool


@functools.lru_cache(maxsize=None)
def sym_tiles_plan(F: int, m: int, aligned: bool) -> SymPlan:
    """The launch of the symmetric pair for F folds of m x m (``aligned``:
    every operand starts on 16 bytes, as ``torch.empty`` gives them): nt =
    ceil(m / SYM_TILE) tiles a side, a block per unordered tile pair,
    nt (nt + 1) / 2 per fold; 16-byte accesses only where m % 4 == 0 and
    the operands are aligned. The C entries derive the same grid."""
    if F < 1 or m < 1:
        raise ValueError(f"sym_tiles_plan needs F, m >= 1 (F={F}, m={m})")
    if F > SYM_MAX_F:
        raise ValueError(f"sym_tiles_plan: F = {F} above {SYM_MAX_F}")
    nt = -(-m // SYM_TILE)
    pairs = nt * (nt + 1) // 2
    if pairs >= 2 ** 31:
        raise ValueError(f"sym_tiles_plan: m = {m} needs {pairs} blocks")
    return SymPlan(pairs, (pairs, F), bool(aligned) and m % 4 == 0)


def sym_pair(p: int):
    """(ti, tj) of block p, the kernel's map: p = tj (tj + 1) / 2 + ti,
    0 <= ti <= tj, from a float32 square root and the same integer
    correction (tail.cu::sym_pair)."""
    one = np.float32(1.0)
    t = int((np.sqrt(np.float32(8.0) * np.float32(p) + one) - one)
            * np.float32(0.5))
    while t * (t + 1) // 2 > p:
        t -= 1
    while (t + 1) * (t + 2) // 2 <= p:
        t += 1
    return p - t * (t + 1) // 2, t


def _sym_launch(name, g, x, c):
    _check(x.device, g, x)
    _contig(g, x)
    F, m, m2 = x.shape
    if m2 != m or (g is not None and g.shape != x.shape):
        raise ValueError(f"{name}: operands must be one (F, m, m) shape")
    out = torch.empty_like(x)
    xp, op = x.data_ptr(), out.data_ptr()
    if g is None:
        vec = sym_tiles_plan(F, m, (xp | op) % 16 == 0).vec
        KERNELS[name](x.device, xp, op, F, m, vec)
    else:
        gp = g.data_ptr()
        vec = sym_tiles_plan(F, m, (xp | op | gp) % 16 == 0).vec
        KERNELS[name](x.device, gp, xp, float(c), op, F, m, vec)
    return out


def sym_abs_fill(x):
    """|fill_diag((X + X^T) / 2, 1)| over (F, m, m): one launch of a block
    per pair of mirrored tiles (``sym_tiles_plan``)."""
    if not x.is_cuda:
        return sym_abs_fill_plain(x)
    return _sym_launch("sym_abs_fill", None, x, None)


def sym_sign_grad_plain(g, x, c):
    eye = _eye_mask(x.shape[-1], x.device)
    G = torch.where(eye, torch.zeros((), dtype=x.dtype, device=x.device),
                    g * _asign(_sym(x)))
    return c * G + c * G.transpose(-1, -2)


def sym_sign_grad(g, x, c):
    """Adjoint of ``sym_abs_fill`` at X given d out, times ``2c``:
    ``c (G + G^T)`` with ``G = g * sign(sym X)``, zero diagonal
    (c = 1/2 is the exact adjoint); launched as ``sym_abs_fill`` is."""
    if not x.is_cuda:
        return sym_sign_grad_plain(g, x, c)
    return _sym_launch("sym_sign_grad", g, x, c)


def sym_check_inputs(F: int, m: int, seed: int):
    """(x, g), float32 numpy (F, m, m) from a seeded draw, with the special
    values the symmetric pair is checked on (CPU tests and the card's):
    exact zeros, -0.0, pairs x_ij = -x_ji, a NaN off and on the diagonal,
    +-inf (an inf - inf pair in x and in g), an inf on g's diagonal."""
    if m < 8:
        raise ValueError(f"sym_check_inputs needs m >= 8 (m={m})")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((F, m, m)).astype(np.float32)
    g = rng.standard_normal((F, m, m)).astype(np.float32)
    x[:, 0, 1:5] = 0.0
    x[:, 1:5, 0] = 0.0
    x[:, 2, 3] = x[:, 3, 2] = -0.0
    x[:, 0, 5], x[:, 5, 0] = -0.0, 0.0
    x[:, 6, 7:] = -x[:, 7:, 6]
    x[0, m - 1, 1] = x[0, 2, 2] = np.nan
    x[-1, 1, m - 2], x[-1, m - 2, 1] = np.inf, -np.inf
    x[0, 3, m - 1] = np.inf
    g[:, 4, 5] = -0.0
    g[0, 4, 7], g[0, 7, 4] = np.inf, -np.inf
    g[0, 5, 5] = np.inf
    return x, g


def _check_loss_outputs(vals, slot, loss, recon):
    """l1_term writes (loss, recon) with the last of the three terms only,
    and recon only beside loss."""
    if loss is None:
        if recon is not None:
            raise ValueError("l1_term: recon is written only beside loss")
        return
    if slot != 2:
        raise ValueError("l1_term writes loss and recon with the last term "
                         f"(slot 2), not slot {slot}")
    for t in (loss, recon):
        if t is not None and tuple(t.shape) != (vals.shape[0],):
            raise ValueError(f"loss and recon must be ({vals.shape[0]},), "
                             f"got {tuple(t.shape)}")


def l1_term_plain(a, b, vals, slot, value_scale, grad_scale, zero_sign,
                  neg=False, loss=None, recon=None, with_l1=True):
    _check_loss_outputs(vals, slot, loss, recon)
    d = (a - b).reshape(a.shape[0], -1)
    vals[:, slot] = value_scale * d.abs().mean(-1)
    if loss is not None:
        tail = vals[:, 1] + vals[:, 2]
        loss.copy_(vals[:, 0] + tail if with_l1 else tail)
        if recon is not None:
            recon.copy_(vals[:, 1])
    sgn = torch.sign(d) if zero_sign else _asign(d)
    grad = (sgn * grad_scale).reshape(a.shape)
    return (grad, -grad) if neg else grad


class L1Plan(NamedTuple):
    """l1_term's launch: ``cluster`` blocks per fold, each taking
    ``per_block`` groups of 4 elements; 16-byte loads and stores when
    ``vec``."""
    cluster: int
    per_block: int
    vec: bool


def l1_term_plan(a, b) -> L1Plan:
    """The launch of ``l1_term`` on operands a, b (F, ...): the fewest
    blocks per fold (a power of two, at most 16) that give each thread
    about ``L1_GROUPS`` groups; the 16-byte path where n % 4 == 0 and a,
    b and both batch strides are 16-byte aligned (outputs from
    ``torch.empty`` are). Reads only shapes, strides and addresses; the
    value's bits depend on the cluster size alone, so on n alone."""
    F = a.shape[0]
    n = a.numel() // F if F else 0
    groups = -(-n // 4)
    want = -(-groups // (L1_THREADS * L1_GROUPS))
    cluster = min(MAX_CLUSTER, 1 << max(0, want - 1).bit_length())
    vec = (n % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
           and (F == 1 or (a.stride(0) % 4 == 0 and b.stride(0) % 4 == 0)))
    return L1Plan(cluster, -(-groups // cluster), vec)


def l1_term(a, b, vals, slot, value_scale, grad_scale, zero_sign,
            neg=False, loss=None, recon=None, with_l1=True):
    """Writes ``vals[:, slot] = value_scale * mean|a - b|`` per fold and
    returns its adjoint ``sign(a - b) * grad_scale`` (and its negation when
    ``neg``); ``zero_sign`` picks sign(0) = 0 over the |.| adjoint's +1.
    a and b may have any batch stride but contiguous fold slices. One
    launch, a cluster of up to 16 blocks per fold whose partial sums meet
    in rank order; up to 2^31 - 4 elements per fold.

    ``vals`` (F, 3) holds a loss entry point's terms [lmbda * L1(net,
    start), recon, spectral]. With the last term (slot 2) the launch also
    writes the entry point's scalars into ``loss`` (F,): ``vals[0] +
    (vals[1] + vals[2])`` (``adam_masked``'s order, so the same bits), or
    without ``with_l1`` the tail's ``vals[1] + vals[2]`` (slot 0 is then
    not read); and ``recon`` (F,), when given, ``vals[1]``. Slots 0 and 1
    must have been written before, on the same stream."""
    if not a.is_cuda:
        return l1_term_plain(a, b, vals, slot, value_scale, grad_scale,
                             zero_sign, neg, loss, recon, with_l1)
    _check(a.device, a, b, vals, loss, recon)
    _contig(vals, loss, recon)
    _check_loss_outputs(vals, slot, loss, recon)
    F = a.shape[0]
    n = a.numel() // F if F else 0
    for t in (a, b):
        if not _folds_contig(t) or t.shape != a.shape:
            raise ValueError("l1_term operands need contiguous fold slices")
    if n > L1_MAX_N:
        raise ValueError(f"l1_term: {n} elements per fold above {L1_MAX_N}")
    if vals.shape != (F, 3):
        raise ValueError("vals must be (F, 3)")
    plan = l1_term_plan(a, b)
    grad = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    ng = torch.empty_like(grad) if neg else None
    KERNELS["l1_term"](a.device, _ptr(a), a.stride(0), _ptr(b), b.stride(0), n,
                       float(value_scale), float(grad_scale), int(zero_sign),
                       _ptr(vals), int(slot), _ptr(grad), _ptr(ng),
                       _ptr(loss), _ptr(recon), int(bool(with_l1)), F,
                       plan.cluster, plan.per_block, int(plan.vec))
    return (grad, ng) if neg else grad


# ---------------------------------------------------------------------------
# adam_masked
# ---------------------------------------------------------------------------

def adam_masked_plain(p, m, v, g, scal, vals, lr, b1, b2, eps):
    ok, d1, d2 = (scal[:, j:j + 1] for j in range(3))
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * (g * g)
    mhat = m_new / d1
    vhat = v_new / d2
    step = lr * mhat / (torch.sqrt(vhat) + eps)
    on = ok > 0
    loss = (vals[:, 0] + (vals[:, 1] + vals[:, 2])) * scal[:, 0]
    recon = vals[:, 1] * scal[:, 0]
    return (torch.where(on, p - step, p), torch.where(on, m_new, m),
            torch.where(on, v_new, v), loss, recon)


def adam_masked(p, m, v, g, scal, vals, lr, b1, b2, eps):
    """Masked Adam on flat (F, P) buffers with per-fold scalars
    ``scal[f] = [ok, 1 - b1^t, 1 - b2^t]``; returns (p', m', v', loss,
    recon) where loss/recon are the per-fold step values from ``vals``
    (F, 3) = [lmbda * L1(net, start), recon, spectral], times ok."""
    if not p.is_cuda:
        return adam_masked_plain(p, m, v, g, scal, vals, lr, b1, b2, eps)
    _check(p.device, p, m, v, g, scal, vals)
    _contig(p, m, v, g, scal, vals)
    F, P = p.shape
    if m.shape != p.shape or v.shape != p.shape or g.shape != p.shape:
        raise ValueError("adam_masked buffers must share one (F, P) shape")
    p2, m2, v2 = (torch.empty_like(p) for _ in range(3))
    loss = torch.empty(F, dtype=torch.float32, device=p.device)
    recon = torch.empty_like(loss)
    KERNELS["adam_masked"](p.device, _ptr(p), _ptr(m), _ptr(v), _ptr(g),
                           _ptr(scal), _ptr(vals), _ptr(p2), _ptr(m2),
                           _ptr(v2), _ptr(loss), _ptr(recon), F, P, float(lr),
                           float(b1), float(1.0 - b1), float(b2),
                           float(1.0 - b2), float(eps))
    return p2, m2, v2, loss, recon


# ---------------------------------------------------------------------------
# triu: vectorized connectomes <-> dense adjacency stacks
# ---------------------------------------------------------------------------

def _degree_normalize(a):
    """``(a r_i) r_j`` with ``r = rowsum^-1/2``; only the infinite r of a
    zero row sum becomes 0, a negative row sum's NaN propagates."""
    rowsum = a.sum(-1, keepdim=True)
    r = torch.where(rowsum == 0, torch.zeros_like(rowsum),
                    torch.rsqrt(rowsum))
    return (a * r) * r.transpose(-1, -2)


def _check_batch(t, what, max_b=65535):
    if t.dim() != 3 or t.shape[1] != t.shape[2] or t.shape[1] < 2:
        raise ValueError(f"{what} needs a (B, n, n) stack with n >= 2, got "
                         f"{tuple(t.shape)}")
    if not 0 < t.shape[0] <= max_b:
        raise ValueError(f"{what} takes 1 to {max_b} matrices per call, got "
                         f"{t.shape[0]}")


def anti_vectorize_normalize_plain(v, n, normalize=True, fill_diag=0.0):
    m = n * (n - 1) // 2
    rows, cols = torch.triu_indices(n, n, 1, device=v.device)
    out = torch.zeros(v.shape[0], n, n, dtype=v.dtype, device=v.device)
    out[:, rows, cols] = v[:, :m]
    out = out + out.transpose(-1, -2)
    if fill_diag != 0.0:
        out = torch.where(_eye_mask(n, v.device),
                          torch.full((), fill_diag, dtype=v.dtype,
                                     device=v.device), out)
    return _degree_normalize(out) if normalize else out


AV_TILE = 32            # triu.cu's tile edge (AV_T)
AV_TILE_BYTES = 4 * AV_TILE * (AV_TILE + 1)   # a tile staged, rows of 33
AV_CHUNK = 8            # tiles a normalised block stages at once (AV_CHUNK)
AV_MAX_B = 2 ** 31 - 1  # matrices per launch (triu.cu walks them past the
                        # grid's y extent)


class AntivecPlan(NamedTuple):
    """anti_vectorize_normalize's launch over B matrices: ``form`` 0 the
    copy, a block per tile pair (grid (pairs, min(B, 65535))); 1
    normalised, a cluster of ``cluster`` blocks per matrix (grid
    (cluster, min(B, 65535))), each owning ``per_block`` consecutive tile
    pairs, staged in chunks of up to ``AV_CHUNK`` tiles (v read once where
    they make one chunk, else again for the writes); 16-byte stores when
    ``vec`` (n % 4 == 0: the output, from ``torch.empty``, starts on 16
    bytes, and so does every tile row); ``smem`` bytes of dynamic shared
    memory per block."""
    form: int
    grid: tuple
    cluster: int
    per_block: int
    vec: bool
    smem: int


@functools.lru_cache(maxsize=None)
def antivec_plan(B: int, n: int, normalize: bool, smem_optin: int,
                 sms: int) -> AntivecPlan:
    """The launch of ``anti_vectorize_normalize`` for B matrices of n x n
    on a card of ``sms`` SMs whose blocks may opt in to ``smem_optin``
    bytes of shared memory. nt = ceil(n / 32) tiles a side, nt (nt + 1) /
    2 unordered tile pairs (``sym_pair``). The copy takes a block per
    pair. Normalised, a cluster per matrix takes the fewest blocks whose
    pairs make one chunk each (a block stages them in one batch and reads
    v once), or more where that leaves an SM fewer than two blocks (a
    block walks its pairs one after another, so fewer pairs a block is
    shorter where the card has room), at most 16 and at most the pairs;
    the pairs spread evenly over them. A block holds the chunk's tiles,
    partial and final row sums (2 n floats) and nt flags. Refuses what the
    grid or a block's shared memory cannot take."""
    if n < 2 or not 1 <= B <= AV_MAX_B:
        raise ValueError(f"anti_vectorize_normalize: n = {n} (>= 2) and "
                         f"B = {B} (1 to {AV_MAX_B}) per launch")
    nt = -(-n // AV_TILE)
    pairs = nt * (nt + 1) // 2
    if pairs >= 2 ** 31:
        raise ValueError(f"anti_vectorize_normalize: n = {n} needs {pairs} "
                         "tile pairs, past the grid")
    vec = n % 4 == 0
    rows = min(B, 65535)
    if not normalize:
        return AntivecPlan(0, (pairs, rows), 1, 1, vec, 0)
    want = max(-(-pairs // AV_CHUNK), -(-2 * sms // B))
    per = -(-pairs // min(MAX_CLUSTER, pairs, want))
    cluster = -(-pairs // per)
    smem = 4 * (2 * n + nt) + AV_CHUNK * AV_TILE_BYTES
    if smem > smem_optin:
        raise ValueError(f"anti_vectorize_normalize: n = {n} too large for "
                         f"{smem_optin} bytes of shared memory (normalised)")
    return AntivecPlan(1, (cluster, rows), cluster, per, vec, smem)


def antivec_tile_runs(n: int, p: int):
    """The runs of a row-major strict-upper vector that the block of tile
    pair p stages (triu.cu's ``av_stage``): for each row i of the upper
    tile (ti, tj) = ``sym_pair(p)`` that holds entries, (i, j_first,
    start, count): ``v[start + k]`` is entry (i, j_first + k), k < count
    (entry (i, j), i < j, lies at i n - i (i + 1) / 2 + j - i - 1)."""
    ti, tj = sym_pair(p)
    i0, j0 = ti * AV_TILE, tj * AV_TILE
    runs = []
    for i in range(i0, min(i0 + AV_TILE, n)):
        j_first, j_end = max(j0, i + 1), min(j0 + AV_TILE, n)
        if j_first < j_end:
            runs.append((i, j_first,
                         i * n - i * (i + 1) // 2 + j_first - i - 1,
                         j_end - j_first))
    return runs


def anti_vectorize_normalize(v, n, normalize=True, fill_diag=0.0):
    """(B, V) row-major strict-upper vectors, V >= n(n-1)/2 (trailing
    entries ignored) -> (B, n, n) symmetric; the diagonal is 0, or
    ``fill_diag`` when that is not 0; with ``normalize`` the result is
    ``(a r_i) r_j``, r from the row sums. One launch of a block per pair
    of mirrored tiles, or normalised a cluster per matrix
    (``antivec_plan``)."""
    m = n * (n - 1) // 2
    if v.dim() != 2 or n < 2 or v.shape[1] < m:
        raise ValueError(f"anti_vectorize_normalize needs (B, V >= {m}) "
                         f"vectors for n={n}, got {tuple(v.shape)}")
    if not v.is_cuda:
        return anti_vectorize_normalize_plain(v, n, normalize, fill_diag)
    _check(v.device, v)
    if v.stride(1) != 1:
        raise ValueError("anti_vectorize_normalize needs vectors with unit "
                         "element stride")
    B = v.shape[0]
    if normalize:
        props = torch.cuda.get_device_properties(v.device.index)
        plan = antivec_plan(B, n, True, props.shared_memory_per_block_optin,
                            props.multi_processor_count)
    else:
        plan = antivec_plan(B, n, False, 0, 0)
    out = torch.empty(B, n, n, dtype=torch.float32, device=v.device)
    # -0.0 fills nothing, as in the plain version
    KERNELS["anti_vectorize_normalize"](v.device, _ptr(v), v.stride(0),
                                        _ptr(out), B, n,
                                        float(fill_diag) or 0.0, plan.form,
                                        plan.cluster, plan.per_block,
                                        int(plan.vec))
    return out


def vectorize_colmajor_plain(m):
    # strict-lower pairs in row-major order are (j, i), i < j, sorted by
    # (j, i): swapped, the column-major walk of the strict upper triangle
    j, i = torch.tril_indices(m.shape[-1], m.shape[-1], -1, device=m.device)
    return m[:, i, j]


CM_MATS = 2             # matrices a vectorize_colmajor block stages (CM_MATS)


def colmajor_plan(B: int, n: int):
    """The grid of ``vectorize_colmajor``'s launch over B matrices of n x
    n: (tiles, rows), a block per upper 32 x 32 tile (nt (nt + 1) / 2 of
    them, nt = ceil(n / 32), the map ``sym_pair``) and pair of matrices
    (``CM_MATS``), rows = min(ceil(B / 2), 65535) (blocks walk the pairs
    past that). Refuses what the C entry refuses or writes nothing for: n
    < 2, B outside 1 to ``AV_MAX_B``, 2^31 tiles or more."""
    if n < 2 or not 1 <= B <= AV_MAX_B:
        raise ValueError(f"vectorize_colmajor: n = {n} (>= 2) and B = {B} "
                         f"(1 to {AV_MAX_B}) per launch")
    nt = -(-n // AV_TILE)
    tiles = nt * (nt + 1) // 2
    if tiles >= 2 ** 31:
        raise ValueError(f"vectorize_colmajor: n = {n} needs {tiles} tiles, "
                         "past the grid")
    return tiles, min(-(-B // CM_MATS), 65535)


def colmajor_tile_runs(n: int, p: int):
    """The column runs that the block of tile p writes (triu.cu's
    ``colmajor_tiles``): for each column j of the upper tile (ti, tj) =
    ``sym_pair(p)`` that holds entries above the diagonal, (j, i_first,
    out_start, count): ``out[out_start + k]`` is ``M[i_first + k, j]``, k <
    count (entry (i, j), i < j, lies at j (j - 1) / 2 + i)."""
    ti, tj = sym_pair(p)
    i0, j0 = ti * AV_TILE, tj * AV_TILE
    return [(j, i0, j * (j - 1) // 2 + i0, min(AV_TILE, j - i0))
            for j in range(j0, min(j0 + AV_TILE, n)) if j > i0]


def vectorize_colmajor(m):
    """(B, n, n) -> (B, n(n-1)/2): entry ``p = j(j-1)/2 + i`` is
    ``m[:, i, j]``, i < j (columns in order, rows above the diagonal within
    each column; the input need not be symmetric). A copy: exact. One
    launch, a block per upper 32 x 32 tile and pair of matrices
    (``colmajor_plan``) that reads the tiles' rows and writes their
    columns as runs."""
    _check_batch(m, "vectorize_colmajor", AV_MAX_B)
    if not m.is_cuda:
        return vectorize_colmajor_plain(m)
    _check(m.device, m)
    _contig(m)
    B, n, _ = m.shape
    out = torch.empty(B, n * (n - 1) // 2, dtype=torch.float32,
                      device=m.device)
    KERNELS["vectorize_colmajor"](m.device, _ptr(m), _ptr(out), B, n)
    return out


def normalize_adj_batch_plain(a):
    return _degree_normalize(a)


def normalize_adj_batch(a):
    """(B, n, n) -> ``(a r_i) r_j`` with ``r = rowsum^-1/2`` (0 for a zero
    row sum, NaN for a negative one). No transpose: equal to
    ``core.normalize.normalize_adj`` on symmetric input up to the order of
    the two multiplications."""
    _check_batch(a, "normalize_adj_batch")
    if not a.is_cuda:
        return normalize_adj_batch_plain(a)
    _check(a.device, a)
    _contig(a)
    B, n, _ = a.shape
    if n > 12 * 1024:
        raise ValueError("normalize_adj_batch: n too large for shared memory")
    out = torch.empty_like(a)
    KERNELS["normalize_adj_batch"](a.device, _ptr(a), _ptr(out), B, n)
    return out


# ---------------------------------------------------------------------------
# gat: masked multi-head attention and its adjoint, the counter-based
# dropout masks, pooled adjacency, column softmax, off-diagonal losses, AdamW
# ---------------------------------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(const, x):
    """(high, low) 32-bit words of ``const * x`` for int64 ``x`` in
    [0, 2^32), through 16-bit halves so that int64 never overflows."""
    p_lo = const * (x & 0xFFFF)
    p_hi = const * (x >> 16)
    lo = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (lo >> 32), lo & _U32


def philox_words(seeds, mask_id, heads, per_head):
    """(F, heads, per_head) int64 words in [0, 2^32): word 0 of
    Philox-4x32-10 at counter (element, head, mask_id, 0) under the key
    ``seeds[f]`` (two int32 words per fold) — what the kernels draw."""
    dev = seeds.device
    F = seeds.shape[0]
    key = seeds.to(torch.int64) & _U32
    k0, k1 = key[:, 0].view(F, 1, 1), key[:, 1].view(F, 1, 1)
    c0 = torch.arange(per_head, dtype=torch.int64, device=dev).view(
        1, 1, per_head).expand(F, heads, per_head)
    c1 = torch.arange(heads, dtype=torch.int64, device=dev).view(
        1, heads, 1).expand(F, heads, per_head)
    c2 = torch.full_like(c0, mask_id)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _U32
        k1 = (k1 + _PHILOX_W1) & _U32
    return c0


def bits_to_keep(words, drop_p):
    """Unsigned 32-bit words (int64 values) -> float32 keep mask
    ~ Bernoulli(1 - drop_p): ``u = (word >>> 8) / 2^24``, keep when
    ``u >= drop_p`` (compared in float32) — the reference's transform."""
    u = (words >> 8).to(torch.float32) * (1.0 / (1 << 24))
    p32 = torch.tensor(drop_p, dtype=torch.float32).item()
    return (u >= p32).to(torch.float32)


def _seeds_ok(seeds, F):
    if seeds is None or seeds.dtype != torch.int32 \
            or tuple(seeds.shape) != (F, 2) or not seeds.is_contiguous():
        raise ValueError(f"dropout needs contiguous int32 seeds of shape "
                         f"({F}, 2)")


def philox_keep_mask_plain(seeds, mask_id, heads, rows, cols, drop_p,
                           x=None, scale=1.0):
    keep = bits_to_keep(philox_words(seeds, mask_id, heads, rows * cols),
                        drop_p).view(seeds.shape[0], heads, rows, cols)
    if x is None:
        return keep * scale
    return ((x.reshape(keep.shape) * keep) * scale).view(x.shape)


KM_THREADS = 256        # philox_keep_mask's threads per block (gat.cu)
KM_WAVE = 1056          # blocks of 256 threads 132 SMs hold at once (8 each)
MAX_F = 65535           # a grid's y or z extent: the most folds (or heads)


class KeepMaskPlan(NamedTuple):
    """``philox_keep_mask``'s launch: grid (``strips``, heads, F) of
    ``KM_THREADS`` threads, ``vec`` consecutive elements a thread."""
    strips: int
    vec: int


def philox_keep_mask_plan(batch: int, heads: int, per_head: int,
                          aligned: bool) -> KeepMaskPlan:
    """The launch of ``philox_keep_mask`` over ``batch`` x ``heads`` planes
    of ``per_head`` elements: 16-byte accesses (4 draws a thread) where
    per_head % 4 == 0 and out and x are ``aligned``; as many strips a
    plane as cover it, at most about one wave of blocks on the card in
    all (longer planes are walked grid-stride)."""
    if batch > MAX_F:
        raise ValueError(f"philox_keep_mask: {batch} folds, at most {MAX_F}")
    if heads > MAX_F:
        raise ValueError(f"philox_keep_mask: {heads} heads, at most {MAX_F}")
    if per_head >= 2 ** 32:
        raise ValueError(f"philox_keep_mask: {per_head} elements a plane "
                         "overflow the generator's 32-bit element counter")
    vec = 4 if per_head % 4 == 0 and aligned else 1
    need = max(1, -(-per_head // (KM_THREADS * vec)))
    return KeepMaskPlan(min(need, max(1, KM_WAVE // max(1, batch * heads))),
                        vec)


def philox_keep_mask(seeds, mask_id, heads, rows, cols, drop_p, x=None,
                     scale=1.0):
    """The dropout keep-mask ``mask_id`` (its place in the step's order)
    under the per-fold ``seeds`` (F, 2) int32: (F, heads, rows, cols) of
    0 / 1 times ``scale``; with ``x`` of that many elements,
    ``(x * keep) * scale`` in x's shape. The attention kernels draw the
    same bits from the same function, so no mask is stored."""
    F = seeds.shape[0]
    _seeds_ok(seeds, F)
    if not seeds.is_cuda:
        return philox_keep_mask_plain(seeds, mask_id, heads, rows, cols,
                                      drop_p, x, scale)
    if x is not None:
        _check(seeds.device, x)
        _contig(x)
        if x.numel() != F * heads * rows * cols:
            raise ValueError("philox_keep_mask: x does not match the mask")
    # out is a fresh allocation: 16-byte aligned
    plan = philox_keep_mask_plan(F, heads, rows * cols,
                                 x is None or x.data_ptr() % 16 == 0)
    out = (torch.empty(F, heads, rows, cols, dtype=torch.float32,
                       device=seeds.device) if x is None
           else torch.empty_like(x))
    KERNELS["philox_keep_mask"](seeds.device, _ptr(seeds), _ptr(x), _ptr(out),
                                F, heads, rows * cols, plan.strips, plan.vec,
                                int(mask_id), float(drop_p), float(scale))
    return out


DROP_THREADS = 128      # the pool products' threads per block (gat.cu)
DROP_WARPS = 4          # ... a warp per row in the forward


def _drop_checks(what, F, n, c):
    if F > MAX_F:
        raise ValueError(f"{what}: {F} folds, at most {MAX_F}")
    if n * c >= 2 ** 32:
        raise ValueError(f"{what}: {n} x {c} elements overflow the "
                         "generator's 32-bit element counter")


def philox_drop_logits_plan(F: int, n: int, c: int) -> int:
    """Blocks per fold of ``philox_drop_logits``: a warp per row of the
    (n, c) input, ``DROP_WARPS`` rows a block (grid (blocks, F))."""
    _drop_checks("philox_drop_logits", F, n, c)
    return max(1, -(-n // DROP_WARPS))


class DropPlan(NamedTuple):
    """``philox_drop_outer``'s launch: grid (``blocks``, F) of
    ``DROP_THREADS`` threads, ``vec`` consecutive columns a thread."""
    blocks: int
    vec: int


def philox_drop_outer_plan(F: int, n: int, c: int,
                           aligned: bool) -> DropPlan:
    """The launch of ``philox_drop_outer`` over the (n, c) adjoint: 16-byte
    stores (4 columns a thread) where c % 4 == 0 and g_z is aligned."""
    _drop_checks("philox_drop_outer", F, n, c)
    vec = 4 if c % 4 == 0 and aligned else 1
    return DropPlan(max(1, -(-(n * c // vec) // DROP_THREADS)), vec)


def philox_drop_logits_plain(x, w, b, seeds, mask_id, drop_p, scale):
    _, n, c = x.shape
    z = philox_keep_mask_plain(seeds, mask_id, 1, n, c, drop_p, x, scale)
    return z, bgemm_plain(z, w, bias=b)


def philox_drop_logits(x, w, b, seeds, mask_id, drop_p, scale):
    """The pool's forward under dropout: ``z = (x keep) scale`` with the
    keep mask ``mask_id`` (head 0) of the per-fold ``seeds``, and the
    logits ``z w + b``: x (F, n, c), w (F, c, 1) and b (F, 1, 1) with
    contiguous rows and any batch stride. Returns (z (F, n, c), logits
    (F, n, 1)), the bits of ``philox_keep_mask`` followed by ``bgemm``, in
    one launch."""
    F, n, c = x.shape
    _seeds_ok(seeds, F)
    if not x.is_cuda:
        return philox_drop_logits_plain(x, w, b, seeds, mask_id, drop_p,
                                        scale)
    _check(x.device, x, w, b)
    _contig(x)
    _rows_contig(w)
    if tuple(w.shape) != (F, c, 1) or b.numel() != F or b.dim() < 2:
        raise ValueError(f"philox_drop_logits: w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not fit x {tuple(x.shape)}")
    blocks = philox_drop_logits_plan(F, n, c)
    z = torch.empty_like(x)
    logits = torch.empty(F, n, 1, dtype=torch.float32, device=x.device)
    KERNELS["philox_drop_logits"](x.device, _ptr(x), _ptr(w), w.stride(0),
                                  _ptr(b), b.stride(0), _ptr(seeds), _ptr(z),
                                  _ptr(logits), F, n, c, blocks, int(mask_id),
                                  float(drop_p), float(scale))
    return z, logits


def philox_drop_outer_plain(gl, w, seeds, mask_id, drop_p, scale):
    n, c = gl.shape[1], w.shape[1]
    g_z = bgemm_plain(gl, w, tb=True)
    return philox_keep_mask_plain(seeds, mask_id, 1, n, c, drop_p, g_z,
                                  scale)


def philox_drop_outer(gl, w, seeds, mask_id, drop_p, scale):
    """The pool's input adjoint under dropout: ``g_z = ((gl w^T) keep)
    scale`` for gl (F, n, 1) and w (F, c, 1) (contiguous rows, any batch
    stride), keep the mask of ``philox_drop_logits``: the bits of the
    rank-1 ``bgemm`` followed by ``philox_keep_mask``, in one launch."""
    F, n = gl.shape[0], gl.shape[1]
    _seeds_ok(seeds, F)
    if not gl.is_cuda:
        return philox_drop_outer_plain(gl, w, seeds, mask_id, drop_p, scale)
    _check(gl.device, gl, w)
    _contig(gl)
    _rows_contig(w)
    c = w.shape[1]
    if tuple(gl.shape) != (F, n, 1) or tuple(w.shape) != (F, c, 1):
        raise ValueError(f"philox_drop_outer: gl {tuple(gl.shape)} and w "
                         f"{tuple(w.shape)} are not (F, n, 1), (F, c, 1)")
    g_z = torch.empty(F, n, c, dtype=torch.float32, device=gl.device)
    plan = philox_drop_outer_plan(F, n, c, g_z.data_ptr() % 16 == 0)
    KERNELS["philox_drop_outer"](gl.device, _ptr(gl), _ptr(w), w.stride(0),
                                 _ptr(seeds), _ptr(g_z), F, n, c,
                                 plan.blocks, plan.vec, int(mask_id),
                                 float(drop_p), float(scale))
    return g_z


def _drop_scale(drop_p):
    return 1.0 / (1.0 - drop_p)


def gat_attention_math(h, att_src, att_dst, bias, a, keep_scale=None,
                       global_shift=False):
    """Dense masked multi-head attention (PyG GATConv semantics) as
    differentiable PyTorch: h (F, n, H d) the projected features, att_src /
    att_dst (F, H, d), bias (F, 1, H d), a (F, n, n). Returns
    (relu(out + bias), alpha) with alpha (F, H, n, n) the attention before
    dropout; ``keep_scale`` = (keep mask (F, H, n, n), 1 / (1 - p))."""
    F, n, HD = h.shape
    H, d = att_src.shape[-2:]
    hh = h.reshape(F, n, H, d)
    s = (hh * att_src[:, None]).sum(-1)                     # (F, n, H)
    t = (hh * att_dst[:, None]).sum(-1)
    z = s.transpose(1, 2)[:, :, None, :] + t.transpose(1, 2)[:, :, :, None]
    z = torch.where(z >= 0, z, 0.2 * z)                     # slope 1 at 0
    mask = ((a != 0) | _eye_mask(n, a.device))[:, None]
    logits = z.masked_fill(~mask, -1e30)
    zmax = logits.amax(-1, keepdim=True)
    if global_shift:
        zmax = zmax.amax(1, keepdim=True)
    e = torch.exp(logits - zmax.detach()) * mask
    alpha = e / e.sum(-1, keepdim=True)
    ad = alpha
    if keep_scale is not None:
        ad = alpha * keep_scale[0] * keep_scale[1]
    out = torch.matmul(ad, hh.permute(0, 2, 1, 3))          # (F, H, n, d)
    out = out.permute(0, 2, 1, 3).reshape(F, n, HD)
    return torch.relu(out + bias.reshape(F, 1, HD)), alpha


def _keep_scale(seeds, mask_id, H, n, drop_p):
    if not drop_p > 0:
        return None
    return (philox_keep_mask_plain(seeds, mask_id, H, n, n, drop_p),
            _drop_scale(drop_p))


def gat_attention_plain(h, att_src, att_dst, bias, a, seeds=None, mask_id=0,
                        drop_p=0.0, global_shift=False, need_alpha=True):
    H = att_src.shape[-2]
    y, alpha = gat_attention_math(
        h, att_src, att_dst, bias, a,
        _keep_scale(seeds, mask_id, H, h.shape[1], drop_p), global_shift)
    return y, (alpha if need_alpha else None)


def _param_stride(t, rows, cols, what):
    """Batch stride of a (F, rows, cols) parameter operand with dense
    rows (a leaf view of the flat buffer, or one model's leaf expanded)."""
    if t.dim() != 3 or tuple(t.shape[1:]) != (rows, cols):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"(F, {rows}, {cols})")
    _rows_contig(t)
    return t.stride(0)


# Every launch of gat.cu but the elementwise ones takes a plan that its
# wrapper makes here, on the host, from shapes and the card's opt-in shared
# memory; a given input always gets the same plan.
SMS = 132               # an H100's multiprocessors: the blocks a plan aims at
GAT_MAX_N = 12 * 1024   # gat_attention's and its adjoint's widest n
GAT_FWD_THREADS = 256   # gat_attention's threads per block ...
GAT_FWD_WAVE = 2 * SMS  # ... the blocks its plan aims at ...
GAT_FWD_MIN_ROWS = 4    # ... the fewest target rows of a band ...
GAT_FWD_MAX_ROWS = 32   # ... and the most


class GatFwdPlan(NamedTuple):
    """gat_attention's launch: ``bands`` blocks of ``rows`` target rows per
    (head, fold); the sources in chunks of ``chunk`` (``staged``: one
    chunk, the head's h and the band's rows of a staged once); each output
    summed by ``group`` lanes; ``smem`` bytes of shared memory per block."""
    rows: int
    bands: int
    chunk: int
    group: int
    staged: bool
    smem: int


def _gat_fwd_smem(n, hh, d, rows, chunk):
    """Bytes of gat_attention's shared memory (gat.cu ``fwd_smem``): the
    band's rows of a (then alpha k) in 16-byte rows, h rows of ``hh``
    heads at an odd stride, s of the chunk, t, shift and denominator of
    the band, att_src and att_dst, and with chunks the band's partial
    outputs."""
    ldp = -(-chunk // 4) * 4 + 4
    return 4 * (rows * ldp + chunk * ((hh * d) | 1) + hh * chunk + hh * rows
                + 2 * rows + 2 * hh * d + (0 if chunk >= n else rows * d))


def gat_attention_plan(n: int, heads: int, d: int, F: int,
                       global_shift: bool, smem_optin: int) -> GatFwdPlan:
    """The launch of ``gat_attention`` for F folds of ``heads`` heads of d
    features over n nodes (``global_shift``: every head's logits reach the
    shift, so the block stages all heads' h columns), on a card whose
    blocks may opt in to ``smem_optin`` bytes of shared memory: bands of
    equal height (4 to 32 target rows) so that the (band, head, fold) grid
    is about two blocks per SM, lower ones where the staged head and band
    would not fit; past that, the sources in the widest chunks of a
    multiple of 32. Each output is summed by as many lanes (a power of two
    up to 32) as keep the block's threads busy."""
    hh = heads if global_shift else 1
    bands = max(min(-(-GAT_FWD_WAVE // (heads * F)),
                    -(-n // GAT_FWD_MIN_ROWS)), -(-n // GAT_FWD_MAX_ROWS))
    rows = -(-n // bands)
    rows = even = -(-n // -(-n // rows))   # the last band as tall as the rest
    while rows > 1 and _gat_fwd_smem(n, hh, d, rows, n) > smem_optin:
        rows = -(-rows // 2)
    staged = _gat_fwd_smem(n, hh, d, rows, n) <= smem_optin
    chunk = n
    if not staged:
        rows = even
        while True:
            fixed = _gat_fwd_smem(n, hh, d, rows, 0)
            chunk = (smem_optin - fixed) // (4 * (rows + ((hh * d) | 1)
                                                  + hh))
            chunk -= chunk % 32
            if chunk >= 32 or rows == 1:
                break
            rows = -(-rows // 2)
        if chunk < 32:
            raise ValueError(f"gat_attention: n = {n}, {hh} x {d} staged "
                             f"features too large for {smem_optin} bytes "
                             "of shared memory")
    group = 1
    while group < 32 and 2 * group * rows * d <= GAT_FWD_THREADS:
        group *= 2
    return GatFwdPlan(rows, -(-n // rows), chunk, group, staged,
                      _gat_fwd_smem(n, hh, d, rows, chunk))


def gat_attention(h, att_src, att_dst, bias, a, seeds=None, mask_id=0,
                  drop_p=0.0, global_shift=False, need_alpha=True):
    """One GAT layer after its projection: (y, alpha) with
    ``y = relu(attend(h) + bias)`` (F, n, H d) and alpha (F, H, n, n) the
    softmax over the existing-edge + self-loop sources before dropout
    (None unless ``need_alpha``). With ``drop_p > 0`` the attention is
    multiplied by keep-mask ``mask_id`` of ``seeds`` over 1 - p.
    ``global_shift`` takes the softmax shift over all heads of a row.
    One launch, a block per (band of target rows, head, fold) over the
    head's staged h (``gat_attention_plan``); n up to 12 288."""
    if not h.is_cuda:
        return gat_attention_plain(h, att_src, att_dst, bias, a, seeds,
                                   mask_id, drop_p, global_shift, need_alpha)
    F, n, HD = h.shape
    H, d = att_src.shape[-2:]
    _check(h.device, h, att_src, att_dst, bias, a)
    _contig(h, a)
    if H * d != HD or tuple(a.shape) != (F, n, n) or att_src.shape[0] != F:
        raise ValueError("gat_attention shape mismatch")
    s_src = _param_stride(att_src, H, d, "att_src")
    s_dst = _param_stride(att_dst, H, d, "att_dst")
    s_bias = _param_stride(bias, 1, HD, "bias")
    if n > GAT_MAX_N:
        raise ValueError(f"gat_attention: n = {n} above {GAT_MAX_N}")
    if drop_p > 0:
        _seeds_ok(seeds, F)
        _check(h.device, seeds, dtype=torch.int32)
    plan = gat_attention_plan(n, H, d, _PLAN_FOLDS.get() or F,
                              bool(global_shift),
                              _smem_optin(h.device.index))
    y = torch.empty_like(h)
    alpha = torch.empty(F, H, n, n, dtype=torch.float32, device=h.device) \
        if need_alpha else None
    KERNELS["gat_attention"](h.device, _ptr(h), _ptr(att_src), s_src,
                             _ptr(att_dst), s_dst, _ptr(bias), s_bias, _ptr(a),
                             _ptr(seeds) if drop_p > 0 else None, _ptr(y),
                             _ptr(alpha), F, n, H, d, int(mask_id),
                             float(drop_p), float(_drop_scale(drop_p)),
                             int(bool(global_shift)), plan.rows, plan.chunk,
                             plan.group)
    return y, alpha


def gat_attention_bwd_plain(g_y, y, alpha, h, att_src, att_dst, seeds,
                            mask_id, drop_p, g_src, g_dst, g_bias):
    F, n, HD = h.shape
    H, d = att_src.shape[-2:]
    go = torch.where(y > 0, g_y, torch.zeros((), dtype=g_y.dtype,
                                             device=g_y.device))
    goh = go.view(F, n, H, d).permute(0, 2, 1, 3)            # (F, H, n, d)
    hh = h.view(F, n, H, d).permute(0, 2, 1, 3)
    asrc, adst = att_src[:, :, None, :], att_dst[:, :, None, :]
    ks = _keep_scale(seeds, mask_id, H, n, drop_p)
    g_al = torch.matmul(goh, hh.transpose(-1, -2))           # (F, H, i, src)
    ad = alpha
    if ks is not None:
        g_al = g_al * ks[0] * ks[1]
        ad = alpha * ks[0] * ks[1]
    g_logit = alpha * (g_al - (alpha * g_al).sum(-1, keepdim=True))
    z = (hh * asrc).sum(-1)[:, :, None, :] + (hh * adst).sum(-1)[:, :, :, None]
    gz = torch.where(z >= 0, g_logit, 0.2 * g_logit)
    gs, gt = gz.sum(-2), gz.sum(-1)                          # (F, H, n)
    g_hh = (torch.matmul(ad.transpose(-1, -2), goh)
            + gs[..., None] * asrc + gt[..., None] * adst)
    g_src.copy_((gs[..., None] * hh).sum(-2))
    g_dst.copy_((gt[..., None] * hh).sum(-2))
    g_bias.copy_(go.sum(1, keepdim=True))
    return g_hh.permute(0, 2, 1, 3).reshape(F, n, HD)


# gat_attention_bwd and the off-diagonal losses run a thread-block cluster
# per (head, fold) or per fold (gat.cu); their wrappers plan the launch
# here, on the host, from shapes and the card's shared-memory limit.
GAT_BWD_THREADS = 512   # gat_attention_bwd's threads per block ...
GAT_BWD_WARPS = 16      # ... its warps
GAT_BWD_SUB = 32        # ... and its sub-band of target rows
GAT_BWD_MIN_ROWS = 4    # the fewest target rows a block is planned with


class GatBwdPlan(NamedTuple):
    """gat_attention_bwd's launch: ``cluster`` blocks per (head, fold),
    each owning ``rows`` target rows and as many sources; the sources in
    chunks of ``chunk`` (``staged``: one chunk, the head's h staged once),
    the rows in sub-bands of ``sub``; ``smem`` bytes of shared memory per
    block."""
    cluster: int
    rows: int
    chunk: int
    sub: int
    staged: bool
    smem: int


def _gat_bwd_smem(n, d, cluster, rows, chunk, sub):
    """Bytes of gat_attention_bwd's shared memory (gat.cu ``bwd_smem``):
    h rows, s, five band vectors, the two attention vectors, g_o of a
    sub-band, the gz and alpha k tiles, the band's partials, a row's g_o
    per warp, the parameter shares and rank 0's sums of them, and when
    the sources fit in one chunk the band's alpha rows."""
    return 4 * (chunk * (d | 1) + n + 5 * rows + 2 * d + sub * d
                + 2 * sub * chunk + chunk * (d + 1) + GAT_BWD_WARPS * d
                + 3 * GAT_BWD_THREADS + 3 * cluster * d
                + (rows * n if chunk >= n else 0))


def gat_attention_bwd_plan(n: int, heads: int, d: int, F: int,
                           smem_optin: int) -> GatBwdPlan:
    """The launch of ``gat_attention_bwd`` for F folds of ``heads`` heads
    of d features over n nodes, on a card whose blocks may opt in to
    ``smem_optin`` bytes of shared memory: the largest power-of-two
    cluster (at most 16) that keeps the grid near one block per SM and
    each block at least 4 target rows; all sources in one chunk where
    that fits (every shipped layer), else the widest multiple of 32."""
    want = max(1, min(MAX_CLUSTER, SMS // max(1, heads * F),
                      n // GAT_BWD_MIN_ROWS))
    cluster = 1 << (want.bit_length() - 1)
    rows = -(-n // cluster)
    sub = min(rows, GAT_BWD_SUB)
    smem = _gat_bwd_smem(n, d, cluster, rows, n, sub)
    if smem <= smem_optin:
        return GatBwdPlan(cluster, rows, n, sub, True, smem)
    fixed = _gat_bwd_smem(n, d, cluster, rows, 0, sub)
    chunk = (smem_optin - fixed) // (4 * ((d | 1) + 2 * sub + d + 1))
    chunk -= chunk % 32
    if chunk < 32:
        raise ValueError(f"gat_attention_bwd: n = {n}, d = {d} too large "
                         f"for {smem_optin} bytes of shared memory")
    return GatBwdPlan(cluster, rows, chunk, sub, False,
                      _gat_bwd_smem(n, d, cluster, rows, chunk, sub))


def gat_attention_bwd(g_y, y, alpha, h, att_src, att_dst, seeds, mask_id,
                      drop_p, g_src, g_dst, g_bias):
    """Adjoint of ``gat_attention`` given d y: returns d h (through the
    values and through both attention logits) and writes d att_src,
    d att_dst (F, H, d) and d bias (F, 1, H d) into the given views. The
    keep-mask is drawn again from ``seeds``; alpha is the forward's. One
    launch, a cluster per (head, fold) reducing in distributed shared
    memory (``gat_attention_bwd_plan``); n up to 12 288."""
    if not h.is_cuda:
        return gat_attention_bwd_plain(g_y, y, alpha, h, att_src, att_dst,
                                       seeds, mask_id, drop_p, g_src, g_dst,
                                       g_bias)
    F, n, HD = h.shape
    H, d = att_src.shape[-2:]
    _check(h.device, g_y, y, alpha, h, att_src, att_dst, g_src, g_dst,
           g_bias)
    _contig(g_y, y, alpha, h)
    if g_y.shape != h.shape or y.shape != h.shape \
            or tuple(alpha.shape) != (F, H, n, n):
        raise ValueError("gat_attention_bwd shape mismatch")
    if n > GAT_MAX_N:
        raise ValueError(f"gat_attention_bwd: n = {n} above {GAT_MAX_N}")
    strides = [_param_stride(t, r, c, what) for t, r, c, what in (
        (att_src, H, d, "att_src"), (att_dst, H, d, "att_dst"),
        (g_src, H, d, "g_src"), (g_dst, H, d, "g_dst"),
        (g_bias, 1, HD, "g_bias"))]
    if drop_p > 0:
        _seeds_ok(seeds, F)
        _check(h.device, seeds, dtype=torch.int32)
    plan = gat_attention_bwd_plan(n, H, d, _PLAN_FOLDS.get() or F,
                                  _smem_optin(h.device.index))
    g_h = torch.empty_like(h)
    KERNELS["gat_attention_bwd"](h.device, _ptr(g_y), _ptr(y), _ptr(alpha),
                                 _ptr(h), _ptr(att_src), strides[0],
                                 _ptr(att_dst), strides[1],
                                 _ptr(seeds) if drop_p > 0 else None,
                                 _ptr(g_h), _ptr(g_src), strides[2],
                                 _ptr(g_dst), strides[3], _ptr(g_bias),
                                 strides[4], F, n, H, d, int(mask_id),
                                 float(drop_p), float(_drop_scale(drop_p)),
                                 plan.cluster, plan.rows, plan.chunk, plan.sub)
    return g_h


def gat_pool_adj_plain(a, idx, eps=1e-5):
    ix = idx.long()
    g = torch.take_along_dim(torch.take_along_dim(a, ix[:, :, None], 1),
                             ix[:, None, :], 2)
    r = torch.rsqrt(g.sum(-1) + eps)
    return g * r[:, None, :] * r[:, :, None]


GAT_POOL_MIN_ROWS = 4   # the fewest pooled rows a block is planned with
GAT_POOL_MAX_BANDS = 16  # the most blocks a fold is planned with


class PoolPlan(NamedTuple):
    """gat_pool_adj's launch: ``bands`` blocks per fold, each summing every
    row and writing ``rows`` pooled rows; ``smem`` bytes of shared memory
    per block."""
    bands: int
    rows: int
    smem: int


def _gat_pool_smem(k):
    """Bytes of gat_pool_adj's dynamic shared memory (gat.cu
    ``pool_smem``): the fold's idx and every row's r."""
    return 8 * k


def gat_pool_adj_plan(F: int, n: int, k: int, smem_optin: int) -> PoolPlan:
    """The launch of ``gat_pool_adj`` for F folds pooling n nodes to k on a
    card whose blocks may opt in to ``smem_optin`` bytes of shared memory:
    up to 16 blocks per fold, within one block per SM and at least 4
    pooled rows each. Each block sums all k rows itself, so no block waits
    on another; k = 12 288 needs 96 KB."""
    if not 0 < k <= n:
        raise ValueError(f"gat_pool_adj: cannot keep k = {k} of n = {n}")
    smem = _gat_pool_smem(k)
    if smem > smem_optin:
        raise ValueError(f"gat_pool_adj: k = {k} too large for "
                         f"{smem_optin} bytes of shared memory")
    want = max(1, min(GAT_POOL_MAX_BANDS, SMS // max(1, F),
                       k // GAT_POOL_MIN_ROWS))
    rows = -(-k // want)
    return PoolPlan(-(-k // rows), rows, smem)


def gat_pool_adj(a, idx, eps=1e-5):
    """The pooled adjacency ``symnorm(a[idx][:, idx])`` (F, k, k) for a
    (F, n, n) and int32 idx (F, k): ``(g r_col) r_row`` with
    ``r = (rowsum(g) + eps)^-1/2``. Data and selection only: no adjoint.
    One launch of bands of pooled rows per fold, each block summing every
    row (``gat_pool_adj_plan``); k up to 12 288."""
    if not a.is_cuda:
        return gat_pool_adj_plain(a, idx, eps)
    _check(a.device, a)
    _check(a.device, idx, dtype=torch.int32)
    _contig(a, idx)
    F, n, _ = a.shape
    k = idx.shape[1]
    if k > GAT_MAX_N:
        raise ValueError(f"gat_pool_adj: k = {k} above {GAT_MAX_N}")
    plan = gat_pool_adj_plan(F, n, k, _smem_optin(a.device.index))
    out = torch.empty(F, k, k, dtype=torch.float32, device=a.device)
    KERNELS["gat_pool_adj"](a.device, _ptr(a), _ptr(idx), _ptr(out), F, n, k,
                            float(eps), plan.bands, plan.rows)
    return out


def col_softmax_plain(y):
    e = torch.exp(y - y.amax(1, keepdim=True))
    return e / e.sum(1, keepdim=True)


CSM_PER = 4             # col_softmax's rows a thread keeps in registers
CSM_MAX_WARPS = 32      # ... its most warps a block
CSM_REG_ROWS = CSM_PER * CSM_MAX_WARPS   # the most rows kept in registers


class SoftmaxPlan(NamedTuple):
    """col_softmax's launch, grid (ceil(C / 32), F): ``form`` 0 keeps the
    values in registers, 1 reads y again; ``warps`` split the rows."""
    form: int
    warps: int


@functools.lru_cache(maxsize=None)
def col_softmax_plan(F: int, R: int) -> SoftmaxPlan:
    """The launch of ``col_softmax`` over (F, R, C): up to
    ``CSM_REG_ROWS`` rows, ceil(R / 4) warps holding 4 rows each in
    registers; past that 32 warps over y itself. Every R runs."""
    if F > MAX_F:
        raise ValueError(f"col_softmax: {F} folds, at most {MAX_F}")
    if R <= CSM_REG_ROWS:
        return SoftmaxPlan(0, max(1, -(-R // CSM_PER)))
    return SoftmaxPlan(1, CSM_MAX_WARPS)


def col_softmax(y):
    """Softmax over the rows (axis 1) of (F, R, C), column by column: one
    launch, a block per (fold, 32 columns), each y read once up to 128
    rows (``col_softmax_plan``)."""
    if not y.is_cuda:
        return col_softmax_plain(y)
    _check(y.device, y)
    _contig(y)
    F, R, C = y.shape
    form, warps = col_softmax_plan(F, R)
    q = torch.empty_like(y)
    KERNELS["col_softmax"](y.device, _ptr(y), _ptr(q), F, R, C, form, warps)
    return q


def col_softmax_bwd_plain(g_q, q):
    return q * (g_q - (q * g_q).sum(1, keepdim=True))


def col_softmax_bwd(g_q, q):
    """d y of ``q = col_softmax(y)`` given d q: ``q (g_q - sum_rows q
    g_q)``, one launch in ``col_softmax``'s layout and plan
    (``col_softmax_plan``): a block per (fold, 32 columns), q and g_q read
    once up to 128 rows."""
    if not q.is_cuda:
        return col_softmax_bwd_plain(g_q, q)
    _check(q.device, g_q, q)
    _contig(g_q, q)
    if g_q.shape != q.shape:
        raise ValueError("col_softmax_bwd: g_q and q must be one (F, R, C) "
                         "shape")
    F, R, C = q.shape
    form, warps = col_softmax_plan(F, R)
    g_y = torch.empty_like(q)
    KERNELS["col_softmax_bwd"](q.device, _ptr(g_q), _ptr(q), _ptr(g_y), F, R,
                               C, form, warps)
    return g_y


def _offdiag_diff(G, T):
    return (torch.relu(G) - T).masked_fill(_eye_mask(G.shape[-1], G.device),
                                           0.0)


def offdiag_mse_plain(G, T, vals, slot, grad=True):
    n = G.shape[-1]
    d = _offdiag_diff(G, T)
    vals[:, slot] = (d * d).sum((-2, -1)) / (n * n)
    if not grad:
        return None
    gd = torch.where(G > 0, d, torch.zeros((), dtype=G.dtype,
                                           device=G.device))
    return (2.0 / (n * n)) * (gd + gd.transpose(-1, -2))


def _check_offdiag(G, T, vals, slot):
    _check(G.device, G, T, vals)
    _contig(G, T, vals)
    F, n, _ = G.shape
    if G.shape != T.shape or G.shape[1] != G.shape[2] or vals.dim() != 2 \
            or vals.shape[0] != F or not 0 <= slot < vals.shape[1]:
        raise ValueError("off-diagonal loss shape mismatch")
    return F, n


OFFDIAG_TILE = 32
# one staged tile set at most: G and T, and with the cotangent their
# mirrored tiles in rows padded to 36 floats (gat.cu offdiag_loss_kernel)
OFFDIAG_STAGE_BYTES = 4 * (2 * 32 * 32 + 2 * 32 * 36)


class OffdiagPlan(NamedTuple):
    """The off-diagonal losses' launch: ``cluster`` blocks per fold, each
    taking ``per_block`` of the fold's 32 x 32 tiles (tiles b, b + cluster,
    ...), ``stages`` of them staged at once."""
    cluster: int
    per_block: int
    stages: int


def offdiag_plan(F: int, n: int, smem_optin: int) -> OffdiagPlan:
    """The launch of ``offdiag_mse`` / ``offdiag_mae`` for F folds of
    n x n: the largest power-of-two cluster (at most 16, at most the
    fold's tiles) that keeps the grid near two blocks per SM, so many
    blocks per fold at F = 3 and few at the validation's F = 56; as many
    of a block's tiles staged at once as half the card's opt-in shared
    memory holds (two blocks share an SM). The value's bits depend on the
    cluster alone, so on (F, n)."""
    tiles = (-(-n // OFFDIAG_TILE)) ** 2
    want = max(1, min(MAX_CLUSTER, 2 * SMS // max(1, F), tiles))
    cluster = 1 << (want.bit_length() - 1)
    per_block = -(-tiles // cluster)
    stages = max(1, min(per_block, smem_optin // 2 // OFFDIAG_STAGE_BYTES))
    return OffdiagPlan(cluster, per_block, stages)


def _offdiag_launch(name, G, T, vals, slot, gsym):
    F, n = G.shape[:2]
    plan = offdiag_plan(_PLAN_FOLDS.get() or F, n,
                        _smem_optin(G.device.index))
    vec = n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (G, T, gsym)
                             if t is not None)
    args = [_ptr(G), _ptr(T), _ptr(vals), vals.shape[1], int(slot)]
    if name == "offdiag_mse":
        args.append(_ptr(gsym))
    KERNELS[name](G.device, *args, F, n, plan.cluster, plan.per_block,
                  plan.stages, int(vec))


def offdiag_mse(G, T, vals, slot, grad=True):
    """Writes ``vals[:, slot] = sum_{i != j} (relu(G) - T)^2 / n^2`` per
    fold (the mean over all n^2 entries with the diagonal zeroed) and, with
    ``grad``, returns the symmetrised cotangent of G,
    ``(2 / n^2) (D + D^T)`` with ``D = (relu(G) - T) [G > 0]`` off the
    diagonal: for ``G = X X^T`` (or ``Q^T Q``) d loss / d X is that times X.
    One launch, a cluster per fold over 32 x 32 tiles (``offdiag_plan``)."""
    if not G.is_cuda:
        return offdiag_mse_plain(G, T, vals, slot, grad)
    _check_offdiag(G, T, vals, slot)
    gsym = torch.empty_like(G) if grad else None
    _offdiag_launch("offdiag_mse", G, T, vals, slot, gsym)
    return gsym


def offdiag_mae_plain(G, T, vals, slot):
    n = G.shape[-1]
    vals[:, slot] = _offdiag_diff(G, T).abs().sum((-2, -1)) / (n * n)


def offdiag_mae(G, T, vals, slot):
    """Writes ``vals[:, slot] = sum_{i != j} |relu(G) - T| / n^2``, as
    ``offdiag_mse`` launches."""
    if not G.is_cuda:
        return offdiag_mae_plain(G, T, vals, slot)
    _check_offdiag(G, T, vals, slot)
    _offdiag_launch("offdiag_mae", G, T, vals, slot, None)


def _sum_terms(vals):
    loss = vals[:, 0]
    for j in range(1, vals.shape[1]):
        loss = loss + vals[:, j]
    return loss.clone() if vals.shape[1] == 1 else loss


def adamw_masked_plain(p, m, v, g, scal, vals, b1, b2, eps, wd,
                       inplace=False):
    ok, lr, d1, d2 = (scal[:, j:j + 1] for j in range(4))
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * (g * g)
    mhat = m_new / d1
    vhat = v_new / d2
    step = lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p)
    on = ok > 0
    out = (torch.where(on, p - step, p), torch.where(on, m_new, m),
           torch.where(on, v_new, v))
    if inplace:
        for buf, new in zip((p, m, v), out):
            buf.copy_(new)
        out = (p, m, v)
    return (*out, _sum_terms(vals))


def adamw_masked(p, m, v, g, scal, vals, b1, b2, eps, wd, inplace=False):
    """Masked AdamW (the decay inside the step, as optax.adamw) on flat
    (F, P) buffers with per-fold scalars ``scal[f] = [ok, lr, 1 - b1^t,
    1 - b2^t]`` read from device memory; returns (p', m', v', loss) with
    ``loss[f]`` the sum of the fold's loss terms ``vals[f]`` in order.
    With ``inplace`` p', m', v' are written over p, m, v (the returned
    tensors are those three): the kernel's in-place form, the same bits."""
    if not p.is_cuda:
        return adamw_masked_plain(p, m, v, g, scal, vals, b1, b2, eps, wd,
                                  inplace)
    _check(p.device, p, m, v, g, scal, vals)
    _contig(p, m, v, g, scal, vals)
    F, P = p.shape
    if m.shape != p.shape or v.shape != p.shape or g.shape != p.shape \
            or tuple(scal.shape) != (F, 4) or vals.shape[0] != F:
        raise ValueError("adamw_masked: buffers must share one (F, P) shape, "
                         "scal be (F, 4) and vals (F, terms)")
    p2, m2, v2 = (p, m, v) if inplace else (torch.empty_like(p)
                                             for _ in range(3))
    loss = torch.empty(F, dtype=torch.float32, device=p.device)
    KERNELS["adamw_masked"](p.device, _ptr(p), _ptr(m), _ptr(v), _ptr(g),
                            _ptr(scal), _ptr(vals), vals.shape[1], _ptr(p2),
                            _ptr(m2), _ptr(v2), _ptr(loss), F, P, float(b1),
                            float(1.0 - b1), float(b2), float(1.0 - b2),
                            float(eps), float(wd))
    return p2, m2, v2, loss


_OPS = ("bgemm", "colsum_f32", "rank_select", "gather_rows",
        "scatter_rows", "pool_logits_bwd", "pool_bwd_pair", "add_bias",
        "tail_normalize", "tail_normalize_bwd", "sym_abs_fill",
        "sym_sign_grad", "l1_term", "adam_masked", "anti_vectorize_normalize",
        "vectorize_colmajor", "normalize_adj_batch", "gat_attention",
        "gat_attention_bwd", "philox_keep_mask", "philox_drop_logits",
        "philox_drop_outer", "gat_pool_adj",
        "col_softmax", "col_softmax_bwd", "offdiag_mse", "offdiag_mae",
        "adamw_masked")
# launch the kernel for CUDA tensors, the plain version for CPU tensors
KERNEL_OPS = SimpleNamespace(**{name: globals()[name] for name in _OPS})
# always the plain PyTorch version (the reference the kernels are held to)
PLAIN_OPS = SimpleNamespace(**{name: globals()[name + "_plain"]
                               for name in _OPS})
# the GSR step's ops under FCSR_MM_MODE=bf16: single-pass bf16 products
# and the rounding instances of the pool, row and bias kernels, with
# ``pool_bwd_pair_ad`` the pair of the autodiff-shaped backward
_BF16_OPS = ("bgemm", "rank_select", "gather_rows", "scatter_rows",
             "pool_bwd_pair", "add_bias")
KERNEL_OPS_BF16 = SimpleNamespace(**dict(
    vars(KERNEL_OPS), **{name: globals()[name + "_bf16"]
                         for name in _BF16_OPS},
    pool_bwd_pair_ad=pool_bwd_pair_bf16_ad))
PLAIN_OPS_BF16 = SimpleNamespace(**dict(
    vars(PLAIN_OPS), **{name: globals()[name + "_bf16_plain"]
                        for name in _BF16_OPS},
    pool_bwd_pair_ad=pool_bwd_pair_bf16_ad_plain))


def mode_ops(plain: bool = False) -> SimpleNamespace:
    """The GSR step's op namespace for ``core.mm_mode.MODE``, read at this
    call (``ValueError`` for an unknown mode): ``KERNEL_OPS`` in the
    compensated modes (IEEE fp32 products), ``KERNEL_OPS_BF16`` under
    ``bf16``; with ``plain`` the plain versions of either. The GAT path
    does not call it: its products stay fp32 in every mode."""
    from fcsr_tpu_torch.core import mm_mode
    bf16 = mm_mode.check_mode() == "bf16"
    if plain:
        return PLAIN_OPS_BF16 if bf16 else PLAIN_OPS
    return KERNEL_OPS_BF16 if bf16 else KERNEL_OPS
