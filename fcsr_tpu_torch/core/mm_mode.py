"""The precision of the GSR step's in-kernel products (counterpart of
``fcsr_tpu/core/mosaic_mm.py``).

``MODE`` is read from ``FCSR_MM_MODE`` at import (default
``"bf16x3_concat"``); the kernels' op namespace (``kernels.ops.mode_ops``)
and the plain oracles read it at each call, so a caller or a test may set
``mm_mode.MODE``. The modes:

* ``"bf16x3_concat"`` (the default) and ``"bf16x3"``: the JAX package's
  compensated products, three bf16 passes, f32-class. The port runs IEEE
  fp32 products there (``bgemm_f32``, TF32 off), at least as accurate as a
  compensated product; ``mm`` is then ``torch.matmul``.
* ``"bf16"``: one bf16 pass per product, the mode the JAX package's bench
  runs: each operand rounded to bf16 (round to nearest even), the
  products summed in fp32 (``bgemm_bf16`` on the card, ``mm_bf16`` here).

Any other value raises ``ValueError`` at the first product. The GAT path
ignores the mode, as the JAX package's GAT kernels pin ``mm_compensated``.

``mm``, ``mm_compensated`` and ``mm_compensated3`` carry the ideal
adjoints (``torch.autograd.Function``): ``da = impl(ct, b^T)``,
``db = impl(a^T, ct)`` in the same mode, so a cotangent is rounded only as
an operand of its own product. ``mm_bf16``, ``mm_bf16x3`` and
``mm_bf16x3_concat`` are the plain formulations, emulated in fp32 as the
JAX package computes them off the TPU. All take 2-D operands or batches.
"""

from __future__ import annotations

import os

import torch

__all__ = ["MODE", "MODES", "mm", "mm_compensated", "mm_compensated3",
           "mm_bf16", "mm_bf16x3", "mm_bf16x3_concat", "check_mode",
           "round_bf16", "round_through"]

MODES = ("bf16x3_concat", "bf16", "bf16x3")
MODE = os.environ.get("FCSR_MM_MODE", "bf16x3_concat")


def check_mode() -> str:
    """``MODE``, or ``ValueError`` for a value that is none of ``MODES``:
    a mistyped mode must not select another rounding silently."""
    if MODE not in MODES:
        raise ValueError(
            f"unknown FCSR_MM_MODE={MODE!r}; expected 'bf16x3_concat', "
            "'bf16' or 'bf16x3'")
    return MODE


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (round to nearest even), in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _mT(x):
    return x.transpose(-1, -2)


def _split(x):
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def mm_bf16x3(a, b):
    """Three products of the bf16 halves, summed: a_hi b_hi + a_hi b_lo +
    a_lo b_hi."""
    a_hi, b_hi = round_bf16(a), round_bf16(b)
    a_lo, b_lo = a - a_hi, b - b_hi
    return (torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_lo, b_hi))


def mm_bf16x3_concat(a, b):
    """The same three products as one over operands concatenated along the
    contraction axis: [a_hi a_lo a_hi] [b_hi; b_hi; b_lo]."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return torch.matmul(torch.cat([a_hi, a_lo, a_hi], dim=-1),
                        torch.cat([b_hi, b_hi, b_lo], dim=-2))


def mm_bf16(a, b):
    """One bf16 pass: both operands rounded to bf16, the products summed in
    fp32 (a product of two bf16 values is exact in fp32)."""
    return torch.matmul(round_bf16(a), round_bf16(b))


class _IdealAdjoints(torch.autograd.Function):
    """``impl(a, b)`` whose adjoints are the ideal ones through ``impl``."""

    @staticmethod
    def forward(ctx, a, b, impl):
        ctx.save_for_backward(a, b)
        ctx.impl = impl
        return impl(a, b)

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        da = ctx.impl(ct, _mT(b)) if ctx.needs_input_grad[0] else None
        db = ctx.impl(_mT(a), ct) if ctx.needs_input_grad[1] else None
        return da, db, None


def mm(a, b):
    """The in-kernel product of the current ``MODE``: fp32 (IEEE, the
    compensated modes) or one bf16 pass with its ideal adjoints."""
    if check_mode() == "bf16":
        return _IdealAdjoints.apply(a, b, mm_bf16)
    return torch.matmul(a, b)


def mm_compensated(a, b):
    """Always ``mm_bf16x3_concat`` with its ideal adjoints, whatever
    ``MODE`` is."""
    return _IdealAdjoints.apply(a, b, mm_bf16x3_concat)


def mm_compensated3(a, b):
    """Always ``mm_bf16x3`` (three separate products) with its ideal
    adjoints."""
    return _IdealAdjoints.apply(a, b, mm_bf16x3)


class _RoundThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, ct):
        return round_bf16(ct)


def round_through(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a one-hot product gives it in the bf16 mode (the JAX
    package's ``mm(P, x)`` of a 0 / 1 selection ``P``): rounded to bf16,
    and its cotangent rounded too (the adjoint ``mm(P^T, ct)``)."""
    return _RoundThrough.apply(x)
