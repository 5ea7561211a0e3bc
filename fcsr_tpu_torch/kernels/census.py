"""Census of a path's kernel calls: every ``bgemm`` call's signature, and
the launches, FLOPs and bytes of every op the path calls.

A path written over an op namespace (the GSR step, the GAT step) runs
unchanged through ``Census.wrap(ops)``, a copy of the namespace whose
every op is counted. FLOPs are 2 M N K per product and fold; bytes are
each op's tensor inputs read once and its outputs written once.

``gsr_step_census`` and ``gat_step_census`` run one fold-batched training
step of each family (full width by default) on seeded random weights and
return its census: the product signatures do not depend on the values.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fcsr_tpu_torch.kernels.ops import rows_contiguous

__all__ = ["Product", "product_of", "vector_ready", "Census", "census_of",
           "replay", "gsr_step_census", "gat_step_census"]


@dataclass(frozen=True)
class Product:
    """One product's signature: ``op(a) (M x K) @ op(b) (K x N)`` over F
    folds; ``ones``: ``a`` is a row of ones; ``aligned``: both stored
    operands allow 16-byte copies (base, row and batch strides)."""
    F: int
    M: int
    N: int
    K: int
    ta: bool
    tb: bool
    ones: bool
    bias: bool
    add: bool
    aligned: bool

    @property
    def flops(self) -> float:
        return 2.0 * self.F * self.M * self.N * self.K

    @property
    def nbytes(self) -> float:
        """Each input read once and the output written once (fp32)."""
        words = self.N * self.K + (0 if self.ones else self.M * self.K) \
            + self.M * self.N * (2 if self.add else 1) \
            + (self.N if self.bias else 0)
        return 4.0 * self.F * words

    def label(self) -> str:
        extra = [name for name, on in (("ones", self.ones), ("ta", self.ta),
                                       ("tb", self.tb), ("bias", self.bias),
                                       ("add", self.add)) if on]
        if not self.aligned:
            extra.append("unaligned")
        return f"{self.M}x{self.N}x{self.K}" + (
            " " + ",".join(extra) if extra else "")


def vector_ready(t: Optional[torch.Tensor]) -> bool:
    """Whether the product kernel may copy the stored operand ``t`` (F,
    rows, cols) in 16-byte vectors: base 16-byte aligned, row stride and
    batch stride multiples of 4 floats (a stride of a size-1 axis is never
    used). ``None`` (the row of ones) needs no copy."""
    if t is None:
        return True
    return (t.data_ptr() % 16 == 0
            and (t.shape[1] == 1 or t.stride(1) % 4 == 0)
            and (t.shape[0] == 1 or t.stride(0) % 4 == 0))


def _as_handed(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` as the product kernel is handed it. The card's operands all
    have contiguous rows (``ops.bgemm`` checks); on the CPU an operand
    without them is the output of a plain op whose kernel returns a fresh
    contiguous tensor, so it counts as that."""
    return None if t is None else rows_contiguous(t)


def product_of(a, b, ta=False, tb=False, bias=None, add=None,
               out=None, bias_operand=False) -> Product:
    """The signature of ``ops.bgemm(a, b, ta, tb, bias, add, out)`` (or of
    ``bgemm_bf16``'s)."""
    a, b = _as_handed(a), _as_handed(b)
    K, N = (b.shape[2], b.shape[1]) if tb else (b.shape[1], b.shape[2])
    M = 1 if a is None else (a.shape[2] if ta else a.shape[1])
    return Product(int(b.shape[0]), int(M), int(N), int(K), bool(ta),
                   bool(tb), a is None, bias is not None, add is not None,
                   vector_ready(a) and vector_ready(b))


def _layout(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), tuple(t.stride()),
                                   int(t.storage_offset()))


def _layout_of(a, b, ta=False, tb=False, bias=None, add=None, out=None,
               bias_operand=False):
    """(shape, stride, storage offset) of the stored ``a`` and ``b``, and
    whether ``add`` is ``out``: enough to replay the call's alignment."""
    return {"a": _layout(_as_handed(a)), "b": _layout(_as_handed(b)),
            "alias": add is not None and add is out}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(t) for t in x)
    return 0


class Census:
    """Launches, FLOPs and bytes of every op called through ``wrap(ops)``,
    and each product's signature in call order."""

    def __init__(self):
        self.products: List[Product] = []
        # per signature, the stored layout of its first call's operands
        self.layouts: Dict[Product, dict] = {}
        self.launches: Dict[str, int] = {}
        self.flops = 0.0
        self.bytes = 0.0

    def wrap(self, ops: SimpleNamespace) -> SimpleNamespace:
        def counted(name, fn):
            def call(*a, **kw):
                ins = _nbytes(list(a)) + _nbytes(
                    [v for k, v in kw.items() if k != "out"])
                if name == "bgemm":
                    prod = product_of(*a, **kw)
                    self.products.append(prod)
                    self.flops += prod.flops
                    if prod not in self.layouts:
                        self.layouts[prod] = _layout_of(*a, **kw)
                out = fn(*a, **kw)
                self.bytes += ins + _nbytes(out)
                self.launches[name] = self.launches.get(name, 0) + 1
                return out
            return call
        return SimpleNamespace(**{k: counted(k, v)
                                  for k, v in vars(ops).items()})

    def signatures(self) -> Dict[Product, int]:
        """Distinct product signatures with their call counts, in the
        order of first call."""
        out: Dict[Product, int] = {}
        for p in self.products:
            out[p] = out.get(p, 0) + 1
        return out


def census_of(run: Callable[[SimpleNamespace], object],
              ops: SimpleNamespace) -> Census:
    """The census of ``run(counted ops)``."""
    census = Census()
    run(census.wrap(ops))
    return census


def replay(prod: Product, layout: dict, generator: torch.Generator,
           device) -> dict:
    """Random operands of one census signature: ``a`` and ``b`` with the
    (shape, stride, storage offset) its first call had, so they meet the
    same alignment, fresh ``bias`` (F, 1, N) and ``add`` (F, M, N) where
    the signature has them, and ``alias``: whether the call wrote its
    result into ``add``."""
    def operand(lay):
        if lay is None:
            return None
        shape, stride, offset = lay
        size = offset + sum((n - 1) * st for n, st in zip(shape, stride)) + 1
        return torch.randn(size, generator=generator,
                           device=device).as_strided(shape, stride, offset)

    def fresh(on, *shape):
        return torch.randn(*shape, generator=generator,
                           device=device) if on else None

    return {"a": operand(layout["a"]), "b": operand(layout["b"]),
            "bias": fresh(prod.bias, prod.F, 1, prod.N),
            "add": fresh(prod.add, prod.F, prod.M, prod.N),
            "alias": layout["alias"]}


def _rand(rng, *shape, scale=1.0, device="cpu"):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)


def gsr_step_census(device="cpu", F: int = 3, lr_dim: int = 160,
                    hr_dim: int = 268,
                    ks: Sequence[float] = (0.9, 0.7, 0.6, 0.5),
                    ops: Optional[SimpleNamespace] = None,
                    seed: int = 0) -> Census:
    """The census of one GSR-Net ``train_step_fused`` step (F folds, the
    ``fused_adam`` path) on seeded random weights and data."""
    from fcsr_tpu_torch.kernels.ops import KERNEL_OPS
    from fcsr_tpu_torch.models.fused_step import FlatLayout, step_with_ops

    rng = np.random.default_rng(seed)
    n_p = FlatLayout(lr_dim, hr_dim, len(ks)).size
    p = _rand(rng, F, n_p, scale=0.05, device=device)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    u_lr = _rand(rng, F, lr_dim, lr_dim, scale=0.1, device=device)
    u_hr = _rand(rng, F, hr_dim, lr_dim, scale=0.1, device=device)
    hr = _rand(rng, F, hr_dim, hr_dim, device=device).abs()
    scal = torch.tensor([[1.0, 0.1, 0.001]] * F, device=device)
    return census_of(lambda o: step_with_ops(
        o, p, m, v, u_lr, u_hr, hr, scal, tuple(ks), lr_dim, hr_dim, 16.0,
        1e-4, 0.9, 0.999, 1e-8), ops or KERNEL_OPS)


def gat_step_census(device="cpu", F: int = 3, n_nodes: int = 160,
                    m_nodes: int = 268, dim: int = 16,
                    ks: Sequence[float] = (0.5, 0.5, 0.5), heads: int = 4,
                    drop_p: float = 0.01,
                    ops: Optional[SimpleNamespace] = None,
                    seed: int = 0) -> Census:
    """The census of one GAT U-Net ``gat_train_step_fused`` step (F folds,
    the shipped width by default) on seeded random weights and data."""
    from fcsr_tpu_torch.kernels.ops import KERNEL_OPS
    from fcsr_tpu_torch.models.fused_gat import GATLayout, _step_with_ops

    rng = np.random.default_rng(seed)
    n_p = GATLayout(dim, tuple(ks), heads, n_nodes, m_nodes).size
    p = _rand(rng, F, n_p, scale=0.1, device=device)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    a0 = _rand(rng, F, n_nodes, n_nodes, scale=0.1, device=device).abs()
    a0 = 0.5 * (a0 + a0.transpose(1, 2))
    x0 = _rand(rng, F, n_nodes, dim, device=device)
    hr = _rand(rng, F, m_nodes, m_nodes, device=device).abs()
    scal = torch.tensor([[1.0, 1e-3, 0.1, 0.001]] * F, device=device)
    seeds = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(F, 2),
                                          dtype=np.int64).astype(np.int32)
                             ).to(device)
    return census_of(lambda o: _step_with_ops(
        o, p, m, v, a0, x0, hr, scal, seeds, 0.9, 0.999, 1e-8, 0.01,
        dim=dim, ks=tuple(ks), n_nodes=n_nodes, m_nodes=m_nodes, heads=heads,
        drop_p=drop_p), ops or KERNEL_OPS)
