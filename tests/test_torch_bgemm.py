"""The product op ``bgemm`` on the CPU (its plain version, the yardstick
the CUDA kernel is held to on the card) and the census of the products the
full-width GSR and GAT steps launch (``fcsr_tpu_torch/kernels/census.py``).

Every shape class the kernel has a path for is held to a float64 numpy
product: dense with each transpose, M = 1 (a row of ones or a real row),
N = 1, K = 1, bias, ``add`` aliasing ``out``, and operands that start
1-3 floats into a flat buffer, as the flat parameter buffers' views do.
The tolerance is the one ``chip_smoke.py`` holds the kernel to:
1e-5 x max(scale, K)."""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.kernels import KERNEL_OPS, PLAIN_OPS
from fcsr_tpu_torch.kernels.ops import BGEMM_EXTRA
from fcsr_tpu_torch.kernels.census import (Census, Product, census_of,
                                           gat_step_census, gsr_step_census,
                                           product_of, replay, vector_ready)

F = 3

# (label, launches) of every distinct product of one full-width step, in
# the order of first call (GSR-Net 160 -> 268, ks (0.9, 0.7, 0.6, 0.5);
# GAT U-Net n 160, m 268, dim 16, ks (0.5, 0.5, 0.5), 4 heads, drop_p
# 0.01): 52 + 38, "1x1x160 ones,unaligned" in both, 89 in all; the card's
# census is the same. At drop_p > 0 the GAT pools' scores and input
# adjoints are philox_drop_logits / philox_drop_outer launches, not
# products
GSR_SIGNATURES = [
    ("160x268x268 bias", 2), ("160x1x268 bias,unaligned", 1),
    ("144x268x268 bias", 1), ("144x1x268 bias,unaligned", 1),
    ("101x268x268 bias", 1), ("101x1x268 bias,unaligned", 1),
    ("61x268x268 bias", 1), ("61x1x268 bias,unaligned", 1),
    ("30x268x268 bias", 1), ("61x268x268 bias,add", 1),
    ("101x268x268 bias,add", 1), ("144x268x268 bias,add", 1),
    ("160x268x268 bias,add", 1), ("160x268x268 add", 1),
    ("268x160x160 tb", 1), ("268x268x160", 1), ("268x268x268 tb", 4),
    ("268x268x268", 4), ("268x268x268 ta", 4), ("268x268x268 tb,add", 1),
    ("268x268x268 add", 1), ("268x160x268 tb", 1),
    ("160x268x268 ta,add", 1), ("268x160x160 add", 1),
    ("268x268x160 ta", 4), ("1x268x160 ones", 4), ("160x268x268 tb", 2),
    ("160x268x268 tb,add", 2), ("268x268x144 ta", 2),
    ("1x268x144 ones", 2), ("144x268x268 tb", 2), ("268x268x101 ta", 2),
    ("1x268x101 ones", 2), ("101x268x268 tb", 2), ("268x268x61 ta", 2),
    ("1x268x61 ones", 2), ("61x268x268 tb", 2), ("268x268x30 ta", 1),
    ("1x268x30 ones", 1), ("30x268x268 tb", 1),
    ("268x1x61 ta,unaligned", 1), ("1x1x61 ones,unaligned", 1),
    ("61x268x1 tb,add,unaligned", 1), ("268x1x101 ta,unaligned", 1),
    ("1x1x101 ones,unaligned", 1), ("101x268x1 tb,add,unaligned", 1),
    ("268x1x144 ta,unaligned", 1), ("1x1x144 ones,unaligned", 1),
    ("144x268x1 tb,add,unaligned", 1), ("268x1x160 ta,unaligned", 1),
    ("1x1x160 ones,unaligned", 1), ("160x268x1 tb,add,unaligned", 1)]
GAT_SIGNATURES = [
    ("160x32x16 unaligned", 1), ("80x64x32 unaligned", 1),
    ("40x128x64 unaligned", 1),
    ("20x128x128 unaligned", 1), ("40x64x128 unaligned", 1),
    ("40x40x64 tb", 1), ("80x32x64 unaligned", 1), ("80x80x32 tb", 1),
    ("160x16x32 unaligned", 1), ("160x160x16 tb", 1),
    ("16x268x160 ta,bias,unaligned", 1), ("268x268x16 ta", 1),
    ("16x268x268", 1), ("160x268x16", 1), ("1x268x16 ones", 1),
    ("160x16x268 tb,unaligned", 1), ("160x16x160 add", 1),
    ("32x16x160 ta", 1), ("160x32x16 tb,unaligned", 1),
    ("80x32x80 add", 1), ("64x32x80 ta", 1), ("80x64x32 tb,unaligned", 1),
    ("40x64x40 add", 1), ("128x64x40 ta", 1),
    ("40x128x64 tb,unaligned", 1), ("128x128x20 ta", 1),
    ("20x128x128 tb,unaligned", 1), ("128x1x40 ta,unaligned", 1),
    ("1x1x40 ones,unaligned", 1),
    ("64x128x40 ta", 1), ("40x64x128 tb,unaligned", 1),
    ("64x1x80 ta,unaligned", 1), ("1x1x80 ones,unaligned", 1),
    ("32x64x80 ta", 1),
    ("80x32x64 tb,unaligned", 1), ("32x1x160 ta,unaligned", 1),
    ("1x1x160 ones,unaligned", 1), ("16x32x160 ta", 1)]


@pytest.fixture(scope="module")
def gsr_census():
    return gsr_step_census()


@pytest.fixture(scope="module")
def gat_census():
    return gat_step_census()


def _labels(census):
    return [(p.label(), n) for p, n in census.signatures().items()]


def test_gsr_step_census(gsr_census):
    c = gsr_census
    assert len(c.products) == c.launches["bgemm"] == 79
    # each pool ranks and gathers in one rank_select launch: 4 gather_rows
    # launches (the backward's) of the 8 before the pools were fused; the
    # backward unpools and takes the logits' adjoint in one launch a level
    assert sum(c.launches.values()) == 106
    assert c.launches["rank_select"] == c.launches["gather_rows"] == 4
    assert c.launches["scatter_rows"] == c.launches["pool_bwd_pair"] == 4
    assert "pool_logits_bwd" not in c.launches
    assert _labels(c) == GSR_SIGNATURES
    assert all(p.F == F for p in c.products)
    # skinny products: 15 column sums (4 of them N = 1), 4 logits and 4
    # weight gradients with N = 1, 4 rank-1 updates with add
    ones = [p for p in c.products if p.ones]
    assert len(ones) == 15 and sum(p.N == 1 for p in ones) == 4
    assert sum(p.N == 1 and not p.ones for p in c.products) == 8
    assert sum(p.K == 1 and p.add for p in c.products) == 4
    assert c.flops == pytest.approx(3.567807468e9, rel=1e-12)


def test_gat_step_census(gat_census):
    c = gat_census
    assert len(c.products) == c.launches["bgemm"] == 38
    assert sum(c.launches.values()) == 83              # at drop_p = 0.01
    # each pool's dropout drawn inside its scores' product and its input
    # adjoint: no philox_keep_mask launch
    assert c.launches["philox_drop_logits"] == 3
    assert c.launches["philox_drop_outer"] == 3
    assert "philox_keep_mask" not in c.launches
    assert c.launches["rank_select"] == c.launches["gather_rows"] == 3
    # the unpool forward and backward; the logits' adjoint feeds the
    # backward unpool's addend, so the two stay apart
    assert c.launches["scatter_rows"] == 6
    assert c.launches["pool_logits_bwd"] == 3
    assert "pool_bwd_pair" not in c.launches
    assert _labels(c) == GAT_SIGNATURES
    assert sum(min(p.M, p.N) == 1 or p.K == 1 for p in c.products) == 7
    assert max(p.flops for p in c.products) <= 7e6


def test_census_layouts_replay_the_signature(gsr_census, gat_census):
    """A replay with the census's layout meets the same signature, so the
    card times each signature at the alignment the step gave it."""
    g = torch.Generator().manual_seed(0)
    for census in (gsr_census, gat_census):
        for prod in census.signatures():
            ops = replay(prod, census.layouts[prod], g, "cpu")
            out = ops["add"] if ops["alias"] else None
            assert product_of(ops["a"], ops["b"], prod.ta, prod.tb,
                              bias=ops["bias"], add=ops["add"],
                              out=out) == prod


def test_census_takes_operands_as_the_kernel_is_handed_them():
    """On the CPU a plain op may return a transposed view; its kernel twin
    returns a fresh contiguous tensor, and that is what the census
    describes (so the CPU census equals the card's)."""
    b = torch.zeros(F, 64, 64)
    col_major = torch.zeros(F, 64, 64).transpose(1, 2)
    assert product_of(col_major, b) == product_of(b, b)
    assert product_of(col_major, b).aligned
    census = Census()
    census.wrap(PLAIN_OPS).bgemm(col_major, b)
    assert census.layouts[census.products[0]]["a"] == (
        (F, 64, 64), (64 * 64, 64, 1), 0)


def test_census_counts_every_op_and_passes_results_through():
    a = torch.ones(F, 5, 7)
    b = torch.ones(F, 7, 3)
    census = Census()
    ops = census.wrap(PLAIN_OPS)
    c = ops.bgemm(a, b)
    ops.bgemm(None, b)
    assert torch.equal(c, torch.full((F, 5, 3), 7.0))
    assert census.launches == {"bgemm": 2}
    assert census.flops == 2.0 * F * (5 * 3 * 7 + 1 * 3 * 7)
    assert census.bytes == 4.0 * F * ((35 + 21 + 15) + (21 + 3))
    # rows of 7 and 3 floats: no 16-byte copies
    assert census_of(lambda o: o.bgemm(a, b), KERNEL_OPS).products == [
        Product(F, 5, 3, 7, False, False, False, False, False, False)]


def test_vector_ready_follows_base_and_strides():
    flat = torch.zeros(F, 4 * 64 + 8)
    assert vector_ready(flat[:, :256].view(F, 4, 64))
    for off in (1, 2, 3):                       # 1-3 floats past 16 bytes
        assert not vector_ready(flat[:, off:off + 256].view(F, 4, 64))
    assert not vector_ready(torch.zeros(F, 4, 61))          # row stride 61
    assert vector_ready(torch.zeros(F, 1, 64)[:, :, :61])   # one row
    assert not vector_ready(torch.zeros(F, 1, 61))          # batch stride
    assert vector_ready(torch.zeros(1, 1, 61))              # one fold
    assert not vector_ready(torch.zeros(F, 61, 1))          # row stride 1
    assert vector_ready(None)


def _operand(rng, shape, offset):
    """(F, r, c) float32 view starting ``offset`` floats into a flat
    (F, P) buffer, as the step's leaf views are."""
    r, c = shape
    width = (offset + r * c + 7) // 4 * 4      # batch stride: 4-float multiple
    flat = torch.from_numpy(rng.standard_normal(
        (F, width)).astype(np.float32))
    return flat[:, offset:offset + r * c].view(F, r, c)


def _aligned(shape, offset):
    return offset == 0 and (shape[0] == 1 or shape[1] % 4 == 0)


def _want(a, b, ta, tb, bias, add, K):
    A = np.ones((F, 1, K)) if a is None else a.double().numpy()
    if ta and a is not None:
        A = A.transpose(0, 2, 1)
    B = b.double().numpy()
    if tb:
        B = B.transpose(0, 2, 1)
    c = A @ B
    if bias is not None:
        c = c + bias.double().numpy().reshape(F, 1, -1)
    if add is not None:
        c = c + add.double().numpy()
    return c


# (class, M, N, K, ta, tb, ones, bias, add aliasing out, offset of a / b)
CASES = [
    ("dense", 268, 268, 268, False, False, False, True, False, 0),
    ("dense", 160, 268, 268, False, True, False, False, False, 0),
    ("dense", 268, 268, 160, True, False, False, False, False, 0),
    ("dense", 268, 160, 268, True, True, False, False, False, 0),
    ("dense", 20, 128, 128, False, False, False, False, False, 1),
    ("dense", 160, 16, 268, False, True, False, False, False, 2),
    ("dense", 16, 268, 160, True, False, False, True, False, 3),
    ("dense add", 268, 268, 268, False, True, False, False, True, 0),
    ("dense bias add", 61, 268, 268, False, False, False, True, True, 1),
    ("M=1 ones", 1, 268, 160, False, False, True, False, False, 0),
    ("M=1 ones N=1", 1, 1, 61, False, False, True, False, False, 3),
    ("M=1 ones tb", 1, 160, 268, False, True, True, False, False, 2),
    ("M=1 row", 1, 268, 144, False, False, False, True, False, 1),
    ("M=1 row ta", 1, 268, 144, True, True, False, False, True, 0),
    ("N=1", 160, 1, 268, False, False, False, True, False, 1),
    ("N=1 ta", 268, 1, 61, True, False, False, False, False, 2),
    ("N=1 tb", 101, 1, 268, False, True, False, False, True, 3),
    ("N=1 ta tb", 268, 1, 144, True, True, False, True, False, 0),
    ("K=1 tb add", 61, 268, 1, False, True, False, False, True, 1),
    ("K=1 ta", 160, 268, 1, True, False, False, True, False, 3),
]


@pytest.mark.parametrize(
    "cls,M,N,K,ta,tb,ones,with_bias,alias,offset", CASES,
    ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-ta{int(c[4])}tb{int(c[5])}"
         f"-off{c[9]}" for c in CASES])
def test_bgemm_plain_against_float64(cls, M, N, K, ta, tb, ones, with_bias,
                                     alias, offset):
    rng = np.random.default_rng(M * 7 + N * 3 + K)
    a_shape, b_shape = (K, M) if ta else (M, K), (N, K) if tb else (K, N)
    a = None if ones else _operand(rng, a_shape, offset)
    b = _operand(rng, b_shape, (offset * 3) % 4)
    bias = torch.from_numpy(rng.standard_normal(
        (F, 1, N)).astype(np.float32)) if with_bias else None
    add = torch.from_numpy(rng.standard_normal(
        (F, M, N)).astype(np.float32)) if alias else None
    want = _want(a, b, ta, tb, bias, add, K)
    limit = 1e-5 * max(1.0, float(np.abs(want).max()), float(K))
    for ops in (PLAIN_OPS, KERNEL_OPS):       # KERNEL_OPS: plain on the CPU
        if alias:
            acc = add.clone()
            got = ops.bgemm(a, b, ta, tb, bias=bias, add=acc, out=acc)
            assert got is acc
        else:
            got = ops.bgemm(a, b, ta, tb, bias=bias)
        assert tuple(got.shape) == (F, M, N)
        assert float(np.abs(got.double().numpy() - want).max()) <= limit
    prod = product_of(a, b, ta, tb, bias=bias, add=add)
    assert (prod.M, prod.N, prod.K, prod.ones) == (M, N, K, ones)
    assert prod.aligned == ((ones or _aligned(a_shape, offset))
                            and _aligned(b_shape, (offset * 3) % 4))


def test_bgemm_extra_bindings_match_c_signatures():
    """The plan, tile-table and forced-plan entry points of ``bgemm.cu``
    and ``bgemm_bf16.cu`` are declared to ctypes with exactly their C
    parameters."""
    csrc = Path(__file__).resolve().parents[1] / "fcsr_tpu_torch" / "kernels" \
        / "csrc"
    assert {s.rsplit("_", 1)[0] for s in BGEMM_EXTRA} == {
        "fcsr_bgemm_f32", "fcsr_bgemm_bf16"}
    for symbol, argtypes in BGEMM_EXTRA.items():
        src = (csrc / ("bgemm_bf16.cu" if "_bf16_" in symbol
                       else "bgemm.cu")).read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", src,
                      re.S)
        assert m, symbol
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), symbol
        for p, t in zip(params, argtypes):
            want = (ctypes.c_void_p if "*" in p else
                    {"int": ctypes.c_int,
                     "long long": ctypes.c_longlong}[p.rsplit(" ", 1)[0]])
            assert t is want, (symbol, p)
