"""The pool as one launch: ``rank_select`` (scores, ranks and, given the
source rows, the gathered and scaled rows) and the backward's banded
``gather_rows`` (``fcsr_tpu_torch/kernels/csrc/rank_select.cu``).

Their host-side launch plans (``ops.rank_select_plan``,
``ops.gather_rows_plan``) at every pool shape of the GSR step (160 -> 144
-> 101 -> 61 -> 30, rows of 268) and of the GAT step (160 -> 80 -> 40 ->
20, rows of 32 / 64 / 128), at F = 1, the steps' F = 3 and the GAT
validation's F = 56: each plan is valid, covers every kept row, and a
plan the card cannot run is refused.

Then the plain pool, which the kernel is held to on the card, against the
JAX package's one-hot projection (``fcsr_tpu/models/fused_step.py::
_topk_projection``) and the products the TPU kernel forms with it,
``pre = P @ d`` and ``x = (P @ d) * (P @ s)``: indices and slots exactly,
rows to 1e-6 relative (a one-hot product in full fp32 is exact; the TPU
kernel's own compensated bf16x3 product keeps 2^-17 of each entry).
Inputs come from a numpy seed, with exact ties, at div 100 (GSR-Net) and
1 (the GAT U-Net). NaN scores sort last and the ranks stay a permutation,
against an independent numpy version of that rule.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.core.mosaic_mm import mm as j_mm
from fcsr_tpu.models.fused_step import _topk_projection
from fcsr_tpu_torch.kernels import KERNEL_OPS, PLAIN_OPS
from fcsr_tpu_torch.kernels.ops import (SEL_MAX_N, SEL_MAX_ROWS,
                                        SEL_MIN_ROWS, SEL_THREADS, SMS,
                                        gather_rows_plan, rank_select_plan)

# shared memory a block may opt in to on an H100
SMEM = 232448
# (n, k, cols) of the GSR step's four pools and the GAT step's three
GSR_POOLS = ((160, 144, 268), (144, 101, 268), (101, 61, 268),
             (61, 30, 268))
GAT_POOLS = ((160, 80, 32), (80, 40, 64), (40, 20, 128))
FOLDS = (1, 3, 56)
# the tiny configs' pools (20 -> 18 -> 13 for GSR-Net, 20 -> 10 -> 5 GAT)
TINY_POOLS = ((20, 18, 32), (18, 13, 32), (20, 10, 4), (10, 5, 8))


def _pow2(x):
    return x >= 1 and x & (x - 1) == 0


@pytest.mark.parametrize("F", FOLDS)
@pytest.mark.parametrize("pool", GSR_POOLS + GAT_POOLS,
                         ids=lambda p: "{}-{}x{}".format(*p))
def test_select_plan_of_every_pool(pool, F):
    n, k, cols = pool
    plan = rank_select_plan(F, n, k, cols, SMEM)
    # the bands cover every kept row, and every band has one
    assert plan.bands * plan.rows >= k > (plan.bands - 1) * plan.rows
    assert min(k, SEL_MIN_ROWS) <= plan.rows <= SEL_MAX_ROWS
    # about one wave over the card, unless a band is at its most rows
    assert plan.bands * F <= SMS or plan.rows == SEL_MAX_ROWS
    assert plan.threads == SEL_THREADS and plan.threads % 32 == 0
    assert _pow2(plan.lanes) and plan.lanes <= 32
    # keys and scores over n rounded up to 4, the kept nodes and scores
    assert plan.smem == 4 * (2 * (-(-n // 4) * 4) + 2 * k) <= 48 * 1024
    assert plan.vec                      # every step's rows are 4-aligned
    assert plan == rank_select_plan(F, n, k, cols, SMEM)
    g = gather_rows_plan(F, k, cols)
    assert (g.bands, g.rows, g.vec) == (plan.bands, plan.rows, plan.vec)
    assert g.threads == 32 * min(plan.rows, 8)


@pytest.mark.parametrize("n,lanes", [(160, 2), (144, 2), (101, 4), (61, 4),
                                     (80, 4), (40, 4), (20, 4), (300, 1),
                                     (1024, 1)])
def test_rank_lanes_shorten_the_compare_chain(n, lanes):
    """A node's compares are split over as many lanes as still cover every
    node in one pass, up to 4: one pass up to n = 512."""
    plan = rank_select_plan(3, n, n // 2, 268, SMEM)
    assert plan.lanes == lanes and 32 % plan.lanes == 0
    assert n * plan.lanes <= plan.threads or n > plan.threads


def test_select_plan_at_the_step_pool():
    """160 -> 144 at F = 3: 36 bands of 4 rows, 108 blocks of 512
    threads, two lanes per node."""
    plan = rank_select_plan(3, 160, 144, 268, SMEM)
    assert (plan.bands, plan.rows, plan.threads, plan.lanes, plan.vec) == \
        (36, 4, 512, 2, True)


@pytest.mark.parametrize("cols,aligned,vec", [(268, True, True),
                                              (268, False, False),
                                              (30, True, False),
                                              (1, True, False)])
def test_select_plan_takes_16_bytes_only_where_allowed(cols, aligned, vec):
    assert rank_select_plan(3, 160, 144, cols, SMEM, aligned).vec is vec
    assert gather_rows_plan(3, 144, cols, aligned).vec is vec


def test_select_plan_without_rows_ranks_in_one_band():
    plan = rank_select_plan(3, 160, 144, 0, SMEM)
    assert (plan.bands, plan.rows, plan.vec) == (1, 144, False)


@pytest.mark.parametrize("n,k,smem", [(SEL_MAX_N + 1, 10, SMEM),
                                      (160, 0, SMEM), (160, 161, SMEM),
                                      (160, 144, 2000)])
def test_select_plan_refuses_what_the_card_cannot_run(n, k, smem):
    with pytest.raises(ValueError):
        rank_select_plan(3, n, k, 268, smem)


def test_select_plan_at_its_widest():
    plan = rank_select_plan(1, SEL_MAX_N, SEL_MAX_N, 268, SMEM)
    assert plan.smem == 16 * 1024 and plan.bands * plan.rows >= SEL_MAX_N


def _logits(rng, F, n, div):
    """Scores spread over the sigmoid's range, with exact ties."""
    logits = (rng.standard_normal((F, n)) * (100.0 if div == 100 else 3.0)
              ).astype(np.float32)
    logits[:, 3:7] = logits[:, 9:10]                 # a 5-way tie
    logits[:, n - 1] = logits[:, 0]                  # a tie across the row
    return logits


@pytest.mark.parametrize("div", [100.0, 1.0])
@pytest.mark.parametrize("pool", TINY_POOLS + GSR_POOLS[:2] + GAT_POOLS[:1],
                         ids=lambda p: "{}-{}x{}".format(*p))
def test_pool_matches_topk_projection_products(rng, pool, div):
    n, k, cols = pool
    F = 2
    logits = _logits(rng, F, n, div)
    src = rng.standard_normal((F, n, cols)).astype(np.float32)
    s, idx, vals, slot, pre, x = PLAIN_OPS.rank_select(
        torch.from_numpy(logits), k, div, src=torch.from_numpy(src))
    assert pre.shape == x.shape == (F, k, cols)
    for f in range(F):
        sj = jax.nn.sigmoid(jnp.asarray(logits[f]) / div)
        proj = _topk_projection(sj, k)
        np.testing.assert_allclose(s[f].numpy(), np.asarray(sj), rtol=1e-6)
        np.testing.assert_array_equal(idx[f].numpy(),
                                      np.asarray(proj).argmax(axis=1))
        want_slot = np.full(n, -1)
        want_slot[np.asarray(proj).argmax(axis=1)] = np.arange(k)
        np.testing.assert_array_equal(slot[f].numpy(), want_slot)
        hi = jax.lax.Precision.HIGHEST
        pre_j = jnp.matmul(proj, jnp.asarray(src[f]), precision=hi)
        kscol = jnp.matmul(proj, sj[:, None], precision=hi)
        np.testing.assert_allclose(pre[f].numpy(), np.asarray(pre_j),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(x[f].numpy(),
                                   np.asarray(pre_j * kscol), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(vals[f].numpy(),
                                   np.asarray(kscol[:, 0]), rtol=1e-6)
        # the TPU kernel's own product (compensated bf16x3: d_hi + d_lo)
        np.testing.assert_allclose(
            pre[f].numpy(), np.asarray(j_mm(proj, jnp.asarray(src[f]))),
            rtol=2.0 ** -17, atol=0)


def _np_pool(logits, k, div, src):
    """The pool by its documented rule in numpy: NaN scores as -inf, a
    stable descending order (ties to the lower index)."""
    s = (1.0 / (1.0 + np.exp(-(logits.astype(np.float64) / div)))
         ).astype(np.float32)
    key = np.where(np.isnan(s), -np.inf, s)
    idx = np.stack([np.argsort(-key[f], kind="stable")[:k]
                    for f in range(len(s))])
    slot = np.full(s.shape, -1)
    for f in range(len(s)):
        slot[f, idx[f]] = np.arange(k)
    vals = np.take_along_axis(s, idx, 1)
    pre = np.take_along_axis(src, idx[..., None], 1)
    return s, idx, vals, slot, pre, pre * vals[..., None]


@pytest.mark.parametrize("k", [3, 10, 13])
def test_nan_scores_sort_last_and_ranks_stay_a_permutation(rng, k):
    F, n, cols = 3, 13, 8                       # n not a multiple of 4
    logits = _logits(rng, F, n, 100.0)
    logits[0, [2, 5, 11]] = np.nan
    logits[1, :] = np.nan                       # every score NaN
    logits[2, 0] = np.nan
    src = rng.standard_normal((F, n, cols)).astype(np.float32)
    got = PLAIN_OPS.rank_select(torch.from_numpy(logits), k,
                                src=torch.from_numpy(src))
    want = _np_pool(logits, k, 100.0, src)
    for name, a, b in zip(("s", "idx", "vals", "slot", "pre", "x"), got,
                          want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, err_msg=name)
    idx, slot = got[1].numpy(), got[3].numpy()
    for f in range(F):
        assert len(set(idx[f])) == k and ((0 <= idx[f]) & (idx[f] < n)).all()
        assert sorted(slot[f][slot[f] >= 0]) == list(range(k))
        nan = np.isnan(logits[f])
        # a NaN node is kept only once every finite one is
        kept_nan = nan[idx[f]]
        assert not kept_nan.any() or (~nan).sum() < k
        assert not (kept_nan[:-1] & ~kept_nan[1:]).any()
    # the all-NaN fold keeps the lowest indices, in order
    np.testing.assert_array_equal(idx[1], np.arange(k))


def test_pool_is_rank_select_then_gather(rng):
    """The one call returns what the two calls it replaced returned."""
    logits = torch.from_numpy(_logits(rng, 3, 61, 100.0))
    src = torch.from_numpy(rng.standard_normal((3, 61, 12)).astype(
        np.float32))
    fused = KERNEL_OPS.rank_select(logits, 30, src=src)
    s, idx, vals, slot = KERNEL_OPS.rank_select(logits, 30)
    pre, x = KERNEL_OPS.gather_rows(src, idx, vals)
    for a, b in zip(fused, (s, idx, vals, slot, pre, x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cols", [1, 30, 268])
def test_gather_rows_is_take_along_dim(rng, cols):
    src = torch.from_numpy(rng.standard_normal((3, 160, cols)).astype(
        np.float32))
    idx = torch.from_numpy(np.stack([rng.permutation(160)[:144]
                                     for _ in range(3)]).astype(np.int32))
    idx64 = idx.long()
    assert torch.equal(KERNEL_OPS.gather_rows(src, idx),
                       torch.take_along_dim(src, idx64[..., None], 1))


# the parameters of the two C entries, in the order the wrappers pass them
C_PARAMS = {
    "fcsr_rank_select": ("logits", "src", "s", "idx", "vals", "slot", "pre",
                         "x", "batch", "n", "k", "cols", "div", "bands",
                         "rows", "threads", "lanes", "vec", "stream"),
    "fcsr_gather_rows": ("src", "idx", "scale", "out", "out_scaled",
                         "batch", "n_src", "k", "cols", "bands", "rows",
                         "threads", "vec", "stream"),
}


@pytest.mark.parametrize("symbol", sorted(C_PARAMS))
def test_pool_entries_take_the_plan(symbol):
    src = (Path(__file__).resolve().parents[1] / "fcsr_tpu_torch" / "kernels"
           / "csrc" / "rank_select.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", src, re.S)
    names = tuple(p.strip().rsplit(" ", 1)[1].lstrip("*")
                  for p in m.group(1).split(","))
    assert names == C_PARAMS[symbol]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("div", [100.0, 1.0])
def test_pool_kernel_matches_plain_on_card(cuda_device, rng, div):
    for n, k, cols in GSR_POOLS + GAT_POOLS + TINY_POOLS:
        for F in (3, 56):
            logits = torch.from_numpy(_logits(rng, F, n, div))
            logits[0, 1] = float("nan")
            src = torch.from_numpy(rng.standard_normal((F, n, cols)).astype(
                np.float32))
            want = PLAIN_OPS.rank_select(logits, k, div, src=src)
            got = KERNEL_OPS.rank_select(logits.to(cuda_device), k, div,
                                         src=src.to(cuda_device))
            for name, a, b in zip(("s", "idx", "vals", "slot", "pre", "x"),
                                  got, want):
                if name == "s":
                    torch.testing.assert_close(a.cpu(), b, rtol=1e-6,
                                               atol=0, equal_nan=True)
                else:
                    assert torch.equal(a.cpu().isnan(), b.isnan()), name
                    assert torch.equal(a.cpu().nan_to_num(),
                                       b.nan_to_num()), name
            g = KERNEL_OPS.gather_rows(src.to(cuda_device), got[1])
            assert torch.equal(g.cpu(), want[4])
