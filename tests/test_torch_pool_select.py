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

The score rule: the JAX package writes ``sigmoid(logits / div)`` and runs
it jitted, where XLA computes the division by a constant as a product with
its fp32 reciprocal. The reference's scores are taken that way here
(``_jax_scores``), and every pool score of the port (``rank_select_plain``,
``GraphPool``, ``unet_forward_rankselect``) is held to
``sigmoid(logits * fl32(1 / div))`` bit for bit, on logits where the true
quotient rounds apart from that product, and at a pair of logits that tie
under the product but not under the quotient.

JAX and the JAX package load inside the tests that compare with them, so
the card test collects where they are not installed (``pytest
--noconftest -m cuda``).
"""

import functools
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch.overrides import TorchFunctionMode

from fcsr_tpu_torch.kernels import KERNEL_OPS, PLAIN_OPS
from fcsr_tpu_torch.kernels.ops import (SEL_MAX_N, SEL_MAX_ROWS,
                                        SEL_MIN_ROWS, SEL_THREADS, SMS,
                                        gather_rows_plan, rank_select_plan)
from fcsr_tpu_torch.models.fused_step import (leaf_specs,
                                              unet_forward_rankselect)
from fcsr_tpu_torch.models.gsr import GraphPool

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
    jax, jnp = _jax()
    _topk_projection = importlib.import_module(
        "fcsr_tpu.models.fused_step")._topk_projection
    j_mm = importlib.import_module("fcsr_tpu.core.mosaic_mm").mm
    n, k, cols = pool
    F = 2
    logits = _logits(rng, F, n, div)
    src = rng.standard_normal((F, n, cols)).astype(np.float32)
    s, idx, vals, slot, pre, x = PLAIN_OPS.rank_select(
        torch.from_numpy(logits), k, div, src=torch.from_numpy(src))
    assert pre.shape == x.shape == (F, k, cols)
    for f in range(F):
        sj = _jax_scores(jnp.asarray(logits[f]), div)
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


def _jax():
    """(jax, jax.numpy), imported by the tests that compare with JAX."""
    return importlib.import_module("jax"), importlib.import_module("jax.numpy")


@functools.lru_cache(maxsize=None)
def _jitted():
    """The reference's pool scores and kept nodes, each jitted once."""
    jax, jnp = _jax()
    _topk_projection = importlib.import_module(
        "fcsr_tpu.models.fused_step")._topk_projection

    def scores(logits, div):
        return jax.nn.sigmoid(logits / div)

    def kept(logits, k):
        return jnp.argmax(_topk_projection(jax.nn.sigmoid(logits / 100.0),
                                           k), axis=1)
    return (jax.jit(scores, static_argnums=1),
            jax.jit(kept, static_argnums=1))


def _jax_scores(logits, div):
    """The reference's pool scores as its jitted code computes them
    (``fcsr_tpu/models/gsr.py:88``, ``fused_step.py:381``)."""
    return _jitted()[0](logits, div)


def _jax_kept(logits, k):
    """The nodes GSR-Net's pool keeps, by the jitted reference: the
    one-hot projection's rows (``_topk_projection``) as indices."""
    return _jitted()[1](logits, k)


def test_reference_divides_by_the_fp32_reciprocal(rng):
    """Jitted ``x / 100.0`` is ``x * fl32(0.01)``, not the true quotient,
    which rounds apart on a share of the entries."""
    jax, jnp = _jax()
    x = (rng.standard_normal(100_000) * 300.0).astype(np.float32)
    jitted = np.asarray(jax.jit(lambda a: a / 100.0)(x))
    np.testing.assert_array_equal(jitted, x * np.float32(0.01))
    assert (jitted != x / np.float32(100.0)).mean() > 0.05
    # and so the scores of the reference's pool
    np.testing.assert_array_equal(
        np.asarray(_jax_scores(jnp.asarray(x), 100.0)),
        np.asarray(jax.jit(jax.nn.sigmoid)(x * np.float32(0.01))))


def _rule_scores(logits, div):
    """sigmoid(logits * fl32(1 / div)) and sigmoid(logits / div) (the true
    quotient), by torch on the CPU."""
    lg = np.asarray(logits, np.float32)
    r = np.float32(1.0) / np.float32(div)
    return (torch.sigmoid(torch.from_numpy(lg * r)),
            torch.sigmoid(torch.from_numpy(lg / np.float32(div))))


# torch's CPU sigmoid takes a vectorised path in blocks of 16-64 floats
# and a scalar one for the rest, whose bits may differ: the score tests
# use rows of 64, which take the vectorised path whole, row by row or
# as one (F, 64) tensor
ROW = 64


@functools.lru_cache(maxsize=None)
def _apart_logits(F, n=ROW, seed=7):
    """(F, n) logits at GSR-Net's scale whose scores differ under the two
    rules, every one of them."""
    rng = np.random.default_rng(seed)
    cand = (rng.standard_normal(40 * F * n) * 300.0).astype(np.float32)
    prod, true = _rule_scores(cand, 100.0)
    apart = cand[(prod != true).numpy()]
    assert apart.size >= F * n
    return apart[:F * n].reshape(F, n)


@functools.lru_cache(maxsize=None)
def _boundary_pair():
    """Two logits a < b that tie under the product (the same score) but
    not under the true quotient, where b scores higher."""
    start = np.float32(500.0).view(np.int32)
    a = -np.arange(start, start + 200_000, dtype=np.int32).view(np.float32)
    b = np.nextafter(a, np.float32(0.0))         # the next one up
    pa, ta = _rule_scores(a, 100.0)
    pb, tb = _rule_scores(b, 100.0)
    hit = np.flatnonzero(((pa == pb) & (tb > ta)).numpy())
    assert hit.size
    return float(a[hit[0]]), float(b[hit[0]])


class _Sigmoids(TorchFunctionMode):
    """Records the output of every ``torch.sigmoid`` call under it."""

    def __init__(self):
        super().__init__()
        self.out = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        result = func(*args, **(kwargs or {}))
        if func is torch.sigmoid:
            self.out.append(result)
        return result


def _graph_pool(k):
    """GraphPool on 2 features whose score logits are feature 0 exactly."""
    pool = GraphPool(k, 2, torch.Generator().manual_seed(0))
    with torch.no_grad():
        pool.proj.weight.copy_(torch.tensor([[1.0, 0.0]]))
        pool.proj.bias.zero_()
    return pool


def graph_pool_scores(logits, k):
    """(scores, kept indices) of GraphPool for each row of (F, n) logits:
    the features are (logit, 1)."""
    pool, scores, kept = _graph_pool(k), [], []
    for row in torch.as_tensor(logits):
        x = torch.stack([row, torch.ones_like(row)], 1)
        adj = torch.eye(len(row))
        with torch.no_grad(), _Sigmoids() as rec:
            kept.append(pool(adj, x)[2])
        scores.append(rec.out[0])
    return torch.stack(scores), torch.stack(kept)


def rankselect_scores(logits, k):
    """The first level's scores of ``unet_forward_rankselect`` for (F, n)
    logits, through one level on 2 features whose pool logits are the
    given ones exactly (identity start, down and pool weights)."""
    lg = torch.as_tensor(logits)
    F, n = lg.shape
    W = {name: torch.zeros((F,) + shape)
         for name, shape in leaf_specs(n, 2, 1)}
    W["w:start_gcn"][..., 0] = lg
    W["w:start_gcn"][..., 1] = 1.0
    W["w:down_gcns_0"][:] = torch.eye(2)
    W["w:pools_0"][:, 0, 0] = 1.0
    with torch.no_grad(), _Sigmoids() as rec:
        unet_forward_rankselect(W, (k / n,), n)
    return rec.out[0]


SCORE_PATHS = {
    "rank_select_plain": lambda lg, k: PLAIN_OPS.rank_select(lg, k)[0],
    "GraphPool": lambda lg, k: graph_pool_scores(lg, k)[0],
    "unet_forward_rankselect": rankselect_scores,
}


@pytest.mark.parametrize("path", sorted(SCORE_PATHS))
def test_pool_scores_multiply_by_the_fp32_reciprocal(path):
    logits = _apart_logits(3)
    want, true = _rule_scores(logits, 100.0)
    assert (want != true).all()
    got = SCORE_PATHS[path](torch.from_numpy(logits), 48)
    assert torch.equal(got, want), path


def test_gat_pool_scores_stay_the_sigmoid(rng):
    """At div 1 (the GAT U-Net) the rule multiplies by 1: the scores are
    the sigmoid of the logits themselves, as before the rule."""
    logits = torch.from_numpy(_logits(rng, 3, 80, 1.0))
    s = PLAIN_OPS.rank_select(logits, 40, 1.0)[0]
    assert torch.equal(s, torch.sigmoid(logits))


def test_boundary_pair_keeps_the_node_jax_keeps():
    """a at node 2 and b at node 5 tie under the product, so the lower
    index is kept, as jitted JAX keeps it; under the true quotient b
    would win the last place."""
    _, jnp = _jax()
    a, b = _boundary_pair()
    logits = np.full((1, ROW), -2000.0, np.float32)    # far below
    logits[0, [0, 1, 4]] = (100.0, 90.0, 80.0)         # far above
    logits[0, 2], logits[0, 5] = a, b
    k = 4                                              # 3 above, a or b
    want = np.asarray(_jax_kept(jnp.asarray(logits[0]), k))
    np.testing.assert_array_equal(want, [0, 1, 4, 2])
    idx = PLAIN_OPS.rank_select(torch.from_numpy(logits), k)[1]
    np.testing.assert_array_equal(idx[0].numpy(), want)
    np.testing.assert_array_equal(
        graph_pool_scores(torch.from_numpy(logits), k)[1][0].numpy(), want)


def _np_pool(logits, k, div, src):
    """The pool by its documented rule in numpy: NaN scores as -inf, a
    stable descending order (ties to the lower index)."""
    s = (1.0 / (1.0 + np.exp(-(logits.astype(np.float64)
                                * np.float32(1.0 / div))))).astype(np.float32)
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
def test_pool_kernel_matches_plain_on_card(cuda_device, div):
    """The kernel against the plain version on the card's tensors: the
    CPU's sigmoid rounds apart from the card's in the last bit, and a
    score one ulp apart can change which of two near-tied nodes is kept."""
    rng = np.random.default_rng(42)
    for n, k, cols in GSR_POOLS + GAT_POOLS + TINY_POOLS:
        for F in (3, 56):
            logits = torch.from_numpy(_logits(rng, F, n, div))
            logits[0, 1] = float("nan")
            src = torch.from_numpy(rng.standard_normal((F, n, cols)).astype(
                np.float32))
            want = [t.cpu() for t in PLAIN_OPS.rank_select(
                logits.to(cuda_device), k, div, src=src.to(cuda_device))]
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
