"""The pool's backward rows: ``scatter_rows`` (the unpool, and the adjoint
of the pooled rows with its scale and skip addend), ``pool_logits_bwd``
(the adjoint to the pooling logits) and ``pool_bwd_pair``, the GSR
backward's two in one launch (``fcsr_tpu_torch/kernels/csrc/
rank_select.cu``).

Their host-side launch plan (``ops.scatter_rows_plan``) at every level of
the GSR step (rows of 268) and the GAT step (rows of 32 / 64 / 128), at
F = 1, the steps' F = 3 and the GAT validation's F = 56: the bands cover
every output row, the lanes per row fit the width, 16-byte accesses only
where the width and pointers allow, and what no launch can take is
refused.

Then the plain versions, which the kernels are held to on the card: the
scatter against numpy, the pair against the two plain calls it replaces,
bit for bit, and the pair against the JAX package's per-level adjoint
(``_topk_projection`` with the products of ``_unet_bwd_math``,
``fcsr_tpu/models/fused_step.py:446-458``, at HIGHEST precision) to 1e-6.
The adjoint's inputs there are dyadic (multiples of 1/8 below 8), so its
row sums are exact in fp32 in any order and the comparison sees the
selection, the scaling and the sigmoid's derivative, not the sum order.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.models.fused_step import _topk_projection
from fcsr_tpu_torch.kernels import KERNEL_OPS, PLAIN_OPS
from fcsr_tpu_torch.kernels.ops import (ROW_MAX_LANES, ROW_MAX_THREADS,
                                        SEL_MAX_ROWS, SMS,
                                        scatter_rows_plan)

# (n, k, cols) of the GSR step's four pools and the GAT step's three
GSR_POOLS = ((160, 144, 268), (144, 101, 268), (101, 61, 268),
             (61, 30, 268))
GAT_POOLS = ((160, 80, 32), (80, 40, 64), (40, 20, 128))
FOLDS = (1, 3, 56)
# the tiny configs' pools (20 -> 18 -> 13 for GSR-Net, 20 -> 10 -> 5 GAT)
TINY_POOLS = ((20, 18, 32), (18, 13, 32), (20, 10, 4), (10, 5, 8))


@pytest.mark.parametrize("F", FOLDS)
@pytest.mark.parametrize("pool", GSR_POOLS + GAT_POOLS + TINY_POOLS,
                         ids=lambda p: "{}-{}x{}".format(*p))
def test_row_plan_of_every_level(pool, F):
    n, _, cols = pool
    plan = scatter_rows_plan(F, n, cols)
    # the bands cover every output row, and every band has one
    assert plan.bands * plan.rows >= n > (plan.bands - 1) * plan.rows
    # lanes: a power of two, the fewest that give a lane at most one
    # vector of the row, up to 4 warps
    vectors = cols // 4 if plan.vec else cols
    lanes = plan.lanes
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= ROW_MAX_LANES == 128
    assert lanes >= min(ROW_MAX_LANES, vectors)
    assert lanes == 1 or lanes < 2 * vectors
    # one pass of the block covers its band, and a warp's groups all get
    # a row
    assert plan.threads == 32 * -(-plan.rows * lanes // 32)
    assert plan.threads % lanes == 0 or lanes < 32
    assert plan.threads <= ROW_MAX_THREADS
    assert plan.rows >= min(n, 32 // lanes)
    # about one wave over the card, unless a band is at its most rows
    assert plan.bands * F <= SMS or plan.rows >= min(
        SEL_MAX_ROWS, ROW_MAX_THREADS // lanes)
    assert plan.vec is (cols % 4 == 0)
    assert plan == scatter_rows_plan(F, n, cols)


def test_row_plan_at_the_steps():
    """The GSR step's first unpool (160 rows of 268 floats, F = 3): 80
    bands of 2 rows, 4 warps a row, a lane per 16-byte vector; the GAT
    step's (rows of 32 floats): 8 lanes a row, one warp of 4 rows per
    block; the validation's (F = 56): 5 bands of 32 rows."""
    assert tuple(scatter_rows_plan(3, 160, 268)) == (80, 2, 256, 128, True)
    assert tuple(scatter_rows_plan(3, 160, 32)) == (40, 4, 32, 8, True)
    assert tuple(scatter_rows_plan(56, 160, 32)) == (5, 32, 256, 8, True)


@pytest.mark.parametrize("cols,aligned,vec,lanes", [(268, True, True, 128),
                                                    (268, False, False, 128),
                                                    (32, True, True, 8),
                                                    (32, False, False, 32),
                                                    (30, True, False, 32),
                                                    (7, True, False, 8),
                                                    (1, True, False, 1)])
def test_row_plan_takes_16_bytes_only_where_allowed(cols, aligned, vec,
                                                    lanes):
    plan = scatter_rows_plan(3, 160, cols, aligned)
    assert (plan.vec, plan.lanes) == (vec, lanes)


@pytest.mark.parametrize("F,n,cols", [(0, 160, 268), (3, 0, 268),
                                      (3, 160, 0)])
def test_row_plan_refuses_empty_shapes(F, n, cols):
    with pytest.raises(ValueError):
        scatter_rows_plan(F, n, cols)


def _slots(rng, F, n, k):
    """slot (F, n) int32: k of the n nodes kept, in a random order, the
    rest -1."""
    slot = np.full((F, n), -1, np.int32)
    for f in range(F):
        slot[f, rng.permutation(n)[:k]] = np.arange(k)
    return slot


def _dyadic(rng, *shape):
    """Multiples of 1/8 in (-8, 8): products and sums of a few hundred
    of them are exact in fp32."""
    return (rng.integers(-63, 64, shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("with_add", [False, True])
def test_scatter_rows_plain_is_the_masked_scatter(rng, with_scale,
                                                  with_add):
    F, n, k, m = 3, 20, 13, 7
    src = rng.standard_normal((F, k, m)).astype(np.float32)
    slot = _slots(rng, F, n, k)
    scale = rng.random((F, k)).astype(np.float32) if with_scale else None
    add = rng.standard_normal((F, n, m)).astype(np.float32) \
        if with_add else None
    want = np.zeros((F, n, m), np.float32)
    for f in range(F):
        for p in range(n):
            r = slot[f, p]
            if r >= 0:
                want[f, p] = src[f, r] * (scale[f, r] if with_scale
                                          else np.float32(1.0))
            if with_add:
                want[f, p] = want[f, p] + add[f, p]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = PLAIN_OPS.scatter_rows(t(src), t(slot), t(scale), t(add))
    assert torch.equal(got, torch.from_numpy(want))
    assert torch.equal(KERNEL_OPS.scatter_rows(t(src), t(slot), t(scale),
                                               t(add)), got)


@pytest.mark.parametrize("scale", [1.0 / 100.0, 1.0])
def test_pair_is_the_two_calls_it_replaces(rng, scale):
    """One call, both adjoints, each bit for bit what its own call
    returns (on the CPU the dispatching op takes the plain version)."""
    F, n, k, m = 3, 61, 30, 268
    g = torch.from_numpy(rng.standard_normal((F, k, m)).astype(np.float32))
    pre = torch.from_numpy(rng.standard_normal((F, k, m)).astype(
        np.float32))
    slot = torch.from_numpy(_slots(rng, F, n, k))
    s = torch.from_numpy(rng.random((F, n)).astype(np.float32))
    vals = torch.from_numpy(rng.random((F, k)).astype(np.float32))
    add = torch.from_numpy(rng.standard_normal((F, n, m)).astype(
        np.float32))
    want = (PLAIN_OPS.scatter_rows(g, slot, vals, add),
            PLAIN_OPS.pool_logits_bwd(g, pre, slot, s, scale))
    for ops in (PLAIN_OPS, KERNEL_OPS):
        got = ops.pool_bwd_pair(g, pre, slot, s, vals, add, scale)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a dropped node's logit adjoint is 0, its row the addend alone
    dropped = slot < 0
    assert (want[1][dropped] == 0).all()
    assert torch.equal(want[0][dropped], add[dropped])


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_level_adjoint(logits, d, g_p, k, div, g_skip):
    """The JAX package's adjoint of one pool level (``_unet_bwd_math``'s
    down/pool loop body up to the skip, without the rank-1 term of the
    pool's weights): the unpooled g_d and the logits' adjoint."""
    hi = jax.lax.Precision.HIGHEST
    s_col = jax.nn.sigmoid(logits / div)[:, None]
    proj = _topk_projection(s_col[:, 0], k)
    pre = jnp.matmul(proj, d, precision=hi)
    ks_col = jnp.matmul(proj, s_col, precision=hi)
    g_pre = g_p * ks_col
    g_ks = jnp.matmul(g_p * pre, jnp.ones((d.shape[1], 1), jnp.float32),
                      precision=hi)
    g_d = jnp.matmul(proj.T, g_pre, precision=hi)
    g_s = jnp.matmul(proj.T, g_ks, precision=hi)
    g_logits = g_s * s_col * (1.0 - s_col) * (1.0 / div)
    return g_d + g_skip, g_logits[:, 0]


@pytest.mark.parametrize("pool,div", [(p, 100.0) for p in TINY_POOLS[:2]]
                         + [(p, 1.0) for p in TINY_POOLS[2:]]
                         + [(p, 100.0) for p in GSR_POOLS[:2]]
                         + [(GAT_POOLS[0], 1.0)],
                         ids=lambda v: "{}-{}x{}".format(*v)
                         if isinstance(v, tuple) else f"div{v:g}")
def test_pair_matches_the_jax_level_adjoint(rng, pool, div):
    n, k, m = pool
    F = 2
    logits = (rng.standard_normal((F, n)) * (100.0 if div == 100 else 3.0)
              ).astype(np.float32)
    logits[:, 3:5] = logits[:, 7:8]                 # an exact tie
    d = _dyadic(rng, F, n, m)
    g_p = _dyadic(rng, F, k, m)
    g_skip = _dyadic(rng, F, n, m)
    s, idx, vals, slot, pre, _ = PLAIN_OPS.rank_select(
        torch.from_numpy(logits), k, div, src=torch.from_numpy(d))
    g_d, g_logits = PLAIN_OPS.pool_bwd_pair(
        torch.from_numpy(g_p), pre, slot, s, vals, torch.from_numpy(g_skip),
        1.0 / div)
    assert (slot < 0).any() or k == n
    for f in range(F):
        want_d, want_l = _jax_level_adjoint(
            jnp.asarray(logits[f]), jnp.asarray(d[f]), jnp.asarray(g_p[f]),
            k, div, jnp.asarray(g_skip[f]))
        np.testing.assert_allclose(g_d[f].numpy(), np.asarray(want_d),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(g_logits[f].numpy(), np.asarray(want_l),
                                   rtol=1e-6, atol=0)


# the parameters of the three C entries, in the order the wrappers pass
# them
C_PARAMS = {
    "fcsr_scatter_rows": ("src", "slot", "scale", "add", "out", "batch",
                          "n", "k", "cols", "bands", "rows", "threads",
                          "lanes", "vec", "stream"),
    "fcsr_pool_logits_bwd": ("g", "pre", "slot", "s", "out", "batch", "n",
                             "k", "cols", "scale", "bands", "rows",
                             "threads", "lanes", "vec", "stream"),
    "fcsr_pool_bwd_pair": ("g", "pre", "slot", "s", "vals", "add", "g_d",
                           "g_logits", "batch", "n", "k", "cols", "scale",
                           "bands", "rows", "threads", "lanes", "vec",
                           "stream"),
}


@pytest.mark.parametrize("symbol", sorted(C_PARAMS))
def test_row_entries_take_the_plan(symbol):
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
def test_row_kernels_match_plain_on_card(cuda_device, rng):
    """Scatter (both forms) and the pair's g_d exactly, the logits'
    adjoint to 1e-5 of the plain version (another sum order) and the
    pair's equal to the standalone launch's bits."""
    for n, k, m in GSR_POOLS + GAT_POOLS + TINY_POOLS:
        for F in (3, 56):
            dev = cuda_device
            g = torch.from_numpy(rng.standard_normal((F, k, m)).astype(
                np.float32)).to(dev)
            pre = torch.from_numpy(rng.standard_normal((F, k, m)).astype(
                np.float32)).to(dev)
            slot = torch.from_numpy(_slots(rng, F, n, k)).to(dev)
            s = torch.from_numpy(rng.random((F, n)).astype(np.float32)).to(
                dev)
            vals = torch.from_numpy(rng.random((F, k)).astype(
                np.float32)).to(dev)
            add = torch.from_numpy(rng.standard_normal((F, n, m)).astype(
                np.float32)).to(dev)
            assert torch.equal(KERNEL_OPS.scatter_rows(g, slot),
                               PLAIN_OPS.scatter_rows(g, slot))
            assert torch.equal(KERNEL_OPS.scatter_rows(g, slot, vals, add),
                               PLAIN_OPS.scatter_rows(g, slot, vals, add))
            g_d, g_l = KERNEL_OPS.pool_bwd_pair(g, pre, slot, s, vals, add)
            alone = KERNEL_OPS.pool_logits_bwd(g, pre, slot, s)
            want = PLAIN_OPS.pool_bwd_pair(g, pre, slot, s, vals, add)
            assert torch.equal(g_d, want[0])
            assert torch.equal(g_l, alone)
            torch.testing.assert_close(g_l, want[1], rtol=0,
                                       atol=1e-5 * float(
                                           want[1].abs().max()))
