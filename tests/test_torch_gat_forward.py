"""The two kernels of the GAT forward: ``gat_attention`` and
``gat_pool_adj`` (``fcsr_tpu_torch/kernels/csrc/gat.cu``).

Their wrappers' host-side launch plans (``ops.gat_attention_plan``,
``ops.gat_pool_adj_plan``) on the seven layer shapes and three pools of
the shipped GAT step at the step's F = 3, at F = 1 and at the
validation's F = 56, with and without the global softmax shift, on wide
widths, against an H100's opt-in shared memory and a smaller card's:
each plan is valid, covers every row, and is the same for the same input.

Then the plain versions, which the kernels are held to on the card,
against the JAX package: ``gat_attention_plain``'s y against
``relu(fcsr_tpu.models.fused_gat._gat_layer(...))`` with the JAX
``drop_mask`` taken from the port's Philox bits, per-head and batched
softmax chain, and its alpha against a float64 recomputation
(``gat_pool_adj_plain`` against ``_symnorm`` of the gathered block is
``test_torch_gat_fused.py::test_pool_adj_matches_jax_symnorm``).

Tolerances: y within 2e-5 of its largest entry, as
``test_torch_gat_fused.py`` holds JAX values (the JAX products are
compensated bf16x3, about 2^-16 relative each, the port's IEEE fp32);
alpha within 1e-6 of float64 (fp32 softmax over at most 40 sources of
O(1) logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.models import fused_gat as jfg
from fcsr_tpu_torch.kernels.ops import (GAT_FWD_THREADS, GAT_POOL_MAX_BANDS,
                                        SMS, _gat_fwd_smem, _gat_pool_smem,
                                        gat_attention_plain,
                                        gat_attention_plan,
                                        gat_pool_adj_plan,
                                        philox_keep_mask_plain)

# shared memory a block may opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin)
# on an H100, and on a card with 99 KB of it (sm_86)
SMEMS = {"h100": 232448, "small": 101376}
# (n, heads, d_head) of the seven GAT layers of the shipped step
LAYER_SHAPES = ((160, 4, 8), (80, 4, 16), (40, 4, 32), (20, 2, 64),
                (40, 4, 16), (80, 4, 8), (160, 4, 4))
WIDE_SHAPES = ((1000, 2, 128), (4096, 1, 128), (12288, 1, 128))
FOLDS = (1, 3, 56)
# (n, k) of the step's three pools, and wide ones
POOLS = ((160, 80), (80, 40), (40, 20), (300, 129), (2000, 1000),
         (12288, 12288))
Y_TOL = 2e-5
ALPHA_TOL = 1e-6


def _pow2(x):
    return x >= 1 and x & (x - 1) == 0


def _check_fwd_plan(plan, n, hh, d, smem):
    assert 1 <= plan.rows <= n and plan.bands == -(-n // plan.rows)
    # the bands cover every row, and every band has one
    assert plan.bands * plan.rows >= n > (plan.bands - 1) * plan.rows
    assert _pow2(plan.group) and plan.group <= 32
    assert plan.group == 1 or plan.rows * d * plan.group <= GAT_FWD_THREADS
    assert plan.smem == _gat_fwd_smem(n, hh, d, plan.rows, plan.chunk) <= smem
    if plan.staged:
        assert plan.chunk == n
    else:
        assert plan.chunk % 32 == 0 and 32 <= plan.chunk < n
        assert plan.rows <= 32


@pytest.mark.parametrize("smem", sorted(SMEMS))
@pytest.mark.parametrize("shift", [False, True], ids=["head", "global"])
@pytest.mark.parametrize("F", FOLDS)
@pytest.mark.parametrize("shape", LAYER_SHAPES, ids=str)
def test_attention_plan_of_every_layer_stages_the_head(shape, F, shift,
                                                       smem):
    """Every shipped layer stages its head's h (every head's with the
    global shift) and its bands' rows of a at once, in bands of equal
    height (at most 32 rows) that make about two blocks per SM at F = 1
    and 3, more than one band per (head, fold) there."""
    n, H, d = shape
    plan = gat_attention_plan(n, H, d, F, shift, SMEMS[smem])
    _check_fwd_plan(plan, n, H if shift else 1, d, SMEMS[smem])
    assert plan.staged and plan.rows <= 32
    assert plan.bands * plan.rows - n < plan.bands      # equal heights
    if F <= 3:
        assert plan.bands > 1 and H * F * plan.bands <= 2 * SMS + H * F
    assert gat_attention_plan(n, H, d, F, shift, SMEMS[smem]) == plan


@pytest.mark.parametrize("smem", sorted(SMEMS))
@pytest.mark.parametrize("shift", [False, True], ids=["head", "global"])
@pytest.mark.parametrize("shape", WIDE_SHAPES + ((37, 3, 5), (1, 1, 4)),
                         ids=str)
def test_attention_plan_of_wide_and_odd_widths(shape, shift, smem):
    """Past what shared memory holds (d 128 from n 1000 up) the sources go
    in chunks of a multiple of 32 and bands of at most 32 rows; odd and
    tiny widths stage at once."""
    n, H, d = shape
    plan = gat_attention_plan(n, H, d, 1, shift, SMEMS[smem])
    _check_fwd_plan(plan, n, H if shift else 1, d, SMEMS[smem])
    assert plan.staged == (n < 1000)
    assert gat_attention_plan(n, H, d, 1, shift, SMEMS[smem]) == plan


def test_attention_plan_refuses_what_no_chunk_fits():
    with pytest.raises(ValueError, match="too large"):
        gat_attention_plan(12288, 4, 128, 1, True, 48 * 1024)


def _check_pool_plan(plan, n, k, smem):
    assert 1 <= plan.bands <= GAT_POOL_MAX_BANDS
    assert plan.rows == -(-k // plan.bands)
    # the bands cover every row, and every band has one
    assert plan.bands * plan.rows >= k > (plan.bands - 1) * plan.rows
    assert plan.smem == _gat_pool_smem(k) <= smem


@pytest.mark.parametrize("smem", sorted(SMEMS))
@pytest.mark.parametrize("F", FOLDS)
@pytest.mark.parametrize("pool", POOLS, ids=str)
def test_pool_plan_spreads_a_fold_over_blocks(pool, F, smem):
    """A fold's pooled rows go to bands of at least 4 rows, each block
    summing every row: more than one block per fold at F = 1 and 3, and
    within one block per SM."""
    n, k = pool
    plan = gat_pool_adj_plan(F, n, k, SMEMS[smem])
    _check_pool_plan(plan, n, k, SMEMS[smem])
    if F <= 3:
        assert plan.bands > 1
    assert plan.bands * F <= SMS or plan.bands == 1
    assert plan.rows >= 4
    assert gat_pool_adj_plan(F, n, k, SMEMS[smem]) == plan


def test_pool_plan_refuses_impossible_pools():
    """A pool of more nodes than the graph has, and one whose idx and r
    would pass the card's opt-in shared memory: k = 12 288 needs 98 304
    bytes, which a 99 KB card (101 376) holds and one byte fewer than
    that need does not."""
    with pytest.raises(ValueError, match="cannot keep"):
        gat_pool_adj_plan(3, 20, 21, SMEMS["h100"])
    with pytest.raises(ValueError, match="too large"):
        gat_pool_adj_plan(1, 12288, 12288, 64 * 1024)
    need = _gat_pool_smem(12288)
    assert need == 98304 <= SMEMS["small"]
    assert gat_pool_adj_plan(1, 12288, 12288, need).smem == need
    with pytest.raises(ValueError, match="too large"):
        gat_pool_adj_plan(1, 12288, 12288, need - 1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _layer_inputs(rng, n, H, d, k=6):
    x = rng.normal(size=(n, k)).astype(np.float32)
    w = (rng.normal(size=(k, H * d)) / np.sqrt(k)).astype(np.float32)
    # attention vectors at the model's initial scale (glorot over d): the
    # logits are O(1), as in the step
    asrc = (rng.normal(size=(H, d)) / np.sqrt(d)).astype(np.float32)
    adst = (rng.normal(size=(H, d)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(1, H * d))).astype(np.float32)
    a = rng.random((n, n)).astype(np.float32)
    a = np.triu(np.where(a < 0.3, a, 0.0), 1)
    return x, w, asrc, adst, bias, (a + a.T).astype(np.float32)


def _alpha64(h, asrc, adst, a, global_shift):
    """alpha (H, n, n) in float64 from the float32 h, written out."""
    n = h.shape[0]
    H, d = asrc.shape
    hh = h.astype(np.float64).reshape(n, H, d)
    s = np.einsum("nhd,hd->hn", hh, asrc.astype(np.float64))
    t = np.einsum("nhd,hd->hn", hh, adst.astype(np.float64))
    z = s[:, None, :] + t[:, :, None]                    # (H, i, src)
    z = np.where(z >= 0, z, 0.2 * z)
    mask = (a != 0) | np.eye(n, dtype=bool)
    logits = np.where(mask[None], z, -np.inf)
    shift = logits.max(-1, keepdims=True)
    if global_shift:
        shift = shift.max(0, keepdims=True)
    e = np.exp(logits - shift)
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("batched_chain", [False, True])
@pytest.mark.parametrize("drop_p", [0.0, 0.01, 0.3])
@pytest.mark.parametrize("shape", [(20, 2, 64), (40, 4, 32), (20, 4, 4)],
                         ids=str)
def test_attention_plain_is_the_jax_layer(rng, shape, drop_p,
                                          batched_chain):
    """y of ``gat_attention_plain`` on h = x w against relu of the JAX
    layer under the same keep mask (the batched chain takes the row's
    shift over all heads: ``global_shift``), and alpha against float64."""
    n, H, d = shape
    x, w, asrc, adst, bias, a = _layer_inputs(rng, n, H, d)
    seeds = torch.tensor([[5, -19]], dtype=torch.int32)
    mask_id = 2
    keep = None
    if drop_p > 0:
        keep = philox_keep_mask_plain(seeds, mask_id, H, n, n, drop_p)[0]
        assert 0 < float(keep.mean()) < 1 or drop_p < 0.05
    want = jax.nn.relu(jfg._gat_layer(
        jnp.asarray(w), jnp.asarray(asrc), jnp.asarray(adst),
        jnp.asarray(bias), jnp.asarray(a), jnp.asarray(x), H,
        drop_mask=None if keep is None else jnp.asarray(keep.numpy()),
        drop_p=drop_p, batched_chain=batched_chain))
    h = (_t(x) @ _t(w))[None]
    y, alpha = gat_attention_plain(h, _t(asrc)[None], _t(adst)[None],
                                   _t(bias)[None], _t(a)[None], seeds,
                                   mask_id, drop_p,
                                   global_shift=batched_chain)
    want = np.asarray(want, np.float64)
    err = float(np.abs(y[0].numpy() - want).max())
    assert err <= Y_TOL * float(np.abs(want).max()), err
    exact = _alpha64(h[0].numpy(), asrc, adst, a, batched_chain)
    err_a = float(np.abs(alpha[0].numpy() - exact).max())
    assert err_a <= ALPHA_TOL, err_a
    y_bare, none = gat_attention_plain(
        h, _t(asrc)[None], _t(adst)[None], _t(bias)[None], _t(a)[None],
        seeds, mask_id, drop_p, global_shift=batched_chain, need_alpha=False)
    assert none is None and torch.equal(y_bare, y)
