"""The two cluster kernels of the GAT step: ``gat_attention_bwd`` and the
off-diagonal losses ``offdiag_mse`` / ``offdiag_mae``
(``fcsr_tpu_torch/kernels/csrc/gat.cu``).

Their wrappers' host-side launch plans (``ops.gat_attention_bwd_plan``,
``ops.offdiag_plan``) on the seven layer shapes of the shipped GAT step,
on the step's and the validation's loss sizes, on widths not divisible by
4 and on wide ones, against an H100's opt-in shared memory and a smaller
card's: each plan is valid and the same for the same input.

Then the plain versions, which the kernels are held to on the card,
against the JAX package: ``gat_attention_bwd_plain`` composed with the
projection's two products against ``jax.vjp`` of
``relu(fcsr_tpu.models.fused_gat._gat_layer(...))`` with the JAX
``drop_mask`` taken from the port's Philox bits, per-head and batched
softmax chain; ``offdiag_mse_plain``'s value and ``gsym @ X`` against
``jax.value_and_grad`` of ``_offdiag_mse(relu(X X^T), T)``.

Tolerances: against JAX, a gradient within 2e-5 of the largest entry of
the layer's whole gradient, as ``test_torch_gat_fused.py`` holds JAX
gradients: the JAX products are compensated bf16x3 (about 2^-16 relative
each, the port's IEEE fp32), and on their own they put more than 2e-5 of
d att_src's own largest entry between the two at (20, 4, 4), drop_p 0.3.
So each leaf is also held on its own to autograd in float64 over the same
math (``gat_attention_math``), within 2e-6 of its largest entry (fp32
against fp64 over sums of at most 40 terms). The off-diagonal loss's
gradient within 2e-5 of its largest entry, values within 5e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.models import fused_gat as jfg
from fcsr_tpu_torch.kernels.ops import (MAX_CLUSTER, OFFDIAG_STAGE_BYTES,
                                        _gat_bwd_smem, gat_attention_bwd_plain,
                                        gat_attention_bwd_plan,
                                        gat_attention_math,
                                        gat_attention_plain,
                                        offdiag_mae_plain, offdiag_mse_plain,
                                        offdiag_plan, philox_keep_mask_plain)

# shared memory a block may opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin)
# on an H100, and on a card with 99 KB of it (sm_86)
H100_SMEM = 232448
SMALL_SMEM = 101376
SMEMS = {"h100": H100_SMEM, "small": SMALL_SMEM}
# (n, heads, d_head) of the seven GAT layers of the shipped step
LAYER_SHAPES = ((160, 4, 8), (80, 4, 16), (40, 4, 32), (20, 2, 64),
                (40, 4, 16), (80, 4, 8), (160, 4, 4))
WIDE_SHAPES = ((1000, 2, 128), (4096, 1, 128), (12288, 1, 64))
GRAD_TOL = 2e-5
F64_TOL = 2e-6
VALUE_RTOL = 5e-6


def _pow2(x):
    return x >= 1 and x & (x - 1) == 0


def _check_bwd_plan(plan, n, d, smem):
    assert _pow2(plan.cluster) and plan.cluster <= MAX_CLUSTER
    assert plan.rows >= 1 and plan.cluster * plan.rows >= n
    assert (plan.cluster - 1) * plan.rows < n      # no block without rows
    assert 1 <= plan.sub <= min(plan.rows, 32)
    assert plan.smem == _gat_bwd_smem(n, d, plan.cluster, plan.rows,
                                      plan.chunk, plan.sub) <= smem
    if plan.staged:
        assert plan.chunk == n
    else:
        assert plan.chunk % 32 == 0 and 32 <= plan.chunk < n


@pytest.mark.parametrize("smem", sorted(SMEMS))
@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("shape", LAYER_SHAPES, ids=str)
def test_bwd_plan_of_every_layer_is_one_staged_chunk(shape, F, smem):
    """Every shipped layer stages its head's h once (one chunk), with at
    least 4 target rows per block and about one block per SM at F = 3."""
    n, H, d = shape
    plan = gat_attention_bwd_plan(n, H, d, F, SMEMS[smem])
    _check_bwd_plan(plan, n, d, SMEMS[smem])
    assert plan.staged and plan.rows >= 4
    assert H * F * plan.cluster <= 2 * 132
    assert gat_attention_bwd_plan(n, H, d, F, SMEMS[smem]) == plan


@pytest.mark.parametrize("smem", sorted(SMEMS))
@pytest.mark.parametrize("shape", WIDE_SHAPES + ((37, 3, 5), (1, 1, 4)),
                         ids=str)
def test_bwd_plan_of_wide_and_odd_widths(shape, smem):
    """Past what shared memory holds the sources go in chunks of a
    multiple of 32; where not even one chunk of 32 fits, the plan is
    refused by name."""
    n, H, d = shape
    try:
        plan = gat_attention_bwd_plan(n, H, d, 1, SMEMS[smem])
    except ValueError as e:
        assert smem == "small" and n >= 1000, (shape, smem)
        assert "too large" in str(e)
        return
    _check_bwd_plan(plan, n, d, SMEMS[smem])
    assert plan.staged == (n < 1000)
    assert gat_attention_bwd_plan(n, H, d, 1, SMEMS[smem]) == plan


def _check_offdiag_plan(plan, n, smem):
    tiles = (-(-n // 32)) ** 2
    assert _pow2(plan.cluster) and plan.cluster <= min(MAX_CLUSTER, tiles)
    # block b takes tiles b, b + cluster, ...: every block has one
    assert plan.per_block == -(-tiles // plan.cluster)
    assert 1 <= plan.stages <= plan.per_block
    assert plan.stages == 1 or plan.stages * OFFDIAG_STAGE_BYTES <= smem // 2


@pytest.mark.parametrize("smem", sorted(SMEMS))
@pytest.mark.parametrize("n", [268, 160, 80, 40, 37, 269, 1000, 3500])
def test_offdiag_plan_spreads_a_fold_at_f3_and_less_at_f56(n, smem):
    """At the step's F = 3 a fold runs on many blocks (more than one from
    n = 40 up); at the validation's F = 56 on no more than at F = 3; a
    plan is a function of (F, n) and the card's limit alone."""
    plans = {F: offdiag_plan(F, n, SMEMS[smem]) for F in (1, 3, 56)}
    for F, plan in plans.items():
        _check_offdiag_plan(plan, n, SMEMS[smem])
        assert offdiag_plan(F, n, SMEMS[smem]) == plan
    assert plans[3].cluster > 1
    assert plans[56].cluster <= plans[3].cluster <= plans[1].cluster
    assert plans[56].cluster * 56 <= 2 * 132
    if n == 268:
        assert plans[3].cluster == MAX_CLUSTER


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _close_scaled(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + 1e-12, (what, err, scale)


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
    a = (a + a.T).astype(np.float32)
    ct = rng.normal(size=(n, H * d)).astype(np.float32)
    return x, w, asrc, adst, bias, a, ct


@pytest.mark.parametrize("batched_chain", [False, True])
@pytest.mark.parametrize("drop_p", [0.0, 0.01, 0.3])
@pytest.mark.parametrize("shape", [(20, 2, 64), (40, 4, 32), (20, 4, 4)],
                         ids=str)
def test_attention_bwd_plain_is_the_vjp_of_the_jax_layer(rng, shape, drop_p,
                                                         batched_chain):
    """d w, d att_src, d att_dst, d bias and d x of one GAT layer (its
    projection h = x w, then ``gat_attention_bwd_plain``) against
    ``jax.vjp`` of the JAX layer under the same keep mask, and each
    against float64 autograd."""
    n, H, d = shape
    x, w, asrc, adst, bias, a, ct = _layer_inputs(rng, n, H, d)
    seeds = torch.tensor([[11, -7]], dtype=torch.int32)
    mask_id = 3
    keep = None
    if drop_p > 0:
        keep = philox_keep_mask_plain(seeds, mask_id, H, n, n, drop_p)[0]
        assert 0 < float(keep.mean()) < 1 or drop_p < 0.05

    def layer(w_, asrc_, adst_, bias_, x_):
        out = jfg._gat_layer(w_, asrc_, adst_, bias_, jnp.asarray(a), x_, H,
                             drop_mask=None if keep is None
                             else jnp.asarray(keep.numpy()),
                             drop_p=drop_p, batched_chain=batched_chain)
        return jax.nn.relu(out)

    _, vjp = jax.vjp(layer, *(jnp.asarray(v) for v in (w, asrc, adst, bias,
                                                       x)))
    want = vjp(jnp.asarray(ct))

    xt, wt = _t(x), _t(w)
    h = (xt @ wt)[None]
    y, alpha = gat_attention_plain(h, _t(asrc)[None], _t(adst)[None],
                                   _t(bias)[None], _t(a)[None], seeds,
                                   mask_id, drop_p, global_shift=batched_chain)
    g_src, g_dst = torch.zeros(1, H, d), torch.zeros(1, H, d)
    g_bias = torch.zeros(1, 1, H * d)
    g_h = gat_attention_bwd_plain(_t(ct)[None], y, alpha, h, _t(asrc)[None],
                                  _t(adst)[None], seeds, mask_id, drop_p,
                                  g_src, g_dst, g_bias)[0]
    got = (xt.T @ g_h, g_src[0], g_dst[0], g_bias[0], g_h @ wt.T)
    names = ("w", "att_src", "att_dst", "bias", "x")
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want)
    for name, g, wg in zip(names, got, want):
        err = float(np.abs(g.numpy() - np.asarray(wg, np.float64)).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)

    # each leaf on its own against autograd in float64 over the same math
    D = torch.float64
    leaves = [torch.tensor(v, dtype=D, requires_grad=True)
              for v in (w, asrc, adst, bias, x)]
    y64, _ = gat_attention_math(
        (leaves[4] @ leaves[0])[None], leaves[1][None], leaves[2][None],
        leaves[3][None], torch.tensor(a, dtype=D)[None],
        None if keep is None else (keep[None].to(D), 1.0 / (1.0 - drop_p)),
        batched_chain)
    exact = torch.autograd.grad((y64[0] * torch.tensor(ct, dtype=D)).sum(),
                                leaves)
    for name, g, e in zip(names, got, exact):
        _close_scaled(g.numpy(), e.numpy(), F64_TOL, name)


@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("n", [20, 37, 68])
def test_offdiag_mse_plain_is_value_and_grad_of_the_jax_loss(rng, n, F):
    """vals[:, slot] and ``gsym @ X`` of ``offdiag_mse_plain`` at G = X X^T
    against ``jax.value_and_grad`` of ``_offdiag_mse(relu(X X^T), T)``;
    ``offdiag_mae_plain`` against the same expression with |.|."""
    X = (rng.normal(size=(F, n, 5)) / np.sqrt(5)).astype(np.float32)
    T = rng.random((F, n, n)).astype(np.float32)
    G = np.einsum("fik,fjk->fij", X, X).astype(np.float32)
    vals = torch.zeros(F, 3)
    gsym = offdiag_mse_plain(_t(G), _t(T), vals, 1)
    offdiag_mae_plain(_t(G), _t(T), vals, 2)
    assert float(vals[:, 0].abs().max()) == 0.0
    for f in range(F):
        value, grad = jax.value_and_grad(
            lambda x: jfg._offdiag_mse(jax.nn.relu(x @ x.T),
                                       jnp.asarray(T[f])))(jnp.asarray(X[f]))
        np.testing.assert_allclose(float(vals[f, 1]), float(value),
                                   rtol=VALUE_RTOL)
        _close_scaled((gsym[f] @ _t(X[f])).numpy(), np.asarray(grad),
                      GRAD_TOL, "X")
        off = 1.0 - jnp.eye(n, dtype=jnp.float32)
        mae = jnp.sum(jnp.abs((jax.nn.relu(jnp.asarray(G[f]))
                               - jnp.asarray(T[f])) * off)) / (n * n)
        np.testing.assert_allclose(float(vals[f, 2]), float(mae),
                                   rtol=VALUE_RTOL)
