"""The two cross-block reductions of the GSR tail: ``l1_term`` and
``tail_normalize`` (``fcsr_tpu_torch/kernels/csrc/tail.cu``).

``l1_term_plain`` — what the kernel is held to on the card — against the
JAX package's own expressions at the step's three call signatures, each
with exact ties a == b so the two sign conventions show: the U-Net term
``lmbda * jnp.mean(jnp.abs(net - x0))`` with its ``jnp.sign`` adjoint
(fcsr_tpu/models/fused_step.py:706-710), and ``jax.value_and_grad``
through ``jnp.mean(jnp.abs(.))`` for the tail's recon and spectral terms
(fcsr_tpu/models/fused_tail.py:60-61), the spectral one on the step's
strided ``FlatLayout`` leaf view. Then the wrappers' host-side launch
plans on the step's real views.

Tolerances: the value is a float32 mean summed in another order than
JAX's, 1e-6 relative; the gradient is a sign times a scale, exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu_torch.kernels.ops import (MAX_CLUSTER, l1_term_plain,
                                        l1_term_plan, tail_normalize_plan)
from fcsr_tpu_torch.models.fused_step import FlatLayout

# (lr, hr, pooling levels): the tests' tiny config and the full width
SIZES = {"tiny": (20, 32, 2), "full": (160, 268, 4)}
VALUE_RTOL = 1e-6
# shared memory a block may opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin)
# on an H100, and on a card with 99 KB of it (sm_86)
H100_SMEM = 232448
SMALL_SMEM = 101376


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _with_ties(rng, a):
    """b ~ N(0, 1) with b == a exactly on every 7th row and 5th column."""
    b = rng.normal(size=a.shape).astype(np.float32)
    b[:, ::7, ::5] = a[:, ::7, ::5]
    return b


def _leaf(flat, layout, name):
    return layout.views(flat)[name]


@pytest.mark.parametrize("size", sorted(SIZES))
def test_l1_term_plain_is_the_steps_l1_with_jnp_sign(rng, size):
    """vals[:, 0] and the (ct_net, ct_start) pair of the step's
    ``lmbda * L1(net, start)`` term: sign(0) = 0 at the ties."""
    lr, hr, _ = SIZES[size]
    F, lmbda = 3, 16.0
    net = rng.normal(size=(F, lr, hr)).astype(np.float32)
    x0 = _with_ties(rng, net)
    vals = torch.zeros(F, 3)
    g, ng = l1_term_plain(_t(net), _t(x0), vals, 0, lmbda,
                          lmbda / (lr * hr), True, neg=True)
    for f in range(F):
        diff = jnp.asarray(net[f]) - jnp.asarray(x0[f])
        value = lmbda * jnp.mean(jnp.abs(diff))
        g_l1 = np.asarray(jnp.sign(diff) * (lmbda / diff.size))
        np.testing.assert_allclose(float(vals[f, 0]), float(value),
                                   rtol=VALUE_RTOL)
        np.testing.assert_array_equal(g[f].numpy(), g_l1)
        np.testing.assert_array_equal(ng[f].numpy(), -g_l1)
    assert (g.numpy() == 0).sum() >= F * len(range(0, lr, 7)) * \
        len(range(0, hr, 5))


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("term", ["recon", "spectral"])
def test_l1_term_plain_is_value_and_grad_of_the_tail_terms(rng, size, term):
    """vals[:, 1] / vals[:, 2] and their gradients as the tail's
    ``jax.value_and_grad`` gives them (the |.| adjoint: +1 at the ties);
    the spectral term's ``a`` is the ``layer.weights`` leaf view, whose
    batch stride is the flat buffer's."""
    lr, hr, levels = SIZES[size]
    F = 3
    if term == "recon":
        slot, shape = 1, (hr, hr)
        a = _t(rng.normal(size=(F,) + shape))
    else:
        slot, shape = 2, (hr, lr)
        layout = FlatLayout(lr, hr, levels)
        flat = _t(rng.normal(size=(F, layout.size)))
        a = _leaf(flat, layout, "layer.weights")
        assert a.stride(0) == layout.size and not a.is_contiguous()
    b_np = _with_ties(rng, a.numpy())
    vals = torch.zeros(F, 3)
    n = shape[0] * shape[1]
    g = l1_term_plain(a, _t(b_np), vals, slot, 1.0, 1.0 / n, False)
    a_np = a.numpy()
    for f in range(F):
        value, grad = jax.value_and_grad(
            lambda x: jnp.mean(jnp.abs(x - jnp.asarray(b_np[f]))))(
            jnp.asarray(a_np[f]))
        np.testing.assert_allclose(float(vals[f, slot]), float(value),
                                   rtol=VALUE_RTOL)
        np.testing.assert_array_equal(g[f].numpy(), np.asarray(grad))
    assert vals[:, [i for i in range(3) if i != slot]].abs().sum() == 0


def _step_l1_operands(lr, hr, levels, F=3):
    """The three (a, b) pairs of the step's l1_term calls, with ``a`` as
    the step hands it over (activations contiguous, ``layer.weights`` a
    view of the flat parameter buffer)."""
    layout = FlatLayout(lr, hr, levels)
    flat = torch.zeros(F, layout.size)
    return {"net / x0": (torch.zeros(F, lr, hr), torch.zeros(F, lr, hr)),
            "pred / hr": (torch.zeros(F, hr, hr), torch.zeros(F, hr, hr)),
            "layer.weights / u_hr": (_leaf(flat, layout, "layer.weights"),
                                     torch.zeros(F, hr, lr))}


@pytest.mark.parametrize("size", sorted(SIZES))
def test_l1_term_plan_on_the_steps_views(size):
    """At full width all three call signatures take the 16-byte path (the
    leaf view starts on 16 bytes and the flat row is a multiple of 4
    floats); at the tiny width the leaf view starts 2 floats off (the two
    1-float pool biases before it) and takes 4-byte copies. The full width
    runs 16 blocks per fold, the tiny one block; the blocks' 4-element
    groups cover each fold exactly once."""
    lr, hr, levels = SIZES[size]
    for label, (a, b) in _step_l1_operands(lr, hr, levels).items():
        plan = l1_term_plan(a, b)
        n = a[0].numel()
        assert plan.vec == (n % 4 == 0 and a.storage_offset() % 4 == 0
                            and a.stride(0) % 4 == 0), label
        assert plan.vec == (size == "full"
                            or label != "layer.weights / u_hr"), label
        groups = -(-n // 4)
        assert plan.cluster == (MAX_CLUSTER if size == "full" else 1), label
        assert plan.cluster & (plan.cluster - 1) == 0
        assert (plan.cluster - 1) * plan.per_block < groups \
            <= plan.cluster * plan.per_block, label


@pytest.mark.parametrize("off", [1, 2, 3])
def test_l1_term_plan_takes_4_byte_copies_off_16_bytes(off):
    """Operands 1-3 floats past a 16-byte boundary, or a fold length that
    is not a multiple of 4, take the 4-byte path; the cluster size does
    not change with the path (so neither do the value's bits)."""
    F, rows, cols = 3, 268, 160
    n = rows * cols
    buf = torch.zeros(F, n + 4)
    a = buf[:, off:off + n].view(F, rows, cols)
    b = torch.zeros(F, rows, cols)
    aligned = l1_term_plan(buf[:, :n].view(F, rows, cols), b)
    plan = l1_term_plan(a, b)
    assert aligned.vec and not plan.vec
    assert plan[:2] == aligned[:2]
    skew = torch.zeros(F, n + 2)[:, :n].view(F, rows, cols)
    assert skew.data_ptr() % 16 == 0 and skew.stride(0) % 4 == 2
    assert not l1_term_plan(skew, b).vec       # fold 1 starts off 16 bytes
    odd = torch.zeros(F, 7, 9)
    assert not l1_term_plan(odd, odd).vec


@pytest.mark.parametrize("m", [32, 37, 268, 300, 900, 1000, 3500, 12288])
def test_tail_normalize_plan_by_width(m):
    """16 blocks per fold sharing the m rows; rows staged once up to m
    ~950 (16-byte copies and a row stride of 4 mod 32 where m % 4 == 0,
    else an odd stride), in even column chunks past that; every plan
    within an H100's opt-in shared memory, up to the widest m."""
    plan = tail_normalize_plan(m, True, H100_SMEM)
    assert plan.rows == -(-m // 16)        # (blocks past m hold no rows)
    assert plan.smem == 4 * (m + plan.rows * plan.ld) <= H100_SMEM
    assert plan.staged == (m <= 950) == (plan.chunk == m)
    if plan.vec:
        assert plan.staged and m % 4 == 0 and plan.ld % 32 == 4
    else:
        assert plan.ld % 2 == 1 and plan.ld >= plan.chunk
    assert plan.vec == (plan.staged and m % 4 == 0)
    if not plan.staged:
        assert plan.chunk % 2 == 0 and 2 <= plan.chunk < m
    assert not tail_normalize_plan(m, False, H100_SMEM).vec


def test_tail_normalize_plan_on_the_step():
    """At the main path's width: 17 rows in each of 16 blocks, the band
    staged once with 16-byte copies in 20 KB, under the 48 KB a block gets
    without opting in."""
    plan = tail_normalize_plan(268, True, H100_SMEM)
    assert plan == (17, 268, 292, True, True, 4 * (268 + 17 * 292))
    assert plan.smem <= 48 * 1024
    with pytest.raises(ValueError, match="too large"):
        tail_normalize_plan(50000, True, H100_SMEM)


@pytest.mark.parametrize("m", [268, 600, 800, 3500])
def test_tail_normalize_plan_follows_the_cards_limit(m):
    """The plan reads the limit it is given, not the H100's: on a card with
    99 KB a block stages its rows once only up to m ~620, and its chunks
    are narrower; every plan fits the limit."""
    big = tail_normalize_plan(m, True, H100_SMEM)
    small = tail_normalize_plan(m, True, SMALL_SMEM)
    assert small.smem <= SMALL_SMEM and small.rows == big.rows
    assert small.staged == (m <= 600) and big.staged == (m <= 800)
    assert small.chunk <= big.chunk
    if big.staged and not small.staged:
        assert not small.vec and small.chunk < m
