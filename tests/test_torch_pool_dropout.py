"""The GAT pool's dropout drawn inside its two products, and the
upsampler's column softmax (``fcsr_tpu_torch/kernels/csrc/gat.cu``).

``philox_drop_logits`` (the masked pool input and its scores) and
``philox_drop_outer`` (the masked input adjoint) each replace two
launches: ``philox_keep_mask`` then ``bgemm``, and the rank-1 ``bgemm``
then ``philox_keep_mask``. Their plain versions are those pairs, bit for
bit, at every pool shape of the tiny config (20 -> 32 nodes, dim 4, ks
(0.5, 0.5)) and of the shipped width, each shape under one of drop_p
0.01 / 0.3 / 0.9 and one of the edge seeds (on the CPU the wrappers run
these same plain versions; the card test holds the kernels to the pairs at
every drop_p and seed). Their launch plans cover every row and refuse what the
counter or the grid cannot take. The step at drop_p > 0 goes through them
(its census) and still gives the loss and gradients of autograd over the
plain loss (the tolerances of ``test_torch_gat_fused.py``: values 1e-6
relative, a gradient within 1e-5 of the whole gradient's largest entry
and 1e-4 of its leaf's, each plus 1e-8), and the JAX package's
``gat_step_loss`` and ``jax.value_and_grad`` given the masks the port
draws (5e-6 relative on the loss, 2e-5 of the largest entry on the
gradients: the JAX products are compensated bf16x3, the port's IEEE
fp32).

``col_softmax``'s plain version against the JAX package's upsampler
softmax (the column max as shift, exp, a true division;
``fcsr_tpu/models/fused_gat.py:320-322``) to 1e-6 relative, and its plan
at R = 1, 16, 64, 200 and 5000. The kernels against their plain versions
run on the card only (``cuda``-marked); the JAX side loads inside the
tests that compare with it, so those also run where the JAX package's
dependencies are not installed (``pytest --noconftest -m cuda``).
"""

import importlib

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.iox import weights as W
from fcsr_tpu_torch.kernels import KERNEL_OPS, KERNELS, PLAIN_OPS
from fcsr_tpu_torch.kernels.census import gat_step_census
from fcsr_tpu_torch.kernels.ops import (CSM_MAX_WARPS, CSM_PER,
                                        CSM_REG_ROWS, DROP_THREADS, DROP_WARPS, MAX_F,
                                        bgemm_plain, col_softmax_plan,
                                        philox_drop_logits_plan,
                                        philox_drop_outer_plan,
                                        philox_keep_mask_plain)
from fcsr_tpu_torch.models import fused_gat as fg

KS = (0.5, 0.5)         # the tiny config's pools (test_torch_gat_fused.KS)

# (F, n, c) of the pools' inputs: the tiny config's two, the shipped
# width's three at F = 3 and a wide one
POOL_SHAPES = ((2, 20, 8), (2, 10, 16), (3, 160, 32), (3, 80, 64),
               (3, 40, 128), (1, 37, 5))
DROP_PS = (0.01, 0.3, 0.9)
EDGE_SEEDS = ((-2 ** 31, 2 ** 31 - 1), (0, 0), (2 ** 31 - 1, -2 ** 31))
# one case per shape, the drop_p and the edge seeds taken in turn
POOL_CASES = tuple((shape, DROP_PS[i % 3], EDGE_SEEDS[(i + i // 3) % 3])
                   for i, shape in enumerate(POOL_SHAPES))


def _jax_side():
    """jax, jax.numpy, the JAX package's fused_gat and the GAT tests'
    helpers (which import JAX)."""
    return tuple(importlib.import_module(m) for m in (
        "jax", "jax.numpy", "fcsr_tpu.models.fused_gat",
        "tests.test_torch_gat_fused"))


def _seeds(F, edge):
    return torch.tensor([edge] * F, dtype=torch.int32)


def _pool_inputs(F, n, c, seed):
    """x (F, n, c), gl (F, n, 1) and the pool's w (F, c, 1) and b (F, 1,
    1) as views into a flat (F, P) buffer, as the step hands them over."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    flat = t(F, 3 + c + 1)
    w = flat[:, 3:3 + c].view(F, c, 1)
    b = flat[:, 3 + c:].view(F, 1, 1)
    return t(F, n, c), t(F, n, 1), w, b


def _assert_bits(got, want):
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the plain versions are the two-launch pairs, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,drop_p,edge", POOL_CASES)
def test_drop_logits_plain_is_mask_then_product(shape, drop_p, edge):
    F, n, c = shape
    x, _, w, b = _pool_inputs(F, n, c, 1)
    seeds = _seeds(F, edge)
    scale = 1.0 / (1.0 - drop_p)
    z_want = philox_keep_mask_plain(seeds, 3, 1, n, c, drop_p, x, scale)
    l_want = bgemm_plain(z_want, w, bias=b)
    for ops in (PLAIN_OPS, KERNEL_OPS):      # CPU tensors: the plain path
        z, logits = ops.philox_drop_logits(x, w, b, seeds, 3, drop_p, scale)
        _assert_bits(z, z_want)
        _assert_bits(logits, l_want)
    keep = philox_keep_mask_plain(seeds, 3, 1, n, c, drop_p)
    if n * c * min(drop_p, 1 - drop_p) >= 10:  # dropped and kept entries
        assert 0 < float(keep.mean()) < 1


@pytest.mark.parametrize("shape,drop_p,edge", POOL_CASES)
def test_drop_outer_plain_is_product_then_mask(shape, drop_p, edge):
    F, n, c = shape
    _, gl, w, _ = _pool_inputs(F, n, c, 2)
    seeds = _seeds(F, edge)
    scale = 1.0 / (1.0 - drop_p)
    want = philox_keep_mask_plain(seeds, 4, 1, n, c, drop_p,
                                  bgemm_plain(gl, w, tb=True), scale)
    for ops in (PLAIN_OPS, KERNEL_OPS):
        _assert_bits(ops.philox_drop_outer(gl, w, seeds, 4, drop_p, scale),
                     want)


def test_wrappers_launch_nothing_on_cpu_and_check_seeds():
    x, gl, w, b = _pool_inputs(2, 20, 8, 3)
    before = sum(k.launches for k in KERNELS.values())
    KERNEL_OPS.philox_drop_logits(x, w, b, _seeds(2, (1, 2)), 1, 0.1, 1.0)
    KERNEL_OPS.philox_drop_outer(gl, w, _seeds(2, (1, 2)), 1, 0.1, 1.0)
    assert sum(k.launches for k in KERNELS.values()) == before
    with pytest.raises(ValueError, match="seeds"):
        KERNEL_OPS.philox_drop_logits(x, w, b, _seeds(3, (1, 2)), 1, 0.1, 1)
    with pytest.raises(ValueError, match="seeds"):
        KERNEL_OPS.philox_drop_outer(gl, w, _seeds(2, (1, 2)).long(), 1,
                                     0.1, 1.0)


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("F", (1, 3, 56, MAX_F))
@pytest.mark.parametrize("n,c", ((1, 1), (20, 8), (160, 32), (80, 64),
                                 (40, 128), (37, 5), (4096, 128),
                                 (2 ** 20, 2 ** 12 - 1)))
def test_drop_plans_cover_every_row(F, n, c):
    blocks = philox_drop_logits_plan(F, n, c)
    # a warp per row: every row has its warp, no block lies past the rows
    assert blocks * DROP_WARPS >= n > (blocks - 1) * DROP_WARPS
    for aligned in (True, False):
        plan = philox_drop_outer_plan(F, n, c, aligned)
        assert plan.vec == (4 if aligned and c % 4 == 0 else 1)
        vecs = n * c // plan.vec
        assert plan.vec * vecs == n * c          # no vector crosses a row
        assert plan.blocks * DROP_THREADS >= vecs
        assert (plan.blocks - 1) * DROP_THREADS < vecs


@pytest.mark.parametrize("plan", (
    lambda F, n, c: philox_drop_logits_plan(F, n, c),
    lambda F, n, c: philox_drop_outer_plan(F, n, c, True)))
def test_drop_plans_refuse_what_no_launch_takes(plan):
    with pytest.raises(ValueError, match="32-bit"):
        plan(1, 2 ** 16, 2 ** 16)
    with pytest.raises(ValueError, match="32-bit"):
        plan(3, 2 ** 20, 2 ** 12)
    with pytest.raises(ValueError, match="folds"):
        plan(MAX_F + 1, 20, 8)
    plan(1, 2 ** 16, 2 ** 16 - 1)                # the largest counter


@pytest.mark.parametrize("R", (1, 3, 4, 5, 16, 64, 128, 129, 200, 1784,
                               1785, 5000))
def test_col_softmax_plan_covers_every_row(R):
    plan = col_softmax_plan(56, R)
    assert 1 <= plan.warps <= CSM_MAX_WARPS
    if R <= CSM_REG_ROWS:
        # registers: warp w keeps rows w * 4 .. w * 4 + 3
        assert plan.form == 0
        rows = {w * CSM_PER + j for w in range(plan.warps)
                for j in range(CSM_PER)}
        assert set(range(R)) <= rows
        assert plan.warps == -(-R // CSM_PER)
    else:
        # warp w takes rows w, w + W, ...: every row once
        assert plan.form == 1
        rows = [r for w in range(plan.warps) for r in range(w, R,
                                                            plan.warps)]
        assert sorted(rows) == list(range(R))


def test_col_softmax_plan_step_shapes_and_small_cards():
    """The plan reads no limit of the card (no form stages in shared
    memory), so a card with 48 KB a block runs the same launches."""
    # the step's R = 16: four warps of 4 rows each
    assert col_softmax_plan(3, 16) == (0, 4)
    assert col_softmax_plan(56, 64) == (0, 16)
    assert col_softmax_plan(3, 128) == (0, 32)
    assert col_softmax_plan(3, 129) == (1, 32)
    with pytest.raises(ValueError, match="folds"):
        col_softmax_plan(MAX_F + 1, 16)


# ---------------------------------------------------------------------------
# the step through the new forms
# ---------------------------------------------------------------------------

def test_step_draws_pool_masks_inside_its_products():
    """At drop_p > 0 each pool is one philox_drop_logits and one
    philox_drop_outer launch in place of two products, with no
    philox_keep_mask: as many launches as at drop_p 0, where neither form
    runs."""
    kw = dict(n_nodes=20, m_nodes=32, dim=4, ks=KS, heads=2, F=2)
    on = gat_step_census(drop_p=0.01, **kw).launches
    off = gat_step_census(drop_p=0.0, **kw).launches
    assert on["philox_drop_logits"] == on["philox_drop_outer"] == len(KS)
    assert "philox_keep_mask" not in on
    assert on["bgemm"] == off["bgemm"] - 2 * len(KS)
    assert sum(on.values()) == sum(off.values())
    assert not {"philox_drop_logits", "philox_drop_outer",
                "philox_keep_mask"} & set(off)


@pytest.mark.parametrize("drop_p", (0.01, 0.3))
def test_plain_step_matches_autograd_oracle(rng, drop_p):
    """``gat_train_step_plain``'s loss and the hand-written gradients at
    drop_p > 0 against autograd over ``gat_step_loss`` with the masks the
    step's seeds draw (edge seeds included)."""
    tgf = _jax_side()[3]
    assert tgf.KS == KS
    _kw = tgf._kw
    _, p, a0, x0, hr = tgf._setup(rng, 2, 3)
    seeds = torch.tensor([[1, 2], [-2 ** 31, 2 ** 31 - 1],
                          [2 ** 31 - 1, -2 ** 31]], dtype=torch.int32)
    kw = dict(drop_p=drop_p, **_kw())
    zeros = torch.zeros_like(p)
    scal = torch.tensor([[1.0, 1e-3, 0.1, 0.001]] * 3)
    loss, _, _, _ = fg.gat_train_step_plain(p, zeros, zeros, a0, x0, hr,
                                            scal, seeds, **kw)
    vals, g = fg.gat_value_and_grads(PLAIN_OPS, p, a0, x0, hr, seeds, **kw)
    masks = fg.draw_masks(seeds, dim=4, ks=KS, n_nodes=20, heads=2,
                          drop_p=drop_p)
    assert any(float(m.mean()) < 1 for m in masks.values())
    pp = p.clone().requires_grad_()
    layout, leaves = tgf._leaf_list(pp)
    want = fg.gat_step_loss(leaves, a0, x0, hr, drop_masks=masks, **kw)
    want.sum().backward()
    np.testing.assert_allclose(loss.numpy(), want.detach().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(vals.sum(1).numpy(), want.detach().numpy(),
                               rtol=1e-6)
    largest = float(pp.grad.abs().max())
    for name, got, ref in zip(layout.names, layout.views(g).values(),
                              layout.views(pp.grad).values()):
        if name == "upsampler.bias":       # an exact zero: rounding noise
            assert float(got.abs().max()) < 1e-6 > float(ref.abs().max())
            continue
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * largest + 1e-8, (name, err, largest)
        assert err <= 1e-4 * float(ref.abs().max()) + 1e-8, (name, err)


@pytest.mark.parametrize("drop_p", (0.01, 0.3))
def test_step_matches_jax_with_the_ports_masks(rng, drop_p):
    """The port's step loss and gradients at drop_p > 0 against the JAX
    package's ``gat_step_loss`` and ``jax.value_and_grad``, handed the
    keep masks the port draws from its seeds."""
    jax, jnp, jfg, tgf = _jax_side()
    _kw = tgf._kw
    n_folds = 2
    jax_side, p, a0, x0, hr = tgf._setup(rng, 2, n_folds)
    seeds = torch.tensor([[-2 ** 31, 2 ** 31 - 1], [5, -9]],
                         dtype=torch.int32)
    vals, g = fg.gat_value_and_grads(PLAIN_OPS, p, a0, x0, hr, seeds,
                                     drop_p=drop_p, **_kw())
    masks = fg.draw_masks(seeds, dim=4, ks=KS, n_nodes=20, heads=2,
                          drop_p=drop_p)
    layout = fg.GATLayout(4, KS, 2, 20, 32)
    for f, (j_leaves, ja0, jx, jhr) in enumerate(jax_side):
        j_masks = {name: [jnp.asarray(m[f, c].numpy())
                          for c in range(m.shape[1])]
                   for name, m in masks.items()}
        want, j_grads = jax.value_and_grad(lambda l: jfg.gat_step_loss(
            l, ja0, jx, jhr, drop_p=drop_p, drop_masks=j_masks,
            **_kw()))(j_leaves)
        np.testing.assert_allclose(float(vals[f].sum()), float(want),
                                   rtol=5e-6)
        largest = tgf._largest(j_grads)
        for name, got, w in zip(W.gat_leaf_names(2),
                                layout.views(g).values(), j_grads):
            np.testing.assert_allclose(got[f].numpy() / largest,
                                       np.asarray(w) / largest, atol=2e-5,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# col_softmax against the JAX package's upsampler softmax
# ---------------------------------------------------------------------------

def _jax_col_softmax(y):
    """fcsr_tpu/models/fused_gat.py:320-322 over each fold's (feat, m)."""
    jax, jnp = _jax_side()[:2]

    def one(y):
        zmax = jax.lax.stop_gradient(jnp.max(y, axis=0, keepdims=True))
        e = jnp.exp(y - zmax)
        return e / jnp.sum(e, axis=0, keepdims=True)
    return jax.vmap(one)(y)


@pytest.mark.parametrize("shape", ((3, 16, 268), (2, 64, 32), (1, 1, 5)))
def test_col_softmax_plain_matches_jax(rng, shape):
    y = (rng.standard_normal(shape) * 4.0).astype(np.float32)
    want = np.asarray(_jax_col_softmax(y))
    for ops in (PLAIN_OPS, KERNEL_OPS):
        got = ops.col_softmax(torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pool_dropout_kernels_match_plain_on_card(cuda_device):
    """Both forms bit-equal to the two-launch pairs they replaced on the
    card at every pool shape, drop_p and edge seed; against their plain
    versions z and g_z bit-equal, the logits (gemv_dot's sum order, not the
    library product's) within 1e-5 of their scale."""
    dev = cuda_device
    K, P = KERNEL_OPS, PLAIN_OPS
    for F, n, c in POOL_SHAPES + ((3, 4096, 128),):
        x, gl, w, b = (t.to(dev) for t in _pool_inputs(F, n, c, 5))
        for drop_p in DROP_PS:
            for edge in EDGE_SEEDS:
                seeds = _seeds(F, edge).to(dev)
                s = 1.0 / (1.0 - drop_p)
                z, logits = K.philox_drop_logits(x, w, b, seeds, 2, drop_p, s)
                z_pair = K.philox_keep_mask(seeds, 2, 1, n, c, drop_p, x, s)
                _assert_bits(z, z_pair)
                _assert_bits(logits, K.bgemm(z_pair, w, bias=b))
                z_plain, l_plain = P.philox_drop_logits(x, w, b, seeds, 2,
                                                        drop_p, s)
                _assert_bits(z, z_plain)
                scale = max(1.0, float(l_plain.abs().max()))
                assert float((logits - l_plain).abs().max()) <= 1e-5 * scale
                g_z = K.philox_drop_outer(gl, w, seeds, 2, drop_p, s)
                _assert_bits(g_z, K.philox_keep_mask(
                    seeds, 2, 1, n, c, drop_p, K.bgemm(gl, w, tb=True), s))
                _assert_bits(g_z, P.philox_drop_outer(gl, w, seeds, 2,
                                                      drop_p, s))


@pytest.mark.cuda
def test_col_softmax_kernel_matches_plain_on_card(cuda_device):
    """Within 1e-6 of the plain version in both forms of the plan, and
    bit-equal run to run."""
    g = torch.Generator(device="cpu").manual_seed(0)
    for shape in ((3, 16, 268), (56, 16, 268), (3, 64, 268), (3, 200, 268),
                  (2, 2048, 40), (1, 1, 5)):
        y = (torch.randn(*shape, generator=g) * 4.0).to(cuda_device)
        got, again = KERNEL_OPS.col_softmax(y), KERNEL_OPS.col_softmax(y)
        want = PLAIN_OPS.col_softmax(y)
        assert torch.equal(got, again)
        assert float((got - want).abs().max()) <= 1e-6
