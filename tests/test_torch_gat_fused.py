"""The port's fused GAT step (models/fused_gat.py) and the plain versions
of its kernels (kernels/ops.py) against the JAX package: the pure
``gat_step_loss`` and its ``jax.value_and_grad``, and the two Mosaic
kernels run in Pallas interpret mode, at the tiny config (20 -> 32 nodes,
dim 4, ks = (0.5, 0.5)).

Tolerances: values 5e-6 relative (the JAX products are compensated bf16x3,
about 2^-16 relative each, the port's IEEE fp32; 1.6e-6 was the largest
seen); a gradient is compared after scaling by its largest
entry: the hand-written one against autograd over the plain loss at 1e-5
of the whole gradient's largest entry and at 1e-4 of the leaf's, each plus
1e-8 absolute (without the intermediate losses the whole gradient is below
1e-4 and the products' rounding noise of about 1e-9 shows; a wrong adjoint
is off by its own size), against JAX over the whole gradient
at 2e-5 (5e-6 was the largest seen); one fused step's loss, p', m', v'
against the interpreted kernel 1e-5. The upsampler's bias has a gradient
of exactly zero in exact arithmetic (a softmax ignores a shift of its
column), so its entries are rounding noise on both sides: a per-leaf scale
would compare noise with noise.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.core.normalize import symmetric_normalize as j_symnorm
from fcsr_tpu.models import fused_gat as jfg
from fcsr_tpu.train.gat_loop import GATTrainConfig as JGATTrainConfig
from fcsr_tpu.train.gat_loop import precompute_gat_features as j_features
from fcsr_tpu_torch.iox import weights as W
from fcsr_tpu_torch.kernels import KERNELS, ops
from fcsr_tpu_torch.kernels import KERNEL_OPS as KOPS
from fcsr_tpu_torch.kernels import PLAIN_OPS as POPS
from fcsr_tpu_torch.models import fused_gat as fg
from fcsr_tpu_torch.train.gat_loop import adamw_flat_update

KS = (0.5, 0.5)


@pytest.fixture(autouse=True)
def _seed_torch():
    """Inputs drawn with ``torch.randn`` do not depend on the test order."""
    torch.manual_seed(0)


def _kw(heads=2):
    return dict(dim=4, ks=KS, n_nodes=20, m_nodes=32, heads=heads)


def _setup(rng, heads=2, n_folds=1, seed=0):
    """JAX leaves and data for ``n_folds`` subjects whose adjacency has real
    zeros; returns the JAX side (lists per fold) and the port's tensors."""
    cfg = JGATTrainConfig(n_nodes=20, m_nodes=32, dim=4, ks=KS, heads=heads,
                          drop_p=0.0)
    model = cfg.model()
    jax_side, flats, a0s, xs, hrs = [], [], [], [], []
    for f in range(n_folds):
        a_raw = rng.random((20, 20)).astype(np.float32)
        a_raw = (a_raw + a_raw.T) / 2
        a_raw = np.where(a_raw > 0.45, a_raw, 0.0).astype(np.float32)
        np.fill_diagonal(a_raw, 0.0)
        hr = rng.random((32, 32)).astype(np.float32)
        hr = (hr + hr.T) / 2
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed + f))
        v = model.init({"params": k1, "dropout": k2}, jnp.asarray(a_raw))
        # biases start at zero: perturb every leaf so each gradient is live
        v = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
                a.shape).astype(np.float32), v)
        x = np.asarray(j_features(a_raw[None], dim=4))[0]
        a0 = np.asarray(j_symnorm(jnp.asarray(a_raw) + jnp.eye(20)))
        leaves = jfg.gat_leaves_from_tree(v["params"], 4, KS, heads)
        jax_side.append((leaves, jnp.asarray(a0), jnp.asarray(x),
                         jnp.asarray(hr)))
        flats.append(W.gat_state_to_flat(W.gat_flax_to_state(v)))
        a0s.append(a0)
        xs.append(x)
        hrs.append(hr)
    t = lambda arrs: torch.from_numpy(np.stack(arrs))
    return jax_side, t(flats), t(a0s), t(xs), t(hrs)


def _leaf_list(p, heads=2):
    layout = fg.GATLayout(4, KS, heads, 20, 32)
    return layout, list(layout.views(p).values())


def _close_scaled(got, want, atol, name="", scale=None):
    got, want = np.asarray(got), np.asarray(want)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-3)
    scale = max(scale, 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=name)


def _largest(grads):
    return max(float(np.abs(np.asarray(g)).max()) for g in grads)


def _random_masks(rng, heads, drop_p, n_folds):
    """Keep masks for both sides: port tensors (F, count, rows, cols) and
    the JAX per-fold dict of per-head lists."""
    port, jax_masks = {}, [dict() for _ in range(n_folds)]
    for name, count, shape in fg._mask_shapes(4, KS, 20, heads):
        m = (rng.random((n_folds, count) + shape) >= drop_p).astype(
            np.float32)
        port[name] = torch.from_numpy(m)
        for f in range(n_folds):
            jax_masks[f][name] = [jnp.asarray(m[f, c]) for c in range(count)]
    return port, jax_masks


@pytest.mark.parametrize("heads,drop_p,chain", [
    (2, 0.0, False), (2, 0.0, True), (2, 0.3, False), (2, 0.3, True),
    (1, 0.0, False), (1, 0.5, False)])
def test_step_loss_value_and_grad_match_jax(rng, heads, drop_p, chain):
    """``gat_step_loss`` (value, autograd gradient) against JAX's pure loss
    and ``jax.value_and_grad``, with given dropout masks, heads = 1 (the
    per-head-list hazard) and both softmax shifts."""
    n_folds = 2
    jax_side, p, a0, x0, hr = _setup(rng, heads, n_folds)
    port_masks, jax_masks = (None, [None] * n_folds) if drop_p == 0 \
        else _random_masks(rng, heads, drop_p, n_folds)
    pp = p.clone().requires_grad_()
    _, leaves = _leaf_list(pp, heads)
    loss = fg.gat_step_loss(leaves, a0, x0, hr, drop_p=drop_p,
                            drop_masks=port_masks, batched_chain=chain,
                            **_kw(heads))
    grads = torch.autograd.grad(loss.sum(), leaves)
    for f, (j_leaves, ja0, jx, jhr) in enumerate(jax_side):
        want, j_grads = jax.value_and_grad(lambda l: jfg.gat_step_loss(
            l, ja0, jx, jhr, drop_p=drop_p, drop_masks=jax_masks[f],
            batched_chain=chain, **_kw(heads)))(j_leaves)
        np.testing.assert_allclose(float(loss[f].detach()), float(want),
                                   rtol=5e-6)
        for name, g, w in zip(W.gat_leaf_names(2), grads, j_grads):
            _close_scaled(g[f].numpy(), w, 2e-5, name, _largest(j_grads))


@pytest.mark.parametrize("heads,drop_p,chain,inter", [
    (2, 0.0, False, True), (2, 0.0, True, True), (2, 0.3, False, True),
    (2, 0.3, True, True), (1, 0.5, False, True), (2, 0.0, False, False),
    (2, 0.3, False, False)])
def test_hand_written_gradient_matches_autograd(rng, heads, drop_p, chain,
                                                inter):
    """The adjoints written out in ``_backward`` against ``torch.autograd``
    over the plain loss, fed the very masks the step draws from its seeds."""
    _, p, a0, x0, hr = _setup(rng, heads, 3)
    seeds = torch.tensor([[1, 2], [-7, 9], [2 ** 31 - 1, -2 ** 31]],
                         dtype=torch.int32)
    kw = dict(drop_p=drop_p, batched_chain=chain, intermediate_losses=inter,
              **_kw(heads))
    vals, g = fg.gat_value_and_grads(POPS, p, a0, x0, hr, seeds, **kw)
    assert vals.shape == (3, 3 if inter else 1)
    masks = None if drop_p == 0 else fg.draw_masks(
        seeds, dim=4, ks=KS, n_nodes=20, heads=heads, drop_p=drop_p)
    pp = p.clone().requires_grad_()
    layout, leaves = _leaf_list(pp, heads)
    loss = fg.gat_step_loss(leaves, a0, x0, hr, drop_masks=masks, **kw)
    loss.sum().backward()
    np.testing.assert_allclose(vals.sum(1).numpy(), loss.detach().numpy(),
                               rtol=1e-6)
    largest = float(pp.grad.abs().max())
    for name, got, want in zip(layout.names, layout.views(g).values(),
                               layout.views(pp.grad).values()):
        if name == "upsampler.bias":       # an exact zero: rounding noise
            assert float(got.abs().max()) < 1e-6 > float(want.abs().max())
            continue
        assert float(want.abs().max()) > 0, name      # every leaf is live
        err = float((got - want).abs().max())
        assert err <= 1e-5 * largest + 1e-8, (name, err, largest)
        assert err <= 1e-4 * float(want.abs().max()) + 1e-8, (name, err)


def test_one_step_matches_jax_interpret(rng):
    """One fused step (loss, p', m', v') against the Mosaic kernel in
    interpret mode, and a masked (ok = 0) fold that must not change."""
    jax_side, p, a0, x0, hr = _setup(rng, 2, 2)
    m = torch.from_numpy(rng.normal(0, 1e-3, p.shape).astype(np.float32))
    v = torch.from_numpy(np.abs(rng.normal(0, 1e-3, p.shape)).astype(
        np.float32))
    scal = np.array([[1.0, 1e-3, 1 - 0.9 ** 3, 1 - 0.999 ** 3],
                     [0.0, 1e-3, 1 - 0.9 ** 2, 1 - 0.999 ** 2]], np.float32)
    loss, p2, m2, v2 = fg.gat_train_step_fused(
        p, m, v, a0, x0, hr, torch.from_numpy(scal), None, device="cpu",
        **_kw())
    layout = fg.GATLayout(4, KS, 2, 20, 32)
    # fold 0 against the interpreted kernel
    j_leaves, ja0, jx, jhr = jax_side[0]
    split = lambda flat: [jnp.asarray(a) for a in W.flat_to_leaves(
        flat.numpy(), layout.shapes)]
    want = jfg.gat_train_step_fused(
        j_leaves, split(m[0]), split(v[0]), ja0, jx, jhr,
        jnp.asarray(scal[:1]), jnp.zeros((1, 2), jnp.int32), interpret=True,
        **_kw())
    np.testing.assert_allclose(float(loss[0]), float(want[0]), rtol=1e-5)
    for got, ws, name in ((p2, want[1], "p"), (m2, want[2], "m"),
                          (v2, want[3], "v")):
        w = W.leaves_to_flat([np.asarray(a) for a in ws])
        _close_scaled(got[0].numpy(), w, 1e-5, name)
    # the masked fold: state bit-unchanged, its loss still reported
    for new, old in ((p2, p), (m2, m), (v2, v)):
        assert torch.equal(new[1], old[1])
        assert not torch.equal(new[0], old[0])
    assert float(loss[1]) > 0


def test_plain_step_equals_dispatching_step_on_cpu(rng):
    _, p, a0, x0, hr = _setup(rng, 2, 2)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    scal = torch.tensor([[1.0, 1e-3, 0.1, 0.001]] * 2)
    seeds = torch.tensor([[3, 4], [5, 6]], dtype=torch.int32)
    for drop_p in (0.0, 0.3):
        a = fg.gat_train_step_fused(p, m, v, a0, x0, hr, scal, seeds,
                                    drop_p=drop_p, device="cpu", **_kw())
        b = fg.gat_train_step_plain(p, m, v, a0, x0, hr, scal, seeds,
                                    drop_p=drop_p, **_kw())
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("chain", [False, True])
def test_val_matches_jax_interpret(rng, chain):
    """``gat_val_fused`` (loss, off-diagonal MAE over m^2 entries) against
    the Mosaic validation kernel in interpret mode; one model serving a
    batch of subjects equals one model per subject."""
    jax_side, p, a0, x0, hr = _setup(rng, 2, 2)
    loss, mae = fg.gat_val_fused(p, a0, x0, hr, batched_chain=chain,
                                 device="cpu", **_kw())
    for f, (j_leaves, ja0, jx, jhr) in enumerate(jax_side):
        w_loss, w_mae = jfg.gat_val_fused(j_leaves, ja0, jx, jhr,
                                          interpret=True, batched_chain=chain,
                                          **_kw())
        np.testing.assert_allclose(float(loss[f]), float(w_loss), rtol=1e-5)
        np.testing.assert_allclose(float(mae[f]), float(w_mae), rtol=1e-5)
    shared = fg.gat_val_fused(p[0], a0, x0, hr, device="cpu", **_kw())
    tiled = fg.gat_val_fused(p[:1].repeat(2, 1), a0, x0, hr, device="cpu",
                             **_kw())
    for a, b in zip(shared, tiled):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    # the validation loss is the training objective with dropout off
    _, leaves = _leaf_list(p)
    want = fg.gat_step_loss(leaves, a0, x0, hr, **_kw())
    torch.testing.assert_close(fg.gat_val_plain(p, a0, x0, hr, **_kw())[0],
                               want, atol=1e-7, rtol=1e-6)


def test_keep_transform_matches_jax_exactly(rng):
    """The port's word -> keep function against ``_bits_to_keep_mask`` on
    the same words (the signed / unsigned shift hazard included)."""
    words = rng.integers(0, 2 ** 32, size=(64, 64), dtype=np.int64)
    words[0, :4] = [0, 2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1]
    signed = jnp.asarray(words.astype(np.uint32).view(np.int32))
    for p in (0.01, 0.1, 0.3, 0.5, 0.9):
        got = ops.bits_to_keep(torch.from_numpy(words), p).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jfg._bits_to_keep_mask(signed, p)))
        assert set(np.unique(got)) <= {0.0, 1.0}


def _philox_numpy(k0, k1, c0, c1, c2, c3):
    """Philox-4x32-10 word 0 in numpy uint64, independent of the port's."""
    k0, k1 = np.uint64(k0), np.uint64(k1)
    c = [np.asarray(x, np.uint64) for x in (c0, c1, c2, c3)]
    m32 = np.uint64(0xFFFFFFFF)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & m32]
        k0 = (k0 + np.uint64(0x9E3779B9)) & m32
        k1 = (k1 + np.uint64(0xBB67AE85)) & m32
    return c[0]


def test_philox_words_known_answer_and_reference():
    zero = torch.zeros(1, 2, dtype=torch.int32)
    # Random123's known answer for counter 0, key 0
    assert int(ops.philox_words(zero, 0, 1, 1)[0, 0, 0]) == 0x6627E8D5
    seeds = torch.tensor([[123456789, -5], [-2 ** 31, 2 ** 31 - 1]],
                         dtype=torch.int32)
    got = ops.philox_words(seeds, 7, 3, 50).numpy()
    for f in range(2):
        k = seeds[f].numpy().astype(np.int64) & 0xFFFFFFFF
        for head in range(3):
            want = _philox_numpy(k[0], k[1], np.arange(50), head, 7, 0)
            np.testing.assert_array_equal(got[f, head], want.astype(np.int64))


@pytest.mark.parametrize("p", [0.01, 0.1, 0.5, 0.9])
def test_keep_mask_rate_within_binomial_bounds(p):
    """The masks the step draws keep ~ Bernoulli(1 - p): 4 seeds x 4 heads
    of (256, 256), inside a 4-sigma binomial bound."""
    seeds = torch.tensor([[s, 17 * s + 1] for s in range(4)],
                         dtype=torch.int32)
    mask = POPS.philox_keep_mask(seeds, 2, 4, 256, 256, p)
    assert mask.shape == (4, 4, 256, 256)
    n = mask.numel()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(float(mask.mean()) - (1.0 - p)) < 4 * sigma + 1e-6
    # another mask id, head or seed draws other bits
    assert not torch.equal(mask, POPS.philox_keep_mask(seeds, 3, 4, 256, 256,
                                                       p))
    assert not torch.equal(mask[0, 0], mask[0, 1])
    assert not torch.equal(mask[0], mask[1])
    x = torch.randn(4, 4, 256, 256)
    scaled = POPS.philox_keep_mask(seeds, 2, 4, 256, 256, p, x,
                                   1.0 / (1.0 - p))
    assert torch.equal(scaled, (x * mask) * (1.0 / (1.0 - p)))


def test_attention_dropout_placement_and_scaling(rng):
    """With given masks at drop_p = 0.3 the attention is alpha * keep /
    (1 - p) and a dropped pool input is zeroed before the scores."""
    h = torch.randn(2, 20, 8)
    a = torch.from_numpy((rng.random((2, 20, 20)) < 0.4).astype(np.float32))
    att = torch.randn(2, 2, 4)
    bias = torch.zeros(2, 1, 8)
    seeds = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    y0, alpha = POPS.gat_attention(h, att, att, bias, a)
    y1, alpha1 = POPS.gat_attention(h, att, att, bias, a, seeds, 5, 0.3)
    assert torch.equal(alpha, alpha1)            # alpha is before dropout
    keep = POPS.philox_keep_mask(seeds, 5, 2, 20, 20, 0.3)
    hh = h.view(2, 20, 2, 4).permute(0, 2, 1, 3)
    want = torch.matmul(alpha * keep * (1.0 / 0.7), hh).permute(
        0, 2, 1, 3).reshape(2, 20, 8)
    torch.testing.assert_close(y1, torch.relu(want), atol=1e-6, rtol=1e-6)
    assert not torch.equal(y0, y1)
    np.testing.assert_allclose(alpha.sum(-1).numpy(), 1.0, atol=1e-6)
    off_edges = (a == 0) & ~torch.eye(20, dtype=torch.bool)
    assert float(alpha[:, 0][off_edges].abs().max()) == 0.0


def test_attention_bwd_plain_matches_autograd(rng):
    h = torch.randn(2, 20, 8, requires_grad=True)
    asrc = torch.randn(2, 2, 4, requires_grad=True)
    adst = torch.randn(2, 2, 4, requires_grad=True)
    bias = torch.randn(2, 1, 8, requires_grad=True)
    a = torch.from_numpy((rng.random((2, 20, 20)) < 0.4).astype(np.float32))
    seeds = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    ct = torch.randn(2, 20, 8)
    for drop_p in (0.0, 0.3):
        keep = None if drop_p == 0 else (
            POPS.philox_keep_mask(seeds, 1, 2, 20, 20, drop_p),
            1.0 / (1.0 - drop_p))
        y, alpha = ops.gat_attention_math(h, asrc, adst, bias, a, keep)
        want = torch.autograd.grad((y * ct).sum(), (h, asrc, adst, bias))
        g_src, g_dst = torch.zeros(2, 2, 4), torch.zeros(2, 2, 4)
        g_bias = torch.zeros(2, 1, 8)
        g_h = POPS.gat_attention_bwd(ct, y.detach(), alpha.detach(),
                                     h.detach(), asrc.detach(), adst.detach(),
                                     seeds, 1, drop_p, g_src, g_dst, g_bias)
        # 1e-5 of the largest entry: sums of 20-80 fp32 products of
        # unit-variance inputs in another order
        for got, w in zip((g_h, g_src, g_dst, g_bias), want):
            _close_scaled(got.numpy(), w.numpy(), 1e-5)


def test_leaky_slope_at_zero_is_one():
    """A logit of exactly 0 takes slope 1 (``where(z >= 0, ...)``), not
    0.2: the backward of a zero logit passes the cotangent through."""
    h = torch.zeros(1, 3, 2)
    att = torch.ones(1, 1, 2)
    a = torch.ones(1, 3, 3)
    y, alpha = POPS.gat_attention(h, att, att, torch.ones(1, 1, 2), a)
    g_src, g_dst = torch.zeros(1, 1, 2), torch.zeros(1, 1, 2)
    g_bias = torch.zeros(1, 1, 2)
    # with h = 0 only the logit path reaches att: give h a value path too
    h = torch.tensor([[[1.0, 0.0], [0.0, 0.0], [-1.0, 0.0]]])
    att = torch.tensor([[[1.0, 1.0]]])
    y, alpha = POPS.gat_attention(h, att, att, torch.ones(1, 1, 2), a)
    ct = torch.tensor([[[1.0, 0.0], [0.0, 0.0], [0.0, 0.0]]])
    POPS.gat_attention_bwd(ct, y, alpha, h, att, att, None, 0, 0.0, g_src,
                           g_dst, g_bias)
    hh = h.clone().requires_grad_()
    aa = att.clone().requires_grad_()
    y2, _ = ops.gat_attention_math(hh, aa, aa.detach(), torch.ones(1, 1, 2),
                                   a)
    (want,) = torch.autograd.grad((y2 * ct).sum(), aa)
    torch.testing.assert_close(g_src, want, atol=1e-7, rtol=1e-6)
    # row 0's logits are 2, 1, 0: the zero one is on the slope-1 side
    z = torch.tensor([2.0, 1.0, 0.0])
    torch.testing.assert_close(alpha[0, 0, 0], torch.softmax(z, 0))


def test_pool_adj_matches_jax_symnorm(rng):
    a = rng.random((2, 20, 20)).astype(np.float32)
    a = a + a.transpose(0, 2, 1)
    idx = np.stack([rng.permutation(20)[:10] for _ in range(2)]).astype(
        np.int32)
    got = POPS.gat_pool_adj(torch.from_numpy(a), torch.from_numpy(idx))
    for f in range(2):
        want = jfg._symnorm(jnp.asarray(a[f][idx[f]][:, idx[f]]))
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want),
                                   atol=1e-6)


def test_rank_select_without_the_gsr_scale(rng):
    """GAT's pool ranks sigmoid(logits), not GSR's sigmoid(logits / 100);
    saturated scores tie where the logits do not, and ties go to the lower
    index."""
    logits = torch.tensor([[30.0, 40.0, -1.0, 0.5, 50.0, 0.5]])
    s, idx, vals, slot = POPS.rank_select(logits, 4, 1.0)
    torch.testing.assert_close(s, torch.sigmoid(logits))
    assert idx.tolist() == [[0, 1, 4, 3]]       # 30, 40, 50 saturate to 1.0
    assert slot.tolist() == [[0, 1, -1, 3, 2, -1]]
    s100, idx100, _, _ = POPS.rank_select(logits, 4)
    assert idx100.tolist() == [[4, 1, 0, 3]]
    g, pre = torch.randn(1, 4, 3), torch.randn(1, 4, 3)
    got = POPS.pool_logits_bwd(g, pre, slot, s, 1.0)
    torch.testing.assert_close(
        got, 100.0 * POPS.pool_logits_bwd(g, pre, slot, s), rtol=1e-6,
        atol=0)


def test_col_softmax_and_offdiag_losses_match_autograd(rng):
    y = torch.randn(2, 4, 9, requires_grad=True)
    q = POPS.col_softmax(y.detach())
    torch.testing.assert_close(q, torch.softmax(y.detach(), 1), atol=1e-7,
                               rtol=1e-6)
    ct = torch.randn(2, 4, 9)
    (want,) = torch.autograd.grad((torch.softmax(y, 1) * ct).sum(), y)
    torch.testing.assert_close(POPS.col_softmax_bwd(ct, q), want, atol=1e-7,
                               rtol=1e-5)
    x = torch.randn(2, 6, 3, requires_grad=True)
    t = torch.rand(2, 6, 6)
    vals = torch.zeros(2, 3)
    g_raw = torch.matmul(x, x.transpose(1, 2))
    gsym = POPS.offdiag_mse(g_raw.detach(), t, vals, 1)
    loss = fg._offdiag_mse(torch.relu(g_raw), t)
    torch.testing.assert_close(vals[:, 1], loss.detach(), atol=1e-7,
                               rtol=1e-6)
    (want,) = torch.autograd.grad(loss.sum(), x)
    torch.testing.assert_close(torch.matmul(gsym, x.detach()), want,
                               atol=1e-6, rtol=1e-5)
    assert POPS.offdiag_mse(g_raw.detach(), t, vals, 2, grad=False) is None
    POPS.offdiag_mae(g_raw.detach(), t, vals, 0)
    eye = torch.eye(6, dtype=torch.bool)
    want_mae = (torch.relu(g_raw.detach()) - t).abs().masked_fill(
        eye, 0.0).sum((-2, -1)) / 36
    torch.testing.assert_close(vals[:, 0], want_mae, atol=1e-7, rtol=1e-6)


def test_adamw_masked_plain_is_adamw_flat_update(rng):
    """The masked kernel's plain version against the literal optax.adamw
    formula (the decay inside the step), per fold with its own lr and
    step count; a masked fold comes through bit-unchanged."""
    p, g, m = (torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
               for _ in range(3))
    v = torch.from_numpy(np.abs(rng.normal(size=(3, 40))).astype(np.float32))
    ts, lrs = (5.0, 1.0, 9.0), (1e-3, 1e-4, 1e-3)
    scal = torch.tensor([[1.0, lr, 1 - fg.ADAM_B1 ** t, 1 - fg.ADAM_B2 ** t]
                         for t, lr in zip(ts, lrs)])
    scal[2, 0] = 0.0
    vals = torch.tensor([[1.0, 2.0, 4.0]] * 3)
    p2, m2, v2, loss = POPS.adamw_masked(p, m, v, g, scal, vals, fg.ADAM_B1,
                                         fg.ADAM_B2, 1e-8, 0.01)
    for f in range(2):
        step, m_ref, v_ref = adamw_flat_update(g[f], p[f], m[f], v[f], ts[f],
                                               lrs[f], wd=0.01)
        torch.testing.assert_close(p2[f], p[f] - step, atol=1e-7, rtol=1e-6)
        torch.testing.assert_close(m2[f], m_ref, atol=1e-7, rtol=0)
        torch.testing.assert_close(v2[f], v_ref, atol=1e-7, rtol=0)
    for new, old in ((p2, p), (m2, m), (v2, v)):
        assert torch.equal(new[2], old[2])
    assert loss.tolist() == [7.0, 7.0, 7.0]
    # weight decay is live: wd = 0 gives another step
    p3 = POPS.adamw_masked(p, m, v, g, scal, vals, 0.9, 0.999, 1e-8, 0.0)[0]
    assert not torch.equal(p3[0], p2[0])


def test_kernel_ops_use_plain_versions_on_cpu(rng):
    """A wrapper given CPU tensors runs its plain version (and counts no
    launch); the names of both namespaces agree."""
    assert set(vars(KOPS)) == set(vars(POPS))
    before = sum(k.launches for k in KERNELS.values())
    y = torch.randn(2, 4, 9)
    assert torch.equal(KOPS.col_softmax(y), POPS.col_softmax(y))
    seeds = torch.tensor([[1, 2]], dtype=torch.int32)
    assert torch.equal(KOPS.philox_keep_mask(seeds, 0, 1, 4, 4, 0.5),
                       POPS.philox_keep_mask(seeds, 0, 1, 4, 4, 0.5))
    assert sum(k.launches for k in KERNELS.values()) == before


def test_gat_kernel_bindings_match_c_signatures():
    """Each ctypes binding of gat.cu declares exactly its C entry point's
    parameters (plus the trailing stream)."""
    src = (Path(__file__).resolve().parents[1] / "fcsr_tpu_torch" / "kernels"
           / "csrc" / "gat.cu").read_text()
    gat = [k for k in KERNELS.values() if k.source == "gat"]
    assert {k.name for k in gat} == {
        "gat_attention", "gat_attention_bwd", "philox_keep_mask",
        "gat_pool_adj", "col_softmax", "col_softmax_bwd", "offdiag_mse",
        "offdiag_mae", "adamw_masked"}
    for k in gat:
        m = re.search(r'extern "C" int ' + k.symbol + r"\((.*?)\)\s*\{", src,
                      re.S)
        assert m, k.symbol
        params = [p.strip() for p in m.group(1).split(",")]
        assert params[-1] == "void* stream"
        assert len(params) == len(k.argtypes) + 1, k.symbol
        for p, t in zip(params, k.argtypes):
            want = (ctypes.c_void_p if "*" in p else
                    {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                     "float": ctypes.c_float}[p.rsplit(" ", 1)[0]])
            assert t is want, (k.symbol, p)
        assert k.replaces.startswith(("fcsr_tpu/models/fused_gat.py:",
                                      "tools/experiments/"))


@pytest.mark.parametrize("kw", [dict(dim=6, heads=4), dict(dim=3, heads=2)])
def test_width_not_divisible_by_heads_is_refused(kw):
    p = torch.zeros(1, 10)
    with pytest.raises(ValueError, match="not divisible"):
        fg.gat_train_step_fused(p, p, p, p, p, p, p, None, ks=KS, n_nodes=20,
                                m_nodes=32, device="cpu", **kw)
    with pytest.raises(ValueError, match="not divisible"):
        fg.gat_val_fused(p, p, p, p, ks=KS, n_nodes=20, m_nodes=32,
                         device="cpu", **kw)


def test_step_refuses_wrong_shapes_and_missing_seeds(rng):
    _, p, a0, x0, hr = _setup(rng, 2, 1)
    z = torch.zeros_like(p)
    scal = torch.tensor([[1.0, 1e-3, 0.1, 0.001]])
    with pytest.raises(ValueError, match="seeds"):
        fg.gat_train_step_fused(p, z, z, a0, x0, hr, scal, None, drop_p=0.1,
                                device="cpu", **_kw())
    with pytest.raises(ValueError, match="scalars"):
        fg.gat_train_step_fused(p, z, z, a0, x0, hr, scal[:, :3], None,
                                device="cpu", **_kw())
    with pytest.raises(ValueError, match="a0"):
        fg.gat_train_step_fused(p, z, z, a0[:, :10], x0, hr, scal, None,
                                device="cpu", **_kw())
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fg.gat_train_step_fused(p, z, z, a0, x0, hr, scal, None, **_kw())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gat_step_kernels_match_plain_on_card(cuda_device, rng):
    _, p, a0, x0, hr = _setup(rng, 2, 3)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    scal = torch.tensor([[1.0, 1e-3, 0.1, 0.001]] * 3)
    seeds = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    args = [t.to(cuda_device) for t in (p, m, v, a0, x0, hr, scal, seeds)]
    for drop_p in (0.0, 0.3):
        got = fg.gat_train_step_fused(*args, drop_p=drop_p, **_kw())
        want = fg.gat_train_step_plain(*args, drop_p=drop_p, **_kw())
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
