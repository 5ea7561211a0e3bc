"""The port's GAT Graph-U-Net (models/gat_unet.py), its weight layouts
(iox/weights.py), losses, plateau scheduler and SVD features against the
JAX package, on the CPU.

Inputs come from a numpy seed; the weights are the flax model's own init
carried through ``gat_flax_to_state``. Tolerance 1e-5 absolute on
predictions, adjacencies and reconstructions (values in [0, 1]): the two
frameworks sum the attention and the matrix products in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.models.fused_gat import gat_leaves_from_tree
from fcsr_tpu.models.gat_unet import gat_pool_sizes as j_pool_sizes
from fcsr_tpu.train import losses as j_losses
from fcsr_tpu.train.gat_loop import GATTrainConfig as JGATTrainConfig
from fcsr_tpu.train.gat_loop import precompute_gat_features as j_features
from fcsr_tpu.train.generic_loop import PlateauScheduler as JPlateau
from fcsr_tpu_torch.iox import weights as W
from fcsr_tpu_torch.models.fused_gat import GATLayout, _mask_shapes
from fcsr_tpu_torch.models.gat_unet import (GATGraphUnet, gat_pool_sizes,
                                            svd_node_features,
                                            symmetric_normalize)
from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig,
                                           precompute_gat_features, unet_loss)
from fcsr_tpu_torch.train.generic_loop import PlateauScheduler
from fcsr_tpu_torch.train.losses import (intermediate_recon_loss,
                                         offdiag_mse_loss)

TINY = dict(n_nodes=20, m_nodes=32, dim=4, ks=(0.5, 0.5), heads=2,
            drop_p=0.0)
FULL = dict(n_nodes=160, m_nodes=268, dim=16, ks=(0.5, 0.5, 0.5), heads=4,
            drop_p=0.0)


def _sparse_symmetric(rng, n, density):
    """Symmetric, zero diagonal, real zeros off it: the attention mask is
    exercised."""
    m = rng.random((n, n)) * (rng.random((n, n)) < density)
    m = np.triu(m, k=1)
    return (m + m.T).astype(np.float32)


def _flax_init(kw, seed=0):
    cfg = JGATTrainConfig(**kw)
    model = cfg.model()
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    v = model.init({"params": k1, "dropout": k2},
                   jnp.eye(kw["n_nodes"], dtype=jnp.float32) * 0.5)
    return model, jax.tree_util.tree_map(np.asarray, v)


def _port_model(kw, state):
    model = GATGraphUnet(ks=kw["ks"], n_nodes=kw["n_nodes"],
                         m_nodes=kw["m_nodes"], dim=kw["dim"],
                         heads=kw["heads"], drop_p=kw["drop_p"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


@pytest.mark.parametrize("kw,density", [(TINY, 0.5), (TINY, 1.0),
                                        (FULL, 0.3)],
                         ids=["tiny-sparse", "tiny-dense", "full-width"])
def test_forward_matches_flax(rng, kw, density):
    j_model, variables = _flax_init(kw)
    a_raw = _sparse_symmetric(rng, kw["n_nodes"], density)
    x = np.asarray(j_features(a_raw[None], dim=kw["dim"]))[0]
    want = j_model.apply(variables, jnp.asarray(a_raw), x=jnp.asarray(x),
                         train=False)
    model = _port_model(kw, W.gat_flax_to_state(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(a_raw), torch.from_numpy(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    assert len(got[1]) == len(got[2]) == len(kw["ks"])
    for g, w in zip(got[1] + got[2], tuple(want[1]) + tuple(want[2])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_forward_batch_equals_single(rng):
    _, variables = _flax_init(TINY)
    model = _port_model(TINY, W.gat_flax_to_state(variables))
    a = torch.from_numpy(np.stack([_sparse_symmetric(rng, 20, 0.5)
                                   for _ in range(3)]))
    x = torch.from_numpy(precompute_gat_features(a.numpy(), 4))
    with torch.no_grad():
        batched = model(a, x)
        for b in range(3):
            single = model(a[b], x[b])
            for g, w in zip((batched[0],) + batched[1] + batched[2],
                            (single[0],) + single[1] + single[2]):
                torch.testing.assert_close(g[b], w, atol=1e-6, rtol=0)


def test_forward_without_features_uses_svd(rng):
    """x=None decomposes inside the forward: |U| agrees with the host
    features (singular-vector signs are the library's) and the output has
    the right shape."""
    model = GATGraphUnet(**{**TINY, "device": "cpu"})
    a_raw = torch.from_numpy(_sparse_symmetric(rng, 20, 0.8))
    a = symmetric_normalize(a_raw + torch.eye(20))
    feats = precompute_gat_features(a_raw[None].numpy(), 4)[0]
    np.testing.assert_allclose(svd_node_features(a, 4).abs().numpy(),
                               np.abs(feats), atol=1e-4)
    with torch.no_grad():
        assert model(a_raw)[0].shape == (32, 32)


def test_weights_roundtrip_and_leaf_order():
    _, variables = _flax_init(TINY, seed=3)
    state = W.gat_flax_to_state(variables)
    leaves = W.gat_state_to_leaves(state)
    want = gat_leaves_from_tree(variables["params"], 4, (0.5, 0.5), 2)
    assert len(leaves) == len(want) == 10 * 2 + 6
    for got, w in zip(leaves, want):
        np.testing.assert_array_equal(got, np.asarray(w))
    layout = GATLayout(4, (0.5, 0.5), 2, 20, 32)
    assert layout.shapes == [a.shape for a in leaves]
    assert layout.names == W.gat_leaf_names(2)
    flat = W.gat_state_to_flat(state)
    assert flat.shape == (layout.size,)
    back = W.gat_flat_to_state(flat, layout.shapes)
    assert sorted(back) == sorted(state)
    for k in state:
        assert back[k].shape == state[k].shape
        np.testing.assert_array_equal(back[k], state[k])
    tree = W.gat_state_to_flax(back)
    for (p1, l1), (p2, l2) in zip(
            jax.tree_util.tree_flatten_with_path(variables)[0],
            jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert jax.tree_util.keystr(p1) == jax.tree_util.keystr(p2)
        np.testing.assert_array_equal(l1, l2)
    # the views of a flat buffer read the same model, differentiably
    views = layout.views(torch.from_numpy(flat)[None])
    named = W.gat_leaf_tensors_to_state({k: v[0] for k, v in views.items()})
    for k in state:
        np.testing.assert_array_equal(named[k].numpy(), state[k])


def test_state_dict_names_are_the_reference_names():
    model = GATGraphUnet(device="cpu")
    names = set(model.state_dict())
    assert {"down_gcns.0.gat.lin.weight", "up_gcns.2.gat.att_src",
            "bottom_gcn.gat.att_dst", "bottom_gcn.gat.bias",
            "pools.1.proj.weight", "pools.1.proj.bias",
            "upsampler.upsample_mlp.weight",
            "upsampler.upsample_mlp.bias"} <= names
    assert len(names) == 36
    sd = model.state_dict()
    assert sd["down_gcns.0.gat.lin.weight"].shape == (32, 16)
    assert sd["bottom_gcn.gat.att_src"].shape == (1, 2, 64)
    assert sd["upsampler.upsample_mlp.weight"].shape == (268, 160)
    assert sum(v.numel() for v in sd.values()) == GATLayout(
        16, (0.5, 0.5, 0.5), 4, 160, 268).size == 82655


def test_init_is_seeded_xavier():
    a = GATGraphUnet(device="cpu", seed=5).state_dict()
    b = GATGraphUnet(device="cpu", seed=5).state_dict()
    c = GATGraphUnet(device="cpu", seed=6).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["upsampler.upsample_mlp.weight"],
                           c["upsampler.upsample_mlp.weight"])
    w = a["down_gcns.0.gat.lin.weight"]                 # (32, 16)
    bound = (6.0 / (16 + 32)) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.8 * bound
    att = a["down_gcns.0.gat.att_src"]                  # fans (heads, d_head)
    assert float(att.abs().max()) <= (6.0 / (4 + 8)) ** 0.5
    for k in a:
        if k.endswith("bias"):
            assert float(a[k].abs().max()) == 0.0


@pytest.mark.parametrize("n,ks", [(160, (0.5, 0.5, 0.5)), (20, (0.5, 0.5)),
                                  (7, (0.3, 0.3)), (33, (0.9, 0.7, 0.6))])
def test_pool_sizes_truncate(n, ks):
    assert gat_pool_sizes(n, ks) == j_pool_sizes(n, ks)


def test_mask_shapes_match_jax():
    from fcsr_tpu.models.fused_gat import _mask_shapes as j_mask_shapes
    assert _mask_shapes(16, (0.5, 0.5, 0.5), 160, 4) == j_mask_shapes(
        16, (0.5, 0.5, 0.5), 160, 4)


def test_skip_keeps_the_reference_constraint(rng):
    a = torch.from_numpy(_sparse_symmetric(rng, 20, 0.8))
    ok = GATGraphUnet(ks=(1.0, 1.0), n_nodes=20, m_nodes=32, dim=4, heads=2,
                      drop_p=0.0, skip=True, device="cpu")
    with torch.no_grad():
        assert ok(a)[0].shape == (32, 32)
    bad = GATGraphUnet(ks=(0.5, 0.5), n_nodes=20, m_nodes=32, dim=4, heads=2,
                       drop_p=0.0, skip=True, device="cpu")
    with pytest.raises(RuntimeError):
        with torch.no_grad():
            bad(a)


def test_dropout_is_inverted_and_seeded(rng):
    model = GATGraphUnet(**{**TINY, "drop_p": 0.5, "device": "cpu"})
    a = torch.from_numpy(_sparse_symmetric(rng, 20, 0.8))
    with torch.no_grad():
        eval_a, eval_b = model(a)[0], model(a, train=False)[0]
        model.set_generator(torch.Generator().manual_seed(1))
        t1 = model(a, train=True)[0]
        model.set_generator(torch.Generator().manual_seed(1))
        t2 = model(a, train=True)[0]
        model.set_generator(torch.Generator().manual_seed(2))
        t3 = model(a, train=True)[0]
    assert torch.equal(eval_a, eval_b) and torch.equal(t1, t2)
    assert not torch.equal(t1, eval_a) and not torch.equal(t1, t3)


def test_losses_match_jax(rng):
    p = rng.random((3, 12, 12)).astype(np.float32)
    t = rng.random((3, 12, 12)).astype(np.float32)
    got = offdiag_mse_loss(torch.from_numpy(p), torch.from_numpy(t))
    for b in range(3):
        np.testing.assert_allclose(
            float(got[b]), float(j_losses.offdiag_mse_loss(p[b], t[b])),
            rtol=1e-6)
    # the mean runs over all n^2 entries, not n (n - 1)
    d = (p[0] - t[0]) * (1 - np.eye(12))
    np.testing.assert_allclose(float(got[0]), (d ** 2).sum() / 144, rtol=1e-6)
    hist = [rng.random((n, n)).astype(np.float32) for n in (12, 6)]
    rec = [rng.random((n, n)).astype(np.float32) for n in (12, 6)]
    np.testing.assert_allclose(
        float(intermediate_recon_loss([torch.from_numpy(a) for a in hist],
                                      [torch.from_numpy(a) for a in rec])),
        float(j_losses.intermediate_recon_loss(hist, rec)), rtol=1e-6)
    want = float(j_losses.offdiag_mse_loss(p[0], t[0])
                 + j_losses.intermediate_recon_loss(hist, rec))
    got = unet_loss(torch.from_numpy(p[0]), torch.from_numpy(t[0]),
                    [torch.from_numpy(a) for a in hist],
                    [torch.from_numpy(a) for a in rec[::-1]])
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("mode", ["rel", "abs"])
def test_plateau_scheduler_matches_jax(rng, mode):
    kw = dict(patience=2, factor=0.1, threshold=1e-2, threshold_mode=mode)
    a, b = PlateauScheduler(1e-3, **kw), JPlateau(1e-3, **kw)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 6),
                              0.5 + 0.001 * rng.random(12)])
    lrs = [(a.step(float(m)), b.step(float(m))) for m in metrics]
    assert all(x == y for x, y in lrs)
    assert lrs[-1][0] < 1e-3          # it did decay


def test_svd_features_match_jax(rng):
    lr = np.stack([_sparse_symmetric(rng, 20, 0.6) for _ in range(4)])
    got = precompute_gat_features(lr, 4)
    assert got.dtype == np.float32 and got.shape == (4, 20, 4)
    np.testing.assert_array_equal(got, np.asarray(j_features(lr, dim=4)))
    assert precompute_gat_features(lr.copy(), 4) is got       # memoized


def test_config_defaults_match_jax():
    ours, theirs = GATTrainConfig(), JGATTrainConfig()
    for name in ("ks", "n_nodes", "m_nodes", "dim", "heads", "drop_p", "skip",
                 "epochs", "lr", "patience", "plateau_threshold",
                 "plateau_factor", "intermediate_losses", "weight_decay",
                 "scan_unroll", "fused_step", "fused_batched_chain",
                 "fused_val"):
        assert getattr(ours, name) == getattr(theirs, name), name
