"""The port's GSRNet (evaluation forward) against the JAX package's flax
GSRNet, with weights carried across by iox/weights.py (CPU).

Tolerance: both sides run float32 matmuls (XLA vs PyTorch CPU kernels,
different summation order); 1e-5 absolute at the tiny size, 1e-4 at full
width where the chains are ~8 products deep over 268-wide sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.core.normalize import normalize_adj_np
from fcsr_tpu.iox.torch_interop import flax_to_reference_state
from fcsr_tpu.models.gsr import GraphPool as JGraphPool
from fcsr_tpu.models.gsr import GSRNet as JGSRNet
from fcsr_tpu_torch.iox.weights import (flax_to_state, leaves_to_state,
                                        state_to_flax, state_to_leaves)
from fcsr_tpu_torch.models.gsr import GraphPool, GSRNet, topk_desc
from tests.conftest import random_symmetric


def _flax_init(jmodel, lr_dim, seed=0):
    eye = jnp.eye(lr_dim, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), eye, u_lr=eye)
    return jax.tree_util.tree_map(np.asarray, params)


def _port(params, ks, lr_dim, hr_dim):
    model = GSRNet(ks, lr_dim, hr_dim, hr_dim, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in flax_to_state(params).items()})
    return model


@pytest.mark.parametrize("ks,lr_dim,hr_dim,atol", [
    ((0.9, 0.7), 20, 32, 1e-5),
    ((0.9, 0.7, 0.6, 0.5), 160, 268, 1e-4),
])
def test_gsrnet_forward_matches_flax(rng, ks, lr_dim, hr_dim, atol):
    jmodel = JGSRNet(ks=ks, lr_dim=lr_dim, hr_dim=hr_dim, hidden_dim=hr_dim)
    params = _flax_init(jmodel, lr_dim)
    lr = random_symmetric(rng, lr_dim)
    a_norm = normalize_adj_np(lr).astype(np.float32)
    u_lr = np.linalg.eigh(a_norm)[1].astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(a_norm), u_lr=jnp.asarray(u_lr),
                        a_norm=jnp.asarray(a_norm))
    model = _port(params, ks, lr_dim, hr_dim)
    with torch.no_grad():
        got = model(torch.from_numpy(a_norm), u_lr=torch.from_numpy(u_lr),
                    a_norm=torch.from_numpy(a_norm))
    for name, g, w in zip(("pred", "net_outs", "start_outs", "adj"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   err_msg=name)


def test_gsrnet_batched_forward_equals_per_subject(rng):
    model = GSRNet((0.9, 0.7), 20, 32, 32, device="cpu", seed=3)
    lrs = np.stack([random_symmetric(rng, 20) for _ in range(3)])
    a = normalize_adj_np(lrs).astype(np.float32)
    u = np.linalg.eigh(a)[1].astype(np.float32)
    with torch.no_grad():
        batch = model(torch.from_numpy(a), u_lr=torch.from_numpy(u),
                      a_norm=torch.from_numpy(a))[0]
        for i in range(3):
            one = model(torch.from_numpy(a[i]), u_lr=torch.from_numpy(u[i]),
                        a_norm=torch.from_numpy(a[i]))[0]
            torch.testing.assert_close(batch[i], one, atol=1e-6, rtol=0)


def test_graphpool_ties_pick_lax_top_k_indices():
    """Exact score ties: descending with ties to the LOWER index, as
    lax.top_k (torch.topk does not promise this order)."""
    scores = np.array([0.3, 0.7, 0.7, 0.1, 0.7, 0.3, 0.3, 0.9],
                      np.float32)
    for k in (1, 3, 5, 7):
        _, want = jax.lax.top_k(jnp.asarray(scores), k)
        vals, got = topk_desc(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(vals.numpy(), scores[np.asarray(want)])

    # through the module: duplicated feature rows give tied scores
    x = np.random.default_rng(0).normal(size=(6, 8)).astype(np.float32)
    x[4] = x[1]
    x[5] = x[1]
    jpool = JGraphPool(k_out=4, in_dim=8)
    jparams = jpool.init(jax.random.PRNGKey(0), jnp.eye(6), jnp.asarray(x))
    _, _, jidx = jpool.apply(jparams, jnp.eye(6), jnp.asarray(x))
    pool = GraphPool(4, 8)
    proj = jparams["params"]["proj"]
    with torch.no_grad():
        pool.proj.weight.copy_(torch.from_numpy(np.array(proj["kernel"]).T))
        pool.proj.bias.copy_(torch.from_numpy(np.array(proj["bias"])))
        _, _, idx = pool(torch.eye(6), torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_state_dict_names_are_the_reference_names():
    jmodel = JGSRNet(ks=(0.9, 0.7), lr_dim=20, hr_dim=32, hidden_dim=32)
    params = _flax_init(jmodel, 20)
    ref = flax_to_reference_state(params)
    mine = flax_to_state(params)
    port = GSRNet((0.9, 0.7), 20, 32, 32, device="cpu").state_dict()
    assert set(ref) == set(mine) == set(port)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k])
        assert tuple(port[k].shape) == ref[k].shape, k


def test_weight_layouts_round_trip():
    jmodel = JGSRNet(ks=(0.9, 0.7), lr_dim=20, hr_dim=32, hidden_dim=32)
    params = _flax_init(jmodel, 20, seed=4)
    back = state_to_flax(flax_to_state(params))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    state = flax_to_state(params)
    again = leaves_to_state(state_to_leaves(state))
    assert set(again) == set(state)
    for k in state:
        np.testing.assert_array_equal(again[k], state[k])


def test_init_matches_reference_distributions():
    model = GSRNet(device="cpu", seed=0)
    sd = model.state_dict()
    assert float(sd["net.start_gcn.proj.weight"].abs().max()) <= 160 ** -0.5
    assert float(sd["net.end_gcn.proj.bias"].abs().max()) <= 536 ** -0.5
    assert float(sd["gc1.weight"].abs().max()) <= (6 / 536) ** 0.5
    w = sd["layer.weights"]
    assert abs(float(w.std()) - 1.0) < 0.05 and abs(float(w.mean())) < 0.05
    same = GSRNet(device="cpu", seed=0).state_dict()
    other = GSRNet(device="cpu", seed=1).state_dict()
    assert all(torch.equal(sd[k], same[k]) for k in sd)
    assert not torch.equal(sd["gc2.weight"], other["gc2.weight"])
