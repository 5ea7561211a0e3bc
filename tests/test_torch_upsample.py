"""The GraphSAGE / linear-interpolation upsampler against the JAX package's
(``fcsr_tpu/models/upsample.py``) on the CPU, weights carried across by
``iox.weights.upsample_flax_to_state``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.models.upsample import GCNLayer as JGCNLayer
from fcsr_tpu.models.upsample import GraphSAGEUpsampler as JUpsampler
from fcsr_tpu.models.upsample import linear_interp_matrix as j_interp
from fcsr_tpu_torch.iox import upsample_flax_to_state, upsample_state_to_flax
from fcsr_tpu_torch.models import GraphSAGEUpsampler, linear_interp_matrix


def _sym_stack(seed, b, n):
    rng = np.random.default_rng(seed)
    a = rng.random((b, n, n)).astype(np.float32)
    a = (a + a.transpose(0, 2, 1)) / 2
    a[:, np.arange(n), np.arange(n)] = 0.0
    return a


@pytest.mark.parametrize("n_in,n_out", [(12, 20), (20, 12), (160, 268),
                                        (268, 160), (7, 7), (1, 3)])
def test_interp_matrix_bit_equal(n_in, n_out):
    got = linear_interp_matrix(n_in, n_out, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_in, n_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_interp(n_in,
                                                                   n_out)))
    # a fresh tensor each call: writing to one leaves the cache alone
    got.zero_()
    assert linear_interp_matrix(n_in, n_out, device="cpu").abs().sum() > 0


def test_interp_matches_torch_interpolate():
    """The cases of tests/test_upsample_and_io.py: upsampling 12 -> 20
    and downsampling 20 -> 12 along the node axis."""
    rng = np.random.default_rng(42)
    for n_in, n_out in ((12, 20), (20, 12)):
        x = torch.from_numpy(rng.random((1, 3, n_in)).astype(np.float32))
        want = torch.nn.functional.interpolate(x, size=(n_out,),
                                               mode="linear")
        got = torch.einsum("bcn,nm->bcm", x,
                           linear_interp_matrix(n_in, n_out, device="cpu"))
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def _jax_scores(variables, a, hidden, out_size, n_layers):
    """The JAX model's forward up to the threshold, from its own layers."""
    b, n, _ = a.shape
    x = jnp.ones((b, n, hidden), a.dtype)
    for i in range(n_layers):
        layer = JGCNLayer(hidden, hidden, use_nonlinearity=i < n_layers - 1)
        x = layer.apply({"params": variables["params"][f"gcn_{i}"]}, a, x)
    x = jnp.einsum("bnc,nm->bmc", x, j_interp(n, out_size))
    return jax.nn.sigmoid(jnp.einsum("bmc,bkc->bmk", x, x))


@pytest.mark.parametrize("n_layers", [2, 3])
def test_upsampler_matches_flax(n_layers):
    a = _sym_stack(n_layers, 3, 12)
    jmodel = JUpsampler(hidden_channels=8, out_size=18, n_layers=n_layers)
    variables = jmodel.init(jax.random.PRNGKey(n_layers), jnp.asarray(a))
    want_out = np.asarray(jmodel.apply(variables, jnp.asarray(a)))
    want_scores = np.asarray(_jax_scores(variables, jnp.asarray(a), 8, 18,
                                         n_layers))

    model = GraphSAGEUpsampler(8, 18, n_layers=n_layers, device="cpu")
    state = upsample_flax_to_state(jax.tree_util.tree_map(np.array,
                                                          variables))
    assert sorted(state) == sorted(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        scores = torch.sigmoid(model.logits(torch.from_numpy(a))).numpy()
        out = model(torch.from_numpy(a)).numpy()
    assert out.shape == (3, 18, 18)
    np.testing.assert_allclose(scores, want_scores, atol=1e-6, rtol=0)
    assert np.all((out == 0) | (out > 0.2)) and np.all(out <= 1.0)
    # after the threshold: equal, except where the score sits within
    # 1e-6 of 0.2 and the two sides fall on either side of it
    differ = out != want_out
    assert np.all(np.abs(want_scores[differ] - 0.2) <= 1e-6)
    np.testing.assert_allclose(out[~differ], want_out[~differ], atol=1e-6,
                               rtol=0)


def test_weight_maps_round_trip():
    variables = JUpsampler(hidden_channels=5, out_size=9, n_layers=3).init(
        jax.random.PRNGKey(1), jnp.ones((1, 6, 6)))
    tree = jax.tree_util.tree_map(np.asarray, variables)
    state = upsample_flax_to_state(tree)
    assert list(state) == ["gcn.0.omega", "gcn.0.beta", "gcn.1.omega",
                           "gcn.1.beta", "gcn.2.omega", "gcn.2.beta"]
    back = upsample_state_to_flax(state)
    assert back["params"].keys() == tree["params"].keys()
    for name, leaves in tree["params"].items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(back["params"][name][leaf], arr)
    model = GraphSAGEUpsampler(5, 9, n_layers=3, device="cpu", seed=4)
    mine = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    again = upsample_flax_to_state(upsample_state_to_flax(mine))
    for k in mine:
        np.testing.assert_array_equal(again[k], mine[k])


def test_init_follows_its_seed_and_scale():
    a = GraphSAGEUpsampler(64, 10, n_layers=2, device="cpu", seed=7)
    b = GraphSAGEUpsampler(64, 10, n_layers=2, device="cpu", seed=7)
    c = GraphSAGEUpsampler(64, 10, n_layers=2, device="cpu", seed=8)
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y)
        if k.endswith("beta"):
            assert not x.any()
        else:
            assert not torch.equal(x, z)
            # normal(0, sqrt(2 / (64 + 64))) over 4096 draws
            assert abs(float(x.std()) / (2 / 128) ** 0.5 - 1) < 0.05
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphSAGEUpsampler(8, 4)
