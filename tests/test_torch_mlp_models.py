"""The port's MLP family (models/mlp.py) and its weight mappings
(iox/weights.py) against the JAX package on the CPU, at the tiny 20 -> 32
configuration, every input from a numpy seed and every weight carried
across by ``mlp_flax_to_state`` / ``mlp_state_to_flax``.

Tolerances: layer and model outputs 1e-5 of the output's largest entry
(float32 sums and rsqrt in another order than XLA's), running statistics
and stored spectral-norm vectors 1e-6 relative (+1e-7); the weight
mappings, the flat layouts and the fold axis are exact (copies, and a
fold's arithmetic does not depend on F). The spectral-norm check against
``torch.nn.utils.spectral_norm`` draws its u and v from a seeded numpy
generator and holds the outputs to 1e-5 of their scale.
"""

import jax
import numpy as np
import pytest
import torch

from fcsr_tpu.iox import torch_interop as j_interop
from fcsr_tpu.models import mlp as jmlp
from fcsr_tpu_torch.iox.weights import (mlp_flat_to_state, mlp_flax_to_state,
                                        mlp_state_to_flat, mlp_state_to_flax)
from fcsr_tpu_torch.models import mlp as tmlp

N_IN, N_OUT, HIDDEN = 20, 32, 26
L_IN, L_OUT = N_IN * (N_IN - 1) // 2, N_OUT * (N_OUT - 1) // 2


def _sym_stack(rng, b, n):
    m = np.triu(rng.random((b, n, n)), k=1)
    return (m + m.transpose(0, 2, 1)).astype(np.float32)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(variant, n_layers, **kw):
    if variant == "v2":
        return jmlp.SpectralResMLP(num_nodes_input=N_IN,
                                   num_nodes_output=N_OUT,
                                   num_hidden=HIDDEN, n_layers=n_layers,
                                   dropout=0.0, **kw)
    return jmlp.SuperResMLP(input_size=N_IN * N_IN,
                            output_size=N_OUT * N_OUT, hidden_dim=HIDDEN,
                            n_layers=n_layers, dropout=0.0)


def _port_model(variant, n_layers, **kw):
    if variant == "v2":
        return tmlp.SpectralResMLP(N_IN, N_OUT, HIDDEN, n_layers, dropout=0.0,
                                   device="cpu", **kw)
    return tmlp.SuperResMLP(N_IN * N_IN, N_OUT * N_OUT, HIDDEN, n_layers,
                            dropout=0.0, device="cpu")


def _jax_init(model, seed=0):
    return _np(model.init({"params": jax.random.PRNGKey(seed),
                           "dropout": jax.random.PRNGKey(100 + seed)},
                          np.zeros((2, N_IN, N_IN), np.float32)))


def _load(model, state):
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in state.items()})
    return model


@pytest.mark.parametrize("batch", [8, 1], ids=["batch8", "batch1"])
def test_torch_batchnorm_matches_jax(batch):
    """Train-mode forwards (the batch's statistics, then the running ones
    updated with the unbiased variance and momentum 0.9 in flax's sense),
    a batch of 1 included (n / max(n - 1, 1)), then an eval forward."""
    rng = np.random.default_rng(0)
    feat = 6
    jbn = jmlp.TorchBatchNorm()
    variables = _np(jbn.init(jax.random.PRNGKey(0),
                             np.zeros((2, feat), np.float32),
                             use_running_average=False))
    variables["params"]["scale"] = rng.normal(size=feat).astype(np.float32)
    variables["params"]["bias"] = rng.normal(size=feat).astype(np.float32)
    tbn = tmlp.TorchBatchNorm(feat, device="cpu")
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        tbn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
    tbn.train()
    for _ in range(3):
        x = (rng.normal(size=(batch, feat)) * 3 + 1).astype(np.float32)
        j_out, upd = jbn.apply(variables, x, use_running_average=False,
                               mutable=["batch_stats"])
        variables = {**variables, "batch_stats": _np(upd["batch_stats"])}
        _close(tbn(torch.from_numpy(x)).detach(), j_out)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tbn, name).numpy(),
                                   variables["batch_stats"][key], rtol=1e-6,
                                   atol=1e-7)
    tbn.eval()
    x = rng.normal(size=(5, feat)).astype(np.float32)
    _close(tbn(torch.from_numpy(x)).detach(),
           jbn.apply(variables, x, use_running_average=True))


def test_torch_batchnorm_is_not_batchnorm1d():
    """The port keeps the JAX formula: BatchNorm1d's running variance after
    one step from the same batch differs from it only by rounding, and the
    momentum is flax's 0.9 (torch's 0.1)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(7, 4)).astype(np.float32))
    ours = tmlp.TorchBatchNorm(4, device="cpu")
    ref = torch.nn.BatchNorm1d(4, momentum=0.1)
    ours(x)
    ref(x)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               ref.running_var.numpy(), rtol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               ref.running_mean.numpy(), rtol=1e-6,
                               atol=1e-7)


def _sndense_pair(seed=3, in_f=9, out_f=5):
    port = tmlp.SNDense(in_f, out_f, device="cpu", seed=seed)
    variables = {"params": {"kernel": port.weight_orig.detach().numpy().T,
                            "bias": np.random.default_rng(seed).normal(
                                size=out_f).astype(np.float32)},
                 "batch_stats": {"u": port.weight_u.numpy().copy(),
                                 "v": port.weight_v.numpy().copy()}}
    with torch.no_grad():
        port.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
    return port, variables


def test_sndense_matches_jax_in_train_and_eval():
    """Eval before any step (the stored pair), three train-mode forwards
    (one power iteration each, u and v stored), then eval again."""
    rng = np.random.default_rng(2)
    port, variables = _sndense_pair()
    jsn = jmlp.SNDense(5)
    port.eval()
    x = rng.normal(size=(3, 9)).astype(np.float32)
    _close(port(torch.from_numpy(x)).detach(),
           jsn.apply(variables, x, update_stats=False))
    port.train()
    for _ in range(3):
        x = rng.normal(size=(4, 9)).astype(np.float32)
        j_out, upd = jsn.apply(variables, x, update_stats=True,
                               mutable=["batch_stats"])
        variables = {**variables, "batch_stats": _np(upd["batch_stats"])}
        _close(port(torch.from_numpy(x)).detach(), j_out)
    for name, key in (("weight_u", "u"), ("weight_v", "v")):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   variables["batch_stats"][key], rtol=1e-6,
                                   atol=1e-7)
    port.eval()
    x = rng.normal(size=(6, 9)).astype(np.float32)
    _close(port(torch.from_numpy(x)).detach(),
           jsn.apply(variables, x, update_stats=False))


def test_sndense_matches_torch_spectral_norm_seeded():
    """Against the reference's ``torch.nn.utils.spectral_norm(Linear)``,
    every draw seeded (the weights and both vectors from numpy): eval with
    the stored pair, train steps, the stored pair, eval again, each within
    1e-5 of the outputs' scale."""
    from torch.nn.utils import spectral_norm

    rng = np.random.default_rng(4)
    in_f, out_f = 9, 5
    with torch.random.fork_rng(devices=[]):
        # its own draws are overwritten below; the global state is kept
        ref = spectral_norm(torch.nn.Linear(in_f, out_f))
    port = tmlp.SNDense(in_f, out_f, device="cpu")
    with torch.no_grad():
        w = torch.from_numpy(rng.normal(size=(out_f, in_f)).astype(
            np.float32))
        b = torch.from_numpy(rng.normal(size=out_f).astype(np.float32))
        u = rng.normal(size=out_f).astype(np.float32)
        v = rng.normal(size=in_f).astype(np.float32)
        for mod, wname in ((ref, "weight_orig"), (port, "weight_orig")):
            getattr(mod, wname).copy_(w)
            mod.bias.copy_(b)
            mod.weight_u.copy_(torch.from_numpy(u / np.linalg.norm(u)))
            mod.weight_v.copy_(torch.from_numpy(v / np.linalg.norm(v)))
    for train in (False, True, True, True, False):
        ref.train(train)
        port.train(train)
        x = torch.from_numpy(rng.normal(size=(4, in_f)).astype(np.float32))
        with torch.no_grad():
            _close(port(x), ref(x))
    for name in ("weight_u", "weight_v"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   getattr(ref, name).numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_fold_axis_changes_no_fold():
    """``sn_dense_fold`` and ``batch_norm_fold`` on F = 3 stacked weights
    give each fold the bits it gets alone (F = 1)."""
    rng = np.random.default_rng(5)
    F = 3
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, k, b, u, v = t(F, 8, L_IN), t(F, L_IN, HIDDEN), t(F, HIDDEN), \
        t(F, HIDDEN), t(F, L_IN)
    for update in (True, False):
        full = tmlp.sn_dense_fold(x, k, b, u, v, update)
        for f in range(F):
            one = tmlp.sn_dense_fold(x[f:f + 1], k[f:f + 1], b[f:f + 1],
                                     u[f:f + 1], v[f:f + 1], update)
            for a, c in zip(full, one):
                assert torch.equal(a[f], c[0])
    h, sc, bi, mr, vr = t(F, 8, 6), t(F, 6), t(F, 6), t(F, 6), t(F, 6).abs()
    for train in (True, False):
        full = tmlp.batch_norm_fold(h, sc, bi, mr, vr, train)
        for f in range(F):
            one = tmlp.batch_norm_fold(h[f:f + 1], sc[f:f + 1], bi[f:f + 1],
                                       mr[f:f + 1], vr[f:f + 1], train)
            for a, c in zip(full, one):
                assert torch.equal(a[f], c[0])


@pytest.mark.parametrize("variant,n_layers", [("v2", 0), ("v2", 1),
                                              ("v1", 1), ("v1", 2)])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(variant, n_layers, train):
    """The whole model from the JAX init after one training forward (so
    the stored spectral-norm pair has had its power iteration: a random
    pair can make sigma tiny and the eval output ill-conditioned), dense
    input, at dropout 0: the output (v2 matrix and vector, v1 matrix) and,
    in training, the updated statistics."""
    rng = np.random.default_rng(6)
    jm = _jax_model(variant, n_layers)
    variables = _jax_init(jm)
    _, upd = jm.apply(variables, _sym_stack(rng, 8, N_IN), train=True,
                      mutable=["batch_stats"])
    variables = {"params": variables["params"],
                 "batch_stats": _np(upd["batch_stats"])}
    port = _load(_port_model(variant, n_layers), mlp_flax_to_state(variables))
    port.train(train)
    x = _sym_stack(rng, 5, N_IN)
    if train:
        j_out, upd = jm.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    else:
        j_out = jm.apply(variables, x, train=False)
    _close(port(torch.from_numpy(x)).detach(), j_out)
    if train:
        want = mlp_flax_to_state({"params": variables["params"],
                                  "batch_stats": _np(upd["batch_stats"])})
        for k, b in port.named_buffers():
            np.testing.assert_allclose(b.numpy(), want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    if variant == "v2":
        jv = _jax_model(variant, n_layers, output="vector")
        pv = _load(_port_model(variant, n_layers, output="vector"),
                   mlp_flax_to_state(variables)).eval()
        _close(pv(torch.from_numpy(x[:, *np.triu_indices(N_IN, 1)])).detach(),
               jv.apply(variables, x, train=False))


def test_matrix_output_scatters_the_vector():
    """v2's matrix form is its vector form scattered row-major into the
    upper triangle and mirrored, with a zero diagonal (the plain version
    of ``anti_vectorize_normalize`` on the CPU): exactly."""
    rng = np.random.default_rng(7)
    mat = _port_model("v2", 1).eval()
    vec = _port_model("v2", 1, output="vector").eval()
    vec.load_state_dict(mat.state_dict())
    x = torch.from_numpy(_sym_stack(rng, 4, N_IN))
    with torch.no_grad():
        m, v = mat(x), vec(x)
    r, c = np.triu_indices(N_OUT, 1)
    assert torch.equal(m[:, r, c], v) and torch.equal(m[:, c, r], v)
    assert not m.diagonal(dim1=1, dim2=2).any()


@pytest.mark.parametrize("variant,n_layers", [("v2", 0), ("v2", 2),
                                              ("v1", 1), ("v1", 2)])
def test_weight_mappings_round_trip(variant, n_layers):
    """flax <-> state_dict <-> flat layouts, exact; v2's state_dict is the
    JAX package's reference mapping (``torch_interop``) without its
    ``num_batches_tracked`` entries, which ``mlp_state_to_flax`` ignores;
    the port's modules carry exactly these names and shapes."""
    variables = _jax_init(_jax_model(variant, n_layers))
    state = mlp_flax_to_state(variables)
    back = mlp_state_to_flax(state)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    port = _port_model(variant, n_layers)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in state.items()}
    p, s = mlp_state_to_flat(state)
    layout = port.layout
    assert p.shape == (layout.params.size,) and s.shape == (layout.stats.size,)
    again = mlp_flat_to_state(p, s, layout)
    for k in state:
        np.testing.assert_array_equal(again[k], state[k])
    if variant == "v2":
        ref = j_interop.flax_to_mlp_reference_state(variables)
        assert {k for k in ref if not k.endswith("num_batches_tracked")} \
            == set(state)
        for k in state:
            np.testing.assert_array_equal(state[k], ref[k])
        from_ref = mlp_state_to_flax(ref)
        want = j_interop.mlp_reference_state_to_flax(ref)
        for a, b in zip(jax.tree_util.tree_leaves(from_ref),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_init_flat_is_the_module_init(variant):
    """A module built with seed s holds row 0 of ``init_flat([s])``; the
    draws follow the JAX package's initialisers (v2: xavier-uniform
    kernels, zero biases, unit-norm u and v; v1: torch-Linear uniform
    +-1/sqrt(fan_in)); ``device="meta"`` allocates no weights."""
    port = _port_model(variant, 1)
    p, s = port.init_flat([0, 5], "cpu")
    state = mlp_flat_to_state(p[0].numpy(), s[0].numpy(), port.layout)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
    assert not torch.equal(p[0], p[1])
    views = port.layout.params.views(p)
    stats = port.layout.stats.views(s)
    if variant == "v2":
        k = views["input_dense.kernel"]
        bound = np.sqrt(6.0 / (L_IN + HIDDEN))
        assert float(k.abs().max()) <= bound and float(k.abs().max()) > \
            0.9 * bound
        assert not views["output_dense.bias"].any()
        for name in ("input_dense.u", "input_dense.v", "output_dense.u"):
            np.testing.assert_allclose(
                torch.linalg.vector_norm(stats[name], dim=-1).numpy(), 1.0,
                rtol=1e-6)
    else:
        for name, fan_in in (("Dense_0.kernel", N_IN * N_IN),
                             ("Dense_1.bias", HIDDEN)):
            m = float(views[name].abs().max())
            assert 0.9 / np.sqrt(fan_in) < m <= 1.0 / np.sqrt(fan_in)
    meta = (tmlp.SpectralResMLP(device="meta") if variant == "v2" else
            tmlp.SuperResMLP(25600, 71824, 10000, 1, device="meta"))
    assert all(t.is_meta for t in meta.state_dict().values())
    assert meta.layout.params.size == (10414992 if variant == "v2"
                                       else 974341824)
