"""The port's training step and its pieces against the JAX package's
fused kernels (run on the CPU in Pallas interpret mode or through their
plain references), at the tiny config (20 -> 32 nodes, ks=(0.9, 0.7)).

Tolerances: the JAX kernels' products are f32-class compensated bf16x3
(about 2^-16 relative per product), the port's are IEEE fp32, so values
agree to ~1e-6 relative; gradients are compared after scaling by their
largest entry, at 1e-4.

JAX and the JAX package load inside the tests that compare with them, so
the card test collects where they are not installed (``pytest
--noconftest -m cuda``): it takes its weights from the port's own
``GSRNet`` init.
"""

import ctypes
import functools
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.core.normalize import normalize_adj_np
from fcsr_tpu_torch.iox.weights import (flax_to_state, leaves_to_flat,
                                        state_to_leaves)
from fcsr_tpu_torch.kernels import KERNELS
from fcsr_tpu_torch.kernels import KERNEL_OPS as KOPS
from fcsr_tpu_torch.kernels import PLAIN_OPS as POPS
from fcsr_tpu_torch.models.fused_step import (FlatLayout, adam_scalars,
                                              train_step_fused,
                                              train_step_plain,
                                              unet_backward, unet_forward)
from fcsr_tpu_torch.models.fused_tail import tail_loss, tail_loss_grads
from fcsr_tpu_torch.models.gsr import GSRNet, pool_sizes
from fcsr_tpu_torch.train import GSRTrainConfig
from fcsr_tpu_torch.train.fast_loop import adam_flat_update

CFG = GSRTrainConfig(lr_dim=20, hr_dim=32, hidden_dim=32, ks=(0.9, 0.7))
N, M, L = CFG.lr_dim, CFG.hr_dim, len(CFG.ks)


def _jax():
    """(jax, jax.numpy), imported by the tests that compare with JAX."""
    return importlib.import_module("jax"), importlib.import_module("jax.numpy")


def _jfs():
    return importlib.import_module("fcsr_tpu.models.fused_step")


def _leaves(seed=0):
    """The JAX package's GSR-Net init at the test's config, as leaves."""
    jax, _ = _jax()
    jtrain = importlib.import_module("fcsr_tpu.train")
    cfg = jtrain.GSRTrainConfig(lr_dim=N, hr_dim=M, hidden_dim=M, ks=CFG.ks)
    _, params, _, _ = jtrain.init_gsr(cfg, jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    return state_to_leaves(flax_to_state(params))


def _port_leaves(seed=0):
    """The port's own GSRNet init at the test's config, as leaves."""
    return state_to_leaves({k: v.numpy() for k, v in GSRNet(
        CFG.ks, N, M, M, device="cpu", seed=seed).state_dict().items()})


def random_symmetric(rng, n):
    """``tests/conftest.py::random_symmetric`` at density 1 (the same draws
    and bits): conftest imports JAX, the card's machine has none."""
    m = np.triu(rng.random((n, n)), k=1)
    return (m + m.T).astype(np.float32)


def _data(rng, n_folds):
    lrs = [random_symmetric(rng, N) for _ in range(n_folds)]
    u_lr = np.stack([np.linalg.eigh(normalize_adj_np(a))[1]
                     for a in lrs]).astype(np.float32)
    u_hr = rng.normal(size=(n_folds, M, N)).astype(np.float32)
    hr = np.stack([random_symmetric(rng, M) for _ in range(n_folds)])
    return u_lr, u_hr, hr


def _close_scaled(got, want, atol=1e-4, name=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=name)


def test_leaf_layout_matches_jax_kernel_order():
    shapes = [tuple(s.shape)
              for s in _jfs()._unet_leaf_shapes(N, M, L, tail=True)]
    assert FlatLayout(N, M, L).shapes == shapes
    assert [tuple(a.shape) for a in _leaves()] == shapes
    full = FlatLayout(160, 268, 4)
    assert len(full.specs) == 34 and full.size == 1023496


def test_tail_value_and_grads_match_jax_reference(rng):
    w_gsr = rng.normal(size=(M, N)).astype(np.float32)
    w1, w2 = (rng.uniform(-0.3, 0.3, (M, M)).astype(np.float32)
              for _ in range(2))
    f = rng.normal(0, 0.3, (N, M)).astype(np.float32)
    u_lr, u_hr, hr = (x[0] for x in _data(rng, 1))
    args = (w_gsr, w1, w2, f, u_lr, u_hr, hr)
    _, jnp = _jax()
    jl, jr, jg = importlib.import_module(
        "fcsr_tpu.models.fused_tail").tail_loss_reference(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a) for a in args]
    loss, recon, grads = tail_loss_grads(*targs)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(recon), float(jr), rtol=1e-5)
    for name, g, w in zip(("w_gsr", "w1", "w2", "f"), grads, jg):
        _close_scaled(g.numpy(), w, name=name)
    l2, r2 = tail_loss(*targs)
    assert float(l2) == float(loss) and float(r2) == float(recon)


def _unet_inputs(seed):
    _, jnp = _jax()
    leaves = _leaves(seed)
    flat = torch.from_numpy(leaves_to_flat(leaves))[None].contiguous()
    views = FlatLayout(N, M, L).views(flat)
    names = _jfs()._lin_names(L)
    w = {n: jnp.asarray(leaves[j]) for j, n in enumerate(names[:-1])}
    w["end_gcn"] = jnp.concatenate([jnp.asarray(leaves[len(names) - 1]),
                                    jnp.asarray(leaves[len(names)])], 0)
    b = {n: jnp.asarray(leaves[len(names) + 1 + j])
         for j, n in enumerate(names)}
    return leaves, views, w, b


def test_unet_forward_residuals_match_jax():
    sizes = pool_sizes(N, CFG.ks)
    _, views, w, b = _unet_inputs(1)
    net, x0, d, s, P, pooled, xu, xf, pre, kscol = _jfs()._unet_fwd_math(
        w, b, N, sizes, L)
    t_net, t_x0, res = unet_forward(KOPS, views, views, sizes)
    for name, got, want in (("net", t_net, net), ("x0", t_x0, x0),
                            ("xf", res["xf"], xf)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   atol=1e-5, err_msg=name)
    for i in range(L):
        np.testing.assert_array_equal(
            res["idx"][i][0].numpy(), np.asarray(P[i]).argmax(axis=1))
        for name, got, want in (("d", res["d"][i], d[i]),
                                ("s", res["s"][i], s[i][:, 0]),
                                ("pre", res["pre"][i], pre[i]),
                                ("pooled", res["pooled"][i], pooled[i]),
                                ("xu", res["xu"][i], xu[i]),
                                ("vals", res["vals"][i], kscol[i][:, 0])):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                       atol=1e-5, err_msg=f"{name}[{i}]")


def test_unet_backward_matches_jax(rng):
    sizes = pool_sizes(N, CFG.ks)
    _, jnp = _jax()
    jfs = _jfs()
    _, views, w, b = _unet_inputs(2)
    net, x0, d, s, P, pooled, xu, xf, pre, kscol = jfs._unet_fwd_math(
        w, b, N, sizes, L)
    ct_net = rng.normal(size=(N, M)).astype(np.float32)
    ct_start = rng.normal(size=(N, M)).astype(np.float32)
    names = jfs._lin_names(L)
    want = jfs._unet_bwd_math(
        w["end_gcn"][:M], w["end_gcn"][M:], w["bottom_gcn"],
        [w[f"down_gcns_{i}"] for i in range(L)],
        [w[f"up_gcns_{i}"] for i in range(L)],
        [w[f"pools_{i}"] for i in range(L)],
        x0, d, s, P, pooled, xu, xf, jnp.asarray(ct_net),
        jnp.asarray(ct_start), L, M)
    t_net, t_x0, res = unet_forward(KOPS, views, views, sizes)
    g = torch.empty(1, FlatLayout(N, M, L).size)
    G = FlatLayout(N, M, L).views(g)
    unet_backward(KOPS, views, G, G, t_x0, res,
                  torch.from_numpy(ct_net)[None],
                  torch.from_numpy(ct_start)[None])
    spec_names = [name for name, _ in FlatLayout(N, M, L).specs]
    assert len(want) == 2 * len(names) + 1
    for name, gw in zip(spec_names, want):
        _close_scaled(G[name][0].numpy(), gw, name=name)


def _step_inputs(rng, n_folds=2, leaves_of=_leaves):
    leaves = [leaves_of(j) for j in range(n_folds)]
    ms = [[rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in lv]
          for lv in leaves]
    vs = [[np.abs(rng.normal(0, 1e-3, a.shape)).astype(np.float32)
           for a in lv] for lv in leaves]
    scal = np.array([[1, 1 - 0.9 ** 3, 1 - 0.999 ** 3],
                     [1, 1 - 0.9 ** 1, 1 - 0.999 ** 1]], np.float32)
    return leaves, ms, vs, scal[:n_folds], _data(rng, n_folds)


def _flat(per_fold):
    return torch.from_numpy(np.stack([leaves_to_flat(x)
                                      for x in per_fold])).contiguous()


def test_one_step_matches_jax_interpret(rng):
    """train_step_fused (port, CPU) vs JAX train_step_fused(interpret=True)
    on loss, recon, p', m', v' for two folds at different step counts."""
    _, jnp = _jax()
    leaves, ms, vs, scal, (u_lr, u_hr, hr) = _step_inputs(rng)
    got = train_step_fused(
        _flat(leaves), _flat(ms), _flat(vs), torch.from_numpy(u_lr),
        torch.from_numpy(u_hr), torch.from_numpy(hr),
        torch.from_numpy(scal), CFG.ks, N, M, CFG.lmbda, CFG.lr,
        device="cpu")
    for f in range(2):
        jl, jr, jp, jm, jv = _jfs().train_step_fused(
            [jnp.asarray(a) for a in leaves[f]],
            [jnp.asarray(a) for a in ms[f]],
            [jnp.asarray(a) for a in vs[f]], jnp.asarray(u_lr[f]),
            jnp.asarray(u_hr[f]), jnp.asarray(hr[f]),
            jnp.asarray(scal[f:f + 1]), CFG.ks, N, M, CFG.lmbda, CFG.lr,
            interpret=True)
        np.testing.assert_allclose(float(got[0][f]), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(got[1][f]), float(jr), rtol=1e-5)
        for name, t, j, atol in (("p", got[2], jp, 1e-6),
                                 ("m", got[3], jm, 1e-6),
                                 ("v", got[4], jv, 1e-8)):
            np.testing.assert_allclose(t[f].numpy(), leaves_to_flat(
                [np.asarray(a) for a in j]), atol=atol, err_msg=name)


def test_masked_step_leaves_state_bit_unchanged(rng):
    leaves, ms, vs, scal, (u_lr, u_hr, hr) = _step_inputs(rng)
    scal = scal.copy()
    scal[1, 0] = 0.0
    p, m, v = _flat(leaves), _flat(ms), _flat(vs)
    loss, recon, p2, m2, v2 = train_step_fused(
        p, m, v, torch.from_numpy(u_lr), torch.from_numpy(u_hr),
        torch.from_numpy(hr), torch.from_numpy(scal), CFG.ks, N, M,
        CFG.lmbda, CFG.lr, device="cpu")
    for new, old in ((p2, p), (m2, m), (v2, v)):
        assert torch.equal(new[1], old[1])
        assert not torch.equal(new[0], old[0])
    assert float(loss[1]) == 0.0 and float(recon[1]) == 0.0
    assert float(loss[0]) > 0.0


def test_plain_step_equals_dispatching_step_on_cpu(rng):
    leaves, ms, vs, scal, (u_lr, u_hr, hr) = _step_inputs(rng)
    args = (_flat(leaves), _flat(ms), _flat(vs), torch.from_numpy(u_lr),
            torch.from_numpy(u_hr), torch.from_numpy(hr),
            torch.from_numpy(scal), CFG.ks, N, M, CFG.lmbda, CFG.lr)
    for a, b in zip(train_step_fused(*args, device="cpu"),
                    train_step_plain(*args)):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_scores_jit():
    jax, _ = _jax()
    return jax.jit(lambda logits: jax.nn.sigmoid(logits / 100.0))


def _jax_scores(logits):
    """The reference's pool scores as its jitted code computes them: XLA
    takes the division by 100 as a product with fl32(0.01)."""
    return _jax_scores_jit()(logits)


@pytest.mark.parametrize("n,k", [(160, 144), (101, 61), (13, 5)])
def test_rank_select_matches_topk_projection(rng, n, k):
    _, jnp = _jax()
    logits = rng.normal(0, 100, (2, n)).astype(np.float32)
    logits[:, 3:7] = logits[:, 9:10]                   # exact ties
    s, idx, vals, slot = POPS.rank_select(torch.from_numpy(logits), k)
    for f in range(2):
        sj = _jax_scores(jnp.asarray(logits[f]))
        proj = np.asarray(_jfs()._topk_projection(sj, k))
        np.testing.assert_array_equal(idx[f].numpy(), proj.argmax(axis=1))
        want_slot = np.full(n, -1)
        want_slot[proj.argmax(axis=1)] = np.arange(k)
        np.testing.assert_array_equal(slot[f].numpy(), want_slot)
        np.testing.assert_allclose(vals[f].numpy(), proj @ np.asarray(sj),
                                   atol=1e-7)


def test_adam_masked_plain_is_adam_flat_update(rng):
    p, g, m = (torch.from_numpy(rng.normal(size=(2, 50)).astype(np.float32))
               for _ in range(3))
    v = torch.from_numpy(np.abs(rng.normal(size=(2, 50))).astype(np.float32))
    scal_np, t_new = adam_scalars(np.array([4.0, 0.0], np.float32),
                                  np.array([1.0, 1.0], np.float32))
    np.testing.assert_array_equal(t_new, [5.0, 1.0])
    np.testing.assert_allclose(scal_np[:, 1], [1 - 0.9 ** 5, 1 - 0.9],
                               rtol=1e-6)
    vals = torch.ones(2, 3)
    p2, m2, v2, loss, recon = POPS.adam_masked(
        p, m, v, g, torch.from_numpy(scal_np), vals, 1e-3, 0.9, 0.999, 1e-8)
    # the flat update's bias corrections are taken in float64 (Python
    # scalars), the kernel's in float32: one ulp apart
    for f, t in ((0, 5.0), (1, 1.0)):
        step, m_ref, v_ref = adam_flat_update(g[f], m[f], v[f], t, 1e-3)
        torch.testing.assert_close(p2[f], p[f] - step, atol=1e-7, rtol=1e-6)
        torch.testing.assert_close(m2[f], m_ref, atol=1e-7, rtol=0)
        torch.testing.assert_close(v2[f], v_ref, atol=1e-7, rtol=0)
    assert loss.tolist() == [3.0, 3.0] and recon.tolist() == [1.0, 1.0]


def test_kernel_bindings_match_c_signatures():
    """Each ctypes binding declares exactly the C entry point's parameters
    (plus the trailing stream) — a mismatch would corrupt every argument
    on the card, where nothing type-checks the call."""
    csrc = Path(__file__).resolve().parents[1] / "fcsr_tpu_torch" / \
        "kernels" / "csrc"
    assert len(KERNELS) == 34 and {"anti_vectorize_normalize",
                                   "vectorize_colmajor",
                                   "normalize_adj_batch",
                                   "l1_term", "bgemm_bf16",
                                   "rank_select_bf16", "gather_rows_bf16",
                                   "scatter_rows_bf16", "pool_bwd_pair_bf16",
                                   "pool_bwd_pair_bf16_ad",
                                   "add_bias_bf16"} <= set(KERNELS)
    assert "loss_terms" not in KERNELS    # l1_term writes the loss scalars
    for k in KERNELS.values():
        src = (csrc / f"{k.source}.cu").read_text()
        m = re.search(r'extern "C" int ' + k.symbol + r"\((.*?)\)\s*\{",
                      src, re.S)
        assert m, k.symbol
        params = [p.strip() for p in m.group(1).split(",")]
        assert params[-1] == "void* stream", k.symbol
        assert len(params) == len(k.argtypes) + 1, k.symbol
        for p, t in zip(params, k.argtypes):
            ctype = p.rsplit(" ", 1)[0]
            want = (ctypes.c_void_p if "*" in p else
                    {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                     "float": ctypes.c_float}[ctype])
            assert t is want, (k.symbol, p)


def test_step_bias_views_take_the_16_byte_path():
    """add_bias's 16-byte loads need x, bias and their batch strides
    16-byte aligned: the step's w:start_gcn and b:start_gcn views of the
    full-width flat layout start at multiples of 4 floats and the buffer's
    row (the batch stride) is too, so on a 16-byte-aligned buffer they
    qualify."""
    layout = FlatLayout(160, 268, 4)
    flat = torch.zeros(2, layout.size)
    views = layout.views(flat)
    assert flat.stride(0) % 4 == 0
    for name in ("w:start_gcn", "b:start_gcn"):
        v = views[name]
        assert (v.data_ptr() - flat.data_ptr()) % 16 == 0, name
        assert v.stride(0) % 4 == 0, name
        assert v.shape[2] % 4 == 0 and v.stride(2) == 1, name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_step_kernels_match_plain_on_card(cuda_device):
    leaves, ms, vs, scal, (u_lr, u_hr, hr) = _step_inputs(
        np.random.default_rng(42), leaves_of=_port_leaves)
    args = [_flat(leaves), _flat(ms), _flat(vs), torch.from_numpy(u_lr),
            torch.from_numpy(u_hr), torch.from_numpy(hr),
            torch.from_numpy(scal)]
    args = [a.to(cuda_device) for a in args]
    rest = (CFG.ks, N, M, CFG.lmbda, CFG.lr)
    got = train_step_fused(*args, *rest)
    want = train_step_plain(*args, *rest)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
