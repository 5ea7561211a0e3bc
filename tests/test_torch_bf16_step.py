"""The GSR step under ``FCSR_MM_MODE=bf16`` (single-pass bf16 products)
against the JAX package in the same mode, on the CPU at the tiny config
(20 -> 32 nodes, ks=(0.9, 0.7), F = 2), and ``compute_dtype="bf16"``.

The JAX side runs once, in a process of its own with the variable set
(module fixture ``jax_bf16``): its kernel builders are cached without the
mode (``fcsr_tpu/models/fused_step.py:131, :201, :261, :477, :662,
:825``, ``fused_tail.py:110``), so flipping the mode in a worker would
hand back stale kernels there and to later files. The port side sets
``mm_mode.MODE`` (read at each call).

Tolerances: both sides round the same operands the same way and sum in
fp32 in other orders (XLA's dots, torch's one product a fold); where a sum
lands beside a bf16 rounding edge, the next product's operand rounds the
other way, so values agree to ~1e-6 relative, not bit for bit: loss and
recon within 1e-5 relative, parameters and moments within 1e-6 after two
Adam steps, gradients within 1e-5 of their scale. The fp32 step sits
~4e-4 away from the bf16 one in parameters (``test_bf16_is_live``).
``unet_fused`` and ``step_value_and_grad_fused`` run the hand-written
adjoints (those of #7-#9) in both modes, where the JAX package
differentiates its forward: its bias gradients are unrounded fp32 sums of
the cotangent, and the start weights' gradient is rounded, so their
gradients differ from JAX's by up to one bf16 rounding of a term (5e-3 of
the scale); the rest agree as above.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.core import mm_mode
from fcsr_tpu_torch.iox.weights import (leaf_names, leaf_tensors_to_state,
                                        leaves_to_flat)
from fcsr_tpu_torch.models.fused_step import (FlatLayout,
                                              gsr_step_loss_fused,
                                              step_value_and_grad_fused,
                                              train_step_fused,
                                              train_step_plain, unet_fused,
                                              unet_fused_fwdbwd,
                                              unet_fused_fwdonly)
from fcsr_tpu_torch.models.fused_tail import tail_loss_fused
from fcsr_tpu_torch.models.gsr import pool_scores_bf16

ROOT = Path(__file__).resolve().parents[1]
N, M, KS, F, LMBDA, LR = 20, 32, (0.9, 0.7), 2, 16.0, 1e-4
TINY = dict(lr_dim=N, hr_dim=M, hidden_dim=M, ks=KS)

# the JAX side: seeded inputs, then each entry point under
# FCSR_MM_MODE=bf16, everything into one npz
JAX_SIDE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from fcsr_tpu.core import mosaic_mm
from fcsr_tpu.models import fused_step as jfs
from fcsr_tpu.models.fused_tail import tail_loss_fused
from fcsr_tpu.train import GSRTrainConfig, init_gsr
assert mosaic_mm.MODE == "bf16", mosaic_mm.MODE
N, M, KS, F, LMBDA, LR = 20, 32, (0.9, 0.7), 2, 16.0, 1e-4
rng = np.random.default_rng(7)

def sym(n):
    m = np.triu(rng.random((n, n)), k=1)
    return (m + m.T).astype(np.float32)

def norm(a):
    r = a.sum(-1) ** -0.5
    return a * r[None, :] * r[:, None]

lrs = [sym(N) for _ in range(F)]
u_lr = np.stack([np.linalg.eigh(norm(a))[1] for a in lrs]).astype(np.float32)
u_hr = rng.normal(size=(F, M, N)).astype(np.float32)
hr = np.stack([sym(M) for _ in range(F)])
names = jfs._lin_names(len(KS))

def to_leaves(p):
    net = p["net"]
    we = net["end_gcn"]["proj"]["kernel"]
    return ([net[n]["proj"]["kernel"] for n in names[:-1]] + [we[:M], we[M:]]
            + [net[n]["proj"]["bias"][None, :] for n in names]
            + [p["layer"]["weights"], p["gc1"]["weight"], p["gc2"]["weight"]])

def put(prefix, leaves):
    for j, a in enumerate(leaves):
        res[f"{prefix}_{j}"] = np.asarray(a)

res = {"u_lr": u_lr, "u_hr": u_hr, "hr": hr}
cfg = GSRTrainConfig(lr_dim=N, hr_dim=M, hidden_dim=M, ks=KS)
params = [init_gsr(cfg, jax.random.PRNGKey(f))[1] for f in range(F)]
for f in range(F):
    p = to_leaves(params[f]["params"])
    put(f"p0_{f}", p)
    m = [jnp.zeros_like(a) for a in p]
    v = [jnp.zeros_like(a) for a in p]
    for t in (1, 2):
        scal = jnp.asarray([[1.0, 1 - 0.9 ** t, 1 - 0.999 ** t]], jnp.float32)
        loss, recon, p, m, v = jfs.train_step_fused(
            p, m, v, u_lr[f], u_hr[f], hr[f], scal, KS, N, M, LMBDA, LR,
            interpret=True)
        res[f"loss_{f}_{t}"], res[f"recon_{f}_{t}"] = loss, recon
    put(f"p2_{f}", p)
    put(f"m2_{f}", m)
    put(f"v2_{f}", v)

pr0, pr1 = params[0]["params"], params[1]["params"]

def grads_of(net, wg, w1, w2):
    return to_leaves({"net": net, "layer": {"weights": wg},
                      "gc1": {"weight": w1}, "gc2": {"weight": w2}})

(loss, recon), g = jax.value_and_grad(
    lambda net, wg, w1, w2: jfs.gsr_step_loss_fused(
        net, wg, w1, w2, u_lr[0], u_hr[0], hr[0], KS, N, M, LMBDA,
        interpret=True), argnums=(0, 1, 2, 3), has_aux=True)(
    pr0["net"], pr0["layer"]["weights"], pr0["gc1"]["weight"],
    pr0["gc2"]["weight"])
res["sl_loss"], res["sl_recon"] = loss, recon
put("sl_g", grads_of(*g))

loss, recon, g = jfs.step_value_and_grad_fused(
    params[0], u_lr[0], u_hr[0], hr[0], KS, N, M, M, LMBDA, interpret=True)
res["svg_loss"], res["svg_recon"] = loss, recon
put("svg_g", to_leaves(g["params"]))

f_in = rng.normal(0, 0.3, (N, M)).astype(np.float32)
res["tail_f"] = f_in
val, g = jax.value_and_grad(
    lambda wg, w1, w2, f: tail_loss_fused(wg, w1, w2, f, u_lr[1], u_hr[1],
                                          hr[1], interpret=True),
    argnums=(0, 1, 2, 3))(pr1["layer"]["weights"], pr1["gc1"]["weight"],
                          pr1["gc2"]["weight"], f_in)
res["tail_loss"] = val
put("tail_g", g)

ct = [rng.normal(size=(N, M)).astype(np.float32) for _ in range(2)]
res["ct_net"], res["ct_start"] = ct
for tag, fn in (("fb", jfs.unet_fused_fwdbwd), ("fo", jfs.unet_fused_fwdonly)):
    (net, start), vjp = jax.vjp(lambda p: fn(p, KS, N, M, interpret=True),
                                pr1["net"])
    (g,) = vjp((jnp.asarray(ct[0]), jnp.asarray(ct[1])))
    res[f"{tag}_net"], res[f"{tag}_start"] = net, start
    put(f"{tag}_g", grads_of(g, pr1["layer"]["weights"], pr1["gc1"]["weight"],
                             pr1["gc2"]["weight"])[:-3])
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in res.items()})
'''


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_bf16") / "out.npz"
    env = dict(os.environ, FCSR_MM_MODE="bf16", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)], cwd=ROOT,
                   env=env, check=True, capture_output=True, timeout=600)
    return dict(np.load(path))


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setattr(mm_mode, "MODE", "bf16")


NL = len(FlatLayout(N, M, len(KS)).specs)
NAMES = leaf_names(len(KS))
UNET = leaf_names(len(KS), tail=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(r, prefix):
    return _t(np.stack([leaves_to_flat([r[f"{prefix}_{f}_{j}"]
                                        for j in range(NL)])
                        for f in range(F)])).contiguous()


def _leaves(r, f, names=NAMES):
    return {n: _t(r[f"p0_{f}_{j}"]).requires_grad_()
            for j, n in enumerate(names)}


def _close_scaled(got, want, atol, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=atol, err_msg=name)


def _two_steps(r, step=train_step_plain):
    p = _flat(r, "p0")
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    hist = []
    for t in (1, 2):
        scal = _t(np.array([[1.0, 1 - 0.9 ** t, 1 - 0.999 ** t]] * F,
                           np.float32))
        loss, recon, p, m, v = step(p, m, v, _t(r["u_lr"]), _t(r["u_hr"]),
                                    _t(r["hr"]), scal, KS, N, M, LMBDA, LR)
        hist.append((loss, recon))
    return hist, p, m, v


def test_train_step_fused_matches_jax_bf16(jax_bf16, bf16):
    """Two steps of the plain bf16 step from m = v = 0 against the JAX
    ``train_step_fused`` (interpret mode) under FCSR_MM_MODE=bf16; the
    dispatching step is the same on CPU tensors."""
    r = jax_bf16
    hist, p, m, v = _two_steps(r)
    for t, (loss, recon) in zip((1, 2), hist):
        for f in range(F):
            np.testing.assert_allclose(float(loss[f]), r[f"loss_{f}_{t}"],
                                       rtol=1e-5)
            np.testing.assert_allclose(float(recon[f]), r[f"recon_{f}_{t}"],
                                       rtol=1e-5)
    for name, got in (("p2", p), ("m2", m), ("v2", v)):
        np.testing.assert_allclose(got.numpy(), _flat(r, name).numpy(),
                                   atol=1e-6, err_msg=name)
    _, p_d, m_d, v_d = _two_steps(r, lambda *a: train_step_fused(
        *a, device="cpu"))
    assert torch.equal(p, p_d) and torch.equal(m, m_d) and torch.equal(v, v_d)


def test_bf16_is_live(jax_bf16, monkeypatch):
    """The fp32 mode's step lands far from the JAX bf16 step (the bf16
    mode's own lands within 1e-6): the products really round."""
    monkeypatch.setattr(mm_mode, "MODE", "bf16x3_concat")
    _, p, _, _ = _two_steps(jax_bf16)
    assert float((p - _flat(jax_bf16, "p2")).abs().max()) > 1e-4


def test_gsr_step_loss_fused_matches_jax_bf16(jax_bf16, bf16):
    r = jax_bf16
    P = _leaves(r, 0)
    net = {k: t for k, t in P.items() if k in UNET}
    loss, recon = gsr_step_loss_fused(
        net, P["layer.weights"], P["gc1.weight"], P["gc2.weight"],
        _t(r["u_lr"][0]), _t(r["u_hr"][0]), _t(r["hr"][0]), KS, N, M, LMBDA,
        device="cpu")
    np.testing.assert_allclose(float(loss.detach()), r["sl_loss"], rtol=1e-5)
    np.testing.assert_allclose(float(recon), r["sl_recon"], rtol=1e-5)
    for j, g in enumerate(torch.autograd.grad(loss, list(P.values()))):
        _close_scaled(g.numpy(), r[f"sl_g_{j}"], 1e-5, NAMES[j])


def test_step_value_and_grad_fused_follows_bf16(jax_bf16, bf16):
    """Loss and recon as the JAX package's; the gradients within one bf16
    rounding of a term (the JAX package differentiates its forward, the
    port runs the hand-written adjoints), and bit-equal to the port's
    gsr_step_loss_fused."""
    r = jax_bf16
    state = leaf_tensors_to_state({k: t.detach()
                                   for k, t in _leaves(r, 0).items()})
    loss, recon, g = step_value_and_grad_fused(
        state, _t(r["u_lr"][0]), _t(r["u_hr"][0]), _t(r["hr"][0]), KS, N, M,
        M, LMBDA, device="cpu")
    np.testing.assert_allclose(float(loss), r["svg_loss"], rtol=1e-5)
    np.testing.assert_allclose(float(recon), r["svg_recon"], rtol=1e-5)
    from fcsr_tpu_torch.iox.weights import state_to_leaf_tensors
    gl = state_to_leaf_tensors(g)
    for j, name in enumerate(NAMES):
        _close_scaled(gl[name].numpy(), r[f"svg_g_{j}"], 5e-3, name)


def test_tail_loss_fused_matches_jax_bf16(jax_bf16, bf16):
    r = jax_bf16
    P = _leaves(r, 1)
    args = [P["layer.weights"], P["gc1.weight"], P["gc2.weight"],
            _t(r["tail_f"]).requires_grad_()]
    loss = tail_loss_fused(*args, _t(r["u_lr"][1]), _t(r["u_hr"][1]),
                           _t(r["hr"][1]), device="cpu")
    np.testing.assert_allclose(float(loss.detach()), r["tail_loss"],
                               rtol=1e-5)
    for j, g in enumerate(torch.autograd.grad(loss, args)):
        _close_scaled(g.numpy(), r[f"tail_g_{j}"], 1e-5, str(j))


@pytest.mark.parametrize("tag,fn", [("fb", unet_fused_fwdbwd),
                                    ("fo", unet_fused_fwdonly)])
def test_unet_entry_points_match_jax_bf16(jax_bf16, bf16, tag, fn):
    """``unet_fused_fwdbwd`` (the hand-written adjoints, as the JAX
    kernel's) and ``unet_fused_fwdonly`` (autograd over the bf16 oracle,
    as the JAX package's XLA backward) against the JAX package's."""
    r = jax_bf16
    P = {k: t for k, t in _leaves(r, 1).items() if k in UNET}
    net, start = fn(P, KS, N, M, device="cpu")
    np.testing.assert_allclose(net.detach().numpy(), r[f"{tag}_net"],
                               atol=1e-6)
    np.testing.assert_allclose(start.detach().numpy(), r[f"{tag}_start"],
                               atol=1e-6)
    grads = torch.autograd.grad((net, start), list(P.values()),
                                (_t(r["ct_net"]), _t(r["ct_start"])))
    for j, g in enumerate(grads):
        _close_scaled(g.numpy(), r[f"{tag}_g_{j}"], 1e-5, UNET[j])


def test_unet_fused_is_fwdbwd_in_bf16(jax_bf16, bf16):
    """``unet_fused`` launches the forward again for its residuals: the same
    bits as ``unet_fused_fwdbwd``'s kept ones."""
    P = {k: t for k, t in _leaves(jax_bf16, 1).items() if k in UNET}
    ct = (_t(jax_bf16["ct_net"]), _t(jax_bf16["ct_start"]))
    outs = []
    for fn in (unet_fused, unet_fused_fwdbwd):
        net, start = fn(P, KS, N, M, device="cpu")
        outs.append([net, start] + list(torch.autograd.grad(
            (net, start), list(P.values()), ct)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _gsr_data(n=6):
    from fcsr_tpu_torch.data import synthesize_teacher_connectomes
    return synthesize_teacher_connectomes(n, lr_dim=N, hr_dim=M, seed=2)


def _run(cfg, mesh=None, **kw):
    from fcsr_tpu_torch.data import kfold_indices
    from fcsr_tpu_torch.train import GSRFoldRunner
    lr, hr = _gsr_data()
    runner = GSRFoldRunner(cfg, lr, hr, kfold_indices(6, 3, seed=42),
                           device="cpu", mesh=mesh, **kw)
    p, loss, err = runner.train()
    maes, _ = runner.evaluate()
    return p, loss, err, maes


def test_bf16_fused_step_and_mesh_are_bit_equal_to_fused_adam(bf16):
    """In the bf16 mode, as in fp32: ``fused_step`` gives ``fused_adam``'s
    bits, and a 4-shard mesh of the CPU (3 folds padded to 4) the
    unsharded run's."""
    from fcsr_tpu_torch.parallel import virtual_batch_mesh
    from fcsr_tpu_torch.train import GSRTrainConfig
    base = _run(GSRTrainConfig(epochs=2, fused_adam=True, **TINY))
    for other in (_run(GSRTrainConfig(epochs=2, fused_step=True, **TINY)),
                  _run(GSRTrainConfig(epochs=2, fused_adam=True, **TINY),
                       mesh=virtual_batch_mesh(4, "cpu"))):
        for a, b in zip(base, other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_pool_score_rule_matches_xla():
    """The pool's bf16 score, XLA's ``sigmoid(x / 100)`` in bf16 op by op
    (``models/gsr.py::pool_scores_bf16``), against jitted JAX over every
    finite bf16 value below 3000 in magnitude. The one difference is XLA
    flushing a denormal quotient to zero (|x| < 1.2e-36), where both give
    0.5."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    x = bits[np.isfinite(bits) & (np.abs(bits) < 3000)]
    want = np.asarray(jax.jit(lambda v: jax.nn.sigmoid(v / 100.0))(
        jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = pool_scores_bf16(torch.from_numpy(x).to(torch.bfloat16)).float()
    assert np.array_equal(got.numpy(), want)
    # its adjoint: g s (1 - s) / 100 in bf16, op by op, as jax.grad's
    g = jax.grad(lambda v: jnp.sum(jax.nn.sigmoid(v / 100.0)
                                   .astype(jnp.float32)))(
        jnp.asarray(x[:4096]).astype(jnp.bfloat16))
    t = torch.from_numpy(x[:4096]).to(torch.bfloat16).requires_grad_()
    (tg,) = torch.autograd.grad(pool_scores_bf16(t).float().sum(), t)
    assert np.array_equal(tg.float().numpy(),
                          np.asarray(g.astype(jnp.float32)))


def test_unfused_bf16_runner_matches_jax_runner():
    """``GSRTrainConfig(compute_dtype="bf16")``: one epoch of the unfused
    fold-parallel runner over 2 folds against the JAX package's
    ``GSRFoldRunner`` from the same weights. The U-Net agrees bit for bit
    (every product and sum rounded to bf16 as XLA rounds it), but XLA's
    CPU compiler keeps excess precision where a bf16 result feeds an fp32
    operation (its float-conversion simplification drops the f32 -> bf16
    -> f32 round trip at the U-Net's output into the GSR layer and the
    loss), and sums a bf16 reduction in its own order: the loss moves by
    ~6e-5 relative. Adam's first steps move a parameter by about
    lr x sign(g), so a near-zero gradient entry that takes the other sign
    moves its parameter by up to 2 lr a step: all parameters within
    2 lr x 3 steps, 99.5% of them within 1e-5; loss within 1e-3, val MAE
    within 1e-4."""
    import jax

    from fcsr_tpu.train import GSRTrainConfig as JConfig
    from fcsr_tpu.train.fast_loop import GSRFoldRunner as JRunner
    from fcsr_tpu_torch.data import kfold_indices
    from fcsr_tpu_torch.iox.weights import flax_to_state, state_to_flat
    from fcsr_tpu_torch.train import GSRFoldRunner, GSRTrainConfig

    lr, hr = _gsr_data(5)
    folds = kfold_indices(5, 2, seed=42)
    jr = JRunner(JConfig(epochs=1, compute_dtype="bf16", **TINY), lr, hr,
                 folds)
    j_p, j_loss, j_err = jr.train()
    j_mae, _ = jr.evaluate()

    def flat(x):
        return np.stack([state_to_flat(flax_to_state(jax.tree_util.tree_map(
            np.asarray, jr.unravel(x[j])))) for j in range(x.shape[0])])

    r = GSRFoldRunner(GSRTrainConfig(epochs=1, compute_dtype="bf16", **TINY),
                      lr, hr, folds, flat0=flat(jr.flat0), device="cpu")
    p, loss, err = r.train()
    mae, _ = r.evaluate()
    d = np.abs(p.numpy() - flat(j_p))
    assert d.max() <= 2 * LR * 3 and (d > 1e-5).mean() <= 5e-3
    np.testing.assert_allclose(loss, np.asarray(j_loss), atol=1e-3)
    np.testing.assert_allclose(err, np.asarray(j_err), atol=1e-3)
    np.testing.assert_allclose(mae, np.asarray(j_mae), atol=1e-4)
    # and it is the bf16 run: the fp32 runner lands elsewhere
    p32, _, _ = GSRFoldRunner(GSRTrainConfig(epochs=1, **TINY), lr, hr,
                              folds, flat0=flat(jr.flat0),
                              device="cpu").train()
    assert float((p32 - p).abs().max()) > 1e-5
