"""The fold axis (and the data-parallel step's subject axis) as one
batched call, at the tiny size (20 -> 32 nodes) on the CPU: where the JAX
package writes ``jax.vmap``, the port maps its module over the folds with
``torch.func.vmap`` over ``functional_call``.

* The unfused GSR step (``fast_loop._FoldShard.loss``, fp32 and bf16) and
  the unfused GAT step (``gat_loop._FoldTrainer._unfused_step``, drop_p 0)
  against the per-fold ``functional_call`` loop they replaced, written out
  below: values and gradients within 1e-6 (bf16 within the bf16 runner
  test's 1e-3).
* The padded (F, V) plans on ragged folds (5 subjects in 2 folds):
  ``GSRFoldRunner.evaluate``, the unfused GAT validation and
  ``predict_gat_folds`` give each fold's mean over its own subjects.
* ``make_sharded_batch_step`` with 4 subjects a shard (batch 8 on 2
  shards) within 2e-5 of the JAX package's step.

Every test runs with vmap's per-sample fallback switched off and its
warning raised as an error: an op without a batching rule fails here
instead of looping over the folds.
"""

import warnings

import numpy as np
import pytest
import torch
from torch.func import functional_call

from fcsr_tpu_torch.core.normalize import fill_diagonal, unpad
from fcsr_tpu_torch.data import kfold_indices, synthesize_teacher_connectomes
from fcsr_tpu_torch.iox.weights import (gat_leaf_tensors_to_state,
                                        leaf_tensors_to_state)
from fcsr_tpu_torch.parallel import (make_sharded_batch_step,
                                     virtual_batch_mesh)
from fcsr_tpu_torch.train import GSRFoldRunner, GSRTrainConfig, gat_loop
from fcsr_tpu_torch.train.losses import gsr_composite_loss

GSR_TINY = dict(lr_dim=20, hr_dim=32, hidden_dim=32, ks=(0.9, 0.7))
GAT_TINY = dict(ks=(0.5, 0.5), n_nodes=20, m_nodes=32, dim=4, heads=2)


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    """vmap's per-sample fallback off (an op without a batching rule
    raises) and its performance warning an error."""
    fc = torch._C._functorch
    was = fc._is_vmap_fallback_enabled()
    fc._set_vmap_fallback_warning_enabled(True)
    fc._set_vmap_fallback_enabled(False)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            yield
    finally:
        fc._set_vmap_fallback_enabled(was)
        fc._set_vmap_fallback_warning_enabled(False)


def _data(n, seed=2):
    return synthesize_teacher_connectomes(n, lr_dim=20, hr_dim=32, seed=seed)


def _ragged_folds():
    return kfold_indices(5, 2, seed=42)          # 3 and 2 subjects


# ---------------------------------------------------------------------------
# the unfused steps against the per-fold loop
# ---------------------------------------------------------------------------

def _gsr_loop_loss(shard, P, s):
    """The unfused GSR loss as the runner took it fold by fold."""
    cfg = shard.cfg
    u_lr, u_hr, hr = (x[s] for x in shard._steps)
    cast = (lambda t: t.to(torch.bfloat16)) \
        if cfg.compute_dtype == "bf16" else (lambda t: t)
    state = leaf_tensors_to_state(P)
    out = []
    for j in range(shard.n_folds):
        params = {k: cast(t[j]) for k, t in state.items()}
        a_j = cast(shard._a_norm_steps[s][j])
        pred, net, start, _ = functional_call(
            shard._module, params, (a_j,), {"u_lr": cast(u_lr[j]),
                                            "a_norm": a_j})
        out.append(gsr_composite_loss(
            unpad(pred.float(), cfg.padding), net.float(), start.float(),
            params["layer.weights"].float(), u_hr[j], hr[j], cfg.lmbda))
    return (torch.stack([x for x, _ in out]), torch.stack([e for _, e in out]))


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-6), ("bf16", 1e-3)])
def test_unfused_gsr_step_equals_the_fold_loop(dtype, tol):
    """Loss, error and every leaf's gradient of two sample slots, 3
    folds."""
    lr, hr = _data(9)
    cfg = GSRTrainConfig(epochs=1, compute_dtype=dtype, **GSR_TINY)
    runner = GSRFoldRunner(cfg, lr, hr, kfold_indices(9, 3, seed=42),
                           device="cpu")
    shard = runner.shards[0]
    for s in (0, 1):
        got, want = [], []
        for fn, out in ((shard.loss, got), (
                lambda P, s: _gsr_loop_loss(shard, P, s), want)):
            P = {k: t.requires_grad_() for k, t in
                 runner.layout.views(runner.flat0.clone()).items()}
            loss, err = fn(P, s)
            grads = torch.autograd.grad(loss.sum(), list(P.values()))
            out.extend([loss.detach(), err.detach(), *grads])
        assert got[0].shape == (3,)
        for a, b in zip(got, want):
            scale = max(float(b.abs().max()), 1.0)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=tol * scale)


def _gat_loop_step(tr, p0, i):
    """The unfused GAT loss and gradient as the trainer took them fold by
    fold."""
    p = p0.detach().requires_grad_()
    views = tr.layout.views(p)
    losses = []
    for f in range(tr.n_folds):
        state = gat_leaf_tensors_to_state({k: v[f] for k, v in views.items()})
        pred, a_hist, a_recon = functional_call(
            tr.model, state, (tr.lr_d[i][f], tr.x_d[i][f]), {"train": True})
        losses.append(gat_loop.unet_loss(pred, tr.hr_d[i][f], a_hist,
                                         a_recon, tr.cfg.intermediate_losses))
    loss = torch.stack(losses)
    return loss.detach(), torch.autograd.grad(loss.sum(), p)[0]


def _gat_trainer(n=10, folds=None):
    lr, hr = _data(n, seed=3)
    cfg = gat_loop.GATTrainConfig(epochs=1, drop_p=0.0, **GAT_TINY)
    return gat_loop._FoldTrainer(cfg, lr, hr,
                                 folds or kfold_indices(n, 3, seed=42), 42,
                                 "cpu"), lr, hr


def test_unfused_gat_step_equals_the_fold_loop():
    """drop_p 0: the step's losses and its update (whose gradient the
    AdamW step carries) against the loop's, 3 folds."""
    tr, _, _ = _gat_trainer()
    p0 = tr.p.clone()
    i = torch.tensor([0, 4, 7])
    scal = torch.tensor([[1.0, 1e-3, 1.0]] * 3)
    m0, v0 = torch.zeros_like(p0), torch.zeros_like(p0)
    loss, p1, m1, _ = tr._unfused_step(p0, m0, v0, i, scal)
    want_loss, g = _gat_loop_step(tr, p0, i)
    np.testing.assert_allclose(loss.numpy(), want_loss.numpy(), rtol=0,
                               atol=1e-6 * max(float(want_loss.max()), 1.0))
    # m1 = (1 - b1) g exactly scaled: the gradient itself, to 1e-6
    np.testing.assert_allclose(m1.numpy() / (1 - gat_loop.ADAM_B1),
                               g.numpy(), rtol=0,
                               atol=1e-6 * max(float(g.abs().max()), 1.0))
    assert not torch.equal(p1, p0)


# ---------------------------------------------------------------------------
# the padded validation and evaluation plans
# ---------------------------------------------------------------------------

def test_gsr_evaluate_over_the_padded_plan_gives_fold_means():
    """``GSRFoldRunner.evaluate`` on 2 ragged folds: each fold's MAE is
    the mean over its own subjects of the per-fold forward's."""
    lr, hr = _data(5)
    folds = _ragged_folds()
    cfg = GSRTrainConfig(epochs=1, **GSR_TINY)
    runner = GSRFoldRunner(cfg, lr, hr, folds, device="cpu")
    maes, preds = runner.evaluate(runner.flat0)
    assert tuple(preds.shape) == (2, 3, 32, 32)
    a_norm, hr_d, u_lr, _ = runner.data
    views = leaf_tensors_to_state(runner.layout.views(runner.flat0))
    model = runner.shards[0]._module
    for j, (_, va) in enumerate(folds):
        va = torch.from_numpy(np.asarray(va, np.int64))
        with torch.no_grad():
            want = functional_call(
                model, {k: t[j] for k, t in views.items()}, (a_norm[va],),
                {"u_lr": u_lr[va], "a_norm": a_norm[va]})[0]
        np.testing.assert_allclose(preds[j, :len(va)].numpy(),
                                   want.numpy(), rtol=0, atol=1e-6)
        mae = (want - fill_diagonal(hr_d[va], 1.0)).abs().mean(dim=(1, 2))
        np.testing.assert_allclose(maes[j], float(mae.mean()), rtol=1e-6)


def test_gat_validation_and_predictions_over_the_padded_plan():
    """The unfused validation on 2 ragged folds gives each fold's mean
    loss and off-diagonal MAE over its own subjects, as the per-fold
    forward; ``predict_gat_folds`` each fold's predictions."""
    folds = _ragged_folds()
    tr, lr, hr = _gat_trainer(5, folds)
    assert tuple(tr.va_idx.shape) == (2, 3)
    assert tr.va_valid.sum(1).tolist() == [len(va) for _, va in folds]
    with torch.no_grad():
        vloss, vmae = tr._validate(tr.p)
    views = tr.layout.views(tr.p)
    states = [{k: t.detach().clone().numpy() for k, t in
               gat_leaf_tensors_to_state({k: v[j] for k, v in
                                          views.items()}).items()}
              for j in range(2)]
    preds = gat_loop.predict_gat_folds(tr.model, states, tr.lr_d, tr.x_d,
                                       tr.va_idx.numpy())
    assert tuple(preds.shape) == (2, 3, 32, 32)
    for j, (_, va) in enumerate(folds):
        va = torch.from_numpy(np.asarray(va, np.int64))
        state = gat_leaf_tensors_to_state({k: v[j] for k, v in views.items()})
        with torch.no_grad():
            pred, a_hist, a_recon = functional_call(
                tr.model, state, (tr.lr_d[va], tr.x_d[va]))
            loss = gat_loop.unet_loss(pred, tr.hr_d[va], a_hist, a_recon)
            mae = gat_loop._offdiag_mae_all(pred, tr.hr_d[va])
        np.testing.assert_allclose(float(vloss[j]), float(loss.mean()),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(vmae[j]), float(mae.mean()),
                                   rtol=1e-6)
        np.testing.assert_allclose(preds[j, :len(va)].numpy(), pred.numpy(),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the data-parallel step
# ---------------------------------------------------------------------------

def test_sharded_batch_step_with_several_subjects_a_shard_matches_jax():
    """Batch 8 on 2 shards (4 subjects each, one forward a shard) against
    the JAX package's step on a 2-device mesh, from the same weights: loss,
    error and parameters within 2e-5."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from fcsr_tpu.parallel import batch_mesh as j_batch_mesh
    from fcsr_tpu.parallel import make_sharded_batch_step as j_step
    from fcsr_tpu.parallel import shard_batch as j_shard
    from fcsr_tpu.train import GSRTrainConfig as JConfig
    from fcsr_tpu.train import init_gsr as j_init
    from fcsr_tpu.train import precompute_spectral
    from fcsr_tpu_torch.iox.weights import flax_to_state
    from fcsr_tpu_torch.train import init_gsr

    cfg = dict(lr_dim=16, hr_dim=24, hidden_dim=24, ks=(0.8, 0.5))
    rng = np.random.default_rng(5)

    def sym(n):
        m = np.triu(rng.random((8, n, n)), k=1)
        return (m + m.transpose(0, 2, 1)).astype(np.float32)
    lr, hr = sym(16), sym(24)
    u_lr, u_hr = (np.asarray(u, np.float32) for u in precompute_spectral(
        lr, hr, lr_dim=16))
    jmesh = j_batch_mesh(jax.devices()[:2])
    model, params, tx, opt = j_init(JConfig(**cfg), jax.random.PRNGKey(2))
    rep = NamedSharding(jmesh, PartitionSpec())
    state0 = flax_to_state(jax.tree_util.tree_map(np.asarray, params))
    got_p, _, j_loss, j_err = j_step(model, tx, jmesh)(
        jax.device_put(params, rep), jax.device_put(opt, rep),
        *j_shard(jmesh, lr, hr, u_lr, u_hr))
    want = flax_to_state(jax.tree_util.tree_map(np.asarray, got_p))

    t_model, t_opt = init_gsr(GSRTrainConfig(**cfg), device="cpu")
    t_model.load_state_dict({k: torch.from_numpy(np.array(v))
                             for k, v in state0.items()})
    step = make_sharded_batch_step(t_model, t_opt,
                                   virtual_batch_mesh(2, "cpu"))
    loss, err = step(lr, hr, u_lr, u_hr)
    assert abs(float(loss) - float(j_loss)) <= 2e-5
    assert abs(float(err) - float(j_err)) <= 2e-5
    got = t_model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=2e-5, err_msg=k)
