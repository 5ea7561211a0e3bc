"""GSR-Net with a decoder width ``hidden_dim`` other than ``hr_dim`` in the
port against the JAX package, on the CPU at the tiny config (20 -> 32
nodes, ks=(0.9, 0.7), a 9-subject set), the JAX side in Pallas interpret
mode as its own tests run it.

The JAX package trains such a model in its unfused and three
``fused_tail`` modes, and its ``tail_loss_fused`` (#4) and
``step_value_and_grad_fused`` (#10) take it; its whole-step kernels #8 and
#9 (``fused_step``, ``fused_adam``) fail there, and the port refuses them
with a ``ValueError`` before any launch.

Tolerances, as in ``test_torch_gsr_trainers.py`` and
``test_torch_fused_entry_points.py``: the JAX kernels' products are bf16x3,
the port's fp32, so over a handful of Adam steps a loss moves by up to
1e-4 and a parameter by up to 1e-5; an entry point's value agrees to 1e-5
relative and its gradients to 3e-4 of their largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fcsr_tpu.models import fused_step as j_fused_step
from fcsr_tpu.models import fused_tail as j_fused_tail
from fcsr_tpu.train import GSRTrainConfig as JConfig
from fcsr_tpu.train import init_gsr as j_init_gsr
from fcsr_tpu.train.fast_loop import GSRFoldRunner as JRunner
from fcsr_tpu_torch import cli
from fcsr_tpu_torch.core.normalize import normalize_adj_np
from fcsr_tpu_torch.data import (kfold_indices, load_or_synthesize,
                                 synthesize_teacher_connectomes,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.iox import (load_params, save_arrays, save_state,
                                submission_frame)
from fcsr_tpu_torch.iox.weights import (flat_from_flax_ravel, flat_to_state,
                                        flat_to_flax_ravel, flax_to_state,
                                        state_to_flat, state_to_leaf_tensors)
from fcsr_tpu_torch.models import (FlatLayout, gsr_step_loss_fused,
                                   step_value_and_grad_fused,
                                   tail_loss_fused, tail_loss_reference,
                                   train_step_fused, train_step_plain)
from fcsr_tpu_torch.models.fused_step import leaf_specs
from fcsr_tpu_torch.models.gsr import GSRNet
from fcsr_tpu_torch.train import GSRFoldRunner, GSRTrainConfig, predict_gsr
from fcsr_tpu_torch.train import fast_loop

N, M, KS, H = 20, 32, (0.9, 0.7), 16
LMBDA = 16.0
MODES = {
    "unfused": {},
    "fused_tail": dict(fused_tail=True),
    "fused_tail_unet": dict(fused_tail=True, fused_unet=True),
    "fused_tail_unet_bwd": dict(fused_tail=True, fused_unet=True,
                                fused_unet_bwd=True),
}
REFUSED = {"fused_step": dict(fused_step=True),
           "fused_adam": dict(fused_adam=True)}


def _dims(hidden):
    return dict(lr_dim=N, hr_dim=M, hidden_dim=hidden, ks=KS)


def _data(n=9):
    return synthesize_teacher_connectomes(n, lr_dim=N, hr_dim=M, seed=2)


def _flax(hidden, seed):
    """The JAX package's GSR-Net init at width ``hidden``, numpy leaves."""
    _, params, _, _ = j_init_gsr(JConfig(**_dims(hidden)),
                                 jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def _spectral(rng, F):
    """u_lr (F, N, N), u_hr (F, M, N), hr (F, M, M) float32."""
    lrs = []
    for _ in range(F):
        a = np.triu(rng.random((N, N)), k=1)
        lrs.append((a + a.T).astype(np.float32))
    u_lr = np.stack([np.linalg.eigh(normalize_adj_np(a))[1]
                     for a in lrs]).astype(np.float32)
    u_hr = rng.normal(size=(F, M, N)).astype(np.float32)
    hr = np.abs(rng.normal(size=(F, M, M))).astype(np.float32)
    hr = 0.5 * (hr + hr.transpose(0, 2, 1))
    return u_lr, u_hr, hr


def _close_scaled(got, want, atol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=name)


# ---------------------------------------------------------------- layouts

@pytest.mark.parametrize("hidden", [H, M, 48])
def test_flat_layout_is_the_jax_ravel_at_any_width(hidden):
    """FlatLayout.size is the length of ravel_pytree(cfg.model().init()),
    and the ravel permutation carries JAX's flat vector to the one
    flax_to_state -> state_to_flat gives, and back."""
    params = _flax(hidden, 3)
    flat, _ = ravel_pytree(params)
    flat = np.asarray(flat)
    layout = FlatLayout(N, M, len(KS), hidden)
    assert layout.size == flat.size
    specs = dict(layout.specs)
    assert specs["gc1.weight"] == (M, hidden)
    assert specs["gc2.weight"] == (hidden, M)
    want = state_to_flat(flax_to_state(params))
    got = flat_from_flax_ravel(flat[None], N, M, len(KS), hidden)
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(
        flat_to_flax_ravel(got, N, M, len(KS), hidden)[0], flat)
    state = flat_to_state(want, layout.shapes)
    assert state["gc1.weight"].shape == (M, hidden)
    np.testing.assert_array_equal(state["gc2.weight"],
                                  params["params"]["gc2"]["weight"])


def test_default_width_keeps_every_offset():
    """hidden_dim None or hr_dim: the layout every caller had."""
    assert FlatLayout(N, M, 2) == FlatLayout(N, M, 2, M)
    assert FlatLayout(N, M, 2).hidden_dim == M
    assert leaf_specs(N, M, 2) == leaf_specs(N, M, 2, M)
    assert FlatLayout(160, 268, 4).size == 1023496


@pytest.mark.parametrize("kw", [
    {}, dict(_dims(H), epochs=3, fused_tail=True),
    dict(lr=3e-4, lmbda=2.0, padding=2, ks=(0.5,), fused_adam=True,
         compute_dtype="bf16")], ids=["default", "narrow_tail", "flags"])
def test_config_repr_is_the_jax_configs(kw):
    """The msgpack blob's fingerprint hashes repr(cfg): the port's config
    has the JAX one's fields in the same order and the same name."""
    assert [f.name for f in dataclasses.fields(GSRTrainConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    assert repr(GSRTrainConfig(**kw)) == repr(JConfig(**kw))


# ---------------------------------------------------------- entry points

@pytest.mark.parametrize("hidden", [H, 48])
def test_tail_loss_fused_matches_jax_at_hidden(rng, hidden):
    """#4 at hidden != hr over a fold batch of 2: value and the four
    gradients under a cotangent of 2.5 against the JAX kernel's, and
    against autograd over the port's plain tail."""
    F = 2
    w_gsr = rng.normal(size=(F, M, N)).astype(np.float32)
    w1 = rng.uniform(-0.3, 0.3, (F, M, hidden)).astype(np.float32)
    w2 = rng.uniform(-0.3, 0.3, (F, hidden, M)).astype(np.float32)
    f = rng.normal(0, 0.3, (F, N, M)).astype(np.float32)
    data = _spectral(rng, F)
    diff = [torch.from_numpy(a).requires_grad_()
            for a in (w_gsr, w1, w2, f)]
    loss = tail_loss_fused(*diff, *map(torch.from_numpy, data),
                           device="cpu")
    (2.5 * loss).sum().backward()
    _, _, ref = tail_loss_reference(*[torch.from_numpy(a) for a in (
        w_gsr, w1, w2, f, *data)])
    for j in range(F):
        args = [jnp.asarray(a[j]) for a in (w_gsr, w1, w2, f, *data)]
        jl, jg = jax.value_and_grad(
            lambda *a: 2.5 * j_fused_tail.tail_loss_fused(*a, interpret=True),
            argnums=(0, 1, 2, 3))(*args)
        np.testing.assert_allclose(2.5 * float(loss[j].detach()), float(jl),
                                   rtol=1e-5)
        for name, t, w, r in zip(("w_gsr", "w1", "w2", "f"), diff, jg, ref):
            _close_scaled(t.grad[j].numpy(), w, 3e-4, name)
            _close_scaled(t.grad[j].numpy(), 2.5 * r[j].numpy(), 1e-5, name)


def test_step_value_and_grad_fused_matches_jax_at_hidden(rng):
    """#10 at hidden 16 over a fold batch of 2: loss and recon within 1e-5
    relative of the JAX kernel's, every gradient (gc1 (32, 16), gc2
    (16, 32) among them) within 3e-4 of its scale; a hidden_dim that is not
    gc1's width is refused."""
    F = 2
    flaxes = [_flax(H, seed) for seed in range(F)]
    states = [flax_to_state(p) for p in flaxes]
    state = {k: torch.from_numpy(np.stack([s[k] for s in states]))
             for k in states[0]}
    data = _spectral(rng, F)
    loss, recon, grads = step_value_and_grad_fused(
        state, *map(torch.from_numpy, data), KS, N, M, H, LMBDA,
        device="cpu")
    assert grads["gc1.weight"].shape == (F, M, H)
    assert grads["gc2.weight"].shape == (F, H, M)
    for j in range(F):
        jl, jr, jg = j_fused_step.step_value_and_grad_fused(
            flaxes[j], *[jnp.asarray(a[j]) for a in data], KS, N, M, H,
            LMBDA, interpret=True)
        np.testing.assert_allclose(float(loss[j]), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(recon[j]), float(jr), rtol=1e-5)
        want = flax_to_state(jax.tree_util.tree_map(np.asarray, jg))
        assert sorted(want) == sorted(grads)
        for k, w in want.items():
            _close_scaled(grads[k][j].numpy(), w, 3e-4, k)
    with pytest.raises(ValueError, match="gc1.weight"):
        step_value_and_grad_fused(state, *map(torch.from_numpy, data), KS,
                                  N, M, M, LMBDA, device="cpu")


def test_whole_step_kernels_refuse_hidden(rng):
    """#8 and #9 (and #9's plain version) raise before any launch, as the
    JAX kernels fail at hidden != hr."""
    state = {k: torch.from_numpy(np.array(v))[None]
             for k, v in flax_to_state(_flax(H, 0)).items()}
    leaves = state_to_leaf_tensors(state)
    data = [torch.from_numpy(a) for a in _spectral(rng, 1)]
    net = {k: t for k, t in leaves.items() if ":" in k}
    with pytest.raises(ValueError, match="hidden_dim == hr_dim only"):
        gsr_step_loss_fused(net, leaves["layer.weights"],
                            leaves["gc1.weight"], leaves["gc2.weight"],
                            *data, KS, N, M, LMBDA, device="cpu")
    p = torch.zeros(1, FlatLayout(N, M, len(KS), H).size)
    scal = torch.tensor([[1.0, 0.1, 0.001]])
    for step in (train_step_fused, train_step_plain):
        kw = {"device": "cpu"} if step is train_step_fused else {}
        with pytest.raises(ValueError, match="fused_step.py:344-347"):
            step(p, p.clone(), p.clone(), *data, scal, KS, N, M, LMBDA,
                 1e-4, **kw)


@pytest.mark.parametrize("mode", sorted(REFUSED))
def test_runner_refuses_whole_step_modes_before_staging(monkeypatch, mode):
    def staged(*a, **kw):
        raise AssertionError("staged before the refusal")
    monkeypatch.setattr(fast_loop, "stage_dataset", staged)
    lr, hr = _data(4)
    with pytest.raises(ValueError, match=f"{mode} at hidden_dim 16"):
        GSRFoldRunner(GSRTrainConfig(**_dims(H), **REFUSED[mode]), lr, hr,
                      kfold_indices(4, 2, seed=42), device="cpu")


# ------------------------------------------------------------ the runner

@pytest.mark.parametrize("mode,hidden", [(m, H) for m in MODES]
                         + [("fused_tail_unet_bwd", 48)])
def test_runner_matches_jax_at_hidden(mode, hidden):
    """2 epochs over 2 folds of the 9 subjects (one masked step an epoch),
    from the JAX runner's init carried by the ravel permutation: loss and
    err within 1e-4, parameters and val MAE within 1e-5."""
    lr, hr = _data()
    folds = kfold_indices(9, 2, seed=42)
    cfg = dict(epochs=2, **_dims(hidden), **MODES[mode])
    jr = JRunner(JConfig(**cfg), lr, hr, folds)
    j_p, j_loss, j_err = jr.train()
    j_mae, _ = jr.evaluate()
    flat0 = flat_from_flax_ravel(np.asarray(jr.flat0), N, M, len(KS), hidden)
    r = GSRFoldRunner(GSRTrainConfig(**cfg), lr, hr, folds, flat0=flat0,
                      device="cpu")
    assert r.mode == mode and r.tr_valid.sum() < r.tr_valid.size
    p, loss, err = r.train()
    mae, preds = r.evaluate()
    assert tuple(preds.shape) == (2, 5, M, M)
    np.testing.assert_allclose(loss, np.asarray(j_loss), atol=1e-4)
    np.testing.assert_allclose(err, np.asarray(j_err), atol=1e-4)
    np.testing.assert_allclose(
        p.numpy(), flat_from_flax_ravel(np.asarray(j_p), N, M, len(KS),
                                        hidden), atol=1e-5)
    np.testing.assert_allclose(mae, np.asarray(j_mae), atol=1e-5)
    states = r.params_per_fold()
    assert states[1]["gc1.weight"].shape == (M, hidden)
    assert np.all(loss[:, -1] < loss[:, 0])                  # it trains


def test_npz_blob_and_predict_carry_the_width(tmp_path):
    """The npz resume blob records hidden_dim and load_params reads it (a
    blob without it is at hr_dim); ``predict`` takes the width from
    gc1.weight."""
    lr, hr = _data(5)
    cfg = GSRTrainConfig(epochs=1, **_dims(H))
    r = GSRFoldRunner(cfg, lr, hr, kfold_indices(5, 2, seed=42),
                      device="cpu")
    ck = str(tmp_path / "ck.npz")
    r.train(checkpoint_path=ck)
    blob = dict(np.load(ck))
    assert int(blob["hidden_dim"]) == H
    params = load_params(ck)
    assert params["gc1.weight"].shape == (M, H)
    for k, a in r.params_per_fold()[-1].items():
        np.testing.assert_array_equal(params[k], a)
    wide = GSRFoldRunner(dataclasses.replace(cfg, hidden_dim=M), lr, hr,
                         kfold_indices(5, 2, seed=42), device="cpu")
    old = str(tmp_path / "old.npz")
    wide.save_checkpoint(old, wide.fresh_state(), 0, np.zeros((2, 0)),
                         np.zeros((2, 0)))
    save_arrays(old, **{k: v for k, v in dict(np.load(old)).items()
                        if k != "hidden_dim"})
    assert load_params(old)["gc2.weight"].shape == (M, M)

    data_dir, out = str(tmp_path / "csv"), str(tmp_path / "sub.csv")
    full = synthesize_teacher_connectomes(7, lr_dim=N, hr_dim=M, seed=4)
    write_kaggle_csvs({"lr_train": full[0][:5], "hr_train": full[1][:5],
                       "lr_test": full[0][5:]}, data_dir)
    # predict builds the shipped U-Net (4 levels) around the file's dims
    ks4 = GSRTrainConfig().ks
    model = GSRNet(ks4, N, M, H, device="cpu", seed=1)
    path = str(tmp_path / "params.npz")
    save_state(model.state_dict(), path)
    assert cli.main(["predict", "--params", path, "--data-dir", data_dir,
                     "--out", out, "--ordering", "colmajor", "--device",
                     "cpu"]) == 0
    lr_test = load_or_synthesize(data_dir, device="cpu")["lr_test"]
    want = predict_gsr(None, model, GSRTrainConfig(lr_dim=N, hr_dim=M,
                                                   hidden_dim=H), lr_test)
    _, flat = submission_frame(want, "colmajor")
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    np.testing.assert_allclose(rows[:, 1], flat, rtol=1e-6, atol=1e-7)
