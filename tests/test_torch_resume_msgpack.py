"""The JAX fast loop's msgpack resume blob (``fcsr_tpu/train/fast_loop.py``,
``GSRFoldRunner.train(checkpoint_path=...)``) read and written by the
port's runner, on the CPU at the tiny config (20 -> 32 nodes, ks=(0.9,
0.7), a 9-subject set, hidden width 16 in the ``fused_tail_unet_bwd``
mode, which both packages train), the JAX side in Pallas interpret mode.

A run interrupted in one package and resumed in the other ends within
1e-5 of the other package's uninterrupted run in its parameters (the
tolerance of bf16x3 against fp32 products over an epoch of Adam steps, as
in ``test_torch_gsr_trainers.py``) and 1e-4 in its losses; within the port
a msgpack resume is bit-exact, as the npz resume is.
"""

import os
import warnings

import numpy as np
import pytest
import torch
from flax import serialization as ser

from fcsr_tpu.train import GSRTrainConfig as JConfig
from fcsr_tpu.train.fast_loop import GSRFoldRunner as JRunner
from fcsr_tpu_torch.data import kfold_indices, synthesize_teacher_connectomes
from fcsr_tpu_torch.iox import load_arrays
from fcsr_tpu_torch.iox.checkpoint import (load_resume_msgpack,
                                           save_resume_msgpack)
from fcsr_tpu_torch.iox.weights import flat_from_flax_ravel
from fcsr_tpu_torch.parallel import virtual_batch_mesh
from fcsr_tpu_torch.train import GSRFoldRunner, GSRTrainConfig
from fcsr_tpu_torch.train.fast_loop import checkpoint_format

N, M, KS, H = 20, 32, (0.9, 0.7), 16
CFG = dict(epochs=2, lr_dim=N, hr_dim=M, hidden_dim=H, ks=KS,
           fused_tail=True, fused_unet=True, fused_unet_bwd=True)
SEED = 3


@pytest.fixture(scope="module")
def setup():
    lr, hr = synthesize_teacher_connectomes(9, lr_dim=N, hr_dim=M, seed=2)
    return lr, hr, kfold_indices(9, 2, seed=42)


def _port(setup, **kw):
    lr, hr, folds = setup
    cfg = GSRTrainConfig(**dict(CFG, **kw.pop("cfg", {})))
    kw.setdefault("init_seed", SEED)
    return GSRFoldRunner(cfg, lr, hr, folds, device="cpu", **kw)


def _jax_runner(setup):
    lr, hr, folds = setup
    return JRunner(JConfig(**CFG), lr, hr, folds, init_seed=SEED)


def _kernel_flat(x):
    return flat_from_flax_ravel(np.asarray(x), N, M, len(KS), H)


def _fingerprint_warnings(record):
    return [w for w in record if "fingerprint" in str(w.message)]


def test_fingerprint_is_the_jax_runners(setup):
    """The blob's fingerprint as the JAX runner computes it: config repr,
    init_seed, padded fold count, folds, data."""
    jr = _jax_runner(setup)
    assert _port(setup).jax_fingerprint == jr.fingerprint
    assert _port(setup, init_seed=SEED + 1).jax_fingerprint != \
        jr.fingerprint
    assert _port(setup, cfg=dict(epochs=3)).jax_fingerprint != \
        jr.fingerprint


def test_blob_bytes_are_flax_msgpack_serialize(tmp_path):
    """save_resume_msgpack writes flax's msgpack_serialize bytes of the
    JAX loop's blob dict, and reads them back."""
    rng = np.random.default_rng(0)
    p, m, v = (rng.normal(size=(2, 50)).astype(np.float32)
               for _ in range(3))
    t = np.array([4.0, 3.0], np.float32)
    hist = rng.normal(size=(2, 3)).astype(np.float32)
    path = str(tmp_path / "b.msgpack")
    save_resume_msgpack(path, p, m, v, t, 3, "00ff", hist, 2 * hist)
    blob = {"state": [p, m, v, t], "epoch": 3, "fingerprint": "00ff",
            "loss_hist": hist, "err_hist": 2 * hist}
    with open(path, "rb") as f:
        assert f.read() == ser.msgpack_serialize(blob)
    back = load_resume_msgpack(path)
    assert back["epoch"] == 3 and back["fingerprint"] == "00ff"
    for a, b in zip(back["state"], (p, m, v, t)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not a resume blob"):
        ser_path = str(tmp_path / "w.msgpack")
        with open(ser_path, "wb") as f:
            f.write(ser.msgpack_serialize({"params": {"x": p}}))
        load_resume_msgpack(ser_path)


def test_format_rule(tmp_path):
    """msgpack where the file is a msgpack blob, or a new path ending in
    .msgpack; npz everywhere else."""
    assert checkpoint_format(str(tmp_path / "new.msgpack")) == "msgpack"
    assert checkpoint_format(str(tmp_path / "new.npz")) == "npz"
    assert checkpoint_format(str(tmp_path / "new.ckpt")) == "npz"
    npz_named = str(tmp_path / "old.msgpack")
    with open(npz_named, "wb") as f:
        np.savez(f, x=np.zeros(1))
    assert checkpoint_format(npz_named) == "npz"
    packed = str(tmp_path / "old.bin")
    save_resume_msgpack(packed, *(np.zeros((1, 2), np.float32),) * 3,
                        np.zeros(1, np.float32), 0, "", np.zeros((1, 0)),
                        np.zeros((1, 0)))
    assert checkpoint_format(packed) == "msgpack"


def test_port_resumes_a_jax_blob(setup, tmp_path):
    """JAX runs epoch 1 of 2 and its blob is written as fast_loop.py:546-553
    writes it; the port resumes it without a warning and ends within 1e-5
    of JAX's uninterrupted run; the blob it leaves is the JAX layout."""
    jr = _jax_runner(setup)
    n = jr.n_folds
    state, lh, eh = jr._run_chunk(jr.fresh_state(), 1)
    blob = {"state": [np.asarray(x) for x in state], "epoch": 1,
            "fingerprint": jr.fingerprint,
            "loss_hist": np.asarray(lh)[:n], "err_hist": np.asarray(eh)[:n]}
    ck = str(tmp_path / "run.ck")                # msgpack by its content
    with open(ck, "wb") as f:
        f.write(ser.msgpack_serialize(blob))
    j_p, j_loss, j_err = _jax_runner(setup).train()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        p, loss, err = _port(setup).train(checkpoint_path=ck,
                                          checkpoint_every=1)
    assert not _fingerprint_warnings(record)
    np.testing.assert_allclose(p.numpy(), _kernel_flat(j_p), atol=1e-5)
    np.testing.assert_array_equal(loss[:, :1], np.asarray(lh)[:n])
    np.testing.assert_allclose(loss, np.asarray(j_loss), atol=1e-4)
    np.testing.assert_allclose(err, np.asarray(j_err), atol=1e-4)
    with open(ck, "rb") as f:
        out = ser.msgpack_restore(f.read())
    assert out["epoch"] == 2 and out["fingerprint"] == jr.fingerprint
    np.testing.assert_array_equal(_kernel_flat(out["state"][0]), p.numpy())
    np.testing.assert_array_equal(out["loss_hist"], loss)


def test_jax_resumes_a_port_blob(setup, tmp_path):
    """The port runs epoch 1 of 2 and writes a .msgpack blob; the JAX
    runner resumes it without a warning and ends within 1e-5 of the
    port's uninterrupted run."""
    first = _port(setup)
    state, lh, eh = first._run_chunk(first.fresh_state(), 1)
    ck = str(tmp_path / "ck.msgpack")
    first.save_checkpoint(ck, state, 1, lh, eh)
    p, loss, err = _port(setup).train()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        j_p, j_loss, j_err = _jax_runner(setup).train(checkpoint_path=ck,
                                                      checkpoint_every=1)
    assert not _fingerprint_warnings(record)
    np.testing.assert_array_equal(np.asarray(j_loss)[:, 0], loss[:, 0])
    np.testing.assert_allclose(_kernel_flat(j_p), p.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(j_loss), loss, atol=1e-4)
    np.testing.assert_allclose(np.asarray(j_err), err, atol=1e-4)


def test_stale_blob_is_discarded_with_the_jax_warning(setup, tmp_path):
    """Another run's msgpack blob at the path: the JAX warning, the file
    removed, the run trained from scratch and its own blob written."""
    ck = str(tmp_path / "ck.msgpack")
    other = _port(setup, cfg=dict(lr=3e-4))
    state, lh, eh = other._run_chunk(other.fresh_state(), 1)
    other.save_checkpoint(ck, state, 1, lh, eh)
    p_want, l_want, _ = _port(setup).train()
    runner = _port(setup)
    with pytest.warns(UserWarning, match=r"\(config/folds/dataset "
                      r"fingerprint mismatch\) — discarding it"):
        p, loss, _ = runner.train(checkpoint_path=ck, checkpoint_every=1)
    assert torch.equal(p, p_want)
    np.testing.assert_array_equal(loss, l_want)
    blob = load_resume_msgpack(ck)
    assert blob["fingerprint"] == runner.jax_fingerprint
    assert blob["epoch"] == 2


@pytest.mark.parametrize("mode", ["fused_tail_unet_bwd", "fused_adam"])
def test_msgpack_resume_is_exact_in_the_port(setup, tmp_path, mode):
    """Interrupted after epoch 1 and resumed from the .msgpack blob by a
    fresh runner: bit-equal to the straight run, at hidden 16 and in
    fused_adam at hidden == hr (the npz path's guarantee)."""
    kw = {} if mode != "fused_adam" else dict(
        fused_tail=False, fused_unet=False, fused_unet_bwd=False,
        fused_adam=True, hidden_dim=M)
    p_want, l_want, e_want = _port(setup, cfg=kw).train()
    first = _port(setup, cfg=kw)
    state, lh, eh = first._run_chunk(first.fresh_state(), 1)
    ck = str(tmp_path / "ck.msgpack")
    first.save_checkpoint(ck, state, 1, lh, eh)
    p, loss, err = _port(setup, cfg=kw).train(checkpoint_path=ck,
                                              checkpoint_every=1)
    assert torch.equal(p, p_want)
    np.testing.assert_array_equal(loss, l_want)
    np.testing.assert_array_equal(err, e_want)


def test_msgpack_resume_under_a_mesh(setup, tmp_path):
    """3 folds on a 2-shard mesh (padded to 4): the blob holds the padded
    stack, hashes the padded count, and a resume is bit-equal to the
    straight sharded run; an unsharded runner discards it (another padded
    count), and an npz path keeps the npz blob."""
    lr, hr, _ = setup
    folds = kfold_indices(9, 3, seed=42)
    cfg = GSRTrainConfig(**CFG)

    def runner(mesh=None):
        return GSRFoldRunner(cfg, lr, hr, folds, init_seed=SEED,
                             device="cpu",
                             mesh=mesh or virtual_batch_mesh(2, "cpu"))
    p_want, l_want, _ = runner().train()
    first = runner()
    state, lh, eh = first._run_chunk(first.fresh_state(), 1)
    ck = str(tmp_path / "ck.msgpack")
    first.save_checkpoint(ck, state, 1, lh, eh)
    blob = load_resume_msgpack(ck)
    assert blob["state"][0].shape[0] == 4 and blob["loss_hist"].shape == (3, 1)
    p, loss, _ = runner().train(checkpoint_path=ck, checkpoint_every=1)
    assert torch.equal(p, p_want)
    np.testing.assert_array_equal(loss, l_want)
    alone = GSRFoldRunner(cfg, lr, hr, folds, init_seed=SEED, device="cpu")
    assert alone.jax_fingerprint != first.jax_fingerprint
    npz = str(tmp_path / "ck.npz")
    runner().train(checkpoint_path=npz, checkpoint_every=1)
    assert load_arrays(npz)["hidden_dim"] == H
    assert os.path.exists(npz) and checkpoint_format(npz) == "npz"
