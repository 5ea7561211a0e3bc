"""The port's multi-device layer (``fcsr_tpu_torch/parallel``) on the CPU:
meshes of several shards on the one CPU (``virtual_batch_mesh``), as the
JAX package's tests split the host into 8 devices.

* Fold sharding: ``GSRFoldRunner(mesh=)`` (3 folds padded to 8 shards) is
  bit-equal to the unsharded run in ``fused_adam`` and within 2e-5 in the
  other modes, and within 1e-4 (loss) / 1e-5 (parameters) of the JAX
  package's sharded runner from the same initial weights;
  ``train_gat_folds_parallel(mesh=)`` equals the unsharded run at drop_p 0
  and 0.01 (fused).
* The data-parallel steps: ``make_sharded_batch_step`` within 2e-5 of the
  JAX package's on an 8-device mesh; ``make_sharded_generic_step`` (MLP
  v2: BatchNorm, spectral norm, dropout) within 2e-5 of the
  single-device step, running statistics included.
* The launch guard and the kernels' per-device set-up.

The JAX package is imported inside the tests that compare with it: the
card's machine has no JAX, and this file holds a ``cuda`` test.
"""

import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fcsr_tpu_torch import cli
from fcsr_tpu_torch.data import (kfold_indices, load_or_synthesize,
                                 synthesize_teacher_connectomes,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.iox import load_arrays
from fcsr_tpu_torch.iox.weights import gat_state_to_flat
from fcsr_tpu_torch.kernels.ops import Kernel
from fcsr_tpu_torch.models.mlp import SpectralResMLP
from fcsr_tpu_torch.parallel import (BatchMesh, batch_mesh,
                                     make_sharded_batch_step,
                                     make_sharded_generic_step, shard_batch,
                                     virtual_batch_mesh)
from fcsr_tpu_torch.train import GSRFoldRunner, GSRTrainConfig
from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig,
                                           train_gat_folds_parallel)
from fcsr_tpu_torch.train.losses import (make_triu_mse_criterion,
                                         pack_triu_targets)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(lr_dim=20, hr_dim=32, hidden_dim=32, ks=(0.9, 0.7))
GAT_TINY = dict(ks=(0.5, 0.5), n_nodes=20, m_nodes=32, dim=4, heads=2)
MODES = {"fused_step": dict(fused_step=True),
         "fused_tail": dict(fused_tail=True),
         "fused_tail_unet": dict(fused_tail=True, fused_unet=True),
         "fused_tail_unet_bwd": dict(fused_tail=True, fused_unet=True,
                                     fused_unet_bwd=True),
         "unfused": {}}


def _gsr_data(n=12):
    d = load_or_synthesize(None, n_train=n, n_test=1, seed=3)
    return (d["lr_train"][:, :20, :20].copy(),
            d["hr_train"][:, :32, :32].copy())


def _sym(rng, n, b):
    m = np.triu(rng.random((b, n, n)), k=1)
    return (m + m.transpose(0, 2, 1)).astype(np.float32)


def _run(cfg, lr, hr, folds, mesh=None, **kw):
    r = GSRFoldRunner(cfg, lr, hr, folds, device="cpu", mesh=mesh, **kw)
    p, loss, err = r.train()
    mae, preds = r.evaluate()
    return r, p, loss, err, mae, preds


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_meshes_and_shard_batch():
    mesh = virtual_batch_mesh(8, "cpu")
    assert isinstance(mesh, BatchMesh) and mesh.axis_names == ("batch",)
    assert mesh.size == 8 and set(mesh.devices) == {torch.device("cpu")}
    assert batch_mesh(["cpu"]).devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="distinct devices"):
        batch_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="at least one"):
        virtual_batch_mesh(0, "cpu")
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    shards = shard_batch(virtual_batch_mesh(4, "cpu"), x)
    assert len(shards) == 4 and all(s.shape == (2, 3) for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    a, b = shard_batch(virtual_batch_mesh(2, "cpu"), x, x[:, 0])
    assert a[1].shape == (4, 3) and b[1].shape == (4,)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(virtual_batch_mesh(3, "cpu"), x)


def test_mesh_constructors_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        virtual_batch_mesh(2)


# ---------------------------------------------------------------------------
# GSR-Net fold sharding
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gsr_case():
    lr, hr = _gsr_data()
    return lr, hr, kfold_indices(12, 3, seed=42)


def test_sharded_fused_adam_runner_is_bit_equal(gsr_case):
    """8 shards, 3 real folds padded with 5 masked no-op folds (one fold a
    shard): histories, parameters, MAEs and predictions bit-equal to the
    unsharded F = 3 run."""
    lr, hr, folds = gsr_case
    cfg = GSRTrainConfig(epochs=2, fused_adam=True, **TINY)
    _, p1, l1, e1, m1, pr1 = _run(cfg, lr, hr, folds)
    r2, p2, l2, e2, m2, pr2 = _run(cfg, lr, hr, folds,
                                   virtual_batch_mesh(8, "cpu"))
    assert r2.flat0.shape[0] == 8 and len(r2.shards) == 8
    assert r2.tr_valid[3:].sum() == 0 and r2.va_valid[3:].sum() == 0
    assert l2.shape == (3, 2) and tuple(p2.shape) == tuple(p1.shape)
    assert torch.equal(p1, p2) and torch.equal(pr1, pr2)
    for a, b in ((l1, l2), (e1, e2), (m1, m2)):
        np.testing.assert_array_equal(a, b)
    assert len(r2.params_per_fold()) == 3
    # padding folds start from init_seed + j, as in the JAX package
    r3 = GSRFoldRunner(cfg, lr, hr, folds, device="cpu", init_seed=5,
                       mesh=virtual_batch_mesh(8, "cpu"))
    np.testing.assert_array_equal(r3.flat0[7].numpy(), r3._init_flat(12))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sharded_runner_matches_single_in_every_mode(gsr_case, mode):
    lr, hr, folds = gsr_case
    cfg = GSRTrainConfig(epochs=1, **MODES[mode], **TINY)
    _, p1, l1, e1, m1, _ = _run(cfg, lr, hr, folds)
    _, p2, l2, e2, m2, _ = _run(cfg, lr, hr, folds,
                                virtual_batch_mesh(8, "cpu"))
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), atol=2e-5)
    for a, b in ((l1, l2), (e1, e2), (m1, m2)):
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_sharded_runner_matches_jax_sharded_runner(gsr_case):
    """The port on 8 shards against ``fcsr_tpu``'s GSRFoldRunner on a
    2-device mesh (3 folds padded to 4), from the JAX runner's initial
    weights: loss within 1e-4, parameters within 1e-5."""
    import jax
    from fcsr_tpu.parallel import batch_mesh as j_batch_mesh
    from fcsr_tpu.train import GSRTrainConfig as JConfig
    from fcsr_tpu.train.fast_loop import GSRFoldRunner as JRunner
    from fcsr_tpu_torch.iox.weights import flax_to_state, state_to_flat

    lr, hr, folds = gsr_case
    jr = JRunner(JConfig(epochs=2, fused_adam=True, **TINY), lr, hr, folds,
                 mesh=j_batch_mesh(jax.devices()[:2]))
    j_p, j_loss, j_err = jr.train()
    j_mae, _ = jr.evaluate()
    assert jr.flat0.shape[0] == 4
    flat0 = np.stack([state_to_flat(flax_to_state(jax.tree_util.tree_map(
        np.asarray, jr.unravel(jr.flat0[j])))) for j in range(3)])
    want = np.stack([state_to_flat(flax_to_state(jax.tree_util.tree_map(
        np.asarray, jr.unravel(j_p[j])))) for j in range(3)])
    cfg = GSRTrainConfig(epochs=2, fused_adam=True, **TINY)
    _, p, loss, err, mae, _ = _run(cfg, lr, hr, folds,
                                   virtual_batch_mesh(8, "cpu"), flat0=flat0)
    np.testing.assert_allclose(loss, np.asarray(j_loss), atol=1e-4)
    np.testing.assert_allclose(err, np.asarray(j_err), atol=1e-4)
    np.testing.assert_allclose(mae, np.asarray(j_mae), atol=1e-5)
    np.testing.assert_allclose(p.numpy(), want, atol=1e-5)


def test_sharded_runner_divisible_fold_count():
    """4 folds on 4 shards: no padding fold."""
    lr, hr = _gsr_data(8)
    folds = kfold_indices(8, 4, seed=42)
    cfg = GSRTrainConfig(epochs=1, fused_adam=True, **TINY)
    _, p1, l1, _, m1, _ = _run(cfg, lr, hr, folds)
    r2, p2, l2, _, m2, _ = _run(cfg, lr, hr, folds,
                                virtual_batch_mesh(4, "cpu"))
    assert r2.flat0.shape[0] == 4 and r2.tr_valid.sum() == \
        sum(len(tr) for tr, _ in folds)
    assert torch.equal(p1, p2)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(m1, m2)


def test_sharded_runner_chunks_and_checkpoints(tmp_path):
    """Chunked and checkpointed sharded runs equal the one-shot one (1e-6),
    a resume from the blob too; a blob written under another mesh size is
    discarded with a warning."""
    lr, hr = _gsr_data(10)
    folds = kfold_indices(10, 3, seed=42)
    cfg = GSRTrainConfig(epochs=4, fused_adam=True, **TINY)
    mesh = virtual_batch_mesh(2, "cpu")

    def runner(m=mesh):
        return GSRFoldRunner(cfg, lr, hr, folds, device="cpu", mesh=m)
    p1, l1, _ = runner().train()
    p2, l2, _ = runner().train(chunk_epochs=3)
    ck = str(tmp_path / "ck.npz")
    p3, l3, _ = runner().train(checkpoint_path=ck, checkpoint_every=2)
    for p, loss in ((p2, l2), (p3, l3)):
        np.testing.assert_allclose(p.numpy(), p1.numpy(), atol=1e-6)
        np.testing.assert_allclose(loss, l1, atol=1e-6)
    blob = load_arrays(ck)
    assert blob["p"].shape[0] == 4 and blob["loss_hist"].shape == (3, 4)
    # an interrupted run resumes exactly
    first = runner()
    state, lh, eh = first._run_chunk(first.fresh_state(), 1)
    assert isinstance(state[0], list) and len(state[0]) == 2
    ck2 = str(tmp_path / "ck2.npz")
    first.save_checkpoint(ck2, state, 1, lh, eh)
    p4, l4, _ = runner().train(checkpoint_path=ck2, checkpoint_every=3)
    np.testing.assert_allclose(p4.numpy(), p1.numpy(), atol=1e-6)
    np.testing.assert_allclose(l4, l1, atol=1e-6)
    # 3 folds on 4 shards pad to 4 as well; on 8 to 8: another state
    assert runner(virtual_batch_mesh(4, "cpu")).fingerprint == \
        runner().fingerprint
    other = runner(virtual_batch_mesh(8, "cpu"))
    assert other.fingerprint != runner().fingerprint
    with pytest.warns(UserWarning, match="different run"):
        p5, _, _ = other.train(checkpoint_path=ck2, checkpoint_every=4)
    np.testing.assert_allclose(p5.numpy(), p1.numpy(), atol=1e-6)
    assert load_arrays(ck2)["p"].shape[0] == 8


# ---------------------------------------------------------------------------
# GAT fold sharding
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gat_case():
    rng = np.random.default_rng(7)
    return _sym(rng, 20, 12), _sym(rng, 32, 12), kfold_indices(12, 3,
                                                                seed=42)


@pytest.mark.parametrize("drop_p,shards", [(0.0, 2), (0.01, 3)])
def test_gat_sharded_matches_single(gat_case, drop_p, shards):
    """drop_p 0 on 2 shards (3 folds padded to 4) and drop_p 0.01 on 3
    (a fold a shard): the fused trainer's histories and best weights equal
    the unsharded run's, dropout masks included (the seed table is drawn
    once for the real folds and sliced to the shards)."""
    lr, hr, folds = gat_case
    cfg = GATTrainConfig(epochs=2, drop_p=drop_p, fused_step=True,
                         **GAT_TINY)
    _, v1, h1 = train_gat_folds_parallel(cfg, lr, hr, folds, seed=42,
                                         device="cpu")
    _, v2, h2 = train_gat_folds_parallel(
        cfg, lr, hr, folds, seed=42, mesh=virtual_batch_mesh(shards, "cpu"))
    assert len(v2) == len(h2) == 3
    for a, b in zip(h1, h2):
        assert a == b
    for a, b in zip(v1, v2):
        np.testing.assert_array_equal(gat_state_to_flat(a),
                                      gat_state_to_flat(b))


def test_gat_mesh_refuses_host_control(gat_case):
    lr, hr, folds = gat_case
    cfg = GATTrainConfig(epochs=1, drop_p=0.0, **GAT_TINY)
    with pytest.raises(ValueError, match="on-device control"):
        train_gat_folds_parallel(cfg, lr, hr, folds, host_control=True,
                                 mesh=virtual_batch_mesh(2, "cpu"))


# ---------------------------------------------------------------------------
# the data-parallel steps
# ---------------------------------------------------------------------------

def test_sharded_batch_step_matches_jax():
    """One 8-shard step of GSR-Net (batch 8) against the JAX package's
    ``make_sharded_batch_step`` on its 8-device CPU mesh, from the same
    weights: loss and parameters within 2e-5."""
    import jax
    import optax
    from fcsr_tpu.parallel import batch_mesh as j_batch_mesh
    from fcsr_tpu.parallel import make_sharded_batch_step as j_step
    from fcsr_tpu.parallel import shard_batch as j_shard
    from fcsr_tpu.train import GSRTrainConfig as JConfig
    from fcsr_tpu.train import init_gsr as j_init
    from fcsr_tpu.train import precompute_spectral
    from fcsr_tpu_torch.iox.weights import flax_to_state
    from fcsr_tpu_torch.train import init_gsr
    from jax.sharding import NamedSharding, PartitionSpec

    cfg = dict(lr_dim=16, hr_dim=24, hidden_dim=24, ks=(0.8, 0.5))
    rng = np.random.default_rng(42)
    lr, hr = _sym(rng, 16, 8), _sym(rng, 24, 8)
    u_lr, u_hr = (np.asarray(u, np.float32) for u in precompute_spectral(
        lr, hr, lr_dim=16))
    jmesh = j_batch_mesh(jax.devices()[:8])
    model, params, tx, opt = j_init(JConfig(**cfg), jax.random.PRNGKey(1))
    rep = NamedSharding(jmesh, PartitionSpec())
    state0 = flax_to_state(jax.tree_util.tree_map(np.asarray, params))
    got_p, _, j_loss, j_err = j_step(model, tx, jmesh)(
        jax.device_put(params, rep), jax.device_put(opt, rep),
        *j_shard(jmesh, lr, hr, u_lr, u_hr))
    want = flax_to_state(jax.tree_util.tree_map(np.asarray, got_p))
    assert isinstance(tx, optax.GradientTransformation)

    t_model, t_opt = init_gsr(GSRTrainConfig(**cfg), device="cpu")
    t_model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                             for k, v in state0.items()})
    step = make_sharded_batch_step(t_model, t_opt,
                                   virtual_batch_mesh(8, "cpu"))
    loss, err = step(lr, hr, u_lr, u_hr)
    assert abs(float(loss) - float(j_loss)) <= 2e-5
    assert abs(float(err) - float(j_err)) <= 2e-5
    got = t_model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=2e-5, err_msg=k)


def _v2_case(seed=0, batch=32):
    rng = np.random.default_rng(seed)
    n_in, n_out = 12, 16
    r, c = np.triu_indices(n_in, 1)
    x = _sym(rng, n_in, batch)[:, r, c]
    y = pack_triu_targets(_sym(rng, n_out, batch)).astype(np.float32)
    model = SpectralResMLP(n_in, n_out, 14, n_layers=1, dropout=0.1,
                           output="vector", device="cpu", seed=3)
    return model, x, y, make_triu_mse_criterion(n_out)


def _single_generic_step(model, opt, x, y, crit):
    model.train()
    loss = crit(model(torch.from_numpy(x)), torch.from_numpy(y))
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_generic_step_matches_single(shards):
    """MLP v2 (spectral norm, BatchNorm, dropout 0.1), batch 32: two steps
    on the mesh against two single-device steps from the same weights and
    generator. BatchNorm normalises by the whole batch's moments and its
    running statistics take them; the dropout masks are the whole batch's
    draw, split. SGD: Adam's first step is lr * sign(g), which turns the
    float noise of the pre-BatchNorm biases' zero gradient into lr-sized
    moves and would compare noise."""
    import copy
    model, x, y, crit = _v2_case()
    twin = copy.deepcopy(model)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    opt2 = torch.optim.SGD(twin.parameters(), lr=0.1)
    step = make_sharded_generic_step(twin, opt2,
                                     virtual_batch_mesh(shards, "cpu"), crit)
    for _ in range(2):
        want = _single_generic_step(model, opt, x, y, crit)
        got = step(x, y)
        assert abs(float(got) - float(want)) <= 2e-5
    a = dict(model.named_parameters()) | dict(model.named_buffers())
    b = dict(twin.named_parameters()) | dict(twin.named_buffers())
    assert sorted(a) == sorted(b)
    assert any("running_var" in k for k in a)
    for k in a:
        np.testing.assert_allclose(b[k].detach().numpy(),
                                   a[k].detach().numpy(), atol=2e-5,
                                   err_msg=k)
    assert torch.equal(model.generator.get_state(),
                       twin.generator.get_state())


def test_sharded_steps_check_their_inputs():
    model, x, y, crit = _v2_case()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = make_sharded_generic_step(model, opt, virtual_batch_mesh(3, "cpu"),
                                     crit)
    with pytest.raises(ValueError, match="does not divide"):
        step(x, y)


# ---------------------------------------------------------------------------
# pipelines and the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    lr, hr, lt = synthesize_teacher_connectomes(6, lr_dim=20, hr_dim=32,
                                                seed=1, n_test=2)
    d = tmp_path_factory.mktemp("kaggle_parallel")
    write_kaggle_csvs({"lr_train": lr, "hr_train": hr, "lr_test": lt},
                      str(d))
    return str(d)


@pytest.mark.parametrize("family,flags", [("gsr", ["--fused"]),
                                          ("gat", ["--fused", "--dim",
                                                   "4"])])
def test_cli_multichip_equals_fast(csv_dir, tmp_path, capsys, family,
                                   flags):
    """``train gsr|gat --multichip --device cpu`` (the one-CPU mesh) writes
    the fold MAEs and submission of ``--fast``."""
    outs = {}
    for extra in (["--fast"], ["--multichip"]):
        out = tmp_path / extra[0].strip("-")
        assert cli.main(["train", family, *flags, *extra, "--epochs", "2",
                         "--splits", "2", "--data-dir", csv_dir,
                         "--out-dir", str(out), "--device", "cpu"]) == 0
        report = capsys.readouterr().out.strip().splitlines()[0]
        outs[extra[0]] = (json.loads(report)["fold_maes"],
                          (out / "submission.csv").read_bytes())
    assert outs["--fast"] == outs["--multichip"]


def test_pipelines_build_the_fold_mesh(monkeypatch):
    from fcsr_tpu_torch import pipelines
    assert pipelines._fold_mesh(False, 3, "cpu") is None
    assert pipelines._fold_mesh(True, 3, "cpu").devices == (
        torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    mesh = pipelines._fold_mesh(True, 3, "cuda")
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(3))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pipelines._fold_mesh(True, 5, "cuda").size == 2


# ---------------------------------------------------------------------------
# the launch guard and the kernels' per-device set-up
# ---------------------------------------------------------------------------

def test_kernel_refuses_a_launch_off_the_current_device(monkeypatch):
    """A launch whose operands lie on another card than the current one is
    refused before it reaches the C entry; a matching one launches."""
    k = Kernel("probe", "adam", "fcsr_probe", [], "here")
    seen = []
    k._fn = lambda *args: seen.append(args) or 0
    k._err = None
    stream = SimpleNamespace(device=torch.device("cuda", 1), cuda_stream=7)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    with pytest.raises(RuntimeError, match="current device cuda:1"):
        k(torch.device("cuda", 0), 1, 2)
    assert seen == [] and k.launches == 0
    k(torch.device("cuda", 1), 1, 2)
    assert seen == [(1, 2, 7)] and k.launches == 1


def test_shards_plan_for_the_real_fold_count(gsr_case, gat_case,
                                             monkeypatch):
    """Every step of the runners, sharded or not, runs inside
    ``plan_folds(<real folds>)`` (the kernels then plan a fold's sums as the
    unsharded run does); outside it a launch plans for its own folds."""
    from fcsr_tpu_torch.kernels import ops
    from fcsr_tpu_torch.train import fast_loop, gat_loop

    with ops.plan_folds(5):
        assert ops._PLAN_FOLDS.get() == 5
        with ops.plan_folds(2):
            assert ops._PLAN_FOLDS.get() == 2
        assert ops._PLAN_FOLDS.get() == 5
    assert ops._PLAN_FOLDS.get() == 0
    seen = []

    def spy(cls):
        step = cls.epoch_step if cls is gat_loop._FoldTrainer else cls.step

        def wrapped(self, *a, **kw):
            seen.append(ops._PLAN_FOLDS.get())
            return step(self, *a, **kw)
        monkeypatch.setattr(cls, step.__name__, wrapped)

    spy(fast_loop._FoldShard)
    spy(gat_loop._FoldTrainer)
    lr, hr, folds = gsr_case
    cfg = GSRTrainConfig(epochs=1, fused_adam=True, **TINY)
    GSRFoldRunner(cfg, lr, hr, folds, device="cpu").train()
    assert set(seen) == {3}
    seen.clear()
    GSRFoldRunner(cfg, lr, hr, folds, device="cpu",
                  mesh=virtual_batch_mesh(2, "cpu")).train()
    assert set(seen) == {3}
    seen.clear()
    lr, hr, folds = gat_case
    train_gat_folds_parallel(GATTrainConfig(epochs=1, fused_step=True,
                                            **GAT_TINY), lr, hr, folds,
                             mesh=virtual_batch_mesh(2, "cpu"))
    assert set(seen) == {3} and ops._PLAN_FOLDS.get() == 0


def test_kernel_set_up_is_per_device():
    """Every attribute a C entry sets once (opt-in shared memory, cluster
    size) and every value it reads from the card is kept per device, in
    tables indexed by cudaGetDevice: no process-wide flag or value is
    left."""
    csrc = REPO / "fcsr_tpu_torch" / "kernels" / "csrc"
    text = {p.name: p.read_text() for p in csrc.glob("*.cu*")}
    for name, src in text.items():
        assert not re.search(r"static bool\b", src), name
        assert not re.search(r"^(int|size_t) g_\w+ = 0", src, re.M), name
        for m in re.finditer(r"cudaFuncSetAttribute\(", src):
            before = src[:m.start()]
            fn = before[before.rfind("\nint "):]
            assert "current_device" in fn or "read_smem_optin" in fn, (
                name, fn[:60])
    assert "g_sms[MAX_DEVICES]" in text["bgemm.cu"]
    assert "g_smem_optin[MAX_DEVICES]" in text["common.cuh"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_sharded_fused_adam_on_card():
    """The ``fused_adam`` runner on 3- and 2-shard meshes of one card (F = 1
    a shard; 3 folds padded to 4) against the F = 3 run on the card:
    bit-equal, as chip_smoke.py holds it (phase 11 b): each shard's
    products are planned for the 3 real folds (``ops.plan_folds``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run on the card only")
    from fcsr_tpu_torch.kernels import launch_counts, reset_launch_counts
    lr, hr = _gsr_data()
    folds = kfold_indices(12, 3, seed=42)
    cfg = GSRTrainConfig(epochs=2, fused_adam=True, **TINY)
    runs = {}
    for shards in (None, 3, 2):
        mesh = None if shards is None else virtual_batch_mesh(shards, "cuda")
        r = GSRFoldRunner(cfg, lr, hr, folds, mesh=mesh)
        reset_launch_counts()
        p, loss, _ = r.train()
        assert launch_counts()["adam_masked"] == \
            r.tr_idx.shape[1] * 2 * len(r.shards)
        runs[shards] = (p.cpu().numpy(), loss, r.evaluate()[0])
    for shards in (3, 2):
        for a, b in zip(runs[None], runs[shards]):
            np.testing.assert_array_equal(a, b)
