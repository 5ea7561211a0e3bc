"""The benchmark's yardstick on the CPU: the manifest and the files it
names, the frozen data against the port's, the operation counts against
``torch.utils.flop_counter``, the references' parameters against the
port's models, and that nothing of JAX or the JAX package is loaded.

    python -m pytest h100_bench/tests -q
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402
from h100_bench.data import kfold, sub_seed, teacher_connectomes  # noqa: E402
from h100_bench.families import gat as gat_family  # noqa: E402
from h100_bench.families import gsr as gsr_family  # noqa: E402
from h100_bench.families.shared import (  # noqa: E402
    init_weights, product_flops)
from h100_bench.reference import common  # noqa: E402
from h100_bench.reference import gat_unet as gat_ref  # noqa: E402
from h100_bench.reference import gsr_net as gsr_ref  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files(cell):
    _, cfg, mix, _ = harness.load_cell(cell)
    assert cfg["family"] in ("gsr", "gat")
    assert mix["splits"] >= 2 and mix["min_runs"] >= 2
    assert set(cfg["check_limits"]) and all(
        float(v) >= 0 for v in cfg["check_limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_every_metric_has_a_reader(metric):
    read = harness._metric_reader(metric)
    assert callable(read)
    # a reader with nothing to read returns nothing
    from types import SimpleNamespace
    assert read(SimpleNamespace(runs=[], window_s=0.0, flops=0,
                                slice=None, work={})) is None


def test_manifest_contract_shape():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert {"cv_run_s", "cv_run_s.gat", "setup_s"} <= set(e2e)
    assert all(harness.quantity(n) in harness.END_TO_END for n in e2e)
    for cell in MANIFEST["workloads"]:
        reported = {m["name"] for m in harness.cell_metrics(
            MANIFEST, "end_to_end", cell)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = harness.cell_metrics(MANIFEST, "per_layer", cell)
        assert layers and all(m["moves"] in reported for m in layers)
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])


def test_teacher_generator_is_the_ports_bit_for_bit():
    from fcsr_tpu_torch.data.synthetic import synthesize_teacher_connectomes
    seed = sub_seed(2 ** 31 + 77, 0)
    ours = teacher_connectomes(4, seed=seed, n_test=2)
    port = synthesize_teacher_connectomes(4, seed=seed, n_test=2)
    for a, b in zip(ours, port):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,k", [(167, 3), (167, 5), (12, 3)])
def test_fold_plan_is_the_ports(n, k):
    from fcsr_tpu_torch.data.datamodule import kfold_indices
    seed = sub_seed(5, 1)
    for (a_tr, a_va), (b_tr, b_va) in zip(kfold(n, k, seed),
                                          kfold_indices(n, k, seed=seed)):
        assert np.array_equal(a_tr, b_tr) and np.array_equal(a_va, b_va)


def test_sub_seeds_take_large_seeds():
    s = sub_seed(2 ** 33 + 5, 2)
    assert 0 <= s < 2 ** 31
    assert sub_seed(2 ** 33 + 5, 2) == s != sub_seed(2 ** 33 + 5, 1)


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _params(spec, seed=0):
    _, views = init_weights(spec, 1, seed, "cpu")
    return {k: v[0].clone().requires_grad_() for k, v in views.items()}


def test_gsr_operation_count_matches_the_flop_counter():
    n, m, h, ks = 20, 32, 32, (0.9, 0.7, 0.6, 0.5)
    P = _params(gsr_ref.param_spec(n, m, h, len(ks)))
    rng = np.random.default_rng(0)
    u_lr = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    u_hr = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    hr = torch.from_numpy(rng.random((m, m)).astype(np.float32))
    train = _count(lambda: torch.autograd.grad(
        gsr_ref.sample_loss(P, ks, 16.0, u_lr, u_hr, hr), list(P.values())))
    assert train == product_flops(gsr_family.sample_products(n, m, h, ks),
                                  True)
    with torch.no_grad():
        fwd = _count(lambda: gsr_ref.predict(P, ks, u_lr[None].repeat(3, 1,
                                                                      1)))
    assert fwd == product_flops(gsr_family.unet_products(n, m, ks), False) \
        + 3 * product_flops(gsr_family.tail_products(n, m, h), False)


def test_gat_operation_count_matches_the_flop_counter():
    n, m, dim, ks, heads = 20, 32, 4, (0.5, 0.5, 0.5), 2
    P = _params(gat_ref.param_spec(n, m, dim, ks, heads))
    rng = np.random.default_rng(1)
    lr = rng.random((1, n, n)).astype(np.float32)
    lr = (lr + lr.transpose(0, 2, 1)) / 2
    x = torch.from_numpy(gat_ref.node_features(lr, dim))
    lr = torch.from_numpy(lr)
    hr = torch.from_numpy(rng.random((1, m, m)).astype(np.float32))

    def train():
        pred, hist, recons, _ = gat_ref.forward(P, lr, x, ks, heads)
        loss = gat_ref.loss_of(pred, hr, hist, recons).sum()
        torch.autograd.grad(loss, list(P.values()), allow_unused=True)
    prods = gat_family.sample_products(n, m, dim, ks, heads)
    assert _count(train) == product_flops(prods, True)
    with torch.no_grad():
        fwd = _count(lambda: gat_ref.forward(P, lr, x, ks, heads))
    assert fwd == product_flops(prods, False)


def test_reference_parameters_are_the_ports_models():
    from fcsr_tpu_torch.models.gat_unet import GATGraphUnet
    from fcsr_tpu_torch.models.gsr import GSRNet
    spec = gsr_ref.param_spec(160, 268, 268, 4)
    assert sum(int(np.prod(s)) for _, s, _, _ in spec) == 1023496
    port = GSRNet(device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(s) for k, s, _, _ in spec}
    spec = gat_ref.param_spec(160, 268, 16, (0.5, 0.5, 0.5), 4)
    assert sum(int(np.prod(s)) for _, s, _, _ in spec) == 82655
    port = GATGraphUnet(device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(s) for k, s, _, _ in spec}


def test_reference_forward_is_the_ports_model_at_small_size():
    """The references compute what the port's plain models compute (the
    same weights and inputs, on the CPU)."""
    from fcsr_tpu_torch.models.gat_unet import GATGraphUnet
    from fcsr_tpu_torch.models.gsr import GSRNet
    lr, hr, lr_t = teacher_connectomes(3, 20, 32, seed=3, n_test=2)
    model = GSRNet(lr_dim=20, hr_dim=32, hidden_dim=32, device="cpu")
    P = {k: v.detach() for k, v in model.state_dict().items()}
    u_lr, _ = common.spectral_bases(lr_t)
    u = torch.from_numpy(u_lr)
    ours, _ = gsr_ref.predict(P, model.ks, u)
    with torch.no_grad():
        port = model(torch.from_numpy(lr_t), u_lr=u)[0]
    assert common.rel_gap(port, ours) < 1e-5
    gat = GATGraphUnet(n_nodes=20, m_nodes=32, dim=4, heads=2, device="cpu")
    P = {k: v.detach() for k, v in gat.state_dict().items()}
    x = torch.from_numpy(gat_ref.node_features(lr, 4))
    ours = gat_ref.forward(P, torch.from_numpy(lr), x, gat.ks, 2)[0]
    with torch.no_grad():
        port = gat(torch.from_numpy(lr), x)[0]
    assert common.rel_gap(port, ours) < 1e-5


def test_forbidden_names_are_compared_whole():
    saved = dict(sys.modules)
    before = set(harness.forbidden_modules())
    try:
        sys.modules["fcsr_tpu_torch_lookalike"] = sys
        sys.modules["jaxtyping_lookalike.sub"] = sys
        assert set(harness.forbidden_modules()) == before
        sys.modules["fcsr_tpu.sub"] = sys
        assert set(harness.forbidden_modules()) == before | {"fcsr_tpu"}
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_card_path_loads_no_jax_and_reference_no_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import h100_bench.reference.gsr_net, h100_bench.reference.gat_unet\n"
        "import h100_bench.data\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('fcsr_tpu', 'fcsr_tpu_torch', 'jax', 'jaxlib', 'flax')], 'ref'\n"
        "from h100_bench import harness, trace\n"
        "import h100_bench.families.gsr, h100_bench.families.gat\n"
        "import fcsr_tpu_torch.pipelines, fcsr_tpu_torch.train.fast_loop\n"
        "import fcsr_tpu_torch.train.gat_loop\n"
        "for m in %r: harness._metric_reader(m)\n"
        "assert not harness.forbidden_modules(), harness.forbidden_modules()\n"
        % (str(ROOT), [m["name"] for m in MANIFEST["per_layer"]]))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


class _Ev:
    """A profiler event: name, device type and time range (us)."""

    def __init__(self, name, start, end, cuda=False):
        self.name, self.is_user_annotation = name, False
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_trace_leaves_the_profilers_flushes_out_of_the_window():
    """Idle time under the profiler's own buffer flush is tracing's cost:
    it leaves the window and the idle gaps; busy time stays."""
    from h100_bench import trace
    events = [_Ev(trace.MARK, 0, 100), _Ev("cudaGraphLaunch", 10, 30),
              _Ev("Buffer Flush", 40, 70), _Ev("k1", 0, 10, True),
              _Ev("k2", 30, 40, True), _Ev("k3", 50, 60, True),
              _Ev("Memcpy HtoD", 90, 100, True)]
    prof = type("P", (), {"events": lambda self: events})()
    s = trace.reduce(prof)
    # busy 10 + 10 + 10 + 10; idle 10-30, 40-50, 60-90; the flush covers
    # 40-50 and 60-70 of it
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["profiler_s"] == pytest.approx(20e-6)
    assert s["window_s"] == pytest.approx(80e-6)
    assert s["kernels"] == 3
    assert [g[0] for g in s["idle_gaps"]] == ["host", "cudaGraphLaunch"]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx([20e-6, 20e-6])


@pytest.mark.parametrize("drop_p", [0.0, 0.3])
def test_gat_reference_steps_follow_the_ports_trainer(drop_p):
    """Three AdamW steps of the port's fold-batched GAT trainer (its
    vmapped step, dropout from its own generator) and of the reference,
    from one seed's weights at 20 -> 32 on the CPU: the same losses and
    first gradients; a reference that draws another stream parts from it
    once anything is dropped."""
    from fcsr_tpu_torch.train import gat_loop
    from fcsr_tpu_torch.train.gat_loop import GATTrainConfig
    n, m, dim, heads, ks, F = 20, 32, 4, 2, (0.5, 0.5, 0.5), 3
    lr, hr, _ = teacher_connectomes(9, n, m, seed=11, n_test=1)
    folds = kfold(len(lr), F, 5)
    spec = gat_ref.param_spec(n, m, dim, ks, heads)
    _, w0 = init_weights(spec, F, 7, "cpu")
    from fcsr_tpu_torch.iox.weights import gat_state_to_flat
    flat0 = np.stack([gat_state_to_flat({k: v[f].numpy() for k, v in
                                         w0.items()}) for f in range(F)])
    cfg = GATTrainConfig(ks=ks, n_nodes=n, m_nodes=m, dim=dim, heads=heads,
                         drop_p=drop_p, lr=1e-3)
    tr = gat_loop._FoldTrainer(cfg, lr, hr, folds, 5, "cpu", flat0=flat0)
    p, mo, v = tr.p.clone(), tr.m.clone(), tr.v.clone()
    ours = []
    for s in range(3):
        i = torch.tensor([int(t[s]) for t, _ in folds])
        scal = torch.tensor([[1.0, cfg.lr, s + 1.0]] * F)
        loss, p, mo, v = tr.epoch_step(p, mo, v, i, scal, None)
        ours.append(loss.detach())
    ours = torch.stack(ours)
    x = torch.from_numpy(gat_ref.node_features(lr, dim))
    lr_t, hr_t = torch.from_numpy(lr), torch.from_numpy(hr)
    sites = gat_ref.dropout_sites(n, dim, ks, heads)
    for seed, same in ((5, True), (6, drop_p == 0)):
        gen = torch.Generator().manual_seed(seed)
        masks = [gat_ref.keep_masks(gen, F, sites, drop_p) for _ in range(3)]
        for f, (t, _) in enumerate(folds):
            samples = [(lr_t[j:j + 1], x[j:j + 1], hr_t[j:j + 1])
                       for j in t[:3]]
            drops = [gat_ref.dropper([mk[f] for mk in step], drop_p)
                     for step in masks]
            losses, _, _ = gat_ref.adamw_steps(
                {k: w[f] for k, w in w0.items()}, samples, drops, ks,
                heads, cfg.lr, cfg.weight_decay)
            gap = float((ours[:, f].double()
                         - torch.tensor(losses, dtype=torch.float64)
                         ).abs().max() / abs(losses[0]))
            assert (gap < 1e-5) == same, (seed, f, gap)
