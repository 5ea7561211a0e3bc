"""The port's multi-process bootstrap (``fcsr_tpu_torch/parallel/
distributed.py``) on the CPU.

``torch.distributed.init_process_group`` is monkeypatched for the decision
logic (arguments, env fallbacks, backend) and the host-shard arithmetic,
mirroring the JAX package's tests/test_distributed.py; one real run starts
two processes in a ``gloo`` group, each with half the batch, and holds
their ``all_reduce``d data-parallel steps to the one-process step.
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fcsr_tpu_torch.parallel.distributed import (group_rank, group_size,
                                                 host_shard_slice,
                                                 maybe_initialize_distributed)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def fake_init(monkeypatch):
    calls = []

    def record(**kwargs):
        calls.append(kwargs)

    monkeypatch.setattr(dist, "init_process_group", record)
    for var in ("FCSR_COORDINATOR", "FCSR_NUM_PROCESSES",
                "FCSR_PROCESS_ID", "FCSR_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_noop_single_host(fake_init):
    assert maybe_initialize_distributed() is False
    assert fake_init == []


def test_explicit_args(fake_init):
    assert maybe_initialize_distributed("10.0.0.1:1234", 4, 2) is True
    assert fake_init == [{"backend": "nccl",
                          "init_method": "tcp://10.0.0.1:1234",
                          "world_size": 4, "rank": 2}]


def test_env_fallbacks(fake_init, monkeypatch):
    monkeypatch.setenv("FCSR_COORDINATOR", "host0:9999")
    monkeypatch.setenv("FCSR_NUM_PROCESSES", "8")
    monkeypatch.setenv("FCSR_PROCESS_ID", "3")
    assert maybe_initialize_distributed() is True
    assert fake_init == [{"backend": "nccl",
                          "init_method": "tcp://host0:9999",
                          "world_size": 8, "rank": 3}]


def test_env_process_id_defaults_to_zero(fake_init, monkeypatch):
    monkeypatch.setenv("FCSR_COORDINATOR", "host0:9999")
    monkeypatch.setenv("FCSR_NUM_PROCESSES", "2")
    assert maybe_initialize_distributed() is True
    assert fake_init[0]["rank"] == 0


def test_torchrun_env(fake_init, monkeypatch):
    monkeypatch.setenv("FCSR_DISTRIBUTED", "1")
    assert maybe_initialize_distributed() is True
    assert fake_init == [{"backend": "nccl", "init_method": "env://"}]


def test_coordinator_without_nprocs_is_noop(fake_init, monkeypatch):
    monkeypatch.setenv("FCSR_COORDINATOR", "host0:9999")
    assert maybe_initialize_distributed() is False
    assert fake_init == []


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda", "nccl"),
                                            ("cuda:1", "nccl")])
def test_backend_follows_the_device(fake_init, device, backend):
    assert maybe_initialize_distributed("h:1", 2, 1, device=device) is True
    assert fake_init[0]["backend"] == backend


def _fake_group(monkeypatch, rank, count):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: count)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)


@pytest.mark.parametrize("n,count", [(10, 4), (8, 4), (3, 4), (0, 4),
                                     (167, 8), (1, 1)])
def test_host_shard_slice_partition(monkeypatch, n, count):
    """Slices across all processes tile [0, n) exactly, in order, with
    sizes differing by at most the ceil-division remainder."""
    got = []
    for pid in range(count):
        _fake_group(monkeypatch, pid, count)
        assert (group_rank(), group_size()) == (pid, count)
        s = host_shard_slice(n)
        got.extend(range(n)[s])
        assert (s.stop - s.start) <= -(-n // count)
    assert got == list(range(n))


def test_host_shard_slice_single_process():
    assert not dist.is_initialized()
    assert (group_rank(), group_size()) == (0, 1)
    assert host_shard_slice(167) == slice(0, 167)


def test_host_shard_slice_usable_on_arrays(monkeypatch):
    _fake_group(monkeypatch, 1, 3)
    x = np.arange(10)
    np.testing.assert_array_equal(x[host_shard_slice(10)], [4, 5, 6, 7])


# ---------------------------------------------------------------------------
# two real processes
# ---------------------------------------------------------------------------

# One data-parallel step of GSR-Net and one of MLP v2 (BatchNorm, spectral
# norm, dropout 0.1), from the same seeds, on a 2-shard CPU mesh: argv is
# (port, rank, world size, output file). Each process takes its
# host_shard_slice of the batch; world size 1 is the one-process step.
_WORKER = r"""
import sys
import numpy as np
import torch
from fcsr_tpu_torch.parallel import (host_shard_slice,
                                     make_sharded_batch_step,
                                     make_sharded_generic_step,
                                     maybe_initialize_distributed,
                                     virtual_batch_mesh)
from fcsr_tpu_torch.models.mlp import SpectralResMLP
from fcsr_tpu_torch.train import init_gsr, precompute_spectral
from fcsr_tpu_torch.train.gsr_loop import GSRTrainConfig
from fcsr_tpu_torch.train.losses import (make_triu_mse_criterion,
                                         pack_triu_targets)

port, rank, world, out = sys.argv[1:5]
if int(world) > 1:
    assert maybe_initialize_distributed(f"127.0.0.1:{port}", int(world),
                                        int(rank), device="cpu")
rng = np.random.default_rng(0)


def sym(n, b):
    m = np.triu(rng.random((b, n, n)), k=1)
    return (m + m.transpose(0, 2, 1)).astype(np.float32)


lr, hr = sym(16, 8), sym(24, 8)
u_lr, u_hr = precompute_spectral(lr, hr, lr_dim=16)
mine = host_shard_slice(8)
mesh = virtual_batch_mesh(2, "cpu")
model, opt = init_gsr(GSRTrainConfig(lr_dim=16, hr_dim=24, hidden_dim=24,
                                     ks=(0.8, 0.5)), seed=1, device="cpu")
step = make_sharded_batch_step(model, opt, mesh)
loss, err = step(*(np.asarray(a, np.float32)[mine]
                   for a in (lr, hr, u_lr, u_hr)))

r, c = np.triu_indices(12, 1)
x = sym(12, 32)[:, r, c]
y = pack_triu_targets(sym(16, 32)).astype(np.float32)
mlp = SpectralResMLP(12, 16, 14, n_layers=1, dropout=0.1, output="vector",
                     device="cpu", seed=3)
gstep = make_sharded_generic_step(
    mlp, torch.optim.SGD(mlp.parameters(), lr=0.1), mesh,
    make_triu_mse_criterion(16))
mine = host_shard_slice(32)
gloss = gstep(x[mine], y[mine])
arrays = {"gsr:" + k: v.detach().numpy() for k, v in
          model.state_dict().items()}
arrays.update({"mlp:" + k: v.detach().numpy() for k, v in
               mlp.state_dict().items()})
np.savez(out, loss=float(loss), err=float(err), gloss=float(gloss),
         **arrays)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_one(tmp_path):
    """Two processes with half the batch each, their gradients (and the
    MLP's BatchNorm moments) ``all_reduce``d over gloo: losses, parameters
    and running statistics within 2e-5 of the same steps in one process
    over the whole batch, the two ranks bit-equal."""
    port = _free_port()
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(port), str(r), "2",
         str(outs[r])], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    one = tmp_path / "one.npz"
    solo = subprocess.run([sys.executable, "-c", _WORKER, "0", "0", "1",
                           str(one)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    assert solo.returncode == 0, solo.stderr[-3000:]
    want = np.load(one)
    ranks = [np.load(o) for o in outs]
    assert sorted(ranks[0].files) == sorted(want.files)
    assert any(k.endswith("running_var") for k in want.files)
    for k in want.files:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        np.testing.assert_allclose(ranks[0][k], want[k], atol=2e-5,
                                   err_msg=k)
