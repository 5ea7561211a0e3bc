"""The port's ``utils`` helpers (initializations, logging, profiling,
debug, the package's exports) against the JAX package's (CPU). The JAX
package is imported inside the tests: this file's card test runs where
there is none."""

import json

import numpy as np
import pytest
import torch

from fcsr_tpu_torch import utils
from fcsr_tpu_torch.kernels import KERNEL_OPS, PLAIN_OPS, launch_counts
from fcsr_tpu_torch.kernels import ops
from fcsr_tpu_torch.utils.debug import eager_debug, nan_debug
from fcsr_tpu_torch.utils.initializations import (glorot_init,
                                                  glorot_uniform_square)
from fcsr_tpu_torch.utils.logging import MetricLogger
from fcsr_tpu_torch.utils.profiling import PhaseTimer, trace_if_enabled


@pytest.mark.parametrize("dim,seed", [(1, 0), (8, 3), (268, 42)])
def test_glorot_uniform_square_bit_equal(dim, seed):
    from fcsr_tpu.utils.initializations import glorot_uniform_square as jg
    got, want = glorot_uniform_square(dim, seed), jg(dim, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_glorot_init_bounds_and_seed():
    def draw(seed, shape):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return glorot_init(gen, shape, device="cpu")

    a, b, c = draw(5, (40, 60)), draw(5, (40, 60)), draw(6, (40, 60))
    limit = (6.0 / 100) ** 0.5
    assert a.dtype == torch.float32 and tuple(a.shape) == (40, 60)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= limit
    assert float(a.abs().max()) > 0.9 * limit        # fills its range
    assert abs(float(a.mean())) < 0.05 * limit
    # fans from the last two axes, as the JAX package's
    d = draw(1, (3, 10, 30))
    assert float(d.abs().max()) <= (6.0 / 40) ** 0.5
    assert glorot_init(torch.Generator().manual_seed(0), (4, 4),
                       dtype=torch.float64, device="cpu").dtype == \
        torch.float64


def test_phase_timer_records_as_jax():
    from fcsr_tpu.utils import PhaseTimer as JPhaseTimer
    reports = []
    for timer in (PhaseTimer(), JPhaseTimer()):
        for name in ("load", "train", "load"):
            with timer(name):
                sum(range(1000))
        with pytest.raises(KeyError):
            with timer("fails"):
                raise KeyError("x")
        reports.append(timer.report())
    got, want = reports
    assert list(got) == list(want) == ["load", "train", "fails"]
    assert all(v >= 0 for v in got.values())


def test_metric_logger_records_as_jax(tmp_path):
    import jax.numpy as jnp

    from fcsr_tpu.utils.logging import MetricLogger as JLogger
    records = []
    for name, logger, scalar in (
            ("port", MetricLogger, torch.tensor(1.25)),
            ("jax", JLogger, jnp.asarray(1.25))):
        path = tmp_path / name / "log.jsonl"
        log = logger(str(path))
        ret = [log.log("epoch", loss=1.5, epoch=0),
               log.log("epoch", loss=np.float32(1.2), epoch=1, tag="x"),
               log.log("val", mae=scalar, n=np.int64(3))]
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        assert lines == ret
        records.append([{k: v for k, v in r.items() if k != "t"}
                        for r in lines])
    assert records[0] == records[1]
    assert records[0][2] == {"event": "val", "mae": 1.25, "n": 3.0}


@pytest.mark.filterwarnings("ignore:Error detected in SqrtBackward0")
def test_nan_debug_raises_on_a_nan_in_backward():
    x = torch.zeros(3, requires_grad=True)
    with nan_debug():
        assert torch.is_anomaly_enabled()
        y = (torch.sqrt(x) * 0.0).sum()    # d sqrt at 0 is inf; inf * 0
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()
    assert not torch.is_anomaly_enabled()
    (torch.sqrt(x) * 0.0).sum().backward()  # outside: no check
    assert torch.isnan(x.grad).all()
    with nan_debug(False):
        assert not torch.is_anomaly_enabled()


def test_trace_if_enabled_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("FCSR_TRACE_DIR", raising=False)
    with trace_if_enabled():                 # off: no file anywhere
        torch.ones(4).sum()
    out = tmp_path / "trace"
    with trace_if_enabled(str(out)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(out.glob("fcsr_*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    env = tmp_path / "env"
    monkeypatch.setenv("FCSR_TRACE_DIR", str(env))
    with trace_if_enabled():
        torch.ones(4).sum()
    assert len(list(env.glob("fcsr_*.pt.trace.json"))) == 1


def test_eager_debug_scopes_the_launch_check():
    assert ops.SYNC_EACH_LAUNCH is False
    with eager_debug():
        assert ops.SYNC_EACH_LAUNCH is True
        with eager_debug(False):
            assert ops.SYNC_EACH_LAUNCH is False
        assert ops.SYNC_EACH_LAUNCH is True
        # CPU tensors take the plain version: nothing is launched
        x = torch.rand(2, 5, 5)
        torch.testing.assert_close(KERNEL_OPS.normalize_adj_batch(x),
                                   PLAIN_OPS.normalize_adj_batch(x))
    assert ops.SYNC_EACH_LAUNCH is False


def test_utils_exports_the_jax_names():
    import fcsr_tpu.utils as j_utils
    from fcsr_tpu.utils.debug import __all__ as j_debug
    from fcsr_tpu.utils.initializations import __all__ as j_init

    jax_names = {n for n in vars(j_utils) if not n.startswith("_")
                 and callable(getattr(j_utils, n))}
    # enable_persistent_cache is a TPU-runtime helper (an XLA cache)
    assert jax_names - {"enable_persistent_cache"} == {
        "set_seed", "seed_everything", "PhaseTimer", "trace_if_enabled"}
    assert jax_names - {"enable_persistent_cache"} <= set(utils.__all__)
    assert utils.seed_everything is utils.set_seed
    from fcsr_tpu_torch.utils import debug, initializations
    assert debug.__all__ == j_debug and initializations.__all__ == j_init


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: eager_debug synchronizes after "
                    "each kernel launch there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_eager_debug_on_card_keeps_results_and_counts(cuda_device):
    x = torch.rand(3, 33, 33, device=cuda_device)
    before = launch_counts()["normalize_adj_batch"]
    plain = KERNEL_OPS.normalize_adj_batch(x)
    with eager_debug():
        checked = KERNEL_OPS.normalize_adj_batch(x)
    assert launch_counts()["normalize_adj_batch"] == before + 2
    assert torch.equal(plain, checked)
