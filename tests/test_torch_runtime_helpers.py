"""The JAX package's checkpoint and runtime helpers in the port:
``iox.load_pytree(template, path)`` against ``fcsr_tpu.iox.load_pytree``,
``core.symmetric_normalize`` against ``fcsr_tpu.core``'s, and
``utils/{probe,compile_cache,transfer}.py`` on the CPU.
"""

import collections
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.iox import load_pytree, save_pytree
from fcsr_tpu_torch.kernels import build
from fcsr_tpu_torch.utils import enable_persistent_cache, probe, transfer

ROOT = Path(__file__).resolve().parents[1]
GSR_FILE = ROOT / "outputs" / "gsr" / "gsr_net_trained.msgpack"


def _same_tree(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jax_template():
    import jax

    from fcsr_tpu.train import GSRTrainConfig, init_gsr
    _, params, _, _ = init_gsr(GSRTrainConfig(), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def test_load_pytree_takes_the_jax_signature():
    """The JAX package's trained GSR-Net file restored into its own
    template: the same tree, key order and arrays as
    ``fcsr_tpu.iox.load_pytree(template, path)``."""
    from fcsr_tpu.iox import load_pytree as j_load_pytree
    template = _jax_template()
    want = j_load_pytree(template, str(GSR_FILE))
    got = load_pytree(template, str(GSR_FILE))
    import jax
    _same_tree(got, jax.tree_util.tree_map(np.asarray, want))
    # one argument: the raw tree, as before
    assert load_pytree(str(GSR_FILE))["params"].keys() == got[
        "params"].keys()


Pair = collections.namedtuple("Pair", "a b")


def test_load_pytree_restores_lists_tuples_and_keys(tmp_path):
    """A tree with a list, a tuple, a namedtuple, int keys and a scalar,
    written by the port and read by both packages against one template."""
    from flax import serialization

    from fcsr_tpu.iox import load_pytree as j_load_pytree
    rng = np.random.default_rng(0)
    tree = {"w": [rng.normal(size=(2, 3)).astype(np.float32),
                  np.arange(4, dtype=np.int32)],
            "t": (np.float32(1.5), {3: rng.normal(size=5)}),
            "nt": Pair(np.ones(2, np.float32), [np.zeros(1, np.float32)]),
            "step": np.int64(7)}
    path = str(tmp_path / "tree.msgpack")
    save_pytree(tree, path)
    template = {"w": [0, 0], "t": (0, {3: 0}), "nt": Pair(0, [0]),
                "step": 0}
    got = load_pytree(template, path)
    want = j_load_pytree(template, path)
    _same_tree(got, want)
    assert isinstance(got["w"], list) and isinstance(got["t"], tuple)
    assert isinstance(got["nt"], Pair) and list(got["t"][1]) == [3]
    _same_tree(got["w"], tree["w"])
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes(tree)
    # a template key the file does not hold, or a list of another length
    with pytest.raises(ValueError, match="not present in state dict"):
        load_pytree({"w": [0, 0], "missing": 0}, path)
    with pytest.raises(ValueError, match="size of the list"):
        load_pytree({"w": [0, 0, 0]}, path)


def test_symmetric_normalize_is_exported_from_core():
    from fcsr_tpu.core import symmetric_normalize as j_sn
    from fcsr_tpu_torch.core import symmetric_normalize
    from fcsr_tpu_torch.models.gat_unet import symmetric_normalize as gat_sn
    a = np.abs(np.random.default_rng(1).normal(size=(3, 7, 7))).astype(
        np.float32)
    a[0, 2] = 0.0                       # a zero row: eps keeps it finite
    np.testing.assert_allclose(symmetric_normalize(torch.from_numpy(a)),
                               np.asarray(j_sn(a)), rtol=1e-6)
    assert gat_sn is symmetric_normalize


def test_probe_answers_on_a_live_device():
    t0 = time.monotonic()
    assert probe.require_live_device(timeout_s=30, device="cpu") == "cpu"
    assert time.monotonic() - t0 < 30


def test_probe_exits_naming_the_device_when_it_stalls(monkeypatch):
    monkeypatch.setattr(probe, "_probe_op", lambda device: time.sleep(5))
    monkeypatch.setenv("FCSR_BENCH_PROBE_TIMEOUT", "1")
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match=r"device probe on cpu did not "
                                         r"complete within 1 s"):
        probe.require_live_device(device="cpu")
    assert time.monotonic() - t0 < 4


def test_probe_exits_when_the_operation_fails(monkeypatch):
    def broken(device):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(probe, "_probe_op", broken)
    with pytest.raises(SystemExit, match="failed: launch failed"):
        probe.require_live_device(timeout_s=5, device="cpu")


def test_persistent_cache_names_the_build_directory(tmp_path, monkeypatch):
    """The kernels' and the CSV parser's build cache: the repository's
    ``build/fcsr_tpu_torch`` by default, ``FCSR_KERNEL_CACHE_DIR`` or an
    explicit directory instead, none with ``FCSR_NO_COMPILE_CACHE=1``
    (a fresh directory of this process each time)."""
    monkeypatch.setattr(build, "CACHE_ROOT", None)
    monkeypatch.delenv("FCSR_KERNEL_CACHE_DIR", raising=False)
    monkeypatch.delenv("FCSR_NO_COMPILE_CACHE", raising=False)
    default = ROOT / "build" / "fcsr_tpu_torch"
    assert build.cache_root() == default
    assert build.build_dir().parent == default
    env_dir = tmp_path / "env"
    monkeypatch.setenv("FCSR_KERNEL_CACHE_DIR", str(env_dir))
    assert enable_persistent_cache() == str(env_dir) and env_dir.is_dir()
    chosen = tmp_path / "chosen"
    assert enable_persistent_cache(str(chosen)) == str(chosen)
    assert build.build_dir().parent == chosen
    from fcsr_tpu_torch.native import csv_reader
    assert csv_reader._lib_path().parents[1] == chosen
    monkeypatch.setenv("FCSR_NO_COMPILE_CACHE", "1")
    assert enable_persistent_cache() is None
    fresh = build.cache_root()
    assert fresh.parent == default / "nocache" and fresh == build.cache_root()


def test_stage_cached_copies_a_dataset_once(monkeypatch):
    monkeypatch.setattr(transfer, "_STAGE_CACHE", {})
    copies = []
    put = transfer.device_put_fast
    monkeypatch.setattr(transfer, "device_put_fast",
                        lambda x, device=None: copies.append(1) or put(
                            x, device))
    a = np.random.default_rng(2).normal(size=(4, 5, 5)).astype(np.float32)
    first = transfer.stage_cached(a, "cpu")
    assert transfer.stage_cached(a.copy(), "cpu") is first
    assert len(copies) == 1 and torch.equal(first, torch.from_numpy(a))
    transfer.stage_cached(a + 1, "cpu")                  # other content
    transfer.stage_cached(a.astype(np.float64), "cpu")   # other dtype
    assert len(copies) == 3
    for j in range(transfer.STAGE_CACHE_SIZE):           # the oldest goes
        transfer.stage_cached(np.full(3, j, np.float32), "cpu")
    assert transfer.stage_cached(a, "cpu") is not first


def test_transfer_helpers_copy():
    """``device_put_fast`` copies (a cached stack never aliases the
    caller's array), ``to_host`` returns numpy, ``init_on_host`` builds on
    the host."""
    a = np.random.default_rng(3).normal(size=(2, 3)).astype(np.float32)
    x = transfer.device_put_fast(a, "cpu")
    a[0, 0] += 1.0
    assert tuple(x.shape) == (2, 3) and float(x[0, 0]) != float(a[0, 0])
    np.testing.assert_array_equal(transfer.to_host(x)[1], a[1])
    made = transfer.init_on_host(lambda: torch.zeros(2))
    assert made.device.type == "cpu"
