"""The port's msgpack coder (``fcsr_tpu_torch/iox/msgpack.py``) against
flax's ``flax.serialization`` (CPU): the same bytes out, the same tree
back, on the JAX package's trained GSR-Net file and hand-built and drawn
trees."""

import struct
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fs
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from fcsr_tpu_torch.iox import msgpack as pm

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "outputs" / "gsr" / "gsr_net_trained.msgpack"


def _same(a, b, path="") -> None:
    """Equal trees: same container types and key order, arrays equal in
    dtype, shape and bytes, floats equal bit for bit."""
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), (
        path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, (float, np.floating)):
        assert struct.pack(">d", float(a)) == struct.pack(">d", float(b)) \
            and type(a) is type(b), path
    else:
        assert a == b, path


def test_fixture_decodes_as_flax_does():
    raw = FIXTURE.read_bytes()
    got, want = pm.msgpack_restore(raw), fs.msgpack_restore(raw)
    _same(got, want)

    def leaves(t):
        for v in t.values():
            yield from leaves(v) if isinstance(v, dict) else [v]
    arrays = list(leaves(got))
    assert len(arrays) == 33
    assert all(a.flags.writeable and a.flags.c_contiguous for a in arrays)


def test_fixture_encodes_byte_for_byte():
    raw = FIXTURE.read_bytes()
    tree = pm.msgpack_restore(raw)
    assert pm.msgpack_serialize(tree) == raw
    assert pm.to_bytes(tree) == raw
    assert fs.msgpack_serialize(fs.msgpack_restore(raw)) == raw


_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
         2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
         -2 ** 31 - 1, -2 ** 63]
HAND_TREES = {
    "ints": {"i": _INTS, "neg": {"a": -5, "b": 200}},
    "floats_bool_none": {"f": [0.5, -1e300, float("inf"), float("nan"),
                               -0.0], "b": [True, False, None]},
    "strings": {"s": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256,
                      "a" * 65535, "a" * 65536, "é∂"]},
    "bytes": {"b": [b"", b"x" * 255, b"x" * 256, b"x" * 65536]},
    "nested": {"l": [[], [[1, [2, [3]]]], {}], "e": {}, "d": {"z": {}},
               "wide": {f"k{i}": i for i in range(20)},
               "long": list(range(70000))},
    "arrays": {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
               "f64": np.linspace(-1, 1, 7),
               "i32": np.arange(-3, 3, dtype=np.int32),
               "i64": np.array([2 ** 40, -2 ** 40], np.int64),
               "u8": np.arange(256, dtype=np.uint8),
               "bool": np.array([[True, False]]),
               "zero_d": np.array(3.0, np.float32),
               "empty": np.zeros((0, 4), np.float64),
               "fortran": np.asfortranarray(np.arange(6.0).reshape(2, 3)),
               "in_list": [np.ones(2, np.float32)]},
    "scalars": {"f32": np.float32(2.5), "i64": np.int64(-7),
                "b": np.bool_(True), "c": 1 + 2j, "c0": complex(0, -0.5)},
    "unsorted": {"b": 1, "a": {"y": 2, "x": [3, {"q": 4, "p": 5}]}},
}


@pytest.mark.parametrize("name", sorted(HAND_TREES))
def test_hand_built_tree_bytes_and_tree(name):
    tree = HAND_TREES[name]
    want = fs.msgpack_serialize(tree)
    assert pm.msgpack_serialize(tree) == want
    assert pm.to_bytes(tree) == fs.to_bytes(tree)
    _same(pm.msgpack_restore(want), fs.msgpack_restore(want))
    # in place: the given dict order
    assert pm.msgpack_serialize(dict(tree), in_place=True) == \
        fs.msgpack_serialize(dict(tree), in_place=True)


def test_tuple_is_refused_as_flax_refuses_it():
    with pytest.raises(TypeError):
        fs.msgpack_serialize({"a": (1, 2)})
    with pytest.raises(TypeError, match="tuple"):
        pm.msgpack_serialize({"a": (1, 2)})
    # to_bytes turns lists and tuples into {"0": ...} dicts first
    tree = {"a": (1, 2), "b": [np.float32(3)], 4: "int key"}
    assert pm.to_bytes(tree) == fs.to_bytes(tree)


def test_unknown_types_and_ranges_raise():
    with pytest.raises(TypeError):
        pm.msgpack_serialize({"a": object()})
    with pytest.raises(OverflowError):
        pm.msgpack_serialize({"a": 2 ** 64})
    with pytest.raises(ValueError, match="map key"):
        pm.msgpack_restore(b"\x81\x01\x02")     # {1: 2}: not a str key
    with pytest.raises(ValueError, match="truncated"):
        pm.msgpack_restore(FIXTURE.read_bytes()[:-3])
    with pytest.raises(ValueError, match="extra bytes"):
        pm.msgpack_restore(b"\x80\x80")


def test_chunked_arrays_small_limit(monkeypatch):
    """Arrays above the chunk limit, as dict values and as the whole tree,
    with the limit patched small on both sides; arrays in lists stay
    whole."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(pm, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(4, 25),
            "n": {"x": np.arange(33, dtype=np.float64),
                  "small": np.arange(16, dtype=np.float32)},
            "l": [np.arange(40, dtype=np.float32)]}
    want = fs.msgpack_serialize(tree)
    assert pm.msgpack_serialize(tree) == want
    assert b"__msgpack_chunked_array__" in want
    got = pm.msgpack_restore(want)
    _same(got, fs.msgpack_restore(want))
    _same(got["w"], tree["w"])
    assert got["w"].flags.writeable
    whole = np.arange(40, dtype=np.int32).reshape(2, 20)
    assert pm.msgpack_serialize(whole) == fs.msgpack_serialize(whole)
    _same(pm.msgpack_restore(fs.msgpack_serialize(whole)), whole)


def test_bfloat16_leaves():
    """flax writes a bfloat16 array under the name 'bfloat16'; the port
    reads it as a torch.bfloat16 tensor and writes one back the same."""
    x = np.linspace(-3, 3, 10, dtype=np.float32).reshape(2, 5)
    want = fs.msgpack_serialize({"w": jnp.asarray(x, jnp.bfloat16)})
    got = pm.msgpack_restore(want)["w"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 5)
    assert torch.equal(got, torch.from_numpy(x).to(torch.bfloat16))
    assert pm.msgpack_serialize({"w": got}) == want


def test_tensor_leaves_write_as_arrays():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree = {"t": torch.from_numpy(x).T, "i": torch.tensor([1, 2])}
    want = fs.msgpack_serialize({"t": x.T, "i": np.array([1, 2])})
    assert pm.msgpack_serialize(tree) == want


_leaf = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
         | st.floats(width=64) | st.text(max_size=40)
         | st.binary(max_size=40)
         | st.builds(lambda v, d: np.asarray(v, d),
                     st.lists(st.integers(0, 100), max_size=6),
                     st.sampled_from([np.float32, np.int64, np.uint8])))
_trees = st.recursive(
    _leaf, lambda kids: st.lists(kids, max_size=4)
    | st.dictionaries(st.text(max_size=6), kids, max_size=4),
    max_leaves=16)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.dictionaries(st.text(max_size=6), _trees, max_size=4))
def test_drawn_trees_match_flax(tree):
    want = fs.msgpack_serialize(tree)
    assert pm.msgpack_serialize(tree) == want
    _same(pm.msgpack_restore(want), fs.msgpack_restore(want))


_BLOCKED = r"""
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "fcsr_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is refused here")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
from fcsr_tpu_torch.iox.msgpack import msgpack_restore, msgpack_serialize
raw = open(sys.argv[2], "rb").read()
assert msgpack_serialize(msgpack_restore(raw)) == raw
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("round trip without", BLOCKED)
"""


def test_coder_needs_no_msgpack_flax_or_jax():
    """The coder imports and round-trips the fixture in an interpreter
    that refuses msgpack, flax, JAX and the JAX package (the card's
    machine has no flax)."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(ROOT), str(FIXTURE)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "round trip without" in out.stdout
