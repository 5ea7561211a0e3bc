"""The ``lift`` synthetic dataset (``synthesize_paired_connectomes``,
``load_or_synthesize(flavor="lift")``) against the JAX package's (CPU):
numpy on both sides, so bit for bit; one cache file shared by both."""

import hashlib

import numpy as np
import pytest

from fcsr_tpu.data import io as j_io
from fcsr_tpu.data import synthetic as j_syn
from fcsr_tpu_torch.data import (load_or_synthesize,
                                 synthesize_paired_connectomes)

# sha256 of load_or_synthesize(None, flavor="lift") at its full size (167
# + 112 subjects, 160 -> 268), keys in order, each as name, shape, dtype
# and bytes: also held on the card's machine by chip_smoke.py phase 10
LIFT_SHA256 = \
    "6a59b7836ef1776df61a91ff9fdcbcacb3aa5b41ce9d8426a5faf9e0c989b3da"


def dataset_sha256(data) -> str:
    h = hashlib.sha256()
    for name in ("lr_train", "hr_train", "lr_test"):
        a = np.ascontiguousarray(data[name])
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_test", [0, 4])
def test_paired_connectomes_bit_equal(n_test):
    _equal(synthesize_paired_connectomes(5, seed=3, n_test=n_test),
           j_syn.synthesize_paired_connectomes(5, seed=3, n_test=n_test))
    # the test subjects come at the end of the stream: train unchanged
    if n_test:
        _equal(synthesize_paired_connectomes(5, seed=3, n_test=n_test)[:2],
               synthesize_paired_connectomes(5, seed=3))


def test_small_dims_bit_equal():
    kw = dict(lr_dim=24, hr_dim=40, n_comm=5, noise=0.05, seed=11, n_test=2)
    _equal(synthesize_paired_connectomes(3, **kw),
           j_syn.synthesize_paired_connectomes(3, **kw))


def test_lift_cache_is_shared(tmp_path):
    """The cache file has the JAX package's name; each package reads the
    file the other wrote (a marked entry proves it is read, not drawn
    again)."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    # positional, in the JAX package's order: n_train, n_test, seed, flavor
    a = load_or_synthesize(str(port_dir), 2, 1, 5, "lift")
    path = port_dir / "fcsr_synth2_lift_5_2_1.npz"
    assert [p.name for p in port_dir.iterdir()] == [path.name]
    b = j_io.load_or_synthesize(str(port_dir), 2, 1, 5, "lift")
    for k in ("lr_train", "hr_train", "lr_test"):
        np.testing.assert_array_equal(a[k], b[k])
    marked = dict(a, lr_test=np.full_like(a["lr_test"], 0.25))
    np.savez(path, **marked)
    np.testing.assert_array_equal(
        j_io.load_or_synthesize(str(port_dir), 2, 1, 5, "lift")["lr_test"],
        marked["lr_test"])

    j_io.load_or_synthesize(str(jax_dir), 2, 1, 5, "lift")
    jpath = jax_dir / "fcsr_synth2_lift_5_2_1.npz"
    np.savez(jpath, **marked)
    got = load_or_synthesize(str(jax_dir), n_train=2, n_test=1, seed=5,
                             flavor="lift", device="cpu")
    np.testing.assert_array_equal(got["lr_test"], marked["lr_test"])
    # the teacher set keeps its own file
    load_or_synthesize(str(jax_dir), n_train=2, n_test=1, seed=5)
    assert (jax_dir / "fcsr_synth2_teacher_5_2_1.npz").exists()
    with pytest.raises(ValueError, match="flavor"):
        load_or_synthesize(None, 2, 1, 5, "mixed")


def test_lift_dataset_content_pin():
    """The full-size lift set regenerates bit-exactly: its pinned sha256,
    and equal to the JAX package's."""
    got = load_or_synthesize(None, flavor="lift")
    assert {k: v.shape for k, v in got.items()} == {
        "lr_train": (167, 160, 160), "hr_train": (167, 268, 268),
        "lr_test": (112, 160, 160)}
    assert dataset_sha256(got) == LIFT_SHA256
    assert dataset_sha256(j_io.load_or_synthesize(None, flavor="lift")) == \
        LIFT_SHA256
