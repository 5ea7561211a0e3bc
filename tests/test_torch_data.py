"""The port's data layer against fcsr_tpu.data (CPU): exact equality."""

import hashlib

import numpy as np
import pytest

from fcsr_tpu.data import synthetic as jsyn
from fcsr_tpu.data.datamodule import kfold_indices as j_kfold
from fcsr_tpu.train.gsr_loop import precompute_spectral as j_spectral
from fcsr_tpu_torch.data import (has_real_csvs, kfold_indices,
                                 load_or_synthesize,
                                 synthesize_teacher_connectomes)
from fcsr_tpu_torch.train.gsr_loop import precompute_spectral


@pytest.mark.parametrize("n,n_test,seed", [(3, 0, 42), (4, 2, 7)])
def test_teacher_data_equals_jax_package(n, n_test, seed):
    got = synthesize_teacher_connectomes(n, lr_dim=24, hr_dim=40, seed=seed,
                                         n_test=n_test)
    want = jsyn.synthesize_teacher_connectomes(n, lr_dim=24, hr_dim=40,
                                               seed=seed, n_test=n_test)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_teacher_dataset_content_pin():
    """The full-size seeded teacher dataset regenerates bit-exactly: the
    same pinned content hash as the JAX package's dataset."""
    lr, hr, lr_te = synthesize_teacher_connectomes(167, seed=42, n_test=112)
    h = hashlib.blake2b(digest_size=16)
    for name, a in [("hr_train", hr), ("lr_test", lr_te), ("lr_train", lr)]:
        a = np.ascontiguousarray(a)
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(memoryview(a).cast("B"))
    assert h.hexdigest() == "5b1379f6624d7492b4d5a56ddd403e78"


@pytest.mark.parametrize("n,k,seed", [(167, 3, 42), (10, 4, 0), (6, 2, 42)])
def test_kfold_indices_identical(n, k, seed):
    got, want = kfold_indices(n, k, seed=seed), j_kfold(n, k, seed=seed)
    assert len(got) == len(want)
    for (tr, va), (jtr, jva) in zip(got, want):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(va, jva)


def test_load_or_synthesize_caches(tmp_path):
    a = load_or_synthesize(str(tmp_path), n_train=2, n_test=1, seed=5)
    files = list(tmp_path.glob("fcsr_synth2_teacher_5_2_1.npz"))
    assert len(files) == 1
    b = load_or_synthesize(str(tmp_path), n_train=2, n_test=1, seed=5)
    for k in ("lr_train", "hr_train", "lr_test"):
        np.testing.assert_array_equal(a[k], b[k])
    assert not has_real_csvs(str(tmp_path))


def test_real_csvs_raise_not_implemented(tmp_path):
    (tmp_path / "lr_train.csv").write_text("ID,v0\n1,0.5\n")
    """A directory with the CSVs is ingested now, not refused: a partial
    set names the files it lacks (the whole set is read in
    tests/test_torch_io.py)."""
    assert has_real_csvs(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="missing hr_train.csv, "
                                                "lr_test.csv"):
        load_or_synthesize(str(tmp_path), device="cpu")


def test_precompute_spectral_equals_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("FCSR_SPECTRAL_CACHE_DIR", str(tmp_path))
    lr, hr = synthesize_teacher_connectomes(3, lr_dim=20, hr_dim=32, seed=1)
    got = precompute_spectral(lr, hr, lr_dim=20)
    monkeypatch.setenv("FCSR_NO_SPECTRAL_CACHE", "1")
    want = j_spectral(lr, hr, lr_dim=20)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # a cache hit returns the same arrays
    monkeypatch.delenv("FCSR_NO_SPECTRAL_CACHE")
    again = precompute_spectral(lr, hr, lr_dim=20)
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a, b)
