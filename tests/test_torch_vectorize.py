"""The port's triu orderings (fcsr_tpu_torch.core.vectorize) against the
JAX package's: exact, all three orderings, with and without
``include_diagonal`` (CPU)."""

from importlib import import_module

import numpy as np
import pytest
import torch

# both packages re-export a function named ``vectorize`` that shadows the
# module attribute, so fetch the modules themselves
jv = import_module("fcsr_tpu.core.vectorize")
tv = import_module("fcsr_tpu_torch.core.vectorize")

SIZES = [2, 3, 8, 33]


def _mats(rng, n, b=3):
    return rng.random((b, n, n)).astype(np.float32)


@pytest.mark.parametrize("include_diagonal", [False, True])
@pytest.mark.parametrize("n", SIZES + [160])
def test_vec_len_and_index_maps_equal_jax(n, include_diagonal):
    for ordering in ("rowmajor", "colmajor"):
        assert tv.vec_len(n, include_diagonal, ordering) == \
            jv.vec_len(n, include_diagonal, ordering)
    for got, want in zip(tv.triu_indices_colmajor(n, include_diagonal),
                         jv.triu_indices_colmajor(n, include_diagonal)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tv.triu_indices_rowmajor(n),
                         jv.triu_indices_rowmajor(n)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown ordering"):
        tv.vec_len(n, True, "diagonal")


@pytest.mark.parametrize("include_diagonal", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_vectorize_colmajor_equals_jax(rng, n, include_diagonal):
    m = _mats(rng, n)
    got = tv.vectorize_batch(torch.from_numpy(m), include_diagonal)
    assert got.shape[-1] == tv.vec_len(n, include_diagonal, "colmajor")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jv.vectorize_batch(m, include_diagonal)))
    np.testing.assert_array_equal(
        tv.vectorize(m[0], include_diagonal).numpy(),
        np.asarray(jv.vectorize(m[0], include_diagonal)))


@pytest.mark.parametrize("include_diagonal", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_vectorize_rowmajor_equals_jax(rng, n, include_diagonal):
    m = _mats(rng, n)
    got = tv.vectorize_rowmajor(torch.from_numpy(m), include_diagonal)
    assert got.shape[-1] == tv.vec_len(n, include_diagonal, "rowmajor")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jv.vectorize_rowmajor(m, include_diagonal)))


@pytest.mark.parametrize("include_diagonal", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_anti_vectorize_equals_jax(rng, n, include_diagonal):
    # 5 trailing entries beyond the required length are ignored
    length = tv.vec_len(n, include_diagonal, "rowmajor") + 5
    v = rng.random((3, length)).astype(np.float32)
    got = tv.anti_vectorize_batch(torch.from_numpy(v), n, include_diagonal)
    want = np.asarray(jv.anti_vectorize_batch(v, n, include_diagonal))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tv.anti_vectorize(v[1], n, include_diagonal).numpy(), want[1])


@pytest.mark.parametrize("include_diagonal", [False, True])
def test_matrix_vectorizer_facade_equals_jax(rng, include_diagonal):
    m = _mats(rng, 9)[0]
    m = m + m.T
    got = tv.MatrixVectorizer.vectorize(m, include_diagonal)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(
        got, jv.MatrixVectorizer.vectorize(m, include_diagonal))
    v = rng.random(tv.vec_len(9, include_diagonal)).astype(np.float32)
    np.testing.assert_array_equal(
        tv.MatrixVectorizer.anti_vectorize(v, 9, include_diagonal),
        jv.MatrixVectorizer.anti_vectorize(v, 9, include_diagonal))


def test_orderings_pair_like_the_reference(rng):
    """Row-major anti-vectorize and column-major vectorize are NOT
    inverses; row-major vectorize inverts the anti-vectorize."""
    n = 7
    v = torch.from_numpy(rng.random((2, tv.vec_len(n))).astype(np.float32))
    dense = tv.anti_vectorize_batch(v, n)
    assert torch.equal(tv.vectorize_rowmajor(dense), v)
    assert not torch.equal(tv.vectorize_batch(dense), v)
    assert torch.equal(dense, dense.transpose(-1, -2))
    assert bool((torch.diagonal(dense, dim1=-2, dim2=-1) == 0).all())
