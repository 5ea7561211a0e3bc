"""The plain PyTorch versions of the three data-path kernels
(``fcsr_tpu_torch/kernels/csrc/triu.cu``) against the Pallas kernels they
replace, run with ``interpret=True`` (CPU): exact for the copies
(``vectorize_colmajor``, un-normalized ``anti_vectorize_normalize``), 1e-6
where a row sum is taken in another order, zero and negative row sums
included. On CPU tensors the public wrappers take the plain versions."""

import numpy as np
import pytest
import torch

from fcsr_tpu.core.pallas_kernels import (
    anti_vectorize_normalize as j_antivec,
    normalize_adj_pallas as j_normalize,
    vectorize_colmajor_pallas as j_colmajor)
from fcsr_tpu_torch.core import (anti_vectorize_batch,
                                 anti_vectorize_normalize, normalize_adj,
                                 normalize_adj_batch, vec_len,
                                 vectorize_batch, vectorize_colmajor)
from fcsr_tpu_torch.kernels import KERNEL_OPS, KERNELS, PLAIN_OPS

SIZES = [2, 3, 8, 33]


def _same_with_nans(got, want, atol):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], atol=atol, rtol=0)


@pytest.mark.parametrize("n", SIZES)
def test_anti_vectorize_unnormalized_is_exact(rng, n):
    v = rng.random((3, vec_len(n) + 4)).astype(np.float32)   # trailing entries
    got = anti_vectorize_normalize(v, n, normalize=False)
    want = np.asarray(j_antivec(v, n, normalize=False, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, anti_vectorize_batch(torch.from_numpy(v), n))


@pytest.mark.parametrize("fill_diag", [0.0, 1.0])
@pytest.mark.parametrize("n", SIZES)
def test_anti_vectorize_normalized_matches_pallas(rng, n, fill_diag):
    v = rng.random((3, vec_len(n))).astype(np.float32)
    got = anti_vectorize_normalize(v, n, normalize=True, fill_diag=fill_diag)
    want = np.asarray(j_antivec(v, n, normalize=True, fill_diag=fill_diag,
                                interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if fill_diag:
        plain = anti_vectorize_normalize(v, n, normalize=False,
                                         fill_diag=fill_diag)
        assert bool((torch.diagonal(plain, dim1=-2, dim2=-1)
                     == fill_diag).all())


@pytest.mark.parametrize("n", SIZES)
def test_vectorize_colmajor_is_exact(rng, n):
    m = rng.standard_normal((3, n, n)).astype(np.float32)   # not symmetric
    got = vectorize_colmajor(m)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_colmajor(m, interpret=True)))
    assert torch.equal(got, vectorize_batch(torch.from_numpy(m)))


@pytest.mark.parametrize("n", [3, 8, 33])
def test_normalize_adj_batch_matches_pallas(rng, n):
    a = rng.random((4, n, n)).astype(np.float32)
    a = a + a.transpose(0, 2, 1)
    a[2, 1, :] = 0.0
    a[2, :, 1] = 0.0                      # a zero row sum
    got = normalize_adj_batch(a)
    want = np.asarray(j_normalize(a, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert bool((got[2, 1] == 0).all()) and bool((got[2, :, 1] == 0).all())
    # on symmetric input it agrees with the transposing normalize_adj
    np.testing.assert_allclose(got.numpy(),
                               normalize_adj(torch.from_numpy(a)).numpy(),
                               atol=1e-6, rtol=0)


def test_guard_zero_rows_give_zero_negative_rows_give_nan():
    """Only the infinite r of a zero row sum (-0.0 included) becomes 0; a
    negative row sum's NaN reaches the output, in both normalizing
    kernels and on both sides."""
    n = 8
    a = np.zeros((1, n, n), np.float32)
    a[0, 0, 1] = a[0, 1, 0] = -1.0        # negative row sums: rows 0, 1
    a[0, 2, 3] = a[0, 3, 2] = 0.5         # ordinary rows 2, 3
    a[0, 4, 5] = a[0, 5, 4] = -0.0        # rows 4..7 sum to (-)0
    got = normalize_adj_batch(a).numpy()
    _same_with_nans(got, np.asarray(j_normalize(a, interpret=True)), 1e-6)
    assert np.isnan(got[0, 0, 1]) and abs(got[0, 2, 3] - 1.0) <= 1e-6
    assert not np.isnan(got[0, 4:, 2:]).any() and (got[0, 4:, 2:] == 0).all()

    rows, cols = np.triu_indices(n, 1)
    v = a[:, rows, cols]
    got_v = anti_vectorize_normalize(v, n, normalize=True).numpy()
    _same_with_nans(got_v, np.asarray(j_antivec(v, n, normalize=True,
                                                interpret=True)), 1e-6)
    _same_with_nans(got_v, got, 0.0)


def test_roundtrip_pairs_like_the_reference(rng):
    n = 16
    v = rng.random((2, vec_len(n))).astype(np.float32)
    dense = anti_vectorize_normalize(v, n, normalize=False)
    got = vectorize_colmajor(dense)
    want = np.asarray(j_colmajor(np.asarray(j_antivec(
        v, n, normalize=False, interpret=True)), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_check_their_arguments():
    with pytest.raises(ValueError, match="V >= 28"):
        anti_vectorize_normalize(np.zeros((2, 27), np.float32), 8)
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        vectorize_colmajor(np.zeros((2, 3, 4), np.float32))
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        normalize_adj_batch(np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="1 to 65535"):
        normalize_adj_batch(np.zeros((0, 3, 3), np.float32))


@pytest.mark.parametrize("name", ["anti_vectorize_normalize",
                                  "vectorize_colmajor",
                                  "normalize_adj_batch"])
def test_kernel_is_registered_with_its_plain_version(name):
    k = KERNELS[name]
    assert k.source == "triu" and k.symbol == f"fcsr_{name}"
    assert k.replaces.startswith("fcsr_tpu/core/pallas_kernels.py:")
    assert callable(getattr(KERNEL_OPS, name))
    assert callable(getattr(PLAIN_OPS, name))
    assert k.launches == 0                # CPU tensors launch nothing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_triu_kernels_match_plain_on_card(cuda_device, rng):
    n = 33
    v = torch.from_numpy(rng.random((5, vec_len(n))).astype(np.float32))
    dense = PLAIN_OPS.anti_vectorize_normalize(v, n, False)
    assert torch.equal(KERNEL_OPS.anti_vectorize_normalize(
        v.to(cuda_device), n, False).cpu(), dense)
    assert torch.equal(KERNEL_OPS.vectorize_colmajor(
        dense.to(cuda_device)).cpu(), PLAIN_OPS.vectorize_colmajor(dense))
    torch.testing.assert_close(
        KERNEL_OPS.normalize_adj_batch(dense.to(cuda_device)).cpu(),
        PLAIN_OPS.normalize_adj_batch(dense), atol=1e-6, rtol=0)
