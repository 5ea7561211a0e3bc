"""The port's core/normalize.py against fcsr_tpu.core.normalize (CPU).

Tolerance: float32 results of the same operation order; 1e-6 absolute
covers the reduction-order difference of the row sums."""

import jax.numpy as jnp
import numpy as np
import torch

from fcsr_tpu.core import normalize as jn
from fcsr_tpu_torch.core import normalize as tn
from fcsr_tpu_torch.kernels.ops import tail_normalize_plain

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_normalize_adj_nonsymmetric_matches_jax(rng):
    """The transposing form D^-1/2 A^T D^-1/2 (D from row sums) matters
    for the spectral tail's non-symmetric f_d."""
    a = rng.random((3, 17, 17)).astype(np.float32)
    assert not np.allclose(a, np.swapaxes(a, -1, -2))
    want = np.asarray(jn.normalize_adj(jnp.asarray(a)))
    got = tn.normalize_adj(_t(a)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and it is NOT the symmetric form for such an input
    sym = np.asarray(jn.normalize_adj_np(a))
    assert np.abs(got - sym).max() > 1e-3


def test_normalize_adj_zero_and_negative_rows(rng):
    a = rng.random((9, 9)).astype(np.float32)
    a[2, :] = 0.0                     # zero row sum -> its r is 0
    a[5, :] = -rng.random(9)          # negative row sum -> NaN propagates
    want = np.asarray(jn.normalize_adj(jnp.asarray(a)))
    got = tn.normalize_adj(_t(a)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, equal_nan=True)
    keep = np.arange(9) != 5
    assert np.all(got[keep, 2] == 0) and np.all(got[2, keep] == 0)
    assert np.isnan(got[5]).all() and np.isnan(got[:, 5]).all()


def test_normalize_adj_np_matches_jax(rng):
    a = rng.random((4, 12, 12)).astype(np.float32)
    a = a + np.swapaxes(a, -1, -2)
    a[1, 3, :] = 0.0
    a[1, :, 3] = 0.0
    np.testing.assert_array_equal(tn.normalize_adj_np(a),
                                  jn.normalize_adj_np(a))


def test_fill_symmetrize_pad_unpad_match_jax(rng):
    m = rng.normal(size=(2, 7, 7)).astype(np.float32)
    for fn_t, fn_j in ((lambda x: tn.fill_diagonal(x, 1.0),
                        lambda x: jn.fill_diagonal(x, 1.0)),
                       (tn.symmetrize, jn.symmetrize),
                       (lambda x: tn.pad_hr_adj(x, 2),
                        lambda x: jn.pad_hr_adj(x, 2)),
                       (lambda x: tn.pad_hr_adj(x, 0),
                        lambda x: jn.pad_hr_adj(x, 0)),
                       (lambda x: tn.unpad(x, 2), lambda x: jn.unpad(x, 2)),
                       (lambda x: tn.unpad(x, 0), lambda x: jn.unpad(x, 0))):
        np.testing.assert_array_equal(fn_t(_t(m)).numpy(),
                                      np.asarray(fn_j(jnp.asarray(m))))


def test_tail_normalize_plain_is_normalize_adj_of_fd(rng):
    """The tail kernel's plain version = normalize_adj(fill_diag(|T|, 1)),
    with r = rowsum^-1/2."""
    t = _t(rng.normal(size=(2, 11, 11)))
    adj, r = tail_normalize_plain(t)
    fd = tn.fill_diagonal(t.abs(), 1.0)
    torch.testing.assert_close(adj, tn.normalize_adj(fd), atol=ATOL, rtol=0)
    torch.testing.assert_close(r, fd.sum(-1).pow(-0.5), atol=ATOL, rtol=0)
