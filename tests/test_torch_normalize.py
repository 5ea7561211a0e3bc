"""The port's core/normalize.py against fcsr_tpu.core.normalize (CPU),
and the plain versions of two step kernels held to what they stand for.

Tolerance: float32 results of the same operation order; 1e-6 absolute
covers the reduction-order difference of the row sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.core import normalize as jn
from fcsr_tpu_torch.core import normalize as tn
from fcsr_tpu_torch.kernels.ops import (add_bias_plain,
                                        tail_normalize_bwd_plain,
                                        tail_normalize_plain)

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


@pytest.mark.parametrize("F,m", [(1, 11), (3, 11), (1, 37), (3, 37), (2, 1)])
def test_tail_normalize_bwd_plain_is_the_vjp_of_normalize_adj(rng, F, m):
    """The tail adjoint's plain version (which the CUDA kernel is held to on
    the card) = jax.vjp of normalize_adj(fill_diagonal(|T|, 1)), within
    1e-5 of the largest entry (float32 sums in another order); a one-node
    graph (only its diagonal) has an exactly zero adjoint."""
    t = rng.normal(size=(F, m, m)).astype(np.float32)
    g = rng.normal(size=(F, m, m)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x: jn.normalize_adj(jn.fill_diagonal(jnp.abs(x), 1.0)),
        jnp.asarray(t))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    _, r = tail_normalize_plain(_t(t))
    got = tail_normalize_bwd_plain(_t(g), _t(t), r).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert (np.diagonal(got, axis1=1, axis2=2) == 0).all()


@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_add_bias_plain_is_i_w_plus_b_on_flat_views(rng, off):
    """x0 = I W + b of the step, on views into a flat (F, P) buffer that
    start 0-3 floats past a 16-byte boundary (the kernel's two copy
    widths): exactly numpy's."""
    F, rows, cols = 3, 5, 12
    flat = rng.normal(size=(F, off + rows * cols + cols + 1)) \
        .astype(np.float32)
    buf = torch.from_numpy(flat)
    w = buf[:, off:off + rows * cols].view(F, rows, cols)
    b = buf[:, off + rows * cols:off + rows * cols + cols].view(F, 1, cols)
    want = (np.eye(rows, dtype=np.float32)
            @ flat[:, off:off + rows * cols].reshape(F, rows, cols)
            + flat[:, None, off + rows * cols:off + rows * cols + cols])
    np.testing.assert_array_equal(add_bias_plain(w, b).numpy(), want)
