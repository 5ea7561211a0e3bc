"""The port's global metrics and edge-weight-histogram KL
(``fcsr_tpu_torch/evalx/metrics.py``) against the JAX package's on the
same seeded inputs, on the CPU. Tolerance: float64 to 1e-12 (the same
operations; only the order of a few sums differs); the KL's float32 path
to 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.evalx import metrics as JM
from fcsr_tpu_torch.evalx import metrics as TM
from tests.conftest import random_symmetric


@pytest.fixture(autouse=True)
def _x64_scope():
    with jax.enable_x64(True):
        yield


def test_mae_pcc_jsd_match_jax():
    rng = np.random.default_rng(3)
    x, y = rng.random(700), rng.random(700)
    for name in ("mae", "pearson_corr", "jensen_shannon_distance"):
        want = float(getattr(JM, name)(x, y))
        got = float(getattr(TM, name)(torch.from_numpy(x),
                                      torch.from_numpy(y)))
        assert abs(got - want) <= 1e-12, (name, got, want)
    # a zero entry on either side: the 0 * log 0 terms drop out
    x[:5] = 0.0
    y[3:9] = 0.0
    assert abs(float(TM.jensen_shannon_distance(x, y))
               - float(JM.jensen_shannon_distance(x, y))) <= 1e-12


def test_edge_weight_mask_and_histogram_match_jax():
    rng = np.random.default_rng(4)
    w = np.stack([random_symmetric(rng, 19, density=0.5)
                  for _ in range(3)]).astype(np.float64)
    mask = TM.edge_weight_mask(torch.from_numpy(w))
    np.testing.assert_array_equal(
        mask.numpy(), np.stack([np.asarray(JM.edge_weight_mask(m))
                                for m in w]))
    lo = np.array([0.0, 0.1, 0.2])
    hi = np.array([1.0, 0.9, 0.2])                 # an empty range too
    got = TM._masked_histogram(torch.from_numpy(w), mask,
                               torch.from_numpy(lo), torch.from_numpy(hi), 7)
    assert got.dtype == torch.float32
    for b in range(3):
        want = JM._masked_histogram(jnp.asarray(w[b]),
                                    jnp.asarray(mask[b].numpy()),
                                    lo[b], hi[b], 7)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def _kl_pairs(rng, n=24):
    dense = random_symmetric(rng, n, density=0.7).astype(np.float64)
    sparse = random_symmetric(rng, n, density=0.2).astype(np.float64)
    zero = np.zeros((n, n))
    one_edge = zero.copy()
    one_edge[2, 5] = one_edge[5, 2] = 0.4
    # pairs: random, edgeless prediction, edgeless gt, both edgeless, a
    # single edge against a dense graph
    gt = np.stack([dense, dense, zero, zero, one_edge])
    pred = np.stack([sparse, zero, dense, zero, dense])
    return gt, pred


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_weight_histogram_kl_matches_jax(dtype):
    """Batched over the leading axis, edgeless sides included (the
    placeholder weight 0). float64 to 1e-12; float32 to 1e-6 relative."""
    gt, pred = _kl_pairs(np.random.default_rng(5))
    gt, pred = gt.astype(dtype), pred.astype(dtype)
    got = TM.weight_histogram_kl(torch.from_numpy(gt), torch.from_numpy(pred))
    assert got.shape == (5,) and str(got.dtype) == f"torch.{dtype}"
    want = np.array([float(JM.weight_histogram_kl(g, p))
                     for g, p in zip(gt, pred)])
    if dtype == "float64":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert want[3] == 0.0 and float(got[3]) == 0.0   # both edgeless


def test_weight_histogram_kl_runs_on_the_tensors_device():
    gt, pred = _kl_pairs(np.random.default_rng(6), n=9)
    got = TM.weight_histogram_kl(torch.from_numpy(gt), torch.from_numpy(pred))
    assert got.device.type == "cpu"
    np.testing.assert_allclose(
        got.numpy(),
        [float(TM.weight_histogram_kl(torch.from_numpy(g[None]),
                                      torch.from_numpy(p[None]))[0])
         for g, p in zip(gt, pred)], rtol=0, atol=0)
