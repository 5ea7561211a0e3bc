"""The port's differentiable metrics (``evalx/differentiable.py``), graph
helpers (``core/graph.py``) and plots (``evalx/plots.py``) against the JAX
package's on the same seeded inputs, on the CPU. Tolerance: float32 to
1e-5 (relative where the values are large); COO conversions exact; the
plots write their files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.core import graph as JG
from fcsr_tpu.evalx import differentiable as JD
from fcsr_tpu_torch.core import graph as TG
from fcsr_tpu_torch.evalx import differentiable as TD
from fcsr_tpu_torch.evalx import plots as TP
from tests.conftest import random_symmetric


def _stack(seed, n=10, b=3, scale=1.0):
    rng = np.random.default_rng(seed)
    return np.stack([random_symmetric(rng, n, density=0.6) * scale
                     for _ in range(b)]).astype(np.float32)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", ["betweenness_approx", "eigenvector_power",
                                  "pagerank_diff"])
def test_differentiable_metrics_match_jax(name):
    a = _stack(1, scale=0.3)
    got = getattr(TD, name)(torch.from_numpy(a))
    want = np.stack([np.asarray(getattr(JD, name)(jnp.asarray(m)))
                     for m in a])
    _close(got.numpy(), want)
    one = getattr(TD, name)(torch.from_numpy(a[1]))        # one matrix
    _close(one.numpy(), want[1])


def test_gsr_loss_and_its_gradient_match_jax():
    """Away from ties: where an entry of the two adjacencies is equal,
    |x|'s subgradient at 0 is 0 in torch and 1 in JAX."""
    a = _stack(2, scale=0.3)
    b = a * 0.5 + 0.05
    x = torch.from_numpy(a).requires_grad_(True)
    loss = TD.gsr_loss(x, torch.from_numpy(b))
    loss.backward()
    j_loss, j_grad = jax.value_and_grad(
        lambda p: JD.gsr_loss(p, jnp.asarray(b)))(jnp.asarray(a))
    _close(loss.item(), float(j_loss))
    _close(x.grad.numpy(), np.asarray(j_grad))
    assert TD.gsr_loss(x, x).item() == 0.0
    _close(TD.evaluate_model_mae(a, b), JD.evaluate_model_mae(a, b))


def test_coo_graph_roundtrip_matches_jax():
    a = _stack(4, n=12, b=1)[0]
    feats = np.arange(24, dtype=np.float32).reshape(12, 2)
    for x in (None, feats):
        t, j = TG.create_graph(a, x), JG.create_graph(a, x)
        for field in ("x", "edge_index", "edge_attr"):
            np.testing.assert_array_equal(getattr(t, field),
                                          getattr(j, field))
        assert t.num_nodes == j.num_nodes == 12
        np.testing.assert_array_equal(TG.to_dense_adj(t), JG.to_dense_adj(j))
    np.testing.assert_array_equal(TG.to_dense_adj(TG.create_graph(a)), a)


def test_topological_node_features_match_jax():
    n = 15
    # scaled so that the resolvent (I - W)^-1 is well-conditioned
    w = _stack(5, n=n, b=2, scale=0.9 / n)
    got = TG.topological_node_features(torch.from_numpy(w))
    want = JG.topological_node_features(w)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32
        _close(got[key].numpy(), np.asarray(want[key]))
    assert tuple(got["stacked"].shape) == (2, n, 8)
    one = TG.topological_node_features(w[0])                # one matrix
    _close(one["stacked"].numpy(), np.asarray(want["stacked"])[0])


def test_plots_write_their_files(tmp_path):
    path = TP.save_loss_curve([3.0, 2.0, 1.5], str(tmp_path / "a" /
                                                   "loss.png"),
                              val_hist=[3.1, 2.2, 1.9])
    assert (tmp_path / "a" / "loss.png").stat().st_size > 0
    assert path == str(tmp_path / "a" / "loss.png")
    folds = [{"mae": 0.1, "pcc": 0.5}, {"mae": 0.12, "pcc": 0.55}]
    paths = TP.save_fold_comparison({"gsr": folds, "gat": folds[:1]},
                                    str(tmp_path / "cmp"),
                                    metrics=["mae", "pcc"])
    assert [p.split("/")[-1] for p in paths] == ["compare_mae.png",
                                                 "compare_pcc.png"]
    assert all((tmp_path / "cmp" / p.split("/")[-1]).stat().st_size > 0
               for p in paths)
