"""The port's batched centralities (``fcsr_tpu_torch/evalx/centrality.py``)
against the JAX package's per-sample ones on the same seeded graphs (18-60
nodes), on the CPU: float64 to 1e-10, core numbers equal. The batched
form equals the per-sample form bit for bit, also on a batch that mixes
fast- and slow-converging graphs. The card test holds the card's results
to the CPU's.

The JAX package is imported inside the tests that compare with it: the
card's machine has no JAX, and the card test runs there.
"""

import random

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.evalx import centrality as TC


def _sym(rng, n, density=1.0):
    """Random nonnegative symmetric matrix, zero diagonal, values [0, 1)."""
    m = rng.random((n, n))
    if density < 1.0:
        m = m * (rng.random((n, n)) < density)
    m = np.triu(m, k=1)
    return m + m.T


def _jax_each(name, ws, *per_sample_args, **kw):
    """The JAX package's ``centrality.<name>`` on each graph, in x64."""
    import jax
    import jax.numpy as jnp

    from fcsr_tpu.evalx import centrality as JC
    fn = getattr(JC, name)
    with jax.enable_x64(True):
        return np.stack([
            np.asarray(fn(jnp.asarray(w), *(jnp.asarray(a[i])
                                             for a in per_sample_args), **kw))
            for i, w in enumerate(ws)])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pagerank_graphs(rng):
    dense = _sym(rng, 25)
    sparse = _sym(rng, 25, density=0.3)
    dangling = _sym(rng, 25, density=0.4)
    dangling[5, :] = dangling[:, 5] = 0.0           # an isolated node
    return np.stack([dense, sparse, dangling])


@pytest.mark.parametrize("density", [1.0, 0.3])
def test_eigenvector_centrality_matches_jax(density):
    rng = np.random.default_rng(10)
    ws = []
    for _ in range(3):
        w = _sym(rng, 30, density=density)
        w[w.sum(1) == 0, 0] = 0.5
        ws.append((w + w.T) / 2)
    ws = np.stack(ws)
    got, ok = TC.eigenvector_centrality(_t(ws), return_converged=True)
    assert got.dtype == torch.float64 and bool(ok.all())
    np.testing.assert_allclose(got.numpy(),
                               _jax_each("eigenvector_centrality", ws),
                               rtol=0, atol=1e-10)


def test_pagerank_matches_jax_dense_sparse_dangling():
    ws = _pagerank_graphs(np.random.default_rng(11))
    got, ok = TC.pagerank(_t(ws), return_converged=True)
    assert bool(ok.all())
    np.testing.assert_allclose(got.numpy(), _jax_each("pagerank", ws),
                               rtol=0, atol=1e-10)


def test_betweenness_full_pivots_matches_jax():
    rng = np.random.default_rng(12)
    n = 18
    ws = np.stack([_sym(rng, n, density=0.5), _sym(rng, n)])
    piv = np.tile(np.arange(n, dtype=np.int32), (2, 1))
    got = TC.betweenness_centrality(_t(ws), _t(piv))
    np.testing.assert_allclose(
        got.numpy(), _jax_each("betweenness_centrality", ws, piv),
        rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_betweenness_sampled_pivots_matches_jax(dtype):
    """networkx's pivot draw, K = 7 of 22 nodes, both normalizations;
    float32 (the eps 1e-5 tie rule) to 1e-6 against JAX's float32."""
    rng = np.random.default_rng(13)
    n, k = 22, 7
    ws = np.stack([_sym(rng, n, density=0.6), _sym(rng, n, density=0.9),
                   _sym(rng, n, density=0.3)])
    piv = np.stack([random.Random(s).sample(range(n), k)
                    for s in (123, 5, 9)]).astype(np.int32)
    tol = 1e-10 if dtype == "float64" else 1e-6
    import jax.numpy as jnp
    for normalized in (True, False):
        got = TC.betweenness_centrality(
            _t(ws), _t(piv), normalized=normalized,
            dtype=getattr(torch, dtype))
        assert str(got.dtype) == f"torch.{dtype}"
        want = _jax_each("betweenness_centrality", ws, piv,
                         normalized=normalized, dtype=getattr(jnp, dtype))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))


def test_core_number_and_kcore_scores_equal_jax():
    rng = np.random.default_rng(14)
    ws = np.stack([_sym(rng, 40, density=0.15), _sym(rng, 40, density=0.5),
                   np.zeros((40, 40))])
    adj = (ws != 0).astype(np.float32)
    core = TC.core_number(_t(adj))
    np.testing.assert_array_equal(core.numpy(), _jax_each("core_number", adj))
    kc = TC.weighted_kcore_scores(_t(ws))
    np.testing.assert_array_equal(kc.numpy(),
                                  _jax_each("weighted_kcore_scores", ws))
    assert not kc[2].any()                          # edgeless: zeros


def _mixed_batch(rng, n=24):
    """Graphs whose power iterations converge after very different counts:
    a dense random graph (fast), two cliques joined by one weak edge (a
    small spectral gap: slow), a sparse one and a path."""
    fast = _sym(rng, n)
    slow = np.zeros((n, n))
    h = n // 2
    slow[:h, :h] = 1.0
    slow[h:, h:] = 0.97
    slow[h - 1, h] = slow[h, h - 1] = 1e-3
    np.fill_diagonal(slow, 0.0)
    path = np.zeros((n, n))
    idx = np.arange(n - 1)
    path[idx, idx + 1] = path[idx + 1, idx] = 0.5 + rng.random(n - 1) / 2
    return np.stack([fast, slow, _sym(rng, n, density=0.3), path])


def test_batched_equals_per_sample():
    """Every element stops on its own condition and keeps its carry: the
    batched result equals each graph run alone, bit for bit, though the
    graphs take different iteration counts."""
    ws = _mixed_batch(np.random.default_rng(15))
    piv = np.stack([random.Random(s).sample(range(24), 10)
                    for s in range(4)])
    iters = []
    for i in range(len(ws)):
        TC.reset_loop_counts()
        TC.eigenvector_centrality(_t(ws[i:i + 1]))
        iters.append(TC.loop_counts()["eigenvector"]["iterations"])
    assert max(iters) >= 3 * min(iters), iters
    fns = {
        "eigenvector": lambda w, p: TC.eigenvector_centrality(
            w, return_converged=True),
        "pagerank": lambda w, p: TC.pagerank(w, return_converged=True),
        "betweenness": lambda w, p: TC.betweenness_centrality(w, p),
        "betweenness_f32": lambda w, p: TC.betweenness_centrality(
            w, p, dtype=torch.float32),
        "kcore": lambda w, p: TC.weighted_kcore_scores(w),
    }
    for name, fn in fns.items():
        batched = fn(_t(ws), _t(piv))
        for i in range(len(ws)):
            alone = fn(_t(ws[i:i + 1]), _t(piv[i:i + 1]))
            for b, a in zip(batched if isinstance(batched, tuple)
                            else (batched,),
                            alone if isinstance(alone, tuple) else (alone,)):
                assert torch.equal(b[i:i + 1], a), (name, i)


def test_loop_counts_record_iterations_and_syncs():
    ws = _mixed_batch(np.random.default_rng(16))
    TC.reset_loop_counts()
    TC.pagerank(_t(ws))
    counts = TC.loop_counts()
    assert list(counts) == ["pagerank"]
    # one host read per iteration, and the final one that ends the loop
    assert counts["pagerank"]["syncs"] == counts["pagerank"]["iterations"] + 1
    TC.reset_loop_counts()
    assert TC.loop_counts() == {}


def test_eigenvector_reports_non_convergence():
    """(I + A) of a triangle with weights -2 has eigenvalues +-3 of equal
    size: the iterate flips sign each step and never converges; the flag
    says so for that element only."""
    bad = -2.0 * (np.ones((3, 3)) - np.eye(3))
    good = _sym(np.random.default_rng(17), 3) + 0.1
    np.fill_diagonal(good, 0.0)
    _, ok = TC.eigenvector_centrality(_t(np.stack([bad, good])),
                                      return_converged=True)
    assert ok.tolist() == [False, True]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's results are held to "
                    "the CPU's there (python3 chip_smoke.py phase 8 too)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_centralities_on_card_match_cpu(cuda_device):
    """float64 within 1e-9 of the CPU, core numbers equal."""
    rng = np.random.default_rng(18)
    ws = np.concatenate([_mixed_batch(rng, 60),
                         _pagerank_graphs(rng)[:, :24, :24].repeat(
                             3, axis=1).repeat(3, axis=2)[:, :60, :60]])
    piv = np.stack([random.Random(s).sample(range(60), 10)
                    for s in range(len(ws))])
    for fn in (TC.eigenvector_centrality, TC.pagerank,
               lambda w: TC.betweenness_centrality(w, _t(piv).to(w.device))):
        card = fn(_t(ws).to(cuda_device)).cpu()
        host = fn(_t(ws))
        assert float((card - host).abs().max()) <= 1e-9
    assert torch.equal(TC.weighted_kcore_scores(_t(ws).to(cuda_device)).cpu(),
                       TC.weighted_kcore_scores(_t(ws)))
