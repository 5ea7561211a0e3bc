"""Graph centralities of the evaluation pass, batched, in torch.

Counterpart of ``fcsr_tpu/evalx/centrality.py``: tensor versions of the
NetworkX algorithms the reference runs per sample on the host, with the
same semantics:

  * eigenvector centrality: (I + A) power iteration, L2 normalization,
    L1 convergence at n * tol (networkx eigenvector_centrality);
  * PageRank: row-stochastic power iteration with dangling handling
    (networkx _pagerank_scipy);
  * betweenness centrality: pivot-sampled Brandes, Dijkstra distances by
    dense min-plus (Bellman-Ford) relaxation, path counts and
    dependencies as fixpoints over the predecessor DAG. Edge weights act
    as DISTANCES, as in networkx;
  * core number: iterative peeling of the binary topology. The
    reference's 'weighted k-core' scales the weights to integers, then
    calls nx.core_number, which ignores edge data: it is the plain k-core
    of the unweighted topology, and so is this.

Every function takes a batch on its leading axis. Each iteration runs on
the whole batch as the JAX package's ``vmap`` of ``lax.while_loop`` does:
an element steps while its own condition holds and keeps its carry once
the condition fails, and the loop ends when no element's condition holds
(one host read of the batch's condition per iteration). ``loop_counts()``
gives the iterations and host syncs of each loop since
``reset_loop_counts()``.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["eigenvector_centrality", "pagerank", "betweenness_centrality",
           "core_number", "weighted_kcore_scores", "loop_counts",
           "reset_loop_counts"]

_INF = 1e30

# loop name -> [iterations, host syncs]
_LOOPS: Dict[str, list] = {}


def loop_counts() -> Dict[str, Dict[str, int]]:
    """Iterations and host syncs of each batched loop since the last
    ``reset_loop_counts()``."""
    return {k: {"iterations": v[0], "syncs": v[1]} for k, v in _LOOPS.items()}


def reset_loop_counts():
    _LOOPS.clear()


def _while(name: str, cond, body, state):
    """``jax.lax.while_loop`` under ``vmap`` over the leading axes of
    ``cond``'s result: ``body`` runs on the whole batch and only the
    elements whose condition held take its result."""
    rec = _LOOPS.setdefault(name, [0, 0])
    while True:
        active = cond(state)
        rec[1] += 1
        if not bool(active.any()):
            return state
        new = body(state)
        state = tuple(
            torch.where(active.reshape(active.shape
                                       + (1,) * (s.dim() - active.dim())),
                        a, s)
            for a, s in zip(new, state))
        rec[0] += 1


def _offdiag(w):
    n = w.shape[-1]
    return w * (1.0 - torch.eye(n, dtype=w.dtype, device=w.device))


def _matvec(m, x):
    """(..., n, n) @ (..., n) -> (..., n), as a row vector times m^T: on
    the CPU a batch of one takes another summation order in ``m @ x``
    (a matrix-vector routine) than a larger batch, and this form takes
    the same in both, so a graph's result does not depend on its batch."""
    return torch.matmul(x.unsqueeze(-2), m.mT).squeeze(-2)


def _vecmat(x, m):
    """(..., n) @ (..., n, n) -> (..., n)."""
    return torch.matmul(x.unsqueeze(-2), m).squeeze(-2)


def eigenvector_centrality(w, max_iter: int = 1000, tol: float = 1e-6,
                           return_converged: bool = False,
                           dtype=torch.float64):
    """NetworkX-semantics eigenvector centrality of each weighted
    undirected graph of the (B, n, n) stack (self-loops ignored); (B, n).

    ``return_converged`` also returns each element's convergence flag (B,):
    networkx RAISES PowerIterationFailedConvergence when max_iter is
    exhausted, and callers should mirror that (report.py does)."""
    w = _offdiag(w.to(dtype))
    b, n = w.shape[0], w.shape[-1]
    x0 = torch.full((b, n), 1.0 / n, dtype=dtype, device=w.device)

    def cond(state):
        _, it, done = state
        return (~done) & (it < max_iter)

    def body(state):
        x, it, done = state
        xlast = x
        x = xlast + _matvec(w, xlast)
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        x = x / torch.where(norm == 0, 1.0, norm)
        new_done = torch.sum(torch.abs(x - xlast), dim=-1) < n * tol
        # an element that has converged keeps networkx's stopping point
        x = torch.where(done[:, None], xlast, x)
        return x, it + 1, done | new_done

    x, _, done = _while(
        "eigenvector", cond, body,
        (x0, torch.zeros(b, dtype=torch.int64, device=w.device),
         torch.zeros(b, dtype=torch.bool, device=w.device)))
    if return_converged:
        return x, done
    return x


def pagerank(w, alpha: float = 0.85, max_iter: int = 100, tol: float = 1e-6,
             return_converged: bool = False, dtype=torch.float64):
    """NetworkX-semantics PageRank of each dense weighted matrix of the
    (B, n, n) stack (self-loops ignored; the graphs are undirected, so in-
    and out-edges coincide); (B, n). ``return_converged`` / ``dtype``: see
    eigenvector_centrality."""
    w = _offdiag(w.to(dtype))
    b, n = w.shape[0], w.shape[-1]
    s = w.sum(dim=-1, keepdim=True)
    a = torch.where(s != 0, w / torch.where(s == 0, 1.0, s), 0.0)
    dangling = s[..., 0] == 0
    p = torch.full((b, n), 1.0 / n, dtype=dtype, device=w.device)

    def cond(state):
        _, it, done = state
        return (~done) & (it < max_iter)

    def body(state):
        x, it, done = state
        xlast = x
        x = alpha * (_vecmat(x, a)
                     + torch.sum(torch.where(dangling, x, 0.0), dim=-1,
                                 keepdim=True) * p) \
            + (1 - alpha) * p
        new_done = torch.sum(torch.abs(x - xlast), dim=-1) < n * tol
        x = torch.where(done[:, None], xlast, x)  # see eigenvector_centrality
        return x, it + 1, done | new_done

    x, _, done = _while(
        "pagerank", cond, body,
        (p, torch.zeros(b, dtype=torch.int64, device=w.device),
         torch.zeros(b, dtype=torch.bool, device=w.device)))
    if return_converged:
        return x, done
    return x


def _dijkstra_dense(dist_mx, sources):
    """Shortest-path distances (B, K, n) from each of the K ``sources`` of
    each (n, n) distance matrix (non-edges _INF), by min-plus
    (Bellman-Ford) relaxation to its fixpoint: as many sweeps as the
    shortest-path tree is deep, at most n."""
    b, n = dist_mx.shape[0], dist_mx.shape[-1]
    d0 = torch.full(tuple(sources.shape) + (n,), _INF, dtype=dist_mx.dtype,
                    device=dist_mx.device).scatter_(-1, sources[..., None],
                                                    0.0)
    edges = dist_mx[:, None]

    def cond(state):
        _, changed, it = state
        return changed & (it < n)

    def body(state):
        d, _, it = state
        d2 = torch.minimum(d, torch.amin(d[..., :, None] + edges, dim=-2))
        return d2, torch.any(d2 < d, dim=-1), it + 1

    d, _, _ = _while(
        "dijkstra", cond, body,
        (d0, torch.ones(sources.shape, dtype=torch.bool, device=d0.device),
         torch.zeros(sources.shape, dtype=torch.int64, device=d0.device)))
    return d


def _brandes_from_pivots(dist_mx, sources, eps: float = 1e-12):
    """Brandes dependencies (B, K, n) of every node on each of the K
    ``sources`` of each distance matrix (endpoints excluded).

    Predecessor relation: edge (u, v) with d[u] + w(u, v) == d[v] within
    eps scaled by |d[v]|, and d[u] < d[v] strictly: without the strict
    guard a near-tie in both directions makes a 2-cycle and the path
    counts explode (float32); with it d increases along every edge, so
    the predecessor graph is acyclic in any precision. On that DAG

        sigma = e_s + P^T sigma,   delta = R (1 + delta),
        R = P * sigma_u / sigma_v

    reach their fixpoints in DAG-depth iterations, equal to the textbook
    distance-ordered accumulation."""
    n = dist_mx.shape[-1]
    d = _dijkstra_dense(dist_mx, sources)
    reach = d < _INF / 2
    has_edge = (dist_mx < _INF / 2)[:, None]
    tol = eps * (1.0 + torch.abs(d))[..., None, :]
    edges = dist_mx[:, None]
    pred = has_edge & reach[..., :, None] & reach[..., None, :] \
        & (torch.abs(d[..., :, None] + edges - d[..., None, :]) <= tol) \
        & (d[..., :, None] < d[..., None, :])
    p_mx = pred.to(d.dtype)
    src = sources[..., None]
    e_s = torch.zeros_like(d).scatter_(-1, src, 1.0)
    never = torch.full_like(d, -1.0)
    steps = torch.zeros(sources.shape, dtype=torch.int64, device=d.device)

    def sig_cond(state):
        sigma, prev, it = state
        return torch.any(sigma != prev, dim=-1) & (it < n + 1)

    def sig_body(state):
        sigma, _, it = state
        new = (e_s + _vecmat(sigma, p_mx)).scatter(-1, src, 1.0)
        return new, sigma, it + 1

    sigma, _, _ = _while("brandes_sigma", sig_cond, sig_body,
                         (e_s, never, steps))

    # R[u, v] = pred[u, v] * sigma_u / sigma_v (0 where sigma_v == 0)
    safe = torch.where(sigma > 0, sigma, 1.0)
    r_mx = p_mx * sigma[..., :, None] / safe[..., None, :]
    r_mx = r_mx * (sigma > 0)[..., None, :]

    def del_cond(state):
        delta, prev, it = state
        return torch.any(delta != prev, dim=-1) & (it < n + 1)

    def del_body(state):
        delta, _, it = state
        new = _matvec(r_mx, 1.0 + delta).scatter(-1, src, 0.0)
        return new, delta, it + 1

    delta, _, _ = _while("brandes_delta", del_cond, del_body,
                         (torch.zeros_like(d), never, steps))
    return delta.scatter(-1, src, 0.0)


def betweenness_centrality(w, pivots, normalized: bool = True,
                           dtype=torch.float64):
    """Pivot-sampled weighted betweenness centrality of each graph of the
    (B, n, n) stack (networkx betweenness_centrality(weight='weight',
    k=K)); (B, n).

    ``pivots``: (B, K) int source nodes per graph (sample them on the host
    to mirror the reference's pivot draw). Weights act as distances.
    Normalized with the networkx >= 3.5 sampling rescale: pivots by
    1/((K-1)(n-2)), other nodes by 1/(K(n-2)).

    ``dtype``: float64 reproduces networkx to ~1e-9; in float32 the
    predecessor-tie tolerance widens from 1e-12 to 1e-5 relative, so
    near-degenerate shortest-path ties may resolve differently."""
    w = _offdiag(w.to(dtype))
    n = w.shape[-1]
    pivots = torch.as_tensor(pivots, dtype=torch.int64, device=w.device)
    k = pivots.shape[-1]
    eps = 1e-12 if dtype == torch.float64 else 1e-5
    eye = torch.eye(n, dtype=torch.bool, device=w.device)
    dist_mx = torch.where(w != 0, w, _INF)
    dist_mx = torch.where(eye, _INF, dist_mx)

    bc = _brandes_from_pivots(dist_mx, pivots, eps=eps).sum(dim=1)

    if normalized:
        scale_src = 1.0 / ((k - 1) * (n - 2)) if k > 1 else float("nan")
        scale_non = 1.0 / (k * (n - 2))
    else:
        scale_src = (n - 1) / ((k - 1) * 2.0) if k > 1 else float("nan")
        scale_non = (n - 1) / (k * 2.0)
    is_pivot = torch.zeros(bc.shape, dtype=torch.bool,
                           device=w.device).scatter_(-1, pivots, True)
    scale = torch.full_like(bc, scale_non).masked_fill(is_pivot, scale_src)
    return bc * scale


def core_number(adj_bool):
    """k-core numbers (B, n) of each binary undirected topology of the
    (B, n, n) stack by iterative peeling (networkx core_number semantics;
    self-loops are ignored). Integral values in float64."""
    adj = _offdiag(adj_bool.to(torch.float32))
    b, n = adj.shape[0], adj.shape[-1]

    def degrees(alive):
        # 0/1 sums: exact in float32 (and in TF32)
        return _matvec(adj, alive.to(adj.dtype))

    def cond(state):
        alive, _, _ = state
        return alive.any(dim=-1)

    def body(state):
        alive, core, k = state
        deg = degrees(alive) * alive
        deg = torch.where(alive, deg, torch.inf)
        k = torch.maximum(k, deg.amin(dim=-1))

        # peel everything with degree <= k until fixpoint at this k
        def peel_cond(s):
            alive_i, _ = s
            return (alive_i & (degrees(alive_i) <= k[:, None])).any(dim=-1)

        def peel_body(s):
            alive_i, core_i = s
            remove = alive_i & (degrees(alive_i) <= k[:, None])
            core_i = torch.where(remove, k[:, None].to(core_i.dtype), core_i)
            return alive_i & ~remove, core_i

        alive, core = _while("kcore_peel", peel_cond, peel_body,
                             (alive, core))
        return alive, core, k

    alive0 = adj.sum(dim=-1) >= 0  # every node (isolated nodes get core 0)
    _, core, _ = _while(
        "kcore", cond, body,
        (alive0, torch.zeros((b, n), dtype=torch.float64, device=adj.device),
         torch.zeros(b, dtype=torch.float32, device=adj.device)))
    return core


def weighted_kcore_scores(w):
    """The reference's 'core-periphery' score of each graph of the
    (B, n, n) stack: the plain k-core of the nonzero off-diagonal topology
    (the reference's integer weight scaling feeds nx.core_number, which
    ignores weights), divided by the largest core; zeros for an edgeless
    graph. (B, n) float64."""
    core = core_number(w != 0)
    mx = core.amax(dim=-1, keepdim=True)
    return torch.where(mx > 0, core / torch.where(mx > 0, mx, 1.0),
                       torch.zeros_like(core))
