"""Full evaluation pass: per-sample topology metrics and global regression
metrics, the reference's ``print_metrics``, with two backends:

  * ``backend="device"``: the batched torch centralities of
    ``centrality.py`` on ``device`` (the card unless the caller asks for
    the CPU);
  * ``backend="networkx"``: the reference's host NetworkX / scipy
    pipeline, for bit-parity of official numbers. It needs the
    ``networkx`` package; without it the call raises.

Counterpart of ``fcsr_tpu/evalx/report.py``, with its documented
divergences from the reference: the results file is named with the actual
fold index, and the betweenness pivots are drawn from a seeded generator.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional

import numpy as np
import torch

from fcsr_tpu_torch.core.vectorize import triu_indices_colmajor
from fcsr_tpu_torch.evalx import centrality as C
from fcsr_tpu_torch.evalx import metrics as M
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["print_metrics", "evaluate_pair_stacks", "evaluate_metrics",
           "require_networkx"]

_DTYPES = {"float64": torch.float64, "float32": torch.float32}

# the per-sample rows of the device backend, in the order _topo_rows
# stacks them
_TOPO_ROWS = ("mae_betweenness", "mae_eigenvector", "mae_pagerank",
              "mae_core_periphery", "kl_weights", "ec_converged",
              "pr_converged")

# the default chunk: as many samples as keep one (2 x samples, pivots, n, n)
# temporary of the betweenness pass (pred and gt, 10 pivots each) within
# 1 GiB; the pass holds a few such temporaries at once
_CHUNK_BYTES = 1 << 30


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def evaluate_metrics(apply_fn, lr_stack, hr_stack, fold_i: int = 0,
                     backend: str = "device", **kwargs):
    """Run the model forward over a validation stack and report the full
    metric suite. ``apply_fn(lr_stack) -> pred_stack`` (a numpy array or a
    tensor on any device)."""
    preds = _to_numpy(apply_fn(np.asarray(lr_stack, dtype=np.float32)))
    return print_metrics(np.asarray(hr_stack), preds, fold_i=fold_i,
                         backend=backend, **kwargs)


def _sample_pivots(n: int, k: int, rng: random.Random) -> np.ndarray:
    """Mirror networkx's ``seed.sample(list(G.nodes()), k)`` pivot draw."""
    return np.asarray(rng.sample(range(n), k), dtype=np.int32)


def require_networkx():
    """The ``networkx`` module; an ImportError naming it where it is not
    installed (the networkx backend never falls back to the device)."""
    try:
        import networkx as nx
    except ImportError as e:
        raise ImportError(
            "backend='networkx' needs the networkx package, which is not "
            "installed here; use backend='device'") from e
    return nx


def _topo_rows(w, pivots, m: int, dtype):
    """The per-sample rows (_TOPO_ROWS, m) in float64 for one chunk: ``w``
    stacks the chunk's m predictions, then its m ground truths, and
    ``pivots`` their betweenness sources. The betweenness pass runs in
    ``dtype``; eigenvector centrality and PageRank always run in float64
    (their networkx stopping criterion, n * 1e-6 on the L1 change of the
    iterate, sits at float32's noise floor at n = 268)."""
    bc = C.betweenness_centrality(w, pivots, dtype=dtype)
    ec, ec_ok = C.eigenvector_centrality(w, return_converged=True)
    pr, pr_ok = C.pagerank(w, return_converged=True)
    kc = C.weighted_kcore_scores(w)
    kl = M.weight_histogram_kl(w[m:], w[:m])

    def gap(x):
        return torch.mean(torch.abs(x[:m] - x[m:]), dim=1).to(torch.float64)

    return torch.stack([gap(bc), gap(ec), gap(pr), gap(kc),
                        kl.to(torch.float64),
                        (ec_ok[:m] & ec_ok[m:]).to(torch.float64),
                        (pr_ok[:m] & pr_ok[m:]).to(torch.float64)])


def _device_chunks(gt: np.ndarray, pred: np.ndarray, seed: Optional[int],
                   precision: str = "float64", device=DEFAULT_DEVICE):
    """The device backend's passes over the stacks: for each chunk of as
    many samples as keep a betweenness temporary within _CHUNK_BYTES,
    ``(w, pivots, m, dtype)``: the chunk's m predictions then its m ground
    truths on ``device`` in ``precision``, and their betweenness
    sources."""
    n_samples, n, _ = gt.shape
    k = min(10, n)
    rng = random.Random(seed)
    # the reference evaluates pred-BC then gt-BC per sample: draw in that
    # order for cross-backend parity
    piv_pred, piv_gt = [], []
    for _ in range(n_samples):
        piv_pred.append(_sample_pivots(n, k, rng))
        piv_gt.append(_sample_pivots(n, k, rng))
    piv_pred, piv_gt = np.stack(piv_pred), np.stack(piv_gt)

    if precision not in _DTYPES:
        raise ValueError(f"unknown precision: {precision!r}")
    dtype = _DTYPES[precision]
    dev = resolve_device(device)
    chunk = max(1, _CHUNK_BYTES // (2 * k * n * n * torch.finfo(dtype).bits
                                    // 8))
    gt_d = torch.from_numpy(np.ascontiguousarray(gt, dtype=precision)) \
        .to(dev)
    pred_d = torch.from_numpy(np.ascontiguousarray(pred, dtype=precision)) \
        .to(dev)
    piv_d = torch.from_numpy(np.stack([piv_pred, piv_gt]).astype(np.int64)) \
        .to(dev)
    for lo in range(0, n_samples, chunk):
        sl = slice(lo, lo + chunk)
        yield (torch.cat([pred_d[sl], gt_d[sl]]),
               torch.cat([piv_d[0, sl], piv_d[1, sl]]),
               min(chunk, n_samples - lo), dtype)


def _device_metrics(gt: np.ndarray, pred: np.ndarray, seed: Optional[int],
                    precision: str = "float64",
                    device=DEFAULT_DEVICE) -> Dict[str, float]:
    """Per-sample centrality / histogram metrics on ``device``, averaged
    on the host in float64. A chunk's predictions and ground truths go
    through the suite together (_device_chunks); the result does not
    depend on the chunk size."""
    parts = [_topo_rows(*c)
             for c in _device_chunks(gt, pred, seed, precision, device)]
    # one host pull for the whole stack
    packed = torch.cat(parts, dim=1).cpu().numpy()
    rows = dict(zip(_TOPO_ROWS, packed))

    for key, what in (("ec_converged", "eigenvector centrality"),
                      ("pr_converged", "pagerank")):
        if not bool(rows[key].all()):
            # networkx raises PowerIterationFailedConvergence here;
            # reporting the last iterate would make the two backends
            # compute different quantities
            raise RuntimeError(
                f"{what} power iteration failed to converge within "
                "max_iter (networkx raises "
                "PowerIterationFailedConvergence for this input)")
    return {key: float(np.mean(rows[key]))
            for key in ("mae_betweenness", "mae_eigenvector",
                        "mae_pagerank", "mae_core_periphery",
                        "kl_weights")}


def _networkx_metrics(gt: np.ndarray, pred: np.ndarray,
                      seed: Optional[int]) -> Dict[str, float]:
    """The reference's exact host pipeline."""
    nx = require_networkx()
    from scipy.stats import entropy

    if seed is not None:
        random.seed(seed)
    mae_bc, mae_ec, mae_pc, mae_cp, kls = [], [], [], [], []
    for i in range(len(gt)):
        pg = nx.from_numpy_array(pred[i], edge_attr="weight")
        gg = nx.from_numpy_array(gt[i], edge_attr="weight")
        pg.remove_edges_from(nx.selfloop_edges(pg))
        gg.remove_edges_from(nx.selfloop_edges(gg))

        gw = [d["weight"] for _, _, d in gg.edges(data=True)] or [0]
        pw = [d["weight"] for _, _, d in pg.edges(data=True)] or [0]
        lo = min(min(gw), min(pw))
        hi = max(max(gw), max(pw))
        gh, _ = np.histogram(gw, bins=50, range=(lo, hi), density=True)
        ph, _ = np.histogram(pw, bins=50, range=(lo, hi), density=True)
        gh, ph = gh + 1e-10, ph + 1e-10
        kls.append(entropy(gh / gh.sum(), ph / ph.sum()))

        p_bc = nx.betweenness_centrality(pg, weight="weight",
                                         k=min(10, len(pg.nodes())))
        g_bc = nx.betweenness_centrality(gg, weight="weight",
                                         k=min(10, len(gg.nodes())))
        p_ec = nx.eigenvector_centrality(pg, weight="weight", max_iter=1000)
        g_ec = nx.eigenvector_centrality(gg, weight="weight", max_iter=1000)
        p_pc = nx.pagerank(pg, weight="weight")
        g_pc = nx.pagerank(gg, weight="weight")
        p_cp = _nx_weighted_kcore(pg)
        g_cp = _nx_weighted_kcore(gg)

        def _mae(a, b):
            return float(np.mean(np.abs(np.array(list(a.values()))
                                        - np.array(list(b.values())))))

        mae_bc.append(_mae(p_bc, g_bc))
        mae_ec.append(_mae(p_ec, g_ec))
        mae_pc.append(_mae(p_pc, g_pc))
        mae_cp.append(_mae(p_cp, g_cp))
    return {
        "mae_betweenness": float(np.mean(mae_bc)),
        "mae_eigenvector": float(np.mean(mae_ec)),
        "mae_pagerank": float(np.mean(mae_pc)),
        "mae_core_periphery": float(np.mean(mae_cp)),
        "kl_weights": float(np.mean(kls)),
    }


def _nx_weighted_kcore(graph) -> Dict[int, float]:
    """The reference's weighted k-core: integer-scaled weights feed
    nx.core_number, which ignores them (see centrality.py)."""
    nx = require_networkx()
    g2 = nx.Graph()
    g2.add_nodes_from(graph.nodes())
    weights = [d["weight"] for _, _, d in graph.edges(data=True)]
    if not weights:
        return {v: 0 for v in graph.nodes()}
    min_w = min(weights)
    scale = 1.0 / min_w if min_w > 0 else 1.0
    for u, v, d in graph.edges(data=True):
        g2.add_edge(u, v, weight=max(1, int(d["weight"] * scale)))
    core = nx.core_number(g2)
    mx = max(core.values()) if core.values() else 1
    return {v: c / mx for v, c in core.items()}


def evaluate_pair_stacks(gt_matrices, pred_matrices,
                         backend: str = "device",
                         seed: Optional[int] = 42,
                         precision: str = "float64",
                         device=DEFAULT_DEVICE) -> Dict[str, float]:
    """The full metric dict of stacked (B, n, n) gt / pred matrices (numpy
    arrays or tensors).

    ``precision`` (device backend): "float64" (the default; the card runs
    it natively) matches the networkx backend to ~1e-8; "float32" runs
    the betweenness pass in float32, its metrics within ~1e-5 of float64
    where no near-zero weights make near-tied shortest paths. ``device``
    applies to the device backend, which goes over the samples in chunks
    that bound its memory. The global regression metrics (MAE, PCC, JSD)
    are host numpy / scipy in float64 either way."""
    gt = np.asarray(_to_numpy(gt_matrices), dtype=np.float64)
    pred = np.asarray(_to_numpy(pred_matrices), dtype=np.float64)

    if backend == "device":
        topo = _device_metrics(gt, pred, seed, precision=precision,
                               device=device)
    elif backend == "networkx":
        topo = _networkx_metrics(gt, pred, seed)
    else:
        raise ValueError(f"unknown backend: {backend}")
    return {**topo, **_global_metrics(gt, pred)}


def _global_metrics(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    """MAE, PCC and JSD of the float64 stacks' column-major strict-upper
    concatenations: the reference's numpy / scipy calls, on the host."""
    from scipy.spatial.distance import jensenshannon
    from scipy.stats import pearsonr
    rows, cols = triu_indices_colmajor(gt.shape[-1])
    gt_1d = gt[..., rows, cols].reshape(-1)
    pred_1d = pred[..., rows, cols].reshape(-1)
    return {"mae": float(np.mean(np.abs(gt_1d - pred_1d))),
            "pcc": float(pearsonr(gt_1d, pred_1d)[0]),
            "js_distance": float(jensenshannon(gt_1d, pred_1d))}


def print_metrics(gt_matrices, pred_matrices, fold_i: int,
                  backend: str = "device", seed: Optional[int] = 42,
                  out_dir: str = ".", write_file: bool = True,
                  verbose: bool = True,
                  precision: str = "float64",
                  device=DEFAULT_DEVICE) -> Dict[str, float]:
    """The reference's evaluation report: prints the eight metrics and
    writes ``results_fold_{fold_i}.txt``."""
    m = evaluate_pair_stacks(gt_matrices, pred_matrices, backend=backend,
                             seed=seed, precision=precision, device=device)
    lines = [
        ("MAE: ", m["mae"]),
        ("PCC: ", m["pcc"]),
        ("Jensen-Shannon Distance: ", m["js_distance"]),
        ("Average KL Divergence on weight distributions: ", m["kl_weights"]),
        ("Average MAE betweenness centrality: ", m["mae_betweenness"]),
        ("Average MAE eigenvector centrality: ", m["mae_eigenvector"]),
        ("Average MAE PageRank centrality: ", m["mae_pagerank"]),
        ("Average MAE core-periphery structure: ", m["mae_core_periphery"]),
    ]
    if verbose:
        for label, val in lines:
            print(label, val)
    if write_file:
        path = os.path.join(out_dir, f"results_fold_{fold_i}.txt")
        with open(path, "w") as f:
            for label, val in lines:
                f.write(f"{label}{val}\n")
    return m
