"""Dense <-> COO graph conversions and topological node features.

Counterpart of ``fcsr_tpu/core/graph.py``. The framework is dense-native
(connectomes are small, <= 268 nodes, and nearly dense), so dense
(B, n, n) stacks are the canonical form; COO conversion is kept for
interop / export, and the topological node features are computed batched
on the tensors' device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["COOGraph", "create_graph", "to_dense_adj",
           "topological_node_features"]


class COOGraph(NamedTuple):
    """Edge-list graph: the dense-free exchange format
    (mirrors PyG Data: x / edge_index / edge_attr / num_nodes)."""
    x: np.ndarray            # (n, f) node features
    edge_index: np.ndarray   # (2, e) int
    edge_attr: np.ndarray    # (e,) weights
    num_nodes: int


def create_graph(adjacency: np.ndarray,
                 node_features: Optional[np.ndarray] = None) -> COOGraph:
    """Dense adjacency -> COO graph; edges where A > 0, ones features by
    default."""
    adjacency = np.asarray(adjacency)
    rows, cols = np.where(adjacency > 0)
    edge_index = np.stack([rows, cols])
    edge_attr = adjacency[rows, cols]
    x = (node_features if node_features is not None
         else np.ones((adjacency.shape[0], 1), dtype=adjacency.dtype))
    return COOGraph(x=x, edge_index=edge_index, edge_attr=edge_attr,
                    num_nodes=adjacency.shape[0])


def to_dense_adj(graph: COOGraph) -> np.ndarray:
    """COO -> dense (PyG to_dense_adj single-graph semantics)."""
    a = np.zeros((graph.num_nodes, graph.num_nodes),
                 dtype=graph.edge_attr.dtype)
    a[graph.edge_index[0], graph.edge_index[1]] = graph.edge_attr
    return a


def topological_node_features(w) -> Dict[str, torch.Tensor]:
    """Batched topological node features in float32, the reference's
    ``calculate_topological_metrics``:

      degree          - WEIGHTED row sum (the reference's 'degree')
      strength        - identical to degree (the reference clones it)
      clustering      - diag(W^3) / (degree * (degree - 1)), weighted,
                        no 1/2 factor
      avg_neighbor_degree - (W @ degree) / |{j : w_ij > 0}|
      degree_centrality   - degree / (n - 1)
      closeness       - rowsum((I - W)^-1) / (n - 1): a resolvent proxy,
                        not shortest paths (reproduced as-is, including
                        its numerical fragility when the spectral radius
                        of W is near 1)
      betweenness     - zeros: the reference's loop is an unfinished
                        ``pass`` stub; use
                        evalx.centrality.betweenness_centrality for a real
                        value
      eigenvector     - 100-step power iteration on W, L2-normalized

    Input (B, n, n) or (n, n), a tensor or an array; returns a dict of
    (..., n) tensors plus ``stacked``: the reference's (..., n, 8) feature
    layout.
    """
    w = torch.as_tensor(w, dtype=torch.float32)
    n = w.shape[-1]

    degree = w.sum(dim=-1)
    strength = degree

    triangles = torch.diagonal(w @ (w @ w), dim1=-2, dim2=-1)
    possible = degree * (degree - 1.0)
    clustering = torch.where(
        possible > 0,
        triangles / torch.where(possible > 0, possible, 1.0), 0.0)

    neighbor_deg = (w @ degree[..., None])[..., 0]
    neighbor_cnt = (w > 0).sum(dim=-1).to(w.dtype)
    avg_neighbor_degree = torch.where(
        neighbor_cnt > 0,
        neighbor_deg / torch.where(neighbor_cnt > 0, neighbor_cnt, 1.0), 0.0)

    degree_centrality = degree / (n - 1)

    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    closeness = torch.linalg.inv(eye - w).sum(dim=-1) / (n - 1)

    betweenness = torch.zeros_like(degree)

    ec = torch.ones(w.shape[:-1] + (1,), dtype=w.dtype, device=w.device)
    for _ in range(100):
        ec = w @ ec
        ec = ec / torch.linalg.vector_norm(ec, dim=(-2, -1), keepdim=True)
    ec = ec[..., 0]

    feats = {"degree": degree, "strength": strength,
             "clustering": clustering,
             "avg_neighbor_degree": avg_neighbor_degree,
             "degree_centrality": degree_centrality,
             "closeness": closeness, "betweenness": betweenness,
             "eigenvector": ec}
    feats["stacked"] = torch.stack(
        [degree, strength, clustering, avg_neighbor_degree,
         degree_centrality, closeness, betweenness, ec], dim=-1)
    return feats
