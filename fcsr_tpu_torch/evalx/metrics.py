"""Global metrics (MAE, Pearson r, Jensen-Shannon distance) and the
per-sample edge-weight-histogram KL divergence, in torch.

Counterpart of ``fcsr_tpu/evalx/metrics.py``: the scipy / numpy calls of
the reference's evaluation pass written as tensor code. The histogram KL
takes a batch on its leading axis and runs on the tensors' device.
"""

from __future__ import annotations

import torch

__all__ = ["mae", "pearson_corr", "jensen_shannon_distance",
           "weight_histogram_kl", "edge_weight_mask"]


def mae(a, b):
    return torch.mean(torch.abs(torch.as_tensor(a) - torch.as_tensor(b)))


def pearson_corr(x, y):
    """Pearson correlation coefficient (scipy.stats.pearsonr[0]) in
    float64: over stacks of millions of entries a float32 sum loses 3-4
    digits."""
    x = torch.as_tensor(x, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64)
    xm = x - x.mean()
    ym = y - y.mean()
    num = torch.sum(xm * ym)
    den = torch.sqrt(torch.sum(xm * xm) * torch.sum(ym * ym))
    return num / den


def jensen_shannon_distance(p, q):
    """scipy.spatial.distance.jensenshannon semantics: normalize inputs to
    probability vectors, JS divergence with natural log, return the sqrt."""
    p = torch.as_tensor(p, dtype=torch.float64)
    q = torch.as_tensor(q, dtype=torch.float64)
    p = p / p.sum()
    q = q / q.sum()
    m = (p + q) / 2.0

    def kl(a, b):
        ratio = torch.where(a > 0, a / torch.where(b > 0, b, 1.0), 1.0)
        return torch.sum(torch.where(a > 0, a * torch.log(ratio), 0.0))

    js = (kl(p, m) + kl(q, m)) / 2.0
    return torch.sqrt(torch.clamp(js, min=0.0))


def edge_weight_mask(w):
    """Boolean mask of undirected non-self-loop edges (i < j, weight != 0):
    the edge set networkx builds from a dense matrix after removing self
    loops. ``w`` is (..., n, n)."""
    n = w.shape[-1]
    iu = torch.triu(torch.ones((n, n), dtype=torch.bool, device=w.device),
                    diagonal=1)
    return iu & (w != 0)


def _masked_histogram(values, mask, lo, hi, bins: int):
    """Fixed-bin float32 counts of each matrix's ``values`` under ``mask``
    (B, n, n), over [lo, hi] (B,); numpy.histogram's closed right edge on
    the last bin."""
    b = values.shape[0]
    width = (hi - lo) / bins
    scale = torch.where(width > 0, width, 1.0)
    idx = torch.floor((values - lo[:, None, None]) / scale[:, None, None])
    idx = torch.clamp(idx, 0, bins - 1).to(torch.int64)
    flat_idx = torch.where(mask, idx, bins)  # out-of-range slot for masked-out
    counts = torch.zeros((b, bins + 1), dtype=torch.float32,
                         device=values.device)
    counts.scatter_add_(1, flat_idx.reshape(b, -1),
                        mask.to(torch.float32).reshape(b, -1))
    return counts[:, :bins]


def weight_histogram_kl(gt, pred, bins: int = 50, eps: float = 1e-10):
    """KL divergence between the 50-bin edge-weight distributions of each
    ground-truth / prediction pair of the (B, n, n) stacks; returns (B,).

    The bin range is [min, max] over the union of both graphs' (nonzero,
    off-diagonal, upper-triangle) edge weights; histograms are
    density-normalized, epsilon-smoothed, renormalized, then
    KL(gt || pred) with natural log.
    """
    m_gt = edge_weight_mask(gt)
    m_pr = edge_weight_mask(pred)
    big = torch.finfo(torch.float32).max

    def extremes(w, m):
        # an edgeless graph's weights are the placeholder [0]
        has = m.flatten(1).any(-1)
        lo = torch.where(m, w, big).flatten(1).amin(-1)
        hi = torch.where(m, w, -big).flatten(1).amax(-1)
        return has, torch.where(has, lo, 0.0), torch.where(has, hi, 0.0)

    any_gt, min_gt, max_gt = extremes(gt, m_gt)
    any_pr, min_pr, max_pr = extremes(pred, m_pr)
    lo = torch.minimum(min_gt, min_pr)
    hi = torch.maximum(max_gt, max_pr)

    # numpy adds eps to DENSITY values (counts / (total * width)), and the
    # renormalization does not commute with adding eps to raw counts
    width = torch.where(hi > lo, (hi - lo) / bins, 1.0)

    # an EDGELESS graph contributes one literal placeholder weight 0.0 to
    # its histogram, not an empty histogram (which would smooth to uniform)
    idx0 = torch.clamp(torch.floor((0.0 - lo) / width), 0,
                       bins - 1).to(torch.int64)
    placeholder = torch.zeros((gt.shape[0], bins), dtype=torch.float32,
                              device=gt.device)
    placeholder.scatter_(1, idx0[:, None], 1.0)

    def density(values, mask, has_edges):
        counts = _masked_histogram(values, mask, lo, hi, bins)
        counts = torch.where(has_edges[:, None], counts, placeholder)
        total = torch.where(has_edges,
                            torch.clamp(mask.flatten(1).sum(-1), min=1), 1)
        d = counts / (total * width)[:, None] + eps
        return d / d.sum(-1, keepdim=True)

    h_gt = density(gt, m_gt, any_gt)
    h_pr = density(pred, m_pr, any_pr)
    return torch.sum(h_gt * torch.log(h_gt / h_pr), dim=-1)
