"""Seeded synthetic connectomes (pure numpy, float64 internally).

Counterpart of ``fcsr_tpu/data/synthetic.py`` and bit-identical to it: the
same generator calls in the same order, so seed 42 at 167 subjects
reproduces the pinned dataset contents. Two flavors:

* ``synthesize_teacher_connectomes`` (the default): HR is a hidden teacher
  drawn from GSR-Net's own realizable family, ``pred = |sym(A (A Z G1)
  G2)|`` with ``A = normalize(|W u_s^T C|)`` where ``u_s`` are the
  subject's normalized-LR eigenvectors, so the dataset is
  quality-sensitive: training cuts val MAE well below the untrained model.
* ``synthesize_paired_connectomes`` (the ``lift`` set): HR is a fixed
  soft-parcellation LIFT of the clean LR matrix, ``hr ~ L @ lr_clean @
  L^T``; statistically realistic, but not reachable through GSR-Net's
  spectral bottleneck.
"""

from __future__ import annotations

import numpy as np

LR_DIM = 160
HR_DIM = 268

__all__ = ["synthesize_paired_connectomes",
           "synthesize_teacher_connectomes", "LR_DIM", "HR_DIM"]


def _random_membership(rng, n_nodes: int, n_comm: int) -> np.ndarray:
    """Soft community membership matrix (n_nodes, n_comm), rows on simplex."""
    m = rng.gamma(shape=0.5, scale=1.0, size=(n_nodes, n_comm))
    return m / m.sum(axis=1, keepdims=True)


def _draw_lr_subject(rng, p_lr, lr_dim: int, n_comm: int, noise: float):
    """One subject's LR matrix on the shared parcellation ``p_lr``."""
    c = rng.gamma(shape=1.5, scale=1.0, size=(n_comm, n_comm))
    c = (c + c.T) / 2
    c = c / c.max()
    lr_clean = p_lr @ c @ p_lr.T
    lr_clean = lr_clean / max(lr_clean.max(), 1e-9)
    e_lr = rng.normal(0.0, noise, size=(lr_dim, lr_dim))
    lr = np.clip(lr_clean + (e_lr + e_lr.T) / 2, 0.0, 1.0)
    np.fill_diagonal(lr, 0.0)
    return lr


def synthesize_paired_connectomes(n_subjects: int, lr_dim: int = LR_DIM,
                                  hr_dim: int = HR_DIM, n_comm: int = 12,
                                  noise: float = 0.08, seed: int = 42,
                                  n_test: int = 0):
    """(lr, hr) stacks of paired connectomes: each subject gets a
    community-strength profile on a fixed LR parcellation; its HR matrix is
    a LIFT of its clean LR matrix through a fixed soft parcellation map L
    (each HR node mixes a couple of LR parents), ``hr ~ L @ lr_clean @
    L^T``.

    Returns (lr, hr): float32 (n, lr_dim, lr_dim), (n, hr_dim, hr_dim),
    symmetric, zero diagonal, clipped to [0, 1]. ``n_test > 0``
    additionally returns LR-only test subjects of the same parcellation,
    drawn at the END of the RNG stream, so the train set is bit-identical
    to ``n_test=0``.
    """
    rng = np.random.default_rng(seed)
    # fixed LR parcellation + fixed HR<-LR lift shared across subjects
    p_lr = _random_membership(rng, lr_dim, n_comm)
    lift = rng.gamma(shape=0.3, scale=1.0, size=(hr_dim, lr_dim))
    # concentrate each HR node on a dominant LR parent
    parents = rng.integers(0, lr_dim, size=hr_dim)
    lift[np.arange(hr_dim), parents] += 3.0
    lift = lift / lift.sum(axis=1, keepdims=True)

    lr_out = np.empty((n_subjects, lr_dim, lr_dim), dtype=np.float32)
    hr_out = np.empty((n_subjects, hr_dim, hr_dim), dtype=np.float32)
    for i in range(n_subjects):
        c = rng.gamma(shape=1.5, scale=1.0, size=(n_comm, n_comm))
        c = (c + c.T) / 2
        c = c / c.max()
        lr_clean = p_lr @ c @ p_lr.T
        lr_clean = lr_clean / max(lr_clean.max(), 1e-9)
        hr_clean = lift @ lr_clean @ lift.T
        hr_clean = hr_clean / max(hr_clean.max(), 1e-9)
        e_lr = rng.normal(0.0, noise, size=(lr_dim, lr_dim))
        e_hr = rng.normal(0.0, noise, size=(hr_dim, hr_dim))
        lr = lr_clean + (e_lr + e_lr.T) / 2
        hr = hr_clean + (e_hr + e_hr.T) / 2
        for m, out in ((lr, lr_out[i]), (hr, hr_out[i])):
            m = np.clip(m, 0.0, 1.0)
            np.fill_diagonal(m, 0.0)
            out[:] = m.astype(np.float32)
    if n_test:
        lr_test = np.stack([
            _draw_lr_subject(rng, p_lr, lr_dim, n_comm, noise)
            for _ in range(n_test)]).astype(np.float32)
        return lr_out, hr_out, lr_test
    return lr_out, hr_out


def _normalize_adj_np(mx):
    """f64 D^-1/2 A^T D^-1/2 with the inf->0 guard — the transposing form
    of ``core.normalize.normalize_adj`` (it differs from the symmetric form
    for the non-symmetric f_d inside the teacher forward)."""
    rowsum = mx.sum(axis=-1)
    with np.errstate(divide="ignore"):
        r = rowsum ** -0.5
    r[np.isinf(r)] = 0.0
    return (mx * r[None, :]).T * r[None, :]


def _teacher_forward(u_s, w_star, c_star, g1, g2):
    """One hidden-teacher forward: the ops of GSRLayer + the two-layer
    GraphConvolution decoder with the subject-independent U-Net output
    replaced by the constant ``c_star``."""
    f_d = np.abs((w_star @ u_s.T) @ c_star)
    np.fill_diagonal(f_d, 1.0)
    a = _normalize_adj_np(f_d)
    z = a @ a.T
    z = np.abs((z + z.T) / 2)
    np.fill_diagonal(z, 1.0)
    h1 = a @ (z @ g1)
    h2 = a @ (h1 @ g2)
    return np.abs((h2 + h2.T) / 2)


def synthesize_teacher_connectomes(n_subjects: int, lr_dim: int = LR_DIM,
                                   hr_dim: int = HR_DIM, n_comm: int = 12,
                                   lr_noise: float = 0.04,
                                   hr_noise: float = 0.005, seed: int = 42,
                                   n_test: int = 0):
    """Teacher-in-the-family paired connectomes.

    Returns (lr, hr): float32 (n, lr_dim, lr_dim), (n, hr_dim, hr_dim),
    symmetric, zero diagonal, values in [0, 1]. ``n_test > 0`` additionally
    returns LR-only test subjects drawn at the END of the RNG stream, so
    the train set is bit-identical to ``n_test=0``.
    """
    rng = np.random.default_rng(seed)
    p_lr = _random_membership(rng, lr_dim, n_comm)

    # teacher W with orthonormal columns (where the spectral loss term
    # keeps the student's W), C at U-Net-output scale, G1/G2 at 8x Xavier
    w_star = np.linalg.qr(rng.normal(size=(hr_dim, lr_dim)))[0]
    c_star = rng.normal(0.0, 0.5, size=(lr_dim, hr_dim))
    gb = np.sqrt(6.0 / (2 * hr_dim)) * 8.0
    g1 = rng.uniform(-gb, gb, size=(hr_dim, hr_dim))
    g2 = rng.uniform(-gb, gb, size=(hr_dim, hr_dim))

    lr_out = np.empty((n_subjects, lr_dim, lr_dim), dtype=np.float32)
    hr_raw = np.empty((n_subjects, hr_dim, hr_dim), dtype=np.float64)
    for i in range(n_subjects):
        lr = _draw_lr_subject(rng, p_lr, lr_dim, n_comm, lr_noise)
        lr_out[i] = lr.astype(np.float32)
        _, u_s = np.linalg.eigh(_normalize_adj_np(lr.astype(np.float64)))
        hr_raw[i] = _teacher_forward(u_s, w_star, c_star, g1, g2)

    # one global positive scale into [0, 1] (realizable via G2)
    scale = 0.95 / max(np.quantile(hr_raw, 0.995), 1e-9)
    hr_out = np.empty((n_subjects, hr_dim, hr_dim), dtype=np.float32)
    for i in range(n_subjects):
        e_hr = rng.normal(0.0, hr_noise, size=(hr_dim, hr_dim))
        hr = np.clip(hr_raw[i] * scale + (e_hr + e_hr.T) / 2, 0.0, 1.0)
        np.fill_diagonal(hr, 0.0)
        hr_out[i] = hr.astype(np.float32)
    if n_test:
        lr_test = np.stack([
            _draw_lr_subject(rng, p_lr, lr_dim, n_comm, lr_noise)
            for _ in range(n_test)]).astype(np.float32)
        return lr_out, hr_out, lr_test
    return lr_out, hr_out
