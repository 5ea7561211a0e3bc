"""The benchmark's inputs, made from ``--seed``: a frozen copy of the
port's teacher generator and of its k-fold plan, so that no later change
to the program moves the yardstick.

``teacher_connectomes`` is ``fcsr_tpu_torch/data/synthetic.py::
synthesize_teacher_connectomes`` as it stood when the benchmark was made
(bit for bit, checked by ``tests/test_h100bench_units.py``): an LR
connectome per subject on a shared parcellation, its HR label the output
of a hidden teacher drawn from GSR-Net's own family, so that training
cuts the validation MAE well below the untrained model's. ``kfold`` is
sklearn's ``KFold(shuffle=True)`` plan, as ``fcsr_tpu_torch/data/
datamodule.py::kfold_indices`` computes it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["teacher_connectomes", "kfold", "sub_seed"]


def sub_seed(seed: int, stream: int) -> int:
    """A 31-bit seed for one use of ``seed`` (data, fold plan, weights,
    dropout), so that every library takes it and the uses draw apart;
    ``seed`` may be any whole number."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 63, int(stream)])
               .generate_state(1)[0] % (2 ** 31 - 1))


def _random_membership(rng, n_nodes, n_comm):
    m = rng.gamma(shape=0.5, scale=1.0, size=(n_nodes, n_comm))
    return m / m.sum(axis=1, keepdims=True)


def _draw_lr_subject(rng, p_lr, lr_dim, n_comm, noise):
    c = rng.gamma(shape=1.5, scale=1.0, size=(n_comm, n_comm))
    c = (c + c.T) / 2
    c = c / c.max()
    lr_clean = p_lr @ c @ p_lr.T
    lr_clean = lr_clean / max(lr_clean.max(), 1e-9)
    e_lr = rng.normal(0.0, noise, size=(lr_dim, lr_dim))
    lr = np.clip(lr_clean + (e_lr + e_lr.T) / 2, 0.0, 1.0)
    np.fill_diagonal(lr, 0.0)
    return lr


def _normalize_adj_np(mx):
    rowsum = mx.sum(axis=-1)
    with np.errstate(divide="ignore"):
        r = rowsum ** -0.5
    r[np.isinf(r)] = 0.0
    return (mx * r[None, :]).T * r[None, :]


def _teacher_forward(u_s, w_star, c_star, g1, g2):
    f_d = np.abs((w_star @ u_s.T) @ c_star)
    np.fill_diagonal(f_d, 1.0)
    a = _normalize_adj_np(f_d)
    z = a @ a.T
    z = np.abs((z + z.T) / 2)
    np.fill_diagonal(z, 1.0)
    h1 = a @ (z @ g1)
    h2 = a @ (h1 @ g2)
    return np.abs((h2 + h2.T) / 2)


def teacher_connectomes(n_subjects, lr_dim=160, hr_dim=268, n_comm=12,
                        lr_noise=0.04, hr_noise=0.005, seed=42, n_test=0):
    """(lr (n, lr, lr), hr (n, hr, hr)[, lr_test (n_test, lr, lr)]),
    float32, symmetric, zero diagonal, values in [0, 1]; the test subjects
    are drawn at the end of the stream."""
    rng = np.random.default_rng(seed)
    p_lr = _random_membership(rng, lr_dim, n_comm)
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


def kfold(n, k, seed):
    """[(train, val)] index arrays of sklearn's shuffled ``KFold``: the
    validation windows ``n // k`` long (+1 for the first ``n % k``), both
    sets sorted."""
    indices = np.arange(n)
    np.random.RandomState(seed).shuffle(indices)
    sizes = np.full(k, n // k, dtype=int)
    sizes[: n % k] += 1
    folds, start = [], 0
    for size in sizes:
        stop = start + size
        train = np.concatenate([indices[:start], indices[stop:]])
        folds.append((np.sort(train), np.sort(indices[start:stop])))
        start = stop
    return folds
