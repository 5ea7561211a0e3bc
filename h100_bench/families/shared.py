"""What the family adapters share: the initial weights made from the seed
on the device, the products' operation count, and the planted faults'
bookkeeping."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Adapter", "init_weights", "product_flops", "fold_rows"]


def init_weights(spec, n_folds, seed, device):
    """(F, P) float32 weights of ``n_folds`` models drawn on ``device``
    from ``seed`` in two calls (a uniform and a normal draw over the whole
    stack), each leaf scaled by its initialiser (``spec``: [(name, shape,
    "uniform" | "normal" | "zeros", scale)]); returns the stack and
    name -> (F, *shape) views of it."""
    sizes = [int(np.prod(shape)) for _, shape, _, _ in spec]
    scale = np.repeat([s if kind != "zeros" else 0.0
                       for _, _, kind, s in spec], sizes).astype(np.float32)
    normal = np.repeat([kind == "normal" for _, _, kind, _ in spec], sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = int(sum(sizes))
    uni = torch.rand((n_folds, total), generator=gen, device=device)
    nrm = torch.randn((n_folds, total), generator=gen, device=device)
    flat = torch.where(torch.from_numpy(normal).to(device), nrm,
                       uni.mul_(2.0).sub_(1.0))
    flat.mul_(torch.from_numpy(scale).to(device))
    views, off = {}, 0
    for (name, shape, _, _), size in zip(spec, sizes):
        views[name] = flat[:, off:off + size].view(n_folds, *shape)
        off += size
    return flat, views


def product_flops(products, train: bool) -> int:
    """Operations of a list of products ``(batch, m, k, n, a_grad,
    b_grad)`` (``batch`` products of (m, k) by (k, n)): 2 m k n each
    forward, and with ``train`` 2 m k n more for each operand that needs a
    gradient (its adjoint product)."""
    total = 0
    for batch, m, k, n, a_grad, b_grad in products:
        one = 2 * m * k * n
        total += batch * one * (1 + (int(a_grad) + int(b_grad) if train
                                     else 0))
    return total


def fold_rows(n_folds, which):
    """The folds a planted fault acts on: "half" the last half (at least
    one)."""
    if which == "half":
        return list(range(n_folds // 2, n_folds)) or [n_folds - 1]
    return list(range(n_folds))


class Adapter:
    """What a family's ``Cell`` shares: the calls into the program's entry
    (``_entry(cfg)``, ``pcfg``, ``mix``, ``device`` are the family's), and
    the settings a control or a planted fault changes in the program,
    each put back by ``close``."""

    def initial(self):
        """The (F, P) initial weights handed to the program: on the CPU a
        copy, since the program stages them with ``torch.from_numpy`` and
        trains them in place there."""
        if torch.device(self.device).type == "cuda":
            return self.flat0
        return self.flat0.copy()

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        """One CV run of the mix's ``warm_epochs`` through the timed
        entry: builds the kernels, fills the host caches (``eigh``, SVD
        features), captures the cell's graphs once and runs the fold
        evaluation and the test predictions at the cell's shapes."""
        self._entry(dataclasses.replace(
            self.pcfg, epochs=int(self.mix["warm_epochs"])))
        self._sync()

    def run_once(self):
        """One whole CV run as a user's command makes it, ended on the
        device."""
        res = self._entry(self.pcfg)
        self._sync()
        return res

    _undo = ()
    _masks = None

    def _fold_mask(self, like, rows):
        """An (F, 1) boolean mask of ``rows``, made at the first call (an
        eager one, before any capture) and kept."""
        if self._masks is None:
            self._masks = {}
        key = (like.device, like.shape[0], tuple(rows))
        if key not in self._masks:
            mask = torch.zeros(like.shape[0], 1, dtype=torch.bool)
            mask[list(rows)] = True
            self._masks[key] = mask.to(like.device)
        return self._masks[key]

    def _set(self, obj, name, value):
        if not self._undo:
            self._undo = []
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def close(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)
