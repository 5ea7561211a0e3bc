"""GraphSAGE / linear-interpolation upsampling baseline in PyTorch.
Counterpart of ``fcsr_tpu/models/upsample.py`` (ref: models/upsample.py).

Batched end to end: constant-ones node features, hand-rolled GCN layers
(``A @ H @ Omega + beta``), 1-D linear interpolation from n to
``out_size`` nodes along the node axis as a product with a dense two-tap
matrix (``torch.nn.functional.interpolate(mode="linear",
align_corners=False)`` semantics, in the JAX package's summation order),
inner-product decode with sigmoid, hard threshold. The products are
``torch.matmul`` / ``einsum``, as the JAX package's are ``jnp.matmul``
outside any Pallas kernel.

``state_dict`` names follow the module tree: ``gcn.{i}.omega`` (in, out)
and ``gcn.{i}.beta`` (out,), the flax tree's ``gcn_{i}/omega`` and
``gcn_{i}/beta`` (``iox/weights.py::upsample_flax_to_state``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["GCNLayer", "GraphSAGEUpsampler", "linear_interp_matrix"]


@functools.lru_cache(maxsize=None)
def _interp_weights(n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) two-tap weights of 1-D linear interpolation:
    output i samples input coordinate (i + 0.5) * n_in / n_out - 0.5 with
    edge clamping."""
    scale = n_in / n_out
    w = np.zeros((n_in, n_out), dtype=np.float32)
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        lo = min(max(x0, 0), n_in - 1)
        hi = min(max(x0 + 1, 0), n_in - 1)
        w[lo, i] += 1.0 - frac
        w[hi, i] += frac
    return w


def linear_interp_matrix(n_in: int, n_out: int,
                         device=DEFAULT_DEVICE) -> torch.Tensor:
    """The interpolation matrix (n_in, n_out), float32, a fresh tensor on
    ``device``."""
    return torch.tensor(_interp_weights(n_in, n_out),
                        device=resolve_device(device))


class GCNLayer(nn.Module):
    """``A @ H @ omega + beta``, ReLU unless ``use_nonlinearity`` is off;
    omega ~ normal(0, sqrt(2 / (in + out))) from ``generator``, beta zero
    (ref: models/upsample.py:12-29)."""

    def __init__(self, input_dim: int, output_dim: int,
                 use_nonlinearity: bool = True, generator=None):
        super().__init__()
        self.use_nonlinearity = use_nonlinearity
        std = float(np.sqrt(2.0 / (input_dim + output_dim)))
        self.omega = nn.Parameter(torch.empty(input_dim, output_dim))
        self.beta = nn.Parameter(torch.zeros(output_dim))
        with torch.no_grad():
            self.omega.normal_(0.0, std, generator=generator)

    def forward(self, a_norm, h):
        out = torch.matmul(torch.matmul(a_norm, h), self.omega) + self.beta
        return torch.relu(out) if self.use_nonlinearity else out


class GraphSAGEUpsampler(nn.Module):
    """(B, n, n) adjacencies -> (B, out_size, out_size) thresholded sigmoid
    inner products (ref: models/upsample.py:33-83, 'GraphSAGE').

    ``device`` defaults to CUDA and raises without a card unless the
    caller passes ``device="cpu"``; ``seed`` seeds the explicit CPU
    generator of the initialisation (the same weights on every device)."""

    def __init__(self, hidden_channels: int, out_size: int,
                 n_layers: int = 2, threshold: float = 0.2,
                 device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        self.hidden_channels, self.out_size = hidden_channels, out_size
        self.threshold = threshold
        self.gcn = nn.ModuleList(
            GCNLayer(hidden_channels, hidden_channels,
                     use_nonlinearity=i < n_layers - 1, generator=gen)
            for i in range(n_layers))
        self.to(dev)

    def logits(self, a_batch):
        """The decoder's inner products ``x x^T`` (B, out_size, out_size),
        before the sigmoid and the threshold."""
        b, n, _ = a_batch.shape
        x = torch.ones(b, n, self.hidden_channels, dtype=a_batch.dtype,
                       device=a_batch.device)
        for layer in self.gcn:
            x = layer(a_batch, x)
        w = linear_interp_matrix(n, self.out_size, a_batch.device)
        x = torch.einsum("bnc,nm->bmc", x, w)
        return torch.einsum("bmc,bkc->bmk", x, x)

    def forward(self, a_batch):
        a_pred = torch.sigmoid(self.logits(a_batch))
        return a_pred * (a_pred > self.threshold)
