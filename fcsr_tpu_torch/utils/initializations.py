"""Initializer helpers (ref: utils/initializations.py). Counterpart of
``fcsr_tpu/utils/initializations.py``.

``glorot_uniform_square`` mirrors the reference's
``weight_variable_glorot`` (uniform +-sqrt(6 / (2 * dim)) for a square
matrix); it is numpy, bit-equal to the JAX package's. The reference
imports it into its GSR layer but never uses it (GSRLayer initializes
with randn, ref: models/layers.py:6,18); kept for API completeness.
"""

from __future__ import annotations

import numpy as np
import torch

from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["glorot_uniform_square", "glorot_init"]


def glorot_uniform_square(output_dim: int, seed: int = 0) -> np.ndarray:
    """Numpy variant matching the reference's signature."""
    init_range = np.sqrt(6.0 / (output_dim + output_dim))
    rng = np.random.default_rng(seed)
    return rng.uniform(-init_range, init_range,
                       (output_dim, output_dim)).astype(np.float32)


def glorot_init(generator: torch.Generator, shape, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> torch.Tensor:
    """Uniform +-sqrt(6 / (fan_in + fan_out)) over the last two axes of
    ``shape``, drawn from ``generator`` on its own device and placed on
    ``device`` (the torch form of the JAX package's ``glorot_init(key,
    shape, dtype)``)."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    out = torch.empty(tuple(shape), dtype=dtype, device=generator.device)
    out.uniform_(-limit, limit, generator=generator)
    return out.to(resolve_device(device))
