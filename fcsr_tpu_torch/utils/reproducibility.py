"""Reproducibility helper. The port's models and datasets take explicit
seeds; what ``set_seed`` covers is the global host randomness around them
(python ``random``, numpy's legacy global state, torch's default
generator)."""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["set_seed", "seed_everything"]


def set_seed(random_seed: int = 42) -> torch.Generator:
    """Seed python / numpy / torch global RNGs; returns a CPU generator
    seeded the same way (the counterpart of the JAX package's root key)."""
    random.seed(random_seed)
    np.random.seed(random_seed)
    torch.manual_seed(random_seed)
    return torch.Generator(device="cpu").manual_seed(random_seed)


# alias with the more common modern name (as the JAX package has it)
seed_everything = set_seed
