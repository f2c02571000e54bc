"""Seeding (port of ``convnet_approximater_tpu/utils/random.py``).

The reference seeds torch, numpy and Python with ``seed + rank``.  Here Python
and numpy are seeded the same way, for host-side draws, and the device-side
randomness comes from an explicit ``torch.Generator`` that the caller passes on
(the JAX function returns a ``jax.random`` key folded with the rank instead).
"""

from __future__ import annotations

import random as _py_random

import numpy as np
import torch


def random_seed(seed: int = 42, rank: int = 0) -> torch.Generator:
    """Seed Python's and numpy's generators with ``seed + rank`` and return a
    CPU ``torch.Generator`` seeded the same way."""
    _py_random.seed(seed + rank)
    np.random.seed(seed + rank)
    return torch.Generator().manual_seed(seed + rank)
