"""Stochastic depth (port of ``convnet_approximater_tpu/layers/drop.py``).

A training forward draws its masks from the module's ``generator`` (a
``torch.Generator`` on the input's device, which the trainer owns and seeds
from the run's seed), or from torch's global generator when it has none.
:func:`drop_generator` sets it on every ``DropPath`` and ``Dropout`` of a
model for the length of a block.  Eval forwards draw nothing.  Inside
``nn.sharded_batch`` (training across processes) a rank draws the global
batch's masks and takes its rows (``nn.bernoulli_rows``), as one process
would draw them for the whole batch.  In a pipelined stage in training each
block draws each microbatch's masks from a generator of their own
(:func:`block_draws`), seeded from the step's seed, the block and the
microbatch: one process and any split over pipe and data ranks draw the same
masks.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional

import numpy as np
import torch
from torch import nn

from convnet_approximater_tpu_torch.nn import Dropout, bernoulli_rows


def drop_path(x, drop_prob: float, training: bool, scale_by_keep: bool = True,
              generator: Optional[torch.Generator] = None):
    """Drop whole residual paths per sample while training."""
    if not training or drop_prob == 0.0:
        return x
    keep_prob = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = bernoulli_rows(x.new_empty(shape), keep_prob, generator)
    if scale_by_keep and keep_prob > 0.0:
        mask = mask / keep_prob
    return x * mask


class DropPath(nn.Module):
    def __init__(self, drop_prob: float = 0.0, scale_by_keep: bool = True):
        super().__init__()
        self.drop_prob = drop_prob
        self.scale_by_keep = scale_by_keep
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        return drop_path(x, self.drop_prob, self.training, self.scale_by_keep, self.generator)


@contextmanager
def drop_generator(model: nn.Module, generator: torch.Generator) -> Iterator[None]:
    """Draw every ``DropPath`` and ``Dropout`` mask of ``model`` from ``generator``
    inside the block; the modules get their previous generators back after it."""
    layers = [m for m in model.modules() if isinstance(m, (DropPath, Dropout))]
    previous = [m.generator for m in layers]
    for m in layers:
        m.generator = generator
    try:
        yield
    finally:
        for m, g in zip(layers, previous):
            m.generator = g


def draw_layers(module: nn.Module) -> list:
    """The ``DropPath`` and ``Dropout`` layers of ``module`` that draw a mask now."""
    return [m for m in module.modules() if isinstance(m, (DropPath, Dropout)) and m.training
            and getattr(m, "drop_prob", getattr(m, "p", 0.0)) > 0.0]


def draws_seed(module: nn.Module) -> Optional[int]:
    """The seed of the generator ``module``'s drop layers draw from now (the
    step's, :func:`drop_generator`), or one drawn from torch's global
    generator when they have none; None when no layer draws."""
    layers = draw_layers(module)
    if not layers:
        return None
    generator = layers[0].generator
    if generator is None:
        return int(torch.randint(0, 2 ** 62, ()))
    return int(generator.initial_seed())


@contextmanager
def block_draws(block: nn.Module, seed: Optional[int], key: tuple,
                device: torch.device) -> Iterator[None]:
    """Inside the block, ``block``'s drop layers draw from a generator on
    ``device`` seeded from ``seed`` and ``key`` (the stage, the block and the
    global microbatch).  Nothing changes when ``seed`` is None."""
    if seed is None:
        yield
        return
    generator = torch.Generator(device=device)
    generator.manual_seed(int(np.random.SeedSequence([seed, *key]).generate_state(1, np.uint64)[0]))
    with drop_generator(block, generator):
        yield
