"""Paths and fixtures of the benchmark's tests: the checkout's root holds the
program, the benchmark's folder the harness.  Tests that need a CUDA card take
the ``cuda_device`` fixture, which decides in the test whether one is there."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent), str(BENCH)]


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
