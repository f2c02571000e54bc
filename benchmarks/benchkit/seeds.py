"""Seeds of the run's parts, drawn from ``--seed``."""

import numpy as np


def sub_seed(seed: int, part: int) -> int:
    """A 32-bit seed for part ``part`` of a run seeded ``seed`` (any whole number)."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, part]).generate_state(1)[0])
