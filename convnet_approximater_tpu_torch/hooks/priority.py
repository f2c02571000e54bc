"""Hook priority levels, 0 (highest) .. 100 (lowest) (port of
``convnet_approximater_tpu/hooks/priority.py``)."""

from __future__ import annotations

from enum import Enum


class Priority(Enum):
    HIGHEST = 0
    VERY_HIGH = 10
    HIGH = 30
    ABOVE_NORMAL = 40
    NORMAL = 50
    BELOW_NORMAL = 60
    LOW = 70
    VERY_LOW = 90
    LOWEST = 100


def get_priority(priority) -> int:
    if isinstance(priority, int):
        if not 0 <= priority <= 100:
            raise ValueError("priority must be between 0 and 100")
        return priority
    if isinstance(priority, Priority):
        return priority.value
    if isinstance(priority, str):
        return Priority[priority.upper()].value
    raise TypeError("priority must be int, str, or Priority")
