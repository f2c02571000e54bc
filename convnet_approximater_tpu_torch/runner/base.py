"""Runner ABC (port of ``convnet_approximater_tpu/runner/base.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod


class BaseRunner(ABC):
    @abstractmethod
    def run(self):
        ...
