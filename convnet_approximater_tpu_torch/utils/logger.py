"""Rank-0 gated logging (port of ``convnet_approximater_tpu/utils/logger.py``).

``get_logger`` returns the real logger on rank 0 and a no-op ``DummyLogger``
elsewhere.  The rank is ``torch.distributed``'s when a process group is
initialised, else 0.
"""

from __future__ import annotations

import logging
import sys

_LOGGER_NAME = "convnet_approximater_tpu_torch"


class DummyLogger:
    """Swallows all logging calls on non-primary processes."""

    def noop(self, *args, **kwargs):
        pass

    debug = info = warning = error = critical = exception = log = noop


_dummy = DummyLogger()


def get_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_logger():
    if get_rank() == 0:
        return logging.getLogger(_LOGGER_NAME)
    return _dummy


def build_logger(log_file=None, level=logging.INFO):
    """Attach stream (+ optional file) handlers to the framework logger."""
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(level)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
