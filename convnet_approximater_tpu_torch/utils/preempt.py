"""Cooperative preemption handling for long training runs (port of
``convnet_approximater_tpu/utils/preempt.py``).

Schedulers announce eviction with SIGTERM and grant a grace window.  The
guard turns SIGTERM into a cooperative stop: the handler only sets a flag,
the train loop checks it at step granularity, saves the full train state
(weights, optimizer moments, epoch) and returns, so a preempted run resumes
exactly (``hooks/finetune.py``).  Across processes the ranks decide the stop
together at each step (:meth:`PreemptionGuard.stop_requested`).
"""

from __future__ import annotations

import signal
import threading

from .logger import get_logger


class Preempted(Exception):
    """Raised by a train loop when a preemption notice has been received."""


class PreemptionGuard:
    """Context manager installing a SIGTERM flag-setter.

    Signal handlers run only on the main thread, so outside it (pytest-xdist
    workers, for example) the handler is not installed, and :meth:`trigger`
    still sets the flag.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous = {}
        self._event = threading.Event()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self, signum=None):
        if not self._event.is_set():
            get_logger().warning(
                f"preemption notice received (signal {signum}); "
                "will checkpoint and exit at the next step boundary")
        self._event.set()

    def check(self):
        """Raise :class:`Preempted` if a notice arrived (call once per step)."""
        if self._event.is_set():
            raise Preempted()

    def stop_requested(self, shard=None) -> bool:
        """Whether a train loop stops at this step: a notice arrived here or,
        across processes, on any rank of the data axis ``shard`` (an
        ``nn.DataShard``).  Every rank asks at every step and they decide
        together, so all of them leave at the same step and none waits alone
        in a collective."""
        from convnet_approximater_tpu_torch.parallel.data_parallel import any_rank

        return any_rank(self.triggered, shard)

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._previous[sig] = signal.signal(
                    sig, lambda signum, frame: self.trigger(signum))
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        return False
