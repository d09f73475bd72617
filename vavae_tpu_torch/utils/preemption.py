"""Preemption-safe training (port of ``vavae_tpu/utils/preemption.py``):
catch SIGTERM, finish the in-flight step, checkpoint, exit cleanly, so a
relaunch resumes there instead of at the last ``ckpt_every``.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Install as a context manager around the training loop; poll
    ``should_stop`` once per step (cheap: a bool read). ``signals`` lets a
    test stand a harmless signal in for SIGTERM."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._stop = threading.Event()
        self._prev = {}

    def _handler(self, signum, frame):
        self._stop.set()

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):  # non-main thread / unsupported
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        return False

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()
