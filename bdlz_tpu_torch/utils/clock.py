"""Injectable clocks (counterpart of ``bdlz_tpu/utils/clock.py``).

Every layer that waits — lease TTLs, autoscale intervals, host
heartbeats — takes one of these, so CPU tests never sleep.
"""
from __future__ import annotations

import time


class ManualClock:
    """Deterministic clock for in-process drivers and tests: time moves
    only when :meth:`advance` is called, so lease TTLs expire exactly at
    scripted round boundaries."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        self._now += float(seconds)
        return self._now


class WallClock:
    """Real-time clock for control loops that run beside external worker
    processes (``sweep_cli --elastic coordinator``): ``now`` is wall time
    and :meth:`advance` really waits, so the driver's lease arithmetic
    agrees with workers on ``time.time``.  Both seams are injectable."""

    def __init__(self, time_fn=time.time, sleep=time.sleep):
        self._time = time_fn
        self._sleep = sleep

    def __call__(self) -> float:
        return float(self._time())

    def advance(self, seconds: float) -> float:
        self._sleep(float(seconds))
        return float(self._time())
