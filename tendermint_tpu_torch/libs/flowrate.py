"""Flow-rate monitoring and limiting (ref libs/flowrate/flowrate.go), the
port's copy of the reference package's ``libs/flowrate.py``.

``Monitor`` tracks an EWMA transfer rate and offers a token-bucket
``limit()``; the state-sync reactor's chunk sender paces its sends with it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class Status:
    bytes: int = 0
    duration: float = 0.0
    avg_rate: float = 0.0
    inst_rate: float = 0.0
    cur_rate: float = 0.0


class Monitor:
    def __init__(self, sample_period: float = 0.1, window: float = 1.0):
        self._mtx = threading.Lock()
        self._start = time.monotonic()
        self._total = 0
        self._sample_period = sample_period
        self._window = window
        self._sample_start = self._start
        self._sample_bytes = 0
        self._rate = 0.0  # EWMA bytes/s

    def update(self, n: int) -> int:
        with self._mtx:
            now = time.monotonic()
            self._total += n
            self._sample_bytes += n
            elapsed = now - self._sample_start
            if elapsed >= self._sample_period:
                inst = self._sample_bytes / elapsed
                w = min(1.0, elapsed / self._window)
                self._rate = self._rate * (1 - w) + inst * w
                self._sample_start = now
                self._sample_bytes = 0
        return n

    def status(self) -> Status:
        with self._mtx:
            dur = time.monotonic() - self._start
            return Status(
                bytes=self._total,
                duration=dur,
                avg_rate=self._total / dur if dur > 0 else 0.0,
                inst_rate=self._rate,
                cur_rate=self._rate,
            )

    def limit(self, want: int, rate_limit: int) -> int:
        """How many bytes may be transferred now to stay under
        ``rate_limit`` bytes/s; may sleep briefly (ref flowrate Limit)."""
        if rate_limit <= 0:
            return want
        with self._mtx:
            dur = time.monotonic() - self._start
            allowed = int(rate_limit * dur) - self._total
        if allowed <= 0:
            time.sleep(min(0.05, (-allowed) / rate_limit))
            return max(0, min(want, allowed + int(rate_limit * 0.05)))
        return min(want, allowed)
