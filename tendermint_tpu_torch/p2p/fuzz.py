"""FuzzedConnection — wraps a connection to inject delays and drops for
resilience testing (ref: p2p/fuzz.go:14; config.go FuzzConn* knobs).

Modes (fuzz.go FuzzModeDrop/FuzzModeDelay): after ``start_after`` seconds,
each read/write may be dropped (prob_drop_rw), the connection may be killed
outright (prob_drop_conn), or the op sleeps (prob_sleep × max_delay).
Wraps anything with write/read_exactly/close — RawConn or SecretConnection —
so it slots between the transport and the MConnection.

The port's copy of the reference package's ``p2p/fuzz.py``: a seeded rng
makes the same drop and delay decisions.
"""

from __future__ import annotations

import random
import time
from typing import Optional


class FuzzConfig:
    """config.go FuzzConnConfig defaults."""

    def __init__(
        self,
        mode: str = "drop",  # "drop" | "delay"
        max_delay: float = 3.0,
        prob_drop_rw: float = 0.2,
        prob_drop_conn: float = 0.0,
        prob_sleep: float = 0.0,
        start_after: float = 0.0,
    ):
        self.mode = mode
        self.max_delay = max_delay
        self.prob_drop_rw = prob_drop_rw
        self.prob_drop_conn = prob_drop_conn
        self.prob_sleep = prob_sleep
        self.start_after = start_after


class FuzzedConnection:
    def __init__(self, conn, config: Optional[FuzzConfig] = None, rng=None):
        self._conn = conn
        self.config = config or FuzzConfig()
        self._rng = rng or random.Random()
        self._started_at = time.monotonic()

    # -- fuzz decision (fuzz.go fuzz()) --------------------------------------
    def _fuzz(self) -> bool:
        """True = drop this op."""
        cfg = self.config
        if time.monotonic() - self._started_at < cfg.start_after:
            return False
        if cfg.mode == "drop":
            r = self._rng.random()
            if r < cfg.prob_drop_rw:
                return True
            if r < cfg.prob_drop_rw + cfg.prob_drop_conn:
                self.close()
                return True
            if r < cfg.prob_drop_rw + cfg.prob_drop_conn + cfg.prob_sleep:
                time.sleep(self._rng.random() * cfg.max_delay)
            return False
        if cfg.mode == "delay":
            time.sleep(self._rng.random() * cfg.max_delay)
        return False

    # -- conn surface ---------------------------------------------------------
    def write(self, data: bytes):
        if self._fuzz():
            return len(data)  # silently dropped (fuzz.go Write)
        return self._conn.write(data)

    def read_exactly(self, n: int) -> bytes:
        # reads can't be "dropped" without corrupting framing; fuzz as delay
        if self._fuzz():
            time.sleep(min(0.1, self.config.max_delay))
        return self._conn.read_exactly(n)

    def read(self, n: int) -> bytes:
        if self._fuzz():
            time.sleep(min(0.1, self.config.max_delay))
        return self._conn.read(n)

    def close(self) -> None:
        self._conn.close()

    def __getattr__(self, name):
        return getattr(self._conn, name)
