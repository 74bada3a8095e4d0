"""Liveness watchdog — detects a consensus height that stopped advancing;
the port's copy of the reference package's ``libs/watchdog.py``.

Tendermint's worst production failures are liveness failures: the chain
simply stops because the proposer is slow, >1/3 of voting power went
silent, or gossip is partitioned.  Nothing crashes, so nothing pages.

The watchdog samples the consensus (height, round) at a fixed interval and
keeps an EWMA of recent block intervals.  When no (height, round) progress
has happened for `stall_factor` × that EWMA (floored at
`min_stall_seconds`), it:

  * increments `tendermint_consensus_stalls_total` (once per stall onset),
  * publishes the live stall age in `tendermint_consensus_stall_seconds`
    (reset to 0 on recovery),
  * logs + retains a structured stall report: current h/r/s, which
    validators are missing from the round's prevote/precommit sets and
    their cumulative voting power, and per-peer last-message ages from the
    switch — everything an operator needs to tell "slow proposer" from
    ">1/3 silent" from "partition".

The report is read from ``report()`` / ``status()``; the port has no
switch yet, so ``switch`` stays None and the report's ``peers`` is empty.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Optional

DEFAULT_INTERVAL = 1.0  # seconds between checks
DEFAULT_STALL_FACTOR = 5.0  # stall when idle > factor × block-interval EWMA
DEFAULT_MIN_STALL_SECONDS = 10.0  # ...but never sooner than this
DEFAULT_EWMA_ALPHA = 0.3
# A single block-interval sample never contributes more than this multiple
# of the current EWMA.  One pathological gap (a frozen-then-resumed clock,
# a multi-minute snapshot restore) would otherwise poison the EWMA and
# inflate the stall threshold for many blocks afterwards.
DEFAULT_MAX_SAMPLE_FACTOR = 10.0


class LivenessWatchdog:
    """Watches one ConsensusState.  `switch` (optional) contributes per-peer
    last-receive ages to the stall report; `metrics` (optional ConsensusMetrics)
    receives the stall counter/gauge."""

    def __init__(
        self,
        consensus_state,
        switch=None,
        metrics=None,
        interval: float = DEFAULT_INTERVAL,
        stall_factor: float = DEFAULT_STALL_FACTOR,
        min_stall_seconds: float = DEFAULT_MIN_STALL_SECONDS,
        ewma_alpha: float = DEFAULT_EWMA_ALPHA,
        max_sample_factor: float = DEFAULT_MAX_SAMPLE_FACTOR,
        logger: Optional[logging.Logger] = None,
        now_ns=None,
    ):
        self.cons = consensus_state
        self.switch = switch
        self.metrics = metrics
        # wall-clock source stamped into stall reports (cross-node fusable);
        # sampling/thresholds stay on time.monotonic. The sim harness injects
        # each node's skewed clock here so reports land on its timeline.
        self.now_ns = now_ns or time.time_ns
        self.interval = interval
        self.stall_factor = stall_factor
        self.min_stall_seconds = min_stall_seconds
        self.ewma_alpha = ewma_alpha
        self.max_sample_factor = max_sample_factor
        self.logger = logger or logging.getLogger("watchdog")

        self._mtx = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        now = time.monotonic()
        self._last_hr = (-1, -1)
        self._last_progress = now
        self._last_height_at = now
        self._ewma: Optional[float] = None  # block-interval EWMA, seconds
        self._stalled = False
        self._stalls_total = 0
        self._report: Optional[dict] = None

    # lifecycle --------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="liveness-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval + 2.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.check()
            except Exception:
                self.logger.exception("watchdog check failed")

    # core -------------------------------------------------------------------
    def check(self, now: Optional[float] = None) -> Optional[dict]:
        """One sample.  Returns the current stall report (None when healthy).
        Exposed for tests — production calls come from the thread."""
        now = time.monotonic() if now is None else now
        rs = self.cons.rs
        hr = (rs.height, rs.round)

        with self._mtx:
            if hr != self._last_hr:
                if hr[0] > self._last_hr[0] >= 0:
                    # several heights may land between two samples (fast
                    # blocks, slow sampling): amortize, or one long gap
                    # poisons the EWMA and inflates the stall threshold
                    dt = (now - self._last_height_at) / (hr[0] - self._last_hr[0])
                    if self._ewma is None:
                        self._ewma = dt
                    else:
                        # clamp the sample: a frozen-then-resumed clock (or
                        # any single multi-minute gap) must not swamp the
                        # average — the stall threshold would stay inflated
                        # long after blocks resumed at normal pace
                        if self.max_sample_factor > 0:
                            dt = min(dt, self.max_sample_factor * self._ewma)
                        self._ewma = (
                            self.ewma_alpha * dt
                            + (1 - self.ewma_alpha) * self._ewma
                        )
                if hr[0] != self._last_hr[0]:
                    self._last_height_at = now
                self._last_hr = hr
                self._last_progress = now
                if self._stalled:
                    self._stalled = False
                    self._report = None
                    self.logger.warning(
                        "consensus recovered at h=%d r=%d", hr[0], hr[1]
                    )
                if self.metrics is not None:
                    self.metrics.stall_seconds.set(0.0)
                return None

            idle = now - self._last_progress
            threshold = self.threshold()
            if idle <= threshold:
                return None

            onset = not self._stalled
            if onset:
                self._stalled = True
                self._stalls_total += 1
            report = self._build_report(idle, threshold)
            self._report = report
            if self.metrics is not None:
                if onset:
                    self.metrics.stalls.add(1.0)
                self.metrics.stall_seconds.set(idle)

        if onset:
            self.logger.warning("consensus stall detected: %s", json.dumps(report))
        return report

    def threshold(self) -> float:
        ewma = self._ewma
        if ewma is None:
            return self.min_stall_seconds
        return max(self.stall_factor * ewma, self.min_stall_seconds)

    # reporting --------------------------------------------------------------
    def _missing_votes(self, rs, vote_set) -> dict:
        """Validators absent from `vote_set` and their cumulative power."""
        vals = rs.validators
        total_power = vals.total_voting_power()
        missing = []
        missing_power = 0
        ba = vote_set.bit_array() if vote_set is not None else None
        for i in range(vals.size):
            if ba is not None and ba.get_index(i):
                continue
            addr, val = vals.get_by_index(i)
            power = val.voting_power if val is not None else 0
            missing_power += power
            missing.append(
                {
                    "index": i,
                    "address": (addr or b"").hex().upper(),
                    "voting_power": power,
                }
            )
        return {
            "validators": missing,
            "power": missing_power,
            "total_power": total_power,
        }

    def _peer_ages(self) -> list:
        if self.switch is None:
            return []
        out = []
        try:
            peers = self.switch.peers.list()
        except Exception:
            return []
        for p in peers:
            age = None
            try:
                st = p.status()
                age = st.get("last_recv_age")
            except Exception:
                pass
            out.append({"id": p.id, "last_recv_age_seconds": age})
        return out

    def _build_report(self, idle: float, threshold: float) -> dict:
        rs = self.cons.rs
        try:
            prevotes = rs.votes.prevotes(rs.round)
        except Exception:
            prevotes = None
        try:
            precommits = rs.votes.precommits(rs.round)
        except Exception:
            precommits = None
        return {
            "stalled": True,
            "wall_time_ns": self.now_ns(),
            "height": rs.height,
            "round": rs.round,
            "step": rs.step.name,
            "stall_seconds": round(idle, 3),
            "threshold_seconds": round(threshold, 3),
            "block_interval_ewma_seconds": (
                round(self._ewma, 3) if self._ewma is not None else None
            ),
            "missing_prevotes": self._missing_votes(rs, prevotes),
            "missing_precommits": self._missing_votes(rs, precommits),
            "peers": self._peer_ages(),
            "stalls_total": self._stalls_total,
        }

    def report(self) -> Optional[dict]:
        """The retained stall report; None while healthy."""
        with self._mtx:
            return self._report

    def status(self) -> dict:
        """Compact health summary (always available, stalled or not)."""
        with self._mtx:
            return {
                "stalled": self._stalled,
                "stall_seconds": (
                    round(time.monotonic() - self._last_progress, 3)
                    if self._stalled
                    else 0.0
                ),
                "stalls_total": self._stalls_total,
                "block_interval_ewma_seconds": (
                    round(self._ewma, 3) if self._ewma is not None else None
                ),
            }
