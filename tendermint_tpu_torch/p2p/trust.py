"""Peer trust metric — EWMA of good/bad events with history-weighted
derivative damping (ref: p2p/trust/metric.go TrustMetric, store.go).

Score in [0, 100] (metric.go TrustValue ×100): a weighted mix of the
proportional value (good vs bad events in the current interval), the decayed
history, and a derivative penalty for downward swings. The store persists
scores keyed by peer so restarts remember who behaved.

The port's copy of the reference package's ``p2p/trust.py``: the same
scores for the same events under the same clock (``time.monotonic``).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Optional

# metric.go defaults
INTERVAL = 30.0  # seconds per measurement interval
HISTORY_MAX = 16  # intervals folded into history
PROPORTIONAL_WEIGHT = 0.4
HISTORY_WEIGHT = 0.6


class TrustMetric:
    def __init__(self):
        self._mtx = threading.Lock()
        self._good = 0.0
        self._bad = 0.0
        self._history: list = []  # most recent first
        self._interval_start = time.monotonic()

    def good_event(self, weight: float = 1.0) -> None:
        with self._mtx:
            self._roll()
            self._good += weight

    def bad_event(self, weight: float = 1.0) -> None:
        with self._mtx:
            self._roll()
            self._bad += weight

    def _roll(self) -> None:
        now = time.monotonic()
        while now - self._interval_start >= INTERVAL:
            self._history.insert(0, self._proportional())
            del self._history[HISTORY_MAX:]
            self._good = 0.0
            self._bad = 0.0
            self._interval_start += INTERVAL

    def _proportional(self) -> float:
        total = self._good + self._bad
        return self._good / total if total > 0 else 1.0

    def _history_value(self) -> float:
        """Faded average: recent intervals weigh more (metric.go fading)."""
        if not self._history:
            return 1.0
        num = den = 0.0
        for i, v in enumerate(self._history):
            w = 1.0 / (i + 1)
            num += v * w
            den += w
        return num / den

    def trust_value(self) -> float:
        with self._mtx:
            self._roll()
            p = self._proportional()
            h = self._history_value()
            v = PROPORTIONAL_WEIGHT * p + HISTORY_WEIGHT * h
            # derivative damping: dropping below history costs extra
            # (metric.go calcTrustValue's negative-derivative weighting)
            d = p - h
            if d < 0:
                v += 0.1 * d * len(self._history or [0])
            return max(0.0, min(1.0, v))

    def trust_score(self) -> int:
        """0..100 (metric.go TrustScore)."""
        return int(math.floor(self.trust_value() * 100))


class TrustMetricStore:
    """Peer-keyed metrics with JSON persistence (trust/store.go)."""

    def __init__(self, file_path: Optional[str] = None):
        self._mtx = threading.Lock()
        self._metrics: Dict[str, TrustMetric] = {}
        self._saved_scores: Dict[str, int] = {}
        self._file = file_path
        if file_path and os.path.exists(file_path):
            try:
                with open(file_path) as f:
                    self._saved_scores = {
                        k: int(v) for k, v in json.load(f).items()
                    }
            except Exception:
                self._saved_scores = {}

    def get_metric(self, peer_id: str) -> TrustMetric:
        with self._mtx:
            m = self._metrics.get(peer_id)
            if m is None:
                m = TrustMetric()
                saved = self._saved_scores.get(peer_id)
                if saved is not None:
                    # seed history from the persisted score
                    m._history = [saved / 100.0]
                self._metrics[peer_id] = m
            return m

    def peer_score(self, peer_id: str) -> int:
        return self.get_metric(peer_id).trust_score()

    def size(self) -> int:
        with self._mtx:
            return len(self._metrics)

    def save(self) -> None:
        if not self._file:
            return
        with self._mtx:
            scores = {k: m.trust_score() for k, m in self._metrics.items()}
            scores.update(
                {k: v for k, v in self._saved_scores.items() if k not in scores}
            )
        tmp = self._file + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self._file)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(scores, f)
        os.replace(tmp, self._file)
