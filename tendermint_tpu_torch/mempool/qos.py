"""Mempool admission control: per-peer token buckets, deterministic
fairness under contention, and repeat-offender muting.

The reference mempool admits any peer's txs as fast as the wire delivers
them; one spamming peer can starve honest traffic long before consensus
notices.  Later Tendermint/CometBFT releases grew per-peer flow control
around the priority mempool — this module is that layer for the gossip
reactor (and anything else with a per-source identity):

* **per-peer token buckets** — txs/s and bytes/s, refilled continuously
  from an injectable ``now_ns`` clock (any callable returning ns, so
  refill math is unit-testable to the token);
* **deterministic fairness** — an optional aggregate bucket caps total
  admission; when it contends, peers at or below their fair share of the
  recent grant window may overdraft a bounded reserve while over-share
  peers are shed first.  Every decision is a pure function of the call
  sequence and the injected clock — no randomness;
* **repeat-offender muting** — sustained violations demote the peer:
  drops escalate into a temporary mute whose duration doubles per offense
  (capped), and a clean quiet period forgives the offense count.

Decisions are never silent: each one lands in the
``tendermint_mempool_qos_*`` counters (when metrics are wired) and in the
per-peer ledger that ``MempoolReactor.qos_snapshot`` serves (the unsafe
``dump_mempool_qos`` RPC route serves it, the port's as the reference's).

The port's copy of the reference package's ``mempool/qos.py``: the same
decisions, reasons and snapshots for the same call sequence and clock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

# admission decision reasons (the `reason` label on
# tendermint_mempool_qos_dropped_total)
ADMIT = "ok"
DROP_TX_RATE = "tx_rate"
DROP_BYTE_RATE = "byte_rate"
DROP_MUTED = "muted"
DROP_FAIR = "fair"


class TokenBucket:
    """Continuous-refill token bucket over an injectable ns clock.

    ``rate <= 0`` disables the bucket (every consume succeeds).  Refill is
    exact float math on the clock delta, so with a frozen/stepped clock the
    token level is fully deterministic.
    """

    def __init__(self, rate: float, burst: float,
                 now_ns: Callable[[], int] = time.monotonic_ns):
        self.rate = float(rate)
        self.burst = float(burst)
        self._now_ns = now_ns
        self._tokens = self.burst
        self._last_ns = now_ns()

    def _refill(self, t_ns: int) -> None:
        dt_ns = t_ns - self._last_ns
        if dt_ns > 0:
            self._tokens = min(
                self.burst, self._tokens + (dt_ns / 1e9) * self.rate
            )
            self._last_ns = t_ns

    def try_consume(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        self._refill(self._now_ns())
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def consume_with_overdraft(self, n: float = 1.0,
                               floor: float = 0.0) -> bool:
        """Consume even past empty, down to ``-floor`` — the bounded
        reserve an under-share peer may draw on when the bucket contends."""
        if self.rate <= 0:
            return True
        self._refill(self._now_ns())
        if self._tokens - n >= -floor:
            self._tokens -= n
            return True
        return False

    def level(self) -> float:
        if self.rate <= 0:
            return self.burst
        self._refill(self._now_ns())
        return self._tokens


class PeerState:
    """Per-peer admission ledger (buckets + offender bookkeeping)."""

    def __init__(self, tx_bucket: TokenBucket, byte_bucket: TokenBucket):
        self.tx_bucket = tx_bucket
        self.byte_bucket = byte_bucket
        self.admitted = 0        # lifetime admitted txs
        self.dropped = 0         # lifetime dropped txs
        self.window_admitted = 0.0  # decayed fair-share counter
        self.violations = 0      # consecutive-ish drops since last clean run
        self.offenses = 0        # mutes served (exponential penalty index)
        self.muted_until_ns = 0
        self.last_drop_reason = ""

    def snapshot(self) -> dict:
        return {
            "admitted": self.admitted,
            "dropped": self.dropped,
            "window_admitted": round(self.window_admitted, 2),
            "violations": self.violations,
            "offenses": self.offenses,
            "muted": self.muted_until_ns > 0,
            "muted_until_ns": self.muted_until_ns,
            "last_drop_reason": self.last_drop_reason,
            "tx_tokens": round(self.tx_bucket.level(), 3),
            "byte_tokens": round(self.byte_bucket.level(), 1),
        }


class MempoolQoS:
    """Admission controller for per-source mempool traffic.

    One instance per reactor; ``admit(peer_id, n_bytes)`` is the single
    decision point.  All state is guarded by one lock — admission is a few
    float ops, far off the hot path's critical constant.
    """

    def __init__(self, config, metrics=None,
                 now_ns: Callable[[], int] = time.monotonic_ns):
        """``config`` is a ``MempoolConfig`` (only the ``qos_*`` fields are
        read); ``metrics`` is a ``NodeMetrics`` (or None)."""
        self._cfg = config
        self.metrics = metrics
        self._now_ns = now_ns
        self._mtx = threading.Lock()
        self._peers: Dict[str, PeerState] = {}
        self._global: Optional[TokenBucket] = None
        if getattr(config, "qos_global_tx_rate", 0) > 0:
            burst = getattr(config, "qos_global_tx_burst", 0) or (
                2.0 * config.qos_global_tx_rate
            )
            self._global = TokenBucket(
                config.qos_global_tx_rate, burst, now_ns
            )
        # fair-share window: decays lazily every window_ns of injected time
        self._window_ns = int(
            getattr(config, "qos_fair_window_s", 1.0) * 1e9
        )
        self._window_start_ns = now_ns()
        self._window_grants = 0.0
        self._mutes_total = 0

    # -- internals -----------------------------------------------------------

    def _peer(self, peer_id: str) -> PeerState:
        st = self._peers.get(peer_id)
        if st is None:
            c = self._cfg
            st = PeerState(
                TokenBucket(
                    getattr(c, "qos_peer_tx_rate", 0),
                    getattr(c, "qos_peer_tx_burst", 0)
                    or 2.0 * getattr(c, "qos_peer_tx_rate", 0),
                    self._now_ns,
                ),
                TokenBucket(
                    getattr(c, "qos_peer_byte_rate", 0),
                    getattr(c, "qos_peer_byte_burst", 0)
                    or 2.0 * getattr(c, "qos_peer_byte_rate", 0),
                    self._now_ns,
                ),
            )
            self._peers[peer_id] = st
        return st

    def _decay_window(self, t_ns: int) -> None:
        """Halve the fair-share counters once per elapsed window — cheap,
        lazy, and a pure function of the injected clock."""
        while t_ns - self._window_start_ns >= self._window_ns:
            self._window_start_ns += self._window_ns
            self._window_grants /= 2.0
            for st in self._peers.values():
                st.window_admitted /= 2.0

    def _fair_share(self) -> float:
        """A peer's tolerated slice of the recent grant window."""
        n = max(1, len(self._peers))
        slack = getattr(self._cfg, "qos_fair_slack", 1.5)
        # +1 keeps the very first grants of a window from tripping fairness
        return slack * (self._window_grants / n) + 1.0

    def _violate(self, st: PeerState, reason: str, t_ns: int) -> Tuple[bool, str]:
        st.dropped += 1
        st.violations += 1
        st.last_drop_reason = reason
        mute_after = getattr(self._cfg, "qos_mute_after", 0)
        if mute_after > 0 and st.violations >= mute_after:
            base = getattr(self._cfg, "qos_mute_base_s", 1.0)
            cap = getattr(self._cfg, "qos_mute_max_s", 60.0)
            dur_s = min(cap, base * (2.0 ** st.offenses))
            st.offenses += 1
            st.violations = 0
            st.muted_until_ns = t_ns + int(dur_s * 1e9)
            self._mutes_total += 1
            if self.metrics is not None:
                self.metrics.mempool_qos_mutes_total.add(1)
                self.metrics.mempool_qos_muted_peers.set(
                    sum(1 for p in self._peers.values()
                        if p.muted_until_ns > t_ns)
                )
        if self.metrics is not None:
            self.metrics.mempool_qos_dropped_total.add(1.0, (reason,))
        return False, reason

    # -- the decision point --------------------------------------------------

    def admit(self, peer_id: str, n_bytes: int) -> Tuple[bool, str]:
        """Admission decision for one tx from ``peer_id``.

        Returns ``(admitted, reason)``; reason is ``"ok"`` on admission or
        one of {tx_rate, byte_rate, muted, fair} on a drop.
        """
        t_ns = self._now_ns()
        with self._mtx:
            st = self._peer(peer_id)
            self._decay_window(t_ns)
            if st.muted_until_ns:
                if st.muted_until_ns > t_ns:
                    st.dropped += 1
                    st.last_drop_reason = DROP_MUTED
                    if self.metrics is not None:
                        self.metrics.mempool_qos_dropped_total.add(
                            1.0, (DROP_MUTED,)
                        )
                    return False, DROP_MUTED
                # mute expired; a long-enough clean stretch forgives the
                # exponential-penalty index entirely
                forgive_ns = int(
                    getattr(self._cfg, "qos_forgive_s", 30.0) * 1e9
                )
                if t_ns - st.muted_until_ns > forgive_ns:
                    st.offenses = 0
                st.muted_until_ns = 0
                if self.metrics is not None:
                    self.metrics.mempool_qos_muted_peers.set(
                        sum(1 for p in self._peers.values()
                            if p.muted_until_ns > t_ns)
                    )
            if not st.tx_bucket.try_consume(1.0):
                return self._violate(st, DROP_TX_RATE, t_ns)
            if not st.byte_bucket.try_consume(float(n_bytes)):
                return self._violate(st, DROP_BYTE_RATE, t_ns)
            if self._global is not None and not self._global.try_consume(1.0):
                # aggregate budget contends: shed over-share peers first;
                # an under-share peer may overdraft a bounded reserve so a
                # spammer cannot starve honest, slower sources
                reserve = getattr(self._cfg, "qos_fair_reserve", 0) or (
                    self._global.burst
                )
                if (st.window_admitted > self._fair_share()
                        or not self._global.consume_with_overdraft(
                            1.0, floor=reserve)):
                    return self._violate(st, DROP_FAIR, t_ns)
            st.admitted += 1
            st.window_admitted += 1.0
            self._window_grants += 1.0
            st.violations = max(0, st.violations - 1)
            if self.metrics is not None:
                self.metrics.mempool_qos_admitted_total.add(1)
            return True, ADMIT

    # -- lifecycle / introspection -------------------------------------------

    def forget_peer(self, peer_id: str) -> None:
        """Drop a disconnected peer's ledger (cardinality hygiene — a
        reconnecting offender starts from a fresh, full bucket, exactly as
        a restarted reference node would see it)."""
        with self._mtx:
            self._peers.pop(peer_id, None)

    def peer_state(self, peer_id: str) -> Optional[dict]:
        with self._mtx:
            st = self._peers.get(peer_id)
            return st.snapshot() if st is not None else None

    def snapshot(self) -> dict:
        """The dump_mempool_qos view: per-peer ledgers + controller totals."""
        t_ns = self._now_ns()
        with self._mtx:
            return {
                "enabled": True,
                "peers": {pid: st.snapshot() for pid, st in self._peers.items()},
                "muted_peers": sum(
                    1 for st in self._peers.values()
                    if st.muted_until_ns > t_ns
                ),
                "mutes_total": self._mutes_total,
                "window_grants": round(self._window_grants, 2),
                "global_tokens": (
                    round(self._global.level(), 3)
                    if self._global is not None else None
                ),
            }
