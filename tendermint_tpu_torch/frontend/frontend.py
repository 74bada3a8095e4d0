"""Multi-client light-client serving frontend (the port's copy of the
reference package's ``frontend/frontend.py``).

One ``LiteFrontend`` anchors any number of thin clients to a chain. A
request for a certified commit at any height shares three things with
every other request in flight:

  * one trust store: a bisection hop verified for one client is trusted
    for all (``DBProvider`` over the frontend's trust DB);
  * one verified-header LRU (``HeaderCache``) with single-flight dedup, so
    concurrent misses on the same height do the work once;
  * one ``LaneFeed`` aggregator (``profile_kind="frontend.verify_batch"``),
    so the signature batches of concurrent verifications ride shared
    lane-packed dispatches. On its defaults the feed takes the verifier
    route: ``verify_generic`` and the installed default verifier, which on
    the card is the configuration root's ``GuardedBatchVerifier`` (K1 +
    K2); a failed, hung or audit-failed dispatch there raises
    ``DeviceDispatchError`` to every client waiting on that height.

Verdict parity with the per-client serial path is by construction:
certification runs the same ``DynamicVerifier`` hop and bisection code;
only the ``verify_generic`` signature primitive is swapped for the
aggregator, and each height's trust extension is single-flighted so N
clients pay for it once.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from tendermint_tpu_torch.frontend.aggregator import BatchingVerifier
from tendermint_tpu_torch.frontend.cache import HeaderCache, SingleFlight
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.metrics import get_frontend_metrics
from tendermint_tpu_torch.lite.provider import DBProvider, Provider, ProviderError
from tendermint_tpu_torch.lite.types import FullCommit
from tendermint_tpu_torch.lite.verifier import DynamicVerifier
from tendermint_tpu_torch.parallel.planner import LaneFeed


class _SharedDynamicVerifier(DynamicVerifier):
    """DynamicVerifier whose per-height trust extension is single-flighted:
    when N clients need trust at the same height (the top of a shared
    bisection, or a common midpoint), one leader runs the hop and every
    waiter adopts the saved trust. The hop logic is inherited unchanged, so
    error types and verdicts cannot drift from the serial path."""

    def __init__(self, chain_id, trusted, source, batch_verifier, flight, metrics):
        super().__init__(chain_id, trusted, source, batch_verifier=batch_verifier)
        self._flight = flight
        self._metrics = metrics

    def _update_to_height(self, h: int) -> None:
        def work():
            DynamicVerifier._update_to_height(self, h)
            self._metrics.heights_verified.add(1.0)

        self._flight.do(("trust", h), work)


class LiteFrontend:
    """Batched, deduplicated certification service over one chain."""

    def __init__(
        self,
        chain_id: str,
        source: Provider,
        trust_db=None,
        *,
        mesh=None,
        use_device: Optional[bool] = None,
        batch_window_s: float = 0.002,
        batch_max_rows: int = 64,
        cache_size: int = 4096,
        inner_verifier=None,
        metrics=None,
    ):
        self.chain_id = chain_id
        self.source = source
        self.trusted = DBProvider(trust_db if trust_db is not None else MemDB())
        self.metrics = metrics or get_frontend_metrics()
        self.feed = LaneFeed(
            mesh=mesh,
            verifier=inner_verifier,
            use_device=use_device,
            window_s=batch_window_s,
            max_rows=batch_max_rows,
            profile_kind="frontend.verify_batch",
            on_flush=self._on_flush,
        )
        self.batch_verifier = BatchingVerifier(self.feed)
        self.cache = HeaderCache(cache_size)
        self._flight = SingleFlight()
        self._dv = _SharedDynamicVerifier(
            chain_id, self.trusted, source, self.batch_verifier, self._flight,
            self.metrics,
        )
        self._stats_mtx = threading.Lock()
        self._occ_sum = 0.0
        self._flushes = 0

    # -- trust bootstrap ----------------------------------------------------
    def init_trust(self, fc: FullCommit) -> None:
        """Seed the shared trust store (a root verified out of band)."""
        self._dv.init_from_full_commit(fc)

    def has_trust(self) -> bool:
        try:
            self.trusted.latest_full_commit(self.chain_id, 1, 1 << 60)
            return True
        except ProviderError:
            return False

    # -- serving ------------------------------------------------------------
    def certified_commit(self, height: Optional[int] = None,
                         route: str = "verify_commit") -> FullCommit:
        """The certified FullCommit at ``height`` (default: the source's
        tip), shared across clients: a cache hit, else the single-flight
        leader's or waiter's path, else batched bisection through the
        aggregator."""
        t0 = time.perf_counter()
        try:
            if height is None:
                height = self.source.latest_full_commit(self.chain_id, 1, 1 << 60).height
            height = int(height)
            fc = self.cache.get(height)
            if fc is not None:
                self.metrics.cache_events.add(1.0, ("hit",))
            else:
                self.metrics.cache_events.add(1.0, ("miss",))
                fc = self._flight.do(
                    ("commit", height),
                    lambda: self._certify(height),
                    on_wait=lambda: self.metrics.cache_events.add(1.0, ("wait",)),
                )
            self.metrics.requests.add(1.0, (route, "ok"))
            return fc
        except Exception:
            self.metrics.requests.add(1.0, (route, "error"))
            raise
        finally:
            self.metrics.verify_seconds.observe(time.perf_counter() - t0)

    def light_block(self, height: Optional[int] = None) -> bytes:
        """The certified FullCommit's codec bytes (what thin clients and
        state-syncing peers feed to ``FullCommit.unmarshal``)."""
        return self.certified_commit(height, route="light_block").marshal()

    def _certify(self, height: int) -> FullCommit:
        fc = self.source.full_commit_at(self.chain_id, height)
        with trace.span("frontend.certify", height=height):
            self._dv.verify(fc.signed_header)
        self.cache.put(height, fc, fc.validators.hash())
        self.metrics.cache_size.set(float(len(self.cache)))
        return fc

    # -- observability ------------------------------------------------------
    def _on_flush(self, verdict, n_rows: int, seconds: float) -> None:
        self.metrics.batch_rows.observe(float(n_rows))
        self.metrics.batch_occupancy.observe(verdict.occupancy)
        with self._stats_mtx:
            self._occ_sum += verdict.occupancy
            self._flushes += 1

    def stats(self) -> dict:
        with self._stats_mtx:
            occ = self._occ_sum / self._flushes if self._flushes else 1.0
        feed = self.feed
        return {
            "cache_entries": len(self.cache),
            "cache_capacity": self.cache.capacity,
            "dispatches": feed.dispatches,
            # windows folded into those dispatches: windows_out > dispatches
            # means racing flushes rode one superdispatch
            "windows_out": feed.windows_out,
            "rows_in": feed.rows_in,
            "lanes_in": feed.lanes_in,
            "avg_batch_rows": feed.rows_in / feed.dispatches if feed.dispatches else 0.0,
            "avg_occupancy": occ,
        }

    def close(self) -> None:
        self.feed.close()
