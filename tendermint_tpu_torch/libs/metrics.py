"""Minimal Prometheus-style metrics: Counter/Gauge/Histogram + registry +
text exposition (plain text format v0.0.4, which is all Prometheus needs to
scrape).

The port's copy of the registry primitives of the JAX package's
``libs/metrics.py`` and of its ``VerifyMetrics``, ``FrontendMetrics``,
``VoteBatchMetrics`` and ``MempoolBatchMetrics``: the same
``tendermint_verify_*``, ``tendermint_lite_frontend_*``,
``tendermint_consensus_vote_batch_*`` and ``tendermint_mempool_batch_*``
family names, help texts, label names and buckets, so a dashboard built on
the reference reads the port unchanged. ``MempoolMetrics`` is the mempool
family of the reference's ``NodeMetrics`` that ``mempool/mempool.py``
writes, under the same attribute names; ``StateMetrics`` is its state
family (``state_block_processing_time``, which ``BlockExecutor.apply_block``
observes). The other metric sets of the reference (consensus, p2p, the
mempool's QoS, state sync) belong to subsystems the port has not taken
over.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple


def _fmt_value(v: float) -> str:
    """Full precision: %g truncates to 6 significant digits, silently
    corrupting counters past ~1e6 (real client libs emit repr-style)."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape_label_value(v: str) -> str:
    """Text-format v0.0.4 label-value escaping: backslash, double-quote and
    newline must be escaped or the series line is unparseable/corrupts the
    scrape (prometheus docs "text-based format", escaping rules)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(h: str) -> str:
    """HELP lines escape backslash and newline (a raw newline would start a
    bogus sample line mid-scrape)."""
    return h.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._mtx = threading.Lock()

    def expose(self) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help="", label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def labels(self, *values: str) -> "_BoundCounter":
        return _BoundCounter(self, tuple(str(v) for v in values))

    def add(self, v: float = 1.0, _labels: Tuple[str, ...] = ()) -> None:
        with self._mtx:
            self._values[_labels] = self._values.get(_labels, 0.0) + v

    def remove_matching(self, label_name: str, value: str) -> int:
        """Drop every series whose `label_name` equals `value` — the
        cardinality-hygiene hook for per-peer labels on disconnect."""
        if label_name not in self.label_names:
            return 0
        i = self.label_names.index(label_name)
        with self._mtx:
            doomed = [lv for lv in self._values if lv[i] == value]
            for lv in doomed:
                del self._values[lv]
        return len(doomed)

    def expose(self) -> List[str]:
        with self._mtx:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            return [f"{self.name} 0"]
        return [
            f"{self.name}{_fmt_labels(self.label_names, lv)} {_fmt_value(v)}"
            for lv, v in items
        ]


class _BoundCounter:
    def __init__(self, parent: Counter, labels: Tuple[str, ...]):
        self._p, self._l = parent, labels

    def add(self, v: float = 1.0) -> None:
        self._p.add(v, self._l)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help="", label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple[str, ...], float] = {} if label_names else {(): 0.0}

    def labels(self, *values: str) -> "_BoundGauge":
        return _BoundGauge(self, tuple(str(v) for v in values))

    def set(self, v: float, _labels: Tuple[str, ...] = ()) -> None:
        with self._mtx:
            self._values[_labels] = float(v)

    def add(self, v: float = 1.0, _labels: Tuple[str, ...] = ()) -> None:
        with self._mtx:
            self._values[_labels] = self._values.get(_labels, 0.0) + v

    def remove_matching(self, label_name: str, value: str) -> int:
        """Drop every series whose `label_name` equals `value` (see
        Counter.remove_matching)."""
        if label_name not in self.label_names:
            return 0
        i = self.label_names.index(label_name)
        with self._mtx:
            doomed = [lv for lv in self._values if lv[i] == value]
            for lv in doomed:
                del self._values[lv]
        return len(doomed)

    def expose(self) -> List[str]:
        with self._mtx:
            items = sorted(self._values.items())
        return [
            f"{self.name}{_fmt_labels(self.label_names, lv)} {_fmt_value(v)}"
            for lv, v in items
        ]


class _BoundGauge:
    def __init__(self, parent: Gauge, labels: Tuple[str, ...]):
        self._p, self._l = parent, labels

    def set(self, v: float) -> None:
        self._p.set(v, self._l)

    def add(self, v: float = 1.0) -> None:
        self._p.add(v, self._l)


_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)

# power-of-two ladder for batch sizes (1 .. 64k signatures per dispatch)
_SIZE_BUCKETS = tuple(float(1 << i) for i in range(17))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", buckets: Sequence[float] = _DEFAULT_BUCKETS,
                 label_names: Sequence[str] = ()):
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(buckets))
        # per-labelset series: labels -> [bucket counts (+Inf last), sum, n]
        self._series: Dict[Tuple[str, ...], list] = {}
        if not self.label_names:
            # an unlabeled histogram exposes its zero series immediately
            # (back-compat with the pre-labeled exposition)
            self._series[()] = [[0] * (len(self.buckets) + 1), 0.0, 0]

    def labels(self, *values: str) -> "_BoundHistogram":
        return _BoundHistogram(self, tuple(str(v) for v in values))

    def observe(self, v: float, _labels: Tuple[str, ...] = ()) -> None:
        with self._mtx:
            s = self._series.get(_labels)
            if s is None:
                s = self._series[_labels] = [
                    [0] * (len(self.buckets) + 1), 0.0, 0
                ]
            s[1] += v
            s[2] += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s[0][i] += 1
                    return
            s[0][-1] += 1

    def expose(self) -> List[str]:
        with self._mtx:
            series = [
                (lv, list(s[0]), s[1], s[2])
                for lv, s in sorted(self._series.items())
            ]
        out: List[str] = []
        bucket_names = self.label_names + ("le",)
        for lv, counts, total_sum, n in series:
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(bucket_names, lv + (f'{b:g}',))} {cum}"
                )
            out.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(bucket_names, lv + ('+Inf',))} {n}"
            )
            out.append(
                f"{self.name}_sum{_fmt_labels(self.label_names, lv)} "
                f"{_fmt_value(total_sum)}"
            )
            out.append(
                f"{self.name}_count{_fmt_labels(self.label_names, lv)} {n}"
            )
        return out


class _BoundHistogram:
    def __init__(self, parent: Histogram, labels: Tuple[str, ...]):
        self._p, self._l = parent, labels

    def observe(self, v: float) -> None:
        self._p.observe(v, self._l)


class Registry:
    def __init__(self, namespace: str = "tendermint"):
        self.namespace = namespace
        self._metrics: List[_Metric] = []
        self._attached: List["Registry"] = []
        self._mtx = threading.Lock()

    def _register(self, m: _Metric) -> _Metric:
        with self._mtx:
            self._metrics.append(m)
        return m

    def counter(self, name, help="", label_names=()) -> Counter:
        return self._register(
            Counter(f"{self.namespace}_{name}", help, label_names)
        )

    def gauge(self, name, help="", label_names=()) -> Gauge:
        return self._register(Gauge(f"{self.namespace}_{name}", help, label_names))

    def histogram(self, name, help="", buckets=_DEFAULT_BUCKETS,
                  label_names=()) -> Histogram:
        return self._register(
            Histogram(f"{self.namespace}_{name}", help, buckets, label_names)
        )

    def attach(self, other: "Registry") -> None:
        """Expose another registry's metrics through this one's scrape.
        The process-wide VerifyMetrics registry rides every node's /metrics
        this way (the batch verifier is process-global, so per-node
        registration would double count)."""
        with self._mtx:
            if other is not self and other not in self._attached:
                self._attached.append(other)

    def expose_text(self) -> str:
        lines: List[str] = []
        with self._mtx:
            metrics = list(self._metrics)
            attached = list(self._attached)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.expose())
        text = "\n".join(lines) + "\n" if lines else ""
        for reg in attached:
            text += reg.expose_text()
        return text


# -- the per-subsystem metric sets the reference defines -----------------------


class VerifyMetrics:
    """Verification-pipeline telemetry at the batch boundary.

    Recorded inside crypto/batch.py (every BatchVerifier dispatch and the
    guard's fallbacks, retries and audits) and parallel/planner.py (the
    planner's device dispatch). Labels stay low-cardinality: backend in
    {host, cuda, cpu, planner}, algo in {ed25519, secp256k1}; the device
    label of ``record_device_shards`` is the CUDA device index.
    """

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.batch_size = r.histogram(
            "verify_batch_size", "Signatures per batch-verify dispatch",
            buckets=_SIZE_BUCKETS,
        )
        self.dispatch_seconds = r.histogram(
            "verify_dispatch_seconds",
            "Batch-verify dispatch wall seconds by backend",
            label_names=("backend",),
        )
        self.compile_seconds = r.histogram(
            "verify_compile_seconds",
            "First-dispatch (compile/warm-up) wall seconds by backend",
            buckets=(0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0),
            label_names=("backend",),
        )
        self.calls = r.counter(
            "verify_calls_total", "Batch-verify dispatches",
            label_names=("backend", "algo"),
        )
        self.sigs = r.counter(
            "verify_sigs_total", "Signatures verified in batch dispatches",
            label_names=("backend", "algo"),
        )
        self.rejects = r.counter(
            "verify_rejects_total", "Signatures that failed verification",
            label_names=("backend", "algo"),
        )
        self.host_fallback = r.counter(
            "verify_host_fallback_total",
            "Items diverted from the device batch to the host path",
            label_names=("reason",),
        )
        self.speculative = r.counter(
            "verify_speculative_total",
            "Speculative (double-buffered) fast-sync window verifies by outcome",
            label_names=("outcome",),
        )
        self.window_heights = r.histogram(
            "verify_window_heights", "Heights per fast-sync verify window",
            buckets=tuple(float(1 << i) for i in range(11)),
        )
        # verification planner (parallel/planner.py): ragged lane packing
        self.lane_occupancy = r.histogram(
            "verify_lane_occupancy",
            "Present lanes / dispatched lanes per planner dispatch",
            buckets=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
        )
        self.lanes = r.counter(
            "verify_lanes_total",
            "Planner device lanes dispatched by kind (present|padded)",
            label_names=("kind",),
        )
        self.planner_bucket = r.counter(
            "verify_planner_bucket_total",
            "Planner (lane, segment) bucket lookups by event (hit|compile)",
            label_names=("event",),
        )
        # device dispatch guard (libs/breaker.py): breaker state + the
        # fallback/retry/audit outcomes of every guarded device dispatch
        self.device_breaker_state = r.gauge(
            "verify_device_breaker_state",
            "Device verify circuit-breaker state "
            "(0=closed 1=open 2=half_open 3=quarantined)",
        )
        self.device_fallback = r.counter(
            "verify_device_fallback_total",
            "Device dispatches completed on the host path instead, by reason",
            label_names=("reason",),
        )
        self.device_retries = r.counter(
            "verify_device_retries_total",
            "Device dispatches retried after a transient failure",
        )
        self.device_audit = r.counter(
            "verify_device_audit_total",
            "Silent-corruption audit lane cross-checks by outcome "
            "(ok|mismatch)",
            label_names=("outcome",),
        )
        # the [verify] fe_backend (vpu | mxu | mxu16), carry schedule
        # (eager | lazy) and verify strategy (ladder) recorded for each
        # device window; the port has one limb multiplier, so these are the
        # configured labels. Host dispatches carry no fe backend and are
        # not recorded here
        self.fe_dispatch = r.counter(
            "verify_fe_backend_total",
            "Batch-verify device dispatches by limb-multiplier backend, "
            "carry schedule and ed25519 verify path",
            label_names=("backend", "fe_backend", "carry_mode",
                         "ed25519_path"),
        )
        # per-device attribution of planner dispatches: which devices the
        # lane tile ran on and how many lanes each carried. Label
        # cardinality is capped: at most MAX_DEVICE_LABELS distinct device
        # ids ever get their own value, the rest fold into "overflow"
        self.device_lanes = r.counter(
            "verify_device_lanes_total",
            "Lanes dispatched per mesh device (lane-tile shard size)",
            label_names=("device",),
        )
        self.device_dispatches = r.counter(
            "verify_device_dispatch_total",
            "Device dispatches that included each mesh device",
            label_names=("device",),
        )
        self._device_label_ids: set = set()
        self._device_label_mtx = threading.Lock()

    MAX_DEVICE_LABELS = 16

    def _device_label(self, device_id: str) -> str:
        with self._device_label_mtx:
            if device_id in self._device_label_ids:
                return device_id
            if len(self._device_label_ids) < self.MAX_DEVICE_LABELS:
                self._device_label_ids.add(device_id)
                return device_id
        return "overflow"

    def record_device_shards(self, device_ids, lanes_per_device: int) -> None:
        """One mesh (or single-device) dispatch: every participating device
        gets a dispatch tick and its lane-tile shard size attributed."""
        for d in device_ids:
            lbl = self._device_label(str(d))
            self.device_dispatches.add(1.0, (lbl,))
            self.device_lanes.add(float(lanes_per_device), (lbl,))

    def record_dispatch(self, backend: str, algo: str, n: int,
                        seconds: float, rejects: int = 0,
                        first: bool = False, fe_backend: str = "",
                        carry_mode: str = "",
                        ed25519_path: str = "") -> None:
        """One batch dispatch: size + latency + outcome in one call so the
        instrumented hot paths stay one-liners."""
        self.batch_size.observe(float(n))
        self.dispatch_seconds.observe(seconds, (backend,))
        if first:
            self.compile_seconds.observe(seconds, (backend,))
        self.calls.add(1.0, (backend, algo))
        self.sigs.add(float(n), (backend, algo))
        if rejects:
            self.rejects.add(float(rejects), (backend, algo))
        if fe_backend:
            self.fe_dispatch.add(
                1.0,
                (backend, fe_backend, carry_mode, ed25519_path or "ladder"),
            )

    def record_planner(self, present: int, dispatched: int,
                       compiled: bool = False) -> None:
        """One planner device dispatch: lane occupancy (present vs padded)
        and the compile-cache outcome for its (lane, segment) bucket."""
        if dispatched > 0:
            self.lane_occupancy.observe(present / dispatched)
            self.lanes.add(float(present), ("present",))
            self.lanes.add(float(dispatched - present), ("padded",))
        self.planner_bucket.add(1.0, ("compile" if compiled else "hit",))


_verify_mtx = threading.Lock()
_verify_metrics: Optional[VerifyMetrics] = None


def get_verify_metrics() -> VerifyMetrics:
    """Process-wide VerifyMetrics singleton — mirrors the process-wide
    default BatchVerifier (crypto/batch.get_batch_verifier)."""
    global _verify_metrics
    with _verify_mtx:
        if _verify_metrics is None:
            _verify_metrics = VerifyMetrics()
        return _verify_metrics


class FrontendMetrics:
    """Light-client frontend telemetry (frontend/): request outcomes per
    route, verified-header cache effectiveness, the aggregator's batch
    shape, and end-to-end certification latency. Process-wide like
    VerifyMetrics: one frontend serves every client of the process."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.requests = r.counter(
            "lite_frontend_requests_total",
            "Frontend requests by route and outcome (ok|error)",
            label_names=("route", "outcome"),
        )
        self.cache_events = r.counter(
            "lite_frontend_cache_events_total",
            "Verified-header cache lookups by outcome (hit|miss|wait)",
            label_names=("outcome",),
        )
        self.cache_size = r.gauge(
            "lite_frontend_cache_size", "Verified headers currently cached"
        )
        self.heights_verified = r.counter(
            "lite_frontend_heights_verified_total",
            "Trust-extension operations actually performed — cache +"
            " single-flight keep this well below requests under fan-in",
        )
        self.batch_rows = r.histogram(
            "lite_frontend_batch_rows",
            "Commit rows folded into one aggregated planner dispatch",
            buckets=_SIZE_BUCKETS,
        )
        self.batch_occupancy = r.histogram(
            "lite_frontend_batch_occupancy",
            "Lane occupancy (present/dispatched) of aggregated dispatches",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
        )
        self.verify_seconds = r.histogram(
            "lite_frontend_verify_seconds",
            "End-to-end certification latency per frontend request",
        )


_frontend_mtx = threading.Lock()
_frontend_metrics: Optional[FrontendMetrics] = None


def get_frontend_metrics() -> FrontendMetrics:
    """Process-wide FrontendMetrics singleton (mirrors get_verify_metrics)."""
    global _frontend_metrics
    with _frontend_mtx:
        if _frontend_metrics is None:
            _frontend_metrics = FrontendMetrics()
        return _frontend_metrics


class VoteBatchMetrics:
    """The live-vote micro-batcher's telemetry (parallel/planner.VoteFeed):
    vote-set rows a flush, the lane tile's fill, the flush's trigger
    (deadline|quorum|close) and each vote's queue wait. Process-wide, like
    VerifyMetrics."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.batch_rows = r.histogram(
            "consensus_vote_batch_rows",
            "Vote-set rows folded into one batched vote-verify dispatch",
            buckets=_SIZE_BUCKETS,
        )
        self.batch_lanes = r.histogram(
            "consensus_vote_batch_lanes",
            "Votes (present lanes) per batched vote-verify dispatch",
            buckets=_SIZE_BUCKETS,
        )
        self.lane_occupancy = r.histogram(
            "consensus_vote_batch_lane_occupancy",
            "Lane occupancy (present/dispatched) of batched vote dispatches",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
        )
        self.flushes = r.counter(
            "consensus_vote_batch_flush_total",
            "Vote micro-batcher flushes by trigger (deadline|quorum|close)",
            label_names=("reason",),
        )
        self.batch_wait = r.histogram(
            "consensus_vote_batch_wait_seconds",
            "Queue wait a vote spent parked in the micro-batcher between "
            "ticket submit and flush (batching-added latency, separable "
            "from network propagation in the quorum reports)",
            buckets=[b / 100 for b in _DEFAULT_BUCKETS],
        )

    def record_flush(self, reason: str, rows: int, lanes: int,
                     occupancy: float) -> None:
        """One VoteFeed flush: its shape and trigger."""
        self.batch_rows.observe(float(rows))
        self.batch_lanes.observe(float(lanes))
        self.lane_occupancy.observe(float(occupancy))
        self.flushes.add(1.0, (reason,))

    def record_wait(self, seconds: float) -> None:
        """One ticket's submit-to-flush queue wait."""
        if seconds >= 0.0:
            self.batch_wait.observe(seconds)


_vote_batch_mtx = threading.Lock()
_vote_batch_metrics: Optional[VoteBatchMetrics] = None


def get_vote_batch_metrics() -> VoteBatchMetrics:
    """Process-wide VoteBatchMetrics singleton."""
    global _vote_batch_metrics
    with _vote_batch_mtx:
        if _vote_batch_metrics is None:
            _vote_batch_metrics = VoteBatchMetrics()
        return _vote_batch_metrics


class MempoolBatchMetrics:
    """The CheckTx micro-batcher's telemetry (parallel/planner.TxFeed):
    CheckTx-window rows a flush, the lane tile's fill and the flush's
    trigger (deadline|quorum|close). Process-wide, like VoteBatchMetrics."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.batch_rows = r.histogram(
            "mempool_batch_rows",
            "CheckTx-window rows folded into one batched tx-verify dispatch",
            buckets=_SIZE_BUCKETS,
        )
        self.batch_lanes = r.histogram(
            "mempool_batch_lanes",
            "Txs (present lanes) per batched tx-verify dispatch",
            buckets=_SIZE_BUCKETS,
        )
        self.lane_occupancy = r.histogram(
            "mempool_batch_lane_occupancy",
            "Lane occupancy (present/dispatched) of batched tx dispatches",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
        )
        self.flushes = r.counter(
            "mempool_batch_flush_total",
            "Tx micro-batcher flushes by trigger (deadline|quorum|close)",
            label_names=("reason",),
        )

    def record_flush(self, reason: str, rows: int, lanes: int,
                     occupancy: float) -> None:
        """One TxFeed flush: its shape and trigger."""
        self.batch_rows.observe(float(rows))
        self.batch_lanes.observe(float(lanes))
        self.lane_occupancy.observe(float(occupancy))
        self.flushes.add(1.0, (reason,))


_mempool_batch_mtx = threading.Lock()
_mempool_batch_metrics: Optional[MempoolBatchMetrics] = None


def get_mempool_batch_metrics() -> MempoolBatchMetrics:
    """Process-wide MempoolBatchMetrics singleton."""
    global _mempool_batch_metrics
    with _mempool_batch_mtx:
        if _mempool_batch_metrics is None:
            _mempool_batch_metrics = MempoolBatchMetrics()
        return _mempool_batch_metrics


class MempoolMetrics:
    """The mempool family of the reference's ``NodeMetrics`` that
    ``mempool/mempool.py`` writes (mempool/metrics.go): the pool's size, the
    accepted txs' sizes, CheckTx rejections, rechecks, the priority lanes'
    sizes, the CheckTx/recheck windows' sizes and the lane evictions."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.mempool_size = r.gauge("mempool_size", "Unconfirmed txs in the mempool")
        self.mempool_tx_size_bytes = r.histogram(
            "mempool_tx_size_bytes", "Size of accepted mempool txs",
            buckets=_SIZE_BUCKETS,
        )
        self.mempool_failed_txs = r.counter(
            "mempool_failed_txs", "Txs rejected by CheckTx"
        )
        self.mempool_recheck_times = r.counter(
            "mempool_recheck_times", "Txs re-checked after a commit"
        )
        self.mempool_qos_evicted_total = r.counter(
            "mempool_qos_evicted_total",
            "Txs evicted from lower lanes to admit higher-priority txs",
            label_names=("lane",),
        )
        self.mempool_lane_txs = r.gauge(
            "mempool_lane_txs", "Unconfirmed txs per priority lane",
            label_names=("lane",),
        )
        self.mempool_checktx_batch_size = r.histogram(
            "mempool_checktx_batch_size",
            "Txs coalesced per CheckTx/recheck app-conn window",
            buckets=_SIZE_BUCKETS,
        )


class StateMetrics:
    """The state family of the reference's ``NodeMetrics``
    (libs/metrics.py:937): the seconds of each block's execution on the
    app, which ``state/execution.BlockExecutor.apply_block`` observes."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.block_processing_time = r.histogram(
            "state_block_processing_time", "ApplyBlock seconds",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
        )
