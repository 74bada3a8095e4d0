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
observes); ``ConsensusMetrics`` is the part of its consensus family that
``consensus/state.py`` and ``consensus/wal.py`` write (the round, the step
durations, the vote arrival latency, the WAL's appends and fsyncs).
``StateSyncMetrics`` is the reference's state-sync family
(``statesync_*``), which ``statesync/syncer.py`` and ``statesync/reactor.py``
write. The other metric sets of the reference (the rest of consensus, p2p,
the mempool's QoS) are all in ``NodeMetrics``, the port's copy of the
reference's one-registry node family, which the switch, its peers and the
consensus reactor write.
"""

from __future__ import annotations

import threading
import time
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
        gets a dispatch tick and its lane-tile shard size attributed. A
        mesh passes ``DeviceMesh.labels()``, one label a shard, in which a
        device the mesh repeats carries its occurrence ("0#0" .. "0#3" for
        four shards on cuda:0), so that each shard is counted on its own;
        an id that comes twice in one call is counted twice."""
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


class ConsensusMetrics:
    """The consensus family of the reference's ``NodeMetrics``
    (libs/metrics.py:763-840) that ``consensus/state.py``,
    ``consensus/wal.py`` and the per-height instruments
    (``libs/critpath.py``, ``libs/quorumtrace.py``, ``libs/watchdog.py``)
    write, under the same attribute names."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.rounds = r.gauge("consensus_rounds", "Round of the current height")
        self.step_duration = r.histogram(
            "consensus_step_duration_seconds",
            "Wall seconds spent in each consensus step (labeled by the step "
            "being left)",
            label_names=("step",),
        )
        self.vote_arrival_latency = r.histogram(
            "consensus_vote_arrival_latency_seconds",
            "Wall-clock delay between a vote's signed timestamp and its "
            "arrival at the state machine",
            label_names=("type",),
        )
        self.wal_append_seconds = r.histogram(
            "consensus_wal_append_seconds", "WAL buffered-append wall seconds",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
        )
        self.wal_fsync_seconds = r.histogram(
            "consensus_wal_fsync_seconds", "WAL fsync wall seconds",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
        )
        # commit-latency waterfall (libs/critpath.py): wall seconds each
        # committed height spent in each phase of the commit path
        self.height_phase_seconds = r.histogram(
            "consensus_height_phase_seconds",
            "Per-committed-height wall seconds attributed to each "
            "commit-path phase by the critical-path analyzer",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
            label_names=("phase",),
        )
        # quorum formation (libs/quorumtrace.py): wall seconds from round
        # entry until arriving voting power crossed 1/3 and 2/3 of total
        self.quorum_time_to_third = r.histogram(
            "consensus_quorum_time_to_third_seconds",
            "Per-height wall seconds from round entry until arriving votes "
            "crossed 1/3 of total voting power",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
            label_names=("type",),
        )
        self.quorum_time_to_two_thirds = r.histogram(
            "consensus_quorum_time_to_two_thirds_seconds",
            "Per-height wall seconds from round entry until arriving votes "
            "crossed 2/3 of total voting power (quorum)",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
            label_names=("type",),
        )
        # liveness watchdog (libs/watchdog.py)
        self.stalls = r.counter(
            "consensus_stalls_total",
            "Distinct consensus stalls detected by the liveness watchdog",
        )
        self.stall_seconds = r.gauge(
            "consensus_stall_seconds",
            "Age of the current consensus stall (0 when progressing)",
        )


class TelemetryMetrics:
    """Telemetry-spool health (``libs/telemetry.TelemetrySpool``) plus
    ring-eviction visibility across the bounded observability stores (the
    reference's ``TelemetryMetrics``, libs/metrics.py:704-740, same
    names). One per spool, not a process singleton."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.snapshots = r.counter(
            "telemetry_snapshots_total",
            "Telemetry snapshots appended to the on-disk spool",
        )
        self.spool_bytes = r.gauge(
            "telemetry_spool_bytes",
            "On-disk size of the telemetry spool across all segments",
        )
        self.write_errors = r.counter(
            "telemetry_write_errors_total",
            "Telemetry snapshot appends that failed (disk errors)",
        )
        self.dropped = r.counter(
            "telemetry_dropped_snapshots_total",
            "Telemetry snapshots dropped before reaching the spool "
            "(serialization failures / flusher shutdown races)",
        )
        # the flight recorder, profile ledger and CritPath/QuorumTrace
        # rings all evict silently under load; these counters say so
        self.evicted = r.counter(
            "observability_evicted_total",
            "Records evicted from bounded observability stores",
            label_names=("store",),
        )


class StateSyncMetrics:
    """State-sync telemetry (the reference's ``StateSyncMetrics``, same
    names, labels and buckets): restore progress on the client side (chunk
    fetch outcomes, restore latency, backfill window size) and serving
    counters on the provider side. Process-wide like ``VerifyMetrics``."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.syncing = r.gauge("statesync_syncing", "1 while a snapshot restore is in progress")
        self.snapshot_height = r.gauge(
            "statesync_snapshot_height", "Height of the snapshot being restored")
        self.chunks_expected = r.gauge(
            "statesync_chunks_expected", "Chunks in the snapshot being restored")
        self.chunks_applied = r.gauge("statesync_chunks_applied", "Chunks applied so far")
        self.chunk_fetch = r.counter(
            "statesync_chunk_fetch_total",
            "Chunk fetch attempts by outcome (ok|bad|timeout|missing)",
            label_names=("outcome",),
        )
        self.chunk_bytes = r.counter("statesync_chunk_bytes_total", "Verified chunk bytes received")
        self.served = r.counter(
            "statesync_served_total",
            "Requests served to restoring peers by message type",
            label_names=("msg",),
        )
        self.chunk_fetch_seconds = r.histogram(
            "statesync_chunk_fetch_seconds", "Per-chunk fetch wall seconds")
        self.backfill_heights = r.histogram(
            "statesync_backfill_heights",
            "Heights in the trailing commit backfill window",
            buckets=tuple(float(1 << i) for i in range(11)),
        )
        self.restore_seconds = r.histogram(
            "statesync_restore_seconds",
            "End-to-end snapshot restore wall seconds",
            buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0),
        )


_statesync_mtx = threading.Lock()
_statesync_metrics: Optional[StateSyncMetrics] = None


def get_statesync_metrics() -> StateSyncMetrics:
    """The process-wide ``StateSyncMetrics`` (as ``get_verify_metrics``)."""
    global _statesync_metrics
    with _statesync_mtx:
        if _statesync_metrics is None:
            _statesync_metrics = StateSyncMetrics()
        return _statesync_metrics


class NodeMetrics:
    """All four reference metric families on one registry
    (consensus/metrics.go:14, p2p/metrics.go, mempool/metrics.go,
    state/metrics.go), plus the process-wide verify family attached: the
    port's copy of the reference's ``NodeMetrics`` (libs/metrics.py:755),
    with the same names, labels, buckets and attribute names. The switch
    and its peers write its p2p family (the per-peer wire bytes by channel,
    the messages by channel); the consensus reactor its vote sightings. It
    has every attribute of ``ConsensusMetrics``, so a node passes one
    ``NodeMetrics`` to its consensus state and its switch."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        # consensus
        self.height = r.gauge("consensus_height", "Height of the chain")
        self.rounds = r.gauge("consensus_rounds", "Round of the current height")
        self.validators = r.gauge("consensus_validators", "Number of validators")
        self.validators_power = r.gauge(
            "consensus_validators_power", "Total voting power of validators"
        )
        self.missing_validators = r.gauge(
            "consensus_missing_validators", "Validators missing from the last commit"
        )
        self.byzantine_validators = r.gauge(
            "consensus_byzantine_validators", "Validators that double-signed"
        )
        self.block_interval_seconds = r.histogram(
            "consensus_block_interval_seconds", "Time between this and the last block"
        )
        self.num_txs = r.gauge("consensus_num_txs", "Txs in the latest block")
        self.block_size_bytes = r.gauge(
            "consensus_block_size_bytes", "Size of the latest block"
        )
        self.total_txs = r.gauge("consensus_total_txs", "Total txs committed")
        self.fast_syncing = r.gauge("consensus_fast_syncing", "1 while fast syncing")
        self.step_duration = r.histogram(
            "consensus_step_duration_seconds",
            "Wall seconds spent in each consensus step (labeled by the step "
            "being left)",
            label_names=("step",),
        )
        self.vote_arrival_latency = r.histogram(
            "consensus_vote_arrival_latency_seconds",
            "Wall-clock delay between a vote's signed timestamp and its "
            "arrival at the state machine",
            label_names=("type",),
        )
        self.wal_append_seconds = r.histogram(
            "consensus_wal_append_seconds", "WAL buffered-append wall seconds",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
        )
        self.wal_fsync_seconds = r.histogram(
            "consensus_wal_fsync_seconds", "WAL fsync wall seconds",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
        )
        # commit-latency waterfall (libs/critpath.py): wall seconds each
        # committed height spent in each phase of the commit path
        self.height_phase_seconds = r.histogram(
            "consensus_height_phase_seconds",
            "Per-committed-height wall seconds attributed to each "
            "commit-path phase by the critical-path analyzer",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
            label_names=("phase",),
        )
        # quorum formation (libs/quorumtrace.py): wall seconds from round
        # entry until arriving voting power crossed 1/3 and 2/3 of total
        self.quorum_time_to_third = r.histogram(
            "consensus_quorum_time_to_third_seconds",
            "Per-height wall seconds from round entry until arriving votes "
            "crossed 1/3 of total voting power",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
            label_names=("type",),
        )
        self.quorum_time_to_two_thirds = r.histogram(
            "consensus_quorum_time_to_two_thirds_seconds",
            "Per-height wall seconds from round entry until arriving votes "
            "crossed 2/3 of total voting power (quorum)",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
            label_names=("type",),
        )
        # liveness watchdog (libs/watchdog.py)
        self.stalls = r.counter(
            "consensus_stalls_total",
            "Distinct consensus stalls detected by the liveness watchdog",
        )
        self.stall_seconds = r.gauge(
            "consensus_stall_seconds",
            "Age of the current consensus stall (0 when progressing)",
        )
        # pubsub (libs/pubsub.py slow-subscriber drops)
        self.pubsub_dropped = r.counter(
            "pubsub_dropped_events_total",
            "Events dropped because a subscriber's buffer was full",
            label_names=("client_id",),
        )
        # p2p
        self.peers = r.gauge("p2p_peers", "Connected peers")
        self.peer_receive_bytes = r.counter(
            "p2p_peer_receive_bytes_total",
            "Wire bytes received from a peer by channel (packet framing "
            "included; sourced from the same stream the flowrate recv "
            "monitor measures)",
            label_names=("peer_id", "chID"),
        )
        self.peer_send_bytes = r.counter(
            "p2p_peer_send_bytes_total",
            "Wire bytes sent to a peer by channel (packet framing included)",
            label_names=("peer_id", "chID"),
        )
        self.peer_pending_send_bytes = r.gauge(
            "p2p_peer_pending_send_bytes",
            "Bytes queued (not yet on the wire) toward a peer",
            label_names=("peer_id",),
        )
        self.messages_received = r.counter(
            "p2p_messages_received_total",
            "Complete messages delivered to reactors by channel",
            label_names=("chID",),
        )
        self.messages_sent = r.counter(
            "p2p_messages_sent_total",
            "Messages queued toward peers by channel",
            label_names=("chID",),
        )
        # vote-gossip efficiency at the consensus reactor receive seam
        # (BEFORE VoteSet dedup): every VoteMessage increments exactly one
        # of these two, so their sum is total votes received
        self.vote_first_sighting = r.counter(
            "p2p_vote_first_sighting_total",
            "Votes received that were the node's first sighting of that "
            "(height, round, type, validator) vote, by gossiping peer",
            label_names=("peer_id", "chID"),
        )
        self.duplicate_votes = r.counter(
            "p2p_duplicate_votes_total",
            "Votes received that the node had already seen (gossip "
            "amplification waste), by gossiping peer",
            label_names=("peer_id", "chID"),
        )
        # mempool
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
        # mempool QoS / admission control (mempool/qos.py)
        self.mempool_qos_admitted_total = r.counter(
            "mempool_qos_admitted_total",
            "Peer txs admitted past the QoS layer",
        )
        self.mempool_qos_dropped_total = r.counter(
            "mempool_qos_dropped_total",
            "Peer txs dropped by the QoS layer",
            label_names=("reason",),
        )
        self.mempool_qos_muted_peers = r.gauge(
            "mempool_qos_muted_peers", "Peers currently muted by QoS"
        )
        self.mempool_qos_mutes_total = r.counter(
            "mempool_qos_mutes_total", "Repeat-offender mutes issued"
        )
        self.mempool_qos_shed_total = r.counter(
            "mempool_qos_shed_total",
            "RPC broadcast_tx_* requests shed under overload",
            label_names=("route",),
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
        # state
        self.block_processing_time = r.histogram(
            "state_block_processing_time", "ApplyBlock seconds",
            buckets=[b / 10 for b in _DEFAULT_BUCKETS],
        )
        # verify pipeline + state sync (process-global; attached, not
        # re-registered)
        self.verify = get_verify_metrics()
        r.attach(self.verify.registry)
        self.statesync = get_statesync_metrics()
        r.attach(self.statesync.registry)
        self.frontend = get_frontend_metrics()
        r.attach(self.frontend.registry)
        self.vote_batch = get_vote_batch_metrics()
        r.attach(self.vote_batch.registry)
        self.mempool_batch = get_mempool_batch_metrics()
        r.attach(self.mempool_batch.registry)
        # per-node telemetry spool family (see TelemetryMetrics docstring
        # for why this one is NOT a process singleton)
        self.telemetry = TelemetryMetrics()
        r.attach(self.telemetry.registry)
        self._last_block_time: Optional[float] = None
        # cardinality hygiene: at most MAX_PEER_LABELS distinct peer ids ever
        # get their own label value; the rest collapse into "overflow"
        self._peer_label_ids: set = set()
        self._peer_label_mtx = threading.Lock()

    # called from the consensus event path -------------------------------------
    def record_block(self, block, valset) -> None:
        now = time.monotonic()
        self.height.set(block.height)
        self.num_txs.set(len(block.data.txs))
        self.total_txs.add(len(block.data.txs))
        self.block_size_bytes.set(len(block.marshal()))
        if valset is not None:
            self.validators.set(valset.size)
            self.validators_power.set(valset.total_voting_power())
            if block.height > 1:
                # height 1 has no LastCommit — counting "missing" precommits
                # there reports the whole valset absent
                missing = sum(
                    1 for pc in block.last_commit.precommits if pc is None
                )
                self.missing_validators.set(missing)
        # double-sign evidence included in this block (metrics.go
        # ByzantineValidators is computed from block evidence)
        self.byzantine_validators.set(len(block.evidence.evidence))
        if self._last_block_time is not None:
            dt = now - self._last_block_time
            # monotonic() is process-local: a restart (or a timer reset at
            # fast-sync exit) leaves no usable previous timestamp, and a
            # non-positive delta means the clock basis changed under us
            if dt > 0:
                self.block_interval_seconds.observe(dt)
        self._last_block_time = now

    def reset_block_timer(self) -> None:
        """Forget the last block timestamp.  Called at fast-sync exit: the
        synced blocks arrived at replay speed, so the next live block's
        interval measured against them would be garbage."""
        self._last_block_time = None

    # per-peer traffic ----------------------------------------------------------
    MAX_PEER_LABELS = 64

    def _peer_label(self, peer_id: str) -> str:
        with self._peer_label_mtx:
            if peer_id in self._peer_label_ids:
                return peer_id
            if len(self._peer_label_ids) < self.MAX_PEER_LABELS:
                self._peer_label_ids.add(peer_id)
                return peer_id
        return "overflow"

    def record_peer_traffic(self, peer_id: str, chan_id: int,
                            sent: int = 0, received: int = 0) -> None:
        pid = self._peer_label(peer_id)
        ch = f"{chan_id:#x}"
        if sent:
            self.peer_send_bytes.add(sent, (pid, ch))
        if received:
            self.peer_receive_bytes.add(received, (pid, ch))

    def set_peer_pending(self, peer_id: str, pending: int) -> None:
        self.peer_pending_send_bytes.set(float(pending),
                                         (self._peer_label(peer_id),))

    def record_vote_sighting(self, peer_id: str, chan_id: int,
                             first: bool) -> None:
        """One VoteMessage at the reactor receive seam: first sighting or
        duplicate (same 64-peer label fold as the traffic counters)."""
        pid = self._peer_label(peer_id)
        ch = f"{chan_id:#x}"
        if first:
            self.vote_first_sighting.add(1.0, (pid, ch))
        else:
            self.duplicate_votes.add(1.0, (pid, ch))

    def forget_peer(self, peer_id: str) -> None:
        """Drop every per-peer series for a disconnected peer so label
        cardinality tracks the live peer set, not its history."""
        with self._peer_label_mtx:
            self._peer_label_ids.discard(peer_id)
        self.peer_send_bytes.remove_matching("peer_id", peer_id)
        self.peer_receive_bytes.remove_matching("peer_id", peer_id)
        self.peer_pending_send_bytes.remove_matching("peer_id", peer_id)
        self.vote_first_sighting.remove_matching("peer_id", peer_id)
        self.duplicate_votes.remove_matching("peer_id", peer_id)
