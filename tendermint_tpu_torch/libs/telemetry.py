"""Crash-safe telemetry spool — the soak observatory's durable memory; the
port's copy of the reference package's ``libs/telemetry.py``, over the
port's ``libs/autofile.py``.

Every observability surface in this repo is an in-memory ring dumped
point-in-time over RPC: a node restart erases its history and a
thousand-height soak silently forgets its tails.  The spool fixes both.
A background flusher appends one **snapshot** — metrics-derived gauges,
the critpath/quorum whole-run sketches (libs/sketch.py), profile-ledger
totals, device-breaker health, and the eviction counts of every bounded
store — every N committed heights or T seconds, whichever fires first,
to a rotating on-disk segment group (libs/autofile.py).

Record framing (one frame per snapshot, frames never span a rotation
because Group.write appends whole buffers to the head):

    4 bytes  big-endian payload length
    4 bytes  big-endian CRC32 of the payload
    N bytes  payload: one compact JSON line (sort_keys, trailing \\n)

A torn final frame — the node died mid-write — is TOLERATED on reopen:
readers verify length + CRC and stop at the first bad frame of the last
segment.  A bad frame before the tail is corruption and is counted, not
raised.  Appending after a torn tail is safe for readers of the NEW
frames only via the recovery truncate in ``TelemetrySpool.__init__``:
the spool re-scans its head segment on open and truncates the torn tail
so the next frame starts clean.

``TelemetrySpool.snapshot(limit)`` follows the established dump contract
(``limit`` newest, ``truncated``, ``total_records``, ONE lock
acquisition) over an in-memory ring of recent snapshots; the on-disk
spool is the long horizon a reader takes offline with ``read_spool``.
"""

from __future__ import annotations

import json
import os
import re
import struct
import threading
import time
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from tendermint_tpu_torch.libs.autofile import (
    DEFAULT_HEAD_SIZE_LIMIT,
    DEFAULT_TOTAL_SIZE_LIMIT,
    Group,
)

_HEADER = struct.Struct(">II")  # (payload_len, crc32)

# a single snapshot larger than this is a serialization bug, not data;
# the bound also stops a corrupt length field from allocating gigabytes
MAX_RECORD_BYTES = 16 * 1024 * 1024

DEFAULT_RING_CAPACITY = 256  # in-memory snapshots behind dump_telemetry
DEFAULT_INTERVAL_HEIGHTS = 20
DEFAULT_INTERVAL_SECONDS = 5.0

# store labels of the eviction counters surfaced into metrics + snapshots
EVICTION_STORES = ("flight", "profile", "critpath", "quorum")


def encode_record(payload: bytes) -> bytes:
    """One spool frame: length + CRC32 header, then the payload."""
    return _HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _scan_segment(path: str, is_tail: bool) -> Tuple[List[bytes], int, int]:
    """Parse one segment file into (payloads, corrupt_frames, valid_bytes).

    ``valid_bytes`` is the offset of the first bad byte (== file size when
    the segment is clean).  A bad frame is tolerated silently when it is
    the torn tail of the LAST segment (``is_tail``); anywhere else it
    counts as corruption.  Either way parsing stops: a bad frame loses
    framing sync for the rest of the file.
    """
    payloads: List[bytes] = []
    corrupt = 0
    offset = 0
    try:
        data = open(path, "rb").read()
    except OSError:
        return payloads, corrupt, offset
    size = len(data)
    while offset + _HEADER.size <= size:
        length, crc = _HEADER.unpack_from(data, offset)
        end = offset + _HEADER.size + length
        if length > MAX_RECORD_BYTES or end > size:
            if not is_tail:
                corrupt += 1
            break
        payload = data[offset + _HEADER.size:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            # checksum mismatch: torn tail if nothing follows, corruption
            # otherwise (and on any non-tail segment)
            if not is_tail or end < size:
                corrupt += 1
            break
        payloads.append(payload)
        offset = end
    return payloads, corrupt, offset


def spool_segments(head_path: str) -> List[str]:
    """All on-disk segment paths of a spool, oldest first, head last."""
    d = os.path.dirname(os.path.abspath(head_path)) or "."
    base = os.path.basename(head_path)
    pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
    idxs = []
    if os.path.isdir(d):
        for fn in os.listdir(d):
            m = pat.match(fn)
            if m:
                idxs.append(int(m.group(1)))
    out = [f"{head_path}.{i:03d}" for i in sorted(idxs)]
    if os.path.exists(head_path):
        out.append(head_path)
    return out


def read_spool(head_path: str) -> dict:
    """Read every decodable snapshot from a spool on disk (offline path —
    the node may be dead; no Group is opened, nothing is created).

    Returns ``{"snapshots": [dict...], "corrupt_frames": n,
    "segments": n}``; a torn tail on the final segment is tolerated
    silently, per the crash-safety contract.
    """
    segments = spool_segments(head_path)
    snapshots: List[dict] = []
    corrupt = 0
    for i, path in enumerate(segments):
        payloads, bad, _ = _scan_segment(path, is_tail=(i == len(segments) - 1))
        corrupt += bad
        for payload in payloads:
            try:
                snapshots.append(json.loads(payload))
            except ValueError:
                corrupt += 1
    return {
        "snapshots": snapshots,
        "corrupt_frames": corrupt,
        "segments": len(segments),
    }


class TelemetrySpool:
    """Periodic snapshot spooler for one node.

    ``sources`` maps section name -> zero-arg callable returning a JSON-
    safe value; each flush calls every source (each takes its own lock)
    and frames the combined snapshot onto the autofile group.  Sources
    that raise are skipped for that snapshot (their error is counted) —
    telemetry must not fail the node.

    Thread model: the flusher thread and RPC threads share ``_mtx``; the
    single-lock snapshot contract of the other dump surfaces applies to
    ``snapshot(limit)`` and ``status()``.
    """

    def __init__(
        self,
        path: str,
        node_id: str = "",
        interval_heights: int = DEFAULT_INTERVAL_HEIGHTS,
        interval_seconds: float = DEFAULT_INTERVAL_SECONDS,
        head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT,
        total_size_limit: int = DEFAULT_TOTAL_SIZE_LIMIT,
        ring_capacity: int = DEFAULT_RING_CAPACITY,
        metrics=None,
        height_fn: Optional[Callable[[], int]] = None,
        now=time.monotonic,
    ):
        if ring_capacity < 1:
            raise ValueError(
                f"telemetry ring capacity must be >= 1, got {ring_capacity}")
        self.path = path
        self.node_id = node_id
        self.interval_heights = max(int(interval_heights), 1)
        self.interval_seconds = float(interval_seconds)
        self.metrics = metrics  # TelemetryMetrics or None
        self._height_fn = height_fn
        self._now = now
        self._mtx = threading.Lock()
        self._sources: Dict[str, Callable[[], object]] = {}
        # recover a torn tail BEFORE the Group opens the head for append:
        # frames written after garbage would be unreachable to readers
        self._recovered_bytes = self._truncate_torn_tail(path)
        self._group = Group(
            path,
            head_size_limit=head_size_limit,
            total_size_limit=total_size_limit,
        )
        self._configure(ring_capacity)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_flush_t = self._now()
        self._last_flush_height = self._current_height()
        # last-seen eviction totals, for delta feeding the counter family
        self._evicted_seen: Dict[str, int] = {s: 0 for s in EVICTION_STORES}

    def _configure(self, ring_capacity: int) -> None:
        self.ring_capacity = int(ring_capacity)
        self._ring: List[dict] = []  # oldest first
        self._ring_evicted = 0
        self.snapshots_written = 0
        self.write_errors = 0
        self.dropped = 0
        self.source_errors = 0

    @staticmethod
    def _truncate_torn_tail(path: str) -> int:
        """Drop a torn final frame from the head segment so appended
        frames stay reachable; returns the bytes discarded (0 normally)."""
        if not os.path.exists(path):
            return 0
        _, _, valid = _scan_segment(path, is_tail=True)
        size = os.path.getsize(path)
        if valid < size:
            with open(path, "r+b") as f:
                f.truncate(valid)
            return size - valid
        return 0

    # -- sources ------------------------------------------------------------

    def set_source(self, name: str, fn: Callable[[], object]) -> None:
        with self._mtx:
            self._sources[name] = fn

    def _current_height(self) -> int:
        if self._height_fn is None:
            return 0
        try:
            return int(self._height_fn())
        except Exception:
            return 0

    # -- flushing -----------------------------------------------------------

    def _build_snapshot(self, reason: str) -> dict:
        height = self._current_height()
        snap = {
            "v": 1,
            "node_id": self.node_id,
            "seq": self.snapshots_written,
            "height": height,
            "wall_time": time.time(),
            "reason": reason,
        }
        with self._mtx:
            sources = list(self._sources.items())
        for name, fn in sources:
            try:
                snap[name] = fn()
            except Exception:
                # a failed section must not lose the rest of the snapshot
                with self._mtx:
                    self.source_errors += 1
                snap[name] = None
        return snap

    def _observe_evictions(self, evicted: Optional[dict]) -> None:
        """Feed eviction-count DELTAS into the per-store counter family
        (the stores report monotone totals; counters need increments)."""
        if self.metrics is None or not isinstance(evicted, dict):
            return
        for store in EVICTION_STORES:
            total = evicted.get(store)
            if not isinstance(total, (int, float)):
                continue
            delta = int(total) - self._evicted_seen.get(store, 0)
            if delta > 0:
                self.metrics.evicted.add(float(delta), (store,))
                self._evicted_seen[store] = int(total)

    def flush(self, reason: str = "manual") -> Optional[dict]:
        """Build + append one snapshot now.  Returns the snapshot dict, or
        None when it could not even be serialized (counted as dropped)."""
        snap = self._build_snapshot(reason)
        try:
            payload = (
                json.dumps(snap, sort_keys=True, separators=(",", ":"))
                + "\n"
            ).encode()
        except (TypeError, ValueError):
            with self._mtx:
                self.dropped += 1
            if self.metrics is not None:
                self.metrics.dropped.add(1.0)
            return None
        frame = encode_record(payload)
        try:
            self._group.write(frame)
            self._group.flush()
            self._group.maybe_rotate()
            spool_bytes = self._group.total_size()
        except OSError:
            with self._mtx:
                self.write_errors += 1
            if self.metrics is not None:
                self.metrics.write_errors.add(1.0)
            return snap
        with self._mtx:
            self.snapshots_written += 1
            self._ring.append(snap)
            if len(self._ring) > self.ring_capacity:
                del self._ring[: len(self._ring) - self.ring_capacity]
                self._ring_evicted += 1
        self._last_flush_t = self._now()
        self._last_flush_height = snap["height"]
        if self.metrics is not None:
            self.metrics.snapshots.add(1.0)
            self.metrics.spool_bytes.set(float(spool_bytes))
        self._observe_evictions(snap.get("evicted"))
        return snap

    def _due(self) -> Optional[str]:
        if self.interval_seconds > 0 and (
            self._now() - self._last_flush_t >= self.interval_seconds
        ):
            return "interval"
        if self.interval_heights > 0:
            h = self._current_height()
            if h - self._last_flush_height >= self.interval_heights:
                return "heights"
        return None

    def maybe_flush(self) -> Optional[dict]:
        """Flush if an interval elapsed (the flusher's tick; tests and the
        sim harness call it directly for determinism)."""
        reason = self._due()
        return self.flush(reason) if reason else None

    def _run(self) -> None:
        # tick well below the flush interval so height-triggered flushes
        # land promptly even when the wall interval is long
        tick = min(0.25, self.interval_seconds / 4.0 or 0.25)
        while not self._stop.wait(max(tick, 0.01)):
            try:
                self.maybe_flush()
            except Exception:
                with self._mtx:
                    self.write_errors += 1

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-spool", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the flusher and append one final snapshot (clean shutdown
        marks the end of a leg)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(5.0)
        try:
            self.flush("shutdown")
        finally:
            try:
                self._group.sync()
            except OSError:
                pass
            self._group.close()

    def kill(self) -> None:
        """Crash-style stop: halt the flusher and drop the file handle with
        NO shutdown snapshot — what a kill -9 leaves behind.  Exists for
        crash-safety tests; production shutdown is ``stop``."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(5.0)
        self._group.close()

    # -- export -------------------------------------------------------------

    def reset(self, capacity: Optional[int] = None) -> dict:
        """telemetry_reset RPC: clear the in-memory ring + health counters
        (optionally resizing the ring).  The on-disk spool is history and
        is deliberately NOT touched."""
        with self._mtx:
            cap = capacity if capacity is not None else self.ring_capacity
            if cap < 1:
                raise ValueError(
                    f"telemetry ring capacity must be >= 1, got {cap}")
            self._configure(cap)
            return {"ring_capacity": self.ring_capacity}

    def status(self) -> dict:
        """Health summary under ONE lock acquisition (tm_monitor column,
        included in every snapshot via the node's 'spool' source)."""
        with self._mtx:
            return {
                "node_id": self.node_id,
                "path": self.path,
                "snapshots_written": self.snapshots_written,
                "write_errors": self.write_errors,
                "dropped": self.dropped,
                "source_errors": self.source_errors,
                "recovered_bytes": self._recovered_bytes,
                "interval_heights": self.interval_heights,
                "interval_seconds": self.interval_seconds,
            }

    def spool_bytes(self) -> int:
        try:
            return self._group.total_size()
        except (OSError, ValueError):
            return 0

    def snapshot(self, limit: Optional[int] = None) -> dict:
        """The dump_telemetry RPC payload: newest ``limit`` in-memory
        snapshots, all derived counts under ONE lock acquisition so the
        truncated flag can never contradict the record list."""
        with self._mtx:
            total = len(self._ring)
            recs = self._ring
            if limit is not None and limit >= 0:
                recs = recs[-limit:] if limit else []
            recs = [dict(r) for r in recs]
            return {
                "node_id": self.node_id,
                "path": self.path,
                "ring_capacity": self.ring_capacity,
                "ring_evicted": self._ring_evicted,
                "snapshots_written": self.snapshots_written,
                "write_errors": self.write_errors,
                "dropped": self.dropped,
                "source_errors": self.source_errors,
                "total_records": total,
                "truncated": len(recs) < total,
                "records": recs,
            }


def node_sources(node) -> Dict[str, Callable[[], object]]:
    """The standard snapshot sections for a running ``node/node.Node``
    (anything with a ``consensus_state``): the instruments' sketches, the
    eviction counts of every bounded store, the profile ledger's totals,
    the device breaker's snapshot and the per-phase and quorum stats."""
    cs = node.consensus_state

    def _sketches() -> dict:
        return {
            "critpath": cs.critpath.sketches(),
            "quorum": cs.quorumtrace.sketches(),
        }

    def _evicted() -> dict:
        from tendermint_tpu_torch.libs.profile import get_profiler

        return {
            "flight": cs.flight.evicted(),
            "profile": get_profiler().dropped,
            "critpath": cs.critpath.snapshot(limit=0)["evicted"],
            "quorum": cs.quorumtrace.snapshot(limit=0)["evicted"],
        }

    def _profile() -> dict:
        from tendermint_tpu_torch.libs.profile import get_profiler

        p = get_profiler()
        rows = p.ledger()
        return {
            "rows": len(rows),
            "dispatches": sum(r["dispatches"] for r in rows),
            "pack_seconds": sum(r["pack_seconds"] for r in rows),
            "run_seconds": sum(r["run_seconds"] for r in rows),
            "compile_seconds": sum(r["compile_seconds"] for r in rows),
            "bytes_to_device": sum(r["bytes_to_device"] for r in rows),
            "dropped": p.dropped,
        }

    def _device() -> Optional[dict]:
        try:
            from tendermint_tpu_torch.libs.breaker import get_device_breaker

            return get_device_breaker().snapshot()
        except Exception:
            return None

    def _stats() -> dict:
        return {
            "height": cs.rs.height,
            "phase_stats": cs.critpath.phase_stats(),
            "quorum_stats": cs.quorumtrace.quorum_stats(),
        }

    return {
        "sketches": _sketches,
        "evicted": _evicted,
        "profile_ledger": _profile,
        "device_health": _device,
        "stats": _stats,
    }
