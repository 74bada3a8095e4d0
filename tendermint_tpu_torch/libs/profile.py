"""Device-dispatch cost ledger: where wall time goes inside a batched
verify dispatch (host pack vs. first-dispatch warm-up vs. device run vs.
transfer).

The port's copy of the JAX package's ``libs/profile.py``: the same ring
buffer, the same entry fields, the same per-window ``ledger()`` fold. The
port's planner (``parallel/planner.py``) records one entry per dispatch,
``kind`` "planner" for the device executor ("planner_mesh" when it splits
the lanes over a ``DeviceMesh``, "planner_msm" on the MSM path) and "host"
for the verifier route; the commit window records "window", "window_mesh"
or "window_msm". A mesh entry's ``n_devices`` is the mesh's shard count. Each entry carries the (window, bucket) coordinates plus:

- ``pack_seconds``   host plan + pack (sign-bytes, decompress, upload) time
- ``run_seconds``    device dispatch wall time (includes the bucket's
                     first-dispatch warm-up when ``compiled`` is True)
- ``bytes_to_device`` packed tensor bytes on the device for the dispatch
- ``lanes_present`` / ``lanes_dispatched``  occupancy of the padded bucket

Callers that know which heights a window covers annotate the current thread
with ``window(height_base)`` so entries can be grouped into a per-height
ledger (``ledger()``). A separate ring keeps rare health events (breaker
transitions, audit mismatches, device fallbacks).

Like libs/trace.py this is dependency-free and cheap when idle: recording
is a dict append under a lock, and the ring buffers bound memory.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

_DEFAULT_CAPACITY = 4096
_EVENT_CAPACITY = 512

_tls = threading.local()


class Profiler:
    """Bounded ring buffer of dispatch-cost entries."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 event_capacity: int = _EVENT_CAPACITY):
        self._mtx = threading.Lock()
        self._capacity = max(1, int(capacity))
        self._entries: List[dict] = []
        self._dropped = 0
        self._seq = 0
        # separate ring for rare, schema-free health events (breaker
        # transitions, audit verdicts, fallbacks) so they survive long
        # after the high-churn dispatch entries have rotated out
        self._event_capacity = max(1, int(event_capacity))
        self._events: List[dict] = []
        self._events_dropped = 0

    # recording ---------------------------------------------------------------

    @contextmanager
    def window(self, height_base: int, heights: int = 0) -> Iterator[None]:
        """Annotate dispatches on this thread with the window's first height.

        Nesting restores the outer annotation on exit, so a syncer backfill
        inside a fast-sync window doesn't mislabel the outer dispatches.
        """
        prev = getattr(_tls, "window", None)
        _tls.window = (int(height_base), int(heights))
        try:
            yield
        finally:
            _tls.window = prev

    def record(
        self,
        kind: str,
        *,
        bucket: tuple = (),
        lanes_present: int = 0,
        lanes_dispatched: int = 0,
        heights: int = 0,
        pack_seconds: float = 0.0,
        run_seconds: float = 0.0,
        compiled: bool = False,
        bytes_to_device: int = 0,
        fe_backend: str = "",
        carry_mode: str = "",
        ed25519_path: str = "",
        n_windows: int = 1,
        n_devices: int = 1,
    ) -> None:
        win = getattr(_tls, "window", None)
        entry = {
            "kind": kind,
            # superdispatch shape: independent windows folded into this
            # dispatch and mesh devices the lane tile sharded across
            "n_windows": int(n_windows),
            "n_devices": int(n_devices),
            # limb-multiplier backend recorded for this dispatch
            # (vpu | mxu | mxu16; "" = host / not applicable)
            "fe_backend": str(fe_backend),
            # carry schedule recorded for the dispatch (eager | lazy;
            # "" = host / not applicable)
            "carry_mode": str(carry_mode),
            # verify strategy (ladder | msm; "" = host / not applicable):
            "ed25519_path": str(ed25519_path),
            "height_base": win[0] if win else None,
            "heights": heights or (win[1] if win else 0),
            "bucket": list(bucket),
            "lanes_present": int(lanes_present),
            "lanes_dispatched": int(lanes_dispatched),
            "occupancy": (
                round(lanes_present / lanes_dispatched, 4)
                if lanes_dispatched else 0.0
            ),
            "pack_seconds": float(pack_seconds),
            "run_seconds": float(run_seconds),
            # a bucket's first dispatch pays the launch warm-up, so a
            # compiled entry's run_seconds is warm-up + run; steady-state
            # cost is the non-compiled entries for the same bucket
            "compile_seconds": float(run_seconds) if compiled else 0.0,
            "compiled": bool(compiled),
            "bytes_to_device": int(bytes_to_device),
        }
        with self._mtx:
            entry["seq"] = self._seq
            self._seq += 1
            self._entries.append(entry)
            if len(self._entries) > self._capacity:
                del self._entries[0]
                self._dropped += 1

    def record_event(self, kind: str, **fields) -> None:
        """One health/state event (breaker transition, audit verdict,
        host fallback) into the bounded event ring.  Unlike ``record``
        the schema is free-form: kind plus whatever the event carries."""
        entry = {"kind": kind, "wall_time": time.time()}
        entry.update(fields)
        win = getattr(_tls, "window", None)
        if win is not None and "height_base" not in entry:
            entry["height_base"] = win[0]
        with self._mtx:
            entry["seq"] = self._seq
            self._seq += 1
            self._events.append(entry)
            if len(self._events) > self._event_capacity:
                del self._events[0]
                self._events_dropped += 1

    # querying ----------------------------------------------------------------

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._mtx:
            out = [dict(e) for e in self._events]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out

    @property
    def events_dropped(self) -> int:
        with self._mtx:
            return self._events_dropped

    def entries(self) -> List[dict]:
        with self._mtx:
            return [dict(e) for e in self._entries]

    @property
    def dropped(self) -> int:
        with self._mtx:
            return self._dropped

    def ledger(self) -> List[dict]:
        """Per-window cost rows, newest last.  Entries recorded with the
        same window annotation fold into one row; un-annotated entries
        (bench harnesses, direct calls) each get their own row."""
        rows: Dict[object, dict] = {}
        order: List[object] = []
        for e in self.entries():
            key = e["height_base"] if e["height_base"] is not None else (
                "seq", e["seq"]
            )
            row = rows.get(key)
            if row is None:
                row = {
                    "height_base": e["height_base"],
                    "heights": e["heights"],
                    "dispatches": 0,
                    "windows": 0,
                    "n_devices": 1,
                    "kinds": [],
                    "fe_backends": [],
                    "carry_modes": [],
                    "ed25519_paths": [],
                    "buckets": [],
                    "lanes_present": 0,
                    "lanes_dispatched": 0,
                    "pack_seconds": 0.0,
                    "run_seconds": 0.0,
                    "compile_seconds": 0.0,
                    "compiles": 0,
                    "bytes_to_device": 0,
                }
                rows[key] = row
                order.append(key)
            row["dispatches"] += 1
            row["windows"] += e.get("n_windows", 1)
            row["n_devices"] = max(row["n_devices"], e.get("n_devices", 1))
            if e["kind"] not in row["kinds"]:
                row["kinds"].append(e["kind"])
            fb = e.get("fe_backend", "")
            if fb and fb not in row["fe_backends"]:
                row["fe_backends"].append(fb)
            cm = e.get("carry_mode", "")
            if cm and cm not in row["carry_modes"]:
                row["carry_modes"].append(cm)
            ep = e.get("ed25519_path", "")
            if ep and ep not in row["ed25519_paths"]:
                row["ed25519_paths"].append(ep)
            if e["bucket"] and e["bucket"] not in row["buckets"]:
                row["buckets"].append(e["bucket"])
            row["lanes_present"] += e["lanes_present"]
            row["lanes_dispatched"] += e["lanes_dispatched"]
            row["heights"] = max(row["heights"], e["heights"])
            row["pack_seconds"] += e["pack_seconds"]
            row["run_seconds"] += e["run_seconds"]
            row["compile_seconds"] += e["compile_seconds"]
            row["compiles"] += 1 if e["compiled"] else 0
            row["bytes_to_device"] += e["bytes_to_device"]
        out = []
        for key in order:
            row = rows[key]
            ld = row["lanes_dispatched"]
            row["occupancy"] = round(row["lanes_present"] / ld, 4) if ld else 0.0
            out.append(row)
        return out

    def reset(self, capacity: Optional[int] = None) -> None:
        with self._mtx:
            self._entries.clear()
            self._dropped = 0
            self._seq = 0
            self._events.clear()
            self._events_dropped = 0
            if capacity is not None:
                self._capacity = max(1, int(capacity))


_profiler: Optional[Profiler] = None
_profiler_mtx = threading.Lock()


def get_profiler() -> Profiler:
    global _profiler
    with _profiler_mtx:
        if _profiler is None:
            _profiler = Profiler()
        return _profiler
