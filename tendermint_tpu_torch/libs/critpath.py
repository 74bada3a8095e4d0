"""Per-height critical-path analyzer — fuses the four observability streams
into one commit-latency waterfall per committed height; the port's copy of
the reference package's ``libs/critpath.py``.

The repo measures consensus latency in four disconnected places: histograms
(libs/metrics.py), thread spans (libs/trace.py), lifecycle stamps
(consensus/flight.py), and the dispatch cost ledger (libs/profile.py).
None of them answers "where did each millisecond of height H go?".  This
module does the join:

* the flight record's wall-clock milestones are cut into disjoint timeline
  phases —

      propose_wait      new-round entry .. first proposal sighting
      block_parts       proposal .. block parts complete
      prevote_quorum    block parts .. polka (+2/3 prevotes)
      precommit_quorum  polka .. commit (+2/3 precommits)
      commit_persist    block-store save_block span (flight "persist")
      abci_exec         ABCI apply_block span (flight "exec")

  whose sum plus an explicit ``other_seconds`` residual reconciles with the
  wall height time exactly (it is an identity by construction; tests assert
  it against the raw stamps);

* per-height WAL costs (``wal_append`` / ``wal_fsync``) come from the
  height-tagged accumulators consensus/wal.py keeps next to its spans, and
  ``verify_dispatch`` comes from profiler entries whose ``window()`` height
  annotation covers the height (the port's ``parallel/planner.VoteFeed``
  annotates each flush on the card, so its K1 + K2 time lands here).  These three are OVERLAY phases: they run
  concurrently with the timeline segments (a WAL fsync during
  prevote_quorum is counted in both), so they are reported but excluded
  from the reconciliation sum;

* the dominant phase is flagged as the height's critical path (ties break
  toward the earlier phase in chain order, so flagging is deterministic),
  and rolling per-phase samples in a ring buffer give p50/p99 without
  unbounded growth.

Like the flight recorder this is per-ConsensusState, piggybacks on the
flight recorder's enable gate (no stamps -> nothing to analyze), and its
``snapshot(limit)`` follows the standard dump contract (``limit`` newest,
``truncated``, ``total_records``).  Analysis runs once per committed height
on the consensus thread; any internal error is counted, never raised —
observability must not fail consensus.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence

from tendermint_tpu_torch.libs.sketch import QuantileSketch

# Phase chain of the waterfall, in canonical (chain) order.  The order is
# load-bearing twice: trace_merge emits slices in it, and critical-path
# ties break toward the earlier entry.
PHASES = (
    "propose_wait",
    "block_parts",
    "prevote_quorum",
    "precommit_quorum",
    "wal_append",
    "wal_fsync",
    "abci_exec",
    "commit_persist",
)

# Disjoint timeline segments of [height start, height end]; their sum plus
# other_seconds equals wall_seconds exactly.
TIMELINE_PHASES = (
    "propose_wait",
    "block_parts",
    "prevote_quorum",
    "precommit_quorum",
    "commit_persist",
    "abci_exec",
)

# Joined per-height costs that overlap the timeline (reported, not summed).
OVERLAY_PHASES = ("wal_append", "wal_fsync", "verify_dispatch")

DEFAULT_CAPACITY = 256  # waterfalls remembered before the ring evicts
DEFAULT_SAMPLE_WINDOW = 512  # rolling per-phase percentile samples


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0,100]); 0.0 on empty input."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[min(rank, len(xs)) - 1]


def verify_seconds_for_height(entries: Sequence[dict], height: int) -> float:
    """Verify-dispatch seconds attributable to `height` from profiler
    entries (libs/profile.py, entries() shape).

    Entries carry the window() annotation as (height_base, heights).  An
    entry whose height_base IS the height gets full attribution — that is
    the live-vote path, where VoteFeed annotates each flush with the batch's
    height span.  A multi-height window (fast-sync / state-sync replay)
    covering the height contributes its cost amortized evenly across the
    window; the first height of such a window is attributed in full, a
    documented imprecision that only affects replay traffic.
    """
    total = 0.0
    for e in entries:
        hb = e.get("height_base")
        if hb is None:
            continue
        cost = float(e.get("pack_seconds") or 0.0) + float(
            e.get("run_seconds") or 0.0
        )
        if hb == height:
            total += cost
            continue
        span = max(int(e.get("heights") or 0), 1)
        if hb < height < hb + span:
            total += cost / span
    return total


def build_waterfall(
    rec: dict,
    wal_costs: Optional[dict] = None,
    verify_seconds: float = 0.0,
) -> Optional[dict]:
    """One flight record -> one waterfall dict, or None if the height never
    committed (no reconciliation target exists without a commit stamp).

    Milestones are clamped monotonically non-decreasing before cutting:
    a proposer stamps block parts before its own proposal acceptance, and
    skewed sim clocks can invert neighbors — a negative phase would break
    the reconciliation identity, a zero-width one does not.
    """
    rounds = rec.get("rounds") or []
    commit = rec.get("commit")
    if not rounds or commit is None:
        return None
    t_start = min(r["t"] for r in rounds)
    marks = [t_start]
    for milestone in ("proposal", "block_parts", "polka"):
        m = rec.get(milestone)
        marks.append(max(m["t"] if m else marks[-1], marks[-1]))
    marks.append(max(commit["t"], marks[-1]))
    _, t_prop, t_parts, t_polka, t_commit = marks

    persist = rec.get("persist")
    ex = rec.get("exec")
    persist_ns = max(persist["dur_ns"], 0) if persist else 0
    exec_ns = max(ex["dur_ns"], 0) if ex else 0
    t_end = t_commit
    for m, dur in ((persist, persist_ns), (ex, exec_ns)):
        if m is not None:
            t_end = max(t_end, m["t"] + dur)

    wal_costs = wal_costs or {}
    phases: Dict[str, float] = {
        "propose_wait": (t_prop - t_start) / 1e9,
        "block_parts": (t_parts - t_prop) / 1e9,
        "prevote_quorum": (t_polka - t_parts) / 1e9,
        "precommit_quorum": (t_commit - t_polka) / 1e9,
        "commit_persist": persist_ns / 1e9,
        "abci_exec": exec_ns / 1e9,
        "wal_append": float(wal_costs.get("append_seconds") or 0.0),
        "wal_fsync": float(wal_costs.get("fsync_seconds") or 0.0),
    }
    wall = (t_end - t_start) / 1e9
    other = wall - sum(phases[p] for p in TIMELINE_PHASES)
    critical = max(PHASES, key=lambda p: (phases[p], -PHASES.index(p)))

    # timeline segments with their absolute stamps, for trace_merge's
    # nested Chrome slices (finalize segments sit after the commit stamp;
    # persist runs before exec in _do_finalize_commit)
    segments = [
        {"phase": "propose_wait", "t0_ns": t_start, "t1_ns": t_prop},
        {"phase": "block_parts", "t0_ns": t_prop, "t1_ns": t_parts},
        {"phase": "prevote_quorum", "t0_ns": t_parts, "t1_ns": t_polka},
        {"phase": "precommit_quorum", "t0_ns": t_polka, "t1_ns": t_commit},
    ]
    if persist is not None:
        segments.append({
            "phase": "commit_persist",
            "t0_ns": persist["t"],
            "t1_ns": persist["t"] + persist_ns,
        })
    if ex is not None:
        segments.append({
            "phase": "abci_exec",
            "t0_ns": ex["t"],
            "t1_ns": ex["t"] + exec_ns,
        })

    return {
        "height": rec["height"],
        "commit_round": commit.get("round", 0),
        "t_start_ns": t_start,
        "t_end_ns": t_end,
        "wall_seconds": wall,
        # signing-to-commit latency: the bench/gate metric
        "commit_seconds": (t_commit - t_start) / 1e9,
        "phases": phases,
        "other_seconds": other,
        "critical_path": critical,
        "verify_dispatch_seconds": verify_seconds,
        "wal_appends": int(wal_costs.get("appends") or 0),
        "wal_fsyncs": int(wal_costs.get("fsyncs") or 0),
        "segments": segments,
    }


class CritPath:
    """Ring of per-height waterfalls plus rolling per-phase percentile
    windows.  One per ConsensusState (``cs.critpath``), mutated only from
    the consensus thread's finalize path; snapshots may come from RPC
    threads, so every access takes one lock — and every derived count in a
    snapshot is computed under that SINGLE acquisition, the contract the
    flight recorder's wraparound fix established."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        sample_window: int = DEFAULT_SAMPLE_WINDOW,
        metrics=None,
        profiler_entries=None,
    ):
        self._mtx = threading.Lock()
        self.metrics = metrics  # ConsensusMetrics (height_phase_seconds) or None
        self.node_id = ""  # refreshed from the flight recorder on analyze
        self.sample_window = max(int(sample_window), 1)
        # injectable for tests; defaults to the process profiler ledger
        self._profiler_entries = profiler_entries
        self.analysis_errors = 0
        self._configure(capacity)

    def _configure(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"critpath capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._records: List[dict] = []  # oldest first
        self._evicted = 0
        self._samples: Dict[str, List[float]] = {}
        self._commit_samples: List[float] = []
        # whole-run mergeable sketches next to the exact rolling windows:
        # the windows answer "lately", the sketches answer "this run" in
        # bounded memory and pool exactly across nodes (fixed gamma)
        self._sketches: Dict[str, QuantileSketch] = {
            phase: QuantileSketch() for phase in PHASES
        }
        self._sketches["commit"] = QuantileSketch()

    # control ---------------------------------------------------------------
    def reset(self, capacity: Optional[int] = None) -> None:
        with self._mtx:
            self._configure(capacity if capacity is not None else self.capacity)
            self.analysis_errors = 0

    def __len__(self) -> int:
        with self._mtx:
            return len(self._records)

    # ingestion -------------------------------------------------------------
    def _entries(self) -> List[dict]:
        if self._profiler_entries is not None:
            return self._profiler_entries()
        from tendermint_tpu_torch.libs.profile import get_profiler

        return get_profiler().entries()

    def on_height_complete(self, height: int, flight, wal=None) -> Optional[dict]:
        """Analyze one committed height.  Called from _do_finalize_commit
        right after flight.on_execute; returns the waterfall (tests use it)
        or None when the flight recorder is off / the record is gone."""
        if not getattr(flight, "enabled", False):
            return None
        try:
            rec = flight.peek(height)
            if rec is None:
                return None
            wal_costs = None
            if wal is not None and hasattr(wal, "pop_height_costs"):
                wal_costs = wal.pop_height_costs(height)
            verify_s = verify_seconds_for_height(self._entries(), height)
            wf = build_waterfall(rec, wal_costs, verify_s)
            if wf is None:
                return None
            self.node_id = getattr(flight, "node_id", "") or self.node_id
            self._ingest(wf)
            if self.metrics is not None:
                for phase, secs in wf["phases"].items():
                    self.metrics.height_phase_seconds.observe(secs, (phase,))
            return wf
        except Exception:
            # never let the analyzer take down the consensus thread
            self.analysis_errors += 1
            return None

    def _ingest(self, wf: dict) -> None:
        with self._mtx:
            self._records.append(wf)
            if len(self._records) > self.capacity:
                del self._records[: len(self._records) - self.capacity]
                self._evicted += 1
            win = self.sample_window
            for phase, secs in wf["phases"].items():
                ring = self._samples.setdefault(phase, [])
                ring.append(secs)
                if len(ring) > win:
                    del ring[: len(ring) - win]
                sk = self._sketches.get(phase)
                if sk is not None:
                    sk.add(secs)
            self._commit_samples.append(wf["commit_seconds"])
            if len(self._commit_samples) > win:
                del self._commit_samples[: len(self._commit_samples) - win]
            self._sketches["commit"].add(wf["commit_seconds"])

    # export ----------------------------------------------------------------
    def records(self, limit: Optional[int] = None) -> List[dict]:
        """Copied waterfalls, oldest first (newest N when limit is set)."""
        with self._mtx:
            return self._records_locked(limit)

    def _records_locked(self, limit: Optional[int]) -> List[dict]:
        recs = self._records
        if limit is not None and limit >= 0:
            recs = recs[-limit:] if limit else []
        return [dict(r) for r in recs]

    def phase_stats(self) -> Dict[str, dict]:
        with self._mtx:
            return self._phase_stats_locked()

    def _phase_stats_locked(self) -> Dict[str, dict]:
        out = {}
        for phase in PHASES:
            xs = self._samples.get(phase, ())
            out[phase] = self._stats_entry(self._sketches[phase], xs)
        out["commit"] = self._stats_entry(
            self._sketches["commit"], self._commit_samples)
        return out

    @staticmethod
    def _stats_entry(sk: QuantileSketch, xs: Sequence[float]) -> dict:
        """p50/p99 from the whole-run sketch; the exact rolling-window
        values ride alongside under window_* for continuity."""
        return {
            "n": sk.count,
            "p50_seconds": sk.p50(),
            "p99_seconds": sk.p99(),
            "window_n": len(xs),
            "window_p50_seconds": percentile(xs, 50),
            "window_p99_seconds": percentile(xs, 99),
        }

    def sketches(self) -> Dict[str, dict]:
        """Serialized per-phase + commit sketches (spool / fleet merge)."""
        with self._mtx:
            return self._sketches_locked()

    def _sketches_locked(self) -> Dict[str, dict]:
        return {name: sk.to_dict() for name, sk in self._sketches.items()}

    def snapshot(self, limit: Optional[int] = None) -> dict:
        """The dump_critpath RPC payload.  total/records/evicted/stats are
        all read under ONE lock acquisition so the truncated flag can never
        contradict the record list it ships with."""
        with self._mtx:
            total = len(self._records)
            recs = self._records_locked(limit)
            return {
                "node_id": self.node_id,
                "capacity": self.capacity,
                "sample_window": self.sample_window,
                "evicted": self._evicted,
                "analysis_errors": self.analysis_errors,
                "total_records": total,
                "truncated": len(recs) < total,
                "records": recs,
                "phase_stats": self._phase_stats_locked(),
                "sketches": self._sketches_locked(),
            }
