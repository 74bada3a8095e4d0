"""Quorum observatory — cross-node vote-propagation fusion and the live
per-height quorum-formation analyzer; the port's copy of the reference
package's ``libs/quorumtrace.py``.

The flight recorder (consensus/flight.py) stamps each vote's full journey
with wall-clock ns:

    signed      our own vote the instant the privval signature lands
    first_send  first gossip send of each validator's vote to any peer
    arrivals    first sighting of each validator's vote at the reactor
                receive seam (BEFORE VoteSet dedup)
    contrib     the instant each validator's vote was ADDED to the vote
                set, with its voting power (the quorum contribution)
    dup_by_peer duplicate votes per gossiping peer (amplification waste)

This module fuses those stamps two ways:

* **Pure fusion functions** (`build_journeys`, `completion_curve`,
  `gossip_ledger`, `flush_attribution`) operate on dump dicts — the
  `dump_flight` / `dump_quorum` RPC payloads after a JSON round trip —
  with per-node clock corrections supplied by the caller (the commit-
  anchor median math in tools/trace_merge.py).  tools/quorum_report.py
  composes them into the operator-facing report.

* **`QuorumTrace`** is the live per-ConsensusState analyzer: once per
  committed height (from `_do_finalize_commit`, right after the critpath
  analyzer) it cuts the height's contrib stamps into a quorum completion
  curve — time for arriving voting power to cross 1/3, 1/2, 2/3 of the
  valset total, with the pivotal validator named — feeds the
  `tendermint_consensus_quorum_time_to_{third,two_thirds}_seconds`
  histograms, joins the VoteFeed flush ledger for batching attribution,
  and keeps a ring of per-height records behind the standard
  ``snapshot(limit)`` dump contract (`dump_quorum` RPC).

Like the critpath analyzer it piggybacks on the flight recorder's enable
gate and never raises into the consensus thread — internal errors are
counted, not propagated.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from tendermint_tpu_torch.libs.critpath import percentile
from tendermint_tpu_torch.libs.sketch import QuantileSketch

VOTE_KINDS = ("prevote", "precommit")

DEFAULT_CAPACITY = 256  # heights remembered before the ring evicts
DEFAULT_SAMPLE_WINDOW = 512  # rolling time-to-quorum percentile samples

# quorum thresholds as (numerator, denominator) of total voting power;
# "two_thirds" uses the STRICT Tendermint rule (cum * 3 > total * 2)
_THRESHOLDS = (
    ("third", 1, 3),
    ("half", 1, 2),
    ("two_thirds", 2, 3),
)


def _crossed(cum: int, total: int, num: int, den: int, name: str) -> bool:
    if name == "two_thirds":
        return cum * den > total * num  # strict: exactly 2/3 must NOT cross
    return cum * den >= total * num


# ---------------------------------------------------------------------------
# pure fusion over dump dicts
# ---------------------------------------------------------------------------


def _vote_slot(rec: dict, kind: str) -> dict:
    slot = rec.get(kind)
    return slot if isinstance(slot, dict) else {}


def _int_keys(d: Optional[dict]) -> dict:
    """Validator-index maps survive a JSON round trip with string keys —
    coerce back to int so fusion joins across transports."""
    if not d:
        return {}
    return {int(k): v for k, v in d.items()}


def build_journeys(
    dumps: Sequence[dict], skews: Optional[Dict[str, int]] = None
) -> List[dict]:
    """Fuse flight dumps into per-(height, kind, validator) vote journeys.

    Every node's stamps are shifted onto the reference timeline by its
    entry in ``skews`` (node_id -> ns to ADD, trace_merge.compute_skews
    convention).  Each journey carries:

        origin / signed_ns   the signer node and its corrected sign stamp
        first_send           the origin's first gossip send (corrected)
        arrivals             per receiving node: the receive-seam first
                             sighting — ``t_ns`` is the raw corrected
                             stamp (reconciles EXACTLY with the
                             receiver's record), ``t_mono_ns`` is clamped
                             so sign <= send <= arrival always holds even
                             when residual skew inverts neighbors
                             (``clamped`` flags it)
        contrib              per node: when the vote entered that node's
                             vote set, with its voting power

    Journeys are sorted (height, kind, validator_index); a journey with no
    known origin (the signer's dump is missing or evicted) still fuses its
    arrivals — ``origin`` is None and arrivals are not clamped.
    """
    skews = skews or {}
    # (height, kind, vi) -> journey
    out: Dict[tuple, dict] = {}

    def journey(height: int, kind: str, vi: int) -> dict:
        key = (height, kind, vi)
        j = out.get(key)
        if j is None:
            j = {
                "height": height,
                "kind": kind,
                "validator_index": vi,
                "origin": None,
                "signed_ns": None,
                "round": None,
                "first_send": None,
                "arrivals": {},
                "contrib": {},
                "clamped": False,
            }
            out[key] = j
        return j

    for dump in dumps:
        node = dump.get("node_id", "")
        skew = int(skews.get(node, 0))
        for rec in dump.get("records") or []:
            height = rec.get("height")
            if height is None:
                continue
            for kind in VOTE_KINDS:
                slot = _vote_slot(rec, kind)
                signed = slot.get("signed")
                if signed is not None:
                    vi = int(signed.get("validator_index", -1))
                    if vi >= 0:
                        j = journey(height, kind, vi)
                        j["origin"] = node
                        j["signed_ns"] = int(signed["t"]) + skew
                        j["round"] = signed.get("round")
                        send = _int_keys(slot.get("first_send")).get(vi)
                        if send is not None:
                            j["first_send"] = {
                                "t_ns": int(send["t"]) + skew,
                                "peer": send.get("peer", ""),
                            }
                for vi, mark in _int_keys(slot.get("arrivals")).items():
                    j = journey(height, kind, vi)
                    j["arrivals"][node] = {
                        "t_ns": int(mark["t"]) + skew,
                        "peer": mark.get("peer", ""),
                        "round": mark.get("round"),
                    }
                for vi, mark in _int_keys(slot.get("contrib")).items():
                    j = journey(height, kind, vi)
                    j["contrib"][node] = {
                        "t_ns": int(mark["t"]) + skew,
                        "power": int(mark.get("power") or 0),
                    }

    # monotone view: clamp each leg to its predecessor (residual skew after
    # anchor correction can invert real sub-ms gaps; the raw t_ns is kept
    # for exact per-node reconciliation)
    for j in out.values():
        floor = j["signed_ns"]
        if j["first_send"] is not None and floor is not None:
            mono = max(j["first_send"]["t_ns"], floor)
            j["first_send"]["t_mono_ns"] = mono
            if mono != j["first_send"]["t_ns"]:
                j["clamped"] = True
            floor = mono
        for mark in j["arrivals"].values():
            if floor is None:
                mark["t_mono_ns"] = mark["t_ns"]
                continue
            mono = max(mark["t_ns"], floor)
            mark["t_mono_ns"] = mono
            if mono != mark["t_ns"]:
                j["clamped"] = True

    return [out[k] for k in sorted(out)]


def completion_curve(
    rec: dict, kind: str, total_power: int, skew_ns: int = 0
) -> Optional[dict]:
    """One node's quorum completion curve for (height, kind): sort the
    contrib stamps, accumulate power, and mark the instants arriving power
    crossed 1/3, 1/2 and (strictly) 2/3 of ``total_power``.

    t0 is the height's round entry (first round stamp); returns None when
    the record has no rounds or no contributions.  The validator whose
    contribution crossed 2/3 is the height's **pivotal** validator — the
    one the commit actually waited for.
    """
    rounds = rec.get("rounds") or []
    contrib = _int_keys(_vote_slot(rec, kind).get("contrib"))
    if not rounds or not contrib or total_power <= 0:
        return None
    t0 = min(int(r["t"]) for r in rounds) + skew_ns
    arrivals = sorted(
        (int(m["t"]) + skew_ns, vi, int(m.get("power") or 0))
        for vi, m in contrib.items()
    )
    crossings: Dict[str, Optional[dict]] = {
        name: None for name, _, _ in _THRESHOLDS
    }
    cum = 0
    for t, vi, power in arrivals:
        cum += power
        for name, num, den in _THRESHOLDS:
            if crossings[name] is None and _crossed(
                cum, total_power, num, den, name
            ):
                crossings[name] = {
                    "t_ns": t,
                    "seconds": max(0.0, (t - t0) / 1e9),
                    "validator_index": vi,
                    "cum_power": cum,
                }
    present = [vi for _, vi, _ in arrivals]
    pivotal = crossings["two_thirds"]
    return {
        "height": rec.get("height"),
        "kind": kind,
        "t0_ns": t0,
        "total_power": int(total_power),
        "present_power": cum,
        "present": sorted(present),
        "crossings": crossings,
        "pivotal_validator": (
            pivotal["validator_index"] if pivotal is not None else None
        ),
    }


def gossip_ledger(
    dumps: Sequence[dict],
    skews: Optional[Dict[str, int]] = None,
    journeys: Optional[Sequence[dict]] = None,
) -> dict:
    """Gossip-efficiency accounting across all dumps.

    Per link (gossiping peer -> receiving node): first sightings (the
    arrivals slots), duplicates (dup_by_peer), and — when ``journeys`` are
    supplied — median/p99 sign-to-arrival propagation latency over that
    link.  The amplification **waste ratio** is duplicates divided by
    first sightings: 0 means every vote traveled each edge once, 1 means
    half the vote traffic was redundant re-gossip.
    """
    links: Dict[tuple, dict] = {}

    def link(peer: str, node: str) -> dict:
        entry = links.get((peer, node))
        if entry is None:
            entry = {"first": 0, "dup": 0, "latency_s": []}
            links[(peer, node)] = entry
        return entry

    first_total = dup_total = 0
    for dump in dumps:
        node = dump.get("node_id", "")
        for rec in dump.get("records") or []:
            for kind in VOTE_KINDS:
                slot = _vote_slot(rec, kind)
                for mark in _int_keys(slot.get("arrivals")).values():
                    link(mark.get("peer", ""), node)["first"] += 1
                    first_total += 1
                for peer, n in (slot.get("dup_by_peer") or {}).items():
                    link(peer, node)["dup"] += int(n)
                    dup_total += int(n)

    if journeys:
        for j in journeys:
            signed = j.get("signed_ns")
            if signed is None:
                continue
            for node, mark in j["arrivals"].items():
                links.get((mark.get("peer", ""), node), {}).setdefault(
                    "latency_s", []
                ).append(max(0.0, (mark["t_ns"] - signed) / 1e9))

    out_links = []
    for (peer, node), entry in sorted(links.items()):
        lat = entry.pop("latency_s")
        # per-link latency through the mergeable sketch (soak_report pools
        # links fleet-wide); the exact values stay under window_* keys
        sk = QuantileSketch()
        sk.extend(lat)
        out_links.append({
            "peer": peer,
            "node": node,
            "first_sightings": entry["first"],
            "duplicates": entry["dup"],
            "latency_p50_s": sk.p50(),
            "latency_p99_s": sk.p99(),
            "window_latency_p50_s": percentile(lat, 50),
            "window_latency_p99_s": percentile(lat, 99),
            "latency_samples": len(lat),
            "latency_sketch": sk.to_dict(),
        })
    return {
        "links": out_links,
        "first_sightings": first_total,
        "duplicates": dup_total,
        "waste_ratio": (dup_total / first_total) if first_total else 0.0,
    }


def flush_attribution(
    flush_dump: Optional[dict], height: int
) -> List[dict]:
    """VoteFeed flush records whose group list covers ``height`` — the
    batching-added spans to subtract from the height's quorum tail.
    ``flush_dump`` is VoteFeed.flush_records() (possibly JSON round-
    tripped); group keys are [height, round, vote_type] lists."""
    if not flush_dump:
        return []
    out = []
    for rec in flush_dump.get("records") or []:
        for gk in rec.get("groups") or []:
            if (
                isinstance(gk, (list, tuple))
                and gk
                and int(gk[0]) == height
            ):
                out.append(dict(rec))
                break
    return out


# ---------------------------------------------------------------------------
# live per-node analyzer
# ---------------------------------------------------------------------------


class QuorumTrace:
    """Ring of per-height quorum-formation records plus rolling
    time-to-quorum percentile windows.  One per ConsensusState
    (``cs.quorumtrace``), fed from the consensus thread's finalize path;
    snapshots may come from RPC threads, so every derived count in a
    snapshot is computed under ONE lock acquisition (the flight recorder's
    wraparound contract)."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        sample_window: int = DEFAULT_SAMPLE_WINDOW,
        metrics=None,
    ):
        self._mtx = threading.Lock()
        self.metrics = metrics  # ConsensusMetrics (quorum_time_to_*) or None
        self.node_id = ""  # refreshed from the flight recorder on analyze
        self.sample_window = max(int(sample_window), 1)
        self.analysis_errors = 0
        self._configure(capacity)

    def _configure(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(
                f"quorumtrace capacity must be >= 1, got {capacity}"
            )
        self.capacity = capacity
        self._records: List[dict] = []  # oldest first
        self._evicted = 0
        # kind -> rolling [seconds] rings for the two crossing thresholds
        self._third_samples: Dict[str, List[float]] = {}
        self._two_thirds_samples: Dict[str, List[float]] = {}
        # whole-run mergeable sketches next to the exact rolling windows
        # (fixed gamma: two nodes' sketches pool exactly in soak_report)
        self._sketches: Dict[str, QuantileSketch] = {
            f"{kind}_{name}": QuantileSketch()
            for kind in VOTE_KINDS
            for name in ("third", "two_thirds")
        }

    # control ---------------------------------------------------------------
    def reset(self, capacity: Optional[int] = None) -> None:
        with self._mtx:
            self._configure(
                capacity if capacity is not None else self.capacity
            )
            self.analysis_errors = 0

    def __len__(self) -> int:
        with self._mtx:
            return len(self._records)

    # ingestion -------------------------------------------------------------
    def on_height_complete(
        self, height: int, flight, validators=None, vote_feed=None
    ) -> Optional[dict]:
        """Analyze one committed height.  Called from _do_finalize_commit
        right after the critpath analyzer, while ``validators`` is still
        the committed height's valset (its total power scales the curve).
        Returns the record (tests use it) or None when the flight recorder
        is off / the record is gone."""
        if not getattr(flight, "enabled", False):
            return None
        try:
            rec = flight.peek(height)
            if rec is None:
                return None
            total_power = 0
            if validators is not None:
                try:
                    total_power = int(validators.total_voting_power())
                except Exception:
                    total_power = 0
            curves = {}
            for kind in VOTE_KINDS:
                if total_power <= 0:
                    # no valset in sight: scale by the power that DID
                    # arrive, so crossings still mark relative progress
                    contrib = _int_keys(
                        _vote_slot(rec, kind).get("contrib")
                    )
                    total = sum(
                        int(m.get("power") or 0) for m in contrib.values()
                    )
                else:
                    total = total_power
                curve = completion_curve(rec, kind, total)
                if curve is not None:
                    curves[kind] = curve
            if not curves:
                return None
            first = dup = 0
            dup_by_peer: Dict[str, int] = {}
            for kind in VOTE_KINDS:
                slot = _vote_slot(rec, kind)
                first += len(slot.get("arrivals") or {})
                for peer, n in (slot.get("dup_by_peer") or {}).items():
                    dup += int(n)
                    dup_by_peer[peer] = dup_by_peer.get(peer, 0) + int(n)
            out = {
                "height": height,
                "node_id": getattr(flight, "node_id", ""),
                "total_power": int(total_power),
                "curves": curves,
                "gossip": {
                    "first_sightings": first,
                    "duplicates": dup,
                    "dup_by_peer": dup_by_peer,
                },
                "flushes": (
                    flush_attribution(vote_feed.flush_records(), height)
                    if vote_feed is not None
                    and hasattr(vote_feed, "flush_records")
                    else []
                ),
            }
            self.node_id = getattr(flight, "node_id", "") or self.node_id
            self._ingest(out)
            if self.metrics is not None:
                for kind, curve in curves.items():
                    third = curve["crossings"]["third"]
                    if third is not None:
                        self.metrics.quorum_time_to_third.observe(
                            third["seconds"], (kind,)
                        )
                    two = curve["crossings"]["two_thirds"]
                    if two is not None:
                        self.metrics.quorum_time_to_two_thirds.observe(
                            two["seconds"], (kind,)
                        )
            return out
        except Exception:
            # never let the analyzer take down the consensus thread
            self.analysis_errors += 1
            return None

    def _ingest(self, out: dict) -> None:
        with self._mtx:
            self._records.append(out)
            if len(self._records) > self.capacity:
                del self._records[: len(self._records) - self.capacity]
                self._evicted += 1
            win = self.sample_window
            for kind, curve in out["curves"].items():
                for name, ring in (
                    ("third", self._third_samples),
                    ("two_thirds", self._two_thirds_samples),
                ):
                    mark = curve["crossings"][name]
                    if mark is None:
                        continue
                    xs = ring.setdefault(kind, [])
                    xs.append(mark["seconds"])
                    if len(xs) > win:
                        del xs[: len(xs) - win]
                    self._sketches[f"{kind}_{name}"].add(mark["seconds"])

    # export ----------------------------------------------------------------
    def records(self, limit: Optional[int] = None) -> List[dict]:
        """Copied records, oldest first (newest N when limit is set)."""
        with self._mtx:
            return self._records_locked(limit)

    def _records_locked(self, limit: Optional[int]) -> List[dict]:
        recs = self._records
        if limit is not None and limit >= 0:
            recs = recs[-limit:] if limit else []
        return [dict(r) for r in recs]

    def quorum_stats(self) -> Dict[str, dict]:
        with self._mtx:
            return self._quorum_stats_locked()

    def _quorum_stats_locked(self) -> Dict[str, dict]:
        out = {}
        for kind in VOTE_KINDS:
            third = self._third_samples.get(kind, ())
            two = self._two_thirds_samples.get(kind, ())
            sk_third = self._sketches[f"{kind}_third"]
            sk_two = self._sketches[f"{kind}_two_thirds"]
            out[kind] = {
                # whole-run sketch values lead; the exact rolling-window
                # values ride alongside under window_* for continuity
                "n": sk_two.count,
                "third_p50_seconds": sk_third.p50(),
                "third_p99_seconds": sk_third.p99(),
                "two_thirds_p50_seconds": sk_two.p50(),
                "two_thirds_p99_seconds": sk_two.p99(),
                "window_n": len(two),
                "window_third_p50_seconds": percentile(third, 50),
                "window_third_p99_seconds": percentile(third, 99),
                "window_two_thirds_p50_seconds": percentile(two, 50),
                "window_two_thirds_p99_seconds": percentile(two, 99),
            }
        return out

    def sketches(self) -> Dict[str, dict]:
        """Serialized time-to-quorum sketches (spool / fleet merge)."""
        with self._mtx:
            return self._sketches_locked()

    def _sketches_locked(self) -> Dict[str, dict]:
        return {name: sk.to_dict() for name, sk in self._sketches.items()}

    def snapshot(self, limit: Optional[int] = None) -> dict:
        """The dump_quorum RPC payload, under ONE lock acquisition so the
        truncated flag can never contradict the record list."""
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
                "quorum_stats": self._quorum_stats_locked(),
                "sketches": self._sketches_locked(),
            }
