"""Consensus flight recorder — a fixed-size ring of per-height lifecycle
records; the port's copy of the reference package's
``consensus/flight.py``.

Where libs/trace.py answers "what did THIS thread spend time on", the flight
recorder answers the liveness question operators actually ask: for height H,
when did each node enter the round, first see the proposal, complete the
block parts, collect its first/last prevote and precommit (and from which
peer), form the polka, commit, and execute the block through ABCI.

Timestamps are WALL-clock nanoseconds (`time.time_ns`), not perf_counter:
records from different nodes must be fusable on one timeline.  Each record
is tagged with the recorder's `node_id`; `tools/trace_merge.py` aligns
per-node clocks using commit events of shared heights as anchors (same
commit hash = same instant class) and emits a merged Chrome trace with one
track per node.

Disabled (the default) every hook is one attribute check and an early
return — the same <1% gate `libs/trace.py` holds on the host fast-sync
bench.  Enable with TM_FLIGHT=1, `[instrumentation] flight_recorder`
(``node/verify_root.consensus_state``), or `FlightRecorder.enable()`.

Unlike the tracer this is NOT a process singleton: each ConsensusState owns
one recorder (``cs.flight``), so in-proc multi-node tests and smokes get
genuinely per-node records.
"""

from __future__ import annotations

import copy as _copy
import os
import threading
import time
from typing import Dict, List, Optional

_now_ns = time.time_ns  # wall clock: cross-node fusable (see module doc)

DEFAULT_CAPACITY = 512  # heights remembered before the ring evicts
MAX_PEERS_PER_RECORD = 64  # per-peer vote attribution cap ("overflow" folds)


def _vote_slot() -> dict:
    return {
        "first": None, "last": None, "count": 0, "by_peer": {},
        # vote-journey stamps (libs/quorumtrace.py fuses these cross-node):
        "signed": None,     # {t, round} — OUR vote leaving the signer
        "first_send": {},   # validator_index -> {t, round, peer} first gossip
        "arrivals": {},     # validator_index -> {t, round, peer} first sighting
        "contrib": {},      # validator_index -> {t, round, power} quorum add
        "dup_by_peer": {},  # peer -> duplicate votes received (gossip waste)
    }


class FlightRecorder:
    """Ring of per-height records.  One per ConsensusState; every mutation
    takes the recorder lock (hooks run on the consensus receive thread and
    the reactor's peer threads)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, node_id: str = "",
                 enabled: bool = False):
        self._mtx = threading.Lock()
        self.enabled = enabled
        self.node_id = node_id
        # wall-clock source for every stamp; per-instance so the sim
        # harness can inject skewed/frozen clocks node by node
        self.now_ns = _now_ns
        self._configure(capacity)

    @classmethod
    def from_env(cls) -> "FlightRecorder":
        cap = int(os.environ.get("TM_FLIGHT_BUFFER", "") or DEFAULT_CAPACITY)
        on = os.environ.get("TM_FLIGHT", "") not in ("", "0")
        return cls(cap, enabled=on)

    def _configure(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: List[Optional[dict]] = [None] * capacity
        self._by_height: Dict[int, int] = {}  # height -> ring slot
        self._next = 0  # records ever allocated; slot = _next % capacity
        self._evicted = 0

    # control ---------------------------------------------------------------
    def enable(self, capacity: Optional[int] = None) -> None:
        with self._mtx:
            if capacity is not None and capacity != self.capacity:
                self._configure(capacity)
            self.enabled = True

    def disable(self) -> None:
        with self._mtx:
            self.enabled = False

    def reset(self, capacity: Optional[int] = None) -> None:
        with self._mtx:
            self._configure(capacity if capacity is not None else self.capacity)

    def evicted(self) -> int:
        """Height records overwritten by ring wraparound since last reset."""
        with self._mtx:
            return self._evicted

    def __len__(self) -> int:
        with self._mtx:
            return min(self._next, self.capacity)

    # record access (callers hold self._mtx) --------------------------------
    def _rec(self, height: int) -> dict:
        slot = self._by_height.get(height)
        if slot is not None:
            return self._buf[slot]
        slot = self._next % self.capacity
        old = self._buf[slot]
        if old is not None:
            self._by_height.pop(old["height"], None)
            self._evicted += 1
        rec = {
            "height": height,
            "rounds": [],       # [{round, t}]
            "proposal": None,   # {t, round, peer}
            "block_parts": None,  # {t}
            "prevote": _vote_slot(),
            "precommit": _vote_slot(),
            "polka": None,      # {t, round}
            "commit": None,     # {t, round, hash}
            "persist": None,    # {t, dur_ns} — block-store save_block span
            "exec": None,       # {t, dur_ns}
        }
        self._buf[slot] = rec
        self._by_height[height] = slot
        self._next += 1
        return rec

    # milestone hooks -------------------------------------------------------
    def on_new_round(self, height: int, round: int) -> None:
        if not self.enabled:
            return
        t = self.now_ns()
        with self._mtx:
            self._rec(height)["rounds"].append({"round": round, "t": t})

    def on_proposal(self, height: int, round: int, peer_id: str = "") -> None:
        """First sighting of the height's proposal.  The reactor calls this
        from its receive path with the gossiping peer's id; the state machine
        calls it with "" when it accepts (covers our own proposals).  First
        call wins — it IS the first-seen time."""
        if not self.enabled:
            return
        t = self.now_ns()
        with self._mtx:
            rec = self._rec(height)
            if rec["proposal"] is None:
                rec["proposal"] = {
                    "t": t, "round": round, "peer": peer_id or "local"
                }

    def on_block_parts_complete(self, height: int) -> None:
        if not self.enabled:
            return
        t = self.now_ns()
        with self._mtx:
            rec = self._rec(height)
            if rec["block_parts"] is None:
                rec["block_parts"] = {"t": t}

    def on_vote(self, height: int, round: int, kind: str, peer_id: str,
                validator_index: int, power: int = 0) -> None:
        """One vote ADDED by the state machine (post-dedup/verify).  kind is
        "prevote" | "precommit"; peer_id "" means our own/internal vote.
        ``power`` (the validator's voting power, when the caller knows it)
        feeds the quorum-completion curve in libs/quorumtrace.py."""
        if not self.enabled:
            return
        t = self.now_ns()
        peer = peer_id or "local"
        with self._mtx:
            slot = self._rec(height)[kind]
            mark = {"t": t, "round": round, "peer": peer,
                    "validator_index": validator_index}
            if slot["first"] is None:
                slot["first"] = mark
            slot["last"] = mark
            slot["count"] += 1
            contrib = slot["contrib"]
            if validator_index >= 0 and validator_index not in contrib:
                contrib[validator_index] = {
                    "t": t, "round": round, "power": power
                }
            by_peer = slot["by_peer"]
            if peer not in by_peer and len(by_peer) >= MAX_PEERS_PER_RECORD:
                peer = "overflow"
            by_peer[peer] = by_peer.get(peer, 0) + 1

    # vote-journey hooks (sign -> send -> arrival; add = contrib above) ------
    def on_vote_signed(self, height: int, round: int, kind: str,
                       validator_index: int) -> None:
        """OUR vote the instant the privval signature lands (origin of the
        journey).  First call wins — re-signs at later rounds keep the
        original stamp for that kind."""
        if not self.enabled:
            return
        t = self.now_ns()
        with self._mtx:
            slot = self._rec(height)[kind]
            if slot["signed"] is None:
                slot["signed"] = {
                    "t": t, "round": round, "validator_index": validator_index
                }

    def on_vote_send(self, height: int, round: int, kind: str,
                     validator_index: int, peer_id: str) -> None:
        """First gossip send of validator_index's vote to ANY peer (the
        reactor's pick_send_vote seam).  First send wins per validator;
        beyond MAX_PEERS_PER_RECORD validators new entries are dropped."""
        if not self.enabled:
            return
        t = self.now_ns()
        with self._mtx:
            sends = self._rec(height)[kind]["first_send"]
            if validator_index in sends:
                return
            if len(sends) >= MAX_PEERS_PER_RECORD:
                return
            sends[validator_index] = {"t": t, "round": round, "peer": peer_id}

    def on_vote_arrival(self, height: int, round: int, kind: str,
                        peer_id: str, validator_index: int,
                        duplicate: bool = False) -> None:
        """A VoteMessage hitting the consensus reactor's receive seam —
        BEFORE VoteSet dedup.  First sighting per validator stamps the
        arrival; duplicates fold into the per-peer waste counter."""
        if not self.enabled:
            return
        t = self.now_ns()
        peer = peer_id or "local"
        with self._mtx:
            slot = self._rec(height)[kind]
            if duplicate:
                dup = slot["dup_by_peer"]
                if peer not in dup and len(dup) >= MAX_PEERS_PER_RECORD:
                    peer = "overflow"
                dup[peer] = dup.get(peer, 0) + 1
                return
            arrivals = slot["arrivals"]
            if validator_index in arrivals:
                return
            if len(arrivals) >= MAX_PEERS_PER_RECORD:
                return
            arrivals[validator_index] = {"t": t, "round": round, "peer": peer}

    def on_polka(self, height: int, round: int) -> None:
        if not self.enabled:
            return
        t = self.now_ns()
        with self._mtx:
            rec = self._rec(height)
            if rec["polka"] is None:
                rec["polka"] = {"t": t, "round": round}

    def on_commit(self, height: int, round: int, block_hash: bytes = b"") -> None:
        if not self.enabled:
            return
        t = self.now_ns()
        with self._mtx:
            rec = self._rec(height)
            if rec["commit"] is None:
                rec["commit"] = {
                    "t": t, "round": round,
                    "hash": (block_hash or b"").hex().upper(),
                }

    def on_persist(self, height: int, t0_ns: int, t1_ns: int) -> None:
        """The block-store save_block span for the committed height."""
        if not self.enabled:
            return
        with self._mtx:
            self._rec(height)["persist"] = {"t": t0_ns, "dur_ns": t1_ns - t0_ns}

    def on_execute(self, height: int, t0_ns: int, t1_ns: int) -> None:
        """The ABCI apply_block span for the committed height."""
        if not self.enabled:
            return
        with self._mtx:
            self._rec(height)["exec"] = {"t": t0_ns, "dur_ns": t1_ns - t0_ns}

    # export ----------------------------------------------------------------
    def peek(self, height: int) -> Optional[dict]:
        """Deep copy of one height's record, or None (critpath analyzer)."""
        with self._mtx:
            slot = self._by_height.get(height)
            return None if slot is None else _copy.deepcopy(self._buf[slot])

    def _records_locked(self, limit: Optional[int]) -> List[dict]:
        heights = sorted(self._by_height)
        if limit is not None and limit >= 0:
            heights = heights[-limit:] if limit else []
        return [_copy.deepcopy(self._buf[self._by_height[h]]) for h in heights]

    def records(self, limit: Optional[int] = None) -> List[dict]:
        """Deep-copied records, oldest first (newest N when limit is set)."""
        with self._mtx:
            return self._records_locked(limit)

    def snapshot(self, limit: Optional[int] = None) -> dict:
        """The dump_flight RPC payload: records plus the metadata the
        cross-node merger needs.

        Everything derived — total, the record list, the evicted counter,
        and the truncated flag — is computed under ONE lock acquisition.
        The old shape (len under the lock, then records()/evicted() each
        re-locking) let a hook fire between acquisitions when the ring
        wraps mid-height, shipping a truncated flag that contradicted the
        record list next to it."""
        with self._mtx:
            total = len(self._by_height)
            live = min(self._next, self.capacity)
            assert total == live, (
                f"flight ring accounting drift: {total} indexed, {live} live"
            )
            recs = self._records_locked(limit)
            return {
                "node_id": self.node_id,
                "enabled": self.enabled,
                "capacity": self.capacity,
                "evicted": self._evicted,
                "total_records": total,
                "truncated": len(recs) < total,
                "records": recs,
            }
