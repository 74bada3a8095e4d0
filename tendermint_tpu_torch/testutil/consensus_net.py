"""An in-process net of full consensus nodes with their flight recorders
on, and a strict Chrome-trace validator for ``tools/trace_merge.merge``.

The port's copy of the reference's ``scripts/flight_smoke.py`` ``_Net`` and
``validate_chrome_trace``, with two changes that make a run deterministic
for the per-height instruments:

* every node's ``ConsensusState.now_ns`` and ``FlightRecorder.now_ns`` are
  one shared clock (``now_ns``; by default ``shared_clock()``, a wall-based
  clock that never steps back), so stamps of one node and across nodes lie
  on one timeline;
* a message of height h reaches a node only once that node has entered
  height h's round (its step has left NEW_HEIGHT) or moved past h. Without
  that gate a node whose own round-0 timeout has not fired yet takes a
  complete proposal straight from NEW_HEIGHT into prevote, never enters
  the round and so never stamps ``on_new_round``: the critical-path
  analyzer then has no start for that height and makes no waterfall (a
  property of the reference's instruments, kept in the port).

Gossip is the reference's: each node's own votes and, as the height's
proposer, its proposal and block parts are forwarded to every other node
with peer id ``node<i>``; a silenced node forwards nothing.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Callable, List, Optional

from tendermint_tpu_torch.consensus.cstypes import RoundStepType
from tendermint_tpu_torch.consensus.messages import (
    BlockPartMessage,
    ProposalMessage,
    VoteMessage,
)
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.testutil.consensus import make_cs_from_genesis, make_genesis
from tendermint_tpu_torch.types.events import (
    EVENT_COMPLETE_PROPOSAL,
    EVENT_VOTE,
    query_for_event,
)


def shared_clock() -> Callable[[], int]:
    """Wall-clock nanoseconds that never step back: the wall time at the
    call plus the monotonic time since (block times stay after genesis)."""
    base = time.time_ns() - time.monotonic_ns()
    return lambda: base + time.monotonic_ns()


def _msg_height(msg) -> int:
    if isinstance(msg, ProposalMessage):
        return msg.proposal.height
    if isinstance(msg, VoteMessage):
        return msg.vote.height
    return msg.height


class Net:
    """``n_vals`` validators of power 10, each a ``ConsensusState`` over its
    own stores and app (``testutil/consensus.make_cs_from_genesis``), with
    ``flight.node_id`` ``node<i>`` and the recorder enabled; node i's WAL
    is ``wal_factory(i)`` (default none). ``nodes`` holds (state, event
    bus, own address); ``silenced`` the indices that stop forwarding."""

    def __init__(self, n_vals: int = 4, now_ns: Optional[Callable[[], int]] = None,
                 wal_factory: Optional[Callable[[int], object]] = None):
        doc, pvs = make_genesis(n_vals)
        st = state_from_genesis(doc)
        by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
        sorted_pvs = [by_addr[v.address] for v in st.validators.validators]
        self.now_ns = now_ns or shared_clock()
        self.silenced = set()
        self.nodes = []
        self._inboxes: List["queue.Queue"] = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        for i in range(n_vals):
            wal = wal_factory(i) if wal_factory is not None else None
            cs, bus = make_cs_from_genesis(doc, sorted_pvs[i], wal=wal)
            cs.now_ns = self.now_ns
            cs.flight.now_ns = self.now_ns
            cs.flight.node_id = f"node{i}"
            cs.flight.enable()
            self.nodes.append((cs, bus, sorted_pvs[i].get_pub_key().address()))
            self._inboxes.append(queue.Queue())
        for i in range(n_vals):
            self._pump(i)
            self._spawn(self._deliver, i, f"net-deliver-{i}")

    def _spawn(self, fn, arg, name: str) -> None:
        t = threading.Thread(target=fn, args=(arg,), name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def _ready(self, cs, height: int) -> bool:
        rs = cs.rs
        return rs.height > height or (rs.height == height
                                      and rs.step != RoundStepType.NEW_HEIGHT)

    def _deliver(self, j: int) -> None:
        """Node j's inbox: each message in arrival order once node j is
        ready for its height; messages not yet ready wait, later ready
        ones pass them."""
        cs = self.nodes[j][0]
        inbox, pending = self._inboxes[j], []
        while not self._stop.is_set():
            try:
                pending.append(inbox.get(timeout=0.002))
                while True:
                    pending.append(inbox.get_nowait())
            except queue.Empty:
                pass
            keep = []
            for msg, peer in pending:
                if self._ready(cs, _msg_height(msg)):
                    cs.send_peer_msg(msg, peer)
                else:
                    keep.append((msg, peer))
            pending = keep

    def _pump(self, i: int) -> None:
        cs, bus, own_addr = self.nodes[i]
        votes = bus.subscribe(f"pump-votes-{i}", query_for_event(EVENT_VOTE), maxsize=256)
        props = bus.subscribe(f"pump-props-{i}", query_for_event(EVENT_COMPLETE_PROPOSAL),
                              maxsize=64)

        def fanout(msg):
            for j in range(len(self.nodes)):
                if j != i:
                    self._inboxes[j].put((msg, f"node{i}"))

        def vote_loop(_):
            while True:
                try:
                    ev = votes.get(timeout=0.2)
                except queue.Empty:
                    if votes.cancelled.is_set():
                        return
                    continue
                vote = ev.data.vote
                # forward only our own signatures: received votes already
                # reached everyone from their signer (loop-free gossip)
                if vote.validator_address == own_addr and i not in self.silenced:
                    fanout(VoteMessage(vote))

        def prop_loop(_):
            while True:
                try:
                    ev = props.get(timeout=0.2)
                except queue.Empty:
                    if props.cancelled.is_set():
                        return
                    continue
                rs = ev.data.round_state
                if rs is None or rs.proposal is None:
                    continue
                # only the height's proposer ships the block
                if rs.validators.get_proposer().address != own_addr or i in self.silenced:
                    continue
                fanout(ProposalMessage(rs.proposal))
                parts = rs.proposal_block_parts
                for pi in range(parts.total):
                    fanout(BlockPartMessage(rs.height, rs.round, parts.get_part(pi)))

        self._spawn(vote_loop, None, f"pump-votes-{i}")
        self._spawn(prop_loop, None, f"pump-props-{i}")

    def start(self) -> None:
        for cs, _, _ in self.nodes:
            cs.start()

    def stop(self) -> None:
        self._stop.set()
        for i, (cs, bus, _) in enumerate(self.nodes):
            for name in (f"pump-votes-{i}", f"pump-props-{i}"):
                try:
                    bus.unsubscribe_all(name)
                except Exception:
                    pass
            try:
                cs.stop()
            except Exception:
                pass
            try:
                bus.stop()
            except Exception:
                pass
        for t in self._threads:
            t.join(5.0)


def validate_chrome_trace(merged, n_nodes, min_commits_per_node):
    """Strict validation of a merged Chrome trace: every problem collected,
    not just the first (the reference's ``scripts/flight_smoke.py``)."""
    errors = []
    try:
        merged = json.loads(json.dumps(merged))
    except (TypeError, ValueError) as e:
        return [f"not JSON-serializable: {e}"]
    events = merged.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]

    named_pids = set()
    commits_by_pid = {}
    flow_starts = {}  # flow id -> start ts (ph "s")
    flow_ends = {}  # flow id -> end ts (ph "f")
    for n, ev in enumerate(events):
        where = f"event {n}"
        for key in ("name", "ph", "pid"):
            if key not in ev:
                errors.append(f"{where}: missing {key!r}")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "s", "f"):
            errors.append(f"{where}: unexpected ph {ph!r}")
            continue
        if ph == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev.get("pid"))
            if "args" not in ev or "name" not in ev["args"]:
                errors.append(f"{where}: M event without args.name")
            continue
        for key in ("tid", "ts"):
            if key not in ev:
                errors.append(f"{where}: missing {key!r}")
        if not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"{where}: non-numeric ts {ev.get('ts')!r}")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                errors.append(f"{where}: X event bad dur {ev.get('dur')!r}")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            errors.append(f"{where}: instant without scope 's'")
        if ph in ("s", "f"):
            fid = ev.get("id")
            if fid is None:
                errors.append(f"{where}: flow event without id")
                continue
            book = flow_starts if ph == "s" else flow_ends
            if fid in book:
                errors.append(f"{where}: duplicate flow {ph!r} for id {fid}")
            book[fid] = ev.get("ts")
        if ev.get("name") == "commit":
            commits_by_pid[ev["pid"]] = commits_by_pid.get(ev["pid"], 0) + 1

    # every flow id must have BOTH endpoints, and the arrow must not point
    # backward in time (trace_merge clamps finish >= start in µs space)
    for fid in sorted(set(flow_starts) | set(flow_ends)):
        if fid not in flow_starts:
            errors.append(f"flow id {fid}: finish without start (dangling)")
        elif fid not in flow_ends:
            errors.append(f"flow id {fid}: start without finish (dangling)")
        elif isinstance(flow_starts[fid], (int, float)) and isinstance(
            flow_ends[fid], (int, float)
        ) and flow_ends[fid] < flow_starts[fid]:
            errors.append(
                f"flow id {fid}: finish ts {flow_ends[fid]} before start "
                f"ts {flow_starts[fid]}"
            )

    for pid in range(n_nodes):
        if pid not in named_pids:
            errors.append(f"pid {pid}: no process_name metadata")
        got = commits_by_pid.get(pid, 0)
        if got < min_commits_per_node:
            errors.append(
                f"pid {pid}: only {got} commit instants "
                f"(need >= {min_commits_per_node})"
            )
    return errors
