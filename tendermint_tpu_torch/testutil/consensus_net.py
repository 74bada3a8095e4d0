"""In-process nets of full consensus nodes: ``make_consensus_net``, nodes
wired by ``node/verify_root`` gossiping through real switches, and
``make_joining_node``, one more node that joins such a net; ``Net``, a
deterministic net without p2p for the per-height instruments; and a strict
Chrome-trace validator for ``tools/trace_merge.merge``.

``make_consensus_net`` is the port's copy of the reference's
``tests/consensus_harness.py`` ``make_consensus_net`` (``:161-226``; the Go
harness's randConsensusNet with MakeConnectedSwitches): N validators of
power 10, each node built as a node builds one (``verify_root.mempool``,
``block_executor``, ``handshake``, ``consensus_state`` with its WAL when
``wal_dir`` is given, its ``[verify]`` vote feed and a ``NodeMetrics``),
with the node's whole reactor set (``verify_root.node_reactors``:
consensus, blockchain, mempool with its QoS gate, evidence, and state sync
when the ``[statesync]`` section asks for it) on a ``Switch``; the
validators start consensus at once (fast sync off), as the reference
harness's do. By default the switches are wired pairwise over
``socket.socketpair()`` (``p2p/test_util``'s ``make_switch`` and
``connect_switches``, as its ``make_connected_switches``);
with ``tcp=True`` each switch is ``verify_root.switch`` of a ``[p2p]``
section listening on 127.0.0.1 port 0 with the other nodes as its
``persistent_peers``, so every connection is a TCP dial, a secret
connection, the ``NodeInfo`` exchange and an ``MConnection``, as on a
localnet. ``make_joining_node`` builds a non-validator with an empty store
that restores by state sync (``[statesync] enable``) or fast-syncs from
genesis, and connects it to every running node the same way (over TCP it
dials them as persistent peers).

``Net`` follows.

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

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Callable, List, Optional

from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.consensus import consensus_test_config
from tendermint_tpu_torch.config.instrumentation import InstrumentationConfig
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.config.p2p import P2PConfig
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.metrics import NodeMetrics, StateSyncMetrics
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.p2p.conn.connection import MConnConfig
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.test_util import connect_switches, make_switch
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.state import store as sm_store

from tendermint_tpu_torch.consensus.cstypes import RoundStepType
from tendermint_tpu_torch.consensus.messages import (
    BlockPartMessage,
    ProposalMessage,
    VoteMessage,
)
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.testutil.consensus import make_cs_from_genesis, make_genesis
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.events import (
    EVENT_COMPLETE_PROPOSAL,
    EventBus,
    EVENT_VOTE,
    query_for_event,
)


# the test speed of MConnConfig.test_config() with the default keepalive: a
# 0.35 s pong deadline stops peers whenever a loaded interpreter holds a
# connection's threads that long, which is no fault of the peer
NET_MCONFIG = dataclasses.replace(MConnConfig.test_config(), ping_interval=60.0,
                                  pong_timeout=45.0)


class NetNode:
    """One node of a ``make_consensus_net`` net: its consensus state, event
    bus, consensus reactor, validator key (None: a non-validator), switch,
    ``verify_root.ConsensusRoot`` (vote feed, WAL, watchdog), ``NodeMetrics``,
    app and app connection, its whole reactor set (``reactors``, a
    ``verify_root.NodeReactors``), stores and genesis, and ``checks``, the
    heights whose LastCommit its executor checked (one verify a check)."""

    def __init__(self, root, reactor, pv, metrics, app, conn, node_key=None):
        self.root = root
        self.cs = root.consensus_state
        self.bus = root.event_bus
        self.feed = root.vote_feed
        self.reactor = reactor
        self.pv = pv
        self.metrics = metrics
        self.app = app
        self.conn = conn
        self.node_key = node_key
        self.switch = None
        self.p2p_cfg: Optional[P2PConfig] = None
        self.checks: List[int] = []
        self.reactors: Optional[verify_root.NodeReactors] = None
        self.genesis_doc = None
        self.state_db = None
        self.evidence_pool = None
        self.join_peers: List["NetNode"] = []  # a joining node's net


def build_node(i, doc, pv, cfg, verify_cfg, device, app, wal_dir, inst, sw, *,
               fast_sync: bool = False,
               statesync_cfg: Optional[StateSyncConfig] = None) -> "NetNode":
    """Node i of a net over genesis ``doc``, holding ``pv`` (None: a
    non-validator), wired by ``node/verify_root`` onto switch ``sw`` with
    the node's reactor set (``node_reactors``: ``fast_sync``, the
    ``[mempool]`` defaults, the ``[statesync]`` section ``statesync_cfg``;
    see ``make_consensus_net``)."""
    st0 = state_from_genesis(doc)
    state_db = MemDB()
    sm_store.save_state(state_db, st0)
    conn = MultiAppConn(LocalClientCreator(app))
    conn.start()
    mempool_cfg = MempoolConfig()
    mp = verify_root.mempool(mempool_cfg, conn, app, device=device).mempool
    bus = EventBus()
    bus.start()
    evpool, ex = verify_root.block_executor(state_db, MemDB(), conn, mp, st0, event_bus=bus)
    bs = BlockStore(MemDB())
    st = verify_root.handshake(state_db, st0, bs, doc, conn)
    metrics = NodeMetrics()
    wal_file = os.path.join(wal_dir, f"node{i}", "cs.wal", "wal") if wal_dir else None
    root = verify_root.consensus_state(
        cfg, verify_cfg, st, ex, bs, mp, evpool, wal_file=wal_file, event_bus=bus, priv_validator=pv,
        metrics=metrics, device=device, instrumentation=inst, node_id=sw.node_id, switch=sw,
        telemetry_metrics=metrics.telemetry)
    reactors = verify_root.node_reactors(
        sw, root.consensus_state, st, ex, bs, mp, evpool, genesis_doc=doc, proxy_app=conn,
        state_db=state_db, app=app, priv_validator=pv, fast_sync=fast_sync,
        mempool_cfg=mempool_cfg, statesync_cfg=statesync_cfg, metrics=metrics,
        statesync_metrics=StateSyncMetrics())
    node = NetNode(root, reactors.consensus, pv, metrics, app, conn, sw.transport.node_key)
    node.reactors, node.genesis_doc, node.state_db = reactors, doc, state_db
    node.evidence_pool = evpool
    real = ex.validate_block

    def validate_block(state, block, trusted_last_commit=False):
        if block.height > 1 and not trusted_last_commit:
            node.checks.append(block.height)
        return real(state, block, trusted_last_commit=trusted_last_commit)

    ex.validate_block = validate_block
    sw.metrics = metrics  # the switch's peers count their traffic in it
    node.switch = sw
    return node


# the [p2p] section of a TCP net: the defaults with the peer exchange off and
# duplicate IPs allowed, as a local testnet sets them, on 127.0.0.1 port 0
TCP_P2P = P2PConfig(laddr="tcp://127.0.0.1:0", pex=False, allow_duplicate_ip=True)


def make_consensus_net(n_vals: int, config=None, app_factory=None, *,
                       verify_cfg=None, device="cpu", wal_dir: Optional[str] = None,
                       flight: bool = False, watchdog: bool = False, tcp: bool = False,
                       start: bool = True,
                       statesync_cfg: Optional[StateSyncConfig] = None) -> List[NetNode]:
    """``n_vals`` nodes over one genesis (``make_genesis``), node i holding
    the i-th validator of the sorted set, at
    ``config`` (default the TestConsensusConfig timeouts), ``verify_cfg``'s
    vote feed on ``device`` (default the feed off: every peer vote verified
    on the host inside ``add_vote``), each node's app ``app_factory(i)``
    (default ``KVStoreApp``), WAL under ``wal_dir/node<i>`` when given, and
    the ``[instrumentation]`` flight recorder (named by the node's p2p ID,
    on) and watchdog (built, unstarted) when ``flight`` / ``watchdog``; the
    ``[mempool]`` defaults (QoS on) and ``statesync_cfg`` (default off; with
    ``snapshot_interval > 0`` an app that takes snapshots serves them) go to
    every node. Sockets: pairwise
    socketpairs with ``NET_MCONFIG``, or with ``tcp=True`` ``TCP_P2P``,
    dialing each other as persistent peers. Started unless ``start`` is
    False (then ``start_consensus_net``)."""
    cfg = config or consensus_test_config()
    doc, pvs = make_genesis(n_vals)
    st = state_from_genesis(doc)
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    sorted_pvs = [by_addr[v.address] for v in st.validators.validators]
    inst = InstrumentationConfig(flight_recorder=flight, watchdog=watchdog)
    apps = [app_factory(i) if app_factory is not None else KVStoreApp() for i in range(n_vals)]
    nodes: List[NetNode] = [None] * n_vals

    def build(i, sw):
        nodes[i] = build_node(i, doc, sorted_pvs[i], cfg, verify_cfg, device, apps[i], wal_dir,
                               inst, sw, statesync_cfg=statesync_cfg)
        return sw

    if not tcp:
        for i in range(n_vals):
            make_switch(i, network=doc.chain_id, init_switch=build, mconfig=NET_MCONFIG)
        if start:
            start_consensus_net(nodes)
        return nodes
    for i in range(n_vals):
        build(i, verify_root.switch(TCP_P2P, NodeKey(PrivKeyEd25519.generate()), doc.chain_id,
                                    moniker=f"node{i}"))
    addrs = [str(verify_root.listen(node.switch, TCP_P2P)) for node in nodes]
    for i, node in enumerate(nodes):
        node.p2p_cfg = dataclasses.replace(
            TCP_P2P, persistent_peers=",".join(a for j, a in enumerate(addrs) if j != i))
    if start:
        start_consensus_net(nodes)
    return nodes


def start_consensus_net(nodes: List[NetNode]) -> None:
    """Start an unstarted net: each switch (its reactors start; the
    consensus reactor starts the state machine), then the connections: over
    TCP each node dials its persistent peers; otherwise every pair is wired
    over a socketpair, as ``p2p/test_util.make_connected_switches`` wires its
    switches."""
    if nodes[0].p2p_cfg is not None:
        for node in nodes:
            verify_root.start_switch(node.switch, node.p2p_cfg)
        return
    for node in nodes:
        node.switch.start()
    for i in range(len(nodes)):
        for j in range(i + 1, len(nodes)):
            connect_switches(nodes[i].switch, nodes[j].switch)


def make_joining_node(nodes: List[NetNode], app, *, config=None, verify_cfg=None,
                      device="cpu", statesync_cfg: Optional[StateSyncConfig] = None,
                      wal_dir: Optional[str] = None, start: bool = True) -> NetNode:
    """One more node for the running net ``nodes``: a non-validator over the
    net's genesis with an empty store and ``app``, built as ``build_node``
    builds one (index ``len(nodes)``), that restores a snapshot when
    ``statesync_cfg.enable`` (then fast-syncs and switches to consensus) or
    else fast-syncs from genesis; its flight recorder is off. Over TCP (the net's
    ``p2p_cfg``) it listens on ``TCP_P2P`` and dials every node of ``nodes``
    as a persistent peer (they do not dial it); otherwise it is wired to
    each over a socketpair. Started (and connected) unless ``start`` is False
    (then ``start_joining_node``)."""
    cfg = config or consensus_test_config()
    i = len(nodes)
    doc = nodes[0].genesis_doc
    inst = InstrumentationConfig(flight_recorder=False, watchdog=False)
    kw = dict(fast_sync=True, statesync_cfg=statesync_cfg)
    if nodes[0].p2p_cfg is None:
        built = {}

        def build(_, sw):
            built["n"] = build_node(i, doc, None, cfg, verify_cfg, device, app, wal_dir, inst,
                                    sw, **kw)
            return sw

        make_switch(i, network=doc.chain_id, init_switch=build, mconfig=NET_MCONFIG)
        node = built["n"]
    else:
        sw = verify_root.switch(TCP_P2P, NodeKey(PrivKeyEd25519.generate()), doc.chain_id,
                                moniker=f"node{i}")
        node = build_node(i, doc, None, cfg, verify_cfg, device, app, wal_dir, inst, sw, **kw)
        verify_root.listen(sw, TCP_P2P)
        node.p2p_cfg = dataclasses.replace(
            TCP_P2P, persistent_peers=",".join(str(n.switch.transport.listen_address)
                                               for n in nodes))
    node.join_peers = list(nodes)
    if start:
        start_joining_node(node)
    return node


def start_joining_node(node: NetNode) -> None:
    """Start a ``make_joining_node`` node and connect it to its net."""
    if node.p2p_cfg is not None:
        verify_root.start_switch(node.switch, node.p2p_cfg)
        return
    node.switch.start()
    for other in node.join_peers:
        connect_switches(other.switch, node.switch)


def duplicate_vote_evidence(nodes: List[NetNode], offender: int, height: int,
                            timestamp_ns: Optional[int] = None) -> DuplicateVoteEvidence:
    """Validator ``offender``'s double sign at ``height``: two round-0
    prevotes for two made-up blocks, signed with its key (the reference's
    ``tests/test_gossip_reactors.py:75``), stamped ``timestamp_ns``
    (default now)."""
    pv = nodes[offender].pv
    addr = pv.get_pub_key().address()
    idx, _ = nodes[0].cs.get_state().validators.get_by_address(addr)
    ts = time.time_ns() if timestamp_ns is None else timestamp_ns
    chain_id = nodes[0].genesis_doc.chain_id
    votes = [pv.sign_vote(chain_id, Vote(
        vote_type=SignedMsgType.PREVOTE, height=height, round=0, timestamp_ns=ts,
        block_id=BlockID(hash=h, parts_header=PartSetHeader(1, b"\x33" * 32)),
        validator_address=addr, validator_index=idx)) for h in (b"\x11" * 32, b"\x22" * 32)]
    return DuplicateVoteEvidence(pub_key=pv.get_pub_key(), vote_a=votes[0], vote_b=votes[1])


def committed_in(node: NetNode, pred) -> Optional[int]:
    """The height of the first block in ``node``'s store (from its base)
    holding a tx or an evidence for which ``pred(item)`` holds, else None."""
    bs = node.cs.block_store
    for h in range(max(1, bs.base()), bs.height() + 1):
        block = bs.load_block(h)
        if block is None:
            continue
        if any(pred(bytes(t)) for t in block.data.txs) or any(
                pred(ev) for ev in block.evidence.evidence):
            return h
    return None


def stop_consensus_net(nodes: List[NetNode], timeout: float = 30.0) -> None:
    """Stop every switch (which stops its reactor and with it the state
    machine), wait for each receive routine, close the vote feeds, the app
    connections and the event buses."""
    for node in nodes:
        if node is None:
            continue
        if node.root.watchdog is not None:
            node.root.watchdog.stop()
        if node.switch is not None and node.switch.is_running:
            node.switch.stop()
        if node.cs.is_running:
            node.cs.stop()
    for node in nodes:
        if node is None:
            continue
        if node.cs._started:
            node.cs._done.wait(timeout)
        if node.feed is not None:
            node.feed.close()
            node.feed.join(timeout)
        node.conn.stop()
        if node.bus.is_running:
            node.bus.stop()


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
