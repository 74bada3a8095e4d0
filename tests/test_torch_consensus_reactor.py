"""The consensus reactor (``consensus/reactor.py``) over the port's switches:
N full nodes, each wired by ``node/verify_root`` (``testutil/consensus_net``),
gossiping proposals, block parts and votes.

* The reference's ``tests/test_consensus_reactor.py`` restated on the port's
  net, on the host verifier with the vote feed off as the reference's conftest
  runs its own: identical blocks, new-block events, a voting-power change
  mid-run, double-signed votes becoming evidence while the net lives; and the
  same net dialing over TCP (``verify_root.switch`` / ``start_switch``).
* The vote feed on, over the kernels' plain versions (``dispatch_deadline=0``):
  4 nodes, 2 heights.
* A mixed net, 2 port nodes and 2 reference nodes, committing the same blocks:
  the wire is one protocol.
* The device-fault contract on a faked card: one node's flush fails (that node
  halts, no peer is stopped, the other three commit on); the shared guarded
  verifier fails (every node that dispatches after its breaker opens halts:
  the net stops).
* The flight recorder's gossip stamps (``on_vote_send`` / ``on_vote_arrival``)
  on the port's net and the reference's, with the same structure: journeys per
  validator, ledger links per peer pair.
* The watchdog names the switch's peers; the reactor's channels are the
  reference's; ``switch_to_consensus`` starts a deferred state machine.

Every wait has a deadline; sockets are socketpairs or bind port 0.
"""

import base64
import dataclasses
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu.consensus.reactor import ConsensusReactor as RConsensusReactor
from tendermint_tpu.libs import quorumtrace as r_qt
from tendermint_tpu.p2p import test_util as r_tu
from tendermint_tpu.p2p.conn.connection import MConnConfig as RMConnConfig
from tendermint_tpu.state.state_types import state_from_genesis as r_state
from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp, PersistentKVStoreApp
from tendermint_tpu_torch.config.consensus import consensus_test_config
from tendermint_tpu_torch.config.instrumentation import InstrumentationConfig
from tendermint_tpu_torch.config.p2p import P2PConfig
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.consensus import reactor as p_reactor
from tendermint_tpu_torch.consensus.messages import (
    VoteMessage,
    VoteSetMaj23Message,
    encode_msg,
    unmarshal_msg,
)
from tendermint_tpu_torch.consensus.reactor import VOTE_CHANNEL, ConsensusReactor
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs import quorumtrace as qt
from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.test_util import connect_switches, make_switch
from tendermint_tpu_torch.state.state_types import state_from_genesis as p_state
from tendermint_tpu_torch.testutil import chain as tchain
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.testutil import consensus_net as cn
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.events import EVENT_NEW_BLOCK, query_for_event
from tendermint_tpu_torch.types.vote import Vote

from tests import consensus_harness as r_harness
from tests.test_torch_consensus_fault import at_height
from tests.test_torch_fastsync_fault import guarded
from tests.test_torch_p2p import _connect_across

DEADLINE = 60.0


@pytest.fixture(autouse=True)
def _host_verifier():
    """The port's installed verifier on the host, as the reference's conftest
    installs the reference's."""
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())
    yield
    verify_root.reset_verify()


def _wait_all_heights(nodes, height, timeout=DEADLINE):
    return harness.wait_for(lambda: all(n.cs.get_round_state().height >= height for n in nodes),
                            timeout=timeout, interval=0.05)


def _stopped_peers(nodes):
    """Record every peer the nodes' switches stop for an error (a call for a
    peer object the set no longer holds stops nothing and is not counted)."""
    stopped = []
    for n in nodes:
        sw, real = n.switch, n.switch.stop_peer_for_error

        def record(peer, reason, sw=sw, real=real):
            if sw.peers.get(peer.id) is peer:
                stopped.append((peer.id, str(reason)))
            return real(peer, reason)

        sw.stop_peer_for_error = record
    return stopped


# ---------------------------------------------------------------------------
# The reference's tests/test_consensus_reactor.py on the port's net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tcp", [False, True], ids=["socketpair", "tcp"])
def test_4_node_net_commits_blocks(tcp):
    nodes = cn.make_consensus_net(4, tcp=tcp)
    try:
        assert _wait_all_heights(nodes, 4), [n.cs.get_round_state().height for n in nodes]
        assert len({n.cs.block_store.load_block(2).hash() for n in nodes}) == 1
        metas = [n.cs.block_store.load_block_meta(3) for n in nodes]
        assert all(m is not None for m in metas)
        assert len({m.header.app_hash for m in metas}) == 1
        assert all(n.switch.peers.size() == 3 for n in nodes)
        if tcp:
            # every connection a dial over the [p2p] section's transport
            assert all(n.p2p_cfg.persistent_peers.count("@") == 3 for n in nodes)
            assert all(p.socket_addr.host == "127.0.0.1" for n in nodes
                       for p in n.switch.peers.list())
    finally:
        cn.stop_consensus_net(nodes)


def test_net_emits_new_block_events():
    nodes = cn.make_consensus_net(4, start=False)
    subs = [n.bus.subscribe(f"test-{i}", query_for_event(EVENT_NEW_BLOCK))
            for i, n in enumerate(nodes)]
    cn.start_consensus_net(nodes)
    try:
        for sub in subs:
            assert sub.get(timeout=DEADLINE).data.block.height >= 1
    finally:
        cn.stop_consensus_net(nodes)


def test_voting_power_change_mid_run():
    nodes = cn.make_consensus_net(4, app_factory=lambda i: PersistentKVStoreApp())
    try:
        assert _wait_all_heights(nodes, 2)
        target = nodes[1].pv.get_pub_key()
        nodes[0].cs.mempool.check_tx(b"val:" + base64.b64encode(target.bytes()) + b"!25")

        def power_updated():
            for n in nodes:
                _, val = n.cs.get_state().validators.get_by_address(target.address())
                if val is None or val.voting_power != 25:
                    return False
            return True

        assert harness.wait_for(power_updated, timeout=DEADLINE, interval=0.05)
        h = max(n.cs.get_round_state().height for n in nodes)
        assert _wait_all_heights(nodes, h + 2)
    finally:
        cn.stop_consensus_net(nodes)


def test_double_signed_votes_become_evidence_and_net_lives():
    nodes = cn.make_consensus_net(4)
    byz, honest = nodes[0], nodes[1]
    added = []
    real_add = honest.cs.evpool.add_evidence

    def add_evidence(ev):
        added.append(ev)
        return real_add(ev)

    honest.cs.evpool.add_evidence = add_evidence
    try:
        assert _wait_all_heights(nodes, 2)
        byz_peer = honest.switch.peers.get(byz.switch.node_id)
        assert byz_peer is not None

        def inject():
            rs = honest.cs.get_round_state()
            idx, _ = rs.validators.get_by_address(byz.pv.get_pub_key().address())
            for hh in (b"\xaa" * 32, b"\xbb" * 32):
                vote = Vote(vote_type=SignedMsgType.PREVOTE, height=rs.height, round=rs.round,
                            timestamp_ns=time.time_ns(),
                            block_id=BlockID(hash=hh, parts_header=PartSetHeader(1, b"\xcc" * 32)),
                            validator_address=byz.pv.get_pub_key().address(),
                            validator_index=idx)
                signed = byz.pv.sign_vote(byz.cs.state.chain_id, vote)
                honest.reactor.receive(VOTE_CHANNEL, byz_peer, encode_msg(VoteMessage(signed)))

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not added:
            inject()
            harness.wait_for(lambda: bool(added), timeout=1.0)
        assert added, "the honest node never recorded DuplicateVoteEvidence"
        assert added[0].vote_a.height == added[0].vote_b.height
        h = max(n.cs.get_round_state().height for n in nodes)
        assert _wait_all_heights(nodes, h + 2)
    finally:
        cn.stop_consensus_net(nodes)


class _OnePeer:
    """A peer that records what the maj23 routine sends it, and stops after
    the first send or the third pass."""

    id = "peer-behind"

    def __init__(self):
        self.sent, self.passes = [], 0

    @property
    def is_running(self):
        self.passes += 1
        return not self.sent and self.passes <= 3

    def try_send(self, chan_id, msg_bytes):
        self.sent.append((chan_id, unmarshal_msg(msg_bytes)))
        return True


def test_the_catchup_maj23_reads_the_seen_commit_at_the_top_height():
    """A peer one height behind hears that the block it lacks had +2/3: at
    the store's top height from the seen commit (Go's LoadCommit), below it
    from the next block's LastCommit. The reference reads the next block's
    only, which the top height does not have yet."""
    fx = tchain.build_chain(n_vals=4, n_heights=3, verifier=tbatch.HostBatchVerifier())
    bs = fx.block_store
    assert bs.height() == 3 and bs.load_block_commit(3) is None
    cs = SimpleNamespace(block_store=bs, config=SimpleNamespace(peer_query_maj23_sleep_duration=0.0),
                         get_round_state=lambda: SimpleNamespace(height=4, votes=None))
    reactor = SimpleNamespace(cons=cs, is_running=True)
    reactor._load_commit = lambda h: ConsensusReactor._load_commit(reactor, h)
    assert reactor._load_commit(3) == bs.load_seen_commit(3)
    assert reactor._load_commit(2) == bs.load_block_commit(2)
    for h in (3, 2):
        peer = _OnePeer()
        ps = p_reactor.PeerState(peer)
        ps.prs.height = h
        ConsensusReactor._query_maj23_routine(reactor, peer, ps)
        want = reactor._load_commit(h)
        assert peer.sent == [(p_reactor.STATE_CHANNEL, VoteSetMaj23Message(
            h, want.round(), int(SignedMsgType.PRECOMMIT), want.block_id))]


# ---------------------------------------------------------------------------
# The vote feed on the kernels' plain versions
# ---------------------------------------------------------------------------


class _Serialized:
    """The root's guarded verifier, one call at a time: the plain versions
    are thousands of small torch ops, each of which gives up the interpreter
    lock, and four concurrent callers on one CPU interpreter take many times
    as long as the same calls one after the other."""

    def __init__(self, verifier):
        self.verifier, self.calls, self._mtx = verifier, 0, threading.Lock()

    def __getattr__(self, name):
        return getattr(self.verifier, name)

    def verify_ed25519_raw(self, pubs, msgs, sigs):
        with self._mtx:
            self.calls += 1
            return self.verifier.verify_ed25519_raw(pubs, msgs, sigs)

    def verify_ed25519(self, items):
        with self._mtx:
            self.calls += 1
            return self.verifier.verify_ed25519(items)


def test_vote_feed_on_the_plain_versions_commits_two_heights():
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())  # LastCommit checks on the host
    # rounds that outlast a plain flush, and the default gossip cadence (a
    # 5 ms cadence keeps 36 gossip threads on the interpreter lock)
    cfg = dataclasses.replace(consensus_test_config(), timeout_propose=30.0, timeout_prevote=30.0,
                              timeout_precommit=30.0, peer_gossip_sleep_duration=0.1,
                              peer_query_maj23_sleep_duration=2.0)
    # a 1 s vote window: a plain flush costs about 1.4 s whatever its size,
    # and with a 2 ms window the duplicates gossiped while a vote waits its
    # verdict doubled the votes submitted and slowed each serialized flush
    # to 4-13 s (158 s alone for the two heights); the quorum-completing
    # vote still flushes at once (urgent)
    nodes = cn.make_consensus_net(4, config=cfg, start=False,
                                  verify_cfg=VerifyConfig(vote_batch_window_ms=1000.0))
    plain = _Serialized(root.verifier)
    for n in nodes:
        assert n.feed is not None and n.cs._vote_feed is n.feed
        n.feed.verifier = plain  # on the CPU the feed would default to the host RLC
    stopped = _stopped_peers(nodes)
    cn.start_consensus_net(nodes)
    try:
        assert harness.wait_for(lambda: all(n.cs.block_store.height() >= 2 for n in nodes),
                                timeout=150.0, interval=0.05), [
            n.cs.block_store.height() for n in nodes]
        for h in (1, 2):
            assert len({n.cs.block_store.load_block(h).hash() for n in nodes}) == 1
        assert all(n.feed.dispatches > 0 and n.feed.votes_in > 0 for n in nodes)
        assert all(n.cs.device_fault is None for n in nodes) and not stopped
    finally:
        cn.stop_consensus_net(nodes)
    # every flush went to the plain versions: one call a flush (one
    # message-length group), none failed its audit
    assert plain.calls == sum(n.feed.dispatches for n in nodes)
    assert root.verifier.snapshot()["audit_mismatches"] == 0


# ---------------------------------------------------------------------------
# A mixed net: two port nodes and two reference nodes
# ---------------------------------------------------------------------------


def _ref_node(i, doc, pv):
    cs, bus = r_harness.make_cs_from_genesis(doc, pv)
    reactor = RConsensusReactor(cs)
    sw = r_tu.make_switch(i, network=doc.chain_id,
                          init_switch=lambda _, s: s.add_reactor("consensus", reactor) and s,
                          mconfig=RMConnConfig(**dataclasses.asdict(cn.NET_MCONFIG)))
    node = r_harness.NetNode(cs, bus, reactor, pv)
    node.switch = sw
    return node


def test_mixed_net_commits_the_same_blocks():
    pdoc, ppvs = harness.make_genesis(4)
    rdoc, rpvs = r_harness.make_genesis(4)
    assert pdoc.chain_id == rdoc.chain_id
    p_order = [v.address for v in p_state(pdoc).validators.validators]
    assert p_order == [v.address for v in r_state(rdoc).validators.validators]
    p_by = {pv.get_pub_key().address(): pv for pv in ppvs}
    r_by = {pv.get_pub_key().address(): pv for pv in rpvs}
    port = []
    for i in (0, 2):
        built = {}

        def init(_, s, i=i, built=built):
            built["n"] = cn.build_node(i, pdoc, p_by[p_order[i]], consensus_test_config(), None,
                                       "cpu", KVStoreApp(), None, InstrumentationConfig(
                                           watchdog=False), s)
            return s

        make_switch(i, network=pdoc.chain_id, init_switch=init, mconfig=cn.NET_MCONFIG)
        port.append(built["n"])
    ref = [_ref_node(i, rdoc, r_by[p_order[i]]) for i in (1, 3)]
    nodes = [port[0], ref[0], port[1], ref[1]]
    for n in nodes:
        n.switch.start()
    try:
        connect_switches(port[0].switch, port[1].switch)
        r_tu.connect_switches(ref[0].switch, ref[1].switch)
        for p in port:
            for r in ref:
                _connect_across(p.switch, r.switch)
        # every connection up and every reactor holding its peers' states, then
        # each node announces its round step once more: the reference's reactor
        # makes a peer's state in add_peer, after its switch started the peer,
        # and drops a NewRoundStep that arrives in between; a node that reached
        # a step with no timeout (prevote, +2/3 of any votes awaited) before the
        # connections came up announces nothing else, and the net stalls at
        # height 0 (every run does when that window is widened by 0.3 s)
        assert harness.wait_for(lambda: all(
            n.switch.peers.size() == 3
            and all(n.reactor.peer_state(p.id) is not None for p in n.switch.peers.list())
            for n in nodes), timeout=DEADLINE, interval=0.05)
        for n in nodes:
            n.reactor._broadcast_new_round_step(n.cs.get_round_state())
        assert harness.wait_for(lambda: all(n.cs.block_store.height() >= 4 for n in nodes),
                                timeout=DEADLINE, interval=0.05), [
            n.cs.block_store.height() for n in nodes]
        for h in range(1, 5):
            blocks = [n.cs.block_store.load_block(h) for n in nodes]
            assert len({b.hash() for b in blocks}) == 1, h
            # the header's app hash is the app's state after the height before
            assert len({b.header.app_hash for b in blocks}) == 1, h
        assert all(n.switch.peers.size() == 3 for n in nodes)
    finally:
        cn.stop_consensus_net(port)
        r_harness.stop_consensus_net(ref)


# ---------------------------------------------------------------------------
# The device-fault contract on a faked card
# ---------------------------------------------------------------------------


def _on_the_card(feed, verifier):
    feed.verifier = verifier
    feed.device = torch.device("cuda")  # the guarded verifier's device is CUDA too
    assert brk.on_card(feed)


def test_one_nodes_failed_flush_halts_it_and_the_others_commit_on():
    nodes = cn.make_consensus_net(4, start=False, verify_cfg=VerifyConfig(vote_batch_window_ms=2.0))
    victim = nodes[0]
    _on_the_card(victim.feed, guarded("raise", at_height(2)))
    stopped = _stopped_peers(nodes)
    cn.start_consensus_net(nodes)
    try:
        assert victim.cs._done.wait(DEADLINE), "the node did not halt"
        assert isinstance(victim.cs.device_fault, brk.DeviceDispatchError)
        assert victim.cs.block_store.height() == 1
        others = nodes[1:]  # 30 of 40 power: above 2/3
        assert harness.wait_for(lambda: all(n.cs.block_store.height() >= 4 for n in others),
                                timeout=DEADLINE, interval=0.05)
        assert len({n.cs.block_store.load_block(4).hash() for n in others}) == 1
        assert victim.cs.block_store.height() == 1 and victim.cs.get_state().last_block_height == 1
        assert all(n.cs.device_fault is None for n in others)
        assert not stopped and all(n.switch.peers.size() == 3 for n in nodes)
    finally:
        cn.stop_consensus_net(nodes)


def test_a_fault_in_the_shared_guarded_verifier_stops_the_net():
    """The four nodes share the process's guarded verifier and its breaker:
    the first failed dispatch (a flush of height-2 votes) opens it, and every
    node's next dispatch (a flush or a LastCommit check) raises on the card,
    so each node that dispatches after that halts at height 2, with the
    flush's error or with breaker_open (a node whose own flush failed may
    meet the open breaker in a LastCommit check before its pump takes the
    flush's error). Once more than a third of the power has halted, no
    quorum can form: a node that had nothing left to dispatch stays up at
    height 2 without a fault, and the net commits nothing more."""
    nodes = []

    def height_two_once_all_stored_one(msgs):
        # a height-2 batch fails once every node has stored height 1: under
        # load a node may still be finishing height 1 when the first
        # height-2 flush comes, and meeting the open breaker there it would
        # halt at height 1. No node commits height 2 while this waits: that
        # takes a height-2 flush, and each one waits here.
        if not at_height(2)(msgs):
            return False
        harness.wait_for(lambda: all(n.cs.block_store.height() >= 1 for n in nodes),
                         timeout=DEADLINE, interval=0.01)
        return True

    shared = guarded("raise", height_two_once_all_stored_one)
    failed, real = [], shared.device.verify_ed25519_raw

    def counted(pubs, msgs, sigs):
        try:
            return real(pubs, msgs, sigs)
        except RuntimeError:
            failed.append(len(pubs))
            raise

    shared.device.verify_ed25519_raw = counted
    tbatch.set_batch_verifier(shared)
    nodes += cn.make_consensus_net(4, start=False, verify_cfg=VerifyConfig(vote_batch_window_ms=2.0))
    for n in nodes:
        _on_the_card(n.feed, shared)
    stopped = _stopped_peers(nodes)
    cn.start_consensus_net(nodes)
    try:
        assert harness.wait_for(lambda: sum(n.cs.device_fault is not None for n in nodes) >= 2,
                                timeout=DEADLINE, interval=0.05), [
            (n.cs.get_round_state().height, n.cs.device_fault) for n in nodes]
        time.sleep(1.0)  # what could still dispatch has dispatched
        halted = [n for n in nodes if n.cs.device_fault is not None]
        live = [n for n in nodes if n.cs.device_fault is None]
        assert all(n.cs._done.wait(DEADLINE) for n in halted)
        assert all(isinstance(n.cs.device_fault, brk.DeviceDispatchError) for n in halted)
        assert {n.cs.device_fault.reason for n in halted} <= {"error", "breaker_open"}
        # the device failed (a probe after the breaker's backoff may close
        # it again: the next height-2 dispatch fails and opens it anew)
        assert failed
        # more than 1/3 of the power halted: the rest stay at height 2
        assert 10 * len(halted) > 40 / 3
        assert all(n.cs.get_round_state().height == 2 for n in live)
        assert all(n.cs.block_store.height() == 1 for n in nodes)
        assert not stopped and all(n.switch.peers.size() == 3 for n in nodes)
    finally:
        cn.stop_consensus_net(nodes)


# ---------------------------------------------------------------------------
# The flight recorder's gossip stamps
# ---------------------------------------------------------------------------

CHECKED = (1, 2, 3)


def _gossip_structure(nodes, build_journeys, gossip_ledger):
    """What the dumps say per validator and per peer pair, by node index."""
    ids = [n.switch.node_id for n in nodes]
    idx = {nid: i for i, nid in enumerate(ids)}
    dumps = [n.cs.flight.snapshot() for n in nodes]
    journeys = {(j["height"], j["kind"], j["validator_index"]): j
                for j in build_journeys(dumps) if j["height"] in CHECKED}
    ledger = gossip_ledger(dumps)
    out = {"keys": set(), "origins": {}, "sent": {}, "arrivals": {},
           "links": {(idx.get(lk["peer"]), idx[lk["node"]]) for lk in ledger["links"]
                     if lk["first_sightings"] > 0},
           "link_keys": {tuple(sorted(lk)) for lk in ledger["links"]}}
    for key, j in journeys.items():
        out["keys"].add(tuple(sorted(j)))
        out["origins"][key] = idx.get(j["origin"])
        if j["first_send"] is not None:
            out["sent"][key] = idx[j["first_send"]["peer"]]
        for node, mark in j["arrivals"].items():
            out["arrivals"].setdefault((key[0], key[1], idx[node]), set()).add(idx[mark["peer"]])
    return out


def _check_gossip(s, n=4):
    assert len(s["keys"]) == 1  # one journey schema
    # links join two nodes of the net; each node took first sightings from
    # two peers at least and gave them to two (which peer is first is a race)
    assert all(p is not None and p != q for p, q in s["links"]), s["links"]
    for i in range(n):
        assert sum(1 for p, q in s["links"] if q == i) >= 2, s["links"]
        assert sum(1 for p, q in s["links"] if p == i) >= 2, s["links"]
    for h in CHECKED:
        for kind in ("prevote", "precommit"):
            # validator v's vote was signed on node v, and first sent to a peer
            signed = [v for v in range(n) if s["origins"].get((h, kind, v)) == v]
            assert len(signed) >= 3, (h, kind, s["origins"])
            sent = [v for v in signed if (h, kind, v) in s["sent"]]
            assert len(sent) >= 3, (h, kind)
            assert all(s["sent"][(h, kind, v)] != v for v in sent)
        for node in range(n):
            # a node commits with its own precommit and two others' at least
            got = s["arrivals"].get((h, "precommit", node), set())
            assert got and node not in got and got <= set(range(n)), (h, node, got)


def test_gossip_stamps_on_the_port_and_the_reference(monkeypatch):
    nodes = cn.make_consensus_net(4, flight=True)
    try:
        assert all(n.cs.flight.enabled and n.cs.flight.node_id == n.switch.node_id for n in nodes)
        assert _wait_all_heights(nodes, max(CHECKED) + 2)
        ours = _gossip_structure(nodes, qt.build_journeys, qt.gossip_ledger)
    finally:
        cn.stop_consensus_net(nodes)
    _check_gossip(ours)

    monkeypatch.setenv("TM_FLIGHT", "1")
    rnodes = r_harness.make_consensus_net(4)
    try:
        for n in rnodes:
            n.cs.flight.node_id = n.switch.node_id
        assert _wait_all_heights(rnodes, max(CHECKED) + 2)
        theirs = _gossip_structure(rnodes, r_qt.build_journeys, r_qt.gossip_ledger)
    finally:
        r_harness.stop_consensus_net(rnodes)
    _check_gossip(theirs)
    # the same schema: journeys keyed per validator, links per peer pair
    assert ours["keys"] == theirs["keys"] and ours["link_keys"] == theirs["link_keys"]
    assert {k[:2] for k in ours["origins"]} == {k[:2] for k in theirs["origins"]}


def test_vote_sightings_are_counted_by_peer():
    nodes = cn.make_consensus_net(4)
    try:
        assert _wait_all_heights(nodes, 3)
        for n in nodes:
            peers = {p.id for p in n.switch.peers.list()}
            first = n.metrics.vote_first_sighting._values
            assert first and {labels[0] for labels in first} <= peers
            assert {labels[1] for labels in first} == {"0x22"}
    finally:
        cn.stop_consensus_net(nodes)


# ---------------------------------------------------------------------------
# Wiring
# ---------------------------------------------------------------------------


def test_the_watchdog_names_the_switchs_peers():
    nodes = cn.make_consensus_net(4, watchdog=True)
    try:
        assert _wait_all_heights(nodes, 2)
        wd = nodes[0].root.watchdog
        assert wd is not None and wd.switch is nodes[0].switch
        report = wd._build_report(10.0, 1.0)
        assert {p["id"] for p in report["peers"]} == {n.switch.node_id for n in nodes[1:]}
        assert all(p["last_recv_age_seconds"] is not None for p in report["peers"])
    finally:
        cn.stop_consensus_net(nodes)


def test_reactor_channels_equal_the_references():
    doc, pvs = harness.make_genesis(1)
    cs, bus = harness.make_cs_from_genesis(doc, pvs[0])
    rdoc, rpvs = r_harness.make_genesis(1)
    rcs, rbus = r_harness.make_cs_from_genesis(rdoc, rpvs[0])
    try:
        ours = [dataclasses.astuple(d) for d in ConsensusReactor(cs).get_channels()]
        theirs = [dataclasses.astuple(d) for d in RConsensusReactor(rcs).get_channels()]
        assert ours == theirs
        assert (p_reactor.STATE_CHANNEL, p_reactor.DATA_CHANNEL, p_reactor.VOTE_CHANNEL,
                p_reactor.VOTE_SET_BITS_CHANNEL, p_reactor.MAX_MSG_SIZE) == (
            0x20, 0x21, 0x22, 0x23, 1024 * 1024)
    finally:
        bus.stop(), rbus.stop()


def test_verify_root_switch_applies_the_p2p_section():
    cfg = P2PConfig(laddr="tcp://127.0.0.1:0", pex=False, allow_duplicate_ip=True,
                    flush_throttle_timeout=0.05, send_rate=1000, recv_rate=2000,
                    max_packet_msg_payload_size=512, handshake_timeout=7.0, dial_timeout=2.0,
                    max_num_inbound_peers=3, max_num_outbound_peers=2)
    doc, pvs = harness.make_genesis(1)
    cs, bus = harness.make_cs_from_genesis(doc, pvs[0])
    nk = NodeKey(PrivKeyEd25519.generate())
    metrics = NodeMetrics()
    try:
        sw = verify_root.switch(cfg, nk, doc.chain_id, metrics=metrics, moniker="m")
        reactor = verify_root.consensus_reactor(cs)
        verify_root.add_reactor(sw, "consensus", reactor)
        ni = sw.transport.node_info
        assert ni.id == nk.id() and ni.network == doc.chain_id and ni.moniker == "m"
        assert ni.channels == bytes([0x20, 0x21, 0x22, 0x23])
        m = sw.mconfig
        assert (m.send_rate, m.recv_rate, m.max_packet_msg_payload_size, m.flush_throttle) == (
            1000, 2000, 512, 0.05)
        assert (sw.transport.handshake_timeout, sw.transport.dial_timeout) == (7.0, 2.0)
        assert (sw.config.max_num_inbound_peers, sw.config.max_num_outbound_peers,
                sw.config.allow_duplicate_ip) == (3, 2, True)
        assert sw.metrics is metrics and reactor.switch is sw and reactor.cons is cs
        addr = verify_root.listen(sw, cfg)
        assert addr.port > 0 and sw.transport.node_info.listen_addr == f"127.0.0.1:{addr.port}"
        sw.transport.stop()
        # the [p2p] defaults (pex on) build too: the exchange is a reactor
        # of its own
        assert verify_root.switch(P2PConfig(), nk, doc.chain_id).transport.node_info.id == nk.id()
    finally:
        bus.stop()


def test_switch_to_consensus_starts_a_deferred_state_machine():
    doc, pvs = harness.make_genesis(1)
    cs, bus = harness.make_cs_from_genesis(doc, pvs[0])
    reactor = verify_root.consensus_reactor(cs, fast_sync=True)
    sw = make_switch(0, network=doc.chain_id,
                     init_switch=lambda _, s: s.add_reactor("consensus", reactor) and s)
    sw.start()
    try:
        assert reactor.is_running and reactor.fast_sync and not cs.is_running
        reactor.switch_to_consensus(cs.get_state(), blocks_synced=0)
        assert not reactor.fast_sync and cs.is_running
        assert harness.wait_for(lambda: cs.block_store.height() >= 2, DEADLINE)
    finally:
        sw.stop()
        assert cs._done.wait(DEADLINE)
        bus.stop()


def test_a_node_metrics_spool_writes_its_own_telemetry_family(tmp_path):
    """Given the node's NodeMetrics and its attached telemetry family, the
    spool writes that family: each telemetry series is exposed once."""
    doc, pvs = harness.make_genesis(1)
    cs, bus = harness.make_cs_from_genesis(doc, pvs[0])
    metrics = NodeMetrics()
    try:
        root = verify_root.consensus_state(
            consensus_test_config(), None, cs.state, cs.block_exec, cs.block_store, cs.mempool,
            cs.evpool, event_bus=bus, metrics=metrics, device="cpu", root_dir=str(tmp_path),
            telemetry_metrics=metrics.telemetry,
            instrumentation=InstrumentationConfig(telemetry_spool=True, watchdog=False))
        assert root.telemetry_spool.metrics is metrics.telemetry
        text = metrics.registry.expose_text()
        assert text.count("# TYPE tendermint_telemetry_snapshots_total ") == 1
        assert text.count("# TYPE tendermint_consensus_rounds ") == 1
    finally:
        bus.stop()


class _FakePeer:
    """A peer the reactor can hold: never running, so no gossip routine
    loops on it; it records what is sent."""

    is_running = False

    def __init__(self, peer_id):
        self.id, self.sent = peer_id, []

    def send(self, chan_id, msg):
        self.sent.append((chan_id, msg))
        return True

    try_send = send


def test_a_round_step_before_add_peer_is_kept():
    """A peer's first NewRoundStep can arrive between the switch starting
    the peer and ``add_peer``. The port's reactor made the peer's state in
    ``init_peer`` (Go's InitPeer) and keeps the step; the reference's drops
    it, and a node that never hears the step again believes the peer at
    height 0 and gossips it nothing (a 4-node net stuck at height 1)."""
    from tendermint_tpu.consensus.messages import NewRoundStepMessage as RNewRoundStep
    from tendermint_tpu.consensus.messages import encode_msg as r_encode
    from tendermint_tpu.consensus.reactor import STATE_CHANNEL as R_STATE
    from tendermint_tpu_torch.consensus.messages import NewRoundStepMessage

    doc, pvs = harness.make_genesis(1)
    cs, bus = harness.make_cs_from_genesis(doc, pvs[0])
    rdoc, rpvs = r_harness.make_genesis(1)
    rcs, rbus = r_harness.make_cs_from_genesis(rdoc, rpvs[0])
    ours, theirs = ConsensusReactor(cs, fast_sync=True), RConsensusReactor(rcs, fast_sync=True)
    ours.start(), theirs.start()
    step = dict(height=7, round=0, step=3, seconds_since_start_time=0, last_commit_round=0)
    try:
        peer = _FakePeer("ab" * 20)
        assert ours.init_peer(peer) is peer
        ours.receive(p_reactor.STATE_CHANNEL, peer, encode_msg(NewRoundStepMessage(**step)))
        assert ours.peer_state(peer.id).height == 7
        ours.add_peer(peer)  # the state made at init is the one kept
        assert ours.peer_state(peer.id).height == 7
        ours.remove_peer(_FakePeer(peer.id), "a stale object of the same id")
        assert ours.peer_state(peer.id) is not None
        ours.remove_peer(peer, "gone")
        assert ours.peer_state(peer.id) is None

        rpeer = _FakePeer("ab" * 20)
        theirs.receive(R_STATE, rpeer, r_encode(RNewRoundStep(**step)))
        assert theirs.peer_state(rpeer.id) is None  # dropped
    finally:
        ours.stop(), theirs.stop()
        bus.stop(), rbus.stop()
