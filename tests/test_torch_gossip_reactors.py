"""The mempool and evidence gossip reactors (``mempool/reactor.py``,
``evidence/reactor.py``, their shared walker ``libs/gossip.py``) on the port's
net, and across the packages.

* The reference's ``tests/test_gossip_reactors.py`` restated on the port's
  4-node net (``testutil/consensus_net.make_consensus_net``, every node with
  the reactor set ``node/verify_root.node_reactors`` wires): a tx given to a
  node that is not the next proposer commits through gossip; a tx reaches
  every mempool; a double sign added to one node's pool reaches every pool
  and commits on every node.
* The wire: ``encode_tx_msg`` and ``encode_evidence_list`` give the
  reference's bytes for the same seeded txs and evidence, and each package
  decodes the other's; the channel descriptors equal the reference's.
* The walker: each element once a walker, new elements wake it, a held-back
  element waits.
* A mixed net of 2 port nodes and 2 reference nodes: a tx given to a node of
  either package reaches every node's reactor by gossip and commits on every
  node, and a double sign added to a node of either package commits on every
  node.

The nets verify on the host (the port's installed verifier is the host
verifier, as the reference's conftest installs the reference's). Every wait
has a deadline; sockets are socketpairs.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from tendermint_tpu.consensus.reactor import ConsensusReactor as RConsensusReactor
from tendermint_tpu.evidence import reactor as revr
from tendermint_tpu.mempool import reactor as rmpr
from tendermint_tpu.p2p import test_util as r_tu
from tendermint_tpu.p2p.conn.connection import MConnConfig as RMConnConfig
from tendermint_tpu.types import BlockID as RBlockID
from tendermint_tpu.types import PartSetHeader as RPartSetHeader
from tendermint_tpu.types import SignedMsgType as RSignedMsgType
from tendermint_tpu.types import Vote as RVote
from tendermint_tpu.types.evidence import DuplicateVoteEvidence as RDuplicateVoteEvidence
from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.config.consensus import consensus_test_config
from tendermint_tpu_torch.config.instrumentation import InstrumentationConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.evidence import reactor as pevr
from tendermint_tpu_torch.libs import gossip
from tendermint_tpu_torch.libs.clist import CList
from tendermint_tpu_torch.mempool import reactor as pmpr
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.p2p.test_util import connect_switches, make_switch
from tendermint_tpu_torch.state.state_types import state_from_genesis as p_state
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.testutil import consensus_net as cn
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.vote import Vote

from tests import consensus_harness as r_harness
from tests.test_torch_p2p import _connect_across

DEADLINE = 60.0


@pytest.fixture(autouse=True)
def _host_verifier():
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())
    yield
    verify_root.reset_verify()


def wait_for(pred, timeout=DEADLINE):
    return harness.wait_for(pred, timeout=timeout, interval=0.02)


def committed(node, pred) -> bool:
    """Whether a block in ``node``'s store holds a tx or an evidence for
    which ``pred`` holds (either package's node)."""
    bs = node.cs.block_store
    for h in range(1, bs.height() + 1):
        block = bs.load_block(h)
        if block is not None and (any(pred(bytes(t)) for t in block.data.txs)
                                  or any(pred(ev) for ev in block.evidence.evidence)):
            return True
    return False


def in_pool(mp, tx: bytes) -> bool:
    el = mp.txs_front()
    while el is not None:
        if el.value.tx == tx:
            return True
        el = el.next()
    return False


# ---------------------------------------------------------------------------
# The reference's tests/test_gossip_reactors.py on the port's net
# ---------------------------------------------------------------------------


def test_tx_submitted_to_one_node_commits_via_gossip():
    nodes = cn.make_consensus_net(4)
    try:
        assert wait_for(lambda: all(n.cs.get_round_state().height >= 2 for n in nodes))
        # a node that is NOT the next proposer: the tx commits only if gossip
        # carries it to whoever proposes
        proposer = nodes[0].cs.get_round_state().validators.get_proposer().address
        submit_to = next(n for n in nodes if n.pv.get_pub_key().address() != proposer)
        tx = b"gossip-me=across-the-net"
        submit_to.cs.mempool.check_tx(tx)
        assert wait_for(lambda: all(committed(n, lambda t: t == tx) for n in nodes))
    finally:
        cn.stop_consensus_net(nodes)


def test_tx_reaches_all_mempools_before_commit():
    nodes = cn.make_consensus_net(4)
    try:
        tx = b"replicated=yes"
        nodes[2].cs.mempool.check_tx(tx)
        # each node's mempool sees it by gossip, or it was reaped and
        # committed meanwhile: either observation counts
        assert wait_for(lambda: all(in_pool(n.cs.mempool, tx) or committed(n, lambda t: t == tx)
                                    for n in nodes))
        assert all(n.reactors.mempool.qos is not None for n in nodes)
    finally:
        cn.stop_consensus_net(nodes)


def test_evidence_propagates_and_commits():
    nodes = cn.make_consensus_net(4)
    try:
        # the validators of the evidence's height are in every state DB
        assert wait_for(lambda: all(n.cs.get_round_state().height >= 3 for n in nodes))
        ev = cn.duplicate_vote_evidence(nodes, 1, 2)
        nodes[0].evidence_pool.add_evidence(ev)
        assert wait_for(lambda: all(n.evidence_pool.pending_evidence(-1)
                                    or n.evidence_pool.is_committed(ev) for n in nodes))
        assert wait_for(lambda: all(n.evidence_pool.is_committed(ev) for n in nodes))
        assert all(committed(n, lambda e: isinstance(e, DuplicateVoteEvidence)
                             and e.hash() == ev.hash()) for n in nodes)
    finally:
        cn.stop_consensus_net(nodes)


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------


def seeded_txs(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, size=int(k), dtype=np.uint8))
            for k in rng.integers(0, 3000, size=n)]


@pytest.mark.parametrize("seed", [3, 11])
def test_tx_messages_are_the_references_bytes(seed):
    for tx in seeded_txs(seed) + [b"", b"a=b"]:
        wire = pmpr.encode_tx_msg(tx)
        assert wire == rmpr.encode_tx_msg(tx)
        assert pmpr.decode_tx_msg(rmpr.encode_tx_msg(tx)) == tx
        assert rmpr.decode_tx_msg(wire) == tx
    for bad in (b"\x02\x01a", b""):
        for mod in (pmpr, rmpr):
            with pytest.raises(Exception):
                mod.decode_tx_msg(bad)


def both_evidence(seed: int, count: int):
    """``count`` double signs built in both packages from the same seeded
    votes and keys (signed by the validators of ``make_genesis``)."""
    rng = np.random.default_rng(seed)
    _, ppvs = harness.make_genesis(4)
    _, rpvs = r_harness.make_genesis(4)
    port, ref = [], []
    for k in range(count):
        i = int(rng.integers(0, 4))
        h, r, ts = int(rng.integers(1, 10_000)), int(rng.integers(0, 5)), int(rng.integers(1, 1 << 62))
        hashes = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(2)]
        psh = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        addr = ppvs[i].get_pub_key().address()
        pv = [ppvs[i].sign_vote("test-chain", Vote(
            vote_type=SignedMsgType.PREVOTE, height=h, round=r, timestamp_ns=ts,
            block_id=BlockID(hash=hh, parts_header=PartSetHeader(2, psh)),
            validator_address=addr, validator_index=i)) for hh in hashes]
        rv = [rpvs[i].sign_vote("test-chain", RVote(
            vote_type=RSignedMsgType.PREVOTE, height=h, round=r, timestamp_ns=ts,
            block_id=RBlockID(hash=hh, parts_header=RPartSetHeader(2, psh)),
            validator_address=addr, validator_index=i)) for hh in hashes]
        port.append(DuplicateVoteEvidence(pub_key=ppvs[i].get_pub_key(), vote_a=pv[0], vote_b=pv[1]))
        ref.append(RDuplicateVoteEvidence(pub_key=rpvs[i].get_pub_key(), vote_a=rv[0],
                                          vote_b=rv[1]))
    return port, ref


@pytest.mark.parametrize("count", [0, 1, 5])
def test_evidence_lists_are_the_references_bytes(count):
    port, ref = both_evidence(count + 1, count)
    wire = pevr.encode_evidence_list(port)
    assert wire == revr.encode_evidence_list(ref)
    assert [e.marshal() for e in revr.decode_evidence_list(wire)] == [e.marshal() for e in ref]
    assert [e.marshal() for e in pevr.decode_evidence_list(revr.encode_evidence_list(ref))] == \
        [e.marshal() for e in port]
    assert [e.hash() for e in port] == [e.hash() for e in ref]


def test_an_overlong_evidence_list_is_refused_by_both():
    for mod in (pevr, revr):
        w = bytearray(b"\x01")
        w += bytes([0x81, 0x08])  # uvarint 1025
        with pytest.raises(ValueError):
            mod.decode_evidence_list(bytes(w))


def test_channels_equal_the_references():
    def descs(r):
        return [(d.id, d.priority, d.send_queue_capacity, d.recv_message_capacity)
                for d in r.get_channels()]
    assert descs(pevr.EvidenceReactor(None)) == descs(revr.EvidenceReactor(None))
    assert descs(pmpr.MempoolReactor(None)) == descs(rmpr.MempoolReactor(None))
    assert (pmpr.MEMPOOL_CHANNEL, pevr.EVIDENCE_CHANNEL) == (rmpr.MEMPOOL_CHANNEL,
                                                             revr.EVIDENCE_CHANNEL)


# ---------------------------------------------------------------------------
# The walker
# ---------------------------------------------------------------------------


def _walk(cl, send, hold_back=None):
    alive = threading.Event()
    alive.set()
    t = threading.Thread(target=gossip.walk_and_send, daemon=True,
                         args=(alive.is_set, cl.front_wait, send, hold_back))
    t.start()
    return alive, t


def _stop(alive, t):
    alive.clear()
    t.join(5)
    assert not t.is_alive()


def test_the_walker_sends_each_element_once_and_waits_for_new_ones():
    """The walker waits on the empty list (``front_wait``) and delivers what
    the reference's polling walker delivers."""
    cl, sent, hold = CList(), [], {"until": 3}

    def send(v):
        sent.append(v)
        return True

    alive, t = _walk(cl, send, lambda v: v >= hold["until"])
    try:
        for v in range(5):
            cl.push_back(v)
        assert wait_for(lambda: sent == [0, 1, 2], timeout=10)
        time.sleep(0.3)
        assert sent == [0, 1, 2]  # 3 is held back
        hold["until"] = 100
        assert wait_for(lambda: sent == [0, 1, 2, 3, 4], timeout=10)
        cl.push_back(5)  # a new element wakes the walker
        assert wait_for(lambda: sent == [0, 1, 2, 3, 4, 5], timeout=10)
    finally:
        _stop(alive, t)


def test_the_walker_restarts_from_the_front_when_its_anchor_is_removed():
    """A removed tail anchor sends the walker back to the list's head: what
    was pushed after the removal is delivered, the removed element is not
    sent again."""
    cl, sent = CList(), []

    def send(v):
        sent.append(v)
        return True

    alive, t = _walk(cl, send)
    try:
        el = cl.push_back(0)
        assert wait_for(lambda: sent == [0], timeout=10)
        cl.remove(el)  # the anchor goes, the list is empty
        time.sleep(0.3)
        cl.push_back(1)
        assert wait_for(lambda: sent == [0, 1], timeout=10)
        time.sleep(0.3)
        assert sent == [0, 1]
    finally:
        _stop(alive, t)


# ---------------------------------------------------------------------------
# A mixed net: two port nodes and two reference nodes
# ---------------------------------------------------------------------------


def _ref_node(i, doc, pv):
    cs, bus = r_harness.make_cs_from_genesis(doc, pv, real_evidence_pool=True)
    node = r_harness.NetNode(cs, bus, RConsensusReactor(cs), pv)
    node.mempool_reactor = rmpr.MempoolReactor(cs.mempool,
                                               peer_height_lookup=node.reactor.peer_height)
    node.evidence_reactor = revr.EvidenceReactor(cs.evpool,
                                                 peer_height_lookup=node.reactor.peer_height)

    def init(_, s):
        s.add_reactor("consensus", node.reactor)
        s.add_reactor("mempool", node.mempool_reactor)
        s.add_reactor("evidence", node.evidence_reactor)
        return s

    node.switch = r_tu.make_switch(i, network=doc.chain_id, init_switch=init,
                                   mconfig=RMConnConfig(**dataclasses.asdict(cn.NET_MCONFIG)))
    return node


def _record_receives(reactor, decode):
    got, real = [], reactor.receive

    def receive(chan_id, peer, msg_bytes):
        got.extend(decode(msg_bytes))
        return real(chan_id, peer, msg_bytes)

    reactor.receive = receive
    return got


def test_mixed_net_gossips_txs_and_evidence_across_the_packages():
    pdoc, ppvs = harness.make_genesis(4)
    rdoc, rpvs = r_harness.make_genesis(4)
    order = [v.address for v in p_state(pdoc).validators.validators]
    p_by = {pv.get_pub_key().address(): pv for pv in ppvs}
    r_by = {pv.get_pub_key().address(): pv for pv in rpvs}
    port = []
    for i in (0, 2):
        built = {}

        def init(_, s, i=i, built=built):
            built["n"] = cn.build_node(i, pdoc, p_by[order[i]], consensus_test_config(), None,
                                       "cpu", KVStoreApp(), None,
                                       InstrumentationConfig(watchdog=False), s)
            return s

        make_switch(i, network=pdoc.chain_id, init_switch=init, mconfig=cn.NET_MCONFIG)
        port.append(built["n"])
    ref = [_ref_node(i, rdoc, r_by[order[i]]) for i in (1, 3)]
    nodes = [port[0], ref[0], port[1], ref[1]]
    txs_in = [_record_receives(port[0].reactors.mempool, lambda m: [pmpr.decode_tx_msg(m)]),
              _record_receives(ref[0].mempool_reactor, lambda m: [rmpr.decode_tx_msg(m)]),
              _record_receives(port[1].reactors.mempool, lambda m: [pmpr.decode_tx_msg(m)]),
              _record_receives(ref[1].mempool_reactor, lambda m: [rmpr.decode_tx_msg(m)])]
    pools = [port[0].evidence_pool, ref[0].cs.evpool, port[1].evidence_pool, ref[1].cs.evpool]
    for n in nodes:
        n.switch.start()
    try:
        connect_switches(port[0].switch, port[1].switch)
        r_tu.connect_switches(ref[0].switch, ref[1].switch)
        for p in port:
            for r in ref:
                _connect_across(p.switch, r.switch)
        assert wait_for(lambda: all(n.cs.block_store.height() >= 3 for n in nodes))
        from_port, from_ref = b"port-to-ref=1", b"ref-to-port=1"
        port[0].cs.mempool.check_tx(from_port)
        ref[1].cs.mempool.check_tx(from_ref)
        ev_port = cn.duplicate_vote_evidence(port, 1, 2)  # validator 2, a port node's key
        pools[0].add_evidence(ev_port)
        # validator 1's double sign, built and added on a reference node
        pv = r_by[order[1]]
        votes = [pv.sign_vote(rdoc.chain_id, RVote(
            vote_type=RSignedMsgType.PREVOTE, height=2, round=0, timestamp_ns=time.time_ns(),
            block_id=RBlockID(hash=hh, parts_header=RPartSetHeader(1, b"\x33" * 32)),
            validator_address=order[1], validator_index=1)) for hh in (b"\x44" * 32, b"\x55" * 32)]
        ev_ref = RDuplicateVoteEvidence(pub_key=pv.get_pub_key(), vote_a=votes[0], vote_b=votes[1])
        pools[1].add_evidence(ev_ref)
        assert wait_for(lambda: all(committed(n, lambda t: t == tx) for n in nodes
                                    for tx in (from_port, from_ref))), [
            n.cs.block_store.height() for n in nodes]
        # each tx crossed the wire into every node but its own by gossip
        assert all(from_port in txs_in[k] for k in (1, 2, 3))
        assert all(from_ref in txs_in[k] for k in (0, 1, 2))
        hashes = {ev_port.hash(), ev_ref.hash()}
        assert ev_port.marshal() != ev_ref.marshal()
        assert wait_for(lambda: all(
            committed(n, lambda e, h=h: not isinstance(e, bytes) and e.hash() == h)
            for n in nodes for h in hashes))
        top = min(n.cs.block_store.height() for n in nodes)
        for h in range(1, top + 1):
            assert len({n.cs.block_store.load_block(h).hash() for n in nodes}) == 1, h
        assert all(n.switch.peers.size() == 3 for n in nodes)
        assert port[0].reactors.mempool.device_fault is None
    finally:
        cn.stop_consensus_net(port)
        r_harness.stop_consensus_net(ref)
