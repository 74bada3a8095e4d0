"""Fast sync and state sync over the real switch (``p2p/switch.Switch``,
``p2p/peer.Peer``), and a node that joins a running net
(``testutil/consensus_net.make_joining_node``, wired by
``node/verify_root.node_reactors``).

* The reference's ``tests/test_fastsync.py::TestFastSyncIntegration``
  restated on the port's switches: a late joiner syncs a 30-height chain
  from a serving node and switches to consensus; a late joiner catches a
  live single-validator producer and follows it.
* The reference's ``tests/test_statesync.py::TestStateSyncEndToEnd`` restore
  (a corrupt chunk rejected and its sender banned, the trust hops, the
  backfill in one dispatch, the restored state, app and records) over each
  package's ``make_connected_switches`` in place of its hub fakes.
* A port node that restores and fast-syncs from reference producers across
  the wire leaves the same records, byte for byte, as a reference node that
  does the same.
* ``node_reactors``' wiring: the reference's order and channels, the
  single-validator exception, the restoring node's flags; a node that joins
  the port's 4-node net by state sync and by fast sync reaches the tip and
  follows it with the validators' hashes.

The port's installed verifier and device executor verify on the host here
(the kernels' plain versions under a running net's threads are what
``tests/test_torch_statesync.py`` runs without one); the reference's host
verifier is installed for the reference's nodes. Every wait has a deadline;
sockets are socketpairs.
"""

import dataclasses
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu.blockchain import reactor as rbc
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.p2p import test_util as r_tu
from tendermint_tpu.p2p.conn.connection import MConnConfig as RMConnConfig
from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp, PersistentKVStoreApp
from tendermint_tpu_torch.blockchain import reactor as pbc
from tendermint_tpu_torch.config.consensus import consensus_test_config
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.p2p import test_util as p_tu
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.testutil import consensus_net as cn
from tendermint_tpu_torch.testutil.consensus import wait_for

from tests.test_torch_fastsync import ConsensusStub
from tests.test_torch_p2p import _connect_across
from tests import test_torch_statesync as tss
from tests.test_torch_statesync import db_records, fast_sync_state, producer_chain

DEADLINE = 60.0
# the nets' MConnection timing (consensus_net.NET_MCONFIG): the test speed
# with the default keepalive, which a loaded interpreter cannot trip
REF = SimpleNamespace(**vars(tss.REF), bc=rbc, tu=r_tu,
                      mconfig=RMConnConfig(**dataclasses.asdict(cn.NET_MCONFIG)))
PORT = SimpleNamespace(**vars(tss.PORT), bc=pbc, tu=p_tu, mconfig=cn.NET_MCONFIG)
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=lambda ns: ns.name)


def host_executor(plan, mesh=None):
    """The device executor off the card, on the host oracle."""
    return planner._execute_host(plan, tbatch.HostBatchVerifier())


@pytest.fixture(autouse=True)
def _verifiers():
    rset_batch_verifier(RHostBatchVerifier())
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())
    planner.set_device_executor(host_executor)
    yield
    verify_root.reset_verify()


def stop_all(switches):
    for sw in switches:
        if sw.is_running:
            sw.stop()


def block_exec(pkg, genesis, app):
    st = pkg.st.state_from_genesis(genesis)
    db = pkg.MemDB()
    pkg.sm_store.save_state(db, st)
    conn = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(app))
    conn.start()
    return st, db, conn, pkg.execution.BlockExecutor(db, conn.consensus)


def serving_reactors(pkg, fx, snap_store=None):
    """A node that serves ``fx``'s chain: its blocks on the blockchain
    channel (fast sync off: the chain's validators are not running) and,
    with ``snap_store``, its snapshots and light blocks on the state sync
    channel."""
    _, _, _, ex = block_exec(pkg, fx.genesis, pkg.App())
    out = [("blockchain", pkg.bc.BlockchainReactor(fx.state.copy(), ex, fx.block_store,
                                                  fast_sync=False))]
    if snap_store is not None:
        out.append(("statesync", pkg.Reactor(pkg.Config(), snapshot_store=snap_store,
                                             block_store=fx.block_store,
                                             state_db=fx.state_db)))
    return out


# ---------------------------------------------------------------------------
# TestFastSyncIntegration on the port's switches
# ---------------------------------------------------------------------------


def test_late_joiner_syncs_chain_and_switches_to_consensus():
    fx = PORT.build_chain(n_vals=4, n_heights=30, chain_id="sync-chain", **PORT.build_kw)
    server = serving_reactors(PORT, fx)
    built = {}

    def init(i, sw):
        if i == 0:
            for name, r in server:
                sw.add_reactor(name, r)
            return sw
        built["n"] = cn.build_node(1, fx.genesis, None, consensus_test_config(), None, "cpu",
                                   KVStoreApp(), None, None, sw, fast_sync=True)
        return sw

    switches = p_tu.make_connected_switches(2, init, network="sync-chain", mconfig=PORT.mconfig)
    node = built["n"]
    bc, store = node.reactors.blockchain, node.cs.block_store
    try:
        # 29 of 30 blocks (the tip's commit lives in the future), then consensus
        assert wait_for(lambda: store.height() >= 29, timeout=DEADLINE), store.height()
        assert wait_for(lambda: not bc.fast_sync, timeout=30)
        assert wait_for(lambda: node.cs.is_running, timeout=30)
        assert node.cs.get_round_state().height == 30
        assert bc.blocks_synced >= 29
        assert store.load_block(29).hash() == fx.block_store.load_block(29).hash()
        assert bc.device_fault is None and all(sw.peers.size() == 1 for sw in switches)
    finally:
        cn.stop_consensus_net([node])
        stop_all(switches)


def test_live_producer_late_joiner_follows():
    """The producer keeps committing while the joiner syncs; after switching
    to consensus the joiner follows new heights through consensus gossip."""
    cfg = consensus_test_config()
    cfg.skip_timeout_commit = False
    cfg.timeout_commit = 0.2  # ~5 blocks/s: a solo producer outruns any follower
    nodes = cn.make_consensus_net(1, config=cfg)
    joiner = None
    try:
        prod = nodes[0]
        assert not prod.reactors.fast_sync and not prod.reactors.consensus.fast_sync
        assert wait_for(lambda: prod.cs.get_round_state().height >= 8, timeout=DEADLINE)
        joiner = cn.make_joining_node(nodes, KVStoreApp(), config=cfg)
        bc = joiner.reactors.blockchain
        assert joiner.reactors.fast_sync and not joiner.reactors.restoring
        assert wait_for(lambda: not bc.fast_sync, timeout=DEADLINE)
        assert wait_for(lambda: joiner.cs.is_running, timeout=30)
        target = prod.cs.get_round_state().height + 3
        assert wait_for(lambda: joiner.cs.block_store.height() >= target - 1, timeout=DEADLINE), (
            joiner.cs.block_store.height(), prod.cs.get_round_state().height)
        for h in range(1, target):
            assert joiner.cs.block_store.load_block(h).hash() == \
                prod.cs.block_store.load_block(h).hash()
    finally:
        cn.stop_consensus_net(nodes + ([joiner] if joiner is not None else []))


# ---------------------------------------------------------------------------
# TestStateSyncEndToEnd over the real switches
# ---------------------------------------------------------------------------


@PKGS
def test_restore_over_the_switch_rejects_a_corrupt_chunk_verifies_and_backfills(
        pkg, monkeypatch):
    fx, snap_store = producer_chain(pkg, chain_id="ss-switch")
    snap = snap_store.get(12, pkg.chunker.SNAPSHOT_FORMAT)
    assert snap is not None and snap.chunks >= 2
    app2 = pkg.App()
    conn2 = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(app2))
    conn2.start()
    state_db2, block_store2 = pkg.MemDB(), pkg.BlockStore(pkg.MemDB())
    cfg = pkg.Config(enable=True, trust_height=1,
                     trust_hash=fx.block_store.load_block_meta(1).header.hash().hex(),
                     discovery_time=0.25, chunk_fetch_timeout=5.0, chunk_retries=4,
                     backfill_blocks=4)
    metrics = pkg.Metrics()
    syncer = pkg.Syncer(cfg, fx.chain_id, fx.genesis, conn2.query, state_db2, block_store2,
                        metrics=metrics)
    synced = []
    client = pkg.Reactor(cfg, app_query=conn2.query, block_store=block_store2,
                         state_db=state_db2, syncer=syncer,
                         on_synced=lambda st, h: synced.append(st), metrics=metrics)
    good = pkg.Reactor(pkg.Config(), snapshot_store=snap_store, block_store=fx.block_store,
                       state_db=fx.state_db)
    evil = pkg.Reactor(pkg.Config(), snapshot_store=pkg.CorruptingStore(snap_store),
                       block_store=fx.block_store, state_db=fx.state_db)
    dispatches = []
    orig = pkg.planner.execute_plan

    def counting(plan, **k):
        dispatches.append((plan.H, plan.V))
        return orig(plan, **k)

    monkeypatch.setattr(pkg.planner, "execute_plan", counting)
    reactors = [client, good, evil]
    switches = pkg.tu.make_connected_switches(
        3, lambda i, sw: (sw.add_reactor("statesync", reactors[i]), sw)[1], network=fx.chain_id,
        mconfig=pkg.mconfig)
    evil_id = switches[2].node_id
    try:
        assert wait_for(lambda: synced, timeout=DEADLINE), client.progress()
        state = synced[0]
        # the corrupt sender banned and stopped by the switch; every chunk
        # then came from the honest peer
        assert evil_id in client._banned and switches[0].peers.get(evil_id) is None
        assert switches[0].peers.get(switches[1].node_id) is not None
        assert metrics.chunk_fetch._values.get(("bad",), 0) >= 1
        assert metrics.chunk_fetch._values.get(("ok",), 0) >= snap.chunks
        expected = fast_sync_state(pkg, fx, 12)
        for f in ("last_block_height", "chain_id", "last_block_id", "app_hash",
                  "last_results_hash", "last_block_time_ns", "last_block_total_tx"):
            assert getattr(state, f) == getattr(expected, f), f
        for f in ("validators", "next_validators", "last_validators"):
            assert getattr(state, f).hash() == getattr(expected, f).hash(), f
        meta13 = fx.block_store.load_block_meta(13)
        assert state.app_hash == meta13.header.app_hash and app2.height == 12
        info = conn2.query.info_sync(pkg.abci.RequestInfo())
        assert info.last_block_height == 12 and info.last_block_app_hash == meta13.header.app_hash
        assert dispatches == [(4, 4)]  # the backfill [9..12]: one dispatch
        assert block_store2.height() == 12 and block_store2.base() == 9
        for h in range(9, 13):
            assert block_store2.load_block_meta(h) is not None
            assert block_store2.load_block_commit(h) is not None
        for h in range(9, 14):
            assert pkg.sm_store.load_validators(state_db2, h).hash() == \
                fx.state.validators.hash()
        prog = client.progress()
        assert prog["synced_height"] == 12 and prog["syncing"] is False
        assert prog["chunks_applied"] == snap.chunks
    finally:
        stop_all(switches)
        conn2.stop()


class _Idle(Reactor):
    """A reactor on a channel of its own: a peer that runs no state sync."""

    def get_channels(self):
        return [ChannelDescriptor(id=0x77, priority=1)]


def test_a_peer_without_the_state_sync_channel_is_not_asked():
    """On the real switch a peer need not run state sync; the restore asks
    only the peers that advertise its channel (the hub fakes run every
    reactor on every peer), and a request the switch refuses to queue fails
    at once instead of waiting out ``chunk_fetch_timeout``."""
    fx, snap_store = producer_chain(PORT, chain_id="ss-mixed-peers", n_heights=14)
    cfg = PORT.Config(enable=True, trust_height=1,
                      trust_hash=fx.block_store.load_block_meta(1).header.hash().hex(),
                      discovery_time=0.25, chunk_fetch_timeout=20.0, backfill_blocks=4)
    node = joining_reactors(PORT, fx, cfg)
    asked, real = [], node.ss._request
    node.ss._request = lambda peer_id, key, msg, timeout: (asked.append(peer_id),
                                                          real(peer_id, key, msg, timeout))[1]
    server = serving_reactors(PORT, fx, snap_store)
    reactor_sets = [node.reactors, server, [("idle", _Idle())]]
    switches = p_tu.make_connected_switches(
        3, lambda i, sw: ([sw.add_reactor(n, r) for n, r in reactor_sets[i]], sw)[1],
        network=fx.chain_id, mconfig=PORT.mconfig)
    try:
        t0 = time.monotonic()
        assert node.cons.switched.wait(DEADLINE), node.ss.progress()
        assert time.monotonic() - t0 < cfg.chunk_fetch_timeout
        idle_id = switches[2].node_id
        assert switches[0].peers.get(idle_id) is not None and idle_id not in asked
        assert node.ss.peer_ids() == {switches[1].node_id}
        assert node.cons.state.last_block_height == 13 and node.bc.blocks_synced == 1
        # a request its peer does not queue returns at once
        peer = switches[0].peers.get(switches[1].node_id)
        peer.try_send = lambda chan_id, msg: False
        t1 = time.monotonic()
        assert node.ss.fetch_chunk(peer.id, 12, 1, 0, timeout=20.0) is None
        assert time.monotonic() - t1 < 5.0
    finally:
        stop_all(switches)
        node.conn.stop()


# ---------------------------------------------------------------------------
# A port node joins reference producers across the wire
# ---------------------------------------------------------------------------


def joining_reactors(pkg, fx, cfg):
    """An empty node that restores ``fx``'s tallest snapshot, then hands off
    to fast sync (its reactor built with fast sync off), which switches to a
    recorded consensus stub: the port's wired by ``node/verify_root``."""
    app = pkg.App()
    st0, state_db, conn, ex = block_exec(pkg, fx.genesis, app)
    store, cons = pkg.BlockStore(pkg.MemDB()), ConsensusStub()
    if pkg is PORT:
        bc = verify_root.blockchain_reactor(st0, ex, store, fast_sync=False,
                                            consensus_reactor=cons)
        ss = verify_root.state_sync(cfg, fx.genesis, conn, st0, state_db, store, app=app,
                                    blockchain_reactor=bc, metrics=pkg.Metrics()).reactor
    else:
        bc = pkg.bc.BlockchainReactor(st0, ex, store, fast_sync=False, consensus_reactor=cons)
        syncer = pkg.Syncer(cfg, fx.chain_id, fx.genesis, conn.query, state_db, store,
                            metrics=pkg.Metrics())
        ss = pkg.Reactor(cfg, app_query=conn.query, block_store=store, state_db=state_db,
                         syncer=syncer, on_synced=lambda st, h: bc.start_from_statesync(st),
                         metrics=pkg.Metrics())
    return SimpleNamespace(app=app, conn=conn, state_db=state_db, store=store, cons=cons,
                           bc=bc, ss=ss, reactors=[("blockchain", bc), ("statesync", ss)])


def test_a_port_node_joins_reference_producers_and_keeps_a_reference_nodes_records():
    # snapshots at 4, 8 and 12; 13 and 14 exist: the restore of 12 verifies
    # header 13, and fast sync then verifies block 13 with 14's LastCommit
    fx, snap_store = producer_chain(REF, chain_id="ss-wire", n_heights=14)
    serving = [serving_reactors(REF, fx, snap_store) for _ in range(2)]
    producers = [REF.tu.make_switch(i, network=fx.chain_id, mconfig=REF.mconfig,
                                    init_switch=lambda _, sw, rs=rs: ([sw.add_reactor(n, r)
                                                                       for n, r in rs], sw)[1])
                 for i, rs in enumerate(serving)]
    cfg = dict(enable=True, trust_height=1,
               trust_hash=fx.block_store.load_block_meta(1).header.hash().hex(),
               discovery_time=0.25, chunk_fetch_timeout=5.0, backfill_blocks=4)
    nodes = {}
    for pkg in (REF, PORT):
        node = joining_reactors(pkg, fx, pkg.Config(**cfg))
        node.switch = pkg.tu.make_switch(
            2, network=fx.chain_id, mconfig=pkg.mconfig,
            init_switch=lambda _, sw, node=node: ([sw.add_reactor(n, r) for n, r in
                                                   node.reactors], sw)[1])
        nodes[pkg.name] = node
    switches = producers + [n.switch for n in nodes.values()]
    for sw in switches:
        sw.start()
    try:
        for sw in producers:
            r_tu.connect_switches(sw, nodes["reference"].switch)
            _connect_across(nodes["port"].switch, sw)
        for name, n in nodes.items():
            assert n.cons.switched.wait(DEADLINE), (name, n.ss.progress())
        r, p = nodes["reference"], nodes["port"]
        assert p.cons.state.last_block_height == r.cons.state.last_block_height == 13
        assert p.bc.blocks_synced == r.bc.blocks_synced == 1
        assert p.cons.state.marshal() == r.cons.state.marshal()
        assert db_records(p.state_db) == db_records(r.state_db)
        assert db_records(p.store._db) == db_records(r.store._db)
        assert p.store.base() == r.store.base() == 9 and p.store.height() == 13
        assert p.app._db.get(b"kvstore:state") == r.app._db.get(b"kvstore:state")
        assert p.app._app_hash() == r.app._app_hash() == fx.block_store.load_block_meta(
            14).header.app_hash
        assert p.ss.progress() == r.ss.progress()
        assert p.bc.device_fault is None and p.ss.device_fault is None
        # no peer stopped: each producer still holds both joiners
        assert all(sw.peers.size() == 2 for sw in producers)
    finally:
        stop_all(switches)
        for n in nodes.values():
            n.conn.stop()


# ---------------------------------------------------------------------------
# node_reactors, and a node joining the port's net
# ---------------------------------------------------------------------------


def test_node_reactors_register_the_references_order_and_channels():
    ss = StateSyncConfig(snapshot_interval=2)
    nodes = cn.make_consensus_net(2, app_factory=lambda i: PersistentKVStoreApp(),
                                  statesync_cfg=ss, start=False)
    try:
        for n in nodes:
            sw, r = n.switch, n.reactors
            assert list(sw.reactors) == ["consensus", "blockchain", "mempool", "evidence",
                                         "statesync"]
            assert [sw.reactors[k] for k in sw.reactors] == [
                r.consensus, r.blockchain, r.mempool, r.evidence, r.statesync.reactor]
            assert sw.node_info.channels == bytes(
                [0x20, 0x21, 0x22, 0x23, 0x40, 0x30, 0x38, 0x60])
            assert r.statesync.syncer is None and not r.restoring and not r.fast_sync
            assert r.mempool._peer_height_lookup == r.consensus.peer_height
            assert r.evidence._peer_height_lookup == r.consensus.peer_height
            assert r.mempool.qos is not None and r.blockchain.consensus_reactor is r.consensus
        # no [statesync]: no state sync reactor, channel 0x60 not advertised
        plain = cn.make_consensus_net(1, start=False)
        assert plain[0].reactors.statesync is None
        assert list(plain[0].switch.reactors) == ["consensus", "blockchain", "mempool",
                                                  "evidence"]
        # the only validator never fast-syncs, even asked to (node.go:246-252);
        # a non-validator of the same genesis does
        doc, pv = plain[0].genesis_doc, plain[0].pv
        solo = [cn.build_node(i, doc, who, consensus_test_config(), None, "cpu", KVStoreApp(),
                              None, None, p_tu.make_switch(i, network=doc.chain_id),
                              fast_sync=True) for i, who in enumerate((pv, None))]
        assert not solo[0].reactors.fast_sync and not solo[0].reactors.consensus.fast_sync
        assert solo[1].reactors.fast_sync and solo[1].reactors.consensus.fast_sync
        plain += solo
        # a restoring node: consensus and fast sync wait for the restore
        meta_hash = "00" * 32
        j = cn.make_joining_node(nodes, PersistentKVStoreApp(), start=False,
                                 statesync_cfg=StateSyncConfig(enable=True, trust_height=1,
                                                               trust_hash=meta_hash))
        assert j.reactors.restoring and not j.reactors.fast_sync
        assert j.reactors.consensus.fast_sync and not j.reactors.blockchain.fast_sync
        assert j.reactors.statesync.syncer is not None and j.pv is None
        cn.stop_consensus_net(plain + [j])
    finally:
        cn.stop_consensus_net(nodes)


def test_a_node_joins_the_net_by_state_sync_and_follows_it():
    nodes = cn.make_consensus_net(4, app_factory=lambda i: PersistentKVStoreApp(),
                                  statesync_cfg=StateSyncConfig(snapshot_interval=2))
    joiner = None
    try:
        # snapshots at 2 and 4; 5 holds header 5, which the restore of 4 verifies
        assert wait_for(lambda: all(n.cs.block_store.height() >= 5 for n in nodes),
                        timeout=DEADLINE)
        meta = nodes[0].cs.block_store.load_block_meta(1)
        cfg = StateSyncConfig(enable=True, trust_height=1, trust_hash=meta.header.hash().hex(),
                              discovery_time=0.25)
        joiner = cn.make_joining_node(nodes, PersistentKVStoreApp(), statesync_cfg=cfg)
        ss = joiner.reactors.statesync.reactor
        assert wait_for(lambda: joiner.cs.is_running, timeout=DEADLINE), ss.progress()
        tip = min(n.cs.block_store.height() for n in nodes)
        assert wait_for(lambda: joiner.cs.block_store.height() >= tip + 2, timeout=DEADLINE)
        prog, bs = ss.progress(), joiner.cs.block_store
        assert prog["synced_height"] % 2 == 0 and prog["synced_height"] >= 4
        assert prog["error"] is None and ss.device_fault is None
        assert bs.base() == 1  # backfill_blocks (16) is more than the chain held
        top = min(bs.height(), nodes[1].cs.block_store.height())
        for h in range(bs.base(), top + 1):
            want = nodes[1].cs.block_store.load_block_meta(h).header
            assert bs.load_block_meta(h).header.hash() == want.hash(), h
            if h > prog["synced_height"]:
                assert bs.load_block(h).hash() == nodes[1].cs.block_store.load_block(h).hash()
        assert all(n.switch.peers.size() == 4 for n in nodes) and joiner.switch.peers.size() == 4
        assert joiner.cs.device_fault is None and joiner.reactors.blockchain.device_fault is None
    finally:
        cn.stop_consensus_net(nodes + ([joiner] if joiner is not None else []))
