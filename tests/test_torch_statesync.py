"""State sync on the port against the reference on the same inputs:
``statesync/{chunker,store,messages,syncer,reactor}.py``,
``config/statesync.py``, ``libs/flowrate.py``, the snapshot messages of
``abci/types.py`` with their client dispatch and app-conn calls,
``PersistentKVStoreApp``'s snapshot half, ``StateSyncMetrics``,
``node/verify_root.state_sync`` and ``testutil/statesync.py``.

The restated cases of ``tests/test_statesync.py`` (``TestChunker``,
``TestSnapshotStore``, ``TestMessages``, ``TestKVStoreSnapshotHandshake``,
``TestBlockStoreBaseAndPrune``, ``TestBackfillWindowBitExact`` and both
tests of ``TestStateSyncEndToEnd``) run once on each package through the
``pkg`` parameter: the reference test's assertions hold on both. Every
message encodes to the same bytes in each package and decodes from the
other's; one restore of the same chain through each package leaves the
same state, block-store and validator records, app hash and sub-window
dispatches. The reference verifies with its host verifier (the suite's
conftest installs it); the port with the configuration root's guarded
verifier and device executor on ``device="cpu"`` (the kernels' plain
versions) at ``dispatch_deadline=0``. Everything is discrete, so equality
is exact. Every wait is bounded by a deadline, never a sleep.
"""

import dataclasses
from types import SimpleNamespace

import pytest

from tendermint_tpu.abci import types as rabci
from tendermint_tpu.abci.examples.kvstore import PersistentKVStoreApp as RPersistentKVStoreApp
from tendermint_tpu.blockchain.store import BlockStore as RBlockStore
from tendermint_tpu.config.config import StateSyncConfig as RStateSyncConfig
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.libs import flowrate as rflowrate
from tendermint_tpu.libs.db.kv import MemDB as RMemDB
from tendermint_tpu.libs.metrics import StateSyncMetrics as RStateSyncMetrics
from tendermint_tpu.lite.provider import NodeProvider as RNodeProvider
from tendermint_tpu.parallel import commit_verify as rcv
from tendermint_tpu.parallel import planner as rplanner
from tendermint_tpu.proxy import app_conn as rapp_conn
from tendermint_tpu.state import execution as rexec
from tendermint_tpu.state import state_types as rst
from tendermint_tpu.state import store as rsm_store
from tendermint_tpu.statesync import chunker as rchunker
from tendermint_tpu.statesync import messages as rmsgs
from tendermint_tpu.statesync.reactor import StateSyncReactor as RStateSyncReactor
from tendermint_tpu.statesync.store import SnapshotStore as RSnapshotStore
from tendermint_tpu.statesync.syncer import StateSyncer as RStateSyncer
from tendermint_tpu.statesync.syncer import _SnapshotRejected as RSnapshotRejected
from tendermint_tpu.testutil.chain import build_chain as rbuild_chain
import tendermint_tpu.types as rtypes
from tendermint_tpu.types.validator_set import CommitError as RCommitError
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.examples.kvstore import PersistentKVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto.batch import HostBatchVerifier
from tendermint_tpu_torch.libs import flowrate
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.metrics import StateSyncMetrics
from tendermint_tpu_torch.lite.provider import NodeProvider
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import commit_verify as cv
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.parallel.mesh import DeviceMesh
from tendermint_tpu_torch.proxy import app_conn
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state import state_types as st_types
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.statesync import chunker
from tendermint_tpu_torch.statesync import messages as msgs
from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
from tendermint_tpu_torch.statesync.store import SnapshotStore
from tendermint_tpu_torch.statesync.syncer import StateSyncer, _SnapshotRejected
from tendermint_tpu_torch.testutil import chain
from tendermint_tpu_torch.testutil import statesync as hub
from tendermint_tpu_torch.testutil.consensus import wait_for
from tendermint_tpu_torch.types import core
from tendermint_tpu_torch.types.validator_set import CommitError

from tests import test_statesync as rtest

DEADLINE = 60.0

REF = SimpleNamespace(
    name="reference", abci=rabci, App=RPersistentKVStoreApp, BlockStore=RBlockStore,
    Config=RStateSyncConfig, MemDB=RMemDB, Metrics=RStateSyncMetrics,
    NodeProvider=RNodeProvider, cv=rcv, cv_kw={}, planner=rplanner, conn=rapp_conn,
    execution=rexec, st=rst, sm_store=rsm_store, chunker=rchunker, msgs=rmsgs,
    Reactor=RStateSyncReactor, SnapshotStore=RSnapshotStore, Syncer=RStateSyncer,
    Rejected=RSnapshotRejected, CommitError=RCommitError, BlockID=rtypes.BlockID,
    hub_net=rtest._hub_net, CorruptingStore=rtest._CorruptingStore, flowrate=rflowrate,
    build_chain=rbuild_chain, build_kw={})
PORT = SimpleNamespace(
    name="port", abci=abci, App=PersistentKVStoreApp, BlockStore=BlockStore,
    Config=StateSyncConfig, MemDB=MemDB, Metrics=StateSyncMetrics,
    NodeProvider=NodeProvider, cv=cv, cv_kw={"device": "cpu"}, planner=planner,
    conn=app_conn, execution=execution, st=st_types, sm_store=sm_store, chunker=chunker,
    msgs=msgs, Reactor=StateSyncReactor, SnapshotStore=SnapshotStore, Syncer=StateSyncer,
    Rejected=_SnapshotRejected, CommitError=CommitError, BlockID=core.BlockID,
    hub_net=hub.hub_net, CorruptingStore=hub.CorruptingStore, flowrate=flowrate,
    build_chain=chain.build_chain,
    # the chain's own LastCommits through the host oracle: set-up, not the
    # path under test
    build_kw={"verifier": HostBatchVerifier()})
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=lambda ns: ns.name)


@pytest.fixture(autouse=True)
def _verifiers():
    """The reference's host verifier (as its suite's conftest installs it)
    and the port's guarded verifier and device executor on the CPU."""
    rset_batch_verifier(RHostBatchVerifier())
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield root
    verify_root.reset_verify()


# -- TestChunker ----------------------------------------------------------------------------


@PKGS
def test_chunker_round_trip(pkg):
    data = bytes(range(256)) * 5
    snap, chunks = pkg.chunker.make_snapshot(7, data, chunk_size=100)
    assert snap.height == 7 and snap.format == pkg.chunker.SNAPSHOT_FORMAT
    assert snap.chunks == len(chunks) == 13
    assert b"".join(chunks) == data
    hashes = pkg.chunker.chunk_hashes_from_metadata(snap)
    for i, c in enumerate(chunks):
        assert pkg.chunker.verify_chunk(c, i, hashes)


@PKGS
def test_chunker_empty_blob_is_one_empty_chunk(pkg):
    snap, chunks = pkg.chunker.make_snapshot(1, b"")
    assert snap.chunks == 1 and chunks == [b""]
    assert pkg.chunker.verify_chunk(b"", 0, pkg.chunker.chunk_hashes_from_metadata(snap))


@PKGS
def test_chunker_corrupted_chunk_detected(pkg):
    data = bytes(range(256)) + b"tail" * 11
    snap, chunks = pkg.chunker.make_snapshot(3, data, chunk_size=100)
    hashes = pkg.chunker.chunk_hashes_from_metadata(snap)
    assert not pkg.chunker.verify_chunk(b"y" * 100, 1, hashes)
    assert not pkg.chunker.verify_chunk(chunks[0], 1, hashes)  # wrong slot
    assert not pkg.chunker.verify_chunk(chunks[0], 99, hashes)  # bad index


@PKGS
def test_chunker_lying_manifest_rejected(pkg):
    snap, _ = pkg.chunker.make_snapshot(3, b"x" * 300, chunk_size=100)
    with pytest.raises(ValueError, match="manifest root"):
        pkg.chunker.chunk_hashes_from_metadata(dataclasses.replace(snap, hash=b"\xde" * 32))
    with pytest.raises(ValueError, match="manifest"):
        pkg.chunker.chunk_hashes_from_metadata(
            dataclasses.replace(snap, metadata=snap.metadata[:-1]))


@PKGS
def test_chunker_bad_chunk_size_rejected(pkg):
    with pytest.raises(ValueError):
        pkg.chunker.chunk_state(b"abc", chunk_size=0)


@pytest.mark.parametrize("fmt", [1, 2])
def test_snapshots_and_chunks_are_the_references_bytes(fmt):
    """Both formats: the same chunks, manifest, hash, and zlib decode."""
    data = bytes(range(256)) * 41
    rs, rc = rchunker.make_snapshot(9, data, chunk_size=1000, format=fmt)
    ps, pc = chunker.make_snapshot(9, data, chunk_size=1000, format=fmt)
    assert pc == rc and dataclasses.asdict(ps) == dataclasses.asdict(rs)
    assert b"".join(chunker.decode_chunk(c, fmt) for c in pc) == data
    with pytest.raises(ValueError):
        chunker.make_snapshot(1, data, format=3)


# -- TestSnapshotStore ----------------------------------------------------------------------


def _store_with(pkg, heights):
    store = pkg.SnapshotStore(pkg.MemDB())
    for h in heights:
        snap, chunks = pkg.chunker.make_snapshot(h, b"state-at-%d" % h * 20, chunk_size=64)
        store.save(snap, chunks)
    return store


@PKGS
def test_snapshot_store_save_list_load(pkg):
    store = _store_with(pkg, [4, 8, 12])
    assert [s.height for s in store.list()] == [12, 8, 4]  # tallest first
    snap = store.get(8, pkg.chunker.SNAPSHOT_FORMAT)
    assert snap is not None and snap.chunks > 1
    got = b"".join(store.load_chunk(8, snap.format, i) for i in range(snap.chunks))
    assert got == b"state-at-8" * 20
    assert store.load_chunk(8, snap.format, snap.chunks) is None
    assert store.get(99, snap.format) is None


@PKGS
def test_snapshot_store_save_checks_chunk_count(pkg):
    store = pkg.SnapshotStore(pkg.MemDB())
    snap, chunks = pkg.chunker.make_snapshot(1, b"abc")
    with pytest.raises(ValueError):
        store.save(snap, chunks + [b"extra"])


@PKGS
def test_snapshot_store_prune_keeps_tallest(pkg):
    store = _store_with(pkg, [4, 8, 12, 16])
    assert store.prune(keep_recent=2) == 2
    assert [s.height for s in store.list()] == [16, 12]
    assert store.get(4, pkg.chunker.SNAPSHOT_FORMAT) is None
    assert store.load_chunk(4, pkg.chunker.SNAPSHOT_FORMAT, 0) is None
    assert store.prune(keep_recent=2) == 0


def test_snapshot_store_records_are_the_references_bytes():
    r, p = _store_with(REF, [4, 8]), _store_with(PORT, [4, 8])
    assert list(p._db.iterator()) == list(r._db.iterator())


# -- TestMessages -----------------------------------------------------------------------------


def sample_messages(ns):
    snap, _ = ns.chunker.make_snapshot(5, b"z" * 100, chunk_size=40)
    m = ns.msgs
    return [
        m.SnapshotsRequestMessage(),
        m.SnapshotsResponseMessage(snapshots=[snap]),
        m.ChunkRequestMessage(height=5, format=1, index=2),
        m.ChunkResponseMessage(height=5, format=1, index=2, chunk=b"abc"),
        m.ChunkResponseMessage(height=5, format=1, index=0, chunk=b"", missing=True),
        m.LightBlockRequestMessage(height=9),
        m.LightBlockResponseMessage(height=9, full_commit=b"\x01\x02"),
    ]


@PKGS
def test_messages_round_trip(pkg):
    for m in sample_messages(pkg):
        assert pkg.msgs.unmarshal_msg(pkg.msgs.encode_msg(m)) == m


@PKGS
def test_messages_unknown_tag_rejected(pkg):
    with pytest.raises(ValueError):
        pkg.msgs.unmarshal_msg(b"\xff\x00")
    with pytest.raises(Exception):
        pkg.msgs.unmarshal_msg(b"")


@pytest.mark.parametrize("i", range(7))
def test_message_bytes_equal_and_cross_decode(i):
    r, p = sample_messages(REF)[i], sample_messages(PORT)[i]
    rb, pb = rmsgs.encode_msg(r), msgs.encode_msg(p)
    assert pb == rb
    assert dataclasses.asdict(msgs.unmarshal_msg(rb)) == dataclasses.asdict(p)
    assert dataclasses.asdict(rmsgs.unmarshal_msg(pb)) == dataclasses.asdict(r)


# -- TestKVStoreSnapshotHandshake ---------------------------------------------------------------


def _run_blocks(pkg, app, start, stop, txs_for):
    a = pkg.abci
    for h in range(start, stop + 1):
        app.begin_block(a.RequestBeginBlock())
        for tx in txs_for(h):
            assert app.deliver_tx(a.RequestDeliverTx(tx=tx)).code == 0
        app.end_block(a.RequestEndBlock())
        app.commit(a.RequestCommit())


def _producer(pkg, interval=3, chunk_size=32, heights=6):
    app = pkg.App()
    store = pkg.SnapshotStore(pkg.MemDB())
    app.configure_snapshots(store, interval, chunk_size=chunk_size)
    _run_blocks(pkg, app, 1, heights, lambda h: [b"k%d-%d=v%d" % (h, j, h) for j in range(3)])
    app.wait_snapshots()  # production runs off the commit thread
    return app, store


@PKGS
def test_kvstore_producer_snapshots_at_interval(pkg):
    app, store = _producer(pkg, interval=3, heights=7)
    assert [s.height for s in store.list()] == [6, 3]
    snap = store.get(6, pkg.chunker.SNAPSHOT_FORMAT)
    assert len(pkg.chunker.chunk_hashes_from_metadata(snap)) == snap.chunks > 1


@PKGS
def test_kvstore_producer_prunes_old_snapshots(pkg):
    app = pkg.App()
    store = pkg.SnapshotStore(pkg.MemDB())
    app.configure_snapshots(store, 2, keep_recent=2)
    _run_blocks(pkg, app, 1, 10, lambda h: [b"a%d=b" % h])
    app.wait_snapshots()
    assert [s.height for s in store.list()] == [10, 8]


@PKGS
def test_kvstore_restore_round_trip_with_corrupt_chunk_retry(pkg):
    a = pkg.abci
    app, store = _producer(pkg, interval=3, heights=6)
    snap = store.get(6, pkg.chunker.SNAPSHOT_FORMAT)
    app2 = pkg.App()
    res = app2.offer_snapshot(a.RequestOfferSnapshot(snapshot=snap, app_hash=app._app_hash()))
    assert res.result == a.OFFER_SNAPSHOT_ACCEPT
    # an out-of-order chunk is a RETRY, not corruption
    res = app2.apply_snapshot_chunk(a.RequestApplySnapshotChunk(index=1, chunk=b"x"))
    assert res.result == a.APPLY_CHUNK_RETRY
    for i in range(snap.chunks):
        chunk = store.load_chunk(snap.height, snap.format, i)
        if i == 1:
            # a corrupted chunk: refetch it, punish the sender
            res = app2.apply_snapshot_chunk(
                a.RequestApplySnapshotChunk(index=i, chunk=b"garbage", sender="evil-peer"))
            assert res.result == a.APPLY_CHUNK_RETRY
            assert res.refetch_chunks == [i] and res.reject_senders == ["evil-peer"]
        res = app2.apply_snapshot_chunk(a.RequestApplySnapshotChunk(index=i, chunk=chunk))
        assert res.result == a.APPLY_CHUNK_ACCEPT
    assert app2.height == 6 and app2.size == app.size
    assert app2.state == app.state and app2.validators == app.validators
    assert app2._app_hash() == app._app_hash()
    # the restored app persisted the exact snapshot blob
    assert app2._db.get(b"kvstore:state") == app._db.get(b"kvstore:state")


@PKGS
def test_kvstore_offer_rejects_bad_snapshots(pkg):
    a = pkg.abci
    app = pkg.App()
    snap, _ = pkg.chunker.make_snapshot(5, b"blob")
    res = app.offer_snapshot(a.RequestOfferSnapshot(snapshot=dataclasses.replace(snap, format=99)))
    assert res.result == a.OFFER_SNAPSHOT_REJECT_FORMAT
    res = app.offer_snapshot(
        a.RequestOfferSnapshot(snapshot=dataclasses.replace(snap, hash=b"\xab" * 32)))
    assert res.result == a.OFFER_SNAPSHOT_REJECT
    assert app.offer_snapshot(a.RequestOfferSnapshot(snapshot=None)).result == \
        a.OFFER_SNAPSHOT_REJECT
    # apply without an accepted offer aborts
    res = app.apply_snapshot_chunk(a.RequestApplySnapshotChunk(index=0, chunk=b""))
    assert res.result == a.APPLY_CHUNK_ABORT


@pytest.mark.parametrize("fmt", [1, 2])
def test_kvstore_snapshots_are_the_references_and_restore_across(fmt):
    """The producers of both packages store the same snapshot bytes; each
    package's app restores the other's chunks, through the query
    connection's snapshot calls."""
    stores = []
    for ns in (REF, PORT):
        app = ns.App()
        store = ns.SnapshotStore(ns.MemDB())
        app.configure_snapshots(store, 4, chunk_size=40, snapshot_format=fmt)
        _run_blocks(ns, app, 1, 8, lambda h: [b"k%d=v%d" % (h, h), b"x%d" % h])
        app.wait_snapshots()
        stores.append((app, store))
    (rapp, rstore), (papp, pstore) = stores
    assert list(pstore._db.iterator()) == list(rstore._db.iterator())
    assert papp._app_hash() == rapp._app_hash()
    for ns, src_store, src_app in ((PORT, rstore, rapp), (REF, pstore, papp)):
        a = ns.abci
        conn = ns.conn.MultiAppConn(ns.conn.LocalClientCreator(ns.App()))
        conn.start()
        snap = src_store.get(8, fmt)
        offered = a.Snapshot(**dataclasses.asdict(snap))
        assert conn.query.offer_snapshot_sync(
            a.RequestOfferSnapshot(snapshot=offered)).result == a.OFFER_SNAPSHOT_ACCEPT
        for i in range(snap.chunks):
            res = conn.query.apply_snapshot_chunk_sync(a.RequestApplySnapshotChunk(
                index=i, chunk=src_store.load_chunk(8, fmt, i)))
            assert res.result == a.APPLY_CHUNK_ACCEPT
        info = conn.query.info_sync(a.RequestInfo())
        assert (info.last_block_height, info.last_block_app_hash) == (8, src_app._app_hash())
        conn.stop()


def test_the_snapshot_messages_join_the_json_type_table():
    a = abci
    snap, _ = chunker.make_snapshot(3, b"abc" * 50, chunk_size=32)
    for msg in (a.RequestOfferSnapshot(snapshot=snap, app_hash=b"h" * 32),
                a.ResponseListSnapshots(snapshots=[snap, snap]),
                a.ResponseApplySnapshotChunk(result=a.APPLY_CHUNK_RETRY, refetch_chunks=[1],
                                             reject_senders=["p"]),
                a.RequestLoadSnapshotChunk(height=3, format=1, chunk=2)):
        assert a.msg_from_json(a.msg_to_json(msg)) == msg
    names = ("OFFER_SNAPSHOT_UNKNOWN", "OFFER_SNAPSHOT_ACCEPT", "OFFER_SNAPSHOT_ABORT",
             "OFFER_SNAPSHOT_REJECT", "OFFER_SNAPSHOT_REJECT_FORMAT",
             "OFFER_SNAPSHOT_REJECT_SENDER", "APPLY_CHUNK_UNKNOWN", "APPLY_CHUNK_ACCEPT",
             "APPLY_CHUNK_ABORT", "APPLY_CHUNK_RETRY", "APPLY_CHUNK_RETRY_SNAPSHOT",
             "APPLY_CHUNK_REJECT_SNAPSHOT")
    assert [getattr(a, n) for n in names] == [getattr(rabci, n) for n in names]
    # the base application advertises no snapshot support, as the reference's
    base, rbase = a.Application(), rabci.Application()
    assert base.list_snapshots(a.RequestListSnapshots()).snapshots == []
    assert base.offer_snapshot(a.RequestOfferSnapshot()).result == \
        rbase.offer_snapshot(rabci.RequestOfferSnapshot()).result
    assert base.apply_snapshot_chunk(a.RequestApplySnapshotChunk()).result == \
        rbase.apply_snapshot_chunk(rabci.RequestApplySnapshotChunk()).result


# -- TestBlockStoreBaseAndPrune --------------------------------------------------------------


_CHAINS = {}


def cached_chain(pkg, **kw):
    key = (pkg.name,) + tuple(sorted(kw.items()))
    if key not in _CHAINS:
        _CHAINS[key] = pkg.build_chain(**kw, **pkg.build_kw)
    return _CHAINS[key]


@PKGS
def test_block_store_base_tracks_first_block(pkg):
    fx = cached_chain(pkg, n_vals=2, n_heights=8, chain_id="bs-prune")
    assert fx.block_store.base() == 1
    assert pkg.BlockStore(pkg.MemDB()).base() == 0


@PKGS
def test_block_store_prune_drops_history_below_retain(pkg):
    store = pkg.build_chain(n_vals=1, n_heights=6, chain_id="bs-prune-w",
                            **pkg.build_kw).block_store
    assert store.prune(4) == 3
    assert store.base() == 4 and store.height() == 6
    assert store.load_block(3) is None
    assert store.load_block_meta(3) is None and store.load_block_commit(3) is None
    assert store.load_block(4) is not None
    # below base: no-op; above height: clamps, the top block survives
    assert store.prune(2) == 0
    assert store.prune(100) == 2
    assert store.base() == 6 and store.load_block(6) is not None
    store2 = pkg.BlockStore(store._db)  # the base survives a reopen
    assert store2.base() == 6 and store2.height() == 6


@PKGS
def test_block_store_backfill_seeds_empty_store(pkg):
    fx = cached_chain(pkg, n_vals=2, n_heights=8, chain_id="bs-prune")
    metas = [fx.block_store.load_block_meta(h) for h in range(4, 8)]
    commits = [fx.block_store.load_block_commit(h) for h in range(4, 8)]
    store = pkg.BlockStore(pkg.MemDB())
    store.save_statesync_backfill(metas, commits)
    assert store.height() == 7 and store.base() == 4
    # metas and commits served, but no parts: no full blocks
    assert store.load_block_meta(5) is not None and store.load_block_commit(5) is not None
    assert store.load_block(5) is None
    assert store.load_seen_commit(7) is not None
    # fast sync continues contiguously above the seeded top
    block = fx.block_store.load_block(8)
    store.save_block(block, block.make_part_set(), fx.block_store.load_seen_commit(8))
    assert store.height() == 8 and store.base() == 4 and store.load_block(8) is not None


@PKGS
def test_block_store_backfill_rejects_bad_input(pkg):
    fx = cached_chain(pkg, n_vals=2, n_heights=8, chain_id="bs-prune")
    metas = [fx.block_store.load_block_meta(h) for h in (4, 6)]
    commits = [fx.block_store.load_block_commit(h) for h in (4, 6)]
    store = pkg.BlockStore(pkg.MemDB())
    with pytest.raises(ValueError, match="contiguous"):
        store.save_statesync_backfill(metas, commits)
    with pytest.raises(ValueError, match="non-empty"):
        store.save_statesync_backfill([], [])
    with pytest.raises(ValueError, match="empty"):  # only an empty store is seeded
        fx.block_store.save_statesync_backfill([fx.block_store.load_block_meta(4)],
                                               [fx.block_store.load_block_commit(4)])


# -- TestBackfillWindowBitExact --------------------------------------------------------------


def syncer_for(pkg, fx, backfill_blocks=4):
    return pkg.Syncer(pkg.Config(backfill_blocks=backfill_blocks), fx.chain_id, fx.genesis,
                      None, pkg.MemDB(), pkg.BlockStore(pkg.MemDB()), metrics=pkg.Metrics())


def window(pkg, fx, lo, hi):
    provider = pkg.NodeProvider(fx.block_store, fx.state_db)
    return [provider.full_commit_at(fx.chain_id, h) for h in range(lo, hi + 1)]


def bf_chain(pkg):
    return cached_chain(pkg, n_vals=4, n_heights=10, chain_id="bf-chain")


@PKGS
def test_backfill_valid_window_accepted_by_device_and_host(pkg):
    fx = bf_chain(pkg)
    fcs = window(pkg, fx, 6, 9)
    syncer_for(pkg, fx)._verify_backfill_window(fcs)  # no raise
    for fc in fcs:  # the host verifier agrees, height by height
        sh = fc.signed_header
        fc.validators.verify_commit(fx.chain_id, sh.commit.block_id, fc.height, sh.commit)


@PKGS
def test_backfill_device_verdict_matches_per_signature_host_verify(pkg):
    """The batched (H, V) dispatch agrees with per-signature host
    verification, a tampered signature in the middle included."""
    fx = bf_chain(pkg)
    fcs = window(pkg, fx, 6, 9)
    pc = fcs[2].signed_header.commit.precommits[1]
    fcs[2].signed_header.commit.precommits[1] = dataclasses.replace(pc, signature=b"\x00" * 64)
    votes_rows, power_rows, totals = [], [], []
    for fc in fcs:
        sh = fc.signed_header
        pubkeys, ms, sigs, powers = fc.validators.collect_commit_sigs(
            fx.chain_id, sh.commit.block_id, fc.height, sh.commit)
        vrow, prow = pkg.planner.rows_from_commit(sh.commit.precommits,
                                                  [p.bytes() for p in pubkeys], ms, sigs, powers)
        votes_rows.append(vrow)
        power_rows.append(prow)
        totals.append(fc.validators.total_voting_power())
    win = pkg.cv.pack_commit_window(votes_rows, power_rows)
    ok_hv, _, _ = pkg.cv.verify_commit_window(win, max(totals), **pkg.cv_kw)
    for i, fc in enumerate(fcs):
        keys = {v.pub_key.bytes(): v.pub_key for v in fc.validators.validators}
        for v, item in enumerate(votes_rows[i]):
            if item is not None:
                pub, msg, sig = item
                assert bool(ok_hv[i, v]) == keys[pub].verify_bytes(msg, sig), (i, v)
    assert not bool(ok_hv[2, 1])  # the tampered one


@PKGS
def test_backfill_tampered_signature_rejected_like_host(pkg):
    fx = bf_chain(pkg)
    fcs = window(pkg, fx, 6, 9)
    pc = fcs[1].signed_header.commit.precommits[0]
    fcs[1].signed_header.commit.precommits[0] = dataclasses.replace(pc, signature=b"\x11" * 64)
    with pytest.raises(pkg.Rejected, match="invalid signature"):
        syncer_for(pkg, fx)._verify_backfill_window(fcs)
    sh = fcs[1].signed_header
    with pytest.raises(pkg.CommitError, match="invalid signature"):
        fcs[1].validators.verify_commit(fx.chain_id, sh.commit.block_id, fcs[1].height,
                                        sh.commit)


@PKGS
def test_backfill_insufficient_power_rejected_like_host(pkg):
    fx = bf_chain(pkg)
    fcs = window(pkg, fx, 6, 9)
    # 2 of 4 equal-power validators is not > 2/3
    fcs[2].signed_header.commit.precommits[0] = None
    fcs[2].signed_header.commit.precommits[1] = None
    with pytest.raises(pkg.Rejected, match="voting power"):
        syncer_for(pkg, fx)._verify_backfill_window(fcs)
    sh = fcs[2].signed_header
    with pytest.raises(pkg.CommitError, match="voting power"):
        fcs[2].validators.verify_commit(fx.chain_id, sh.commit.block_id, fcs[2].height,
                                        sh.commit)


@PKGS
def test_backfill_empty_window_rejected(pkg):
    with pytest.raises(pkg.Rejected):
        syncer_for(pkg, bf_chain(pkg))._verify_backfill_window([])


def test_the_syncer_refuses_a_mesh():
    """The syncer takes a mesh now: its backfill's pipeline splits each
    sub-window's lanes over the mesh ("planner_mesh") and accepts the
    valid window the flat backfill accepts."""
    fx = bf_chain(PORT)
    mesh = DeviceMesh(["cpu"] * 2)
    syncer = StateSyncer(StateSyncConfig(), fx.chain_id, fx.genesis, None, MemDB(),
                         BlockStore(MemDB()), mesh=mesh)
    assert syncer.mesh is mesh
    syncer._verify_backfill_window(window(PORT, fx, 6, 9))  # no raise
    entry = get_profiler().entries()[-1]
    assert (entry["kind"], entry["n_devices"]) == ("planner_mesh", 2)


# -- TestStateSyncEndToEnd ---------------------------------------------------------------------


def producer_chain(pkg, n_vals=4, n_heights=13, chain_id="ss-e2e", txs=3, interval=4,
                   chunk_size=48):
    """A chain whose kvstore takes a snapshot every ``interval`` heights."""
    snap_store = pkg.SnapshotStore(pkg.MemDB())
    apps = []

    def app_factory():
        app = pkg.App()
        app.configure_snapshots(snap_store, interval, chunk_size=chunk_size)
        apps.append(app)
        return app

    fx = pkg.build_chain(n_vals=n_vals, n_heights=n_heights, chain_id=chain_id,
                         txs_per_block=txs, app_factory=app_factory, **pkg.build_kw)
    for app in apps:
        app.wait_snapshots()  # production runs off the commit thread
    return fx, snap_store


def fast_sync_state(pkg, fx, upto):
    """The chain replayed through a fresh executor: the state a fast-synced
    node reaches at ``upto``."""
    st = pkg.st.state_from_genesis(fx.genesis)
    db = pkg.MemDB()
    pkg.sm_store.save_state(db, st)
    conn = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(pkg.App()))
    conn.start()
    block_exec = pkg.execution.BlockExecutor(db, conn.consensus)
    for h in range(1, upto + 1):
        block = fx.block_store.load_block(h)
        parts = block.make_part_set()
        block_id = pkg.BlockID(hash=block.hash(), parts_header=parts.header())
        st = block_exec.apply_block(st, block_id, block, trusted_last_commit=True)
    return st


def restore(pkg, monkeypatch, fx, snap_store, **cfg_kw):
    """A fresh node restores ``fx``'s tallest snapshot from a good and an
    evil peer over the in-process hub; returns what the reference's test
    observes. The backfill's planner dispatches are counted as (H, V)."""
    app2 = pkg.App()
    conn2 = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(app2))
    conn2.start()
    state_db2, block_store2 = pkg.MemDB(), pkg.BlockStore(pkg.MemDB())
    kw = dict(enable=True, trust_height=1,
              trust_hash=fx.block_store.load_block_meta(1).header.hash().hex(),
              discovery_time=0.25, chunk_fetch_timeout=5.0, chunk_retries=4, backfill_blocks=4)
    kw.update(cfg_kw)
    cfg = pkg.Config(**kw)
    metrics = pkg.Metrics()
    syncer = pkg.Syncer(cfg, fx.chain_id, fx.genesis, conn2.query, state_db2, block_store2,
                        metrics=metrics)
    synced = []
    client = pkg.Reactor(cfg, app_query=conn2.query, block_store=block_store2,
                         state_db=state_db2, syncer=syncer,
                         on_synced=lambda st, h: synced.append(st), metrics=metrics)
    serve_cfg = pkg.Config()
    good = pkg.Reactor(serve_cfg, snapshot_store=snap_store, block_store=fx.block_store,
                       state_db=fx.state_db)
    evil = pkg.Reactor(serve_cfg, snapshot_store=pkg.CorruptingStore(snap_store),
                       block_store=fx.block_store, state_db=fx.state_db)
    dispatches = []
    orig = pkg.planner.execute_plan

    def counting(plan, **k):
        dispatches.append((plan.H, plan.V))
        return orig(plan, **k)

    monkeypatch.setattr(pkg.planner, "execute_plan", counting)
    pkg.hub_net([("peer-client", client), ("peer-good", good), ("peer-evil", evil)])
    try:
        assert wait_for(lambda: synced, timeout=DEADLINE), client.progress()
    finally:
        for r in (client, good, evil):
            r.stop()
    return SimpleNamespace(state=synced[0], app=app2, conn=conn2, state_db=state_db2,
                           block_store=block_store2, client=client, metrics=metrics,
                           dispatches=dispatches)


@PKGS
def test_restore_rejects_corrupt_chunk_verifies_and_backfills(pkg, monkeypatch):
    # snapshots at 4, 8, 12; height 13 exists so that header(13) carries
    # the trusted app hash of the height-12 snapshot
    fx, snap_store = producer_chain(pkg)
    snap = snap_store.get(12, pkg.chunker.SNAPSHOT_FORMAT)
    assert snap is not None and snap.chunks >= 2  # the round robin hits both peers
    got = restore(pkg, monkeypatch, fx, snap_store)
    state, metrics = got.state, got.metrics

    # the evil peer's corrupt chunk was caught and the peer banned; every
    # chunk was then re-requested from the honest peer
    assert "peer-evil" in got.client._banned
    assert metrics.chunk_fetch._values.get(("bad",), 0) >= 1
    assert metrics.chunk_fetch._values.get(("ok",), 0) >= snap.chunks

    # the restored state is what a fast-synced node computes from genesis
    expected = fast_sync_state(pkg, fx, 12)
    assert state.last_block_height == 12 and state.chain_id == fx.chain_id
    assert state.last_block_id == expected.last_block_id
    assert state.app_hash == expected.app_hash
    assert state.last_results_hash == expected.last_results_hash
    assert state.validators.hash() == expected.validators.hash()
    assert state.next_validators.hash() == expected.next_validators.hash()
    assert state.last_validators.hash() == expected.last_validators.hash()
    assert state.last_block_time_ns == expected.last_block_time_ns
    assert state.last_block_total_tx == expected.last_block_total_tx
    meta13 = fx.block_store.load_block_meta(13)
    assert state.app_hash == meta13.header.app_hash

    # the restored app: the exact snapshot blob, the verified app hash
    assert got.app.height == 12
    info = got.conn.query.info_sync(pkg.abci.RequestInfo())
    assert info.last_block_height == 12 and info.last_block_app_hash == meta13.header.app_hash

    # the backfill window [9..12]: one batched (H, V) dispatch
    assert got.dispatches == [(4, 4)]
    bs = got.block_store
    assert bs.height() == 12 and bs.base() == 9 and bs.load_seen_commit(12) is not None
    for h in range(9, 13):
        assert bs.load_block_meta(h) is not None and bs.load_block_commit(h) is not None

    # the restored state DB serves validators for the window and H+1
    for h in range(9, 14):
        assert pkg.sm_store.load_validators(got.state_db, h).hash() == fx.state.validators.hash()
    reloaded = pkg.sm_store.load_state(got.state_db)
    assert reloaded.last_block_height == 12 and reloaded.app_hash == state.app_hash

    prog = got.client.progress()
    assert prog["synced_height"] == 12 and prog["syncing"] is False
    assert prog["chunks_applied"] == snap.chunks


@PKGS
def test_bad_trust_root_is_fatal(pkg):
    """A configured trust hash that the network disagrees with aborts the
    restore, rather than falling through to the next snapshot."""
    fx, snap_store = producer_chain(pkg, n_vals=2, n_heights=9, chain_id="ss-badroot", txs=1)
    app2 = pkg.App()
    conn2 = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(app2))
    conn2.start()
    cfg = pkg.Config(enable=True, trust_height=1, trust_hash="ab" * 32, discovery_time=0.2,
                     chunk_fetch_timeout=3.0)
    syncer = pkg.Syncer(cfg, fx.chain_id, fx.genesis, conn2.query, pkg.MemDB(),
                        pkg.BlockStore(pkg.MemDB()), metrics=pkg.Metrics())
    client = pkg.Reactor(cfg, app_query=conn2.query, syncer=syncer, metrics=pkg.Metrics())
    server = pkg.Reactor(pkg.Config(), snapshot_store=snap_store, block_store=fx.block_store,
                         state_db=fx.state_db)
    pkg.hub_net([("peer-client", client), ("peer-server", server)])
    try:
        assert wait_for(lambda: client._sync_error is not None, timeout=DEADLINE), \
            client.progress()
        assert "trust root mismatch" in client._sync_error
        assert app2.height == 0  # no chunk ever reached the app
    finally:
        client.stop()
        server.stop()


def db_records(db):
    return list(db.iterator())


def test_one_restore_leaves_the_same_records_in_each_package(monkeypatch):
    """The same chain restored through each package: the state DB (state,
    validator and params records, the light client's trust store), the
    block store's records, the app's blob and hash, and the backfill's
    dispatches are equal, byte for byte."""
    got = {}
    for ns in (REF, PORT):
        fx, snap_store = producer_chain(ns, chain_id="ss-parity")
        got[ns.name] = (fx, restore(ns, monkeypatch, fx, snap_store, backfill_blocks=6))
    (rfx, r), (pfx, p) = got["reference"], got["port"]
    assert pfx.block_store.load_block_meta(13).header.hash() == \
        rfx.block_store.load_block_meta(13).header.hash()
    assert p.state.marshal() == r.state.marshal()
    assert db_records(p.state_db) == db_records(r.state_db)
    assert db_records(p.block_store._db) == db_records(r.block_store._db)
    assert p.app._db.get(b"kvstore:state") == r.app._db.get(b"kvstore:state")
    assert p.app._app_hash() == r.app._app_hash()
    assert p.dispatches == r.dispatches == [(6, 4)]
    assert p.client.progress() == r.client.progress()


# -- the configuration root, the metrics, the flow monitor -----------------------------------


def test_state_sync_config_carries_the_references_defaults():
    assert dataclasses.asdict(StateSyncConfig()) == dataclasses.asdict(RStateSyncConfig())
    cfg = StateSyncConfig()
    assert (cfg.backfill_blocks, cfg.chunk_fetch_timeout, cfg.discovery_time,
            cfg.snapshot_chunk_size, cfg.snapshot_format) == (16, 10.0, 1.0, 65536, 1)


def test_statesync_metrics_carry_the_references_names_labels_and_buckets():
    ref, port = RStateSyncMetrics(), StateSyncMetrics()
    attrs = [a for a in vars(ref) if a != "registry"]
    assert attrs == [a for a in vars(port) if a != "registry"]
    for a in attrs:
        r, p = getattr(ref, a), getattr(port, a)
        assert (type(p).__name__, p.name, p.help, p.label_names) == \
            (type(r).__name__, r.name, r.help, r.label_names), a
        assert list(getattr(p, "buckets", ())) == list(getattr(r, "buckets", ())), a


def test_the_flow_monitor_paces_as_the_references():
    for ns in (REF, PORT):
        m = ns.flowrate.Monitor()
        assert m.limit(1000, 0) == 1000  # no cap
        m.update(500)
        st = m.status()
        assert st.bytes == 500 and st.duration >= 0
        # far over budget at 1 byte/s: nothing may go now
        assert m.limit(100, 1) == 0


def test_verify_root_wires_the_serving_and_the_restoring_side():
    """``state_sync`` is None with the section off; with a snapshot
    interval it configures the app's producer; with ``enable`` on an empty
    state it builds the syncer over the installed verifier, whose hand-off
    updates the mempool and starts the fast-sync reactor from the restored
    state."""
    fx = bf_chain(PORT)
    conn = app_conn.MultiAppConn(app_conn.LocalClientCreator(PersistentKVStoreApp()))
    conn.start()
    st0 = st_types.state_from_genesis(fx.genesis)
    assert verify_root.state_sync(None, fx.genesis, conn, st0, MemDB(), BlockStore(MemDB())) \
        is None

    app = PersistentKVStoreApp()
    serving = verify_root.state_sync(StateSyncConfig(snapshot_interval=2, snapshot_format=2),
                                     fx.genesis, conn, fx.state, fx.state_db, fx.block_store,
                                     app=app)
    assert serving.syncer is None and serving.reactor.syncer is None
    assert (app._snapshot_store, app._snapshot_interval, app._snapshot_format) == \
        (serving.snapshot_store, 2, 2)

    calls = []
    mempool = SimpleNamespace(update=lambda h, txs: calls.append(("update", h, list(txs))))
    bc = SimpleNamespace(start_from_statesync=lambda s: calls.append(("bc", s)))
    root = verify_root.state_sync(StateSyncConfig(enable=True), fx.genesis, conn, st0, MemDB(),
                                  BlockStore(MemDB()), mempool=mempool, blockchain_reactor=bc)
    assert root.syncer is not None and root.reactor.syncer is root.syncer
    assert root.syncer.batch_verifier is None  # the installed verifier
    restored = fx.state.copy()
    root.reactor.on_synced(restored, restored.last_block_height)
    assert calls == [("update", restored.last_block_height, []), ("bc", restored)]
    # a node with blocks does not restore
    again = verify_root.state_sync(StateSyncConfig(enable=True), fx.genesis, conn, fx.state,
                                   fx.state_db, fx.block_store)
    assert again.syncer is None
    conn.stop()
