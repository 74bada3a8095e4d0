"""Fast sync on the port against the reference on the same inputs:
``blockchain/messages.py``, ``blockchain/pool.py``, ``blockchain/reactor.py``
(``verify_block_window``, ``BlockchainReactor``), ``p2p/base_reactor.py``,
``node/verify_root.blockchain_reactor`` and ``testutil/fastsync.py``.

The restated cases of ``tests/test_fastsync.py`` (``TestVerifyBlockWindow``,
``TestBlockPool``, ``TestPipelinedVerify``) run once on each package through
the ``pkg`` parameter: the reference test's assertions hold on both, and
where a case observes verdicts, heights or bytes the port's equal the
reference's. The reference verifies with its host verifier (the suite's
conftest installs it); the port with the configuration root's guarded
verifier on ``device="cpu"`` (the kernels' plain versions) at
``dispatch_deadline=0``. Everything is discrete, so equality is exact.

Not restated here: ``TestFastSyncIntegration`` (a late joiner through real
switches and consensus) waits for ROADMAP item 17 (the p2p stack and
consensus); ``TestVerifyBlockWindowSharded`` (the mesh) is restated in
``tests/test_torch_mesh.py``. Every wait is bounded by a deadline.
"""

import base64
import dataclasses
import functools
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.abci.examples import kvstore as rkv
from tendermint_tpu.blockchain import messages as rmsgs
from tendermint_tpu.blockchain import pool as rpool
from tendermint_tpu.blockchain import reactor as rreactor
from tendermint_tpu.blockchain import store as rbstore
from tendermint_tpu.crypto import keys as rkeys
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.libs.db import kv as rkvdb
from tendermint_tpu.proxy import app_conn as rapp_conn
from tendermint_tpu.state import execution as rexec
from tendermint_tpu.state import state_types as rst
from tendermint_tpu.state import store as rstore
from tendermint_tpu.testutil import chain as rchain
import tendermint_tpu.types as rtypes
from tendermint_tpu_torch.abci.examples import kvstore as kv
from tendermint_tpu_torch.blockchain import messages as msgs
from tendermint_tpu_torch.blockchain import pool
from tendermint_tpu_torch.blockchain import reactor
from tendermint_tpu_torch.blockchain import store as bstore
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import keys
from tendermint_tpu_torch.crypto.batch import HostBatchVerifier
from tendermint_tpu_torch.libs.db import kv as kvdb
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.parallel.mesh import DeviceMesh
from tendermint_tpu_torch.proxy import app_conn
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state import state_types as st_types
from tendermint_tpu_torch.state import store
from tendermint_tpu_torch.testutil import chain
from tendermint_tpu_torch.testutil.fastsync import LoopbackSwitch, ServingPeer
from tendermint_tpu_torch.types import core, priv_validator

REF = SimpleNamespace(
    name="reference", msgs=rmsgs, pool=rpool, reactor=rreactor, kv=rkv,
    BlockStore=rbstore.BlockStore, MemDB=rkvdb.MemDB, conn=rapp_conn, execution=rexec,
    st=rst, store=rstore, chain=rchain, BlockID=rtypes.BlockID, MockPV=rtypes.MockPV,
    PrivKeyEd25519=rkeys.PrivKeyEd25519, build_kw={})
PORT = SimpleNamespace(
    name="port", msgs=msgs, pool=pool, reactor=reactor, kv=kv,
    BlockStore=bstore.BlockStore, MemDB=kvdb.MemDB, conn=app_conn, execution=execution,
    st=st_types, store=store, chain=chain, BlockID=core.BlockID, MockPV=priv_validator.MockPV,
    PrivKeyEd25519=keys.PrivKeyEd25519,
    # the chain's own LastCommits through the host oracle: set-up, not the
    # path under test
    build_kw={"verifier": HostBatchVerifier()})
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=lambda ns: ns.name)
DEADLINE = 120.0


@pytest.fixture(autouse=True)
def _verifiers():
    """The reference's host verifier (as its suite's conftest installs it)
    and the port's guarded verifier on the CPU."""
    rset_batch_verifier(RHostBatchVerifier())
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield root
    verify_root.reset_verify()


def wait_for(pred, timeout: float = DEADLINE) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


@functools.lru_cache(maxsize=None)
def vbw_chain(name: str):
    ns = REF if name == "reference" else PORT
    return ns.chain.build_chain(n_vals=4, n_heights=12, chain_id="vbw-chain", **ns.build_kw)


def load_blocks(fx, top=None):
    """Fresh block objects (load_block unmarshals anew) of heights 1..top."""
    return [fx.block_store.load_block(h) for h in range(1, (top or fx.height) + 1)]


def churn_chain(ns, n_heights=12, chain_id="churn-sync", change_at=(5,), joiners=2):
    """4 validators of power 10; at each height of ``change_at`` a
    PersistentKVStoreApp validator tx adds ``joiners`` keys of power 50
    (each takes effect two heights later)."""
    pvs = [ns.MockPV(ns.PrivKeyEd25519.generate(bytes([77 + i]) * 32))
           for i in range(joiners * len(change_at))]

    def on_height(h, st):
        if h in change_at:
            k = change_at.index(h)
            return [b"val:" + base64.b64encode(pv.get_pub_key().bytes()) + b"!50"
                    for pv in pvs[k * joiners:(k + 1) * joiners]]
        return []

    return ns.chain.build_chain(n_vals=4, n_heights=n_heights, chain_id=chain_id,
                                app_factory=ns.kv.PersistentKVStoreApp, on_height=on_height,
                                extra_pvs=pvs, **ns.build_kw)


def fresh_executor(ns, genesis, app_factory=None, verifier=None):
    st = ns.st.state_from_genesis(genesis)
    db = ns.MemDB()
    ns.store.save_state(db, st)
    conn = ns.conn.MultiAppConn(ns.conn.LocalClientCreator(
        (app_factory or ns.kv.KVStoreApp)()))
    conn.start()
    kw = {} if verifier is None else {"verifier": verifier}
    return st, ns.execution.BlockExecutor(db, conn.consensus, **kw)


def outcome(res):
    n_ok, err = res
    return n_ok, None if err is None else (err.bad_index, str(err))


# -- tests/test_fastsync.py::TestVerifyBlockWindow ------------------------------------


def _tamper(blocks):
    pc = blocks[5].last_commit.precommits[0]
    blocks[5].last_commit.precommits[0] = dataclasses.replace(pc, signature=b"\x00" * 64)


def _wrong_block(blocks):
    blocks[3].last_commit.block_id = dataclasses.replace(
        blocks[3].last_commit.block_id, hash=b"\xde" * 32)


def _under_quorum(blocks):
    pcs = blocks[8].last_commit.precommits
    pcs[2] = None
    pcs[3] = None


def window_outcome(ns, mutate=None, top=None):
    fx = vbw_chain(ns.name)
    blocks = load_blocks(fx, top)
    if mutate is not None:
        mutate(blocks)
    return outcome(ns.reactor.verify_block_window(ns.st.state_from_genesis(fx.genesis), blocks))


class TestVerifyBlockWindow:
    @PKGS
    def test_valid_window_verifies_all(self, pkg):
        got = window_outcome(pkg)
        assert got == (11, None)

    @PKGS
    def test_tampered_signature_detected_at_offset(self, pkg):
        got = window_outcome(pkg, _tamper)
        assert got[0] == 4 and got[1] is not None and got[1][0] == 4
        assert got == window_outcome(REF, _tamper)

    @PKGS
    def test_commit_for_wrong_block_rejected(self, pkg):
        got = window_outcome(pkg, _wrong_block)
        assert got[0] == 2 and got[1] is not None and got[1][0] == 2
        assert got == window_outcome(REF, _wrong_block)

    @PKGS
    def test_insufficient_quorum_rejected(self, pkg):
        got = window_outcome(pkg, _under_quorum)
        assert got[0] == 7 and got[1] is not None and "voting power" in got[1][1]
        assert got == window_outcome(REF, _under_quorum)

    @PKGS
    def test_single_block_window_verifies_nothing(self, pkg):
        assert window_outcome(pkg, top=1) == (0, None)

    @PKGS
    def test_window_truncates_at_valset_change_and_full_chain_applies(self, pkg):
        """A window spanning a set change ends at the boundary (not an
        error), and the verify -> apply walk reaches the end of the chain,
        verifying the heights after the change under the new set."""
        fx = churn_chain(pkg)
        blocks = load_blocks(fx)
        st, block_exec = fresh_executor(pkg, fx.genesis, pkg.kv.PersistentKVStoreApp)
        applied = pos = rounds = 0
        walk = []
        while pos < len(blocks) - 1:
            window = blocks[pos:]
            parts_list = []
            n_ok, err = pkg.reactor.verify_block_window(st, window, parts_out=parts_list)
            assert err is None, f"round {rounds}: {err}"
            assert n_ok > 0
            if pos == 0:
                assert n_ok == 6, n_ok  # the set changes at height 7
            for i in range(n_ok):
                block = window[i]
                bid = pkg.BlockID(hash=block.hash(), parts_header=parts_list[i].header())
                st = block_exec.apply_block(st, bid, block, trusted_last_commit=True)
                applied += 1
            walk.append((pos, n_ok))
            pos += n_ok
            rounds += 1
        assert applied == 11  # the tip's commit lives in block 13
        assert st.validators.size == 6
        assert rounds >= 2
        if pkg is PORT:
            assert (walk, st.marshal()) == self._ref_walk()

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _ref_walk():
        fx = churn_chain(REF)
        blocks = load_blocks(fx)
        st, ex = fresh_executor(REF, fx.genesis, REF.kv.PersistentKVStoreApp)
        pos, walk = 0, []
        while pos < len(blocks) - 1:
            parts = []
            n_ok, _ = REF.reactor.verify_block_window(st, blocks[pos:], parts_out=parts)
            for i in range(n_ok):
                b = blocks[pos + i]
                st = ex.apply_block(st, REF.BlockID(hash=b.hash(), parts_header=parts[i].header()),
                                    b, trusted_last_commit=True)
            walk.append((pos, n_ok))
            pos += n_ok
        return walk, st.marshal()


# -- tests/test_fastsync.py::TestBlockPool --------------------------------------------


class _FakeBlock:
    def __init__(self, height):
        self.height = height


class TestBlockPool:
    def _pool(self, pkg, start=1, timeout=0.3):
        requests, errors = [], []
        p = pkg.pool.BlockPool(
            start_height=start,
            request_cb=lambda h, peer: requests.append((h, peer)),
            error_cb=lambda peer, r: errors.append((peer, r)),
            request_timeout=timeout,
        )
        p.start()
        return p, requests, errors

    @PKGS
    def test_requests_fan_out_and_blocks_flow(self, pkg):
        p, requests, errors = self._pool(pkg)
        try:
            p.set_peer_height("peerA", 10)
            assert wait_for(lambda: len(requests) >= 10, timeout=5)
            assert {h for h, _ in requests} == set(range(1, 11))
            for h, peer in list(requests):
                assert p.add_block(peer, _FakeBlock(h))
            window = p.peek_window(100)
            assert [b.height for b in window] == list(range(1, 11))
            for _ in range(10):
                p.pop_first()
            assert p.is_caught_up()
            assert not errors
        finally:
            p.stop()

    @PKGS
    def test_unsolicited_block_rejected(self, pkg):
        p, requests, _ = self._pool(pkg)
        try:
            p.set_peer_height("peerA", 5)
            assert wait_for(lambda: len(requests) >= 5, timeout=5)
            assert not p.add_block("stranger", _FakeBlock(1))
            assert not p.add_block("peerA", _FakeBlock(99))
        finally:
            p.stop()

    @PKGS
    def test_timeout_reassigns_and_reports_peer(self, pkg):
        p, requests, errors = self._pool(pkg, timeout=0.2)
        try:
            p.set_peer_height("slow", 3)
            assert wait_for(lambda: len(requests) >= 3, timeout=5)
            p.set_peer_height("fast", 3)
            assert wait_for(lambda: any(peer == "slow" for peer, _ in errors), timeout=5), \
                "slow peer never reported"
            assert wait_for(lambda: any(peer == "fast" for _, peer in requests), timeout=5), \
                "requests never reassigned"
        finally:
            p.stop()

    @PKGS
    def test_redo_request_identifies_bad_peer(self, pkg):
        p, requests, _ = self._pool(pkg)
        try:
            p.set_peer_height("badpeer", 2)
            assert wait_for(lambda: len(requests) >= 2, timeout=5)
            assert p.add_block("badpeer", _FakeBlock(1))
            assert p.redo_request(1) == "badpeer"
            assert p.peek_window(10) == []
        finally:
            p.stop()


# -- tests/test_fastsync.py::TestPipelinedVerify --------------------------------------


def direct_reactor(pkg, fx, window, verifier, app_factory=None, peer_id=""):
    """A reactor from genesis whose pool holds every block of ``fx``, handed
    over directly (no switch): the sync loop runs synchronously from the
    test's thread."""
    st, ex = fresh_executor(pkg, fx.genesis, app_factory)
    st_store = pkg.BlockStore(pkg.MemDB())
    bc = pkg.reactor.BlockchainReactor(st, ex, st_store, verifier=verifier,
                                       verify_window=window)
    for h in range(1, fx.height + 1):
        bc.pool._requests[h] = pkg.pool._Request(
            height=h, block=fx.block_store.load_block(h), peer_id=peer_id)
    return bc, st_store


class GatedVerifier:
    """Call 1 passes; call 2 (the speculative window) blocks until released."""

    def __init__(self):
        self.calls = 0
        self.started2 = threading.Event()
        self.release2 = threading.Event()

    def verify_ed25519(self, items):
        self.calls += 1
        if self.calls == 2:
            self.started2.set()
            assert self.release2.wait(20), "never released"
        return np.ones((len(items),), dtype=bool)

    verify_secp256k1 = verify_ed25519


class CountingVerifier:
    def __init__(self):
        self.calls = 0

    def verify_ed25519(self, items):
        self.calls += 1
        return np.ones((len(items),), dtype=bool)

    verify_secp256k1 = verify_ed25519


class TestPipelinedVerify:
    @PKGS
    def test_speculative_verify_overlaps_apply(self, pkg):
        fx = pkg.chain.build_chain(n_vals=4, n_heights=12, chain_id="pipe-chain",
                                   **pkg.build_kw)
        gv = GatedVerifier()
        bc, st_store = direct_reactor(pkg, fx, 4, gv)
        # pass 1 verifies blocks 1..4, dispatches the speculation for 5..8
        # and applies 1..4 while call 2 waits at the gate
        bc._try_sync_window()
        assert gv.started2.wait(10), "speculative verify never dispatched"
        assert st_store.height() >= 4, (
            "apply did not proceed while the speculative verify was in flight "
            f"(store at {st_store.height()})")
        assert bc._spec
        gv.release2.set()
        bc._try_sync_window()  # harvests the speculation
        assert st_store.height() >= 8
        for _ in range(4):
            bc._try_sync_window()
        assert st_store.height() == fx.height - 1
        bc.on_stop()

    @PKGS
    def test_speculation_discarded_on_valset_change(self, pkg):
        """A set change during window N voids the speculative window N+1: it
        is verified again, and its stale 'wrong validators_hash' verdict
        never punishes anyone."""
        fx = churn_chain(pkg, chain_id="pipe-churn", change_at=(4,), joiners=1)
        punished = []
        cv = CountingVerifier()
        bc, st_store = direct_reactor(pkg, fx, 4, cv, pkg.kv.PersistentKVStoreApp)
        bc._stop_peer_by_id = lambda pid, reason: punished.append((pid, reason))
        for _ in range(8):
            bc._try_sync_window()
        assert st_store.height() == fx.height - 1
        assert punished == []
        bc.on_stop()


# -- the messages -----------------------------------------------------------------------


def test_messages_equal_the_reference_and_decode_across():
    block = vbw_chain("port").block_store.load_block(5)
    rblock = vbw_chain("reference").block_store.load_block(5)
    assert block.marshal() == rblock.marshal()  # the chains themselves agree
    pairs = [
        (msgs.BlockRequestMessage(7), rmsgs.BlockRequestMessage(7)),
        (msgs.NoBlockResponseMessage(1 << 40), rmsgs.NoBlockResponseMessage(1 << 40)),
        (msgs.BlockResponseMessage(block), rmsgs.BlockResponseMessage(rblock)),
        (msgs.StatusRequestMessage(0), rmsgs.StatusRequestMessage(0)),
        (msgs.StatusResponseMessage(12), rmsgs.StatusResponseMessage(12)),
    ]
    for mine, theirs in pairs:
        data = msgs.encode_msg(mine)
        assert data == rmsgs.encode_msg(theirs), type(mine).__name__
        back, rback = msgs.unmarshal_msg(rmsgs.encode_msg(theirs)), rmsgs.unmarshal_msg(data)
        assert type(back).__name__ == type(rback).__name__ == type(mine).__name__
        assert msgs.encode_msg(back) == rmsgs.encode_msg(rback) == data
    with pytest.raises(ValueError, match="unknown blockchain message tag"):
        msgs.unmarshal_msg(b"\x06\x00")


@pytest.mark.parametrize("n_vals", [1, 64, 1024, 10_000])
def test_auto_verify_window_equals_the_reference(n_vals):
    assert reactor.auto_verify_window(n_vals) == rreactor.auto_verify_window(n_vals)
    assert (reactor.VERIFY_WINDOW, reactor.MAX_WINDOW_SIGS, pool.REQUEST_WINDOW) == (
        rreactor.VERIFY_WINDOW, rreactor.MAX_WINDOW_SIGS, rpool.REQUEST_WINDOW)


# -- the receive half -------------------------------------------------------------------


class RecordingPeer:
    def __init__(self, peer_id="p1"):
        self.id = peer_id
        self.sent = []

    def try_send(self, chan_id, msg_bytes):
        self.sent.append((chan_id, msg_bytes))
        return True


@functools.lru_cache(maxsize=None)
def receive_half(name: str):
    """What a serving reactor over the 12-height chain sends back for a
    BlockRequest of a stored and of a missing height, a StatusRequest, and
    an unsolicited BlockResponse (which it only offers to its pool)."""
    ns = REF if name == "reference" else PORT
    fx = vbw_chain(name)
    st, ex = fresh_executor(ns, fx.genesis)
    bc = ns.reactor.BlockchainReactor(fx.state.copy(), ex, fx.block_store, fast_sync=False)
    peer = RecordingPeer()
    bc.add_peer(peer)
    for msg in (ns.msgs.BlockRequestMessage(3), ns.msgs.BlockRequestMessage(99),
                ns.msgs.StatusRequestMessage(0),
                ns.msgs.BlockResponseMessage(fx.block_store.load_block(4))):
        bc.receive(ns.reactor.BLOCKCHAIN_CHANNEL, peer, ns.msgs.encode_msg(msg))
    channels = [(c.id, c.priority, c.send_queue_capacity, c.recv_message_capacity)
                for c in bc.get_channels()]
    return peer.sent, channels, bc.pool.peek_window(10)


def test_the_receive_half_sends_what_the_reference_sends():
    got, want = receive_half("port"), receive_half("reference")
    assert got[:2] == want[:2]
    sent = got[0]
    assert [type(msgs.unmarshal_msg(b)).__name__ for _, b in sent] == [
        "StatusResponseMessage", "BlockResponseMessage", "NoBlockResponseMessage",
        "StatusResponseMessage"]
    assert msgs.unmarshal_msg(sent[1][1]).block.height == 3
    assert {c for c, _ in sent} == {reactor.BLOCKCHAIN_CHANNEL}
    assert got[2] == want[2] == []  # the unsolicited block was not taken
    assert issubclass(reactor.BlockchainReactor, Reactor)


# -- the replay: the port's reactor against the reference's ----------------------------


def churn2_chain(ns):
    """The two-change chain: joiners at heights 4 and 8 (effective at 6 and
    10), 14 heights."""
    return churn_chain(ns, n_heights=14, chain_id="replay-parity", change_at=(4, 8), joiners=1)


@pytest.fixture(scope="module")
def churn2():
    return {"reference": churn2_chain(REF), "port": churn2_chain(PORT)}


class RecordedWindows:
    """Every verify_block_window call of a reactor module while active:
    (first height, heights verified)."""

    def __init__(self, ns):
        self.ns, self.got, self.mtx = ns, [], threading.Lock()

    def __enter__(self):
        real = self.real = self.ns.reactor.verify_block_window

        def record(st, blocks, *a, **k):
            out = real(st, blocks, *a, **k)
            with self.mtx:
                self.got.append((blocks[0].height, out[0]))
            return out

        self.ns.reactor.verify_block_window = record
        return self.got

    def __exit__(self, *exc):
        self.ns.reactor.verify_block_window = self.real


def hand_fed_replay(ns, fx):
    bc, st_store = direct_reactor(ns, fx, 4, None, ns.kv.PersistentKVStoreApp)
    with RecordedWindows(ns) as windows:
        for _ in range(16):
            bc._try_sync_window()
            if st_store.height() == fx.height - 1:
                break
        bc.on_stop()
    return windows, bc.state.marshal(), st_store.height()


def test_hand_fed_windows_equal_the_reference(churn2):
    got = hand_fed_replay(PORT, churn2["port"])
    want = hand_fed_replay(REF, churn2["reference"])
    assert got == want
    assert got[2] == 13
    # the set changes at 6 and 10 end windows there
    assert {h for h, _ in got[0]} >= {6, 10}


class ConsensusStub:
    def __init__(self):
        self.switched = threading.Event()
        self.state = self.n = None

    def switch_to_consensus(self, state, n):
        self.state, self.n = state, n
        self.switched.set()


class MetricsStub:
    def __init__(self):
        self.values, self.resets = [], 0
        self.fast_syncing = SimpleNamespace(set=self.values.append)

    def reset_block_timer(self):
        self.resets += 1


def loopback_sync(ns, fx):
    st, ex = fresh_executor(ns, fx.genesis, ns.kv.PersistentKVStoreApp)
    st_store = ns.BlockStore(ns.MemDB())
    cons, metrics = ConsensusStub(), MetricsStub()
    bc = ns.reactor.BlockchainReactor(st, ex, st_store, consensus_reactor=cons,
                                      metrics=metrics)
    sw = LoopbackSwitch(bc)
    sw.connect(ServingPeer("server", fx.block_store, codec=ns.msgs))
    bc.start()
    try:
        assert cons.switched.wait(DEADLINE), f"{ns.name}: no switch (store {st_store.height()})"
    finally:
        bc.stop()
    assert sw.stopped == [] and metrics.values == [1, 0] and metrics.resets == 1
    assert cons.n == bc.blocks_synced == fx.height - 1
    stored = [(st_store.load_block(h).hash(), st_store.load_seen_commit(h).marshal())
              for h in range(1, st_store.height() + 1)]
    return cons.state.marshal(), cons.state.app_hash, st_store.height(), stored


def test_loopback_sync_ends_where_the_reference_ends(churn2):
    got = loopback_sync(PORT, churn2["port"])
    want = loopback_sync(REF, churn2["reference"])
    assert got == want
    assert got[2] == 13
    assert got[3] == [(churn2["port"].block_store.load_block(h).hash(),
                       churn2["port"].block_store.load_seen_commit(h).marshal())
                      for h in range(1, 14)]


# -- node/verify_root.blockchain_reactor ------------------------------------------------


def test_verify_root_wires_the_installed_guarded_verifier(_verifiers):
    fx = vbw_chain("port")
    st, ex = fresh_executor(PORT, fx.genesis)
    bc = verify_root.blockchain_reactor(st, ex, PORT.BlockStore(PORT.MemDB()))
    assert bc.verifier is None and bc._fixed_window is None and bc.fast_sync
    assert bc.verify_window == reactor.auto_verify_window(4) == reactor.VERIFY_WINDOW
    for h in range(1, fx.height + 1):
        bc.pool._requests[h] = pool._Request(height=h, block=fx.block_store.load_block(h))
    d0 = _verifiers.verifier.snapshot()["dispatches"]
    bc._try_sync_window()
    assert bc.store.height() == fx.height - 1
    assert _verifiers.verifier.snapshot()["dispatches"] == d0 + 1  # one window, one dispatch
    bc.on_stop()


def test_a_mesh_is_not_ported():
    """The mesh is ported: ``verify_block_window(mesh=)`` splits the
    window's lanes over four CPU shards (the planner's device route,
    "planner_mesh") and verifies what the flat verifier route verifies,
    part for part; ``BlockchainReactor(mesh=)`` keeps its mesh."""
    fx = vbw_chain("port")
    st = PORT.st.state_from_genesis(fx.genesis)
    mesh = DeviceMesh(["cpu"] * 4)
    flat_parts, mesh_parts = [], []
    flat = reactor.verify_block_window(st, load_blocks(fx), parts_out=flat_parts)
    sharded = reactor.verify_block_window(st, load_blocks(fx), parts_out=mesh_parts, mesh=mesh)
    assert flat == sharded == (fx.height - 1, None)
    assert [p.header() for p in flat_parts] == [p.header() for p in mesh_parts]
    entry = get_profiler().entries()[-1]
    assert (entry["kind"], entry["n_devices"]) == ("planner_mesh", 4)
    st, ex = fresh_executor(PORT, fx.genesis)
    assert reactor.BlockchainReactor(st, ex, PORT.BlockStore(PORT.MemDB()), mesh=mesh).mesh is mesh


# -- tools/bench_fastsync ---------------------------------------------------------------


def test_bench_fastsync_prints_the_references_json_line(capsys):
    from tendermint_tpu_torch.tools import bench_fastsync as bf

    assert bf.main(["5", "4", "2", "--null-verify", "--device=cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "fastsync_replay_null_5x4" and line["unit"] == "blocks/s"
    assert line["verifier"] == "null" and line["value"] > 0 and line["vs_baseline"] > 0
    # the replay ends where the chain's build did, at the tip's parent
    chain_ = bf.build(5, 4, verifier=HostBatchVerifier(), keep=(4,))
    run = bf.replay(chain_, bf.NullVerifier(), 2)
    assert run.windows == [2, 2] and run.state.marshal() == chain_.states[4].marshal()
