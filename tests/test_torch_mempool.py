"""The port's mempool (mempool/mempool.py), local ABCI client
(abci/client.py), app connections (proxy/app_conn.py), example apps
(abci/examples/kvstore.py), service and list (libs/service.py, clist.py)
against the reference's on the same inputs.

Every restated case of ``tests/test_mempool_evidence_privval.py::TestMempool``
and of ``tests/test_mempool_qos.py``'s ``TestPriorityLanes``,
``TestRecheckDesync`` (with a copy of its ``DeferredConn`` on each
package's types) and ``TestBatchedCheckTx`` runs once on each package: the
reference test's assertions hold on both, and what each run observes (codes,
pool order, lane sizes, reap order, flush counts) is equal. The seeded
parity case runs one stream of signed txs through the reference's
``Mempool`` + ``SignedKVStoreApp`` and through the port's, serially and
through the port's batched hook on the CPU, then delivers and commits the
reap: codes, pool order, lane sizes, reap order and the app hash are equal.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.abci import types as rabci
from tendermint_tpu.abci.client import ReqRes as RReqRes
from tendermint_tpu.abci.examples import kvstore as rkv
from tendermint_tpu.crypto.hashing import tmhash as rtmhash
from tendermint_tpu.mempool import mempool as rmempool
from tendermint_tpu.proxy import app_conn as rapp_conn
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient, ReqRes
from tendermint_tpu_torch.abci.examples import kvstore as kv
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.crypto.hashing import sha256 as tmhash
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PrivKeySecp256k1
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.clist import CList
from tendermint_tpu_torch.libs.metrics import MempoolMetrics
from tendermint_tpu_torch.libs.service import AlreadyStartedError, BaseService, NotStartedError
from tendermint_tpu_torch.mempool import mempool as pmempool
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.proxy import app_conn
from tendermint_tpu_torch.state.services import MockMempool

REF = SimpleNamespace(name="reference", abci=rabci, kv=rkv, mp=rmempool, conn=rapp_conn,
                      ReqRes=RReqRes, tmhash=rtmhash)
PORT = SimpleNamespace(name="port", abci=abci, kv=kv, mp=pmempool, conn=app_conn,
                       ReqRes=ReqRes, tmhash=tmhash)


@pytest.fixture(autouse=True)
def _clean():
    brk.configure_device_guard(dispatch_deadline=0)
    yield
    brk.reset_device_guard()


def both(scenario):
    """Run ``scenario`` on each package; what each observes is equal."""
    want, got = scenario(REF), scenario(PORT)
    assert got == want
    return got


def make_mempool(ns, app=None, **kw):
    conn = ns.conn.MultiAppConn(ns.conn.LocalClientCreator(app or ns.kv.KVStoreApp()))
    conn.start()
    return ns.mp.Mempool(conn.mempool, **kw), conn


def pool(mp):
    return [memtx.tx for memtx in mp._txs]


# -- tests/test_mempool_evidence_privval.py::TestMempool -------------------------------


class TestMempool:
    def test_check_tx_and_reap(self):
        def scenario(ns):
            mp, _ = make_mempool(ns)
            results = []
            for i in range(5):
                mp.check_tx(b"k%d=v%d" % (i, i), callback=results.append)
            assert mp.size() == 5
            assert all(r.code == 0 for r in results)
            txs = mp.reap_max_bytes_max_gas(-1, -1)
            assert len(txs) == 5
            some = mp.reap_max_bytes_max_gas(2 * (8 + 8), -1)  # a byte budget cuts the reap
            assert len(some) == 2
            return txs, some
        both(scenario)

    def test_cache_rejects_duplicates(self):
        def scenario(ns):
            mp, _ = make_mempool(ns)
            mp.check_tx(b"dup=1")
            with pytest.raises(ns.mp.TxInCacheError):
                mp.check_tx(b"dup=1")
            assert mp.size() == 1
            return pool(mp)
        both(scenario)

    def test_full_mempool(self):
        def scenario(ns):
            mp, _ = make_mempool(ns, size=2)
            mp.check_tx(b"a=1")
            mp.check_tx(b"b=2")
            with pytest.raises(ns.mp.MempoolFullError) as ei:
                mp.check_tx(b"c=3")
            return str(ei.value), pool(mp)
        both(scenario)

    def test_update_removes_committed(self):
        def scenario(ns):
            mp, _ = make_mempool(ns)
            for i in range(4):
                mp.check_tx(b"u%d=%d" % (i, i))
            mp.lock()
            try:
                mp.update(1, [b"u0=0", b"u2=2"])
            finally:
                mp.unlock()
            left = mp.reap_max_bytes_max_gas(-1, -1)
            assert left == [b"u1=1", b"u3=3"]
            with pytest.raises(ns.mp.TxInCacheError):  # a committed tx stays cached
                mp.check_tx(b"u0=0")
            return left
        both(scenario)

    def test_recheck_drops_invalidated(self):
        """CounterApp with serial nonces: after committing nonces 0-1, the
        stale nonce-5 tx left in the pool is dropped by the recheck."""
        def scenario(ns):
            app = ns.kv.CounterApp(serial=False)  # any nonce enters the pool
            mp, _ = make_mempool(ns, app)
            for tx in (b"\x00", b"\x01", b"\x02", b"\x05"):
                mp.check_tx(tx)
            assert mp.size() == 4
            app.serial = True
            app.tx_count = 2
            mp.lock()
            try:
                mp.update(1, [b"\x00", b"\x01"])
            finally:
                mp.unlock()
            mp.flush_app_conn()
            assert mp.reap_max_bytes_max_gas(-1, -1) == [b"\x02"]
            return pool(mp)
        both(scenario)

    def test_txs_available_notification(self):
        def scenario(ns):
            mp, _ = make_mempool(ns)
            mp.enable_txs_available()
            ev = mp.txs_available()
            assert not ev.is_set()
            mp.check_tx(b"n=1")
            assert ev.wait(timeout=1)
            return mp.size()
        both(scenario)


# -- tests/test_mempool_qos.py::TestPriorityLanes ------------------------------------


def lane_mempool(ns, size=100, bounds=(1, 1024), **kw):
    mp, _ = make_mempool(ns, ns.kv.PriorityKVStoreApp(), size=size, lane_bounds=bounds, **kw)
    return mp


class TestPriorityLanes:
    def test_lane_of_thresholds(self):
        def scenario(ns):
            mp = lane_mempool(ns, bounds=(1, 1024))
            assert mp.n_lanes() == 3
            lanes = [mp.lane_of(p) for p in (0, 1, 1023, 1024, 10**9)]
            assert lanes == [0, 1, 1, 2, 2]
            return lanes
        both(scenario)

    def test_reap_serves_high_lanes_first_fifo_within(self):
        def scenario(ns):
            mp = lane_mempool(ns)
            for tx in (b"low0=a", b"pri5:mid0=b", b"pri2000:hi0=c", b"pri7:mid1=d",
                       b"pri1500:hi1=e"):
                mp.check_tx(tx)
            assert mp.lane_sizes() == [1, 2, 2]
            reap = mp.reap_max_bytes_max_gas(-1, -1)
            assert reap == [b"pri2000:hi0=c", b"pri1500:hi1=e", b"pri5:mid0=b",
                            b"pri7:mid1=d", b"low0=a"]
            assert mp.reap_max_txs(2) == [b"pri2000:hi0=c", b"pri1500:hi1=e"]
            return reap, mp.lane_sizes()
        both(scenario)

    def test_full_pool_evicts_lowest_lane_first(self):
        def scenario(ns):
            mp = lane_mempool(ns, size=3, bounds=(10,))
            for tx in (b"low0=a", b"low1=b", b"pri100:hi0=c"):
                mp.check_tx(tx)
            assert mp.size() == 3
            mp.check_tx(b"pri100:hi1=d")  # full: evicts the OLDEST lowest-lane tx
            assert mp.size() == 3
            txs = mp.reap_max_bytes_max_gas(-1, -1)
            assert txs == [b"pri100:hi0=c", b"pri100:hi1=d", b"low1=b"]
            mp.check_tx(b"pri100:hi2=e")
            after = mp.reap_max_bytes_max_gas(-1, -1)
            assert b"low1=b" not in after
            mp.check_tx(b"low0=a")  # the evicted tx may re-enter (dropped, not committed)
            return txs, after
        both(scenario)

    def test_full_pool_rejects_when_no_lower_lane(self):
        def scenario(ns):
            mp = lane_mempool(ns, size=2, bounds=(10,))
            mp.check_tx(b"pri100:hi0=a")
            mp.check_tx(b"pri100:hi1=b")
            results = []
            mp.check_tx(b"pri100:hi2=c", callback=results.append)  # same lane: no eviction
            assert mp.size() == 2
            assert results and results[0].code == ns.mp.CODE_MEMPOOL_FULL
            assert "full" in results[0].log
            mp.check_tx(b"low=x", callback=results.append)  # a low arrival evicts nothing
            assert results[1].code == ns.mp.CODE_MEMPOOL_FULL
            assert mp.size() == 2
            return [(r.code, r.log) for r in results], pool(mp)
        both(scenario)

    def test_eviction_never_exceeds_max_and_prefers_oldest(self):
        def scenario(ns):
            mp = lane_mempool(ns, size=5, bounds=(10, 100))
            prios = [0, 5, 20, 150, 0, 30, 200, 7, 999, 50, 2, 120]
            for i, p in enumerate(prios):
                mp.check_tx(b"pri%d:k%02d=v" % (p, i) if p else b"k%02d=v" % i)
                assert mp.size() <= 5
            assert mp.size() == 5
            reaped = mp.reap_max_bytes_max_gas(-1, -1)
            lanes = [mp.lane_of(ns.kv.PriorityKVStoreApp.tx_priority(t)) for t in reaped]
            assert lanes == sorted(lanes, reverse=True)
            assert mp.lane_sizes()[2] == sum(1 for p in prios if p >= 100)
            return reaped, mp.lane_sizes()
        both(scenario)

    def test_single_lane_keeps_sync_full_error(self):
        def scenario(ns):
            mp, _ = make_mempool(ns, size=1)
            mp.check_tx(b"a=1")
            with pytest.raises(ns.mp.MempoolFullError):
                mp.check_tx(b"b=2")
            return pool(mp)
        both(scenario)


# -- tests/test_mempool_qos.py: DeferredConn, TestRecheckDesync, TestBatchedCheckTx ----


class DeferredConn:
    """A copy of ``tests/test_mempool_qos.py``'s ``DeferredConn`` on one
    package's types: responses can be held back and delivered one by one
    (a socket conn whose CheckTx responses race commits), with the local
    client's order: the global callback first, then the ReqRes completion.
    Its ``check_tx_async`` takes no ``sig_verified``."""

    def __init__(self, ns, app=None):
        self.ns = ns
        self.app = app or ns.kv.PriorityKVStoreApp()
        self._cb = None
        self.deferred = False
        self.pending = []
        self.flushes = 0

    def set_response_callback(self, cb):
        self._cb = cb

    def check_tx_async(self, tx):
        req = self.ns.abci.RequestCheckTx(tx=tx)
        rr = self.ns.ReqRes(req)
        res = self.app.check_tx(req)
        if self.deferred:
            self.pending.append((rr, res))
        else:
            self._complete(rr, res)
        return rr

    def _complete(self, rr, res):
        self._cb(rr.request, res)
        rr.complete(res)

    def deliver(self, n=1):
        for _ in range(n):
            rr, res = self.pending.pop(0)
            self._complete(rr, res)

    def deliver_all(self):
        self.deliver(len(self.pending))

    def flush_async(self):
        self.flushes += 1

    def flush_sync(self):
        pass


def locked_update(mp, height, txs):
    mp.lock()
    try:
        mp.update(height, txs)
    finally:
        mp.unlock()


class TestRecheckDesync:
    def test_commit_mid_recheck_aborts_stale_round(self):
        def scenario(ns):
            conn = DeferredConn(ns)
            mp = ns.mp.Mempool(conn, recheck=True)
            for tx in (b"a=1", b"b=2", b"c=3"):
                mp.check_tx(tx)
            assert mp.size() == 3
            conn.deferred = True
            locked_update(mp, 2, [])  # recheck round 1: 3 responses in flight
            conn.deliver(1)  # a=1 rechecked OK; the cursor now at b=2
            locked_update(mp, 3, [b"b=2"])  # height 3 commits b=2 mid-round
            conn.deliver(2)  # round-1 leftovers drain
            assert mp.size() == 2
            conn.deliver_all()
            assert not conn.pending
            assert sorted(mp.reap_max_bytes_max_gas(-1, -1)) == [b"a=1", b"c=3"]
            assert mp.size() == 2
            conn.deferred = False
            locked_update(mp, 4, [b"a=1"])
            assert mp.reap_max_bytes_max_gas(-1, -1) == [b"c=3"]
            return pool(mp), conn.flushes
        both(scenario)

    def test_cursor_resyncs_after_concurrent_removal(self):
        def scenario(ns):
            conn = DeferredConn(ns)
            mp = ns.mp.Mempool(conn, recheck=True)
            for tx in (b"a=1", b"b=2", b"c=3"):
                mp.check_tx(tx)
            conn.deferred = True
            locked_update(mp, 2, [])
            with mp._mtx:  # a concurrent removal of the tx the cursor points at
                mp._remove_el(mp._tx_map[ns.tmhash(b"a=1")], from_cache=True)
            conn.deliver_all()  # a's response is dropped; b and c resync
            assert mp.size() == 2
            assert sorted(mp.reap_max_bytes_max_gas(-1, -1)) == [b"b=2", b"c=3"]
            return pool(mp)
        both(scenario)

    def test_recheck_removes_newly_invalid_txs(self):
        def scenario(ns):
            class RejectApp(ns.kv.PriorityKVStoreApp):
                def __init__(self):
                    super().__init__()
                    self.reject = set()

                def check_tx(self, req):
                    if req.tx in self.reject:
                        return ns.abci.ResponseCheckTx(code=7, log="stale")
                    return super().check_tx(req)

            conn = DeferredConn(ns, app=RejectApp())
            mp = ns.mp.Mempool(conn, recheck=True)
            for tx in (b"a=1", b"b=2", b"c=3"):
                mp.check_tx(tx)
            conn.app.reject.add(b"b=2")  # committed state invalidated b
            locked_update(mp, 2, [])
            assert mp.reap_max_bytes_max_gas(-1, -1) == [b"a=1", b"c=3"]
            conn.app.reject.discard(b"b=2")
            mp.check_tx(b"b=2")  # b left the cache too: it may be resubmitted
            assert mp.size() == 3
            return pool(mp)
        both(scenario)


class TestBatchedCheckTx:
    def test_batch_one_flushes_per_submission(self):
        def scenario(ns):
            conn = DeferredConn(ns)
            mp = ns.mp.Mempool(conn, checktx_batch=1)
            for i in range(3):
                mp.check_tx(b"t%d=%d" % (i, i))
            assert conn.flushes == 3
            return conn.flushes
        both(scenario)

    def test_batch_flushes_once_per_window(self):
        def scenario(ns):
            conn = DeferredConn(ns)
            mp = ns.mp.Mempool(conn, checktx_batch=3, checktx_batch_wait=60.0)
            seen = []
            mp.batch_check_hook = seen.append
            for i in range(6):
                mp.check_tx(b"t%d=%d" % (i, i))
            assert conn.flushes == 2  # two full windows of three
            assert [len(b) for b in seen] == [3, 3]
            assert mp.size() == 6
            return seen, pool(mp)
        both(scenario)

    def test_partial_batch_flushes_on_deadline(self):
        def scenario(ns):
            conn = DeferredConn(ns)
            mp = ns.mp.Mempool(conn, checktx_batch=8, checktx_batch_wait=0.02)
            mp.check_tx(b"solo=1")
            assert conn.flushes == 0  # below the window: the timer is armed
            deadline = time.monotonic() + 10.0
            while not conn.flushes and time.monotonic() < deadline:
                time.sleep(0.01)
            assert conn.flushes, "the deadline timer never flushed the window"
            assert mp.size() == 1
            return pool(mp)
        both(scenario)

    def test_recheck_batches_through_hook(self):
        def scenario(ns):
            conn = DeferredConn(ns)
            mp = ns.mp.Mempool(conn, recheck=True, recheck_batch=2)
            for i in range(5):
                mp.check_tx(b"r%d=%d" % (i, i))
            flushes_before = conn.flushes
            windows = []
            mp.batch_check_hook = windows.append
            locked_update(mp, 2, [])
            assert [len(w) for w in windows] == [2, 2, 1]  # 5 survivors in windows of 2
            assert conn.flushes - flushes_before == 3
            assert mp.size() == 5
            return windows, pool(mp)
        both(scenario)


# -- the seeded parity case: one signed stream through both packages ---------------


def seeded_stream(seed=11, n_keys=6, n=60):
    """Signed txs of ``n_keys`` ed25519 senders and one secp256k1 sender in a
    seeded order: mostly the next nonce, with payload priorities of every
    lane, replayed nonces, nonce gaps, flipped signature bytes and mutant
    payloads, plus an undecodable tx."""
    rng = np.random.default_rng(seed)
    privs = [PrivKeyEd25519.generate(bytes([0x40 + i]) * 32) for i in range(n_keys)]
    privs.append(PrivKeySecp256k1.generate(b"\x33" * 32))
    nonces = [0] * len(privs)
    txs = []
    for j in range(n):
        k = int(rng.integers(len(privs)))
        prio = (b"", b"pri5:", b"pri2000:")[int(rng.integers(3))]
        roll = rng.random()
        nonce = nonces[k] + 1
        if roll < 0.08:
            nonce = max(1, nonces[k])  # replayed
        elif roll < 0.14:
            nonce += 3  # a gap
        else:
            nonces[k] = nonce
        tx = bytearray(kv.make_signed_tx(privs[k], nonce, prio + b"s%03d=v%d" % (j, k)))
        if 0.14 <= roll < 0.2:
            tx[-1] ^= 1  # a mutant payload
        elif 0.2 <= roll < 0.24 and k < n_keys:
            tx[-12] ^= 0x40  # a flipped signature byte
        txs.append(bytes(tx))
    txs.insert(n // 2, b"\x00undecodable")
    return txs


def run_stream(ns, txs, batched=False, size=40):
    """Push ``txs`` through a lane mempool of ``size`` over SignedKVStoreApp,
    then deliver and commit the reap and update the mempool. Returns what
    parity compares."""
    app = ns.kv.SignedKVStoreApp()
    conn = ns.conn.MultiAppConn(ns.conn.LocalClientCreator(app))
    conn.start()
    feed = None
    if batched:
        cfg = MempoolConfig(size=size, checktx_batch=8, tx_batch_window_ms=5.0)
        root = verify_root.mempool(cfg, conn, app, checktx_batch_wait=0.02, device="cpu")
        mp, feed = root.mempool, root.feed
    else:
        mp = ns.mp.Mempool(conn.mempool, size=size, lane_bounds=(1, 1024))
    try:
        codes = [None] * len(txs)
        for i, tx in enumerate(txs):
            try:
                mp.check_tx(tx, lambda res, _i=i: codes.__setitem__(_i, res.code))
            except ns.mp.MempoolError:
                codes[i] = -1
        if batched:
            mp._flush_checktx_batch()
            deadline = time.monotonic() + 120.0
            while any(c is None for c in codes) and time.monotonic() < deadline:
                time.sleep(0.002)
        admitted = (codes, pool(mp), mp.lane_sizes(), mp.reap_max_bytes_max_gas(-1, -1))
        block = mp.reap_max_txs(16)
        cons = conn.consensus
        cons.begin_block_sync(ns.abci.RequestBeginBlock())
        delivered = [cons.deliver_tx_async(tx).response.code for tx in block]
        cons.end_block_sync(ns.abci.RequestEndBlock(height=1))
        app_hash = cons.commit_sync().data
        locked_update(mp, 1, block)
        after = (pool(mp), mp.lane_sizes(), mp.reap_max_bytes_max_gas(-1, -1))
        return {"admitted": admitted, "delivered": delivered, "app_hash": app_hash,
                "after": after, "serial_verifies": app.serial_verifies,
                "dispatches": None if feed is None else feed.dispatches}
    finally:
        if feed is not None:
            feed.close()
            feed.join(10.0)
        conn.stop()


@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
def test_seeded_stream_equals_the_reference(batched):
    txs = seeded_stream()
    want = run_stream(REF, txs)
    got = run_stream(PORT, txs, batched=batched)
    for key in ("admitted", "delivered", "app_hash", "after"):
        assert got[key] == want[key], key
    codes = got["admitted"][0]
    assert codes.count(0) > 20
    assert {kv.CODE_BAD_TX, kv.CODE_BAD_SIG, kv.CODE_BAD_NONCE} <= set(codes)
    # the reap serves lanes high to low, so some deliveries break a
    # sender's nonce order; both packages agree on which
    assert 0 in got["delivered"] and got["app_hash"]
    if batched:
        # the deliveries verify serially; admission paid none
        assert got["serial_verifies"] == len(got["delivered"])
        assert got["dispatches"] > 0
    else:
        assert got["serial_verifies"] == want["serial_verifies"]


# -- the pieces under the mempool ----------------------------------------------------


def test_local_client_calls_the_global_callback_before_the_request_callback():
    order = []
    client = LocalClient(kv.KVStoreApp())
    client.set_response_callback(lambda req, res: order.append(("global", type(req).__name__)))
    rr = client.request_async(abci.RequestCheckTx(tx=b"a=1"))
    rr.set_callback(lambda req, res: order.append(("request", type(req).__name__)))
    assert order == [("global", "RequestCheckTx"), ("request", "RequestCheckTx")]
    assert rr.wait(1.0).code == abci.CODE_TYPE_OK
    assert client.request_sync(abci.RequestEcho(message="hi")).message == "hi"
    assert isinstance(client.request_async(abci.RequestFlush()).response, abci.ResponseFlush)


def test_app_conns_pass_the_verdict_and_share_one_app():
    app = kv.SignedKVStoreApp()
    conn = app_conn.MultiAppConn(app_conn.LocalClientCreator(app))
    conn.start()
    try:
        priv = PrivKeyEd25519.generate(b"\x05" * 32)
        tx = kv.make_signed_tx(priv, 1, b"k=v")
        seen = []
        conn.mempool.set_response_callback(lambda req, res: seen.append(req.sig_verified))
        assert conn.mempool.check_tx_async(tx, sig_verified=True).response.code == 0
        assert seen == [True] and app.serial_verifies == 0
        cons = conn.consensus
        cons.begin_block_sync(abci.RequestBeginBlock())
        assert cons.deliver_tx_async(tx).response.code == 0
        cons.end_block_sync(abci.RequestEndBlock(height=1))
        assert cons.commit_sync().data == app._app_hash()
        assert app.serial_verifies == 1  # DeliverTx always verifies
        assert conn.query.query_sync(abci.RequestQuery(data=b"k")).value == b"v"
        assert conn.query.info_sync(abci.RequestInfo()).last_block_height == 1
        assert conn.query.echo_sync("e").message == "e"
        with pytest.raises(AlreadyStartedError):
            conn.start()
    finally:
        conn.stop()


@pytest.mark.parametrize("app_name", ["KVStoreApp", "PriorityKVStoreApp", "CounterApp",
                                      "SignedKVStoreApp"])
def test_apps_answer_as_the_reference(app_name):
    """The same request sequence through each app of both packages: every
    response and the final app hash are equal."""
    privs = [PrivKeyEd25519.generate(bytes([0x60 + i]) * 32) for i in range(3)]
    signed = [kv.make_signed_tx(privs[i % 3], i // 3 + 1, b"pri%d:s%d=v" % (i * 700, i))
              for i in range(9)]
    plain = [b"a=1", b"pri1500:b=2", b"c", b"\x00", b"\x01", b"\x03", b"pri9:d=4"]
    txs = signed + plain if app_name == "SignedKVStoreApp" else plain

    def run(ns):
        app = getattr(ns.kv, app_name)()
        out = [app.info(ns.abci.RequestInfo()).last_block_height]
        for tx in txs:
            res = app.check_tx(ns.abci.RequestCheckTx(tx=tx))
            out.append((res.code, res.priority))
        for tx in txs:
            out.append(app.deliver_tx(ns.abci.RequestDeliverTx(tx=tx)).code)
        out.append(app.commit(ns.abci.RequestCommit()).data)
        out.append(app.query(ns.abci.RequestQuery(data=b"a", path="tx")).value)
        info = app.info(ns.abci.RequestInfo())
        out.append((info.data, info.last_block_height, info.last_block_app_hash))
        return out

    assert run(PORT) == run(REF)


def test_clist_walks_past_removed_elements():
    cl = CList()
    els = [cl.push_back(i) for i in range(4)]
    cl.remove(els[1])
    assert list(cl) == [0, 2, 3] and len(cl) == 3
    assert els[1].removed and els[1].next() is els[2]  # a removed element keeps its next
    got = []
    t = threading.Thread(target=lambda: got.append(els[3].next_wait(5.0)))
    t.start()
    el4 = cl.push_back(4)
    t.join(10.0)
    assert got == [el4] and cl.back() is el4 and cl.front() is els[0]


def test_base_service_lifecycle():
    class Svc(BaseService):
        def __init__(self):
            super().__init__("svc")
            self.calls = []

        def on_start(self):
            self.calls.append("start")

        def on_stop(self):
            self.calls.append("stop")

    s = Svc()
    with pytest.raises(NotStartedError):
        s.stop()
    s.start()
    assert s.is_running
    s.stop()
    assert not s.is_running and s.quit_event.is_set()
    s.reset()
    s.start()
    assert s.calls == ["start", "stop", "start"]


def test_metrics_carry_the_reference_names():
    m = MempoolMetrics()
    mp, _ = make_mempool(PORT, kv.PriorityKVStoreApp(), size=2, lane_bounds=(10,),
                         metrics=m)
    for tx in (b"low=1", b"pri100:hi=2", b"pri100:hi2=3", b"pri100:hi3=4"):
        mp.check_tx(tx)
    text = m.registry.expose_text()
    for name in ("mempool_size 2", 'mempool_lane_txs{lane="1"} 2', "mempool_failed_txs 1",
                 'mempool_qos_evicted_total{lane="0"} 1', "mempool_tx_size_bytes_count 3",
                 "mempool_checktx_batch_size_count 4"):
        assert "tendermint_" + name in text, name
    locked_update(mp, 1, [])
    assert "tendermint_mempool_recheck_times 2" in m.registry.expose_text()


def test_mock_mempool_is_a_mempool():
    m = MockMempool()
    m.lock()
    m.unlock()
    assert (m.size(), m.reap_max_bytes_max_gas(-1, -1), m.txs_available()) == (0, [], None)
    assert isinstance(pmempool.Mempool(DeferredConn(PORT)), type(m).__mro__[1])
