"""The port's mempool through the verdict-bearing seam: ``Mempool`` +
``mempool/tx_verify.BatchTxVerifier`` + ``parallel/planner.TxFeed`` on
``device="cpu"``, wired by ``node/verify_root.mempool`` from a
``MempoolConfig``.

``tests/test_tx_batch.py``'s mempool cases restated on the port
(``TestSignedAppSerial``, ``TestBatchedParity``, ``TestRecheckDedupe``,
``TestRecheckDesyncUnderVerdicts``, ``TestGuardFallback`` off the card,
``TestQoSLanesPreserved``), with the app's codes held against the
reference app's; the wiring function; and the seam's failure contract: on a
faked card (a hook whose feed's device is CUDA) a hook that raises, hangs
or returns a verdict list of the wrong length raises out of ``check_tx``,
``update`` or the next call after a timer flush, and the window reaches no
app; off the card the reference's fallback to the app's serial verify
holds. The guard runs with ``dispatch_deadline=0``; every feed is closed
and every wait bounded.
"""

import time

import pytest
import torch

import tests.test_tx_batch as rtx
from tendermint_tpu.abci import types as rabci
from tendermint_tpu.abci.examples import kvstore as rkv
from tendermint_tpu.mempool import mempool as rmempool
from tendermint_tpu.proxy import app_conn as rapp_conn
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.examples import kvstore as kv
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto.hashing import sha256 as tmhash
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PrivKeySecp256k1
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.mempool.mempool import Mempool, TxInCacheError
from tendermint_tpu_torch.mempool.tx_verify import BatchTxVerifier
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.testutil import votes as tv

PRIVS = [PrivKeyEd25519.generate(bytes([i + 1]) * 32) for i in range(8)]
SECP = PrivKeySecp256k1.generate(b"\x77" * 32)
SETTLE = 60.0


@pytest.fixture(autouse=True)
def _clean():
    brk.configure_device_guard(dispatch_deadline=0)
    yield
    brk.reset_device_guard()


@pytest.fixture
def closing():
    """Close every feed and app conn a test made."""
    made = []
    yield made.append
    for obj in made:
        if obj is None:
            continue
        if isinstance(obj, planner.TxFeed):
            obj.close()
            obj.join(10.0)
        else:
            obj.stop()


def settle(pred, timeout=SETTLE):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


def push(mp, txs):
    """Submit txs; per-tx CheckTx codes (None until the window flushes;
    -1 = rejected before the app saw it)."""
    codes = [None] * len(txs)
    for i, tx in enumerate(txs):
        try:
            mp.check_tx(tx, lambda res, _i=i: codes.__setitem__(_i, res.code))
        except TxInCacheError:
            codes[i] = -1
    return codes


def start_conn(app, closing):
    conn = MultiAppConn(LocalClientCreator(app))
    conn.start()
    closing(conn)
    return conn


def feed_mempool(closing, app=None, *, checktx_batch=8, wait=0.005, rows=16, **cfg):
    """(mempool, feed, verifier, app) wired by ``verify_root.mempool`` as the
    node wires them, on the CPU."""
    app = app or kv.SignedKVStoreApp()
    conn = start_conn(app, closing)
    cfg = MempoolConfig(checktx_batch=checktx_batch, tx_batch_window_ms=5.0,
                        tx_batch_rows=rows, **cfg)
    root = verify_root.mempool(cfg, conn, app, checktx_batch_wait=wait, device="cpu")
    closing(root.feed)
    return root.mempool, root.feed, root.verifier, app


def serial_mempool(closing, app=None, **kw):
    app = app or kv.SignedKVStoreApp()
    return Mempool(start_conn(app, closing).mempool, checktx_batch=1, **kw), app


def locked_update(mp, height, txs):
    mp.lock()
    try:
        mp.update(height, txs)
    finally:
        mp.unlock()


def ref_codes(reqs):
    """The reference app's CheckTx codes for the same requests."""
    app = rkv.SignedKVStoreApp()
    out = [app.check_tx(rabci.RequestCheckTx(tx=tx, sig_verified=hint)).code
           for tx, hint in reqs]
    return out, app


def port_codes(reqs):
    app = kv.SignedKVStoreApp()
    out = [app.check_tx(abci.RequestCheckTx(tx=tx, sig_verified=hint)).code
           for tx, hint in reqs]
    return out, app


# -- TestSignedAppSerial --------------------------------------------------------------


class TestSignedAppSerial:
    def test_codes(self):
        mutant = bytearray(kv.make_signed_tx(PRIVS[0], 2, b"k=w"))
        mutant[-1] ^= 1
        reqs = [(kv.make_signed_tx(PRIVS[0], 1, b"k=v"), None), (b"junk", None),
                (bytes(mutant), None), (kv.make_signed_tx(PRIVS[0], 9, b"k=z"), None)]
        got, _ = port_codes(reqs)
        assert got == [abci.CODE_TYPE_OK, kv.CODE_BAD_TX, kv.CODE_BAD_SIG, kv.CODE_BAD_NONCE]
        assert got == ref_codes(reqs)[0]

    def test_checktx_overlay_sequences_nonces_and_commit_resets(self):
        app = kv.SignedKVStoreApp()
        for nonce in (1, 2, 3):
            res = app.check_tx(abci.RequestCheckTx(
                tx=kv.make_signed_tx(PRIVS[0], nonce, b"k=v%d" % nonce)))
            assert res.code == abci.CODE_TYPE_OK
        replay = kv.make_signed_tx(PRIVS[0], 1, b"k=v1")
        assert app.check_tx(abci.RequestCheckTx(tx=replay)).code == kv.CODE_BAD_NONCE
        app.commit(abci.RequestCommit())  # back to committed state (none)
        assert app.check_tx(abci.RequestCheckTx(tx=replay)).code == abci.CODE_TYPE_OK

    def test_deliver_updates_committed_nonces(self):
        tx = kv.make_signed_tx(PRIVS[0], 1, b"k=v")
        for ns, app in ((abci, kv.SignedKVStoreApp()), (rabci, rkv.SignedKVStoreApp())):
            assert app.deliver_tx(ns.RequestDeliverTx(tx=tx)).code == abci.CODE_TYPE_OK
            assert app.nonces[PRIVS[0].pub_key().bytes()] == 1
            assert app.state[b"k"] == b"v"
            assert app.deliver_tx(ns.RequestDeliverTx(tx=tx)).code == kv.CODE_BAD_NONCE
            assert app.commit(ns.RequestCommit()).data == app._app_hash()

    def test_sig_verified_hint_is_trusted(self):
        reqs = [(kv.make_signed_tx(PRIVS[0], 1, b"k=v"), True),
                (kv.make_signed_tx(PRIVS[1], 1, b"j=w"), False),
                (kv.make_signed_tx(PRIVS[2], 1, b"m=x"), None)]
        got, app = port_codes(reqs)
        assert got == [abci.CODE_TYPE_OK, kv.CODE_BAD_SIG, abci.CODE_TYPE_OK]
        assert app.serial_verifies == 1  # only the None hint paid its own verify
        want, rapp = ref_codes(reqs)
        assert (got, app.serial_verifies) == (want, rapp.serial_verifies)

    def test_priority_rides_payload(self):
        res = kv.SignedKVStoreApp().check_tx(abci.RequestCheckTx(
            tx=kv.make_signed_tx(PRIVS[0], 1, b"pri2000:k=v")))
        assert res.priority == 2000


# -- TestBatchedParity -----------------------------------------------------------------


class TestBatchedParity:
    def test_bit_parity_with_serial_checktx(self, closing):
        txs = tv.mixed_stream()
        assert txs == rtx.mixed_stream()  # the reference test's stream
        serial_mp, serial_app = serial_mempool(closing)
        serial_codes = push(serial_mp, txs)
        assert settle(lambda: all(c is not None for c in serial_codes))
        assert serial_app.serial_verifies > 0
        mp, feed, ver, app = feed_mempool(closing, checktx_batch=8)
        codes = push(mp, txs)
        mp._flush_checktx_batch()
        assert settle(lambda: all(c is not None for c in codes))
        assert codes == serial_codes
        assert app.serial_verifies == 0  # the feed, not the app, paid for the signatures
        assert feed.dispatches > 0 and ver.submitted > 0
        assert ver.unsigned == 1  # the undecodable tx fell to the app
        assert mp.size() == serial_mp.size()

    def test_duplicate_rejected_at_cache(self, closing):
        mp, _, _, _ = feed_mempool(closing, checktx_batch=4)
        tx = kv.make_signed_tx(PRIVS[0], 1, b"dup=1")
        mp.check_tx(tx)
        with pytest.raises(TxInCacheError):
            mp.check_tx(tx)

    def test_secp_rides_host_lane_through_feed(self, closing):
        mp, _, ver, app = feed_mempool(closing, checktx_batch=2)
        codes = push(mp, [kv.make_signed_tx(SECP, 1, b"s=1"),
                          kv.make_signed_tx(PRIVS[0], 1, b"e=1")])
        assert settle(lambda: all(c is not None for c in codes))
        assert codes == [0, 0]
        assert app.serial_verifies == 0  # the secp256k1 tx verified on the feed too
        assert ver.submitted == 2


# -- TestRecheckDedupe -----------------------------------------------------------------


class TestRecheckDedupe:
    def test_recheck_answers_from_verdict_cache(self, closing):
        mp, feed, ver, app = feed_mempool(closing, checktx_batch=4)
        push(mp, [kv.make_signed_tx(p, 1, b"rk%d=v" % i) for i, p in enumerate(PRIVS[:4])])
        assert settle(lambda: mp.size() == 4)
        submitted, hits, dispatches = ver.submitted, ver.cache_hits, feed.dispatches
        app.commit(abci.RequestCommit())  # resets the app's CheckTx nonce overlay
        locked_update(mp, 2, [])
        assert mp.size() == 4
        assert (ver.submitted, feed.dispatches) == (submitted, dispatches)  # no re-dispatch
        assert ver.cache_hits >= hits + 4
        assert app.serial_verifies == 0

    def test_cache_bounded(self, closing):
        feed = planner.TxFeed(window_s=0.005, device="cpu")
        closing(feed)
        ver = BatchTxVerifier(feed, kv.extract_signed_tx_sig, cache_size=2)
        ver([kv.make_signed_tx(PRIVS[0], n, b"cb%d=v" % n) for n in range(1, 5)])
        assert len(ver._cache) == 2  # FIFO-evicted down to the bound


# -- TestRecheckDesyncUnderVerdicts ----------------------------------------------------


class DeferredConn:
    """``tests/test_mempool_qos.py``'s ``DeferredConn`` on the port's types:
    responses held back and delivered one by one; ``check_tx_async`` takes
    no ``sig_verified`` (the mempool's signature probe)."""

    def __init__(self, app=None):
        self.app = app or kv.PriorityKVStoreApp()
        self._cb = None
        self.deferred = False
        self.pending = []

    def set_response_callback(self, cb):
        self._cb = cb

    def check_tx_async(self, tx):
        from tendermint_tpu_torch.abci.client import ReqRes

        req = abci.RequestCheckTx(tx=tx)
        rr = ReqRes(req)
        res = self.app.check_tx(req)
        if self.deferred:
            self.pending.append((rr, res))
        else:
            self._cb(rr.request, res)
            rr.complete(res)
        return rr

    def deliver(self, n=1):
        for _ in range(n):
            rr, res = self.pending.pop(0)
            self._cb(rr.request, res)
            rr.complete(res)

    def deliver_all(self):
        self.deliver(len(self.pending))

    def flush_async(self):
        pass

    def flush_sync(self):
        pass


class TestRecheckDesyncUnderVerdicts:
    def test_commit_mid_recheck_aborts_stale_round(self, closing):
        conn = DeferredConn()
        mp = Mempool(conn, recheck=True)
        feed = planner.TxFeed(window_s=0.005, device="cpu")
        closing(feed)
        # plain "a=1" txs are not signed txs: every verdict is None, the app
        # decides; the deferred-send plumbing is under test
        mp.set_batch_check_hook(BatchTxVerifier(feed, kv.extract_signed_tx_sig), verdicts=True)
        for tx in (b"a=1", b"b=2", b"c=3"):
            mp.check_tx(tx)
        mp._flush_checktx_batch()
        assert mp.size() == 3
        conn.deferred = True
        locked_update(mp, 2, [])  # recheck round 1: 3 responses in flight
        conn.deliver(1)
        locked_update(mp, 3, [b"b=2"])  # a commit lands mid-round
        conn.deliver(2)  # round-1 leftovers drain
        assert mp.size() == 2
        conn.deliver_all()
        assert not conn.pending
        assert sorted(mp.reap_max_bytes_max_gas(-1, -1)) == [b"a=1", b"c=3"]
        assert mp.size() == 2


# -- TestGuardFallback, off the card ---------------------------------------------------


class TestGuardFallback:
    def test_quarantined_breaker_still_resolves_correct_verdicts(self, closing):
        """Off the card a quarantined breaker sends the flush to the host:
        every CheckTx still gets the right verdict, the app pays none."""
        app = kv.SignedKVStoreApp()
        mp = Mempool(start_conn(app, closing).mempool, checktx_batch=3,
                     checktx_batch_wait=0.005)
        feed = planner.TxFeed(window_s=0.005, device="cpu", verifier=tbatch.GuardedBatchVerifier(
            tbatch.TorchBatchVerifier("cpu")))
        closing(feed)
        ver = BatchTxVerifier(feed, kv.extract_signed_tx_sig, height_fn=mp.height)
        mp.set_batch_check_hook(ver, verdicts=True)
        brk.get_device_breaker().quarantine("tx_batch_test")
        try:
            bad = bytearray(kv.make_signed_tx(PRIVS[1], 1, b"q2=b"))
            bad[-1] ^= 1
            codes = push(mp, [kv.make_signed_tx(PRIVS[0], 1, b"q1=a"), bytes(bad),
                              kv.make_signed_tx(PRIVS[2], 1, b"q3=c")])
            assert settle(lambda: all(c is not None for c in codes))
        finally:
            brk.get_device_breaker().reset()
        assert codes == [0, kv.CODE_BAD_SIG, 0]
        assert ver.feed_errors == 0
        assert app.serial_verifies == 0


# -- TestQoSLanesPreserved -------------------------------------------------------------


class TestQoSLanesPreserved:
    def test_lane_assignment_matches_serial_path(self, closing):
        txs = [kv.make_signed_tx(PRIVS[0], 1, b"lo=1"),          # lane 0
               kv.make_signed_tx(PRIVS[1], 1, b"pri50:mid=2"),    # lane 1
               kv.make_signed_tx(PRIVS[2], 1, b"pri2000:hi=3"),   # lane 2
               kv.make_signed_tx(PRIVS[3], 1, b"pri60:mid2=4")]   # lane 1

        def lanes_and_reap(mp):
            codes = push(mp, txs)
            assert settle(lambda: all(c is not None for c in codes))
            assert codes == [0, 0, 0, 0]
            return mp.lane_sizes(), mp.reap_max_bytes_max_gas(-1, -1)

        serial, _ = serial_mempool(closing, lane_bounds=(1, 1024))
        batched, _, _, _ = feed_mempool(closing, checktx_batch=4)
        want = lanes_and_reap(serial)
        assert lanes_and_reap(batched) == want
        assert want[0] == [1, 2, 1] and want[1][0].endswith(b"pri2000:hi=3")


# -- the wiring function -------------------------------------------------------------------


def test_the_wiring_follows_the_mempool_section(closing):
    app = kv.SignedKVStoreApp()
    conn = start_conn(app, closing)
    # the defaults: no batched ingest, the reference's serial app path
    root = verify_root.mempool(None, conn, app, height=3)
    assert (root.feed, root.verifier) == (None, None)
    mp = root.mempool
    assert mp.batch_check_hook is None and mp.height() == 3
    assert (mp._max_size, mp.cache._size, mp._recheck_enabled) == (5000, 10000, True)
    assert mp.n_lanes() == 3 and mp._checktx_batch == 1
    # an app with no extractor keeps the serial path at any window
    cfg = MempoolConfig(size=64, cache_size=128, lane_bounds=(), checktx_batch=16,
                        recheck_batch=4, tx_batch_window_ms=7.0, tx_batch_rows=32)
    plain = kv.KVStoreApp()
    assert verify_root.mempool(cfg, start_conn(plain, closing), plain, device="cpu").feed is None
    root = verify_root.mempool(cfg, conn, app, checktx_batch_wait=0.2, device="cpu")
    closing(root.feed)
    mp, feed, ver = root
    assert mp.batch_check_hook is ver and mp._hook_verdicts
    assert (mp._max_size, mp.cache._size, mp.n_lanes()) == (64, 128, 1)
    assert (mp._checktx_batch, mp._recheck_batch, mp._checktx_batch_wait) == (16, 4, 0.2)
    assert (feed.window_s, feed.max_rows, feed.device.type) == (0.007, 32, "cpu")
    assert isinstance(feed.verifier, tbatch.RLCHostVerifier)  # the CPU's default
    assert ver.feed is feed and ver.height_fn == mp.height
    assert ver.extractor is kv.SignedKVStoreApp.tx_sig_extractor
    assert not brk.on_card(ver)
    with pytest.raises(NotImplementedError):
        verify_root.mempool(MempoolConfig(wal_path="data/mempool.wal"), conn, app)
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):  # the card unless the caller asks for the CPU
            verify_root.mempool(cfg, conn, app)


def test_the_config_equals_the_reference():
    from dataclasses import asdict

    from tendermint_tpu.config.config import MempoolConfig as RMempoolConfig

    assert asdict(MempoolConfig()) == asdict(RMempoolConfig())


def test_the_wired_mempool_equals_the_serial_one_on_the_bench_stream(closing):
    """``scripts/bench_mempool.py --signed`` at a small width: its valid txs
    then its mixed stream, through a serial mempool and the wired one; the
    codes, pools, lanes and reaps are equal and the app paid no verify."""
    _, txs, mixed = tv.signed_stream(n=24, n_keys=6)

    def run(mp):
        codes = push(mp, txs + mixed)
        mp._flush_checktx_batch()
        assert settle(lambda: all(c is not None for c in codes))
        return codes, [m.tx for m in mp._txs], mp.lane_sizes(), mp.reap_max_txs(-1)

    serial, _ = serial_mempool(closing, lane_bounds=(1, 1024))
    want = run(serial)
    mp, feed, ver, app = feed_mempool(closing, checktx_batch=16, wait=0.05, rows=64)
    assert run(mp) == want
    assert want[0][:24] == [0] * 24 and want[0].count(0) == 30
    # a window's submissions may outlast the feed's 5 ms and split a flush
    assert app.serial_verifies == 0 and ver.windows == 3 and feed.dispatches >= 3


# -- the failure contract -------------------------------------------------------------------


class _CardFeed:
    """A feed that claims the card: its tickets never resolve (``hang``) or
    resolve with ``err`` (what the guard or the feed raised)."""

    device = torch.device("cuda")

    def __init__(self, err=None):
        self.err = err

    def submit(self, group_key, pub, msg, sig):
        ticket = planner.TxTicket()
        if self.err is not None:
            ticket._resolve(err=self.err)
        return ticket

    def flush_now(self):
        pass


class CardHook:
    """A verdict hook on a faked card: a working ``BatchTxVerifier`` on a CPU
    feed until ``fault`` is set, then a ``BatchTxVerifier`` on a failing
    card feed (``raise``: the guard's ``DeviceDispatchError``; ``flaky``:
    another error of the feed; ``hang``: a flush that never completes) or
    the working verdicts one short (``short``)."""

    device = torch.device("cuda")

    def __init__(self, feed):
        self.ok = BatchTxVerifier(feed, kv.extract_signed_tx_sig)
        self.fault = None
        self.calls = 0

    def __call__(self, txs):
        self.calls += 1
        if self.fault is None:
            return self.ok(txs)
        if self.fault == "short":
            return self.ok(txs)[:-1]
        err = {"raise": brk.DeviceDispatchError("error", "tx feed flush"),
               "flaky": RuntimeError("flaky"), "hang": None}[self.fault]
        return BatchTxVerifier(_CardFeed(err), kv.extract_signed_tx_sig, timeout_s=0.05)(txs)


FAULTS = ("raise", "flaky", "hang", "short")


def expect(fault):
    if fault == "flaky":
        return pytest.raises(RuntimeError, match="flaky")
    return pytest.raises(brk.DeviceDispatchError,
                         match="timeout" if fault == "hang" else None)


def card_mempool(closing, **kw):
    app = kv.SignedKVStoreApp()
    mp = Mempool(start_conn(app, closing).mempool, lane_bounds=(1, 1024), **kw)
    feed = planner.TxFeed(window_s=0.005, device="cpu")
    closing(feed)
    hook = CardHook(feed)
    mp.set_batch_check_hook(hook, verdicts=True)
    assert brk.on_card(hook)
    return mp, hook, app


def in_cache(mp, tx):
    return tmhash(tx) in mp.cache._map


@pytest.mark.parametrize("fault", FAULTS)
def test_on_the_card_a_failed_checktx_window_raises_and_admits_nothing(closing, fault):
    mp, hook, app = card_mempool(closing, checktx_batch=2, checktx_batch_wait=60.0)
    txs = [kv.make_signed_tx(PRIVS[0], 1, b"f1=a"), kv.make_signed_tx(PRIVS[1], 1, b"f2=b")]
    hook.fault = fault
    codes = [None, None]
    mp.check_tx(txs[0], lambda res: codes.__setitem__(0, res.code))
    with expect(fault):
        mp.check_tx(txs[1], lambda res: codes.__setitem__(1, res.code))  # the inline flush
    assert codes == [None, None] and mp.size() == 0 and app.serial_verifies == 0
    assert not in_cache(mp, txs[0]) and not in_cache(mp, txs[1])
    hook.fault = None  # a resubmission is admitted
    assert push(mp, txs) == [0, 0] and mp.size() == 2 and app.serial_verifies == 0


@pytest.mark.parametrize("fault", FAULTS)
def test_on_the_card_a_failed_recheck_window_raises_out_of_update(closing, fault):
    mp, hook, app = card_mempool(closing, checktx_batch=3, checktx_batch_wait=60.0)
    txs = [kv.make_signed_tx(p, 1, b"r%d=v" % i) for i, p in enumerate(PRIVS[:3])]
    assert push(mp, txs) == [0, 0, 0] and mp.size() == 3
    app.commit(abci.RequestCommit())
    hook.fault = fault
    with expect(fault):
        locked_update(mp, 2, [])
    # the window was revalidated by no app: it leaves the pool and the cache
    assert mp.size() == 0 and mp.lane_sizes() == [0, 0, 0] and not mp._rechecking
    assert app.serial_verifies == 0 and not any(in_cache(mp, tx) for tx in txs)
    hook.fault = None
    assert push(mp, txs) == [0, 0, 0] and mp.size() == 3
    app.commit(abci.RequestCommit())
    locked_update(mp, 3, [])  # the next round is clean
    assert mp.size() == 3 and app.serial_verifies == 0


@pytest.mark.parametrize("call", ["check_tx", "update", "explicit_flush", "flush_app_conn"])
def test_on_the_card_a_timer_flush_failure_raises_from_the_next_call(closing, call):
    mp, hook, app = card_mempool(closing, checktx_batch=8, checktx_batch_wait=0.01)
    tx = kv.make_signed_tx(PRIVS[0], 1, b"t=1")
    hook.fault = "raise"
    mp.check_tx(tx)  # below the window: the wait timer flushes it
    assert settle(lambda: mp._deferred_error is not None)
    assert mp.size() == 0 and app.serial_verifies == 0 and not in_cache(mp, tx)
    hook.fault = None
    other = kv.make_signed_tx(PRIVS[1], 1, b"u=1")
    run = {"check_tx": lambda: mp.check_tx(other),
           "update": lambda: locked_update(mp, 1, []),
           "explicit_flush": mp._flush_checktx_batch,
           "flush_app_conn": mp.flush_app_conn}[call]
    with pytest.raises(brk.DeviceDispatchError):
        run()
    run()  # raised once, then cleared
    mp._flush_checktx_batch()
    codes = push(mp, [tx])
    mp._flush_checktx_batch()
    assert codes == [0] and app.serial_verifies == 0


@pytest.mark.parametrize("fault", ["raise", "short", "hang"])
def test_off_the_card_a_failed_hook_falls_back_to_the_app(closing, fault):
    """The reference's contract off the card: the window goes to the app's
    serial verify with ``sig_verified=None``, and the codes equal the
    reference mempool's under the same failing hook."""
    txs = tv.mixed_stream()[:8]

    def failing(mempool_cls, conn):
        mp = mempool_cls(conn.mempool, checktx_batch=4, checktx_batch_wait=60.0)
        feed = planner.TxFeed(window_s=0.005, device="cpu")
        closing(feed)
        ok = BatchTxVerifier(feed, kv.extract_signed_tx_sig, timeout_s=0.05)
        if fault == "hang":  # a CPU feed that never answers: every verdict None
            ok = BatchTxVerifier(type("F", (_CardFeed,), {"device": torch.device("cpu")})(),
                                 kv.extract_signed_tx_sig, timeout_s=0.05)

        def hook(batch):
            if fault == "raise":
                raise RuntimeError("flush failed")
            out = ok(batch)
            return out[:-1] if fault == "short" else out
        mp.set_batch_check_hook(hook, verdicts=True)
        return mp

    app = kv.SignedKVStoreApp()
    mp = failing(Mempool, start_conn(app, closing))
    codes = push(mp, txs)
    rapp = rkv.SignedKVStoreApp()
    rconn = rapp_conn.MultiAppConn(rapp_conn.LocalClientCreator(rapp))
    rconn.start()
    closing(rconn)
    want = push(failing(rmempool.Mempool, rconn), txs)
    assert codes == want and None not in codes
    assert app.serial_verifies == rapp.serial_verifies == len(txs)


def test_concurrent_submitters_and_the_wait_timer_admit_every_tx_once(closing):
    """Eight threads submit at once while the wait timer also flushes
    windows, under a short switch interval: every tx reaches the app once
    with its batched verdict, and the pool holds each exactly once."""
    import sys
    import threading

    privs = [PrivKeyEd25519.generate(bytes([0x90, i]) * 16) for i in range(64)]
    txs = [kv.make_signed_tx(p, 1, b"c%02d=v" % i) for i, p in enumerate(privs)]
    mp, feed, ver, app = feed_mempool(closing, checktx_batch=8, wait=0.002)
    codes = [None] * len(txs)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda k=k: [
            mp.check_tx(txs[i], lambda res, _i=i: codes.__setitem__(_i, res.code))
            for i in range(k, len(txs), 8)]) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SETTLE)
        assert not any(t.is_alive() for t in threads)
        mp._flush_checktx_batch()
        assert settle(lambda: all(c is not None for c in codes))
    finally:
        sys.setswitchinterval(interval)
    assert codes == [0] * len(txs)
    pooled = [m.tx for m in mp._txs]
    assert len(pooled) == len(set(pooled)) == len(txs) and set(pooled) == set(txs)
    assert app.serial_verifies == 0 and ver.submitted == len(txs)
