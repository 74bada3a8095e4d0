"""The port's signed-tx codec (abci/examples/kvstore.py), ``TxFeed``
(parallel/planner.py) and ``BatchTxVerifier`` (mempool/tx_verify.py)
against the reference's on the same seeded txs, exactly: the codec's bytes,
``TestSignedTxCodec`` and ``TestTxFeed`` of ``tests/test_tx_batch.py``
restated on ``device="cpu"``, and ``BatchTxVerifier``'s verdicts on the
mixed streams equal to the reference's and to a serial decode +
``verify_bytes``. The mempool is not ported, so the recheck is driven on
the hook itself. Every feed is closed, every wait bounded; the guard runs
with ``dispatch_deadline=0``."""

import time

import pytest
import torch

import tests.test_tx_batch as rtx
from tendermint_tpu.abci.examples import kvstore as rkv
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as RPrivKeyEd25519
from tendermint_tpu.crypto.keys import PrivKeySecp256k1 as RPrivKeySecp256k1
from tendermint_tpu.mempool.tx_verify import BatchTxVerifier as RBatchTxVerifier
from tendermint_tpu.parallel import planner as rplanner
from tendermint_tpu_torch.abci.examples import kvstore as kv
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto.keys import (
    PrivKeyEd25519,
    PrivKeySecp256k1,
    PubKeyEd25519,
    PubKeySecp256k1,
)
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import get_mempool_batch_metrics, get_verify_metrics
from tendermint_tpu_torch.mempool.tx_verify import BatchTxVerifier
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.parallel.mesh import DeviceMesh
from tendermint_tpu_torch.testutil import votes as tv

LONG = 30.0
TIMEOUT = 120.0
PRIVS = [PrivKeyEd25519.generate(bytes([i + 1]) * 32) for i in range(8)]
SECP = PrivKeySecp256k1.generate(b"\x77" * 32)
ROUTES = ("verifier", "executor", "rlc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    brk.configure_device_guard(dispatch_deadline=0)
    planner.set_device_executor(planner.device_executor("cpu"))
    tbatch.set_batch_verifier(tbatch.TorchBatchVerifier("cpu"))
    yield
    planner.set_device_executor(None)
    tbatch.set_batch_verifier(None)
    brk.reset_device_guard()


@pytest.fixture
def feeds():
    made = []

    def make(**kw):
        kw.setdefault("device", "cpu")
        feed = planner.TxFeed(**kw)
        made.append(feed)
        return feed

    yield make
    for feed in made:
        feed.close()
        feed.join(10.0)


def route_feed(make, route, **kw):
    if route == "verifier":
        return make(use_device=False, verifier=tbatch.TorchBatchVerifier("cpu"), **kw)
    if route == "executor":
        return make(use_device=True, **kw)
    return make(use_device=False, **kw)


def _triple(priv, nonce, payload):
    return kv.extract_signed_tx_sig(kv.make_signed_tx(priv, nonce, payload))


def serial_verdict(tx):
    """The app's serial check: decode, then the key's verify_bytes."""
    item = kv.extract_signed_tx_sig(tx)
    if item is None:
        return None
    pk, msg, sig = item
    return pk.verify_bytes(msg, sig)


# -- TestSignedTxCodec ----------------------------------------------------------


class TestSignedTxCodec:
    def test_roundtrip_ed25519(self):
        tx = kv.make_signed_tx(PRIVS[0], 3, b"k=v")
        stx = kv.decode_signed_tx(tx)
        assert stx is not None
        assert stx.algo == kv.ALGO_ED25519
        assert stx.pub == PRIVS[0].pub_key().bytes()
        assert (stx.nonce, stx.payload) == (3, b"k=v")
        assert stx.sign_bytes == kv.signed_tx_sign_bytes(kv.ALGO_ED25519, stx.pub, 3, b"k=v")

    def test_roundtrip_secp256k1(self):
        stx = kv.decode_signed_tx(kv.make_signed_tx(SECP, 1, b"s=1"))
        assert stx is not None and stx.algo == kv.ALGO_SECP256K1
        assert len(stx.pub) == 33

    def test_sign_bytes_exclude_signature(self):
        stx = kv.decode_signed_tx(kv.make_signed_tx(PRIVS[0], 1, b"k=v"))
        assert stx.sig not in stx.sign_bytes

    @pytest.mark.parametrize("mutate", [
        lambda tx: b"xxx" + tx[3:],            # wrong magic
        lambda tx: tx[:4] + b"\x09" + tx[5:],  # unknown algo
        lambda tx: tx[:5] + b"\x05" + tx[6:],  # wrong publen for algo
        lambda tx: tx[:8],                     # truncated
        lambda tx: b"",
    ])
    def test_structural_tampering_fails_decode(self, mutate):
        tx = kv.make_signed_tx(PRIVS[0], 1, b"k=v")
        assert kv.decode_signed_tx(mutate(tx)) is None
        assert rkv.decode_signed_tx(mutate(tx)) is None

    def test_extractor_yields_verifiable_triples(self):
        pk, msg, sig = _triple(PRIVS[1], 1, b"a=b")
        assert isinstance(pk, PubKeyEd25519)
        assert ted._verify_pure(pk.bytes(), msg, sig)
        pk2, msg2, sig2 = _triple(SECP, 1, b"c=d")
        assert isinstance(pk2, PubKeySecp256k1) and pk2.verify_bytes(msg2, sig2)
        assert kv.extract_signed_tx_sig(b"not-a-signed-tx") is None

    def test_codec_bytes_equal_the_reference(self):
        rprivs = [RPrivKeyEd25519.generate(bytes([i + 1]) * 32) for i in range(3)]
        rsecp = RPrivKeySecp256k1.generate(b"\x77" * 32)
        for (p, rp), nonce in zip(zip(PRIVS[:3] + [SECP], rprivs + [rsecp]), (1, 2, 2**40, 7)):
            tx, rtx_ = kv.make_signed_tx(p, nonce, b"pay=%d" % nonce), rkv.make_signed_tx(
                rp, nonce, b"pay=%d" % nonce)
            assert tx == rtx_
            a, b = kv.decode_signed_tx(tx), rkv.decode_signed_tx(tx)
            assert [getattr(a, f) for f in kv.SignedTx.__slots__] == [
                getattr(b, f) for f in rkv.SignedTx.__slots__]
            pk, msg, sig = kv.extract_signed_tx_sig(tx)
            rpk, rmsg, rsig = rkv.extract_signed_tx_sig(tx)
            assert (pk.bytes(), msg, sig) == (rpk.bytes(), rmsg, rsig)
        assert (kv.SIGNED_TX_MAGIC, kv.ALGO_ED25519, kv.ALGO_SECP256K1) == (
            rkv.SIGNED_TX_MAGIC, rkv.ALGO_ED25519, rkv.ALGO_SECP256K1)
        assert (kv.CODE_BAD_TX, kv.CODE_BAD_SIG, kv.CODE_BAD_NONCE) == (
            rkv.CODE_BAD_TX, rkv.CODE_BAD_SIG, rkv.CODE_BAD_NONCE)

    def test_streams_equal_the_reference(self):
        assert tv.mixed_stream() == rtx.mixed_stream()
        _, txs, mixed = tv.signed_stream(n=24, n_keys=8)
        rprivs = [RPrivKeyEd25519.generate(b"bench-signed-%03d" % i + b"\x00" * 16)
                  for i in range(8)]
        assert txs == [rkv.make_signed_tx(rprivs[i % 8], i // 8 + 1, b"sb%07d=v" % i)
                       for i in range(24)]
        assert len(mixed) == 32 and mixed[0] == rkv.make_signed_tx(rprivs[0], 4, b"mx0000=v")


# -- TestTxFeed -------------------------------------------------------------------


class TestTxFeed:
    @pytest.mark.parametrize("route", ROUTES)
    def test_deadline_flush(self, feeds, route):
        feed = route_feed(feeds, route, window_s=0.02)
        pk, msg, sig = _triple(PRIVS[0], 1, b"a=1")
        v = feed.submit((1, 0), pk, msg, sig).result(timeout=TIMEOUT)
        assert v.ok and v.flush_reason == "deadline"
        assert isinstance(v, planner.TxVerdict)
        assert feed.flushes["deadline"] == 1

    def test_flush_now_short_circuits_window(self, feeds):
        feed = feeds(use_device=False, window_s=LONG)
        t0 = time.monotonic()
        tickets = [feed.submit((1, 0), *_triple(p, 1, b"t=%d" % i))
                   for i, p in enumerate(PRIVS[:3])]
        feed.flush_now()
        verdicts = [t.result(timeout=TIMEOUT) for t in tickets]
        assert time.monotonic() - t0 < LONG - 5
        assert all(v.ok for v in verdicts)
        assert verdicts[0].flush_reason == "quorum"
        assert feed.flushes["quorum"] == 1
        assert (verdicts[0].batch_rows, verdicts[0].batch_lanes) == (1, 3)

    def test_close_drains_pending(self):
        feed = planner.TxFeed(device="cpu", use_device=False, window_s=60.0)
        t = feed.submit((1, 0), *_triple(PRIVS[0], 1, b"a=1"))
        feed.close()
        v = t.result(timeout=TIMEOUT)
        feed.join(10.0)
        assert v.ok and v.flush_reason == "close"
        with pytest.raises(RuntimeError):
            feed.submit((1, 0), *_triple(PRIVS[0], 1, b"a=1"))

    @pytest.mark.parametrize("route", ROUTES)
    def test_bad_signature_verdict(self, feeds, route):
        feed = route_feed(feeds, route, window_s=LONG)
        pk, msg, sig = _triple(PRIVS[0], 1, b"a=1")
        good = feed.submit((1, 0), pk, msg, sig)
        bad = feed.submit((1, 1), pk, msg, b"\x01" * 64)
        feed.flush_now()
        g, b = good.result(timeout=TIMEOUT), bad.result(timeout=TIMEOUT)
        assert g.ok is True and b.ok is False
        assert g.batch_rows == 2 and feed.rows_out == 2  # one row a group key

    def test_flush_metrics_recorded(self, feeds):
        m = get_mempool_batch_metrics()
        before = m.flushes._values.get(("quorum",), 0.0)
        feed = feeds(use_device=False, window_s=LONG)
        t = feed.submit((1, 0), *_triple(PRIVS[0], 1, b"a=1"))
        feed.flush_now()
        t.result(timeout=TIMEOUT)
        assert m.flushes._values.get(("quorum",), 0.0) == before + 1


def test_tx_feed_defaults_and_the_card():
    feed = planner.TxFeed(device="cpu")
    assert isinstance(feed.verifier, tbatch.RLCHostVerifier)
    assert (feed.profile_kind, feed.txs_in) == ("mempool.tx_batch", 0)
    mesh = DeviceMesh(["cpu"] * 2)  # taken now: the budget scales with its devices
    meshed = planner.TxFeed(mesh=mesh, device="cpu")
    assert meshed.mesh is mesh and planner.windows_per_dispatch(mesh) == 8
    meshed.close()
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            planner.TxFeed()


# -- BatchTxVerifier ----------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_batch_verifier_equals_the_reference_on_the_mixed_stream(feeds, route):
    txs = tv.mixed_stream()
    rfeed = rplanner.TxFeed(use_device=False, window_s=LONG)
    try:
        want = RBatchTxVerifier(rfeed, rkv.extract_signed_tx_sig)(txs)
    finally:
        rfeed.close()
        rfeed.join(10.0)
    feed = route_feed(feeds, route, window_s=LONG, max_rows=16)
    # the ticket wait of the file's other waits: the verifier's 5 s default
    # runs out on the plain versions under a loaded run, leaving None
    ver = BatchTxVerifier(feed, kv.extract_signed_tx_sig, height_fn=lambda: 7,
                          timeout_s=TIMEOUT)
    got = ver(txs)
    assert got == want == [serial_verdict(tx) for tx in txs]
    assert got[-1] is None and got[-2] is True  # undecodable; secp256k1
    assert (ver.windows, ver.submitted, ver.unsigned, ver.feed_errors) == (
        1, len(txs) - 1, 1, 0)
    assert feed.dispatches == 1 and feed.txs_in == len(txs) - 1


@pytest.mark.parametrize("route", ROUTES)
def test_bench_mixed_stream_equals_the_serial_verdicts(feeds, route):
    _, txs, mixed = tv.signed_stream(n=32, n_keys=8)
    feed = route_feed(feeds, route, window_s=LONG, max_rows=64)
    ver = BatchTxVerifier(feed, kv.extract_signed_tx_sig, timeout_s=TIMEOUT)
    stream = txs + mixed
    got = []
    for lo in range(0, len(stream), 16):  # CheckTx windows of 16
        got += ver(stream[lo: lo + 16])
    assert got == [serial_verdict(tx) for tx in stream]
    assert got.count(False) == 16 and got.count(True) == len(stream) - 16
    assert ver.windows == len(stream) // 16 == feed.dispatches


def test_recheck_answers_from_the_cache(feeds):
    feed = feeds(use_device=False, window_s=LONG)
    ver = BatchTxVerifier(feed, kv.extract_signed_tx_sig)
    txs = tv.mixed_stream()
    first = ver(txs)
    submitted, dispatches = ver.submitted, feed.dispatches
    accepted = [tx for tx, ok in zip(txs, first) if ok]
    again = ver(accepted)
    assert again == [True] * len(accepted)
    assert ver.cache_hits == len(accepted)
    assert (ver.submitted, feed.dispatches) == (submitted, dispatches)  # no re-dispatch


def test_cache_bounded(feeds):
    feed = feeds(use_device=False, window_s=0.005)
    ver = BatchTxVerifier(feed, kv.extract_signed_tx_sig, cache_size=2)
    ver([kv.make_signed_tx(PRIVS[0], n, b"cb%d=v" % n) for n in range(1, 5)])
    assert len(ver._cache) == 2  # FIFO-evicted down to the bound


@pytest.mark.parametrize("route", ["executor", "guarded_verifier"])
def test_quarantined_breaker_still_resolves_correct_verdicts(feeds, route):
    """Off the card a quarantined breaker sends the flush to the host; the
    verdicts stay right and the hook counts no feed error."""
    if route == "executor":
        feed = feeds(use_device=True, window_s=LONG)
    else:
        feed = feeds(window_s=LONG,
                     verifier=tbatch.GuardedBatchVerifier(tbatch.TorchBatchVerifier("cpu")))
    ver = BatchTxVerifier(feed, kv.extract_signed_tx_sig)
    bad = bytearray(kv.make_signed_tx(PRIVS[1], 1, b"q2=b"))
    bad[-1] ^= 1
    txs = [kv.make_signed_tx(PRIVS[0], 1, b"q1=a"), bytes(bad),
           kv.make_signed_tx(PRIVS[2], 1, b"q3=c")]
    fallbacks = get_verify_metrics().device_fallback
    before = fallbacks._values.get(("quarantined",), 0.0)
    brk.get_device_breaker().quarantine("tx_batch_test")
    try:
        assert ver(txs) == [True, False, True]
    finally:
        brk.get_device_breaker().reset()
    assert ver.feed_errors == 0
    assert fallbacks._values.get(("quarantined",), 0.0) == before + 1


def test_a_device_failure_raises_and_other_failures_leave_none(feeds):
    """A ``DeviceDispatchError`` (the card's failed dispatch) raises out of
    the hook; any other flush failure leaves the verdict to the app."""

    class Raises(tbatch.HostBatchVerifier):
        def __init__(self, err):
            self.err = err

        def verify_ed25519_raw(self, pubs, msgs, sigs):
            raise self.err

    txs = [kv.make_signed_tx(PRIVS[0], 1, b"x=1"), kv.make_signed_tx(PRIVS[1], 1, b"y=1")]
    ver = BatchTxVerifier(feeds(use_device=False, window_s=LONG,
                                verifier=Raises(RuntimeError("flaky"))),
                          kv.extract_signed_tx_sig)
    assert ver(txs) == [None, None] and ver.feed_errors == 2 and not ver._cache
    ver = BatchTxVerifier(feeds(use_device=False, window_s=LONG,
                                verifier=Raises(brk.DeviceDispatchError("error", "t"))),
                          kv.extract_signed_tx_sig)
    with pytest.raises(brk.DeviceDispatchError):
        ver(txs)
    assert not ver._cache


class _CardFeed:
    """A feed that claims the card and fails in one way: its flush never
    completes, its submit fails (a closed feed), or its flush raises."""

    device = torch.device("cuda")

    def __init__(self, fault):
        self.fault = fault
        self.tickets = []

    def submit(self, group_key, pub, msg, sig):
        if self.fault == "submit":
            raise RuntimeError("tx feed is closed")
        ticket = planner.TxTicket()
        if self.fault == "flush":
            ticket._resolve(err=RuntimeError("flaky"))
        self.tickets.append(ticket)
        return ticket

    def flush_now(self):
        pass


@pytest.mark.parametrize("fault", ["hung", "submit", "flush"])
def test_on_the_card_every_feed_failure_raises(fault):
    """On the card no feed failure hands a tx back to the app's host check:
    a flush that does not complete in time raises
    ``DeviceDispatchError('timeout')``, a failed submit or flush raises what
    it raised; nothing is cached."""
    txs = [kv.make_signed_tx(PRIVS[0], 1, b"x=1"), kv.make_signed_tx(PRIVS[1], 1, b"y=1")]
    ver = BatchTxVerifier(_CardFeed(fault), kv.extract_signed_tx_sig, timeout_s=0.05)
    t0 = time.monotonic()
    if fault == "hung":
        with pytest.raises(brk.DeviceDispatchError) as ei:
            ver(txs)
        assert ei.value.reason == "timeout"
    else:
        with pytest.raises(RuntimeError, match="closed" if fault == "submit" else "flaky"):
            ver(txs)
    assert time.monotonic() - t0 < 10.0
    assert ver.feed_errors == 1 and not ver._cache


def test_on_the_card_a_ticket_waits_out_the_guards_deadline():
    """A dispatch the guard still supervises is not yet a failure: on the
    card the ticket wait is at least the guard's dispatch deadline."""
    brk.configure_device_guard(dispatch_deadline=0.3)
    ver = BatchTxVerifier(_CardFeed("hung"), kv.extract_signed_tx_sig, timeout_s=0.01)
    t0 = time.monotonic()
    with pytest.raises(brk.DeviceDispatchError):
        ver([kv.make_signed_tx(PRIVS[0], 1, b"x=1")])
    assert time.monotonic() - t0 >= 0.3
