"""The port's light-client frontend (frontend/cache.py, frontend/frontend.py,
lite/proxy.RPCProvider) against the reference's on the CPU, exactly:
verdicts, error types, codec bytes and trust frontiers. Restates
tests/test_frontend.py's ``TestHeaderCache``, ``TestSingleFlight``,
``TestFrontendConcurrency``, ``TestFrontendParity``,
``TestFrontendRejections`` and ``TestRPCProviderResilience`` against the
port, over the reference's chains carried in as codec bytes
(``testutil/lite_chain.ChainProvider``), and holds ``RPCProvider`` against a stub
JSON-RPC node serving the reference's ``lite_full_commit`` shape
(rpc/core/env.py:336).

Signatures verify on the port's ``HostBatchVerifier`` unless the guard or
the kernels are the subject; threads wait with deadlines, and every
frontend, feed and server is closed."""

import base64
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from tendermint_tpu.abci.examples.kvstore import PersistentKVStoreApp
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as JPriv
from tendermint_tpu.encoding.codec import Writer as JWriter
from tendermint_tpu.libs.db.kv import MemDB as JMemDB
from tendermint_tpu.lite import provider as jprovider
from tendermint_tpu.lite import verifier as jverifier
from tendermint_tpu.testutil.chain import build_chain
from tendermint_tpu.types import MockPV
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.frontend import HeaderCache, LiteFrontend, SingleFlight
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.lite import DBProvider, DynamicVerifier, LiteError, ProviderError
from tendermint_tpu_torch.lite.proxy import RPCProvider
from tendermint_tpu_torch.testutil import lite_chain as lc
from tendermint_tpu_torch.types.validator_set import CommitError, Validator, ValidatorSet

TIMEOUT = 60.0


def _val_tx(pub: bytes, power: int) -> bytes:
    return b"val:" + base64.b64encode(pub) + b"!%d" % power


def _carry(fx):
    src = jprovider.NodeProvider(fx.block_store, fx.state_db)
    return lc.ChainProvider({h: src.full_commit_at(fx.chain_id, h).marshal()
                             for h in range(1, fx.height + 1)})


@pytest.fixture(scope="module")
def static_chain():
    fx = build_chain(n_vals=4, n_heights=10, chain_id="fe-static")
    return fx, _carry(fx)


@pytest.fixture(scope="module")
def churn_chain():
    """3 big validators join at h4, 3 originals leave at h8 (bisection)."""
    joiners = [MockPV(JPriv.generate(bytes([80 + i]) * 32)) for i in range(3)]

    def on_height(h, st):
        if h == 4:
            return [_val_tx(pv.get_pub_key().bytes(), 100) for pv in joiners]
        if h == 8:
            leavers = [v for v in st.validators.validators if v.voting_power == 10][:3]
            return [_val_tx(v.pub_key.bytes(), 0) for v in leavers]
        return []

    fx = build_chain(n_vals=4, n_heights=14, chain_id="fe-churn",
                     app_factory=PersistentKVStoreApp, on_height=on_height,
                     extra_pvs=joiners)
    return fx, _carry(fx)


@pytest.fixture(autouse=True)
def _host_verifier():
    brk.configure_device_guard(dispatch_deadline=0)
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())
    yield
    tbatch.set_batch_verifier(None)
    brk.reset_device_guard()


@pytest.fixture
def frontends():
    """Frontends made by a test, closed after it whatever happened."""
    made = []

    def make(fx, src, seed_src=None, **kw):
        fe = LiteFrontend(fx.chain_id, src, batch_window_s=0.001, **kw)
        made.append(fe)
        fe.init_trust((seed_src or src).full_commit_at(fx.chain_id, 1))
        return fe

    yield make
    for fe in made:
        fe.close()


def _run_clients(n, fn):
    """n threads each run fn(); returns (results, errors) once all ended."""
    results, errors = [], []

    def client():
        try:
            results.append(fn())
        except Exception as e:
            errors.append(e)

    ts = [threading.Thread(target=client) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in ts), "a client did not finish"
    return results, errors


# -- HeaderCache + SingleFlight ----------------------------------------------

class TestHeaderCache:
    def test_pin_mismatch_is_a_miss(self):
        c = HeaderCache(4)
        c.put(5, "fc5", b"pin-a")
        assert c.get(5) == "fc5"
        assert c.get(5, pin=b"pin-a") == "fc5"
        assert c.get(5, pin=b"pin-b") is None

    def test_lru_evicts_oldest(self):
        c = HeaderCache(2)
        c.put(1, "a", b"p")
        c.put(2, "b", b"p")
        assert c.get(1) == "a"  # touch 1 so 2 is now oldest
        c.put(3, "c", b"p")
        assert c.get(2) is None
        assert c.get(1) == "a" and c.get(3) == "c"


def _wait_for(cond):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, "condition not reached in time"
        time.sleep(0.005)


class TestSingleFlight:
    def _burst(self, sf, work, n):
        """A leader, then n - 1 waiters parked behind it; returns (results,
        errors, waits) once the gate opened and every caller ended."""
        gate = threading.Event()
        waits, out = [], []

        def run():
            out.append(_run_clients(1, lambda: sf.do(
                "k", lambda: work(gate), on_wait=lambda: waits.append(1))))

        ts = [threading.Thread(target=run)]
        ts[0].start()
        _wait_for(lambda: sf._flights)
        ts += [threading.Thread(target=run) for _ in range(n - 1)]
        for t in ts[1:]:
            t.start()
        _wait_for(lambda: len(waits) == n - 1)
        gate.set()
        for t in ts:
            t.join(TIMEOUT)
        return ([r for rs, _ in out for r in rs], [e for _, es in out for e in es],
                len(waits))

    def test_waiters_share_leader_result(self):
        calls = []

        def work(gate):
            calls.append(1)
            assert gate.wait(TIMEOUT)
            return "shared"

        results, errors, waits = self._burst(SingleFlight(), work, 6)
        assert calls == [1] and not errors and waits == 5
        assert results == ["shared"] * 6

    def test_failures_propagate_and_are_not_cached(self):
        sf = SingleFlight()
        with pytest.raises(ValueError):
            sf.do("k", lambda: (_ for _ in ()).throw(ValueError("boom")))
        assert sf.do("k", lambda: 42) == 42

    def test_a_device_error_reaches_every_waiter_and_the_key_retires(self):
        def work(gate):
            assert gate.wait(TIMEOUT)
            raise brk.DeviceDispatchError("timeout", "frontend hop")

        sf = SingleFlight()
        results, errors, waits = self._burst(sf, work, 4)
        assert not results and len(errors) == 4 and waits == 3
        assert all(isinstance(e, brk.DeviceDispatchError) for e in errors)
        assert not sf._flights
        assert sf.do("k", lambda: "fresh") == "fresh"


# -- LiteFrontend -------------------------------------------------------------------

class TestFrontendConcurrency:
    def test_concurrent_clients_do_the_work_once(self, churn_chain, frontends):
        fx, src = churn_chain
        tip = fx.height
        solo = frontends(fx, src)
        solo.certified_commit(tip)
        solo_rows = solo.feed.rows_in
        assert solo_rows > 0

        fe = frontends(fx, src)
        heads, errs = _run_clients(
            16, lambda: fe.certified_commit(tip).signed_header.header.hash())
        assert not errs
        assert len(set(heads)) == 1
        assert fe.feed.rows_in == solo_rows
        st = fe.stats()
        assert st["cache_entries"] == 1
        assert st["dispatches"] <= solo_rows

    def test_cache_hit_skips_reverification(self, static_chain, frontends):
        fx, src = static_chain
        fe = frontends(fx, src)
        fc = fe.certified_commit(7)
        rows = fe.feed.rows_in
        assert fe.certified_commit(7) is fc
        assert fe.feed.rows_in == rows


def _serial(fx, height):
    """The reference's serial DynamicVerifier on its own chain: (FullCommit
    bytes at height, trust frontier)."""
    src = jprovider.NodeProvider(fx.block_store, fx.state_db)
    dv = jverifier.DynamicVerifier(fx.chain_id, jprovider.DBProvider(JMemDB()), src)
    dv.init_from_full_commit(src.full_commit_at(fx.chain_id, 1))
    fc = src.full_commit_at(fx.chain_id, height)
    dv.verify(fc.signed_header)
    return fc.marshal(), dv.trusted.latest_full_commit(fx.chain_id, 1, 1 << 60).height


class TestFrontendParity:
    def test_bit_identical_with_serial_dynamic_verifier(self, churn_chain, frontends):
        fx, src = churn_chain
        fe = frontends(fx, src)
        fc_batched = fe.certified_commit(fx.height)
        raw_batched = fe.light_block(fx.height)

        dv = DynamicVerifier(fx.chain_id, DBProvider(MemDB()), src)
        dv.init_from_full_commit(src.full_commit_at(fx.chain_id, 1))
        fc_serial = src.full_commit_at(fx.chain_id, fx.height)
        dv.verify(fc_serial.signed_header)

        assert raw_batched == fc_serial.marshal()
        assert fc_batched.signed_header.header.hash() == fc_serial.signed_header.header.hash()
        frontier = fe.trusted.latest_full_commit(fx.chain_id, 1, 1 << 60).height
        assert frontier == dv.trusted.latest_full_commit(fx.chain_id, 1, 1 << 60).height
        # and equal to the reference's serial verifier on its own chain
        assert (raw_batched, frontier) == _serial(fx, fx.height)

    def test_plain_kernels_behind_the_guard_give_the_same_bytes(self, static_chain, frontends):
        """The frontend's feed over GuardedBatchVerifier(TorchBatchVerifier("cpu")):
        K1's and K2's plain versions behind the guard, no host fallback."""
        fx, src = static_chain
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            guarded = tbatch.GuardedBatchVerifier(tbatch.TorchBatchVerifier("cpu"),
                                                  deadline=0)
            fe = frontends(fx, src, inner_verifier=guarded)
            raw = fe.light_block(9)
        finally:
            torch.set_num_threads(n)
        assert (raw, fe.trusted.latest_full_commit(fx.chain_id, 1, 1 << 60).height) \
            == _serial(fx, 9)
        assert guarded.snapshot()["dispatches"] == fe.feed.dispatches >= 2
        assert brk.get_device_breaker().state == brk.CLOSED


class TestFrontendRejections:
    def test_valset_hash_mismatch_rejected_for_every_client(self, static_chain, frontends):
        fx, honest = static_chain
        strangers = ValidatorSet([Validator(PubKeyEd25519(ted.pubkey_from_seed(
            bytes([230 + i]) * 32)), 10) for i in range(4)])

        def swap_valset(height, fc):
            if height >= 5:
                fc.validators = strangers
            return fc

        fe = frontends(fx, lc.DoctoringProvider(honest, swap_valset), seed_src=honest)
        _, errs = _run_clients(4, lambda: fe.certified_commit(7))
        assert len(errs) == 4
        for e in errs:
            assert isinstance(e, LiteError)
            assert "validators_hash" in str(e)
        assert len(fe.cache) == 0
        with pytest.raises(LiteError, match="validators_hash"):
            fe.certified_commit(7)
        assert fe.trusted.latest_full_commit(fx.chain_id, 1, 1 << 60).height == 1

    def test_insufficient_power_rejected_through_batched_path(self, static_chain, frontends):
        fx, honest = static_chain

        def strip_commit(height, fc):
            return lc.strip_precommits(fc, (0, 1)) if height > 1 else fc

        fe = frontends(fx, lc.DoctoringProvider(honest, strip_commit), seed_src=honest)
        with pytest.raises(CommitError, match="voting power"):
            fe.certified_commit(9)
        assert len(fe.cache) == 0

    def test_a_device_error_reaches_every_client_and_nothing_is_trusted(
            self, static_chain, frontends):
        """On the card the guard raises DeviceDispatchError where the
        reference would complete on the host: every client waiting on the
        height gets it, nothing is cached or trusted, and a later request
        runs afresh."""
        fx, src = static_chain

        class Failing:
            calls = 0

            def verify_ed25519_raw(self, pubs, msgs, sigs):
                Failing.calls += 1
                raise brk.DeviceDispatchError("timeout", "frontend batch")

        fe = frontends(fx, src, inner_verifier=Failing())
        _, errs = _run_clients(4, lambda: fe.certified_commit(8))
        assert len(errs) == 4
        assert all(isinstance(e, brk.DeviceDispatchError) for e in errs)
        assert Failing.calls >= 1
        assert len(fe.cache) == 0
        assert fe.trusted.latest_full_commit(fx.chain_id, 1, 1 << 60).height == 1
        fe.feed.verifier = tbatch.HostBatchVerifier()
        assert fe.certified_commit(8).height == 8


# -- RPCProvider -------------------------------------------------------------------

class TestRPCProviderResilience:
    def test_refused_connection_surfaces_provider_error(self):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        p = RPCProvider(f"127.0.0.1:{port}", timeout=0.2, retries=1, backoff=0.01)
        with pytest.raises(ProviderError, match="unreachable"):
            p.full_commit_at("any-chain", 3)

    def test_hung_upstream_times_out_with_bounded_retries(self):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(4)
        port = srv.getsockname()[1]
        try:
            p = RPCProvider(f"127.0.0.1:{port}", timeout=0.2, retries=2, backoff=0.01)
            with pytest.raises(ProviderError, match="unreachable"):
                p.latest_full_commit("any-chain", 1, 10)
        finally:
            srv.close()


@pytest.fixture
def stub_node(churn_chain):
    """A JSON-RPC node on 127.0.0.1 serving ``status`` and the reference's
    ``lite_full_commit`` shape from the reference's chain; heights past
    ``missing_from`` answer with an RPC error. Yields (address, calls)."""
    fx, _ = churn_chain
    src = jprovider.NodeProvider(fx.block_store, fx.state_db)
    calls = []
    missing_from = fx.height + 1

    def b64(b):
        return base64.b64encode(b).decode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_POST(self):
            req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            calls.append(req["method"])
            out = {"jsonrpc": "2.0", "id": req["id"]}
            if req["method"] == "status":
                out["result"] = {"sync_info": {"latest_block_height": fx.height + 2}}
            elif req["params"]["height"] >= missing_from:
                out["error"] = {"code": -32603, "message": "no commit for height"}
            else:
                fc = src.full_commit_at(fx.chain_id, req["params"]["height"])
                w = JWriter()
                fc.signed_header.header.encode(w)
                out["result"] = {
                    "height": fc.height,
                    "header": b64(w.build()),
                    "commit": b64(fc.signed_header.commit.marshal()),
                    "validators": b64(fc.validators.marshal()),
                    "next_validators": b64(fc.next_validators.marshal()),
                }
            body = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"127.0.0.1:{httpd.server_address[1]}", calls
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(TIMEOUT)


def test_rpc_provider_serves_the_reference_bytes(churn_chain, stub_node):
    fx, src = churn_chain
    addr, calls = stub_node
    p = RPCProvider(addr, timeout=TIMEOUT, retries=0)
    for h in (1, 7, fx.height):
        assert p.full_commit_at(fx.chain_id, h).marshal() == \
            src.full_commit_at(fx.chain_id, h).marshal()
    # the node reports two heights it cannot serve: the walk down skips them
    assert p.latest_full_commit(fx.chain_id, 1, 1 << 60).height == fx.height
    # an RPC-level error is the node answering no: never retried
    calls.clear()
    p = RPCProvider(addr, timeout=TIMEOUT, retries=3, backoff=0.0)
    with pytest.raises(ProviderError, match="no commit"):
        p.full_commit_at(fx.chain_id, fx.height + 1)
    assert calls == ["lite_full_commit"]


def test_frontend_over_the_rpc_provider(churn_chain, stub_node, frontends):
    fx, src = churn_chain
    addr, _ = stub_node
    fe = frontends(fx, RPCProvider(addr, timeout=TIMEOUT), seed_src=src)
    assert fe.light_block(fx.height) == _serial(fx, fx.height)[0]


def test_frontend_records_the_reference_metrics(churn_chain, frontends):
    """The same serial requests through the port's and the reference's
    frontends move the same request, cache, height and size series."""
    from tendermint_tpu.frontend import LiteFrontend as JLiteFrontend
    from tendermint_tpu.libs import metrics as jmetrics
    from tendermint_tpu_torch.libs import metrics as tmetrics

    fx, src = churn_chain
    ref_src = jprovider.NodeProvider(fx.block_store, fx.state_db)
    port = frontends(fx, src, metrics=tmetrics.FrontendMetrics())
    ref = JLiteFrontend(fx.chain_id, ref_src, batch_window_s=0.001,
                        metrics=jmetrics.FrontendMetrics())
    try:
        ref.init_trust(ref_src.full_commit_at(fx.chain_id, 1))
        for fe in (port, ref):
            fe.certified_commit(fx.height)
            fe.certified_commit(fx.height)
            fe.light_block(5)
            with pytest.raises(Exception):
                fe.certified_commit(fx.height + 5)
    finally:
        ref.close()
    for name in ("requests", "cache_events", "heights_verified", "cache_size"):
        assert getattr(port.metrics, name)._values == getattr(ref.metrics, name)._values, name
    assert port.metrics.verify_seconds._series[()][2] == 4
