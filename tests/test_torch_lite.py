"""The port's light client (lite/, frontend/ metrics, lite/proxy.py) against
the reference's on the CPU, exactly: verdicts, error types, trust
frontiers and the proxy's JSON.

The reference's chains (``testutil/chain.build_chain``: tests/test_lite.py's
static 4 x 10 and churn chains) reach the port as codec bytes through
``testutil/lite_chain.ChainProvider``. ``TestBaseVerifier``,
``TestDBProvider``, ``TestDynamicVerifier`` and
``TestDynamicVerifierRejections`` restate the 12 cases of
tests/test_lite.py against the port. A chain from the port's own
``build_lite_chain`` is decoded and certified by the reference too; a
``LiteProxy`` over the stores of the port's own ``build_chain``
(``NodeProvider``) certifies what one over the reference's chain does.
Signatures verify on the port's ``HostBatchVerifier``: the kernels are not
the subject here.
"""

import base64
import json
import threading
import urllib.request

import pytest

from tendermint_tpu.abci.examples.kvstore import PersistentKVStoreApp
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as JPriv
from tendermint_tpu.libs import metrics as jmetrics
from tendermint_tpu.libs.db.kv import MemDB as JMemDB
from tendermint_tpu.lite import provider as jprovider
from tendermint_tpu.lite import proxy as jproxy
from tendermint_tpu.lite import types as jtypes
from tendermint_tpu.lite import verifier as jverifier
from tendermint_tpu.testutil.chain import build_chain
from tendermint_tpu.types import MockPV
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.libs import metrics as tmetrics
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.lite import (
    BaseVerifier,
    DBProvider,
    DynamicVerifier,
    FullCommit,
    LiteError,
    ProviderError,
)
from tendermint_tpu_torch.lite.provider import NodeProvider
from tendermint_tpu_torch.lite.proxy import LiteProxy, serve_proxy
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
    """10 heights, a fixed 4-validator set; (reference fixture, port source)."""
    fx = build_chain(n_vals=4, n_heights=10, chain_id="lite-static")
    return fx, _carry(fx)


@pytest.fixture(scope="module")
def churn_chain():
    """3 big validators join at h4, 3 of the original 4 leave at h8: one
    trust hop from early to late heights overlaps too little and bisects."""
    joiners = [MockPV(JPriv.generate(bytes([50 + i]) * 32)) for i in range(3)]

    def on_height(h, st):
        if h == 4:
            return [_val_tx(pv.get_pub_key().bytes(), 100) for pv in joiners]
        if h == 8:
            leavers = [v for v in st.validators.validators if v.voting_power == 10][:3]
            return [_val_tx(v.pub_key.bytes(), 0) for v in leavers]
        return []

    fx = build_chain(n_vals=4, n_heights=14, chain_id="lite-churn",
                     app_factory=PersistentKVStoreApp, on_height=on_height,
                     extra_pvs=joiners)
    return fx, _carry(fx)


@pytest.fixture(autouse=True)
def _host_verifier():
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())
    yield
    tbatch.set_batch_verifier(None)


def _strangers(first_seed_byte):
    return ValidatorSet([Validator(PubKeyEd25519(ted.pubkey_from_seed(
        bytes([first_seed_byte + i]) * 32)), 10) for i in range(4)])


def _trusted_heights(trusted, chain_id, top):
    out = []
    while True:
        try:
            fc = trusted.latest_full_commit(chain_id, 1, top)
        except (ProviderError, jprovider.ProviderError):
            return out
        out.append(fc.height)
        top = fc.height - 1


# -- tests/test_lite.py, restated ----------------------------------------------

class TestBaseVerifier:
    def test_accepts_valid_header(self, static_chain):
        fx, src = static_chain
        fc = src.full_commit_at(fx.chain_id, 5)
        BaseVerifier(fx.chain_id, 1, fc.validators).verify(fc.signed_header)

    def test_rejects_wrong_valset(self, static_chain):
        fx, src = static_chain
        fc = src.full_commit_at(fx.chain_id, 5)
        with pytest.raises(LiteError):
            BaseVerifier(fx.chain_id, 1, _strangers(200)).verify(fc.signed_header)

    def test_rejects_tampered_header(self, static_chain):
        fx, src = static_chain
        fc = src.full_commit_at(fx.chain_id, 6)
        fc.signed_header.header.app_hash = b"\xff" * 32
        with pytest.raises(LiteError):
            BaseVerifier(fx.chain_id, 1, fc.validators).verify(fc.signed_header)

    def test_rejects_below_initial_height(self, static_chain):
        fx, src = static_chain
        fc = src.full_commit_at(fx.chain_id, 3)
        with pytest.raises(LiteError):
            BaseVerifier(fx.chain_id, 5, fc.validators).verify(fc.signed_header)


class TestDBProvider:
    def test_save_and_latest(self, static_chain):
        fx, src = static_chain
        db = DBProvider(MemDB())
        for h in (2, 5, 7):
            db.save_full_commit(src.full_commit_at(fx.chain_id, h))
        assert db.latest_full_commit(fx.chain_id, 1, 10).height == 7
        assert db.latest_full_commit(fx.chain_id, 1, 6).height == 5
        with pytest.raises(ProviderError):
            db.latest_full_commit(fx.chain_id, 3, 4)
        with pytest.raises(ProviderError):
            db.latest_full_commit("other-chain", 1, 10)


class TestDynamicVerifier:
    def _seeded(self, fx, src, seed_height=1):
        dv = DynamicVerifier(fx.chain_id, DBProvider(MemDB()), src)
        dv.init_from_full_commit(src.full_commit_at(fx.chain_id, seed_height))
        return dv

    def test_verify_static_chain_tip(self, static_chain):
        fx, src = static_chain
        self._seeded(fx, src).verify(src.full_commit_at(fx.chain_id, 9).signed_header)

    def test_verify_across_valset_churn_with_bisection(self, churn_chain):
        fx, src = churn_chain
        tip_set = src.full_commit_at(fx.chain_id, fx.height).next_validators
        assert tip_set.size == 4
        assert {v.voting_power for v in tip_set.validators} == {10, 100}
        dv = self._seeded(fx, src, seed_height=2)
        dv.verify(src.full_commit_at(fx.chain_id, 13).signed_header)
        heights = _trusted_heights(dv.trusted, fx.chain_id, 13)
        assert 13 in heights
        assert len(heights) > 2, f"expected bisection hops, got {heights}"
        # the same hops as the reference's verifier on the same chain
        ref_src = jprovider.NodeProvider(fx.block_store, fx.state_db)
        ref = jverifier.DynamicVerifier(fx.chain_id, jprovider.DBProvider(JMemDB()), ref_src)
        ref.init_from_full_commit(ref_src.full_commit_at(fx.chain_id, 2))
        ref.verify(ref_src.full_commit_at(fx.chain_id, 13).signed_header)
        assert heights == _trusted_heights(ref.trusted, fx.chain_id, 13)

    def test_rejects_forged_tip(self, churn_chain):
        fx, src = churn_chain
        dv = self._seeded(fx, src, seed_height=2)
        tip = src.full_commit_at(fx.chain_id, 12)
        tip.signed_header.header.app_hash = b"\x66" * 32
        with pytest.raises(LiteError):
            dv.verify(tip.signed_header)

    def test_requires_seed(self, static_chain):
        fx, src = static_chain
        dv = DynamicVerifier(fx.chain_id, DBProvider(MemDB()), src)
        with pytest.raises(LiteError):
            dv.verify(src.full_commit_at(fx.chain_id, 5).signed_header)


class TestDynamicVerifierRejections:
    def test_rejects_valset_hash_mismatch(self, static_chain):
        fx, honest = static_chain
        strangers = _strangers(210)

        def swap_valset(height, fc):
            if height >= 5:
                fc.validators = strangers
            return fc

        src = lc.DoctoringProvider(honest, swap_valset)
        trusted = DBProvider(MemDB())
        dv = DynamicVerifier(fx.chain_id, trusted, src)
        dv.init_from_full_commit(src.full_commit_at(fx.chain_id, 1))
        with pytest.raises(LiteError, match="validators_hash"):
            dv.verify(honest.full_commit_at(fx.chain_id, 7).signed_header)
        assert trusted.latest_full_commit(fx.chain_id, 1, 10).height == 1

    def test_rejects_insufficient_power_at_trusted_ancestor(self, static_chain):
        fx, honest = static_chain

        def strip_commit(height, fc):
            return lc.strip_precommits(fc, (0, 1)) if height > 1 else fc

        src = lc.DoctoringProvider(honest, strip_commit)
        dv = DynamicVerifier(fx.chain_id, DBProvider(MemDB()), src)
        dv.init_from_full_commit(src.full_commit_at(fx.chain_id, 1))
        with pytest.raises(CommitError, match="voting power"):
            dv.verify(honest.full_commit_at(fx.chain_id, 9).signed_header)

    def test_bisection_across_big_churn_fails_when_intermediates_pruned(self, churn_chain):
        fx, honest = churn_chain

        def prune_middle(height, fc):
            if 2 < height < 13:
                raise ProviderError(f"height {height} pruned")
            return fc

        src = lc.DoctoringProvider(honest, prune_middle)
        dv = DynamicVerifier(fx.chain_id, DBProvider(MemDB()), src)
        dv.init_from_full_commit(src.full_commit_at(fx.chain_id, 2))
        tip = honest.full_commit_at(fx.chain_id, 13).signed_header
        with pytest.raises(LiteError):
            dv.verify(tip)
        dv2 = DynamicVerifier(fx.chain_id, DBProvider(MemDB()), honest)
        dv2.init_from_full_commit(honest.full_commit_at(fx.chain_id, 2))
        dv2.verify(tip)


# -- a chain of the port's build_lite_chain, certified by both -----------------

@pytest.fixture(scope="module")
def port_chain():
    """7 validators x 24 heights, 3 of 7 replaced every 8 heights."""
    return lc.build_lite_chain(7, 24, change_heights=(9, 17), n_change=3, seed=5,
                               chain_id="port-lite")


class _RefBytesProvider(jprovider.Provider):
    """The reference's view of the port's chain: its own FullCommit decoded
    from the port's bytes."""

    def __init__(self, fcs, doctor=None):
        self._fcs = fcs
        self._doctor = doctor or (lambda h, fc: fc)

    def full_commit_at(self, chain_id, height):
        if height not in self._fcs:
            raise jprovider.ProviderError(f"height {height} not in the chain")
        return self._doctor(height, jtypes.FullCommit.unmarshal(self._fcs[height]))


def _flip_at(bad_height):
    def doctor(height, fc):
        if height == bad_height:
            pcs = fc.signed_header.commit.precommits
            sig = bytearray(pcs[2].signature)
            sig[40] ^= 0x08
            pcs[2] = pcs[2].with_signature(bytes(sig))
        return fc
    return doctor


def _outcome(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("target,bad", [(24, None), (12, None), (17, None), (9, None),
                                        (24, 12), (24, 6), (20, 20)])
def test_port_chain_certifies_as_the_reference_certifies_it(port_chain, target, bad):
    ch = port_chain
    for h in range(1, ch.height + 1):
        assert jtypes.FullCommit.unmarshal(ch.full_commits[h]).marshal() == ch.full_commits[h]
    doctor = _flip_at(bad) if bad else (lambda h, fc: fc)
    ref_src = _RefBytesProvider(ch.full_commits, doctor)
    ref = jverifier.DynamicVerifier(ch.chain_id, jprovider.DBProvider(JMemDB()), ref_src)
    ref.init_from_full_commit(ref_src.full_commit_at(ch.chain_id, 1))
    want = _outcome(lambda: ref.verify(ref_src.full_commit_at(ch.chain_id, target).signed_header))

    src = lc.DoctoringProvider(ch.provider(), doctor)
    dv = DynamicVerifier(ch.chain_id, DBProvider(MemDB()), src)
    dv.init_from_full_commit(src.full_commit_at(ch.chain_id, 1))
    got = _outcome(lambda: dv.verify(src.full_commit_at(ch.chain_id, target).signed_header))
    assert got == want
    assert (_trusted_heights(dv.trusted, ch.chain_id, ch.height)
            == _trusted_heights(ref.trusted, ch.chain_id, ch.height))
    if bad is None:
        assert want is None
        assert len(_trusted_heights(dv.trusted, ch.chain_id, ch.height)) > 2 or target <= 8


# -- the proxy's JSON -----------------------------------------------------------

def _proxies(fx, src, **kw):
    ref_src = jprovider.NodeProvider(fx.block_store, fx.state_db)
    return (jproxy.LiteProxy(fx.chain_id, source=ref_src, batch_window_s=0.001, **kw),
            LiteProxy(fx.chain_id, source=src, batch_window_s=0.001, **kw))


def _pin(fx):
    return jprovider.NodeProvider(fx.block_store, fx.state_db).full_commit_at(
        fx.chain_id, 1).signed_header.header.hash()


@pytest.mark.parametrize("pinned", [False, True])
def test_proxy_json_matches_the_reference(churn_chain, pinned):
    fx, src = churn_chain
    kw = dict(trusted_height=1, trusted_hash=_pin(fx)) if pinned else {}
    ref, port = _proxies(fx, src, **kw)
    try:
        assert port.status() == ref.status()
        for h in (3, 8, 13, fx.height):
            assert port.commit(h) == ref.commit(h)
            assert port.verify_commit(h) == ref.verify_commit(h)
            assert port.light_block(h) == ref.light_block(h)
        assert port.verify_commit() == ref.verify_commit()
        assert port.stats().keys() == ref.stats().keys()
    finally:
        ref.close()
        port.close()


def test_proxy_pin_mismatch_raises_in_both(churn_chain):
    fx, src = churn_chain
    bad = b"\x13" * 32
    ref, port = _proxies(fx, src, trusted_height=1, trusted_hash=bad)
    try:
        with pytest.raises(jprovider.ProviderError, match="mismatch"):
            ref.status()
        with pytest.raises(ProviderError, match="mismatch"):
            port.status()
    finally:
        ref.close()
        port.close()
    # a trust store that conflicts with the pin raises in both
    for cls, db, source, err in (
        (jproxy.LiteProxy, JMemDB(), jprovider.NodeProvider(fx.block_store, fx.state_db),
         jprovider.ProviderError),
        (LiteProxy, MemDB(), src, ProviderError),
    ):
        seeded = cls(fx.chain_id, source=source, trust_db=db)  # trust on first use
        seeded.verify_commit(3)
        seeded.close()
        pinned = cls(fx.chain_id, source=source, trust_db=db, trusted_height=2,
                     trusted_hash=_pin(fx))
        with pytest.raises(err, match="pinned height"):
            pinned.verify_commit(3)
        pinned.close()
        pinned = cls(fx.chain_id, source=source, trust_db=db, trusted_height=1,
                     trusted_hash=bad)
        with pytest.raises(err, match="conflicts with the pinned hash"):
            pinned.verify_commit(3)
        pinned.close()
    for cls in (jproxy.LiteProxy, LiteProxy):
        with pytest.raises(ValueError):
            cls(fx.chain_id, source=src, trusted_height=1)


def test_proxy_without_a_source_or_with_stores_raises(churn_chain):
    fx, _ = churn_chain
    with pytest.raises(ValueError):
        LiteProxy(fx.chain_id)
    with pytest.raises(ValueError):  # a block store alone is no source
        LiteProxy(fx.chain_id, block_store=object())
    proxy = LiteProxy(fx.chain_id, block_store=object(), state_db=object())
    assert isinstance(proxy.source, NodeProvider)  # the stores serve in process
    proxy.close()


def _port_churn_chain():
    """The churn chain of ``churn_chain``, built and executed by the port's
    ``testutil/chain.build_chain``."""
    from tendermint_tpu_torch.abci.examples.kvstore import PersistentKVStoreApp as PApp
    from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519 as PPriv
    from tendermint_tpu_torch.testutil.chain import build_chain as pbuild_chain
    from tendermint_tpu_torch.types.priv_validator import MockPV as PMockPV

    joiners = [PMockPV(PPriv.generate(bytes([50 + i]) * 32)) for i in range(3)]

    def on_height(h, st):
        if h == 4:
            return [_val_tx(pv.get_pub_key().bytes(), 100) for pv in joiners]
        if h == 8:
            leavers = [v for v in st.validators.validators if v.voting_power == 10][:3]
            return [_val_tx(v.pub_key.bytes(), 0) for v in leavers]
        return []

    return pbuild_chain(n_vals=4, n_heights=14, chain_id="lite-churn", app_factory=PApp,
                        on_height=on_height, extra_pvs=joiners)


def test_proxy_over_the_ports_stores_certifies_what_the_chains_source_does(churn_chain):
    fx, src = churn_chain
    port_fx = _port_churn_chain()
    pin = dict(trusted_height=1, trusted_hash=_pin(fx))
    over_stores = LiteProxy(fx.chain_id, block_store=port_fx.block_store,
                            state_db=port_fx.state_db, batch_window_s=0.001, **pin)
    over_source = LiteProxy(fx.chain_id, source=src, batch_window_s=0.001, **pin)
    try:
        assert isinstance(over_stores.source, NodeProvider)
        assert over_stores.status() == over_source.status()
        for h in (2, 5, 8, 11, fx.height):
            assert over_stores.verify_commit(h) == over_source.verify_commit(h)
            assert over_stores.light_block(h) == over_source.light_block(h)
        assert (_trusted_heights(over_stores.trusted, fx.chain_id, fx.height)
                == _trusted_heights(over_source.trusted, fx.chain_id, fx.height))
    finally:
        over_stores.close()
        over_source.close()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body) if body else None


def test_http_surface_serves_the_reference_json(churn_chain):
    fx, src = churn_chain
    ref, port = _proxies(fx, src, trusted_height=1, trusted_hash=_pin(fx))
    httpd = serve_proxy(port, "127.0.0.1:0")
    # a burst of clients must not overflow the stdlib's listen backlog of 5
    assert httpd.request_queue_size >= 64
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        p = httpd.server_address[1]
        assert _get(p, "/status") == (200, {"result": ref.status()})
        assert _get(p, "/commit?height=5") == (200, {"result": ref.commit(5)})
        assert _get(p, "/verify_commit?height=13") == (200, {"result": ref.verify_commit(13)})
        code, body = _get(p, "/light_block?height=13")
        assert code == 200 and body == {"result": ref.light_block(13)}
        raw = base64.b64decode(body["result"]["full_commit"])
        assert FullCommit.unmarshal(raw).marshal() == raw
        code, body = _get(p, "/frontend_stats")
        assert code == 200 and body["result"]["cache_entries"] == 2  # heights 13 and 5
        assert _get(p, "/verify_commit?height=x") == (400, {"error": "bad height"})
        assert _get(p, "/nothing")[0] == 404
        code, body = _get(p, "/verify_commit?height=99")
        assert code == 502 and "99" in body["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(TIMEOUT)
        ref.close()
        port.close()


# -- metrics ----------------------------------------------------------------------

def test_frontend_metrics_match_the_reference():
    port, ref = tmetrics.FrontendMetrics(), jmetrics.FrontendMetrics()
    assert port.registry.expose_text() == ref.registry.expose_text()
    for m in (port, ref):
        m.requests.add(2.0, ("verify_commit", "ok"))
        m.requests.add(1.0, ("light_block", "error"))
        for outcome in ("hit", "miss", "wait", "hit"):
            m.cache_events.add(1.0, (outcome,))
        m.cache_size.set(17.0)
        m.heights_verified.add(5.0)
        m.batch_rows.observe(12.0)
        m.batch_occupancy.observe(0.75)
        m.verify_seconds.observe(0.031)
    assert port.registry.expose_text() == ref.registry.expose_text()
    assert tmetrics.get_frontend_metrics() is tmetrics.get_frontend_metrics()
