"""The port's mempool admission control (``mempool/qos.py``) and the gossip
reactor's QoS gate (``mempool/reactor.py``) against the reference package's.

* The reference's ``tests/test_mempool_qos.py`` classes ``TestTokenBucket``,
  ``TestMempoolQoS`` and ``TestReactorGate`` restated, each case run on both
  packages: refill math to the token, per-peer limits, muting and
  forgiveness, fairness under a contended aggregate bucket, the metrics and
  the snapshot, the reactor's gate in front of ``check_tx``.
* A differential case: a seeded numpy stream of (peer, bytes, clock step)
  through both packages' ``MempoolQoS`` gives the same decisions, reasons,
  per-peer ledgers and snapshots, and the same metrics exposition.
* The reactor's device-fault contract: on a faked card (the mempool's verdict
  hook claims CUDA) a CheckTx window's device fault met on a gossiped tx,
  the window's own or one the wait timer kept, is this node's, not the
  sender's: the reactor keeps it as ``device_fault`` and returns; any other
  error (an app's, on the card or off it) and off the card any error but
  ``MempoolError`` raise, as the reference's do (the switch then stops the
  sender).

Every QoS clock is a stepped ``SimClock``; only the timer's case waits on
the wall clock, for the mempool's 10 ms batch wait.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.abci.examples.kvstore import KVStoreApp as RKVStoreApp
from tendermint_tpu.config.config import MempoolConfig as RMempoolConfig
from tendermint_tpu.libs.metrics import NodeMetrics as RNodeMetrics
from tendermint_tpu.mempool import mempool as rmempool
from tendermint_tpu.mempool import qos as rqos
from tendermint_tpu.mempool import reactor as rreactor
from tendermint_tpu.proxy import app_conn as rapp_conn
from tendermint_tpu.sim.clock import SimClock
from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.mempool import mempool as pmempool
from tendermint_tpu_torch.mempool import qos as pqos
from tendermint_tpu_torch.mempool import reactor as preactor
from tendermint_tpu_torch.proxy import app_conn as papp_conn

SEC = 1_000_000_000  # ns

REF = SimpleNamespace(name="reference", qos=rqos, reactor=rreactor, mempool=rmempool,
                      conn=rapp_conn, App=RKVStoreApp, Config=RMempoolConfig,
                      Metrics=RNodeMetrics)
PORT = SimpleNamespace(name="port", qos=pqos, reactor=preactor, mempool=pmempool,
                       conn=papp_conn, App=KVStoreApp, Config=MempoolConfig, Metrics=NodeMetrics)
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=lambda ns: ns.name)


def stepped_clock(start_ns: int = 1 * SEC) -> SimClock:
    """A frozen SimClock advanced explicitly via .freeze(t)."""
    return SimClock(frozen_at_ns=start_ns)


def qos_config(pkg, **kw):
    defaults = dict(qos_enabled=True, qos_peer_tx_rate=2.0, qos_peer_tx_burst=2.0,
                    qos_peer_byte_rate=1000.0, qos_peer_byte_burst=1000.0,
                    qos_global_tx_rate=0.0, qos_mute_after=0)
    defaults.update(kw)
    return pkg.Config(**defaults)


def test_the_decision_names_equal_the_references():
    for name in ("ADMIT", "DROP_TX_RATE", "DROP_BYTE_RATE", "DROP_MUTED", "DROP_FAIR"):
        assert getattr(pqos, name) == getattr(rqos, name)


# -- TestTokenBucket ------------------------------------------------------------------------


@PKGS
class TestTokenBucket:
    def test_refill_math_is_exact(self, pkg):
        clk = stepped_clock()
        b = pkg.qos.TokenBucket(rate=10.0, burst=5.0, now_ns=clk)
        assert b.level() == 5.0
        for _ in range(5):
            assert b.try_consume(1.0)
        assert not b.try_consume(1.0)
        clk.freeze(clk.now_ns() + SEC // 4)  # 0.25 s at 10/s: exactly 2.5 tokens
        assert b.level() == pytest.approx(2.5)
        assert b.try_consume(2.0)
        assert not b.try_consume(1.0)
        clk.freeze(clk.now_ns() + 1000 * SEC)  # refill caps at the burst
        assert b.level() == 5.0

    def test_zero_rate_disables(self, pkg):
        b = pkg.qos.TokenBucket(rate=0.0, burst=0.0, now_ns=stepped_clock())
        assert all(b.try_consume(1.0) for _ in range(100))

    def test_overdraft_floor(self, pkg):
        b = pkg.qos.TokenBucket(rate=10.0, burst=2.0, now_ns=stepped_clock())
        assert b.try_consume(2.0)
        assert b.consume_with_overdraft(1.0, floor=2.0)
        assert b.consume_with_overdraft(1.0, floor=2.0)
        assert not b.consume_with_overdraft(1.0, floor=2.0)
        assert b.level() == pytest.approx(-2.0)

    def test_clock_never_goes_backwards_in_refill(self, pkg):
        clk = stepped_clock(start_ns=10 * SEC)
        b = pkg.qos.TokenBucket(rate=10.0, burst=5.0, now_ns=clk)
        assert b.try_consume(5.0)
        clk.freeze(9 * SEC)  # a host clock hiccup: one second back
        assert b.level() == 0.0


# -- TestMempoolQoS -------------------------------------------------------------------------


@PKGS
class TestMempoolQoS:
    def test_peer_tx_rate_limit(self, pkg):
        q, clk = pkg.qos, stepped_clock()
        m = q.MempoolQoS(qos_config(pkg), now_ns=clk)
        assert m.admit("p1", 10) == (True, q.ADMIT)
        assert m.admit("p1", 10) == (True, q.ADMIT)
        assert m.admit("p1", 10) == (False, q.DROP_TX_RATE)
        clk.freeze(clk.now_ns() + SEC // 2)  # one token back at 2 tx/s
        assert m.admit("p1", 10) == (True, q.ADMIT)
        assert m.admit("p1", 10) == (False, q.DROP_TX_RATE)

    def test_peer_byte_rate_limit(self, pkg):
        q = pkg.qos
        m = q.MempoolQoS(qos_config(pkg, qos_peer_tx_rate=1000.0, qos_peer_tx_burst=1000.0,
                                    qos_peer_byte_rate=100.0, qos_peer_byte_burst=100.0),
                         now_ns=stepped_clock())
        assert m.admit("p1", 60) == (True, q.ADMIT)
        assert m.admit("p1", 60) == (False, q.DROP_BYTE_RATE)
        assert m.admit("p1", 40) == (True, q.ADMIT)

    def test_peers_are_isolated(self, pkg):
        q = pkg.qos
        m = q.MempoolQoS(qos_config(pkg), now_ns=stepped_clock())
        m.admit("spam", 1)
        m.admit("spam", 1)
        assert m.admit("spam", 1)[0] is False
        assert m.admit("honest", 1) == (True, q.ADMIT)

    def test_mute_escalates_and_forgives(self, pkg):
        q, clk = pkg.qos, stepped_clock()
        m = q.MempoolQoS(qos_config(pkg, qos_mute_after=2, qos_mute_base_s=1.0,
                                    qos_mute_max_s=60.0, qos_forgive_s=10.0), now_ns=clk)
        m.admit("p", 1)
        m.admit("p", 1)
        assert m.admit("p", 1) == (False, q.DROP_TX_RATE)
        assert m.admit("p", 1) == (False, q.DROP_TX_RATE)  # the 2nd violation mutes
        st = m.peer_state("p")
        assert st["muted"] and st["offenses"] == 1
        mute1_until = st["muted_until_ns"]
        assert mute1_until == clk.now_ns() + 1 * SEC
        assert m.admit("p", 1) == (False, q.DROP_MUTED)
        clk.freeze(mute1_until + 1)
        assert m.admit("p", 1) == (True, q.ADMIT)
        for _ in range(4):  # re-offend inside the forgiveness window: 2 s
            m.admit("p", 1)
        st = m.peer_state("p")
        assert st["muted"] and st["offenses"] == 2
        assert st["muted_until_ns"] - clk.now_ns() == 2 * SEC
        clk.freeze(st["muted_until_ns"] + 11 * SEC)  # a long clean stretch
        assert m.admit("p", 1) == (True, q.ADMIT)
        assert m.peer_state("p")["offenses"] == 0

    def test_fairness_spammer_cannot_starve_honest_peer(self, pkg):
        q = pkg.qos
        m = q.MempoolQoS(qos_config(pkg, qos_peer_tx_rate=1000.0, qos_peer_tx_burst=1000.0,
                                    qos_global_tx_rate=10.0, qos_global_tx_burst=10.0,
                                    qos_fair_reserve=5.0, qos_fair_slack=1.0,
                                    qos_fair_window_s=1.0), now_ns=stepped_clock())
        assert m.admit("honest", 1) == (True, q.ADMIT)
        for _ in range(9):
            assert m.admit("spam", 1) == (True, q.ADMIT)
        assert m.admit("spam", 1) == (False, q.DROP_FAIR)
        assert m.admit("honest", 1) == (True, q.ADMIT)  # the bounded reserve
        assert m.admit("spam", 1) == (False, q.DROP_FAIR)

    def test_decisions_are_deterministic_replay(self, pkg):
        schedule = ([("spam", 1, 0)] * 8 + [("honest", 1, 0)] * 2
                    + [("spam", 1, SEC // 10)] * 6 + [("honest", 1, SEC // 5)] * 3)

        def run():
            clk = stepped_clock()
            m = pkg.qos.MempoolQoS(qos_config(pkg, qos_peer_tx_rate=4.0, qos_peer_tx_burst=4.0,
                                              qos_global_tx_rate=8.0, qos_global_tx_burst=8.0,
                                              qos_mute_after=3, qos_mute_base_s=0.5),
                                   now_ns=clk)
            out = []
            for peer, nbytes, advance_ns in schedule:
                clk.freeze(clk.now_ns() + advance_ns)
                out.append(m.admit(peer, nbytes))
            return out

        assert run() == run()

    def test_forget_peer_resets_ledger(self, pkg):
        q = pkg.qos
        m = q.MempoolQoS(qos_config(pkg), now_ns=stepped_clock())
        m.admit("p", 1)
        m.admit("p", 1)
        assert m.admit("p", 1)[0] is False
        m.forget_peer("p")
        assert m.admit("p", 1) == (True, q.ADMIT)

    def test_drop_metrics_and_snapshot(self, pkg):
        q, metrics = pkg.qos, pkg.Metrics()
        m = q.MempoolQoS(qos_config(pkg), metrics=metrics, now_ns=stepped_clock())
        for _ in range(3):
            m.admit("p", 1)
        text = metrics.registry.expose_text()
        assert "tendermint_mempool_qos_admitted_total 2" in text
        assert 'tendermint_mempool_qos_dropped_total{reason="tx_rate"} 1' in text
        snap = m.snapshot()
        assert snap["enabled"] is True
        assert snap["peers"]["p"]["admitted"] == 2
        assert snap["peers"]["p"]["dropped"] == 1
        assert snap["peers"]["p"]["last_drop_reason"] == q.DROP_TX_RATE


# -- TestReactorGate ------------------------------------------------------------------------


class _FakePeer:
    def __init__(self, pid):
        self.id = pid


def started_mempool(pkg, closing=None, **kw):
    conn = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(pkg.App()))
    conn.start()
    if closing is not None:
        closing.append(conn)
    return pkg.mempool.Mempool(conn.mempool, **kw)


@pytest.fixture
def conns():
    opened = []
    yield opened
    for c in opened:
        c.stop()


@PKGS
class TestReactorGate:
    def test_receive_drops_over_limit_txs(self, pkg, conns):
        mp = started_mempool(pkg, conns)
        cfg = qos_config(pkg, qos_peer_tx_rate=2.0, qos_peer_tx_burst=2.0)
        reactor = pkg.reactor.MempoolReactor(mp, config=cfg, now_ns=stepped_clock())
        peer = _FakePeer("noisy")
        for i in range(5):
            reactor.receive(0, peer, pkg.reactor.encode_tx_msg(b"t%d=%d" % (i, i)))
        assert mp.size() == 2  # the bucket admitted exactly its burst
        snap = reactor.qos_snapshot()
        assert snap["peers"]["noisy"]["admitted"] == 2
        assert snap["peers"]["noisy"]["dropped"] == 3
        reactor.remove_peer(peer, None)  # a disconnect drops the ledger
        assert "noisy" not in reactor.qos_snapshot()["peers"]

    def test_reactor_without_config_admits_everything(self, pkg, conns):
        mp = started_mempool(pkg, conns)
        reactor = pkg.reactor.MempoolReactor(mp)
        assert reactor.qos is None
        for i in range(10):
            reactor.receive(0, _FakePeer("p"), pkg.reactor.encode_tx_msg(b"x%d=%d" % (i, i)))
        assert mp.size() == 10
        assert reactor.qos_snapshot() == {"enabled": False, "peers": {}}

    def test_the_default_section_gates_with_qos_on(self, pkg, conns):
        reactor = pkg.reactor.MempoolReactor(started_mempool(pkg, conns), config=pkg.Config())
        assert reactor.qos is not None
        assert [(d.id, d.priority, d.send_queue_capacity, d.recv_message_capacity)
                for d in reactor.get_channels()] == [(0x30, 5, 100, 1024 * 1024)]


# -- the differential case ---------------------------------------------------------------------


def qos_stream(seed: int, n: int = 600):
    """A seeded stream of (peer, bytes, clock step in ns): four peers, one of
    them a spammer sending most of the traffic in bursts."""
    rng = np.random.default_rng(seed)
    peers = rng.choice(["spam", "a", "b", "c"], size=n, p=[0.55, 0.15, 0.15, 0.15])
    sizes = rng.integers(1, 400, size=n)
    steps = np.where(rng.random(n) < 0.8, 0, rng.integers(1, SEC // 3, size=n))
    return [(str(p), int(b), int(s)) for p, b, s in zip(peers, sizes, steps)]


QOS_KNOBS = [
    {},  # the [mempool] defaults
    dict(qos_peer_tx_rate=20.0, qos_peer_tx_burst=10.0, qos_peer_byte_rate=2000.0,
         qos_peer_byte_burst=1500.0, qos_mute_after=4, qos_mute_base_s=0.25, qos_mute_max_s=2.0,
         qos_forgive_s=1.5),
    dict(qos_peer_tx_rate=200.0, qos_peer_tx_burst=100.0, qos_global_tx_rate=30.0,
         qos_global_tx_burst=15.0, qos_fair_reserve=4.0, qos_fair_slack=1.2,
         qos_fair_window_s=0.5, qos_mute_after=6),
]


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("knobs", range(len(QOS_KNOBS)))
def test_a_seeded_stream_gets_the_references_decisions_and_snapshots(knobs, seed):
    runs = []
    for pkg in (REF, PORT):
        clk, metrics = stepped_clock(), pkg.Metrics()
        m = pkg.qos.MempoolQoS(pkg.Config(**QOS_KNOBS[knobs]), metrics=metrics, now_ns=clk)
        out, snaps = [], []
        for i, (peer, nbytes, step) in enumerate(qos_stream(seed)):
            clk.freeze(clk.now_ns() + step)
            out.append(m.admit(peer, nbytes))
            if i % 97 == 0:
                snaps.append(m.snapshot())
                if i % 2:
                    m.forget_peer("a")
        snaps.append(m.snapshot())
        qos_lines = sorted(line for line in metrics.registry.expose_text().splitlines()
                           if "mempool_qos" in line and not line.startswith("#"))
        runs.append((out, snaps, {p: m.peer_state(p) for p in ("spam", "a", "b", "c")},
                     qos_lines))
    assert runs[0] == runs[1]
    reasons = {r for _, r in runs[1][0]}
    assert pqos.ADMIT in reasons
    if knobs:
        assert len(reasons) >= 3  # the stream reaches the drop paths


# -- the device-fault contract -------------------------------------------------------------------


class _CardHook:
    """A verdict hook on a faked card: ``fault`` set, it raises ``fault``."""

    device = SimpleNamespace(type="cuda")

    def __init__(self):
        self.fault = None

    def __call__(self, txs):
        if self.fault is not None:
            raise self.fault
        return [True] * len(txs)


def hooked_reactor(conns, device_type="cuda", **kw):
    mp = started_mempool(PORT, conns, **{"checktx_batch": 1, **kw})
    hook = _CardHook()
    hook.device = SimpleNamespace(type=device_type)
    mp.set_batch_check_hook(hook, verdicts=True)
    assert brk.on_card(hook) == (device_type == "cuda")
    return mp, hook, preactor.MempoolReactor(mp, config=MempoolConfig())


@pytest.mark.parametrize("fault", [brk.DeviceDispatchError("error", "tx feed flush"),
                                   RuntimeError("flaky feed")], ids=["dispatch", "feed"])
def test_on_the_card_a_checktx_fault_is_the_nodes_not_the_senders(conns, fault):
    mp, hook, reactor = hooked_reactor(conns)
    hook.fault = fault
    reactor.receive(0x30, _FakePeer("honest"), preactor.encode_tx_msg(b"k1=v1"))
    reactor.receive(0x30, _FakePeer("honest"), preactor.encode_tx_msg(b"k2=v2"))
    assert reactor.device_fault is fault and reactor.device_faults == 2
    assert mp.size() == 0
    hook.fault = None  # the card is back: the next gossiped tx is admitted
    reactor.receive(0x30, _FakePeer("honest"), preactor.encode_tx_msg(b"k3=v3"))
    assert mp.size() == 1 and reactor.device_faults == 2
    # what the gate admitted, the fault included
    assert reactor.qos_snapshot()["peers"]["honest"]["admitted"] == 3


def test_on_the_card_a_timer_window_fault_met_by_a_gossiped_tx_is_the_nodes(conns):
    """A window flushed on the wait timer's thread fails; the next
    ``check_tx`` raises it, and here that call is the reactor's."""
    mp, hook, reactor = hooked_reactor(conns, checktx_batch=8, checktx_batch_wait=0.01)
    fault = brk.DeviceDispatchError("error", "tx feed flush")
    hook.fault = fault
    mp.check_tx(b"rpc=1")  # below the window: the timer flushes it
    deadline = time.monotonic() + 10
    while mp._deferred_error is None and time.monotonic() < deadline:
        time.sleep(0.005)
    assert mp._deferred_error is fault and pmempool.is_window_fault(fault)
    hook.fault = None
    reactor.receive(0x30, _FakePeer("honest"), preactor.encode_tx_msg(b"k=v"))
    assert reactor.device_fault is fault and reactor.device_faults == 1


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_an_app_error_on_a_gossiped_tx_raises_as_the_references(conns, device_type):
    """An error out of the app connection is no CheckTx window's: on the
    card as off it, the reactor raises it (the switch stops the sender), as
    the reference's does."""
    mp, hook, reactor = hooked_reactor(conns, device_type=device_type)

    def crafted(tx, sig_verified=None):
        raise RuntimeError("crafted tx")

    rmp = started_mempool(REF, conns)
    for m in (mp, rmp):
        m._proxy.check_tx_async = crafted
    with pytest.raises(RuntimeError, match="crafted tx"):
        reactor.receive(0x30, _FakePeer("p"), preactor.encode_tx_msg(b"k=v"))
    with pytest.raises(RuntimeError, match="crafted tx"):
        rreactor.MempoolReactor(rmp).receive(0x30, _FakePeer("p"),
                                            rreactor.encode_tx_msg(b"k=v"))
    assert reactor.device_fault is None and reactor.device_faults == 0


def test_off_the_card_a_checktx_error_raises_as_the_references(conns):
    mp, hook, reactor = hooked_reactor(conns, device_type="cpu")
    hook.fault = RuntimeError("hook failed")
    # off the card the mempool falls back to the app's serial path: admitted
    reactor.receive(0x30, _FakePeer("p"), preactor.encode_tx_msg(b"k=v"))
    assert mp.size() == 1 and reactor.device_fault is None
    # any other error out of check_tx raises, as the reference's reactor
    # raises it (the switch stops the sender)
    mp.check_tx = lambda tx: (_ for _ in ()).throw(RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        reactor.receive(0x30, _FakePeer("p"), preactor.encode_tx_msg(b"k2=v"))
    rmp = started_mempool(REF, conns)
    rmp.check_tx = mp.check_tx
    with pytest.raises(RuntimeError, match="boom"):
        rreactor.MempoolReactor(rmp).receive(0x30, _FakePeer("p"),
                                            rreactor.encode_tx_msg(b"k2=v"))
    assert reactor.device_fault is None


def test_mempool_errors_stay_unremarkable_on_both_packages(conns):
    for pkg in (REF, PORT):
        mp = started_mempool(pkg, conns)
        reactor = pkg.reactor.MempoolReactor(mp)
        msg = pkg.reactor.encode_tx_msg(b"dup=1")
        reactor.receive(0x30, _FakePeer("p"), msg)
        reactor.receive(0x30, _FakePeer("p"), msg)  # TxInCacheError: swallowed
        assert mp.size() == 1
        with pytest.raises(ValueError):
            reactor.receive(0x30, _FakePeer("p"), b"\x02\x00")  # an unknown tag raises
