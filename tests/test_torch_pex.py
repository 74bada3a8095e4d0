"""The peer exchange and the p2p periphery of the port (``p2p/pex/``,
``p2p/trust.py``, ``p2p/fuzz.py``, ``p2p/upnp.py``) against the reference's.

* Every case of ``tests/test_pex.py`` and of ``tests/test_periphery.py``'s
  ``TestFuzzedConnection`` and ``TestTrustMetric`` runs once on each package.
* Across the packages: the PEX messages byte for byte both ways, a port
  switch's PEX reactor against a reference switch's over TCP (either end
  dialing), an address book written by one package loaded by the other,
  equal trust scores for the same events under one clock, equal fuzz
  decisions from one seed, and the UPnP probe's answer without a gateway.
* Nodes: a port node that knows only a seed joins a 3-node port net by
  PEX and follows its heights (the host verifying, as the nets' tests do).
"""

import json
import random
import socket
import time
from types import SimpleNamespace

import numpy as np
import pytest

import tendermint_tpu.p2p as R
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as RKey
from tendermint_tpu.p2p import fuzz as r_fuzz
from tendermint_tpu.p2p import test_util as r_tu
from tendermint_tpu.p2p import trust as r_trust
from tendermint_tpu.p2p import upnp as r_upnp
from tendermint_tpu.p2p.conn import secret_connection as r_sc
from tendermint_tpu.p2p.pex import addrbook as r_addrbook
from tendermint_tpu.p2p.pex import pex_reactor as r_pex
from tendermint_tpu_torch.config import config as pconfig
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.p2p import NetAddress, fuzz, test_util, trust, upnp
from tendermint_tpu_torch.p2p.conn import secret_connection as p_sc
from tendermint_tpu_torch.p2p.pex import addrbook, pex_reactor
from tendermint_tpu_torch.testutil import node_net

DEADLINE = 30.0

REF = SimpleNamespace(name="reference", Key=RKey, NetAddress=R.NetAddress,
                      AddrBook=r_addrbook.AddrBook, PEXReactor=r_pex.PEXReactor, pex=r_pex,
                      tu=r_tu, sc=r_sc, fuzz=r_fuzz, trust=r_trust)
PORT = SimpleNamespace(name="port", Key=PrivKeyEd25519, NetAddress=NetAddress,
                       AddrBook=addrbook.AddrBook, PEXReactor=pex_reactor.PEXReactor,
                       pex=pex_reactor, tu=test_util, sc=p_sc, fuzz=fuzz, trust=trust)
PACKAGES = [REF, PORT]
by_pkg = pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)


def _wait_until(pred, timeout=5.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _local_dials_only(sw):
    """Refuse the switch's dials of any host but 127.0.0.1 without sending
    a packet: the books' 1.2.3.x extras stand for peers out of reach."""
    real = sw.dial_peer_with_address

    def dial(addr, *a, **kw):
        if addr.host != "127.0.0.1":
            raise ConnectionRefusedError(f"{addr.host} is out of reach")
        return real(addr, *a, **kw)

    sw.dial_peer_with_address = dial
    return sw


def _addr(pkg, i: int, port=26656):
    ident = pkg.Key.generate(bytes([i]) * 32).pub_key().address().hex()
    return pkg.NetAddress(ident, f"1.2.3.{i}", port)


# ---------------------------------------------------------------------------
# tests/test_pex.py, restated on both packages
# ---------------------------------------------------------------------------


@by_pkg
class TestAddrBook:
    def test_add_pick_mark_good(self, pkg, tmp_path):
        book = pkg.AddrBook(str(tmp_path / "book.json"))
        src = _addr(pkg, 1)
        for i in range(2, 12):
            assert book.add_address(_addr(pkg, i), src)
        assert book.size() == 10
        picked = book.pick_address()
        assert picked is not None
        book.mark_good(picked)
        assert book.is_good(picked)

    def test_strict_rejects_private(self, pkg, tmp_path):
        book = pkg.AddrBook(str(tmp_path / "b.json"), strict=True)
        loop = pkg.NetAddress(_addr(pkg, 1).id, "127.0.0.1", 26656)
        assert not book.add_address(loop, loop)
        lax = pkg.AddrBook(None, strict=False)
        assert lax.add_address(loop, loop)

    def test_rejects_our_address(self, pkg):
        book = pkg.AddrBook(None)
        me = _addr(pkg, 7)
        book.add_our_address(me)
        assert not book.add_address(me, _addr(pkg, 8))

    def test_persistence_roundtrip(self, pkg, tmp_path):
        path = str(tmp_path / "book.json")
        book = pkg.AddrBook(path)
        a = _addr(pkg, 3)
        book.add_address(a, a)
        book.mark_good(a)
        book.save()
        reloaded = pkg.AddrBook(path)
        assert reloaded.size() == 1
        assert reloaded.is_good(a)

    def test_attempts_eventually_drop_new_addresses(self, pkg):
        book = pkg.AddrBook(None)
        a = _addr(pkg, 4)
        book.add_address(a, a)
        for _ in range(10):
            book.mark_attempt(a)
        assert not book.has_address(a)

    def test_list_known_carries_monotonic_attempt_stamp(self, pkg):
        book = pkg.AddrBook(None)
        a = _addr(pkg, 5)
        book.add_address(a, a)
        book.mark_attempt(a)
        (ka,) = book.list_known()
        assert ka.last_attempt_mono > 0.0
        assert ka.last_attempt > 0.0

    def test_get_selection_capped(self, pkg):
        book = pkg.AddrBook(None, strict=False)
        src = _addr(pkg, 1)
        for i in range(2, 60):
            book.add_address(_addr(pkg, i), src)
        sel = book.get_selection()
        assert 1 <= len(sel) <= 250
        assert len({a.id for a in sel}) == len(sel)

    def test_wire_roundtrip(self, pkg):
        addrs = [_addr(pkg, i) for i in range(1, 5)]
        kind, got = pkg.pex.decode_pex_msg(pkg.pex.encode_pex_addrs(addrs))
        assert kind == "addrs" and got == addrs
        assert pkg.pex.decode_pex_msg(pkg.pex.encode_pex_request()) == ("request", None)


@by_pkg
class TestPEXReactor:
    def test_outbound_peer_addr_exchange(self, pkg):
        books = {}

        def init(i, sw):
            books[i] = pkg.AddrBook(None, strict=False)
            sw.add_reactor("pex", pkg.PEXReactor(books[i], ensure_period=0.15))
            return _local_dials_only(sw)

        sws = pkg.tu.make_connected_switches(2, init)
        try:
            # the 1.2.3.x extras are unreachable: failed dials must not
            # evict them while the exchange runs
            books[0].mark_attempt = lambda a: None
            books[1].mark_attempt = lambda a: None
            extra = [_addr(pkg, i) for i in range(50, 55)]
            for a in extra:
                books[1].add_address(a, a)
            assert _wait_until(lambda: all(books[0].has_address(a) for a in extra),
                               timeout=DEADLINE), books[0].size()
        finally:
            for sw in sws:
                sw.stop()

    def test_unsolicited_addrs_drops_peer(self, pkg):
        def init(i, sw):
            sw.add_reactor("pex", pkg.PEXReactor(pkg.AddrBook(None), ensure_period=5))
            return _local_dials_only(sw)

        sws = pkg.tu.make_connected_switches(2, init)
        try:
            peer0 = sws[1].peers.list()[0]
            peer0.send(0x00, pkg.pex.encode_pex_addrs([_addr(pkg, 9)]))
            assert _wait_until(lambda: sws[0].peers.size() == 0, timeout=10)
        finally:
            for sw in sws:
                sw.stop()

    def test_seed_mode_shares_then_disconnects(self, pkg):
        books = {0: pkg.AddrBook(None, strict=False), 1: pkg.AddrBook(None, strict=False)}
        stock = [_addr(pkg, i) for i in range(40, 44)]
        for a in stock:
            books[0].add_address(a, a)
        books[1].mark_attempt = lambda a: None

        def init(i, sw):
            if i == 0:
                sw.add_reactor("pex", pkg.PEXReactor(
                    books[i], seed_mode=True, ensure_period=0.2,
                    seed_share_disconnect_delay=0.3, crawl_period=30))
            else:
                sw.add_reactor("pex", pkg.PEXReactor(books[i], ensure_period=0.2))
            return _local_dials_only(sw)

        sws = pkg.tu.make_connected_switches(2, init)
        try:
            assert _wait_until(lambda: any(books[1].has_address(a) for a in stock),
                               timeout=DEADLINE)
            assert _wait_until(lambda: sws[0].peers.size() == 0, timeout=10)
        finally:
            for sw in sws:
                sw.stop()

    def test_seed_bootstraps_three_node_net(self, pkg):
        books = {}

        def init(i, sw):
            books[i] = pkg.AddrBook(None, strict=False)
            if i == 0:
                sw.add_reactor("pex", pkg.PEXReactor(
                    books[i], seed_mode=True, ensure_period=0.3,
                    seed_share_disconnect_delay=0.5, crawl_period=0.5, crawl_interval=0.5,
                    seed_disconnect_wait=2.0))
            else:
                sw.add_reactor("pex", pkg.PEXReactor(books[i], ensure_period=0.3))
            return sw

        seed = pkg.tu.make_switch(0, init_switch=init, network="seednet")
        sw_a = pkg.tu.make_switch(1, init_switch=init, network="seednet")
        sw_b = pkg.tu.make_switch(2, init_switch=init, network="seednet")
        seed.start(), sw_a.start(), sw_b.start()
        try:
            seed_laddr = seed.transport.listen("127.0.0.1:0")
            a_laddr = sw_a.transport.listen("127.0.0.1:0")
            b_laddr = sw_b.transport.listen("127.0.0.1:0")
            books[1].add_address(seed_laddr, seed_laddr)
            books[2].add_address(seed_laddr, seed_laddr)
            books[0].add_address(a_laddr, a_laddr)
            books[0].add_address(b_laddr, b_laddr)
            assert _wait_until(lambda: sw_a.peers.has(sw_b.node_id)
                               or sw_b.peers.has(sw_a.node_id), timeout=DEADLINE)
        finally:
            seed.stop(), sw_a.stop(), sw_b.stop()

    def test_ensure_peers_dials_from_book(self, pkg):
        books = {}

        def init(i, sw):
            books[i] = pkg.AddrBook(None, strict=False)
            sw.add_reactor("pex", pkg.PEXReactor(books[i], ensure_period=0.3))
            return sw

        sw_a = pkg.tu.make_switch(0, init_switch=init, network="pexnet")
        books_a = books[0]
        sw_b = pkg.tu.make_switch(1, init_switch=init, network="pexnet")
        sw_a.start(), sw_b.start()
        try:
            laddr = sw_b.transport.listen("127.0.0.1:0")
            books_a.add_address(laddr, laddr)
            assert _wait_until(lambda: sw_a.peers.has(sw_b.node_id), timeout=DEADLINE)
            assert _wait_until(lambda: books_a.is_good(laddr), timeout=5)
        finally:
            sw_a.stop(), sw_b.stop()


# ---------------------------------------------------------------------------
# tests/test_periphery.py's TestFuzzedConnection and TestTrustMetric
# ---------------------------------------------------------------------------


@by_pkg
class TestFuzzedConnection:
    def test_drop_mode_loses_writes(self, pkg):
        s1, s2 = socket.socketpair()
        fz = pkg.fuzz.FuzzedConnection(
            pkg.sc.RawConn(s1), pkg.fuzz.FuzzConfig(mode="drop", prob_drop_rw=1.0),
            rng=random.Random(1))
        fz.write(b"dropped")
        s1.sendall(b"real")
        assert s2.recv(100) == b"real"
        fz.close(), s2.close()

    def test_delay_mode_delivers_slowly(self, pkg):
        s1, s2 = socket.socketpair()
        fz = pkg.fuzz.FuzzedConnection(
            pkg.sc.RawConn(s1), pkg.fuzz.FuzzConfig(mode="delay", max_delay=0.05),
            rng=random.Random(2))
        fz.write(b"slow")
        assert s2.recv(10) == b"slow"
        fz.close(), s2.close()


@by_pkg
class TestTrustMetric:
    def test_good_and_bad_events_move_score(self, pkg):
        m = pkg.trust.TrustMetric()
        assert m.trust_score() == 100
        for _ in range(10):
            m.bad_event()
        low = m.trust_score()
        assert low < 100
        for _ in range(50):
            m.good_event()
        assert m.trust_score() > low

    def test_store_persistence(self, pkg, tmp_path):
        path = str(tmp_path / "trust.json")
        store = pkg.trust.TrustMetricStore(path)
        m = store.get_metric("peer-a")
        for _ in range(10):
            m.bad_event()
        score = store.peer_score("peer-a")
        store.save()
        reloaded = pkg.trust.TrustMetricStore(path)
        assert abs(reloaded.peer_score("peer-a") - score) <= 45
        assert reloaded.peer_score("peer-a") < 100


# ---------------------------------------------------------------------------
# the packages against each other
# ---------------------------------------------------------------------------


def _seeded_addrs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        ident = PrivKeyEd25519.generate(key).pub_key().address().hex()
        host = ".".join(str(int(x)) for x in rng.integers(1, 255, 4))
        out.append((ident, host, int(rng.integers(1, 65535))))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_pex_messages_equal_the_reference_both_ways(seed):
    triples = _seeded_addrs(seed, 1 + 40 * seed)
    p_addrs = [NetAddress(*t) for t in triples]
    r_addrs = [R.NetAddress(*t) for t in triples]
    assert pex_reactor.encode_pex_request() == r_pex.encode_pex_request()
    wire = pex_reactor.encode_pex_addrs(p_addrs)
    assert wire == r_pex.encode_pex_addrs(r_addrs)
    kind, got = r_pex.decode_pex_msg(wire)
    assert kind == "addrs" and [str(a) for a in got] == [str(a) for a in p_addrs]
    kind, got = pex_reactor.decode_pex_msg(r_pex.encode_pex_addrs(r_addrs))
    assert kind == "addrs" and got == p_addrs
    for bad in (r_pex.encode_pex_addrs([R.NetAddress(*triples[0])] * 251), b"\x07"):
        errs = []
        for decode in (pex_reactor.decode_pex_msg, r_pex.decode_pex_msg):
            with pytest.raises(ValueError) as ei:
                decode(bad)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("writer", PACKAGES, ids=lambda p: p.name)
def test_an_address_book_written_by_one_package_loads_in_the_other(writer, tmp_path):
    reader = PORT if writer is REF else REF
    path = str(tmp_path / "addrbook.json")
    book = writer.AddrBook(path, strict=False)
    triples = _seeded_addrs(7, 12)
    addrs = [writer.NetAddress(*t) for t in triples]
    for a in addrs:
        assert book.add_address(a, addrs[0])
    for a in addrs[:4]:
        book.mark_good(a)
    book.mark_attempt(addrs[5])
    book.save()
    got = reader.AddrBook(path, strict=False)
    assert got.size() == book.size() == 12
    for t in triples:
        a = reader.NetAddress(*t)
        assert got.has_address(a)
        assert got.is_good(a) == book.is_good(writer.NetAddress(*t))
    fields = ("attempts", "last_attempt", "last_success", "bucket_type")
    mine = {str(k.addr): (str(k.src),) + tuple(getattr(k, f) for f in fields)
            for k in book.list_known()}
    theirs = {str(k.addr): (str(k.src),) + tuple(getattr(k, f) for f in fields)
              for k in got.list_known()}
    assert mine == theirs
    got.save()
    with open(path) as f:
        assert {e["addr"] for e in json.load(f)["addrs"]} == set(mine)
    for t in triples:
        assert addrbook.AddrBook._bucket_of(NetAddress(*t)) == r_addrbook.AddrBook._bucket_of(
            R.NetAddress(*t))


def _pex_switch(pkg, idx, book, period):
    return _local_dials_only(pkg.tu.make_switch(idx, init_switch=lambda i, sw: sw.add_reactor(
        "pex", pkg.PEXReactor(book, ensure_period=period)) and sw, network="crossnet"))


@pytest.mark.parametrize("dialer", ["port", "reference"])
def test_a_port_pex_reactor_against_a_reference_one(dialer):
    """A port switch with its PEX reactor and a reference switch with the
    reference's exchange their books over TCP, whichever end dials."""
    books = {"port": addrbook.AddrBook(None, strict=False),
             "reference": r_addrbook.AddrBook(None, strict=False)}
    for b in books.values():
        b.mark_attempt = lambda a: None  # the extras are unreachable: keep them
    extras = {"port": [_addr(PORT, i) for i in range(60, 64)],
              "reference": [_addr(REF, i) for i in range(70, 74)]}
    for name, b in books.items():
        for a in extras[name]:
            b.add_address(a, a)
    sw = {"port": _pex_switch(PORT, 0, books["port"], 0.3),
          "reference": _pex_switch(REF, 1, books["reference"], 0.3)}
    for s in sw.values():
        s.start()
    try:
        other = "reference" if dialer == "port" else "port"
        laddr = sw[other].transport.listen("127.0.0.1:0")
        pkg = PORT if dialer == "port" else REF
        sw[dialer].dial_peer_with_address(pkg.NetAddress(laddr.id, laddr.host, laddr.port))
        assert _wait_until(lambda: sw["port"].peers.size() == sw["reference"].peers.size() == 1,
                           DEADLINE)
        # each learns the other's extras by PEX
        assert _wait_until(lambda: all(books["port"].has_address(NetAddress(a.id, a.host, a.port))
                                       for a in extras["reference"]), DEADLINE)
        assert _wait_until(lambda: all(books["reference"].has_address(
            R.NetAddress(a.id, a.host, a.port)) for a in extras["port"]), DEADLINE)
        # the dialer marked the acceptor good; neither stopped the other
        dialed = books[dialer]
        assert dialed.is_good((PORT if dialer == "port" else REF).NetAddress(
            laddr.id, laddr.host, laddr.port))
        assert sw["port"].peers.size() == sw["reference"].peers.size() == 1
    finally:
        for s in sw.values():
            s.stop()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def test_trust_scores_equal_the_reference_under_one_clock(monkeypatch, tmp_path):
    clock = _Clock()
    for mod in (trust, r_trust):
        monkeypatch.setattr(mod, "time", clock)
    rng = np.random.default_rng(5)
    metrics = [trust.TrustMetric(), r_trust.TrustMetric()]
    stores = [trust.TrustMetricStore(str(tmp_path / "p.json")),
              r_trust.TrustMetricStore(str(tmp_path / "r.json"))]
    scores = [[], []]
    for _ in range(400):
        ev, w, dt = int(rng.integers(0, 3)), float(rng.random() * 3), float(rng.random() * 9)
        clock.t += dt
        peer = f"peer-{int(rng.integers(0, 4))}"
        for k in (0, 1):
            for m in (metrics[k], stores[k].get_metric(peer)):
                if ev == 0:
                    m.good_event(w)
                elif ev == 1:
                    m.bad_event(w)
            scores[k].append((metrics[k].trust_value(), metrics[k].trust_score(),
                              stores[k].peer_score(peer)))
    assert scores[0] == scores[1]
    assert len({s[1] for s in scores[0]}) > 5  # the events moved the score
    for k in (0, 1):
        stores[k].save()
    for path in ("p.json", "r.json"):
        got = [trust.TrustMetricStore(str(tmp_path / path)),
               r_trust.TrustMetricStore(str(tmp_path / path))]
        for peer in ("peer-0", "peer-1", "peer-2", "peer-3", "peer-x"):
            assert got[0].peer_score(peer) == got[1].peer_score(peer)


class _Sink:
    def __init__(self):
        self.written, self.closed = [], 0

    def write(self, data):
        self.written.append(bytes(data))
        return len(data)

    def read_exactly(self, n):
        return b"\x00" * n

    def read(self, n):
        return b"\x00" * n

    def close(self):
        self.closed += 1


@pytest.mark.parametrize("cfg", [
    dict(mode="drop", prob_drop_rw=0.3),
    dict(mode="drop", prob_drop_rw=0.1, prob_drop_conn=0.05, prob_sleep=0.3, max_delay=2.0),
    dict(mode="delay", max_delay=0.7),
    dict(mode="drop", prob_drop_rw=0.5, start_after=5.0),
], ids=["drop", "drop_conn_sleep", "delay", "start_after"])
def test_fuzz_decisions_equal_the_reference_from_one_seed(monkeypatch, cfg):
    runs = []
    for mod in (fuzz, r_fuzz):
        clock, sleeps = _Clock(), []

        class _Time:
            monotonic = clock.monotonic

            @staticmethod
            def sleep(s):
                sleeps.append(s)

        monkeypatch.setattr(mod, "time", _Time)
        sink = _Sink()
        fz = mod.FuzzedConnection(sink, mod.FuzzConfig(**cfg), rng=random.Random(42))
        for i in range(200):
            clock.t += 0.05
            fz.write(b"m%d" % i)
            if i % 3 == 0:
                fz.read_exactly(4)
        runs.append((sink.written, sink.closed, sleeps))
    assert runs[0] == runs[1]
    assert runs[0][0] or runs[0][2]


class _NoGatewaySocket:
    """A UDP socket on a net with no UPnP gateway: the M-SEARCH goes out,
    no answer comes before the timeout."""

    def __init__(self, *a, **kw):
        pass

    def settimeout(self, t):
        pass

    def sendto(self, data, addr):
        return len(data)

    def recvfrom(self, n):
        raise socket.timeout("timed out")

    def close(self):
        pass


def test_upnp_probe_without_a_gateway_equals_the_reference(monkeypatch):
    monkeypatch.setattr(socket, "socket", _NoGatewaySocket)
    assert upnp.discover(0.01) is None and r_upnp.discover(0.01) is None
    got, want = upnp.probe(0.01), r_upnp.probe(0.01)
    assert got.__dict__ == want.__dict__
    assert not got.found_gateway and "no UPnP gateway" in got.error


# ---------------------------------------------------------------------------
# a port node that knows only a seed joins a port net
# ---------------------------------------------------------------------------

# the sweep period, as chip_smoke.py's localnet phase sweeps: a receiver
# drops a peer whose address requests come within a third of its period,
# and a sender's sweeps come a period apart, so a receive thread that
# stalls past two thirds of it reads two requests as a flood. At 0.3 s
# (0.2 s of room) that happened under six busy workers; at 1 s it takes a
# stall of 0.67 s
PEX_PERIOD = 1.0


@pytest.fixture
def _host_verify():
    yield
    verify_root.reset_verify()


def _net_config():
    cfg = pconfig.test_config()
    cfg.base.proxy_app, cfg.base.db_backend = "kvstore", "memdb"
    cfg.instrumentation.watchdog = False
    return cfg


def test_a_port_node_joins_a_port_net_knowing_only_a_seed(tmp_path, _host_verify):
    cfg = _net_config()
    nodes, joiner = [], None
    try:
        nodes = node_net.make_node_net(3, str(tmp_path), cfg, device="cpu", start=False,
                                       pex_period=PEX_PERIOD)
        node_net.install_host_verify()
        node_net.start_node_net(nodes)
        assert all(n.pex_reactor is not None and n.switch.reactors["pex"] is n.pex_reactor
                   and 0x00 in n.switch.transport.node_info.channels for n in nodes)
        assert node_net.wait_for(lambda: all(n.block_store.height() >= 2 for n in nodes),
                                 DEADLINE), [n.block_store.height() for n in nodes]
        joiner = node_net.add_joining_node(nodes, str(tmp_path), cfg, device="cpu",
                                           pex_period=PEX_PERIOD, seed_only=True)
        assert joiner.config.p2p.persistent_peers == ""
        seed = nodes[0].switch.transport.listen_address
        assert [str(s) for s in joiner.pex_reactor.seeds] == [str(seed)]
        ids = {n.switch.node_id for n in nodes}
        snap = {}

        def every_validator_a_peer_in_the_book():
            # one snapshot of the peers and the book (a peer is in the set
            # before its reactors' add_peer has run)
            snap["peers"] = {p.id: p for p in joiner.switch.peers.list()}
            snap["book"] = {k.addr.id: k for k in joiner.addr_book.list_known()}
            return ids <= set(snap["peers"]) and ids <= set(snap["book"])

        assert node_net.wait_for(every_validator_a_peer_in_the_book, DEADLINE), (
            list(snap["peers"]), list(snap["book"]))
        # the seed came from the config; each other validator either came
        # by PEX from a peer and was dialed, or learned of the joiner by PEX
        # and dialed in (then the book holds the address it announced)
        book, peers = snap["book"], snap["peers"]
        assert str(book[seed.id].src) == str(seed)
        for i in ids - {seed.id}:
            assert book[i].src.id != i or not peers[i].outbound, (book[i], peers[i])
        top = min(n.block_store.height() for n in nodes) + 2
        # the joiner can store a block before nodes[0] does (it needs only
        # the precommits, and nodes[0]'s commit may still be on its way)
        assert node_net.wait_for(lambda: joiner.block_store.height() >= top
                                 and nodes[0].block_store.height() >= top, DEADLINE), (
            joiner.block_store.height(), nodes[0].block_store.height(), top)
        for h in range(1, top + 1):
            assert joiner.block_store.load_block(h).hash() == nodes[0].block_store.load_block(
                h).hash()
    finally:
        node_net.stop_node_net(nodes + ([joiner] if joiner is not None else []))
