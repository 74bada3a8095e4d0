"""The port's p2p layer (``tendermint_tpu_torch/p2p/``, ``crypto/sts_fallback.py``,
the codec's ``length_prefix``, ``libs/metrics.NodeMetrics``, ``config/p2p.py``)
against the reference package's, then the reference's ``tests/test_p2p.py``
cases restated on the port.

Across the packages: ``NetAddress`` parsing; ``NodeInfo``'s wire bytes,
``validate`` and ``compatible_with``; ``MConnection``'s packet bytes (message,
ping, pong), with a port ``MConnection`` talking to a reference one over a
socketpair; ``SecretConnection`` between the packages on either STS backend,
with the port's ephemeral key the lower and the higher of the two (which
decides each end's send and receive keys); ``sts_fallback`` against
``cryptography`` on seeded inputs and on the RFC 7748 / 8439 / 5869 vectors;
a port switch and a reference switch exchanging messages through echo
reactors, over a socketpair and over TCP; ``NodeMetrics``' families; the
``[p2p]`` section's fields. Every socket is a socketpair or binds port 0;
every wait has a deadline.
"""

import socket
import struct
import threading
import time
from binascii import unhexlify as h

import numpy as np
import pytest
from cryptography.hazmat.primitives import hashes as c_hashes
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey as CX25519PrivateKey,
    X25519PublicKey as CX25519PublicKey,
)
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305 as CChaCha20Poly1305
from cryptography.hazmat.primitives.kdf.hkdf import HKDF as CHKDF

import tendermint_tpu.p2p as R
import tendermint_tpu_torch.p2p as P
from tendermint_tpu.config.config import P2PConfig as RP2PConfig
from tendermint_tpu.crypto import sts_fallback as r_sts
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as RKey
from tendermint_tpu.encoding import codec as r_codec
from tendermint_tpu.libs.metrics import NodeMetrics as RNodeMetrics
from tendermint_tpu.p2p import test_util as r_tu
from tendermint_tpu.p2p.conn import connection as r_mc
from tendermint_tpu.p2p.conn import secret_connection as r_sc
from tendermint_tpu_torch.config.p2p import P2PConfig
from tendermint_tpu_torch.crypto import sts_fallback as p_sts
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.encoding import codec as p_codec
from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.p2p import (
    ChannelDescriptor,
    MConnConfig,
    MConnection,
    NetAddress,
    NodeInfo,
    NodeKey,
    ProtocolVersion,
    Reactor,
)
from tendermint_tpu_torch.p2p.conn import connection as p_mc
from tendermint_tpu_torch.p2p.conn import secret_connection as p_sc
from tendermint_tpu_torch.p2p.conn.secret_connection import RawConn, SecretConnection
from tendermint_tpu_torch.p2p.errors import RejectedError
from tendermint_tpu_torch.p2p.test_util import (
    connect_switches,
    connect_switches_plain,
    make_connected_switches,
    make_switch,
    stop_switches,
)

DEADLINE = 10.0


def _wait_until(pred, timeout=5.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _rand(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


# ---------------------------------------------------------------------------
# sts_fallback against cryptography, and the RFC vectors
# ---------------------------------------------------------------------------


class TestFallbackAgainstCryptography:
    @pytest.mark.parametrize("seed", range(6))
    def test_x25519_on_seeded_keys(self, seed):
        rng = np.random.default_rng(seed)
        a, b = _rand(rng, 32), _rand(rng, 32)
        pa = p_sts.X25519PrivateKey(a)
        ca, cb = CX25519PrivateKey.from_private_bytes(a), CX25519PrivateKey.from_private_bytes(b)
        assert pa.public_key().public_bytes_raw() == ca.public_key().public_bytes_raw()
        pub_b = cb.public_key().public_bytes_raw()
        assert (pa.exchange(p_sts.X25519PublicKey.from_public_bytes(pub_b))
                == ca.exchange(CX25519PublicKey.from_public_bytes(pub_b)))

    @pytest.mark.parametrize("n", [0, 1, 15, 16, 63, 64, 65, 1028, 1044, 4100])
    def test_chacha20_poly1305_on_seeded_inputs(self, n):
        rng = np.random.default_rng(1000 + n)
        key, nonce, data = _rand(rng, 32), _rand(rng, 12), _rand(rng, n)
        aad = _rand(rng, n % 29) if n % 2 else None
        sealed = CChaCha20Poly1305(key).encrypt(nonce, data, aad)
        assert p_sts.ChaCha20Poly1305(key).encrypt(nonce, data, aad) == sealed
        assert r_sts.ChaCha20Poly1305(key).encrypt(nonce, data, aad) == sealed
        assert p_sts.ChaCha20Poly1305(key).decrypt(nonce, sealed, aad) == data

    @pytest.mark.parametrize("counter", [0, 1, 7, 0xFFFFFFF0])
    def test_keystream_blocks_equal_the_reference_blocks(self, counter):
        """A frame's 18 keystream blocks equal the reference's, across the
        32-bit counter's wrap."""
        rng = np.random.default_rng(counter & 0xFFFF)
        key, nonce = _rand(rng, 32), _rand(rng, 12)
        for i in range(18):
            c = (counter + i) & 0xFFFFFFFF
            assert p_sts.chacha20_block(key, c, nonce) == r_sts.chacha20_block(key, c, nonce)
        data = bytes(18 * 64)
        assert (p_sts.chacha20_xor(key, counter, nonce, data)
                == r_sts.chacha20_xor(key, counter, nonce, data))

    @pytest.mark.parametrize("seed", range(4))
    def test_hkdf_on_seeded_inputs(self, seed):
        rng = np.random.default_rng(50 + seed)
        ikm, info = _rand(rng, 32), _rand(rng, seed * 7)
        salt = _rand(rng, 16) if seed % 2 else None
        want = CHKDF(algorithm=c_hashes.SHA256(), length=96, salt=salt, info=info).derive(ikm)
        got = p_sts.HKDF(algorithm=p_sts.hashes.SHA256(), length=96, salt=salt,
                         info=info).derive(ikm)
        assert got == want

    def test_rfc7748_vectors(self):
        assert p_sts.x25519_scalarmult(
            h("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4"),
            h("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c"),
        ) == h("c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552")
        apriv = h("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
        bpriv = h("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
        a, b = p_sts.X25519PrivateKey(apriv), p_sts.X25519PrivateKey(bpriv)
        assert a.public_key().public_bytes_raw() == h(
            "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
        shared = h("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
        assert a.exchange(b.public_key()) == b.exchange(a.public_key()) == shared
        with pytest.raises(ValueError):
            a.exchange(p_sts.X25519PublicKey.from_public_bytes(b"\x00" * 32))

    def test_rfc8439_vectors(self):
        assert p_sts.chacha20_block(bytes(range(32)), 1, h("000000090000004a00000000")) == h(
            "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
            "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
        assert p_sts.poly1305_mac(
            h("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b"),
            b"Cryptographic Forum Research Group") == h("a8061dc1305136c6c22b8baf0c0127a9")
        key = h("808182838485868788898a8b8c8d8e8f909192939495969798999a9b9c9d9e9f")
        nonce, aad = h("070000004041424344454647"), h("50515253c0c1c2c3c4c5c6c7")
        pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
              b"only one tip for the future, sunscreen would be it.")
        sealed = h(
            "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
            "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
            "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
            "3ff4def08e4b7a9de576d26586cec64b6116"
            "1ae10b594f09e26a7e902ecbd0600691")
        aead = p_sts.ChaCha20Poly1305(key)
        assert aead.encrypt(nonce, pt, aad) == sealed
        assert aead.decrypt(nonce, sealed, aad) == pt
        bad = bytearray(sealed)
        bad[3] ^= 1
        with pytest.raises(p_sts.InvalidTag):
            aead.decrypt(nonce, bytes(bad), aad)

    def test_rfc5869_vector(self):
        okm = p_sts.HKDF(algorithm=p_sts.hashes.SHA256(), length=42,
                         salt=h("000102030405060708090a0b0c"),
                         info=h("f0f1f2f3f4f5f6f7f8f9")).derive(h("0b" * 22))
        assert okm == h("3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf"
                        "34007208d5b887185865")


# ---------------------------------------------------------------------------
# The codec's length prefix, the [p2p] section, NodeMetrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 20_000])
def test_length_prefix_equals_the_reference(n):
    payload = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    assert p_codec.length_prefix(payload) == r_codec.length_prefix(payload)


def test_p2p_config_fields_and_defaults_equal_the_reference():
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(P2PConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(RP2PConfig)}
    assert ours == theirs
    assert P2PConfig().addr_book_path("/r") == RP2PConfig().addr_book_path("/r")


@pytest.mark.parametrize("field,value", [("pex", True), ("seeds", "ab" * 20 + "@1.2.3.4:1"),
                                         ("seed_mode", True), ("private_peer_ids", "x"),
                                         ("upnp", True), ("test_fuzz", True)])
def test_p2p_config_refuses_unported_modules(field, value):
    """Every field is ported: the node's switch builds with each one set,
    and the peer exchange comes with pex on (the reference reads
    private_peer_ids, upnp and test_fuzz and wires them to nothing)."""
    from tendermint_tpu_torch.node import verify_root

    cfg = P2PConfig(pex=False)
    setattr(cfg, field, value)
    sw = verify_root.switch(cfg, NodeKey(PrivKeyEd25519.generate()), "c")
    book, pex = verify_root.pex_reactor(cfg)
    assert sw.transport.node_info.network == "c"
    assert (pex is not None) == (field == "pex")
    if pex is not None:
        assert pex.book is book and book._strict and pex.seeds == []
    seeded = P2PConfig(seeds=value if field == "seeds" else "", seed_mode=field == "seed_mode")
    _, pex = verify_root.pex_reactor(seeded)
    assert [str(s) for s in pex.seeds] == ([value] if field == "seeds" else [])
    assert pex.seed_mode == (field == "seed_mode")


def _families(registry):
    return [(m.name, tuple(m.label_names), type(m).__name__, m.help,
             tuple(getattr(m, "buckets", ()) or ())) for m in registry._metrics]


def test_node_metrics_families_equal_the_reference():
    ours, theirs = NodeMetrics(), RNodeMetrics()
    assert _families(ours.registry) == _families(theirs.registry)
    for m in (ours, theirs):
        m.record_peer_traffic("aa" * 20, 0x22, sent=17, received=5)
        m.record_vote_sighting("aa" * 20, 0x22, first=True)
        m.record_vote_sighting("aa" * 20, 0x22, first=False)
        m.set_peer_pending("aa" * 20, 3)
        m.messages_sent.add(1, ("0x22",))
    assert ours.registry.expose_text() == theirs.registry.expose_text()
    ours.forget_peer("aa" * 20)
    theirs.forget_peer("aa" * 20)
    assert ours.registry.expose_text() == theirs.registry.expose_text()


# ---------------------------------------------------------------------------
# NetAddress and NodeInfo across the packages
# ---------------------------------------------------------------------------

ADDRESSES = ["aa" * 20 + "@1.2.3.4:26656", "0123456789abcdef0123456789abcdef01234567@[::1]:80",
             "ab" * 20 + "@:26656", "ab" * 20 + "@host.example:1", "1.2.3.4:26656",
             "zz" * 20 + "@1.2.3.4:1", "ab" * 20 + "@1.2.3.4", "ab" * 20 + "@1.2.3.4:0",
             "ab" * 20 + "@1.2.3.4:70000", "  " + "cd" * 20 + "@10.0.0.1:5  ", "ab" * 19 + "@h:1"]


def _parse(cls, s):
    try:
        a = cls.parse(s)
    except ValueError as e:
        return ("error", type(e).__name__)
    return (a.id, a.host, a.port, str(a), a.dial_string, a.routable(), a.local())


@pytest.mark.parametrize("s", ADDRESSES)
def test_net_address_parsing_equals_the_reference(s):
    assert _parse(NetAddress, s) == _parse(R.NetAddress, s)


@pytest.mark.parametrize("host", ["8.8.8.8", "127.0.0.1", "10.0.0.1", "192.168.1.1", "0.0.0.0",
                                  "169.254.0.1", "224.0.0.1", "example.org", "::1"])
def test_net_address_routability_equals_the_reference(host):
    assert (NetAddress("", host, 1).routable(), NetAddress("", host, 1).local()) == (
        R.NetAddress("", host, 1).routable(), R.NetAddress("", host, 1).local())


def _infos(pkg, **kw):
    fields = dict(id="ab" * 20, listen_addr="127.0.0.1:26656", network="net", version="0.1.0",
                  channels=b"\x20\x21\x22\x23", moniker="n", tx_index="on", rpc_address="tcp://x")
    fields.update(kw)
    pv = fields.pop("pv", (4, 8, 0))
    return pkg.NodeInfo(protocol_version=pkg.ProtocolVersion(*pv), **fields)


NODE_INFOS = [{}, {"channels": b""}, {"channels": b"\x20\x20"}, {"id": "nothex"},
              {"moniker": "bad\nname"}, {"tx_index": "maybe"}, {"channels": bytes(range(17))},
              {"network": "other"}, {"pv": (4, 9, 0)}, {"channels": b"\x99"},
              {"pv": (5, 8, 3), "moniker": "ünïcode", "rpc_address": ""}]


@pytest.mark.parametrize("kw", NODE_INFOS, ids=range(len(NODE_INFOS)))
def test_node_info_bytes_and_checks_equal_the_reference(kw):
    ours, theirs = _infos(P, **kw), _infos(R, **kw)
    assert ours.to_bytes() == theirs.to_bytes()
    assert NodeInfo.from_bytes(theirs.to_bytes()) == ours

    def outcome(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    assert outcome(ours.validate) == outcome(theirs.validate)
    base_p, base_r = _infos(P), _infos(R)
    assert outcome(lambda: base_p.compatible_with(ours)) == outcome(
        lambda: base_r.compatible_with(theirs))


# ---------------------------------------------------------------------------
# MConnection: the port against the reference, packet by packet
# ---------------------------------------------------------------------------


class _Sniff:
    """A conn that records every write, over a raw socket of either package."""

    def __init__(self, raw):
        self.raw, self.writes = raw, []

    def write(self, data):
        self.writes.append(bytes(data))
        self.raw.write(data)

    def read_exactly(self, n):
        return self.raw.read_exactly(n)

    def close(self):
        self.raw.close()


def _packets(stream: bytes):
    """(type, channel, eof, chunk) for each packet of a written stream."""
    out, i = [], 0
    while i < len(stream):
        t = stream[i]
        if t in (0x01, 0x02):
            out.append((t, None, None, b""))
            i += 1
            continue
        assert t == 0x03, stream[i:i + 8]
        ch, eof = stream[i + 1], stream[i + 2]
        (n,) = struct.unpack("<H", stream[i + 3:i + 5])
        out.append((t, ch, eof, stream[i + 5:i + 5 + n]))
        i += 5 + n
    return out


MSGS = [b"alpha", b"\x00" * 1024, bytes(range(256)) * 9, b"z"]


def _mconn_pair(port_cfg, ref_cfg, recv_port, recv_ref):
    s1, s2 = socket.socketpair()
    errs = []
    sp, sr = _Sniff(p_sc.RawConn(s1)), _Sniff(r_sc.RawConn(s2))
    mp = p_mc.MConnection(sp, [ChannelDescriptor(id=0x21, priority=5, send_queue_capacity=32)],
                          recv_port, errs.append, port_cfg, name="port")
    mr = r_mc.MConnection(sr, [r_mc.ChannelDescriptor(id=0x21, priority=5,
                                                      send_queue_capacity=32)],
                          recv_ref, errs.append, ref_cfg, name="ref")
    mp.start(), mr.start()
    return mp, mr, sp, sr, errs


def test_mconnection_talks_to_the_reference_both_ways():
    got_p, got_r = [], []
    cfg = MConnConfig(send_rate=5_120_000, recv_rate=5_120_000, flush_throttle=0.01)
    rcfg = r_mc.MConnConfig(send_rate=5_120_000, recv_rate=5_120_000, flush_throttle=0.01)
    mp, mr, sp, sr, errs = _mconn_pair(cfg, rcfg, lambda c, m: got_p.append((c, m)),
                                       lambda c, m: got_r.append((c, m)))
    try:
        for m in MSGS:
            assert mp.send(0x21, m) and mr.send(0x21, m[::-1])
        assert _wait_until(lambda: len(got_p) == len(got_r) == len(MSGS), DEADLINE)
        assert got_r == [(0x21, m) for m in MSGS]
        assert got_p == [(0x21, m[::-1]) for m in MSGS]
        assert not errs
    finally:
        mp.stop(), mr.stop()
    # each end's packets are the reference's layout: every message split
    # into chunks of at most 1,024 bytes, EOF on the last
    def want(msgs):
        out = []
        for m in msgs:
            chunks = [m[i:i + 1024] for i in range(0, len(m), 1024)] or [b""]
            out += [(0x03, 0x21, int(k == len(chunks) - 1), c) for k, c in enumerate(chunks)]
        return out

    assert [p for p in _packets(b"".join(sp.writes)) if p[0] == 0x03] == want(MSGS)
    assert [p for p in _packets(b"".join(sr.writes)) if p[0] == 0x03] == want(
        [m[::-1] for m in MSGS])


def test_mconnection_pings_are_answered_across_the_packages():
    """The port pings every 50 ms; the reference answers each with a pong,
    and the other way round; neither side times out."""
    fast = dict(send_rate=5_120_000, recv_rate=5_120_000, flush_throttle=0.01,
                ping_interval=0.05, pong_timeout=5.0)
    mp, mr, sp, sr, errs = _mconn_pair(MConnConfig(**fast), r_mc.MConnConfig(**fast),
                                       lambda c, m: None, lambda c, m: None)
    try:
        assert _wait_until(lambda: sum(1 for p in _packets(b"".join(sr.writes))
                                       if p[0] == 0x02) >= 3, DEADLINE)
        assert _wait_until(lambda: sum(1 for p in _packets(b"".join(sp.writes))
                                       if p[0] == 0x02) >= 3, DEADLINE)
        assert mp.is_running and mr.is_running and not errs
    finally:
        mp.stop(), mr.stop()
    kinds_p = {p[0] for p in _packets(b"".join(sp.writes))}
    assert {0x01, 0x02} <= kinds_p and kinds_p <= {0x01, 0x02, 0x03}


def test_mconnection_rejects_what_the_reference_rejects():
    """An oversized packet and an unknown channel end the connection."""
    for bad in (b"\x03\x21\x01" + struct.pack("<H", 1025), b"\x03\x77\x01\x01\x00x", b"\x09"):
        s1, s2 = socket.socketpair()
        errs = []
        m = MConnection(RawConn(s1), [ChannelDescriptor(id=0x21)], lambda c, x: None,
                        errs.append, MConnConfig.test_config())
        m.start()
        try:
            s2.sendall(bad)
            assert _wait_until(lambda: len(errs) == 1, DEADLINE), bad
            assert not m.is_running
        finally:
            s2.close()


# ---------------------------------------------------------------------------
# SecretConnection between the packages, on either backend
# ---------------------------------------------------------------------------

BACKENDS = {
    "fallback": lambda sts: dict(X25519PrivateKey=sts.X25519PrivateKey,
                                 X25519PublicKey=sts.X25519PublicKey,
                                 ChaCha20Poly1305=sts.ChaCha20Poly1305, HKDF=sts.HKDF,
                                 hashes=sts.hashes),
    "cryptography": lambda sts: dict(X25519PrivateKey=CX25519PrivateKey,
                                     X25519PublicKey=CX25519PublicKey,
                                     ChaCha20Poly1305=CChaCha20Poly1305, HKDF=CHKDF,
                                     hashes=c_hashes),
}


class _SeededEphemeral:
    """``X25519PrivateKey`` of a backend whose ``generate`` returns a fixed
    key, so that a test chooses which end's ephemeral key sorts lower."""

    def __init__(self, cls, seed: bytes):
        self.cls, self.seed = cls, seed

    def generate(self):
        return self.cls.from_private_bytes(self.seed)


def _ordered_seeds():
    """Two ephemeral seeds, the first's public key the lower."""
    a, b = b"\x11" * 32, b"\x22" * 32
    pa = p_sts.x25519_scalarmult(a, (9).to_bytes(32, "little"))
    pb = p_sts.x25519_scalarmult(b, (9).to_bytes(32, "little"))
    return (a, b) if pa < pb else (b, a)


def _use(monkeypatch, module, sts, backend, seed):
    for name, value in BACKENDS[backend](sts).items():
        monkeypatch.setattr(module, name, value)
    monkeypatch.setattr(module, "X25519PrivateKey",
                        _SeededEphemeral(BACKENDS[backend](sts)["X25519PrivateKey"], seed))


def _interop_pair(monkeypatch, port_backend, ref_backend, port_least):
    lo, hi = _ordered_seeds()
    _use(monkeypatch, p_sc, p_sts, port_backend, lo if port_least else hi)
    _use(monkeypatch, r_sc, r_sts, ref_backend, hi if port_least else lo)
    s1, s2 = socket.socketpair()
    kp, kr = PrivKeyEd25519.generate(b"\x05" * 32), RKey.generate(b"\x06" * 32)
    out, err = [None, None], [None, None]

    def go(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # asserted below
            err[i] = e

    ts = [threading.Thread(target=go, args=(0, lambda: p_sc.SecretConnection(
              p_sc.RawConn(s1), kp))),
          threading.Thread(target=go, args=(1, lambda: r_sc.SecretConnection(
              r_sc.RawConn(s2), kr)))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(DEADLINE)
    assert err == [None, None], err
    return out[0], out[1], kp, kr


INTEROP = [(pb, rb, least) for pb, rb in (("fallback", "cryptography"), ("cryptography", "fallback"))
           for least in (True, False)]


@pytest.mark.parametrize("port_backend,ref_backend,port_least", INTEROP,
                         ids=[f"port-{a}-ref-{b}-{'least' if c else 'greatest'}"
                              for a, b, c in INTEROP])
class TestSecretConnectionInterop:
    def test_handshake_and_data_both_ways(self, monkeypatch, port_backend, ref_backend,
                                          port_least):
        cp, cr, kp, kr = _interop_pair(monkeypatch, port_backend, ref_backend, port_least)
        try:
            assert cp.remote_pubkey.bytes() == kr.pub_key().bytes()
            assert cr.remote_pubkey.bytes() == kp.pub_key().bytes()
            blob = bytes(range(256)) * 12  # 3,072 bytes: three frames
            cp.write(blob)
            assert cr.read_exactly(len(blob)) == blob
            cr.write(blob[::-1] + b"!")
            assert cp.read_exactly(len(blob) + 1) == blob[::-1] + b"!"
            cp.write(b"x")
            assert cr.read_exactly(1) == b"x"
        finally:
            cp.close(), cr.close()

    @pytest.mark.parametrize("victim", ["port", "reference"])
    def test_tampered_frame_rejected(self, monkeypatch, port_backend, ref_backend, port_least,
                                     victim):
        cp, cr, _, _ = _interop_pair(monkeypatch, port_backend, ref_backend, port_least)
        sender, receiver = (cr, cp) if victim == "port" else (cp, cr)
        try:
            frame = struct.pack("<I", 5) + b"hello" + b"\x00" * (1028 - 9)
            sealed = bytearray(sender._send_aead.encrypt(sender._send_nonce.next(), frame, None))
            sealed[7] ^= 0x01
            sender._conn.write(bytes(sealed))
            with pytest.raises(ConnectionError):
                receiver.read_exactly(1)
        finally:
            cp.close(), cr.close()


# ---------------------------------------------------------------------------
# A port switch and a reference switch
# ---------------------------------------------------------------------------


def _echo_reactor_cls(base):
    class Echo(base):
        def __init__(self, chan_id=0x10, echo=True):
            super().__init__(name=f"Echo-{chan_id:#x}")
            self.chan_id, self.echo = chan_id, echo
            self.received, self.peers_added, self.peers_removed = [], [], []

        def get_channels(self):
            mod = P if base is Reactor else R
            return [mod.ChannelDescriptor(id=self.chan_id, priority=5, send_queue_capacity=32)]

        def add_peer(self, peer):
            self.peers_added.append(peer.id)

        def remove_peer(self, peer, reason):
            self.peers_removed.append(peer.id)

        def receive(self, chan_id, peer, msg_bytes):
            self.received.append((peer.id, msg_bytes))
            if self.echo and not msg_bytes.startswith(b"echo:"):
                peer.send(chan_id, b"echo:" + msg_bytes)

    return Echo


EchoReactor = _echo_reactor_cls(Reactor)
REchoReactor = _echo_reactor_cls(R.Reactor)


def _connect_across(sw_port, sw_ref):
    """``connect_switches`` for a port switch and a reference switch: each
    end upgrades with its own package, then admits the peer."""
    s1, s2 = socket.socketpair()
    res, errs = [None, None], [None, None]

    def upgrade(i, sw, sock, sc):
        try:
            conn = sc.SecretConnection(sc.RawConn(sock), sw.transport.node_key.priv_key)
            ni = sw.transport._exchange_node_info(conn)
            ni.validate()
            res[i] = (conn, ni)
        except Exception as e:
            errs[i] = e

    ts = [threading.Thread(target=upgrade, args=(0, sw_port, s1, p_sc)),
          threading.Thread(target=upgrade, args=(1, sw_ref, s2, r_sc))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(DEADLINE)
    assert errs == [None, None], errs
    for i, (sw, pkg, outbound) in enumerate(((sw_port, P, True), (sw_ref, R, False))):
        conn, ni = res[i]
        sw._add_peer(pkg.UpgradedConn(conn=conn, node_info=ni,
                                      socket_addr=pkg.NetAddress(ni.id, "127.0.0.1", 1 + i),
                                      outbound=outbound))


def _switch_pair():
    rp, rr = {}, {}
    sw_p = make_switch(0, init_switch=lambda i, s: rp.setdefault("r", s.add_reactor(
        "echo", EchoReactor())) and s)
    sw_r = r_tu.make_switch(1, init_switch=lambda i, s: rr.setdefault("r", s.add_reactor(
        "echo", REchoReactor())) and s)
    sw_p.start(), sw_r.start()
    return sw_p, sw_r, rp["r"], rr["r"]


def test_port_and_reference_switches_exchange_messages():
    sw_p, sw_r, rp, rr = _switch_pair()
    try:
        _connect_across(sw_p, sw_r)
        assert sw_p.peers.size() == sw_r.peers.size() == 1
        assert sw_p.peers.list()[0].send(0x10, b"marco")
        assert _wait_until(lambda: rp.received, DEADLINE)
        assert rp.received[0] == (sw_r.node_id, b"echo:marco")
        assert sw_r.peers.list()[0].send(0x10, b"polo")
        assert _wait_until(lambda: rr.received[1:], DEADLINE)
        assert rr.received == [(sw_p.node_id, b"marco"), (sw_p.node_id, b"echo:polo")]
        sw_r.broadcast(0x10, b"all")
        assert _wait_until(lambda: (sw_r.node_id, b"all") in rp.received, DEADLINE)
    finally:
        sw_p.stop(), sw_r.stop()


@pytest.mark.parametrize("dialer", ["port", "reference"])
def test_port_and_reference_switches_over_tcp(dialer):
    sw_p, sw_r, rp, rr = _switch_pair()
    try:
        if dialer == "port":
            laddr = sw_r.transport.listen("127.0.0.1:0")
            peer = sw_p.dial_peer_with_address(NetAddress(laddr.id, laddr.host, laddr.port))
        else:
            laddr = sw_p.transport.listen("127.0.0.1:0")
            peer = sw_r.dial_peer_with_address(R.NetAddress(laddr.id, laddr.host, laddr.port))
        assert _wait_until(lambda: sw_p.peers.size() == sw_r.peers.size() == 1, DEADLINE)
        assert peer.send(0x10, b"over-tcp")
        mine = rp if dialer == "port" else rr
        assert _wait_until(lambda: mine.received, DEADLINE)
        assert mine.received[0][1] == b"echo:over-tcp"
    finally:
        sw_p.stop(), sw_r.stop()


# ---------------------------------------------------------------------------
# The reference's tests/test_p2p.py, restated on the port
# ---------------------------------------------------------------------------


class TestNetAddress:
    def test_parse_roundtrip(self):
        s = "aa" * 20 + "@1.2.3.4:26656"
        addr = NetAddress.parse(s)
        assert (addr.id, addr.host, addr.port, str(addr)) == ("aa" * 20, "1.2.3.4", 26656, s)

    def test_parse_requires_id(self):
        with pytest.raises(ValueError):
            NetAddress.parse("1.2.3.4:26656")

    def test_bad_id(self):
        with pytest.raises(ValueError):
            NetAddress.parse("zz" * 20 + "@1.2.3.4:26656")

    def test_routable(self):
        mk = lambda host: NetAddress("", host, 26656)  # noqa: E731
        assert mk("8.8.8.8").routable()
        assert not mk("127.0.0.1").routable()
        assert not mk("10.0.0.1").routable()
        assert not mk("192.168.1.1").routable()


def _node_info(node_key=None, network="net", channels=b"\x20\x21", block=8):
    nk = node_key or NodeKey(PrivKeyEd25519.generate())
    return NodeInfo(protocol_version=ProtocolVersion(block=block), id=nk.id(),
                    listen_addr="127.0.0.1:26656", network=network, version="0.1.0",
                    channels=channels, moniker="n")


class TestNodeInfo:
    def test_validate_ok(self):
        _node_info().validate()

    def test_validate_rejects_dup_channels(self):
        with pytest.raises(ValueError):
            _node_info(channels=b"\x20\x20").validate()

    def test_validate_rejects_bad_id(self):
        ni = _node_info()
        object.__setattr__(ni, "id", "nothex")
        with pytest.raises(ValueError):
            ni.validate()

    def test_compatible(self):
        a, b = _node_info(), _node_info()
        a.compatible_with(b)
        with pytest.raises(ValueError):
            a.compatible_with(_node_info(network="other"))
        with pytest.raises(ValueError):
            a.compatible_with(_node_info(block=9))
        with pytest.raises(ValueError):
            a.compatible_with(_node_info(channels=b"\x99"))

    def test_wire_roundtrip(self):
        ni = _node_info()
        assert NodeInfo.from_bytes(ni.to_bytes()) == ni

    def test_node_key_saves_and_loads(self, tmp_path):
        path = str(tmp_path / "config" / "node_key.json")
        nk = NodeKey.load_or_generate(path)
        assert NodeKey.load_or_generate(path).id() == nk.id()
        assert R.NodeKey.load(path).id() == nk.id()  # the reference reads the port's file


def _make_secret_pair():
    s1, s2 = socket.socketpair()
    k1, k2 = PrivKeyEd25519.generate(), PrivKeyEd25519.generate()
    out, err = [None, None], [None, None]

    def go(i, sock, key):
        try:
            out[i] = SecretConnection(RawConn(sock), key)
        except Exception as e:
            err[i] = e

    ts = [threading.Thread(target=go, args=(0, s1, k1)),
          threading.Thread(target=go, args=(1, s2, k2))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(DEADLINE)
    assert err == [None, None], err
    return out[0], out[1], k1, k2


class TestSecretConnection:
    def test_handshake_authenticates_identities(self):
        c1, c2, k1, k2 = _make_secret_pair()
        assert c1.remote_pubkey.bytes() == k2.pub_key().bytes()
        assert c2.remote_pubkey.bytes() == k1.pub_key().bytes()
        c1.close()

    def test_data_roundtrip_both_directions(self):
        c1, c2, _, _ = _make_secret_pair()
        c1.write(b"hello from 1")
        assert c2.read_exactly(12) == b"hello from 1"
        c2.write(b"hi")
        assert c1.read_exactly(2) == b"hi"
        c1.close()

    def test_large_message_spans_frames(self):
        c1, c2, _, _ = _make_secret_pair()
        blob = bytes(range(256)) * 40  # 10,240 B > a 1,024-byte frame
        c1.write(blob)
        assert c2.read_exactly(len(blob)) == blob
        c1.close()

    def test_ciphertext_on_the_wire(self):
        s1, s2 = socket.socketpair()
        k1, k2 = PrivKeyEd25519.generate(), PrivKeyEd25519.generate()
        captured = []

        class SniffRaw(RawConn):
            def write(self, data):
                captured.append(bytes(data))
                super().write(data)

        out = [None, None]

        def go(i, sock, key, cls):
            out[i] = SecretConnection(cls(sock), key)

        ts = [threading.Thread(target=go, args=(0, s1, k1, SniffRaw)),
              threading.Thread(target=go, args=(1, s2, k2, RawConn))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(DEADLINE)
        secret = b"attack at dawn (this must never appear in the clear)"
        out[0].write(secret)
        assert out[1].read_exactly(len(secret)) == secret
        assert all(secret not in frame for frame in captured)
        out[0].close()

    def test_tampered_frame_rejected(self):
        c1, c2, _, _ = _make_secret_pair()
        c1._conn.write(bytes(1044))
        with pytest.raises(ConnectionError):
            c2.read_exactly(1)
        c1.close()


def _mconn_pair_port(descs, on_recv1, on_recv2, cfg=None):
    cfg = cfg or MConnConfig.test_config()
    s1, s2 = socket.socketpair()
    errs = []
    m1 = MConnection(RawConn(s1), descs, on_recv1, errs.append, cfg, name="m1")
    m2 = MConnection(RawConn(s2), descs, on_recv2, errs.append, cfg, name="m2")
    m1.start(), m2.start()
    return m1, m2, errs


class TestMConnection:
    DESCS = [ChannelDescriptor(id=0x01, priority=1, send_queue_capacity=32),
             ChannelDescriptor(id=0x02, priority=10, send_queue_capacity=32)]

    def test_send_receive_multichannel(self):
        got = {0x01: [], 0x02: []}
        done = threading.Event()

        def recv(cid, msg):
            got[cid].append(msg)
            if len(got[0x01]) == 1 and len(got[0x02]) == 1:
                done.set()

        m1, m2, errs = _mconn_pair_port(self.DESCS, lambda c, m: None, recv)
        try:
            assert m1.send(0x01, b"alpha")
            assert m1.send(0x02, b"beta")
            assert done.wait(DEADLINE)
            assert got == {0x01: [b"alpha"], 0x02: [b"beta"]}
            assert not errs
        finally:
            m1.stop(), m2.stop()

    def test_large_message_packetized(self):
        blob = b"\xab" * 50_000  # ~49 packets
        got, done = [], threading.Event()

        def recv(cid, msg):
            got.append((cid, msg))
            done.set()

        m1, m2, errs = _mconn_pair_port(self.DESCS, lambda c, m: None, recv)
        try:
            assert m1.send(0x02, blob)
            assert done.wait(DEADLINE)
            assert got == [(0x02, blob)]
        finally:
            m1.stop(), m2.stop()

    def test_send_unknown_channel_fails(self):
        m1, m2, _ = _mconn_pair_port(self.DESCS, lambda c, m: None, lambda c, m: None)
        try:
            assert not m1.send(0x77, b"x")
            assert not m1.try_send(0x77, b"x")
            assert m1.can_send(0x01)
        finally:
            m1.stop(), m2.stop()

    def test_peer_disconnect_fires_on_error(self):
        errs1 = []
        s1, s2 = socket.socketpair()
        m1 = MConnection(RawConn(s1), self.DESCS, lambda c, m: None, errs1.append,
                         MConnConfig.test_config())
        m1.start()
        s2.close()
        m1.send(0x01, b"ping into the void")
        assert _wait_until(lambda: len(errs1) == 1)
        assert not m1.is_running

    def test_pong_timeout_errors_out(self):
        s1, s2 = socket.socketpair()
        errs = []
        cfg = MConnConfig.test_config()
        m1 = MConnection(RawConn(s1), self.DESCS, lambda c, m: None, errs.append, cfg)
        m1.start()
        try:
            assert _wait_until(lambda: errs and "pong" in str(errs[0]),
                               timeout=cfg.ping_interval + cfg.pong_timeout + 2)
        finally:
            s2.close()


class TestSwitch:
    def test_two_switches_exchange_messages(self):
        reactors = {}

        def init(i, sw):
            reactors[i] = sw.add_reactor("echo", EchoReactor())
            return sw

        sws = make_connected_switches(2, init)
        try:
            assert sws[0].peers.size() == sws[1].peers.size() == 1
            peer = sws[0].peers.list()[0]
            assert peer.send(0x10, b"marco")
            assert _wait_until(lambda: reactors[0].received)
            assert reactors[0].received[0][1] == b"echo:marco"
        finally:
            stop_switches(sws)

    def test_reactor_peer_lifecycle_hooks(self):
        reactors = {}

        def init(i, sw):
            reactors[i] = sw.add_reactor("echo", EchoReactor(echo=False))
            return sw

        sws = make_connected_switches(3, init)
        try:
            assert _wait_until(lambda: len(reactors[0].peers_added) == 2)
            victim = sws[0].peers.list()[0]
            sws[0].stop_peer_for_error(victim, "test")
            assert _wait_until(lambda: reactors[0].peers_removed == [victim.id])
            assert sws[0].peers.size() == 1
        finally:
            stop_switches(sws)

    def test_broadcast_reaches_all_peers(self):
        reactors = {}

        def init(i, sw):
            reactors[i] = sw.add_reactor("echo", EchoReactor(echo=False))
            return sw

        sws = make_connected_switches(4, init)
        try:
            sws[0].broadcast(0x10, b"to-everyone")
            for i in (1, 2, 3):
                assert _wait_until(lambda i=i: reactors[i].received), i
                assert reactors[i].received[0][1] == b"to-everyone"
            assert not reactors[0].received
        finally:
            stop_switches(sws)

    def test_peer_filter_rejects_by_node_id(self):
        from tendermint_tpu_torch.p2p.errors import SwitchPeerFilteredError

        def init(i, s):
            s.add_reactor("echo", EchoReactor())
            return s

        sw_a, sw_b = make_switch(0, init_switch=init), make_switch(1, init_switch=init)
        sw_a.peer_filters.append(lambda nid: "on the blocklist" if nid == sw_b.node_id else None)
        sw_a.start(), sw_b.start()
        try:
            with pytest.raises(SwitchPeerFilteredError):
                connect_switches(sw_a, sw_b)
            assert sw_a.peers.size() == 0
            sw_c = make_switch(2, init_switch=init)
            sw_c.start()
            try:
                connect_switches(sw_a, sw_c)
                assert sw_a.peers.has(sw_c.node_id)
            finally:
                sw_c.stop()
        finally:
            sw_a.stop(), sw_b.stop()

    def test_duplicate_channel_id_rejected(self):
        sw = make_switch(init_switch=lambda i, s: s.add_reactor("a", EchoReactor()) and s)
        with pytest.raises(ValueError):
            sw.add_reactor("b", EchoReactor())

    def test_reactors_init_a_peer_before_it_starts(self):
        """The switch calls every reactor's ``init_peer`` before it starts a
        peer (Go's InitPeer), so a message that arrives before ``add_peer``
        reaches a reactor that has set the peer up."""
        class Order(Reactor):
            def __init__(self, greet, slow_add):
                super().__init__(name="Order")
                self.greet, self.slow_add, self.events = greet, slow_add, []

            def get_channels(self):
                return [ChannelDescriptor(id=0x10, priority=5, send_queue_capacity=8)]

            def init_peer(self, peer):
                self.events.append("init")
                return peer

            def add_peer(self, peer):
                time.sleep(self.slow_add)
                self.events.append("add")
                if self.greet:
                    peer.send(0x10, b"hello")

            def receive(self, chan_id, peer, msg_bytes):
                self.events.append("recv")

        ra, rb = Order(greet=True, slow_add=0.0), Order(greet=False, slow_add=0.3)
        sw_a = make_switch(0, init_switch=lambda i, s: s.add_reactor("o", ra) and s)
        sw_b = make_switch(1, init_switch=lambda i, s: s.add_reactor("o", rb) and s)
        sw_a.start(), sw_b.start()
        try:
            connect_switches(sw_a, sw_b)  # a admits b and greets; then b admits a
            assert _wait_until(lambda: "recv" in rb.events, DEADLINE)
            assert _wait_until(lambda: "add" in rb.events, DEADLINE)
            # the greeting came in before b's add_peer, after its init_peer
            assert rb.events == ["init", "recv", "add"], rb.events
            assert ra.events[0] == "init" and "add" in ra.events
        finally:
            stop_switches([sw_a, sw_b])

    def test_peer_error_removes_peer(self):
        reactors = {}

        def init(i, sw):
            reactors[i] = sw.add_reactor("echo", EchoReactor(echo=False))
            return sw

        sws = make_connected_switches(2, init)
        try:
            sws[0].peers.list()[0].mconn._conn.close()
            assert _wait_until(lambda: sws[0].peers.size() == 0)
            assert _wait_until(lambda: sws[1].peers.size() == 0)
        finally:
            stop_switches(sws)

    def test_simultaneous_dials_settle_on_one_connection(self):
        """Both ends dial at once: where both connections get up, each end
        keeps the one dialed by the smaller node ID (``_conn_is_canonical``),
        so the pair settles on one connection, outbound at one end and
        inbound at the other."""
        def init(i, s):
            s.add_reactor("echo", EchoReactor())
            return s

        a, b = make_switch(0, init_switch=init), make_switch(1, init_switch=init)
        a.start(), b.start()
        try:
            la, lb = a.transport.listen("127.0.0.1:0"), b.transport.listen("127.0.0.1:0")
            a.dial_peers_async([lb], persistent=True)
            b.dial_peers_async([la], persistent=True)
            assert _wait_until(lambda: a.peers.size() == b.peers.size() == 1
                               and a.peers.list()[0].is_running
                               and b.peers.list()[0].is_running, DEADLINE)
            time.sleep(0.3)  # a losing duplicate, if any, is gone by now
            pa, pb = a.peers.list()[0], b.peers.list()[0]
            assert a.peers.size() == b.peers.size() == 1 and pa.outbound != pb.outbound
            assert pa.send(0x10, b"one") and _wait_until(
                lambda: (a.node_id, b"one") in b.reactors["echo"].received, DEADLINE)
        finally:
            stop_switches([a, b])


def _quiet_mconfig():
    """Test-speed flush but the default 60 s ping interval: pings are counted
    by the monitors but not by channel."""
    return MConnConfig(send_rate=5_120_000, recv_rate=5_120_000, flush_throttle=0.01)


class TestPeerTrafficMetrics:
    def _make_pair(self):
        reactors, metrics = {}, {}

        def init(i, sw):
            reactors[i] = sw.add_reactor("echo", EchoReactor())
            return sw

        sws = []
        for i in range(2):
            metrics[i] = NodeMetrics()
            sws.append(make_switch(i, init_switch=lambda idx, sw, i=i: init(i, sw),
                                   mconfig=_quiet_mconfig(), metrics=metrics[i]))
        for sw in sws:
            sw.start()
        connect_switches_plain(sws[0], sws[1])
        return sws, reactors, metrics

    @staticmethod
    def _chan_sum(counter, peer_id):
        return sum(v for labels, v in counter._values.items() if labels[0] == peer_id)

    def test_per_peer_counters_match_flowrate_monitors(self):
        sws, reactors, metrics = self._make_pair()
        try:
            peer0, peer1 = sws[0].peers.list()[0], sws[1].peers.list()[0]
            for i in range(4):
                assert peer0.send(0x10, b"marco-%d" % i)
            assert _wait_until(lambda: len(reactors[0].received) == 4)

            def settled():
                return (peer1.mconn._recv_monitor.status().bytes
                        == peer0.mconn._send_monitor.status().bytes
                        and peer0.mconn._recv_monitor.status().bytes
                        == peer1.mconn._send_monitor.status().bytes)

            assert _wait_until(settled)
            for sw_i, peer, other in ((0, peer0, sws[1]), (1, peer1, sws[0])):
                m = metrics[sw_i]
                sent = peer.mconn._send_monitor.status().bytes
                recv = peer.mconn._recv_monitor.status().bytes
                assert sent > 0 and recv > 0
                assert self._chan_sum(m.peer_send_bytes, other.node_id) == sent
                assert self._chan_sum(m.peer_receive_bytes, other.node_id) == recv
            for i in (0, 1):
                assert metrics[i].messages_sent._values[("0x10",)] == 4
                assert metrics[i].messages_received._values[("0x10",)] == 4
        finally:
            stop_switches(sws)

    def test_pending_send_gauge_and_status(self):
        sws, reactors, metrics = self._make_pair()
        try:
            peer0 = sws[0].peers.list()[0]
            assert peer0.send(0x10, b"x" * 2048)
            assert _wait_until(lambda: peer0.pending_send_bytes() == 0)
            metrics[0].set_peer_pending(peer0.id, peer0.pending_send_bytes())
            assert metrics[0].peer_pending_send_bytes._values[(peer0.id,)] == 0.0
            assert peer0.mconn.status()["channels"]["0x10"]["pending_bytes"] == 0
        finally:
            stop_switches(sws)

    def test_disconnect_forgets_peer_labels(self):
        sws, reactors, metrics = self._make_pair()
        try:
            peer0 = sws[0].peers.list()[0]
            pid = peer0.id
            assert peer0.send(0x10, b"marco")
            assert _wait_until(lambda: reactors[0].received)
            assert pid in metrics[0].registry.expose_text()
            sws[0].stop_peer_for_error(peer0, "test")
            assert _wait_until(lambda: sws[0].peers.size() == 0)
            text = metrics[0].registry.expose_text()
            assert pid not in text
            assert "# TYPE tendermint_p2p_peer_send_bytes_total " in text
        finally:
            stop_switches(sws)


class TestTransportTCP:
    def _make(self, network="tcp-net"):
        def init(i, sw):
            sw.add_reactor("echo", EchoReactor())
            return sw

        return make_switch(init_switch=init, network=network)

    def test_dial_accept_full_upgrade(self):
        sw1, sw2 = self._make(), self._make()
        sw1.start(), sw2.start()
        try:
            laddr = sw1.transport.listen("127.0.0.1:0")
            peer = sw2.dial_peer_with_address(laddr)
            assert peer.id == sw1.node_id
            assert _wait_until(lambda: sw1.peers.size() == 1)
            r2 = sw2.reactors["echo"]
            assert peer.send(0x10, b"over-tcp")
            assert _wait_until(lambda: r2.received)
            assert r2.received[0][1] == b"echo:over-tcp"
        finally:
            stop_switches([sw1, sw2])

    def test_dial_wrong_id_rejected(self):
        sw1, sw2 = self._make(), self._make()
        sw1.start(), sw2.start()
        try:
            laddr = sw1.transport.listen("127.0.0.1:0")
            with pytest.raises(RejectedError) as ei:
                sw2.dial_peer_with_address(NetAddress("ab" * 20, laddr.host, laddr.port))
            assert ei.value.is_auth_failure
            assert sw2.peers.size() == 0
        finally:
            stop_switches([sw1, sw2])

    def test_network_mismatch_rejected(self):
        sw1, sw2 = self._make("net-A"), self._make("net-B")
        sw1.start(), sw2.start()
        try:
            laddr = sw1.transport.listen("127.0.0.1:0")
            with pytest.raises(RejectedError) as ei:
                sw2.dial_peer_with_address(laddr)
            assert ei.value.is_incompatible
        finally:
            stop_switches([sw1, sw2])

    def test_persistent_peer_reconnects(self):
        sw1, sw2 = self._make(), self._make()
        sw1.start(), sw2.start()
        try:
            laddr = sw1.transport.listen("127.0.0.1:0")
            sw2.dial_peer_with_address(laddr, persistent=True)
            assert _wait_until(lambda: sw1.peers.size() == 1)
            sw1.stop_peer_for_error(sw1.peers.list()[0], "simulated failure")
            assert _wait_until(lambda: sw2.peers.size() == 1
                               and sw2.peers.list()[0].is_running, timeout=DEADLINE)
            assert _wait_until(lambda: sw1.peers.size() == 1, timeout=DEADLINE)
        finally:
            stop_switches([sw1, sw2])

    def test_upgrade_deadline_is_the_transports(self):
        """A dialer that never speaks is cut at the transport's handshake
        deadline and never becomes a peer."""
        from tendermint_tpu_torch.p2p.transport import MultiplexTransport

        nk = NodeKey(PrivKeyEd25519.generate())
        t = MultiplexTransport(_node_info(nk), nk, handshake_timeout=0.3, dial_timeout=1.0)
        addr = t.listen("127.0.0.1:0")
        try:
            s = socket.create_connection((addr.host, addr.port), timeout=DEADLINE)
            s.settimeout(DEADLINE)
            t0 = time.monotonic()
            # the transport sends its ephemeral key, then gives up on ours
            assert len(s.recv(64)) == 32
            assert s.recv(64) == b""
            assert time.monotonic() - t0 < 5.0
            s.close()
            with pytest.raises(Exception):
                t.accept(timeout=0.2)
        finally:
            t.stop()
