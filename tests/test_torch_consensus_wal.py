"""The port's crash recovery against the reference's on the same inputs: the
write-ahead log (``consensus/wal.py``: the framing, ``TimedWALMessage``,
``#ENDHEIGHT`` search, corruption), the WAL of a running node, and the ABCI
``Handshaker`` (``consensus/replay.py``) with ``verify_root.handshake``.

The restated cases of ``tests/test_consensus.py`` (``TestWALReplay``,
``TestWALCodec``) and ``tests/test_state.py`` (``TestHandshaker``: the
matrix of app and state behind the store, its three refusals and the app's
InitChain parameters) run once on each package through the ``pkg``
parameter. ``tests/test_wal_fuzz.py``'s ``TestWALFuzz`` cases run on the
port (its native scanner where it built, ``_wal_native.c``) and on the
reference's pure-Python framing loop (its ``_native_scan = False``); a
differential case over seeded random streams holds the two to the same
accepted prefix and the same error string on every input
(``tests/test_torch_wal_fuzz.py`` runs both of the port's decoders). The reference verifies with its host verifier, the
port with the configuration root's guarded verifier on ``device="cpu"``.
"""

import random
import struct
import zlib
from types import SimpleNamespace

import pytest

from tendermint_tpu.consensus import messages as rmsgs
from tendermint_tpu.consensus import replay as rreplay
from tendermint_tpu.consensus import wal as rwal
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.encoding.codec import Writer as RWriter
from tendermint_tpu.types import events as revents
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus import replay
from tendermint_tpu_torch.consensus import wal
from tendermint_tpu_torch.encoding.codec import Writer, encode_uvarint
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.types import events

from tests import consensus_harness as rharness
from tests.test_torch_state import PORT as SPORT
from tests.test_torch_state import REF as SREF
from tests.test_torch_state import commit_for, make_genesis

DEADLINE = 60.0

REF = SimpleNamespace(**{**vars(SREF), "name": "reference"}, h=rharness, msgs=rmsgs,
                      wal=rwal, replay=rreplay, CodecWriter=RWriter,
                      EVENT_NEW_BLOCK=revents.EVENT_NEW_BLOCK,
                      query_for_event=revents.query_for_event)
PORT = SimpleNamespace(**{**vars(SPORT), "name": "port"}, h=harness, msgs=msgs, wal=wal,
                       replay=replay, CodecWriter=Writer,
                       EVENT_NEW_BLOCK=events.EVENT_NEW_BLOCK,
                       query_for_event=events.query_for_event)
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=lambda ns: ns.name)


@pytest.fixture(autouse=True)
def _verifiers():
    rset_batch_verifier(RHostBatchVerifier())
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield root
    verify_root.reset_verify()


@pytest.fixture
def pure_reference_loop(monkeypatch):
    """The reference's WAL reads through its pure-Python framing loop."""
    monkeypatch.setattr(rwal, "_native_scan", False)


# -- tests/test_consensus.py::TestWALReplay ---------------------------------------------


@PKGS
def test_wal_records_and_replays(pkg, tmp_path):
    """Run heights with a real WAL; it holds #ENDHEIGHT 1 and the stored
    state resumed past it."""
    wal_path = str(tmp_path / "cs.wal" / "wal")
    state_db, bs_db = pkg.MemDB(), pkg.MemDB()
    cs, stubs, bus = pkg.h.make_consensus_state(1, wal=pkg.wal.WAL(wal_path),
                                                state_db=state_db, block_store_db=bs_db)
    sub = bus.subscribe("blk", pkg.query_for_event(pkg.EVENT_NEW_BLOCK))
    cs.start()
    try:
        for _ in range(2):
            sub.get(timeout=DEADLINE)
    finally:
        cs.stop()
        cs.wait_done(DEADLINE)
        bus.stop()
    wal2 = pkg.wal.WAL(wal_path)
    heights = [tm.msg.height for tm in wal2.iter_all()
               if isinstance(tm.msg, pkg.msgs.EndHeightMessage)]
    assert 1 in heights
    assert pkg.store.load_state(state_db).last_block_height >= 2


@PKGS
def test_corrupt_wal_detected(pkg, tmp_path, pure_reference_loop):
    wal_path = str(tmp_path / "wal")
    w = pkg.wal.WAL(wal_path)
    w.start()
    w.write_sync(pkg.msgs.EndHeightMessage(0))
    w.write_sync(pkg.msgs.EndHeightMessage(1))
    w.stop()
    with open(wal_path, "r+b") as f:  # flip a byte in the middle
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(pkg.wal.DataCorruptionError):
        list(pkg.wal.WAL(wal_path).iter_all())


def test_a_restarted_node_replays_its_wal_and_goes_on(tmp_path):
    """The port's node stopped mid-chain restarts on the same WAL and
    stores: ``catchup_replay`` finds #ENDHEIGHT of the last stored height,
    and the node commits the next one."""
    wal_path = str(tmp_path / "cs.wal" / "wal")
    state_db, bs_db = PORT.MemDB(), PORT.MemDB()
    cs, _, bus = harness.make_consensus_state(1, wal=wal.WAL(wal_path), state_db=state_db,
                                              block_store_db=bs_db)
    sub = bus.subscribe("blk", events.query_for_event(events.EVENT_NEW_BLOCK))
    cs.start()
    try:
        sub.get(timeout=DEADLINE)
    finally:
        cs.stop()
        cs.wait_done(DEADLINE)
        bus.stop()
    st = PORT.store.load_state(state_db)
    doc, pvs = harness.make_genesis(1)
    cs2, bus2 = harness.make_cs_from_genesis(doc, pvs[0], wal=wal.WAL(wal_path),
                                             state_db=PORT.MemDB(), block_store_db=bs_db)
    # resume from the stored state, as a node's handshake would
    cs2.update_to_state(st)
    cs2.reconstruct_last_commit_if_needed(st)
    sub2 = bus2.subscribe("blk", events.query_for_event(events.EVENT_NEW_BLOCK))
    cs2.start()
    try:
        blk = sub2.get(timeout=DEADLINE).data.block
        assert blk.height == st.last_block_height + 1
        assert cs2.device_fault is None and cs2.wal_replayed >= 1
    finally:
        cs2.stop()
        cs2.wait_done(DEADLINE)
        bus2.stop()


# -- tests/test_consensus.py::TestWALCodec ----------------------------------------------


@PKGS
def test_timed_message_roundtrip(pkg):
    tm = pkg.wal.TimedWALMessage(123456789, pkg.msgs.TimeoutInfo(1.5, 7, 2, 4))
    rt = pkg.wal.TimedWALMessage.unmarshal(tm.marshal())
    assert rt.time_ns == tm.time_ns
    assert rt.msg == tm.msg


@PKGS
def test_msginfo_roundtrip(pkg):
    doc, pvs = pkg.h.make_genesis(1)
    stub = pkg.h.ValidatorStub(pvs[0], 0)
    vote = stub.sign_vote(pkg.SignedMsgType.PREVOTE, pkg.BlockID())
    mi = pkg.msgs.MsgInfo(pkg.msgs.VoteMessage(vote), "peer-x")
    rt = pkg.msgs.unmarshal_msg(pkg.msgs.encode_msg(mi))
    assert rt.peer_id == "peer-x"
    assert rt.msg.vote == vote


def test_timed_messages_marshal_to_the_same_bytes():
    for ref_msg, port_msg in ((rmsgs.TimeoutInfo(1.5, 7, 2, 4), msgs.TimeoutInfo(1.5, 7, 2, 4)),
                              (rmsgs.EndHeightMessage(9), msgs.EndHeightMessage(9)),
                              (rmsgs.EventRoundStep(9, 1, 3), msgs.EventRoundStep(9, 1, 3))):
        a = rwal.TimedWALMessage(1_700_000_000_000_000_123, ref_msg).marshal()
        b = wal.TimedWALMessage(1_700_000_000_000_000_123, port_msg).marshal()
        assert a == b
        assert wal.TimedWALMessage.unmarshal(a).msg == port_msg


# -- tests/test_wal_fuzz.py::TestWALFuzz, on the port and the reference's pure loop ------


def _record(payload: bytes) -> bytes:
    return struct.pack("<I", zlib.crc32(payload)) + encode_uvarint(len(payload)) + payload


def _valid_wal_bytes(ns, n_msgs: int = 8) -> bytes:
    out = b""
    for i in range(n_msgs):
        tm = ns.wal.TimedWALMessage(1_700_000_000_000_000_000 + i, ns.msgs.EndHeightMessage(i))
        out += _record(tm.marshal())
    return out


def _decode_all(ns, tmp_path, data: bytes, name: str):
    """Raw bytes through the real WAL read path."""
    path = str(tmp_path / f"{ns.name}-{name}")
    with open(path, "wb") as f:
        f.write(data)
    w = ns.wal.WAL(path)
    out = []
    try:
        for tm in w.iter_all():
            # wal_fuzz.go invariant: a decoded message must re-encode
            cw = ns.CodecWriter()
            ns.msgs.encode_msg(tm.msg, cw)
            assert cw.build()
            out.append(tm)
    finally:
        w.group.close()
    return out


@PKGS
def test_fuzz_valid_stream_roundtrips(pkg, tmp_path, pure_reference_loop):
    got = _decode_all(pkg, tmp_path, _valid_wal_bytes(pkg, 8), "valid")
    assert [m.msg.height for m in got] == list(range(8))


@PKGS
def test_fuzz_random_bytes_never_crash(pkg, tmp_path, pure_reference_loop):
    rng = random.Random(1337)
    for trial in range(300):
        data = rng.randbytes(rng.randrange(0, 400))
        try:
            _decode_all(pkg, tmp_path, data, f"rand{trial}")
        except pkg.wal.DataCorruptionError:
            pass  # the ONLY acceptable failure mode


@PKGS
def test_fuzz_truncations_of_valid_stream(pkg, tmp_path, pure_reference_loop):
    data = _valid_wal_bytes(pkg, 6)
    for cut in range(len(data)):
        try:
            got = _decode_all(pkg, tmp_path, data[:cut], f"trunc{cut}")
            assert all(m.msg.height == i for i, m in enumerate(got))
        except pkg.wal.DataCorruptionError:
            pass


@PKGS
def test_fuzz_bit_flips_detected_or_tolerated(pkg, tmp_path, pure_reference_loop):
    rng = random.Random(7)
    data = _valid_wal_bytes(pkg, 6)
    for trial in range(200):
        buf = bytearray(data)
        pos = rng.randrange(len(buf))
        buf[pos] ^= 1 << rng.randrange(8)
        try:
            got = _decode_all(pkg, tmp_path, bytes(buf), f"flip{trial}")
        except pkg.wal.DataCorruptionError:
            continue
        for i, m in enumerate(got):
            assert m.msg.height == i


@PKGS
def test_fuzz_giant_length_rejected_without_allocation(pkg, tmp_path, pure_reference_loop):
    payload = b"x"
    rec = struct.pack("<I", zlib.crc32(payload)) + encode_uvarint(1 << 40) + payload
    with pytest.raises(pkg.wal.DataCorruptionError):
        _decode_all(pkg, tmp_path, rec, "giant")


@PKGS
def test_fuzz_crc_mismatch_rejected(pkg, tmp_path, pure_reference_loop):
    payload = pkg.wal.TimedWALMessage(1, pkg.msgs.EndHeightMessage(3)).marshal()
    rec = (struct.pack("<I", zlib.crc32(payload) ^ 0xDEAD) + encode_uvarint(len(payload))
           + payload)
    with pytest.raises(pkg.wal.DataCorruptionError):
        _decode_all(pkg, tmp_path, rec, "badcrc")


def _outcome(ns, tmp_path, data, name):
    try:
        got = _decode_all(ns, tmp_path, data, name)
        return ("ok", [(m.time_ns, ns.msgs.encode_msg(m.msg)) for m in got], None)
    except ns.wal.DataCorruptionError as e:
        return ("err", None, str(e))


@pytest.mark.parametrize("seed", [4242, 99])
def test_the_ports_loop_and_the_references_accept_and_reject_alike(seed, tmp_path,
                                                                   pure_reference_loop):
    """Seeded random streams (random bytes, truncations and bit flips of a
    valid stream, valid records behind a corrupt one, vote records): the
    same accepted prefix and the same error string on every input."""
    rng = random.Random(seed)
    valid = _valid_wal_bytes(PORT, 4)
    assert valid == _valid_wal_bytes(REF, 4)
    doc, pvs = harness.make_genesis(1)
    vote = harness.ValidatorStub(pvs[0], 0).sign_vote(PORT.SignedMsgType.PRECOMMIT,
                                                      PORT.BlockID())
    vote_rec = _record(wal.TimedWALMessage(5, msgs.MsgInfo(msgs.VoteMessage(vote), "p"))
                       .marshal())
    kinds = set()
    for trial in range(250):
        kind = trial % 5
        if kind == 0:
            data = rng.randbytes(rng.randrange(0, 200))
        elif kind == 1:
            data = valid[: rng.randrange(0, len(valid) + 1)]
        elif kind == 2:
            buf = bytearray(valid)
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
            data = bytes(buf)
        elif kind == 3:
            data = valid + rng.randbytes(rng.randrange(1, 12)) + valid
        else:
            buf = bytearray(vote_rec + valid)
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
            data = bytes(buf[: rng.randrange(len(buf) // 2, len(buf) + 1)])
        a = _outcome(REF, tmp_path, data, f"d{trial}")
        b = _outcome(PORT, tmp_path, data, f"d{trial}")
        assert a == b, (trial, a, b)
        kinds.add(a[0] if a[0] == "ok" else a[2].split(":")[0])
    # the streams reached acceptance and several distinct rejections
    assert "ok" in kinds and len(kinds) >= 4, kinds


# -- tests/test_state.py::TestHandshaker -----------------------------------------------

N = 3
_CHAINS = {}


def build_chain(ns):
    """A 1-validator chain of N heights, one tx each, its stores and each
    height's state bytes."""
    if ns.name in _CHAINS:
        return _CHAINS[ns.name]
    doc, pvs = make_genesis(ns, 1)
    st = ns.st.state_from_genesis(doc)
    state_db = ns.MemDB()
    ns.store.save_state(state_db, st)
    block_store = ns.BlockStore(ns.MemDB())
    conn = ns.conn.MultiAppConn(ns.conn.LocalClientCreator(ns.kv.KVStoreApp()))
    conn.start()
    executor = ns.execution.BlockExecutor(state_db, conn.consensus)
    states = {0: st.marshal()}
    last_commit = ns.Commit()
    cur = st
    for h in range(1, N + 1):
        block = cur.make_block(h, [b"k%d=v%d" % (h, h)], last_commit,
                               proposer_address=cur.validators.get_proposer().address)
        parts = block.make_part_set()
        bid = ns.BlockID(hash=block.hash(), parts_header=parts.header())
        new_state = executor.apply_block(cur, bid, block)
        commit = commit_for(ns, cur, block, pvs, bid)
        block_store.save_block(block, parts, commit)
        states[h] = new_state.marshal()
        cur, last_commit = new_state, commit
    conn.stop()
    _CHAINS[ns.name] = (doc, state_db, block_store, states)
    return _CHAINS[ns.name]


def copy_db(ns, db):
    out = ns.MemDB()
    for k, v in db.iterator():
        out.set(k, v)
    return out


def fresh_app_at(ns, block_store, height):
    """A fresh kvstore advanced to ``height`` by re-running stored blocks."""
    app = ns.kv.KVStoreApp()
    for h in range(1, height + 1):
        for tx in block_store.load_block(h).data.txs:
            app.deliver_tx(ns.abci.RequestDeliverTx(tx=bytes(tx)))
        app.commit(ns.abci.RequestCommit())
    return app


def handshaker(ns, state_bytes):
    doc, state_db, block_store, _ = build_chain(ns)
    return ns.replay.Handshaker(copy_db(ns, state_db), ns.st.State.unmarshal(state_bytes),
                                block_store, doc)


@PKGS
@pytest.mark.parametrize("state_behind", [0, 1])
@pytest.mark.parametrize("app_behind", [0, 1, 2, 3])
def test_handshake_matrix(pkg, state_behind, app_behind):
    doc, state_db, block_store, states = build_chain(pkg)
    app = fresh_app_at(pkg, block_store, N - app_behind)
    conn = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(app))
    conn.start()
    hs = handshaker(pkg, states[N - state_behind])
    res_state = hs.handshake(conn)
    expected = pkg.st.State.unmarshal(states[N])
    assert res_state.last_block_height == N
    assert res_state.app_hash == expected.app_hash
    assert res_state.marshal() == expected.marshal()
    assert app.height == N
    # one tx per block: a block applied twice would make the size > N
    assert app.size == N
    assert hs.n_blocks == app_behind + (1 if app_behind == 0 and state_behind else 0)
    conn.stop()


def refused(pkg, state_at, tamper, match):
    doc, state_db, block_store, states = build_chain(pkg)
    app = fresh_app_at(pkg, block_store, N)
    tamper(pkg, app)
    conn = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(app))
    conn.start()
    with pytest.raises(pkg.replay.ReplayError, match=match):
        handshaker(pkg, states[state_at]).handshake(conn)
    conn.stop()


@PKGS
def test_handshake_refuses_an_app_ahead_of_the_store(pkg):
    refused(pkg, N, lambda ns, app: app.commit(ns.abci.RequestCommit()), "ahead of store")


@PKGS
def test_handshake_refuses_a_store_too_far_ahead_of_the_state(pkg):
    refused(pkg, N - 2, lambda ns, app: None, "more than one ahead")


@PKGS
def test_handshake_halts_on_an_app_hash_mismatch(pkg):
    refused(pkg, N, lambda ns, app: app.state.__setitem__(b"rogue", b"entry"),
            "app hash mismatch")


@PKGS
def test_handshake_applies_the_apps_init_chain_params(pkg):
    class ParamApp(pkg.kv.KVStoreApp):
        def __init__(self):
            super().__init__()
            self.seen_params = None

        def init_chain(self, req):
            self.seen_params = req.consensus_params
            return pkg.abci.ResponseInitChain(consensus_params=pkg.abci.ConsensusParams(
                block_size=pkg.abci.BlockSizeParams(max_bytes=12345, max_gas=99)))

    doc, _ = make_genesis(pkg, 1)
    st = pkg.st.state_from_genesis(doc)
    state_db = pkg.MemDB()
    pkg.store.save_state(state_db, st)
    app = ParamApp()
    conn = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(app))
    conn.start()
    res_state = pkg.replay.Handshaker(state_db, st, pkg.BlockStore(pkg.MemDB()),
                                      doc).handshake(conn)
    assert app.seen_params.block_size.max_bytes == doc.consensus_params.block_size.max_bytes
    assert res_state.consensus_params.block_size.max_bytes == 12345
    assert res_state.consensus_params.block_size.max_gas == 99
    assert pkg.store.load_state(state_db).consensus_params.block_size.max_bytes == 12345
    conn.stop()


def test_verify_root_handshake_saves_the_state_it_returns():
    """``verify_root.handshake`` replays what the app misses (a block that
    the state misses too through ``apply_block``) and saves the state."""
    doc, state_db, block_store, states = build_chain(PORT)
    app = fresh_app_at(PORT, block_store, N - 1)
    conn = PORT.conn.MultiAppConn(PORT.conn.LocalClientCreator(app))
    conn.start()
    db = copy_db(PORT, state_db)
    st = verify_root.handshake(db, PORT.st.State.unmarshal(states[N - 1]), block_store, doc,
                               conn)
    assert st.marshal() == states[N]
    assert PORT.store.load_state(db).marshal() == states[N]
    assert app.height == N
    conn.stop()
