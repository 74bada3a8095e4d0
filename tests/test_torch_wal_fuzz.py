"""``tests/test_wal_fuzz.py`` against the port's WAL (``consensus/wal.py``),
each case on both framing decoders: the native scanner
(``consensus/_wal_native.c``) and the pure-Python loop. Then the port's two
decoders against the reference's pure-Python loop on numpy-seeded buffers
(random bytes, truncations, bit flips, a corrupt record with valid ones
behind it, vote records): the same messages and the same error string on
every input, exactly.

Invariants under arbitrary input (ref consensus/wal_fuzz.go): decode yields
messages or raises ``DataCorruptionError``, never another exception; every
decoded message re-encodes; records before the corruption point decode.
"""

import os
import random
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from tendermint_tpu.consensus import messages as rmsgs
from tendermint_tpu.consensus import wal as rwal
from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus import wal as wal_mod
from tendermint_tpu_torch.consensus.wal import WAL, DataCorruptionError, TimedWALMessage
from tendermint_tpu_torch.encoding.codec import Writer, encode_uvarint
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType

ROOT = Path(__file__).resolve().parents[1]


def _record(payload: bytes) -> bytes:
    return struct.pack("<I", zlib.crc32(payload)) + encode_uvarint(len(payload)) + payload


def _valid_wal_bytes(n_msgs: int = 8) -> bytes:
    out = b""
    for i in range(n_msgs):
        tm = TimedWALMessage(1_700_000_000_000_000_000 + i, msgs.EndHeightMessage(i))
        out += _record(tm.marshal())
    return out


def _decode_all(tmp_path, data: bytes, name: str, mod=None):
    """Raw bytes through the real WAL read path (the port's, or ``mod``'s)."""
    mod = mod or wal_mod
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    w = mod.WAL(path)
    out = []
    try:
        for tm in w.iter_all():
            # wal_fuzz.go invariant: a decoded message must re-encode
            cw = Writer()
            (msgs if mod is wal_mod else rmsgs).encode_msg(tm.msg, cw)
            assert cw.build()
            out.append(tm)
    finally:
        w.group.close()
    return out


@pytest.fixture(params=["native", "pure"])
def framing(request, monkeypatch):
    """Each case on both of the port's framing decoders."""
    if request.param == "pure":
        monkeypatch.setattr(wal_mod, "_native_scan", False)
    else:
        assert wal_mod._get_native_scan() is not None
    return request.param


def test_valid_stream_roundtrips(tmp_path, framing):
    got = _decode_all(tmp_path, _valid_wal_bytes(8), "valid")
    assert [m.msg.height for m in got] == list(range(8))


def test_random_bytes_never_crash(tmp_path, framing):
    rng = random.Random(1337)
    for trial in range(300):
        data = rng.randbytes(rng.randrange(0, 400))
        try:
            _decode_all(tmp_path, data, f"rand{trial}")
        except DataCorruptionError:
            pass  # the only acceptable failure


def test_truncations_of_valid_stream(tmp_path, framing):
    data = _valid_wal_bytes(6)
    for cut in range(len(data)):
        try:
            got = _decode_all(tmp_path, data[:cut], f"trunc{cut}")
            assert all(m.msg.height == i for i, m in enumerate(got))
        except DataCorruptionError:
            pass


def test_bit_flips_detected_or_tolerated(tmp_path, framing):
    rng = random.Random(7)
    data = _valid_wal_bytes(6)
    for trial in range(200):
        buf = bytearray(data)
        pos = rng.randrange(len(buf))
        buf[pos] ^= 1 << rng.randrange(8)
        try:
            got = _decode_all(tmp_path, bytes(buf), f"flip{trial}")
        except DataCorruptionError:
            continue
        # the CRC covers the payload: every yielded record is an original
        for i, m in enumerate(got):
            assert m.msg.height == i


def test_giant_length_rejected_without_allocation(tmp_path, framing):
    payload = b"x"
    rec = struct.pack("<I", zlib.crc32(payload)) + encode_uvarint(1 << 40) + payload
    with pytest.raises(DataCorruptionError, match=f"length {1 << 40} too big"):
        _decode_all(tmp_path, rec, "giant")


def test_crc_mismatch_rejected(tmp_path, framing):
    payload = TimedWALMessage(1, msgs.EndHeightMessage(3)).marshal()
    rec = (struct.pack("<I", zlib.crc32(payload) ^ 0xDEAD) + encode_uvarint(len(payload))
           + payload)
    with pytest.raises(DataCorruptionError, match="crc mismatch"):
        _decode_all(tmp_path, rec, "badcrc")


@pytest.mark.parametrize("tail,want", [
    (b"\x01\x02", "truncated crc"),
    (b"\x00\x00\x00\x00", "bad length varint: truncated uvarint"),
    (b"\x00\x00\x00\x00\x80\x00", "bad length varint: non-minimal uvarint"),
    (b"\x00\x00\x00\x00" + b"\xff" * 9 + b"\x02", "bad length varint: uvarint overflows uint64"),
    (b"\x00\x00\x00\x00\x05ab", "truncated payload"),
    (b"\x00\x00\x00\x00\x01\x00", "crc mismatch"),
])
def test_each_error_string_after_the_valid_prefix(tmp_path, framing, tail, want):
    got = []
    with pytest.raises(DataCorruptionError) as e:
        w = WAL(str(tmp_path / "tail"))
        with open(str(tmp_path / "tail"), "wb") as f:
            f.write(_valid_wal_bytes(3) + tail)
        try:
            for tm in w.iter_all():
                got.append(tm.msg.height)
        finally:
            w.group.close()
    assert str(e.value) == want
    assert got == [0, 1, 2]


def test_undecodable_payload_is_corruption(tmp_path, framing):
    rec = _record(b"\x01\x02\x03")  # a valid frame around a short payload
    with pytest.raises(DataCorruptionError, match="undecodable payload: truncated fixed64"):
        _decode_all(tmp_path, _valid_wal_bytes(2) + rec, "undecodable")


# -- the port's decoders against the reference's pure-Python loop ------------------


def _outcome(tmp_path, data, name, mod):
    try:
        got = _decode_all(tmp_path, data, name, mod)
        enc = msgs.encode_msg if mod is wal_mod else rmsgs.encode_msg
        return ("ok", [(m.time_ns, _encoded(enc, m.msg)) for m in got], None)
    except mod.DataCorruptionError as e:
        return ("err", None, str(e))


def _encoded(enc, msg) -> bytes:
    w = Writer()
    enc(msg, w)
    return w.build()


def _vote_records(n: int) -> bytes:
    doc, pvs = harness.make_genesis(2)
    out = b""
    for i in range(n):
        v = harness.ValidatorStub(pvs[i % 2], i % 2).sign_vote(SignedMsgType.PRECOMMIT,
                                                               BlockID())
        out += _record(TimedWALMessage(10 + i, msgs.MsgInfo(msgs.VoteMessage(v), "p"))
                       .marshal())
    return out


@pytest.mark.parametrize("seed", [11, 4242, 99])
def test_the_ports_decoders_and_the_references_loop_agree(seed, tmp_path, monkeypatch):
    monkeypatch.setattr(rwal, "_native_scan", False)
    rng = np.random.default_rng(seed)
    valid = _valid_wal_bytes(4) + _vote_records(3) + _valid_wal_bytes(2)
    bad = bytearray(_record(TimedWALMessage(1, msgs.EndHeightMessage(9)).marshal()))
    bad[0] ^= 1
    inputs = [valid, _valid_wal_bytes(3) + bytes(bad) + _valid_wal_bytes(3)]
    for trial in range(150):
        kind = trial % 3
        if kind == 0:
            inputs.append(rng.bytes(int(rng.integers(0, 300))))
        elif kind == 1:
            inputs.append(valid[: int(rng.integers(0, len(valid) + 1))])
        else:
            buf = bytearray(valid)
            buf[int(rng.integers(0, len(buf)))] ^= 1 << int(rng.integers(0, 8))
            inputs.append(bytes(buf))
    n_err = 0
    for i, data in enumerate(inputs):
        want = _outcome(tmp_path, data, f"r{i}", rwal)
        got_native = _outcome(tmp_path, data, f"n{i}", wal_mod)
        with monkeypatch.context() as m:
            m.setattr(wal_mod, "_native_scan", False)
            got_pure = _outcome(tmp_path, data, f"p{i}", wal_mod)
        assert got_native == got_pure == want, (i, want, got_native, got_pure)
        n_err += want[0] == "err"
    assert _outcome(tmp_path, valid, "v", wal_mod)[0] == "ok" and n_err > 0


def test_the_python_path_reads_the_same_wal(tmp_path):
    """TM_NO_NATIVE_CODEC=1 (a child interpreter): no scanner, the same
    messages and the same error string."""
    data = _valid_wal_bytes(5) + _vote_records(2) + b"\x00\x00\x00\x00\x05ab"
    (tmp_path / "w").write_bytes(data)
    code = ("from tendermint_tpu_torch.consensus import wal\n"
            "assert wal._get_native_scan() is None\n"
            f"w = wal.WAL({str(tmp_path / 'w')!r})\n"
            "out = []\n"
            "try:\n"
            "    for tm in w.iter_all():\n"
            "        out.append(tm.marshal().hex())\n"
            "except wal.DataCorruptionError as e:\n"
            "    out.append('err ' + str(e))\n"
            "print('\\n'.join(out))\n")
    env = {k: v for k, v in os.environ.items() if k != "TM_NO_NATIVE_CODEC"}
    env.update(TM_NO_NATIVE_CODEC="1", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    w = WAL(str(tmp_path / "w"))
    want = []
    try:
        for tm in w.iter_all():
            want.append(tm.marshal().hex())
    except DataCorruptionError as e:
        want.append("err " + str(e))
    finally:
        w.group.close()
    assert res.stdout.splitlines() == want and want[-1] == "err truncated payload"
