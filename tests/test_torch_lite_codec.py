"""The port's light-client codec and hashes (encoding/codec.py,
crypto/merkle.py, types/{core,vote,block,validator_set}.py, lite/types.py)
against the reference's, exactly: bytes, hashes, sign-bytes and error
types. The reference's chains (``testutil/chain.build_chain``: the static
4 x 10 chain and the churn chain of tests/test_lite.py) are carried into
the port as ``FullCommit.marshal()`` bytes; every height's round trip
through the port gives the same bytes, and the port's header hash, set
hashes and commit sign-bytes equal the reference's."""

import base64

import numpy as np
import pytest

from tendermint_tpu.abci.examples.kvstore import PersistentKVStoreApp
from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as JPriv
from tendermint_tpu.encoding import codec as jcodec
from tendermint_tpu.lite.provider import NodeProvider
from tendermint_tpu.testutil.chain import build_chain
from tendermint_tpu.types import MockPV
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types.block import Header as JHeader
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.encoding import codec as tcodec
from tendermint_tpu_torch.lite.types import FullCommit
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types.block import Header
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.vote import Vote

STATIC_HEIGHTS, CHURN_HEIGHTS = 10, 14


def _val_tx(pub: bytes, power: int) -> bytes:
    return b"val:" + base64.b64encode(pub) + b"!%d" % power


def _carry(fx):
    """Every height of a reference chain as FullCommit codec bytes."""
    src = NodeProvider(fx.block_store, fx.state_db)
    return {h: src.full_commit_at(fx.chain_id, h).marshal() for h in range(1, fx.height + 1)}


@pytest.fixture(scope="module")
def chains():
    """The reference's static and churn chains of tests/test_lite.py."""
    static = build_chain(n_vals=4, n_heights=STATIC_HEIGHTS, chain_id="lite-static")
    joiners = [MockPV(JPriv.generate(bytes([50 + i]) * 32)) for i in range(3)]

    def on_height(h, st):
        if h == 4:
            return [_val_tx(pv.get_pub_key().bytes(), 100) for pv in joiners]
        if h == 8:
            leavers = [v for v in st.validators.validators if v.voting_power == 10][:3]
            return [_val_tx(v.pub_key.bytes(), 0) for v in leavers]
        return []

    churn = build_chain(n_vals=4, n_heights=CHURN_HEIGHTS, chain_id="lite-churn",
                        app_factory=PersistentKVStoreApp, on_height=on_height,
                        extra_pvs=joiners)
    return {"static": (static, _carry(static)), "churn": (churn, _carry(churn))}


# -- the codec primitives ------------------------------------------------------

def _ops(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(40):
        k = int(rng.integers(0, 7))
        if k == 0:
            ops.append(("uvarint", int(rng.integers(0, 1 << 62)) >> int(rng.integers(0, 62))))
        elif k == 1:
            ops.append(("svarint", int(rng.integers(-(1 << 62), 1 << 62)) >> int(rng.integers(0, 62))))
        elif k == 2:
            ops.append(("fixed64", int(rng.integers(-(1 << 63), (1 << 63) - 1))))
        elif k == 3:
            ops.append(("bytes", rng.bytes(int(rng.integers(0, 300)))))
        elif k == 4:
            ops.append(("string", "héight-%d" % int(rng.integers(0, 1000))))
        elif k == 5:
            ops.append(("bool", bool(rng.integers(0, 2))))
        else:
            ops.append(("raw", rng.bytes(int(rng.integers(0, 20)))))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_writer_and_reader_match_the_reference(seed):
    ops = _ops(seed)
    tw, jw = tcodec.Writer(), jcodec._PyWriter()
    for name, v in ops:
        getattr(tw, name)(v)
        getattr(jw, name)(v)
    data = tw.build()
    assert data == jw.build()
    tr, jr = tcodec.Reader(data), jcodec._PyReader(data)
    for name, v in ops:
        start = tr.tell()
        assert start == jr.tell()
        args = (len(v),) if name == "raw" else ()
        got = getattr(tr, name)(*args)
        assert got == getattr(jr, name)(*args) == v
        assert tr.span(start) == jr.span(start)
        assert tr.remaining() == jr.remaining()
    assert tr.at_end() and jr.at_end()


BAD_INPUTS = [
    ("uvarint", b""), ("uvarint", b"\x80"), ("uvarint", b"\xc0\x00"),
    ("uvarint", b"\xff" * 9 + b"\x02"), ("uvarint", b"\xff" * 10 + b"\x01"),
    ("svarint", b"\x81"), ("fixed64", b"\x01\x02\x03"), ("bytes", b"\x05abc"),
    ("bytes", b"\x80"), ("string", b"\x02\xff\xfe"), ("bool", b""), ("raw", b"ab"),
]


@pytest.mark.parametrize("op,data", BAD_INPUTS, ids=[f"{o}-{d.hex()}" for o, d in BAD_INPUTS])
def test_reader_rejects_as_the_reference_does(op, data):
    args = (3,) if op == "raw" else ()
    with pytest.raises(Exception) as want:
        getattr(jcodec._PyReader(data), op)(*args)
    with pytest.raises(want.type):
        getattr(tcodec.Reader(data), op)(*args)


def test_span_rejects_a_start_past_the_position():
    r = tcodec.Reader(b"\x01\x02")
    r.uvarint()
    with pytest.raises(ValueError):
        r.span(2)
    assert r.span(0) == b"\x01"


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 33])
def test_merkle_root_matches_the_reference(n):
    rng = np.random.default_rng(n)
    items = [rng.bytes(int(rng.integers(0, 70))) for _ in range(n)]
    want = jmerkle.hash_from_byte_slices(items)
    assert tmerkle.hash_from_byte_slices(items) == want
    assert jmerkle._py_hash_from_byte_slices(items) == want


# -- records -------------------------------------------------------------------

@pytest.mark.parametrize("name,height", [("static", h) for h in range(1, STATIC_HEIGHTS + 1)]
                         + [("churn", h) for h in range(1, CHURN_HEIGHTS + 1)])
def test_full_commit_round_trip_and_hashes(chains, name, height):
    fx, carried = chains[name]
    raw = carried[height]
    ref = NodeProvider(fx.block_store, fx.state_db).full_commit_at(fx.chain_id, height)
    fc = FullCommit.unmarshal(raw)
    assert fc.marshal() == raw
    hdr = fc.signed_header.header
    assert hdr.hash() == ref.signed_header.header.hash()
    assert fc.validators.hash() == ref.validators.hash() == hdr.validators_hash
    assert fc.next_validators.hash() == ref.next_validators.hash()
    # the decoded sets keep their accums and proposer
    for got, want in ((fc.validators, ref.validators), (fc.next_validators, ref.next_validators)):
        assert [v.accum for v in got.validators] == [v.accum for v in want.validators]
        assert got.get_proposer().address == want.get_proposer().address
    commit, ref_commit = fc.signed_header.commit, ref.signed_header.commit
    for pc, rpc in zip(commit.precommits, ref_commit.precommits):
        assert (pc is None) == (rpc is None)
        if pc is not None:
            assert pc.sign_bytes(fx.chain_id) == rpc.sign_bytes(fx.chain_id)
            assert pc.marshal() == rpc.marshal()
    got = fc.validators.collect_commit_sigs(fx.chain_id, commit.block_id, height, commit)
    want = ref.validators.collect_commit_sigs(fx.chain_id, ref_commit.block_id, height, ref_commit)
    assert got[1:] == want[1:]
    fc.validate_full(fx.chain_id)


def test_header_hash_is_none_until_validators_hash_is_set():
    assert Header(chain_id="c", height=3).hash() is None is JHeader(chain_id="c", height=3).hash()
    h, jh = Header(chain_id="c", height=3, validators_hash=b"\x01" * 32), JHeader(
        chain_id="c", height=3, validators_hash=b"\x01" * 32)
    assert h.hash() == jh.hash()
    w = tcodec.Writer()
    h.encode(w)
    assert Header.decode(tcodec.Reader(w.build())) == h


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 4, 7, 10])
def test_validator_set_codec_and_rotation_match_the_reference(n):
    seeds = _keys(n, n)
    powers = [10 + 7 * (i % 3) for i in range(n)]
    port = tvs.ValidatorSet([tvs.Validator(PubKeyEd25519(ted.pubkey_from_seed(s)), p)
                             for s, p in zip(seeds, powers)])
    ref = jvs.ValidatorSet([jvs.Validator(JPriv.generate(s).pub_key(), p)
                            for s, p in zip(seeds, powers)])
    for times in (0, 1, 3, 7):
        if times:
            port, ref = port.copy_increment_accum(times), ref.copy_increment_accum(times)
        assert port.marshal() == ref.marshal()
        assert port.hash() == ref.hash()
        assert port.get_proposer().address == ref.get_proposer().address
        back = tvs.ValidatorSet.unmarshal(ref.marshal())
        assert back.marshal() == ref.marshal()
    addr = ref.validators[n // 2].address
    assert port.get_by_address(addr)[0] == ref.get_by_address(addr)[0]
    assert port.get_by_address(b"\x00" * 20) == (-1, None)


def test_validator_set_decode_rejects_another_codec_version():
    data = tcodec.Writer().uvarint(1).uvarint(0).build()
    with pytest.raises(ValueError, match="codec version"):
        jvs.ValidatorSet.unmarshal(data)
    with pytest.raises(ValueError, match="codec version"):
        tvs.ValidatorSet.unmarshal(data)


def test_vote_codec_matches_the_reference():
    rng = np.random.default_rng(3)
    for i in range(8):
        kw = dict(vote_type=SignedMsgType.PRECOMMIT if i % 2 else SignedMsgType.PREVOTE,
                  height=int(rng.integers(1, 1 << 40)), round=i,
                  timestamp_ns=int(rng.integers(-(1 << 62), 1 << 62)),
                  block_id=BlockID(rng.bytes(32), PartSetHeader(i, rng.bytes(32))),
                  validator_address=rng.bytes(20), validator_index=i, signature=rng.bytes(64))
        v = Vote(**kw)
        data = v.marshal()
        assert JVote.unmarshal(data).marshal() == data
        assert Vote.unmarshal(data) == v


# -- verify_future_commit --------------------------------------------------------

def _outcome(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("old,new", [(1, 3), (2, 5), (2, 13), (3, 6), (5, 6), (5, 9),
                                     (7, 10), (9, 11), (1, 14), (10, 12)])
def test_verify_future_commit_matches_the_reference(chains, old, new):
    fx, carried = chains["churn"]
    ref_src = NodeProvider(fx.block_store, fx.state_db)
    rt, rf = ref_src.full_commit_at(fx.chain_id, old), ref_src.full_commit_at(fx.chain_id, new)
    pt, pf = FullCommit.unmarshal(carried[old]), FullCommit.unmarshal(carried[new])

    def run(t, f, **kw):
        c = f.signed_header.commit
        return _outcome(lambda: t.next_validators.verify_future_commit(
            f.validators, fx.chain_id, c.block_id, f.height, c, **kw))

    want = run(rt, rf)
    assert run(pt, pf, verifier=tbatch.HostBatchVerifier()) == want
    # a flipped signature bit fails it the same way
    for fc in (rf, pf):
        pcs = fc.signed_header.commit.precommits
        i = next(j for j, pc in enumerate(pcs) if pc is not None)
        sig = bytearray(pcs[i].signature)
        sig[37] ^= 0x10
        pcs[i] = pcs[i].with_signature(bytes(sig))
    assert run(pt, pf, verifier=tbatch.HostBatchVerifier()) == run(rt, rf) != want


def test_too_much_change_is_a_commit_error():
    assert issubclass(tvs.TooMuchChangeError, tvs.CommitError)
    assert [c.__name__ for c in tvs.TooMuchChangeError.__mro__[:3]] == [
        c.__name__ for c in jvs.TooMuchChangeError.__mro__[:3]]
