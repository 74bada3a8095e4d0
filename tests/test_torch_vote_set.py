"""The port's ``BitArray``, vote types, ``MockPV``, ``VoteSet`` and the
seeded storms (tendermint_tpu_torch/libs/bit_array.py, types/vote.py,
types/priv_validator.py, types/vote_set.py, testutil/votes.py) against the
reference's on the same seeded inputs, exactly: the storms marshal
byte-equal to the reference bench's and test's, and the serial
``add_vote`` path leaves every vote set as the reference's does (outcomes,
error classes, evidence, bit arrays, sums, maj23, the commit's bytes)."""

import importlib.util
import random
from dataclasses import replace
from pathlib import Path

import pytest

import tests.test_vote_batch as rvb
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as RPrivKeyEd25519
from tendermint_tpu.libs.bit_array import BitArray as RBitArray
from tendermint_tpu.types import BlockID as RBlockID
from tendermint_tpu.types import PartSetHeader as RPartSetHeader
from tendermint_tpu.types import VoteSet as RVoteSet
from tendermint_tpu.types.vote import ErrVoteConflictingVotes as RConflict
from tendermint_tpu.types.vote import VoteError as RVoteError
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.libs.bit_array import BitArray
from tendermint_tpu_torch.testutil import votes as tv
from tendermint_tpu_torch.types.core import SignedMsgType
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.vote import (
    ErrVoteConflictingVotes,
    ErrVoteInvalidSignature,
    ErrVoteInvalidValidatorAddress,
    Vote,
    VoteError,
)
from tendermint_tpu_torch.types.vote_set import ErrVoteUnexpectedStep, VoteSet

ROOT = Path(__file__).resolve().parents[1]
N_BENCH, WAVES = 24, 4


def _bench_votes():
    """The reference's scripts/bench_votes.py as a module (its storm makers)."""
    spec = importlib.util.spec_from_file_location(
        "bench_votes_ref", ROOT / "scripts" / "bench_votes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_state(sets):
    """``tv.vote_set_state`` of the reference's sets."""
    blocks = (rvb.BLOCK_A, rvb.BLOCK_B)
    out = {}
    for gk, s in sets.items():
        maj = s.two_thirds_majority()
        per_block = []
        for bid in blocks:
            ba = s.bit_array_by_block_id(bid)
            per_block.append(None if ba is None else ba.marshal())
        out[tuple(int(x) for x in gk)] = (
            s.bit_array().marshal(), s.sum, None if maj is None else maj.key(),
            tuple(per_block))
    return out


def _ref_serial(sets, waves):
    outcomes, evidence = [], []
    for wave in waves:
        for gk, vote in wave:
            try:
                outcomes.append(("added", sets[gk].add_vote(vote)))
            except RConflict as e:
                outcomes.append(("conflict", e.added))
                evidence.append((gk, e.vote_a, e.vote_b))
            except RVoteError as e:
                outcomes.append((type(e).__name__, None))
    return outcomes, evidence


def _marshal_waves(waves):
    return [[(tuple(int(x) for x in gk), v.marshal()) for gk, v in w] for w in waves]


# -- BitArray ---------------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 1, 7, 8, 64, 100, 257])
def test_bit_array_parity(bits):
    rng = random.Random(bits)
    a, ra = BitArray(bits), RBitArray(bits)
    b, rb = BitArray(bits), RBitArray(bits)
    for _ in range(3 * bits + 4):
        i = rng.randrange(-2, bits + 3)
        v = rng.random() < 0.6
        assert a.set_index(i, v) == ra.set_index(i, v)
        j = rng.randrange(-2, bits + 3)
        assert b.set_index(j, not v) == rb.set_index(j, not v)
        assert a.get_index(i) == ra.get_index(i)
    for got, want in ((a, ra), (a.or_(b), ra.or_(rb)), (a.and_(b), ra.and_(rb)),
                      (a.sub(b), ra.sub(rb)), (a.not_(), ra.not_())):
        assert got.marshal() == want.marshal()
        assert (got.bits, got.num_true(), got.true_indices()) == (
            want.bits, want.num_true(), want.true_indices())
        assert (got.is_empty(), got.is_full(), str(got)) == (
            want.is_empty(), want.is_full(), str(want))
        assert BitArray.unmarshal(want.marshal()) == got
    assert a == a.copy() and a != ra and (a == b) == (ra == rb)
    c = BitArray(bits)
    c.update(a)
    assert c == a


def test_bit_array_decode_bound():
    data = RBitArray(8).marshal()
    assert BitArray.unmarshal(data) == BitArray(8)
    big = bytes([0x80, 0x80, 0x80, 0x10, 0])  # a uvarint of 2^31, no payload
    with pytest.raises(ValueError):
        BitArray.unmarshal(big)
    with pytest.raises(ValueError):
        RBitArray.unmarshal(big)


# -- keys, MockPV, Vote -----------------------------------------------------


@pytest.mark.parametrize("seed", [b"\x01" * 32, b"bench-signed-007" + b"\x00" * 16])
def test_priv_key_and_mock_pv_sign_byte_equal(seed):
    priv, ref = PrivKeyEd25519.generate(seed), RPrivKeyEd25519.generate(seed)
    assert priv.bytes() == ref.bytes()
    assert priv.pub_key().bytes() == ref.pub_key().bytes()
    assert priv.pub_key().address() == ref.pub_key().address()
    for msg in (b"", b"vote", bytes(range(200))):
        assert priv.sign(msg) == ref.sign(msg)
    secret = PrivKeyEd25519.from_secret(b"secret")
    assert secret.bytes() == RPrivKeyEd25519.from_secret(b"secret").bytes()
    pv = MockPV(priv)
    assert pv.address == priv.pub_key().address()
    vs, _ = tv.make_vals(4)
    vote = tv.make_vote(pv, vs, 0, SignedMsgType.PREVOTE, tv.BLOCK_A)
    assert vote.signature == priv.sign(vote.sign_bytes(tv.BENCH_CHAIN_ID))


def test_vote_verify_errors():
    vs, pvs = tv.make_vals(4)
    vote = tv.make_vote(pvs[0], vs, 0, SignedMsgType.PREVOTE, tv.BLOCK_A)
    vote.verify(tv.BENCH_CHAIN_ID, pvs[0].get_pub_key())
    with pytest.raises(ErrVoteInvalidValidatorAddress):
        vote.verify(tv.BENCH_CHAIN_ID, pvs[1].get_pub_key())
    with pytest.raises(ErrVoteInvalidSignature):
        vote.with_signature(b"\x01" * 64).verify(tv.BENCH_CHAIN_ID, pvs[0].get_pub_key())
    with pytest.raises(ErrVoteInvalidSignature):
        vote.verify("another-chain", pvs[0].get_pub_key())
    assert issubclass(ErrVoteConflictingVotes, VoteError)
    err = ErrVoteConflictingVotes(vote, vote)
    assert err.vote_a is vote and err.vote_b is vote and err.pub_key is None


# -- storms -----------------------------------------------------------------


def test_bench_storm_marshals_byte_equal_to_the_reference():
    bv = _bench_votes()
    rvs, rpvs = bv.make_vals(N_BENCH)
    vs, pvs = tv.make_vals(N_BENCH)
    assert vs.hash() == rvs.hash()
    want = _marshal_waves(bv.build_storm(rvs, rpvs, 7, WAVES))
    assert _marshal_waves(tv.build_storm(vs, pvs, seed=7, waves=WAVES)) == want


@pytest.mark.parametrize("n_vals,seed", [(16, 7), (64, 21)])
def test_flat_storm_marshals_byte_equal_to_the_reference(n_vals, seed):
    rvs, rpvs = rvb.make_vals(n_vals)
    vs, pvs = tv.make_vals(n_vals, keys=tv.KEYS_TEST)
    want = [(tuple(int(x) for x in gk), v.marshal())
            for gk, v in rvb.build_storm(rvs, rpvs, seed=seed)]
    got = [(tuple(int(x) for x in gk), v.marshal())
           for gk, v in tv.build_flat_storm(vs, pvs, seed=seed)]
    assert got == want


def test_secp_every_gives_every_kth_validator_a_secp256k1_key():
    from tendermint_tpu_torch.crypto.keys import PubKeySecp256k1

    vs, pvs = tv.make_vals(16, secp_every=8)
    kinds = [type(v.pub_key) for v in vs.validators]
    assert kinds.count(PubKeySecp256k1) == 2
    assert [pv.get_pub_key().address() for pv in pvs] == [v.address for v in vs.validators]


# -- serial VoteSet parity --------------------------------------------------


def _serial_parity(rsets, rwaves, sets, waves, chain_id):
    want, want_ev = _ref_serial(rsets, rwaves)
    got, got_ev = tv.run_serial(sets, waves)
    assert got == want
    assert tv.evidence_key(got_ev) == tv.evidence_key(want_ev)
    assert tv.vote_set_state(sets) == _ref_state(rsets)
    for gk, s in sets.items():
        r = rsets[gk]
        assert (s.has_two_thirds_any(), s.has_all(), s.is_commit(), str(s)) == (
            r.has_two_thirds_any(), r.has_all(), r.is_commit(), str(r))
        for bid, rbid in ((tv.BLOCK_A, rvb.BLOCK_A), (tv.BLOCK_B, rvb.BLOCK_B)):
            assert s.sum_by_block_id(bid) == r.sum_by_block_id(rbid)
        for i in range(s.size):
            a, b = s.get_by_index(i), r.get_by_index(i)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.marshal() == b.marshal()
        if r.is_commit():
            assert s.make_commit().marshal() == r.make_commit().marshal()
            commit = s.make_commit()
            s.val_set.verify_commit(chain_id, commit.block_id, 1, commit,
                                    verifier=_host())
    return got


def _host():
    from tendermint_tpu_torch.crypto.batch import HostBatchVerifier

    return HostBatchVerifier()


def test_serial_bench_storm_equals_the_reference():
    bv = _bench_votes()
    rvs, rpvs = bv.make_vals(N_BENCH)
    vs, pvs = tv.make_vals(N_BENCH)
    rsets, sets = bv.fresh_sets(rvs), tv.fresh_sets(vs)
    got = _serial_parity(rsets, bv.build_storm(rvs, rpvs, 7, WAVES), sets,
                         tv.build_storm(vs, pvs, seed=7, waves=WAVES), tv.BENCH_CHAIN_ID)
    assert {o[0] for o in got} >= {"added"}


@pytest.mark.parametrize("n_vals,seed", [(16, 7), (64, 21)])
def test_serial_flat_storm_equals_the_reference(n_vals, seed):
    rvs, rpvs = rvb.make_vals(n_vals)
    vs, pvs = tv.make_vals(n_vals, keys=tv.KEYS_TEST)
    rsets, sets = rvb.fresh_sets(rvs), tv.fresh_sets(vs, tv.TEST_CHAIN_ID)
    got = _serial_parity(rsets, [rvb.build_storm(rvs, rpvs, seed=seed)], sets,
                         [tv.build_flat_storm(vs, pvs, seed=seed)], tv.TEST_CHAIN_ID)
    labels = {o[0] for o in got}
    # the storm reaches every outcome class the serial path has
    assert {"added", "conflict", "ErrVoteInvalidSignature"} <= labels


def _peer_maj23_case(VS, Vote_, BlockID_, PSH, pub, sign_vote, err_cls, vs, pvs, chain):
    """Validator 0 precommits for block A, then for block B, which a peer
    claims has +2/3: the second vote raises ErrVoteConflictingVotes with
    added=True and enters B's tally; B's quorum then latches maj23 and the
    main tally switches to B's votes."""
    block_a = BlockID_(hash=b"a" * 32, parts_header=PSH(total=1, hash=b"p" * 32))
    block_b = BlockID_(hash=b"b" * 32, parts_header=PSH(total=1, hash=b"p" * 32))
    vset = VS(chain, 1, 0, SignedMsgType.PRECOMMIT, vs)
    trail = []

    def vote(i, bid):
        addr = pub(pvs[i]).address()
        idx, _ = vs.get_by_address(addr)
        return sign_vote(pvs[i], Vote_(vote_type=SignedMsgType.PRECOMMIT, height=1, round=0,
                                       timestamp_ns=tv.TS, block_id=bid,
                                       validator_address=addr, validator_index=idx))

    trail.append(vset.add_vote(vote(0, block_a)))
    try:
        vset.add_vote(vote(0, block_b))
    except err_cls as e:
        trail.append(("conflict", e.added))
    vset.set_peer_maj23("peer-1", block_b)
    vset.set_peer_maj23("peer-1", block_b)  # the same claim again is a no-op
    try:
        vset.set_peer_maj23("peer-1", block_a)
    except Exception as e:  # a changed claim
        trail.append(type(e).__name__)
    try:
        vset.add_vote(vote(0, block_b))
    except err_cls as e:
        trail.append(("conflict", e.added, e.vote_a.block_id.hash, e.vote_b.block_id.hash))
    for i in range(1, len(pvs)):
        trail.append(vset.add_vote(vote(i, block_b)))
    maj = vset.two_thirds_majority()
    trail.append(None if maj is None else maj.hash)
    trail.append(vset.bit_array().marshal())
    trail.append(vset.bit_array_by_block_id(block_b).marshal())
    trail.append(vset.bit_array_by_block_id(block_a).marshal())
    trail.append((vset.sum, vset.sum_by_block_id(block_a), vset.sum_by_block_id(block_b)))
    trail.append(vset.get_by_index(0).block_id.hash)
    trail.append(vset.make_commit().marshal())
    return trail


def test_peer_maj23_conflicting_admission_equals_the_reference():
    from tendermint_tpu.types import MockPV as RMockPV
    from tendermint_tpu.types import Vote as RVote
    from tendermint_tpu.types import Validator as RValidator
    from tendermint_tpu.types import ValidatorSet as RValidatorSet
    from tendermint_tpu_torch.types.core import BlockID, PartSetHeader

    n = 4
    rpvs = [RMockPV(RPrivKeyEd25519.generate(bytes([i + 1]) * 32)) for i in range(n)]
    rvs = RValidatorSet([RValidator(pv.get_pub_key(), 10) for pv in rpvs])
    rby = {pv.get_pub_key().address(): pv for pv in rpvs}
    rpvs = [rby[v.address] for v in rvs.validators]
    vs, pvs = tv.make_vals(n, keys=tv.KEYS_TEST)
    pub = lambda pv: pv.get_pub_key()  # noqa: E731
    sign = lambda pv, v: pv.sign_vote("maj23-chain", v)  # noqa: E731
    want = _peer_maj23_case(RVoteSet, RVote, RBlockID, RPartSetHeader, pub, sign,
                            RConflict, rvs, rpvs, "maj23-chain")
    got = _peer_maj23_case(VoteSet, Vote, BlockID, PartSetHeader, pub, sign,
                           ErrVoteConflictingVotes, vs, pvs, "maj23-chain")
    assert got == want
    assert ("conflict", False) in got and any(
        isinstance(t, tuple) and t[:2] == ("conflict", True) for t in got)


def test_prevalidate_rejections_equal_the_reference():
    rvs, rpvs = rvb.make_vals(4)
    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    rset = RVoteSet(rvb.CHAIN_ID, 1, 0, SignedMsgType.PREVOTE, rvs)
    tset = VoteSet(tv.TEST_CHAIN_ID, 1, 0, SignedMsgType.PREVOTE, vs)
    rv = rvb.make_vote(rpvs[0], rvs, 1, 0, SignedMsgType.PREVOTE, rvb.BLOCK_A)
    tvote = tv.make_vote(pvs[0], vs, 0, SignedMsgType.PREVOTE, tv.BLOCK_A, tv.TEST_CHAIN_ID)
    cases = [
        lambda v: None,
        lambda v: replace(v, height=2),
        lambda v: replace(v, vote_type=SignedMsgType.PRECOMMIT),
        lambda v: replace(v, validator_index=9),
        lambda v: replace(v, validator_index=-1),
        lambda v: replace(v, validator_address=b"\x00" * 20),
    ]

    def outcome(vset, vote):
        try:
            return vset.add_vote(vote)
        except Exception as e:
            return type(e).__name__

    for mk in cases:
        assert outcome(tset, mk(tvote)) == outcome(rset, mk(rv))
    assert outcome(tset, tvote) == outcome(rset, rv) is True
    assert outcome(tset, tvote) == outcome(rset, rv) is False  # the duplicate
    other = tvote.with_signature(pvs[0].sign_vote("x", tvote).signature)
    rother = rv.with_signature(rpvs[0].sign_vote("x", rv).signature)
    assert outcome(tset, other) == outcome(rset, rother) == "ErrVoteNonDeterministicSignature"
    with pytest.raises(ErrVoteUnexpectedStep):
        tset.prevalidate(replace(tvote, round=3))
    with pytest.raises(ValueError):
        VoteSet(tv.TEST_CHAIN_ID, 0, 0, SignedMsgType.PREVOTE, vs)
    with pytest.raises(ValueError):
        VoteSet(tv.TEST_CHAIN_ID, 1, 0, SignedMsgType.PROPOSAL, vs)
    with pytest.raises(VoteError):
        tset.make_commit()
