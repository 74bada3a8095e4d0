"""The port's consensus state machine against the reference's on the same
inputs: ``consensus/{messages,cstypes,ticker,state}.py``,
``types/proposal.py`` with ``MockPV.sign_proposal`` / ``sign_heartbeat``,
``libs/{events,autofile}.py`` and ``testutil/consensus.py``.

The restated cases of ``tests/test_consensus.py`` (``TestSingleValidator``,
``Test4Validators``, ``TestLocking``), ``tests/test_libs.py``
(``TestAutofile``, ``TestEvents``) and ``tests/test_types.py``
(``TestProposal``) run once on each package through the ``pkg`` parameter:
the reference test's assertions hold on both. Where the reference's case
loops over validator indices until its node proposes at height 1 (and
skips when none does), the restated case takes that index from the
genesis, so it never skips. The reference verifies with its host verifier
(the suite's conftest installs it); the port with the configuration root's
guarded verifier on ``device="cpu"`` (the kernels' plain versions) at
``dispatch_deadline=0``. Every consensus message encodes to the same bytes
in both packages, and each package decodes the other's.

The vote-feed case runs 4 validators over 3 heights through each
package's harness, serially and with its ``VoteFeed`` (the port's on
``device="cpu"``, the reference's with ``use_device=False``), with one stub
double-signing a prevote at height 2: the commit round and the app hash at
each height, and the ``DuplicateVoteEvidence`` minted (type, height,
address), are the same in all four runs. The hand-off case gives the state
that the port's ``BlockchainReactor`` fast-synced to a ``ConsensusState``
through a test-only adapter of the reference reactor's
``switch_to_consensus``, and the node commits the next height. Every wait
is bounded by a deadline; no wall time is asserted.
"""

import queue
import threading
import time
from types import SimpleNamespace

import pytest

import tendermint_tpu.types as rtypes
from tendermint_tpu.config import config as rconfig
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as RPrivKeyEd25519
from tendermint_tpu.consensus import messages as rmsgs
from tendermint_tpu.consensus.cstypes import RoundStepType as RRoundStepType
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.libs import autofile as rautofile
from tendermint_tpu.libs import bit_array as rbit_array
from tendermint_tpu.libs import events as rlevents
from tendermint_tpu.parallel import planner as rplanner
from tendermint_tpu.state import state_types as rst
from tendermint_tpu.types import events as revents
from tendermint_tpu.types import part_set as rpart_set
from tendermint_tpu.types import proposal as rproposal
from tendermint_tpu_torch.blockchain import reactor
from tendermint_tpu_torch.config.consensus import consensus_test_config
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus.cstypes import RoundStepType
from tendermint_tpu_torch.crypto.batch import HostBatchVerifier
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.libs import autofile, bit_array
from tendermint_tpu_torch.libs import events as levents
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state import state_types as st_types
from tendermint_tpu_torch.testutil import chain
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.testutil.fastsync import LoopbackSwitch, ServingPeer
from tendermint_tpu_torch.types import core, events, part_set, priv_validator, proposal
from tendermint_tpu_torch.types import evidence as tevidence
from tendermint_tpu_torch.types import vote as tvote

from tests import consensus_harness as rharness

DEADLINE = 60.0
TIME0 = 1_700_000_000_000_000_000


def _ref_config(**consensus):
    cfg = rconfig.test_config()
    for k, v in consensus.items():
        setattr(cfg.consensus, k, v)
    return cfg


def _port_config(**consensus):
    cfg = consensus_test_config()
    for k, v in consensus.items():
        setattr(cfg, k, v)
    return cfg


def _ref_decide_proposal(cs, stub, height, round):
    """The reference harness has no ``decide_proposal``: the same
    construction on the reference's types."""
    with cs._mtx:
        rs, state = cs.rs, cs.state
        commit = rtypes.Commit() if height == 1 else rs.last_commit.make_commit()
        max_bytes = state.consensus_params.block_size.max_bytes
        block = state.make_block(
            height,
            cs.mempool.reap_max_bytes_max_gas(max_bytes * 9 // 10,
                                              state.consensus_params.block_size.max_gas),
            commit, cs.evpool.pending_evidence(max_bytes // 10), stub.address)
        pol_round = rs.valid_round
    parts = block.make_part_set()
    prop = rtypes.Proposal(height=height, round=round, timestamp_ns=time.time_ns(),
                           block_id=rtypes.BlockID(hash=block.hash(), parts_header=parts.header()),
                           pol_round=pol_round)
    return stub.pv.sign_proposal(rharness.CHAIN_ID, prop), block, parts


REF = SimpleNamespace(
    name="reference", h=rharness, msgs=rmsgs, RoundStepType=RRoundStepType, st=rst,
    BlockID=rtypes.BlockID, PartSetHeader=rtypes.PartSetHeader, SignedMsgType=rtypes.SignedMsgType,
    Proposal=rtypes.Proposal, Heartbeat=rproposal.Heartbeat, MockPV=rtypes.MockPV,
    Vote=rtypes.Vote, PartSet=rpart_set.PartSet, BitArray=rbit_array.BitArray,
    DuplicateVoteEvidence=rtypes.DuplicateVoteEvidence,
    Group=rautofile.Group, EventSwitch=rlevents.EventSwitch,
    EVENT_NEW_BLOCK=revents.EVENT_NEW_BLOCK, EVENT_VOTE=revents.EVENT_VOTE,
    query_for_event=revents.query_for_event, config=_ref_config,
    decide_proposal=_ref_decide_proposal,
    vote_feed=lambda: rplanner.VoteFeed(use_device=False, window_s=0.002, max_rows=64))
PORT = SimpleNamespace(
    name="port", h=harness, msgs=msgs, RoundStepType=RoundStepType, st=st_types,
    BlockID=core.BlockID, PartSetHeader=core.PartSetHeader, SignedMsgType=core.SignedMsgType,
    Proposal=proposal.Proposal, Heartbeat=proposal.Heartbeat, MockPV=priv_validator.MockPV,
    Vote=tvote.Vote, PartSet=part_set.PartSet, BitArray=bit_array.BitArray,
    DuplicateVoteEvidence=tevidence.DuplicateVoteEvidence,
    Group=autofile.Group, EventSwitch=levents.EventSwitch,
    EVENT_NEW_BLOCK=events.EVENT_NEW_BLOCK, EVENT_VOTE=events.EVENT_VOTE,
    query_for_event=events.query_for_event, config=_port_config,
    decide_proposal=harness.decide_proposal,
    vote_feed=lambda: planner.VoteFeed(window_s=0.002, max_rows=64, device="cpu"))
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=lambda ns: ns.name)


@pytest.fixture(autouse=True)
def _verifiers():
    """The reference's host verifier (as its suite's conftest installs it)
    and the port's guarded verifier on the CPU."""
    rset_batch_verifier(RHostBatchVerifier())
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield root
    verify_root.reset_verify()


def proposer_index(ns, n_vals):
    """The index, in the sorted set, of the proposer of height 1 round 0."""
    doc, _ = ns.h.make_genesis(n_vals)
    vals = ns.st.state_from_genesis(doc).validators
    return [v.address for v in vals.validators].index(vals.get_proposer().address)


def drain_new_blocks(sub, n, timeout=DEADLINE):
    return [sub.get(timeout=timeout).data.block for _ in range(n)]


def stop(cs, bus):
    cs.stop()
    cs.wait_done(DEADLINE)
    bus.stop()


def block_id_of(ns, rs):
    return ns.BlockID(hash=rs.proposal_block.hash(),
                      parts_header=rs.proposal_block_parts.header())


def send_votes(ns, cs, stubs, vtype, bid, height, round):
    for stub in stubs:
        cs.send_peer_msg(ns.msgs.VoteMessage(stub.sign_vote(vtype, bid, height, round)),
                         f"peer{stub.index}")


# -- tests/test_types.py::TestProposal --------------------------------------------------


def ref_or_port_pv(ns, seed: int):
    if ns is PORT:
        return priv_validator.MockPV(PrivKeyEd25519.generate(bytes([seed]) * 32))
    return rtypes.MockPV(RPrivKeyEd25519.generate(bytes([seed]) * 32))


def some_block_id(ns, seed=b"x"):
    return ns.BlockID(hash=(seed * 32)[:32], parts_header=ns.PartSetHeader(total=1, hash=b"p" * 32))


@PKGS
def test_proposal_sign_and_roundtrip(pkg):
    pv = ref_or_port_pv(pkg, 1)
    prop = pkg.Proposal(height=3, round=1, timestamp_ns=TIME0, block_id=some_block_id(pkg),
                        pol_round=0)
    signed = pv.sign_proposal("test-chain", prop)
    assert pv.get_pub_key().verify_bytes(signed.sign_bytes("test-chain"), signed.signature)
    rt = pkg.Proposal.unmarshal(signed.marshal())
    assert rt == signed


@PKGS
def test_proposal_signature_covers_block_id(pkg):
    import dataclasses

    pv = ref_or_port_pv(pkg, 2)
    prop = pkg.Proposal(height=3, round=1, timestamp_ns=TIME0,
                        block_id=some_block_id(pkg, b"a"), pol_round=-1)
    signed = pv.sign_proposal("test-chain", prop)
    tampered = dataclasses.replace(signed, block_id=some_block_id(pkg, b"b"))
    assert not pv.get_pub_key().verify_bytes(tampered.sign_bytes("test-chain"),
                                             tampered.signature)


def test_proposals_and_heartbeats_sign_to_the_same_bytes():
    """The same proposal and heartbeat, signed by the same key in each
    package: equal sign-bytes, signatures and wire bytes."""
    out = []
    for ns in (REF, PORT):
        pv = ref_or_port_pv(ns, 3)
        prop = pv.sign_proposal("test-chain", ns.Proposal(
            height=7, round=2, timestamp_ns=TIME0 + 5, block_id=some_block_id(ns, b"q"),
            pol_round=1))
        hb = pv.sign_heartbeat("test-chain", ns.Heartbeat(
            validator_address=pv.address, validator_index=3, height=7, round=2, sequence=9))
        out.append((prop.sign_bytes("test-chain"), prop.signature, prop.marshal(),
                    hb.sign_bytes("test-chain"), hb.signature, hb.marshal()))
    assert out[0] == out[1]


# -- tests/test_libs.py::TestEvents, TestAutofile --------------------------------------


@PKGS
def test_events_fire_and_remove(pkg):
    sw = pkg.EventSwitch()
    seen = []
    sw.add_listener_for_event("l1", "step", lambda d: seen.append(d))
    sw.fire_event("step", 1)
    sw.remove_listener("l1")
    sw.fire_event("step", 2)
    assert seen == [1]


@PKGS
def test_autofile_write_rotate_read(pkg, tmp_path):
    head = str(tmp_path / "wal")
    g = pkg.Group(head, head_size_limit=100)
    payload = []
    for i in range(10):
        data = f"entry-{i:02d}-".encode() * 4  # 36 bytes each
        payload.append(data)
        g.write(data)
        g.flush()
        g.maybe_rotate()
    assert g.max_index > 0  # rotated at least once
    r = g.new_reader()
    assert r.read() == b"".join(payload)
    g.close()


@PKGS
def test_autofile_reopen_scans_indices(pkg, tmp_path):
    head = str(tmp_path / "wal")
    g = pkg.Group(head, head_size_limit=50)
    g.write(b"a" * 60)
    g.maybe_rotate()
    g.write(b"b" * 10)
    g.close()
    g2 = pkg.Group(head, head_size_limit=50)
    assert g2.max_index == 1
    r = g2.new_reader()
    assert r.read() == b"a" * 60 + b"b" * 10


@PKGS
def test_autofile_total_size_pruning(pkg, tmp_path):
    g = pkg.Group(str(tmp_path / "wal"), head_size_limit=100, total_size_limit=250)
    for _ in range(10):
        g.write(b"z" * 100)
        g.maybe_rotate()
    assert g.total_size() <= 350  # ~limit + one head
    assert g.min_index > 0  # oldest pruned
    g.close()


# -- the consensus messages' bytes ------------------------------------------------------


def sample_messages(ns):
    """One message of every registered class (the registry's order), built
    from the same values in either package."""
    pv = ref_or_port_pv(ns, 4)
    bid = some_block_id(ns, b"m")
    vote = pv.sign_vote("test-chain", ns.Vote(
        vote_type=ns.SignedMsgType.PRECOMMIT, height=5, round=1, timestamp_ns=TIME0 + 11,
        block_id=bid, validator_address=pv.address, validator_index=2))
    prop = pv.sign_proposal("test-chain", ns.Proposal(
        height=5, round=1, timestamp_ns=TIME0 + 12, block_id=bid, pol_round=-1))
    part = ns.PartSet.from_data(bytes(range(256)) * 3, 128).get_part(2)
    bits = ns.BitArray(11)
    for i in (0, 3, 10):
        bits.set_index(i, True)
    m = ns.msgs
    return [
        m.NewRoundStepMessage(5, 1, 4, 3, 0),
        m.CommitStepMessage(5, bid.parts_header, bits),
        m.ProposalMessage(prop),
        m.ProposalPOLMessage(5, 0, bits),
        m.BlockPartMessage(5, 1, part),
        m.VoteMessage(vote),
        m.HasVoteMessage(5, 1, 2, 7),
        m.VoteSetMaj23Message(5, 1, 1, bid),
        m.VoteSetBitsMessage(5, 1, 2, bid, bits),
        m.TimeoutInfo(1.5, 5, 1, 4),
        m.EndHeightMessage(5),
        m.EventRoundStep(5, 1, 6),
        m.MsgInfo(m.VoteMessage(vote), "peer-x"),
        m.NewValidBlockMessage(5, 1, bid.parts_header, bits, True),
    ]


@pytest.mark.parametrize("i", range(14), ids=[c.__name__ for c in rmsgs._REGISTRY])
def test_consensus_message_bytes_equal_and_cross_decode(i):
    ref_msg, port_msg = sample_messages(REF)[i], sample_messages(PORT)[i]
    assert type(ref_msg).__name__ == rmsgs._REGISTRY[i].__name__
    assert type(port_msg).__name__ == msgs._REGISTRY[i].__name__
    ref_bytes, port_bytes = rmsgs.encode_msg(ref_msg), msgs.encode_msg(port_msg)
    assert ref_bytes == port_bytes
    # each package decodes the other's bytes to a message that re-encodes
    # to them
    assert msgs.encode_msg(msgs.unmarshal_msg(ref_bytes)) == ref_bytes
    assert rmsgs.encode_msg(rmsgs.unmarshal_msg(port_bytes)) == port_bytes
    assert type(msgs.unmarshal_msg(ref_bytes)) is type(port_msg)


def test_an_unknown_message_tag_is_refused_alike():
    bad = bytes([len(msgs._REGISTRY) + 1])
    errs = []
    for m in (rmsgs, msgs):
        with pytest.raises(ValueError) as e:
            m.unmarshal_msg(bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- tests/test_consensus.py::TestSingleValidator ---------------------------------------


@PKGS
def test_single_validator_produces_blocks(pkg):
    """One validator commits heights by itself (propose -> prevote ->
    precommit -> commit -> apply)."""
    cs, stubs, bus = pkg.h.make_consensus_state(1)
    sub = bus.subscribe("test", pkg.query_for_event(pkg.EVENT_NEW_BLOCK))
    cs.start()
    try:
        blocks = drain_new_blocks(sub, 3)
        assert [b.height for b in blocks] == [1, 2, 3]
        assert cs.block_store.height() >= 3
        b2 = cs.block_store.load_block(2)
        assert b2.last_commit.is_commit()
    finally:
        stop(cs, bus)


@PKGS
def test_single_validator_commits_mempool_txs(pkg):
    cs, stubs, bus = pkg.h.make_consensus_state(1)
    sub = bus.subscribe("test", pkg.query_for_event(pkg.EVENT_NEW_BLOCK))
    cs.start()
    try:
        cs.mempool.check_tx(b"k1=v1")
        cs.mempool.check_tx(b"k2=v2")
        found = []
        for _ in range(6):
            blk = sub.get(timeout=DEADLINE).data.block
            found.extend(bytes(t) for t in blk.data.txs)
            if b"k1=v1" in found and b"k2=v2" in found:
                break
        assert b"k1=v1" in found and b"k2=v2" in found
    finally:
        stop(cs, bus)


# -- tests/test_consensus.py::Test4Validators, TestLocking ------------------------------


def started_proposer(ns):
    """Our node as the proposer of height 1, started, in its propose step."""
    cs, stubs, bus = ns.h.make_consensus_state(4, our_index=proposer_index(ns, 4))
    return cs, stubs, bus


@PKGS
def test_4_validators_scripted_quorum_commits(pkg):
    cs, stubs, bus = started_proposer(pkg)
    sub = bus.subscribe("blk", pkg.query_for_event(pkg.EVENT_NEW_BLOCK))
    cs.start()
    try:
        assert pkg.h.wait_for(lambda: cs.get_round_state().step.value >= 3, timeout=DEADLINE)
        assert cs._is_proposer()
        assert pkg.h.wait_for(lambda: cs.get_round_state().proposal_block is not None
                              and cs.get_round_state().height == 1, timeout=DEADLINE), \
            "proposal never completed"
        bid = block_id_of(pkg, cs.get_round_state())
        send_votes(pkg, cs, stubs, pkg.SignedMsgType.PREVOTE, bid, 1, 0)
        send_votes(pkg, cs, stubs, pkg.SignedMsgType.PRECOMMIT, bid, 1, 0)
        assert sub.get(timeout=DEADLINE).data.block.height == 1
        seen = cs.block_store.load_seen_commit(1)
        assert sum(1 for pc in seen.precommits if pc) >= 3
    finally:
        stop(cs, bus)


@PKGS
def test_4_validators_nil_prevotes_advance_round(pkg):
    """3 stubs prevote nil -> we precommit nil -> round advances."""
    cs, stubs, bus = started_proposer(pkg)
    cs.start()
    try:
        assert pkg.h.wait_for(lambda: cs.get_round_state().step.value >= 3, timeout=DEADLINE)
        assert cs._is_proposer()
        send_votes(pkg, cs, stubs, pkg.SignedMsgType.PREVOTE, pkg.BlockID(), 1, 0)
        send_votes(pkg, cs, stubs, pkg.SignedMsgType.PRECOMMIT, pkg.BlockID(), 1, 0)
        assert pkg.h.wait_for(lambda: cs.get_round_state().round >= 1, timeout=DEADLINE), \
            "round did not advance after nil quorum"
        assert cs.get_round_state().height == 1
    finally:
        stop(cs, bus)


@PKGS
def test_4_validators_without_quorum_no_commit(pkg):
    """No stub votes: no 2/3, the height must not advance."""
    cs, stubs, bus = pkg.h.make_consensus_state(4, our_index=0)
    cs.start()
    try:
        time.sleep(2.0)
        assert cs.get_round_state().height == 1
        assert cs.block_store.height() == 0
    finally:
        stop(cs, bus)


@PKGS
def test_lock_held_across_rounds(pkg):
    """After a polka for block B in round 0 (but no commit), we stay locked
    on B and prevote it in round 1 (state.go:997-1002)."""
    cs, stubs, bus = started_proposer(pkg)
    vote_sub = bus.subscribe("votes", pkg.query_for_event(pkg.EVENT_VOTE))
    cs.start()
    try:
        assert pkg.h.wait_for(lambda: cs.get_round_state().step.value >= 3, timeout=DEADLINE)
        assert cs._is_proposer()
        assert pkg.h.wait_for(lambda: cs.get_round_state().proposal_block is not None,
                              DEADLINE)
        bid = block_id_of(pkg, cs.get_round_state())
        # polka: stub prevotes for B, but no precommits (except nil)
        send_votes(pkg, cs, stubs, pkg.SignedMsgType.PREVOTE, bid, 1, 0)
        assert pkg.h.wait_for(lambda: cs.get_round_state().locked_block is not None,
                              timeout=DEADLINE), "did not lock on polka"
        assert cs.get_round_state().locked_block.hash() == bid.hash
        # nil precommits push us to round 1
        send_votes(pkg, cs, stubs, pkg.SignedMsgType.PRECOMMIT, pkg.BlockID(), 1, 0)
        assert pkg.h.wait_for(lambda: cs.get_round_state().round >= 1, timeout=DEADLINE)
        assert cs.get_round_state().locked_block is not None
        deadline = time.monotonic() + DEADLINE
        our_addr = cs.priv_validator.address
        while time.monotonic() < deadline:
            try:
                ev = vote_sub.get(timeout=5.0)
            except queue.Empty:
                break
            v = ev.data.vote
            if (v.validator_address == our_addr and v.round == 1
                    and v.vote_type == pkg.SignedMsgType.PREVOTE):
                assert v.block_id.hash == bid.hash, "prevoted non-locked block"
                return
        raise AssertionError("never saw our round-1 prevote")
    finally:
        stop(cs, bus)


# -- the vote feed against the serial path ------------------------------------------------

PARITY_HEIGHTS = 3
DOUBLE_SIGN_HEIGHT = 2


def drive_heights(ns, batched: bool, n_heights: int = PARITY_HEIGHTS):
    """4 validators, our node at index 1, ``n_heights`` heights: each height
    proposed by our node or a stub proposer (``decide_proposal``, with one
    fresh tx in the mempool first), then every stub's prevote, one stub's
    conflicting nil prevote at DOUBLE_SIGN_HEIGHT, and every stub's
    precommit. Returns what each height committed and the evidence."""
    cs, stubs, bus = ns.h.make_consensus_state(4, our_index=1,
                                               config=ns.config(timeout_propose=10.0))
    by_addr = {s.address: s for s in stubs}
    feed = ns.vote_feed() if batched else None
    if feed is not None:
        cs.set_vote_feed(feed)
    cs.mempool.check_tx(b"k0=v0")
    cs.start()
    try:
        for h in range(1, n_heights + 1):
            assert ns.h.wait_for(lambda: cs.get_round_state().height == h, DEADLINE), \
                f"height {h} never started"
            proposer = cs.get_round_state().validators.get_proposer().address
            if proposer != cs.priv_validator.address:
                stub = by_addr[proposer]
                cs.mempool.check_tx(b"k%d=v%d" % (h, h))
                prop, block, parts = ns.decide_proposal(cs, stub, h, 0)
                cs.set_proposal_and_block(prop, block, parts, f"peer{stub.index}")
            assert ns.h.wait_for(
                lambda: cs.get_round_state().proposal_block is not None
                and cs.get_round_state().height == h, DEADLINE), f"no proposal at {h}"
            bid = block_id_of(ns, cs.get_round_state())
            send_votes(ns, cs, stubs, ns.SignedMsgType.PREVOTE, bid, h, 0)
            if h == DOUBLE_SIGN_HEIGHT:
                cheat = stubs[-1]
                cs.send_peer_msg(ns.msgs.VoteMessage(
                    cheat.sign_vote(ns.SignedMsgType.PREVOTE, ns.BlockID(), h, 0)),
                    f"peer{cheat.index}")
            send_votes(ns, cs, stubs, ns.SignedMsgType.PRECOMMIT, bid, h, 0)
            assert ns.h.wait_for(lambda: cs.block_store.height() >= h, DEADLINE), \
                f"height {h} never committed"
        assert ns.h.wait_for(lambda: cs.get_state().last_block_height >= n_heights, DEADLINE)
    finally:
        stop(cs, bus)
        if feed is not None:
            feed.close()
            feed.join(DEADLINE)
    out = {
        "commits": [(h, cs.block_store.load_seen_commit(h).round(),
                     cs.block_store.load_block(h + 1).header.app_hash
                     if h < n_heights else cs.get_state().app_hash)
                    for h in range(1, n_heights + 1)],
        "txs": [sorted(bytes(t) for t in cs.block_store.load_block(h).data.txs)
                for h in range(1, n_heights + 1)],
        "evidence": [(type(ev).__name__, ev.height, ev.address) for ev in cs.evpool.added],
    }
    return out, cs, feed


def test_the_vote_feed_commits_what_the_serial_path_commits():
    runs = {}
    for ns in (REF, PORT):
        for batched in (False, True):
            runs[(ns.name, batched)], cs, feed = drive_heights(ns, batched)
            if batched:
                assert feed.votes_in >= 3 * 2 * PARITY_HEIGHTS
                if ns is PORT:
                    assert cs.serial_votes["own"] > 0
                    assert cs.serial_votes["no_feed"] == 0
                    assert cs.serial_votes["unknown_verdict"] == 0
                    assert cs.device_fault is None
            elif ns is PORT:
                assert cs.serial_votes["no_feed"] > 0
    want = runs[("reference", False)]
    assert [r for _, r, _ in want["commits"]] == [0] * PARITY_HEIGHTS
    for (name, batched), got in runs.items():
        assert got == want, (name, batched)
    # the double-sign became evidence at its height, on every path
    assert len(want["evidence"]) == 1
    kind, height, _ = want["evidence"][0]
    assert (kind, height) == ("DuplicateVoteEvidence", DOUBLE_SIGN_HEIGHT)
    assert sum(len(t) for t in want["txs"]) >= 1


def test_decide_proposal_signs_what_the_node_would_propose():
    """The stub proposer's proposal verifies under its key and names the
    block and parts it returns; the node accepts it and completes the
    block."""
    cs, stubs, bus = harness.make_consensus_state(4, our_index=1,
                                                  config=_port_config(timeout_propose=10.0))
    cs.start()
    try:
        assert harness.wait_for(lambda: cs.get_round_state().height == 1, DEADLINE)
        proposer = cs.get_round_state().validators.get_proposer()
        stub = next(s for s in stubs if s.address == proposer.address)
        prop, block, parts = harness.decide_proposal(cs, stub, 1, 0)
        assert proposer.pub_key.verify_bytes(prop.sign_bytes(harness.CHAIN_ID), prop.signature)
        assert prop.block_id.hash == block.hash() and prop.block_id.parts_header == parts.header()
        assert block.header.proposer_address == stub.address and prop.pol_round == -1
        cs.set_proposal_and_block(prop, block, parts, f"peer{stub.index}")
        assert harness.wait_for(lambda: cs.get_round_state().proposal_block is not None,
                                DEADLINE)
        assert cs.get_round_state().proposal_block.hash() == block.hash()
    finally:
        stop(cs, bus)


# -- the fast-sync hand-off -------------------------------------------------------------


class SwitchToConsensus:
    """A test-only consensus reactor: the three calls of the reference's
    ``ConsensusReactor.switch_to_consensus`` (consensus/reactor.py:354-366)
    on the port's ``ConsensusState``; the real reactor needs p2p."""

    def __init__(self, cs):
        self.cs = cs
        self.switched = threading.Event()
        self.blocks_synced = None

    def switch_to_consensus(self, state, blocks_synced: int = 0) -> None:
        self.cs.reconstruct_last_commit_if_needed(state)
        self.cs.update_to_state(state)
        if blocks_synced > 0:
            self.cs.skip_wal_catchup = True
        self.cs.start()
        self.blocks_synced = blocks_synced
        self.switched.set()


def test_a_fast_synced_state_hands_over_and_commits_the_next_height():
    """The port's ``BlockchainReactor`` syncs a 4-validator chain from a
    loopback peer into a node's executor and store and hands its state to
    the node's ``ConsensusState``, which then commits the next height with
    the other validators' stub votes."""
    fx = chain.build_chain(n_vals=4, n_heights=6, chain_id=harness.CHAIN_ID,
                           verifier=HostBatchVerifier())
    # as in the reference (and Go's SwitchToConsensus), updateToState clears
    # the LastCommit that reconstructLastCommit set, so the node cannot
    # propose the first height after the switch: a stub proposes it
    vals = st_types.state_from_genesis(fx.genesis).validators.copy()
    vals.increment_accum(fx.height - 1)
    proposer = vals.get_proposer().address
    ours = next(i for i, pv in enumerate(fx.pvs) if pv.address != proposer)
    cs, bus = harness.make_cs_from_genesis(fx.genesis, fx.pvs[ours],
                                           config=_port_config(timeout_propose=10.0))
    stubs = [harness.ValidatorStub(pv, i) for i, pv in enumerate(fx.pvs) if i != ours]
    cons = SwitchToConsensus(cs)
    bc = reactor.BlockchainReactor(cs.get_state(), cs.block_exec, cs.block_store,
                                   consensus_reactor=cons)
    sw = LoopbackSwitch(bc)
    sw.connect(ServingPeer("server", fx.block_store))
    bc.start()
    try:
        assert cons.switched.wait(DEADLINE), f"no switch (store {cs.block_store.height()})"
    finally:
        bc.stop()
    try:
        top = fx.height - 1
        assert cons.blocks_synced == top and cs.block_store.height() == top
        assert cs.get_round_state().height == fx.height
        for h in range(1, top + 1):
            assert cs.block_store.load_block(h).hash() == fx.block_store.load_block(h).hash()
        h = fx.height
        assert cs.get_round_state().validators.get_proposer().address == proposer
        stub = next(s for s in stubs if s.address == proposer)
        prop, block, parts = harness.decide_proposal(cs, stub, h, 0)
        cs.set_proposal_and_block(prop, block, parts, f"peer{stub.index}")
        assert harness.wait_for(lambda: cs.get_round_state().proposal_block is not None,
                                DEADLINE)
        bid = block_id_of(PORT, cs.get_round_state())
        send_votes(PORT, cs, stubs, core.SignedMsgType.PREVOTE, bid, h, 0)
        send_votes(PORT, cs, stubs, core.SignedMsgType.PRECOMMIT, bid, h, 0)
        assert harness.wait_for(lambda: cs.block_store.height() >= h, DEADLINE), \
            f"height {h} never committed"
        assert cs.get_state().last_block_height >= h and cs.device_fault is None
        assert sw.stopped == []
    finally:
        stop(cs, bus)


# -- libs/metrics.ConsensusMetrics --------------------------------------------------------


def test_consensus_metrics_carry_the_references_names_labels_and_buckets():
    from tendermint_tpu.libs.metrics import NodeMetrics
    from tendermint_tpu_torch.libs.metrics import ConsensusMetrics

    ref, port = NodeMetrics(), ConsensusMetrics()
    attrs = ("rounds", "step_duration", "vote_arrival_latency", "wal_append_seconds",
             "wal_fsync_seconds")
    for a in attrs:
        r, p = getattr(ref, a), getattr(port, a)
        assert (type(p).__name__, p.name, p.help, p.label_names) == \
            (type(r).__name__, r.name, r.help, r.label_names), a
        assert list(getattr(p, "buckets", ())) == list(getattr(r, "buckets", ())), a


def test_the_state_machine_and_the_wal_write_the_consensus_metrics(tmp_path):
    """One validator over two heights with ``ConsensusMetrics``: the round
    gauge, every step left, our votes' latency and the WAL's appends and
    fsyncs are observed."""
    from tendermint_tpu_torch.consensus.wal import WAL
    from tendermint_tpu_torch.libs.metrics import ConsensusMetrics

    m = ConsensusMetrics()
    cs, _, bus = harness.make_consensus_state(1, wal=WAL(str(tmp_path / "wal"), metrics=m))
    cs.metrics = m
    sub = bus.subscribe("blk", events.query_for_event(events.EVENT_NEW_BLOCK))
    cs.start()
    try:
        drain_new_blocks(sub, 2)
    finally:
        stop(cs, bus)
    text = m.registry.expose_text()
    for name in ("consensus_rounds", "consensus_step_duration_seconds_count{step=\"PROPOSE\"}",
                 "consensus_vote_arrival_latency_seconds_count{type=\"precommit\"}",
                 "consensus_wal_append_seconds_count", "consensus_wal_fsync_seconds_count"):
        assert name in text, name
