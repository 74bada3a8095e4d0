"""The consensus state machine's device-fault contract
(``consensus/state.py``), on a faked card and off it.

On the card a vote feed's flush that fails (the guard's
``DeviceDispatchError`` out of a ``GuardedBatchVerifier`` whose device is
CUDA), or a ticket that outlives the pump's wait, halts the state machine:
``device_fault`` is set, no vote of that flush is added or verified on the
host, the receive routine stops, the WAL and the ticker are stopped, and
the block store and the state stay at the last committed height. A
``DeviceDispatchError`` or ``DeviceAuditMismatch`` out of
``validate_block`` (the executor's verifier on the card) halts it the same
way in ``enter_prevote`` (where the reference prevotes nil), in
``enter_precommit`` (where it wraps the error in ``ConsensusError``) and in
``_finalize_commit``. Off the card the reference's behaviour holds: an
unknown verdict is verified serially on the host, an invalid proposal is
prevoted nil, and a failure in the other two sites stops the receive
routine with no ``device_fault``. Every wait is bounded.
"""

import pytest
import torch

from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.consensus import wal
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state import validation
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.types import events
from tendermint_tpu_torch.types import vote as tvote
from tendermint_tpu_torch.types.core import SignedMsgType

from tests.test_torch_consensus import PORT, block_id_of, proposer_index, send_votes
from tests.test_torch_fastsync_fault import guarded

DEADLINE = 60.0


@pytest.fixture(autouse=True)
def _verifiers():
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield root
    verify_root.reset_verify()


@pytest.fixture
def host_verifies(monkeypatch):
    """Every single-vote host verify, as (height, validator index)."""
    got = []
    real = tvote.Vote.verify

    def verify(self, chain_id, pub_key):
        got.append((self.height, self.validator_index))
        return real(self, chain_id, pub_key)

    monkeypatch.setattr(tvote.Vote, "verify", verify)
    return got


def vote_height(msg: bytes) -> int:
    """The height in a vote's sign-bytes (a type byte, then fixed64)."""
    return int.from_bytes(msg[1:9], "little", signed=True)


def at_height(h0):
    return lambda msgs: any(vote_height(m) >= h0 for m in msgs)


class HungFeed:
    """A vote feed that claims the card and never resolves a ticket."""

    device = torch.device("cuda")

    def __init__(self):
        self.tickets = []

    def submit(self, group_key, pub, msg, sig, power=1, total=1, urgent=False):
        ticket = planner.VoteTicket()
        self.tickets.append(ticket)
        return ticket


class ErrFeed:
    """A vote feed off the card whose every ticket fails."""

    device = torch.device("cpu")

    def submit(self, group_key, pub, msg, sig, power=1, total=1, urgent=False):
        ticket = planner.VoteTicket()
        ticket._resolve(err=RuntimeError("flaky feed"))
        return ticket


class OnCard:
    """An executor verifier that claims the card (only ``on_card`` is read:
    validation itself is stubbed)."""

    on_card = True


def node(tmp_path, our_index=None):
    """The port's node as the proposer of height 1 (or at ``our_index``),
    on a real WAL."""
    idx = proposer_index(PORT, 4) if our_index is None else our_index
    w = wal.WAL(str(tmp_path / "cs.wal" / "wal"))
    cs, stubs, bus = harness.make_consensus_state(
        4, our_index=idx, wal=w, config=PORT.config(timeout_propose=10.0))
    return cs, stubs, bus, w


def stop(cs, bus):
    if cs.is_running:
        cs.stop()
    assert cs._done.wait(DEADLINE)
    bus.stop()


def run_height(cs, stubs, h, precommit=True):
    assert harness.wait_for(lambda: cs.get_round_state().height == h, DEADLINE)
    proposer = cs.get_round_state().validators.get_proposer().address
    if proposer != cs.priv_validator.address:
        stub = next(s for s in stubs if s.address == proposer)
        prop, block, parts = harness.decide_proposal(cs, stub, h, 0)
        cs.set_proposal_and_block(prop, block, parts, f"peer{stub.index}")
    assert harness.wait_for(lambda: cs.get_round_state().proposal_block is not None
                            and cs.get_round_state().height == h, DEADLINE)
    bid = block_id_of(PORT, cs.get_round_state())
    send_votes(PORT, cs, stubs, SignedMsgType.PREVOTE, bid, h, 0)
    if precommit:
        send_votes(PORT, cs, stubs, SignedMsgType.PRECOMMIT, bid, h, 0)
    return bid


def stub_votes_at(cs, stubs, h):
    """The stubs' votes of height ``h`` in the node's vote sets."""
    if cs.rs.height != h:
        return None
    idx = {s.index for s in stubs}
    n = 0
    for vs in (cs.rs.votes.prevotes(0), cs.rs.votes.precommits(0)):
        n += sum(1 for i in idx if vs.get_by_index(i) is not None)
    return n


def assert_halted(cs, w, height, err=brk.DeviceDispatchError):
    assert cs._done.wait(DEADLINE), "the receive routine did not stop"
    assert isinstance(cs.device_fault, err), repr(cs.device_fault)
    assert not w.is_running and not cs.timeout_ticker.is_running
    assert cs.block_store.height() == height
    assert cs.get_state().last_block_height == height


# -- the vote feed ----------------------------------------------------------------------


def test_on_the_card_a_failed_flush_halts_consensus(tmp_path, host_verifies):
    cs, stubs, bus, w = node(tmp_path)
    feed = planner.VoteFeed(window_s=0.002, device="cpu", verifier=guarded("raise",
                                                                             at_height(2)))
    feed.device = torch.device("cuda")  # the guarded verifier's device is CUDA too
    assert brk.on_card(feed)
    cs.set_vote_feed(feed)
    cs.start()
    try:
        run_height(cs, stubs, 1)  # through the feed on the "card"
        assert harness.wait_for(lambda: cs.block_store.height() >= 1, DEADLINE)
        run_height(cs, stubs, 2, precommit=False)  # the prevotes' flush fails
        assert_halted(cs, w, 1)
        assert cs.device_fault.reason == "error"
        assert stub_votes_at(cs, stubs, 2) == 0
        stub_idx = {s.index for s in stubs}
        assert not [v for v in host_verifies if v[0] == 2 and v[1] in stub_idx]
        assert cs.serial_votes["unknown_verdict"] == 0
        assert feed.votes_in >= 6 + 3
    finally:
        stop(cs, bus)
        feed.close()
        feed.join(DEADLINE)


def test_on_the_card_an_overdue_ticket_halts_consensus(tmp_path, host_verifies):
    cs, stubs, bus, w = node(tmp_path)
    feed = HungFeed()
    cs.set_vote_feed(feed)
    cs.vote_ticket_timeout_s = 0.2
    cs.start()
    try:
        run_height(cs, stubs, 1, precommit=False)
        assert_halted(cs, w, 0)
        assert cs.device_fault.reason == "timeout"
        assert isinstance(cs.device_fault.__cause__, TimeoutError)
        assert len(feed.tickets) == 3 and stub_votes_at(cs, stubs, 1) == 0
        stub_idx = {s.index for s in stubs}
        assert not [v for v in host_verifies if v[1] in stub_idx]
    finally:
        stop(cs, bus)


def test_off_the_card_an_unknown_verdict_is_verified_serially(tmp_path, host_verifies):
    """The reference's pump: a failed ticket off the card re-verifies the
    vote on the host, and the height commits."""
    cs, stubs, bus, w = node(tmp_path)
    cs.set_vote_feed(ErrFeed())
    cs.start()
    try:
        run_height(cs, stubs, 1)
        assert harness.wait_for(lambda: cs.block_store.height() >= 1, DEADLINE)
        assert cs.device_fault is None
        assert cs.serial_votes["unknown_verdict"] >= 3
        stub_idx = {s.index for s in stubs}
        assert len({v for v in host_verifies if v[1] in stub_idx}) == 3
    finally:
        stop(cs, bus)


# -- validate_block -----------------------------------------------------------------------

SITES = {"enter_prevote": 1, "enter_precommit": 2, "finalize_commit": 3}


def failing_validation(cs, fail_at: int, err: Exception, card: bool):
    """``validate_block`` of the node's executor raising ``err`` on its
    ``fail_at``-th call (the earlier ones validate for real)."""
    ex = cs.block_exec
    ex.verifier = OnCard() if card else None
    calls = []

    def validate_block(state, block, trusted_last_commit=False):
        calls.append(block.height)
        if len(calls) == fail_at:
            raise err
        validation.validate_block(ex.db, state, block, verifier=None)

    ex.validate_block = validate_block
    return calls


def our_votes(sub, addr):
    out = []
    while not sub.queue.empty():
        v = sub.get(timeout=1).data.vote
        if v.validator_address == addr:
            out.append((int(v.vote_type), v.block_id.hash))
    return out


@pytest.mark.parametrize("site", sorted(SITES))
@pytest.mark.parametrize("err", [brk.DeviceDispatchError("error", "validate_block"),
                                 brk.DeviceAuditMismatch("audit_mismatch", "validate_block")],
                         ids=["dispatch", "audit"])
def test_on_the_card_a_device_fault_in_validation_halts_consensus(tmp_path, site, err):
    cs, stubs, bus, w = node(tmp_path)
    calls = failing_validation(cs, SITES[site], err, card=True)
    vote_sub = bus.subscribe("votes", events.query_for_event(events.EVENT_VOTE))
    cs.start()
    try:
        run_height(cs, stubs, 1, precommit=site == "finalize_commit")
        assert_halted(cs, w, 0, type(err))
        assert cs.device_fault is err  # unwrapped
        assert len(calls) == SITES[site]
        mine = our_votes(vote_sub, cs.priv_validator.address)
        # no nil vote of ours: the fault is no invalid block
        assert all(h != b"" for _, h in mine), mine
        types = [t for t, _ in mine]
        if site == "finalize_commit":
            # the stubs' precommits may complete the commit before our own
            # precommit leaves the queue
            assert types in ([int(SignedMsgType.PREVOTE)],
                             [int(SignedMsgType.PREVOTE), int(SignedMsgType.PRECOMMIT)])
        else:
            assert types == ([] if site == "enter_prevote" else [int(SignedMsgType.PREVOTE)])
    finally:
        stop(cs, bus)


@pytest.mark.parametrize("site", sorted(SITES))
def test_off_the_card_validation_errors_keep_the_references_behaviour(tmp_path, site):
    """Off the card a ``DeviceDispatchError`` is an error like any other:
    an invalid proposal is prevoted nil and consensus goes on; in
    ``enter_precommit`` and ``_finalize_commit`` the receive routine stops
    (the reference's CONSENSUS FAILURE) with no ``device_fault``."""
    cs, stubs, bus, w = node(tmp_path)
    failing_validation(cs, SITES[site], brk.DeviceDispatchError("error", "validate_block"),
                       card=False)
    vote_sub = bus.subscribe("votes", events.query_for_event(events.EVENT_VOTE))
    cs.start()
    try:
        if site == "enter_prevote":
            assert harness.wait_for(lambda: cs.get_round_state().proposal_block is not None,
                                    DEADLINE)
            assert harness.wait_for(
                lambda: cs.rs.votes.prevotes(0).get_by_index(proposer_index(PORT, 4))
                is not None, DEADLINE)
            mine = our_votes(vote_sub, cs.priv_validator.address)
            assert mine[0] == (int(SignedMsgType.PREVOTE), b"")  # prevoted nil
            assert not cs._done.is_set() and cs.device_fault is None
        else:
            run_height(cs, stubs, 1, precommit=site == "finalize_commit")
            assert cs._done.wait(DEADLINE)
            assert cs.device_fault is None
            assert cs.block_store.height() == 0
    finally:
        stop(cs, bus)
