"""ConsensusState: the Tendermint BFT state machine (ref
consensus/state.go), the port's copy of the reference package's
``consensus/state.py``.

As in the reference:
  * ONE receive thread owns the RoundState; every input (peer msg, own msg,
    timeout, txs-available) is WAL-logged before processing (own msgs with
    fsync);
  * enter* transitions guard on (height, round, step); locking, POL and
    valid-block rules mirror state.go:1058-1180 and the addVote unlock path
    (:1528-1668);
  * with a vote feed set (``set_vote_feed``), a live peer vote at the
    current height is prevalidated and its signature parked in the feed
    (``parallel/planner.VoteFeed``: on the card the installed guarded
    verifier, K1 + K2, K3); a pump thread re-enters each verdict into the
    receive queue in arrival order and the vote is added with
    ``verified=True``. Own votes, WAL replay, other heights and last-commit
    stragglers stay serial (``serial_votes`` counts them by reason);
  * commits finalize through ``BlockExecutor.apply_block``, which checks
    the block's LastCommit through the same verifier. The finalization is
    traced as ``consensus.finalize_commit``.

Where the port differs: the reference turns a failed or overdue vote
ticket into an unknown verdict that ``_handle_vote_verdict`` re-verifies
serially on the host, prevotes nil on any error of ``validate_block`` in
``enter_prevote``, and wraps one in ``enter_precommit`` in
``ConsensusError``. On the card (``breaker.on_card`` of the vote feed; for
validation, the verifier that ``validate_block`` calls) each of these is a
device fault: ``device_fault`` is set to it, no vote of the failed flush is
added or verified on the host, the receive routine stops, the WAL and the
ticker are stopped, and the block store and the state stay at the last
committed height (a ``DeviceDispatchError`` or ``DeviceAuditMismatch``
out of ``_do_finalize_commit`` halts the same way). Off the card the
reference's behaviour stays. And a conflicting vote that the vote set
still adds (a peer claimed +2/3 for its block) is acted on before it
becomes evidence, as Go's ``addVote`` does (``_add_counting_conflict``);
the reference returns at the conflict, and a node whose +2/3 for the
committed block needs that vote never commits it.

Each state owns the reference's per-height instruments: ``flight`` (the
lifecycle stamps, ``consensus/flight.py``), ``critpath`` (each committed
height's waterfall, ``libs/critpath.py``, which joins the WAL's height
costs and the vote feed's dispatch entries) and ``quorumtrace`` (the
quorum completion curves, ``libs/quorumtrace.py``, which joins the feed's
flush ledger). They read what consensus did and decide nothing; with the
recorder off every hook is one attribute check, and an analyzer's error is
counted, never raised.
"""

from __future__ import annotations

import collections
import copy
import queue
import threading
import time
import traceback
from typing import Callable, Optional, Tuple

from tendermint_tpu_torch.consensus.cstypes import (
    HeightVoteSet,
    RoundState,
    RoundStepType,
)
from tendermint_tpu_torch.consensus.messages import (
    BlockPartMessage,
    EndHeightMessage,
    EventRoundStep,
    MsgInfo,
    ProposalMessage,
    TimeoutInfo,
    VoteMessage,
)
from tendermint_tpu_torch.consensus.flight import FlightRecorder
from tendermint_tpu_torch.consensus.replay import catchup_replay
from tendermint_tpu_torch.consensus.ticker import TimeoutTicker
from tendermint_tpu_torch.consensus.wal import NilWAL
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.libs import fail, trace
from tendermint_tpu_torch.libs.critpath import CritPath
from tendermint_tpu_torch.libs.events import EventSwitch
from tendermint_tpu_torch.libs.quorumtrace import QuorumTrace
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.state.execution import _verifier_on_card
from tendermint_tpu_torch.types.block import Block, Commit
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.events import (
    EVENT_COMPLETE_PROPOSAL,
    EVENT_LOCK,
    EVENT_NEW_ROUND,
    EVENT_NEW_ROUND_STEP,
    EVENT_POLKA,
    EVENT_RELOCK,
    EVENT_TIMEOUT_PROPOSE,
    EVENT_TIMEOUT_WAIT,
    EVENT_UNLOCK,
    EVENT_VALID_BLOCK,
    EVENT_VOTE,
    EventBus,
)
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.part_set import PartSet, PartSetError
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import (
    ErrVoteConflictingVotes,
    ErrVoteInvalidSignature,
    Vote,
    VoteError,
)
from tendermint_tpu_torch.types.vote_set import VoteSet


class ErrVoteHeightMismatch(VoteError):
    pass


class ErrInvalidProposalPOLRound(Exception):
    pass


class ErrInvalidProposalSignature(Exception):
    pass


class ConsensusError(Exception):
    pass



def _add_counting_conflict(add, *args, **kwargs):
    """``(added, conflict)`` of one ``VoteSet.add_vote``: a conflicting vote
    raises ``ErrVoteConflictingVotes``, but when a peer claimed +2/3 for its
    block the vote set still adds it (``e.added``), and the quorum it may
    complete must be acted on before the conflict becomes evidence, as Go's
    ``addVote`` goes on when ``added`` (state.go). The reference package
    returns at the raise: a node whose only path to +2/3 for the committed
    block is that vote never commits it, and a net with a double-signer
    stalls at that height. A conflict that added nothing raises here."""
    try:
        return add(*args, **kwargs), None
    except ErrVoteConflictingVotes as e:
        if not getattr(e, "added", False):
            raise
        return True, e

class ConsensusState(BaseService):
    def __init__(
        self,
        config,  # ConsensusConfig
        state,  # sm.State (copied)
        block_exec,  # BlockExecutor
        block_store,  # BlockStore
        mempool,
        evpool,
        wal: Optional[object] = None,
        logger=None,
        metrics=None,  # libs/metrics.ConsensusMetrics or None
    ):
        super().__init__("consensus.State", logger)
        self.config = config
        self.block_exec = block_exec
        self.block_store = block_store
        self.mempool = mempool
        self.evpool = evpool
        self.metrics = metrics
        # per-height lifecycle ledger; disabled unless TM_FLIGHT /
        # [instrumentation] flight_recorder turns it on
        self.flight = FlightRecorder.from_env()
        # commit-latency waterfall analyzer; piggybacks on the flight
        # recorder's enable gate (no stamps -> nothing to analyze)
        self.critpath = CritPath(metrics=metrics)
        # quorum-formation analyzer: per-height time-to-1/3/2/3 curves and
        # gossip-waste ledger off the same flight stamps
        self.quorumtrace = QuorumTrace(metrics=metrics)
        # wall-clock source for proposal/vote timestamps and latency
        # accounting; the sim harness swaps in a skewed/frozen clock
        self.now_ns: Callable[[], int] = time.time_ns
        # step-duration accounting: each _new_step observes the wall time
        # spent in the step being LEFT (None until the first transition)
        self._step_started: Optional[float] = None
        self._step_leaving: Optional[str] = None
        # messages re-fed from the WAL on the last start (crash recovery)
        self.wal_replayed = 0

        self.priv_validator = None

        self.rs = RoundState()
        self.state = None  # sm.State

        self._mtx = threading.RLock()
        # unified input queue: ('peer'|'internal'|'timeout'|'txs', payload)
        self._queue: "queue.Queue[Tuple[str, object]]" = queue.Queue(maxsize=1000)
        self.timeout_ticker = TimeoutTicker()
        self.wal = wal if wal is not None else NilWAL()
        self.event_bus: Optional[EventBus] = None
        self.evsw = EventSwitch()
        self.n_steps = 0
        self.replay_mode = False
        self.skip_wal_catchup = False  # set after fast sync (reactor.go:116)
        self._done = threading.Event()

        # live-vote micro-batcher (parallel/planner.VoteFeed, wired by the
        # node when [verify] vote_batch_window_ms > 0).  Peer votes that
        # clear structural prevalidation park in the feed; a pump thread
        # waits verdict tickets in submit order and re-enters them into
        # the receive queue as 'vote_verdict' items, so batched votes
        # apply on the consensus thread in arrival order.
        self._vote_feed = None
        # FIFO of (vote, peer_id, ticket, group_key, block_key, power)
        self._vote_pump_q: "queue.Queue" = queue.Queue()
        self._vote_pump_started = False
        # power submitted-but-unresolved per ((h, r, type), block_key):
        # the quorum-flush heuristic counts it toward +2/3 so a
        # quorum-completing vote never waits out the deadline
        self._vote_pending_power: dict = {}
        # how long the pump waits for a ticket (the reference's 60 s)
        self.vote_ticket_timeout_s = 60.0
        # the votes that took the serial path, by reason: WAL replay
        # ("replay"), our own ("own"), no feed set ("no_feed"), a last-commit
        # straggler ("last_commit"), another height ("height"), a feed that
        # refused the submit ("feed_error"), a verdict that came after its
        # height moved on and is re-verified as the reference does
        # ("late_verdict"), an unknown verdict off the card ("unknown_verdict")
        self.serial_votes = collections.Counter()
        # on the card: the guarded dispatch's failure that halted the
        # state machine (None while it runs)
        self.device_fault: Optional[BaseException] = None

        # test hooks (state.go:113-115, byzantine_test)
        self.decide_proposal: Callable = self._default_decide_proposal
        self.do_prevote: Callable = self._default_do_prevote
        self.set_proposal_fn: Callable = self._default_set_proposal

        self.update_to_state(state)
        self.reconstruct_last_commit_if_needed(state)

    # wiring ----------------------------------------------------------------
    def set_event_bus(self, bus: EventBus) -> None:
        self.event_bus = bus

    def set_priv_validator(self, pv) -> None:
        with self._mtx:
            self.priv_validator = pv

    def set_timeout_ticker(self, ticker) -> None:
        with self._mtx:
            self.timeout_ticker = ticker

    def set_vote_feed(self, feed) -> None:
        """Enable the vote micro-batcher: live peer votes verify through
        `feed` (a planner VoteFeed) instead of serially inside add_vote.
        Pass None to return to the serial path.  The caller owns the feed's
        lifecycle (close it after stopping this service)."""
        with self._mtx:
            self._vote_feed = feed
            if feed is not None and not self._vote_pump_started:
                self._vote_pump_started = True
                threading.Thread(
                    target=self._vote_verdict_pump,
                    name="consensus-vote-pump",
                    daemon=True,
                ).start()

    # getters ---------------------------------------------------------------
    def get_round_state(self) -> RoundState:
        with self._mtx:
            return copy.copy(self.rs)

    def get_state(self):
        with self._mtx:
            return self.state.copy()

    def get_last_height(self) -> int:
        with self._mtx:
            return self.rs.height - 1

    # lifecycle -------------------------------------------------------------
    def on_start(self) -> None:
        if hasattr(self.wal, "start"):
            self.wal.start()
        # WAL catchup replay happens BEFORE processing new messages
        if not isinstance(self.wal, NilWAL) and not self.skip_wal_catchup:
            self.wal_replayed = catchup_replay(self, self.rs.height)
        self.timeout_ticker.start()
        threading.Thread(target=self._ticker_forwarder, daemon=True).start()
        threading.Thread(target=self._receive_routine, daemon=True).start()
        if self.mempool is not None and self.mempool.txs_available() is not None:
            threading.Thread(target=self._txs_watcher, daemon=True).start()
        self._schedule_round_0(self.rs)

    def on_stop(self) -> None:
        try:
            self.timeout_ticker.stop()
        except Exception:
            pass

    def wait_done(self, timeout=None) -> None:
        self._done.wait(timeout)

    # message input ---------------------------------------------------------
    def send_peer_msg(self, msg, peer_id: str) -> None:
        self._queue.put(("peer", MsgInfo(msg, peer_id)))

    def send_internal(self, msg) -> None:
        mi = MsgInfo(msg, "")
        try:
            self._queue.put_nowait(("internal", mi))
        except queue.Full:
            threading.Thread(
                target=lambda: self._queue.put(("internal", mi)), daemon=True
            ).start()

    def set_proposal(self, proposal: Proposal, peer_id: str = "") -> None:
        if peer_id == "":
            self.send_internal(ProposalMessage(proposal))
        else:
            self.send_peer_msg(ProposalMessage(proposal), peer_id)

    def add_proposal_block_part(self, height: int, round: int, part, peer_id: str = "") -> None:
        msg = BlockPartMessage(height, round, part)
        if peer_id == "":
            self.send_internal(msg)
        else:
            self.send_peer_msg(msg, peer_id)

    def add_vote_msg(self, vote: Vote, peer_id: str = "") -> None:
        if peer_id == "":
            self.send_internal(VoteMessage(vote))
        else:
            self.send_peer_msg(VoteMessage(vote), peer_id)

    def set_proposal_and_block(self, proposal, block, parts, peer_id: str = "") -> None:
        self.set_proposal(proposal, peer_id)
        for i in range(parts.total):
            self.add_proposal_block_part(proposal.height, proposal.round, parts.get_part(i), peer_id)

    # internals -------------------------------------------------------------
    def _ticker_forwarder(self) -> None:
        while not self.quit_event.is_set():
            try:
                ti = self.timeout_ticker.chan().get(timeout=0.1)
            except queue.Empty:
                continue
            self._queue.put(("timeout", ti))

    def _txs_watcher(self) -> None:
        while not self.quit_event.is_set():
            ev = self.mempool.txs_available()
            if ev is None:
                return
            if ev.wait(timeout=0.1):
                ev.clear()
                self._queue.put(("txs", None))

    def _update_height(self, height: int) -> None:
        self.rs.height = height
        # tag subsequent WAL appends/fsyncs with the height they belong to
        # (custom WALs in tests may not implement the height-join surface)
        set_h = getattr(self.wal, "set_height", None)
        if set_h is not None:
            set_h(height)

    def _update_round_step(self, round: int, step: RoundStepType) -> None:
        self.rs.round = round
        self.rs.step = step

    def _schedule_round_0(self, rs: RoundState) -> None:
        sleep = rs.start_time - time.monotonic()
        self._schedule_timeout(sleep, rs.height, 0, RoundStepType.NEW_HEIGHT)

    def _schedule_timeout(self, duration: float, height: int, round: int, step: RoundStepType) -> None:
        self.timeout_ticker.schedule_timeout(
            TimeoutInfo(duration=duration, height=height, round=round, step=int(step))
        )

    def _publish_rs_event(self, event_type: str) -> None:
        if self.event_bus is not None:
            self.event_bus.publish_event_round_state(
                event_type, self.rs.height, self.rs.round, self.rs.step.name,
                self.get_round_state(),
            )

    def _new_step(self) -> None:
        now = time.monotonic()
        if self.metrics is not None and self._step_started is not None:
            dt = now - self._step_started
            if dt >= 0 and self._step_leaving is not None:
                self.metrics.step_duration.observe(dt, (self._step_leaving,))
        self._step_started = now
        self._step_leaving = self.rs.step.name
        trace.instant(
            "consensus.step",
            height=self.rs.height, round=self.rs.round, step=self.rs.step.name,
        )
        self.wal.write(EventRoundStep(self.rs.height, self.rs.round, int(self.rs.step)))
        self.n_steps += 1
        self._publish_rs_event(EVENT_NEW_ROUND_STEP)
        self.evsw.fire_event(EVENT_NEW_ROUND_STEP, self.get_round_state())

    # reconstruct LastCommit from blockstore SeenCommit (state.go:451)
    def reconstruct_last_commit_if_needed(self, state) -> None:
        if state.last_block_height == 0:
            return
        seen_commit = self.block_store.load_seen_commit(state.last_block_height)
        if seen_commit is None:
            raise ConsensusError(
                f"no seen commit for height {state.last_block_height}"
            )
        last_precommits = VoteSet(
            state.chain_id, state.last_block_height, seen_commit.round(),
            SignedMsgType.PRECOMMIT, state.last_validators,
        )
        for pc in seen_commit.precommits:
            if pc is None:
                continue
            if not last_precommits.add_vote(pc):
                raise ConsensusError("failed to reconstruct last commit")
        if not last_precommits.has_two_thirds_majority():
            raise ConsensusError("reconstructed last commit has no +2/3")
        self.rs.last_commit = last_precommits

    # updateToState (state.go:476) ------------------------------------------
    def update_to_state(self, state) -> None:
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height != state.last_block_height:
            raise ConsensusError(
                f"updateToState expected state height {rs.height}, "
                f"found {state.last_block_height}"
            )
        if (
            self.state is not None
            and not self.state.is_empty()
            and self.state.last_block_height + 1 != rs.height
        ):
            raise ConsensusError("inconsistent cs.state vs cs.height")
        if (
            self.state is not None
            and not self.state.is_empty()
            and state.last_block_height <= self.state.last_block_height
        ):
            self._new_step()
            return

        last_precommits: Optional[VoteSet] = None
        if rs.commit_round > -1 and rs.votes is not None:
            pc = rs.votes.precommits(rs.commit_round)
            if pc is None or not pc.has_two_thirds_majority():
                raise ConsensusError("updateToState without +2/3 in commit round")
            last_precommits = pc

        height = state.last_block_height + 1
        self._update_height(height)
        self._update_round_step(0, RoundStepType.NEW_HEIGHT)
        now = time.monotonic()
        if rs.commit_time == 0.0:
            rs.start_time = self.config.commit(now)
        else:
            rs.start_time = self.config.commit(rs.commit_time)

        rs.validators = state.validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(state.chain_id, height, state.validators)
        rs.commit_round = -1
        rs.last_commit = last_precommits
        rs.last_validators = state.last_validators
        rs.triggered_timeout_precommit = False
        self.state = state
        self._new_step()

    # ------------------------------------------------------------------ loop
    def _receive_routine(self) -> None:
        try:
            while not self.quit_event.is_set() and self.device_fault is None:
                try:
                    kind, payload = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                rs_snapshot = self.rs
                if kind == "peer":
                    self.wal.write(payload)
                    self._handle_msg(payload)
                elif kind == "internal":
                    self.wal.write_sync(payload)
                    self._handle_msg(payload)
                elif kind == "timeout":
                    self.wal.write(payload)
                    self._handle_timeout(payload, rs_snapshot)
                elif kind == "txs":
                    self._handle_txs_available()
                elif kind == "vote_verdict":
                    # no WAL write: the vote was WAL-logged as a peer msg
                    # when it arrived; this is its deferred verdict
                    self._handle_vote_verdict(payload)
        except Exception as e:
            if not self._card_fault(e):
                self.logger.error("CONSENSUS FAILURE!!! %s", traceback.format_exc())
        finally:
            if self.device_fault is not None:
                self.logger.error(
                    "consensus halted at height %d: device fault on the card (%s)",
                    self.rs.height, self.device_fault,
                )
                try:
                    self.timeout_ticker.stop()
                except Exception:
                    pass
            try:
                self.wal.stop()
            except Exception:
                pass
            self._done.set()

    # -- the device-fault contract -------------------------------------------
    def _card_fault(self, exc: BaseException) -> bool:
        """True, with the fault recorded, when ``exc`` is a guarded
        dispatch's failure and the verifier that ``validate_block`` calls
        (the executor's, else the installed one) is on the card."""
        if isinstance(exc, _brk.DeviceDispatchError) and _verifier_on_card(
                getattr(self.block_exec, "verifier", None)):
            if self.device_fault is None:
                self.device_fault = exc
            return True
        return False

    def _halt_on_feed_fault(self, exc: BaseException) -> None:
        """A vote ticket failed or outlived its wait on the card: record the
        fault (an overdue ticket as ``DeviceDispatchError('timeout')``); the
        receive routine stops before it takes another input."""
        if isinstance(exc, TimeoutError):
            err = _brk.DeviceDispatchError("timeout", "vote feed ticket")
            err.__cause__ = exc
            exc = err
        if self.device_fault is None:
            self.device_fault = exc

    def _handle_msg(self, mi: MsgInfo) -> None:
        with self._mtx:
            msg, peer_id = mi.msg, mi.peer_id
            try:
                if isinstance(msg, ProposalMessage):
                    self.set_proposal_fn(msg.proposal)
                elif isinstance(msg, BlockPartMessage):
                    # PartSetError covers a catch-up race, not just malice: a
                    # peer pushes parts of the committed block while our part
                    # set still has the header of a stale same-height
                    # proposal (enter_commit resets it once the commit-round
                    # precommits land) — log and keep consuming, like the
                    # reference's handleMsg (state.go:701)
                    try:
                        self._add_proposal_block_part(msg, peer_id)
                    except PartSetError as e:
                        self.logger.debug(
                            "block part rejected h=%d r=%d from %s: %s",
                            msg.height, msg.round, peer_id, e,
                        )
                elif isinstance(msg, VoteMessage):
                    if not self._maybe_batch_vote(msg.vote, peer_id):
                        self._try_add_vote(msg.vote, peer_id)
                else:
                    self.logger.error("unknown msg type %r", type(msg))
            except (VoteError, ErrInvalidProposalPOLRound, ErrInvalidProposalSignature) as e:
                self.logger.debug(
                    "msg error h=%d r=%d: %s", self.rs.height, self.rs.round, e
                )

    def _handle_timeout(self, ti: TimeoutInfo, rs: RoundState) -> None:
        step = RoundStepType(ti.step)
        if (
            ti.height != rs.height
            or ti.round < rs.round
            or (ti.round == rs.round and step < rs.step)
        ):
            return
        with self._mtx:
            if step == RoundStepType.NEW_HEIGHT:
                self.enter_new_round(ti.height, 0)
            elif step == RoundStepType.NEW_ROUND:
                self.enter_propose(ti.height, 0)
            elif step == RoundStepType.PROPOSE:
                self._publish_rs_event(EVENT_TIMEOUT_PROPOSE)
                self.enter_prevote(ti.height, ti.round)
            elif step == RoundStepType.PREVOTE_WAIT:
                self._publish_rs_event(EVENT_TIMEOUT_WAIT)
                self.enter_precommit(ti.height, ti.round)
            elif step == RoundStepType.PRECOMMIT_WAIT:
                self._publish_rs_event(EVENT_TIMEOUT_WAIT)
                self.enter_precommit(ti.height, ti.round)
                self.enter_new_round(ti.height, ti.round + 1)
            else:
                raise ConsensusError(f"invalid timeout step {step}")

    def _handle_txs_available(self) -> None:
        with self._mtx:
            self.enter_propose(self.rs.height, 0)

    # ------------------------------------------------------ state transitions
    def enter_new_round(self, height: int, round: int) -> None:
        rs = self.rs
        if (
            rs.height != height
            or round < rs.round
            or (rs.round == round and rs.step != RoundStepType.NEW_HEIGHT)
        ):
            return
        self.logger.info("enterNewRound(%d/%d)", height, round)
        self.flight.on_new_round(height, round)

        validators = rs.validators
        if rs.round < round:
            validators = validators.copy()
            validators.increment_accum(round - rs.round)

        self._update_round_step(round, RoundStepType.NEW_ROUND)
        if self.metrics is not None:
            # reference sets Rounds here (state.go enterNewRound), not at
            # commit — round skips show up as they happen
            self.metrics.rounds.set(round)
        rs.validators = validators
        if round != 0:
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round + 1)  # track next round for round-skip
        rs.triggered_timeout_precommit = False
        self._publish_rs_event(EVENT_NEW_ROUND)

        wait_for_txs = (
            self.config.wait_for_txs() and round == 0 and not self._need_proof_block(height)
        )
        if wait_for_txs:
            if self.config.create_empty_blocks_interval > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval, height, round,
                    RoundStepType.NEW_ROUND,
                )
        else:
            self.enter_propose(height, round)

    def _need_proof_block(self, height: int) -> bool:
        if height == 1:
            return True
        meta = self.block_store.load_block_meta(height - 1)
        return meta is None or self.state.app_hash != meta.header.app_hash

    def enter_propose(self, height: int, round: int) -> None:
        rs = self.rs
        if (
            rs.height != height
            or round < rs.round
            or (rs.round == round and RoundStepType.PROPOSE <= rs.step)
        ):
            return
        self.logger.info("enterPropose(%d/%d)", height, round)

        try:
            self._schedule_timeout(
                self.config.propose(round), height, round, RoundStepType.PROPOSE
            )
            if self.priv_validator is None:
                return
            if not rs.validators.has_address(self.priv_validator.address):
                return
            if self._is_proposer():
                self.decide_proposal(height, round)
        finally:
            self._update_round_step(round, RoundStepType.PROPOSE)
            self._new_step()
            if self._is_proposal_complete():
                self.enter_prevote(height, self.rs.round)

    def _is_proposer(self) -> bool:
        return (
            self.priv_validator is not None
            and self.rs.validators.get_proposer().address == self.priv_validator.address
        )

    def _default_decide_proposal(self, height: int, round: int) -> None:
        rs = self.rs
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            block, block_parts = self._create_proposal_block()
            if block is None:
                return
        prop_block_id = BlockID(hash=block.hash(), parts_header=block_parts.header())
        proposal = Proposal(
            height=height,
            round=round,
            timestamp_ns=self.now_ns(),
            block_id=prop_block_id,
            pol_round=rs.valid_round,
        )
        try:
            proposal = self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except Exception as e:
            if not self.replay_mode:
                self.logger.error("error signing proposal: %s", e)
            return
        self.send_internal(ProposalMessage(proposal))
        for i in range(block_parts.total):
            self.send_internal(
                BlockPartMessage(rs.height, rs.round, block_parts.get_part(i))
            )
        self.logger.info("signed proposal %d/%d %s", height, round, proposal)

    def _create_proposal_block(self) -> Tuple[Optional[Block], Optional[PartSet]]:
        rs = self.rs
        if rs.height == 1:
            commit = Commit()
        elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
            commit = rs.last_commit.make_commit()
        else:
            self.logger.error("cannot propose: no commit for previous block")
            return None, None
        max_bytes = self.state.consensus_params.block_size.max_bytes
        max_gas = self.state.consensus_params.block_size.max_gas
        evidence = self.evpool.pending_evidence(max_bytes // 10)
        txs = self.mempool.reap_max_bytes_max_gas(max_bytes * 9 // 10, max_gas)
        block = self.state.make_block(
            rs.height, txs, commit, evidence, self.priv_validator.address
        )
        return block, block.make_part_set()

    def _is_proposal_complete(self) -> bool:
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        pv = rs.votes.prevotes(rs.proposal.pol_round)
        return pv is not None and pv.has_two_thirds_majority()

    def enter_prevote(self, height: int, round: int) -> None:
        rs = self.rs
        if (
            rs.height != height
            or round < rs.round
            or (rs.round == round and RoundStepType.PREVOTE <= rs.step)
        ):
            return
        self.logger.info("enterPrevote(%d/%d)", height, round)
        try:
            self.do_prevote(height, round)
        finally:
            self._update_round_step(round, RoundStepType.PREVOTE)
            self._new_step()

    def _default_do_prevote(self, height: int, round: int) -> None:
        rs = self.rs
        if rs.locked_block is not None:
            self._sign_add_vote(
                SignedMsgType.PREVOTE, rs.locked_block.hash(),
                rs.locked_block_parts.header(),
            )
            return
        if rs.proposal_block is None:
            self._sign_add_vote(SignedMsgType.PREVOTE, b"", PartSetHeader())
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except Exception as e:
            if self._card_fault(e):
                raise  # a device fault is no invalid proposal
            self.logger.error("enterPrevote: ProposalBlock invalid: %s", e)
            self._sign_add_vote(SignedMsgType.PREVOTE, b"", PartSetHeader())
            return
        self._sign_add_vote(
            SignedMsgType.PREVOTE, rs.proposal_block.hash(),
            rs.proposal_block_parts.header(),
        )

    def enter_prevote_wait(self, height: int, round: int) -> None:
        rs = self.rs
        if (
            rs.height != height
            or round < rs.round
            or (rs.round == round and RoundStepType.PREVOTE_WAIT <= rs.step)
        ):
            return
        pv = rs.votes.prevotes(round)
        if pv is None or not pv.has_two_thirds_any():
            raise ConsensusError("enterPrevoteWait without +2/3 prevotes any")
        self.logger.info("enterPrevoteWait(%d/%d)", height, round)
        self._update_round_step(round, RoundStepType.PREVOTE_WAIT)
        self._new_step()
        self._schedule_timeout(
            self.config.prevote(round), height, round, RoundStepType.PREVOTE_WAIT
        )

    def enter_precommit(self, height: int, round: int) -> None:
        rs = self.rs
        if (
            rs.height != height
            or round < rs.round
            or (rs.round == round and RoundStepType.PRECOMMIT <= rs.step)
        ):
            return
        self.logger.info("enterPrecommit(%d/%d)", height, round)

        try:
            prevotes = rs.votes.prevotes(round)
            block_id = prevotes.two_thirds_majority() if prevotes else None

            if block_id is None:
                # no polka: precommit nil
                self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
                return

            self._publish_rs_event(EVENT_POLKA)
            self.flight.on_polka(height, round)
            pol_round, _ = rs.votes.pol_info()
            if pol_round < round:
                raise ConsensusError(f"POLRound should be {round} but got {pol_round}")

            if len(block_id.hash) == 0:
                # +2/3 prevoted nil: unlock and precommit nil
                if rs.locked_block is not None:
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                    self._publish_rs_event(EVENT_UNLOCK)
                self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
                return

            # +2/3 prevoted a block
            if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
                rs.locked_round = round
                self._publish_rs_event(EVENT_RELOCK)
                self._sign_add_vote(
                    SignedMsgType.PRECOMMIT, block_id.hash, block_id.parts_header
                )
                return

            if rs.proposal_block is not None and rs.proposal_block.hashes_to(block_id.hash):
                try:
                    self.block_exec.validate_block(self.state, rs.proposal_block)
                except Exception as e:
                    if self._card_fault(e):
                        raise
                    raise ConsensusError(f"+2/3 prevoted an invalid block: {e}")
                rs.locked_round = round
                rs.locked_block = rs.proposal_block
                rs.locked_block_parts = rs.proposal_block_parts
                self._publish_rs_event(EVENT_LOCK)
                self._sign_add_vote(
                    SignedMsgType.PRECOMMIT, block_id.hash, block_id.parts_header
                )
                return

            # polka for a block we don't have: unlock, fetch, precommit nil
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                block_id.parts_header
            ):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(block_id.parts_header)
            self._publish_rs_event(EVENT_UNLOCK)
            self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
        finally:
            self._update_round_step(round, RoundStepType.PRECOMMIT)
            self._new_step()

    def enter_precommit_wait(self, height: int, round: int) -> None:
        rs = self.rs
        if rs.height != height or round < rs.round or (
            rs.round == round and rs.triggered_timeout_precommit
        ):
            return
        pc = rs.votes.precommits(round)
        if pc is None or not pc.has_two_thirds_any():
            raise ConsensusError("enterPrecommitWait without +2/3 precommits any")
        self.logger.info("enterPrecommitWait(%d/%d)", height, round)
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(
            self.config.precommit(round), height, round, RoundStepType.PRECOMMIT_WAIT
        )

    def enter_commit(self, height: int, commit_round: int) -> None:
        rs = self.rs
        if rs.height != height or RoundStepType.COMMIT <= rs.step:
            return
        self.logger.info("enterCommit(%d/%d)", height, commit_round)
        try:
            block_id = rs.votes.precommits(commit_round).two_thirds_majority()
            if block_id is None:
                raise ConsensusError("enterCommit expects +2/3 precommits")
            self.flight.on_commit(height, commit_round, block_id.hash)
            if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
                rs.proposal_block = rs.locked_block
                rs.proposal_block_parts = rs.locked_block_parts
            if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
                if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                    block_id.parts_header
                ):
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet(block_id.parts_header)
                    self._publish_rs_event(EVENT_VALID_BLOCK)
                    # evsw too: the reactor rebroadcasts our (empty) parts
                    # bitmap so peers that already marked parts as sent-to-us
                    # resend them (state.go:1226 FireEvent EventValidBlock)
                    self.evsw.fire_event(EVENT_VALID_BLOCK, self.get_round_state())
        finally:
            self._update_round_step(rs.round, RoundStepType.COMMIT)
            rs.commit_round = commit_round
            rs.commit_time = time.monotonic()
            self._new_step()
            self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height:
            raise ConsensusError("tryFinalizeCommit height mismatch")
        block_id = rs.votes.precommits(rs.commit_round).two_thirds_majority()
        if block_id is None or len(block_id.hash) == 0:
            return
        if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
            return
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        with trace.span("consensus.finalize_commit", height=height):
            self._do_finalize_commit(height)

    def _do_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step != RoundStepType.COMMIT:
            return
        block_id = rs.votes.precommits(rs.commit_round).two_thirds_majority()
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        if block_id is None:
            raise ConsensusError("cannot finalize: no +2/3 majority")
        if not block_parts.has_header(block_id.parts_header):
            raise ConsensusError("commit parts header mismatch")
        if not block.hashes_to(block_id.hash):
            raise ConsensusError("block does not hash to commit hash")
        self.block_exec.validate_block(self.state, block)

        self.logger.info(
            "finalizing commit of block h=%d hash=%s txs=%d",
            block.height, (block.hash() or b"").hex()[:12], len(block.data.txs),
        )
        fail.fail_point()

        if self.block_store.height() < block.height:
            precommits = rs.votes.precommits(rs.commit_round)
            seen_commit = precommits.make_commit()
            persist_t0 = self.now_ns()
            self.block_store.save_block(block, block_parts, seen_commit)
            self.flight.on_persist(height, persist_t0, self.now_ns())

        fail.fail_point()

        # EndHeight marker: blockstore has the block; crash before this and
        # the ABCI handshake re-applies (replay.py)
        self.wal.write_sync(EndHeightMessage(height))

        fail.fail_point()

        state_copy = self.state.copy()
        exec_t0 = self.now_ns()
        try:
            state_copy = self.block_exec.apply_block(
                state_copy, BlockID(hash=block.hash(), parts_header=block_parts.header()),
                block,
            )
        except Exception as e:
            self.logger.error("error on ApplyBlock: %s — halting", e)
            raise
        self.flight.on_execute(height, exec_t0, self.now_ns())
        # the height's lifecycle is complete — fuse its flight stamps, WAL
        # costs, and verify-dispatch ledger into one waterfall record
        self.critpath.on_height_complete(height, self.flight, wal=self.wal)
        # quorum curve needs the committed height's valset (rs advances only
        # in update_to_state below) and the batch-flush ledger if batching
        self.quorumtrace.on_height_complete(
            height, self.flight,
            validators=rs.validators, vote_feed=self._vote_feed,
        )

        fail.fail_point()

        self.update_to_state(state_copy)

        fail.fail_point()

        self._schedule_round_0(self.rs)

    # ---------------------------------------------------------------- inputs
    def _default_set_proposal(self, proposal: Proposal) -> None:
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (
            0 <= proposal.pol_round and proposal.pol_round >= proposal.round
        ):
            raise ErrInvalidProposalPOLRound()
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify_bytes(
            proposal.sign_bytes(self.state.chain_id), proposal.signature
        ):
            raise ErrInvalidProposalSignature()
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(proposal.block_id.parts_header)
        self.flight.on_proposal(rs.height, rs.round)
        self.logger.info("received proposal %s", proposal)

    def _add_proposal_block_part(self, msg: BlockPartMessage, peer_id: str) -> bool:
        rs = self.rs
        height, round, part = msg.height, msg.round, msg.part
        if rs.height != height:
            return False
        if rs.proposal_block_parts is None:
            return False
        added = rs.proposal_block_parts.add_part(part)
        if added and rs.proposal_block_parts.is_complete():
            data = rs.proposal_block_parts.assemble()
            if len(data) > self.state.consensus_params.block_size.max_bytes:
                raise ConsensusError("proposal block too big")
            rs.proposal_block = Block.unmarshal(data)
            self.flight.on_block_parts_complete(height)
            self.logger.info(
                "received complete proposal block h=%d %s",
                rs.proposal_block.height, rs.proposal_block,
            )
            self._publish_rs_event(EVENT_COMPLETE_PROPOSAL)

            prevotes = rs.votes.prevotes(rs.round)
            block_id = prevotes.two_thirds_majority() if prevotes else None
            if (
                block_id is not None
                and not block_id.is_zero()
                and rs.valid_round < rs.round
            ):
                if rs.proposal_block.hashes_to(block_id.hash):
                    rs.valid_round = rs.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
            if rs.step <= RoundStepType.PROPOSE and self._is_proposal_complete():
                self.enter_prevote(height, rs.round)
                if block_id is not None:
                    self.enter_precommit(height, rs.round)
            elif rs.step == RoundStepType.COMMIT:
                self._try_finalize_commit(height)
        return added

    # ---------------------------------------------------- vote micro-batcher
    def _maybe_batch_vote(self, vote: Vote, peer_id: str) -> bool:
        """Route a live peer vote to the vote micro-batcher.  Returns True
        when the vote was consumed by the batched path (submitted for
        verification, or dropped as an exact duplicate); False sends it
        down the serial path unchanged.  Raises the same VoteError
        subclasses structural prevalidation raises serially — _handle_msg's
        existing catch treats them identically either way.

        Kept deliberately narrow: own votes (peer_id ""), WAL replay,
        height mismatches and last-commit stragglers all stay serial, so
        batching only ever defers the signature check of current-height
        gossip — the hot path — and everything else is bit-identical by
        construction."""
        feed = self._vote_feed
        if vote is None or self.rs.votes is None:
            return False
        reason = None
        if self.replay_mode:
            reason = "replay"
        elif peer_id == "":
            reason = "own"
        elif feed is None:
            reason = "no_feed"
        elif vote.height + 1 == self.rs.height and vote.vote_type == SignedMsgType.PRECOMMIT:
            reason = "last_commit"
        elif vote.height != self.rs.height:
            reason = "height"
        if reason is not None:
            self.serial_votes[reason] += 1
            return False
        # GotVoteFromUnwantedRoundError propagates exactly as it would from
        # the serial rs.votes.add_vote (same call, same caller)
        vs = self.rs.votes.vote_set_for(vote, peer_id)
        pending = vs.prevalidate(vote)
        if pending is None:
            return True  # exact duplicate — serial add_vote returns False
        gk = (vote.height, vote.round, int(vote.vote_type))
        bk = vote.block_id.key()
        power = pending.voting_power
        in_flight = self._vote_pending_power.get((gk, bk), 0)
        # flush immediately when this vote could complete the block's +2/3
        # (counting power already submitted but unresolved) — a
        # quorum-completing vote must never wait out the deadline
        urgent = not vs.has_two_thirds_majority() and (
            (vs.sum_by_block_id(vote.block_id) + in_flight + power) * 3
            > vs.val_set.total_voting_power() * 2
        )
        self._vote_pending_power[(gk, bk)] = in_flight + power
        try:
            ticket = feed.submit(
                gk,
                pending.pub_key,
                vote.sign_bytes(vs.chain_id),
                vote.signature,
                power=power,
                total=vs.val_set.total_voting_power(),
                urgent=urgent,
            )
        except Exception:
            # feed closed/raced — undo the accounting, go serial
            self._vote_pending_drop(gk, bk, power)
            self.serial_votes["feed_error"] += 1
            return False
        self._vote_pump_q.put((vote, peer_id, ticket, gk, bk, power))
        return True

    def _vote_pending_drop(self, gk, bk, power: int) -> None:
        left = self._vote_pending_power.get((gk, bk), 0) - power
        if left > 0:
            self._vote_pending_power[(gk, bk)] = left
        else:
            self._vote_pending_power.pop((gk, bk), None)

    def _vote_verdict_pump(self) -> None:
        """Waits batched-verdict tickets in submit (arrival) order and
        re-enters each vote into the receive queue, so the consensus thread
        applies batched votes FIFO just like serial ones. On the card a
        failed or overdue ticket halts the state machine and the pump: no
        vote of that flush, or of any later one, is re-entered."""
        while not self.quit_event.is_set() and self.device_fault is None:
            try:
                item = self._vote_pump_q.get(timeout=0.1)
            except queue.Empty:
                continue
            vote, peer_id, ticket, gk, bk, power = item
            try:
                ok = bool(ticket.result(timeout=self.vote_ticket_timeout_s).ok)
            except BaseException as e:
                if _brk.on_card(self._vote_feed):
                    self._halt_on_feed_fault(e)
                    return
                # feed error/timeout: verdict unknown — the handler falls
                # back to the serial (re-verifying) path, bit-identically
                ok = None
            self._queue.put(("vote_verdict", (vote, peer_id, ok, gk, bk, power)))

    def _handle_vote_verdict(self, payload) -> None:
        vote, peer_id, ok, gk, bk, power = payload
        with self._mtx:
            self._vote_pending_drop(gk, bk, power)
            try:
                if ok is None:
                    # unknown verdict — serial re-verify, same as no batcher
                    self.serial_votes["unknown_verdict"] += 1
                    self._try_add_vote(vote, peer_id)
                elif ok:
                    # signature already paid on the batched dispatch;
                    # structural prevalidation reruns inside add_vote so a
                    # duplicate/conflict that raced in resolves identically
                    self._try_add_vote(vote, peer_id, verified=True)
                else:
                    # failed the batched verify — but re-prevalidate first so
                    # a structural rejection that materialized while the vote
                    # was in flight surfaces the SAME error class the serial
                    # path would have raised (e.g. a second differently-signed
                    # vote for an already-tallied block is a non-deterministic
                    # signature, not an invalid one)
                    if (self.rs.votes is not None
                            and vote.height == self.rs.height):
                        vs = self.rs.votes.vote_set_for(vote, peer_id)
                        if vs is not None and vs.prevalidate(vote) is None:
                            return  # exact duplicate raced in — drop quietly
                    raise ErrVoteInvalidSignature()
            except (VoteError, ErrInvalidProposalPOLRound,
                    ErrInvalidProposalSignature) as e:
                self.logger.debug(
                    "msg error h=%d r=%d: %s", self.rs.height, self.rs.round, e
                )

    def _try_add_vote(self, vote: Vote, peer_id: str,
                      verified: bool = False) -> bool:
        try:
            return self._add_vote(vote, peer_id, verified=verified)
        except ErrVoteHeightMismatch:
            return False
        except ErrVoteConflictingVotes as e:
            if (
                self.priv_validator is not None
                and vote.validator_address == self.priv_validator.address
            ):
                self.logger.error(
                    "found conflicting vote from ourselves h=%d r=%d",
                    vote.height, vote.round,
                )
                return False
            # punishable double-sign: turn into evidence
            _, val = self.rs.validators.get_by_address(vote.validator_address)
            if val is not None:
                try:
                    self.evpool.add_evidence(
                        DuplicateVoteEvidence(
                            pub_key=val.pub_key, vote_a=e.vote_a, vote_b=e.vote_b
                        )
                    )
                except Exception as ee:
                    self.logger.error("failed to add evidence: %s", ee)
            return False

    def _observe_vote_latency(self, vote: Vote) -> None:
        """Wall delay between the vote's signed timestamp and its arrival
        here.  Clock skew can make this negative and a bogus timestamp can
        make it huge — clamp to [0, 1h) so one bad vote can't wreck the
        histogram."""
        if self.metrics is None:
            return
        lat = (self.now_ns() - vote.timestamp_ns) / 1e9
        if 0.0 <= lat < 3600.0:
            kind = (
                "prevote"
                if vote.vote_type == SignedMsgType.PREVOTE
                else "precommit"
            )
            self.metrics.vote_arrival_latency.observe(lat, (kind,))

    def _vote_power(self, vote: Vote) -> int:
        """The voter's power in the CURRENT valset (0 when unknown — e.g. a
        last-commit straggler after a valset change).  Feeds the flight
        recorder's quorum-contribution stamps."""
        try:
            _, val = self.rs.validators.get_by_index(vote.validator_index)
            return val.voting_power if val is not None else 0
        except Exception:
            return 0

    def _add_vote(self, vote: Vote, peer_id: str,
                  verified: bool = False) -> bool:
        rs = self.rs

        # precommit straggler for the previous height (during NEW_HEIGHT wait)
        # — deliberately NOT forwarding `verified`: a batched verdict was
        # issued against the vote's own height, and if the height advanced
        # between submit and verdict the cheap serial re-verify here keeps
        # the last-commit path identical to a node without the batcher
        if vote.height + 1 == rs.height:
            if not (
                rs.step == RoundStepType.NEW_HEIGHT
                and vote.vote_type == SignedMsgType.PRECOMMIT
            ):
                raise ErrVoteHeightMismatch()
            if rs.last_commit is None:
                raise ErrVoteHeightMismatch()
            if verified:
                self.serial_votes["late_verdict"] += 1
            added, conflict = _add_counting_conflict(rs.last_commit.add_vote, vote)
            if not added:
                return False
            self._observe_vote_latency(vote)
            self.flight.on_vote(
                vote.height, vote.round, "precommit", peer_id,
                vote.validator_index,
            )
            self._publish_vote_event(vote)
            if self.config.skip_timeout_commit and rs.last_commit.has_all():
                self.enter_new_round(rs.height, 0)
            if conflict is not None:
                raise conflict
            return added

        if vote.height != rs.height:
            raise ErrVoteHeightMismatch()

        height = rs.height
        added, conflict = _add_counting_conflict(rs.votes.add_vote, vote, peer_id,
                                                 verified=verified)
        if not added:
            return False
        self._observe_vote_latency(vote)
        if self.flight.enabled:  # off, the voter's power is not looked up
            self.flight.on_vote(
                vote.height,
                vote.round,
                "prevote" if vote.vote_type == SignedMsgType.PREVOTE else "precommit",
                peer_id,
                vote.validator_index,
                power=self._vote_power(vote),
            )
        self._publish_vote_event(vote)

        if vote.vote_type == SignedMsgType.PREVOTE:
            prevotes = rs.votes.prevotes(vote.round)
            block_id = prevotes.two_thirds_majority()
            if block_id is not None:
                # unlock on a more recent polka for a different block
                if (
                    rs.locked_block is not None
                    and rs.locked_round < vote.round <= rs.round
                    and not rs.locked_block.hashes_to(block_id.hash)
                ):
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                    self._publish_rs_event(EVENT_UNLOCK)
                # update valid block
                if (
                    len(block_id.hash) != 0
                    and rs.valid_round < vote.round == rs.round
                ):
                    if rs.proposal_block is not None and rs.proposal_block.hashes_to(
                        block_id.hash
                    ):
                        rs.valid_round = vote.round
                        rs.valid_block = rs.proposal_block
                        rs.valid_block_parts = rs.proposal_block_parts
                    else:
                        rs.proposal_block = None
                    if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                        block_id.parts_header
                    ):
                        rs.proposal_block_parts = PartSet(block_id.parts_header)
                    self.evsw.fire_event(EVENT_VALID_BLOCK, self.get_round_state())
                    self._publish_rs_event(EVENT_VALID_BLOCK)

            if rs.round < vote.round and prevotes.has_two_thirds_any():
                self.enter_new_round(height, vote.round)  # round skip
            elif rs.round == vote.round and RoundStepType.PREVOTE <= rs.step:
                block_id = prevotes.two_thirds_majority()
                if block_id is not None and (
                    self._is_proposal_complete() or len(block_id.hash) == 0
                ):
                    self.enter_precommit(height, vote.round)
                elif prevotes.has_two_thirds_any():
                    self.enter_prevote_wait(height, vote.round)
            elif (
                rs.proposal is not None
                and 0 <= rs.proposal.pol_round == vote.round
            ):
                if self._is_proposal_complete():
                    self.enter_prevote(height, rs.round)

        elif vote.vote_type == SignedMsgType.PRECOMMIT:
            precommits = rs.votes.precommits(vote.round)
            block_id = precommits.two_thirds_majority()
            if block_id is not None:
                self.enter_new_round(height, vote.round)
                self.enter_precommit(height, vote.round)
                if len(block_id.hash) != 0:
                    self.enter_commit(height, vote.round)
                    if self.config.skip_timeout_commit and precommits.has_all():
                        self.enter_new_round(self.rs.height, 0)
                else:
                    self.enter_precommit_wait(height, vote.round)
            elif rs.round <= vote.round and precommits.has_two_thirds_any():
                self.enter_new_round(height, vote.round)
                self.enter_precommit_wait(height, vote.round)
        else:
            raise ConsensusError(f"unexpected vote type {vote.vote_type}")
        if conflict is not None:
            raise conflict  # the double-sign still becomes evidence
        return True

    def _publish_vote_event(self, vote: Vote) -> None:
        if self.event_bus is not None:
            self.event_bus.publish_event_vote(vote)
        self.evsw.fire_event(EVENT_VOTE, vote)

    # ----------------------------------------------------------------- votes
    def _vote_time_ns(self) -> int:
        now = self.now_ns()
        min_vote_time = now
        rs = self.rs
        if rs.locked_block is not None:
            min_vote_time = self.config.min_valid_vote_time_ns(rs.locked_block.header.time_ns)
        elif rs.proposal_block is not None:
            min_vote_time = self.config.min_valid_vote_time_ns(rs.proposal_block.header.time_ns)
        return max(now, min_vote_time)

    def _sign_vote(
        self, t: SignedMsgType, hash_: bytes, header: PartSetHeader
    ) -> Vote:
        addr = self.priv_validator.address
        idx, _ = self.rs.validators.get_by_address(addr)
        vote = Vote(
            vote_type=t,
            height=self.rs.height,
            round=self.rs.round,
            timestamp_ns=self._vote_time_ns(),
            block_id=BlockID(hash=hash_, parts_header=header),
            validator_address=addr,
            validator_index=idx,
        )
        return self.priv_validator.sign_vote(self.state.chain_id, vote)

    def _sign_add_vote(
        self, t: SignedMsgType, hash_: bytes, header: PartSetHeader
    ) -> Optional[Vote]:
        if self.priv_validator is None or not self.rs.validators.has_address(
            self.priv_validator.address
        ):
            return None
        try:
            vote = self._sign_vote(t, hash_, header)
        except Exception as e:
            if not self.replay_mode:
                self.logger.error("error signing vote h=%d r=%d: %s",
                                  self.rs.height, self.rs.round, e)
            return None
        # journey origin: OUR vote exists the instant the signature lands,
        # before it enters the internal queue / gossip
        self.flight.on_vote_signed(
            vote.height, vote.round,
            "prevote" if t == SignedMsgType.PREVOTE else "precommit",
            vote.validator_index,
        )
        self.send_internal(VoteMessage(vote))
        return vote
