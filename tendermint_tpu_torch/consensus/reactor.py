"""ConsensusReactor: gossips proposals, block parts and votes between
ConsensusStates over the p2p switch (ref consensus/reactor.go), the port's
copy of the reference package's ``consensus/reactor.py``, with the same
channels, messages and bytes on the wire. Where the port differs:
``init_peer`` makes a peer's ``PeerState`` before the switch starts the
peer (Go's InitPeer), so the NewRoundStep a peer sends on connecting is
never dropped; the reference package makes it in ``add_peer`` and drops
what arrives before, which can leave a node believing a peer at height 0
until that peer changes step again, and a net stuck
(``tests/test_torch_consensus_reactor.py``).

A peer's proposal, block parts and votes enter the state machine through
``ConsensusState.send_peer_msg``, as any peer message does: the reactor
does not reach into the vote feed, so a gossiped vote is prevalidated and
verified by the state's ``[verify]`` vote feed (on the card the installed
guarded verifier: K1 + K2) and a block's LastCommit by ``apply_block``.
The flight recorder stamps each vote's first gossip send and each
VoteMessage at this receive seam (``on_vote_send`` / ``on_vote_arrival``)
and a proposal's first arrival (``on_proposal``).

Per the reference:

* four channels — STATE 0x20, DATA 0x21 (priority 10: block parts are the
  critical path), VOTE 0x22, VOTE_SET_BITS 0x23 (reactor.go:125-155);
* per-peer ``PeerState`` tracks what the peer has (round state, parts
  bitmap, vote bitmaps incl. last/catchup commit, reactor.go:911);
* three gossip threads per peer: data (parts/proposal + catchup from the
  block store, reactor.go:472), votes (reactor.go:609), and the maj23 query
  loop (reactor.go:736);
* reactor-side broadcasts ride the ConsensusState's internal event switch —
  every NewRoundStep/ValidBlock/Vote fires a STATE-channel broadcast
  (reactor.go subscribeToBroadcastEvents :370-398);
* in fast-sync mode the reactor stays passive until ``switch_to_consensus``
  (reactor.go:101-121).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from tendermint_tpu_torch.consensus.messages import (
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    ProposalPOLMessage,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
    encode_msg,
    unmarshal_msg,
)
from tendermint_tpu_torch.consensus.cstypes import RoundStepType
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.libs.bit_array import BitArray
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.types.core import PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.events import EVENT_NEW_ROUND_STEP, EVENT_VALID_BLOCK, EVENT_VOTE

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

MAX_MSG_SIZE = 1024 * 1024  # reactor.go maxMsgSize


@dataclass
class PeerRoundState:
    """What we know the peer knows (ref: consensus/types/peer_round_state.go)."""

    height: int = 0
    round: int = -1
    step: RoundStepType = RoundStepType.NEW_HEIGHT
    proposal: bool = False
    proposal_block_parts_header: PartSetHeader = field(default_factory=PartSetHeader)
    proposal_block_parts: Optional[BitArray] = None
    proposal_pol_round: int = -1
    proposal_pol: Optional[BitArray] = None
    prevotes: Optional[BitArray] = None
    precommits: Optional[BitArray] = None
    last_commit_round: int = -1
    last_commit: Optional[BitArray] = None
    catchup_commit_round: int = -1
    catchup_commit: Optional[BitArray] = None


class PeerState:
    """Thread-safe view of one peer's consensus knowledge (reactor.go:911)."""

    def __init__(self, peer, on_vote_send=None):
        self.peer = peer
        self._mtx = threading.Lock()
        self.prs = PeerRoundState()
        self.stats_votes = 0
        self.stats_block_parts = 0
        # called with (vote, peer_id) after each successful gossip send —
        # the reactor wires the flight recorder's first-send stamp here
        self._on_vote_send = on_vote_send

    def get_round_state(self) -> PeerRoundState:
        with self._mtx:
            import copy

            prs = copy.copy(self.prs)
            # bit arrays are mutated under the lock; hand out copies
            for f in ("proposal_block_parts", "proposal_pol", "prevotes",
                      "precommits", "last_commit", "catchup_commit"):
                ba = getattr(prs, f)
                if ba is not None:
                    setattr(prs, f, ba.copy())
            return prs

    @property
    def height(self) -> int:
        with self._mtx:
            return self.prs.height

    # -- "peer now has X" markers ------------------------------------------------
    def set_has_proposal(self, proposal) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != proposal.height or prs.round != proposal.round:
                return
            if prs.proposal:
                return
            prs.proposal = True
            if prs.proposal_block_parts is not None:
                return  # already set via NewValidBlockMessage
            prs.proposal_block_parts_header = proposal.block_id.parts_header
            prs.proposal_block_parts = BitArray(proposal.block_id.parts_header.total)
            prs.proposal_pol_round = proposal.pol_round
            prs.proposal_pol = None  # until ProposalPOLMessage arrives

    def init_proposal_block_parts(self, parts_header: PartSetHeader) -> None:
        with self._mtx:
            if self.prs.proposal_block_parts is not None:
                return
            self.prs.proposal_block_parts_header = parts_header
            self.prs.proposal_block_parts = BitArray(parts_header.total)

    def set_has_proposal_block_part(self, height: int, round: int, index: int) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != height or prs.round != round:
                return
            if prs.proposal_block_parts is not None:
                prs.proposal_block_parts.set_index(index, True)

    def set_has_vote(self, vote) -> None:
        with self._mtx:
            self._set_has_vote(vote.height, vote.round, vote.vote_type, vote.validator_index)

    def _set_has_vote(self, height: int, round: int, t: int, index: int) -> None:
        ba = self._get_vote_bit_array(height, round, t)
        if ba is not None:
            ba.set_index(index, True)

    # -- vote picking --------------------------------------------------------------
    def pick_send_vote(self, votes) -> bool:
        """Pick a vote the peer lacks and send it (reactor.go PickSendVote)."""
        vote = self._pick_vote_to_send(votes)
        if vote is None:
            return False
        if self.peer.send(VOTE_CHANNEL, encode_msg(VoteMessage(vote))):
            self.set_has_vote(vote)
            if self._on_vote_send is not None:
                self._on_vote_send(vote, self.peer.id)
            return True
        return False

    def _pick_vote_to_send(self, votes):
        if votes is None or votes.size == 0:
            return None
        with self._mtx:
            height, round, t = votes.height, votes.round, votes.signed_msg_type
            if votes.is_commit():
                self._ensure_catchup_commit_round(height, round, votes.size)
            self._ensure_vote_bit_arrays(height, votes.size)
            ps_votes = self._get_vote_bit_array(height, round, t)
            if ps_votes is None:
                return None
            index = votes.bit_array().sub(ps_votes).pick_random()
            if index is None:
                return None
            return votes.get_by_index(index)

    def _get_vote_bit_array(self, height: int, round: int, t: int) -> Optional[BitArray]:
        prs = self.prs
        if prs.height == height:
            if prs.round == round:
                return prs.prevotes if t == SignedMsgType.PREVOTE else prs.precommits
            if prs.catchup_commit_round == round and t == SignedMsgType.PRECOMMIT:
                return prs.catchup_commit
            if prs.proposal_pol_round == round and t == SignedMsgType.PREVOTE:
                return prs.proposal_pol
            return None
        if prs.height == height + 1:
            if prs.last_commit_round == round and t == SignedMsgType.PRECOMMIT:
                return prs.last_commit
        return None

    def _ensure_catchup_commit_round(self, height: int, round: int, num_validators: int) -> None:
        prs = self.prs
        if prs.height != height or prs.catchup_commit_round == round:
            return
        prs.catchup_commit_round = round
        if round == prs.round:
            prs.catchup_commit = prs.precommits
        else:
            prs.catchup_commit = BitArray(num_validators)

    def ensure_vote_bit_arrays(self, height: int, num_validators: int) -> None:
        with self._mtx:
            self._ensure_vote_bit_arrays(height, num_validators)

    def _ensure_vote_bit_arrays(self, height: int, num_validators: int) -> None:
        prs = self.prs
        if prs.height == height:
            if prs.prevotes is None:
                prs.prevotes = BitArray(num_validators)
            if prs.precommits is None:
                prs.precommits = BitArray(num_validators)
            if prs.catchup_commit is None:
                prs.catchup_commit = BitArray(num_validators)
            if prs.proposal_pol is None:
                prs.proposal_pol = BitArray(num_validators)
        elif prs.height == height + 1:
            if prs.last_commit is None:
                prs.last_commit = BitArray(num_validators)

    # -- message application -------------------------------------------------------
    def apply_new_round_step(self, msg: NewRoundStepMessage) -> None:
        with self._mtx:
            prs = self.prs
            if (msg.height, msg.round, msg.step) <= (prs.height, prs.round, int(prs.step)):
                return
            ps_height, ps_round = prs.height, prs.round
            ps_catchup_round, ps_catchup = prs.catchup_commit_round, prs.catchup_commit
            # capture before the reset below wipes it (reactor.go saves
            # lastPrecommits before nilling)
            ps_precommits = prs.precommits

            prs.height = msg.height
            prs.round = msg.round
            prs.step = RoundStepType(msg.step)
            if ps_height != msg.height or ps_round != msg.round:
                prs.proposal = False
                prs.proposal_block_parts_header = PartSetHeader()
                prs.proposal_block_parts = None
                prs.proposal_pol_round = -1
                prs.proposal_pol = None
                prs.prevotes = None
                prs.precommits = None
            if (
                ps_height == msg.height
                and ps_round != msg.round
                and msg.round == ps_catchup_round
            ):
                # peer caught up to the round we have a commit for
                prs.precommits = ps_catchup
            if ps_height != msg.height:
                if ps_height + 1 == msg.height and ps_round == msg.last_commit_round:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = ps_precommits
                else:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = None
                prs.catchup_commit_round = -1
                prs.catchup_commit = None

    def apply_new_valid_block(self, msg: NewValidBlockMessage) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != msg.height:
                return
            if prs.round != msg.round and not msg.is_commit:
                return
            prs.proposal_block_parts_header = msg.block_parts_header
            prs.proposal_block_parts = msg.block_parts

    def apply_proposal_pol(self, msg: ProposalPOLMessage) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != msg.height or prs.proposal_pol_round != msg.proposal_pol_round:
                return
            prs.proposal_pol = msg.proposal_pol

    def apply_has_vote(self, msg: HasVoteMessage) -> None:
        with self._mtx:
            if self.prs.height != msg.height:
                return
            self._set_has_vote(msg.height, msg.round, msg.type, msg.index)

    def apply_vote_set_bits(self, msg: VoteSetBitsMessage, our_votes: Optional[BitArray]) -> None:
        with self._mtx:
            votes = self._get_vote_bit_array(msg.height, msg.round, msg.type)
            if votes is None:
                return
            if our_votes is None:
                votes.update(msg.votes)
            else:
                # trust only claims about votes we don't have ourselves
                other = votes.sub(our_votes)
                votes.update(other.or_(msg.votes))


class ConsensusReactor(Reactor):
    def __init__(self, consensus_state: ConsensusState, fast_sync: bool = False,
                 metrics=None):
        """``metrics``: the node's ``libs/metrics.NodeMetrics``, which counts
        the vote sightings by peer (None: they are not counted)."""
        super().__init__(name="ConsensusReactor")
        self.cons = consensus_state
        self.metrics = metrics
        self._fast_sync = fast_sync
        self._fs_mtx = threading.Lock()
        self._peer_states: Dict[str, PeerState] = {}
        self._ps_mtx = threading.Lock()
        # first-sighting ledger at the receive seam, BEFORE VoteSet dedup:
        # (height, round, type) -> {validator_index}.  Independent of the
        # flight recorder's enable gate so the gossip-waste counters
        # (tendermint_p2p_{vote_first_sighting,duplicate_votes}_total)
        # always tick.  Pruned as the height advances.
        self._vote_seen: Dict[tuple, set] = {}
        self._vote_seen_max_h = 0
        self._seen_mtx = threading.Lock()

    # -- Reactor interface ---------------------------------------------------------
    def get_channels(self):
        return [
            ChannelDescriptor(
                id=STATE_CHANNEL, priority=5, send_queue_capacity=100,
                recv_message_capacity=MAX_MSG_SIZE,
            ),
            ChannelDescriptor(
                id=DATA_CHANNEL, priority=10, send_queue_capacity=100,
                recv_message_capacity=MAX_MSG_SIZE,
            ),
            ChannelDescriptor(
                id=VOTE_CHANNEL, priority=5, send_queue_capacity=100,
                recv_message_capacity=MAX_MSG_SIZE,
            ),
            ChannelDescriptor(
                id=VOTE_SET_BITS_CHANNEL, priority=1, send_queue_capacity=2,
                recv_message_capacity=MAX_MSG_SIZE,
            ),
        ]

    @property
    def fast_sync(self) -> bool:
        with self._fs_mtx:
            return self._fast_sync

    def on_start(self) -> None:
        self._subscribe_broadcast_events()
        if not self.fast_sync:
            if not self.cons.is_running:
                self.cons.start()

    def on_stop(self) -> None:
        self.cons.evsw.remove_listener("consensus-reactor")
        if self.cons.is_running:
            try:
                self.cons.stop()
            except Exception:
                pass

    def switch_to_consensus(self, state, blocks_synced: int = 0) -> None:
        """Fast sync finished: reset to `state` and start the machine
        (reactor.go:101 SwitchToConsensus)."""
        self.logger.info("switching to consensus (synced %d blocks)", blocks_synced)
        self.cons.reconstruct_last_commit_if_needed(state)
        self.cons.update_to_state(state)
        with self._fs_mtx:
            self._fast_sync = False
        if blocks_synced > 0:
            # WAL catchup is pointless after a fast sync: everything in the
            # WAL predates the synced blocks (reference sets doWALCatchup=false)
            self.cons.skip_wal_catchup = True
        self.cons.start()
        self._broadcast_new_round_step(self.cons.get_round_state())

    def init_peer(self, peer):
        """The peer's ``PeerState``, made before the switch starts the peer
        (Go's InitPeer): the NewRoundStep it sends on connecting may arrive
        before ``add_peer``, and a node that drops it never learns the
        peer's height until the peer changes step again."""
        with self._ps_mtx:
            self._peer_states[peer.id] = PeerState(peer, on_vote_send=self._note_vote_send)
        return peer

    def add_peer(self, peer) -> None:
        if not self.is_running:
            return
        with self._ps_mtx:
            ps = self._peer_states.get(peer.id)
            if ps is None or ps.peer is not peer:
                ps = self._peer_states[peer.id] = PeerState(
                    peer, on_vote_send=self._note_vote_send)
        for fn in (self._gossip_data_routine, self._gossip_votes_routine,
                   self._query_maj23_routine):
            threading.Thread(
                target=fn, args=(peer, ps),
                name=f"{fn.__name__}-{peer.id[:8]}", daemon=True,
            ).start()
        if not self.fast_sync:
            rs = self.cons.get_round_state()
            peer.send(STATE_CHANNEL, encode_msg(self._make_round_step_message(rs)))

    def remove_peer(self, peer, reason) -> None:
        with self._ps_mtx:
            ps = self._peer_states.get(peer.id)
            if ps is not None and ps.peer is peer:
                del self._peer_states[peer.id]

    def peer_state(self, peer_id: str) -> Optional[PeerState]:
        with self._ps_mtx:
            return self._peer_states.get(peer_id)

    def peer_height(self, peer_id: str) -> Optional[int]:
        """The peer's consensus height — the hold-back signal the mempool and
        evidence gossip reactors consume (reference: PeerState.GetHeight via
        the peer's shared state key, mempool/reactor.go:150)."""
        ps = self.peer_state(peer_id)
        return ps.height if ps is not None else None

    # -- vote-journey attribution --------------------------------------------------
    def _note_vote_send(self, vote, peer_id: str) -> None:
        """PeerState gossip-send callback: stamp the FIRST outbound send of
        each validator's vote (journey leg 2: sign -> first gossip)."""
        self.cons.flight.on_vote_send(
            vote.height, vote.round,
            "prevote" if vote.vote_type == SignedMsgType.PREVOTE
            else "precommit",
            vote.validator_index, peer_id,
        )

    def _note_vote_arrival(self, vote, peer_id: str) -> None:
        """Receive-seam first-sighting/duplicate split.  Every VoteMessage
        increments EXACTLY one of the two counters, so their sum equals
        total votes received — the reconciliation invariant quorum_smoke
        checks.  Runs before VoteSet dedup burns a prevalidate."""
        key = (vote.height, vote.round, int(vote.vote_type))
        with self._seen_mtx:
            if vote.height > self._vote_seen_max_h:
                self._vote_seen_max_h = vote.height
                floor = vote.height - 2  # keep h and the last-commit h-1
                for k in [k for k in self._vote_seen if k[0] < floor]:
                    del self._vote_seen[k]
            seen = self._vote_seen.setdefault(key, set())
            first = vote.validator_index not in seen
            if first:
                seen.add(vote.validator_index)
        kind = (
            "prevote" if vote.vote_type == SignedMsgType.PREVOTE
            else "precommit"
        )
        self.cons.flight.on_vote_arrival(
            vote.height, vote.round, kind, peer_id, vote.validator_index,
            duplicate=not first,
        )
        if self.metrics is not None:
            self.metrics.record_vote_sighting(peer_id, VOTE_CHANNEL, first=first)

    # -- inbound -------------------------------------------------------------------
    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        if not self.is_running:
            return
        if len(msg_bytes) > MAX_MSG_SIZE:
            raise ValueError(f"consensus msg exceeds {MAX_MSG_SIZE} bytes")
        msg = unmarshal_msg(msg_bytes)
        ps = self.peer_state(peer.id)
        if ps is None:
            return

        if chan_id == STATE_CHANNEL:
            if isinstance(msg, NewRoundStepMessage):
                ps.apply_new_round_step(msg)
            elif isinstance(msg, NewValidBlockMessage):
                ps.apply_new_valid_block(msg)
            elif isinstance(msg, HasVoteMessage):
                ps.apply_has_vote(msg)
            elif isinstance(msg, VoteSetMaj23Message):
                self._handle_vote_set_maj23(peer, ps, msg)
            else:
                self.logger.error("unknown STATE msg %r", type(msg))
        elif chan_id == DATA_CHANNEL:
            if self.fast_sync:
                return
            if isinstance(msg, ProposalMessage):
                ps.set_has_proposal(msg.proposal)
                # first-seen stamp happens HERE (receive path), not when the
                # state machine accepts — gossip latency is what we're after
                self.cons.flight.on_proposal(
                    msg.proposal.height, msg.proposal.round, peer.id
                )
                self.cons.send_peer_msg(msg, peer.id)
            elif isinstance(msg, ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
            elif isinstance(msg, BlockPartMessage):
                ps.set_has_proposal_block_part(msg.height, msg.round, msg.part.index)
                ps.stats_block_parts += 1
                self.cons.send_peer_msg(msg, peer.id)
            else:
                self.logger.error("unknown DATA msg %r", type(msg))
        elif chan_id == VOTE_CHANNEL:
            if self.fast_sync:
                return
            if isinstance(msg, VoteMessage):
                self._note_vote_arrival(msg.vote, peer.id)
                with self.cons._mtx:
                    height = self.cons.rs.height
                    val_size = self.cons.rs.validators.size
                    lc = self.cons.rs.last_commit
                    last_commit_size = lc.size if lc is not None else 0
                ps.ensure_vote_bit_arrays(height, val_size)
                ps.ensure_vote_bit_arrays(height - 1, last_commit_size)
                ps.set_has_vote(msg.vote)
                ps.stats_votes += 1
                self.cons.send_peer_msg(msg, peer.id)
            else:
                self.logger.error("unknown VOTE msg %r", type(msg))
        elif chan_id == VOTE_SET_BITS_CHANNEL:
            if self.fast_sync:
                return
            if isinstance(msg, VoteSetBitsMessage):
                with self.cons._mtx:
                    height, votes = self.cons.rs.height, self.cons.rs.votes
                our_votes = None
                if height == msg.height and votes is not None:
                    vs = (
                        votes.prevotes(msg.round)
                        if msg.type == SignedMsgType.PREVOTE
                        else votes.precommits(msg.round)
                    )
                    if vs is not None:
                        our_votes = vs.bit_array_by_block_id(msg.block_id)
                ps.apply_vote_set_bits(msg, our_votes)
            else:
                self.logger.error("unknown VOTE_SET_BITS msg %r", type(msg))

    def _handle_vote_set_maj23(self, peer, ps: PeerState, msg: VoteSetMaj23Message) -> None:
        with self.cons._mtx:
            height, votes = self.cons.rs.height, self.cons.rs.votes
        if height != msg.height or votes is None:
            return
        try:
            votes.set_peer_maj23(msg.round, SignedMsgType(msg.type), peer.id, msg.block_id)
        except Exception as e:
            if self.switch is not None:
                self.switch.stop_peer_for_error(peer, e)
            return
        vs = (
            votes.prevotes(msg.round)
            if msg.type == SignedMsgType.PREVOTE
            else votes.precommits(msg.round)
        )
        our_votes = vs.bit_array_by_block_id(msg.block_id) if vs is not None else None
        if our_votes is None:
            our_votes = BitArray(0)
        peer.try_send(
            VOTE_SET_BITS_CHANNEL,
            encode_msg(
                VoteSetBitsMessage(msg.height, msg.round, msg.type, msg.block_id, our_votes)
            ),
        )

    # -- event-driven broadcasts ---------------------------------------------------
    def _subscribe_broadcast_events(self) -> None:
        sub = "consensus-reactor"
        self.cons.evsw.add_listener_for_event(
            sub, EVENT_NEW_ROUND_STEP, lambda rs: self._broadcast_new_round_step(rs)
        )
        self.cons.evsw.add_listener_for_event(
            sub, EVENT_VALID_BLOCK, lambda rs: self._broadcast_new_valid_block(rs)
        )
        self.cons.evsw.add_listener_for_event(
            sub, EVENT_VOTE, lambda vote: self._broadcast_has_vote(vote)
        )

    def _make_round_step_message(self, rs) -> NewRoundStepMessage:
        lc_round = rs.last_commit.round if rs.last_commit is not None else -1
        secs = int(max(0.0, time.monotonic() - rs.start_time)) if rs.start_time else 0
        return NewRoundStepMessage(
            height=rs.height, round=rs.round, step=int(rs.step),
            seconds_since_start_time=secs, last_commit_round=lc_round,
        )

    def _broadcast_new_round_step(self, rs) -> None:
        if self.switch is not None:
            self.switch.broadcast(
                STATE_CHANNEL, encode_msg(self._make_round_step_message(rs))
            )

    def _broadcast_new_valid_block(self, rs) -> None:
        if self.switch is None or rs.proposal_block_parts is None:
            return
        msg = NewValidBlockMessage(
            height=rs.height,
            round=rs.round,
            block_parts_header=rs.proposal_block_parts.header(),
            block_parts=rs.proposal_block_parts.bit_array(),
            is_commit=rs.step == RoundStepType.COMMIT,
        )
        self.switch.broadcast(STATE_CHANNEL, encode_msg(msg))

    def _broadcast_has_vote(self, vote) -> None:
        if self.switch is not None:
            msg = HasVoteMessage(
                height=vote.height, round=vote.round, type=int(vote.vote_type),
                index=vote.validator_index,
            )
            self.switch.broadcast(STATE_CHANNEL, encode_msg(msg))

    # -- gossip threads --------------------------------------------------------------
    def _gossip_data_routine(self, peer, ps: PeerState) -> None:
        sleep = self.cons.config.peer_gossip_sleep_duration
        while peer.is_running and self.is_running:
            rs = self.cons.get_round_state()
            prs = ps.get_round_state()

            # 1. proposal block parts the peer lacks (same parts header)
            if rs.proposal_block_parts is not None and rs.proposal_block_parts.has_header(
                prs.proposal_block_parts_header
            ):
                index = (
                    rs.proposal_block_parts.bit_array()
                    .sub(prs.proposal_block_parts)
                    .pick_random()
                    if prs.proposal_block_parts is not None
                    else None
                )
                if index is not None:
                    part = rs.proposal_block_parts.get_part(index)
                    msg = BlockPartMessage(rs.height, rs.round, part)
                    if peer.send(DATA_CHANNEL, encode_msg(msg)):
                        ps.set_has_proposal_block_part(prs.height, prs.round, index)
                    continue

            # 2. peer on an earlier height: catch it up from the block store
            if 0 < prs.height < rs.height:
                if prs.proposal_block_parts is None:
                    meta = self.cons.block_store.load_block_meta(prs.height)
                    if meta is not None:
                        ps.init_proposal_block_parts(meta.block_id.parts_header)
                        continue
                else:
                    self._gossip_catchup(peer, ps, prs)
                    continue
                time.sleep(sleep)
                continue

            # 3. height/round mismatch: wait for the peer to move
            if rs.height != prs.height or rs.round != prs.round:
                time.sleep(sleep)
                continue

            # 4. the Proposal itself (+ POL prevote bitmap)
            if rs.proposal is not None and not prs.proposal:
                if peer.send(DATA_CHANNEL, encode_msg(ProposalMessage(rs.proposal))):
                    ps.set_has_proposal(rs.proposal)
                if rs.proposal.pol_round >= 0 and rs.votes is not None:
                    pol = rs.votes.prevotes(rs.proposal.pol_round)
                    if pol is not None:
                        peer.send(
                            DATA_CHANNEL,
                            encode_msg(
                                ProposalPOLMessage(
                                    rs.height, rs.proposal.pol_round, pol.bit_array()
                                )
                            ),
                        )
                continue

            time.sleep(sleep)

    def _gossip_catchup(self, peer, ps: PeerState, prs: PeerRoundState) -> None:
        """Send one block part of prs.height from our store (reactor.go:569)."""
        sleep = self.cons.config.peer_gossip_sleep_duration
        index = prs.proposal_block_parts.not_().pick_random()
        if index is None:
            time.sleep(sleep)
            return
        meta = self.cons.block_store.load_block_meta(prs.height)
        if meta is None or meta.block_id.parts_header != prs.proposal_block_parts_header:
            time.sleep(sleep)
            return
        part = self.cons.block_store.load_block_part(prs.height, index)
        if part is None:
            time.sleep(sleep)
            return
        msg = BlockPartMessage(prs.height, prs.round, part)
        if peer.send(DATA_CHANNEL, encode_msg(msg)):
            ps.set_has_proposal_block_part(prs.height, prs.round, index)

    def _gossip_votes_routine(self, peer, ps: PeerState) -> None:
        sleep = self.cons.config.peer_gossip_sleep_duration
        while peer.is_running and self.is_running:
            rs = self.cons.get_round_state()
            prs = ps.get_round_state()

            if rs.height == prs.height and self._gossip_votes_for_height(rs, prs, ps):
                continue

            # peer one height behind: our LastCommit has its precommits
            if prs.height != 0 and rs.height == prs.height + 1:
                if ps.pick_send_vote(rs.last_commit):
                    continue

            # peer further behind: send the stored commit votes
            if prs.height != 0 and rs.height >= prs.height + 2:
                commit = self.cons.block_store.load_block_commit(prs.height)
                if commit is not None and ps.pick_send_vote(
                    _CommitVoteSetView(commit, prs.height)
                ):
                    continue

            time.sleep(sleep)

    def _gossip_votes_for_height(self, rs, prs: PeerRoundState, ps: PeerState) -> bool:
        """reactor.go:683 gossipVotesForHeight — ordered preference."""
        if prs.step == RoundStepType.NEW_HEIGHT:
            if ps.pick_send_vote(rs.last_commit):
                return True
        if (
            prs.step <= RoundStepType.PROPOSE
            and prs.round != -1
            and prs.round <= rs.round
            and prs.proposal_pol_round != -1
        ):
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and ps.pick_send_vote(pol):
                return True
        if (
            prs.step <= RoundStepType.PREVOTE_WAIT
            and prs.round != -1
            and prs.round <= rs.round
        ):
            if ps.pick_send_vote(rs.votes.prevotes(prs.round)):
                return True
        if (
            prs.step <= RoundStepType.PRECOMMIT_WAIT
            and prs.round != -1
            and prs.round <= rs.round
        ):
            if ps.pick_send_vote(rs.votes.precommits(prs.round)):
                return True
        if prs.round != -1 and prs.round <= rs.round:
            if ps.pick_send_vote(rs.votes.prevotes(prs.round)):
                return True
        if prs.proposal_pol_round != -1:
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and ps.pick_send_vote(pol):
                return True
        return False

    def _query_maj23_routine(self, peer, ps: PeerState) -> None:
        """Liveness under signature DDoS: periodically tell peers which
        blocks have +2/3 so they can fill in missing votes (reactor.go:736)."""
        sleep = self.cons.config.peer_query_maj23_sleep_duration
        while peer.is_running and self.is_running:
            rs = self.cons.get_round_state()
            prs = ps.get_round_state()
            if rs.height == prs.height and rs.votes is not None:
                for t, vs in (
                    (SignedMsgType.PREVOTE, rs.votes.prevotes(prs.round)),
                    (SignedMsgType.PRECOMMIT, rs.votes.precommits(prs.round)),
                ):
                    maj23 = vs.two_thirds_majority() if vs is not None else None
                    if maj23 is not None:
                        peer.try_send(
                            STATE_CHANNEL,
                            encode_msg(
                                VoteSetMaj23Message(prs.height, prs.round, int(t), maj23)
                            ),
                        )
                if prs.proposal_pol_round >= 0:
                    pol = rs.votes.prevotes(prs.proposal_pol_round)
                    maj23 = pol.two_thirds_majority() if pol is not None else None
                    if maj23 is not None:
                        peer.try_send(
                            STATE_CHANNEL,
                            encode_msg(
                                VoteSetMaj23Message(
                                    prs.height, prs.proposal_pol_round,
                                    int(SignedMsgType.PREVOTE), maj23,
                                )
                            ),
                        )
            # catchup: tell a lagging peer the committed block had +2/3
            if (
                prs.height != 0
                and rs.height >= prs.height + 1
                and prs.height <= self.cons.block_store.height()
            ):
                commit = self.cons.block_store.load_block_commit(prs.height)
                if commit is not None:
                    peer.try_send(
                        STATE_CHANNEL,
                        encode_msg(
                            VoteSetMaj23Message(
                                prs.height, commit.round(),
                                int(SignedMsgType.PRECOMMIT), commit.block_id,
                            )
                        ),
                    )
            time.sleep(sleep)


class _CommitVoteSetView:
    """Adapts a stored Commit to the VoteSet reading surface pick_send_vote
    needs (the reference's types.VoteSetReader implemented by Commit)."""

    def __init__(self, commit, height: int):
        self._commit = commit
        self.height = height
        self.round = commit.round()
        self.signed_msg_type = SignedMsgType.PRECOMMIT
        self.size = len(commit.precommits)

    def is_commit(self) -> bool:
        return True

    def bit_array(self) -> BitArray:
        ba = BitArray(self.size)
        for i, pc in enumerate(self._commit.precommits):
            if pc is not None:
                ba.set_index(i, True)
        return ba

    def get_by_index(self, idx: int):
        return self._commit.precommits[idx]
