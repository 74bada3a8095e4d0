"""Consensus round types: RoundStepType, RoundState, HeightVoteSet (ref
consensus/types/round_state.go, height_vote_set.go), the port's copy of the
reference package's ``consensus/cstypes.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import IntEnum
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import VoteSet


class RoundStepType(IntEnum):
    """round_state.go:21 — ordered progression within a round."""

    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


class GotVoteFromUnwantedRoundError(Exception):
    pass


@dataclass
class RoundVoteSet:
    prevotes: VoteSet
    precommits: VoteSet


class HeightVoteSet:
    """Prevotes+precommits for every round of one height; tracks up to 2
    catchup rounds per peer (height_vote_set.go:37)."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self._mtx = threading.RLock()
        self.reset(height, val_set)

    def reset(self, height: int, val_set: ValidatorSet) -> None:
        with self._mtx:
            self.height = height
            self.val_set = val_set
            self._round_vote_sets: Dict[int, RoundVoteSet] = {}
            self._peer_catchup_rounds: Dict[str, List[int]] = {}
            self._add_round(0)
            self.round = 0

    def _add_round(self, round: int) -> None:
        if round in self._round_vote_sets:
            raise AssertionError("addRound for existing round")
        self._round_vote_sets[round] = RoundVoteSet(
            prevotes=VoteSet(self.chain_id, self.height, round,
                             SignedMsgType.PREVOTE, self.val_set),
            precommits=VoteSet(self.chain_id, self.height, round,
                               SignedMsgType.PRECOMMIT, self.val_set),
        )

    def set_round(self, round: int) -> None:
        """Track rounds up to `round` (+1 in callers for round-skip)."""
        with self._mtx:
            if self.round != 0 and round < self.round + 1:
                raise AssertionError("set_round must increment round")
            for r in range(self.round + 1, round + 1):
                if r not in self._round_vote_sets:
                    self._add_round(r)
            self.round = round

    def add_vote(self, vote: Vote, peer_id: str = "",
                 verified: bool = False) -> bool:
        """Raises VoteError subclasses; returns added.  Unknown rounds are
        created lazily, at most 2 catchup rounds per peer.  `verified=True`
        is the batched-verification seam: the signature already checked on
        the device, so the VoteSet skips the per-vote host verify (structural
        prevalidation still reruns)."""
        with self._mtx:
            vs = self.vote_set_for(vote, peer_id)
            return vs.add_vote(vote, verified=verified)

    def vote_set_for(self, vote: Vote, peer_id: str = "") -> VoteSet:
        """Resolve (creating catchup rounds against the same 2-per-peer
        budget `add_vote` enforces) the VoteSet this vote belongs to — the
        vote micro-batcher prevalidates against it before submitting the
        signature for batched verification."""
        with self._mtx:
            vs = self._get_vote_set(vote.round, vote.vote_type)
            if vs is None:
                rounds = self._peer_catchup_rounds.get(peer_id, [])
                if len(rounds) < 2:
                    self._add_round(vote.round)
                    vs = self._get_vote_set(vote.round, vote.vote_type)
                    rounds.append(vote.round)
                    self._peer_catchup_rounds[peer_id] = rounds
                else:
                    raise GotVoteFromUnwantedRoundError()
            return vs

    def prevotes(self, round: int) -> Optional[VoteSet]:
        with self._mtx:
            return self._get_vote_set(round, SignedMsgType.PREVOTE)

    def precommits(self, round: int) -> Optional[VoteSet]:
        with self._mtx:
            return self._get_vote_set(round, SignedMsgType.PRECOMMIT)

    def pol_info(self) -> Tuple[int, BlockID]:
        """Highest round with a prevote maj23, or (-1, zero)."""
        with self._mtx:
            for r in range(self.round, -1, -1):
                rvs = self._get_vote_set(r, SignedMsgType.PREVOTE)
                if rvs is not None:
                    maj = rvs.two_thirds_majority()
                    if maj is not None:
                        return r, maj
            return -1, BlockID()

    def _get_vote_set(self, round: int, t: SignedMsgType) -> Optional[VoteSet]:
        rvs = self._round_vote_sets.get(round)
        if rvs is None:
            return None
        return rvs.prevotes if t == SignedMsgType.PREVOTE else rvs.precommits

    def set_peer_maj23(self, round: int, t: SignedMsgType, peer_id: str, block_id: BlockID) -> None:
        with self._mtx:
            if round not in self._round_vote_sets:
                self._add_round(round)
                # peer-claimed rounds also count against catchup budget
                rounds = self._peer_catchup_rounds.get(peer_id, [])
                if round not in rounds and len(rounds) < 2:
                    rounds.append(round)
                    self._peer_catchup_rounds[peer_id] = rounds
            vs = self._get_vote_set(round, t)
            if vs is not None:
                vs.set_peer_maj23(peer_id, block_id)


@dataclass
class RoundState:
    """The consensus-internal view (round_state.go:67). Owned by the single
    receive routine."""

    height: int = 0
    round: int = 0
    step: RoundStepType = RoundStepType.NEW_HEIGHT
    start_time: float = 0.0
    commit_time: float = 0.0
    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    last_validators: Optional[ValidatorSet] = None
    triggered_timeout_precommit: bool = False

    def event(self) -> dict:
        return {
            "height": self.height,
            "round": self.round,
            "step": self.step.name,
        }
