"""VoteSet: the votes of one (height, round, type) from a validator set,
and its +2/3 majorities (ref types/vote_set.go); the port's copy of the
reference package's ``types/vote_set.py``.

As in the reference:
  * one vote per validator index; a conflicting vote (same height, round
    and type, another block) raises ErrVoteConflictingVotes carrying both
    votes, the material of duplicate-vote evidence (vote_set.go:142-291);
  * a conflicting vote still enters a block's tally when some peer
    claimed +2/3 for that block (``set_peer_maj23``);
  * maj23 latches the first block to cross 2/3 of the total power;
  * ``make_commit`` emits the Commit of the main tally (vote_set.go:531).

``prevalidate`` is everything ``add_vote`` decides before the signature
check; the batched path (``parallel/planner.VoteFeed``) verifies the
signature in a batch and applies the verdict with
``add_vote(vote, verified=True)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from tendermint_tpu_torch.libs.bit_array import BitArray
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType, is_vote_type_valid
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import (
    ErrVoteConflictingVotes,
    ErrVoteInvalidSignature,
    ErrVoteInvalidValidatorAddress,
    ErrVoteInvalidValidatorIndex,
    ErrVoteNonDeterministicSignature,
    Vote,
    VoteError,
)


class ErrVoteUnexpectedStep(VoteError):
    pass


@dataclass(frozen=True)
class PendingVote:
    """A vote that passed the structural checks and needs only its
    signature checked: (pub_key, sign-bytes, signature) go to a batch, and
    the verdict comes back through ``add_vote(vote, verified=True)``."""

    vote: Vote
    pub_key: object
    voting_power: int


@dataclass
class _BlockVotes:
    """The tally of one BlockID within the set."""

    peer_maj23: bool
    bit_array: BitArray
    votes: List[Optional[Vote]]
    sum: int = 0

    @classmethod
    def new(cls, peer_maj23: bool, num_validators: int) -> "_BlockVotes":
        return cls(
            peer_maj23=peer_maj23,
            bit_array=BitArray(num_validators),
            votes=[None] * num_validators,
        )

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round: int,
        signed_msg_type: SignedMsgType,
        val_set: ValidatorSet,
    ):
        if height == 0:
            raise ValueError("cannot make VoteSet for height == 0")
        if not is_vote_type_valid(signed_msg_type):
            raise ValueError("invalid vote type")
        self.chain_id = chain_id
        self.height = height
        self.round = round
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set

        n = val_set.size
        self._votes_bit_array = BitArray(n)
        self._votes: List[Optional[Vote]] = [None] * n
        self._sum = 0
        self._maj23: Optional[BlockID] = None
        self._votes_by_block: Dict[bytes, _BlockVotes] = {}
        self._peer_maj23s: Dict[str, BlockID] = {}

    # queries --------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.val_set.size

    def bit_array(self) -> BitArray:
        return self._votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        bv = self._votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv else None

    def get_by_index(self, idx: int) -> Optional[Vote]:
        if 0 <= idx < len(self._votes):
            return self._votes[idx]
        return None

    def get_by_address(self, address: bytes) -> Optional[Vote]:
        idx, _ = self.val_set.get_by_address(address)
        return self.get_by_index(idx) if idx >= 0 else None

    @property
    def sum(self) -> int:
        """Voting power in the main tally (one vote per validator)."""
        return self._sum

    def sum_by_block_id(self, block_id: BlockID) -> int:
        """Tallied power for one block: whether a pending vote could
        complete its +2/3 is the vote feed's quorum-flush question."""
        bv = self._votes_by_block.get(block_id.key())
        return bv.sum if bv is not None else 0

    def has_two_thirds_majority(self) -> bool:
        return self._maj23 is not None

    def two_thirds_majority(self) -> Optional[BlockID]:
        return self._maj23

    def has_two_thirds_any(self) -> bool:
        return self._sum * 3 > self.val_set.total_voting_power() * 2

    def has_all(self) -> bool:
        return self._sum == self.val_set.total_voting_power()

    def is_commit(self) -> bool:
        return (
            self.signed_msg_type == SignedMsgType.PRECOMMIT
            and self._maj23 is not None
        )

    # mutation -------------------------------------------------------------
    def add_vote(self, vote: Optional[Vote], verified: bool = False) -> bool:
        """True if the vote was added, False for an exact duplicate; raises
        a VoteError subclass on an invalid or conflicting vote (ref
        vote_set.go:131-291). ``verified=True`` skips the signature check
        (a batch already paid it); the structural checks run again, so a
        duplicate that raced in between is rejected as the serial path
        would reject it."""
        pending = self.prevalidate(vote)
        if pending is None:
            return False  # duplicate
        if not verified:
            vote.verify(self.chain_id, pending.pub_key)
        return self._add_verified_vote(vote, pending.voting_power)

    def prevalidate(self, vote: Optional[Vote]) -> Optional[PendingVote]:
        """What ``add_vote`` decides before the signature check: index,
        address and step, then the dedup. None for an exact duplicate; the
        serial path's VoteError subclasses otherwise; else the key and power
        the signature check needs."""
        if vote is None:
            raise VoteError("nil vote")
        idx = vote.validator_index
        if idx < 0:
            raise ErrVoteInvalidValidatorIndex()
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.vote_type != self.signed_msg_type
        ):
            raise ErrVoteUnexpectedStep(
                f"expected {self.height}/{self.round}/{self.signed_msg_type}"
            )
        addr, val = self.val_set.get_by_index(idx)
        if val is None:
            raise ErrVoteInvalidValidatorIndex()
        if addr != vote.validator_address:
            raise ErrVoteInvalidValidatorAddress()

        # dedup before the signature check (ref getVote: the main tally and
        # this block's tracker)
        key = vote.block_id.key()
        existing = self._get_vote(idx, key)
        if existing is not None:
            if existing.signature == vote.signature:
                return None  # duplicate
            raise ErrVoteNonDeterministicSignature()

        # the same signature under another tracked block: that copy verified
        # over its own sign-bytes, which differ from this vote's, so one
        # signature cannot cover both; reject before paying a verification
        if self._get_same_signature(idx, vote.signature, key) is not None:
            raise ErrVoteInvalidSignature()

        return PendingVote(vote=vote, pub_key=val.pub_key,
                           voting_power=val.voting_power)

    def _get_same_signature(
        self, idx: int, signature: bytes, exclude_key: bytes
    ) -> Optional[Vote]:
        """A tracked vote of validator ``idx`` carrying ``signature`` for a
        block other than ``exclude_key`` (main tally and every tracker)."""
        existing = self._votes[idx]
        if (
            existing is not None
            and existing.signature == signature
            and existing.block_id.key() != exclude_key
        ):
            return existing
        for k, bv in self._votes_by_block.items():
            if k == exclude_key:
                continue
            tracked = bv.get_by_index(idx)
            if tracked is not None and tracked.signature == signature:
                return tracked
        return None

    def _get_vote(self, idx: int, key: bytes) -> Optional[Vote]:
        existing = self._votes[idx]
        if existing is not None and existing.block_id.key() == key:
            return existing
        bv = self._votes_by_block.get(key)
        if bv is not None:
            return bv.get_by_index(idx)
        return None

    def _add_verified_vote(self, vote: Vote, voting_power: int) -> bool:
        """vote_set.go:218-291 addVerifiedVote. A conflicting vote raises
        ErrVoteConflictingVotes, but when its block is tracked with a peer
        maj23 claim it still enters that block's tally first (and replaces
        the main-tally vote if that block already latched maj23); the
        exception's ``added`` says so."""
        idx = vote.validator_index
        key = vote.block_id.key()
        conflicting: Optional[Vote] = None

        existing = self._votes[idx]
        if existing is not None:
            # same-block duplicates were rejected by _get_vote upstream
            conflicting = existing
            if self._maj23 is not None and self._maj23.key() == key:
                self._votes[idx] = vote
                self._votes_bit_array.set_index(idx, True)
        else:
            self._votes[idx] = vote
            self._votes_bit_array.set_index(idx, True)
            self._sum += voting_power

        bv = self._votes_by_block.get(key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                # a conflict, and no peer claims this block is special
                err = ErrVoteConflictingVotes(conflicting, vote)
                err.added = False
                raise err
        else:
            if conflicting is not None:
                # not even tracking this block
                err = ErrVoteConflictingVotes(conflicting, vote)
                err.added = False
                raise err
            bv = _BlockVotes.new(peer_maj23=False, num_validators=self.val_set.size)
            self._votes_by_block[key] = bv

        orig_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, voting_power)

        if orig_sum < quorum <= bv.sum and self._maj23 is None:
            # only the first quorum latches; its votes join the main tally
            self._maj23 = vote.block_id
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self._votes[i] = v

        if conflicting is not None:
            err = ErrVoteConflictingVotes(conflicting, vote)
            err.added = True
            raise err
        return True

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims +2/3 for block_id: track conflicting votes for that
        block (ref vote_set.go SetPeerMaj23)."""
        existing = self._peer_maj23s.get(peer_id)
        if existing is not None:
            if existing == block_id:
                return
            raise VoteError(f"peer {peer_id} changed its maj23 claim")
        self._peer_maj23s[peer_id] = block_id
        bv = self._votes_by_block.get(block_id.key())
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self._votes_by_block[block_id.key()] = _BlockVotes.new(
                peer_maj23=True, num_validators=self.val_set.size
            )

    def make_commit(self) -> Commit:
        if self.signed_msg_type != SignedMsgType.PRECOMMIT:
            raise VoteError("cannot MakeCommit() unless VoteSet is precommits")
        if self._maj23 is None:
            raise VoteError("cannot MakeCommit() unless a blockhash has +2/3")
        # the main tally, not the block's tracker (vote_set.go:543): stray
        # precommits for other blocks ride along to measure availability
        return Commit(block_id=self._maj23, precommits=list(self._votes))

    def __str__(self) -> str:
        t = "Prevote" if self.signed_msg_type == SignedMsgType.PREVOTE else "Precommit"
        return (
            f"VoteSet{{H:{self.height} R:{self.round} {t} "
            f"{self._votes_bit_array} sum:{self._sum}}}"
        )
