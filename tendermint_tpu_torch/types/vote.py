"""Vote: a prevote or precommit from one validator (ref types/vote.go),
with the wire codec, the error family and the single-vote ``verify`` of
the reference package's ``types/vote.py``."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from tendermint_tpu_torch.crypto.keys import PubKey
from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.types.core import (
    BlockID,
    SignedMsgType,
    canonical_vote_sign_bytes,
)


class VoteError(Exception):
    pass


class ErrVoteInvalidValidatorIndex(VoteError):
    pass


class ErrVoteInvalidValidatorAddress(VoteError):
    pass


class ErrVoteInvalidSignature(VoteError):
    pass


class ErrVoteNonDeterministicSignature(VoteError):
    pass


class ErrVoteConflictingVotes(VoteError):
    """Same validator, same height, round and type, different blocks: the
    material of duplicate-vote evidence. ``added`` says whether the vote
    still entered a block's tally (a peer claimed +2/3 for that block)."""

    def __init__(self, vote_a: "Vote", vote_b: "Vote", pub_key: Optional[PubKey] = None):
        super().__init__(f"conflicting votes from validator {vote_a.validator_address.hex()}")
        self.vote_a = vote_a
        self.vote_b = vote_b
        self.pub_key = pub_key


@dataclass(frozen=True)
class Vote:
    vote_type: SignedMsgType
    height: int
    round: int
    timestamp_ns: int
    block_id: BlockID
    validator_address: bytes
    validator_index: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_vote_sign_bytes(
            chain_id,
            self.vote_type,
            self.height,
            self.round,
            self.timestamp_ns,
            self.block_id,
        )

    def verify(self, chain_id: str, pub_key: PubKey) -> None:
        """Raises on a wrong address or signature (ref vote.go:102): the
        single-vote path; batched paths verify the sign-bytes in a batch."""
        if pub_key.address() != self.validator_address:
            raise ErrVoteInvalidValidatorAddress()
        if not pub_key.verify_bytes(self.sign_bytes(chain_id), self.signature):
            raise ErrVoteInvalidSignature()

    def with_signature(self, sig: bytes) -> "Vote":
        return replace(self, signature=sig)

    def encode(self, w: Writer) -> None:
        w.uvarint(int(self.vote_type)).svarint(self.height).svarint(self.round)
        w.fixed64(self.timestamp_ns)
        self.block_id.encode(w)
        w.bytes(self.validator_address).uvarint(self.validator_index)
        w.bytes(self.signature)

    def marshal(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "Vote":
        return cls(
            vote_type=SignedMsgType(r.uvarint()),
            height=r.svarint(),
            round=r.svarint(),
            timestamp_ns=r.fixed64(),
            block_id=BlockID.decode(r),
            validator_address=r.bytes(),
            validator_index=r.uvarint(),
            signature=r.bytes(),
        )

    @classmethod
    def unmarshal(cls, data: bytes) -> "Vote":
        return cls.decode(Reader(data))
