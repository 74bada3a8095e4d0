"""Light-client records (ref lite/commit.go:16 FullCommit, types/block.go
SignedHeader; the port's copy of the reference package's ``lite/types.py``).

A FullCommit is everything needed to trust one height without replaying the
chain: the signed header, the validator set that signed it, and the next
validator set, whose hash the header commits to (the hand-off for trust
propagation).
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.types.block import Commit, Header
from tendermint_tpu_torch.types.validator_set import ValidatorSet


class LiteError(Exception):
    pass


@dataclass
class SignedHeader:
    """A header and the commit that signed it."""

    header: Header
    commit: Commit

    @property
    def height(self) -> int:
        return self.header.height

    def validate_basic(self, chain_id: str) -> None:
        if self.header is None or self.commit is None:
            raise LiteError("incomplete signed header")
        if self.header.chain_id != chain_id:
            raise LiteError(f"wrong chain id: {self.header.chain_id} != {chain_id}")
        if self.commit.height() != self.header.height:
            raise LiteError(
                f"commit height {self.commit.height()} != header {self.header.height}"
            )
        if self.commit.block_id.hash != self.header.hash():
            raise LiteError("commit signs a different header")

    def encode(self, w: Writer) -> None:
        self.header.encode(w)
        self.commit.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "SignedHeader":
        return cls(Header.decode(r), Commit.decode(r))


@dataclass
class FullCommit:
    """A SignedHeader with its validator sets."""

    signed_header: SignedHeader
    validators: ValidatorSet
    next_validators: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    def validate_full(self, chain_id: str) -> None:
        """Internal consistency only (lite/commit.go ValidateFull); the
        signatures are the verifiers' job."""
        self.signed_header.validate_basic(chain_id)
        if self.signed_header.header.validators_hash != self.validators.hash():
            raise LiteError("header validators_hash != validators")
        if self.signed_header.header.next_validators_hash != self.next_validators.hash():
            raise LiteError("header next_validators_hash != next_validators")

    def encode(self, w: Writer) -> None:
        self.signed_header.encode(w)
        self.validators.encode(w)
        self.next_validators.encode(w)

    def marshal(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "FullCommit":
        return cls(SignedHeader.decode(r), ValidatorSet.decode(r), ValidatorSet.decode(r))

    @classmethod
    def unmarshal(cls, data: bytes) -> "FullCommit":
        return cls.decode(Reader(data))
