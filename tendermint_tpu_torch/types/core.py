"""BlockID, PartSetHeader, signed-message types and canonical vote
sign-bytes (field order of the reference's CanonicalVote, types/canonical.go:
type, height and round as fixed64, timestamp, block id, chain id), with the
codec of the reference package's ``types/core.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from tendermint_tpu_torch.encoding.codec import Reader, Writer


class SignedMsgType(IntEnum):
    PREVOTE = 0x01
    PRECOMMIT = 0x02
    PROPOSAL = 0x20
    HEARTBEAT = 0x30


def is_vote_type_valid(t: int) -> bool:
    return t in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT)


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def encode(self, w: Writer) -> None:
        w.uvarint(self.total).bytes(self.hash)

    @classmethod
    def decode(cls, r: Reader) -> "PartSetHeader":
        return cls(total=r.uvarint(), hash=r.bytes())


@dataclass(frozen=True)
class BlockID:
    """Block hash plus the part-set header it was gossiped under; a zero
    BlockID marks a nil vote."""

    hash: bytes = b""
    parts_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.parts_header.is_zero()

    def key(self) -> bytes:
        """Stable map key: the encoded BlockID (the reference keys on the
        amino encoding)."""
        w = Writer()
        self.encode(w)
        return w.build()

    def encode(self, w: Writer) -> None:
        w.bytes(self.hash)
        self.parts_header.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "BlockID":
        return cls(hash=r.bytes(), parts_header=PartSetHeader.decode(r))


def canonical_vote_sign_bytes(
    chain_id: str,
    vote_type: int,
    height: int,
    round: int,
    timestamp_ns: int,
    block_id: BlockID,
) -> bytes:
    w = Writer()
    w.uvarint(int(vote_type)).fixed64(height).fixed64(round).fixed64(timestamp_ns)
    block_id.encode(w)
    w.string(chain_id)
    return w.build()
