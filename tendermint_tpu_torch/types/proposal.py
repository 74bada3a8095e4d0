"""Proposal and Heartbeat, the proposer's signables (ref types/proposal.go,
types/heartbeat.go), the port's copy of the reference package's
``types/proposal.py``: the same fields, sign-bytes and codec."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.types.core import (
    BlockID,
    PartSetHeader,
    canonical_heartbeat_sign_bytes,
    canonical_proposal_sign_bytes,
)


@dataclass(frozen=True)
class Proposal:
    """Proposes a new block, signed by the round's proposer (proposal.go:17).
    BlockID carries the block hash + part-set header; if pol_round >= 0 it is
    the block locked in that round.  The signature covers EVERY
    consensus-meaningful field, block_id included (canonical.go:25-33)."""

    height: int
    round: int
    timestamp_ns: int
    block_id: BlockID
    pol_round: int = -1
    signature: bytes = b""

    @property
    def block_parts_header(self) -> PartSetHeader:
        return self.block_id.parts_header

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_proposal_sign_bytes(
            chain_id,
            self.height,
            self.round,
            self.pol_round,
            self.timestamp_ns,
            self.block_id,
        )

    def with_signature(self, sig: bytes) -> "Proposal":
        return replace(self, signature=sig)

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative height")
        if self.round < 0:
            raise ValueError("negative round")
        if self.pol_round < -1:
            raise ValueError("POLRound < -1")
        self.block_id.validate_basic()

    def encode(self, w: Writer) -> None:
        w.svarint(self.height).svarint(self.round).fixed64(self.timestamp_ns)
        self.block_id.encode(w)
        w.svarint(self.pol_round)
        w.bytes(self.signature)

    def marshal(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "Proposal":
        return cls(
            height=r.svarint(),
            round=r.svarint(),
            timestamp_ns=r.fixed64(),
            block_id=BlockID.decode(r),
            pol_round=r.svarint(),
            signature=r.bytes(),
        )

    @classmethod
    def unmarshal(cls, data: bytes) -> "Proposal":
        return cls.decode(Reader(data))

    def __str__(self) -> str:
        return (
            f"Proposal{{{self.height}/{self.round} "
            f"{self.block_id.hash.hex()[:12]} (POL {self.pol_round})}}"
        )


@dataclass(frozen=True)
class Heartbeat:
    """Proposer liveness signal (types/heartbeat.go)."""

    validator_address: bytes
    validator_index: int
    height: int
    round: int
    sequence: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_heartbeat_sign_bytes(
            chain_id,
            self.height,
            self.round,
            self.sequence,
            self.validator_address,
            self.validator_index,
        )

    def with_signature(self, sig: bytes) -> "Heartbeat":
        return replace(self, signature=sig)

    def encode(self, w: Writer) -> None:
        w.bytes(self.validator_address).uvarint(self.validator_index)
        w.svarint(self.height).svarint(self.round).svarint(self.sequence)
        w.bytes(self.signature)

    def marshal(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "Heartbeat":
        return cls(
            validator_address=r.bytes(),
            validator_index=r.uvarint(),
            height=r.svarint(),
            round=r.svarint(),
            sequence=r.svarint(),
            signature=r.bytes(),
        )
