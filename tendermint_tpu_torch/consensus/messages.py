"""Consensus wire and WAL messages (ref consensus/reactor.go:1405-1679 and
the TimedWALMessage kinds of consensus/wal.go), the port's copy of the
reference package's ``consensus/messages.py``: the same classes, registry
tags and bytes.

One registry serves the WAL and the p2p reactor: every message is a
uvarint tag and a deterministic body in the framework codec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.libs.bit_array import BitArray
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader
from tendermint_tpu_torch.types.part_set import Part
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote


@dataclass
class NewRoundStepMessage:
    """Peer state sync (reactor.go NewRoundStepMessage)."""

    height: int
    round: int
    step: int
    seconds_since_start_time: int
    last_commit_round: int

    def encode(self, w: Writer) -> None:
        w.svarint(self.height).svarint(self.round).uvarint(self.step)
        w.svarint(self.seconds_since_start_time).svarint(self.last_commit_round)

    @classmethod
    def decode(cls, r: Reader) -> "NewRoundStepMessage":
        return cls(r.svarint(), r.svarint(), r.uvarint(), r.svarint(), r.svarint())


@dataclass
class CommitStepMessage:
    height: int
    block_parts_header: PartSetHeader
    block_parts: BitArray

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)
        self.block_parts_header.encode(w)
        self.block_parts.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "CommitStepMessage":
        return cls(r.svarint(), PartSetHeader.decode(r), BitArray.decode(r))


@dataclass
class ProposalMessage:
    proposal: Proposal

    def encode(self, w: Writer) -> None:
        self.proposal.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "ProposalMessage":
        return cls(Proposal.decode(r))


@dataclass
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: BitArray

    def encode(self, w: Writer) -> None:
        w.svarint(self.height).svarint(self.proposal_pol_round)
        self.proposal_pol.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "ProposalPOLMessage":
        return cls(r.svarint(), r.svarint(), BitArray.decode(r))


@dataclass
class BlockPartMessage:
    height: int
    round: int
    part: Part

    def encode(self, w: Writer) -> None:
        w.svarint(self.height).svarint(self.round)
        self.part.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "BlockPartMessage":
        return cls(r.svarint(), r.svarint(), Part.decode(r))


@dataclass
class VoteMessage:
    vote: Vote

    def encode(self, w: Writer) -> None:
        self.vote.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "VoteMessage":
        return cls(Vote.decode(r))


@dataclass
class HasVoteMessage:
    height: int
    round: int
    type: int
    index: int

    def encode(self, w: Writer) -> None:
        w.svarint(self.height).svarint(self.round).uvarint(self.type).svarint(self.index)

    @classmethod
    def decode(cls, r: Reader) -> "HasVoteMessage":
        return cls(r.svarint(), r.svarint(), r.uvarint(), r.svarint())


@dataclass
class VoteSetMaj23Message:
    height: int
    round: int
    type: int
    block_id: BlockID

    def encode(self, w: Writer) -> None:
        w.svarint(self.height).svarint(self.round).uvarint(self.type)
        self.block_id.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "VoteSetMaj23Message":
        return cls(r.svarint(), r.svarint(), r.uvarint(), BlockID.decode(r))


@dataclass
class VoteSetBitsMessage:
    height: int
    round: int
    type: int
    block_id: BlockID
    votes: BitArray

    def encode(self, w: Writer) -> None:
        w.svarint(self.height).svarint(self.round).uvarint(self.type)
        self.block_id.encode(w)
        self.votes.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "VoteSetBitsMessage":
        return cls(r.svarint(), r.svarint(), r.uvarint(), BlockID.decode(r), BitArray.decode(r))


# WAL-only records -----------------------------------------------------------


@dataclass
class TimeoutInfo:
    """ticker.go timeoutInfo."""

    duration: float  # seconds
    height: int
    round: int
    step: int  # RoundStepType value

    def encode(self, w: Writer) -> None:
        w.fixed64(int(self.duration * 1e9))
        w.svarint(self.height).svarint(self.round).uvarint(self.step)

    @classmethod
    def decode(cls, r: Reader) -> "TimeoutInfo":
        return cls(r.fixed64() / 1e9, r.svarint(), r.svarint(), r.uvarint())


@dataclass
class EndHeightMessage:
    """#ENDHEIGHT marker: blockstore has saved the block (wal.go)."""

    height: int

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)

    @classmethod
    def decode(cls, r: Reader) -> "EndHeightMessage":
        return cls(r.svarint())


@dataclass
class EventRoundStep:
    """newStep WAL record (replaces reference's RoundStateEvent in the WAL)."""

    height: int
    round: int
    step: int

    def encode(self, w: Writer) -> None:
        w.svarint(self.height).svarint(self.round).uvarint(self.step)

    @classmethod
    def decode(cls, r: Reader) -> "EventRoundStep":
        return cls(r.svarint(), r.svarint(), r.uvarint())


@dataclass
class MsgInfo:
    """Queued consensus input: a message + its origin ('' = self)."""

    msg: object
    peer_id: str = ""

    def encode(self, w: Writer) -> None:
        w.string(self.peer_id)
        encode_msg(self.msg, w)

    @classmethod
    def decode(cls, r: Reader) -> "MsgInfo":
        peer_id = r.string()
        return cls(decode_msg(r), peer_id)


@dataclass
class NewValidBlockMessage:
    """Block-parts availability for the polka'd block (reactor.go:1444
    NewValidBlockMessage): lets peers fetch a valid/committed block's parts
    even after the round moved on."""

    height: int
    round: int
    block_parts_header: PartSetHeader
    block_parts: BitArray
    is_commit: bool

    def encode(self, w: Writer) -> None:
        w.svarint(self.height).svarint(self.round)
        self.block_parts_header.encode(w)
        self.block_parts.encode(w)
        w.bool(self.is_commit)

    @classmethod
    def decode(cls, r: Reader) -> "NewValidBlockMessage":
        return cls(
            r.svarint(), r.svarint(), PartSetHeader.decode(r), BitArray.decode(r),
            r.bool(),
        )


_REGISTRY = [
    NewRoundStepMessage,
    CommitStepMessage,
    ProposalMessage,
    ProposalPOLMessage,
    BlockPartMessage,
    VoteMessage,
    HasVoteMessage,
    VoteSetMaj23Message,
    VoteSetBitsMessage,
    TimeoutInfo,
    EndHeightMessage,
    EventRoundStep,
    MsgInfo,
    NewValidBlockMessage,  # appended: registry tags are append-only (WAL compat)
]
_TAG = {cls: i + 1 for i, cls in enumerate(_REGISTRY)}


def encode_msg(msg, w: Optional[Writer] = None) -> bytes:
    own = w is None
    if own:
        w = Writer()
    w.uvarint(_TAG[type(msg)])
    msg.encode(w)
    return w.build() if own else b""


def decode_msg(r: Reader):
    tag = r.uvarint()
    if not (1 <= tag <= len(_REGISTRY)):
        raise ValueError(f"unknown consensus message tag {tag}")
    return _REGISTRY[tag - 1].decode(r)


def unmarshal_msg(data: bytes):
    return decode_msg(Reader(data))
