"""State-sync wire messages on channel 0x60 (v0.34 statesync lineage), the
port's copy of the reference package's ``statesync/messages.py``:
SnapshotsRequest/Response and ChunkRequest/Response, plus a light-block
fetch so that the restoring node's light client and commit backfill ride
the same channel. A 1-byte tag and a codec body, as the blockchain
registry; every message encodes to the reference's bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.statesync.store import decode_snapshot, encode_snapshot

MAX_OFFERS_IN_RESPONSE = 64


@dataclass
class SnapshotsRequestMessage:
    """Ask a peer for its snapshot offers."""

    def encode(self, w: Writer) -> None:
        pass

    @classmethod
    def decode(cls, r: Reader) -> "SnapshotsRequestMessage":
        return cls()


@dataclass
class SnapshotsResponseMessage:
    snapshots: List[abci.Snapshot] = field(default_factory=list)

    def encode(self, w: Writer) -> None:
        w.uvarint(len(self.snapshots))
        for s in self.snapshots:
            encode_snapshot(w, s)

    @classmethod
    def decode(cls, r: Reader) -> "SnapshotsResponseMessage":
        n = r.uvarint()
        if n > MAX_OFFERS_IN_RESPONSE:
            raise ValueError(f"too many snapshot offers ({n})")
        return cls([decode_snapshot(r) for _ in range(n)])


@dataclass
class ChunkRequestMessage:
    height: int
    format: int
    index: int

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)
        w.uvarint(self.format)
        w.uvarint(self.index)

    @classmethod
    def decode(cls, r: Reader) -> "ChunkRequestMessage":
        return cls(r.svarint(), r.uvarint(), r.uvarint())


@dataclass
class ChunkResponseMessage:
    height: int
    format: int
    index: int
    chunk: bytes = b""
    missing: bool = False  # the peer does not hold this chunk

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)
        w.uvarint(self.format)
        w.uvarint(self.index)
        w.bytes(self.chunk)
        w.bool(self.missing)

    @classmethod
    def decode(cls, r: Reader) -> "ChunkResponseMessage":
        return cls(r.svarint(), r.uvarint(), r.uvarint(), r.bytes(), r.bool())


@dataclass
class LightBlockRequestMessage:
    height: int

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)

    @classmethod
    def decode(cls, r: Reader) -> "LightBlockRequestMessage":
        return cls(r.svarint())


@dataclass
class LightBlockResponseMessage:
    height: int
    full_commit: bytes = b""  # FullCommit.marshal(); empty: not available

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)
        w.bytes(self.full_commit)

    @classmethod
    def decode(cls, r: Reader) -> "LightBlockResponseMessage":
        return cls(r.svarint(), r.bytes())


_REGISTRY = [
    SnapshotsRequestMessage,
    SnapshotsResponseMessage,
    ChunkRequestMessage,
    ChunkResponseMessage,
    LightBlockRequestMessage,
    LightBlockResponseMessage,
]
_TAG = {cls: i + 1 for i, cls in enumerate(_REGISTRY)}


def encode_msg(msg) -> bytes:
    w = Writer()
    w.uvarint(_TAG[type(msg)])
    msg.encode(w)
    return w.build()


def unmarshal_msg(data: bytes):
    r = Reader(data)
    tag = r.uvarint()
    if not 1 <= tag <= len(_REGISTRY):
        raise ValueError(f"unknown statesync message tag {tag}")
    return _REGISTRY[tag - 1].decode(r)
