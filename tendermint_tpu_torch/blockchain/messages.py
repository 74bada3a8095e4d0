"""Fast-sync wire messages, channel 0x40 (ref blockchain/reactor.go:380-464),
the port's copy of the reference package's ``blockchain/messages.py``.

Each message is a 1-byte-tag uvarint followed by its codec body
(``encoding/codec.py``); a ``BlockResponseMessage`` carries
``Block.marshal()``. The bytes equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.types.block import Block


@dataclass
class BlockRequestMessage:
    height: int

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)

    @classmethod
    def decode(cls, r: Reader) -> "BlockRequestMessage":
        return cls(r.svarint())


@dataclass
class NoBlockResponseMessage:
    height: int

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)

    @classmethod
    def decode(cls, r: Reader) -> "NoBlockResponseMessage":
        return cls(r.svarint())


@dataclass
class BlockResponseMessage:
    block: Block

    def encode(self, w: Writer) -> None:
        w.bytes(self.block.marshal())

    @classmethod
    def decode(cls, r: Reader) -> "BlockResponseMessage":
        return cls(Block.unmarshal(r.bytes()))


@dataclass
class StatusRequestMessage:
    height: int  # the requester's current height (informational)

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)

    @classmethod
    def decode(cls, r: Reader) -> "StatusRequestMessage":
        return cls(r.svarint())


@dataclass
class StatusResponseMessage:
    height: int

    def encode(self, w: Writer) -> None:
        w.svarint(self.height)

    @classmethod
    def decode(cls, r: Reader) -> "StatusResponseMessage":
        return cls(r.svarint())


_REGISTRY = [
    BlockRequestMessage,
    NoBlockResponseMessage,
    BlockResponseMessage,
    StatusRequestMessage,
    StatusResponseMessage,
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
    if not (1 <= tag <= len(_REGISTRY)):
        raise ValueError(f"unknown blockchain message tag {tag}")
    return _REGISTRY[tag - 1].decode(r)
