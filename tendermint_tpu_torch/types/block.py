"""Header and Commit (ref types/block.go), with the hashes and wire codec
of the reference package's ``types/block.py``. ``Header.hash`` is the Merkle
root (``crypto/merkle.py``) of the encoded fields in declaration order;
``Commit.precommits[i]`` indexes the validator set and may be None."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.types.core import BlockID
from tendermint_tpu_torch.types.vote import Vote


@dataclass(frozen=True)
class Version:
    """Consensus version (block protocol, app version)."""

    block: int = 10
    app: int = 0

    def encode(self, w: Writer) -> None:
        w.uvarint(self.block).uvarint(self.app)

    @classmethod
    def decode(cls, r: Reader) -> "Version":
        return cls(block=r.uvarint(), app=r.uvarint())


_HASH_FIELDS = (
    "last_commit_hash",
    "data_hash",
    "validators_hash",
    "next_validators_hash",
    "consensus_hash",
    "app_hash",
    "last_results_hash",
    "evidence_hash",
    "proposer_address",
)


@dataclass
class Header:
    version: Version = field(default_factory=Version)
    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    num_txs: int = 0
    total_txs: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> Optional[bytes]:
        """Merkle root of the encoded fields (block.go:391); None until
        ``validators_hash`` is set."""
        if not self.validators_hash:
            return None
        vw = Writer()
        self.version.encode(vw)
        lbw = Writer()
        self.last_block_id.encode(lbw)
        fields = [
            vw.build(),
            self.chain_id.encode(),
            self.height.to_bytes(8, "big", signed=True),
            self.time_ns.to_bytes(8, "big", signed=True),
            self.num_txs.to_bytes(8, "big", signed=True),
            self.total_txs.to_bytes(8, "big", signed=True),
            lbw.build(),
        ] + [getattr(self, name) for name in _HASH_FIELDS]
        return merkle.hash_from_byte_slices(fields)

    def encode(self, w: Writer) -> None:
        self.version.encode(w)
        w.string(self.chain_id).svarint(self.height).fixed64(self.time_ns)
        w.svarint(self.num_txs).svarint(self.total_txs)
        self.last_block_id.encode(w)
        for name in _HASH_FIELDS:
            w.bytes(getattr(self, name))

    @classmethod
    def decode(cls, r: Reader) -> "Header":
        return cls(
            version=Version.decode(r),
            chain_id=r.string(),
            height=r.svarint(),
            time_ns=r.fixed64(),
            num_txs=r.svarint(),
            total_txs=r.svarint(),
            last_block_id=BlockID.decode(r),
            **{name: r.bytes() for name in _HASH_FIELDS},
        )


@dataclass
class Commit:
    block_id: BlockID = field(default_factory=BlockID)
    precommits: List[Optional[Vote]] = field(default_factory=list)

    def _first(self) -> Optional[Vote]:
        for pc in self.precommits:
            if pc is not None:
                return pc
        return None

    def height(self) -> int:
        v = self._first()
        return v.height if v else 0

    def round(self) -> int:
        v = self._first()
        return v.round if v else 0

    def encode(self, w: Writer) -> None:
        self.block_id.encode(w)
        w.uvarint(len(self.precommits))
        for pc in self.precommits:
            w.bool(pc is not None)
            if pc is not None:
                pc.encode(w)

    def marshal(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "Commit":
        block_id = BlockID.decode(r)
        n = r.uvarint()
        pcs: List[Optional[Vote]] = []
        for _ in range(n):
            pcs.append(Vote.decode(r) if r.bool() else None)
        return cls(block_id=block_id, precommits=pcs)

    @classmethod
    def unmarshal(cls, data: bytes) -> "Commit":
        return cls.decode(Reader(data))
