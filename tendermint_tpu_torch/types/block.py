"""Block, Header, Data, EvidenceData and Commit (ref types/block.go), with
the hashes and wire codec of the reference package's ``types/block.py``.
``Header.hash`` is the Merkle root (``crypto/merkle.py``) of the encoded
fields in declaration order; ``Commit.hash`` the root over its encoded
precommits; ``Commit.precommits[i]`` indexes the validator set and may be
None. A decoded block keeps its wire bytes and caches its hash; a block
built locally re-encodes and rehashes until it is sealed."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.libs.bit_array import BitArray
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence, evidence_hash
from tendermint_tpu_torch.types.tx import Tx, Txs
from tendermint_tpu_torch.types.vote import Vote

MAX_HEADER_BYTES = 653


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
    """+2/3 precommits for a block; empty only before height 2."""

    block_id: BlockID = field(default_factory=BlockID)
    precommits: List[Optional[Vote]] = field(default_factory=list)
    # a memo: commits with the same contents compare equal, hashed or not
    _hash: Optional[bytes] = field(default=None, compare=False, repr=False)

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

    def size(self) -> int:
        return len(self.precommits)

    def is_commit(self) -> bool:
        return len(self.precommits) != 0

    def bit_array(self) -> BitArray:
        ba = BitArray(len(self.precommits))
        for i, pc in enumerate(self.precommits):
            ba.set_index(i, pc is not None)
        return ba

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [pc.marshal() if pc is not None else b"" for pc in self.precommits])
        return self._hash

    def validate_basic(self) -> None:
        if self.block_id.is_zero():
            raise ValueError("commit cannot be for nil block")
        if not self.precommits:
            raise ValueError("no precommits in commit")
        height, round = self.height(), self.round()
        for pc in self.precommits:
            if pc is None:
                continue
            if pc.vote_type != SignedMsgType.PRECOMMIT:
                raise ValueError("commit vote is not precommit")
            if pc.height != height or pc.round != round:
                raise ValueError("commit precommit H/R mismatch")

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


@dataclass
class Data:
    txs: Txs = field(default_factory=Txs)

    def hash(self) -> bytes:
        return self.txs.hash()

    def encode(self, w: Writer) -> None:
        w.uvarint(len(self.txs))
        for tx in self.txs:
            w.bytes(bytes(tx))

    @classmethod
    def decode(cls, r: Reader) -> "Data":
        return cls(txs=Txs([Tx(r.bytes()) for _ in range(r.uvarint())]))


@dataclass
class EvidenceData:
    evidence: List[DuplicateVoteEvidence] = field(default_factory=list)

    def hash(self) -> bytes:
        return evidence_hash(self.evidence)

    def encode(self, w: Writer) -> None:
        w.uvarint(len(self.evidence))
        for ev in self.evidence:
            ev.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "EvidenceData":
        return cls(evidence=[DuplicateVoteEvidence.decode(r) for _ in range(r.uvarint())])


class Block:
    def __init__(self, header: Header, data: Data, evidence: EvidenceData,
                 last_commit: Commit):
        self.header = header
        self.data = data
        self.evidence = evidence
        self.last_commit = last_commit
        self._hash: Optional[bytes] = None
        self._wire: Optional[bytes] = None  # a decoded block's own bytes

    @classmethod
    def make_block(cls, height: int, txs: Sequence[bytes], last_commit: Commit,
                   evidence: Optional[List[DuplicateVoteEvidence]] = None) -> "Block":
        """MakeBlock (block.go:35): the header's block-derived hashes
        filled; the caller (``State.make_block``) fills the rest."""
        block = cls(
            header=Header(height=height, num_txs=len(txs)),
            data=Data(txs=Txs([Tx(t) for t in txs])),
            evidence=EvidenceData(evidence=list(evidence or [])),
            last_commit=last_commit,
        )
        block.fill_header()
        return block

    def fill_header(self) -> None:
        if not self.header.last_commit_hash:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = self.evidence.hash()

    @property
    def height(self) -> int:
        return self.header.height

    def hash(self) -> Optional[bytes]:
        if self._hash is not None:
            return self._hash
        self.fill_header()
        h = self.header.hash()
        if self._wire is not None and h is not None:
            self._hash = h
        return h

    def make_part_set(self, part_size: Optional[int] = None):
        from tendermint_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES, PartSet

        return PartSet.from_data(self.marshal(), part_size or BLOCK_PART_SIZE_BYTES)

    def hashes_to(self, hash_: bytes) -> bool:
        return bool(hash_) and self.hash() == hash_

    def validate_basic(self) -> None:
        if self.header.height < 0:
            raise ValueError("negative header height")
        if self.header.height > 1:
            if not self.last_commit.is_commit():
                raise ValueError("nil LastCommit for height > 1")
            self.last_commit.validate_basic()
        if self.header.last_commit_hash != self.last_commit.hash():
            raise ValueError("wrong LastCommitHash")
        if self.header.num_txs != len(self.data.txs):
            raise ValueError("wrong NumTxs")
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong DataHash")
        if self.header.evidence_hash != self.evidence.hash():
            raise ValueError("wrong EvidenceHash")

    def encode(self, w: Writer) -> None:
        self.header.encode(w)
        self.data.encode(w)
        self.evidence.encode(w)
        self.last_commit.encode(w)

    def marshal(self) -> bytes:
        if self._wire is not None:
            return self._wire
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "Block":
        start = r.tell()
        block = cls(header=Header.decode(r), data=Data.decode(r),
                    evidence=EvidenceData.decode(r), last_commit=Commit.decode(r))
        block._wire = r.span(start)
        return block

    @classmethod
    def unmarshal(cls, data: bytes) -> "Block":
        return cls.decode(Reader(data))

    def __str__(self) -> str:
        h = self.hash()
        return f"Block{{H:{self.header.height} {h.hex()[:12] if h else '-'}}}"
