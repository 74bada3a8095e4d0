"""Part and PartSet (ref types/part_set.go), the port's copy of the
reference package's ``types/part_set.py``: a block's bytes split into
64 kB parts, each with its Merkle proof against the part-set header's
root. A proposer builds the whole set from the block (``from_data``); a
receiver assembles one from gossiped parts (``add_part``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.libs.bit_array import BitArray
from tendermint_tpu_torch.types.core import PartSetHeader
from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES


class PartSetError(Exception):
    pass


class ErrPartSetUnexpectedIndex(PartSetError):
    pass


class ErrPartSetInvalidProof(PartSetError):
    pass


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.SimpleProof

    _hash: Optional[bytes] = field(default=None, compare=False, repr=False)

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.leaf_hash(self.bytes_)
        return self._hash

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative part index")
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            raise ValueError("part too big")

    def encode(self, w: Writer) -> None:
        w.uvarint(self.index).bytes(self.bytes_)
        self.proof.encode(w)

    def marshal(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "Part":
        return cls(index=r.uvarint(), bytes_=r.bytes(), proof=merkle.SimpleProof.decode(r))

    @classmethod
    def unmarshal(cls, data: bytes) -> "Part":
        return cls.decode(Reader(data))


class PartSet:
    def __init__(self, header: PartSetHeader):
        self._header = header
        self._parts: List[Optional[Part]] = [None] * header.total
        self._parts_bit_array = BitArray(header.total)
        self._count = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        total = max(1, (len(data) + part_size - 1) // part_size)
        chunks = [data[i * part_size: (i + 1) * part_size] for i in range(total)]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=total, hash=root))
        for i, chunk in enumerate(chunks):
            ps._parts[i] = Part(index=i, bytes_=chunk, proof=proofs[i],
                                _hash=proofs[i].leaf_hash)
            ps._parts_bit_array.set_index(i, True)
        ps._count = total
        return ps

    def header(self) -> PartSetHeader:
        return self._header

    def has_header(self, header: PartSetHeader) -> bool:
        return self._header == header

    @property
    def total(self) -> int:
        return self._header.total

    @property
    def count(self) -> int:
        return self._count

    def bit_array(self) -> BitArray:
        return self._parts_bit_array.copy()

    def is_complete(self) -> bool:
        return self._count == self._header.total

    def get_part(self, index: int) -> Optional[Part]:
        if 0 <= index < len(self._parts):
            return self._parts[index]
        return None

    def add_part(self, part: Part) -> bool:
        """Check the part's proof against the header and slot it in: False
        if it is already present; raises on a bad index or proof."""
        if part.index >= self._header.total:
            raise ErrPartSetUnexpectedIndex(part.index)
        if self._parts[part.index] is not None:
            return False
        if not part.proof.verify(self._header.hash, part.bytes_):
            raise ErrPartSetInvalidProof(part.index)
        if part.proof.index != part.index or part.proof.total != self._header.total:
            raise ErrPartSetInvalidProof("proof index/total mismatch")
        self._parts[part.index] = part
        self._parts_bit_array.set_index(part.index, True)
        self._count += 1
        return True

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise PartSetError("incomplete part set")
        return b"".join(p.bytes_ for p in self._parts)
