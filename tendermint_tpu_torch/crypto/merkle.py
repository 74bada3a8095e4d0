"""Simple Merkle root over byte slices, in the reference package's own
layout (its ``crypto/merkle.py``), which is not Go's: RFC-6962 domain
separation (leaf = SHA-256(0x00 || leaf), inner = SHA-256(0x01 || left ||
right)), the empty tree is SHA-256(""), and a list splits at the largest
power of two below its length. ``Header.hash`` and ``ValidatorSet.hash``
are roots of this tree; ``SimpleProof`` is a leaf's inclusion proof (a
block part's, ``types/part_set.py``, and a tx's, ``types/tx.py``)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

_LEAF_PREFIX = b"\x00"
_INNER_PREFIX = b"\x01"


def _hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def leaf_hash(leaf: bytes) -> bytes:
    return _hash(_LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _hash(_INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """The largest power of two strictly below n (n >= 2)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return _hash(b"")
    if n == 1:
        return leaf_hash(items[0])
    k = _split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]),
                      hash_from_byte_slices(items[k:]))


@dataclass
class SimpleProof:
    """Inclusion proof of one leaf (ref crypto/merkle/simple_proof.go:16)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes] = field(default_factory=list)

    MAX_AUNTS = 128  # bounds what a decoded proof may allocate

    def compute_root(self) -> Optional[bytes]:
        return _compute_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total <= 0 or not (0 <= self.index < self.total):
            return False
        if self.leaf_hash != leaf_hash(leaf):
            return False
        return self.compute_root() == root

    def encode(self, w) -> None:
        w.uvarint(self.total).uvarint(self.index).bytes(self.leaf_hash)
        w.uvarint(len(self.aunts))
        for a in self.aunts:
            w.bytes(a)

    @classmethod
    def decode(cls, r) -> "SimpleProof":
        total, index, lh, n = r.uvarint(), r.uvarint(), r.bytes(), r.uvarint()
        if n > cls.MAX_AUNTS:
            raise ValueError(f"proof claims {n} aunts (max {cls.MAX_AUNTS})")
        return cls(total=total, index=index, leaf_hash=lh, aunts=[r.bytes() for _ in range(n)])


def _compute_from_aunts(index: int, total: int, lh: bytes,
                        aunts: List[bytes]) -> Optional[bytes]:
    if total == 1:
        return None if aunts else lh
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, lh, aunts[:-1])
        return None if left is None else inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, lh, aunts[:-1])
    return None if right is None else inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: Sequence[bytes]) -> Tuple[bytes, List[SimpleProof]]:
    """The root and one proof a leaf (ref SimpleProofsFromByteSlices); each
    proof's aunts run from the leaf up."""
    lhs = [leaf_hash(it) for it in items]
    n = len(lhs)
    proofs = [SimpleProof(total=n, index=i, leaf_hash=lhs[i]) for i in range(n)]

    def build(lo: int, hi: int) -> bytes:
        cnt = hi - lo
        if cnt == 0:
            return _hash(b"")
        if cnt == 1:
            return lhs[lo]
        k = _split_point(cnt)
        left, right = build(lo, lo + k), build(lo + k, hi)
        for i in range(lo, lo + k):
            proofs[i].aunts.append(right)
        for i in range(lo + k, hi):
            proofs[i].aunts.append(left)
        return inner_hash(left, right)

    return build(0, n), proofs
