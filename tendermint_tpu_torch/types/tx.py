"""Tx and Txs (ref types/tx.go), the port's copy of the reference
package's ``types/tx.py``: opaque app transactions, Merkle-rooted into
``Header.data_hash``, with a tx's inclusion proof (``TxProof``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.encoding.codec import Reader, Writer


class Tx(bytes):
    def hash(self) -> bytes:
        return sha256(bytes(self))

    def __str__(self) -> str:
        return f"Tx{{{bytes(self).hex()[:16]}}}"


class Txs(list):
    """A list of Tx with the Merkle helpers."""

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices([bytes(tx) for tx in self])

    def index(self, tx: bytes) -> int:
        for i, t in enumerate(self):
            if bytes(t) == bytes(tx):
                return i
        return -1

    def proof(self, i: int) -> "TxProof":
        root, proofs = merkle.proofs_from_byte_slices([bytes(tx) for tx in self])
        return TxProof(root_hash=root, data=Tx(self[i]), proof=proofs[i])


@dataclass
class TxProof:
    root_hash: bytes
    data: Tx
    proof: merkle.SimpleProof

    def leaf(self) -> bytes:
        return bytes(self.data)

    def validate(self, data_hash: bytes) -> Optional[str]:
        if data_hash != self.root_hash:
            return "proof matches different data hash"
        if not self.proof.verify(self.root_hash, self.leaf()):
            return "proof is not internally consistent"
        return None

    def encode(self, w: Writer) -> None:
        w.bytes(self.root_hash).bytes(bytes(self.data))
        self.proof.encode(w)

    @classmethod
    def decode(cls, r: Reader) -> "TxProof":
        return cls(root_hash=r.bytes(), data=Tx(r.bytes()),
                   proof=merkle.SimpleProof.decode(r))
