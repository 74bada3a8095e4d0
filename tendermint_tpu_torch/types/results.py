"""ABCIResult and ABCIResults (ref types/results.go), the port's copy of
the reference package's ``types/results.py``: the DeliverTx results' code
and data, Merkle-rooted into ``Header.last_results_hash``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.codec import Writer


@dataclass(frozen=True)
class ABCIResult:
    code: int
    data: bytes

    def bytes_(self) -> bytes:
        return Writer().uvarint(self.code).bytes(self.data).build()


class ABCIResults(list):
    @classmethod
    def from_deliver_txs(cls, responses: Sequence) -> "ABCIResults":
        return cls(ABCIResult(code=r.code, data=r.data or b"") for r in responses)

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices([r.bytes_() for r in self])
