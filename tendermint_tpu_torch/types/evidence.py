"""DuplicateVoteEvidence (ref types/evidence.go), the port's copy of the
reference package's ``types/evidence.py``: two signed votes of one
validator for the same height, round and type but different blocks.

``verify`` checks the two votes one by one through ``Vote.verify`` on the
host, as the reference does: evidence is rare (at most
``state/validation.MAX_EVIDENCE_PER_BLOCK`` a block) and is not a batched
path in the reference either, so this is its design, not a fallback.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.crypto.keys import PubKey, pubkey_from_json_obj
from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.types.vote import Vote


class EvidenceError(Exception):
    pass


@dataclass(frozen=True)
class DuplicateVoteEvidence:
    pub_key: PubKey
    vote_a: Vote
    vote_b: Vote

    @property
    def height(self) -> int:
        return self.vote_a.height

    @property
    def address(self) -> bytes:
        return self.pub_key.address()

    def hash(self) -> bytes:
        return sha256(self.marshal())

    def verify(self, chain_id: str) -> None:
        """Raise unless this is double signing (evidence.go Verify): the
        same height, round and type, different blocks, one validator, and
        both signatures valid for ``pub_key``."""
        a, b = self.vote_a, self.vote_b
        if a.height != b.height or a.round != b.round or a.vote_type != b.vote_type:
            raise EvidenceError("votes are not from the same H/R/S")
        if a.block_id == b.block_id:
            raise EvidenceError("votes are for the same block")
        if a.validator_address != b.validator_address:
            raise EvidenceError("votes are from different validators")
        if a.validator_address != self.pub_key.address():
            raise EvidenceError("address does not match pubkey")
        a.verify(chain_id, self.pub_key)
        b.verify(chain_id, self.pub_key)

    def equal(self, other: "DuplicateVoteEvidence") -> bool:
        return self.marshal() == other.marshal()

    def encode(self, w: Writer) -> None:
        w.string(json.dumps(self.pub_key.to_json_obj(), sort_keys=True))
        self.vote_a.encode(w)
        self.vote_b.encode(w)

    def marshal(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "DuplicateVoteEvidence":
        return cls(pub_key=pubkey_from_json_obj(json.loads(r.string())),
                   vote_a=Vote.decode(r), vote_b=Vote.decode(r))

    @classmethod
    def unmarshal(cls, data: bytes) -> "DuplicateVoteEvidence":
        return cls.decode(Reader(data))


Evidence = DuplicateVoteEvidence  # the only kind the protocol has


def evidence_hash(evidence: List[DuplicateVoteEvidence]) -> bytes:
    return merkle.hash_from_byte_slices([e.marshal() for e in evidence])
