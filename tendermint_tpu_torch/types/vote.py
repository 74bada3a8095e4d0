"""Vote: a prevote or precommit from one validator (ref types/vote.go)."""

from __future__ import annotations

from dataclasses import dataclass, replace

from tendermint_tpu_torch.types.core import (
    BlockID,
    SignedMsgType,
    canonical_vote_sign_bytes,
)


@dataclass(frozen=True)
class Vote:
    vote_type: SignedMsgType
    height: int
    round: int
    timestamp_ns: int
    block_id: BlockID
    validator_address: bytes
    validator_index: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_vote_sign_bytes(
            chain_id,
            self.vote_type,
            self.height,
            self.round,
            self.timestamp_ns,
            self.block_id,
        )

    def with_signature(self, sig: bytes) -> "Vote":
        return replace(self, signature=sig)
