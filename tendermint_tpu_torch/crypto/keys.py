"""Ed25519 public key with the reference's address rule
(crypto/ed25519/ed25519.go:138: SHA-256(pubkey)[:20])."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

ADDRESS_SIZE = 20


@dataclass(frozen=True)
class PubKeyEd25519:
    data: bytes  # 32 bytes
    type_name = "tendermint/PubKeyEd25519"

    def __post_init__(self):
        if len(self.data) != 32:
            raise ValueError("ed25519 pubkey must be 32 bytes")
        object.__setattr__(
            self, "_addr", hashlib.sha256(self.data).digest()[:ADDRESS_SIZE]
        )

    def address(self) -> bytes:
        return self._addr

    def bytes(self) -> bytes:
        return self.data
