"""Public and private keys with the reference's address rules: ed25519
(crypto/ed25519/ed25519.go:138: SHA-256(pubkey)[:20]) and secp256k1
(crypto/secp256k1/secp256k1.go:121: RIPEMD160(SHA256(pubkey))).

``PubKey`` is the interface of crypto/crypto.go:22-27 (Address, Bytes,
VerifyBytes, Equals): the planner treats any lane key that is not a
``PubKey`` as a raw ed25519 key, and ``crypto/multisig.py`` verifies its
sub-keys through ``verify_bytes``, which runs the host oracles."""

from __future__ import annotations

import base64
import hashlib
import hmac
from dataclasses import dataclass

from tendermint_tpu_torch.crypto import ed25519 as _ed
from tendermint_tpu_torch.crypto import secp256k1 as _secp
from tendermint_tpu_torch.crypto.hashing import ripemd160, sha256

ADDRESS_SIZE = 20


class PubKey:
    type_name: str = ""

    def address(self) -> bytes:
        raise NotImplementedError

    def bytes(self) -> bytes:
        raise NotImplementedError

    def verify_bytes(self, msg: bytes, sig: bytes) -> bool:
        raise NotImplementedError

    def equals(self, other: "PubKey") -> bool:
        return type(self) is type(other) and hmac.compare_digest(
            self.bytes(), other.bytes()
        )

    def to_json_obj(self) -> dict:
        """The JSON form of the reference's keys: type name and base64."""
        return {"type": self.type_name, "value": base64.b64encode(self.bytes()).decode()}


@dataclass(frozen=True)
class PubKeyEd25519(PubKey):
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

    def verify_bytes(self, msg: bytes, sig: bytes) -> bool:
        return len(sig) == 64 and _ed._verify_pure(self.data, msg, sig)


@dataclass(frozen=True)
class PrivKeyEd25519:
    data: bytes  # 64 bytes: seed || pubkey
    type_name = "tendermint/PrivKeyEd25519"

    def __post_init__(self):
        if len(self.data) != 64:
            raise ValueError("ed25519 privkey must be 64 bytes")

    def bytes(self) -> bytes:
        return self.data

    def sign(self, msg: bytes) -> bytes:
        return _ed.sign(self.data, msg)

    def pub_key(self) -> PubKeyEd25519:
        return PubKeyEd25519(self.data[32:])

    @staticmethod
    def generate(seed: bytes | None = None) -> "PrivKeyEd25519":
        return PrivKeyEd25519(_ed.gen_privkey(seed))

    @staticmethod
    def from_secret(secret: bytes) -> "PrivKeyEd25519":
        """The reference's GenPrivKeyFromSecret: seed = SHA-256(secret)."""
        return PrivKeyEd25519(_ed.gen_privkey(sha256(secret)))


@dataclass(frozen=True)
class PubKeySecp256k1(PubKey):
    data: bytes  # 33-byte compressed point
    type_name = "tendermint/PubKeySecp256k1"

    def __post_init__(self):
        if len(self.data) != 33:
            raise ValueError("secp256k1 pubkey must be 33 bytes (compressed)")
        object.__setattr__(self, "_addr", ripemd160(sha256(self.data)))

    def address(self) -> bytes:
        return self._addr

    def bytes(self) -> bytes:
        return self.data

    def verify_bytes(self, msg: bytes, sig: bytes) -> bool:
        # SHA-256-premixed message, DER signature, low s (secp256k1.go:140-153)
        return _secp.verify(self.data, sha256(msg), sig)


@dataclass(frozen=True)
class PrivKeySecp256k1:
    data: bytes  # 32 bytes
    type_name = "tendermint/PrivKeySecp256k1"

    def __post_init__(self):
        if len(self.data) != 32:
            raise ValueError("secp256k1 privkey must be 32 bytes")

    def bytes(self) -> bytes:
        return self.data

    def sign(self, msg: bytes) -> bytes:
        # reference signs SHA256(msg) and emits DER (secp256k1.go:58-67)
        return _secp.sign(self.data, sha256(msg))

    def pub_key(self) -> PubKeySecp256k1:
        return PubKeySecp256k1(_secp.pubkey_compressed(self.data))

    @staticmethod
    def generate(seed: bytes | None = None) -> "PrivKeySecp256k1":
        return PrivKeySecp256k1(_secp.gen_privkey(seed))


# type name -> key class, for decoding a validator set's members (the
# reference's registry: ed25519 and secp256k1 keys)
_PUBKEY_TYPES = {
    PubKeyEd25519.type_name: PubKeyEd25519,
    PubKeySecp256k1.type_name: PubKeySecp256k1,
}


def pubkey_from_json_obj(obj: dict) -> PubKey:
    return _PUBKEY_TYPES[obj["type"]](base64.b64decode(obj["value"]))
