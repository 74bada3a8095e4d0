"""ConsensusParams (ref types/params.go), the port's copy of the reference
package's ``types/params.py``: the block-size, evidence and validator
key-type limits, hashed into ``Header.consensus_hash`` and updated by an
ABCI EndBlock's ``consensus_param_updates``."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.encoding.codec import Reader, Writer

MAX_BLOCK_SIZE_BYTES = 104857600  # 100 MB, the protocol's ceiling (params.go:11)
BLOCK_PART_SIZE_BYTES = 65536  # 64 kB (params.go:14)

ABCI_PUBKEY_TYPE_ED25519 = "ed25519"
ABCI_PUBKEY_TYPE_SECP256K1 = "secp256k1"


@dataclass(frozen=True)
class BlockSizeParams:
    max_bytes: int = 22020096  # 21 MB
    max_gas: int = -1


@dataclass(frozen=True)
class EvidenceParams:
    max_age: int = 100000  # heights


@dataclass(frozen=True)
class ValidatorParams:
    pub_key_types: tuple = (ABCI_PUBKEY_TYPE_ED25519,)


@dataclass(frozen=True)
class ConsensusParams:
    block_size: BlockSizeParams = field(default_factory=BlockSizeParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)

    def validate(self) -> None:
        if self.block_size.max_bytes <= 0:
            raise ValueError("BlockSize.MaxBytes must be greater than 0")
        if self.block_size.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError(f"BlockSize.MaxBytes too big: {self.block_size.max_bytes}")
        if self.block_size.max_gas < -1:
            raise ValueError("BlockSize.MaxGas must be >= -1")
        if self.evidence.max_age <= 0:
            raise ValueError("EvidenceParams.MaxAge must be greater than 0")
        if not self.validator.pub_key_types:
            raise ValueError("ValidatorParams.PubKeyTypes must not be empty")

    def hash(self) -> bytes:
        w = Writer()
        self.encode(w)
        return sha256(w.build())

    def update(self, abci_params) -> "ConsensusParams":
        """These params with an ABCI EndBlock delta applied (params.go
        Update): each section the delta carries replaces this one's."""
        res = self
        if abci_params is None:
            return res
        if abci_params.block_size is not None:
            res = replace(res, block_size=BlockSizeParams(
                max_bytes=abci_params.block_size.max_bytes,
                max_gas=abci_params.block_size.max_gas))
        if abci_params.evidence is not None:
            res = replace(res, evidence=EvidenceParams(max_age=abci_params.evidence.max_age))
        if abci_params.validator is not None:
            res = replace(res, validator=ValidatorParams(
                pub_key_types=tuple(abci_params.validator.pub_key_types)))
        return res

    def encode(self, w: Writer) -> None:
        w.svarint(self.block_size.max_bytes).svarint(self.block_size.max_gas)
        w.svarint(self.evidence.max_age)
        w.uvarint(len(self.validator.pub_key_types))
        for t in self.validator.pub_key_types:
            w.string(t)

    @classmethod
    def decode(cls, r: Reader) -> "ConsensusParams":
        bs = BlockSizeParams(max_bytes=r.svarint(), max_gas=r.svarint())
        ev = EvidenceParams(max_age=r.svarint())
        vp = ValidatorParams(pub_key_types=tuple(r.string() for _ in range(r.uvarint())))
        return cls(block_size=bs, evidence=ev, validator=vp)
