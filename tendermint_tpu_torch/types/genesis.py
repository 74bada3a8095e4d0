"""GenesisDoc (ref types/genesis.go), the port's copy of the reference
package's ``types/genesis.py``: the chain's bootstrap document, JSON on
disk, with ``validate_and_complete`` filling the defaults."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.crypto.keys import PubKey, pubkey_from_json_obj
from tendermint_tpu_torch.types.params import (
    BlockSizeParams,
    ConsensusParams,
    EvidenceParams,
    ValidatorParams,
)
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

MAX_CHAIN_ID_LEN = 50


@dataclass
class GenesisValidator:
    pub_key: PubKey
    power: int
    name: str = ""

    def to_json_obj(self) -> dict:
        return {"pub_key": self.pub_key.to_json_obj(), "power": str(self.power),
                "name": self.name}

    @classmethod
    def from_json_obj(cls, obj: dict) -> "GenesisValidator":
        return cls(pub_key=pubkey_from_json_obj(obj["pub_key"]), power=int(obj["power"]),
                   name=obj.get("name", ""))


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    consensus_params: Optional[ConsensusParams] = None
    validators: List[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: Optional[dict] = None

    def validate_and_complete(self) -> None:
        """genesis.go:60 ValidateAndComplete: fill the defaults, validate."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long (max {MAX_CHAIN_ID_LEN})")
        if self.consensus_params is None:
            self.consensus_params = ConsensusParams()
        else:
            self.consensus_params.validate()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(
                    f"genesis file cannot contain validators with no voting power: {i}")
        if self.genesis_time_ns == 0:
            self.genesis_time_ns = time.time_ns()

    def validator_hash(self) -> bytes:
        return ValidatorSet([Validator(v.pub_key, v.power) for v in self.validators]).hash()

    def to_json(self) -> str:
        return json.dumps({
            "genesis_time_ns": self.genesis_time_ns,
            "chain_id": self.chain_id,
            "consensus_params": _params_to_obj(self.consensus_params),
            "validators": [v.to_json_obj() for v in self.validators],
            "app_hash": self.app_hash.hex(),
            "app_state": self.app_state,
        }, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, data: str) -> "GenesisDoc":
        obj = json.loads(data)
        doc = cls(
            chain_id=obj["chain_id"],
            genesis_time_ns=obj.get("genesis_time_ns", 0),
            consensus_params=_params_from_obj(obj.get("consensus_params")),
            validators=[GenesisValidator.from_json_obj(v) for v in obj.get("validators", [])],
            app_hash=bytes.fromhex(obj.get("app_hash", "")),
            app_state=obj.get("app_state"),
        )
        doc.validate_and_complete()
        return doc

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())


def _params_to_obj(p: Optional[ConsensusParams]) -> Optional[dict]:
    if p is None:
        return None
    return {
        "block_size": {"max_bytes": p.block_size.max_bytes, "max_gas": p.block_size.max_gas},
        "evidence": {"max_age": p.evidence.max_age},
        "validator": {"pub_key_types": list(p.validator.pub_key_types)},
    }


def _params_from_obj(obj: Optional[dict]) -> Optional[ConsensusParams]:
    if obj is None:
        return None
    return ConsensusParams(
        block_size=BlockSizeParams(**obj.get("block_size", {})),
        evidence=EvidenceParams(**obj.get("evidence", {})),
        validator=ValidatorParams(pub_key_types=tuple(
            obj.get("validator", {}).get("pub_key_types", ("ed25519",)))),
    )
