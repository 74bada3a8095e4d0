"""Validator and ValidatorSet: commit verification (ref types/validator.go,
types/validator_set.go).

``verify_commit`` is the main path of the port: it collects every non-nil
precommit of a commit and makes ONE batch-verifier call for all of them,
then tallies voting power. Error semantics match the reference: any invalid
signature fails the whole commit, nil precommits are fine, and precommits
for another block id count for availability but not for power.
"""

from __future__ import annotations

import struct as _struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

from tendermint_tpu_torch.crypto.batch import verify_generic
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, PubKeySecp256k1
from tendermint_tpu_torch.types.core import (
    BlockID,
    SignedMsgType,
    canonical_vote_sign_bytes,
)


PubKey = Union[PubKeyEd25519, PubKeySecp256k1]


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int

    @property
    def address(self) -> bytes:
        return self.pub_key.address()


class CommitError(Exception):
    pass


class ValidatorSet:
    """Validators sorted by address."""

    def __init__(self, validators: Optional[Sequence[Validator]] = None):
        self.validators: List[Validator] = sorted(
            validators or [], key=lambda v: v.address
        )

    @property
    def size(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        return sum(v.voting_power for v in self.validators)

    def collect_commit_sigs(
        self, chain_id: str, block_id: BlockID, height: int, commit
    ) -> Tuple[List[PubKey], List[bytes], List[bytes], List[int]]:
        """Structural checks + (pubkeys, msgs, sigs, powers) for every
        non-nil precommit; powers[j] is 0 for a precommit voting another
        block. Raises CommitError.

        Canonical precommit sign-bytes differ across validators only in the
        fixed64 timestamp at offset 17 (uvarint(type) + fixed64(height) +
        fixed64(round)), and in the block id for stray votes: one template
        per block id is built and the timestamps are patched in."""
        if self.size != len(commit.precommits):
            raise CommitError(
                f"wrong set size: {self.size} vs {len(commit.precommits)}"
            )
        if height != commit.height():
            raise CommitError(f"wrong height: {height} vs {commit.height()}")
        if block_id != commit.block_id:
            raise CommitError("wrong block id")

        round = commit.round()
        templates = {
            block_id: canonical_vote_sign_bytes(
                chain_id, SignedMsgType.PRECOMMIT, height, round, 0, block_id
            )
        }
        pack_ts = _struct.Struct("<q").pack
        pubkeys, msgs, sigs, powers = [], [], [], []
        for idx, precommit in enumerate(commit.precommits):
            if precommit is None:
                continue
            if precommit.height != height:
                raise CommitError(f"precommit height {precommit.height} != {height}")
            if precommit.round != round:
                raise CommitError(f"precommit round {precommit.round} != {round}")
            if precommit.vote_type != SignedMsgType.PRECOMMIT:
                raise CommitError(f"not a precommit @ index {idx}")
            val = self.validators[idx]
            key = precommit.block_id
            tpl = templates.get(key)
            if tpl is None:
                tpl = templates[key] = canonical_vote_sign_bytes(
                    chain_id, SignedMsgType.PRECOMMIT, height, round, 0, key
                )
            pubkeys.append(val.pub_key)
            msgs.append(tpl[:17] + pack_ts(precommit.timestamp_ns) + tpl[25:])
            # a stray vote counts for availability, not power
            powers.append(val.voting_power if key == block_id else 0)
            sigs.append(precommit.signature)
        return pubkeys, msgs, sigs, powers

    def verify_commit(
        self, chain_id: str, block_id: BlockID, height: int, commit, verifier=None
    ) -> None:
        """Raise unless +2/3 of this set signed block_id at height."""
        pubkeys, msgs, sigs, powers = self.collect_commit_sigs(
            chain_id, block_id, height, commit
        )
        ok = verify_generic(pubkeys, msgs, sigs, verifier=verifier)
        tallied = 0
        for j in range(len(pubkeys)):
            if not ok[j]:
                raise CommitError("invalid signature in commit")
            tallied += powers[j]

        total = self.total_voting_power()
        if tallied * 3 <= total * 2:
            raise CommitError(
                f"insufficient voting power: got {tallied}, "
                f"needed more than {total * 2 // 3}"
            )
