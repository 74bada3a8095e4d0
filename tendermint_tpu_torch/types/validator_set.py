"""Validator and ValidatorSet: proposer rotation, hashing, the wire codec
and commit verification (ref types/validator.go, types/validator_set.go;
the port's copy of the reference package's ``types/validator_set.py``).

``verify_commit`` is the main path of the port: it collects every non-nil
precommit of a commit and makes ONE batch-verifier call for all of them,
then tallies voting power. Error semantics match the reference: any invalid
signature fails the whole commit, nil precommits are fine, and precommits
for another block id count for availability but not for power.
``verify_future_commit`` is the light client's hop across a validator-set
change: the new set's ``verify_commit``, then a second call over the
precommits of the old set's members, which must hold more than 2/3 of the
old set's power (``TooMuchChangeError`` otherwise, the error the light
client bisects on).
"""

from __future__ import annotations

import bisect
import struct as _struct
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple, Union

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.batch import verify_generic
from tendermint_tpu_torch.crypto.keys import (
    _PUBKEY_TYPES,
    PubKeyEd25519,
    PubKeySecp256k1,
)
from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.types.core import (
    BlockID,
    SignedMsgType,
    canonical_vote_sign_bytes,
)


PubKey = Union[PubKeyEd25519, PubKeySecp256k1]

# the reference's clip bound for accums and power products, and the most
# voting power an EndBlock update may grant (state/execution.update_validators)
_MAX_TOTAL_POWER = 1 << 60


def _clip(v: int) -> int:
    return (_MAX_TOTAL_POWER if v > _MAX_TOTAL_POWER
            else (-_MAX_TOTAL_POWER if v < -_MAX_TOTAL_POWER else v))


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    accum: int = 0

    @property
    def address(self) -> bytes:
        return self.pub_key.address()

    def hash_bytes(self) -> bytes:
        """The bytes folded into the set's hash: the key and the voting
        power (ref validator.go:104), never the accum."""
        return Writer().bytes(self.pub_key.bytes()).svarint(self.voting_power).build()

    def copy(self) -> "Validator":
        return Validator(self.pub_key, self.voting_power, self.accum)

    def compare_accum(self, other: "Validator") -> "Validator":
        """The higher accum; a tie goes to the lower address (ref
        validator.go CompareAccum)."""
        if self.accum != other.accum:
            return self if self.accum > other.accum else other
        return self if self.address < other.address else other


class CommitError(Exception):
    pass


class TooMuchChangeError(CommitError):
    """The old set signed no more than 2/3 of its power of a future commit:
    the light client's bisection trigger."""


class ValidatorSet:
    """Validators sorted by address; the proposer rotates by accumulated
    voting power. A new set has advanced its accums once, as the
    reference's does."""

    _CODEC_VERSION = 2  # the reference's: members blob, two <q arrays, proposer

    def __init__(self, validators: Optional[Sequence[Validator]] = None):
        self.validators: List[Validator] = sorted(
            (replace(v) for v in validators or []), key=lambda v: v.address
        )
        self.proposer: Optional[Validator] = None
        self._hash: Optional[bytes] = None
        self._addresses: Optional[List[bytes]] = None
        if self.validators:
            self.increment_accum(1)

    @property
    def size(self) -> int:
        return len(self.validators)

    def is_nil_or_empty(self) -> bool:
        return len(self.validators) == 0

    def has_address(self, address: bytes) -> bool:
        return self.get_by_address(address)[0] != -1

    def _invalidate(self) -> None:
        """Membership changed: drop every derived cache (the reference
        clears the proposer and the total power on Add/Update/Remove)."""
        self.proposer = None
        self._hash = None
        self._addresses = None

    def total_voting_power(self) -> int:
        return sum(v.voting_power for v in self.validators)

    def get_by_index(self, index: int) -> Tuple[bytes, Optional[Validator]]:
        """(address, a copy of the validator), or (b"", None)."""
        if 0 <= index < len(self.validators):
            v = self.validators[index]
            return v.address, replace(v)
        return b"", None

    def get_by_address(self, address: bytes) -> Tuple[int, Optional[Validator]]:
        """(index, a copy of the validator), or (-1, None)."""
        if self._addresses is None:
            self._addresses = [v.address for v in self.validators]
        i = bisect.bisect_left(self._addresses, address)
        if i < len(self._addresses) and self._addresses[i] == address:
            return i, replace(self.validators[i])
        return -1, None

    # proposer rotation (ref validator_set.go:65-88) -----------------------
    def _find_proposer(self) -> Validator:
        """Highest accum; ties go to the lower address."""
        best = self.validators[0]
        for v in self.validators[1:]:
            if v.accum > best.accum or (v.accum == best.accum and v.address < best.address):
                best = v
        return best

    def get_proposer(self) -> Optional[Validator]:
        if not self.validators:
            return None
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return replace(self.proposer)

    def increment_accum(self, times: int) -> None:
        """accum += power * times for every validator, then ``times``
        rounds in which the highest accum proposes and pays the total."""
        if not self.validators:
            raise ValueError("empty validator set")
        for v in self.validators:
            v.accum = _clip(v.accum + _clip(v.voting_power * times))
        total = self.total_voting_power()
        for _ in range(times):
            mostest = self._find_proposer()
            mostest.accum = _clip(mostest.accum - total)
            self.proposer = mostest

    def copy(self) -> "ValidatorSet":
        """A copy with its own validators (accums included) and the same
        proposer; the hash and address caches are shared until either set
        changes its members."""
        new = ValidatorSet.__new__(ValidatorSet)
        new.validators = [v.copy() for v in self.validators]
        new._hash = self._hash
        new._addresses = self._addresses
        new.proposer = None
        if self.proposer is not None:
            i = self._index_of(self.proposer.address)
            new.proposer = new.validators[i] if i >= 0 else self.proposer.copy()
        return new

    def copy_increment_accum(self, times: int) -> "ValidatorSet":
        """A copy of the set (same members, own accums) advanced ``times``."""
        new = self.copy()
        new.increment_accum(times)
        return new

    # membership changes (ABCI EndBlock; ref validator_set.go:189-240) --------
    def add(self, val: Validator) -> bool:
        """Insert in address order; False if the address is a member."""
        if self.has_address(val.address):
            return False
        self.validators = sorted(self.validators + [val.copy()], key=lambda v: v.address)
        self._invalidate()
        return True

    def update(self, val: Validator) -> bool:
        """Replace the member of ``val``'s address wholesale, accum included
        (ref validator_set.go:216-226); False if it is not a member."""
        idx, _ = self.get_by_address(val.address)
        if idx == -1:
            return False
        self.validators[idx] = val.copy()
        self._invalidate()
        return True

    def remove(self, address: bytes) -> Optional[Validator]:
        idx, _ = self.get_by_address(address)
        if idx == -1:
            return None
        removed = self.validators.pop(idx)
        self._invalidate()
        return removed

    def _index_of(self, address: bytes) -> int:
        for i, v in enumerate(self.validators):
            if v.address == address:
                return i
        return -1

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [v.hash_bytes() for v in self.validators])
        return self._hash

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

    def verify_future_commit(
        self, new_set: "ValidatorSet", chain_id: str, block_id: BlockID,
        height: int, commit, verifier=None,
    ) -> None:
        """The light client's rule (validator_set.go:339): the commit must be
        valid for ``new_set``, and more than 2/3 of this (old) set's power
        must have signed ``block_id`` in it. The old set's pass looks each
        precommit's signer up by address (a repeated index counts once)
        and verifies the full sign-bytes in a second batch call; raises
        ``TooMuchChangeError`` when the old power is too low."""
        new_set.verify_commit(chain_id, block_id, height, commit, verifier=verifier)

        seen = set()
        round = commit.round()
        pubkeys, msgs, sigs, powers = [], [], [], []
        for precommit in commit.precommits:
            if precommit is None:
                continue
            if precommit.height != height:
                raise CommitError("precommit height mismatch")
            if precommit.round != round:
                raise CommitError("precommit round mismatch")
            if precommit.vote_type != SignedMsgType.PRECOMMIT:
                raise CommitError("not a precommit")
            old_idx, val = self.get_by_address(precommit.validator_address)
            if val is None or old_idx in seen:
                continue
            seen.add(old_idx)
            pubkeys.append(val.pub_key)
            msgs.append(precommit.sign_bytes(chain_id))
            sigs.append(precommit.signature)
            powers.append(val.voting_power if precommit.block_id == block_id else 0)

        ok = verify_generic(pubkeys, msgs, sigs, verifier=verifier)
        old_voting_power = 0
        for j in range(len(pubkeys)):
            if not ok[j]:
                raise CommitError("invalid signature (old set)")
            old_voting_power += powers[j]

        if old_voting_power * 3 <= self.total_voting_power() * 2:
            raise TooMuchChangeError(
                f"invalid commit -- insufficient old voting power: got "
                f"{old_voting_power}"
            )

    # codec (version 2) ------------------------------------------------------
    def encode(self, w: Writer) -> None:
        vals = self.validators
        members = Writer()
        for v in vals:
            members.string(v.pub_key.type_name).bytes(v.pub_key.bytes())
        w.uvarint(self._CODEC_VERSION).uvarint(len(vals)).bytes(members.build())
        w.bytes(_struct.pack(f"<{len(vals)}q", *(v.voting_power for v in vals)))
        w.bytes(_struct.pack(f"<{len(vals)}q", *(v.accum for v in vals)))
        w.svarint(-1 if self.proposer is None else self._index_of(self.proposer.address))

    def marshal(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "ValidatorSet":
        """Keeps the members in their encoded order with their accums and
        the proposer, so that ``encode`` gives the same bytes back."""
        ver = r.uvarint()
        if ver != cls._CODEC_VERSION:
            raise ValueError(
                f"validator-set codec version {ver} unsupported "
                f"(this build reads {cls._CODEC_VERSION})"
            )
        n = r.uvarint()
        mr = Reader(r.bytes())
        pks = [_PUBKEY_TYPES[mr.string()](mr.bytes()) for _ in range(n)]
        powers = _struct.unpack(f"<{n}q", r.bytes())
        accums = _struct.unpack(f"<{n}q", r.bytes())
        prop_idx = r.svarint()
        vs = cls.__new__(cls)
        vs.validators = [Validator(pk, p, a) for pk, p, a in zip(pks, powers, accums)]
        vs._hash = None
        vs._addresses = None
        vs.proposer = vs.validators[prop_idx] if 0 <= prop_idx < n else None
        return vs

    @classmethod
    def unmarshal(cls, data: bytes) -> "ValidatorSet":
        return cls.decode(Reader(data))
