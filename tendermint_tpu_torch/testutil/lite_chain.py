"""Seeded signed chains for the light client, and providers over them.

``build_lite_chain`` makes a chain of ``n_heights`` headers whose
``validators_hash`` and ``next_validators_hash`` chain correctly, each with
a commit signed by every validator of its set (``crypto/ed25519.sign``),
and at each of ``change_heights`` replaces ``n_change`` validators of the
set by fresh keys. Between changes a set advances its accums once a height,
as a chain's proposer rotation does. Every height is kept as the codec
bytes of its ``FullCommit``, so each fetch decodes fresh objects that a
caller may doctor without touching the chain.

``ChainProvider`` serves such bytes: the port's own chain, or a chain
carried across from another implementation as its ``FullCommit.marshal()``
bytes, which it serves as the port's ``FullCommit.unmarshal`` of them.
``DoctoringProvider`` rewrites what an inner provider serves, as a lying
or pruned peer would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Sequence

import numpy as np

from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.lite.provider import Provider, ProviderError
from tendermint_tpu_torch.lite.types import FullCommit, SignedHeader
from tendermint_tpu_torch.types.block import Commit, Header
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote

CHAIN_ID = "lite-chain"
TIME0 = 1_700_000_000_000_000_000
SECOND = 1_000_000_000


class ChainProvider(Provider):
    """A source over FullCommit codec bytes by height (of one chain: the
    chain id a caller passes is not looked at, as in the reference's
    NodeProvider)."""

    def __init__(self, full_commits: Mapping[int, bytes]):
        self._fcs = dict(full_commits)
        self.height = max(self._fcs) if self._fcs else 0

    def full_commit_at(self, chain_id: str, height: int) -> FullCommit:
        raw = self._fcs.get(height)
        if raw is None:
            raise ProviderError(f"height {height} not in the chain")
        return FullCommit.unmarshal(raw)

    def latest_full_commit(self, chain_id: str, min_height: int,
                           max_height: int) -> FullCommit:
        for h in range(min(max_height, self.height), min_height - 1, -1):
            if h in self._fcs:
                return self.full_commit_at(chain_id, h)
        raise ProviderError(f"no full commit for {chain_id} in [{min_height},{max_height}]")


class DoctoringProvider(Provider):
    """Rewrites each FullCommit an inner provider serves:
    ``doctor(height, fc) -> fc``, which may raise."""

    def __init__(self, inner: Provider, doctor: Callable[[int, FullCommit], FullCommit]):
        self._inner = inner
        self._doctor = doctor

    def full_commit_at(self, chain_id: str, height: int) -> FullCommit:
        return self._doctor(height, self._inner.full_commit_at(chain_id, height))

    def latest_full_commit(self, chain_id: str, min_height: int,
                           max_height: int) -> FullCommit:
        return self.full_commit_at(chain_id, max_height)


@dataclass
class LiteChain:
    chain_id: str
    full_commits: Dict[int, bytes]  # height -> FullCommit codec bytes

    @property
    def height(self) -> int:
        return max(self.full_commits)

    def full_commit(self, height: int) -> FullCommit:
        return FullCommit.unmarshal(self.full_commits[height])

    def provider(self) -> ChainProvider:
        return ChainProvider(self.full_commits)


def stranger_set(n: int, power: int = 10, seed: int = 0) -> ValidatorSet:
    """A set of n fresh seeded keys that signs nothing."""
    rng = np.random.default_rng(seed)
    return ValidatorSet([Validator(PubKeyEd25519(ed.pubkey_from_seed(rng.bytes(32))), power)
                         for _ in range(n)])


def flip_signature_bit(fc: FullCommit, index: int, bit: int = 300) -> FullCommit:
    """Flip one bit of precommit ``index``'s signature, in place."""
    pcs = fc.signed_header.commit.precommits
    sig = bytearray(pcs[index].signature)
    sig[bit // 8] ^= 1 << (bit % 8)
    pcs[index] = pcs[index].with_signature(bytes(sig))
    return fc


def strip_precommits(fc: FullCommit, indexes: Sequence[int]) -> FullCommit:
    """Set the precommits at ``indexes`` to nil, in place."""
    pcs = fc.signed_header.commit.precommits
    for i in indexes:
        pcs[i] = None
    return fc


def build_lite_chain(n_vals: int, n_heights: int, change_heights: Sequence[int] = (),
                     n_change: int = 0, power: int = 10, seed: int = 0,
                     chain_id: str = CHAIN_ID) -> LiteChain:
    rng = np.random.default_rng(seed)
    privs: Dict[bytes, bytes] = {}  # address -> 64-byte private key

    def fresh() -> Validator:
        priv = ed.gen_privkey(rng.bytes(32))
        pk = PubKeyEd25519(priv[32:])
        privs[pk.address()] = priv
        return Validator(pk, power)

    members = [fresh() for _ in range(n_vals)]
    sets: Dict[int, ValidatorSet] = {}
    vs = ValidatorSet(members)
    for h in range(1, n_heights + 2):
        if h in change_heights:
            for i in sorted(rng.choice(n_vals, n_change, replace=False).tolist()):
                members[i] = fresh()
            vs = ValidatorSet(members)
        elif h > 1:
            vs = vs.copy_increment_accum(1)
        sets[h] = vs

    fcs: Dict[int, bytes] = {}
    last_block_id, last_commit_hash = BlockID(), b""
    for h in range(1, n_heights + 1):
        vals = sets[h]
        header = Header(
            chain_id=chain_id,
            height=h,
            time_ns=TIME0 + h * SECOND,
            last_block_id=last_block_id,
            last_commit_hash=last_commit_hash,
            data_hash=sha256(b""),
            validators_hash=vals.hash(),
            next_validators_hash=sets[h + 1].hash(),
            consensus_hash=sha256(b"consensus-params"),
            app_hash=sha256(b"app-state-%d" % h),
            proposer_address=vals.get_proposer().address,
        )
        block_hash = header.hash()
        block_id = BlockID(block_hash, PartSetHeader(1, sha256(b"parts" + block_hash)))
        precommits = []
        for i, val in enumerate(vals.validators):
            vote = Vote(
                vote_type=SignedMsgType.PRECOMMIT,
                height=h,
                round=0,
                timestamp_ns=header.time_ns + SECOND + i,
                block_id=block_id,
                validator_address=val.address,
                validator_index=i,
            )
            precommits.append(vote.with_signature(
                ed.sign(privs[val.address], vote.sign_bytes(chain_id))))
        commit = Commit(block_id, precommits)
        fcs[h] = FullCommit(SignedHeader(header, commit), vals, sets[h + 1]).marshal()
        last_block_id = block_id
        last_commit_hash = merkle.hash_from_byte_slices([pc.marshal() for pc in precommits])
    return LiteChain(chain_id, fcs)
