"""A seeded, signed fast-sync window for the port's tests and
``chip_smoke.py``.

``build_window(H, V)`` makes H consecutive heights of one V-validator
ed25519 set (power 10 each). Every height has its own block id drawn from
the seed, and every validator signs that height's canonical precommit
sign-bytes (its own timestamp). ``SignedWindow.rows()`` turns the commits
into the ``(votes, powers, totals)`` the planner takes, through
``ValidatorSet.collect_commit_sigs`` and ``planner.rows_from_commit``, as
fast sync does. The fault helpers plant what a window must catch — a
flipped signature bit, dropped precommits, a 63-byte signature, an
all-absent height — and ``expected`` gives the verdict the construction
implies.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import numpy as np

from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.parallel.planner import rows_from_commit
from tendermint_tpu_torch.testutil.commit import flip_signature_bit
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote

CHAIN_ID = "fastsync-chain"
HEIGHT0 = 1
TIMESTAMP0 = 1_700_000_000_000_000_000
POWER = 10
FLIP_BIT = 300  # inside s: the signature keeps its shape and fails


@dataclass
class SignedWindow:
    valset: ValidatorSet
    privs: List[bytes]  # 64-byte ed25519 keys in validator-set order
    block_ids: List[BlockID]
    commits: List[Commit]
    chain_id: str = CHAIN_ID
    height0: int = HEIGHT0
    bad: Set[Tuple[int, int]] = field(default_factory=set)  # planted (h, v) failures

    @property
    def H(self) -> int:
        return len(self.commits)

    @property
    def V(self) -> int:
        return self.valset.size

    def rows(self):
        """(votes, powers, totals) for ``planner.verify_window``."""
        votes, powers = [], []
        for h, commit in enumerate(self.commits):
            if all(pc is None for pc in commit.precommits):
                cols = ([], [], [], [])  # nothing to collect: an all-nil row
            else:
                cols = self.valset.collect_commit_sigs(
                    self.chain_id, self.block_ids[h], self.height0 + h, commit)
            vrow, prow = rows_from_commit(commit.precommits, *cols)
            votes.append(vrow)
            powers.append(prow)
        return votes, powers, [self.valset.total_voting_power()] * self.H


def build_window(H: int, V: int, seed: int = 0) -> SignedWindow:
    """H heights of one seeded V-validator ed25519 set, every precommit
    present and signed."""
    rng = np.random.default_rng(seed)
    privs = [ed.gen_privkey(rng.bytes(32)) for _ in range(V)]
    by_addr = {PubKeyEd25519(p[32:]).address(): p for p in privs}
    valset = ValidatorSet([Validator(PubKeyEd25519(p[32:]), POWER) for p in privs])
    ordered = [by_addr[v.address] for v in valset.validators]
    block_ids, commits = [], []
    for h in range(H):
        block_id = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
        votes = []
        for i, (val, priv) in enumerate(zip(valset.validators, ordered)):
            vote = Vote(
                vote_type=SignedMsgType.PRECOMMIT,
                height=HEIGHT0 + h,
                round=0,
                timestamp_ns=TIMESTAMP0 + h * 1_000_000_000 + i * 1_000,
                block_id=block_id,
                validator_address=val.address,
                validator_index=i,
            )
            votes.append(vote.with_signature(ed.sign(priv, vote.sign_bytes(CHAIN_ID))))
        block_ids.append(block_id)
        commits.append(Commit(block_id, votes))
    return SignedWindow(valset, ordered, block_ids, commits)


def flip_bit(win: SignedWindow, h: int, v: int) -> None:
    """Flip a bit inside s of height h's precommit v."""
    win.commits[h] = flip_signature_bit(win.commits[h], v, FLIP_BIT)
    win.bad.add((h, v))


def drop_precommits(win: SignedWindow, h: int, n: int) -> None:
    """Set height h's last n precommits to nil."""
    keep = win.V - n
    pcs = [pc if i < keep else None for i, pc in enumerate(win.commits[h].precommits)]
    win.commits[h] = Commit(win.commits[h].block_id, pcs)


def short_signature(win: SignedWindow, h: int, v: int) -> None:
    """Cut height h's precommit v's signature to 63 bytes: Go rejects it
    without hashing, and the device route never dispatches it."""
    pcs = list(win.commits[h].precommits)
    pcs[v] = pcs[v].with_signature(pcs[v].signature[:63])
    win.commits[h] = Commit(win.commits[h].block_id, pcs)
    win.bad.add((h, v))


def absent_height(win: SignedWindow, h: int) -> None:
    """Every precommit of height h nil."""
    win.commits[h] = Commit(win.commits[h].block_id, [None] * win.V)


def expected(win: SignedWindow) -> Dict[str, np.ndarray]:
    """The verdict the construction implies: a present precommit verifies
    unless a fault was planted on it; tallies in int64, strict +2/3."""
    ok = np.zeros((win.H, win.V), dtype=bool)
    present = np.zeros((win.H, win.V), dtype=bool)
    for h, commit in enumerate(win.commits):
        for v, pc in enumerate(commit.precommits):
            present[h, v] = pc is not None
            ok[h, v] = pc is not None and (h, v) not in win.bad
    tally = ok.sum(axis=1).astype(np.int64) * POWER
    total = np.int64(win.valset.total_voting_power())
    return {
        "ok": ok,
        "tally": tally,
        "committed": tally * 3 > total * 2,
        "sigs_ok": ~(present & ~ok).any(axis=1),
    }
