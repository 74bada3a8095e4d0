"""Byzantine signer wrappers; the port's copy of the reference package's
``sim/byzantine.py``, whose fabricated block ids it equals byte for byte.

``EquivocatingPV`` wraps any PrivValidator and, for every prevote/precommit
it signs from ``start_height`` on, ALSO signs a conflicting vote for a
fabricated block hash — the classic double-sign.  The wrapper itself only
collects the conflicting signatures; the sim node's equivocation pump
(`SimNode.start_equivocation_pump`) broadcasts them on the consensus VOTE
channel so honest peers see both votes, hit ``ErrVoteConflictingVotes`` in
their vote sets, mint ``DuplicateVoteEvidence``, and push it into their
evidence pools — the entry point of the whole evidence pipeline.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import replace
from typing import List

from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.priv_validator import PrivValidator
from tendermint_tpu_torch.types.vote import Vote


def _fabricated_block_id(height: int, round: int, vote_type: int) -> BlockID:
    """A syntactically valid, never-proposed BlockID, deterministic in
    (height, round, type) so reruns equivocate identically."""
    h = hashlib.sha256(b"equivocation|%d|%d|%d" % (height, round, vote_type))
    block_hash = h.digest()
    parts_hash = hashlib.sha256(block_hash).digest()
    return BlockID(hash=block_hash,
                   parts_header=PartSetHeader(total=1, hash=parts_hash))


class EquivocatingPV(PrivValidator):
    """Signs the honest vote AND a conflicting double for the same
    (height, round, type).  Proposals pass through untouched."""

    def __init__(self, inner: PrivValidator, start_height: int = 2,
                 max_equivocations: int = 8):
        self.inner = inner
        self.start_height = start_height
        self.max_equivocations = max_equivocations
        self._mtx = threading.Lock()
        self._conflicting: List[Vote] = []
        self.equivocations = 0

    def get_pub_key(self):
        return self.inner.get_pub_key()

    def sign_proposal(self, chain_id: str, proposal):
        return self.inner.sign_proposal(chain_id, proposal)

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        signed = self.inner.sign_vote(chain_id, vote)
        if (
            vote.height >= self.start_height
            and vote.vote_type in (SignedMsgType.PREVOTE,
                                   SignedMsgType.PRECOMMIT)
            and self.equivocations < self.max_equivocations
        ):
            alt_id = _fabricated_block_id(
                vote.height, vote.round, int(vote.vote_type)
            )
            if alt_id.hash != signed.block_id.hash:
                alt = replace(signed, block_id=alt_id, signature=b"")
                alt_signed = self.inner.sign_vote(chain_id, alt)
                with self._mtx:
                    self._conflicting.append(alt_signed)
                    self.equivocations += 1
        return signed

    def drain_conflicting(self) -> List[Vote]:
        """The double-signed votes accumulated since the last drain; the
        node's equivocation pump broadcasts these to peers."""
        with self._mtx:
            out, self._conflicting = self._conflicting, []
            return out
