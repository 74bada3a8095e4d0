"""The evidence pool and its store (ref evidence/pool.go, store.go), the
port's copy of the reference package's ``evidence/pool.py``.

Holds verified DuplicateVoteEvidence that no block has committed yet, for
proposals to include; marks it committed; drops it past
``ConsensusParams.evidence.max_age``. Evidence is verified on the host,
one vote at a time (``state/validation.verify_evidence``), as in the
reference.
"""

from __future__ import annotations

import threading
from typing import List

from tendermint_tpu_torch.libs.clist import CList
from tendermint_tpu_torch.libs.db.kv import DB
from tendermint_tpu_torch.state.services import EvidencePool as EvidencePoolIface
from tendermint_tpu_torch.state.validation import verify_evidence
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

_PENDING = b"evp:"
_COMMITTED = b"evc:"


def _key(ev: DuplicateVoteEvidence) -> bytes:
    return b"%016d:%s" % (ev.height, ev.hash().hex().encode())


class EvidenceStore:
    """Pending and committed records (ref store.go)."""

    def __init__(self, db: DB):
        self._db = db

    def add_new_evidence(self, ev: DuplicateVoteEvidence) -> bool:
        k = _key(ev)
        if self._db.has(_PENDING + k) or self._db.has(_COMMITTED + k):
            return False
        self._db.set_sync(_PENDING + k, ev.marshal())
        return True

    def pending_evidence(self, max_count: int = -1) -> List[DuplicateVoteEvidence]:
        out = []
        for k, v in self._db.iterator(_PENDING, _PENDING + b"\xff"):
            out.append(DuplicateVoteEvidence.unmarshal(v))
            if 0 <= max_count <= len(out):
                break
        return out

    def mark_evidence_as_committed(self, ev: DuplicateVoteEvidence) -> None:
        k = _key(ev)
        self._db.delete(_PENDING + k)
        self._db.set(_COMMITTED + k, b"1")

    def is_committed(self, ev: DuplicateVoteEvidence) -> bool:
        return self._db.has(_COMMITTED + _key(ev))

    def prune_before(self, height: int) -> None:
        end = _PENDING + b"%016d" % height
        for k, _ in list(self._db.iterator(_PENDING, end)):
            self._db.delete(k)


class EvidencePool(EvidencePoolIface):
    def __init__(self, state_db: DB, evidence_db: DB, state, logger=None):
        self._state_db = state_db
        self.store = EvidenceStore(evidence_db)
        self._state = state
        self._mtx = threading.Lock()
        self.evidence_list = CList()  # what the gossip reactor walks
        import logging

        self.logger = logger or logging.getLogger("tm.evidence")
        for ev in self.store.pending_evidence():
            self.evidence_list.push_back(ev)

    @property
    def state(self):
        with self._mtx:
            return self._state

    def pending_evidence(self, max_bytes: int = -1) -> List[DuplicateVoteEvidence]:
        if max_bytes < 0:
            return self.store.pending_evidence()
        # a budget of 512 bytes an item, as the reference counts it
        max_count = max(0, max_bytes // 512)
        return self.store.pending_evidence(max_count)

    def add_evidence(self, ev: DuplicateVoteEvidence) -> None:
        """Verify against its height's validators, persist, and queue for
        gossip (pool.go:91)."""
        with self._mtx:
            state = self._state
        verify_evidence(self._state_db, state, ev)
        if not self.store.add_new_evidence(ev):
            return  # duplicate
        self.logger.info("verified new evidence height=%d addr=%s",
                         ev.height, ev.address.hex())
        self.evidence_list.push_back(ev)

    def update(self, block, state) -> None:
        """Mark the block's evidence committed and drop what is too old
        (pool.go Update)."""
        with self._mtx:
            self._state = state
        for ev in block.evidence.evidence:
            self.store.mark_evidence_as_committed(ev)
        max_age = state.consensus_params.evidence.max_age
        if block.height > max_age:
            self.store.prune_before(block.height - max_age)
        # committed or aged-out evidence leaves the gossip list on every
        # update (ref pool.go removeEvidence)
        el = self.evidence_list.front()
        while el is not None:
            nxt = el.next()
            if (
                el.value.height <= block.height - max_age
                or self.store.is_committed(el.value)
            ):
                self.evidence_list.remove(el)
            el = nxt

    def is_committed(self, ev: DuplicateVoteEvidence) -> bool:
        return self.store.is_committed(ev)
