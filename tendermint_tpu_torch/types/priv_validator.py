"""PrivValidator and the MockPV test signer (ref types/priv_validator.go),
the port's copy of the reference package's ``types/priv_validator.py``.

MockPV signs any vote, proposal or heartbeat with one key and keeps no
double-sign state.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PubKey
from tendermint_tpu_torch.types.proposal import Heartbeat, Proposal
from tendermint_tpu_torch.types.vote import Vote


class PrivValidator(ABC):
    """Signs votes and proposals with one consistent key."""

    @abstractmethod
    def get_pub_key(self) -> PubKey: ...

    @property
    def address(self) -> bytes:
        return self.get_pub_key().address()

    @abstractmethod
    def sign_vote(self, chain_id: str, vote: Vote) -> Vote: ...

    @abstractmethod
    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal: ...

    def sign_heartbeat(self, chain_id: str, heartbeat: Heartbeat) -> Heartbeat:
        raise NotImplementedError


class MockPV(PrivValidator):
    """A PrivValidator without persistence or double-sign checks."""

    def __init__(self, priv_key: Optional[object] = None):
        self._priv = priv_key or PrivKeyEd25519.generate()
        self.disable_checks = False  # the byzantine-test hook (MockPV.DisableChecks)

    def get_pub_key(self) -> PubKey:
        return self._priv.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        return vote.with_signature(self._priv.sign(vote.sign_bytes(chain_id)))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        return proposal.with_signature(self._priv.sign(proposal.sign_bytes(chain_id)))

    def sign_heartbeat(self, chain_id: str, heartbeat: Heartbeat) -> Heartbeat:
        return heartbeat.with_signature(self._priv.sign(heartbeat.sign_bytes(chain_id)))
