"""Light-client verifiers (ref lite/base_verifier.go:18,
dynamic_verifier.go:21; the port's copy of the reference package's
``lite/verifier.py``).

BaseVerifier certifies headers against ONE known validator set.
DynamicVerifier tracks validator-set changes: it keeps a trust store of
FullCommits and hops trust forward: directly when the set is unchanged
(the trusted header's ``next_validators_hash``), through
``verify_future_commit`` when it changed, and by bisection when the change
is too large for one hop (``TooMuchChangeError`` only: halve the jump).

Every signature check rides the batch verifier given as
``batch_verifier`` (``None``: the process default, the guarded card
verifier), through ``ValidatorSet.verify_commit`` / ``verify_future_commit``.
"""

from __future__ import annotations

from tendermint_tpu_torch.lite.provider import DBProvider, Provider, ProviderError
from tendermint_tpu_torch.lite.types import FullCommit, LiteError, SignedHeader
from tendermint_tpu_torch.types.validator_set import TooMuchChangeError, ValidatorSet


class BaseVerifier:
    """Certifier over a fixed validator set (base_verifier.go)."""

    def __init__(self, chain_id: str, height: int, valset: ValidatorSet):
        self.chain_id = chain_id
        self.initial_height = height
        self.valset = valset

    def verify(self, signed_header: SignedHeader, verifier=None) -> None:
        """The height is in range, the set's hash matches, and more than
        2/3 of the set signed the header."""
        if signed_header.height < self.initial_height:
            raise LiteError(
                f"height {signed_header.height} below initial {self.initial_height}"
            )
        signed_header.validate_basic(self.chain_id)
        if signed_header.header.validators_hash != self.valset.hash():
            raise LiteError("header validators_hash != trusted valset")
        self.valset.verify_commit(
            self.chain_id,
            signed_header.commit.block_id,
            signed_header.height,
            signed_header.commit,
            verifier=verifier,
        )


class DynamicVerifier:
    """Certifier that tracks the validator set, over a trust store
    (dynamic_verifier.go)."""

    def __init__(self, chain_id: str, trusted: DBProvider, source: Provider,
                 batch_verifier=None):
        self.chain_id = chain_id
        self.trusted = trusted
        self.source = source
        self.batch_verifier = batch_verifier

    def init_from_full_commit(self, fc: FullCommit) -> None:
        """Seed trust, e.g. from a genesis or a checkpoint verified out of
        band."""
        fc.validate_full(self.chain_id)
        self.trusted.save_full_commit(fc)

    def verify(self, signed_header: SignedHeader) -> None:
        """Ensure a trusted FullCommit at exactly this height, then certify
        the header against its set."""
        h = signed_header.height
        tfc = self._trusted_at_or_below(h)
        if tfc.height != h:
            self._update_to_height(h)
            tfc = self._trusted_at_or_below(h)
            if tfc.height != h:
                raise LiteError(f"could not establish trust at height {h}")
        BaseVerifier(self.chain_id, tfc.height, tfc.validators).verify(
            signed_header, verifier=self.batch_verifier
        )

    def _trusted_at_or_below(self, h: int) -> FullCommit:
        try:
            return self.trusted.latest_full_commit(self.chain_id, 1, h)
        except ProviderError as e:
            raise LiteError(
                "no trusted full commit — seed with init_from_full_commit"
            ) from e

    def _update_to_height(self, h: int) -> None:
        """Fetch FullCommit(h) from the source and extend trust to it,
        bisecting on TooMuchChangeError (dynamic_verifier.go:195)."""
        fc = self.source.full_commit_at(self.chain_id, h)
        while True:
            tfc = self._trusted_at_or_below(h)
            if tfc.height == h:
                return
            try:
                self._verify_and_save(tfc, fc)
                return
            except TooMuchChangeError:
                # too much of the set changed in one hop: trust a midpoint first
                mid = (tfc.height + h) // 2
                if mid in (tfc.height, h):
                    raise
                self._update_to_height(mid)

    def _verify_and_save(self, tfc: FullCommit, fc: FullCommit) -> None:
        """One trust hop tfc -> fc (dynamic_verifier.go verifyAndSave)."""
        if fc.height <= tfc.height:
            raise LiteError("hop must move forward")
        fc.validate_full(self.chain_id)
        commit = fc.signed_header.commit
        if tfc.next_validators.hash() == fc.validators.hash():
            fc.validators.verify_commit(
                self.chain_id, commit.block_id, fc.height, commit,
                verifier=self.batch_verifier,
            )
        else:
            # the set changed: the new set must sign, and more than 2/3 of
            # the old next set must overlap (TooMuchChangeError otherwise)
            tfc.next_validators.verify_future_commit(
                fc.validators, self.chain_id, commit.block_id, fc.height, commit,
                verifier=self.batch_verifier,
            )
        self.trusted.save_full_commit(fc)
