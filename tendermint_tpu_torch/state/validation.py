"""Block validation against the state (ref state/validation.go:16-166), the
port's copy of the reference package's ``state/validation.py``.

The LastCommit check (validation.go:102) goes through
``ValidatorSet.verify_commit``: one batch call for the block's precommits,
to the verifier given or the installed one (on the card the configuration
root's ``GuardedBatchVerifier(TorchBatchVerifier())``: K1 + K2, K3 for
secp256k1 keys). Evidence is verified on the host, one vote at a time
(``verify_evidence`` -> ``DuplicateVoteEvidence.verify`` ->
``Vote.verify``), as the reference does: that is its path, not a fallback.
"""

from __future__ import annotations

from tendermint_tpu_torch.libs.db.kv import DB
from tendermint_tpu_torch.state import store
from tendermint_tpu_torch.state.state_types import State, median_time
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

MAX_EVIDENCE_PER_BLOCK = 50


class BlockValidationError(Exception):
    pass


class EvidenceInvalidError(Exception):
    pass


def validate_block(state_db: DB, state: State, block: Block, verifier=None,
                   trusted_last_commit: bool = False) -> None:
    """Raise unless ``block`` is the valid next block of ``state``.
    ``trusted_last_commit`` skips only the LastCommit's signature check
    (fast sync verified those signatures in its window); the structural,
    size and time checks still run."""
    block.validate_basic()
    h = block.header

    if h.version != state.version:
        raise BlockValidationError(f"wrong Version: expected {state.version}, got {h.version}")
    if h.chain_id != state.chain_id:
        raise BlockValidationError(
            f"wrong ChainID: expected {state.chain_id}, got {h.chain_id}")
    if h.height != state.last_block_height + 1:
        raise BlockValidationError(
            f"wrong Height: expected {state.last_block_height + 1}, got {h.height}")

    if h.last_block_id != state.last_block_id:
        raise BlockValidationError("wrong LastBlockID")
    new_txs = len(block.data.txs)
    if h.total_txs != state.last_block_total_tx + new_txs:
        raise BlockValidationError(
            f"wrong TotalTxs: expected {state.last_block_total_tx + new_txs}, "
            f"got {h.total_txs}")

    if h.app_hash != state.app_hash:
        raise BlockValidationError("wrong AppHash")
    if h.consensus_hash != state.consensus_params.hash():
        raise BlockValidationError("wrong ConsensusHash")
    if h.last_results_hash != state.last_results_hash:
        raise BlockValidationError("wrong LastResultsHash")
    if h.validators_hash != state.validators.hash():
        raise BlockValidationError("wrong ValidatorsHash")
    if h.next_validators_hash != state.next_validators.hash():
        raise BlockValidationError("wrong NextValidatorsHash")

    if h.height == 1:
        if len(block.last_commit.precommits) != 0:
            raise BlockValidationError("block at height 1 can't have LastCommit")
    else:
        if len(block.last_commit.precommits) != state.last_validators.size:
            raise BlockValidationError(
                f"invalid commit size: expected {state.last_validators.size}, "
                f"got {len(block.last_commit.precommits)}")
        if not trusted_last_commit:
            state.last_validators.verify_commit(
                state.chain_id, state.last_block_id, h.height - 1,
                block.last_commit, verifier=verifier)

    # block time: the BFT median of the LastCommit (validation.go:117-141)
    if h.height > 1:
        if h.time_ns <= state.last_block_time_ns:
            raise BlockValidationError("block time not greater than last block time")
        want = median_time(block.last_commit, state.last_validators)
        if h.time_ns != want:
            raise BlockValidationError(f"invalid block time: expected {want}, got {h.time_ns}")
    elif h.height == 1 and h.time_ns != state.last_block_time_ns:
        raise BlockValidationError("block time != genesis time")

    if len(block.evidence.evidence) > MAX_EVIDENCE_PER_BLOCK:
        raise BlockValidationError("too much evidence")
    for ev in block.evidence.evidence:
        try:
            verify_evidence(state_db, state, ev)
        except Exception as e:
            raise EvidenceInvalidError(str(e)) from e

    if (len(h.proposer_address) != 20
            or not state.validators.has_address(h.proposer_address)):
        raise BlockValidationError(
            f"ProposerAddress {h.proposer_address.hex()} is not a validator")


def verify_evidence(state_db: DB, state: State, ev: DuplicateVoteEvidence) -> None:
    """validation.go:167: recent enough, from a validator of its height,
    consistent, and signed."""
    height, ev_height = state.last_block_height, ev.height
    max_age = state.consensus_params.evidence.max_age
    if height - ev_height > max_age:
        raise EvidenceInvalidError(
            f"evidence from height {ev_height} is too old (now {height}, max age {max_age})")
    _, val = store.load_validators(state_db, ev_height).get_by_address(ev.address)
    if val is None:
        raise EvidenceInvalidError(
            f"address {ev.address.hex()} was not a validator at height {ev_height}")
    ev.verify(state.chain_id)
