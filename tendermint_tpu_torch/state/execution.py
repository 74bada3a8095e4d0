"""BlockExecutor: validates, executes on the app, commits and persists
blocks (ref state/execution.go), the port's copy of the reference
package's ``state/execution.py``.

``apply_block`` is the state transition: validate (the LastCommit through
the verifier given, else the installed one: on the card the configuration
root's ``GuardedBatchVerifier``, K1 + K2 or K3) -> BeginBlock, DeliverTx,
EndBlock on the app -> save the ABCI responses -> the EndBlock validator
and params updates -> the app's Commit under the mempool's lock, and the
mempool's update -> save the state -> the events. ``fail_point()`` marks
the reference's crash-consistency sites (execution.go:102-106).

Where the port differs: the reference turns every exception of validation
into ``InvalidBlockError``. On the card a guarded dispatch that fails,
hangs or mis-audits raises ``breaker.DeviceDispatchError`` (or
``DeviceAuditMismatch``); ``apply_block`` re-raises it as it is, having
applied and saved nothing, so a device fault never reads as an invalid
block (which fast sync would blame on the peer, and consensus on the
proposer). Off the card it wraps as the reference does. A failure out of
``Mempool.update`` comes after the app's Commit: the mempool is unlocked,
the height's ABCI responses are saved, the state is not, and the error
reaches the caller; the handshake's replay recovers from there, as after
a crash at a fail point.

The parts of ``apply_block`` are traced as ``state.validate``,
``state.exec``, ``state.update``, ``state.commit`` (Commit and the
mempool's update) and ``state.save``; ``state.begin_block_info`` inside
``state.exec`` is BeginBlock's vote info.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto import batch as _batch
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, PubKeySecp256k1
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.libs import fail, trace
from tendermint_tpu_torch.libs.db.kv import DB
from tendermint_tpu_torch.state import store
from tendermint_tpu_torch.state.services import MockEvidencePool, MockMempool
from tendermint_tpu_torch.state.state_types import State
from tendermint_tpu_torch.state.validation import validate_block
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.core import BlockID
from tendermint_tpu_torch.types.events import EventBus
from tendermint_tpu_torch.types.validator_set import (
    _MAX_TOTAL_POWER,
    Validator,
    ValidatorSet,
)


class InvalidBlockError(Exception):
    pass


class ProxyAppConnError(Exception):
    pass


def _verifier_on_card(verifier) -> bool:
    """Whether the verifier that validation calls (``verifier``, else the
    installed one) runs on the card."""
    v = verifier if verifier is not None else _batch.installed_batch_verifier()
    return getattr(v, "on_card", False) is True or _brk.on_card(v)


class BlockExecutor:
    def __init__(self, state_db: DB, proxy_app, mempool=None, evpool=None,
                 event_bus: Optional[EventBus] = None, verifier=None, metrics=None,
                 logger=None):
        self.db = state_db
        self.proxy_app = proxy_app  # AppConnConsensus
        self.mempool = mempool if mempool is not None else MockMempool()
        self.evpool = evpool if evpool is not None else MockEvidencePool()
        self.event_bus = event_bus
        self.verifier = verifier  # None: the installed verifier
        self.metrics = metrics  # libs/metrics.StateMetrics
        self.logger = logger or logging.getLogger("tm.state")

    def validate_block(self, state: State, block: Block,
                       trusted_last_commit: bool = False) -> None:
        validate_block(self.db, state, block, verifier=self.verifier,
                       trusted_last_commit=trusted_last_commit)

    def apply_block(self, state: State, block_id: BlockID, block: Block,
                    trusted_last_commit: bool = False) -> State:
        """execution.go:88: the new state, or an exception (the caller
        halts). ``trusted_last_commit``: fast sync's window verify already
        checked this block's LastCommit signatures."""
        try:
            with trace.span("state.validate", height=block.height):
                self.validate_block(state, block, trusted_last_commit=trusted_last_commit)
        except _brk.DeviceDispatchError as e:
            if _verifier_on_card(self.verifier):
                raise
            raise InvalidBlockError(str(e)) from e
        except Exception as e:
            raise InvalidBlockError(str(e)) from e

        t0 = time.monotonic()
        with trace.span("state.exec", height=block.height, txs=len(block.data.txs)):
            abci_responses = exec_block_on_proxy_app(
                self.proxy_app, block, state.last_validators, self.db, self.logger)
        if self.metrics is not None:
            self.metrics.block_processing_time.observe(time.monotonic() - t0)

        fail.fail_point()

        with trace.span("state.save", what="abci_responses"):
            store.save_abci_responses(self.db, block.height, abci_responses)

        fail.fail_point()

        with trace.span("state.update"):
            state = update_state(state, block_id, block.header, abci_responses)

        # the mempool locked across the app's Commit and its update
        with trace.span("state.commit"):
            app_hash = self.commit(state, block)

        self.evpool.update(block, state)

        fail.fail_point()

        state.app_hash = app_hash
        with trace.span("state.save", what="state"):
            store.save_state(self.db, state)

        fail.fail_point()

        if self.event_bus is not None:
            fire_events(self.event_bus, block, abci_responses)
        return state

    def commit(self, state: State, block: Block) -> bytes:
        """The app's Commit and the mempool's update under the mempool's
        lock (execution.go:145-192); the app hash."""
        self.mempool.lock()
        try:
            self.mempool.flush_app_conn()
            res = self.proxy_app.commit_sync()
            self.logger.info("committed state height=%d txs=%d app_hash=%s",
                             block.height, len(block.data.txs), res.data.hex())
            self.mempool.update(block.height, block.data.txs)
            return res.data
        finally:
            self.mempool.unlock()

    def create_proposal_block(self, height: int, state: State, commit,
                              proposer_address: bytes) -> Tuple[Block, object]:
        """The next proposal from the mempool's and the evidence pool's
        reaps (ref execution.go CreateProposalBlock): (block, part set)."""
        max_bytes = state.consensus_params.block_size.max_bytes
        max_gas = state.consensus_params.block_size.max_gas
        evidence = self.evpool.pending_evidence(max_bytes // 10)
        txs = self.mempool.reap_max_bytes_max_gas(max_bytes * 9 // 10, max_gas)
        block = state.make_block(height, txs, commit, evidence, proposer_address)
        return block, block.make_part_set()


def exec_block_on_proxy_app(proxy_app, block: Block, last_val_set: ValidatorSet,
                            state_db: DB, logger) -> store.ABCIResponses:
    """BeginBlock, DeliverTx for every tx (async), EndBlock
    (execution.go:194-264). An app in the node's process that raises raises
    out of here; a remote app's crash (``ResponseException``, the socket and
    gRPC transports) is a ``ProxyAppConnError``, on a DeliverTx once EndBlock
    has flushed the pipeline."""
    deliver_txs: List[Optional[abci.ResponseDeliverTx]] = [None] * len(block.data.txs)
    counted = [0]
    app_err: List[Optional[str]] = [None]

    def on_response(req, res):
        if isinstance(res, abci.ResponseException) and isinstance(req, abci.RequestDeliverTx):
            # the app crashed on a tx: the block fails rather than shift the
            # results (a state divergence)
            app_err[0] = res.error
            counted[0] += 1
        elif isinstance(res, abci.ResponseDeliverTx):
            deliver_txs[counted[0]] = res
            if res.code != abci.CODE_TYPE_OK:
                logger.debug("invalid tx code=%d log=%s", res.code, res.log)
            counted[0] += 1

    proxy_app.set_response_callback(on_response)

    with trace.span("state.begin_block_info"):
        commit_info, byz_vals = _get_begin_block_validator_info(block, last_val_set, state_db)
    bb = proxy_app.begin_block_sync(abci.RequestBeginBlock(
        hash=block.hash() or b"",
        header=_abci_header(block),
        last_commit_info=commit_info,
        byzantine_validators=byz_vals,
    ))
    if isinstance(bb, abci.ResponseException):
        raise ProxyAppConnError(bb.error)

    for tx in block.data.txs:
        proxy_app.deliver_tx_async(bytes(tx))
        err = proxy_app.error()
        if err:
            raise ProxyAppConnError(str(err))

    eb = proxy_app.end_block_sync(abci.RequestEndBlock(height=block.height))
    if isinstance(eb, abci.ResponseException):
        raise ProxyAppConnError(eb.error)

    # end_block_sync flushed the pipeline: every DeliverTx is accounted for
    if app_err[0] is not None:
        raise ProxyAppConnError(f"DeliverTx failed: {app_err[0]}")
    if counted[0] != len(block.data.txs) or any(r is None for r in deliver_txs):
        raise ProxyAppConnError(
            f"DeliverTx responses missing: got {counted[0]}/{len(block.data.txs)}")

    return store.ABCIResponses(deliver_tx=list(deliver_txs), end_block=eb, begin_block=bb)


def _abci_header(block: Block) -> abci.ABCIHeader:
    h = block.header
    return abci.ABCIHeader(chain_id=h.chain_id, height=h.height, time_ns=h.time_ns,
                           num_txs=h.num_txs, total_txs=h.total_txs, app_hash=h.app_hash,
                           proposer_address=h.proposer_address)


def _get_begin_block_validator_info(block: Block, last_val_set: ValidatorSet, state_db: DB):
    votes = []
    if block.height > 1:
        precommits = block.last_commit.precommits
        n_pc = len(precommits)
        votes = [abci.VoteInfo(val.address, val.voting_power,
                               i < n_pc and precommits[i] is not None)
                 for i, val in enumerate(last_val_set.validators)]
    byz = []
    for ev in block.evidence.evidence:
        try:
            valset = store.load_validators(state_db, ev.height)
            _, val = valset.get_by_address(ev.address)
            power = val.voting_power if val else 0
            total = valset.total_voting_power()
        except store.NoValSetForHeightError:
            power, total = 0, 0
        byz.append(abci.ABCIEvidence(type="duplicate/vote", validator_address=ev.address,
                                     validator_power=power, height=ev.height,
                                     total_voting_power=total))
    return abci.LastCommitInfo(round=block.last_commit.round(), votes=votes), byz


def update_validators(current_set: ValidatorSet,
                      updates: List[abci.ValidatorUpdate]) -> None:
    """Apply EndBlock's changes (execution.go:318): power 0 removes, an
    unknown key joins, a known one is replaced."""
    for vu in updates:
        if vu.power < 0:
            raise ValueError(f"voting power can't be negative: {vu}")
        if vu.power > _MAX_TOTAL_POWER:
            # the set clips at this bound and packs powers as int64
            raise ValueError(f"voting power {vu.power} exceeds maximum")
        if vu.pub_key_type == "ed25519":
            pub = PubKeyEd25519(vu.pub_key)
        elif vu.pub_key_type == "secp256k1":
            pub = PubKeySecp256k1(vu.pub_key)
        else:
            raise ValueError(f"unknown pubkey type {vu.pub_key_type!r}")
        address = pub.address()
        _, val = current_set.get_by_address(address)
        if vu.power == 0:
            if current_set.remove(address) is None:
                raise ValueError(f"failed to remove validator {address.hex()}")
        elif val is None:
            if not current_set.add(Validator(pub, vu.power)):
                raise ValueError("failed to add new validator")
        elif not current_set.update(Validator(pub, vu.power)):
            raise ValueError("failed to update validator")


def update_state(state: State, block_id: BlockID, header,
                 abci_responses: store.ABCIResponses) -> State:
    """execution.go:356: the state after ``header``'s block, before the
    app hash."""
    n_val_set = state.next_validators.copy()

    last_height_vals_changed = state.last_height_validators_changed
    if abci_responses.end_block and abci_responses.end_block.validator_updates:
        update_validators(n_val_set, abci_responses.end_block.validator_updates)
        # the change takes effect the height after next
        last_height_vals_changed = header.height + 1 + 1

    n_val_set.increment_accum(1)

    next_params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    if abci_responses.end_block and abci_responses.end_block.consensus_param_updates:
        next_params = state.consensus_params.update(
            abci_responses.end_block.consensus_param_updates)
        next_params.validate()
        last_height_params_changed = header.height + 1

    return State(
        chain_id=state.chain_id,
        version=state.version,
        last_block_height=header.height,
        last_block_total_tx=state.last_block_total_tx + header.num_txs,
        last_block_id=block_id,
        last_block_time_ns=header.time_ns,
        next_validators=n_val_set,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_height_vals_changed,
        consensus_params=next_params,
        last_height_consensus_params_changed=last_height_params_changed,
        last_results_hash=abci_responses.results_hash(),
        app_hash=b"",  # set after Commit
    )


def fire_events(event_bus: EventBus, block: Block,
                abci_responses: store.ABCIResponses) -> None:
    """NewBlock, NewBlockHeader and one Tx event a tx (execution.go:421)."""
    event_bus.publish_event_new_block(block, abci_responses)
    event_bus.publish_event_new_block_header(block.header)
    for i, tx in enumerate(block.data.txs):
        res = abci_responses.deliver_tx[i] if i < len(abci_responses.deliver_tx) else None
        event_bus.publish_event_tx(block.height, i, bytes(tx), res)
