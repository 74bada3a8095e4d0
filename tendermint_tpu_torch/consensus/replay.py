"""Crash recovery: WAL message replay within a height and the ABCI
handshake's block replay (ref consensus/replay.go), the port's copy of the
reference package's ``consensus/replay.py``.

Two tiers (SURVEY §3.5):
  1. catchup_replay — re-feed WAL messages after #ENDHEIGHT(h-1) into the
     state machine handlers so the round state catches up mid-height;
  2. Handshaker — on startup, compare app height (ABCI Info) with store/state
     heights and re-apply missing blocks so the app catches up to the store.

A block that both the app and the state miss goes through
``BlockExecutor.apply_block``: its LastCommit through the installed
verifier, on the card the configuration root's guarded one (K1 + K2, K3).
"""

from __future__ import annotations

import logging

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.consensus.messages import (
    EndHeightMessage,
    EventRoundStep,
    MsgInfo,
    TimeoutInfo,
)
from tendermint_tpu_torch.consensus.wal import DataCorruptionError
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.execution import (
    BlockExecutor,
    exec_block_on_proxy_app,
    update_state,
)
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, PubKeySecp256k1
from tendermint_tpu_torch.state.state_types import State
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet


class ReplayError(Exception):
    pass


class _MockAppConnConsensus:
    """Consensus app-conn that replays recorded ABCIResponses instead of
    re-executing txs (ref: replay.go:457 mockProxyApp).

    Used when the app already ran Commit for a block but the node crashed
    before save_state: re-running the real app would double-apply the txs.
    """

    def __init__(self, app_hash: bytes, abci_responses: "sm_store.ABCIResponses"):
        self._app_hash = app_hash
        self._responses = abci_responses
        self._tx_count = 0
        self._cb = None

    def set_response_callback(self, cb):
        self._cb = cb

    def error(self):
        return None

    def begin_block_sync(self, req):
        return self._responses.begin_block or abci.ResponseBeginBlock()

    def deliver_tx_async(self, tx: bytes):
        if self._tx_count >= len(self._responses.deliver_tx):
            raise ReplayError(
                f"recorded ABCIResponses truncated: only "
                f"{len(self._responses.deliver_tx)} DeliverTx responses"
            )
        res = self._responses.deliver_tx[self._tx_count]
        self._tx_count += 1
        if self._cb is not None:
            self._cb(abci.RequestDeliverTx(tx=tx), res)
        return res

    def end_block_sync(self, req):
        return self._responses.end_block or abci.ResponseEndBlock()

    def commit_sync(self):
        return abci.ResponseCommit(data=self._app_hash)


def _abci_consensus_params(params) -> abci.ConsensusParams:
    """types.ConsensusParams → abci.ConsensusParams (for RequestInitChain)."""
    return abci.ConsensusParams(
        block_size=abci.BlockSizeParams(
            max_bytes=params.block_size.max_bytes, max_gas=params.block_size.max_gas
        ),
        evidence=abci.EvidenceParams(max_age=params.evidence.max_age),
        validator=abci.ValidatorParams(
            pub_key_types=list(params.validator.pub_key_types)
        ),
    )


# ---------------------------------------------------------------------------
# Tier 1: WAL catchup within a height (replay.go:44-195)
# ---------------------------------------------------------------------------


def replay_one_message(cs, tm) -> None:
    """Re-feed one timed WAL message into the handlers (replay.go:44)."""
    msg = tm.msg
    if isinstance(msg, EventRoundStep):
        return  # informational
    if isinstance(msg, TimeoutInfo):
        cs._handle_timeout(msg, cs.rs)
    elif isinstance(msg, MsgInfo):
        cs._handle_msg(msg)
    elif isinstance(msg, EndHeightMessage):
        raise ReplayError(
            f"unexpected EndHeight {msg.height} while replaying"
        )


def catchup_replay(cs, cs_height: int) -> int:
    """Replay WAL messages since the last block (replay.go:97).  Returns the
    number of messages replayed (0 when the WAL had nothing for us)."""
    cs.replay_mode = True
    try:
        # sanity: nothing for this height should be fully written already
        it = cs.wal.search_for_end_height(cs_height)
        if it is not None:
            raise ReplayError(
                f"WAL should not contain #ENDHEIGHT {cs_height}"
            )
        it = cs.wal.search_for_end_height(cs_height - 1)
        if it is None:
            if cs_height > 1:
                cs.logger.info(
                    "WAL has no #ENDHEIGHT %d — starting fresh", cs_height - 1
                )
                return 0
            # height 1: replay everything from the start
            try:
                it = cs.wal.iter_all()
            except Exception:
                return 0
        count = 0
        try:
            for tm in it:
                replay_one_message(cs, tm)
                count += 1
        except DataCorruptionError as e:
            cs.logger.error("WAL corruption during replay: %s", e)
        cs.logger.info("replayed %d WAL messages for height %d", count, cs_height)
        return count
    finally:
        cs.replay_mode = False


# ---------------------------------------------------------------------------
# Tier 2: ABCI handshake (replay.go:195-456)
# ---------------------------------------------------------------------------


class Handshaker:
    def __init__(self, state_db, state: State, block_store, genesis_doc, logger=None):
        self.state_db = state_db
        self.initial_state = state
        self.store = block_store
        self.genesis = genesis_doc
        self.n_blocks = 0
        self.logger = logger or logging.getLogger("tm.handshaker")

    def handshake(self, proxy_app) -> State:
        """Sync the app with store/state; returns the possibly-updated state
        (replay.go:227)."""
        res = proxy_app.query.info_sync(abci.RequestInfo(version="tpu"))
        app_height = max(0, res.last_block_height)
        app_hash = res.last_block_app_hash
        self.logger.info(
            "ABCI handshake: app height=%d hash=%s", app_height, app_hash.hex()
        )
        state = self.replay_blocks(self.initial_state, app_hash, app_height, proxy_app)
        return state

    def replay_blocks(
        self, state: State, app_hash: bytes, app_height: int, proxy_app
    ) -> State:
        store_height = self.store.height()
        state_height = state.last_block_height

        # genesis: app at 0 → InitChain (replay.go:280-313)
        if app_height == 0:
            validators = [
                abci.ValidatorUpdate(
                    pub_key_type=(
                        "secp256k1" if "Secp256k1" in v.pub_key.type_name else "ed25519"
                    ),
                    pub_key=v.pub_key.bytes(),
                    power=v.power,
                )
                for v in self.genesis.validators
            ]
            req = abci.RequestInitChain(
                time_ns=self.genesis.genesis_time_ns,
                chain_id=self.genesis.chain_id,
                consensus_params=_abci_consensus_params(self.genesis.consensus_params),
                validators=validators,
            )
            res = proxy_app.consensus.init_chain_sync(req)
            if state.last_block_height == 0:
                # only apply the app's genesis overrides if we're starting
                # from genesis ourselves (replay.go:294-303)
                if res.consensus_params is not None:
                    state.consensus_params = state.consensus_params.update(
                        res.consensus_params
                    )
                    state.consensus_params.validate()
                if res.validators:
                    # the app overrode the genesis validator set (replay.go:301)
                    vals = []
                    for vu in res.validators:
                        pk_cls = (
                            PubKeyEd25519 if vu.pub_key_type == "ed25519" else PubKeySecp256k1
                        )
                        vals.append(Validator(pk_cls(vu.pub_key), vu.power))
                    vs = ValidatorSet(vals)
                    state.validators = vs
                    state.next_validators = vs.copy()
                sm_store.save_state(self.state_db, state)

        if store_height == 0:
            return state

        if store_height < app_height:
            raise ReplayError(
                f"app block height {app_height} ahead of store {store_height}"
            )
        if state_height > store_height:
            raise ReplayError(
                f"state height {state_height} ahead of store {store_height}"
            )
        if store_height > state_height + 1:
            # the store can lead the state by at most one block (the crash
            # window between SaveBlock and save_state) — anything more means
            # a corrupted DB (replay.go:320-322)
            raise ReplayError(
                f"store height {store_height} more than one ahead of "
                f"state height {state_height}"
            )

        # replay blocks the app is missing (and maybe the state too)
        first = app_height + 1
        for h in range(first, store_height + 1):
            block = self.store.load_block(h)
            if block is None:
                raise ReplayError(f"missing block {h} in store")
            if h <= state_height:
                # app behind state: re-exec against the app only, with the
                # validator set that actually signed block h's LastCommit
                self.logger.info("replaying block %d against app", h)
                if h > 1:
                    try:
                        hist_vals = sm_store.load_validators(self.state_db, h - 1)
                    except sm_store.NoValSetForHeightError:
                        # acceptable fallback (the reference uses
                        # state.LastValidators unconditionally, replay.go TODO)
                        # but wrong if the valset changed — warn loudly so an
                        # app-hash mismatch downstream has a visible cause
                        self.logger.info(
                            "no stored valset for height %d; falling back to "
                            "state.last_validators (wrong if valset changed)",
                            h - 1,
                        )
                        hist_vals = state.last_validators
                else:
                    hist_vals = state.last_validators  # empty LastCommit at h=1
                exec_block_on_proxy_app(
                    proxy_app.consensus, block, hist_vals,
                    self.state_db, self.logger,
                )
                res = proxy_app.consensus.commit_sync()
                app_hash = res.data
            else:
                # both app and state need this block: full apply
                self.logger.info("applying block %d (app + state)", h)
                block_exec = BlockExecutor(self.state_db, proxy_app.consensus)
                meta = self.store.load_block_meta(h)
                if meta is None:
                    raise ReplayError(f"missing block meta {h} in store")
                state = block_exec.apply_block(state, meta.block_id, block)
                app_hash = state.app_hash
            self.n_blocks += 1

        if app_height == store_height == state_height + 1:
            # the app ran Commit for the last stored block but we crashed
            # before save_state: re-running the real app would double-apply
            # its txs. Replay the block against a mock conn that returns the
            # recorded ABCIResponses + app hash (replay.go:357-365, :457).
            self.logger.info(
                "replaying block %d with recorded responses (app ahead of state)",
                store_height,
            )
            abci_responses = sm_store.load_abci_responses(self.state_db, store_height)
            mock_conn = _MockAppConnConsensus(app_hash, abci_responses)
            block = self.store.load_block(store_height)
            if block is None:
                raise ReplayError(f"missing block {store_height} in store")
            meta = self.store.load_block_meta(store_height)
            if meta is None:
                raise ReplayError(f"missing block meta {store_height} in store")
            block_exec = BlockExecutor(self.state_db, mock_conn)
            state = block_exec.apply_block(state, meta.block_id, block)
            self.n_blocks += 1

        if state.last_block_height == store_height and state.app_hash != app_hash:
            # app nondeterminism or data corruption — halt, don't mask it
            # (replay.go checkAppHash panics here)
            raise ReplayError(
                f"app hash mismatch at height {store_height}: state has "
                f"{state.app_hash.hex()}, app reproduced {app_hash.hex()}"
            )
        return state
