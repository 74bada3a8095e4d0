"""State persistence (ref state/store.go:29-300), the port's copy of the
reference package's ``state/store.py``.

The reference's keys: the State under ``stateKey``; a validator-set record
a height (``validatorsKey:<H>``), consensus params a height
(``consensusParamsKey:<H>``) and the ABCI responses a height
(``abciResponsesKey:<H>``). A validator or params record holds the whole
value only at a height where it changed and a pointer to that height
elsewhere; a load follows the pointer, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.libs.db.kv import DB
from tendermint_tpu_torch.state.state_types import State, state_from_genesis
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.results import ABCIResults
from tendermint_tpu_torch.types.validator_set import ValidatorSet

_STATE_KEY = b"stateKey"


def _validators_key(height: int) -> bytes:
    return b"validatorsKey:%d" % height


def _params_key(height: int) -> bytes:
    return b"consensusParamsKey:%d" % height


def _abci_responses_key(height: int) -> bytes:
    return b"abciResponsesKey:%d" % height


class NoValSetForHeightError(Exception):
    pass


class NoABCIResponsesForHeightError(Exception):
    pass


@dataclass
class ABCIResponses:
    """A block's ABCI responses, kept for replay and indexing (ref state.go
    ABCIResponses); persisted as the ABCI JSON form."""

    deliver_tx: List[abci.ResponseDeliverTx] = field(default_factory=list)
    end_block: Optional[abci.ResponseEndBlock] = None
    begin_block: Optional[abci.ResponseBeginBlock] = None

    def results_hash(self) -> bytes:
        return ABCIResults.from_deliver_txs(self.deliver_tx).hash()

    def marshal(self) -> bytes:
        return abci.msg_to_json([self.deliver_tx, self.end_block, self.begin_block])

    @classmethod
    def unmarshal(cls, data: bytes) -> "ABCIResponses":
        dtxs, eb, bb = abci.msg_from_json(data)
        return cls(deliver_tx=dtxs, end_block=eb, begin_block=bb)


def load_state(db: DB) -> Optional[State]:
    raw = db.get(_STATE_KEY)
    return State.unmarshal(raw) if raw else None


def save_state(db: DB, state: State) -> None:
    """The state, and the next height's validator and params records (ref
    store.go saveState)."""
    next_height = state.last_block_height + 1
    if next_height == 1:
        # the genesis validators are height 1's
        save_validators_info(db, next_height, state.last_height_validators_changed,
                             state.validators)
    save_validators_info(db, next_height + 1, state.last_height_validators_changed,
                         state.next_validators)
    save_consensus_params_info(db, next_height, state.last_height_consensus_params_changed,
                               state.consensus_params)
    db.set_sync(_STATE_KEY, state.marshal())


def load_state_from_db_or_genesis(db: DB, genesis: GenesisDoc) -> State:
    state = load_state(db)
    if state is None or state.is_empty():
        state = state_from_genesis(genesis)
    return state


def _save_info(db: DB, key: bytes, height: int, last_changed: int, value) -> None:
    w = Writer().svarint(last_changed)
    if height == last_changed and value is not None:
        w.bool(True)
        value.encode(w)
    else:
        w.bool(False)
    db.set(key, w.build())


def _load_info(db: DB, key_of, height: int, decode, what: str):
    raw = db.get(key_of(height))
    if raw is None:
        raise NoValSetForHeightError(what)
    r = Reader(raw)
    last_changed = r.svarint()
    if r.bool():
        return decode(r)
    raw = db.get(key_of(last_changed))  # the pointer to the change height
    if raw is None:
        raise NoValSetForHeightError(what)
    r = Reader(raw)
    r.svarint()
    if not r.bool():
        raise NoValSetForHeightError(what)
    return decode(r)


def save_validators_info(db: DB, height: int, last_changed: int,
                         vals: Optional[ValidatorSet]) -> None:
    """The record at ``height``: the whole set at a change height, else the
    pointer (ref store.go:149-170)."""
    _save_info(db, _validators_key(height), height, last_changed, vals)


def load_validators(db: DB, height: int) -> ValidatorSet:
    return _load_info(db, _validators_key, height, ValidatorSet.decode, height)


def save_consensus_params_info(db: DB, height: int, last_changed: int,
                               params: ConsensusParams) -> None:
    _save_info(db, _params_key(height), height, last_changed, params)


def load_consensus_params(db: DB, height: int) -> ConsensusParams:
    return _load_info(db, _params_key, height, ConsensusParams.decode, f"params @ {height}")


def save_abci_responses(db: DB, height: int, responses: ABCIResponses) -> None:
    db.set(_abci_responses_key(height), responses.marshal())


def load_abci_responses(db: DB, height: int) -> ABCIResponses:
    raw = db.get(_abci_responses_key(height))
    if raw is None:
        raise NoABCIResponsesForHeightError(height)
    return ABCIResponses.unmarshal(raw)
