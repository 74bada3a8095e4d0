"""EventBus and its events (ref types/event_bus.go, types/events.go), the
port's copy of the reference package's ``types/events.py``.

The EventBus carries what ``state/execution.fire_events`` publishes
(``NewBlock``, ``NewBlockHeader``, one ``Tx`` a delivered tx) and what the
consensus state publishes (its round steps and votes) to subscribers
through ``libs/pubsub.py`` and its tag queries; each subscriber reads its
own ``Subscription`` queue.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

from tendermint_tpu_torch.libs.pubsub import Server, Subscription
from tendermint_tpu_torch.libs.service import BaseService

EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_TX = "Tx"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_NEW_ROUND = "NewRound"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_POLKA = "Polka"
EVENT_UNLOCK = "Unlock"
EVENT_LOCK = "Lock"
EVENT_RELOCK = "Relock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_VOTE = "Vote"
EVENT_PROPOSAL_HEARTBEAT = "ProposalHeartbeat"
EVENT_VALID_BLOCK = "ValidBlock"

# tag keys (events.go: EventTypeKey, TxHashKey, TxHeightKey)
EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"


def query_for_event(event_type: str) -> str:
    return f"{EVENT_TYPE_KEY} = '{event_type}'"


@dataclass
class EventDataNewBlock:
    block: Any
    result_begin_block: Any = None
    result_end_block: Any = None


@dataclass
class EventDataNewBlockHeader:
    header: Any


@dataclass
class EventDataTx:
    height: int
    index: int
    tx: bytes
    result: Any


@dataclass
class EventDataRoundState:
    height: int
    round: int
    step: str
    round_state: Any = None


@dataclass
class EventDataVote:
    vote: Any


class EventBus(BaseService):
    """event_bus.go:23: typed publish helpers over one pubsub server."""

    def __init__(self, buffer: int = 1024):
        super().__init__("EventBus")
        self._server = Server(buffer=buffer)

    def subscribe(self, client_id: str, query: str, maxsize: int = 0) -> Subscription:
        return self._server.subscribe(client_id, query, maxsize)

    def unsubscribe(self, client_id: str, query: str) -> None:
        self._server.unsubscribe(client_id, query)

    def unsubscribe_all(self, client_id: str) -> None:
        self._server.unsubscribe_all(client_id)

    def set_on_drop(self, fn) -> None:
        """Callback(client_id) on every slow-subscriber drop (pubsub.py)."""
        self._server.set_on_drop(fn)

    def dropped_events(self, client_id: Optional[str] = None):
        return self._server.dropped_events(client_id)

    def _publish(self, event_type: str, data: Any,
                 extra_tags: Optional[Dict[str, str]] = None) -> None:
        tags = {EVENT_TYPE_KEY: event_type}
        if extra_tags:
            tags.update(extra_tags)
        self._server.publish(data, tags)

    def publish_event_new_block(self, block, abci_responses=None) -> None:
        self._publish(EVENT_NEW_BLOCK, EventDataNewBlock(
            block=block,
            result_begin_block=getattr(abci_responses, "begin_block", None),
            result_end_block=getattr(abci_responses, "end_block", None),
        ))

    def publish_event_new_block_header(self, header) -> None:
        self._publish(EVENT_NEW_BLOCK_HEADER, EventDataNewBlockHeader(header=header))

    def publish_event_tx(self, height: int, index: int, tx: bytes, result) -> None:
        """The tx's hash and height and its DeliverTx tags become queryable
        (event_bus.go PublishEventTx)."""
        extra = {TX_HASH_KEY: hashlib.sha256(tx).digest().hex().upper(),
                 TX_HEIGHT_KEY: str(height)}
        for kv in getattr(result, "tags", None) or []:
            try:
                extra[kv.key.decode()] = kv.value.decode()
            except UnicodeDecodeError:
                pass
        self._publish(EVENT_TX, EventDataTx(height=height, index=index, tx=tx, result=result),
                      extra)

    def publish_event_vote(self, vote) -> None:
        self._publish(EVENT_VOTE, EventDataVote(vote=vote))

    def publish_event_round_state(self, event_type: str, height: int, round: int, step: str,
                                  rs=None) -> None:
        self._publish(event_type, EventDataRoundState(height=height, round=round, step=step,
                                                      round_state=rs))
