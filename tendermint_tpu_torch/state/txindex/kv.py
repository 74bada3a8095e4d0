"""Tx indexer (ref: state/txindex/; the port's copy of the reference
package's ``state/txindex/kv.py``): ``TxIndexerService`` subscribes to
EventTx on the node's ``EventBus`` and indexes each result by its hash and
its tags; ``search`` takes the pubsub query language. The records' bytes
are the reference's, so an index written by either package reads in the
other.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.libs.db.kv import DB
from tendermint_tpu_torch.libs.pubsub import Query
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.types.events import EVENT_TX, query_for_event


@dataclass
class TxResult:
    height: int
    index: int
    tx: bytes
    result: Optional[abci.ResponseDeliverTx]

    def hash(self) -> bytes:
        return hashlib.sha256(self.tx).digest()

    def marshal(self) -> bytes:
        w = Writer()
        w.svarint(self.height).svarint(self.index).bytes(self.tx)
        w.bytes(abci.msg_to_json(self.result) if self.result else b"")
        return w.build()

    @classmethod
    def unmarshal(cls, data: bytes) -> "TxResult":
        r = Reader(data)
        height = r.svarint()
        index = r.svarint()
        tx = r.bytes()
        raw = r.bytes()
        return cls(height, index, tx, abci.msg_from_json(raw) if raw else None)


class NullTxIndexer:
    def index(self, tx_result: TxResult) -> None: ...

    def get(self, tx_hash: bytes) -> Optional[TxResult]:
        return None

    def search(self, q: str) -> List[TxResult]:
        return []


class KVTxIndexer:
    """kv backend (txindex/kv/kv.go): primary record by hash + tag rows
    'tag/value/height/index' -> hash."""

    def __init__(self, db: DB):
        self._db = db

    def index(self, tx_result: TxResult) -> None:
        h = tx_result.hash()
        batch = self._db.batch()
        batch.set(h, tx_result.marshal())
        tags = getattr(tx_result.result, "tags", None) or []
        for kv in tags:
            key = b"%s/%s/%d/%d" % (
                kv.key, kv.value, tx_result.height, tx_result.index
            )
            batch.set(key, h)
        # standard height tag
        batch.set(
            b"tx.height/%d/%d/%d" % (tx_result.height, tx_result.height, tx_result.index),
            h,
        )
        batch.write()

    def get(self, tx_hash: bytes) -> Optional[TxResult]:
        raw = self._db.get(tx_hash)
        return TxResult.unmarshal(raw) if raw else None

    def search(self, q: str) -> List[TxResult]:
        """Tag-condition search; supports '=' conditions + tx.height ranges."""
        query = Query(q)
        hashes: Optional[set] = None
        for cond in query.conditions:
            matches = set()
            if cond.tag == "tx.hash" and cond.op == "=":
                h = bytes.fromhex(str(cond.value))
                return [r for r in [self.get(h)] if r is not None]
            prefix = cond.tag.encode() + b"/"
            for k, v in self._db.iterator(prefix, prefix + b"\xff"):
                parts = k.split(b"/")
                if len(parts) < 4:
                    continue
                value = b"/".join(parts[1:-2]).decode(errors="replace")
                if cond.matches({cond.tag: value}):
                    matches.add(bytes(v))
            hashes = matches if hashes is None else (hashes & matches)
        out = []
        for h in hashes or set():
            r = self.get(h)
            if r is not None:
                out.append(r)
        out.sort(key=lambda r: (r.height, r.index))
        return out


class TxIndexerService(BaseService):
    """indexer_service.go:17 — subscribes to EventTx on the bus."""

    def __init__(self, indexer, event_bus):
        super().__init__("TxIndexerService")
        self.indexer = indexer
        self.event_bus = event_bus

    def on_start(self) -> None:
        self._sub = self.event_bus.subscribe(
            "tx_index", query_for_event(EVENT_TX), maxsize=1024
        )
        self._thread = threading.Thread(target=self._run, name="tx-indexer", daemon=True)
        self._thread.start()

    def on_stop(self) -> None:
        try:
            self.event_bus.unsubscribe_all("tx_index")
        except Exception:
            pass
        # the store may close after the node stops: no write may follow
        self._thread.join(5.0)

    def _run(self) -> None:
        import queue as _q

        while not self.quit_event.is_set():
            try:
                msg = self._sub.get(timeout=0.1)
            except _q.Empty:
                continue
            d = msg.data
            self.indexer.index(
                TxResult(height=d.height, index=d.index, tx=d.tx, result=d.result)
            )
