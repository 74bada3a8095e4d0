"""SnapshotStore: persisted snapshots and their chunks (the producer side),
the port's copy of the reference package's ``statesync/store.py``.

Schema (all under one DB):
  ss:meta:<format>:<be-height>      -> encoded Snapshot metadata
  ss:chunk:<format>:<be-height>:<i> -> chunk i bytes

Heights are big-endian so the iterator orders them numerically; ``list``
offers the tallest snapshots first.
"""

from __future__ import annotations

import struct
import threading
from typing import List, Optional, Sequence

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.encoding.codec import Reader, Writer

_META_PREFIX = b"ss:meta:"
_CHUNK_PREFIX = b"ss:chunk:"


def _meta_key(format: int, height: int) -> bytes:
    return _META_PREFIX + b"%d:" % format + struct.pack(">q", height)


def _chunk_key(format: int, height: int, index: int) -> bytes:
    return _CHUNK_PREFIX + b"%d:" % format + struct.pack(">q", height) + b":%d" % index


def encode_snapshot(w: Writer, s: abci.Snapshot) -> None:
    w.svarint(s.height)
    w.uvarint(s.format)
    w.uvarint(s.chunks)
    w.bytes(s.hash)
    w.bytes(s.metadata)


def decode_snapshot(r: Reader) -> abci.Snapshot:
    return abci.Snapshot(height=r.svarint(), format=r.uvarint(), chunks=r.uvarint(),
                         hash=r.bytes(), metadata=r.bytes())


class SnapshotStore:
    def __init__(self, db):
        self._db = db
        self._mtx = threading.Lock()

    def save(self, snapshot: abci.Snapshot, chunks: Sequence[bytes]) -> None:
        if len(chunks) != snapshot.chunks:
            raise ValueError(f"snapshot advertises {snapshot.chunks} chunks, got {len(chunks)}")
        w = Writer()
        encode_snapshot(w, snapshot)
        with self._mtx:
            batch = self._db.batch()
            for i, c in enumerate(chunks):
                batch.set(_chunk_key(snapshot.format, snapshot.height, i), c)
            batch.set(_meta_key(snapshot.format, snapshot.height), w.build())
            batch.write()

    def list(self, limit: int = 10) -> List[abci.Snapshot]:
        """Newest-first snapshot metadata (the chunks stay in the DB)."""
        out = []
        for _, v in self._db.iterator(_META_PREFIX, _META_PREFIX + b"\xff", reverse=True):
            out.append(decode_snapshot(Reader(v)))
            if len(out) >= limit:
                break
        # reverse iteration orders by (format, height); the tallest height
        # first is the useful order for offers
        out.sort(key=lambda s: (s.height, s.format), reverse=True)
        return out

    def load_chunk(self, height: int, format: int, index: int) -> Optional[bytes]:
        return self._db.get(_chunk_key(format, height, index))

    def get(self, height: int, format: int) -> Optional[abci.Snapshot]:
        raw = self._db.get(_meta_key(format, height))
        return decode_snapshot(Reader(raw)) if raw else None

    def prune(self, keep_recent: int) -> int:
        """Drop all but the ``keep_recent`` tallest snapshots; returns the
        number of snapshots deleted."""
        victims = self.list(limit=1 << 30)[keep_recent:]
        with self._mtx:
            batch = self._db.batch()
            for s in victims:
                batch.delete(_meta_key(s.format, s.height))
                for i in range(s.chunks):
                    batch.delete(_chunk_key(s.format, s.height, i))
            batch.write()
        return len(victims)
