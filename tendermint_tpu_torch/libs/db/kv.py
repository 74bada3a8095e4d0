"""The in-memory key-value store (ref libs/db/mem_db.go; the port's copy of
``MemDB`` from the reference package's ``libs/db/kv.py``): keys kept sorted,
iteration over [start, end) by raw bytes with None for an open end, forward
or reverse, and write batches (``Batch``, ref libs/db/types.go). The light
client's trust store (``lite/provider.DBProvider``), the state store
(``state/store.py``), the block store (``blockchain/store.py``) and the
evidence store (``evidence/pool.py``) stand on it. The durable backends
come with the command-line tools (ROADMAP queue 1 item 12)."""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class MemDB:
    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []  # sorted
        self._mtx = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._mtx:
            return self._data.get(bytes(key))

    def set(self, key: bytes, value: bytes) -> None:
        key, value = bytes(key), bytes(value)
        with self._mtx:
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = value

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def delete(self, key: bytes) -> None:
        key = bytes(key)
        with self._mtx:
            if key in self._data:
                del self._data[key]
                self._keys.pop(bisect.bisect_left(self._keys, key))

    def batch(self) -> "Batch":
        return Batch(self)

    def apply_batch(self, ops) -> None:
        with self._mtx:
            for op, k, v in ops:
                if op == "set":
                    self.set(k, v)
                else:
                    self.delete(k)

    def iterator(self, start: Optional[bytes] = None, end: Optional[bytes] = None,
                 reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        """A snapshot of the pairs with start <= key < end, in key order
        (or reversed)."""
        with self._mtx:
            lo = bisect.bisect_left(self._keys, start) if start is not None else 0
            hi = bisect.bisect_left(self._keys, end) if end is not None else len(self._keys)
            items = [(k, self._data[k]) for k in self._keys[lo:hi]]
        return iter(reversed(items) if reverse else items)


DB = MemDB  # the store interface the state layer names (ref libs/db/db.go)


class Batch:
    """Buffered writes, applied under the store's lock by ``write``."""

    def __init__(self, db: MemDB):
        self._db = db
        self._ops: List[Tuple[str, bytes, Optional[bytes]]] = []

    def set(self, key: bytes, value: bytes) -> "Batch":
        self._ops.append(("set", bytes(key), bytes(value)))
        return self

    def delete(self, key: bytes) -> "Batch":
        self._ops.append(("del", bytes(key), None))
        return self

    def write(self) -> None:
        self._db.apply_batch(self._ops)
        self._ops.clear()
