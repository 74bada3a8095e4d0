"""The key-value stores (ref libs/db/db.go, types.go; the port's copy of
the reference package's ``libs/db/kv.py``):

* ``MemDB``: keys kept sorted in memory (ref mem_db.go);
* ``SQLiteDB``: a durable single-file store on ``sqlite3``, the node's
  default backend (the role of goleveldb in the reference);
* ``PrefixDB``: a view of another store with every key under a prefix (ref
  prefix_db.go);
* ``new_db(name, backend, dir)``: the store a node's ``db_backend`` names,
  these or ``fsdb`` (``libs/db/fsdb.FSDB``, a file a key under
  ``<dir>/<name>.db``).

Iteration is over [start, end) by raw bytes with None for an open end,
forward or reverse; ``Batch`` buffers writes (ref libs/db/types.go). The
light client's trust store (``lite/provider.DBProvider``), the state store
(``state/store.py``), the block store (``blockchain/store.py``), the
evidence store (``evidence/pool.py``) and the tx index
(``state/txindex/kv.py``) stand on them. The ``remote`` backend is a
store served over gRPC (``libs/db/remote.py``; the reference package
builds it only by hand, its ``new_db`` has no such backend)."""

from __future__ import annotations

import bisect
import os
import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class DB:
    """The store interface the state layer names: ``get``, ``set``,
    ``delete`` and ``iterator`` are each backend's own."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def iterator(self, start: Optional[bytes] = None, end: Optional[bytes] = None,
                 reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)

    def delete_sync(self, key: bytes) -> None:
        self.delete(key)

    def close(self) -> None:
        pass

    def batch(self) -> "Batch":
        return Batch(self)

    def apply_batch(self, ops) -> None:
        for op, k, v in ops:
            if op == "set":
                self.set(k, v)
            else:
                self.delete(k)

    def stats(self) -> Dict[str, str]:
        return {}


class MemDB(DB):
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

    def delete(self, key: bytes) -> None:
        key = bytes(key)
        with self._mtx:
            if key in self._data:
                del self._data[key]
                self._keys.pop(bisect.bisect_left(self._keys, key))

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

    def stats(self) -> Dict[str, str]:
        with self._mtx:
            return {"keys": str(len(self._data))}


class Batch:
    """Buffered writes, applied under the store's lock by ``write``."""

    def __init__(self, db: DB):
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

    def write_sync(self) -> None:
        self.write()


class SQLiteDB(DB):
    """A durable store on ``sqlite3`` at ``dir/name.db``: one connection
    shared by every thread (``check_same_thread=False``) under one lock,
    WAL journal, ``synchronous=NORMAL`` (``FULL`` for ``set_sync``)."""

    def __init__(self, name: str, dir: str = "."):
        os.makedirs(dir, exist_ok=True)
        self.path = os.path.join(dir, name + ".db")
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)")
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.commit()
        self._mtx = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._mtx:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (bytes(key),)).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._mtx:
            self._conn.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                               (bytes(key), bytes(value)))
            self._conn.commit()

    def set_sync(self, key: bytes, value: bytes) -> None:
        with self._mtx:
            self._conn.execute("PRAGMA synchronous=FULL")
            try:
                self.set(key, value)
            finally:
                self._conn.execute("PRAGMA synchronous=NORMAL")

    def delete(self, key: bytes) -> None:
        with self._mtx:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (bytes(key),))
            self._conn.commit()

    def iterator(self, start=None, end=None, reverse=False):
        q, cond, args = "SELECT k, v FROM kv", [], []
        if start is not None:
            cond.append("k >= ?")
            args.append(bytes(start))
        if end is not None:
            cond.append("k < ?")
            args.append(bytes(end))
        if cond:
            q += " WHERE " + " AND ".join(cond)
        q += " ORDER BY k" + (" DESC" if reverse else "")
        with self._mtx:
            rows = self._conn.execute(q, args).fetchall()
        return iter([(bytes(k), bytes(v)) for k, v in rows])

    def apply_batch(self, ops) -> None:
        with self._mtx:
            for op, k, v in ops:
                if op == "set":
                    self._conn.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (k, v))
                else:
                    self._conn.execute("DELETE FROM kv WHERE k = ?", (k,))
            self._conn.commit()

    def close(self) -> None:
        with self._mtx:
            self._conn.close()

    def stats(self) -> Dict[str, str]:
        with self._mtx:
            n = self._conn.execute("SELECT COUNT(*) FROM kv").fetchone()[0]
        return {"keys": str(n), "path": self.path}


class PrefixDB(DB):
    """A view of ``db`` where every key is namespaced by ``prefix``."""

    def __init__(self, db: DB, prefix: bytes):
        self._db = db
        self._prefix = bytes(prefix)

    def _k(self, key: bytes) -> bytes:
        return self._prefix + bytes(key)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._db.get(self._k(key))

    def set(self, key: bytes, value: bytes) -> None:
        self._db.set(self._k(key), value)

    def set_sync(self, key: bytes, value: bytes) -> None:
        self._db.set_sync(self._k(key), value)

    def delete(self, key: bytes) -> None:
        self._db.delete(self._k(key))

    def iterator(self, start=None, end=None, reverse=False):
        p = self._prefix
        s = p + start if start is not None else p
        if end is not None:
            e = p + end
        else:
            # the end of the prefix's range: the prefix with its last byte
            # that can grow grown by one
            e, pe = None, bytearray(p)
            for i in reversed(range(len(pe))):
                if pe[i] != 0xFF:
                    pe[i] += 1
                    e = bytes(pe[: i + 1])
                    break
        return ((k[len(p):], v) for k, v in self._db.iterator(s, e, reverse))


def _fsdb_factory(name: str, dir: str):
    from tendermint_tpu_torch.libs.db.fsdb import FSDB

    return FSDB(os.path.join(dir, f"{name}.db"))


# the backend a "remote" store asks its server for (under the server's dir)
REMOTE_BACKEND = "sqlite"


def _remote_factory(name: str, addr: str):
    from tendermint_tpu_torch.libs.db.remote import RemoteDB

    return RemoteDB(addr, name, REMOTE_BACKEND)


_BACKENDS = {
    "memdb": lambda name, dir: MemDB(),
    "sqlite": SQLiteDB,
    "goleveldb": SQLiteDB,  # the reference's default's name, kept for configs
    "fsdb": _fsdb_factory,  # a file a key (libs/db/fsdb.go)
    "remote": _remote_factory,  # a store served over gRPC (libs/db/remote.py)
}


def new_db(name: str, backend: str = "sqlite", dir: str = ".") -> DB:
    """The store ``backend`` names, for ``name`` under ``dir``; for
    ``remote``, ``dir`` is the address of a ``libs/db/remote.RemoteDBServer``
    (``host:port``) and the store is its ``REMOTE_BACKEND`` store
    ``name`` (``grpcio`` is needed, else ``ImportError``)."""
    try:
        factory = _BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown db backend {backend!r}") from None
    return factory(name, dir)
