"""FSDB, a store of one file a key (ref libs/db/fsdb.go; the port's copy of
the reference package's ``libs/db/fsdb.py``, whose directories it reads and
writes).

A key's file is named by the percent-escaped key (fsdb.go's escapeKey, as
url.QueryEscape). Human-inspectable; for debugging and tiny stores, not a
hot path (the reference carries the same warning).
"""

from __future__ import annotations

import os
import threading
import urllib.parse
from typing import Dict, Iterator, Optional, Tuple

from tendermint_tpu_torch.libs.db.kv import DB


class FSDB(DB):
    def __init__(self, dir: str):
        self._dir = dir
        self._mtx = threading.Lock()
        os.makedirs(dir, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def _path(self, key: bytes) -> str:
        name = urllib.parse.quote_from_bytes(bytes(key), safe="")
        # quote() leaves '.' unescaped, so the keys b"." and b".." would name
        # the directory or its parent: an all-dots name is escaped (unquote
        # maps %2E back to '.')
        if name and set(name) == {"."}:
            name = name.replace(".", "%2E")
        return os.path.join(self._dir, name)

    @staticmethod
    def _unescape(name: str) -> bytes:
        return urllib.parse.unquote_to_bytes(name)

    # -- DB interface ------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        with self._mtx:
            try:
                with open(self._path(key), "rb") as f:
                    return f.read()
            except FileNotFoundError:
                return None

    def has(self, key: bytes) -> bool:
        with self._mtx:
            return os.path.exists(self._path(key))

    def set(self, key: bytes, value: bytes) -> None:
        self._set(key, value, sync=False)

    def set_sync(self, key: bytes, value: bytes) -> None:
        self._set(key, value, sync=True)

    # a temporary file cannot be taken for a key's: an escaped key's name
    # holds only %XX escapes, so "%!" (no valid escape) names no key (a
    # ".tmp" suffix would: key b"foo"'s temporary file is key b"foo.tmp")
    _TMP_PREFIX = "%!tmp-"

    def _set(self, key: bytes, value: bytes, sync: bool) -> None:
        path = self._path(key)
        tmp = os.path.join(
            self._dir, f"{self._TMP_PREFIX}{os.getpid()}-{threading.get_ident()}"
        )
        with self._mtx:
            with open(tmp, "wb") as f:
                f.write(bytes(value))
                if sync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)

    def delete(self, key: bytes) -> None:
        with self._mtx:
            try:
                os.unlink(self._path(key))
            except FileNotFoundError:
                pass

    def delete_sync(self, key: bytes) -> None:
        self.delete(key)

    def iterator(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None,
        reverse: bool = False,
    ) -> Iterator[Tuple[bytes, bytes]]:
        with self._mtx:
            names = [
                n for n in os.listdir(self._dir)
                if not n.startswith(self._TMP_PREFIX)
            ]
        keys = sorted(self._unescape(n) for n in names)
        if reverse:
            keys = list(reversed(keys))
        out = []
        for k in keys:
            if start is not None and k < start:
                continue
            if end is not None and k >= end:
                continue
            v = self.get(k)
            if v is not None:
                out.append((k, v))
        return iter(out)

    def apply_batch(self, ops) -> None:
        for op, k, v in ops:
            if op == "set":
                self.set(k, v)
            else:
                self.delete(k)

    def close(self) -> None:
        pass

    def stats(self) -> Dict[str, str]:
        with self._mtx:
            n = len(
                [x for x in os.listdir(self._dir)
                 if not x.startswith(self._TMP_PREFIX)]
            )
        return {"keys": str(n), "dir": self._dir}
