"""Append-only file groups with size-based rotation, the consensus WAL's
files (ref libs/autofile/group.go), the port's copy of the reference
package's ``libs/autofile.py``.

A Group owns <head> plus rotated chunks <head>.000, <head>.001, ...
Write() appends to head; when head exceeds head_size_limit it rotates; when
total exceeds total_size_limit the oldest chunks are pruned.  GroupReader
scans from any chunk index forward — consensus WAL replay reads through it.
"""

from __future__ import annotations

import os
import re
import threading
from typing import BinaryIO, List, Optional, Tuple

DEFAULT_HEAD_SIZE_LIMIT = 10 * 1024 * 1024  # 10MB (group.go:25)
DEFAULT_TOTAL_SIZE_LIMIT = 1024 * 1024 * 1024  # 1GB (group.go:26)


class Group:
    def __init__(
        self,
        head_path: str,
        head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT,
        total_size_limit: int = DEFAULT_TOTAL_SIZE_LIMIT,
    ):
        self.head_path = head_path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self._mtx = threading.RLock()
        os.makedirs(os.path.dirname(os.path.abspath(head_path)), exist_ok=True)
        self._head: BinaryIO = open(head_path, "ab")
        self._min_index, self._max_index = self._scan_indices()

    def _scan_indices(self) -> Tuple[int, int]:
        """Chunk files are '<head>.NNN'; returns (min, max) where max is the
        index the head will take on next rotation."""
        d = os.path.dirname(os.path.abspath(self.head_path))
        base = os.path.basename(self.head_path)
        pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
        idxs = []
        for fn in os.listdir(d):
            m = pat.match(fn)
            if m:
                idxs.append(int(m.group(1)))
        if not idxs:
            return 0, 0
        return min(idxs), max(idxs) + 1

    @property
    def min_index(self) -> int:
        return self._min_index

    @property
    def max_index(self) -> int:
        """Index of the head (rotated chunks are min_index..max_index-1)."""
        return self._max_index

    def chunk_path(self, index: int) -> str:
        if index == self._max_index:
            return self.head_path
        return f"{self.head_path}.{index:03d}"

    # writing --------------------------------------------------------------
    def write(self, data: bytes) -> None:
        with self._mtx:
            self._head.write(data)

    def flush(self) -> None:
        with self._mtx:
            self._head.flush()

    def sync(self) -> None:
        with self._mtx:
            self._head.flush()
            os.fsync(self._head.fileno())

    def head_size(self) -> int:
        with self._mtx:
            self._head.flush()
            return os.path.getsize(self.head_path)

    def total_size(self) -> int:
        with self._mtx:
            total = self.head_size()
            for i in range(self._min_index, self._max_index):
                p = self.chunk_path(i)
                if os.path.exists(p):
                    total += os.path.getsize(p)
            return total

    def maybe_rotate(self) -> bool:
        """Rotate head into a numbered chunk if over the size limit; prune
        oldest chunks while over the total limit."""
        with self._mtx:
            rotated = False
            if self.head_size() >= self.head_size_limit:
                self.rotate()
                rotated = True
            while (
                self.total_size() > self.total_size_limit
                and self._min_index < self._max_index
            ):
                p = self.chunk_path(self._min_index)
                if os.path.exists(p):
                    os.remove(p)
                self._min_index += 1
            return rotated

    def rotate(self) -> None:
        with self._mtx:
            self._head.flush()
            self._head.close()
            os.rename(self.head_path, f"{self.head_path}.{self._max_index:03d}")
            self._max_index += 1
            self._head = open(self.head_path, "ab")

    def close(self) -> None:
        with self._mtx:
            self._head.flush()
            self._head.close()

    # reading --------------------------------------------------------------
    def new_reader(self, start_index: Optional[int] = None) -> "GroupReader":
        return GroupReader(self, start_index if start_index is not None else self._min_index)


class GroupReader:
    """Sequential reader across chunk boundaries (ref group.go GroupReader)."""

    def __init__(self, group: Group, start_index: int):
        self._group = group
        self._index = start_index
        self._file: Optional[BinaryIO] = None
        self._open_current()

    @property
    def cur_index(self) -> int:
        return self._index

    def _open_current(self) -> bool:
        if self._file:
            self._file.close()
            self._file = None
        while self._index <= self._group.max_index:
            p = self._group.chunk_path(self._index)
            if os.path.exists(p):
                self._group.flush()
                self._file = open(p, "rb")
                return True
            self._index += 1
        return False

    def read(self, n: int = -1) -> bytes:
        """Read up to n bytes, advancing across chunks; b'' at true EOF."""
        out = b""
        while n < 0 or len(out) < n:
            if self._file is None:
                break
            chunk = self._file.read(n - len(out) if n >= 0 else -1)
            if chunk:
                out += chunk
            else:
                self._index += 1
                if not self._open_current():
                    break
        return out

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
