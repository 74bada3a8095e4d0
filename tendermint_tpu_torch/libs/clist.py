"""Concurrent linked list with wait-for-next semantics (ref
libs/clist/clist.go), the port's copy of the reference package's
``libs/clist.py``: the mempool's list of txs and its recheck cursor.

An iterator can block until a next element is appended. Elements can be
detached from the middle on removal while existing iterators keep a grip on
their node (a removed element keeps its next pointer).
"""

from __future__ import annotations

import threading
from typing import Any, Iterator, Optional


class CElement:
    def __init__(self, value: Any):
        self.value = value
        self._prev: Optional[CElement] = None
        self._next: Optional[CElement] = None
        self._removed = False
        self._mtx = threading.Lock()
        self._next_wait = threading.Condition(self._mtx)

    @property
    def removed(self) -> bool:
        with self._mtx:
            return self._removed

    def next(self) -> Optional["CElement"]:
        with self._mtx:
            return self._next

    def next_wait(self, timeout: Optional[float] = None) -> Optional["CElement"]:
        """Block until a next element exists or this one is removed."""
        with self._mtx:
            if self._next is None and not self._removed:
                self._next_wait.wait(timeout)
            return self._next

    def _set_next(self, nxt: Optional["CElement"]) -> None:
        with self._mtx:
            self._next = nxt
            if nxt is not None:
                self._next_wait.notify_all()

    def _mark_removed(self) -> None:
        with self._mtx:
            self._removed = True
            self._next_wait.notify_all()


class CList:
    def __init__(self):
        self._mtx = threading.RLock()
        self._head: Optional[CElement] = None
        self._tail: Optional[CElement] = None
        self._len = 0
        self._wait = threading.Condition(self._mtx)

    def __len__(self) -> int:
        with self._mtx:
            return self._len

    def front(self) -> Optional[CElement]:
        with self._mtx:
            return self._head

    def front_wait(self, timeout: Optional[float] = None) -> Optional[CElement]:
        with self._mtx:
            if self._head is None:
                self._wait.wait(timeout)
            return self._head

    def back(self) -> Optional[CElement]:
        with self._mtx:
            return self._tail

    def push_back(self, value: Any) -> CElement:
        el = CElement(value)
        with self._mtx:
            if self._tail is None:
                self._head = self._tail = el
            else:
                el._prev = self._tail
                self._tail._set_next(el)
                self._tail = el
            self._len += 1
            self._wait.notify_all()
        return el

    def remove(self, el: CElement) -> Any:
        with self._mtx:
            prev, nxt = el._prev, el._next
            if prev is not None:
                prev._set_next(nxt)
            else:
                self._head = nxt
            if nxt is not None:
                nxt._prev = prev
            else:
                self._tail = prev
            self._len -= 1
            el._mark_removed()
        return el.value

    def __iter__(self) -> Iterator[Any]:
        el = self.front()
        while el is not None:
            if not el.removed:
                yield el.value
            el = el.next()
