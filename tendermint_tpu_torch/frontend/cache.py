"""Verified-header cache: a height-keyed LRU with validator-set-hash
pinning, and the single-flight primitive the frontend dedups concurrent
misses with (the port's copy of the reference package's
``frontend/cache.py``).

Entries are certified FullCommits: their commit verified by their own
validator set through the frontend's batched path. That fact does not
depend on the client, so every client bisecting the same chain shares it.
The pin is the validators hash the entry was certified under: a lookup that
expects another hash is a miss, so a provider that equivocates between
fetches cannot turn the cache into a confusion oracle.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional


class HeaderCache:
    """Height-keyed LRU of (FullCommit, valset-hash pin) entries."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._mtx = threading.Lock()
        self._entries: "OrderedDict[int, tuple]" = OrderedDict()

    def __len__(self) -> int:
        with self._mtx:
            return len(self._entries)

    def get(self, height: int, pin: Optional[bytes] = None):
        """The cached FullCommit at ``height``, or None. With ``pin``, an
        entry certified under another validators hash is a miss."""
        with self._mtx:
            ent = self._entries.get(height)
            if ent is None:
                return None
            fc, ent_pin = ent
            if pin is not None and pin != ent_pin:
                return None
            self._entries.move_to_end(height)
            return fc

    def put(self, height: int, fc, pin: bytes) -> None:
        with self._mtx:
            self._entries[height] = (fc, pin)
            self._entries.move_to_end(height)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)


class SingleFlight:
    """Per-key in-flight dedup: the first caller for a key becomes the
    leader and runs the work; concurrent callers for the same key wait
    until the leader is done, then share its result or re-raise its
    exception (``DeviceDispatchError`` on the card included). The key
    retires when the work ends, so a later request runs afresh: a failure
    is never cached."""

    class _Flight:
        __slots__ = ("ev", "result", "err")

        def __init__(self):
            self.ev = threading.Event()
            self.result = None
            self.err: Optional[BaseException] = None

    def __init__(self):
        self._mtx = threading.Lock()
        self._flights: dict = {}

    def do(self, key, fn: Callable, on_wait: Optional[Callable] = None):
        """Run ``fn`` once per concurrent burst of ``key``; ``on_wait``
        fires on the waiters' path (the frontend's cache "wait" count)."""
        with self._mtx:
            flight = self._flights.get(key)
            leader = flight is None
            if leader:
                flight = self._flights[key] = self._Flight()
        if not leader:
            if on_wait is not None:
                on_wait()
            flight.ev.wait()
            if flight.err is not None:
                raise flight.err
            return flight.result
        try:
            flight.result = fn()
            return flight.result
        except BaseException as e:
            flight.err = e
            raise
        finally:
            with self._mtx:
                self._flights.pop(key, None)
            flight.ev.set()
