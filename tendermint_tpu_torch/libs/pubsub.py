"""Topic pub/sub with a query language (ref libs/pubsub/pubsub.go and
query/), the port's copy of the reference package's ``libs/pubsub.py``.

Queries are the reference's subscription language:
    tm.event = 'NewBlock' AND tx.height > 5 AND account.name CONTAINS 'igor'
Operators: = < <= > >= != CONTAINS, conjunctions with AND. Values: 'strings'
or numbers. (The reference compiles a PEG, query/query.peg.go; this is a
small recursive-descent parser over the same grammar.)

The server delivers published (message, tags) pairs to every subscription
whose query matches the tags, each subscriber getting its own queue. A
full queue drops the message for that subscriber, counted and logged on the
first drop.
"""

from __future__ import annotations

import logging
import queue
import re
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# Query language
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<op><=|>=|!=|=|<|>)|(?P<and>\bAND\b)|(?P<contains>\bCONTAINS\b)"
    r"|(?P<str>'[^']*')|(?P<num>-?\d+(?:\.\d+)?)|(?P<tag>[A-Za-z_][\w.]*))"
)


@dataclass(frozen=True)
class Condition:
    tag: str
    op: str  # '=', '<', '<=', '>', '>=', '!=', 'CONTAINS'
    value: Union[str, float]

    def matches(self, tags: Dict[str, str]) -> bool:
        if self.tag not in tags:
            return False
        actual = tags[self.tag]
        if self.op == "CONTAINS":
            return str(self.value) in actual
        if isinstance(self.value, float):
            try:
                a = float(actual)
            except ValueError:
                return False
            return {
                "=": a == self.value,
                "!=": a != self.value,
                "<": a < self.value,
                "<=": a <= self.value,
                ">": a > self.value,
                ">=": a >= self.value,
            }[self.op]
        if self.op == "=":
            return actual == self.value
        if self.op == "!=":
            return actual != self.value
        # ordered string comparison for non-numeric values
        return {
            "<": actual < self.value,
            "<=": actual <= self.value,
            ">": actual > self.value,
            ">=": actual >= self.value,
        }[self.op]


class QueryError(ValueError):
    pass


class Query:
    """Conjunction of conditions (the reference grammar has no OR)."""

    def __init__(self, s: str):
        self._s = s.strip()
        self.conditions = self._parse(self._s)

    @staticmethod
    def _tokens(s: str) -> List[Tuple[str, str]]:
        out, pos = [], 0
        while pos < len(s):
            m = _TOKEN_RE.match(s, pos)
            if not m or m.end() == pos:
                if s[pos:].strip():
                    raise QueryError(f"bad query near {s[pos:]!r}")
                break
            pos = m.end()
            for kind in ("op", "and", "contains", "str", "num", "tag"):
                if m.group(kind):
                    out.append((kind, m.group(kind)))
                    break
        return out

    @classmethod
    def _parse(cls, s: str) -> List[Condition]:
        if not s:
            raise QueryError("empty query")
        toks = cls._tokens(s)
        conds = []
        i = 0
        while i < len(toks):
            if toks[i][0] != "tag":
                raise QueryError(f"expected tag, got {toks[i]!r}")
            tag = toks[i][1]
            if i + 2 >= len(toks):
                raise QueryError("truncated condition")
            kind, opval = toks[i + 1]
            if kind == "op":
                op = opval
            elif kind == "contains":
                op = "CONTAINS"
            else:
                raise QueryError(f"expected operator, got {opval!r}")
            vkind, vraw = toks[i + 2]
            if vkind == "str":
                value: Union[str, float] = vraw[1:-1]
            elif vkind == "num":
                value = float(vraw)
            else:
                raise QueryError(f"expected value, got {vraw!r}")
            conds.append(Condition(tag, op, value))
            i += 3
            if i < len(toks):
                if toks[i][0] != "and":
                    raise QueryError(f"expected AND, got {toks[i]!r}")
                i += 1
        return conds

    def matches(self, tags: Dict[str, str]) -> bool:
        return all(c.matches(tags) for c in self.conditions)

    def __str__(self) -> str:
        return self._s

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and str(self) == str(other)

    def __hash__(self) -> int:
        return hash(self._s)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class DuplicateSubscriptionError(Exception):
    pass


class SubscriptionNotFoundError(Exception):
    pass


@dataclass
class Message:
    data: Any
    tags: Dict[str, str]


class Subscription:
    def __init__(self, maxsize: int = 0):
        self.queue: "queue.Queue[Message]" = queue.Queue(maxsize)
        self.cancelled = threading.Event()

    def get(self, timeout: Optional[float] = None) -> Message:
        return self.queue.get(timeout=timeout)


class Server:
    """clientID × query → Subscription (ref pubsub.go Server)."""

    def __init__(self, buffer: int = 0,
                 on_drop: Optional[Callable[[str], None]] = None):
        self._mtx = threading.RLock()
        self._subs: Dict[str, Dict[Query, Subscription]] = {}
        self._buffer = buffer
        # slow subscribers: a drop count per client, a warning on each
        # client's first drop and an optional callback per drop
        self._dropped: Dict[str, int] = {}
        self._on_drop = on_drop
        self._logger = logging.getLogger("pubsub")

    def set_on_drop(self, fn: Optional[Callable[[str], None]]) -> None:
        with self._mtx:
            self._on_drop = fn

    def dropped_events(self, client_id: Optional[str] = None):
        """Total drops for one client, or a {client_id: count} copy."""
        with self._mtx:
            if client_id is not None:
                return self._dropped.get(client_id, 0)
            return dict(self._dropped)

    def _note_drop(self, client_id: str) -> None:
        with self._mtx:
            n = self._dropped.get(client_id, 0) + 1
            self._dropped[client_id] = n
            on_drop = self._on_drop
        if n == 1:
            self._logger.warning(
                "dropping events for slow subscriber %r (buffer full); "
                "further drops counted silently", client_id
            )
        if on_drop is not None:
            try:
                on_drop(client_id)
            except Exception:
                self._logger.exception("pubsub on_drop callback failed")

    def subscribe(self, client_id: str, q: Union[str, Query], maxsize: int = 0) -> Subscription:
        q = Query(q) if isinstance(q, str) else q
        with self._mtx:
            by_client = self._subs.setdefault(client_id, {})
            if q in by_client:
                raise DuplicateSubscriptionError(f"{client_id}/{q}")
            sub = Subscription(maxsize or self._buffer)
            by_client[q] = sub
            return sub

    def unsubscribe(self, client_id: str, q: Union[str, Query]) -> None:
        q = Query(q) if isinstance(q, str) else q
        with self._mtx:
            by_client = self._subs.get(client_id, {})
            if q not in by_client:
                raise SubscriptionNotFoundError(f"{client_id}/{q}")
            by_client.pop(q).cancelled.set()
            if not by_client:
                self._subs.pop(client_id, None)

    def unsubscribe_all(self, client_id: str) -> None:
        with self._mtx:
            by_client = self._subs.pop(client_id, None)
            if by_client is None:
                raise SubscriptionNotFoundError(client_id)
            for sub in by_client.values():
                sub.cancelled.set()

    def publish(self, data: Any, tags: Optional[Dict[str, str]] = None) -> None:
        tags = tags or {}
        with self._mtx:
            targets = [
                (client_id, sub)
                for client_id, by_client in self._subs.items()
                for q, sub in by_client.items()
                if q.matches(tags)
            ]
        msg = Message(data=data, tags=tags)
        for client_id, sub in targets:
            try:
                sub.queue.put_nowait(msg)
            except queue.Full:
                # a slow subscriber: drop (the reference blocks), counted
                self._note_drop(client_id)

    def num_clients(self) -> int:
        with self._mtx:
            return len(self._subs)
