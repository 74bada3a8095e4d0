"""A synchronous in-process event switch (ref libs/events/events.go), the
port's copy of the reference package's ``libs/events.py``.

The consensus state fires its step, vote and valid-block events through it
to the listeners that registered for them, on the firing thread: the path
that bypasses the queued EventBus (consensus/state.go:122).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List


Listener = Callable[[Any], None]


class EventSwitch:
    def __init__(self):
        self._mtx = threading.RLock()
        # event name -> listener id -> callback
        self._listeners: Dict[str, Dict[str, Listener]] = {}

    def add_listener_for_event(self, listener_id: str, event: str, cb: Listener) -> None:
        with self._mtx:
            self._listeners.setdefault(event, {})[listener_id] = cb

    def remove_listener_for_event(self, event: str, listener_id: str) -> None:
        with self._mtx:
            self._listeners.get(event, {}).pop(listener_id, None)

    def remove_listener(self, listener_id: str) -> None:
        with self._mtx:
            for cbs in self._listeners.values():
                cbs.pop(listener_id, None)

    def fire_event(self, event: str, data: Any = None) -> None:
        with self._mtx:
            cbs = list(self._listeners.get(event, {}).values())
        for cb in cbs:
            cb(data)
