"""Shared wait-iteration walker for CList-backed gossip (the reference
duplicates this loop in mempool/reactor.go:118-166 and
evidence/reactor.go:109-160; here both reactors share one
implementation), the port's copy of the reference package's
``libs/gossip.py``.

Where the port differs: a walker waits on an empty list through the list's
blocking ``CList.front_wait`` instead of polling it every 10 ms: a push
wakes it at once, and an idle walker wakes every ``IDLE_WAIT`` to check
``alive``. The reference's walkers poll, which is 100 wake-ups a second a
peer and a reactor; a node of a net in one interpreter has two such walkers
a peer, and every wake-up takes the interpreter lock from the threads doing
real work.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

RETRY_SLEEP = 0.1
IDLE_WAIT = 0.1


def walk_and_send(
    alive: Callable[[], bool],
    front_wait: Callable[[float], Optional[object]],
    send: Callable[[object], bool],
    hold_back: Optional[Callable[[object], bool]] = None,
) -> None:
    """Walk a CList forever, delivering each element exactly once per walker:

    * ``alive()`` — loop guard (reactor + peer running);
    * ``front_wait(timeout)`` — the list head, blocking up to ``timeout``
      while the list is empty;
    * ``send(value)`` — deliver; False = retry later;
    * ``hold_back(value)`` — True = not yet (e.g. peer height lags).

    Advancing blocks on next_wait (new elements wake the walker); a removed
    tail anchor restarts from the front — consumers must tolerate the
    occasional duplicate (both pools dedup)."""
    el = None
    while alive():
        if el is None:
            el = front_wait(IDLE_WAIT)
            continue
        value = el.value
        if hold_back is not None and hold_back(value):
            time.sleep(RETRY_SLEEP)
            continue
        if not send(value):
            time.sleep(RETRY_SLEEP)
            continue
        # sent exactly once — block until a successor exists
        while alive():
            nxt = el.next_wait(timeout=0.1)
            if nxt is not None:
                el = nxt
                break
            if el.removed:
                el = None
                break
