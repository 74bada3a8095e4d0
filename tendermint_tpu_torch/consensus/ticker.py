"""TimeoutTicker: one scheduler delivering timeoutInfos in order (ref
consensus/ticker.go), the port's copy of the reference package's
``consensus/ticker.py``.

Scheduling a new timeout overrides any pending one for an earlier or equal
H/R/S (the reference stops the old timer on every ScheduleTimeout).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from tendermint_tpu_torch.consensus.messages import TimeoutInfo
from tendermint_tpu_torch.libs.service import BaseService


class TimeoutTicker(BaseService):
    def __init__(self):
        super().__init__("consensus.TimeoutTicker")
        self._tick_q: "queue.Queue[TimeoutInfo]" = queue.Queue()
        self.tock_q: "queue.Queue[TimeoutInfo]" = queue.Queue()
        self._timer: Optional[threading.Timer] = None
        self._mtx = threading.Lock()

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        self._tick_q.put(ti)

    def chan(self) -> "queue.Queue[TimeoutInfo]":
        return self.tock_q

    def on_start(self) -> None:
        threading.Thread(target=self._timeout_routine, daemon=True).start()

    def on_stop(self) -> None:
        with self._mtx:
            if self._timer is not None:
                self._timer.cancel()

    def _fire(self, ti: TimeoutInfo) -> None:
        self.tock_q.put(ti)

    def _timeout_routine(self) -> None:
        """ticker.go:94 — newer ticks for >= (H,R,S) replace the pending timer."""
        current: Optional[TimeoutInfo] = None
        while not self.quit_event.is_set():
            try:
                ti = self._tick_q.get(timeout=0.1)
            except queue.Empty:
                continue
            # ignore ticks for old height/round/step
            if current is not None:
                if (ti.height, ti.round, ti.step) < (
                    current.height, current.round, current.step,
                ):
                    continue
            with self._mtx:
                if self._timer is not None:
                    self._timer.cancel()
                current = ti
                self._timer = threading.Timer(max(0.0, ti.duration), self._fire, (ti,))
                self._timer.daemon = True
                self._timer.start()


class MockTicker:
    """Deterministic test ticker (common_test.go:635): fires only when the
    test calls fire(), or immediately for zero-duration NewHeight ticks."""

    def __init__(self, fire_instantly: bool = True):
        self.tock_q: "queue.Queue[TimeoutInfo]" = queue.Queue()
        self.scheduled: list = []
        self.fire_instantly = fire_instantly

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        self.scheduled.append(ti)
        if self.fire_instantly and ti.duration <= 0:
            self.tock_q.put(ti)

    def fire_next(self) -> Optional[TimeoutInfo]:
        if not self.scheduled:
            return None
        ti = self.scheduled.pop(0)
        self.tock_q.put(ti)
        return ti

    def chan(self) -> "queue.Queue[TimeoutInfo]":
        return self.tock_q
