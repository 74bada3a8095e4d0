"""Per-node wall-clock injection; the port's copy of the reference package's
``sim/clock.py``.

Every timestamp a node emits (proposal/vote times, flight-recorder stamps,
watchdog report wall time) flows through a pluggable ``now_ns`` callable
(`ConsensusState.now_ns`, `FlightRecorder.now_ns`, `LivenessWatchdog.now_ns`).
A ``SimClock`` bound there gives the harness two capabilities:

* **skew** — shift one node's wall clock by a known offset and verify the
  observability stack (trace_merge's commit-anchor skew recovery) measures
  it back out;
* **freeze** — pin the clock to one constant, which (together with
  ``blocktime_iota``) makes vote/block times pure functions of the chain —
  the determinism scenarios compare commit hashes across runs.
"""

from __future__ import annotations

import time


class SimClock:
    """Wall-clock source for one simulated node."""

    def __init__(self, skew_ns: int = 0, frozen_at_ns: int = 0):
        self.skew_ns = int(skew_ns)
        self.frozen_at_ns = int(frozen_at_ns)  # 0 = not frozen

    def now_ns(self) -> int:
        if self.frozen_at_ns:
            return self.frozen_at_ns + self.skew_ns
        return time.time_ns() + self.skew_ns

    def set_skew(self, skew_ns: int) -> None:
        self.skew_ns = int(skew_ns)

    def freeze(self, at_ns: int) -> None:
        self.frozen_at_ns = int(at_ns)

    def __call__(self) -> int:  # usable directly as a now_ns callable
        return self.now_ns()
