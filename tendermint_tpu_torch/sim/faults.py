"""FaultyDevice — a chaos shim for the batch-verification device path.

Wraps a real BatchVerifier (usually ``HostBatchVerifier``) and injects
deterministic, seeded faults into every ``verify_*`` call:

* **fail** — raise ``InjectedDeviceError`` (models a crashed dispatch);
* **hang** — sleep ``hang_s`` before answering (models a wedged device;
  pair with a small ``dispatch_deadline`` so ``supervised_call`` times
  out);
* **corrupt** — return the inner verdict with one lane's bit flipped
  (models silent corruption; the guard's audit must catch it).

Faults come from an explicit per-call ``schedule`` list (consumed in call
order: ``"ok" | "fail" | "hang" | "corrupt"``) and, once exhausted, from
seeded per-call rates.  Same seed + same call order → same fault
sequence, so sim scenarios using it stay replayable.

The shim exposes the BatchVerifier surface plus a ``backend`` attr so
``GuardedBatchVerifier`` treats it as a device backend.

The port's copy of the reference package's ``sim/faults.py``, but that the
shim also forwards its inner verifier's ``device``: the port's guard
decides "on the card" by ``libs/breaker.on_card`` (a CUDA ``.device``).
Around the card's ``TorchBatchVerifier`` the shim is then on the card, and
a fault it injects raises ``DeviceDispatchError`` out of the guard (no host
verdict); around ``HostBatchVerifier`` (no ``device``) it is off the card,
and the guard falls back to the host as the reference's does.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional, Sequence

import numpy as np


class InjectedDeviceError(RuntimeError):
    """A scheduled/seeded device failure from FaultyDevice."""


class FaultyDevice:
    name = "faulty"

    def __init__(
        self,
        inner,
        seed: int = 0,
        fail_rate: float = 0.0,
        hang_rate: float = 0.0,
        corrupt_rate: float = 0.0,
        hang_s: float = 0.05,
        schedule: Optional[List[str]] = None,
    ):
        self.inner = inner
        self.backend = getattr(inner, "backend", getattr(inner, "name", "host"))
        # the guard's on-card test reads this: the card's verifier carries a
        # CUDA device, the host's none
        self.device = getattr(inner, "device", None)
        self.hang_s = hang_s
        self.fail_rate = fail_rate
        self.hang_rate = hang_rate
        self.corrupt_rate = corrupt_rate
        self._rng = random.Random(seed)
        self._schedule = list(schedule or [])
        self._mtx = threading.Lock()
        self.calls = 0
        self.failures = 0
        self.hangs = 0
        self.corruptions = 0

    # -- fault decision ------------------------------------------------------
    def _next_fault(self) -> str:
        with self._mtx:
            self.calls += 1
            if self._schedule:
                return self._schedule.pop(0)
            r = self._rng.random()
            if r < self.fail_rate:
                return "fail"
            if r < self.fail_rate + self.hang_rate:
                return "hang"
            if r < self.fail_rate + self.hang_rate + self.corrupt_rate:
                return "corrupt"
            return "ok"

    def _apply(self, call) -> np.ndarray:
        fault = self._next_fault()
        if fault == "fail":
            with self._mtx:
                self.failures += 1
            raise InjectedDeviceError("injected device failure")
        if fault == "hang":
            with self._mtx:
                self.hangs += 1
            time.sleep(self.hang_s)
            return call()
        ok = call()
        if fault == "corrupt" and ok.size:
            ok = np.array(ok, copy=True)
            with self._mtx:
                self.corruptions += 1
                lane = self._rng.randrange(ok.size)
            flat = ok.reshape(-1)
            flat[lane] = not bool(flat[lane])
        return ok

    # -- BatchVerifier surface -----------------------------------------------
    def verify_ed25519(self, items: Sequence) -> np.ndarray:
        return self._apply(lambda: self.inner.verify_ed25519(items))

    def verify_ed25519_raw(self, pubs, msgs, sigs) -> np.ndarray:
        return self._apply(lambda: self.inner.verify_ed25519_raw(pubs, msgs, sigs))

    def verify_secp256k1(self, items: Sequence) -> np.ndarray:
        return self._apply(lambda: self.inner.verify_secp256k1(items))

    # -- inspection ------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._mtx:
            return {
                "calls": self.calls,
                "failures": self.failures,
                "hangs": self.hangs,
                "corruptions": self.corruptions,
                "schedule_left": len(self._schedule),
            }
