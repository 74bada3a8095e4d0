"""Circuit breaker + supervised dispatch for the device verification path.

The port's copy of the JAX package's ``libs/breaker.py`` (same states,
transitions, knobs and history); the transition hook writes the port's own
breaker gauge (``libs/metrics.py``) and profiler event (``libs/profile.py``).

A batched signature backend on a GPU behind the consensus verification
boundary turns accelerator failure modes into consensus hazards:

- a **crashed/preempted** device raises mid-dispatch — retrying a dead
  chip on every window burns the consensus routine's time budget;
- a **hung** device (a wedged runtime, a stuck copy) blocks the calling thread
  forever — worse than an error, because nothing propagates;
- a **silently corrupting** device returns wrong verdicts — a safety
  bug, not a perf bug, and must never be retried back into service.

``CircuitBreaker`` is the shared health model for all three.  It is a
deterministic state machine — every transition is a pure function of the
recorded events and an injectable monotonic clock, so the sim fabric can
replay schedules bit-for-bit:

    closed ── N consecutive failures ──► open
    open ── backoff elapsed, one probe granted ──► half_open
    half_open ── probe succeeds ──► closed
    half_open ── probe fails ──► open (backoff doubled)
    any ── corruption detected ──► quarantined   (operator reset only)

``quarantined`` is deliberately latched: a device that *mis-computes*
must not be re-admitted by timers, only by an explicit operator
``reset()`` (the ``device_breaker_reset`` unsafe RPC).

``supervised_call`` bounds a single dispatch with a wall-clock deadline
by running it on a worker thread; a hung call surfaces as
``DispatchTimeout`` so the caller can fall back to the host path instead
of stalling consensus (off the card; on it the guards raise
``DeviceDispatchError`` instead).  The abandoned worker thread is daemonic and left
to the wedged runtime — there is no safe way to kill it, and the breaker
ensures we stop handing work to it.

Callers (parallel/planner.py, crypto/batch.py GuardedBatchVerifier)
share one process-wide breaker via ``get_device_breaker()`` — one
physical device per host means one health state, configured from the
``[verify]`` section (config/verify.py) via ``configure_device_guard``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import asdict, dataclass
from typing import Callable, List, Optional

# state-machine states; GAUGE value encoding used by
# tendermint_verify_device_breaker_state (see libs/metrics.py)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
QUARANTINED = "quarantined"

STATE_GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2, QUARANTINED: 3}

_HISTORY_CAPACITY = 64


class BreakerOpen(Exception):
    """Dispatch refused: the breaker is open or quarantined."""


class DispatchTimeout(Exception):
    """A supervised device call exceeded its wall-clock deadline."""


class DeviceDispatchError(RuntimeError):
    """A guarded dispatch on a CUDA device gave no device verdict.

    Where the reference completes such a dispatch on the host oracle, the
    port's guards raise this instead while the guarded verifier or
    executor is on the card: a kernel that fails, hangs or mis-computes is
    an error there, never a host answer. ``reason`` is the one the
    reference counts a fallback under (``error``, ``timeout``,
    ``breaker_open``, ``quarantined``, ``audit_mismatch``)."""

    def __init__(self, reason: str, what: str):
        super().__init__(f"{what}: device dispatch failed ({reason})")
        self.reason = reason


class DeviceAuditMismatch(DeviceDispatchError):
    """The seeded audit found a device verdict that disagrees with the host
    oracle; the breaker is quarantined."""


def on_card(obj) -> bool:
    """True when ``obj`` (a verifier or an executor) carries a CUDA
    ``torch.device`` as ``.device``."""
    return getattr(getattr(obj, "device", None), "type", None) == "cuda"


class CircuitBreaker:
    """Deterministic circuit breaker with an injectable monotonic clock.

    Thread-safe: concurrent dispatchers may call ``allow`` /
    ``record_success`` / ``record_failure`` freely; exactly one caller
    wins the half-open probe slot.
    """

    def __init__(
        self,
        name: str = "device",
        threshold: int = 3,
        backoff_base: float = 1.0,
        backoff_max: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str, str], None]] = None,
    ):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        if backoff_base <= 0:
            raise ValueError("backoff_base must be > 0")
        self.name = name
        self.threshold = int(threshold)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.clock = clock
        self.on_transition = on_transition
        self._mtx = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opens = 0            # open transitions since last close/reset
        self._retry_at = 0.0       # clock() after which a probe is granted
        self._probe_inflight = False
        self._quarantine_reason: Optional[str] = None
        # lifetime counters (survive transitions; cleared by reset())
        self._n_failures = 0
        self._n_successes = 0
        self._n_probes = 0
        self._history: List[dict] = []
        self._history_dropped = 0

    # -- internals (lock held) -------------------------------------------------

    def _transition(self, new: str, reason: str) -> None:
        old = self._state
        if old == new:
            return
        self._state = new
        self._history.append({
            "t": float(self.clock()),
            "from": old,
            "to": new,
            "reason": reason,
        })
        if len(self._history) > _HISTORY_CAPACITY:
            del self._history[0]
            self._history_dropped += 1
        cb = self.on_transition
        if cb is not None:
            # fire outside any caller expectation of purity but inside the
            # lock: transitions are rare and ordering matters for the gauge
            try:
                cb(old, new, reason)
            except Exception:
                pass

    def _open(self, reason: str) -> None:
        self._opens += 1
        backoff = min(
            self.backoff_max,
            self.backoff_base * (2.0 ** (self._opens - 1)),
        )
        self._retry_at = float(self.clock()) + backoff
        self._probe_inflight = False
        self._transition(OPEN, reason)

    # -- dispatch protocol -----------------------------------------------------

    def allow(self) -> bool:
        """May the caller dispatch to the device right now?

        In ``open`` state, the first caller after the backoff elapses is
        granted the half-open probe (returns True); everyone else gets
        False until the probe reports.
        """
        with self._mtx:
            if self._state == CLOSED:
                return True
            if self._state == QUARANTINED:
                return False
            if self._state == OPEN:
                if self.clock() >= self._retry_at:
                    self._probe_inflight = True
                    self._n_probes += 1
                    self._transition(HALF_OPEN, "backoff_elapsed")
                    return True
                return False
            # HALF_OPEN: a single probe owns the state
            if not self._probe_inflight:
                self._probe_inflight = True
                self._n_probes += 1
                return True
            return False

    def record_success(self) -> None:
        with self._mtx:
            self._n_successes += 1
            self._consecutive_failures = 0
            if self._state == QUARANTINED:
                return  # only reset() leaves quarantine
            if self._state in (HALF_OPEN, OPEN):
                self._opens = 0
                self._probe_inflight = False
                self._transition(CLOSED, "probe_ok")

    def record_failure(self, reason: str = "error") -> None:
        with self._mtx:
            self._n_failures += 1
            self._consecutive_failures += 1
            if self._state == QUARANTINED:
                return
            if self._state == HALF_OPEN:
                self._open(f"probe_failed:{reason}")
            elif self._state == CLOSED and (
                self._consecutive_failures >= self.threshold
            ):
                self._open(f"threshold:{reason}")

    def trip(self, reason: str = "forced") -> None:
        """Force the breaker open immediately (e.g. device init failure),
        regardless of the consecutive-failure count."""
        with self._mtx:
            if self._state in (QUARANTINED, OPEN):
                return
            self._open(f"trip:{reason}")

    def quarantine(self, reason: str) -> None:
        """Latch the breaker: the device returned a verdict that disagrees
        with the host oracle.  Only an operator ``reset()`` re-arms it."""
        with self._mtx:
            self._quarantine_reason = reason
            self._probe_inflight = False
            self._transition(QUARANTINED, reason)

    def reset(self) -> None:
        """Operator reset: back to closed with clean counters."""
        with self._mtx:
            self._consecutive_failures = 0
            self._opens = 0
            self._retry_at = 0.0
            self._probe_inflight = False
            self._quarantine_reason = None
            self._transition(CLOSED, "operator_reset")

    # -- inspection ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._mtx:
            return self._state

    def snapshot(self) -> dict:
        with self._mtx:
            now = float(self.clock())
            return {
                "name": self.name,
                "state": self._state,
                "state_code": STATE_GAUGE[self._state],
                "threshold": self.threshold,
                "backoff_base": self.backoff_base,
                "backoff_max": self.backoff_max,
                "consecutive_failures": self._consecutive_failures,
                "opens_since_close": self._opens,
                "retry_in_seconds": (
                    max(0.0, round(self._retry_at - now, 6))
                    if self._state == OPEN else 0.0
                ),
                "probe_inflight": self._probe_inflight,
                "quarantine_reason": self._quarantine_reason,
                "failures_total": self._n_failures,
                "successes_total": self._n_successes,
                "probes_total": self._n_probes,
                "history": [dict(h) for h in self._history],
                "history_dropped": self._history_dropped,
            }


# -- supervised dispatch -------------------------------------------------------


def supervised_call(fn: Callable[[], object], deadline: float,
                    name: str = "device-dispatch"):
    """Run ``fn`` with a wall-clock deadline.

    ``deadline <= 0`` disables supervision (direct call).  Otherwise the
    call runs on a daemon worker thread; if it does not finish within
    ``deadline`` seconds, ``DispatchTimeout`` is raised and the worker is
    abandoned to the wedged runtime (it cannot be killed safely — the
    breaker's job is to stop sending work its way).

    The caller's profiler window annotation (libs/profile.py is
    thread-local) is propagated into the worker so ledger rows still fold
    into the right per-height group.
    """
    if deadline is None or deadline <= 0:
        return fn()

    from tendermint_tpu_torch.libs import profile as _profile

    win = getattr(_profile._tls, "window", None)
    box: dict = {}
    done = threading.Event()

    def _run():
        if win is not None:
            _profile._tls.window = win
        try:
            box["result"] = fn()
        except BaseException as e:  # propagate to the supervising thread
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_run, name=f"supervised-{name}", daemon=True)
    t.start()
    if not done.wait(deadline):
        raise DispatchTimeout(
            f"{name} exceeded {deadline:.3f}s deadline (worker abandoned)"
        )
    if "error" in box:
        raise box["error"]
    return box.get("result")


# -- process-wide device guard -------------------------------------------------


@dataclass
class GuardConfig:
    """Knobs for the device dispatch guard — the ``[verify]`` config
    section (config/verify.py VerifyConfig) mirrors these names."""

    breaker_threshold: int = 3
    breaker_backoff: float = 1.0
    breaker_backoff_max: float = 60.0
    dispatch_deadline: float = 30.0
    audit_sample_rate: float = 0.05
    audit_seed: int = 0
    retries: int = 1

    def as_dict(self) -> dict:
        return asdict(self)


_guard_mtx = threading.Lock()
_guard_config = GuardConfig()
_device_breaker: Optional[CircuitBreaker] = None


def _set_breaker_gauge(state: str) -> None:
    try:
        from tendermint_tpu_torch.libs.metrics import get_verify_metrics

        get_verify_metrics().device_breaker_state.set(float(STATE_GAUGE[state]))
    except Exception:
        pass


def _default_on_transition(old: str, new: str, reason: str) -> None:
    """Wire breaker transitions into the gauge + the profiler event ring."""
    _set_breaker_gauge(new)
    try:
        from tendermint_tpu_torch.libs.profile import get_profiler

        get_profiler().record_event(
            "breaker", old=old, new=new, reason=reason
        )
    except Exception:
        pass


def get_device_breaker() -> CircuitBreaker:
    """The process-wide breaker guarding the (single) device verify path."""
    global _device_breaker
    with _guard_mtx:
        if _device_breaker is None:
            c = _guard_config
            _device_breaker = CircuitBreaker(
                name="device",
                threshold=c.breaker_threshold,
                backoff_base=c.breaker_backoff,
                backoff_max=c.breaker_backoff_max,
                on_transition=_default_on_transition,
            )
        return _device_breaker


def guard_config() -> GuardConfig:
    with _guard_mtx:
        return _guard_config


def configure_device_guard(
    verify_config=None,
    clock: Optional[Callable[[], float]] = None,
    **overrides,
) -> CircuitBreaker:
    """(Re)build the process-wide breaker + guard config.

    ``verify_config`` is duck-typed (config/verify.py VerifyConfig or any
    object carrying the GuardConfig field names); keyword overrides win.
    Called from the configuration root (node/verify_root.py) with the
    ``[verify]`` section, and from tests with explicit small knobs + an
    injectable clock.
    """
    global _device_breaker, _guard_config
    fields = {}
    for f in GuardConfig.__dataclass_fields__:
        if verify_config is not None and hasattr(verify_config, f):
            fields[f] = getattr(verify_config, f)
        if f in overrides:
            fields[f] = overrides.pop(f)
    if overrides:
        raise TypeError(f"unknown guard knobs: {sorted(overrides)}")
    with _guard_mtx:
        _guard_config = GuardConfig(**fields)
        _device_breaker = CircuitBreaker(
            name="device",
            threshold=_guard_config.breaker_threshold,
            backoff_base=_guard_config.breaker_backoff,
            backoff_max=_guard_config.breaker_backoff_max,
            clock=clock or time.monotonic,
            on_transition=_default_on_transition,
        )
    # the gauge reads the breaker now installed, which starts closed (a
    # breaker replaced while open would leave it reading the old one)
    _set_breaker_gauge(CLOSED)
    return _device_breaker


def reset_device_guard() -> None:
    """Restore defaults (tests/scenarios teardown)."""
    global _device_breaker, _guard_config
    with _guard_mtx:
        _guard_config = GuardConfig()
        _device_breaker = None
