"""The port's circuit breaker (tendermint_tpu_torch/libs/breaker.py): the
cases of tests/test_breaker.py restated against it — deterministic
transitions under an injectable clock, backoff doubling and its cap, the
single-probe half-open protocol under many threads, the latched
quarantine, bounded history, the supervised dispatch deadline and
configure_device_guard's duck typing — and the same scripted event
sequence giving the same snapshots in the port's breaker and the
reference's."""

import threading
import time

import pytest

from tendermint_tpu_torch.libs.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    QUARANTINED,
    STATE_GAUGE,
    CircuitBreaker,
    DispatchTimeout,
    GuardConfig,
    configure_device_guard,
    get_device_breaker,
    guard_config,
    reset_device_guard,
    supervised_call,
)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _breaker(**kw):
    kw.setdefault("threshold", 3)
    kw.setdefault("backoff_base", 1.0)
    kw.setdefault("backoff_max", 8.0)
    clock = kw.pop("clock", None) or FakeClock()
    return CircuitBreaker(clock=clock, **kw), clock


class TestTransitions:
    def test_stays_closed_below_threshold(self):
        br, _ = _breaker()
        br.record_failure()
        br.record_failure()
        assert br.state == CLOSED
        assert br.allow()

    def test_opens_at_threshold_consecutive_failures(self):
        br, _ = _breaker()
        for _ in range(3):
            br.record_failure("error")
        assert br.state == OPEN
        assert not br.allow()

    def test_success_resets_the_consecutive_count(self):
        br, _ = _breaker()
        for _ in range(10):
            br.record_failure()
            br.record_failure()
            br.record_success()
        assert br.state == CLOSED

    def test_half_open_probe_after_backoff_then_close(self):
        br, clock = _breaker()
        for _ in range(3):
            br.record_failure()
        assert not br.allow()  # backoff not elapsed
        clock.advance(1.0)
        assert br.allow()  # the probe slot
        assert br.state == HALF_OPEN
        br.record_success()
        assert br.state == CLOSED
        assert br.allow()

    def test_failed_probe_reopens_with_doubled_backoff(self):
        br, clock = _breaker()
        for _ in range(3):
            br.record_failure()
        clock.advance(1.0)
        assert br.allow()
        br.record_failure()  # probe fails
        assert br.state == OPEN
        clock.advance(1.0)  # base backoff elapsed — but it doubled to 2
        assert not br.allow()
        clock.advance(1.0)
        assert br.allow()

    def test_backoff_is_capped_at_backoff_max(self):
        br, clock = _breaker(backoff_base=1.0, backoff_max=4.0)
        for _ in range(3):
            br.record_failure()
        for _ in range(10):  # repeated failed probes: 1, 2, 4, 4, 4, ...
            clock.advance(4.0)
            assert br.allow()
            br.record_failure()
        snap = br.snapshot()
        assert snap["retry_in_seconds"] <= 4.0

    def test_trip_forces_open_without_threshold(self):
        br, _ = _breaker()
        br.trip("device_init_error")
        assert br.state == OPEN
        assert not br.allow()

    def test_gauge_encoding_is_stable(self):
        # the tendermint_verify_device_breaker_state wire contract
        assert STATE_GAUGE == {
            CLOSED: 0, OPEN: 1, HALF_OPEN: 2, QUARANTINED: 3,
        }


class TestQuarantine:
    def test_quarantine_latches_against_success_and_time(self):
        br, clock = _breaker()
        br.quarantine("audit_mismatch:ed25519")
        assert br.state == QUARANTINED
        br.record_success()
        clock.advance(1e9)
        assert not br.allow()
        assert br.state == QUARANTINED

    def test_only_operator_reset_leaves_quarantine(self):
        br, _ = _breaker()
        br.quarantine("audit_mismatch:planner")
        br.reset()
        assert br.state == CLOSED
        assert br.allow()
        assert br.snapshot()["quarantine_reason"] is None

    def test_reason_survives_in_snapshot_and_history(self):
        br, _ = _breaker()
        br.quarantine("audit_mismatch:ed25519")
        snap = br.snapshot()
        assert snap["quarantine_reason"] == "audit_mismatch:ed25519"
        assert snap["history"][-1]["to"] == QUARANTINED


class TestHistory:
    def test_every_transition_is_recorded_with_reason(self):
        br, clock = _breaker()
        for _ in range(3):
            br.record_failure("timeout")
        clock.advance(1.0)
        br.allow()
        br.record_success()
        hops = [(h["from"], h["to"]) for h in br.snapshot()["history"]]
        assert hops == [
            (CLOSED, OPEN), (OPEN, HALF_OPEN), (HALF_OPEN, CLOSED),
        ]
        reasons = [h["reason"] for h in br.snapshot()["history"]]
        assert reasons[0] == "threshold:timeout"

    def test_history_is_bounded(self):
        br, clock = _breaker(threshold=1, backoff_base=0.001,
                             backoff_max=0.001)
        for _ in range(200):
            br.record_failure()
            clock.advance(1.0)
            br.allow()
            br.record_success()
        snap = br.snapshot()
        assert len(snap["history"]) <= 64
        assert snap["history_dropped"] > 0


class TestConcurrency:
    def test_exactly_one_half_open_probe_is_granted(self):
        br, clock = _breaker()
        for _ in range(3):
            br.record_failure()
        clock.advance(1.0)
        grants = []
        barrier = threading.Barrier(16)

        def contend():
            barrier.wait()
            grants.append(br.allow())

        threads = [threading.Thread(target=contend) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(grants) == 1

    def test_hammering_from_many_threads_keeps_invariants(self):
        br = CircuitBreaker(threshold=2, backoff_base=0.0001,
                            backoff_max=0.001)
        stop = threading.Event()
        errors = []

        def worker(i):
            try:
                while not stop.is_set():
                    if br.allow():
                        (br.record_success if i % 2 else
                         br.record_failure)()
            except Exception as e:  # pragma: no cover - the assertion
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join()
        assert not errors
        snap = br.snapshot()
        assert snap["state"] in (CLOSED, OPEN, HALF_OPEN)
        assert snap["failures_total"] > 0 and snap["successes_total"] > 0


class TestSupervisedCall:
    def test_returns_result_within_deadline(self):
        assert supervised_call(lambda: 42, deadline=5.0) == 42

    def test_propagates_exceptions(self):
        with pytest.raises(ValueError, match="boom"):
            supervised_call(lambda: (_ for _ in ()).throw(ValueError("boom")),
                            deadline=5.0)

    def test_hung_call_raises_dispatch_timeout(self):
        started = threading.Event()

        def hang():
            started.set()
            time.sleep(10.0)

        t0 = time.monotonic()
        with pytest.raises(DispatchTimeout):
            supervised_call(hang, deadline=0.1, name="test-hang")
        assert time.monotonic() - t0 < 5.0
        assert started.is_set()

    def test_zero_deadline_disables_supervision(self):
        # direct call: no worker thread, exceptions still propagate
        before = threading.active_count()
        assert supervised_call(lambda: "x", deadline=0) == "x"
        assert threading.active_count() == before


class TestDeviceGuardConfig:
    def teardown_method(self):
        reset_device_guard()

    def test_configure_from_duck_typed_config(self):
        class V:
            breaker_threshold = 7
            breaker_backoff = 0.5
            audit_sample_rate = 0.25

        br = configure_device_guard(V())
        assert br.threshold == 7
        assert br.backoff_base == 0.5
        assert guard_config().audit_sample_rate == 0.25
        assert get_device_breaker() is br

    def test_overrides_win_and_unknown_knobs_raise(self):
        br = configure_device_guard(breaker_threshold=2)
        assert br.threshold == 2
        with pytest.raises(TypeError):
            configure_device_guard(not_a_knob=1)

    def test_reset_restores_defaults(self):
        configure_device_guard(breaker_threshold=9)
        reset_device_guard()
        assert guard_config() == GuardConfig()
        assert get_device_breaker().threshold == GuardConfig().breaker_threshold

    def test_transitions_drive_the_state_gauge(self):
        from tendermint_tpu_torch.libs.metrics import get_verify_metrics

        br = configure_device_guard(breaker_threshold=1)
        br.trip("test")
        gauge = get_verify_metrics().device_breaker_state
        assert gauge._values[()] == float(STATE_GAUGE[OPEN])
        br.reset()
        assert gauge._values[()] == float(STATE_GAUGE[CLOSED])

    def test_transitions_land_in_the_profiler_event_ring(self):
        from tendermint_tpu_torch.libs.profile import get_profiler

        br = configure_device_guard(breaker_threshold=1)
        before = len(get_profiler().events("breaker"))
        br.trip("test")
        br.reset()
        events = get_profiler().events("breaker")[before:]
        assert [(e["old"], e["new"]) for e in events] == [
            (CLOSED, OPEN), (OPEN, CLOSED)]
        assert events[0]["reason"] == "trip:test"

    def test_supervised_call_carries_the_profiler_window(self):
        from tendermint_tpu_torch.libs import profile

        seen = {}

        def probe():
            seen["window"] = getattr(profile._tls, "window", None)

        with profile.get_profiler().window(77, heights=3):
            supervised_call(probe, deadline=5.0)
        assert seen["window"] == (77, 3)


def _script(mod, clock):
    """One event sequence over every transition kind; the snapshot after
    each step."""
    br = mod.CircuitBreaker(threshold=2, backoff_base=1.0, backoff_max=4.0,
                            clock=clock)
    steps = [
        lambda: br.record_failure("error"),
        lambda: br.record_failure("timeout"),
        lambda: br.allow(),
        lambda: clock.advance(1.0),
        lambda: br.allow(),
        lambda: br.allow(),
        lambda: br.record_failure("error"),
        lambda: clock.advance(2.0),
        lambda: br.allow(),
        lambda: br.record_success(),
        lambda: br.trip("forced"),
        lambda: clock.advance(8.0),
        lambda: br.allow(),
        lambda: br.quarantine("audit_mismatch:ed25519"),
        lambda: br.allow(),
        lambda: br.reset(),
        lambda: br.allow(),
    ]
    out = []
    for step in steps:
        r = step()
        out.append((r, br.snapshot()))
    return out


def test_same_script_gives_the_reference_snapshots():
    from tendermint_tpu.libs import breaker as ref
    from tendermint_tpu_torch.libs import breaker as port

    assert port.STATE_GAUGE == ref.STATE_GAUGE
    assert port._HISTORY_CAPACITY == ref._HISTORY_CAPACITY
    assert port.GuardConfig().as_dict() == ref.GuardConfig().as_dict()
    assert _script(port, FakeClock()) == _script(ref, FakeClock())
