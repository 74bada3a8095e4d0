"""The port's dispatch guard: ``GuardedBatchVerifier``
(tendermint_tpu_torch/crypto/batch.py) and the planner's
``_execute_device_guarded`` (tendermint_tpu_torch/parallel/planner.py),
restating the ``TestGuardedBatchVerifier`` and ``TestPlannerGuard`` cases of
tests/test_device_dispatch.py: a failing device falls back bit-identically,
a transient failure is retried onto the device, a hung device times out to
the host, corruption is quarantined and never escapes, and an operator
reset readmits the device. Faults come from the reference's
``sim.faults.FaultyDevice`` wrapped around the port's verifiers. Every
fallback is counted in the port's metrics by reason. On the card
(``TestOnTheCard``) the same guards record, retry and quarantine, then raise
``DeviceDispatchError`` instead of answering from the host. Exact equality
throughout."""

import time

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.keys import PubKeyEd25519 as JPub
from tendermint_tpu.sim.faults import FaultyDevice, InjectedDeviceError
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519 as TPub
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.parallel import planner


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on tensors of a few hundred elements, where
    torch's thread pool buys nothing; one thread keeps this file from
    crowding the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_guard():
    brk.reset_device_guard()
    planner.set_device_executor(None)
    yield
    brk.reset_device_guard()
    planner.set_device_executor(None)


def _triples(n, tag=0, forged=()):
    rng = np.random.default_rng(1000 + tag)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        priv = ted.gen_privkey(rng.bytes(32))
        msg = b"dispatch-%d-%d" % (tag, i)
        sig = ted.sign(priv, msg)
        if i in forged:
            bad = bytearray(sig)
            bad[5] ^= 1
            sig = bytes(bad)
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(sig)
    return pubs, msgs, sigs


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _fallbacks(reason):
    return get_verify_metrics().device_fallback._values.get((reason,), 0.0)


class TestGuardedBatchVerifier:
    def _guarded(self, dev, **kw):
        kw.setdefault("breaker", brk.CircuitBreaker(
            threshold=2, backoff_base=60.0, clock=FakeClock()))
        kw.setdefault("deadline", 5.0)
        kw.setdefault("retries", 0)
        kw.setdefault("audit_rate", 1.0)
        return tbatch.GuardedBatchVerifier(dev, **kw)

    def test_failing_device_falls_back_bit_identically(self):
        pubs, msgs, sigs = _triples(8, tag=1, forged=(3,))
        expected = tbatch.HostBatchVerifier().verify_ed25519_raw(pubs, msgs, sigs)
        assert expected.tolist() == [i != 3 for i in range(8)]
        dev = FaultyDevice(tbatch.HostBatchVerifier(), fail_rate=1.0)
        g = self._guarded(dev)
        errors0, open0 = _fallbacks("error"), _fallbacks("breaker_open")
        for _ in range(4):
            ok = g.verify_ed25519_raw(pubs, msgs, sigs)
            assert np.array_equal(ok, expected)
        assert g.breaker.state == brk.OPEN
        calls_when_open = dev.calls
        assert np.array_equal(g.verify_ed25519_raw(pubs, msgs, sigs), expected)
        assert dev.calls == calls_when_open
        assert _fallbacks("error") - errors0 == 2
        assert _fallbacks("breaker_open") - open0 == 3

    def test_transient_failure_retries_onto_the_device(self):
        pubs, msgs, sigs = _triples(4, tag=2)
        expected = tbatch.HostBatchVerifier().verify_ed25519_raw(pubs, msgs, sigs)
        dev = FaultyDevice(tbatch.HostBatchVerifier(), schedule=["fail", "ok"])
        g = self._guarded(dev, retries=1)
        retries0 = get_verify_metrics().device_retries._values.get((), 0.0)
        ok = g.verify_ed25519_raw(pubs, msgs, sigs)
        assert np.array_equal(ok, expected)
        assert dev.calls == 2
        assert g.breaker.state == brk.CLOSED
        assert get_verify_metrics().device_retries._values[()] - retries0 == 1

    def test_hung_device_times_out_to_host(self):
        pubs, msgs, sigs = _triples(4, tag=3, forged=(0,))
        expected = tbatch.HostBatchVerifier().verify_ed25519_raw(pubs, msgs, sigs)
        dev = FaultyDevice(tbatch.HostBatchVerifier(), hang_rate=1.0, hang_s=5.0)
        g = self._guarded(dev, deadline=0.1)
        timeouts0 = _fallbacks("timeout")
        t0 = time.monotonic()
        ok = g.verify_ed25519_raw(pubs, msgs, sigs)
        assert time.monotonic() - t0 < 4.0
        assert np.array_equal(ok, expected)
        assert _fallbacks("timeout") - timeouts0 == 1

    def test_corruption_quarantines_and_never_escapes(self):
        pubs, msgs, sigs = _triples(8, tag=4, forged=(2, 6))
        expected = tbatch.HostBatchVerifier().verify_ed25519_raw(pubs, msgs, sigs)
        dev = FaultyDevice(tbatch.HostBatchVerifier(), corrupt_rate=1.0)
        g = self._guarded(dev, audit_rate=1.0)
        mismatch0 = get_verify_metrics().device_audit._values.get(("mismatch",), 0.0)
        ok = g.verify_ed25519_raw(pubs, msgs, sigs)
        assert np.array_equal(ok, expected)
        assert g.breaker.state == brk.QUARANTINED
        calls = dev.calls
        for _ in range(3):
            assert np.array_equal(g.verify_ed25519_raw(pubs, msgs, sigs), expected)
        assert dev.calls == calls
        assert g.snapshot()["audit_mismatches"] == 1
        assert get_verify_metrics().device_audit._values[("mismatch",)] - mismatch0 == 1
        assert get_profiler().events("audit_mismatch")[-1]["mismatches"] == 1

    def test_operator_reset_readmits_the_device(self):
        pubs, msgs, sigs = _triples(4, tag=5)
        dev = FaultyDevice(tbatch.HostBatchVerifier(), schedule=["corrupt"])
        g = self._guarded(dev, audit_rate=1.0)
        g.verify_ed25519_raw(pubs, msgs, sigs)
        assert g.breaker.state == brk.QUARANTINED
        g.breaker.reset()
        calls = dev.calls
        g.verify_ed25519_raw(pubs, msgs, sigs)
        assert dev.calls == calls + 1
        assert g.breaker.state == brk.CLOSED

    def test_secp256k1_items_are_guarded_too(self):
        from tendermint_tpu_torch.testutil import commit as tc

        sc_ = tc.build_commit(4, seed=5, key_type="secp256k1")
        pks, msgs, sigs, _ = sc_.valset.collect_commit_sigs(
            sc_.chain_id, sc_.block_id, sc_.height, sc_.commit)
        items = [tbatch.SigItem(p.bytes(), m, s) for p, m, s in zip(pks, msgs, sigs)]
        items[1] = items[1]._replace(msg=items[1].msg + b"x")
        dev = FaultyDevice(tbatch.HostBatchVerifier(), schedule=["corrupt"])
        g = self._guarded(dev, audit_rate=1.0)
        assert g.verify_secp256k1(items).tolist() == [True, False, True, True]
        assert g.breaker.state == brk.QUARANTINED


def test_guarded_torch_verifier_equals_the_reference_host_verifier():
    """The port's guarded verifier over TorchBatchVerifier("cpu") (the plain
    versions of K1 and K2) against the reference's HostBatchVerifier on a
    seeded 12-row batch, every third signature with a flipped bit; the
    audit (rate 1.0) finds nothing and the breaker stays closed."""
    rng = np.random.default_rng(12)
    pubs, msgs, sigs = [], [], []
    for i in range(12):
        priv = ted.gen_privkey(rng.bytes(32))
        msg = rng.bytes(int(rng.integers(0, 120)))
        sig = bytearray(ted.sign(priv, msg))
        if i % 3 == 2:
            sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(bytes(sig))
    # unsupervised: the plain versions on a loaded CPU can outlast 30 s
    g = tbatch.GuardedBatchVerifier(tbatch.TorchBatchVerifier("cpu"), audit_rate=1.0,
                                    deadline=0)
    got = tbatch.verify_generic([TPub(p) for p in pubs], msgs, sigs, verifier=g)
    want = jbatch.verify_generic([JPub(p) for p in pubs], msgs, sigs,
                                 verifier=jbatch.HostBatchVerifier())
    assert got.tolist() == np.asarray(want, dtype=bool).tolist()
    assert 0 < got.sum() < 12
    assert g.breaker.state == brk.CLOSED
    assert g.snapshot()["dispatches"] == 1 and g.snapshot()["audit_mismatches"] == 0


def test_default_verifier_is_guarded_and_needs_cuda():
    saved = tbatch._default
    tbatch.set_batch_verifier(None)
    try:
        if torch.cuda.is_available():
            v = tbatch.get_batch_verifier()
            assert isinstance(v, tbatch.GuardedBatchVerifier)
            assert v.device.backend == "cuda"
        else:
            with pytest.raises(NoCudaDeviceError):
                tbatch.get_batch_verifier()
            assert tbatch.verifier_info()["installed"] is False
        g = tbatch.GuardedBatchVerifier(tbatch.TorchBatchVerifier("cpu"))
        tbatch.set_batch_verifier(g)
        info = tbatch.verifier_info()
        assert (info["name"], info["backend"], info["latched_reason"]) == ("guarded", "cpu", None)
        assert info["guard"]["deadline"] == 30.0 and info["guard"]["audit_rate"] == 0.05
    finally:
        tbatch.set_batch_verifier(saved)


def _window(sizes, tag=0, forged=()):
    flat_pubs, flat_msgs, flat_sigs = _triples(sum(sizes), tag=tag)
    votes, powers, totals = [], [], []
    i = 0
    for h, V in enumerate(sizes):
        vrow, prow = [], []
        for v in range(V):
            sig = flat_sigs[i]
            if (h, v) in forged:
                bad = bytearray(sig)
                bad[9] ^= 1
                sig = bytes(bad)
            vrow.append((flat_pubs[i], flat_msgs[i], sig))
            prow.append((h + v) % 5 + 1)
            i += 1
        votes.append(vrow)
        powers.append(prow)
        totals.append(sum(prow))
    return votes, powers, totals


def _assert_same_verdict(a, b):
    assert np.array_equal(a.ok, b.ok)
    assert np.array_equal(a.tally, b.tally)
    assert np.array_equal(a.committed, b.committed)
    assert np.array_equal(a.sigs_ok, b.sigs_ok)


HOST = tbatch.HostBatchVerifier()


class TestPlannerGuard:
    def test_raising_executor_completes_on_host(self):
        votes, powers, totals = _window([3, 5], tag=10, forged={(1, 2)})
        host = planner.verify_window(votes, powers, totals, verifier=HOST, use_device=False)

        def explode(plan, mesh):
            raise InjectedDeviceError("kernel crashed")

        planner.set_device_executor(explode)
        errors0 = _fallbacks("error")
        dev = planner.verify_window(votes, powers, totals, verifier=HOST, use_device=True)
        _assert_same_verdict(dev, host)
        assert brk.get_device_breaker().snapshot()["failures_total"] == 2  # one retry
        assert _fallbacks("error") - errors0 == 1
        assert get_profiler().events("device_fallback")[-1]["backend"] == "planner"

    def test_hung_executor_times_out_to_host(self):
        brk.configure_device_guard(dispatch_deadline=0.1, retries=0)
        votes, powers, totals = _window([2, 2], tag=12, forged={(0, 1)})
        host = planner.verify_window(votes, powers, totals, verifier=HOST, use_device=False)

        def hang(plan, mesh):
            time.sleep(5.0)

        planner.set_device_executor(hang)
        timeouts0 = _fallbacks("timeout")
        t0 = time.monotonic()
        dev = planner.verify_window(votes, powers, totals, verifier=HOST, use_device=True)
        assert time.monotonic() - t0 < 4.0
        _assert_same_verdict(dev, host)
        assert _fallbacks("timeout") - timeouts0 == 1

    def test_corrupting_executor_quarantines(self):
        brk.configure_device_guard(audit_sample_rate=1.0)
        votes, powers, totals = _window([4], tag=11)
        host = planner.verify_window(votes, powers, totals, verifier=HOST, use_device=False)

        def corrupt(plan, mesh):
            v = planner._execute_host(plan, verifier=HOST)
            j = int(np.flatnonzero(plan.wellformed)[0])
            h, vv = int(plan.coords[j, 0]), int(plan.coords[j, 1])
            v.ok = np.array(v.ok, copy=True)
            v.ok[h, vv] = not v.ok[h, vv]
            return v

        planner.set_device_executor(corrupt)
        mismatch0 = _fallbacks("audit_mismatch")
        dev = planner.verify_window(votes, powers, totals, verifier=HOST, use_device=True)
        _assert_same_verdict(dev, host)
        assert brk.get_device_breaker().state == brk.QUARANTINED
        assert _fallbacks("audit_mismatch") - mismatch0 == 1
        # latched: the executor is not called again until an operator reset
        calls = {"n": 0}

        def count(plan, mesh):
            calls["n"] += 1
            return planner._execute_host(plan, verifier=HOST)

        planner.set_device_executor(count)
        _assert_same_verdict(
            planner.verify_window(votes, powers, totals, verifier=HOST, use_device=True), host)
        assert calls["n"] == 0
        brk.get_device_breaker().reset()
        _assert_same_verdict(
            planner.verify_window(votes, powers, totals, verifier=HOST, use_device=True), host)
        assert calls["n"] == 1
        assert brk.get_device_breaker().state == brk.CLOSED

    def test_cpu_executor_passes_the_audit(self):
        brk.configure_device_guard(audit_sample_rate=1.0, dispatch_deadline=0)
        votes, powers, totals = _window([3, 2], tag=13, forged={(0, 0)})
        host = planner.verify_window(votes, powers, totals, verifier=HOST, use_device=False)
        planner.set_device_executor(planner.device_executor("cpu"))
        ok0 = get_verify_metrics().device_audit._values.get(("ok",), 0.0)
        dev = planner.verify_window(votes, powers, totals, verifier=HOST, use_device=True)
        _assert_same_verdict(dev, host)
        assert dev.lanes_dispatched == 64
        assert brk.get_device_breaker().state == brk.CLOSED
        assert get_verify_metrics().device_audit._values[("ok",)] - ok0 == 5


class CardFaultyDevice(FaultyDevice):
    """A faulty verifier that reports a CUDA device, as TorchBatchVerifier
    on the card does; nothing here touches a card."""

    device = torch.device("cuda", 0)


class NoHost:
    """A host verifier that must never be called."""

    def __getattr__(self, name):
        raise AssertionError(f"the guard called the host's {name} on the card")


def _all_fallbacks():
    return sum(get_verify_metrics().device_fallback._values.values())


class TestOnTheCard:
    """On the card the guards record, retry and quarantine as off it, then
    raise where the reference would complete on the host."""

    def _guarded(self, dev, **kw):
        kw.setdefault("breaker", brk.CircuitBreaker(
            threshold=2, backoff_base=60.0, clock=FakeClock()))
        kw.setdefault("deadline", 5.0)
        kw.setdefault("retries", 1)
        kw.setdefault("audit_rate", 1.0)
        return tbatch.GuardedBatchVerifier(dev, host=NoHost(), **kw)

    def test_failing_card_raises_after_its_retry(self):
        pubs, msgs, sigs = _triples(4, tag=20)
        dev = CardFaultyDevice(tbatch.HostBatchVerifier(), fail_rate=1.0)
        g = self._guarded(dev)
        assert g.on_card
        fallbacks0 = _all_fallbacks()
        with pytest.raises(brk.DeviceDispatchError) as e:
            g.verify_ed25519_raw(pubs, msgs, sigs)
        assert e.value.reason == "error"
        assert isinstance(e.value.__cause__, InjectedDeviceError)
        assert dev.calls == 2 and g.breaker.state == brk.OPEN
        with pytest.raises(brk.DeviceDispatchError) as e:
            g.verify_ed25519_raw(pubs, msgs, sigs)
        assert e.value.reason == "breaker_open" and dev.calls == 2
        assert _all_fallbacks() == fallbacks0
        assert get_profiler().events("device_failure")[-1]["reason"] == "breaker_open"

    def test_hung_card_raises_a_timeout(self):
        pubs, msgs, sigs = _triples(2, tag=21)
        dev = CardFaultyDevice(tbatch.HostBatchVerifier(), hang_rate=1.0, hang_s=5.0)
        g = self._guarded(dev, deadline=0.1, retries=0)
        t0 = time.monotonic()
        with pytest.raises(brk.DeviceDispatchError) as e:
            g.verify_ed25519_raw(pubs, msgs, sigs)
        assert time.monotonic() - t0 < 4.0
        assert e.value.reason == "timeout"
        assert isinstance(e.value.__cause__, brk.DispatchTimeout)

    def test_corrupting_card_quarantines_and_raises(self):
        pubs, msgs, sigs = _triples(4, tag=22)
        dev = CardFaultyDevice(tbatch.HostBatchVerifier(), corrupt_rate=1.0)
        g = self._guarded(dev)
        fallbacks0 = _all_fallbacks()
        with pytest.raises(brk.DeviceAuditMismatch):
            g.verify_ed25519_raw(pubs, msgs, sigs)
        assert g.breaker.state == brk.QUARANTINED
        with pytest.raises(brk.DeviceDispatchError) as e:
            g.verify_ed25519_raw(pubs, msgs, sigs)
        assert e.value.reason == "quarantined" and dev.calls == 1
        assert g.snapshot()["audit_mismatches"] == 1
        assert _all_fallbacks() == fallbacks0

    def test_card_executor_raises_instead_of_the_host(self):
        votes, powers, totals = _window([3, 2], tag=23)

        def explode(plan, mesh):
            raise InjectedDeviceError("kernel crashed")

        explode.device = torch.device("cuda", 0)
        planner.set_device_executor(explode)
        fallbacks0 = _all_fallbacks()
        with pytest.raises(brk.DeviceDispatchError) as e:
            planner.verify_window(votes, powers, totals, verifier=NoHost(), use_device=True)
        assert e.value.reason == "error"
        assert brk.get_device_breaker().snapshot()["failures_total"] == 2  # one retry
        assert _all_fallbacks() == fallbacks0
        assert get_profiler().events("device_failure")[-1]["backend"] == "planner"

    def test_corrupting_card_executor_quarantines_and_raises(self):
        brk.configure_device_guard(audit_sample_rate=1.0)
        votes, powers, totals = _window([4], tag=24)

        def corrupt(plan, mesh):
            v = planner._execute_host(plan, verifier=HOST)
            v.ok = ~np.asarray(v.ok)
            return v

        corrupt.device = torch.device("cuda", 0)
        planner.set_device_executor(corrupt)
        with pytest.raises(brk.DeviceAuditMismatch):
            planner.verify_window(votes, powers, totals, verifier=NoHost(), use_device=True)
        assert brk.get_device_breaker().state == brk.QUARANTINED
        with pytest.raises(brk.DeviceDispatchError) as e:
            planner.verify_window(votes, powers, totals, verifier=NoHost(), use_device=True)
        assert e.value.reason == "quarantined"

    def test_default_executor_counts_as_the_card(self):
        """With no executor installed the device route targets the current
        CUDA device; without one that is an error, never the host."""
        brk.configure_device_guard(retries=0)
        votes, powers, totals = _window([2], tag=25)
        if torch.cuda.is_available():
            got = planner.verify_window(votes, powers, totals, use_device=True)
            assert got.tally.tolist() == [sum(powers[0])]
        else:
            with pytest.raises(brk.DeviceDispatchError) as e:
                planner.verify_window(votes, powers, totals, verifier=NoHost(),
                                      use_device=True)
            assert isinstance(e.value.__cause__, NoCudaDeviceError)
