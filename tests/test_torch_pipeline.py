"""The port's ``WindowPipeline`` (tendermint_tpu_torch/parallel/planner.py)
against the reference's: the same seeded streams of windows through both
packages, the reference on its host verifier (``use_device=False``, the
``HostBatchVerifier`` tests/conftest.py installs), the port on the device
executor on the CPU (the plain versions of K1 and K2) or on
``TorchBatchVerifier("cpu")``. Verdict grids, int64 tallies, ``committed``
and ``sigs_ok`` must be equal, exactly. Restates the reference's
``TestWindowPipeline``, ``TestPipelineDepth`` (no mesh) and the pipeline case
of ``TestPlannerGuard``, and adds the state-sync backfill shape, a pack
that fails inside the guard and one that hangs on the card. Every wait is
bounded and every stream is closed."""

import threading
import time

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.keys import PubKeyEd25519 as JEd
from tendermint_tpu.parallel import planner as jplanner
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.testutil import window as tw

ROUTES = {"device": True, "verifier": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    # the plain K1 and K2 on a loaded CPU can outlast the 30 s dispatch
    # deadline: run the executor unsupervised (the guard has its own tests)
    brk.configure_device_guard(dispatch_deadline=0)
    planner.set_device_executor(planner.device_executor("cpu"))
    tbatch.set_batch_verifier(tbatch.TorchBatchVerifier("cpu"))
    yield
    planner.set_device_executor(None)
    tbatch.set_batch_verifier(None)
    planner.configure_planner(None)
    brk.reset_device_guard()


def _window(sizes, absent=(), forged=(), malformed=(), tag=0):
    """(votes, powers, totals) of seeded raw-key rows, lanes mutated by
    (h, v) sets; one message length, so one group a dispatch."""
    rng = np.random.default_rng(900 + tag)
    votes, powers, totals = [], [], []
    for h, V in enumerate(sizes):
        vrow, prow = [], []
        for v in range(V):
            priv = ted.gen_privkey(rng.bytes(32))
            msg = b"pipeline-%03d-%02d-%03d" % (tag, h, v)
            sig = ted.sign(priv, msg)
            if (h, v) in absent:
                vrow.append(None)
            elif (h, v) in forged:
                vrow.append((priv[32:], msg, sig[:7] + bytes([sig[7] ^ 1]) + sig[8:]))
            elif (h, v) in malformed:
                vrow.append((priv[32:], msg, sig[:63]))
            else:
                vrow.append((priv[32:], msg, sig))
            prow.append((h + v) % 9 + 1)
        votes.append(vrow)
        powers.append(prow)
        totals.append(sum(prow))
    return votes, powers, totals


def _reference(spec):
    return jplanner.verify_window(*spec, use_device=False)


def _assert_same(got, want):
    assert got.tally.dtype == np.int64
    for k in ("ok", "tally", "committed", "sigs_ok"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


def _run(pipe, specs):
    it = pipe.run(iter(specs))
    try:
        return list(it)
    finally:
        it.close()


def _no_thread(name: str, seconds: float = 5.0) -> bool:
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if not any(t.name == name and t.is_alive() for t in threading.enumerate()):
            return True
        time.sleep(0.02)
    return False


def _fallbacks(reason: str) -> float:
    return get_verify_metrics().device_fallback._values.get((reason,), 0.0)


# -- tests/test_planner.py::TestWindowPipeline -------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pipeline_matches_serial(route):
    specs = [
        _window([1, 4], tag=40),
        _window([16, 2, 12], forged={(1, 1)}, tag=41),
        _window([8], absent={(0, 3)}, malformed={(0, 5)}, tag=42),
    ]
    want = _run(jplanner.WindowPipeline(use_device=False, prefetch=2), specs)
    got = _run(planner.WindowPipeline(use_device=ROUTES[route], prefetch=2), specs)
    assert len(got) == len(want) == len(specs)
    for g, w, spec in zip(got, want, specs):
        _assert_same(g, w)
        _assert_same(g, _reference(spec))
    assert [g.sigs_ok.tolist() for g in got] == [[True, True], [True, False, True], [False]]


def test_abandoned_pipeline_releases_worker_thread():
    """A consumer that raises on its first verdict (the syncer rejecting a
    snapshot) abandons the generator with the queue full: the worker must
    exit, not park on the queue."""
    specs = [_window([2], tag=45 + i) for i in range(8)]
    it = planner.WindowPipeline(use_device=False, prefetch=1).run(iter(specs))
    try:
        _assert_same(next(it), _reference(specs[0]))
    finally:
        it.close()
    assert _no_thread("planner-pack"), "planner-pack worker leaked after abandonment"


def test_pipeline_propagates_spec_errors_in_order():
    good = _window([2], tag=43)

    def specs():
        yield good
        raise RuntimeError("spec construction failed")

    it = planner.WindowPipeline(use_device=False).run(specs())
    try:
        _assert_same(next(it), _reference(good))
        with pytest.raises(RuntimeError, match="spec construction failed"):
            next(it)
    finally:
        it.close()


# -- tests/test_multichip.py::TestPipelineDepth (no mesh) --------------------


def test_depth_gt2_preserves_order():
    specs = [_window([2, 1], tag=50 + i) for i in range(6)]
    pipe = planner.WindowPipeline(use_device=False, depth=4)
    assert pipe.depth == 4
    got = _run(pipe, specs)
    assert len(got) == len(specs)
    for g, spec in zip(got, specs):
        _assert_same(g, planner.verify_window(*spec, use_device=False))
        _assert_same(g, _reference(spec))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_abandoned_deep_pipeline_releases_worker(route):
    """Closing mid-stream at depth 4 leaks neither the worker nor the
    windows it planned ahead."""
    specs = (_window([2], tag=60 + i) for i in range(64))
    gen = planner.WindowPipeline(use_device=ROUTES[route], depth=4).run(specs)
    try:
        next(gen)
        next(gen)
    finally:
        gen.close()
    assert _no_thread("planner-pack"), "pack worker still alive after abandonment"


def test_configured_depth_flows_from_config():
    planner.configure_planner(VerifyConfig(
        pipeline_depth=5, windows_per_device=2, planner_reduce="host"))
    assert planner.pipeline_depth() == 5
    assert planner.windows_per_dispatch() == 2
    assert planner.reduce_mode() == "host"
    assert planner.WindowPipeline(use_device=False).depth == 5
    assert planner.WindowPipeline(use_device=False, depth=3).depth == 3
    planner.configure_planner(None)
    assert (planner.pipeline_depth(), planner.windows_per_dispatch()) == (2, 4)
    assert planner.reduce_mode() == "device"
    with pytest.raises(ValueError):
        planner.configure_planner(VerifyConfig(planner_reduce="sideways"))


# -- tests/test_device_dispatch.py::TestPlannerGuard (pipeline) --------------


class InjectedDeviceError(RuntimeError):
    pass


def _flaky_execute_plan(monkeypatch, fail_on: int):
    real = planner.execute_plan
    calls = {"n": 0}

    def flaky(plan, **kw):
        calls["n"] += 1
        if calls["n"] == fail_on:
            raise InjectedDeviceError("device died mid-stream")
        return real(plan, **kw)

    monkeypatch.setattr(planner, "execute_plan", flaky)


def test_pipeline_survives_mid_stream_fault(monkeypatch):
    """Off the card, a dispatch that raises past the guard completes its
    window on the host and the stream goes on, as in the reference."""
    specs = [_window([2, 3], tag=20 + i) for i in range(4)]
    before = _fallbacks("pipeline_error")
    _flaky_execute_plan(monkeypatch, fail_on=2)
    got = _run(planner.WindowPipeline(use_device=True, prefetch=2), specs)
    assert len(got) == len(specs)
    for g, spec in zip(got, specs):
        _assert_same(g, _reference(spec))
    assert brk.get_device_breaker().snapshot()["failures_total"] > 0
    assert _fallbacks("pipeline_error") == before + 1


class _CardExecutor:
    """An executor that claims the card (``.device`` is CUDA) and computes
    on the CPU's plain versions."""

    device = torch.device("cuda")

    def __init__(self):
        self._cpu = planner.device_executor("cpu")

    def __call__(self, plan, mesh=None):
        return self._cpu(plan, mesh)


def test_pipeline_fault_on_the_card_raises(monkeypatch):
    """On the card the same fault is recorded and its window raises
    DeviceDispatchError: no host verdict, no fallback counted."""
    specs = [_window([2, 3], tag=20 + i) for i in range(4)]
    planner.set_device_executor(_CardExecutor())

    def no_host(plan, verifier=None):
        raise AssertionError("the pipeline completed a window on the host on the card")

    monkeypatch.setattr(planner, "_execute_host", no_host)
    _flaky_execute_plan(monkeypatch, fail_on=2)
    before = sum(get_verify_metrics().device_fallback._values.values())
    it = planner.WindowPipeline(use_device=True, prefetch=2).run(iter(specs))
    try:
        _assert_same(next(it), _reference(specs[0]))
        with pytest.raises(brk.DeviceDispatchError) as e:
            next(it)
    finally:
        it.close()
    assert e.value.reason == "pipeline_error"
    assert brk.get_device_breaker().snapshot()["failures_total"] == 1
    assert sum(get_verify_metrics().device_fallback._values.values()) == before
    assert _no_thread("planner-pack")


# -- what the port adds ------------------------------------------------------


def _subwindows(votes, powers, totals, size):
    for s in range(0, len(votes), size):
        yield votes[s: s + size], powers[s: s + size], totals[s: s + size]


def _as_reference(spec):
    """The same rows with the reference's key objects."""
    votes, powers, totals = spec
    return ([[None if it is None else (JEd(it[0].bytes()), it[1], it[2]) for it in row]
             for row in votes], powers, totals)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_backfill_shape(route):
    """State sync's backfill: a signed window (key objects, planted faults)
    streamed as sub-windows through WindowPipeline(use_device=True,
    depth=pipeline_depth()), as statesync/syncer.py does; here 4
    sub-windows of 2 heights x 4 validators. The concatenated verdicts equal
    the reference pipeline's, the flat window's and the construction's."""
    win = tw.build_window(8, 4, seed=13)
    tw.flip_bit(win, 1, 2)
    tw.drop_precommits(win, 3, 1)
    tw.short_signature(win, 4, 0)
    tw.absent_height(win, 6)
    votes, powers, totals = win.rows()
    specs = list(_subwindows(votes, powers, totals, 2))
    got = _run(planner.WindowPipeline(use_device=ROUTES[route],
                                      depth=planner.pipeline_depth()), specs)
    want = _run(jplanner.WindowPipeline(use_device=False, depth=2),
                [_as_reference(s) for s in specs])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_same(g, w)
    flat = planner.verify_window(votes, powers, totals, use_device=ROUTES[route])
    expected = tw.expected(win)
    for k in ("ok", "tally", "committed", "sigs_ok"):
        cat = np.concatenate([getattr(g, k) for g in got])
        assert np.array_equal(cat, getattr(flat, k)), k
        assert np.array_equal(cat, expected[k]), k


@pytest.mark.parametrize("fault", ["once", "every_pack"])
def test_pack_fault_is_a_guarded_failure_of_its_window(monkeypatch, fault):
    """The worker only plans; the pack and upload run inside the guarded
    executor. A pack that fails once is retried inside the guard and costs
    nothing; a pack that always fails is a guarded failure of that window
    (off the card: a counted fallback and a host verdict), never a stream
    error."""
    specs = [_window([1] * h, tag=70 + h) for h in (1, 2, 3, 4)]
    real = planner.pack_device
    calls = {"worker": 0, "guarded": 0}

    def pack(plan, device):
        if threading.current_thread().name == "planner-pack":
            calls["worker"] += 1
        if plan.H == 2:
            calls["guarded"] += 1
            if fault == "every_pack" or calls["guarded"] == 1:
                raise InjectedDeviceError("pack failed")
        return real(plan, device)

    monkeypatch.setattr(planner, "pack_device", pack)
    before = _fallbacks("error")
    get_profiler().reset()
    got = _run(planner.WindowPipeline(use_device=True, depth=2), specs)
    for g, spec in zip(got, specs):
        _assert_same(g, _reference(spec))
    kinds = [e["kind"] for e in get_profiler().entries()]
    assert calls["worker"] == 0
    assert calls["guarded"] == 2  # the try and its one retry
    if fault == "once":
        assert kinds == ["planner"] * 4 and _fallbacks("error") == before
    else:
        assert kinds == ["planner", "host", "planner", "planner"]
        assert _fallbacks("error") == before + 1
    assert brk.get_device_breaker().state == brk.CLOSED


def test_worker_only_plans():
    """Plans reach the executor unpacked, whatever executor is installed:
    the worker thread touches no device."""
    specs = [_window([2, 1], tag=80 + i) for i in range(3)]
    seen = []
    cpu = planner.device_executor("cpu")

    def recording(plan, mesh=None):
        seen.append((plan.dev is None, threading.current_thread().name))
        return cpu(plan, mesh)

    recording.device = cpu.device
    planner.set_device_executor(recording)
    _run(planner.WindowPipeline(use_device=True), specs)
    assert [unpacked for unpacked, _ in seen] == [True] * 3
    assert "planner-pack" not in {name for _, name in seen}


def test_hung_pack_on_the_card_raises_within_the_deadline(monkeypatch):
    """On the card a pack that hangs (a wedged upload) is bounded by the
    guard's dispatch deadline: the window raises DeviceDispatchError
    ('timeout'), nothing completes on the host, and the stream does not
    block."""
    specs = [_window([1, 1], tag=90 + i) for i in range(3)]
    planner.set_device_executor(_CardExecutor())
    brk.configure_device_guard(dispatch_deadline=0.5, retries=1)
    release = threading.Event()
    entered = []

    def hung_pack(plan, device):
        entered.append(threading.current_thread().name)
        release.wait(60.0)
        raise InjectedDeviceError("the upload never returned")

    def no_host(plan, verifier=None):
        raise AssertionError("the pipeline completed a window on the host on the card")

    monkeypatch.setattr(planner, "pack_device", hung_pack)
    monkeypatch.setattr(planner, "_execute_host", no_host)
    before = sum(get_verify_metrics().device_fallback._values.values())
    it = planner.WindowPipeline(use_device=True, depth=2).run(iter(specs))
    t0 = time.monotonic()
    try:
        with pytest.raises(brk.DeviceDispatchError) as e:
            next(it)
        waited = time.monotonic() - t0
    finally:
        it.close()
        release.set()
    assert e.value.reason == "timeout"
    assert waited < 30.0  # two deadlines of 0.5 s, with room for a loaded host
    assert len(entered) == 2 and "planner-pack" not in entered  # the try and its retry
    assert brk.get_device_breaker().snapshot()["failures_total"] == 2
    assert sum(get_verify_metrics().device_fallback._values.values()) == before
    assert _no_thread("planner-pack")
