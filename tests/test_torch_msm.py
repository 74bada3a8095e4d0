"""The port's one-MSM-per-window path (tendermint_tpu_torch/ops/ed25519_msm.py,
``ed25519_cuda.rlc_verify_batch`` and the ``ed25519_path="msm"`` routing in
crypto/batch.py, parallel/planner.py and node/verify_root.py) against the
JAX package's (ops/ed25519_msm.py, ``ed25519_verify.rlc_verify_batch``).

Exact throughout: schedules, digits, seeds and draws are integers, and so
are the verdicts. The host schedule is held against the reference's numpy
functions; K4's plain version (``msm_ref``) against big-integer sums; the
whole path against the reference's XLA ``rlc_verify_batch`` in two calls
and its ``_msm_kernel`` in one (each XLA MSM call traces for about 10 s on
a CPU, so the rest compares with the reference's numpy and host code).
The process-wide path default is reset around every test."""

import random

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as red
from tendermint_tpu.ops import ed25519_msm as rm
from tendermint_tpu.ops import ed25519_verify as rxla
from tendermint_tpu.parallel import planner as jplanner
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import Registry, VerifyMetrics, get_verify_metrics
from tendermint_tpu_torch.libs.profile import Profiler
from tendermint_tpu_torch.node.verify_root import configure_verify, reset_verify
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import ed25519_msm as tm
from tendermint_tpu_torch.ops import fe
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.testutil import commit as tc

from tests.test_msm_path import _adversarial_window, _corpus, _np_batch

SEED = 1234
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on small tensors, where torch's thread pool
    buys nothing and crowds the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """The path default is process-global in both packages: every test
    starts from "ladder" with no environment override, and the guard runs
    unsupervised (the plain versions on a loaded CPU can outlast the
    default deadline)."""
    monkeypatch.delenv("TM_ED25519_PATH", raising=False)
    tbatch.set_default_ed25519_path(None)
    jbatch.set_default_ed25519_path(None)
    brk.reset_device_guard()
    brk.configure_device_guard(dispatch_deadline=0)
    planner.set_device_executor(planner.device_executor("cpu"))
    yield
    planner.set_device_executor(None)
    tbatch.set_default_ed25519_path(None)
    jbatch.set_default_ed25519_path(None)
    brk.reset_device_guard()


@pytest.fixture()
def msm_default():
    tbatch.set_default_ed25519_path("msm")
    yield


# -- the host schedule ---------------------------------------------------------------


def _scalars(m, seed, bits=253):
    rng = random.Random(seed)
    return [rng.getrandbits(bits) for _ in range(m)]


# m on both sides of every bucket-width threshold
THRESHOLDS = [1, 31, 32, 127, 128, 511, 512, 2047, 2048]


@pytest.mark.parametrize("m", THRESHOLDS)
def test_digit_matrix_bucket_c_and_schedule_equal_the_reference(m):
    c = tm._bucket_c(m)
    assert c == rm._bucket_c(m)
    nwin = (253 + c - 1) // c
    scalars = _scalars(m, m)
    digits = tm._digit_matrix(scalars, c, nwin)
    assert np.array_equal(digits, rm._digit_matrix(scalars, c, nwin))
    _assert_schedules_equal(digits, c)


def _assert_schedules_equal(digits, c):
    m = digits.shape[0]
    pool_rows = tm._pad_width(m + 1)
    assert pool_rows == rm._pad_width(m + 1)
    got = tm._build_schedule(digits, pool_rows, c)
    want = rm._build_schedule(digits, pool_rows, c)
    assert (got.c, got.nwin) == (want.c, want.nwin)
    assert len(got.ias) == len(want.ias) and len(got.ibs) == len(want.ibs)
    for a, b in zip(got.ias + got.ibs, want.ias + want.ibs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.bkt.dtype == want.bkt.dtype and np.array_equal(got.bkt, want.bkt)
    return got


def _edge_digits(case):
    c, nwin = 4, 3
    d = np.zeros((7, nwin), np.uint32)
    if case == "single_member_buckets":
        d[np.arange(7), np.arange(7) % nwin] = np.arange(1, 8)
    elif case == "odd_leftover":
        d[:5, 0] = 9  # one bucket of 5 members: pairs, then a leftover
        d[5:, 1] = 3
    elif case == "all_zero":
        pass
    elif case == "some_zero_rows":
        d[::2] = np.arange(1, 4, dtype=np.uint32)
    return d, c


@pytest.mark.parametrize("case", ["single_member_buckets", "odd_leftover", "all_zero",
                                  "some_zero_rows"])
def test_schedule_edge_cases_equal_the_reference(case):
    digits, c = _edge_digits(case)
    sched = _assert_schedules_equal(digits, c)
    if case == "all_zero":
        assert sched.ias == [] and not sched.bkt.any()
    if case == "odd_leftover":
        assert any((a[1:] != 0).any() and (b == 0)[1:][a[1:] != 0].any()
                   for a, b in zip(sched.ias, sched.ibs))


@pytest.mark.parametrize("x", [0, 1, 7, 8, 9, 1000, 1024, 1025, 20001, 99999])
def test_pad_width_equals_the_reference(x):
    assert tm._pad_width(x) == rm._pad_width(x)


def test_rlc_seed_equals_the_reference():
    pubs, msgs, sigs, _ = _adversarial_window(tag=20)
    p, s = _np_batch(pubs, sigs)
    assert ec.rlc_seed(p, s) == rxla.rlc_seed(p, s)


def _parsed_both(items):
    """The same rows parsed by each package (h on the host)."""
    want, want_out = red._parse_batch(items)
    got, got_out = ted._parse_batch(items)
    assert got_out == want_out
    assert [(i, na, nr, h, s) for (i, na, nr, h, s) in got] == \
        [(i, na, nr, h, s) for (i, na, nr, h, s) in want]
    return got, want


def _limb_values(pool, to_int):
    return [[to_int(row[k]) for k in range(4)] for row in pool]


def test_device_rlc_inputs_equal_the_reference(monkeypatch):
    """The reference's _device_rlc with its XLA kernel replaced by a
    recorder, and the port's rlc_inputs, on the same rows and seed: the z
    draws come in the same order, so the schedule, s_b's digits and the
    pool's values are equal."""
    pubs, msgs, sigs, _ = _adversarial_window(tag=21)
    got_rows, want_rows = _parsed_both(list(zip(pubs, msgs, sigs)))
    seen = {}

    def recorder(fe_backend, carry_mode):
        def run(pool, ias, ibs, bkt, sb_digs):
            seen.update(pool=np.asarray(pool), ias=[np.asarray(a) for a in ias],
                        ibs=[np.asarray(b) for b in ibs], bkt=np.asarray(bkt),
                        sb=np.asarray(sb_digs))
            return True
        return run

    monkeypatch.setattr(rm, "_compiled_msm", recorder)
    rng_ref, rng = random.Random(SEED), random.Random(SEED)
    assert rm._device_rlc([r[1:] for r in want_rows], rng_ref, "vpu", "lazy")
    sched, pool, sb = tm.rlc_inputs([r[1:] for r in got_rows], rng)
    assert rng.getstate() == rng_ref.getstate()  # the same number of draws
    assert np.array_equal(sb, seen["sb"])
    assert np.array_equal(sched.bkt, seen["bkt"])
    for a, b in zip(sched.ias + sched.ibs, seen["ias"] + seen["ibs"]):
        assert np.array_equal(a, b)
    assert pool.shape[:2] == seen["pool"].shape[:2]
    assert _limb_values(pool, fe.limbs_to_int) == _limb_values(seen["pool"], rxla.limbs_to_int)


class _Draws(random.Random):
    """A seeded Random that records every draw."""

    log: list = []

    def getrandbits(self, k):
        v = super().getrandbits(k)
        type(self).log.append(v)
        return v


def _signed_items(n, seed, bad=()):
    rng = np.random.default_rng(4000 + seed)
    items = []
    for j in range(n):
        priv = ted.gen_privkey(rng.bytes(32))
        msg = b"msm-%d-%d" % (seed, j)
        sig = bytearray(ted.sign(priv, msg))
        if j in bad:
            sig[40] ^= 1
        items.append((priv[32:], msg, bytes(sig)))
    return items


@pytest.mark.parametrize("bad", [(0, 31, 33, 64, 74), (0, 74)])
def test_rejected_window_draw_path_equals_the_reference(monkeypatch, bad):
    """A rejected window (both device verdicts forced False): the same
    verdicts and the same coefficient draws as the reference's, the
    window's and then one a row of every chunk of more than 4 rows. The
    port sends every row to the ladder in one call and runs a chunk's RLC
    only where the ladder rejects one of its rows; the reference sends its
    dirty chunks' rows. With (0, 74) the middle chunk is clean: the port
    only draws its coefficients, and the last chunk's RLC still draws the
    reference's."""
    items = _signed_items(75, 1, bad=set(bad))
    got_rows, want_rows = _parsed_both(items)
    expect = [ted._verify_pure(*it) for it in items]
    monkeypatch.setattr(rm, "_compiled_msm", lambda *a: (lambda *x: False))
    monkeypatch.setattr(tm, "msm", lambda *a: (torch.zeros(1, dtype=torch.int32), None))
    monkeypatch.setattr(random, "Random", _Draws)
    chunk_rlcs = []
    real_holds = tm._chunk_rlc_holds
    monkeypatch.setattr(tm, "_chunk_rlc_holds",
                        lambda chunk, rng: chunk_rlcs.append(chunk[0][0]) or real_holds(chunk, rng))
    runs = []
    for mod, rows, kw in ((rm, want_rows, {}), (tm, got_rows, {"device": "cpu"})):
        _Draws.log = []
        calls = []
        out = [False] * len(items)

        def ladder(idx):
            calls.append(list(idx))
            return np.array([expect[i] for i in idx])

        mod.rlc_resolve(rows, out, ladder, seed=SEED, **kw)
        runs.append((out, calls, list(_Draws.log)))
    (want_out, want_calls, want_draws), (out, calls, draws) = runs
    assert out == want_out == expect and draws == want_draws
    assert len(draws) == 75 + 75  # the window's draws, then those of its three chunks
    dirty_chunks = sorted({i // 32 * 32 for i in bad})
    assert want_calls == [[i for lo in dirty_chunks for i in range(lo, min(lo + 32, 75))]]
    assert calls == [list(range(75))] and chunk_rlcs == dirty_chunks


# -- K4's plain version ---------------------------------------------------------------


def _bigint_sum(rows, seed):
    """sum [k]P + [s_b]B on the host, with the z draws of the MSM."""
    rng = random.Random(seed)
    s_b, pairs = 0, []
    for na, nr, h, s in rows:
        z = rng.getrandbits(128) or 1
        s_b = (s_b + z * s) % ted.L
        pairs += [((z * h) % ted.L, na), (z, nr)]
    return ted.pt_add(ted._msm(pairs), ted._mul_b(s_b))


@pytest.mark.parametrize("forged", [False, True])
def test_msm_ref_final_point_equals_the_bigint_sum(forged):
    items = _signed_items(9, 2, bad={4} if forged else ())
    rows = [r[1:] for r in ted._parse_batch(items)[0]]
    sched, pool, sb = tm.rlc_inputs(rows, random.Random(SEED))
    ok, pt = tm.msm(*tm.device_inputs(sched, pool, sb, CPU))
    X, Y, Z, T = (fe.limbs_to_int(pt[k].tolist()) for k in range(4))
    assert all(0 <= v < ted.P for v in (X, Y, Z, T))  # canonical limbs
    wx, wy, wz, wt = _bigint_sum(rows, SEED)
    P = ted.P
    assert (X * wz - wx * Z) % P == 0 and (Y * wz - wy * Z) % P == 0
    assert (T * Z - X * Y) % P == 0
    assert bool(ok.item()) is (not forged) is ted._is_identity(_bigint_sum(rows, SEED))


def test_msm_ref_verdict_equals_the_reference_kernel():
    """One XLA call: the reference's _msm_kernel and msm_ref on the pool
    and schedule of the same clean rows and seed."""
    pubs, msgs, sigs = _corpus(6, tag=22)
    got_rows, want_rows = _parsed_both(list(zip(pubs, msgs, sigs)))
    want = rm._device_rlc([r[1:] for r in want_rows], random.Random(SEED), "vpu", "lazy")
    sched, pool, sb = tm.rlc_inputs([r[1:] for r in got_rows], random.Random(SEED))
    ok, _ = tm.msm_ref(*tm.device_inputs(sched, pool, sb, CPU))
    assert want is True and bool(ok.item()) is want


def test_msm_wrapper_takes_the_plain_version_only_on_the_cpu():
    ins = tm.device_inputs(*tm.rlc_inputs([r[1:] for r in ted._parse_batch(
        _signed_items(3, 3))[0]], random.Random(1)), CPU)
    before = dict(tm.launches)
    ok, pt = tm.msm(*ins)
    assert ok.tolist() == [1] and pt.shape == (4, fe.NLIMB)
    assert tm.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="several devices"):
        tm.msm(ins[0].to("meta"), *ins[1:])


# -- rlc_verify_batch -----------------------------------------------------------------


def test_adversarial_window_equals_expected_the_ladder_and_the_reference():
    pubs, msgs, sigs, expected = _adversarial_window(tag=4)
    p, s = _np_batch(pubs, sigs)
    got = ec.rlc_verify_batch(p, msgs, s, device="cpu", seed=SEED)
    assert got.dtype == bool and np.array_equal(got, expected)
    assert np.array_equal(got, ec.verify_batch(p, msgs, s, device="cpu"))
    want = rxla.rlc_verify_batch(p, msgs, s, fe_backend="vpu", carry_mode="lazy", seed=SEED)
    assert np.array_equal(got, want)


def test_verdicts_do_not_depend_on_the_seed():
    pubs, msgs, sigs, expected = _adversarial_window(tag=5)
    p, s = _np_batch(pubs, sigs)
    for seed in (SEED, 0xDEADBEEF, None):  # None: the content seed
        assert np.array_equal(ec.rlc_verify_batch(p, msgs, s, device="cpu", seed=seed),
                              expected)


def test_go_edge_window_equals_the_reference_and_go():
    """The Go-edge window at a fixed seed: the port's verdicts equal the
    reference's XLA MSM path's and, row by row, Go's single verify (the
    port's oracle); ROADMAP records no divergence of the MSM path here."""
    pubs, msgs, sigs, fixed = tc.go_edge_window(seed=0)
    p, s = _np_batch(pubs, sigs)
    got = ec.rlc_verify_batch(p, msgs, s, device="cpu", seed=SEED)
    want = rxla.rlc_verify_batch(p, msgs, s, seed=SEED)
    assert np.array_equal(got, want)
    go = [ted._verify_pure(a, m, g) for a, m, g in zip(pubs, msgs, sigs)]
    assert got.tolist() == go
    assert all(got[i] == v for i, v in fixed.items() if v is not None)


def test_clean_batch_is_accepted_by_one_msm(monkeypatch):
    pubs, msgs, sigs = _corpus(12, tag=23)
    p, s = _np_batch(pubs, sigs)
    monkeypatch.setattr(ec, "verify_batch", lambda *a, **k: pytest.fail("ladder ran"))
    assert ec.rlc_verify_batch(p, msgs, s, device="cpu").all()
    assert ec.rlc_verify_batch(p[:0], [], s[:0], device="cpu").shape == (0,)


# -- the path knob ---------------------------------------------------------------------


class TestPathKnob:
    def test_resolution_precedence(self, monkeypatch):
        r = tbatch._resolve_ed25519_path
        assert r(None) == "ladder"
        assert r("msm") == "msm"
        assert r("auto") == "ladder"
        tbatch.set_default_ed25519_path("msm")
        assert r(None) == "msm"
        monkeypatch.setenv("TM_ED25519_PATH", "ladder")
        assert r(None) == "ladder"  # the environment outranks the [verify] value
        assert r("msm") == "msm"  # an explicit value outranks everything

    def test_invalid_path_rejected(self):
        with pytest.raises(ValueError):
            tbatch._resolve_ed25519_path("pippenger")
        tbatch.set_default_ed25519_path("msmm")  # stored unvalidated
        with pytest.raises(ValueError):
            tbatch._resolve_ed25519_path(None)
        with pytest.raises(ValueError):
            tbatch.TorchBatchVerifier(device="cpu")

    def test_config_default_is_ladder(self):
        assert VerifyConfig().ed25519_path == "ladder"
        assert tbatch.TorchBatchVerifier(device="cpu").ed25519_path == "ladder"

    def test_verifier_follows_the_default_and_the_environment(self, monkeypatch):
        tbatch.set_default_ed25519_path("msm")
        assert tbatch.TorchBatchVerifier(device="cpu").ed25519_path == "msm"
        monkeypatch.setenv("TM_ED25519_PATH", "ladder")
        assert tbatch.TorchBatchVerifier(device="cpu").ed25519_path == "ladder"


# -- the routes ------------------------------------------------------------------------


def _counting(monkeypatch):
    calls = {"rlc": 0, "ladder": 0}
    for name, key in (("rlc_verify_batch", "rlc"), ("verify_batch", "ladder")):
        real = getattr(ec, name)

        def wrap(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ec, name, wrap)
    return calls


def test_torch_verifier_routes_msm_and_records_the_path(monkeypatch):
    pubs, msgs, sigs, expected = _adversarial_window(tag=6)
    calls = _counting(monkeypatch)
    v = tbatch.TorchBatchVerifier(device="cpu", ed25519_path="msm")
    assert np.array_equal(v.verify_ed25519_raw(pubs, msgs, sigs), expected)
    assert calls == {"rlc": 1, "ladder": 1}  # the ladder on the localized rows
    assert 'ed25519_path="msm"' in get_verify_metrics().registry.expose_text()
    guarded = tbatch.GuardedBatchVerifier(v, audit_rate=1.0)
    assert np.array_equal(guarded.verify_ed25519_raw(pubs, msgs, sigs), expected)
    assert brk.get_device_breaker().state == brk.CLOSED


class TestPlannerMsm:
    """The device route through one MSM: verdicts equal the reference's
    per-vote host route on the same windows, exactly."""

    def _run(self, votes, powers, totals):
        got = planner.verify_window(votes, powers, totals, use_device=True)
        want = jplanner.verify_window(votes, powers, totals,
                                      verifier=jbatch.HostBatchVerifier(), use_device=False)
        assert got.tally.dtype == np.int64
        for k in ("ok", "tally", "committed", "sigs_ok"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
        return got

    def test_ragged_window_parity(self, msm_default, monkeypatch):
        from tests.test_planner import _ragged_window

        calls = _counting(monkeypatch)
        votes, powers, totals = _ragged_window(
            [3, 5, 8], absent={(1, 4)}, forged={(2, 2)}, malformed={(0, 1)}, tag=40)
        got = self._run(votes, powers, totals)
        assert not got.ok[2, 2] and got.ok[2, 1]
        # the forged bit lies in R, which this seed leaves undecompressable:
        # the host parse rejects it, and the MSM over the rest accepts
        assert calls == {"rlc": 1, "ladder": 0}

    def test_clean_window_parity(self, msm_default):
        from tests.test_planner import _ragged_window

        votes, powers, totals = _ragged_window([4, 12], tag=41)
        assert self._run(votes, powers, totals).committed.all()

    def test_mixed_keys_take_the_verifier_route(self, msm_default):
        from tests.test_torch_planner import _mixed_window

        tvotes, jvotes, powers, totals = _mixed_window()
        got = planner.verify_window(tvotes, powers, totals, use_device=True,
                                    verifier=tbatch.TorchBatchVerifier("cpu"))
        want = jplanner.verify_window(jvotes, powers, totals,
                                      verifier=jbatch.HostBatchVerifier(), use_device=False)
        for k in ("ok", "tally", "committed", "sigs_ok"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
        assert got.committed.tolist() == [True, True, False]

    def test_quarantined_device_still_exact(self, msm_default):
        from tests.test_planner import _ragged_window

        brk.get_device_breaker().quarantine("audit_mismatch:test")
        votes, powers, totals = _ragged_window([6], forged={(0, 3)}, tag=42)
        got = planner.verify_window(votes, powers, totals, use_device=True,
                                    verifier=tbatch.HostBatchVerifier())
        want = jplanner.verify_window(votes, powers, totals,
                                      verifier=jbatch.HostBatchVerifier(), use_device=False)
        assert np.array_equal(got.ok, want.ok) and not got.ok[0, 3]

    def test_msm_dispatch_is_labelled(self, msm_default):
        from tests.test_planner import _ragged_window

        prof = planner.get_profiler()
        votes, powers, totals = _ragged_window([4], tag=43)
        with prof.window(1, 1):
            planner.verify_window(votes, powers, totals, use_device=True)
        rows = prof.ledger()
        assert rows[-1]["ed25519_paths"] == ["msm"]
        with pytest.raises(NotImplementedError, match=r"item 4b \(iii\)"):
            planner.device_executor("cpu")(planner.plan_window(votes, powers, totals),
                                           mesh=object())


class TestObservability:
    def test_dispatch_counter_label(self):
        vm = VerifyMetrics(Registry())
        vm.record_dispatch("planner_msm", "ed25519", 16, 0.01, fe_backend="vpu",
                           carry_mode="lazy", ed25519_path="msm")
        vm.record_dispatch("cuda", "ed25519", 16, 0.01, fe_backend="vpu", carry_mode="lazy")
        text = vm.registry.expose_text()
        assert 'ed25519_path="msm"' in text
        assert 'ed25519_path="ladder"' in text  # unlabelled dispatches are the ladder's

    def test_profiler_ledger_paths(self):
        prof = Profiler()
        with prof.window(100, 2):
            for _ in range(2):
                prof.record("planner_msm", fe_backend="vpu", carry_mode="lazy",
                            ed25519_path="msm", lanes_present=16, lanes_dispatched=16,
                            run_seconds=0.01)
        rows = prof.ledger()
        assert rows and rows[-1]["ed25519_paths"] == ["msm"]


def test_configure_verify_installs_the_msm_path():
    try:
        root = configure_verify(VerifyConfig(ed25519_path="msm", dispatch_deadline=0),
                                device="cpu")
        assert root.verifier.device.ed25519_path == "msm"
        assert tbatch._resolve_ed25519_path(None) == "msm"
        pubs, msgs, sigs, expected = _adversarial_window(tag=7)
        assert np.array_equal(root.verifier.verify_ed25519_raw(pubs, msgs, sigs), expected)
    finally:
        reset_verify()
    assert tbatch._resolve_ed25519_path(None) == "ladder"

