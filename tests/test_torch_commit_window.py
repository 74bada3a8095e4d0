"""The port's commit window (tendermint_tpu_torch/parallel/commit_verify.py)
against the JAX package's (parallel/commit_verify.py): the same seeded
votes through both. ``present``, the int64 powers and the raw columns of
``pack_commit_window`` must be equal; ``verify_commit_window`` on the CPU
(K1's and K2's plain versions, the tally in torch int64, or one MSM) must
give the reference's ok, tally and committed, exactly, as the reference's
host completion ``_verify_window_host`` computes them (it equals the
reference's device step by the reference's own tests). The guard cases
restate the reference's, off the card and, with a faked CUDA device, on
it, where a failed dispatch raises instead of completing on the host."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as red
from tendermint_tpu.libs import breaker as jbrk
from tendermint_tpu.parallel import commit_verify as jcv
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.parallel import commit_verify as cv

from tests.test_planner import _ragged_window, _signed

CARD = torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both packages' guards and path defaults are process-global: reset
    them around every test, and run the port's dispatch unsupervised (the
    plain versions on a loaded CPU can outlast the default deadline)."""
    monkeypatch.delenv("TM_ED25519_PATH", raising=False)
    for b in (tbatch, jbatch):
        b.set_default_ed25519_path(None)
    jbrk.reset_device_guard()
    brk.reset_device_guard()
    brk.configure_device_guard(dispatch_deadline=0)
    yield
    for b in (tbatch, jbatch):
        b.set_default_ed25519_path(None)
    jbrk.reset_device_guard()
    brk.reset_device_guard()


def _grid_window(H, V):
    """tests/test_parallel.py's window: every 7th vote absent, every 7th
    from the fifth forged (a bit of R), powers v + 1."""
    triples = _signed(H * V)
    votes, powers = [], []
    for h in range(H):
        vrow, prow = [], []
        for v in range(V):
            pub, msg, sig = triples[h * V + v]
            if (h * V + v) % 7 == 3:
                vrow.append(None)
            elif (h * V + v) % 7 == 5:
                bad = bytearray(sig)
                bad[3] ^= 1
                vrow.append((pub, msg, bytes(bad)))
            else:
                vrow.append((pub, msg, sig))
            prow.append(v + 1)
        votes.append(vrow)
        powers.append(prow)
    return votes, powers


def _both(votes, powers):
    return cv.pack_commit_window(votes, powers), jcv.pack_commit_window(votes, powers)


def _assert_verdict(got, want):
    ok, tally, committed = got
    assert ok.dtype == bool and tally.dtype == np.int64 and committed.dtype == bool
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# -- pack_commit_window ----------------------------------------------------------------


def test_pack_equals_the_reference_on_present_power_and_raw():
    votes, powers = _grid_window(3, 5)
    votes[1][2] = (votes[1][2][0], votes[1][2][1], votes[1][2][2][:63])  # wrong length
    win, jwin = _both(votes, powers)
    assert win.shape == jwin.shape == (3, 5)
    assert np.array_equal(win.present, jwin.present)
    assert win.power.dtype == np.int64 and np.array_equal(win.power, jwin.power)
    assert np.array_equal(win.raw[0], jwin.raw[0])
    for a, b in zip(win.raw[1:], jwin.raw[1:]):
        assert a == b
    # the port's own columns: the K1 + K2 inputs of every present cell
    hs, vs = np.nonzero(win.present)
    for h, v in zip(hs, vs):
        pub, msg, sig = votes[h][v]
        na, ay = ec._decompress_neg_cached(pub)
        assert win.neg_ax[h, v].tolist() == na and win.ay[h, v].tolist() == ay
        assert win.pub_bytes[h, v].tobytes() == pub and win.sig_bytes[h, v].tobytes() == sig
        assert win.msg_bytes[h, v, : win.msg_len[h, v]].tobytes() == msg


class TestPackCommitWindowVectorized:
    def test_power_scatter_matches_validity(self):
        """Power lands only on lanes that pass the host prechecks, an
        undecompressable key and a set top bit of s included."""
        votes, powers, _ = _ragged_window([4, 4], tag=60)
        votes[0][1] = None  # absent: power 0
        pub, msg, sig = votes[1][2]
        bad_pub = next(bytes([b]) + bytes(31) for b in range(256)
                       if ted._decompress_xy(bytes([b]) + bytes(31)) is None)
        votes[1][2] = (bad_pub, msg, sig)
        pub, msg, sig = votes[0][3]
        votes[0][3] = (pub, msg, sig[:63] + bytes([sig[63] | 0xE0]))
        win, jwin = _both(votes, powers)
        want_power = np.asarray(powers, dtype=np.int64)
        for h, v in ((0, 1), (1, 2), (0, 3)):
            want_power[h, v] = 0
            assert not win.present[h, v]
        assert np.array_equal(win.power, want_power)
        assert np.array_equal(win.power, jwin.power)
        assert np.array_equal(win.present, jwin.present)


# -- the K8 step -------------------------------------------------------------------------


class TestCommitWindow:
    def test_unsharded(self):
        votes, powers = _grid_window(3, 5)
        win, jwin = _both(votes, powers)
        total = sum(powers[0])
        got = cv.verify_commit_window(win, total, device="cpu")
        _assert_verdict(got, jcv._verify_window_host(jwin, total))
        ok, tally, committed = got
        want = np.zeros((3, 5), bool)
        for h in range(3):
            for v in range(5):
                want[h, v] = votes[h][v] is not None and (h * 5 + v) % 7 != 5
        assert np.array_equal(ok, want)
        assert np.array_equal(tally, (want * win.power).sum(axis=1))

    @pytest.mark.parametrize("power", [3_000_000_000, (1 << 58) + 3])
    def test_int64_powers_do_not_wrap(self, power):
        """Powers past 2^31, up to a total near the reference's 2^60 cap on
        the total voting power, tally exactly on the device (int32 would
        wrap every one of them)."""
        votes = [list(_signed(3, tag=9))]
        powers = [[power] * 3]
        win, jwin = _both(votes, powers)
        got = cv.verify_commit_window(win, total_power=3 * power, device="cpu")
        _assert_verdict(got, jcv._verify_window_host(jwin, 3 * power))
        ok, tally, committed = got
        assert ok.all() and tally.tolist() == [3 * power] and committed.tolist() == [True]
        torch_tally, _ = cv.window_tally(torch.ones((1, 3), dtype=torch.bool),
                                         torch.full((1, 3), power, dtype=torch.int64),
                                         3 * power)
        assert torch_tally.dtype == torch.int64 and torch_tally.tolist() == [3 * power]

    def test_two_message_lengths_and_an_empty_row(self):
        votes, powers, totals = _ragged_window([3, 0, 4], forged={(2, 1)}, tag=61)
        msg = votes[0][0][1]
        # a vote with a longer message: its own K1 + K2 group
        priv = ted.gen_privkey(np.random.default_rng(3).bytes(32))
        long_msg = msg + b"-and-more"
        votes[0][0] = (priv[32:], long_msg, ted.sign(priv, long_msg))
        win, jwin = _both(votes, powers)
        _assert_verdict(cv.verify_commit_window(win, max(totals), device="cpu"),
                        jcv._verify_window_host(jwin, max(totals)))
        assert len(set(win.msg_len[win.present].tolist())) == 2

    def test_window_without_raw_dispatches_unguarded(self, monkeypatch):
        votes, powers = _grid_window(2, 3)
        win, jwin = _both(votes, powers)
        want = jcv._verify_window_host(jwin, 6)
        win.raw = None
        brk.get_device_breaker().quarantine("audit_mismatch:test")  # not consulted
        _assert_verdict(cv.verify_commit_window(win, 6, device="cpu"), want)

    def test_a_mesh_raises(self):
        win, _ = _both(*_grid_window(1, 2))
        with pytest.raises(NotImplementedError, match=r"item 4b \(iii\)"):
            cv.verify_commit_window(win, 3, mesh=object(), device="cpu")

    def test_no_device_and_no_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device resolves")
        win, _ = _both(*_grid_window(1, 2))
        with pytest.raises(NoCudaDeviceError):
            cv.verify_commit_window(win, 3)


class TestCommitVerifyCompileDetection:
    def test_first_dispatch_keys_on_shape_not_just_mesh(self, monkeypatch):
        firsts = []

        class _Rec:
            def record_dispatch(self, *a, **kw):
                firsts.append(kw.get("first"))

            def record_device_shards(self, *a, **kw):
                pass

        monkeypatch.setattr(cv, "get_verify_metrics", lambda: _Rec())
        monkeypatch.setattr(cv, "_compiled_shapes", set())

        def win(H, V, tag):
            votes, powers, _ = _ragged_window([V] * H, tag=tag)
            return cv.pack_commit_window(votes, powers)

        cv.verify_commit_window(win(2, 3, 50), total_power=100, device="cpu")
        cv.verify_commit_window(win(2, 3, 51), total_power=100, device="cpu")
        cv.verify_commit_window(win(4, 5, 52), total_power=100, device="cpu")  # new shape
        cv.verify_commit_window(win(4, 5, 53), total_power=100, device="cpu")
        assert firsts == [True, False, True, False]

    def test_dispatch_records_the_reference_labels(self):
        prof = get_profiler()
        votes, powers, totals = _ragged_window([3, 3], tag=54)
        win = cv.pack_commit_window(votes, powers)
        with prof.window(1, 2):
            cv.verify_commit_window(win, max(totals), device="cpu")
        row = prof.ledger()[-1]
        assert row["ed25519_paths"] == ["ladder"]
        text = get_verify_metrics().registry.expose_text()
        assert 'backend="window"' in text


# -- the guard -------------------------------------------------------------------------


class InjectedDeviceError(RuntimeError):
    pass


class TestCommitWindowGuard:
    def _win(self, tag):
        votes, powers, totals = _ragged_window([2, 3], tag=tag, forged={(0, 1)})
        win, jwin = _both(votes, powers)
        total = max(totals)
        return win, total, jcv._verify_window_host(jwin, total)

    def test_raising_device_completes_on_host(self, monkeypatch):
        win, total, want = self._win(30)

        def explode(win, total_power, mesh=None, **kw):
            raise InjectedDeviceError("dispatch failed")

        monkeypatch.setattr(cv, "_verify_window_device", explode)
        _assert_verdict(cv.verify_commit_window(win, total, device="cpu"), want)
        assert brk.get_device_breaker().snapshot()["failures_total"] > 0

    def test_corrupting_device_quarantines(self, monkeypatch):
        win, total, want = self._win(31)
        brk.configure_device_guard(audit_sample_rate=1.0, dispatch_deadline=0)

        def corrupt(win, total_power, mesh=None, **kw):
            ok = np.array(want[0], copy=True)
            h, v = np.argwhere(win.present)[0]
            ok[h, v] = not ok[h, v]
            return ok, want[1], want[2]

        monkeypatch.setattr(cv, "_verify_window_device", corrupt)
        _assert_verdict(cv.verify_commit_window(win, total, device="cpu"), want)
        assert brk.get_device_breaker().state == brk.QUARANTINED

    def test_quarantined_breaker_skips_the_device(self, monkeypatch):
        win, total, want = self._win(32)
        brk.get_device_breaker().quarantine("audit_mismatch:test")
        called = {"n": 0}

        def count(win, total_power, mesh=None, **kw):
            called["n"] += 1
            return want

        monkeypatch.setattr(cv, "_verify_window_device", count)
        _assert_verdict(cv.verify_commit_window(win, total, device="cpu"), want)
        assert called["n"] == 0

    def test_on_the_card_a_failed_dispatch_raises(self, monkeypatch):
        """With a CUDA device the guard never answers from the host: a
        failing dispatch, a mis-auditing one and a quarantined breaker each
        raise, and no fallback is counted."""
        win, total, want = self._win(33)
        monkeypatch.setattr(cv, "resolve_device", lambda device: CARD)
        m = get_verify_metrics()
        fallbacks0 = sum(m.device_fallback._values.values())

        def explode(win, total_power, mesh=None, **kw):
            assert kw["device"] == CARD
            raise InjectedDeviceError("kernel crashed")

        monkeypatch.setattr(cv, "_verify_window_device", explode)
        with pytest.raises(brk.DeviceDispatchError) as e:
            cv.verify_commit_window(win, total)
        assert e.value.reason == "error"
        assert isinstance(e.value.__cause__, InjectedDeviceError)
        assert brk.get_device_breaker().snapshot()["failures_total"] == 2  # one retry

        brk.reset_device_guard()
        brk.configure_device_guard(audit_sample_rate=1.0, dispatch_deadline=0)

        def corrupt(win, total_power, mesh=None, **kw):
            return ~want[0], want[1], want[2]

        monkeypatch.setattr(cv, "_verify_window_device", corrupt)
        with pytest.raises(brk.DeviceAuditMismatch):
            cv.verify_commit_window(win, total)
        with pytest.raises(brk.DeviceDispatchError) as e:
            cv.verify_commit_window(win, total)
        assert e.value.reason == "quarantined"
        assert sum(m.device_fallback._values.values()) == fallbacks0
        assert get_profiler().events("device_failure")[-1]["backend"] == "window"


def test_audit_samples_the_reference_lanes(monkeypatch):
    """The same rate, seed and sequence number audit the same lanes."""
    votes, powers, totals = _ragged_window([5, 6, 7], tag=62)
    win, jwin = _both(votes, powers)
    ok = cv._verify_window_host(win, max(totals))[0]
    lanes = {}
    for name, mod, brk_mod, oracle_mod, attr in (
            ("port", cv, brk, ted, "_verify_pure"), ("ref", jcv, jbrk, red, "verify")):
        brk_mod.configure_device_guard(audit_sample_rate=0.3, audit_seed=11)
        monkeypatch.setattr(mod, "_audit_seq", 5)
        seen = []
        real = getattr(oracle_mod, attr)

        def oracle(p, m, s, _real=real, _seen=seen):
            _seen.append(bytes(s))
            return _real(p, m, s)

        monkeypatch.setattr(oracle_mod, attr, oracle)
        assert not mod._audit_window_verdict(win if name == "port" else jwin, ok)
        lanes[name] = seen
    assert lanes["port"] == lanes["ref"] and len(lanes["port"]) == 6  # ceil(0.3 * 17)


# -- the MSM path ------------------------------------------------------------------------


class TestCommitWindowMsm:
    def _window(self, tag, forged=()):
        votes, powers, totals = _ragged_window([8, 8], forged=forged, tag=tag)
        win, jwin = _both(votes, powers)
        # one scalar total_power for every height: the largest keeps every
        # clean height committed
        total = max(totals)
        return win, total, jcv._verify_window_host(jwin, total)

    def test_guarded_msm_matches_host(self, monkeypatch):
        tbatch.set_default_ed25519_path("msm")
        calls = {"n": 0}
        real = ec.rlc_verify_batch

        def counting(*a, **k):
            calls["n"] += 1
            return real(*a, **k)

        monkeypatch.setattr(ec, "rlc_verify_batch", counting)
        win, total, want = self._window(50)
        got = cv.verify_commit_window(win, total, device="cpu")
        _assert_verdict(got, want)
        assert got[0][win.present].all() and got[2].all()
        assert calls["n"] == 1
        assert brk.get_device_breaker().state == brk.CLOSED

    def test_guarded_msm_dirty_window_localizes(self):
        tbatch.set_default_ed25519_path("msm")
        win, total, want = self._window(52, forged={(1, 2)})
        got = cv.verify_commit_window(win, total, device="cpu")
        _assert_verdict(got, want)
        assert not got[0][1, 2]

    def test_quarantine_skips_msm_device(self, monkeypatch):
        tbatch.set_default_ed25519_path("msm")
        win, total, want = self._window(51)
        calls = {"n": 0}
        real = cv._verify_window_device

        def counting(*a, **k):
            calls["n"] += 1
            return real(*a, **k)

        monkeypatch.setattr(cv, "_verify_window_device", counting)
        brk.get_device_breaker().quarantine("audit_mismatch:test")
        _assert_verdict(cv.verify_commit_window(win, total, device="cpu"), want)
        assert calls["n"] == 0, "a quarantined breaker must not dispatch the MSM"
