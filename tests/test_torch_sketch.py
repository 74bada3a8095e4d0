"""The port's ``libs/sketch.py`` and ``libs/telemetry.py`` (the spool)
against the reference's on the same inputs.

Every case of ``tests/test_sketch.py`` (``TestSketchAccuracy``,
``TestSketchAlgebra``, ``TestWindowedCounter``, ``TestTelemetrySpool``)
runs once on each package through the ``pkg`` parameter: the reference
test's assertions hold on both. The cross-package cases feed both packages'
sketches the same seeded samples (numpy) and require the same serialized
dicts and the same quantiles, merge a sketch of one package into one of the
other bucket for bucket, and read each package's spool with the other's
``read_spool``.
"""

import json
import math
import random
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.libs import sketch as rsketch
from tendermint_tpu.libs import telemetry as rtelemetry
from tendermint_tpu_torch.libs import sketch as psketch
from tendermint_tpu_torch.libs import telemetry as ptelemetry


def _pkg(name, sk, tel):
    return SimpleNamespace(
        name=name, QuantileSketch=sk.QuantileSketch, WindowedCounter=sk.WindowedCounter,
        DEFAULT_RELATIVE_ACCURACY=sk.DEFAULT_RELATIVE_ACCURACY,
        TelemetrySpool=tel.TelemetrySpool, encode_record=tel.encode_record,
        read_spool=tel.read_spool, spool_segments=tel.spool_segments)


REF = _pkg("reference", rsketch, rtelemetry)
PORT = _pkg("port", psketch, ptelemetry)


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


def exact_percentile(xs, q):
    ordered = sorted(xs)
    rank = max(1, math.ceil(q * len(ordered)))
    return ordered[rank - 1]


def adversarial_distributions():
    rng = random.Random(97)
    return {
        "constant": [0.25] * 500,
        "single-sample": [3.7],
        "two-sample": [1e-6, 1e3],
        "bimodal": [0.001] * 400 + [10.0] * 100,
        "heavy-tail": [rng.paretovariate(1.2) for _ in range(2000)],
        "uniform": [rng.uniform(1e-4, 1.0) for _ in range(1000)],
        "nine-decades": [10.0 ** rng.uniform(-6, 3) for _ in range(1000)],
    }


class TestSketchAccuracy:
    @pytest.mark.parametrize("name,xs",
                             sorted(adversarial_distributions().items()))
    def test_relative_error_bound(self, pkg, name, xs):
        sk = pkg.QuantileSketch()
        sk.extend(xs)
        assert sk.count == len(xs)
        for q in [0.01, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.999, 1.0]:
            est = sk.quantile(q)
            truth = exact_percentile(xs, q)
            assert abs(est - truth) <= sk.alpha * truth + 1e-12, (
                f"{name}: q={q} est={est} exact={truth}"
            )

    def test_order_independence(self, pkg):
        xs = adversarial_distributions()["heavy-tail"]
        a, b = pkg.QuantileSketch(), pkg.QuantileSketch()
        a.extend(xs)
        b.extend(reversed(xs))
        assert a.to_dict()["buckets"] == b.to_dict()["buckets"]
        assert a.p99() == b.p99()

    def test_min_max_clamp_makes_single_sample_exact(self, pkg):
        sk = pkg.QuantileSketch()
        sk.add(3.7)
        assert sk.quantile(0.0) == 3.7
        assert sk.p50() == 3.7
        assert sk.p99() == 3.7

    def test_zero_and_negative_and_nonfinite(self, pkg):
        sk = pkg.QuantileSketch()
        sk.add(0.0)
        sk.add(-5.0)       # clamped: durations cannot be negative
        sk.add(float("nan"))   # skipped
        sk.add(float("inf"))   # skipped
        assert sk.count == 2
        assert sk.p99() == 0.0
        sk.add(1.0)
        assert sk.p50() == 0.0  # rank 2 of [0, 0, 1]
        assert sk.p99() == pytest.approx(1.0, rel=sk.alpha)

    def test_bounded_memory_over_decades(self, pkg):
        sk = pkg.QuantileSketch()
        rng = random.Random(5)
        for _ in range(50_000):
            sk.add(10.0 ** rng.uniform(-6, 3))
        # nine decades of range at alpha=0.01 stays near
        # log_gamma(1e9) ~ 1036 buckets no matter the sample count
        assert sk.bucket_count() < 1200

    def test_quantile_validation(self, pkg):
        sk = pkg.QuantileSketch()
        with pytest.raises(ValueError):
            sk.quantile(1.5)
        with pytest.raises(ValueError):
            pkg.QuantileSketch(alpha=1.0)
        assert sk.quantile(0.5) == 0.0  # empty


class TestSketchAlgebra:
    def _parts(self, pkg):
        rng = random.Random(11)
        parts = []
        for mu in (0.01, 1.0, 50.0):
            sk = pkg.QuantileSketch()
            sk.extend(rng.lognormvariate(math.log(mu), 1.0)
                      for _ in range(500))
            parts.append(sk)
        return parts

    @staticmethod
    def _key(sk):
        d = sk.to_dict()
        return (d["count"], d["zero"], d["min"], d["max"],
                tuple(map(tuple, d["buckets"])))

    def test_merge_commutative_and_associative_bit_exact(self, pkg):
        a, b, c = self._parts(pkg)
        ab_c = pkg.QuantileSketch.merged([a, b])
        ab_c.merge(c)
        a_bc = pkg.QuantileSketch.merged([b, c])
        a_bc.merge(a)
        c_b_a = pkg.QuantileSketch.merged([c, b, a])
        assert self._key(ab_c) == self._key(a_bc) == self._key(c_b_a)
        # the merged sketch equals one sketch fed every sample directly
        # (bucket-exact: merging IS bucket-wise addition)
        rng = random.Random(11)
        direct = pkg.QuantileSketch()
        for mu in (0.01, 1.0, 50.0):
            direct.extend(rng.lognormvariate(math.log(mu), 1.0)
                          for _ in range(500))
        assert self._key(direct) == self._key(ab_c)

    def test_merge_alpha_mismatch_refused(self, pkg):
        with pytest.raises(ValueError):
            pkg.QuantileSketch(0.01).merge(pkg.QuantileSketch(0.02))

    def test_merged_of_nothing(self, pkg):
        sk = pkg.QuantileSketch.merged([])
        assert sk.count == 0
        assert sk.alpha == pkg.DEFAULT_RELATIVE_ACCURACY

    def test_serde_roundtrip(self, pkg):
        for xs in adversarial_distributions().values():
            sk = pkg.QuantileSketch()
            sk.extend(xs)
            d = json.loads(json.dumps(sk.to_dict(), sort_keys=True))
            back = pkg.QuantileSketch.from_dict(d)
            assert self._key(back) == self._key(sk)
            assert back.sum == sk.sum
            assert back.p99() == sk.p99()
        with pytest.raises(ValueError):
            pkg.QuantileSketch.from_dict({"kind": "histogram"})


class TestWindowedCounter:
    def test_observe_merge_evict(self, pkg):
        wc = pkg.WindowedCounter(window=10.0, max_windows=3)
        for pos in (1, 11, 21, 5, 15):
            wc.observe(pos)
        assert wc.total == 5
        assert wc.evicted == 0
        assert wc.windows() == [(0, 2), (1, 2), (2, 1)]
        wc.observe(35)  # fourth window: oldest (2 events) evicts
        assert wc.evicted == 2
        assert wc.total == 4
        other = pkg.WindowedCounter(window=10.0, max_windows=3)
        other.observe(21, count=7)
        wc.merge(other)
        assert wc.total == 11
        d = pkg.WindowedCounter.from_dict(
            json.loads(json.dumps(wc.to_dict())))
        assert d.windows() == wc.windows()
        assert d.evicted == wc.evicted
        with pytest.raises(ValueError):
            wc.merge(pkg.WindowedCounter(window=5.0))
        with pytest.raises(ValueError):
            pkg.WindowedCounter(window=0.0)


class TestTelemetrySpool:
    def _spool(self, pkg, tmp_path, **kw):
        kw.setdefault("interval_seconds", 0.0)
        kw.setdefault("interval_heights", 0)
        return pkg.TelemetrySpool(str(tmp_path / "spool"), node_id="n0", **kw)

    def test_flush_and_read_roundtrip(self, pkg, tmp_path):
        sp = self._spool(pkg, tmp_path)
        sp.set_source("stats", lambda: {"height": 7})
        for _ in range(5):
            sp.flush()
        sp.stop()  # appends the shutdown snapshot
        out = pkg.read_spool(str(tmp_path / "spool"))
        assert out["corrupt_frames"] == 0
        assert len(out["snapshots"]) == 6
        assert [s["seq"] for s in out["snapshots"]] == list(range(6))
        assert out["snapshots"][0]["stats"] == {"height": 7}
        assert out["snapshots"][-1]["reason"] == "shutdown"

    def test_torn_tail_recovery(self, pkg, tmp_path):
        path = str(tmp_path / "spool")
        sp = self._spool(pkg, tmp_path)
        for _ in range(3):
            sp.flush()
        sp.kill()  # crash: no shutdown snapshot
        before = pkg.read_spool(path)
        assert len(before["snapshots"]) == 3
        # tear: half a frame, as a kill mid-write leaves it
        with open(path, "ab") as f:
            f.write(pkg.encode_record(b'{"torn":true}\n')[:7])
        torn = pkg.read_spool(path)
        assert len(torn["snapshots"]) == 3  # tail tolerated silently
        assert torn["corrupt_frames"] == 0
        # reopen truncates the tear; appends land readable
        sp2 = self._spool(pkg, tmp_path)
        assert sp2.status()["recovered_bytes"] == 7
        sp2.flush()
        sp2.stop()
        after = pkg.read_spool(path)
        assert after["corrupt_frames"] == 0
        assert len(after["snapshots"]) == 5
        assert after["snapshots"][:3] == before["snapshots"]

    def test_mid_file_corruption_counted(self, pkg, tmp_path):
        path = str(tmp_path / "spool")
        sp = self._spool(pkg, tmp_path)
        for _ in range(2):
            sp.flush()
        sp.kill()
        # flip a payload byte inside the FIRST frame: framing desyncs,
        # so everything after it is unreadable and counted corrupt
        data = bytearray(open(path, "rb").read())
        data[10] ^= 0xFF
        open(path, "wb").write(bytes(data))
        out = pkg.read_spool(path)
        assert out["snapshots"] == []
        assert out["corrupt_frames"] == 1

    def test_rotation_spans_segments(self, pkg, tmp_path):
        path = str(tmp_path / "spool")
        sp = self._spool(pkg, tmp_path, head_size_limit=256,
                         total_size_limit=1 << 20)
        sp.set_source("pad", lambda: "x" * 64)
        for _ in range(10):
            sp.flush()
        sp.stop()
        segs = pkg.spool_segments(path)
        assert len(segs) > 1
        out = pkg.read_spool(path)
        assert out["segments"] == len(segs)
        assert out["corrupt_frames"] == 0
        assert len(out["snapshots"]) == 11
        assert [s["seq"] for s in out["snapshots"]] == list(range(11))

    def test_snapshot_single_lock_contract(self, pkg, tmp_path):
        sp = self._spool(pkg, tmp_path, ring_capacity=4)
        for _ in range(6):
            sp.flush()
        snap = sp.snapshot()
        assert snap["total_records"] == 4  # ring capacity
        assert snap["ring_evicted"] > 0
        assert not snap["truncated"]
        limited = sp.snapshot(limit=2)
        assert len(limited["records"]) == 2
        assert limited["truncated"]
        assert limited["total_records"] == 4
        assert sp.snapshot(limit=0)["records"] == []
        assert sp.reset(capacity=8) == {"ring_capacity": 8}
        assert sp.snapshot()["total_records"] == 0
        with pytest.raises(ValueError):
            sp.reset(capacity=0)
        sp.stop()
        # reset touched the ring only — the disk spool kept everything
        assert len(pkg.read_spool(sp.path)["snapshots"]) == 7

    def test_source_failure_isolated(self, pkg, tmp_path):
        sp = self._spool(pkg, tmp_path)
        sp.set_source("good", lambda: 1)
        sp.set_source("bad", lambda: 1 / 0)
        snap = sp.flush()
        assert snap["good"] == 1
        assert snap["bad"] is None
        assert sp.status()["source_errors"] == 1
        sp.stop()

    def test_height_trigger(self, pkg, tmp_path):
        h = {"v": 0}
        sp = self._spool(pkg, tmp_path, interval_heights=5,
                         height_fn=lambda: h["v"])
        assert sp.maybe_flush() is None
        h["v"] = 5
        snap = sp.maybe_flush()
        assert snap is not None and snap["reason"] == "heights"
        assert sp.maybe_flush() is None  # interval restarts at 5
        sp.kill()


# -- across the packages ----------------------------------------------------------


def _samples(seed, n=3000):
    rng = np.random.default_rng(seed)
    return [float(x) for x in np.concatenate([
        rng.lognormal(np.log(0.02), 1.5, n),
        10.0 ** rng.uniform(-7, 3, n // 3),
        np.zeros(7), -rng.uniform(0, 1, 5),
    ])]


class TestAcrossPackages:
    def test_same_samples_same_sketch(self):
        xs = _samples(21)
        r, p = rsketch.QuantileSketch(), psketch.QuantileSketch()
        r.extend(xs)
        p.extend(xs)
        assert json.dumps(r.to_dict(), sort_keys=True) == json.dumps(p.to_dict(), sort_keys=True)
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert r.quantile(q) == p.quantile(q)

    @pytest.mark.parametrize("alpha", [0.01, 0.005, 0.05])
    def test_merge_across_packages_is_exact(self, alpha):
        a, b = _samples(3), _samples(4)
        ra, pb = rsketch.QuantileSketch(alpha), psketch.QuantileSketch(alpha)
        ra.extend(a)
        pb.extend(b)
        direct = rsketch.QuantileSketch(alpha)
        direct.extend(a + b)
        into_ref = rsketch.QuantileSketch.from_dict(ra.to_dict())
        into_ref.merge(pb)
        into_port = psketch.QuantileSketch.from_dict(pb.to_dict())
        into_port.merge(ra)
        want = direct.to_dict()
        for got in (into_ref.to_dict(), into_port.to_dict()):
            assert got["buckets"] == want["buckets"]
            assert (got["count"], got["zero"], got["min"], got["max"]) == \
                (want["count"], want["zero"], want["min"], want["max"])
        assert into_ref.p99() == into_port.p99() == direct.p99()

    def test_windowed_counter_across_packages(self):
        rng = np.random.default_rng(8)
        r = rsketch.WindowedCounter(window=7.0, max_windows=40)
        p = psketch.WindowedCounter(window=7.0, max_windows=40)
        for x in rng.uniform(0, 500, 400):
            r.observe(float(x))
            p.observe(float(x))
        assert r.to_dict() == p.to_dict() and r.evicted > 0
        other = rsketch.WindowedCounter(window=7.0, max_windows=40)
        for x in rng.uniform(200, 600, 300):
            other.observe(float(x))
        r.merge(other)
        p.merge(psketch.WindowedCounter.from_dict(other.to_dict()))
        assert r.to_dict() == p.to_dict()
        assert r.total + r.evicted == 700

    @pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                             ids=["reference-to-port", "port-to-reference"])
    def test_spool_read_by_the_other_package(self, tmp_path, writer, reader):
        path = str(tmp_path / "spool")
        sp = writer.TelemetrySpool(path, node_id="n0", interval_seconds=0.0,
                                   interval_heights=0, head_size_limit=300)
        sk = writer.QuantileSketch()
        sk.extend(_samples(5, 200))
        sp.set_source("sketch", sk.to_dict)
        for _ in range(4):
            sp.flush()
        sp.kill()
        with open(path, "ab") as f:
            f.write(writer.encode_record(b'{"torn":true}\n')[:9])
        got, want = reader.read_spool(path), writer.read_spool(path)
        assert got == want and got["corrupt_frames"] == 0 and len(got["snapshots"]) == 4
        assert reader.spool_segments(path) == writer.spool_segments(path)
        back = reader.QuantileSketch.from_dict(got["snapshots"][-1]["sketch"])
        assert back.to_dict() == sk.to_dict()
        assert reader.encode_record(b"abc") == writer.encode_record(b"abc")
