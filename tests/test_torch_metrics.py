"""The port's verify metrics (tendermint_tpu_torch/libs/metrics.py) against
the reference's: the same sequence of records gives the same exposition —
family names, types, help texts, label sets, buckets and values — and the
same batch through the port's and the reference's host and guarded
verifiers moves the same counters. Also the exposition escaping, the
profiler's ledger fold and the tracer, copied from the reference."""

import numpy as np
import pytest

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.libs import breaker as jbrk
from tendermint_tpu.libs import metrics as jmetrics
from tendermint_tpu.libs import profile as jprofile
from tendermint_tpu.sim.faults import FaultyDevice
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.libs import breaker as tbrk
from tendermint_tpu_torch.libs import metrics as tmetrics
from tendermint_tpu_torch.libs import profile as tprofile
from tendermint_tpu_torch.libs import trace as ttrace

FAMILIES = (
    "calls", "sigs", "rejects", "device_dispatches", "device_fallback",
    "device_retries", "device_audit", "device_lanes", "host_fallback",
    "fe_dispatch", "lanes", "planner_bucket", "speculative", "dispatch_seconds",
    "compile_seconds", "batch_size", "lane_occupancy", "window_heights",
    "device_breaker_state",
)


def _records(m):
    m.record_dispatch("cuda", "ed25519", 10_000, 0.03, rejects=3, first=True,
                      fe_backend="vpu", carry_mode="lazy", ed25519_path="ladder")
    m.record_dispatch("cuda", "ed25519", 10_000, 0.004, fe_backend="mxu16",
                      carry_mode="eager")
    m.record_dispatch("host", "secp256k1", 7, 0.9, rejects=7)
    m.record_dispatch("planner", "ed25519", 32_661, 0.0035, rejects=2,
                      first=True, fe_backend="vpu", carry_mode="lazy",
                      ed25519_path="ladder")
    m.record_planner(32_661, 32_768, compiled=True)
    m.record_planner(41, 64)
    m.record_planner(0, 0)
    m.record_device_shards((0,), 32_768)
    m.record_device_shards([str(i) for i in range(20)], 64)  # past the label cap
    m.device_fallback.add(1.0, ("timeout",))
    m.device_fallback.add(2.0, ("audit_mismatch",))
    m.device_retries.add(1.0)
    m.device_audit.add(1633.0, ("ok",))
    m.device_audit.add(1.0, ("mismatch",))
    m.host_fallback.add(1.0, ("unbatchable_key",))
    m.speculative.add(1.0, ('hit "quoted"\nline',))
    m.window_heights.observe(512.0)
    m.device_breaker_state.set(3.0)


def test_same_records_same_exposition():
    port, ref = tmetrics.VerifyMetrics(), jmetrics.VerifyMetrics()
    assert port.registry.expose_text() == ref.registry.expose_text()
    _records(port)
    _records(ref)
    assert port.registry.expose_text() == ref.registry.expose_text()
    assert port.MAX_DEVICE_LABELS == ref.MAX_DEVICE_LABELS
    assert "overflow" in port.registry.expose_text()


@pytest.mark.parametrize("family", FAMILIES)
def test_family_name_type_help_and_labels(family):
    p, r = getattr(tmetrics.VerifyMetrics(), family), getattr(jmetrics.VerifyMetrics(), family)
    assert (p.name, p.kind, p.help, p.label_names) == (r.name, r.kind, r.help, r.label_names)
    assert p.name.startswith("tendermint_verify_")
    assert getattr(p, "buckets", None) == getattr(r, "buckets", None)


def test_registry_primitives_and_escaping():
    reg_p, reg_r = tmetrics.Registry("x"), jmetrics.Registry("x")
    for reg in (reg_p, reg_r):
        c = reg.counter("c_total", 'help with \\ and\nnewline', ("peer",))
        c.labels('a"b').add(2.5)
        c.labels("z").add(1e16)
        c.remove_matching("peer", "z")
        g = reg.gauge("g", "a gauge")
        g.set(7)
        g.add(0.5)
        h = reg.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0), label_names=("k",))
        h.labels("v").observe(0.05)
        h.labels("v").observe(3.0)
    assert reg_p.expose_text() == reg_r.expose_text()
    assert '\\"' in reg_p.expose_text() and "\\n" in reg_p.expose_text()


def _batch(n=9, forged=(2, 5)):
    rng = np.random.default_rng(31)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        priv = ted.gen_privkey(rng.bytes(32))
        msg = rng.bytes(40)
        sig = bytearray(ted.sign(priv, msg))
        if i in forged:
            sig[3] ^= 4
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(bytes(sig))
    return pubs, msgs, sigs


@pytest.fixture
def fresh_metrics():
    """Fresh process-wide VerifyMetrics in both packages for one test."""
    saved = tmetrics._verify_metrics, jmetrics._verify_metrics
    tmetrics._verify_metrics, jmetrics._verify_metrics = (
        tmetrics.VerifyMetrics(), jmetrics.VerifyMetrics())
    tbrk.reset_device_guard()
    jbrk.reset_device_guard()
    yield tmetrics._verify_metrics, jmetrics._verify_metrics
    tmetrics._verify_metrics, jmetrics._verify_metrics = saved
    tbrk.reset_device_guard()
    jbrk.reset_device_guard()


COUNTERS = ("calls", "sigs", "rejects", "device_fallback", "device_retries",
            "device_audit", "host_fallback")


def _counters(m):
    out = {f: dict(getattr(m, f)._values) for f in COUNTERS}
    out["batch_size"] = {k: (v[0], v[2]) for k, v in m.batch_size._series.items()}
    out["breaker"] = dict(m.device_breaker_state._values)
    return out


def test_host_verifiers_move_the_same_counters(fresh_metrics):
    port_m, ref_m = fresh_metrics
    pubs, msgs, sigs = _batch()
    got = tbatch.HostBatchVerifier().verify_ed25519_raw(pubs, msgs, sigs)
    want = jbatch.HostBatchVerifier().verify_ed25519_raw(pubs, msgs, sigs)
    items_p = [tbatch.SigItem(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    items_r = [jbatch.SigItem(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    got2 = tbatch.HostBatchVerifier().verify_ed25519(items_p)
    want2 = jbatch.HostBatchVerifier().verify_ed25519(items_r)
    assert got.tolist() == want.tolist() == got2.tolist() == want2.tolist()
    assert _counters(port_m) == _counters(ref_m)
    assert port_m.rejects._values == {("host", "ed25519"): 4.0}


@pytest.mark.parametrize("schedule", [["ok"], ["fail", "ok"], ["fail", "fail"], ["corrupt"]])
def test_guarded_verifiers_move_the_same_counters(fresh_metrics, schedule):
    port_m, ref_m = fresh_metrics
    pubs, msgs, sigs = _batch()
    out = []
    for batch_mod, brk in ((tbatch, tbrk), (jbatch, jbrk)):
        dev = FaultyDevice(batch_mod.HostBatchVerifier(), schedule=list(schedule))
        g = batch_mod.GuardedBatchVerifier(dev, audit_rate=0.5, retries=1)
        out.append((g.verify_ed25519_raw(pubs, msgs, sigs).tolist(), g.snapshot(),
                    brk.get_device_breaker().state))
    assert out[0] == out[1]
    assert _counters(port_m) == _counters(ref_m)


def test_profiler_ledger_equals_the_reference():
    port, ref = tprofile.Profiler(capacity=4), jprofile.Profiler(capacity=4)
    for prof in (port, ref):
        with prof.window(100, heights=512):
            prof.record("planner", bucket=(32768, 512), lanes_present=32661,
                        lanes_dispatched=32768, heights=512, pack_seconds=0.1,
                        run_seconds=0.0035, compiled=True, bytes_to_device=1 << 20,
                        fe_backend="vpu", carry_mode="lazy", ed25519_path="ladder")
            prof.record("host", lanes_present=10, heights=512, run_seconds=0.5)
        for i in range(4):
            prof.record("host", lanes_present=i)
    assert port.ledger() == ref.ledger()
    assert port.entries() == ref.entries()
    assert port.dropped == ref.dropped == 2
    port.reset()
    assert port.entries() == [] and port.ledger() == []


def test_tracer_records_spans_when_enabled():
    tr = ttrace.Tracer(capacity=2)
    with tr.span("planner.pack", H=1):
        pass
    assert len(tr) == 0
    tr.enable()
    for i in range(3):
        with tr.span("planner.dispatch", i=i):
            pass
    tr.instant("verify.audit")
    events = [e for e in tr.export() if e["ph"] != "M"]
    assert [e["name"] for e in events] == ["planner.dispatch", "verify.audit"]
    assert tr.dropped() == 2
    assert tr.chrome_trace()["displayTimeUnit"] == "ms"
