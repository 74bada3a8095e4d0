"""The port's critical-path analyzer (``libs/critpath.py``) and the WAL's
per-height costs against the reference's on the same stamps.

Every class of ``tests/test_critpath.py`` but its net tier runs once on
each package through the ``pkg`` parameter (the reference's trace merger
and Chrome-trace validator are its scripts, loaded from the files; the
port's are ``tools/trace_merge.py`` and ``testutil/consensus_net.py``): the
reference test's assertions hold on both. The cross-package cases require
the same waterfall dicts, snapshots and sketches from both analyzers on the
same seeded stamps.

``TestInProcNetReconciliation`` restates the reference's net tier on the
port's 4-node net (``testutil/consensus_net.Net``), whose nodes share one
clock and take a height's messages only once they have entered its round.
The reference's case fails when a node takes a complete proposal straight
from NEW_HEIGHT into prevote (its round-0 timeout not yet fired): that node
never stamps ``on_new_round``, and ``build_waterfall`` makes no waterfall
for a height without a round stamp. ``test_height_entered_without_new_round``
pins that property of the reference's instruments on both packages (the
port's wiring cases are in ``tests/test_torch_instruments.py``). Every
wait is bounded by a deadline.
"""

import json
import os
import random
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.consensus import flight as rflight
from tendermint_tpu.consensus import messages as rmsgs
from tendermint_tpu.consensus import wal as rwal
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.libs import critpath as rcritpath
from tendermint_tpu.libs.metrics import NodeMetrics
from tendermint_tpu.state import state_types as rst
from tendermint_tpu.types import BlockID as RBlockID
from tendermint_tpu.types import SignedMsgType as RSignedMsgType
from tendermint_tpu_torch.consensus import flight as pflight
from tendermint_tpu_torch.consensus import messages as pmsgs
from tendermint_tpu_torch.consensus import wal as pwal
from tendermint_tpu_torch.crypto.batch import HostBatchVerifier, set_batch_verifier
from tendermint_tpu_torch.libs import critpath as pcritpath
from tendermint_tpu_torch.libs.metrics import ConsensusMetrics
from tendermint_tpu_torch.state import state_types as pst
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.testutil import consensus_net
from tendermint_tpu_torch.tools import trace_merge
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType

from tests import consensus_harness as rharness

DEADLINE = 60.0
_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _load_script(name):
    import importlib.util

    if _SCRIPTS not in sys.path:  # scripts import siblings by module name
        sys.path.insert(0, _SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(_SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _pkg(name, flight, cp, wal, msgs, metrics, tm, validate, **kw):
    return SimpleNamespace(
        name=name, FlightRecorder=flight.FlightRecorder, CritPath=cp.CritPath,
        percentile=cp.percentile, verify_seconds_for_height=cp.verify_seconds_for_height,
        build_waterfall=cp.build_waterfall, PHASES=cp.PHASES,
        TIMELINE_PHASES=cp.TIMELINE_PHASES, OVERLAY_PHASES=cp.OVERLAY_PHASES,
        WAL=wal.WAL, NilWAL=wal.NilWAL, EndHeightMessage=msgs.EndHeightMessage,
        Metrics=metrics, trace_merge=tm, validate_chrome_trace=validate, **kw)


REF = _pkg("reference", rflight, rcritpath, rwal, rmsgs, NodeMetrics,
           _load_script("trace_merge"), _load_script("flight_smoke").validate_chrome_trace,
           h=rharness, st=rst, BlockID=RBlockID, SignedMsgType=RSignedMsgType)
PORT = _pkg("port", pflight, pcritpath, pwal, pmsgs, ConsensusMetrics, trace_merge,
            consensus_net.validate_chrome_trace,
            h=harness, st=pst, BlockID=BlockID, SignedMsgType=SignedMsgType)


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


class TestPercentile:
    def test_empty_is_zero(self, pkg):
        assert pkg.percentile([], 50) == 0.0
        assert pkg.percentile([], 99) == 0.0

    def test_single_sample(self, pkg):
        assert pkg.percentile([0.7], 1) == 0.7
        assert pkg.percentile([0.7], 99) == 0.7

    def test_nearest_rank(self, pkg):
        xs = [float(i) for i in range(1, 101)]  # 1..100
        random.Random(3).shuffle(xs)
        assert pkg.percentile(xs, 50) == 50.0
        assert pkg.percentile(xs, 99) == 99.0
        assert pkg.percentile(xs, 100) == 100.0
        # q=0 still returns the smallest sample (rank floor is 1)
        assert pkg.percentile(xs, 0) == 1.0


class TestVerifyJoin:
    def test_exact_height_gets_full_cost(self, pkg):
        entries = [{"height_base": 5, "pack_seconds": 0.1,
                    "run_seconds": 0.2, "heights": 1}]
        assert pkg.verify_seconds_for_height(entries, 5) == pytest.approx(0.3)
        assert pkg.verify_seconds_for_height(entries, 4) == 0.0
        assert pkg.verify_seconds_for_height(entries, 6) == 0.0

    def test_window_amortizes_interior_heights(self, pkg):
        # window [3, 7): base gets full cost (documented imprecision),
        # interior heights get cost/span, heights outside get nothing
        entries = [{"height_base": 3, "run_seconds": 0.4, "heights": 4}]
        assert pkg.verify_seconds_for_height(entries, 3) == pytest.approx(0.4)
        for h in (4, 5, 6):
            assert pkg.verify_seconds_for_height(entries, h) == pytest.approx(0.1)
        assert pkg.verify_seconds_for_height(entries, 7) == 0.0
        assert pkg.verify_seconds_for_height(entries, 2) == 0.0

    def test_unannotated_entries_skipped(self, pkg):
        entries = [
            {"run_seconds": 99.0},  # no window annotation at all
            {"height_base": None, "run_seconds": 99.0},
            {"height_base": 5, "run_seconds": 0.25},  # heights key missing
        ]
        assert pkg.verify_seconds_for_height(entries, 5) == pytest.approx(0.25)

    def test_costs_sum_across_entries(self, pkg):
        entries = [
            {"height_base": 5, "run_seconds": 0.1},
            {"height_base": 5, "pack_seconds": 0.05},
            {"height_base": 4, "heights": 3, "run_seconds": 0.3},
        ]
        assert pkg.verify_seconds_for_height(entries, 5) == pytest.approx(
            0.1 + 0.05 + 0.1
        )


_T0 = 1_000_000_000_000  # ns


def _mk_rec(height=5, t0=_T0, prop=10, parts=30, polka=90, commit=190,
            persist=(190, 5), execspan=(195, 20)):
    """A flight record with millisecond offsets from t0 for each stamp."""
    ms = 1_000_000
    rec = {
        "height": height,
        "rounds": [{"round": 0, "t": t0}],
        "proposal": {"t": t0 + prop * ms, "round": 0, "peer": "p"},
        "block_parts": {"t": t0 + parts * ms},
        "prevote": {"first": None, "last": None, "count": 0, "by_peer": {}},
        "precommit": {"first": None, "last": None, "count": 0, "by_peer": {}},
        "polka": {"t": t0 + polka * ms, "round": 0},
        "commit": {"t": t0 + commit * ms, "round": 0, "hash": "AA"},
        "persist": None,
        "exec": None,
    }
    if persist is not None:
        rec["persist"] = {"t": t0 + persist[0] * ms, "dur_ns": persist[1] * ms}
    if execspan is not None:
        rec["exec"] = {"t": t0 + execspan[0] * ms,
                       "dur_ns": execspan[1] * ms}
    return rec


class TestBuildWaterfall:
    def test_exact_phase_cuts(self, pkg):
        wf = pkg.build_waterfall(_mk_rec())
        assert wf["height"] == 5
        assert wf["phases"]["propose_wait"] == pytest.approx(0.010)
        assert wf["phases"]["block_parts"] == pytest.approx(0.020)
        assert wf["phases"]["prevote_quorum"] == pytest.approx(0.060)
        assert wf["phases"]["precommit_quorum"] == pytest.approx(0.100)
        assert wf["phases"]["commit_persist"] == pytest.approx(0.005)
        assert wf["phases"]["abci_exec"] == pytest.approx(0.020)
        # t_end is the exec span's end: commit+25ms past round entry
        assert wf["wall_seconds"] == pytest.approx(0.215)
        assert wf["commit_seconds"] == pytest.approx(0.190)
        assert wf["critical_path"] == "precommit_quorum"

    def test_reconciliation_identity_is_exact(self, pkg):
        wf = pkg.build_waterfall(_mk_rec())
        timeline = sum(wf["phases"][p] for p in pkg.TIMELINE_PHASES)
        # identity by construction: residual below float dust, not just tol
        assert abs(wf["wall_seconds"] - (timeline + wf["other_seconds"])) \
            < 1e-12

    def test_overlay_excluded_from_reconciliation(self, pkg):
        wal_costs = {"append_seconds": 5.0, "fsync_seconds": 7.0,
                     "appends": 3, "fsyncs": 2}
        wf = pkg.build_waterfall(_mk_rec(), wal_costs, verify_seconds=11.0)
        assert wf["phases"]["wal_append"] == 5.0
        assert wf["phases"]["wal_fsync"] == 7.0
        assert wf["verify_dispatch_seconds"] == 11.0
        assert wf["wal_appends"] == 3 and wf["wal_fsyncs"] == 2
        # huge overlay costs must not disturb the timeline identity
        timeline = sum(wf["phases"][p] for p in pkg.TIMELINE_PHASES)
        assert abs(wf["wall_seconds"] - (timeline + wf["other_seconds"])) \
            < 1e-12
        assert wf["wall_seconds"] == pytest.approx(0.215)

    def test_critical_path_tie_breaks_to_earlier_phase(self, pkg):
        # wal_fsync exactly equals the dominant precommit_quorum: the
        # earlier phase in chain order must win, deterministically
        wal_costs = {"fsync_seconds": 0.100}
        wf = pkg.build_waterfall(_mk_rec(), wal_costs)
        assert wf["phases"]["wal_fsync"] == wf["phases"]["precommit_quorum"]
        assert wf["critical_path"] == "precommit_quorum"
        # strictly larger overlay does take the flag
        wf2 = pkg.build_waterfall(_mk_rec(), {"fsync_seconds": 0.200})
        assert wf2["critical_path"] == "wal_fsync"

    def test_none_without_commit_or_rounds(self, pkg):
        rec = _mk_rec()
        rec["commit"] = None
        assert pkg.build_waterfall(rec) is None
        rec2 = _mk_rec()
        rec2["rounds"] = []
        assert pkg.build_waterfall(rec2) is None

    def test_missing_milestones_collapse_to_zero_width(self, pkg):
        rec = _mk_rec(persist=None, execspan=None)
        rec["proposal"] = None
        rec["block_parts"] = None
        rec["polka"] = None
        wf = pkg.build_waterfall(rec)
        assert wf["phases"]["propose_wait"] == 0.0
        assert wf["phases"]["block_parts"] == 0.0
        assert wf["phases"]["prevote_quorum"] == 0.0
        assert wf["phases"]["precommit_quorum"] == pytest.approx(0.190)
        assert wf["phases"]["commit_persist"] == 0.0
        assert wf["phases"]["abci_exec"] == 0.0
        assert wf["other_seconds"] == pytest.approx(0.0, abs=1e-12)

    def test_inverted_stamps_clamp_no_negative_phase(self, pkg):
        # proposer stamps block parts BEFORE its own proposal acceptance;
        # skewed clocks can invert neighbors — phases must stay >= 0
        rec = _mk_rec(prop=30, parts=10)  # parts stamped before proposal
        wf = pkg.build_waterfall(rec)
        assert all(wf["phases"][p] >= 0.0 for p in pkg.PHASES)
        timeline = sum(wf["phases"][p] for p in pkg.TIMELINE_PHASES)
        assert abs(wf["wall_seconds"] - (timeline + wf["other_seconds"])) \
            < 1e-12

    def test_segments_cover_timeline(self, pkg):
        wf = pkg.build_waterfall(_mk_rec())
        by_phase = {s["phase"]: s for s in wf["segments"]}
        # the four interval segments tile [t_start, t_commit] contiguously
        chain = ["propose_wait", "block_parts", "prevote_quorum",
                 "precommit_quorum"]
        assert by_phase[chain[0]]["t0_ns"] == wf["t_start_ns"]
        for a, b in zip(chain, chain[1:]):
            assert by_phase[a]["t1_ns"] == by_phase[b]["t0_ns"]
        for name in ("commit_persist", "abci_exec"):
            seg = by_phase[name]
            assert wf["t_start_ns"] <= seg["t0_ns"] <= seg["t1_ns"] \
                <= wf["t_end_ns"]

    def test_phase_tuples_consistent(self, pkg):
        assert set(pkg.TIMELINE_PHASES) | {"wal_append", "wal_fsync"} == \
            set(pkg.PHASES)
        assert set(pkg.OVERLAY_PHASES) - {"verify_dispatch"} <= set(pkg.PHASES)
        wf = pkg.build_waterfall(_mk_rec())
        assert set(wf["phases"]) == set(pkg.PHASES)


# -- pkg.WAL height-cost tier ----------------------------------------------------------


class TestWALHeightCosts:
    def test_height_tagged_accounting(self, pkg, tmp_path):
        wal = pkg.WAL(str(tmp_path / "wal"))
        wal.start()
        try:
            wal.set_height(7)
            wal.write(pkg.EndHeightMessage(6))
            wal.write_sync(pkg.EndHeightMessage(7))  # write + fsync
            costs = wal.height_costs(7)
            assert costs is not None
            assert costs["appends"] == 2 and costs["fsyncs"] == 1
            assert costs["append_seconds"] > 0.0
            assert costs["fsync_seconds"] > 0.0
            # other heights untouched
            assert wal.height_costs(6) is None
            # pop consumes exactly once
            assert wal.pop_height_costs(7) == costs
            assert wal.pop_height_costs(7) is None
            assert wal.height_costs(7) is None
        finally:
            wal.stop()

    def test_keep_window_evicts_oldest(self, pkg, tmp_path, monkeypatch):
        monkeypatch.setattr(pkg.WAL, "HEIGHT_COST_KEEP", 4)
        wal = pkg.WAL(str(tmp_path / "wal"))
        wal.start()
        try:
            for h in range(1, 7):  # 6 heights through a keep-4 window
                wal.set_height(h)
                wal.write(pkg.EndHeightMessage(h))
            assert wal.height_costs(1) is None
            assert wal.height_costs(2) is None
            for h in range(3, 7):
                assert wal.height_costs(h)["appends"] == 1
        finally:
            wal.stop()

    def test_nil_wal_surface(self, pkg):
        nil = pkg.NilWAL()
        nil.set_height(5)  # must not raise
        assert nil.height_costs(5) is None
        assert nil.pop_height_costs(5) is None


# -- analyzer tier -----------------------------------------------------------------


class _Clock:
    """Injectable ns clock for pkg.FlightRecorder.now_ns."""

    def __init__(self, t0=_T0):
        self.t = t0

    def __call__(self):
        return self.t

    def tick(self, ms):
        self.t += ms * 1_000_000
        return self.t


class _StubWAL:
    def __init__(self, costs_by_height):
        self._costs = costs_by_height

    def pop_height_costs(self, height):
        return self._costs.pop(height, None)


def _drive_height(fr, clock, height, prop=10, parts=20, polka=60,
                  commit=100, persist=3, execspan=15):
    fr.on_new_round(height, 0)
    clock.tick(prop)
    fr.on_proposal(height, 0, "p")
    clock.tick(parts)
    fr.on_block_parts_complete(height)
    clock.tick(polka)
    fr.on_polka(height, 0)
    clock.tick(commit)
    fr.on_commit(height, 0, b"\xaa")
    t0 = clock.t
    fr.on_persist(height, t0, clock.tick(persist))
    t1 = clock.t
    fr.on_execute(height, t1, clock.tick(execspan))


class TestCritPath:
    def test_on_height_complete_fuses_all_streams(self, pkg):
        clock = _Clock()
        fr = pkg.FlightRecorder(node_id="n7", enabled=True)
        fr.now_ns = clock
        _drive_height(fr, clock, 1)
        wal = _StubWAL({1: {"append_seconds": 0.002, "fsync_seconds": 0.004,
                            "appends": 2, "fsyncs": 1}})
        entries = [{"height_base": 1, "run_seconds": 0.5, "heights": 1}]
        metrics = pkg.Metrics()
        cp = pkg.CritPath(metrics=metrics, profiler_entries=lambda: entries)
        wf = cp.on_height_complete(1, fr, wal=wal)
        assert wf is not None
        assert cp.node_id == "n7"
        assert wf["phases"]["propose_wait"] == pytest.approx(0.010)
        assert wf["phases"]["precommit_quorum"] == pytest.approx(0.100)
        assert wf["phases"]["wal_fsync"] == pytest.approx(0.004)
        assert wf["verify_dispatch_seconds"] == pytest.approx(0.5)
        assert wf["critical_path"] == "precommit_quorum"
        assert len(cp) == 1
        # the pkg.WAL accumulator was consumed exactly once
        assert wal.pop_height_costs(1) is None
        # every phase landed one histogram observation
        text = metrics.registry.expose_text()
        for phase in pkg.PHASES:
            assert (
                f'tendermint_consensus_height_phase_seconds_count'
                f'{{phase="{phase}"}} 1'
            ) in text

    def test_disabled_flight_is_noop(self, pkg):
        fr = pkg.FlightRecorder(enabled=False)
        cp = pkg.CritPath(profiler_entries=list)
        assert cp.on_height_complete(1, fr) is None
        assert len(cp) == 0 and cp.analysis_errors == 0

    def test_missing_record_is_noop(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        cp = pkg.CritPath(profiler_entries=list)
        assert cp.on_height_complete(42, fr) is None
        assert cp.analysis_errors == 0

    def test_internal_errors_counted_never_raised(self, pkg):
        clock = _Clock()
        fr = pkg.FlightRecorder(enabled=True)
        fr.now_ns = clock
        _drive_height(fr, clock, 1)

        def boom():
            raise RuntimeError("profiler exploded")

        cp = pkg.CritPath(profiler_entries=boom)
        assert cp.on_height_complete(1, fr) is None  # must not raise
        assert cp.analysis_errors == 1
        assert len(cp) == 0
        snap = cp.snapshot()
        assert snap["analysis_errors"] == 1

    def test_ring_and_snapshot_contract(self, pkg):
        clock = _Clock()
        fr = pkg.FlightRecorder(node_id="n0", enabled=True)
        fr.now_ns = clock
        cp = pkg.CritPath(capacity=3, sample_window=4, profiler_entries=list)
        for h in range(1, 6):
            _drive_height(fr, clock, h)
            assert cp.on_height_complete(h, fr) is not None
        assert len(cp) == 3
        assert [w["height"] for w in cp.records()] == [3, 4, 5]
        assert [w["height"] for w in cp.records(limit=2)] == [4, 5]
        assert cp.records(limit=0) == []
        snap = cp.snapshot()
        assert snap["total_records"] == 3
        assert snap["truncated"] is False
        assert snap["evicted"] == 2
        assert snap["node_id"] == "n0"
        cut = cp.snapshot(limit=1)
        assert cut["truncated"] is True
        assert len(cut["records"]) == 1 and cut["total_records"] == 3
        # sample_window=4 bounds the exact pkg.percentile rings below record
        # count, while the whole-run sketch keeps all 5 heights
        stats = snap["phase_stats"]
        assert stats["commit"]["window_n"] == 4
        assert all(stats[p]["window_n"] == 4 for p in pkg.PHASES)
        assert stats["commit"]["n"] == 5
        assert all(stats[p]["n"] == 5 for p in pkg.PHASES)
        assert stats["commit"]["p50_seconds"] > 0.0
        assert stats["commit"]["window_p50_seconds"] > 0.0
        assert snap["sketches"]["commit"]["count"] == 5

    def test_reset_and_resize(self, pkg):
        clock = _Clock()
        fr = pkg.FlightRecorder(enabled=True)
        fr.now_ns = clock
        cp = pkg.CritPath(capacity=8, profiler_entries=list)
        for h in (1, 2):
            _drive_height(fr, clock, h)
            cp.on_height_complete(h, fr)
        cp.reset()
        assert len(cp) == 0 and cp.capacity == 8
        cp.reset(capacity=2)
        assert cp.capacity == 2
        with pytest.raises(ValueError):
            cp.reset(capacity=0)

    def test_critical_path_deterministic_under_seeded_storm(self, pkg):
        """Two identical seeded storms (jittered phase durations across 40
        heights) must flag the identical critical-path sequence — flagging
        is a pure function of the stamps, with deterministic tie-breaks."""

        def run_storm(seed):
            rng = random.Random(seed)
            clock = _Clock()
            fr = pkg.FlightRecorder(node_id="storm", enabled=True)
            fr.now_ns = clock
            cp = pkg.CritPath(profiler_entries=list)
            flagged = []
            for h in range(1, 41):
                _drive_height(
                    fr, clock, h,
                    prop=rng.randrange(1, 50),
                    parts=rng.randrange(1, 50),
                    polka=rng.randrange(1, 200),
                    commit=rng.randrange(1, 200),
                    persist=rng.randrange(1, 20),
                    execspan=rng.randrange(1, 20),
                )
                wal = _StubWAL({h: {
                    "append_seconds": rng.random() * 0.05,
                    "fsync_seconds": rng.random() * 0.05,
                    "appends": 1, "fsyncs": 1,
                }})
                wf = cp.on_height_complete(h, fr, wal=wal)
                flagged.append((h, wf["critical_path"]))
            assert cp.analysis_errors == 0
            return flagged

        a, b = run_storm(12), run_storm(12)
        assert a == b
        assert all(phase in pkg.PHASES for _, phase in a)
        # the storm actually exercises multiple phases as dominant
        assert len({phase for _, phase in a}) >= 2
        # a different seed produces a different storm (sanity: the test
        # would be vacuous if every storm flagged one constant sequence)
        assert run_storm(99) != a


# -- trace_merge waterfall tier ----------------------------------------------------


def _mk_full_dump(node_id, heights, skew_ns=0, t0=_T0):
    """dump_flight payload with full milestone records (unlike test_flight's
    minimal _mk_dump) so every record yields a waterfall on merge."""
    records = []
    for n, h in enumerate(heights):
        base = t0 + n * 500_000_000 - skew_ns
        rec = _mk_rec(height=h, t0=base)
        rec["commit"]["hash"] = f"H{h:02d}"
        records.append(rec)
    return {"node_id": node_id, "enabled": True, "capacity": 512,
            "evicted": 0, "total_records": len(records),
            "truncated": False, "records": records}


class TestTraceMergeWaterfall:
    @pytest.fixture()
    def tm(self, pkg):
        return pkg.trace_merge

    def test_waterfall_slices_strict_validate(self, pkg, tm):
        dumps = [_mk_full_dump("n0", [1, 2, 3])]
        merged = tm.merge(dumps, skews=[0])
        errors = pkg.validate_chrome_trace(merged, 1, min_commits_per_node=3)
        assert errors == []

    def test_waterfall_slices_nest_in_parent(self, pkg, tm):
        merged = tm.merge([_mk_full_dump("n0", [1, 2])], skews=[0])
        evs = [e for e in merged["traceEvents"]
               if e.get("cat") == "critpath"]
        parents = {e["args"]["height"]: e for e in evs
                   if e["name"].startswith("waterfall ")}
        children = [e for e in evs
                    if not e["name"].startswith("waterfall ")]
        assert set(parents) == {1, 2}
        assert children, "no phase slices emitted"
        for ev in children:
            parent = parents[ev["args"]["height"]]
            assert ev["name"] in pkg.PHASES
            assert ev["tid"] == parent["tid"]
            assert ev["ts"] >= parent["ts"] - 1e-6
            assert ev["ts"] + ev["dur"] <= \
                parent["ts"] + parent["dur"] + 1e-6
        for h, parent in parents.items():
            assert parent["ph"] == "X" and parent["dur"] >= 0
            args = parent["args"]
            assert args["critical_path"] in pkg.PHASES
            assert args["commit_seconds"] == pytest.approx(0.190)

    def test_commit_anchor_skew_corrects_waterfalls(self, pkg, tm):
        """Two nodes, same commits, one clock 5ms behind: after anchor
        correction the same height's waterfall must end at the same merged
        timestamp on both tracks (the commit IS the anchor)."""
        d0 = _mk_full_dump("n0", [1, 2, 3])
        d1 = _mk_full_dump("n1", [1, 2, 3], skew_ns=5_000_000)
        skews = tm.compute_skews([d0, d1])
        assert skews == [0, 5_000_000]
        merged = tm.merge([d0, d1], skews=skews)
        ends = {}  # height -> {pid: parent end us}
        for e in merged["traceEvents"]:
            if e.get("cat") == "critpath" and \
                    e["name"].startswith("waterfall "):
                ends.setdefault(e["args"]["height"], {})[e["pid"]] = \
                    e["ts"] + e["dur"]
        for h, by_pid in ends.items():
            assert set(by_pid) == {0, 1}
            assert by_pid[0] == pytest.approx(by_pid[1], abs=1.0)  # <=1us


# -- across the packages ----------------------------------------------------------


def _storm_stamps(seed, heights=24):
    """Seeded per-height phase durations (ms) and WAL costs, from numpy."""
    rng = np.random.default_rng(seed)
    return [dict(prop=int(rng.integers(1, 50)), parts=int(rng.integers(1, 50)),
                 polka=int(rng.integers(1, 200)), commit=int(rng.integers(1, 200)),
                 persist=int(rng.integers(1, 20)), execspan=int(rng.integers(1, 20)),
                 wal={"append_seconds": float(rng.random() * 0.05),
                      "fsync_seconds": float(rng.random() * 0.05),
                      "appends": int(rng.integers(1, 9)), "fsyncs": 1},
                 verify=float(rng.random() * 0.3))
            for _ in range(heights)]


def _run_analyzer(pkg, stamps):
    clock = _Clock()
    fr = pkg.FlightRecorder(node_id="same", enabled=True)
    fr.now_ns = clock
    entries = [{"height_base": h, "run_seconds": s["verify"], "heights": 1}
               for h, s in enumerate(stamps, 1)]
    metrics = pkg.Metrics()
    cp = pkg.CritPath(capacity=16, sample_window=8, metrics=metrics,
                      profiler_entries=lambda: entries)
    wfs = []
    for h, s in enumerate(stamps, 1):
        _drive_height(fr, clock, h, **{k: v for k, v in s.items() if k not in ("wal", "verify")})
        wfs.append(cp.on_height_complete(h, fr, wal=_StubWAL({h: dict(s["wal"])})))
    return wfs, cp.snapshot(), metrics.registry.expose_text()


class TestAcrossPackages:
    def test_waterfalls_snapshots_and_sketches_equal(self):
        stamps = _storm_stamps(17)
        r_wfs, r_snap, r_text = _run_analyzer(REF, stamps)
        p_wfs, p_snap, p_text = _run_analyzer(PORT, stamps)
        assert r_wfs == p_wfs and all(w is not None for w in p_wfs)
        assert json.dumps(r_snap, sort_keys=True) == json.dumps(p_snap, sort_keys=True)
        phase_lines = sorted(ln for ln in p_text.splitlines()
                             if ln.startswith("tendermint_consensus_height_phase_seconds"))
        assert phase_lines == sorted(
            ln for ln in r_text.splitlines()
            if ln.startswith("tendermint_consensus_height_phase_seconds"))
        # a sketch of one package merges with the other's bucket for bucket
        from tendermint_tpu.libs.sketch import QuantileSketch as RSketch
        from tendermint_tpu_torch.libs.sketch import QuantileSketch as PSketch
        r = RSketch.from_dict(r_snap["sketches"]["commit"])
        r.merge(PSketch.from_dict(p_snap["sketches"]["commit"]))
        assert r.count == 2 * len(stamps)

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_build_waterfall_equal_on_seeded_records(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(20):
            offs = sorted(int(x) for x in rng.integers(0, 400, 4))
            rng.shuffle(offs[:3])  # inverted neighbours clamp the same way
            rec = _mk_rec(prop=offs[0], parts=offs[1], polka=offs[2], commit=offs[3],
                          persist=(offs[3], int(rng.integers(0, 9))),
                          execspan=(offs[3] + 9, int(rng.integers(0, 30))))
            if rng.random() < 0.3:
                rec["polka"] = None
            wal = {"append_seconds": float(rng.random()), "fsync_seconds": float(rng.random())}
            assert REF.build_waterfall(rec, wal, 0.25) == PORT.build_waterfall(rec, wal, 0.25)

    def test_merged_waterfall_trace_byte_identical(self):
        d0 = _mk_full_dump("n0", [1, 2, 3])
        d1 = _mk_full_dump("n1", [1, 2, 3], skew_ns=5_000_000)
        assert json.dumps(REF.trace_merge.merge([d0, d1])) == \
            json.dumps(PORT.trace_merge.merge([d0, d1]))


# -- the net tier ------------------------------------------------------------------


def _check_reconciled(snap, tol_s):
    assert snap["analysis_errors"] == 0
    for wf in snap["records"]:
        who = f"{snap['node_id']} h={wf['height']}"
        for phase in PORT.PHASES:
            assert wf["phases"][phase] >= 0.0, who
        timeline = sum(wf["phases"][p] for p in PORT.TIMELINE_PHASES)
        assert timeline + wf["other_seconds"] == pytest.approx(wf["wall_seconds"], abs=tol_s), who
        assert wf["other_seconds"] >= -tol_s, who
        assert 0.0 <= wf["commit_seconds"] <= wf["wall_seconds"] + 1e-9, who
        assert wf["critical_path"] in PORT.PHASES, who


class TestInProcNetReconciliation:
    TARGET_HEIGHT = 2
    TOL_S = 1e-6

    def test_phase_sums_reconcile_with_wall_time(self, tmp_path):
        """Every height each of 4 nodes committed has a waterfall, and its
        timeline phases plus other_seconds make its wall time; node 0 runs
        a real WAL, whose costs land in its overlays. The merged trace
        strict-validates, waterfalls included."""
        set_batch_verifier(HostBatchVerifier())
        clock = consensus_net.shared_clock()
        net = consensus_net.Net(
            now_ns=clock,
            wal_factory=lambda i: pwal.WAL(str(tmp_path / "wal" / "wal")) if i == 0 else None)
        try:
            net.start()
            ok = harness.wait_for(
                lambda: all(cs.get_state().last_block_height >= self.TARGET_HEIGHT
                            for cs, _, _ in net.nodes), timeout=DEADLINE)
            heights = [cs.rs.height for cs, _, _ in net.nodes]
            assert ok, f"net never reached {self.TARGET_HEIGHT + 1}: {heights}"
            snaps = [cs.critpath.snapshot() for cs, _, _ in net.nodes]
            dumps = [cs.flight.snapshot() for cs, _, _ in net.nodes]
        finally:
            net.stop()
            set_batch_verifier(None)
        for cs, _, _ in net.nodes:
            assert cs.now_ns is clock and cs.flight.now_ns is clock
        for snap in snaps:
            assert snap["total_records"] >= self.TARGET_HEIGHT
            assert [wf["height"] for wf in snap["records"]][:self.TARGET_HEIGHT] == \
                list(range(1, self.TARGET_HEIGHT + 1))
            assert snap["truncated"] is False
            _check_reconciled(snap, self.TOL_S)
        assert all(wf["wal_appends"] > 0 and wf["phases"]["wal_fsync"] > 0.0
                   for wf in snaps[0]["records"])
        merged = trace_merge.merge(dumps, skews=trace_merge.compute_skews(dumps))
        assert consensus_net.validate_chrome_trace(
            merged, 4, min_commits_per_node=self.TARGET_HEIGHT) == []
        assert any(e.get("cat") == "critpath" for e in merged["traceEvents"])
        # one clock: the same commit lies at the same instant class on
        # every node, so the anchor skews are a few ms at most
        assert all(abs(s) < 1_000_000_000 for s in trace_merge.compute_skews(dumps))


def proposer_index(pkg, n_vals):
    """The index, in the sorted set, of the proposer of height 1 round 0."""
    doc, _ = pkg.h.make_genesis(n_vals)
    vals = pkg.st.state_from_genesis(doc).validators
    return [v.address for v in vals.validators].index(vals.get_proposer().address)


def _scripted_height_from_new_height(pkg):
    """A node at NEW_HEIGHT of height 1 (not the proposer) whose queue holds
    the stub proposer's complete proposal and every stub's prevote and
    precommit before it starts, so the messages come before its own
    round-0 timeout: returns its flight record, critpath snapshot and the
    state's height after the run."""
    n = 4
    prop_idx = proposer_index(pkg, n)
    ours = (prop_idx + 1) % n
    cs, stubs, bus = pkg.h.make_consensus_state(n, our_index=ours)
    cs.flight.enable()
    try:
        stub = next(s for s in stubs if s.index == prop_idx)
        if pkg is PORT:
            prop, block, parts = harness.decide_proposal(cs, stub, 1, 0)
        else:
            from tests.test_torch_consensus import _ref_decide_proposal
            prop, block, parts = _ref_decide_proposal(cs, stub, 1, 0)
        cs.set_proposal_and_block(prop, block, parts, f"peer{stub.index}")
        bid = prop.block_id
        for vtype in (pkg.SignedMsgType.PREVOTE, pkg.SignedMsgType.PRECOMMIT):
            for s in stubs:
                cs.add_vote_msg(s.sign_vote(vtype, bid, 1, 0), f"peer{s.index}")
        cs.start()
        assert pkg.h.wait_for(lambda: cs.get_state().last_block_height >= 1, timeout=DEADLINE)
        assert pkg.h.wait_for(lambda: cs.critpath.analysis_errors == 0
                              and (cs.flight.peek(1) or {}).get("exec") is not None,
                              timeout=DEADLINE)
        return cs.flight.peek(1), cs.critpath.snapshot(), cs.quorumtrace.snapshot()
    finally:
        cs.stop()
        bus.stop()


class TestNewHeight:
    def test_height_entered_without_new_round(self, pkg):
        """Property of the reference, kept: a height entered straight from
        NEW_HEIGHT (a complete proposal before the round-0 timeout) has no
        round stamp, so it commits with no waterfall and no error."""
        rset_batch_verifier(RHostBatchVerifier())
        set_batch_verifier(HostBatchVerifier())
        try:
            rec, snap, qsnap = _scripted_height_from_new_height(pkg)
        finally:
            set_batch_verifier(None)
        assert rec["rounds"] == []
        assert rec["commit"] is not None and rec["exec"] is not None
        assert snap["total_records"] == 0 and snap["analysis_errors"] == 0
        # the quorum curve has no t0 either
        assert qsnap["total_records"] == 0 and qsnap["analysis_errors"] == 0
