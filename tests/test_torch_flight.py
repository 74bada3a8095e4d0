"""The port's flight recorder (``consensus/flight.py``), liveness
watchdog (``libs/watchdog.py``) and ``tools/trace_merge.py`` against the
reference's on the same inputs.

The restated classes of ``tests/test_flight.py`` (``TestFlightRecorder``,
``TestWatchdogSampling``, ``TestWatchdogStallHarness``,
``TestFlightHarness``, ``TestTraceMerge``) run once on each package through
the ``pkg`` parameter: the reference test's assertions hold on both. The
reference's trace merger is its script ``scripts/trace_merge.py``, loaded
from the file; the port's is ``tendermint_tpu_torch.tools.trace_merge``.
Where the reference's harness case loops over validator indices until its
node proposes (and skips when none does), the restated case takes that
index from the genesis, so it never skips. The cross-package cases merge
the same dumps with both mergers and require byte-identical JSON, and
script one height through each package's state machine and require
records that say the same, but for stamps and what the race between the
node's own vote and the stubs' decides. The reference's flight smoke (a
silenced half of the power trips the watchdog, the dumps merge into a
valid trace) runs on the port's 4-node net (``testutil/consensus_net``).
The reference verifies with its host verifier, the port with its host
verifier on the net and the configuration root's guarded verifier on
``device="cpu"`` at ``dispatch_deadline=0`` elsewhere. Every wait is
bounded by a deadline.
"""

import importlib.util
import io
import json
import os
import sys
from types import SimpleNamespace

import pytest

from tendermint_tpu.consensus import flight as rflight
from tendermint_tpu.consensus.messages import VoteMessage as RVoteMessage
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.libs.metrics import NodeMetrics
from tendermint_tpu.libs.watchdog import LivenessWatchdog as RLivenessWatchdog
from tendermint_tpu.state import state_types as rst
from tendermint_tpu.types import BlockID as RBlockID
from tendermint_tpu.types import SignedMsgType as RSignedMsgType
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.consensus import flight as pflight
from tendermint_tpu_torch.consensus.messages import VoteMessage
from tendermint_tpu_torch.crypto.batch import HostBatchVerifier, set_batch_verifier
from tendermint_tpu_torch.libs.metrics import ConsensusMetrics
from tendermint_tpu_torch.libs.watchdog import LivenessWatchdog
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.state import state_types as pst
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.testutil import consensus_net
from tendermint_tpu_torch.tools import trace_merge
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType

from tests import consensus_harness as rharness

DEADLINE = 20.0
_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _load_ref_trace_merge():
    spec = importlib.util.spec_from_file_location(
        "trace_merge", os.path.join(_SCRIPTS, "trace_merge.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["trace_merge"] = mod
    spec.loader.exec_module(mod)
    return mod


REF = SimpleNamespace(
    name="reference", FlightRecorder=rflight.FlightRecorder,
    MAX_PEERS_PER_RECORD=rflight.MAX_PEERS_PER_RECORD, LivenessWatchdog=RLivenessWatchdog,
    Metrics=NodeMetrics, h=rharness, st=rst, BlockID=RBlockID, SignedMsgType=RSignedMsgType,
    VoteMessage=RVoteMessage, trace_merge=_load_ref_trace_merge())
PORT = SimpleNamespace(
    name="port", FlightRecorder=pflight.FlightRecorder,
    MAX_PEERS_PER_RECORD=pflight.MAX_PEERS_PER_RECORD, LivenessWatchdog=LivenessWatchdog,
    Metrics=ConsensusMetrics, h=harness, st=pst, BlockID=BlockID, SignedMsgType=SignedMsgType,
    VoteMessage=VoteMessage, trace_merge=trace_merge)


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _verifiers():
    """The reference's host verifier (as its suite's conftest installs it)
    and the port's guarded verifier on the CPU."""
    rset_batch_verifier(RHostBatchVerifier())
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield root
    verify_root.reset_verify()


def proposer_index(pkg, n_vals):
    """The index, in the sorted set, of the proposer of height 1 round 0."""
    doc, _ = pkg.h.make_genesis(n_vals)
    vals = pkg.st.state_from_genesis(doc).validators
    return [v.address for v in vals.validators].index(vals.get_proposer().address)


# -- recorder unit tier ------------------------------------------------------------


class TestFlightRecorder:
    def test_disabled_hooks_are_noops(self, pkg):
        fr = pkg.FlightRecorder()
        assert fr.enabled is False
        fr.on_new_round(1, 0)
        fr.on_proposal(1, 0, "p")
        fr.on_vote(1, 0, "prevote", "p", 0)
        fr.on_commit(1, 0, b"\xab")
        assert len(fr) == 0
        snap = fr.snapshot()
        assert snap["enabled"] is False and snap["records"] == []

    def test_records_milestones(self, pkg):
        fr = pkg.FlightRecorder(node_id="n0", enabled=True)
        fr.on_new_round(1, 0)
        fr.on_proposal(1, 0)  # own proposal: peer "" -> "local"
        fr.on_block_parts_complete(1)
        fr.on_vote(1, 0, "prevote", "peerA", 2)
        fr.on_vote(1, 0, "prevote", "", 0)
        fr.on_polka(1, 0)
        fr.on_vote(1, 0, "precommit", "peerB", 1)
        fr.on_commit(1, 0, b"\xde\xad")
        fr.on_execute(1, 100, 250)
        (rec,) = fr.records()
        assert rec["height"] == 1
        assert rec["rounds"][0]["round"] == 0
        assert rec["proposal"]["peer"] == "local"
        assert rec["block_parts"] is not None
        pv = rec["prevote"]
        assert pv["count"] == 2
        assert pv["first"]["peer"] == "peerA" and pv["last"]["peer"] == "local"
        assert pv["by_peer"] == {"peerA": 1, "local": 1}
        assert rec["precommit"]["by_peer"] == {"peerB": 1}
        assert rec["polka"]["round"] == 0
        assert rec["commit"]["hash"] == "DEAD"
        assert rec["exec"] == {"t": 100, "dur_ns": 150}

    def test_proposal_first_sighting_wins(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        fr.on_proposal(3, 0, "gossiper")
        fr.on_proposal(3, 0, "latecomer")
        (rec,) = fr.records()
        assert rec["proposal"]["peer"] == "gossiper"

    def test_ring_eviction(self, pkg):
        fr = pkg.FlightRecorder(capacity=2, enabled=True)
        for h in (1, 2, 3):
            fr.on_new_round(h, 0)
        assert len(fr) == 2
        assert fr.evicted() == 1
        assert [r["height"] for r in fr.records()] == [2, 3]
        snap = fr.snapshot()
        assert snap["evicted"] == 1 and snap["total_records"] == 2

    def test_snapshot_limit_and_truncated(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        for h in (1, 2, 3):
            fr.on_new_round(h, 0)
        full = fr.snapshot()
        assert full["truncated"] is False and len(full["records"]) == 3
        cut = fr.snapshot(limit=2)
        assert cut["truncated"] is True
        assert [r["height"] for r in cut["records"]] == [2, 3]  # newest N
        assert cut["total_records"] == 3
        assert fr.snapshot(limit=0)["records"] == []

    def test_by_peer_overflow_folds(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        for i in range(pkg.MAX_PEERS_PER_RECORD + 6):
            fr.on_vote(1, 0, "prevote", f"peer{i}", i)
        (rec,) = fr.records()
        by_peer = rec["prevote"]["by_peer"]
        assert len(by_peer) == pkg.MAX_PEERS_PER_RECORD + 1
        assert by_peer["overflow"] == 6
        assert rec["prevote"]["count"] == pkg.MAX_PEERS_PER_RECORD + 6

    def test_vote_signed_first_wins(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        fr.on_vote_signed(1, 0, "prevote", 2)
        fr.on_vote_signed(1, 3, "prevote", 2)  # re-sign at a later round
        (rec,) = fr.records()
        assert rec["prevote"]["signed"]["round"] == 0
        assert rec["prevote"]["signed"]["validator_index"] == 2
        assert rec["precommit"]["signed"] is None

    def test_vote_send_first_per_validator_and_cap(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        fr.on_vote_send(1, 0, "prevote", 1, "peerA")
        fr.on_vote_send(1, 0, "prevote", 1, "peerB")  # later send ignored
        (rec,) = fr.records()
        assert rec["prevote"]["first_send"][1]["peer"] == "peerA"
        for vi in range(2, pkg.MAX_PEERS_PER_RECORD + 1):
            fr.on_vote_send(1, 0, "prevote", vi, "p")
        fr.on_vote_send(1, 0, "prevote", 999, "p")  # over the cap: dropped
        (rec,) = fr.records()
        sends = rec["prevote"]["first_send"]
        assert len(sends) == pkg.MAX_PEERS_PER_RECORD and 999 not in sends

    def test_vote_arrival_first_wins_and_dup_folds(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        fr.on_vote_arrival(1, 0, "precommit", "peerA", 3)
        fr.on_vote_arrival(1, 0, "precommit", "peerB", 3, duplicate=True)
        fr.on_vote_arrival(1, 0, "precommit", "peerB", 3, duplicate=True)
        fr.on_vote_arrival(1, 0, "precommit", "peerA", 5, duplicate=True)
        (rec,) = fr.records()
        slot = rec["precommit"]
        assert set(slot["arrivals"]) == {3}
        assert slot["arrivals"][3]["peer"] == "peerA"
        assert slot["dup_by_peer"] == {"peerB": 2, "peerA": 1}

    def test_vote_arrival_caps_and_dup_overflow(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        for vi in range(pkg.MAX_PEERS_PER_RECORD):
            fr.on_vote_arrival(1, 0, "prevote", f"peer{vi}", vi)
        fr.on_vote_arrival(1, 0, "prevote", "late", 999)  # dropped
        for i in range(pkg.MAX_PEERS_PER_RECORD + 4):
            fr.on_vote_arrival(1, 0, "prevote", f"dup{i}", 0, duplicate=True)
        (rec,) = fr.records()
        slot = rec["prevote"]
        assert len(slot["arrivals"]) == pkg.MAX_PEERS_PER_RECORD
        assert 999 not in slot["arrivals"]
        assert slot["dup_by_peer"]["overflow"] == 4
        assert len(slot["dup_by_peer"]) == pkg.MAX_PEERS_PER_RECORD + 1

    def test_disabled_vote_journey_hooks_are_noops(self, pkg):
        fr = pkg.FlightRecorder()
        fr.on_vote_signed(1, 0, "prevote", 0)
        fr.on_vote_send(1, 0, "prevote", 0, "p")
        fr.on_vote_arrival(1, 0, "prevote", "p", 0)
        assert len(fr) == 0

    def test_journey_stamps_survive_snapshot_copy(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        fr.on_vote_signed(1, 0, "prevote", 0)
        fr.on_vote_arrival(1, 0, "prevote", "peerA", 1)
        snap = fr.snapshot()
        snap["records"][0]["prevote"]["arrivals"][1]["peer"] = "mutated"
        snap["records"][0]["prevote"]["signed"]["t"] = -1
        (rec,) = fr.records()  # the recorder's copy is unaffected
        assert rec["prevote"]["arrivals"][1]["peer"] == "peerA"
        assert rec["prevote"]["signed"]["t"] > 0

    def test_reset_and_resize(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        fr.on_new_round(1, 0)
        fr.reset(capacity=4)
        assert len(fr) == 0 and fr.capacity == 4 and fr.evicted() == 0
        with pytest.raises(ValueError):
            fr.reset(capacity=0)

    def test_ring_wraparound_mid_height_consistency(self, pkg):
        """Hooks keep landing on EVICTED heights after the ring wraps;
        records(limit)/evicted()/snapshot() must stay mutually consistent
        (the old snapshot took the lock three separate times, so a hook
        firing between acquisitions could ship truncated=False next to a
        record list that WAS truncated)."""
        fr = pkg.FlightRecorder(capacity=3, enabled=True)
        for h in (1, 2, 3, 4, 5):
            fr.on_new_round(h, 0)
        # late vote for an evicted height re-allocates it mid-wrap: height 1
        # re-enters the ring, evicting height 3
        fr.on_vote(1, 0, "prevote", "straggler", 0)
        assert len(fr) == 3
        assert fr.evicted() == 3
        assert [r["height"] for r in fr.records()] == [1, 4, 5]
        snap = fr.snapshot()
        assert snap["total_records"] == 3
        assert snap["evicted"] == 3
        assert snap["truncated"] is False
        assert len(snap["records"]) == snap["total_records"]
        cut = fr.snapshot(limit=2)
        assert cut["truncated"] is True
        assert [r["height"] for r in cut["records"]] == [4, 5]
        assert cut["total_records"] == 3 and cut["evicted"] == 3
        # limit >= total: nothing cut, flag must say so
        assert fr.snapshot(limit=3)["truncated"] is False
        assert fr.snapshot(limit=99)["truncated"] is False

    def test_snapshot_consistent_under_concurrent_wrap(self, pkg):
        """dump_flight's payload must be internally consistent while hooks
        wrap the ring from another thread: each snapshot's truncated flag
        is derived from the SAME locked view as its record list."""
        import threading

        fr = pkg.FlightRecorder(capacity=4, enabled=True)
        stop = threading.Event()

        def hammer():
            h = 0
            while not stop.is_set():
                h += 1
                fr.on_new_round(h, 0)
                fr.on_vote(h, 0, "prevote", "p", 0)
                fr.on_commit(h, 0, b"\xaa")

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            last_evicted = 0
            for _ in range(300):
                snap = fr.snapshot(limit=2)
                assert snap["total_records"] <= 4
                assert len(snap["records"]) <= 2
                assert snap["truncated"] is (
                    len(snap["records"]) < snap["total_records"]
                )
                assert snap["evicted"] >= last_evicted  # monotone
                last_evicted = snap["evicted"]
                full = fr.snapshot()
                assert full["truncated"] is False
                assert len(full["records"]) == full["total_records"]
        finally:
            stop.set()
            t.join(5.0)

    def test_persist_hook_records_span(self, pkg):
        fr = pkg.FlightRecorder(enabled=True)
        fr.on_commit(7, 0, b"\xaa")
        fr.on_persist(7, 1_000, 3_500)
        (rec,) = fr.records()
        assert rec["persist"] == {"t": 1_000, "dur_ns": 2_500}
        assert fr.peek(7)["persist"]["dur_ns"] == 2_500
        assert fr.peek(99) is None
        # peek hands out a copy, not the live record
        fr.peek(7)["persist"]["dur_ns"] = -1
        assert fr.peek(7)["persist"]["dur_ns"] == 2_500

    def test_from_env(self, pkg, monkeypatch):
        monkeypatch.setenv("TM_FLIGHT", "1")
        monkeypatch.setenv("TM_FLIGHT_BUFFER", "16")
        fr = pkg.FlightRecorder.from_env()
        assert fr.enabled is True and fr.capacity == 16
        monkeypatch.setenv("TM_FLIGHT", "0")
        monkeypatch.delenv("TM_FLIGHT_BUFFER")
        fr = pkg.FlightRecorder.from_env()
        assert fr.enabled is False


# -- watchdog unit tier ------------------------------------------------------------


class TestWatchdogSampling:
    """Deterministic check(now=...) over an unstarted harness cs."""

    @pytest.fixture()
    def cs(self, pkg):
        cs, _stubs, bus = pkg.h.make_consensus_state(4, our_index=0)
        yield cs
        bus.stop()

    def _wd(self, pkg, cs, metrics=None, **kw):
        kw.setdefault("stall_factor", 2.0)
        kw.setdefault("min_stall_seconds", 1.0)
        kw.setdefault("ewma_alpha", 0.5)
        return pkg.LivenessWatchdog(cs, metrics=metrics, **kw)

    def test_stall_onset_and_recovery(self, pkg, cs):
        m = pkg.Metrics()
        wd = self._wd(pkg, cs, metrics=m)
        assert wd.check(now=0.0) is None  # first sample = progress
        assert wd.check(now=0.5) is None  # idle below threshold
        report = wd.check(now=1.5)  # idle 1.5 > min_stall 1.0
        assert report is not None and report["stalled"] is True
        assert report["height"] == cs.rs.height
        assert report["stalls_total"] == 1
        assert wd.report() is not None
        # still stalled: counter must NOT increment again
        wd.check(now=2.5)
        assert wd.status()["stalls_total"] == 1
        text = m.registry.expose_text()
        assert "tendermint_consensus_stalls_total 1" in text
        # progress clears the report and the gauge
        cs.rs.height += 1
        assert wd.check(now=3.0) is None
        assert wd.report() is None
        assert wd.status()["stalled"] is False
        gauge_line = next(
            l for l in m.registry.expose_text().splitlines()
            if l.startswith("tendermint_consensus_stall_seconds ")
        )
        assert float(gauge_line.split()[-1]) == 0.0

    def test_report_names_all_missing_validators(self, pkg, cs):
        wd = self._wd(pkg, cs)
        wd.check(now=0.0)
        report = wd.check(now=5.0)
        missing = report["missing_prevotes"]
        # nothing voted: all 4 validators missing, full power accounted
        assert len(missing["validators"]) == 4
        assert missing["power"] == missing["total_power"] == 40
        assert {v["index"] for v in missing["validators"]} == {0, 1, 2, 3}
        assert all(v["address"] for v in missing["validators"])

    def test_ewma_amortizes_multi_height_jumps(self, pkg, cs):
        wd = self._wd(pkg, cs)
        wd.check(now=0.0)  # seeds _last_height_at, no EWMA yet
        assert wd.threshold() == wd.min_stall_seconds
        cs.rs.height += 5  # five heights land between two samples
        wd.check(now=10.0)
        # 10s over 5 heights = 2s/height, not a 10s "block interval"
        assert wd.status()["block_interval_ewma_seconds"] == 2.0
        assert wd.threshold() == 4.0  # max(2.0 factor * 2.0s, 1.0s floor)
        cs.rs.height += 1
        wd.check(now=11.0)  # ewma_alpha 0.5: 0.5*1 + 0.5*2
        assert wd.status()["block_interval_ewma_seconds"] == 1.5

    def test_round_progress_defers_stall(self, pkg, cs):
        wd = self._wd(pkg, cs)
        wd.check(now=0.0)
        cs.rs.round += 1  # round change IS progress (no height yet)
        assert wd.check(now=5.0) is None
        assert wd.status()["block_interval_ewma_seconds"] is None
        assert wd.check(now=5.5) is None  # idle clock restarted

    def test_ewma_clamps_frozen_clock_gap(self, pkg, cs):
        """A frozen-then-resumed clock (one huge inter-height gap) must not
        poison the EWMA: the sample is clamped to max_sample_factor × the
        current EWMA, so the stall threshold recovers immediately."""
        wd = self._wd(pkg, cs, max_sample_factor=10.0)
        wd.check(now=0.0)
        cs.rs.height += 1
        wd.check(now=1.0)  # seeds EWMA at 1s/height
        assert wd.status()["block_interval_ewma_seconds"] == 1.0
        # the clock freezes for 10 minutes, then one height lands
        cs.rs.height += 1
        wd.check(now=601.0)
        # unclamped: 0.5*600 + 0.5*1 = 300.5s EWMA, threshold 601s —
        # clamped: the 600s sample contributes at most 10×1s
        assert wd.status()["block_interval_ewma_seconds"] == 5.5
        assert wd.threshold() == 11.0  # 2.0 factor * 5.5s
        # normal cadence resumes; the average settles back down fast
        cs.rs.height += 1
        wd.check(now=602.0)
        assert wd.status()["block_interval_ewma_seconds"] == 3.25
        # the unclamped first sample still seeds the EWMA (there is no
        # baseline to clamp against)
        wd2 = self._wd(pkg, cs)
        wd2.check(now=0.0)
        cs.rs.height += 1
        wd2.check(now=600.0)
        assert wd2.status()["block_interval_ewma_seconds"] == 600.0


class TestWatchdogStallHarness:
    def test_silenced_majority_trips_watchdog(self, pkg):
        """A running 4-val node whose 3 peer validators never vote must
        stall; the report names the silent >1/3 (here 3/4) power."""
        cs, stubs, bus = pkg.h.make_consensus_state(4, our_index=0)
        m = pkg.Metrics()
        wd = pkg.LivenessWatchdog(
            cs, metrics=m, interval=0.05,
            stall_factor=3.0, min_stall_seconds=0.6,
        )
        cs.start()
        wd.start()
        try:
            assert pkg.h.wait_for(lambda: wd.report() is not None, timeout=15.0), (
                "watchdog never reported a stall"
            )
            report = wd.report()
            assert report["height"] == 1
            missing = report["missing_prevotes"]
            stub_idx = {s.index for s in stubs}
            assert stub_idx <= {v["index"] for v in missing["validators"]}
            # the three silent stubs alone are 30/40 power (> 1/3)
            assert missing["power"] * 3 > missing["total_power"]
            assert report["threshold_seconds"] >= 0.6
            text = m.registry.expose_text()
            assert "tendermint_consensus_stalls_total 1" in text
        finally:
            wd.stop()
            cs.stop()
            bus.stop()


# -- flight milestones on a real consensus height ----------------------------------


def commit_height_one(pkg):
    """Height 1 on a 4-validator state machine at the proposer's index,
    with the three stubs' prevotes then precommits sent as peers; returns
    the height's flight record, the block id and the stubs."""
    cs, stubs, bus = pkg.h.make_consensus_state(4, our_index=proposer_index(pkg, 4))
    cs.flight.node_id = "me"
    cs.flight.enable()
    cs.start()
    try:
        assert pkg.h.wait_for(lambda: cs.get_round_state().proposal_block is not None,
                              timeout=DEADLINE)
        assert cs._is_proposer()
        rs = cs.get_round_state()
        bid = pkg.BlockID(hash=rs.proposal_block.hash(),
                          parts_header=rs.proposal_block_parts.header())
        for vtype in (pkg.SignedMsgType.PREVOTE, pkg.SignedMsgType.PRECOMMIT):
            for stub in stubs:
                cs.send_peer_msg(pkg.VoteMessage(stub.sign_vote(vtype, bid, 1, 0)),
                                 f"peer{stub.index}")
        # wait for execution AND all 4 votes of each kind: our own
        # precommit rides the internal queue and can land after the stub
        # votes already committed the height
        assert pkg.h.wait_for(
            lambda: any(r["height"] == 1 and r["exec"] is not None
                        and r["prevote"]["count"] >= 4 and r["precommit"]["count"] >= 4
                        for r in cs.flight.records()),
            timeout=DEADLINE), "height 1 never executed with all votes recorded"
        rec = next(r for r in cs.flight.records() if r["height"] == 1)
        return rec, bid, stubs
    finally:
        cs.stop()
        bus.stop()


class TestFlightHarness:
    def test_milestone_order_and_attribution(self, pkg):
        """Commit height 1 with scripted peers; the record's stamps must be
        causally ordered and votes attributed to the sending peer ids."""
        rec, bid, stubs = commit_height_one(pkg)
        # every milestone fired
        for key in ("proposal", "block_parts", "polka", "commit", "exec", "persist"):
            assert rec[key] is not None, f"missing {key}"
        # causal order: round entry <= proposal <= parts-complete
        # <= first prevote <= polka <= commit
        t_round = rec["rounds"][0]["t"]
        t_prop = rec["proposal"]["t"]
        t_parts = rec["block_parts"]["t"]
        t_pv = rec["prevote"]["first"]["t"]
        t_polka = rec["polka"]["t"]
        t_commit = rec["commit"]["t"]
        assert t_round <= t_prop <= t_parts <= t_pv
        assert t_pv <= t_polka <= t_commit
        assert rec["proposal"]["peer"] == "local"  # our own block
        assert rec["commit"]["hash"] == bid.hash.hex().upper()
        assert rec["exec"]["dur_ns"] >= 0
        # attribution: our vote is "local", each stub its peer id
        for kind in ("prevote", "precommit"):
            by_peer = rec[kind]["by_peer"]
            assert by_peer.get("local", 0) >= 1
            for stub in stubs:
                assert by_peer.get(f"peer{stub.index}") == 1, (
                    f"{kind} not attributed to peer{stub.index}: {by_peer}")
            assert rec[kind]["count"] == 4
            # our own vote's journey origin, and each stub's power: 10 for a
            # vote counted before the commit, the LastCommit entry's 0 for a
            # precommit that lost the race to our own (the height was
            # already committed on the other three)
            assert rec[kind]["signed"]["validator_index"] == proposer_index(pkg, 4)
            assert stub_powers(rec, kind, stubs) == expected_stub_powers(rec, kind, stubs)
        # the precommits counted before the commit carry its +2/3
        t_commit = rec["commit"]["t"]
        assert 3 * sum(c["power"] for c in rec["precommit"]["contrib"].values()
                       if c["t"] <= t_commit) > 2 * 40


def stub_powers(rec, kind, stubs):
    return [rec[kind]["contrib"][s.index]["power"] for s in stubs]


def expected_stub_powers(rec, kind, stubs):
    """Each stub's power as the flight record must show it whatever the
    arrival order: every prevote and every precommit stamped before the
    commit counts 10; a precommit stamped after it joined the LastCommit,
    whose hook carries no power."""
    t_commit = rec["commit"]["t"]
    return [10 if kind == "prevote" or rec[kind]["contrib"][s.index]["t"] <= t_commit else 0
            for s in stubs]


def _shape(rec, stubs):
    """What a flight record says happened, without its stamps and without
    what the race between our own vote and the stubs' decides (which vote
    came last, our precommit's power: a precommit added after the commit
    joins the LastCommit, whose hook carries no power)."""
    out = {"height": rec["height"], "rounds": [r["round"] for r in rec["rounds"]],
           "proposal": {k: rec["proposal"][k] for k in ("round", "peer")},
           "commit_round": rec["commit"]["round"], "polka_round": rec["polka"]["round"],
           "milestones": sorted(k for k in ("block_parts", "persist", "exec") if rec[k])}
    for kind in ("prevote", "precommit"):
        slot = rec[kind]
        out[kind] = {"count": slot["count"], "by_peer": slot["by_peer"],
                     "signed": slot["signed"]["validator_index"],
                     "contrib": sorted(slot["contrib"]),
                     "stub_power_as_ordered": (stub_powers(rec, kind, stubs)
                                               == expected_stub_powers(rec, kind, stubs)),
                     "journeys": [slot["first_send"], slot["arrivals"], slot["dup_by_peer"]]}
    return out


def test_same_height_same_record_on_both_packages():
    """One scripted height through each package's state machine: the two
    flight records say the same."""
    r_rec, _, r_stubs = commit_height_one(REF)
    p_rec, _, p_stubs = commit_height_one(PORT)
    assert _shape(r_rec, r_stubs) == _shape(p_rec, p_stubs)


# -- cross-node merge over synthetic dumps -----------------------------------------


def _mk_dump(node_id, commits, skew_ns=0, extra=()):
    """A minimal dump_flight payload: commits = [(height, hash, t_ns)];
    skew_ns shifts this node's clock AWAY from the reference."""
    records = []
    for h, hsh, t in commits:
        records.append({
            "height": h,
            "rounds": [{"round": 0, "t": t - 1_000_000 - skew_ns}],
            "proposal": None,
            "block_parts": None,
            "prevote": {"first": None, "last": None, "count": 0,
                        "by_peer": {}},
            "precommit": {"first": None, "last": None, "count": 0,
                          "by_peer": {}},
            "polka": None,
            "commit": {"t": t - skew_ns, "round": 0, "hash": hsh},
            "exec": None,
        })
    records.extend(extra)
    return {"node_id": node_id, "enabled": True, "capacity": 512,
            "evicted": 0, "total_records": len(records),
            "truncated": False, "records": records}


class TestTraceMerge:
    @pytest.fixture()
    def tm(self, pkg):
        return pkg.trace_merge

    def test_skew_from_shared_commit_anchors(self, pkg, tm):
        base = [(1, "AA", 1_000_000_000), (2, "BB", 2_000_000_000),
                (3, "CC", 3_000_000_000)]
        d0 = _mk_dump("n0", base)
        d1 = _mk_dump("n1", base, skew_ns=5_000_000)  # 5ms behind ref
        d2 = _mk_dump("n2", base, skew_ns=-2_000_000)  # 2ms ahead
        skews = tm.compute_skews([d0, d1, d2])
        assert skews == [0, 5_000_000, -2_000_000]
        spread = tm.anchor_spread([d0, d1, d2], skews)
        assert set(spread) == {1, 2, 3}
        assert all(s == 0.0 for s in spread.values())

    def test_no_shared_anchor_gets_zero_skew(self, pkg, tm):
        d0 = _mk_dump("n0", [(1, "AA", 1_000_000_000)])
        d1 = _mk_dump("n1", [(9, "ZZ", 9_000_000_000)])
        assert tm.compute_skews([d0, d1]) == [0, 0]
        assert tm.anchor_spread([d0, d1], [0, 0]) == {}

    def test_alignment_warnings_flag_degenerate_overlap(self, pkg, tm):
        base = [(1, "AA", 1_000_000_000), (2, "BB", 2_000_000_000)]
        # healthy: >= 2 shared anchors, no warnings
        assert tm.alignment_warnings(
            [_mk_dump("n0", base), _mk_dump("n1", base, skew_ns=5_000)]
        ) == []
        # single dump: nothing to align, not a problem
        assert tm.alignment_warnings([_mk_dump("n0", base)]) == []
        # no dumps at all
        assert tm.alignment_warnings([]) == ["nothing to merge: no flight dumps"]
        # disjoint heights: no shared anchor, must be called out by name
        warns = tm.alignment_warnings([
            _mk_dump("n0", [(1, "AA", 1_000_000_000)]),
            _mk_dump("n1", [(9, "ZZ", 9_000_000_000)]),
        ])
        assert len(warns) == 1
        assert "n1" in warns[0] and "no commit anchors shared" in warns[0]
        # exactly one shared anchor: median is a single sample
        warns = tm.alignment_warnings([
            _mk_dump("n0", base),
            _mk_dump("n1", base[:1], skew_ns=5_000),
        ])
        assert len(warns) == 1
        assert "only 1 commit anchor" in warns[0]
        # reference itself committed nothing: alignment impossible anywhere
        warns = tm.alignment_warnings([
            _mk_dump("n0", []), _mk_dump("n1", base),
        ])
        assert any("reference node n0" in w for w in warns)

    def test_merge_carries_alignment_warnings(self, pkg, tm):
        d0 = _mk_dump("n0", [(1, "AA", 1_000_000_000)])
        d1 = _mk_dump("n1", [(9, "ZZ", 9_000_000_000)])
        merged = tm.merge([d0, d1])
        assert any(
            "no commit anchors shared" in w
            for w in merged["otherData"]["alignment_warnings"]
        )

    def test_differing_hash_is_not_an_anchor(self, pkg, tm):
        # same height, different hash (e.g. dump raced a re-org) must NOT
        # align clocks on a non-shared instant
        d0 = _mk_dump("n0", [(1, "AA", 1_000_000_000)])
        d1 = _mk_dump("n1", [(1, "XX", 5_000_000_000)])
        assert tm.compute_skews([d0, d1]) == [0, 0]

    def test_merge_emits_aligned_tracks(self, pkg, tm):
        base = [(1, "AA", 1_000_000_000), (2, "BB", 2_000_000_000)]
        d0 = _mk_dump("n0", base)
        d1 = _mk_dump("n1", base, skew_ns=7_000_000)
        merged = tm.merge([d0, d1])
        assert merged["displayTimeUnit"] == "ms"
        assert merged["otherData"]["nodes"] == ["n0", "n1"]
        assert merged["otherData"]["skews_ns"] == [0, 7_000_000]
        events = merged["traceEvents"]
        names = {(e["pid"], e["name"]) for e in events}
        for pid in (0, 1):
            assert (pid, "process_name") in names
            assert (pid, "commit") in names
        # skew-corrected commits of the same height coincide across tracks
        commits = [e for e in events if e["name"] == "commit"]
        by_height = {}
        for e in commits:
            by_height.setdefault(e["args"]["height"], []).append(e["ts"])
        for ts in by_height.values():
            assert len(ts) == 2 and abs(ts[0] - ts[1]) < 1e-6

    def test_streamed_write_byte_identical_to_json_dump(self, pkg, tm):
        import io
        import json

        base = [(1, "AA", 1_000_000_000), (2, "BB", 2_000_000_000)]
        dumps = [_mk_dump("n0", base), _mk_dump("n1", base, skew_ns=7_000)]
        traces = [None, {
            "anchor": {"wall_ns": 2_000_000_000, "perf_ns": 500_000_000},
            "traceEvents": [{"name": "span", "ph": "X", "pid": 9, "tid": 7,
                             "ts": 100.0, "dur": 5.0}],
        }]
        for d, t in [(dumps, None), (dumps, traces), ([], None),
                     ([_mk_dump("n0", [])], None)]:
            ref = io.StringIO()
            json.dump(tm.merge(d, t), ref)
            streamed = io.StringIO()
            n = tm.write_merged(streamed, d, t)
            assert streamed.getvalue() == ref.getvalue()
            assert n == len(tm.merge(d, t)["traceEvents"])

    def test_trace_events_rebased_to_wall_clock(self, pkg, tm):
        payload = {
            "anchor": {"wall_ns": 2_000_000_000, "perf_ns": 500_000_000},
            "traceEvents": [
                {"name": "span", "ph": "X", "pid": 99, "tid": 7,
                 "ts": 100.0, "dur": 5.0},
                {"name": "thread_name", "ph": "M", "pid": 99, "tid": 7,
                 "args": {"name": "w"}},
            ],
        }
        events = tm._trace_events(payload, pid=3, skew_ns=1_000_000)
        span = next(e for e in events if e["ph"] == "X")
        # perf->wall offset (1.5e9 ns) + skew (1e6 ns), in µs
        assert span["ts"] == 100.0 + 1_500_000.0 + 1_000.0
        assert span["pid"] == 3
        meta = next(e for e in events if e["ph"] == "M")
        assert meta["pid"] == 3 and "ts" not in meta
        # a payload without the anchor pair cannot be placed: dropped
        assert tm._trace_events({"traceEvents": [{}]}, 0, 0) == []


class TestTraceMergeAcrossPackages:
    def _dumps(self):
        base = [(1, "AA", 1_000_000_000), (2, "BB", 2_000_000_000), (3, "CC", 3_000_000_000)]
        d2 = _mk_dump("n2", base[1:], skew_ns=-3_000_000)
        for rec in d2["records"]:
            rec["prevote"].update(
                signed={"t": rec["commit"]["t"] - 500_000, "round": 0, "validator_index": 2},
                first_send={}, arrivals={}, contrib={}, dup_by_peer={})
        d0 = _mk_dump("n0", base)
        for rec in d0["records"]:
            rec["prevote"].update(
                signed=None, first_send={},
                arrivals={2: {"t": rec["commit"]["t"] - 200_000, "round": 0, "peer": "n2"}},
                contrib={}, dup_by_peer={"n2": 1})
        return [d0, _mk_dump("n1", base, skew_ns=5_000_000), d2]

    def test_merge_byte_identical(self):
        dumps = self._dumps()
        traces = [None, {"anchor": {"wall_ns": 2_000_000_000, "perf_ns": 500_000_000},
                         "traceEvents": [{"name": "span", "ph": "X", "pid": 9, "tid": 7,
                                          "ts": 100.0, "dur": 5.0}]}, None]
        r, p = io.StringIO(), io.StringIO()
        assert REF.trace_merge.write_merged(r, dumps, traces) == \
            PORT.trace_merge.write_merged(p, dumps, traces)
        assert r.getvalue() == p.getvalue()
        assert json.loads(r.getvalue())["otherData"]["skews_ns"] == [0, 5_000_000, -3_000_000]
        assert any(e.get("cat") == "flow" for e in json.loads(p.getvalue())["traceEvents"])

    def test_cli_reads_dump_files(self, tmp_path):
        paths = []
        for i, d in enumerate(self._dumps()):
            paths.append(str(tmp_path / f"n{i}.json"))
            with open(paths[-1], "w") as f:
                json.dump(d, f)
        out = str(tmp_path / "merged.json")
        assert trace_merge.main(paths + ["-o", out]) == 0
        with open(out) as f:
            assert json.load(f) == json.loads(json.dumps(
                REF.trace_merge.merge(self._dumps())))


# -- the port's net ----------------------------------------------------------------


def test_net_silenced_third_trips_the_watchdog():
    """The reference's flight smoke on the port's 4-node net: past height
    2, validators 2 and 3 fall silent (half the power); the watchdog on
    node 0 reports the stall, naming more than 1/3 of the power missing,
    and counts it once; the four dumps merge into a valid trace."""
    set_batch_verifier(HostBatchVerifier())
    net = consensus_net.Net()
    metrics = ConsensusMetrics()
    wd = None
    try:
        net.start()
        assert harness.wait_for(lambda: all(cs.get_state().last_block_height >= 2
                                            for cs, _, _ in net.nodes), timeout=60.0)
        wd = LivenessWatchdog(net.nodes[0][0], metrics=metrics, interval=0.2,
                              stall_factor=3.0, min_stall_seconds=1.5)
        wd.start()
        net.silenced.update({2, 3})
        assert harness.wait_for(lambda: wd.report() is not None, timeout=30.0)
        report = wd.report()
        dumps = [cs.flight.snapshot() for cs, _, _ in net.nodes]
    finally:
        if wd is not None:
            wd.stop()
        net.stop()
        set_batch_verifier(None)
    missing = report["missing_precommits"]
    assert missing["total_power"] == 40 and missing["power"] * 3 > missing["total_power"]
    assert {v["index"] for v in missing["validators"]} and report["peers"] == []
    assert "tendermint_consensus_stalls_total 1" in metrics.registry.expose_text()
    merged = trace_merge.merge(dumps)
    assert consensus_net.validate_chrome_trace(merged, 4, min_commits_per_node=2) == []
