"""The port's quorum observatory (``libs/quorumtrace.py``) and
``tools/quorum_report.py`` against the reference's on the same stamps.

Every class of ``tests/test_quorumtrace.py`` runs once on each package
through the ``pkg`` parameter (the reference's report is its script
``scripts/quorum_report.py``, loaded from the file; the port's is
``tendermint_tpu_torch.tools.quorum_report``): the reference test's
assertions hold on both. Where the reference's harness case loops over
validator indices until its node proposes (and skips when none does), the
restated case takes that index from the genesis, so it never skips. The
cross-package cases require the same journeys, curves, gossip ledger,
flush attribution and report from both packages on seeded dumps; the same
flush records from both packages' ``VoteFeed`` on the same votes (its
``"groups"`` lists of ``[height, round, vote_type]``, as
``flush_attribution`` reads them); and the port's 4-node net's live quorum
records re-derive from its flight dumps. The reference verifies with its
host verifier, the port with its host verifier on the net and the
configuration root's guarded verifier on ``device="cpu"`` elsewhere. Every
wait is bounded by a deadline.
"""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.consensus.messages import VoteMessage as RVoteMessage
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.libs import quorumtrace as rquorumtrace
from tendermint_tpu.libs.metrics import NodeMetrics
from tendermint_tpu.parallel import planner as rplanner
from tendermint_tpu.state import state_types as rst
from tendermint_tpu.types import BlockID as RBlockID
from tendermint_tpu.types import SignedMsgType as RSignedMsgType
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.consensus.messages import VoteMessage
from tendermint_tpu_torch.crypto.batch import HostBatchVerifier, set_batch_verifier
from tendermint_tpu_torch.libs import quorumtrace as pquorumtrace
from tendermint_tpu_torch.libs.metrics import ConsensusMetrics
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state import state_types as pst
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.testutil import consensus_net
from tendermint_tpu_torch.tools import quorum_report
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType

from tests import consensus_harness as rharness

DEADLINE = 60.0
_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _load_script(name):
    if _SCRIPTS not in sys.path:  # scripts import siblings by module name
        sys.path.insert(0, _SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(_SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _pkg(name, qt, metrics, report, **kw):
    return SimpleNamespace(
        name=name, QuorumTrace=qt.QuorumTrace, build_journeys=qt.build_journeys,
        completion_curve=qt.completion_curve, flush_attribution=qt.flush_attribution,
        gossip_ledger=qt.gossip_ledger, Metrics=metrics, quorum_report=report, **kw)


REF = _pkg("reference", rquorumtrace, NodeMetrics, _load_script("quorum_report"),
           h=rharness, st=rst, BlockID=RBlockID, SignedMsgType=RSignedMsgType,
           VoteMessage=RVoteMessage,
           vote_feed=lambda: rplanner.VoteFeed(use_device=False, window_s=30.0, max_rows=64))
PORT = _pkg("port", pquorumtrace, ConsensusMetrics, quorum_report,
            h=harness, st=pst, BlockID=BlockID, SignedMsgType=SignedMsgType,
            VoteMessage=VoteMessage,
            vote_feed=lambda: planner.VoteFeed(window_s=30.0, max_rows=64, device="cpu"))


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture()
def verifiers():
    """The reference's host verifier (as its suite's conftest installs it)
    and the port's guarded verifier on the CPU."""
    rset_batch_verifier(RHostBatchVerifier())
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield root
    verify_root.reset_verify()


def _slot(**kw):
    base = {"first": None, "last": None, "count": 0, "by_peer": {},
            "signed": None, "first_send": {}, "arrivals": {},
            "contrib": {}, "dup_by_peer": {}}
    base.update(kw)
    return base


def _rec(height, t0=1_000, **slots):
    rec = {"height": height, "rounds": [{"round": 0, "t": t0}],
           "proposal": None, "block_parts": None, "polka": None,
           "commit": None, "persist": None, "exec": None,
           "prevote": _slot(), "precommit": _slot()}
    rec.update(slots)
    return rec


def _dump(node_id, records):
    return {"node_id": node_id, "records": records}


# -- build_journeys ----------------------------------------------------------------


class TestBuildJourneys:
    def _two_node_dumps(self):
        """n0 signs vi=0 at t=1000 and sends it; n1 (clock 600ns behind the
        reference after correction math, i.e. skew +600 to add) saw it at
        its local t=500."""
        d0 = _dump("n0", [_rec(1, prevote=_slot(
            signed={"t": 1_000, "round": 0, "validator_index": 0},
            first_send={0: {"t": 1_050, "round": 0, "peer": "n1"}},
        ))])
        d1 = _dump("n1", [_rec(1, prevote=_slot(
            arrivals={0: {"t": 500, "round": 0, "peer": "n0"}},
            contrib={0: {"t": 520, "round": 0, "power": 10}},
        ))])
        return d0, d1

    def test_skew_correction_is_exact(self, pkg):
        d0, d1 = self._two_node_dumps()
        (j,) = pkg.build_journeys([d0, d1], {"n0": 0, "n1": 600})
        assert (j["height"], j["kind"], j["validator_index"]) == \
            (1, "prevote", 0)
        assert j["origin"] == "n0" and j["signed_ns"] == 1_000
        assert j["first_send"]["t_ns"] == 1_050
        # raw corrected stamp: EXACTLY receiver's stamp + its skew
        assert j["arrivals"]["n1"]["t_ns"] == 500 + 600
        assert j["arrivals"]["n1"]["t_mono_ns"] == 1_100  # already monotone
        assert j["contrib"]["n1"]["power"] == 10
        assert j["clamped"] is False

    def test_residual_inversion_clamps_monotone_view_only(self, pkg):
        d0, d1 = self._two_node_dumps()
        # under-corrected receiver: arrival lands "before" signing
        (j,) = pkg.build_journeys([d0, d1], {"n0": 0, "n1": 300})
        assert j["arrivals"]["n1"]["t_ns"] == 800  # raw kept for reconcile
        assert j["arrivals"]["n1"]["t_mono_ns"] == 1_050  # clamped to send
        assert j["clamped"] is True

    def test_first_send_clamps_and_floors_arrivals(self, pkg):
        d0 = _dump("n0", [_rec(1, prevote=_slot(
            signed={"t": 2_000, "round": 0, "validator_index": 0},
            first_send={0: {"t": 1_900, "round": 0, "peer": "n1"}},
        ))])
        (j,) = pkg.build_journeys([d0], {})
        assert j["first_send"]["t_ns"] == 1_900
        assert j["first_send"]["t_mono_ns"] == 2_000
        assert j["clamped"] is True

    def test_json_round_trip_string_keys(self, pkg):
        d0, d1 = self._two_node_dumps()
        wire = [json.loads(json.dumps(d)) for d in (d0, d1)]
        assert pkg.build_journeys(wire, {"n0": 0, "n1": 600}) == \
            pkg.build_journeys([d0, d1], {"n0": 0, "n1": 600})

    def test_originless_journey_is_not_clamped(self, pkg):
        _, d1 = self._two_node_dumps()
        (j,) = pkg.build_journeys([d1], {"n1": 600})
        assert j["origin"] is None and j["signed_ns"] is None
        assert j["arrivals"]["n1"]["t_mono_ns"] == \
            j["arrivals"]["n1"]["t_ns"]
        assert j["clamped"] is False

    def test_sorted_by_height_kind_validator(self, pkg):
        d = _dump("n0", [
            _rec(2, prevote=_slot(
                arrivals={1: {"t": 5, "round": 0, "peer": "p"},
                          0: {"t": 6, "round": 0, "peer": "p"}})),
            _rec(1, precommit=_slot(
                arrivals={0: {"t": 1, "round": 0, "peer": "p"}})),
        ])
        keys = [(j["height"], j["kind"], j["validator_index"])
                for j in pkg.build_journeys([d])]
        assert keys == sorted(keys)


# -- completion_curve --------------------------------------------------------------


def _contrib_rec(arrivals, height=1, t0=0, kind="precommit"):
    contrib = {vi: {"t": t, "round": 0, "power": p}
               for t, vi, p in arrivals}
    return _rec(height, t0=t0, **{kind: _slot(contrib=contrib)})


class TestCompletionCurve:
    def test_strict_two_thirds_boundary(self, pkg):
        # 3 of 30 power-10 arrivals: 20/30 is EXACTLY 2/3 -> must not cross
        rec = _contrib_rec([(10, 0, 10), (20, 1, 10), (30, 2, 10)])
        curve = pkg.completion_curve(rec, "precommit", 30)
        cr = curve["crossings"]
        assert cr["third"]["validator_index"] == 0  # 10*3 >= 30
        assert cr["half"]["validator_index"] == 1   # 20*2 >= 30
        assert cr["two_thirds"]["validator_index"] == 2  # 20*3 > 60 is False
        assert cr["two_thirds"]["cum_power"] == 30
        assert curve["pivotal_validator"] == 2
        assert curve["present"] == [0, 1, 2]

    def test_pivotal_is_a_pure_function_of_the_stamps(self, pkg):
        rec = _contrib_rec([(30, 2, 10), (10, 0, 10), (20, 1, 10)])
        first = pkg.completion_curve(rec, "precommit", 30)
        again = pkg.completion_curve(rec, "precommit", 30)
        assert first == again
        # insertion order of the contrib dict is irrelevant: arrivals sort
        # by (t, vi, power) before accumulation
        shuffled = _contrib_rec([(20, 1, 10), (30, 2, 10), (10, 0, 10)])
        assert pkg.completion_curve(shuffled, "precommit", 30) == first

    def test_seconds_measured_from_round_entry(self, pkg):
        rec = _contrib_rec(
            [(2_000_000_000, 0, 10), (3_000_000_000, 1, 10),
             (4_500_000_000, 2, 10)],
            t0=1_000_000_000,
        )
        curve = pkg.completion_curve(rec, "precommit", 30)
        assert curve["crossings"]["two_thirds"]["seconds"] == \
            pytest.approx(3.5)

    def test_skew_shifts_stamps_not_durations(self, pkg):
        rec = _contrib_rec([(10, 0, 10), (20, 1, 10), (30, 2, 10)], t0=5)
        a = pkg.completion_curve(rec, "precommit", 30)
        b = pkg.completion_curve(rec, "precommit", 30, skew_ns=1_000)
        assert b["t0_ns"] == a["t0_ns"] + 1_000
        assert b["crossings"]["two_thirds"]["t_ns"] == \
            a["crossings"]["two_thirds"]["t_ns"] + 1_000
        assert b["crossings"]["two_thirds"]["seconds"] == \
            a["crossings"]["two_thirds"]["seconds"]

    def test_none_without_rounds_contrib_or_power(self, pkg):
        assert pkg.completion_curve(_rec(1), "prevote", 30) is None
        rec = _contrib_rec([(10, 0, 10)])
        rec["rounds"] = []
        assert pkg.completion_curve(rec, "precommit", 30) is None
        assert pkg.completion_curve(
            _contrib_rec([(10, 0, 10)]), "precommit", 0) is None

    def test_incomplete_quorum_names_no_pivotal(self, pkg):
        rec = _contrib_rec([(10, 0, 10), (20, 1, 10)])
        curve = pkg.completion_curve(rec, "precommit", 30)
        assert curve["crossings"]["two_thirds"] is None
        assert curve["pivotal_validator"] is None
        assert curve["present_power"] == 20

    def test_json_round_trip_string_keys(self, pkg):
        rec = json.loads(json.dumps(
            _contrib_rec([(10, 0, 10), (20, 1, 10), (30, 2, 10)])
        ))
        assert pkg.completion_curve(rec, "precommit", 30)[
            "pivotal_validator"] == 2


# -- gossip_ledger -----------------------------------------------------------------


class TestGossipLedger:
    def test_waste_ratio_and_links(self, pkg):
        d0 = _dump("n0", [_rec(1, prevote=_slot(
            arrivals={1: {"t": 10, "round": 0, "peer": "n1"},
                      2: {"t": 12, "round": 0, "peer": "n2"}},
            dup_by_peer={"n1": 3},
        ))])
        ledger = pkg.gossip_ledger([d0])
        assert ledger["first_sightings"] == 2
        assert ledger["duplicates"] == 3
        assert ledger["waste_ratio"] == pytest.approx(1.5)
        by_link = {(l["peer"], l["node"]): l for l in ledger["links"]}
        assert by_link[("n1", "n0")]["first_sightings"] == 1
        assert by_link[("n1", "n0")]["duplicates"] == 3
        assert by_link[("n2", "n0")]["duplicates"] == 0

    def test_latency_joined_from_journeys(self, pkg):
        d0 = _dump("n0", [_rec(1, prevote=_slot(
            signed={"t": 1_000, "round": 0, "validator_index": 0},
        ))])
        d1 = _dump("n1", [_rec(1, prevote=_slot(
            arrivals={0: {"t": 1_500, "round": 0, "peer": "n0"}},
        ))])
        journeys = pkg.build_journeys([d0, d1])
        ledger = pkg.gossip_ledger([d0, d1], journeys=journeys)
        (link,) = [l for l in ledger["links"] if l["latency_samples"]]
        assert (link["peer"], link["node"]) == ("n0", "n1")
        assert link["latency_p50_s"] == pytest.approx(500 / 1e9)

    def test_empty_dumps(self, pkg):
        ledger = pkg.gossip_ledger([])
        assert ledger["waste_ratio"] == 0.0 and ledger["links"] == []


# -- flush_attribution -------------------------------------------------------------


class TestFlushAttribution:
    def test_joins_on_height(self, pkg):
        flushes = {"records": [
            {"reason": "window", "groups": [[1, 0, 1], [1, 0, 2]]},
            {"reason": "rows", "groups": [[2, 0, 1]]},
            {"reason": "window", "groups": [["2", "0", "2"]]},  # wire strs
        ]}
        assert [f["reason"] for f in pkg.flush_attribution(flushes, 2)] == \
            ["rows", "window"]
        assert pkg.flush_attribution(flushes, 9) == []

    def test_none_and_empty(self, pkg):
        assert pkg.flush_attribution(None, 1) == []
        assert pkg.flush_attribution({"records": []}, 1) == []


# -- pkg.QuorumTrace (live analyzer) ---------------------------------------------------


class _FakeFlight:
    def __init__(self, rec, node_id="n0", enabled=True):
        self.enabled = enabled
        self.node_id = node_id
        self._rec = rec

    def peek(self, height):
        if isinstance(self._rec, Exception):
            raise self._rec
        return self._rec if self._rec and \
            self._rec.get("height") == height else None


class _FakeValset:
    def __init__(self, total):
        self._total = total

    def total_voting_power(self):
        return self._total


class _FakeFeed:
    def __init__(self, records):
        self._records = records

    def flush_records(self):
        return {"records": self._records}


class TestQuorumTrace:
    def _rec(self):
        return _contrib_rec([(10, 0, 10), (20, 1, 10), (30, 2, 10)])

    def test_analyze_records_curves_and_metrics(self, pkg):
        nm = pkg.Metrics()
        qt = pkg.QuorumTrace(metrics=nm)
        out = qt.on_height_complete(
            1, _FakeFlight(self._rec()), validators=_FakeValset(30),
            vote_feed=_FakeFeed([{"reason": "window", "groups": [[1, 0, 2]]}]),
        )
        assert out is not None and len(qt) == 1
        assert qt.node_id == "n0"
        curve = out["curves"]["precommit"]
        assert curve["pivotal_validator"] == 2
        assert curve["total_power"] == 30
        assert [f["reason"] for f in out["flushes"]] == ["window"]
        text = nm.registry.expose_text()
        assert ('tendermint_consensus_quorum_time_to_two_thirds_seconds_count'
                '{type="precommit"} 1') in text
        assert ('tendermint_consensus_quorum_time_to_third_seconds_count'
                '{type="precommit"} 1') in text

    def test_no_valset_scales_by_arrived_power(self, pkg):
        qt = pkg.QuorumTrace()
        out = qt.on_height_complete(1, _FakeFlight(self._rec()))
        # record says the valset total was unknown; the curve scaled by
        # the power that DID arrive, so the last arrival is pivotal
        assert out["total_power"] == 0
        assert out["curves"]["precommit"]["total_power"] == 30
        assert out["curves"]["precommit"]["pivotal_validator"] == 2

    def test_disabled_flight_and_missing_record_are_none(self, pkg):
        qt = pkg.QuorumTrace()
        assert qt.on_height_complete(
            1, _FakeFlight(self._rec(), enabled=False)) is None
        assert qt.on_height_complete(9, _FakeFlight(self._rec())) is None
        assert len(qt) == 0

    def test_never_raises_into_consensus(self, pkg):
        qt = pkg.QuorumTrace()
        assert qt.on_height_complete(
            1, _FakeFlight(RuntimeError("boom"))) is None
        assert qt.analysis_errors == 1

    def test_ring_eviction_and_snapshot_contract(self, pkg):
        qt = pkg.QuorumTrace(capacity=2)
        for h in (1, 2, 3):
            rec = self._rec()
            rec["height"] = h
            qt.on_height_complete(h, _FakeFlight(rec))
        snap = qt.snapshot()
        assert snap["total_records"] == 2 and snap["evicted"] == 1
        assert [r["height"] for r in snap["records"]] == [2, 3]
        cut = qt.snapshot(limit=1)
        assert cut["truncated"] is True
        assert [r["height"] for r in cut["records"]] == [3]
        assert qt.snapshot(limit=0)["records"] == []
        # the rolling percentile window is sized independently of the
        # record ring: all 3 heights still sample the stats
        stats = snap["quorum_stats"]["precommit"]
        assert stats["n"] == 3
        assert stats["two_thirds_p99_seconds"] is not None

    def test_reset_clears_and_validates_capacity(self, pkg):
        qt = pkg.QuorumTrace()
        qt.on_height_complete(1, _FakeFlight(self._rec()))
        qt.reset(capacity=4)
        assert len(qt) == 0 and qt.capacity == 4
        with pytest.raises(ValueError):
            qt.reset(capacity=0)
        with pytest.raises(ValueError):
            pkg.QuorumTrace(capacity=-1)


# -- quorum_report fusion ----------------------------------------------------------


class TestQuorumReport:
    @pytest.fixture()
    def qr(self, pkg):
        return pkg.quorum_report

    def _quorum_dump(self, node_id, pivotal, present, height=1):
        return {"node_id": node_id, "records": [{
            "height": height, "node_id": node_id, "total_power": 30,
            "curves": {"precommit": {
                "height": height, "kind": "precommit", "t0_ns": 0,
                "total_power": 30, "present_power": 30,
                "present": present,
                "crossings": {"third": None, "half": None,
                              "two_thirds": {"t_ns": 30, "seconds": 0.03,
                                             "validator_index": pivotal,
                                             "cum_power": 30}},
                "pivotal_validator": pivotal,
            }},
            "gossip": {"first_sightings": 2, "duplicates": 1,
                       "dup_by_peer": {"x": 1}},
            "flushes": [],
        }], "quorum_stats": {}}

    def test_absent_sweep_and_pivotal_majority(self, pkg, qr):
        flights = [_dump("n0", [_rec(1)]), _dump("n1", [_rec(1)])]
        quorums = [self._quorum_dump("n0", 2, [0, 1, 2]),
                   self._quorum_dump("n1", 1, [0, 1, 2])]
        report = qr.build_report(flights, quorums, n_validators=4)
        entry = report["heights"]["1"]
        assert entry["absent_validators"] == [3]
        # 1-1 tie between pivotal 1 and 2 -> deterministic lower index
        assert entry["pivotal"]["precommit"] == 1
        assert qr.absent_everywhere(report) == [3]

    def test_n_validators_inferred_from_dumps(self, pkg, qr):
        flights = [_dump("n0", [_rec(1)])]
        quorums = [self._quorum_dump("n0", 2, [0, 1, 2])]
        report = qr.build_report(flights, quorums)
        assert report["n_validators"] == 3
        assert report["heights"]["1"]["absent_validators"] == []

    def test_no_heights_means_no_absent_claim(self, pkg, qr):
        report = qr.build_report([_dump("n0", [])], [])
        assert qr.absent_everywhere(report) == []


# -- harness tier ------------------------------------------------------------------


def proposer_index(pkg, n_vals):
    """The index, in the sorted set, of the proposer of height 1 round 0."""
    doc, _ = pkg.h.make_genesis(n_vals)
    vals = pkg.st.state_from_genesis(doc).validators
    return [v.address for v in vals.validators].index(vals.get_proposer().address)


class TestQuorumTraceHarness:
    def test_live_record_rederives_from_flight_dump(self, pkg, verifiers):
        """Commit height 1 with scripted peer votes: the analyzer's curve
        must name a pivotal validator whose crossing satisfies the strict
        2/3 rule and re-derive bit-identically from the flight record."""
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
            for kind in (pkg.SignedMsgType.PREVOTE, pkg.SignedMsgType.PRECOMMIT):
                for stub in stubs:
                    vote = stub.sign_vote(kind, bid, 1, 0)
                    cs.send_peer_msg(pkg.VoteMessage(vote), f"peer{stub.index}")
            assert pkg.h.wait_for(lambda: len(cs.quorumtrace) >= 1, timeout=DEADLINE), \
                "quorum analyzer never recorded the committed height"
            (qrec,) = [r for r in cs.quorumtrace.records() if r["height"] == 1]
            assert qrec["node_id"] == "me"
            frec = cs.flight.peek(1)
            for kind in ("prevote", "precommit"):
                curve = qrec["curves"][kind]
                assert curve["pivotal_validator"] is not None
                assert curve["total_power"] == qrec["total_power"] > 0
                # deterministic re-derivation from the dump
                redo = pkg.completion_curve(frec, kind, curve["total_power"])
                assert redo["pivotal_validator"] == curve["pivotal_validator"]
                assert redo["crossings"] == curve["crossings"]
                # the height finalizes once strict 2/3 lands, so at
                # least 3 of 4 equal-power validators contributed
                # (the 4th vote may arrive after the analyzer ran)
                assert len(curve["present"]) >= 3
                assert set(curve["present"]) <= {0, 1, 2, 3}
                assert curve["crossings"]["two_thirds"]["cum_power"] \
                    * 3 > curve["total_power"] * 2
                # the crossing lies at or before the commit stamp
                assert curve["crossings"]["two_thirds"]["t_ns"] <= frec["commit"]["t"]
        finally:
            cs.stop()
            bus.stop()


# -- across the packages ----------------------------------------------------------


def _seeded_dumps(seed, nodes=4, heights=6):
    """Flight dumps of ``nodes`` nodes over ``heights`` heights with seeded
    journey stamps: signed, first sends, arrivals (some duplicated),
    contributions with powers, each node's clock skewed."""
    rng = np.random.default_rng(seed)
    skew = [0] + [int(x) for x in rng.integers(-5_000_000, 5_000_000, nodes - 1)]
    dumps = []
    for n in range(nodes):
        recs = []
        for h in range(1, heights + 1):
            t0 = 1_000_000_000 * h - skew[n]
            rec = _rec(h, t0=t0)
            for kind in ("prevote", "precommit"):
                base = t0 + (1 if kind == "prevote" else 40) * 1_000_000
                arrivals, contrib, dups = {}, {}, {}
                for v in range(nodes):
                    t = base + int(rng.integers(-2_000_000, 30_000_000))
                    if v != n:
                        arrivals[v] = {"t": t, "round": 0, "peer": f"n{v}"}
                        if rng.random() < 0.3:
                            dups[f"n{(v + 1) % nodes}"] = dups.get(f"n{(v + 1) % nodes}", 0) + 1
                    if rng.random() < 0.9:
                        contrib[v] = {"t": t + 1000, "round": 0,
                                      "power": int(rng.integers(1, 20))}
                rec[kind] = _slot(
                    signed={"t": base - 1000, "round": 0, "validator_index": n},
                    first_send={n: {"t": base - 500, "round": 0, "peer": f"n{(n + 1) % nodes}"}},
                    arrivals=arrivals, contrib=contrib, dup_by_peer=dups)
            rec["commit"] = {"t": t0 + 90_000_000, "round": 0, "hash": f"H{h}"}
            recs.append(rec)
        dumps.append(_dump(f"n{n}", recs))
    return json.loads(json.dumps(dumps))  # string keys, as over the wire


class TestAcrossPackages:
    @pytest.mark.parametrize("seed", [5, 6])
    def test_fusion_equal(self, seed):
        dumps = _seeded_dumps(seed)
        skews = {f"n{i}": s for i, s in
                 enumerate(REF.quorum_report.trace_merge.compute_skews(dumps))}
        rj = REF.build_journeys(dumps, skews)
        pj = PORT.build_journeys(dumps, skews)
        assert rj == pj and any(j["clamped"] for j in pj)
        assert REF.gossip_ledger(dumps, skews, rj) == PORT.gossip_ledger(dumps, skews, pj)
        for rec in dumps[0]["records"]:
            for kind in ("prevote", "precommit"):
                for total in (0, 40, 57):
                    assert REF.completion_curve(rec, kind, total, 7) == \
                        PORT.completion_curve(rec, kind, total, 7)

    def test_report_and_live_analyzer_equal(self):
        dumps = _seeded_dumps(9)
        flushes = {"records": [{"reason": "deadline", "groups": [[h, 0, 2], [h - 1, 0, 2]]}
                               for h in range(1, 7)]}
        quorums = []
        for pkg in (REF, PORT):
            snaps = []
            for d in dumps:
                qt = pkg.QuorumTrace(capacity=4, metrics=pkg.Metrics())
                flight = _FakeFlightDump(d)
                for h in range(1, 7):
                    assert qt.on_height_complete(h, flight, _FakeValset(40),
                                                 _FakeFeed(flushes["records"])) is not None
                snaps.append(json.loads(json.dumps(qt.snapshot())))
            quorums.append(snaps)
        assert quorums[0] == quorums[1]
        r = REF.quorum_report.build_report(dumps, quorums[0], n_validators=5)
        p = PORT.quorum_report.build_report(dumps, quorums[1], n_validators=5)
        assert r == p
        assert REF.quorum_report.absent_everywhere(r) == \
            PORT.quorum_report.absent_everywhere(p) == [4]
        for h in range(1, 7):
            assert REF.flush_attribution(flushes, h) == PORT.flush_attribution(flushes, h)

    def test_cli_reads_snapshot_files(self, tmp_path):
        dumps = _seeded_dumps(3, nodes=2, heights=2)
        paths = []
        for i, d in enumerate(dumps):
            paths.append(str(tmp_path / f"f{i}.json"))
            with open(paths[-1], "w") as f:
                json.dump(d, f)
        out = str(tmp_path / "report.json")
        assert quorum_report.main(["--flight", ",".join(paths), "-o", out]) == 0
        with open(out) as f:
            assert json.load(f) == json.loads(json.dumps(
                REF.quorum_report.build_report(dumps, [])))

    def test_vote_feed_flush_records_equal(self, verifiers):
        """The same votes, in the same order, through each package's
        VoteFeed: the same flush records but for their stamps, whose
        groups are [height, round, vote_type] lists."""
        recs = []
        for pkg in (REF, PORT):
            doc, pvs = pkg.h.make_genesis(4)
            vals = pkg.st.state_from_genesis(doc).validators
            feed = pkg.vote_feed()
            tickets = []
            try:
                for h, vtype in ((1, pkg.SignedMsgType.PREVOTE), (1, pkg.SignedMsgType.PRECOMMIT),
                                 (2, pkg.SignedMsgType.PREVOTE)):
                    for i, pv in enumerate(pvs[:3]):
                        stub = pkg.h.ValidatorStub(pv, i)
                        bid = pkg.BlockID(hash=bytes([h]) * 32,
                                          parts_header=pkg.BlockID().parts_header)
                        vote = stub.sign_vote(vtype, bid, h, 0)
                        tickets.append(feed.submit(
                            (h, 0, int(vtype)), pv.get_pub_key(),
                            vote.sign_bytes(pkg.h.CHAIN_ID), vote.signature,
                            power=10, total=vals.total_voting_power()))
                    if h == 1:
                        feed.flush_now()
                        for t in tickets:
                            t.result(DEADLINE)
                feed.flush_now()
                assert all(t.result(DEADLINE).ok for t in tickets)
                out = feed.flush_records()
            finally:
                feed.close()
                feed.join(DEADLINE)
            for r in out["records"]:
                assert r["t_open_ns"] <= r["t_flush_ns"]
                for k in ("t_open_ns", "t_flush_ns", "wait_max_s", "wait_mean_s"):
                    r.pop(k)
            recs.append(out)
        assert recs[0] == recs[1]
        groups = [g for r in recs[1]["records"] for g in r["groups"]]
        assert sorted(groups) == [[1, 0, 1], [1, 0, 2], [2, 0, 1]]
        for h in (1, 2):
            assert PORT.flush_attribution(recs[1], h) == REF.flush_attribution(recs[0], h)


class _FakeFlightDump:
    """A flight recorder that serves the records of one dump."""

    def __init__(self, dump):
        self.enabled = True
        self.node_id = dump["node_id"]
        self._by_h = {r["height"]: r for r in dump["records"]}

    def peek(self, height):
        return self._by_h.get(height)


# -- the port's net ----------------------------------------------------------------


def test_net_quorum_records_rederive_and_report(tmp_path):
    """Three heights on the port's 4-node net (one shared clock): every
    node's live quorum record re-derives from its flight dump, each 2/3
    crossing lies at or before the node's commit stamp, and the report
    over the four dumps names no validator absent."""
    set_batch_verifier(HostBatchVerifier())
    net = consensus_net.Net()
    try:
        net.start()
        assert harness.wait_for(lambda: all(cs.get_state().last_block_height >= 3
                                            for cs, _, _ in net.nodes), timeout=DEADLINE)
        flights = [cs.flight.snapshot() for cs, _, _ in net.nodes]
        quorums = [cs.quorumtrace.snapshot() for cs, _, _ in net.nodes]
    finally:
        net.stop()
        set_batch_verifier(None)
    for f, q in zip(flights, quorums):
        assert q["analysis_errors"] == 0 and q["total_records"] >= 3
        by_h = {r["height"]: r for r in f["records"]}
        for rec in q["records"]:
            frec = by_h[rec["height"]]
            for kind, curve in rec["curves"].items():
                redo = PORT.completion_curve(frec, kind, curve["total_power"])
                assert redo["crossings"] == curve["crossings"]
                two = curve["crossings"]["two_thirds"]
                assert two is not None and two["t_ns"] <= frec["commit"]["t"]
    report = quorum_report.build_report(flights, quorums, n_validators=4)
    assert report == REF.quorum_report.build_report(flights, quorums, n_validators=4)
    assert quorum_report.absent_everywhere(report) == []
    assert report["alignment_warnings"] == []
