"""The port's per-height instruments as the configuration root wires them:
``node/verify_root.consensus_state`` with an ``[instrumentation]``
section, the instruments in a running ``ConsensusState``, and the
exposition of their metrics.

The recorder is off by default and every hook then records nothing; with
``flight_recorder`` on, the root names it and enables it, hands back an
unstarted ``LivenessWatchdog`` and (with ``telemetry_spool`` on) a
``TelemetrySpool`` under ``root_dir``. A node with the ``[verify]`` vote
feed on the CPU, its flushes through the root's guarded verifier on the
kernels' plain versions at ``dispatch_deadline=0``, commits 3 heights: each has a waterfall that
reconciles, its vote-feed flushes land in its ``verify_dispatch`` overlay
from height 2 on and in its quorum record's flushes, and its 2/3 crossing
lies before its commit stamp. An analyzer that raises is counted and the
heights still commit. The new metrics lint clean under the reference's
``scripts/metrics_lint.py``, loaded from the file. Every wait is bounded by
a deadline.
"""

import importlib.util
import os

import pytest

from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.consensus import consensus_test_config
from tendermint_tpu_torch.config.instrumentation import InstrumentationConfig
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.consensus.cstypes import RoundStepType
from tendermint_tpu_torch.consensus.messages import VoteMessage
from tendermint_tpu_torch.crypto.batch import HostBatchVerifier, set_batch_verifier
from tendermint_tpu_torch.libs import critpath
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.metrics import ConsensusMetrics, Registry, TelemetryMetrics
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.libs.telemetry import TelemetrySpool, read_spool
from tendermint_tpu_torch.libs.watchdog import LivenessWatchdog
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType
from tendermint_tpu_torch.types.events import EventBus

DEADLINE = 60.0
N_VALS = 4
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint_text():
    spec = importlib.util.spec_from_file_location(
        "metrics_lint", os.path.join(_ROOT, "scripts", "metrics_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lint_text


class Node:
    """One validator wired as ``node/verify_root`` wires one, with the
    other validators as stubs: a state DB and a KVStoreApp at genesis, the
    mempool, the executor, a block store, then ``consensus_state``."""

    def __init__(self, tmp_path, inst=None, verify_cfg=None, with_wal=True):
        doc, pvs = harness.make_genesis(N_VALS)
        st0 = state_from_genesis(doc)
        by_addr = {pv.address: pv for pv in pvs}
        pvs = [by_addr[v.address] for v in st0.validators.validators]
        ours = 0
        self.state_db = MemDB()
        sm_store.save_state(self.state_db, st0)
        self.conn = MultiAppConn(LocalClientCreator(KVStoreApp()))
        self.conn.start()
        self.mp = Mempool(self.conn.mempool)
        self.bus = EventBus()
        self.bus.start()
        evpool, ex = verify_root.block_executor(self.state_db, MemDB(), self.conn, self.mp,
                                                st0, event_bus=self.bus)
        self.metrics = ConsensusMetrics()
        self.root = verify_root.consensus_state(
            consensus_test_config(), verify_cfg, st0, ex, BlockStore(MemDB()), self.mp,
            evpool, wal_file=str(tmp_path / "cs.wal" / "wal") if with_wal else None,
            event_bus=self.bus, priv_validator=pvs[ours], metrics=self.metrics,
            device="cpu", instrumentation=inst, node_id="n0", root_dir=str(tmp_path))
        self.cs = self.root.consensus_state
        self.stubs = [harness.ValidatorStub(pv, i) for i, pv in enumerate(pvs) if i != ours]
        self.by_addr = {s.address: s for s in self.stubs}

    def run(self, heights):
        """Each height: once the node has entered its round, the stub
        proposer's proposal (when the node does not propose), then the
        stubs' prevotes and precommits; waits for the commit."""
        cs = self.cs
        cs.start()
        for h in range(1, heights + 1):
            assert harness.wait_for(
                lambda: cs.rs.height == h and cs.rs.step != RoundStepType.NEW_HEIGHT,
                DEADLINE), f"height {h} never started its round"
            proposer = cs.get_round_state().validators.get_proposer().address
            if proposer != cs.priv_validator.address:
                stub = self.by_addr[proposer]
                prop, block, parts = harness.decide_proposal(cs, stub, h, 0)
                cs.set_proposal_and_block(prop, block, parts, f"peer{stub.index}")
                bid = prop.block_id
            else:
                assert harness.wait_for(lambda: cs.get_round_state().proposal_block is not None,
                                        DEADLINE)
                rs = cs.get_round_state()
                bid = BlockID(rs.proposal_block.hash(), rs.proposal_block_parts.header())
            for vtype in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
                for s in self.stubs:
                    cs.send_peer_msg(VoteMessage(s.sign_vote(vtype, bid, h, 0)),
                                     f"peer{s.index}")
            assert harness.wait_for(lambda: cs.get_state().last_block_height >= h, DEADLINE), \
                f"height {h} never committed (fault {cs.device_fault})"
            assert harness.wait_for(lambda: (cs.flight.peek(h) or {}).get("exec") is not None
                                    or not cs.flight.enabled, DEADLINE)

    def stop(self):
        for svc in (self.root.watchdog, self.root.telemetry_spool):
            if svc is not None and svc._thread is not None:
                svc.stop()
        if self.cs.is_running:
            self.cs.stop()
            self.cs.wait_done(DEADLINE)
        if self.root.vote_feed is not None:
            self.root.vote_feed.close()
            self.root.vote_feed.join(DEADLINE)
        self.conn.stop()
        self.bus.stop()


@pytest.fixture()
def host_verifier():
    set_batch_verifier(HostBatchVerifier())
    yield
    set_batch_verifier(None)


def test_recorder_off_by_default(tmp_path, host_verifier, monkeypatch):
    monkeypatch.delenv("TM_FLIGHT", raising=False)
    node = Node(tmp_path)
    try:
        assert node.cs.flight.enabled is False and node.cs.flight.node_id == "n0"
        # the section's defaults: a watchdog built, unstarted; no spool
        assert isinstance(node.root.watchdog, LivenessWatchdog)
        assert node.root.watchdog._thread is None and node.root.watchdog.cons is node.cs
        assert node.root.telemetry_spool is None
        node.run(2)
        assert len(node.cs.flight) == 0
        assert len(node.cs.critpath) == 0 and len(node.cs.quorumtrace) == 0
        assert node.cs.critpath.analysis_errors == node.cs.quorumtrace.analysis_errors == 0
    finally:
        node.stop()


def test_instrumentation_section_wires_everything(tmp_path, host_verifier):
    inst = InstrumentationConfig(flight_recorder=True, watchdog=True, watchdog_interval=0.05,
                                 watchdog_stall_factor=7.0, watchdog_min_stall_seconds=30.0,
                                 telemetry_spool=True, telemetry_spool_interval_heights=1,
                                 telemetry_spool_interval_seconds=0.0,
                                 telemetry_spool_ring_capacity=8)
    node = Node(tmp_path, inst)
    wd, spool = node.root.watchdog, node.root.telemetry_spool
    try:
        assert node.cs.flight.enabled and node.cs.flight.node_id == "n0"
        assert wd.cons is node.cs and wd.switch is None and wd.metrics is node.metrics
        assert (wd.interval, wd.stall_factor, wd.min_stall_seconds) == (0.05, 7.0, 30.0)
        assert wd._thread is None and spool._thread is None  # the caller starts them
        assert isinstance(spool, TelemetrySpool) and isinstance(spool.metrics, TelemetryMetrics)
        assert spool.path == os.path.join(str(tmp_path), inst.telemetry_spool_path)
        assert spool.ring_capacity == 8 and spool.interval_heights == 1
        wd.start()
        spool.start()
        node.run(3)
        assert wd.status()["stalled"] is False and wd.status()["stalls_total"] == 0
        assert len(node.cs.critpath) == 3 and len(node.cs.quorumtrace) == 3
    finally:
        node.stop()
    out = read_spool(spool.path)
    assert out["corrupt_frames"] == 0 and out["snapshots"]
    assert out["snapshots"][-1]["reason"] == "shutdown"
    assert all(s["node_id"] == "n0" and s["spool"]["node_id"] == "n0"
               for s in out["snapshots"])
    text = node.metrics.registry.expose_text()
    assert "tendermint_consensus_stalls_total 0" in text
    assert "tendermint_telemetry_snapshots_total" in text
    assert _lint_text()(text) == []


def test_relative_spool_path_needs_root_dir(host_verifier):
    doc, pvs = harness.make_genesis(1)
    cs, bus = harness.make_cs_from_genesis(doc, pvs[0])
    try:
        with pytest.raises(ValueError):
            verify_root.consensus_state(
                consensus_test_config(), None, cs.state, cs.block_exec, cs.block_store,
                cs.mempool, cs.evpool, event_bus=bus, device="cpu",
                instrumentation=InstrumentationConfig(telemetry_spool=True))
    finally:
        bus.stop()


def test_vote_feed_flushes_land_in_the_waterfall(tmp_path):
    """The [verify] vote feed on the plain versions: from height 2 on,
    each height's flushes reach its verify_dispatch overlay."""
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    get_profiler().reset()
    inst = InstrumentationConfig(flight_recorder=True, watchdog=False)
    node = Node(tmp_path, inst, VerifyConfig(vote_batch_window_ms=2.0, vote_batch_rows=64))
    try:
        assert node.root.vote_feed is not None and node.root.watchdog is None
        # the flushes go to the root's guarded verifier, as on the card
        # (on the CPU the feed would default to the host RLC verifier)
        node.root.vote_feed.verifier = root.verifier
        node.run(3)
        snap = node.cs.critpath.snapshot()
        qsnap = node.cs.quorumtrace.snapshot()
        feed = node.root.vote_feed
    finally:
        node.stop()
        verify_root.reset_verify()
    assert feed.dispatches > 0
    assert snap["analysis_errors"] == 0 and qsnap["analysis_errors"] == 0
    # each flush's profiler entry carries the heights it verified, and each
    # overlay is critpath's join over the entries recorded before that
    # height's analysis: a prefix of them in record order
    entries = [e for e in get_profiler().entries() if e["kind"] == feed.profile_kind]
    assert len(entries) == feed.dispatches
    assert all(1 <= e["height_base"] <= e["height_base"] + max(e["heights"], 1) - 1 <= 3
               for e in entries)
    for wf in snap["records"]:
        assert any(critpath.verify_seconds_for_height(entries[:k], wf["height"])
                   == pytest.approx(wf["verify_dispatch_seconds"], abs=1e-9)
                   for k in range(len(entries) + 1)), wf["height"]
    assert [wf["height"] for wf in snap["records"]] == [1, 2, 3]
    for wf in snap["records"]:
        timeline = sum(wf["phases"][p] for p in critpath.TIMELINE_PHASES)
        assert timeline + wf["other_seconds"] == pytest.approx(wf["wall_seconds"], abs=1e-6)
        assert wf["wal_appends"] > 0
        if wf["height"] >= 2:
            assert wf["verify_dispatch_seconds"] > 0.0, wf
    flights = {r["height"]: r for r in node.cs.flight.records()}
    for rec in qsnap["records"]:
        h = rec["height"]
        assert rec["total_power"] == 10 * N_VALS
        two = rec["curves"]["precommit"]["crossings"]["two_thirds"]
        assert two is not None and two["t_ns"] <= flights[h]["commit"]["t"]
        assert rec["curves"]["precommit"]["pivotal_validator"] in range(N_VALS)
        if h >= 2:
            assert rec["flushes"] and all(
                any(g[0] == h for g in f["groups"]) for f in rec["flushes"])


def test_analysis_errors_counted_heights_commit(tmp_path, host_verifier):
    inst = InstrumentationConfig(flight_recorder=True, watchdog=False)
    node = Node(tmp_path, inst, with_wal=False)

    def boom():
        raise RuntimeError("profiler exploded")

    def ingest_boom(out):
        raise RuntimeError("ring exploded")

    node.cs.critpath._profiler_entries = boom
    node.cs.quorumtrace._ingest = ingest_boom
    try:
        node.run(3)
        assert node.cs.get_state().last_block_height >= 3
    finally:
        node.stop()
    assert node.cs.critpath.analysis_errors >= 3 and node.cs.quorumtrace.analysis_errors >= 3
    assert len(node.cs.critpath) == 0 and len(node.cs.quorumtrace) == 0
    assert node.cs.device_fault is None
    assert node.cs.critpath.snapshot()["analysis_errors"] == node.cs.critpath.analysis_errors


def test_instrument_metrics_lint_clean():
    m = ConsensusMetrics()
    for phase in critpath.PHASES:
        m.height_phase_seconds.observe(0.01, (phase,))
    for kind in ("prevote", "precommit"):
        m.quorum_time_to_third.observe(0.002, (kind,))
        m.quorum_time_to_two_thirds.observe(0.004, (kind,))
    m.stalls.add(1.0)
    m.stall_seconds.set(12.5)
    t = TelemetryMetrics(m.registry)
    t.snapshots.add(3.0)
    t.spool_bytes.set(4096.0)
    for store in ("flight", "profile", "critpath", "quorum"):
        t.evicted.add(2.0, (store,))
    text = m.registry.expose_text()
    for name in ("tendermint_consensus_height_phase_seconds_bucket",
                 "tendermint_consensus_quorum_time_to_third_seconds_count",
                 "tendermint_consensus_quorum_time_to_two_thirds_seconds_sum",
                 "tendermint_consensus_stalls_total 1", "tendermint_consensus_stall_seconds 12.5",
                 'tendermint_observability_evicted_total{store="quorum"} 2',
                 "tendermint_telemetry_spool_bytes 4096"):
        assert name in text
    assert _lint_text()(text) == []
    assert _lint_text()(TelemetryMetrics(Registry()).registry.expose_text()) == []
