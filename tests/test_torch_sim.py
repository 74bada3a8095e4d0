"""The port's chaos simulator (``tendermint_tpu_torch/sim``,
``p2p/inproc.py``, ``tools/chaos_smoke.py``) against the reference's.

* ``tests/test_sim_chaos.py``'s tier-1 classes restated: ``TestSimNet``,
  ``TestSimClock``, ``TestEquivocatingPV`` and ``TestEvidenceHoldBack`` on
  each package through the ``pkg`` parameter, ``TestEvidenceEndToEnd`` and
  ``TestCrashRestart`` on the port (``device="cpu"``: the nets verify on the
  host, their feeds on the host RLC).
* Parity for one seed: ``SimNet``'s decision log and ``replay_schedule``
  for one send sequence, ``FaultyDevice``'s fault sequence,
  ``EquivocatingPV``'s fabricated block ids and double-signed votes, and
  ``baseline_determinism``'s commit hashes, port against reference, over
  the round-0-clean prefix (retried as the reference's
  ``test_same_seed_same_chain`` retries).
* ``p2p/inproc.py``'s two differences from the reference: ``init_peer``
  before ``add_peer``, and a message that reaches a switch before it starts
  waits for its dispatcher (the reference's drops it, which left ``churn``'s
  first node at height 1 while the others committed on).
* Tier-1 runs of ``vote_storm``, ``mempool_flood`` and ``crash_restart`` on
  the port (``device_flap``, ``signed_flood`` and the on-card fault are in
  ``test_torch_sim_fault.py``); the full 14-entry matrix and the same-seed
  check under ``slow``, as the reference's ``TestScenarioMatrix``.

Every wait has a deadline. Each scenario's own timeouts bound its run.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as r_batch
from tendermint_tpu.evidence import reactor as r_ev_reactor
from tendermint_tpu.libs import clist as r_clist
from tendermint_tpu import sim as r_sim
from tendermint_tpu.sim import byzantine as r_byz
from tendermint_tpu.sim import clock as r_clock
from tendermint_tpu.sim import faults as r_faults
from tendermint_tpu.sim import simnet as r_simnet
from tendermint_tpu.types import BlockID as RBlockID
from tendermint_tpu.types import MockPV as RMockPV
from tendermint_tpu.types import PartSetHeader as RPartSetHeader
from tendermint_tpu.types import SignedMsgType as RSignedMsgType
from tendermint_tpu.types import Vote as RVote
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as RPrivKeyEd25519
from tendermint_tpu_torch import sim as p_sim
from tendermint_tpu_torch.crypto import batch as p_batch
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.evidence import reactor as p_ev_reactor
from tendermint_tpu_torch.libs import clist as p_clist
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.inproc import InProcSwitch
from tendermint_tpu_torch.sim import byzantine as p_byz
from tendermint_tpu_torch.sim import clock as p_clock
from tendermint_tpu_torch.sim import faults as p_faults
from tendermint_tpu_torch.sim import simnet as p_simnet
from tendermint_tpu_torch.testutil import sim_determinism
from tendermint_tpu_torch.tools import chaos_smoke
from tendermint_tpu_torch.config.consensus import consensus_test_config
from tendermint_tpu_torch.consensus.messages import VoteMessage
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.testutil import consensus as harness
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.vote import Vote

REF = SimpleNamespace(name="reference", simnet=r_simnet, clock=r_clock, byz=r_byz,
                      faults=r_faults, ev=r_ev_reactor, clist=r_clist)
PORT = SimpleNamespace(name="port", simnet=p_simnet, clock=p_clock, byz=p_byz,
                       faults=p_faults, ev=p_ev_reactor, clist=p_clist)


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _verifiers():
    """Each package's installed verifier as the test found it: a sim net on
    the CPU installs the host verifier when none is installed."""
    r_prev = r_batch._default
    yield
    verify_root.reset_verify()
    r_batch.set_batch_verifier(r_prev)


def wait_for(pred, timeout=3.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# ---------------------------------------------------------------------------
# tests/test_sim_chaos.py's tier-1 classes, on each package
# ---------------------------------------------------------------------------


class _SinkSwitch:
    """Registerable stand-in that records deliveries."""

    def __init__(self, node_id):
        self.node_id = node_id
        self.got = []

    def connect(self, peer_id):
        pass

    def disconnect(self, peer_id, reason=None):
        pass

    def deliver(self, chan_id, src_id, msg):
        self.got.append((chan_id, src_id, msg))


class TestSimNet:
    def test_decisions_are_pure_functions_of_seed(self, pkg):
        pol = pkg.simnet.LinkPolicy(delay_s=0.001, jitter_s=0.01, drop=0.3,
                                    duplicate=0.2, reorder=0.4)
        a = pkg.simnet._decide(pol, 42, "sim0", "sim1", 7, 0x20, 100)
        b = pkg.simnet._decide(pol, 42, "sim0", "sim1", 7, 0x20, 100)
        assert a == b
        # any coordinate change re-keys the rng
        assert pkg.simnet._decide(pol, 43, "sim0", "sim1", 7, 0x20, 100) != a

    def test_replay_schedule_detects_tampering(self, pkg):
        net = pkg.simnet.SimNet(seed=9)
        s0, s1 = _SinkSwitch("sim0"), _SinkSwitch("sim1")
        net.register(s0)
        net.register(s1)
        net.set_policy(None, None, pkg.simnet.LinkPolicy(drop=0.5, jitter_s=0.001))
        net.start()
        try:
            for i in range(50):
                net.send("sim0", "sim1", 0x20, b"m%d" % i)
            assert len(net.schedule_log) == 50
            assert net.replay_schedule() == []
            net.schedule_log[17].dropped = not net.schedule_log[17].dropped
            assert net.replay_schedule() == [17]
        finally:
            net.stop()

    def test_clean_links_do_not_grow_the_log(self, pkg):
        net = pkg.simnet.SimNet(seed=1)
        s0, s1 = _SinkSwitch("sim0"), _SinkSwitch("sim1")
        net.register(s0)
        net.register(s1)
        net.start()
        try:
            for _ in range(20):
                net.send("sim0", "sim1", 0x20, b"x")
            assert net.schedule_log == []
            assert wait_for(lambda: len(s1.got) == 20, 2.0)
        finally:
            net.stop()

    def test_partition_and_silence_drop_traffic(self, pkg):
        net = pkg.simnet.SimNet(seed=2)
        switches = [_SinkSwitch(f"sim{i}") for i in range(4)]
        for s in switches:
            net.register(s)
        net.start()
        try:
            net.set_partition([{"sim0", "sim1"}, {"sim2", "sim3"}])
            net.send("sim0", "sim2", 0x20, b"cross")
            net.send("sim0", "sim1", 0x20, b"within")
            assert net.stats["partition_dropped"] == 1
            net.heal_partition()

            net.silence({"sim3"})
            net.send("sim3", "sim0", 0x20, b"void")
            assert net.stats["silence_dropped"] == 1
            net.unsilence()
            assert wait_for(lambda: switches[1].got, 2.0)
            assert [m for _, _, m in switches[1].got] == [b"within"]
            assert all(m != b"cross" for _, _, m in switches[2].got)
        finally:
            net.stop()


class TestSimClock:
    def test_skew_shifts_wall_clock(self, pkg):
        c = pkg.clock.SimClock(skew_ns=5_000_000_000)
        assert abs(c() - time.time_ns() - 5_000_000_000) < 1_000_000_000

    def test_freeze_pins_the_clock(self, pkg):
        c = pkg.clock.SimClock(skew_ns=7, frozen_at_ns=1_000)
        assert c() == 1_007
        assert c.now_ns() == 1_007
        c.set_skew(0)
        assert c() == 1_000


class TestEquivocatingPV:
    def test_fabricated_block_id_is_deterministic(self, pkg):
        a = pkg.byz._fabricated_block_id(5, 0, 1)
        assert a == pkg.byz._fabricated_block_id(5, 0, 1)
        assert a != pkg.byz._fabricated_block_id(5, 0, 2)
        assert len(a.hash) == 32


class _FakeEvidence:
    def __init__(self, height):
        self.height = height

    def marshal(self):
        return b"ev@%d" % self.height


class _FakeEvPool:
    def __init__(self, clist, evs):
        self.evidence_list = clist.CList()
        for ev in evs:
            self.evidence_list.push_back(ev)


class _RecordingPeer:
    def __init__(self, peer_id="peerA"):
        self.id = peer_id
        self.is_running = True
        self.sent = []

    def send(self, chan_id, payload):
        self.sent.append((chan_id, payload))
        return True


class TestEvidenceHoldBack:
    def _start(self, reactor, peer):
        reactor.start()
        reactor.add_peer(peer)

    def test_unknown_peer_height_holds_evidence_back(self, pkg):
        """A wired height lookup that returns None (peer still handshaking /
        hasn't announced state) must not mean send-now."""
        heights = {}
        reactor = pkg.ev.EvidenceReactor(
            _FakeEvPool(pkg.clist, [_FakeEvidence(height=5)]),
            peer_height_lookup=lambda pid: heights.get(pid),
        )
        peer = _RecordingPeer()
        self._start(reactor, peer)
        try:
            time.sleep(0.4)
            assert peer.sent == [], "evidence leaked to unknown-height peer"
            heights[peer.id] = 3  # lagging: still below ev.height
            time.sleep(0.4)
            assert peer.sent == [], "evidence leaked to lagging peer"
            heights[peer.id] = 5  # caught up
            assert wait_for(lambda: len(peer.sent) == 1)
        finally:
            reactor.stop()

    def test_standalone_reactor_broadcasts_eagerly(self, pkg):
        # no lookup wired at all: the standalone behavior is unchanged
        reactor = pkg.ev.EvidenceReactor(
            _FakeEvPool(pkg.clist, [_FakeEvidence(height=5)]), peer_height_lookup=None
        )
        peer = _RecordingPeer()
        self._start(reactor, peer)
        try:
            assert wait_for(lambda: len(peer.sent) == 1)
        finally:
            reactor.stop()

    def test_encode_decode_roundtrip(self, pkg):
        payload = pkg.ev.encode_evidence_list([])
        assert pkg.ev.decode_evidence_list(payload) == []


class TestEvidenceEndToEnd:
    def test_equivocation_to_committed_evidence(self):
        """Double-sign -> honest nodes mint DuplicateVoteEvidence -> gossip ->
        proposer includes it in a block -> committed on all nodes -> marked
        committed in every pool -> gone from pending."""
        result = p_sim.run_scenario(p_sim.SCENARIOS["equivocation"](), device="cpu")
        assert result.ok, f"seed={result.seed} failures={result.failures}"
        assert result.heights and min(result.heights) >= 2
        assert result.fault_summary.get("sent", 0) > 0


class TestCrashRestart:
    def test_crash_restart_scenario(self):
        """Victim killed mid-height rebuilds from its surviving state db,
        block store and WAL, replays into the round state, re-applies the
        chain into a fresh app via the handshake, and rejoins consensus."""
        result = p_sim.run_scenario(p_sim.SCENARIOS["crash_restart"](), device="cpu")
        assert result.ok, f"seed={result.seed} failures={result.failures}"
        assert any(k.startswith("crash_restart:") for k in result.marks)


# ---------------------------------------------------------------------------
# parity with the reference for one seed
# ---------------------------------------------------------------------------


def _send_sequence(net, seq):
    for src, dst, chan, msg in seq:
        net.send(src, dst, chan, msg)


def _decision_fields(d):
    return (d.src, d.dst, d.seq, d.chan_id, d.size, d.dropped, d.duplicated, d.delay_s,
            d.dup_delay_s, (d.policy.delay_s, d.policy.jitter_s, d.policy.drop,
                            d.policy.duplicate, d.policy.reorder, d.policy.reorder_extra_s))


def test_simnet_decision_log_equals_the_reference():
    rng = np.random.default_rng(26)
    ids = [f"sim{i}" for i in range(4)]
    sends = [(ids[a], ids[b], int(c), bytes(rng.integers(0, 256, n, dtype=np.uint8)))
             for a, b, c, n in zip(rng.integers(0, 4, 300), rng.integers(0, 4, 300),
                                   rng.choice([0x20, 0x21, 0x22, 0x30], 300),
                                   rng.integers(1, 200, 300)) if a != b]
    storm = dict(delay_s=0.0, jitter_s=0.0001, drop=0.1, duplicate=0.15, reorder=0.2,
                 reorder_extra_s=0.0002)
    out = {}
    for pkg in (REF, PORT):
        net = pkg.simnet.SimNet(seed=31)
        sinks = [_SinkSwitch(i) for i in ids]
        for s in sinks:
            net.register(s)
        net.start()
        try:
            net.set_policy(None, None, pkg.simnet.LinkPolicy(**storm))
            _send_sequence(net, sends[:150])
            # a policy change mid-run: replay re-derives under the policy
            # in force when each decision was drawn
            net.set_policy("sim0", "sim1", pkg.simnet.LinkPolicy(drop=0.5, jitter_s=0.0001))
            _send_sequence(net, sends[150:])
            assert net.replay_schedule() == []
            out[pkg.name] = ([_decision_fields(d) for d in net.schedule_log],
                             net.fault_summary())
        finally:
            net.stop()
    assert out["port"][0] == out["reference"][0]
    assert len(out["port"][0]) == len(sends)
    assert out["port"][1] == out["reference"][1]


class _AllTrue:
    def verify_ed25519(self, items):
        return np.ones(len(items), dtype=bool)

    def verify_ed25519_raw(self, pubs, msgs, sigs):
        return np.ones(len(pubs), dtype=bool)

    def verify_secp256k1(self, items):
        return np.ones(len(items), dtype=bool)


def _fault_sequence(pkg, n=300):
    dev = pkg.faults.FaultyDevice(_AllTrue(), seed=11, fail_rate=0.1, hang_rate=0.1,
                                  corrupt_rate=0.2, hang_s=0.0,
                                  schedule=["ok", "fail", "corrupt", "hang"])
    seq = []
    for i in range(n):
        try:
            out = dev.verify_ed25519_raw([b""] * 8, [b""] * 8, [b""] * 8)
        except pkg.faults.InjectedDeviceError:
            seq.append("fail")
            continue
        seq.append(tuple(np.flatnonzero(~out).tolist()))
    return seq, dev.snapshot()


def test_faulty_device_fault_sequence_equals_the_reference():
    (got, snap), (want, want_snap) = _fault_sequence(PORT), _fault_sequence(REF)
    assert got == want and snap == want_snap
    # the schedule first (ok, fail, one corrupted lane, a hang), then the rates
    assert got[:4] == [(), "fail", got[2], ()] and len(got[2]) == 1
    assert snap["failures"] > 1 and snap["corruptions"] > 1 and snap["hangs"] > 1


class CardHost(p_batch.HostBatchVerifier):
    """A host verifier that claims the card (only ``.device`` is read)."""

    device = torch.device("cuda")


def test_faulty_device_forwards_its_inner_device():
    host = p_faults.FaultyDevice(p_batch.HostBatchVerifier())
    card = p_faults.FaultyDevice(CardHost())
    plain = p_faults.FaultyDevice(p_batch.TorchBatchVerifier("cpu"))
    assert host.device is None and card.device.type == "cuda" and plain.device.type == "cpu"
    assert host.backend == "host" and plain.backend == "cpu"
    assert not p_batch.GuardedBatchVerifier(host).on_card
    assert p_batch.GuardedBatchVerifier(card).on_card
    assert not p_batch.GuardedBatchVerifier(plain).on_card


def test_equivocating_pv_equals_the_reference():
    for h in (1, 2, 7):
        for r in (0, 3):
            for t in (1, 2):
                a = p_byz._fabricated_block_id(h, r, t)
                b = r_byz._fabricated_block_id(h, r, t)
                assert (a.hash, a.parts_header.total, a.parts_header.hash) == (
                    b.hash, b.parts_header.total, b.parts_header.hash)
    seed = bytes([9]) * 32
    p_pv = p_byz.EquivocatingPV(MockPV(PrivKeyEd25519.generate(seed)), start_height=2)
    r_pv = r_byz.EquivocatingPV(RMockPV(RPrivKeyEd25519.generate(seed)), start_height=2)
    addr = p_pv.get_pub_key().address()
    assert addr == r_pv.get_pub_key().address()
    bid = (b"\x11" * 32, 1, b"\x22" * 32)
    for h in (1, 2, 3):
        for vt in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            p_pv.sign_vote("sim-chain", Vote(
                vote_type=vt, height=h, round=0, timestamp_ns=1_700_000_000_000_000_000 + h,
                block_id=BlockID(hash=bid[0], parts_header=PartSetHeader(bid[1], bid[2])),
                validator_address=addr, validator_index=3))
            r_pv.sign_vote("sim-chain", RVote(
                vote_type=RSignedMsgType(int(vt)), height=h, round=0,
                timestamp_ns=1_700_000_000_000_000_000 + h,
                block_id=RBlockID(hash=bid[0], parts_header=RPartSetHeader(bid[1], bid[2])),
                validator_address=addr, validator_index=3))
    p_dbl, r_dbl = p_pv.drain_conflicting(), r_pv.drain_conflicting()
    assert len(p_dbl) == len(r_dbl) == 4 and p_pv.equivocations == r_pv.equivocations == 4
    for p, r in zip(p_dbl, r_dbl):
        assert (p.height, int(p.vote_type), p.block_id.hash, p.signature) == (
            r.height, int(r.vote_type), r.block_id.hash, r.signature)


def _hard(result):
    # safety/replay problems are bugs; only liveness misses (pure wall
    # clock) qualify for a retry
    return [f for f in result.failures if not f.startswith("liveness")]


def _deterministic_run(pkg, device_kw):
    """One baseline_determinism run and the top of its deterministic prefix
    (``testutil/sim_determinism``): the round-0-clean prefix, cut below the
    first block whose LastCommit misses a precommit or stamps one otherwise
    than the block before's time + iota, as a wall-clock race does at round
    0 too."""
    return sim_determinism.deterministic_run(
        pkg.run_scenario, pkg.SCENARIOS["baseline_determinism"], pkg.round0_clean_top,
        **device_kw)


def test_baseline_determinism_hashes_equal_the_reference():
    """baseline_determinism on each package: frozen clocks make the commit
    hashes a pure function of the chain, so over the deterministic prefix
    (``_deterministic_run``) both packages commit the same blocks. A run
    that a wall-clock timeout perturbed is retried, as the reference's
    same-seed check retries one whose round-0-clean prefix fell short."""
    target = p_sim.SCENARIOS["baseline_determinism"]().target_height
    top = 0
    for _ in range(3):
        port, p_top = _deterministic_run(p_sim, {"device": "cpu"})
        ref, r_top = _deterministic_run(r_sim, {})
        assert not _hard(port) and not _hard(ref), (port.failures, ref.failures)
        top = min(p_top, r_top)
        if port.ok and ref.ok and top >= target:
            break
    assert top >= target, f"the deterministic prefix reached only h={top} in 3 runs"
    for node in range(4):
        for h in range(1, top + 1):
            assert port.commit_hashes[node][h] == ref.commit_hashes[node][h], (
                node, h, top, port.commit_rounds, ref.commit_rounds)


# ---------------------------------------------------------------------------
# p2p/inproc.py: init_peer, messages that arrive before start, and what
# waits from a peer when its connection is cut
# ---------------------------------------------------------------------------


class _Recorder(Reactor):
    def __init__(self):
        super().__init__("recorder")
        self.calls = []
        self.got = []

    def get_channels(self):
        return [ChannelDescriptor(id=0x77, priority=1)]

    def init_peer(self, peer):
        self.calls.append(("init_peer", peer.id, self.is_running))
        return peer

    def add_peer(self, peer):
        self.calls.append(("add_peer", peer.id, self.is_running))

    def receive(self, chan_id, peer, msg_bytes):
        if msg_bytes == b"boom":
            raise ValueError("bad message")
        self.got.append((chan_id, peer.id, msg_bytes))


def _pair(fabric_seed=0):
    net = p_simnet.SimNet(seed=fabric_seed)
    out = []
    for i in range(2):
        sw = InProcSwitch(f"sim{i}", net)
        rec = sw.add_reactor("recorder", _Recorder())
        net.register(sw)
        out.append((sw, rec))
    net.connect_full_mesh()
    return net, out


def test_connect_calls_init_peer_before_add_peer():
    net, [(a, ra), (b, rb)] = _pair()
    net.start()
    try:
        # wired before start: init_peer, then add_peer (which a real reactor
        # ignores before it runs), then add_peer again once running
        assert ra.calls == [("init_peer", "sim1", False), ("add_peer", "sim1", False)]
        a.start()
        assert ra.calls[2:] == [("add_peer", "sim1", True)]
        # a peer that (re)connects while running: init_peer, then add_peer
        a.disconnect("sim1")
        a.connect("sim1")
        assert ra.calls[3:] == [("init_peer", "sim1", True), ("add_peer", "sim1", True)]
    finally:
        if a.is_running:
            a.stop()
        net.stop()


def test_a_message_before_start_waits_for_the_dispatcher():
    net, [(a, ra), (b, rb)] = _pair()
    net.start()
    try:
        a.start()
        assert a.peers.get("sim1").send(0x77, b"early")
        time.sleep(0.1)  # delivered to a switch that has not started
        assert rb.got == []
        b.start()
        assert wait_for(lambda: rb.got == [(0x77, "sim0", b"early")])
        # a stopped switch drops what reaches it
        b.stop()
        a.peers.get("sim1").send(0x77, b"late")
        time.sleep(0.1)
        assert rb.got == [(0x77, "sim0", b"early")]
    finally:
        a.stop()
        net.stop()


def test_what_waits_from_a_cut_peer_dies_with_the_connection():
    """A partition removes the cross peers; what they sent before it that
    still waits in the inbox is dropped with the connection, not taken for
    a new inbound peer (which would bring back, during the partition, a
    PeerState that marks as delivered every vote the partition drops, so
    that after the heal nothing is resent: partition_heal_9's stall). The
    heal then connects fresh peers."""
    net, [(a, ra), (b, rb)] = _pair()
    net.start()
    try:
        a.start()
        for m in (b"m1", b"m2"):
            assert a.peers.get("sim1").send(0x77, m)
        time.sleep(0.1)  # waiting in b's inbox: b has not started
        net.set_partition([{"sim0"}, {"sim1"}])
        assert a.peers.get("sim1") is None and b.peers.get("sim0") is None
        b.start()
        time.sleep(0.2)
        assert rb.got == [] and b.peers.get("sim0") is None
        net.heal_partition()
        assert wait_for(lambda: a.peers.get("sim1") is not None and b.peers.get("sim0") is not None)
        assert a.peers.get("sim1").send(0x77, b"m3")
        assert wait_for(lambda: rb.got == [(0x77, "sim0", b"m3")])
        assert ("init_peer", "sim0", True) in rb.calls
    finally:
        a.stop()
        b.stop()
        net.stop()


def test_a_receive_error_stops_the_peer_and_traffic_reconnects_it():
    net, [(a, ra), (b, rb)] = _pair()
    net.start()
    a.start()
    b.start()
    try:
        a.peers.get("sim1").send(0x77, b"boom")
        assert wait_for(lambda: b.peers.get("sim0") is None)
        # the next message from the stopped peer is an inbound connection
        a.peers.get("sim1").send(0x77, b"again")
        assert wait_for(lambda: rb.got == [(0x77, "sim0", b"again")])
        assert b.peers.get("sim0") is not None
        assert [c[0] for c in rb.calls[-2:]] == ["init_peer", "add_peer"]
    finally:
        a.stop()
        b.stop()
        net.stop()


# ---------------------------------------------------------------------------
# what the double-signer found in the port's consensus
# ---------------------------------------------------------------------------


def _proposer_index(n_vals):
    doc, _ = harness.make_genesis(n_vals)
    vals = state_from_genesis(doc).validators
    return [v.address for v in vals.validators].index(vals.get_proposer().address)


def test_a_conflicting_precommit_that_completes_the_quorum_commits():
    """Validator b's double (a precommit for a block never proposed) reached
    the node first; a peer then claimed +2/3 for the real block, so b's
    honest precommit, though it conflicts, enters that block's tally and
    completes its +2/3 (with the node's own and one stub's; the third stub
    precommitted nil). The node must commit (Go's addVote goes on when the
    vote was added) and still turn the conflict into evidence; the
    reference's state machine returns at the conflict and waits for ever."""
    cs, stubs, bus = harness.make_consensus_state(
        4, our_index=_proposer_index(4), config=consensus_test_config())
    added = []
    cs.evpool.add_evidence = added.append
    cs.start()
    try:
        assert harness.wait_for(lambda: cs.get_round_state().proposal_block is not None, 20.0)
        rs = cs.get_round_state()
        bid = BlockID(hash=rs.proposal_block.hash(), parts_header=rs.proposal_block_parts.header())
        for stub in stubs:
            cs.send_peer_msg(VoteMessage(stub.sign_vote(SignedMsgType.PREVOTE, bid, 1, 0)),
                             f"peer{stub.index}")
        # our own precommit for the block, once the polka is in
        assert harness.wait_for(
            lambda: cs.get_round_state().votes.precommits(0).bit_array().num_true() >= 1,
            20.0)
        byz, honest, nil = stubs
        double = p_byz._fabricated_block_id(1, 0, int(SignedMsgType.PRECOMMIT))
        cs.send_peer_msg(VoteMessage(byz.sign_vote(SignedMsgType.PRECOMMIT, double, 1, 0)),
                         f"peer{byz.index}")
        cs.send_peer_msg(VoteMessage(nil.sign_vote(SignedMsgType.PRECOMMIT, BlockID(), 1, 0)),
                         f"peer{nil.index}")
        cs.send_peer_msg(VoteMessage(honest.sign_vote(SignedMsgType.PRECOMMIT, bid, 1, 0)),
                         f"peer{honest.index}")
        assert harness.wait_for(
            lambda: cs.get_round_state().votes.precommits(0).bit_array().num_true() == 4,
            20.0)
        assert cs.block_store.height() == 0  # 20 of 40 for the block: no quorum
        with cs._mtx:
            cs.rs.votes.set_peer_maj23(0, SignedMsgType.PRECOMMIT, "peer-claims", bid)
        cs.send_peer_msg(VoteMessage(byz.sign_vote(SignedMsgType.PRECOMMIT, bid, 1, 0)),
                         f"peer{byz.index}")
        assert harness.wait_for(lambda: cs.block_store.height() == 1, 20.0), (
            cs.get_round_state().height, cs.get_round_state().votes.precommits(0))
        assert cs.block_store.load_block_meta(1).block_id.hash == bid.hash
        assert len(added) == 1 and added[0].address == byz.address
    finally:
        cs.stop()
        bus.stop()


# ---------------------------------------------------------------------------
# tier-1 runs of the scenarios that reach the feeds, on the port
# ---------------------------------------------------------------------------


def test_vote_storm_on_the_port():
    result = p_sim.run_scenario(p_sim.SCENARIOS["vote_storm"](), device="cpu")
    assert result.ok, f"seed={result.seed} failures={result.failures}"
    assert result.fault_summary["seeded_decisions"] > 0
    assert min(result.heights) >= 2


def test_mempool_flood_on_the_port():
    result = p_sim.run_scenario(p_sim.SCENARIOS["mempool_flood"](), device="cpu")
    assert result.ok, f"seed={result.seed} failures={result.failures}"


def test_a_sim_net_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    verify_root.reset_verify()  # nothing installed, whatever ran before
    with pytest.raises(NoCudaDeviceError):
        p_sim.build_sim_net(4)
    with pytest.raises(NoCudaDeviceError):
        chaos_smoke.main(["--only", "vote_storm"])
    assert chaos_smoke.main(["--device", "cpu", "--only", "no_such_scenario"]) == 2
    fabric, nodes = p_sim.build_sim_net(4, device="cpu")
    try:
        assert isinstance(p_batch.installed_batch_verifier(), p_batch.HostBatchVerifier)
        assert all(n.device.type == "cpu" and n.vote_feed is None and n.tx_feed is None
                   for n in nodes)
    finally:
        for n in nodes:
            n.stop()
            n.conn.stop()
        fabric.stop()


def test_chaos_smoke_runs_one_scenario_on_the_cpu(tmp_path, capsys):
    assert chaos_smoke.main(["--device", "cpu", "--only", "crash_restart",
                             "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[chaos-smoke] PASS crash_restart" in out and "[chaos-smoke] OK" in out


# ---------------------------------------------------------------------------
# slow tier: the full matrix + determinism, as the reference's
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestScenarioMatrix:
    @pytest.mark.parametrize("name", sorted(p_sim.SCENARIOS))
    def test_scenario(self, name):
        result = p_sim.run_scenario(p_sim.SCENARIOS[name](), device="cpu")
        assert result.ok, f"seed={result.seed} failures={result.failures}"

    def test_same_seed_same_chain(self):
        target = p_sim.SCENARIOS["baseline_determinism"]().target_height
        top = 0
        for _ in range(3):
            r1, top1 = _deterministic_run(p_sim, {"device": "cpu"})
            r2, top2 = _deterministic_run(p_sim, {"device": "cpu"})
            assert not _hard(r1) and not _hard(r2)
            top = min(top1, top2)
            if r1.ok and r2.ok and top >= target:
                break
        assert top >= target, f"the deterministic prefix reached only h={top} in 3 runs"
        assert chaos_smoke.commit_hash_mismatches(r1, r2, top) == []
