"""The named chaos scenario matrix ``tools/chaos_smoke.py`` executes; the
port's copy of the reference package's ``sim/scenarios.py``, with the same
seeds, policies and checks. ``clock_skew`` and ``quorum_observatory`` read
their dumps with the port's ``tools/trace_merge.py``.

Each entry is a zero-arg factory returning a fresh `Scenario`; factories
keep runs independent (mutable config/clock objects are per-run).  The
shared invariants (safety at every committed height, seeded-fault
replayability) are asserted by `run_scenario` for every scenario; the
per-scenario `check`/`drive` hooks add the scenario-specific claims named
in the table below.

====================  =====================================================
baseline_determinism  frozen clocks + blocktime_iota → commit hashes are a
                      pure function of the chain; the smoke runs it twice
                      and requires identical hashes
partition_heal        2-2 split: no quorum ⇒ no progress while split,
                      progress resumes within budget after heal
partition_heal_9      the same claim at n_vals=9 (4-5 split) — the larger
                      validator-set variant of the matrix
storm                 delay + jitter + 10% drop + duplicates + reorder on
                      every link; chain still advances
clock_skew            ±2s wall-clock skews; trace_merge's commit-anchor
                      math must recover the injected skews
churn                 validator removed via val-tx, then re-added; the
                      valset transitions apply and consensus keeps going
equivocation          Byzantine double-signer ⇒ DuplicateVoteEvidence is
                      minted, gossiped, included in a block, committed,
                      and marked committed in every pool
silence_watchdog      >1/3 power silenced ⇒ watchdog stall report names
                      the silenced validators' cumulative power; heals
mempool_flood         one node spams signed txs at ~10x the per-peer QoS
                      rate with batched TxFeed ingest on ⇒ honest priority
                      txs still commit, mempools stay bounded, drops land
                      in tendermint_mempool_qos_* counters
signed_flood          mixed valid/garbage/wrong-nonce/mutant signed txs
                      through the batched ingest path while the device
                      backend flaps ⇒ admit/reject codes bit-identical to
                      a serial-verify oracle mempool, committed app state
                      identical on every node, feed demonstrably engaged
device_flap           FaultyDevice behind the guarded verifier fails, hangs,
                      then silently corrupts ⇒ breaker walks closed→open→
                      half_open→closed, then quarantines on the audit
                      mismatch; the chain never stops committing and no
                      wrong verdict escapes
crash_restart         one node killed mid-height, rebuilt from its stores +
                      WAL ⇒ WAL messages replay, the ABCI handshake
                      re-applies committed blocks into the fresh app, and
                      the node catches back up to the chain
quorum_observatory    ±2s skews + seeded storm + one frozen-then-resumed
                      clock ⇒ fused vote journeys are monotone after
                      commit-anchor correction and each node's pivotal-
                      validator naming re-derives bit-identically from its
                      own dump
====================  =====================================================
"""

from __future__ import annotations

import base64
from typing import Callable, Dict, List

from tendermint_tpu_torch.config.config import test_config
from tendermint_tpu_torch.sim.byzantine import EquivocatingPV
from tendermint_tpu_torch.sim.clock import SimClock
from tendermint_tpu_torch.sim.node import SIM_GENESIS_TIME_NS
from tendermint_tpu_torch.sim.scenario import FaultOp, Scenario, ScenarioRun

# injected clock skews for the clock_skew scenario, ns (index-aligned)
SKEWS_NS = [0, 2_000_000_000, -1_500_000_000, 500_000_000]


def _deterministic_config():
    """Frozen-clock determinism needs strictly increasing block times, which
    the iota floor provides (vote time = block time + iota when `now` is
    frozen), AND it needs every height to commit at round 0: a timeout-driven
    round bump changes the proposer and therefore the block hash, so all
    round timeouts are set far above in-proc delivery latency — progress is
    carried entirely by the has-all fast paths (skip_timeout_commit)."""
    cfg = test_config()
    cfg.consensus.blocktime_iota = 1.0
    cfg.consensus.timeout_propose = 10.0
    cfg.consensus.timeout_prevote = 5.0
    cfg.consensus.timeout_precommit = 5.0
    cfg.consensus.timeout_commit = 5.0
    return cfg


def baseline_determinism() -> Scenario:
    return Scenario(
        name="baseline_determinism",
        description="fault-free frozen-clock run; commit hashes must be "
                    "identical across nodes AND across runs of one seed",
        seed=1,
        target_height=4,
        timeout_s=60.0,
        config_factory=_deterministic_config,
        clock_factory=lambda i: SimClock(frozen_at_ns=SIM_GENESIS_TIME_NS),
        check=_check_all_nodes_agree_everywhere,
    )


def _check_all_nodes_agree_everywhere(run: ScenarioRun) -> List[str]:
    """Beyond pairwise safety: every node committed the SAME chain prefix."""
    failures = []
    maps = [n.committed_hashes() for n in run.nodes]
    shared = set(maps[0])
    for m in maps[1:]:
        shared &= set(m)
    if len(shared) < run.scenario.target_height:
        failures.append(
            f"only {len(shared)} heights committed by every node "
            f"(want >= {run.scenario.target_height})"
        )
    for h in sorted(shared):
        hashes = {m[h] for m in maps}
        if len(hashes) > 1:
            failures.append(f"height {h}: nodes disagree: {hashes}")
    return failures


def partition_heal(n_vals: int = 4) -> Scenario:
    split = n_vals // 2  # both halves < 2/3 quorum for any n_vals >= 4

    def drive(run: ScenarioRun) -> List[str]:
        failures = []
        if not run.wait_height(2, 30.0):
            return [f"never reached height 3 pre-partition: {run.heights()}"]
        run.fabric.set_partition(
            [{n.node_id for n in run.nodes[:split]},
             {n.node_id for n in run.nodes[split:]}]
        )
        # let in-flight messages settle, then sample the frozen heights
        run.wait_for(lambda: False, timeout=1.0)
        before = run.mark("partition_settled")["heights"]
        run.wait_for(lambda: False, timeout=3.0)
        after = run.mark("partition_end")["heights"]
        if before != after:
            failures.append(
                f"progress during {split}-{n_vals - split} partition: "
                f"{before} -> {after}"
            )
        run.fabric.heal_partition()
        # bigger nets pay 9 single-sig Python verifies per commit plus
        # post-partition round realignment: give them a wider heal budget
        heal_budget = 30.0 if n_vals == 4 else 90.0
        if not run.wait_height(max(after) + 2, heal_budget):
            failures.append(
                f"liveness: no progress within budget after heal: "
                f"{run.heights()} (was {after})"
            )
        return failures

    return Scenario(
        name="partition_heal" if n_vals == 4 else f"partition_heal_{n_vals}",
        description=f"{split}-{n_vals - split} partition freezes the chain "
                    "(no 2/3 quorum); healing restores progress within "
                    "budget",
        n_vals=n_vals,
        seed=2,
        timeout_s=90.0 if n_vals == 4 else 180.0,
        drive=drive,
    )


def storm() -> Scenario:
    storm_policy = dict(delay_s=0.005, jitter_s=0.015, drop=0.10,
                        duplicate=0.10, reorder=0.20, reorder_extra_s=0.05)
    return Scenario(
        name="storm",
        description="drop/duplicate/reorder storm on every link; the chain "
                    "still advances (gossip retransmission heals losses)",
        seed=3,
        target_height=4,
        timeout_s=120.0,
        ops=[FaultOp(at_s=0.0, op="policy",
                     kwargs={"src": None, "dst": None,
                             "policy": storm_policy})],
    )


def _skew_config():
    # non-zero iota keeps median block time strictly increasing even for
    # validators whose skewed clock lags the latest block time
    cfg = test_config()
    cfg.consensus.blocktime_iota = 1.0
    return cfg


def clock_skew() -> Scenario:
    def check(run: ScenarioRun) -> List[str]:
        from tendermint_tpu_torch.tools import trace_merge as tm


        failures = []
        dumps = [n.cs.flight.snapshot() for n in run.nodes]
        recovered = tm.compute_skews(dumps)
        for i, skew in enumerate(recovered):
            expected = SKEWS_NS[0] - SKEWS_NS[i]
            err_s = abs(skew - expected) / 1e9
            if err_s > 0.3:
                failures.append(
                    f"node {i}: recovered skew {skew / 1e9:+.3f}s vs "
                    f"injected {expected / 1e9:+.3f}s (err {err_s:.3f}s)"
                )
        return failures

    return Scenario(
        name="clock_skew",
        description="±2s wall-clock skews; commit-anchor skew recovery in "
                    "trace_merge must measure the injected offsets back out",
        seed=4,
        target_height=5,
        timeout_s=60.0,
        config_factory=_skew_config,
        clock_factory=lambda i: SimClock(skew_ns=SKEWS_NS[i]),
        check=check,
    )


def churn() -> Scenario:
    from tendermint_tpu_torch.abci.examples.kvstore import PersistentKVStoreApp

    def drive(run: ScenarioRun) -> List[str]:
        failures = []
        # target the validator that sorts LAST in the valset (index 3)
        last_val = run.nodes[3].pv.get_pub_key()
        pub_b64 = base64.b64encode(last_val.bytes())

        if not run.wait_height(2, 30.0):
            return [f"never warmed up: {run.heights()}"]
        for node in run.nodes:
            try:
                node.mempool.check_tx(b"val:" + pub_b64 + b"!0")
            except Exception:
                pass
        removed = run.wait_for(
            lambda: all(n.cs.rs.validators.size == 3 for n in run.nodes),
            timeout=30.0,
        )
        if not removed:
            sizes = [n.cs.rs.validators.size for n in run.nodes]
            return [f"validator never removed: valset sizes {sizes}"]
        run.mark("removed")
        h_removed = max(run.heights())
        if not run.wait_height(h_removed + 1, 30.0):
            failures.append(
                f"3-validator net stopped: {run.heights()}"
            )
        for node in run.nodes:
            try:
                node.mempool.check_tx(b"val:" + pub_b64 + b"!10")
            except Exception:
                pass
        readded = run.wait_for(
            lambda: all(n.cs.rs.validators.size == 4 for n in run.nodes),
            timeout=30.0,
        )
        if not readded:
            sizes = [n.cs.rs.validators.size for n in run.nodes]
            failures.append(f"validator never re-added: valset sizes {sizes}")
        run.mark("readded")
        h_readded = max(run.heights())
        if not run.wait_height(h_readded + 1, 30.0):
            failures.append(
                f"4-validator net stopped after re-add: {run.heights()}"
            )
        return failures

    return Scenario(
        name="churn",
        description="validator removed via val-tx (applies at height+2), "
                    "chain keeps going on 3, validator re-added, back to 4",
        seed=5,
        timeout_s=120.0,
        app_factory=lambda i: PersistentKVStoreApp(),
        drive=drive,
    )


def equivocation() -> Scenario:
    def setup(run: ScenarioRun) -> None:
        run.nodes[3].start_equivocation_pump()

    def drive(run: ScenarioRun) -> List[str]:
        def pools_marked() -> bool:
            # the block lands in the store a beat before apply_block marks
            # the pool, so wait for BOTH before handing to the check hook
            for n in run.nodes:
                heights = n.committed_evidence_heights()
                if not heights:
                    return False
                for h in heights:
                    block = n.block_store.load_block(h)
                    for ev in block.evidence.evidence:
                        if not n.evpool.is_committed(ev):
                            return False
            return True

        failures = []
        if not run.wait_for(pools_marked, timeout=90.0):
            got = [n.committed_evidence_heights() for n in run.nodes]
            failures.append(
                f"evidence never committed+marked on every node: {got}"
            )
        return failures

    def check(run: ScenarioRun) -> List[str]:
        failures = []
        byz_addr = run.nodes[3].pv.get_pub_key().address()
        for node in run.nodes:
            for h in node.committed_evidence_heights():
                block = node.block_store.load_block(h)
                for ev in block.evidence.evidence:
                    if ev.address != byz_addr:
                        failures.append(
                            f"{node.node_id}: evidence at h={h} names "
                            f"{ev.address.hex()[:12]}, not the equivocator"
                        )
                    if not node.evpool.is_committed(ev):
                        failures.append(
                            f"{node.node_id}: committed evidence at h={h} "
                            f"not marked committed in the pool"
                        )
                    if ev in node.evpool.pending_evidence():
                        failures.append(
                            f"{node.node_id}: committed evidence still "
                            f"pending"
                        )
        return failures

    return Scenario(
        name="equivocation",
        description="Byzantine double-signer: honest nodes mint "
                    "DuplicateVoteEvidence, gossip it, a proposer includes "
                    "it, and every pool marks it committed",
        seed=6,
        timeout_s=120.0,
        byzantine={3: lambda pv: EquivocatingPV(pv, start_height=2)},
        setup=setup,
        drive=drive,
        check=check,
    )


def _vote_batch_config():
    # enable the live-vote micro-batcher (parallel/planner.VoteFeed):
    # every honest node's peer votes verify through batched dispatches
    cfg = test_config()
    cfg.verify.vote_batch_window_ms = 2.0
    cfg.verify.vote_batch_rows = 64
    return cfg


def vote_storm() -> Scenario:
    """Equivocation under a message storm WITH the vote micro-batcher on:
    the double-sign must still surface as ErrVoteConflictingVotes out of
    the batched path, mint DuplicateVoteEvidence, and commit — while the
    feed demonstrably carried the vote traffic."""

    storm_policy = dict(delay_s=0.002, jitter_s=0.008, drop=0.05,
                        duplicate=0.15, reorder=0.20, reorder_extra_s=0.03)

    def setup(run: ScenarioRun) -> None:
        run.nodes[3].start_equivocation_pump()

    def drive(run: ScenarioRun) -> List[str]:
        def pools_marked() -> bool:
            for n in run.nodes:
                heights = n.committed_evidence_heights()
                if not heights:
                    return False
                for h in heights:
                    block = n.block_store.load_block(h)
                    for ev in block.evidence.evidence:
                        if not n.evpool.is_committed(ev):
                            return False
            return True

        failures = []
        if not run.wait_for(pools_marked, timeout=90.0):
            got = [n.committed_evidence_heights() for n in run.nodes]
            failures.append(
                f"evidence never committed+marked through the batched "
                f"path: {got}"
            )
        return failures

    def check(run: ScenarioRun) -> List[str]:
        failures = []
        byz_addr = run.nodes[3].pv.get_pub_key().address()
        for node in run.nodes:
            for h in node.committed_evidence_heights():
                block = node.block_store.load_block(h)
                for ev in block.evidence.evidence:
                    if ev.address != byz_addr:
                        failures.append(
                            f"{node.node_id}: evidence at h={h} names "
                            f"{ev.address.hex()[:12]}, not the equivocator"
                        )
                    if not node.evpool.is_committed(ev):
                        failures.append(
                            f"{node.node_id}: committed evidence at h={h} "
                            f"not marked committed in the pool"
                        )
        # the batcher must have actually carried votes — a scenario that
        # silently fell back to serial would vacuously pass the above
        engaged = [n for n in run.nodes
                   if n.vote_feed is not None and n.vote_feed.dispatches > 0]
        if not engaged:
            feeds = [(n.node_id,
                      None if n.vote_feed is None
                      else (n.vote_feed.votes_in, n.vote_feed.dispatches))
                     for n in run.nodes]
            failures.append(f"vote feed never dispatched on any node: {feeds}")
        return failures

    return Scenario(
        name="vote_storm",
        description="message storm + double-signer with the vote "
                    "micro-batcher enabled: batched verification still "
                    "raises the conflict, evidence commits, and the feed "
                    "demonstrably carried the vote traffic",
        seed=12,
        timeout_s=120.0,
        config_factory=_vote_batch_config,
        byzantine={3: lambda pv: EquivocatingPV(pv, start_height=2)},
        setup=setup,
        drive=drive,
        check=check,
        ops=[FaultOp(at_s=0.0, op="policy",
                     kwargs={"src": None, "dst": None,
                             "policy": storm_policy})],
    )


def silence_watchdog() -> Scenario:
    def drive(run: ScenarioRun) -> List[str]:
        failures = []
        if not run.wait_height(3, 30.0):
            return [f"never warmed up: {run.heights()}"]
        # start the watchdog only after the warm-up heights, then give it a
        # couple of healthy samples to seed the block-interval EWMA
        wd = run.nodes[0].start_watchdog(
            interval=0.2, stall_factor=3.0, min_stall_seconds=1.5
        )
        run.wait_for(lambda: False, timeout=1.0)
        run.fabric.silence({run.nodes[2].node_id, run.nodes[3].node_id})
        if not run.wait_for(lambda: wd.report() is not None, timeout=10.0):
            failures.append("watchdog never reported the >1/3-silence stall")
        else:
            report = wd.report()
            missing = report["missing_precommits"]
            if missing["total_power"] <= 0:
                failures.append("stall report has no total power")
            elif missing["power"] * 3 < missing["total_power"]:
                failures.append(
                    f"stall report names {missing['power']}/"
                    f"{missing['total_power']} missing power (< 1/3)"
                )
            silenced_addrs = {
                run.nodes[2].pv.get_pub_key().address().hex().upper(),
                run.nodes[3].pv.get_pub_key().address().hex().upper(),
            }
            named = {v["address"] for v in missing["validators"]}
            if not silenced_addrs <= named:
                failures.append(
                    f"stall report names {named}, missing silenced "
                    f"{silenced_addrs}"
                )
            if "wall_time_ns" not in report:
                failures.append("stall report lacks wall_time_ns stamp")
        run.fabric.unsilence()
        h = max(run.heights())
        if not run.wait_height(h + 1, 30.0):
            failures.append(
                f"no recovery after unsilence: {run.heights()}"
            )
        return failures

    return Scenario(
        name="silence_watchdog",
        description=">1/3 voting power silenced: the liveness watchdog must "
                    "name the silenced validators' cumulative power, then "
                    "the net recovers when they return",
        seed=7,
        timeout_s=90.0,
        drive=drive,
    )


def mempool_flood() -> Scenario:
    """One node floods signed spam txs well above the per-peer QoS budget
    while consensus runs, with the batched TxFeed ingest path on (the
    signed workload makes admission expensive enough that the QoS verdicts
    matter).  Honest high-priority signed txs must still commit, every
    node's mempool stays bounded at `size`, the spammer's bucket saturates
    (per-peer drop counts on honest nodes), and the drops are visible in
    the tendermint_mempool_qos_* metric exposition — the QoS fairness
    story must survive batched ingest unchanged."""
    from tendermint_tpu_torch.abci.examples.kvstore import (
        SignedKVStoreApp,
        make_signed_tx,
    )
    from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
    from tendermint_tpu_torch.mempool.mempool import MempoolError

    MAX_TXS = 100
    SPAM = 600  # >> qos_peer_tx_burst + rate x run-length: must saturate

    def config():
        cfg = test_config()
        cfg.mempool.size = MAX_TXS
        # the signed workload paces the spammer's own gossip: its walker
        # forwards txs only as fast as its batched admission admits them,
        # so the budget must sit below that delivery rate (~30-100 tx/s
        # in-sim) for the honest buckets to saturate
        cfg.mempool.qos_peer_tx_rate = 10.0
        cfg.mempool.qos_peer_tx_burst = 10.0
        # keep peers unmuted so the scenario measures steady-state rate
        # limiting, not the (separately unit-tested) mute escalation
        cfg.mempool.qos_mute_after = 0
        # batched signature ingest: admission windows pre-verify on the
        # planner feed instead of one serial verify per tx in the app
        cfg.mempool.checktx_batch = 16
        cfg.mempool.tx_batch_window_ms = 2.0
        cfg.mempool.tx_batch_rows = 64
        return cfg

    def _key(i: int) -> PrivKeyEd25519:
        return PrivKeyEd25519.generate(b"flood-key-%04d" % i + b"\x00" * 18)

    # 8 spam senders x SPAM/8 sequential nonces; honest txs are one
    # high-priority payload per distinct sender
    spam_privs = [_key(i) for i in range(8)]
    honest_payloads = [b"pri2000:hon%d=x" % i for i in range(5)]
    honest_txs = [
        make_signed_tx(_key(100 + i), 1, p)
        for i, p in enumerate(honest_payloads)
    ]
    honest_keys = [p.split(b"=", 1)[0] for p in honest_payloads]

    def drive(run: ScenarioRun) -> List[str]:
        failures = []
        if not run.wait_height(1, 30.0):
            return [f"never warmed up: {run.heights()}"]
        spammer = run.nodes[3]
        # sign outside the submission loop: the flood's arrival RATE at the
        # honest peers is what saturates their buckets, so the loop must
        # stay tight
        spam_txs = [
            make_signed_tx(spam_privs[i % 8], i // 8 + 1, b"spam%06d=x" % i)
            for i in range(SPAM)
        ]
        # local submissions bypass QoS (it guards the peer boundary); the
        # flood reaches honest nodes via gossip, where their buckets bite
        for tx in spam_txs:
            try:
                spammer.mempool.check_tx(tx)
            except MempoolError:
                pass
        for tx in honest_txs:
            try:
                run.nodes[0].mempool.check_tx(tx)
            except MempoolError as e:
                failures.append(f"honest tx rejected at submission: {e}")
        committed = run.wait_for(
            lambda: all(
                all(k in n.app.state for k in honest_keys)
                for n in run.nodes
            ),
            timeout=60.0,
        )
        if not committed:
            missing = {
                n.node_id: [k.decode() for k in honest_keys
                            if k not in n.app.state]
                for n in run.nodes
            }
            failures.append(
                f"honest txs not committed everywhere under flood: {missing}"
            )
        return failures

    def check(run: ScenarioRun) -> List[str]:
        failures = []
        spammer_id = run.nodes[3].node_id
        for node in run.nodes:
            if node.mempool.size() > MAX_TXS:
                failures.append(
                    f"{node.node_id}: mempool size {node.mempool.size()} "
                    f"exceeds max_txs {MAX_TXS}"
                )
        # the spammer's bucket must have saturated on at least one honest
        # node (gossip dedup means not every node necessarily hears the
        # full flood directly from the spammer)
        drops = {}
        for node in run.nodes[:3]:
            peers = node.mempool_reactor.qos_snapshot()["peers"]
            drops[node.node_id] = peers.get(spammer_id, {}).get("dropped", 0)
        if not any(d > 0 for d in drops.values()):
            failures.append(
                f"no honest node rate-limited the spammer: drops={drops}"
            )
        # ...and the decision must be visible on the wire format operators
        # actually scrape
        for node in run.nodes[:3]:
            if drops[node.node_id] == 0:
                continue
            text = node.metrics.registry.expose_text()
            if "tendermint_mempool_qos_dropped_total" not in text:
                failures.append(
                    f"{node.node_id}: qos drop counter missing from "
                    f"metric exposition"
                )
        # the flood must actually have ridden the batched ingest path
        if not any(
            n.tx_feed is not None and n.tx_feed.dispatches > 0
            for n in run.nodes
        ):
            failures.append("tx feed never dispatched under flood")
        return failures

    return Scenario(
        name="mempool_flood",
        description="one node spams signed txs at ~10x the per-peer QoS "
                    "rate through the batched TxFeed ingest path; honest "
                    "priority txs still commit, mempools stay bounded, and "
                    "the spammer's drops land in the "
                    "tendermint_mempool_qos_* counters",
        seed=8,
        timeout_s=120.0,
        config_factory=config,
        app_factory=lambda i: SignedKVStoreApp(),
        drive=drive,
        check=check,
    )


def signed_flood() -> Scenario:
    """A mixed stream of valid / garbage-sig / wrong-nonce / mutant /
    undecodable signed txs rides the batched TxFeed ingest path while the
    device backend behind the guarded verifier flaps mid-stream.  Claims:
    every admit/reject code is bit-identical to a serial-verify oracle
    mempool fed the same stream, the committed app state ends identical on
    every node, the feed demonstrably dispatched (and fell back host-side
    through the flap), and the whole episode lands in the
    tendermint_mempool_batch_* exposition."""
    from tendermint_tpu_torch.abci.examples.kvstore import SignedKVStoreApp

    def config():
        cfg = test_config()
        cfg.mempool.checktx_batch = 16
        cfg.mempool.tx_batch_window_ms = 2.0
        cfg.mempool.tx_batch_rows = 64
        return cfg

    def setup(run: ScenarioRun) -> None:
        from tendermint_tpu_torch.crypto import batch as _batch
        from tendermint_tpu_torch.libs import breaker as _brk
        from tendermint_tpu_torch.sim.faults import FaultyDevice

        br = _brk.configure_device_guard(
            breaker_threshold=3, breaker_backoff=0.2,
            breaker_backoff_max=0.4, dispatch_deadline=0.3,
            audit_sample_rate=1.0, retries=0,
        )
        prev = _batch.get_batch_verifier()
        dev = FaultyDevice(_batch.HostBatchVerifier(),
                           seed=run.scenario.seed, hang_s=1.0)
        _batch.set_batch_verifier(_batch.GuardedBatchVerifier(dev, breaker=br))
        run.device, run.breaker = dev, br
        run.defer(_brk.reset_device_guard)
        run.defer(lambda: _batch.set_batch_verifier(prev))

    def _stream():
        from tendermint_tpu_torch.abci.examples.kvstore import make_signed_tx
        from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PrivKeySecp256k1

        privs = [
            PrivKeyEd25519.generate(b"signed-flood-%03d" % i + b"\x00" * 16)
            for i in range(6)
        ]
        secp = PrivKeySecp256k1.generate(b"signed-flood-secp" + b"\x00" * 15)
        txs = []
        for i, p in enumerate(privs):
            txs.append(make_signed_tx(p, 1, b"sf%02d=a" % i))
            garbage = bytearray(make_signed_tx(p, 2, b"sg%02d=b" % i))
            garbage[-6] ^= 0x55  # flips a payload byte -> sig mismatch
            txs.append(bytes(garbage))
            txs.append(make_signed_tx(p, 9, b"sw%02d=c" % i))  # nonce gap
            txs.append(make_signed_tx(p, 2, b"sk%02d=d" % i))
        txs.append(make_signed_tx(secp, 1, b"sfsecp=e"))  # host-lane algo
        txs.append(b"\x00garbage-not-a-signed-tx")  # undecodable
        valid_keys = (
            [b"sf%02d" % i for i in range(6)]
            + [b"sk%02d" % i for i in range(6)]
            + [b"sfsecp"]
        )
        return txs, valid_keys

    def drive(run: ScenarioRun) -> List[str]:
        import time as _time

        from tendermint_tpu_torch.mempool.mempool import Mempool, MempoolError
        from tendermint_tpu_torch.proxy.app_conn import (
            LocalClientCreator,
            MultiAppConn,
        )

        failures = []
        if not run.wait_height(1, 30.0):
            return [f"never warmed up: {run.heights()}"]
        txs, valid_keys = _stream()

        # serial oracle: same app, same stream, no feed — the app verifies
        # every signature inline; its codes are the ground truth
        oracle_conn = MultiAppConn(LocalClientCreator(SignedKVStoreApp()))
        oracle_conn.start()
        run.defer(oracle_conn.stop)
        oracle_mp = Mempool(oracle_conn.mempool, checktx_batch=1)
        oracle_codes = []
        for tx in txs:
            try:
                oracle_mp.check_tx(
                    tx, lambda res, _c=oracle_codes: _c.append(res.code))
            except MempoolError:
                oracle_codes.append(-1)

        node = run.nodes[0]
        codes = [None] * len(txs)
        dev = run.device
        for i, tx in enumerate(txs):
            if i == len(txs) // 3:
                dev.fail_rate = 1.0  # device flap mid-flood -> host fallback
            if i == 2 * len(txs) // 3:
                dev.fail_rate = 0.0
            try:
                node.mempool.check_tx(
                    tx,
                    lambda res, _i=i: codes.__setitem__(_i, res.code),
                )
            except MempoolError:
                codes[i] = -1
            _time.sleep(0.002)  # let windows close across the flap phases
        if not run.wait_for(lambda: all(c is not None for c in codes), 30.0):
            return [f"CheckTx verdicts never settled: {codes}"]
        if codes != oracle_codes:
            failures.append(
                "batched admit/reject codes diverged from the serial "
                f"oracle: {oracle_codes} vs {codes}"
            )
        # every valid tx must commit everywhere, and the committed state
        # must be bit-identical across nodes (DeliverTx re-verifies
        # serially, so state equality IS serial-path equality)
        if not run.wait_for(
            lambda: all(
                all(k in n.app.state for k in valid_keys)
                for n in run.nodes
            ),
            timeout=60.0,
        ):
            missing = {
                n.node_id: [k.decode() for k in valid_keys
                            if k not in n.app.state]
                for n in run.nodes
            }
            failures.append(f"valid signed txs not committed: {missing}")
        states = {tuple(sorted(n.app.state.items())) for n in run.nodes}
        if len(states) != 1:
            failures.append("committed app state diverged across nodes")
        nonces = {tuple(sorted(n.app.nonces.items())) for n in run.nodes}
        if len(nonces) != 1:
            failures.append("committed nonce maps diverged across nodes")
        return failures

    def check(run: ScenarioRun) -> List[str]:
        failures = []
        node = run.nodes[0]
        if node.tx_feed is None or node.tx_feed.dispatches == 0:
            failures.append("tx feed never dispatched")
        if run.device.snapshot()["failures"] == 0:
            failures.append("device flap never fired")
        text = node.metrics.registry.expose_text()
        for name in ("tendermint_mempool_batch_rows",
                     "tendermint_mempool_batch_flush_total"):
            if name not in text:
                failures.append(f"{name} missing from metric exposition")
        return failures

    return Scenario(
        name="signed_flood",
        description="mixed valid/garbage/wrong-nonce/mutant signed txs "
                    "through batched TxFeed ingest while the device "
                    "backend flaps; codes bit-identical to a serial "
                    "oracle, committed state identical on every node",
        seed=11,
        timeout_s=180.0,
        config_factory=config,
        app_factory=lambda i: SignedKVStoreApp(),
        setup=setup,
        drive=drive,
        check=check,
    )


def device_flap() -> Scenario:
    """The guarded batch verifier's device backend fails, hangs, recovers,
    then silently corrupts — mid-run, with consensus live on top of it.
    The breaker must walk the whole state machine (open on errors, open on
    timeouts, half-open probe, re-close, quarantine latch on the audit
    mismatch, operator reset), verdicts must stay bit-identical to the
    host path throughout (asserted indirectly: safety + uninterrupted
    liveness), and the episode must land in the metric exposition."""

    def setup(run: ScenarioRun) -> None:
        from tendermint_tpu_torch.crypto import batch as _batch
        from tendermint_tpu_torch.libs import breaker as _brk
        from tendermint_tpu_torch.sim.faults import FaultyDevice

        # small backoffs so every transition fits a smoke-test budget;
        # audit every lane so the first corrupt window is always caught
        br = _brk.configure_device_guard(
            breaker_threshold=3, breaker_backoff=0.2,
            breaker_backoff_max=0.4, dispatch_deadline=0.3,
            audit_sample_rate=1.0, retries=0,
        )
        prev = _batch.get_batch_verifier()  # installed by build_sim_net
        dev = FaultyDevice(_batch.HostBatchVerifier(),
                           seed=run.scenario.seed, hang_s=1.0)
        _batch.set_batch_verifier(_batch.GuardedBatchVerifier(dev, breaker=br))
        run.device, run.breaker = dev, br
        run.defer(_brk.reset_device_guard)
        run.defer(lambda: _batch.set_batch_verifier(prev))

    def drive(run: ScenarioRun) -> List[str]:
        from tendermint_tpu_torch.libs import breaker as _brk

        failures = []
        br, dev = run.breaker, run.device
        if not run.wait_height(1, 30.0):
            return [f"never warmed up: {run.heights()}"]

        def phase(label: str, want_state: str, budget: float = 20.0,
                  progress: int = 2) -> None:
            run.mark(label)
            if not run.wait_for(lambda: br.state == want_state, budget):
                failures.append(
                    f"{label}: breaker stuck in {br.state!r}, "
                    f"wanted {want_state!r}"
                )
            h = max(run.heights())
            if progress and not run.wait_height(h + progress, 45.0):
                failures.append(
                    f"{label}: chain stalled at {run.heights()} "
                    f"(breaker {br.state})"
                )

        dev.fail_rate = 1.0          # crashing device -> open, host fallback
        phase("fail", _brk.OPEN)
        dev.fail_rate = 0.0          # recovery -> half-open probe re-closes
        phase("recover_fail", _brk.CLOSED, progress=0)
        dev.hang_rate = 1.0          # wedged device -> timeouts -> open again
        phase("hang", _brk.OPEN)
        dev.hang_rate = 0.0
        phase("recover_hang", _brk.CLOSED, progress=0)
        dev.corrupt_rate = 1.0       # silent corruption -> quarantine latch
        phase("corrupt", _brk.QUARANTINED)
        dev.corrupt_rate = 0.0
        br.reset()                   # the operator runbook step
        phase("operator_reset", _brk.CLOSED)
        return failures

    def check(run: ScenarioRun) -> List[str]:
        from tendermint_tpu_torch.libs.metrics import get_verify_metrics

        failures = []
        snap = run.breaker.snapshot()
        walked = {(h["from"], h["to"]) for h in snap["history"]}
        for want in [("closed", "open"), ("open", "half_open"),
                     ("half_open", "closed"), ("closed", "quarantined"),
                     ("quarantined", "closed")]:
            if want not in walked:
                failures.append(f"breaker never transitioned {want}: {walked}")
        reasons = " ".join(h["reason"] for h in snap["history"])
        if "timeout" not in reasons:
            failures.append(f"no timeout-driven open in history: {reasons}")
        dsnap = run.device.snapshot()
        if dsnap["failures"] == 0 or dsnap["hangs"] == 0 \
                or dsnap["corruptions"] == 0:
            failures.append(f"fault injection never fired: {dsnap}")
        text = get_verify_metrics().registry.expose_text()
        for name in ("tendermint_verify_device_breaker_state",
                     "tendermint_verify_device_fallback_total",
                     "tendermint_verify_device_audit_total"):
            if name not in text:
                failures.append(f"{name} missing from metric exposition")
        return failures

    return Scenario(
        name="device_flap",
        description="device backend fails/hangs/corrupts mid-run; breaker "
                    "walks its full state machine, consensus keeps "
                    "committing on host fallback, audit quarantines the "
                    "corruptor before a wrong verdict escapes",
        seed=9,
        timeout_s=180.0,
        setup=setup,
        drive=drive,
        check=check,
    )


def crash_restart() -> Scenario:
    """Kill one validator mid-height and rebuild it from its surviving
    stores + WAL file: the replacement must replay WAL messages into the
    round state, re-apply committed blocks into the fresh app over the
    ABCI handshake, and catch back up to the live chain."""
    import os
    import shutil
    import tempfile

    VICTIM = 2

    def setup(run: ScenarioRun) -> None:
        from tendermint_tpu_torch.sim.node import SimNode

        tmp = tempfile.mkdtemp(prefix="tm-sim-crash-")
        run.defer(lambda: shutil.rmtree(tmp, ignore_errors=True))
        # rebuild the victim with a real on-disk WAL before anything
        # starts (build_sim_net wires WAL-less nodes); peers' handles to
        # the node id stay valid, the fabric just re-points the id
        old = run.nodes[VICTIM]
        old.crash()
        node = SimNode(
            index=old.index, node_id=old.node_id, doc=old.doc, pv=old.pv,
            fabric=run.fabric, config=old.config, clock=old.clock,
            wal_path=os.path.join(tmp, "cs.wal"), device=old.device,
        )
        for other in run.nodes:
            if other is not old:
                node.switch.connect(other.node_id)
        run.nodes[VICTIM] = node

    def drive(run: ScenarioRun) -> List[str]:
        failures = []
        if not run.wait_height(2, 45.0):
            return [f"never warmed up: {run.heights()}"]
        pre_crash = dict(run.nodes[VICTIM].committed_hashes())
        node = run.crash_restart(VICTIM)
        if node.handshake_blocks <= 0:
            failures.append(
                "ABCI handshake replayed no blocks into the fresh app"
            )
        if node.cs.wal_replayed <= 0:
            failures.append("WAL replay re-fed no messages after the crash")
        for h, hh in pre_crash.items():
            if node.committed_hashes().get(h) != hh:
                failures.append(
                    f"restart lost/changed committed block at height {h}"
                )
        h = max(run.heights())
        if not run.wait_for(lambda: node.height > h + 2, 60.0):
            failures.append(
                f"restarted node never rejoined: victim at {node.height}, "
                f"net at {run.heights()}"
            )
        return failures

    return Scenario(
        name="crash_restart",
        description="node killed mid-height, rebuilt from stores + WAL; "
                    "WAL replay + ABCI handshake bring it back and it "
                    "catches up to the chain",
        seed=10,
        timeout_s=180.0,
        setup=setup,
        drive=drive,
    )


def quorum_observatory() -> Scenario:
    """The observability stack under its designed-for conditions: ±2s
    wall-clock skews, a seeded gossip storm (duplicates + reorder feed the
    waste ledger), and one node's clock frozen mid-run then resumed (the
    worst distortion commit-anchor math must survive).  Claims: every
    fused vote journey presents a monotone sign -> send -> arrival
    timeline after anchor correction (with the raw stamps of unfrozen
    nodes landing within a small residual of the signer's corrected
    stamp — i.e. the injected ±2s really was measured back out), the
    freeze demonstrably distorted stamps (some journey got clamped), and
    every live quorum record's pivotal-validator naming re-derives
    bit-identically from the node's own flight dump — identification is a
    deterministic pure function of the stamps, not of analysis timing."""

    FROZEN = 2  # index into SKEWS_NS: the -1.5s node also gets frozen
    storm_policy = dict(delay_s=0.002, jitter_s=0.008, drop=0.05,
                        duplicate=0.15, reorder=0.15, reorder_extra_s=0.03)

    def drive(run: ScenarioRun) -> List[str]:
        import time as _time

        failures = []
        if not run.wait_height(2, 45.0):
            return [f"never warmed up: {run.heights()}"]
        clk = run.nodes[FROZEN].clock
        # freeze at the current instant: now_ns() keeps returning
        # frozen + skew, so the node's stamps stop advancing while the
        # chain (driven by real-time timers, not wall stamps) keeps going
        clk.freeze(_time.time_ns())
        run.mark("frozen")
        h = max(run.heights())
        if not run.wait_height(h + 2, 60.0):
            failures.append(
                f"no progress while node {FROZEN}'s clock was frozen: "
                f"{run.heights()}"
            )
        clk.freeze(0)  # resume
        run.mark("resumed")
        h2 = max(run.heights())
        if not run.wait_height(h2 + 2, 60.0):
            failures.append(
                f"no progress after clock resume: {run.heights()}"
            )
        return failures

    def check(run: ScenarioRun) -> List[str]:
        from tendermint_tpu_torch.libs import quorumtrace as qt
        from tendermint_tpu_torch.tools import trace_merge as tm

        failures = []
        frozen_id = run.nodes[FROZEN].node_id
        dumps = [n.cs.flight.snapshot() for n in run.nodes]
        skews = tm.compute_skews(dumps)
        # anchor recovery must still measure the injected skews out of the
        # UNFROZEN nodes; the frozen node's freeze-window anchors are
        # legitimately bogus (the median absorbs them, but only within
        # whatever share of heights the freeze covered — don't gate on it)
        for i, skew in enumerate(skews):
            if i == FROZEN:
                continue
            expected = SKEWS_NS[0] - SKEWS_NS[i]
            err_s = abs(skew - expected) / 1e9
            if err_s > 0.5:
                failures.append(
                    f"node {i}: recovered skew {skew / 1e9:+.3f}s vs "
                    f"injected {expected / 1e9:+.3f}s (err {err_s:.3f}s)"
                )
        skew_map = {
            (d.get("node_id") or f"node{i}"): skews[i]
            for i, d in enumerate(dumps)
        }
        journeys = qt.build_journeys(dumps, skew_map)
        with_arrivals = [
            j for j in journeys
            if j["signed_ns"] is not None and j["arrivals"]
        ]
        if len(with_arrivals) < 4:
            failures.append(
                f"only {len(with_arrivals)} journeys fused with both a "
                f"sign stamp and arrivals"
            )
        clamped_on_frozen = False
        for j in with_arrivals:
            floor = j["signed_ns"]
            send = j["first_send"]
            if send is not None:
                if send["t_mono_ns"] < floor:
                    failures.append(
                        f"h={j['height']} {j['kind']} vi="
                        f"{j['validator_index']}: first_send precedes "
                        f"sign in the monotone view"
                    )
                floor = send["t_mono_ns"]
            for node, mark in j["arrivals"].items():
                if mark["t_mono_ns"] < floor:
                    failures.append(
                        f"h={j['height']} {j['kind']} vi="
                        f"{j['validator_index']}: arrival at {node} "
                        f"precedes its upstream leg in the monotone view"
                    )
                # unfrozen raw stamps must sit within a small residual of
                # the signer's corrected stamp: uncorrected, the -1.5s /
                # +2s skews would invert these legs by whole seconds
                if (node != frozen_id and j["origin"] != frozen_id
                        and mark["t_ns"] < j["signed_ns"] - 350_000_000):
                    failures.append(
                        f"h={j['height']} {j['kind']} vi="
                        f"{j['validator_index']}: arrival at {node} "
                        f"{(mark['t_ns'] - j['signed_ns']) / 1e9:+.3f}s "
                        f"before signing — skew not corrected out"
                    )
                if j["clamped"] and (node == frozen_id
                                     or j["origin"] == frozen_id):
                    clamped_on_frozen = True
        if not clamped_on_frozen:
            failures.append(
                "freeze never distorted a journey (no clamped stamp "
                "touching the frozen node) — the scenario lost its bite"
            )
        # pivotal-validator determinism: every live record's curves must
        # re-derive bit-identically from the node's own flight record —
        # the naming is a pure function of the dump, so any consumer
        # (report, RPC, re-analysis) reproduces it exactly
        named = 0
        for node in run.nodes:
            for rec in node.cs.quorumtrace.records():
                frec = node.cs.flight.peek(rec["height"])
                if frec is None:
                    continue  # ring evicted it; nothing to re-derive
                for kind, curve in rec["curves"].items():
                    redo = qt.completion_curve(
                        frec, kind, curve["total_power"]
                    )
                    if redo is None or (
                        redo["pivotal_validator"]
                        != curve["pivotal_validator"]
                        or redo["crossings"] != curve["crossings"]
                    ):
                        failures.append(
                            f"{node.node_id}: h={rec['height']} {kind} "
                            f"re-derived pivotal "
                            f"{redo and redo['pivotal_validator']} != "
                            f"recorded {curve['pivotal_validator']}"
                        )
                    if curve["pivotal_validator"] is not None:
                        named += 1
        if named == 0:
            failures.append("no height named a pivotal validator")
        return failures

    return Scenario(
        name="quorum_observatory",
        description="±2s skews + seeded storm + one frozen-then-resumed "
                    "clock: fused vote journeys stay monotone after "
                    "commit-anchor correction and pivotal-validator "
                    "naming re-derives bit-identically from the dumps",
        seed=13,
        timeout_s=180.0,
        config_factory=_skew_config,
        clock_factory=lambda i: SimClock(skew_ns=SKEWS_NS[i]),
        drive=drive,
        check=check,
        ops=[FaultOp(at_s=0.0, op="policy",
                     kwargs={"src": None, "dst": None,
                             "policy": storm_policy})],
    )


SCENARIOS: Dict[str, Callable[[], Scenario]] = {
    "baseline_determinism": baseline_determinism,
    "partition_heal": partition_heal,
    "partition_heal_9": lambda: partition_heal(n_vals=9),
    "storm": storm,
    "clock_skew": clock_skew,
    "churn": churn,
    "equivocation": equivocation,
    "vote_storm": vote_storm,
    "silence_watchdog": silence_watchdog,
    "mempool_flood": mempool_flood,
    "signed_flood": signed_flood,
    "device_flap": device_flap,
    "crash_restart": crash_restart,
    "quorum_observatory": quorum_observatory,
}
