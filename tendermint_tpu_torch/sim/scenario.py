"""Scenario — the timed fault-schedule DSL and its runner; the port's copy
of the reference package's ``sim/scenario.py``, whose ``run_scenario``
also takes the net's ``device`` (None: the card; ``"cpu"``: the host, as
the reference runs).

A `Scenario` is data: node count, one PRNG seed, a timed list of
`FaultOp`s (policy changes, partitions, silences, clock skews, tx
injections, height marks), plus optional `setup`/`drive`/`check` hooks for
phase-dependent logic that a fixed timeline can't express (e.g. "wait for
the stall report, then heal").

`run_scenario` builds the net, replays the ops on their timeline, waits
for the completion condition, and then ALWAYS asserts the two invariants
every scenario shares:

* **safety** — no two nodes committed different blocks at any height
  (cross-checked from every node's block store);
* **replayability** — every seeded fault decision the fabric logged
  re-derives bit-identically from (seed, link, seq).

Everything observed lands in the returned `ScenarioResult`: per-node
commit hashes, flight-recorder dumps (for `trace_merge`), fault counters,
stall reports, failures.  `seed` is printed on every failure so the run
can be replayed exactly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.device import DeviceLike
from tendermint_tpu_torch.sim.simnet import LinkPolicy


@dataclass
class FaultOp:
    """One timed operation.  `at_s` is seconds after net start."""

    at_s: float
    # policy|clear_policies|partition|heal|silence|unsilence|skew|tx|mark|
    # crash_restart
    op: str
    kwargs: dict = field(default_factory=dict)


@dataclass
class Scenario:
    name: str
    description: str
    n_vals: int = 4
    seed: int = 0
    target_height: int = 5
    timeout_s: float = 60.0
    ops: List[FaultOp] = field(default_factory=list)
    config_factory: Optional[Callable[[], object]] = None
    app_factory: Optional[Callable[[int], object]] = None
    clock_factory: Optional[Callable[[int], object]] = None
    byzantine: Optional[Dict[int, Callable]] = None
    setup: Optional[Callable[["ScenarioRun"], None]] = None
    # phase-dependent middle part; returns failure strings.  Default waits
    # for every node to pass target_height.
    drive: Optional[Callable[["ScenarioRun"], List[str]]] = None
    check: Optional[Callable[["ScenarioRun"], List[str]]] = None


@dataclass
class ScenarioResult:
    name: str
    seed: int
    ok: bool
    failures: List[str]
    elapsed_s: float
    heights: List[int]
    commit_hashes: List[Dict[int, str]]  # per node: height -> hash hex
    commit_rounds: List[Dict[int, int]]  # per node: height -> commit round
    flight_dumps: List[dict]
    critpath_dumps: List[dict]  # per node: cs.critpath.snapshot()
    quorum_dumps: List[dict]  # per node: cs.quorumtrace.snapshot()
    fault_summary: dict
    stall_reports: List[dict]
    marks: Dict[str, dict]


def round0_clean_top(result: "ScenarioResult") -> int:
    """Highest height H such that every node committed heights 1..H with
    every commit forming at round 0.  Same-seed determinism is only
    guaranteed up to this height: a round > 0 commit means a real-time
    timeout fired (host under load), after which proposer rotation may
    legitimately diverge between otherwise identical runs."""
    tops = []
    for hashes, rounds in zip(result.commit_hashes, result.commit_rounds):
        top = 0
        h = 1
        while h in hashes and rounds.get(h, 0) == 0:
            top = h
            h += 1
        tops.append(top)
    return min(tops) if tops else 0


class ScenarioRun:
    """Live state handed to setup/drive/check hooks."""

    def __init__(self, scenario: Scenario, fabric, nodes):
        self.scenario = scenario
        self.fabric = fabric
        self.nodes = nodes
        self.marks: Dict[str, dict] = {}
        self.failures: List[str] = []
        self.t0 = 0.0
        self._defers: List[Callable[[], None]] = []

    def defer(self, fn: Callable[[], None]) -> None:
        """Register a cleanup to run after every node has stopped (LIFO) —
        scenarios use it for tmpdirs and process-global verifier swaps."""
        self._defers.append(fn)

    def heights(self) -> List[int]:
        return [n.height for n in self.nodes]

    def mark(self, label: str) -> dict:
        m = {"t_s": round(time.monotonic() - self.t0, 3),
             "heights": self.heights()}
        self.marks[label] = m
        return m

    def wait_for(self, predicate, timeout: float, interval: float = 0.02) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(interval)
        return False

    def wait_height(self, height: int, timeout: float,
                    nodes: Optional[List[int]] = None) -> bool:
        idx = nodes if nodes is not None else range(len(self.nodes))
        return self.wait_for(
            lambda: all(self.nodes[i].height > height for i in idx), timeout
        )

    # -- op application ------------------------------------------------------
    def apply_op(self, op: FaultOp) -> None:
        kw = op.kwargs
        if op.op == "policy":
            self.fabric.set_policy(
                kw.get("src"), kw.get("dst"), LinkPolicy(**kw["policy"])
            )
        elif op.op == "clear_policies":
            self.fabric.clear_policies()
        elif op.op == "partition":
            groups = [
                {self.nodes[i].node_id for i in group}
                for group in kw["groups"]
            ]
            self.fabric.set_partition(groups)
        elif op.op == "heal":
            self.fabric.heal_partition()
        elif op.op == "silence":
            self.fabric.silence({self.nodes[i].node_id for i in kw["nodes"]})
        elif op.op == "unsilence":
            self.fabric.unsilence(
                None if "nodes" not in kw
                else {self.nodes[i].node_id for i in kw["nodes"]}
            )
        elif op.op == "skew":
            self.nodes[kw["node"]].clock.set_skew(kw["skew_ns"])
        elif op.op == "tx":
            for i in kw.get("nodes", range(len(self.nodes))):
                try:
                    self.nodes[i].mempool.check_tx(kw["tx"])
                except Exception:
                    pass  # duplicate/rejected on some nodes is fine
        elif op.op == "crash_restart":
            self.crash_restart(kw["node"], fresh_app=kw.get("fresh_app", True))
        elif op.op == "mark":
            self.mark(kw["label"])
        else:
            raise ValueError(f"unknown fault op {op.op!r}")

    def crash_restart(self, i: int, fresh_app: bool = True):
        """Kill node `i` and rebuild it from its surviving stores.  The
        replacement loads state from the old state_db, replays the WAL
        into the round state, runs the ABCI handshake (re-applying every
        committed block into a fresh app when `fresh_app`), and rejoins
        the fabric under the same node id.  Replaces ``self.nodes[i]`` in
        place — run_scenario's final stop loop sees the new node."""
        from tendermint_tpu_torch.sim.node import SimNode

        old = self.nodes[i]
        old.crash()
        node = SimNode(
            index=old.index, node_id=old.node_id, doc=old.doc, pv=old.pv,
            fabric=self.fabric, config=old.config,
            app=None if fresh_app else old.app, clock=old.clock,
            state_db=old.state_db, block_store=old.block_store,
            wal_path=old.wal_path, handshake=True, device=old.device,
        )
        # Re-wire the mesh from the new switch's side; the other nodes'
        # existing InProcPeer handles stay valid (the fabric routes by
        # node id, and register() re-points the id at the new switch).
        for other in self.nodes:
            if other is not old:
                node.switch.connect(other.node_id)
                other.switch.connect(node.node_id)  # idempotent
        node.start()
        self.nodes[i] = node
        self.mark(f"crash_restart:{old.node_id}")
        return node


def _safety_failures(run: ScenarioRun) -> List[str]:
    """No two nodes may commit different blocks at the same height."""
    failures = []
    by_height: Dict[int, Dict[str, List[str]]] = {}
    for node in run.nodes:
        for h, hh in node.committed_hashes().items():
            by_height.setdefault(h, {}).setdefault(hh, []).append(node.node_id)
    for h in sorted(by_height):
        if len(by_height[h]) > 1:
            failures.append(
                f"SAFETY VIOLATION at height {h}: conflicting commits "
                f"{by_height[h]}"
            )
    return failures


def run_scenario(scenario: Scenario, seed: Optional[int] = None, *,
                 device: DeviceLike = None) -> ScenarioResult:
    """Build, run, fault-inject, and invariant-check one scenario on
    ``device`` (None: the card; ``"cpu"``: the host)."""
    from tendermint_tpu_torch.sim.node import build_sim_net

    seed = scenario.seed if seed is None else seed
    config = (scenario.config_factory() if scenario.config_factory
              else None)
    fabric, nodes = build_sim_net(
        scenario.n_vals,
        seed=seed,
        config=config,
        app_factory=scenario.app_factory,
        clock_factory=scenario.clock_factory,
        byzantine=scenario.byzantine,
        device=device,
    )
    run = ScenarioRun(scenario, fabric, nodes)
    failures: List[str] = []
    heights: List[int] = []
    commit_hashes: List[Dict[int, str]] = []
    commit_rounds: List[Dict[int, int]] = []
    flight_dumps: List[dict] = []
    critpath_dumps: List[dict] = []
    quorum_dumps: List[dict] = []
    stall_reports: List[dict] = []
    summary: dict = {}
    started = time.monotonic()
    try:
        if scenario.setup is not None:
            scenario.setup(run)
        fabric.start()
        for node in nodes:
            node.start()
        run.t0 = time.monotonic()

        # the timed fault schedule, interleaved with the drive below
        import threading

        def ops_timeline():
            for op in sorted(scenario.ops, key=lambda o: o.at_s):
                delay = run.t0 + op.at_s - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                try:
                    run.apply_op(op)
                except Exception as e:
                    run.failures.append(f"op {op.op}@{op.at_s}s failed: {e}")

        ops_thread = threading.Thread(
            target=ops_timeline, name="scenario-ops", daemon=True
        )
        ops_thread.start()

        if scenario.drive is not None:
            failures.extend(scenario.drive(run) or [])
        else:
            if not run.wait_height(scenario.target_height, scenario.timeout_s):
                failures.append(
                    f"liveness: heights={run.heights()} never passed "
                    f"{scenario.target_height} within {scenario.timeout_s}s"
                )
        ops_thread.join(timeout=5.0)
        failures.extend(run.failures)

        if scenario.check is not None:
            failures.extend(scenario.check(run) or [])
        failures.extend(_safety_failures(run))
        bad = fabric.replay_schedule()
        if bad:
            failures.append(
                f"replay: {len(bad)} seeded fault decisions did not "
                f"re-derive from seed {seed}"
            )

        heights = run.heights()
        commit_hashes = [n.committed_hashes() for n in nodes]
        commit_rounds = [n.commit_rounds() for n in nodes]
        flight_dumps = [n.cs.flight.snapshot() for n in nodes]
        critpath_dumps = [n.cs.critpath.snapshot() for n in nodes]
        quorum_dumps = [n.cs.quorumtrace.snapshot() for n in nodes]
        stall_reports = [
            n.watchdog.report() for n in nodes
            if n.watchdog is not None and n.watchdog.report() is not None
        ]
        summary = fabric.fault_summary()
    except Exception as e:  # a crashed scenario is a failed scenario
        failures.append(f"scenario crashed: {e!r}")
    finally:
        for node in nodes:
            node.stop()
        fabric.stop()
        for fn in reversed(run._defers):
            try:
                fn()
            except Exception:
                pass

    return ScenarioResult(
        name=scenario.name,
        seed=seed,
        ok=not failures,
        failures=failures,
        elapsed_s=round(time.monotonic() - started, 3),
        heights=heights,
        commit_hashes=commit_hashes,
        commit_rounds=commit_rounds,
        flight_dumps=flight_dumps,
        critpath_dumps=critpath_dumps,
        quorum_dumps=quorum_dumps,
        fault_summary=summary,
        stall_reports=stall_reports,
        marks=run.marks,
    )
