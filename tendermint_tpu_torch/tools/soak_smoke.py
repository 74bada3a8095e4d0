"""Soak observatory smoke: the port's counterpart of the reference's
``scripts/soak_smoke.py`` (``make soak-smoke``).

    python3 -m tendermint_tpu_torch.tools.soak_smoke                   # the card, 210 heights
    python3 -m tendermint_tpu_torch.tools.soak_smoke --device cpu --target-height 42 \\
        [--round-dir DIR]

Drives the soak pipeline (mergeable sketches, the crash-safe telemetry
spool, the fleet report) end to end, in one process: a 4-validator
``sim/node.build_sim_net`` mesh runs ``--target-height`` heights (default
210) through three regimes (clean, a fault leg of injected link latency,
clean again), each node spooling height-triggered telemetry snapshots to
its own on-disk segment group, and one node crashed mid-run (a torn spool
frame appended) and rebuilt from its durable stores. The marks keep the
reference's proportions of the depth (the fault over (1/3, 4/7], the crash
at 2/3, a snapshot every 1/21, at least one height between marks), and so
does the undersized flight ring (32 of 210), so that the rebuilt victim
evicts too at a cut depth. The checks do not change with depth:

  1. **Sketch accuracy**: per node, the whole-run commit sketch agrees with
     the exact nearest-rank percentiles of the full critpath record list,
     within the sketch's relative error, and counted every committed height.
  2. **Crash safety**: the victim's spool survives the kill and the torn
     frame: the rebuilt spool truncates the torn tail on reopen
     (recovered_bytes > 0), every pre-crash snapshot reads back byte for
     byte, and post-crash snapshots append behind them.
  3. **Merge exactness**: the fleet sketch of ``tools/soak_report`` is bucket
     for bucket the manual merge of the per-node sketches, in any order.
  4. **Loss accounting**: with the flight ring undersized,
     ``tendermint_observability_evicted_total{store="flight"}`` ticks on
     every node, the telemetry families expose, and every exposition
     passes ``tools/metrics_lint``.
  5. **The round**: with ``--round-dir``, the next ``SOAK_rNN.json`` there in
     the reference's format (``scripts/bench_check.py --prefix SOAK --dir``
     reads it); without it no round file is written (the reference writes
     into its checkout, beside its CPU rounds).

On ``--device`` (default ``cuda``; ``tools/smoke_verify``): on the card
every block's LastCommit check goes to the root's guarded verifier (K1 +
K2), the rebuilt victim's included, and the run must reach the card;
``cpu`` verifies on the host. Spools live in a temporary directory that
the run removes.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import sys
import tempfile
import time

from tendermint_tpu_torch.config.config import test_config
from tendermint_tpu_torch.libs.sketch import QuantileSketch
from tendermint_tpu_torch.libs.telemetry import (
    TelemetrySpool,
    encode_record,
    node_sources,
    read_spool,
)
from tendermint_tpu_torch.sim.node import SimNode, build_sim_net
from tendermint_tpu_torch.sim.simnet import LinkPolicy
from tendermint_tpu_torch.testutil.consensus import wait_for
from tendermint_tpu_torch.tools import soak_report
from tendermint_tpu_torch.tools.metrics_lint import lint_text
from tendermint_tpu_torch.tools.smoke_verify import SmokeVerify, finish, write_round

N_VALS = 4
SEED = 29
TARGET_HEIGHT = 210  # >= 200 heights of soak at the reference's depth
VICTIM = 2
FAULT_POLICY = LinkPolicy(delay_s=0.02, jitter_s=0.02)
CRITPATH_CAPACITY = 2048  # oversized on purpose: the exact offline reference
LEG_TIMEOUT_S = 180.0
FINAL_TIMEOUT_S = 300.0
CRASH_JOIN_S = 10.0

TELEMETRY_FAMILIES = (
    "tendermint_telemetry_snapshots_total",
    "tendermint_telemetry_spool_bytes",
    "tendermint_telemetry_write_errors_total",
    "tendermint_telemetry_dropped_snapshots_total",
    "tendermint_observability_evicted_total",
)


def marks(target: int) -> dict:
    """The run's marks at depth ``target`` in the reference's proportions
    (at 210: the fault over (70, 120], the crash at 140, a snapshot every
    10 heights, a 32-height flight ring), each at least one height after
    the one before."""
    fault_at = max(1, round(target / 3))
    fault_clear = max(fault_at + 1, round(4 * target / 7))
    crash_at = max(fault_clear + 1, round(2 * target / 3))
    if crash_at >= target:
        raise ValueError(f"--target-height {target} leaves no height after the crash")
    return {"fault_at": fault_at, "fault_clear": fault_clear, "crash_at": crash_at,
            "spool_interval": max(1, round(target / 21)),
            "flight_capacity": max(2, round(32 * target / 210))}


def _prep_node(node, m: dict) -> None:
    """A tiny flight ring (eviction accounting has something to count) and
    a huge critpath ring (the exact reference the sketch is judged
    against)."""
    node.cs.flight.enable(capacity=m["flight_capacity"])
    node.cs.critpath.reset(capacity=CRITPATH_CAPACITY)


def _make_spool(node, tmp: str, m: dict) -> TelemetrySpool:
    """The wiring a node gives its spool, on a SimNode."""
    path = os.path.join(tmp, node.node_id, "spool")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    spool = TelemetrySpool(
        path,
        node_id=node.node_id,
        interval_heights=m["spool_interval"],
        interval_seconds=0.0,  # height-triggered only: deterministic legs
        ring_capacity=64,
        metrics=node.metrics.telemetry,
        height_fn=lambda n=node: n.cs.rs.height,
    )
    node.consensus_state = node.cs  # node_sources speaks a full node's layout
    for name, fn in node_sources(node).items():
        spool.set_source(name, fn)
    spool.set_source("spool", spool.status)
    spool.start()
    return spool


def exact_percentile(xs, q: float) -> float:
    """The exact nearest-rank percentile: the truth the sketch's
    relative-error guarantee is stated against."""
    ordered = sorted(xs)
    return ordered[max(1, math.ceil(q * len(ordered))) - 1]


def _check_sketch_accuracy(node_id: str, crit: dict, failures: list) -> None:
    exact = [rec["commit_seconds"] for rec in crit["records"]]
    if crit["evicted"]:
        failures.append(f"{node_id}: critpath evicted {crit['evicted']} records — exact "
                        f"reference incomplete (raise CRITPATH_CAPACITY)")
        return
    sk = QuantileSketch.from_dict(crit["sketches"]["commit"])
    if sk.count != len(exact):
        failures.append(f"{node_id}: commit sketch counted {sk.count} samples, critpath ring "
                        f"holds {len(exact)}")
        return
    if not exact:
        failures.append(f"{node_id}: no commit samples at all")
        return
    for q in (0.50, 0.90, 0.99):
        est, truth = sk.quantile(q), exact_percentile(exact, q)
        # the DDSketch guarantee: |est - x| <= alpha * x for the sample x
        # at the requested rank
        if abs(est - truth) > sk.alpha * truth + 1e-12:
            failures.append(f"{node_id}: q={q} sketch={est:.6f}s exact={truth:.6f}s violates "
                            f"the {sk.alpha:.0%} relative-error bound")


def sketchdicts_equal(a: dict, b: dict) -> bool:
    """Exact on everything the merge guarantee covers; ``sum`` is float
    addition, order-sensitive by design, so it gets a tolerance."""
    keys = ("kind", "alpha", "count", "min", "max", "zero", "buckets")
    if any(a.get(k) != b.get(k) for k in keys):
        return False
    return math.isclose(a["sum"], b["sum"], rel_tol=1e-9, abs_tol=1e-12)


def _check_fleet_merge(report: dict, failures: list) -> None:
    fleet = (report.get("fleet") or {}).get("critpath/commit")
    if not fleet or fleet["n"] == 0:
        failures.append("report has no fleet commit sketch")
        return
    per_node = {node: d["critpath/commit"]
                for node, d in (report.get("per_node_final") or {}).items()
                if "critpath/commit" in d}
    if len(per_node) != N_VALS:
        failures.append(f"per_node_final commit sketches from {sorted(per_node)} "
                        f"(want all {N_VALS} nodes)")
        return
    merges = [QuantileSketch.merged([QuantileSketch.from_dict(per_node[n]) for n in order]
                                    ).to_dict()
              for order in (sorted(per_node), sorted(per_node, reverse=True))]
    if not sketchdicts_equal(merges[0], merges[1]):
        failures.append("merge order changed the fleet sketch buckets")
    if not sketchdicts_equal(fleet["sketch"], merges[0]):
        failures.append("fleet-merged sketch != manual merge of per-node sketches")


def _check_exposition(node_id: str, text: str, m: dict, failures: list) -> None:
    for name in TELEMETRY_FAMILIES:
        if f"# TYPE {name} " not in text:
            failures.append(f"{node_id}: exposition missing {name}")
    if 'tendermint_observability_evicted_total{store="flight"}' not in text:
        failures.append(f"{node_id}: no flight eviction sample despite the "
                        f"{m['flight_capacity']}-height ring")
    failures.extend(f"{node_id} metrics_lint: {e}" for e in lint_text(text))


def _soak(device, target: int, m: dict, tmp: str) -> tuple:
    """The run and its crash: (failures, nodes, spools, the victim's
    spool path, its pre-crash read) or (failures, ...) on a stuck net."""
    failures = []
    fabric, nodes = build_sim_net(N_VALS, seed=SEED, config=test_config(), device=device)
    for n in nodes:
        _prep_node(n, m)
    spools = {n.node_id: _make_spool(n, tmp, m) for n in nodes}
    victim_id = nodes[VICTIM].node_id
    pre_crash = None

    def reach(height, timeout, what):
        if wait_for(lambda: all(n.height >= height for n in nodes), timeout, 0.05):
            return True
        failures.append(f"{what}: {[n.height for n in nodes]}")
        return False

    try:
        fabric.start()
        for n in nodes:
            n.start()
        print(f"[soak-smoke] {N_VALS}-node net -> height {target} (fault "
              f"({m['fault_at']},{m['fault_clear']}], crash v{VICTIM} at {m['crash_at']}, a "
              f"snapshot every {m['spool_interval']}, flight ring {m['flight_capacity']})...",
              flush=True)
        if not reach(m["fault_at"], LEG_TIMEOUT_S, "never reached the fault leg"):
            return failures, nodes, spools, None
        print("[soak-smoke] fault leg: injecting link latency...", flush=True)
        fabric.set_policy(None, None, FAULT_POLICY)
        if not reach(m["fault_clear"], LEG_TIMEOUT_S, "stuck inside the fault leg"):
            return failures, nodes, spools, None
        fabric.set_policy(None, None, LinkPolicy())
        if not reach(m["crash_at"], LEG_TIMEOUT_S, "never reached the crash height"):
            return failures, nodes, spools, None

        # crash the victim the unclean way: no shutdown snapshot, and a torn
        # half-frame appended to the spool head, as a kill -9 mid-write
        # leaves the disk
        print(f"[soak-smoke] crashing {victim_id} (torn spool frame included)...", flush=True)
        spools[victim_id].kill()
        pre_crash = read_spool(spools[victim_id].path)
        if not pre_crash["snapshots"]:
            failures.append("victim spooled nothing before the crash")
        with open(spools[victim_id].path, "ab") as f:
            f.write(encode_record(b'{"torn":true}\n')[:9])
        old = nodes[VICTIM]
        old.crash()
        # the kill lands between two messages: the dead node's last one
        # finishes before its stores are read back
        old.cs.wait_done(CRASH_JOIN_S)
        # a kill drops the victim's connections: each peer forgets what it
        # knew the victim held (its votes and block parts), as a TCP reset
        # does. The victim has no WAL, so a peer that kept that view would
        # never resend the height the victim lost and it would stay behind.
        for other in nodes:
            if other is not old:
                other.switch.disconnect(old.node_id)
        rebuilt = SimNode(index=old.index, node_id=old.node_id, doc=old.doc, pv=old.pv,
                          fabric=fabric, config=old.config, clock=old.clock,
                          state_db=old.state_db, block_store=old.block_store,
                          handshake=True, device=old.device)
        for other in nodes:
            if other is not old:
                rebuilt.switch.connect(other.node_id)
                other.switch.connect(rebuilt.node_id)
        nodes[VICTIM] = rebuilt
        _prep_node(rebuilt, m)
        spools[victim_id] = _make_spool(rebuilt, tmp, m)
        recovered = spools[victim_id].status()["recovered_bytes"]
        if recovered <= 0:
            failures.append(f"rebuilt spool recovered {recovered} bytes (torn tail not "
                            f"truncated)")
        rebuilt.start()
        reach(target, FINAL_TIMEOUT_S, "never reached the target height")
        return failures, nodes, spools, pre_crash
    finally:
        for n in nodes:
            n.stop()
        fabric.stop()
        # a clean shutdown: each surviving spool appends its final cumulative
        # snapshot; heights are frozen, so the spools' last sketches align
        # with the critpath rings read below
        for spool in spools.values():
            spool.stop()


def _check(nodes, spools, victim_path: str, pre_crash: dict, m: dict) -> tuple:
    """Checks 1-4 after the run: (failures, report, per-node snapshots)."""
    failures = []
    # 1. sketch against the exact offline percentiles, per node
    for n in nodes:
        _check_sketch_accuracy(n.node_id, n.cs.critpath.snapshot(), failures)

    # 2. crash safety: pre-crash snapshots intact, post-crash appended
    full = read_spool(victim_path)
    n_pre = len(pre_crash["snapshots"])
    if len(full["snapshots"]) <= n_pre:
        failures.append(f"victim spool has {len(full['snapshots'])} snapshots, {n_pre} "
                        f"pre-crash — nothing appended after rebuild")
    if full["snapshots"][:n_pre] != pre_crash["snapshots"]:
        failures.append("pre-crash snapshots changed across the rebuild")
    if full["corrupt_frames"]:
        failures.append(f"victim spool reports {full['corrupt_frames']} corrupt frames")
    seqs = [s["seq"] for s in full["snapshots"]]
    if sum(1 for a, b in zip(seqs, seqs[1:]) if b < a) != 1:
        failures.append(f"expected exactly one seq reset (the restart), got seqs={seqs}")

    # 3. the fleet report and merge exactness
    per_node = soak_report.load_spools(sorted(spools[n.node_id].path for n in nodes))
    report = soak_report.build_report(per_node, legs=4)
    soak_report.print_summary(report)
    if sorted(report["nodes"]) != sorted(n.node_id for n in nodes):
        failures.append(f"report fused nodes {report['nodes']}")
    empty_legs = [leg["leg"] for leg in report["legs"]
                  if not leg["metrics"].get("critpath/commit", {}).get("n")]
    if empty_legs:
        failures.append(f"legs {empty_legs} carry no commit samples")
    if not any("restart" in w for w in report["warnings"]):
        failures.append(f"report missed the victim's restart: {report['warnings']}")
    _check_fleet_merge(report, failures)

    # 4. eviction accounting and the telemetry exposition, strict lint
    for n in nodes:
        if n.cs.flight.evicted() <= 0:
            failures.append(f"{n.node_id}: flight ring never evicted despite capacity "
                            f"{m['flight_capacity']}")
        _check_exposition(n.node_id, n.metrics.registry.expose_text(), m, failures)
    return failures, report, per_node


def run(argv=None) -> dict:
    """The smoke; returns {"ok", "failures", "seconds", "heights",
    "launches", "parsed", "round", "marks"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's verify path) or cpu (the host)")
    ap.add_argument("--target-height", type=int, default=TARGET_HEIGHT,
                    help="the soak's depth; the marks scale with it (default %(default)s)")
    ap.add_argument("--round-dir", default=None,
                    help="write the next SOAK_rNN.json here (default: no round file)")
    args = ap.parse_args(argv)
    m = marks(args.target_height)
    t0 = time.perf_counter()
    out = {"marks": m}
    with SmokeVerify(args.device) as sv:
        tmp = tempfile.mkdtemp(prefix="soak-smoke-")
        try:
            failures, nodes, spools, pre_crash = _soak(sv.device, args.target_height, m, tmp)
            out["heights"] = min(n.height for n in nodes)
            if pre_crash is not None and not failures:
                more, report, per_node = _check(nodes, spools, spools[nodes[VICTIM].node_id].path,
                                                pre_crash, m)
                failures += more
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        failures += sv.card_failures()
        out["launches"] = sv.launches()
        print(f"[soak-smoke] verified {sv.summary()}", flush=True)
    if not failures:
        fleet = report["fleet"]["critpath/commit"]
        out["parsed"] = parsed = {
            "soak_commit_p99_seconds": round(fleet["p99_seconds"], 6),
            "soak_commit_p50_seconds": round(fleet["p50_seconds"], 6),
            "soak_commit_samples": fleet["n"],
            "soak_heights": max(n.height for n in nodes),
            "soak_snapshots": sum(len(snaps) for snaps in per_node.values()),
            "soak_legs": report["n_legs"],
            "soak_regressions": len(report["regressions"]),
        }
        if args.round_dir:
            out["round"] = write_round(args.round_dir, "SOAK", {"rc": 0, "parsed": parsed},
                                       "soak-smoke")
        print(f"[soak-smoke] fleet commit p99 = {parsed['soak_commit_p99_seconds']}s, p50 = "
              f"{parsed['soak_commit_p50_seconds']}s over {parsed['soak_commit_samples']} "
              f"commits, {parsed['soak_snapshots']} snapshots", flush=True)
    return finish("soak-smoke", out, failures, t0)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
