"""Critical-path analyzer smoke: the port's counterpart of the reference's
``scripts/critpath_smoke.py`` (``make critpath-smoke``).

    python3 -m tendermint_tpu_torch.tools.critpath_smoke               # the card
    python3 -m tendermint_tpu_torch.tools.critpath_smoke --device cpu

Drives the commit-latency waterfall end to end, in one process, on the
flight smoke's 4-validator net (``testutil/consensus_net.Net``):

  1. run consensus past a target height with every node's flight recorder
     on: the critical-path analyzer (``libs/critpath.py``) builds one
     waterfall per committed height; node 0 runs a real file WAL
     (``consensus/wal.WAL`` in a temporary directory), so the
     height-tagged append/fsync join is exercised, not just the NilWAL's
     zero path;
  2. hold every node to the dump_critpath contract: records present,
     limit/truncated consistent, and each waterfall's timeline phase sum
     plus its residual reconciling with the height's wall time to
     ``RECONCILE_TOL_S``;
  3. lint the ``tendermint_consensus_height_phase_seconds`` exposition with
     ``tools/metrics_lint`` and require every phase label;
  4. merge the flight dumps with ``tools/trace_merge`` and strict-validate
     the result as Chrome trace, the nested waterfall slices included
     (every phase slice inside its parent ``waterfall h`` slice).

On ``--device`` (default ``cuda``; ``tools/smoke_verify``): on the card
every block's LastCommit check goes to the root's guarded verifier (K1 +
K2), and the run must reach the card; ``cpu`` verifies on the host. Exit 0
means stamping, reconciliation, exposition and the merged waterfall view
work end to end on this machine.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

from tendermint_tpu_torch.consensus.wal import WAL
from tendermint_tpu_torch.libs.critpath import PHASES, TIMELINE_PHASES
from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.testutil.consensus_net import Net, validate_chrome_trace
from tendermint_tpu_torch.tools import trace_merge
from tendermint_tpu_torch.tools.flight_smoke import N_VALS, reach
from tendermint_tpu_torch.tools.metrics_lint import lint_text
from tendermint_tpu_torch.tools.smoke_verify import SmokeVerify, finish

TARGET_HEIGHT = 4
# wall-vs-phase reconciliation tolerance: the identity is exact in ns
# arithmetic, float64 seconds round-trips leave sub-microsecond dust
RECONCILE_TOL_S = 1e-6


def check_snapshot(snap: dict, node: str, failures: list) -> None:
    """The dump_critpath contract and the reconciliation identity."""
    recs = snap["records"]
    if snap["total_records"] < TARGET_HEIGHT - 1:
        failures.append(f"{node}: only {snap['total_records']} waterfalls "
                        f"(need >= {TARGET_HEIGHT - 1})")
    if snap["truncated"]:
        failures.append(f"{node}: unlimited snapshot claims truncated")
    if len(recs) != snap["total_records"]:
        failures.append(f"{node}: {len(recs)} records shipped vs "
                        f"total_records={snap['total_records']}")
    if snap["analysis_errors"]:
        failures.append(f"{node}: {snap['analysis_errors']} analyzer errors")
    for wf in recs:
        h = wf["height"]
        for phase in PHASES:
            if wf["phases"][phase] < 0:
                failures.append(f"{node} h={h}: negative phase {phase} {wf['phases'][phase]}")
        timeline = sum(wf["phases"][p] for p in TIMELINE_PHASES)
        resid = wf["wall_seconds"] - (timeline + wf["other_seconds"])
        if abs(resid) > RECONCILE_TOL_S:
            failures.append(f"{node} h={h}: phase sum {timeline + wf['other_seconds']:.9f} != "
                            f"wall {wf['wall_seconds']:.9f} (resid {resid:.3e})")
        if wf["other_seconds"] < -RECONCILE_TOL_S:
            failures.append(f"{node} h={h}: negative residual {wf['other_seconds']:.3e} — "
                            f"overlapping timeline phases")
        if not (0.0 <= wf["commit_seconds"] <= wf["wall_seconds"] + 1e-9):
            failures.append(f"{node} h={h}: commit_seconds {wf['commit_seconds']} outside "
                            f"[0, wall={wf['wall_seconds']}]")
        if wf["critical_path"] not in PHASES:
            failures.append(f"{node} h={h}: bogus critical_path {wf['critical_path']!r}")


def check_waterfall_slices(merged: dict, failures: list) -> None:
    """Every critpath phase slice sits inside its node's parent
    ``waterfall h`` slice (Chrome nests by ts/dur containment on one
    pid/tid)."""
    parents = {}  # (pid, height) -> (ts, ts + dur)
    children = []
    for ev in merged["traceEvents"]:
        if ev.get("cat") != "critpath":
            continue
        if ev["name"].startswith("waterfall "):
            parents[(ev["pid"], ev["args"]["height"])] = (ev["ts"], ev["ts"] + ev["dur"])
        else:
            children.append(ev)
    if not parents:
        failures.append("merged trace has no waterfall parent slices")
    for ev in children:
        where = f"phase slice {ev['name']} (pid {ev['pid']} h={ev['args']['height']})"
        span = parents.get((ev["pid"], ev["args"]["height"]))
        if span is None:
            failures.append(f"{where} has no parent waterfall")
            continue
        t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
        if t0 < span[0] - 1e-6 or t1 > span[1] + 1e-6:
            failures.append(f"{where} [{t0}, {t1}] escapes parent [{span[0]}, {span[1]}]")


def _drive(net: Net, metrics: NodeMetrics) -> tuple:
    failures = reach(net, TARGET_HEIGHT)
    if failures:
        return failures, {}
    snaps = [cs.critpath.snapshot() for cs, _, _ in net.nodes]
    for snap in snaps:
        check_snapshot(snap, snap["node_id"] or "?", failures)
    print(f"[critpath-smoke] {sum(s['total_records'] for s in snaps)} waterfalls across "
          f"{N_VALS} nodes reconcile", flush=True)
    # the limit/truncated contract, as dump_flight's
    limited = net.nodes[0][0].critpath.snapshot(limit=2)
    if len(limited["records"]) != 2 or not limited["truncated"]:
        failures.append(f"limit=2 snapshot broke the truncation contract: "
                        f"{len(limited['records'])} records, truncated={limited['truncated']}")
    # node 0's real WAL must have produced height-tagged costs
    if not any(wf["phases"]["wal_fsync"] > 0 or wf["wal_fsyncs"] > 0
               for wf in snaps[0]["records"]):
        failures.append("node0 runs a real WAL but no waterfall carries fsync cost")
    text = metrics.registry.expose_text()
    for phase in PHASES:
        if f'phase="{phase}"' not in text:
            failures.append(f'exposition missing series phase="{phase}"')
    failures.extend(f"metrics_lint: {e}" for e in lint_text(text))

    print("[critpath-smoke] merging flight dumps with waterfalls...", flush=True)
    dumps = [cs.flight.snapshot() for cs, _, _ in net.nodes]
    merged = trace_merge.merge(dumps, skews=trace_merge.compute_skews(dumps))
    failures.extend(validate_chrome_trace(merged, N_VALS, min_commits_per_node=TARGET_HEIGHT - 1))
    check_waterfall_slices(merged, failures)
    return failures, {"heights": min(cs.rs.height for cs, _, _ in net.nodes) - 1,
                      "waterfalls": sum(s["total_records"] for s in snaps)}


def run(argv=None) -> dict:
    """The smoke; returns {"ok", "failures", "seconds", "heights",
    "launches", "waterfalls"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's verify path) or cpu (the host)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = {}
    with SmokeVerify(args.device) as sv:
        wal_dir = tempfile.mkdtemp(prefix="critpath_smoke_wal_")
        try:
            # node 0 on a real file WAL (the state machine's start owns
            # wal.start and the empty file's catch-up replay)
            net = Net(N_VALS, wal_factory=lambda i: WAL(os.path.join(wal_dir, "wal"))
                      if i == 0 else None)
            metrics = NodeMetrics()
            for cs, _, _ in net.nodes:
                cs.critpath.metrics = metrics  # one registry for the exposition check
            try:
                net.start()
                failures, facts = _drive(net, metrics)
            finally:
                net.stop()
        finally:
            shutil.rmtree(wal_dir, ignore_errors=True)
        failures += sv.card_failures()
        out.update(facts, launches=sv.launches())
        print(f"[critpath-smoke] verified {sv.summary()}", flush=True)
    return finish("critpath-smoke", out, failures, t0)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
