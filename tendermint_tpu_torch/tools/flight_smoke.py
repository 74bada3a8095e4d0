"""Flight-recorder smoke: the port's counterpart of the reference's
``scripts/flight_smoke.py`` (``make flight-smoke``).

    python3 -m tendermint_tpu_torch.tools.flight_smoke                 # the card
    python3 -m tendermint_tpu_torch.tools.flight_smoke --device cpu [--trace-out FILE]

Drives the observability path end to end, in one process:

  1. build a 4-validator in-process consensus net
     (``testutil/consensus_net.Net``: real ConsensusStates over an
     event-bus gossip pump, each node's flight recorder on) and run it to
     a target height;
  2. silence 2 of the 4 validators (>1/3 of voting power) and require the
     liveness watchdog (``libs/watchdog.LivenessWatchdog``) to report the
     stall, naming the missing validators' power, and to count
     tendermint_consensus_stalls_total, within ``STALL_BUDGET_S``;
  3. dump all four recorders, fuse them with ``tools/trace_merge`` (commit
     anchors -> per-node skew correction) and strict-validate the merged
     output as Chrome trace-event JSON (``consensus_net.validate_chrome_trace``);
  4. lint the watchdog metrics exposition with ``tools/metrics_lint``.

On ``--device`` (default ``cuda``; ``tools/smoke_verify``): on the card
every block's LastCommit check goes to the root's guarded verifier (K1 +
K2), and the run must reach the card; ``cpu`` verifies on the host. The
merged trace is written only where ``--trace-out`` says (the reference
writes ``merged_trace.json`` into its checkout). Exit 0 means stamps,
stall detection, merging and validation work end to end on this machine.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.libs.watchdog import LivenessWatchdog
from tendermint_tpu_torch.testutil.consensus import wait_for
from tendermint_tpu_torch.testutil.consensus_net import Net, validate_chrome_trace
from tendermint_tpu_torch.tools import trace_merge
from tendermint_tpu_torch.tools.metrics_lint import lint_text
from tendermint_tpu_torch.tools.smoke_verify import SmokeVerify, finish

N_VALS = 4
TARGET_HEIGHT = 5
STALL_BUDGET_S = 6.0
REACH_TIMEOUT_S = 60.0
MAX_ANCHOR_SPREAD_S = 0.25


def reach(net: Net, height: int, timeout: float = REACH_TIMEOUT_S) -> list:
    """Run ``net`` until every node has passed ``height``; the failures."""
    print(f"running the {len(net.nodes)}-node net to height {height} ...", flush=True)
    if wait_for(lambda: all(cs.rs.height > height for cs, _, _ in net.nodes), timeout):
        return []
    return [f"net never reached height {height + 1}: "
            f"heights={[cs.rs.height for cs, _, _ in net.nodes]}"]


def _drive(net: Net, trace_out) -> tuple:
    """The stall, the merge and the lint on a started net: (failures, facts)."""
    metrics = NodeMetrics()
    failures = reach(net, TARGET_HEIGHT)
    if failures:
        return failures, {}
    heights = [cs.rs.height for cs, _, _ in net.nodes]
    # the watchdog starts after the warm-up, so the first heights' costs do
    # not read as a stall
    watchdog = LivenessWatchdog(net.nodes[0][0], metrics=metrics, interval=0.2,
                                stall_factor=3.0, min_stall_seconds=1.5)
    watchdog.start()
    try:
        time.sleep(1.0)  # a few healthy samples to seed the interval EWMA
        print(f"[flight-smoke] heights={heights}; silencing validators 2 and 3 (>1/3 power)",
              flush=True)
        net.silenced.update({2, 3})
        t0 = time.monotonic()
        stall_s = None
        if not wait_for(lambda: watchdog.report() is not None, STALL_BUDGET_S):
            failures.append(f"watchdog reported no stall within {STALL_BUDGET_S}s")
        else:
            stall_s = time.monotonic() - t0
            report = watchdog.report()
            print(f"[flight-smoke] stall detected after {stall_s:.1f}s at "
                  f"h={report['height']} r={report['round']} step={report['step']}", flush=True)
            missing = report["missing_precommits"]
            if missing["total_power"] <= 0:
                failures.append("stall report has no total power")
            elif missing["power"] * 3 < missing["total_power"]:
                failures.append(f"stall report names only {missing['power']}/"
                                f"{missing['total_power']} missing power (< 1/3)")
            if not {v["index"] for v in missing["validators"]}:
                failures.append("stall report names no missing validators")
        text = metrics.registry.expose_text()
        if "tendermint_consensus_stalls_total 1" not in text:
            failures.append("tendermint_consensus_stalls_total != 1 in exposition")
        failures.extend(f"metrics_lint: {e}" for e in lint_text(text))
    finally:
        watchdog.stop()

    print("[flight-smoke] dumping + merging flight records...", flush=True)
    dumps = [cs.flight.snapshot() for cs, _, _ in net.nodes]
    for d in dumps:
        if not d["records"]:
            failures.append(f"{d['node_id']}: no flight records")
    skews = trace_merge.compute_skews(dumps)
    merged = trace_merge.merge(dumps, skews=skews)
    failures.extend(validate_chrome_trace(merged, N_VALS, min_commits_per_node=TARGET_HEIGHT - 1))
    spread = trace_merge.anchor_spread(dumps, skews)
    if len(spread) < TARGET_HEIGHT - 1:
        failures.append(f"only {len(spread)} shared commit heights across nodes")
    worst = max(spread.values()) if spread else 0.0
    if worst > MAX_ANCHOR_SPREAD_S:
        failures.append(f"anchor spread {worst:.3f}s after skew correction "
                        f"(> {MAX_ANCHOR_SPREAD_S}s)")
    if trace_out:
        with open(trace_out, "w") as f:
            json.dump(merged, f)
    print(f"[flight-smoke] merged {len(merged['traceEvents'])} events"
          f"{f' -> {trace_out}' if trace_out else ''}; skews_ns={skews} "
          f"worst_anchor_spread_s={worst:.4f}", flush=True)
    return failures, {"heights": min(heights), "stall_s": stall_s,
                      "events": len(merged["traceEvents"])}


def run(argv=None) -> dict:
    """The smoke; returns {"ok", "failures", "seconds", "heights",
    "launches", "stall_s", "events"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's verify path) or cpu (the host)")
    ap.add_argument("--trace-out", default=None,
                    help="write the merged Chrome trace here (default: not written)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = {}
    with SmokeVerify(args.device) as sv:
        net = Net(N_VALS)
        try:
            net.start()
            failures, facts = _drive(net, args.trace_out)
        finally:
            net.stop()
        failures += sv.card_failures()
        out.update(facts, launches=sv.launches())
        print(f"[flight-smoke] verified {sv.summary()}", flush=True)
    return finish("flight-smoke", out, failures, t0)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
