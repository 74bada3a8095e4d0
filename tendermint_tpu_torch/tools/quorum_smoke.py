"""Quorum observatory smoke: the port's counterpart of the reference's
``scripts/quorum_smoke.py`` (``make quorum-smoke``).

    python3 -m tendermint_tpu_torch.tools.quorum_smoke                 # the card
    python3 -m tendermint_tpu_torch.tools.quorum_smoke --device cpu [--round-dir DIR]

Drives the cross-node quorum observatory end to end, in one process, over
the real gossip stack: a 4-validator ``sim/node.build_sim_net`` mesh (real
ConsensusReactors over the seeded InProcSwitch fabric) with the live-vote
feed on (2 ms, 64 rows), validator 3 silenced at the fabric and a seeded
duplicate policy (``LinkPolicy(duplicate=0.25)``), so the gossip ledger has
waste to account:

  1. run consensus past a target height; every node's flight recorder
     stamps sign/first-send/arrival/contribution and each node's
     QuorumTrace cuts completion curves at each finalize;
  2. hold every live node to the dump_quorum contract (records present,
     limit/truncated consistent, no analyzer errors) and require every
     honest node's precommit curve to cross the strict 2/3 threshold with a
     pivotal validator named, never the silenced one;
  3. fuse all dumps with ``tools/quorum_report`` and require the silenced
     validator absent from every height's quorums, a finite waste ratio
     above 0, and every journey arrival reconciling exactly (integer ns)
     with the receiver's first-sighting record after commit-anchor skew
     correction;
  4. reconcile the receive seam: per node, first sightings + duplicates =
     the VoteMessages its reactor received (``PeerState.stats_votes``);
  5. require the vote feed to have dispatched, with flush records joined
     to committed heights, and lint every exposition with
     ``tools/metrics_lint``;
  6. merge the flight dumps with ``tools/trace_merge`` and strict-validate
     the result as Chrome trace, the signer -> receiver flow arrows
     included (paired s/f events, none dangling, none backward);
  7. with ``--round-dir``, write the next ``QUORUM_rNN.json`` there in the
     reference's format (``scripts/bench_check.py --prefix QUORUM --dir``
     reads it); without it no round file is written (the reference writes
     into its checkout, beside its CPU rounds).

On ``--device`` (default ``cuda``; ``tools/smoke_verify``): on the card the
vote feeds' flushes and every LastCommit check go to the root's guarded
verifier (K1 + K2), and the run must reach the card; ``cpu`` verifies on
the host (the feeds on the host RLC). Exit 0 means stamping, fusion, skew
correction, attribution, exposition and the merged flow view work end to
end on this machine.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

from tendermint_tpu_torch.config.config import test_config
from tendermint_tpu_torch.libs.critpath import percentile
from tendermint_tpu_torch.libs.metrics import get_vote_batch_metrics
from tendermint_tpu_torch.sim.node import build_sim_net
from tendermint_tpu_torch.sim.simnet import LinkPolicy
from tendermint_tpu_torch.testutil.consensus import wait_for
from tendermint_tpu_torch.testutil.consensus_net import validate_chrome_trace
from tendermint_tpu_torch.tools import quorum_report, trace_merge
from tendermint_tpu_torch.tools.metrics_lint import lint_text
from tendermint_tpu_torch.tools.smoke_verify import SmokeVerify, finish, write_round

N_VALS = 4
SILENCED = 3  # validator index == sim node index (sorted valset order)
TARGET_HEIGHT = 5
SEED = 21
# seeded fabric-level duplication, so re-gossip waste shows in the ledger
# without depending on HasVote race timing
DUP_POLICY = LinkPolicy(duplicate=0.25)
REACH_TIMEOUT_S = 90.0
SETTLE_TIMEOUT_S = 10.0


def _config():
    cfg = test_config()
    # the live-vote feed on: peer votes verify through VoteFeed and the
    # flush ledger feeds the batch attribution report
    cfg.verify.vote_batch_window_ms = 2.0
    cfg.verify.vote_batch_rows = 64
    return cfg


def _check_quorum_snapshot(snap: dict, node: str, failures: list) -> None:
    """The dump_quorum contract (as dump_flight's and dump_critpath's)."""
    recs = snap["records"]
    if snap["total_records"] < TARGET_HEIGHT - 1:
        failures.append(f"{node}: only {snap['total_records']} quorum records "
                        f"(need >= {TARGET_HEIGHT - 1})")
    if snap["truncated"]:
        failures.append(f"{node}: unlimited snapshot claims truncated")
    if len(recs) != snap["total_records"]:
        failures.append(f"{node}: {len(recs)} records shipped vs "
                        f"total_records={snap['total_records']}")
    if snap["analysis_errors"]:
        failures.append(f"{node}: {snap['analysis_errors']} analyzer errors")
    for rec in recs:
        h = rec["height"]
        two = rec["curves"].get("precommit", {}).get("crossings", {}).get("two_thirds")
        if two is None:
            failures.append(f"{node} h={h}: committed without a strict-2/3 precommit "
                            f"crossing in the curve")
            continue
        piv = rec["curves"]["precommit"]["pivotal_validator"]
        if piv is None or not (0 <= piv < N_VALS):
            failures.append(f"{node} h={h}: bogus pivotal validator {piv!r}")
        if two["seconds"] < 0:
            failures.append(f"{node} h={h}: negative time-to-quorum {two['seconds']}")


def _reconcile_journeys(report: dict, flights: list, failures: list) -> int:
    """Every journey arrival must equal the receiver's raw first-sighting
    stamp plus that receiver's anchor skew, in exact integer ns."""
    by_node = {d.get("node_id"): d for d in flights}
    skews = report["skews_ns"]
    checked = 0
    for j in report["journeys"]:
        where = f"journey h={j['height']} {j['kind']} v{j['validator_index']}"
        for node, arr in j["arrivals"].items():
            rec = next((r for r in (by_node.get(node) or {}).get("records", [])
                        if r.get("height") == j["height"]), None)
            if rec is None:
                failures.append(f"{where}: receiver {node} has no flight record for the height")
                continue
            arrivals = (rec.get(j["kind"]) or {}).get("arrivals") or {}
            mark = arrivals.get(j["validator_index"])
            if mark is None:  # JSON round-tripped dumps carry str keys
                mark = arrivals.get(str(j["validator_index"]))
            if mark is None:
                failures.append(f"{where}: no first-sighting record on {node}")
                continue
            want = int(mark["t"]) + int(skews.get(node, 0))
            if int(arr["t_ns"]) != want:
                failures.append(f"{where} -> {node}: corrected arrival {arr['t_ns']} != "
                                f"receiver record {want}")
            checked += 1
    return checked


def _check_flow_events(merged: dict, failures: list) -> None:
    """The merged trace must carry signer -> receiver vote flow arrows."""
    flows = [ev for ev in merged["traceEvents"]
             if ev.get("cat") == "flow" and ev.get("ph") in ("s", "f")]
    if not flows:
        failures.append("merged trace has no vote flow events")
        return
    starts = {ev["id"] for ev in flows if ev["ph"] == "s"}
    ends = {ev["id"] for ev in flows if ev["ph"] == "f"}
    if starts != ends:
        failures.append(f"flow ids unpaired: {len(starts ^ ends)} dangling")


def _collect(device) -> tuple:
    """Run the net; everything read once the fabric stops and before the
    nodes stop (a peer's teardown runs forget_peer, which prunes the
    per-peer counter series)."""
    fabric, nodes = build_sim_net(N_VALS, seed=SEED, config=_config(), device=device)
    silenced_id = nodes[SILENCED].node_id
    honest = [n for n in nodes if n.node_id != silenced_id]
    fabric.set_policy(None, None, DUP_POLICY)
    fabric.silence({silenced_id})
    try:
        fabric.start()
        for n in nodes:
            n.start()
        print(f"[quorum-smoke] running {N_VALS}-node net ({silenced_id} silenced) to height "
              f"{TARGET_HEIGHT}...", flush=True)
        # past the target height with a quorum record for each of the
        # heights the checks need: a node still at NEW_HEIGHT that gets a
        # height's complete proposal goes straight to prevote (the
        # reference's state machine, kept), stamps no round and so makes
        # no record for that height; under a loaded host the net runs on
        # until each honest node has its records
        def ready():
            return all(n.height > TARGET_HEIGHT and len(n.cs.quorumtrace) >= TARGET_HEIGHT - 1
                       for n in honest)

        if not wait_for(ready, REACH_TIMEOUT_S, 0.05):
            return None, [f"net never reached height {TARGET_HEIGHT + 1} with "
                          f"{TARGET_HEIGHT - 1} quorum records a node: heights="
                          f"{[n.height for n in nodes]}, records="
                          f"{[len(n.cs.quorumtrace) for n in nodes]}"]
        # the receive seam counts a vote's sighting, then its PeerState
        # count: read them only once the fabric delivers nothing more and
        # the switches' inboxes have drained (two equal reads 0.2 s apart)
        fabric.stop()

        def seam():
            return ({n.node_id: sum(ps.stats_votes for o in nodes if o is not n
                                    and (ps := n.reactor.peer_state(o.node_id)) is not None)
                     for n in nodes},
                    {n.node_id: (sum(n.metrics.vote_first_sighting._values.values()),
                                 sum(n.metrics.duplicate_votes._values.values()))
                     for n in nodes})

        counts, deadline = seam(), time.monotonic() + SETTLE_TIMEOUT_S
        while time.monotonic() < deadline:
            time.sleep(0.2)
            counts, prev = seam(), counts
            if counts == prev:
                break
        seen = {
            "nodes": [n.node_id for n in nodes],
            "silenced": silenced_id,
            "heights": min(n.height for n in honest) - 1,
            "flights": [n.cs.flight.snapshot() for n in nodes],
            "quorums": [n.cs.quorumtrace.snapshot() for n in nodes],
            "limited": nodes[0].cs.quorumtrace.snapshot(limit=2),
            "votes_received": counts[0],
            "sightings": counts[1],
            "feed_dispatches": {n.node_id: 0 if n.vote_feed is None else n.vote_feed.dispatches
                                for n in nodes},
            "expositions": {n.node_id: n.metrics.registry.expose_text() for n in nodes},
        }
        return seen, []
    finally:
        for n in nodes:
            n.stop()
        fabric.stop()


def _check(seen: dict) -> tuple:
    """Steps 1-6 on what ``_collect`` read: (failures, parsed round)."""
    failures = []
    silenced_id = seen["silenced"]
    flights, quorums = seen["flights"], seen["quorums"]
    # 1. the dump_quorum contract and the curves. The silenced node never
    # commits (peers gossip nothing to a peer whose round state they never
    # hear), so it has no records and, never having analyzed a height, an
    # empty node_id.
    for node_id, snap in zip(seen["nodes"], quorums):
        if node_id == silenced_id:
            if snap["analysis_errors"]:
                failures.append(f"{silenced_id}: {snap['analysis_errors']} analyzer errors")
            continue
        _check_quorum_snapshot(snap, snap["node_id"] or node_id, failures)
    limited = seen["limited"]
    if len(limited["records"]) != 2 or not limited["truncated"]:
        failures.append(f"limit=2 snapshot broke the truncation contract: "
                        f"{len(limited['records'])} records, truncated={limited['truncated']}")

    # 2. the cross-node fusion
    report = quorum_report.build_report(flights, quorums, n_validators=N_VALS)
    quorum_report.print_summary(report)
    if not report["heights"]:
        return failures + ["report fused zero heights"], None
    # the silenced validator is absent from every quorum: no honest node
    # saw its votes, and it finalizes no height itself
    for h, entry in report["heights"].items():
        for node, per_kind in entry["per_node"].items():
            if node == silenced_id:
                continue
            for kind, info in per_kind.items():
                if SILENCED in info["present"]:
                    failures.append(f"h={h} {node} {kind}: silenced validator {SILENCED} "
                                    f"present in the quorum")
                if info["pivotal_validator"] == SILENCED:
                    failures.append(f"h={h} {node} {kind}: silenced validator {SILENCED} "
                                    f"named pivotal")
    absent = quorum_report.absent_everywhere(report)
    if SILENCED not in absent:
        failures.append(f"silenced validator {SILENCED} not in absent_everywhere {absent}")
    for j in report["journeys"]:
        if j["validator_index"] == SILENCED and j["arrivals"]:
            failures.append(f"silenced validator's {j['kind']} h={j['height']} arrived at "
                            f"{sorted(j['arrivals'])}")

    # 3. the gossip-efficiency ledger: waste real and finite
    gossip = report["gossip"]
    if not (0.0 < gossip["waste_ratio"] < math.inf):
        failures.append(f"waste ratio {gossip['waste_ratio']} not finite-positive "
                        f"(first={gossip['first_sightings']} dup={gossip['duplicates']})")
    if not any(link["latency_samples"] > 0 and link["latency_p99_s"] >= 0.0
               for link in gossip["links"]):
        failures.append("no link carried a propagation-latency sample")

    # 4. exact journey <-> receiver-record reconciliation
    n_checked = _reconcile_journeys(report, flights, failures)
    if n_checked == 0:
        failures.append("no journey arrivals to reconcile")
    print(f"[quorum-smoke] {n_checked} journey arrivals reconcile exactly", flush=True)

    # 5. the receive seam: first + dup == votes received
    for node_id, total in seen["votes_received"].items():
        first, dup = seen["sightings"][node_id]
        if int(first + dup) != int(total):
            failures.append(f"{node_id}: first({int(first)}) + dup({int(dup)}) != "
                            f"votes received ({total})")
    if not any(d for _, d in seen["sightings"].values()):
        failures.append("duplicate counter never incremented on any node")

    # 6. the feed dispatched, with flush attribution in the records
    if not any(n for node_id, n in seen["feed_dispatches"].items() if node_id != silenced_id):
        failures.append(f"vote feed never dispatched: {seen['feed_dispatches']}")
    if not any(rec["flushes"] for snap in quorums if snap["node_id"] != silenced_id
               for rec in snap["records"]):
        failures.append("no quorum record carries VoteFeed flush records")

    # 7. the expositions: the families present and strictly lintable
    for node_id, text in seen["expositions"].items():
        for name in ("tendermint_consensus_quorum_time_to_third_seconds",
                     "tendermint_consensus_quorum_time_to_two_thirds_seconds",
                     "tendermint_p2p_vote_first_sighting_total",
                     "tendermint_p2p_duplicate_votes_total"):
            if f"# TYPE {name} " not in text:
                failures.append(f"{node_id}: exposition missing {name}")
        failures.extend(f"{node_id} metrics_lint: {e}" for e in lint_text(text))
    vb_text = get_vote_batch_metrics().registry.expose_text()
    if "tendermint_consensus_vote_batch_wait_seconds" not in vb_text:
        failures.append("vote-batch exposition missing "
                        "tendermint_consensus_vote_batch_wait_seconds")
    failures.extend(f"vote-batch metrics_lint: {e}" for e in lint_text(vb_text))

    # 8. the merged Chrome trace with flow arrows; the silenced node's
    # track has no commit anchors, so the commit floor applies to the
    # honest merge
    print("[quorum-smoke] merging flight dumps with flow arrows...", flush=True)
    honest_flights = [d for d in flights if d.get("node_id") != silenced_id]
    merged = trace_merge.merge(honest_flights, skews=trace_merge.compute_skews(honest_flights))
    failures.extend(validate_chrome_trace(merged, len(honest_flights),
                                          min_commits_per_node=TARGET_HEIGHT - 1))
    _check_flow_events(merged, failures)

    # the round: the pooled honest-node time-to-2/3 tail
    twos = [curve["crossings"]["two_thirds"]["seconds"]
            for snap in quorums if snap["node_id"] != silenced_id
            for rec in snap["records"] for curve in rec["curves"].values()
            if curve["crossings"]["two_thirds"] is not None]
    parsed = {
        "quorum_time_to_two_thirds_p99_seconds": round(percentile(twos, 99), 6),
        "quorum_time_to_two_thirds_p50_seconds": round(percentile(twos, 50), 6),
        "quorum_waste_ratio": round(gossip["waste_ratio"], 6),
        "quorum_heights": len(report["heights"]),
        "quorum_journeys": len(report["journeys"]),
    }
    return failures, parsed


def run(argv=None) -> dict:
    """The smoke; returns {"ok", "failures", "seconds", "heights",
    "launches", "parsed", "round"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's verify path) or cpu (the host)")
    ap.add_argument("--round-dir", default=None,
                    help="write the next QUORUM_rNN.json here (default: no round file)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = {}
    with SmokeVerify(args.device) as sv:
        seen, failures = _collect(sv.device)
        if seen is not None:
            out["heights"] = seen["heights"]
            more, out["parsed"] = _check(seen)
            failures += more
        failures += sv.card_failures()
        out["launches"] = sv.launches()
        print(f"[quorum-smoke] verified {sv.summary()}", flush=True)
    if not failures and args.round_dir:
        out["round"] = write_round(args.round_dir, "QUORUM", {"rc": 0, "parsed": out["parsed"]},
                                   "quorum-smoke")
    if not failures:
        print(f"[quorum-smoke] p99 time-to-2/3 = "
              f"{out['parsed']['quorum_time_to_two_thirds_p99_seconds']}s, "
              f"waste = {out['parsed']['quorum_waste_ratio']}", flush=True)
    return finish("quorum-smoke", out, failures, t0)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
