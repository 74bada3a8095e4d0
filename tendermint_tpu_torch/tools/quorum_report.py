"""Cross-node quorum observatory report: the port's copy of the
reference's ``scripts/quorum_report.py``.

Takes per-node flight snapshots (``cs.flight.snapshot()``) and quorum
snapshots (``cs.quorumtrace.snapshot()``) and fuses every node's
vote-journey stamps into the three reports the commit-latency tail
analysis needs:

  1. **Quorum completion curves** — per height and vote kind, on each
     node, the time for arriving voting power to cross 1/3, 1/2 and
     (strictly) 2/3 of the valset total, with the pivotal validator (the
     one whose vote crossed 2/3) named; plus the cross-node consensus on
     who was pivotal and which validators were absent from every quorum.
  2. **Gossip-efficiency ledger** — per (peer -> receiver) link: first
     sightings vs duplicate votes (amplification waste ratio) and
     median/p99 sign-to-arrival propagation latency.
  3. **Batch-flush attribution** — the VoteFeed flush records covering
     each height (flush reason, window span, ticket queue waits), so
     batching-added latency separates from network latency.

Clock skew is corrected with the commit-anchor median math of
``tools/trace_merge.py`` (shared (height, commit-hash) anchors, first node
as reference); per-validator journeys come from ``libs/quorumtrace.py``.

The port has no RPC server yet, so the CLI reads the snapshots from JSON
files, one flight and one quorum snapshot a node, in the same order:

    python -m tendermint_tpu_torch.tools.quorum_report \
        --flight node0_flight.json,node1_flight.json \
        [--quorum node0_quorum.json,node1_quorum.json] [-o quorum_report.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from tendermint_tpu_torch.libs import quorumtrace
from tendermint_tpu_torch.tools import trace_merge


def _skew_map(flight_dumps: Sequence[dict], skews: Sequence[int]) -> dict:
    return {
        (d.get("node_id") or f"node{i}"): skews[i]
        for i, d in enumerate(flight_dumps)
    }


def build_report(
    flight_dumps: Sequence[dict],
    quorum_dumps: Optional[Sequence[dict]] = None,
    n_validators: Optional[int] = None,
) -> dict:
    """Fuse per-node dump_flight (and optional index-aligned dump_quorum)
    payloads into the quorum observatory report dict.

    ``n_validators`` bounds the absent-validator sweep; when omitted it is
    inferred as max(seen validator index)+1 — which cannot see a validator
    that NEVER voted anywhere, so callers that know the valset size should
    pass it.
    """
    flight_dumps = list(flight_dumps)
    quorum_dumps = list(quorum_dumps or [])
    skews = trace_merge.compute_skews(flight_dumps)
    skew_map = _skew_map(flight_dumps, skews)
    journeys = quorumtrace.build_journeys(flight_dumps, skew_map)
    gossip = quorumtrace.gossip_ledger(flight_dumps, skew_map, journeys)

    if n_validators is None:
        seen = [j["validator_index"] for j in journeys]
        for qd in quorum_dumps:
            for rec in qd.get("records") or []:
                for curve in (rec.get("curves") or {}).values():
                    seen.extend(curve.get("present") or [])
        n_validators = (max(seen) + 1) if seen else 0

    # per-height fusion of the live analyzers' curves
    heights: Dict[int, dict] = {}
    for qd in quorum_dumps:
        node = qd.get("node_id", "")
        skew = int(skew_map.get(node, 0))
        for rec in qd.get("records") or []:
            h = rec.get("height")
            entry = heights.setdefault(h, {"per_node": {}, "flushes": {}})
            per_kind = {}
            for kind, curve in (rec.get("curves") or {}).items():
                two = (curve.get("crossings") or {}).get("two_thirds")
                per_kind[kind] = {
                    "two_thirds_seconds": (
                        two["seconds"] if two else None
                    ),
                    "two_thirds_t_ns": (
                        int(two["t_ns"]) + skew if two else None
                    ),
                    "pivotal_validator": curve.get("pivotal_validator"),
                    "present": sorted(
                        int(v) for v in curve.get("present") or []
                    ),
                }
            entry["per_node"][node] = per_kind
            if rec.get("flushes"):
                entry["flushes"][node] = rec["flushes"]

    for h, entry in heights.items():
        present_union: set = set()
        pivotal_votes: Dict[str, Dict[int, int]] = {}
        for per_kind in entry["per_node"].values():
            for kind, info in per_kind.items():
                present_union.update(info["present"])
                pv = info["pivotal_validator"]
                if pv is not None:
                    tally = pivotal_votes.setdefault(kind, {})
                    tally[pv] = tally.get(pv, 0) + 1
        entry["absent_validators"] = sorted(
            set(range(n_validators)) - present_union
        )
        # cross-node majority on who was pivotal, per kind (ties break
        # toward the lower index for determinism)
        entry["pivotal"] = {
            kind: min(
                (vi for vi, n in tally.items()
                 if n == max(tally.values()))
            )
            for kind, tally in pivotal_votes.items()
        }

    return {
        "nodes": [
            d.get("node_id") or f"node{i}"
            for i, d in enumerate(flight_dumps)
        ],
        "n_validators": n_validators,
        "skews_ns": {n: skew_map[n] for n in sorted(skew_map)},
        "alignment_warnings": trace_merge.alignment_warnings(flight_dumps),
        "journeys": journeys,
        "gossip": gossip,
        "heights": {str(h): heights[h] for h in sorted(heights)},
        "quorum_stats": {
            qd.get("node_id", f"node{i}"): qd.get("quorum_stats") or {}
            for i, qd in enumerate(quorum_dumps)
        },
    }


def absent_everywhere(report: dict) -> List[int]:
    """Validator indices absent from EVERY height's quorums — the
    silenced-validator check the smoke gates on."""
    heights = report.get("heights") or {}
    if not heights:
        return []
    sets = [set(e.get("absent_validators") or []) for e in heights.values()]
    out = set.intersection(*sets) if sets else set()
    return sorted(out)


def print_summary(report: dict, out=sys.stdout) -> None:
    g = report["gossip"]
    print(
        f"[quorum] nodes={len(report['nodes'])} "
        f"journeys={len(report['journeys'])} "
        f"first_sightings={g['first_sightings']} "
        f"duplicates={g['duplicates']} "
        f"waste_ratio={g['waste_ratio']:.3f}",
        file=out,
    )
    for warn in report["alignment_warnings"]:
        print(f"[quorum] WARNING: {warn}", file=out)
    for h, entry in report["heights"].items():
        twos = [
            info["two_thirds_seconds"]
            for per_kind in entry["per_node"].values()
            for info in per_kind.values()
            if info["two_thirds_seconds"] is not None
        ]
        worst = max(twos) if twos else None
        print(
            f"[quorum] h={h} pivotal={entry.get('pivotal')} "
            f"absent={entry.get('absent_validators')} "
            f"worst_two_thirds_s="
            f"{worst if worst is None else round(worst, 4)}",
            file=out,
        )


# --- CLI -------------------------------------------------------------------


def _load(paths: str) -> List[dict]:
    out = []
    for path in (p.strip() for p in paths.split(",")):
        if path:
            with open(path) as f:
                out.append(json.load(f))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--flight", required=True,
                    help="comma-separated flight snapshot JSON files")
    ap.add_argument("--quorum", default="",
                    help="comma-separated quorum snapshot JSON files, "
                         "in the same node order")
    ap.add_argument("--n-validators", type=int, default=None,
                    help="valset size for the absent-validator sweep "
                         "(default: inferred from seen indices)")
    ap.add_argument("-o", "--output", default="quorum_report.json")
    args = ap.parse_args(argv)

    flights = _load(args.flight)
    if not flights:
        print("no flight snapshots", file=sys.stderr)
        return 2
    report = build_report(flights, _load(args.quorum),
                          n_validators=args.n_validators)
    with open(args.output, "w") as f:
        json.dump(report, f)
    print_summary(report)
    print(f"[quorum] report -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
