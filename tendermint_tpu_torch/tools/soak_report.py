"""Fleet-wide soak report: the port's copy of the reference's
``scripts/soak_report.py``.

Reads many nodes' telemetry spools — on-disk segment groups written by
``libs/telemetry.TelemetrySpool`` (``--spools``) or live ``dump_telemetry``
rings (``--endpoints``) — and fuses them into the soak scoreboard:

  1. **Fleet merge** — every node's whole-run quantile sketches pooled by
     bucket-wise addition (``libs/sketch.py``'s fixed-gamma guarantee: the
     merge is EXACT and order-independent), giving run-wide p50/p99 for
     commit latency, each waterfall phase, and time-to-1/3 / 2/3.
  2. **Legs** — the run split into height legs; each leg's distribution
     is the bucket-wise DELTA of consecutive cumulative snapshots (exact
     for fixed-gamma sketches), merged fleet-wide, rendered as per-leg
     p50/p99 trend tables with leg-over-leg regression flags.
  3. **Loss flags** — legs during which any bounded store (flight ring,
     profile ledger, critpath/quorum rings) evicted records, or the
     spool dropped/failed writes, are marked lossy: their tails may be
     understated.

A node crash/restart shows up as a snapshot whose cumulative sketches
shrank; the delta walk detects the reset and counts the restarted
incarnation from zero, so pre-crash legs keep their data.

Usage:
    python -m tendermint_tpu_torch.tools.soak_report --spools n0/spool,n1/spool \
        [--legs 4] [--threshold 0.25] [-o soak_report.json]
    python -m tendermint_tpu_torch.tools.soak_report --endpoints tcp://h1:26657,... [...]

``--device`` (default ``cuda``) is the smokes' common command line: the
report is built on the host either way, and without a card the command
exits non-zero naming ``NoCudaDeviceError`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.libs.sketch import QuantileSketch
from tendermint_tpu_torch.libs.telemetry import EVICTION_STORES, read_spool

DEFAULT_LEGS = 4
DEFAULT_THRESHOLD = 0.25  # leg-over-leg p99 rise flagged beyond this

# sketch families pulled out of each snapshot's "sketches" section;
# (section, inner-key) -> flat metric name
_CRIT_PREFIX = "critpath"
_QUORUM_PREFIX = "quorum"


def _flatten_sketches(snap: dict) -> Dict[str, dict]:
    """snapshot -> {"critpath/commit": sketch-dict, "quorum/...": ...}."""
    out: Dict[str, dict] = {}
    sketches = snap.get("sketches") or {}
    for section, prefix in (
        ("critpath", _CRIT_PREFIX),
        ("quorum", _QUORUM_PREFIX),
    ):
        for name, d in (sketches.get(section) or {}).items():
            if isinstance(d, dict) and d.get("kind") == "ddsketch":
                out[f"{prefix}/{name}"] = d
    return out


def sketch_delta(later: QuantileSketch,
                 earlier: Optional[QuantileSketch]) -> QuantileSketch:
    """Bucket-wise ``later - earlier`` — exact for fixed-gamma sketches.

    When ``later`` is NOT a superset of ``earlier`` (any count would go
    negative), the node restarted between the two snapshots and ``later``
    counts from zero: the delta is ``later`` itself.  min/max cannot be
    recovered for a true delta, so the result leaves them unset (quantile
    estimates stay within the relative-error bound, just unclamped).
    """
    if earlier is None or earlier.count == 0:
        return QuantileSketch.from_dict(later.to_dict())
    if later.count < earlier.count:
        return QuantileSketch.from_dict(later.to_dict())  # restart
    lb = dict(later.to_dict()["buckets"])
    eb = dict(earlier.to_dict()["buckets"])
    if any(lb.get(i, 0) < n for i, n in eb.items()):
        return QuantileSketch.from_dict(later.to_dict())  # restart
    d = QuantileSketch(later.alpha)
    d._buckets = {
        i: lb[i] - eb.get(i, 0) for i in lb if lb[i] - eb.get(i, 0) > 0
    }
    ld, ed = later.to_dict(), earlier.to_dict()
    d._zero = max(int(ld["zero"]) - int(ed["zero"]), 0)
    d._count = later.count - earlier.count
    d._sum = later.sum - earlier.sum
    return d


def _leg_of(height: int, edges: Sequence[int]) -> int:
    """Index of the leg whose (lo, hi] height span contains ``height``."""
    for i in range(len(edges) - 1):
        if height <= edges[i + 1]:
            return i
    return len(edges) - 2


def _leg_edges(heights: Sequence[int], legs: int) -> List[int]:
    lo, hi = min(heights), max(heights)
    legs = max(1, min(int(legs), max(hi - lo, 1)))
    span = (hi - lo) / legs
    edges = [lo + int(round(span * i)) for i in range(legs)] + [hi]
    # strictly increasing even for tiny runs
    for i in range(1, len(edges)):
        edges[i] = max(edges[i], edges[i - 1] + 1)
    return edges


def build_report(
    per_node: Dict[str, List[dict]],
    legs: int = DEFAULT_LEGS,
    threshold: float = DEFAULT_THRESHOLD,
) -> dict:
    """Fuse per-node snapshot sequences (spool order) into the report.

    ``per_node`` maps node name -> its snapshots, oldest first (exactly
    what read_spool / dump_telemetry deliver).
    """
    per_node = {n: list(snaps) for n, snaps in per_node.items() if snaps}
    if not per_node:
        return {
            "nodes": [], "legs": [], "fleet": {}, "regressions": [],
            "warnings": ["nothing to report: no snapshots"],
        }

    heights = [
        int(s.get("height") or 0) for snaps in per_node.values()
        for s in snaps
    ]
    edges = _leg_edges(heights, legs)
    n_legs = len(edges) - 1

    # per-metric: fleet whole-run sketch + per-leg fleet delta sketches
    fleet: Dict[str, QuantileSketch] = {}
    per_node_final: Dict[str, Dict[str, dict]] = {}
    leg_sketches: List[Dict[str, QuantileSketch]] = [
        {} for _ in range(n_legs)
    ]
    leg_loss: List[Dict[str, int]] = [
        {store: 0 for store in EVICTION_STORES} for _ in range(n_legs)
    ]
    leg_spool_errors = [0 for _ in range(n_legs)]
    leg_snapshots = [0 for _ in range(n_legs)]
    warnings: List[str] = []

    for node, snaps in sorted(per_node.items()):
        prev_sketches: Dict[str, QuantileSketch] = {}
        prev_evicted: Dict[str, int] = {}
        prev_errors = 0
        for snap in snaps:
            leg = _leg_of(int(snap.get("height") or 0), edges)
            leg_snapshots[leg] += 1
            cur = {
                name: QuantileSketch.from_dict(d)
                for name, d in _flatten_sketches(snap).items()
            }
            for name, sk in cur.items():
                delta = sketch_delta(sk, prev_sketches.get(name))
                if delta.count > 0:
                    tgt = leg_sketches[leg].get(name)
                    if tgt is None:
                        leg_sketches[leg][name] = delta
                    else:
                        tgt.merge(delta)
            prev_sketches = cur
            # loss accounting: eviction deltas land on the leg they grew in
            evicted = snap.get("evicted") or {}
            if isinstance(evicted, dict):
                for store in EVICTION_STORES:
                    total = evicted.get(store)
                    if not isinstance(total, (int, float)):
                        continue
                    delta = int(total) - prev_evicted.get(store, 0)
                    if delta > 0:  # negative delta == restart, counts anew
                        leg_loss[leg][store] += delta
                    prev_evicted[store] = int(total)
            spool = snap.get("spool") or {}
            if isinstance(spool, dict):
                errs = int(spool.get("write_errors") or 0) + int(
                    spool.get("dropped") or 0
                )
                if errs > prev_errors:
                    leg_spool_errors[leg] += errs - prev_errors
                prev_errors = errs
        # whole-run fleet merge pools each node's FINAL cumulative sketch;
        # restarts mean earlier incarnations' data lives only in the
        # per-leg deltas — say so instead of silently undercounting
        if prev_sketches:
            per_node_final[node] = {
                name: sk.to_dict() for name, sk in prev_sketches.items()
            }
            for name, sk in prev_sketches.items():
                if name not in fleet:
                    fleet[name] = QuantileSketch(sk.alpha)
                fleet[name].merge(sk)
        restarts = sum(
            1 for a, b in zip(snaps, snaps[1:])
            if int(b.get("seq") or 0) < int(a.get("seq") or 0)
        )
        if restarts:
            warnings.append(
                f"{node}: {restarts} restart(s) detected — the fleet "
                f"whole-run merge covers the final incarnation only; "
                f"pre-crash data is in the per-leg tables"
            )

    def _stats(sk: QuantileSketch) -> dict:
        return {
            "n": sk.count,
            "p50_seconds": sk.p50(),
            "p99_seconds": sk.p99(),
        }

    legs_out = []
    for i in range(n_legs):
        lossy = {s: n for s, n in leg_loss[i].items() if n > 0}
        legs_out.append({
            "leg": i,
            "height_lo": edges[i],
            "height_hi": edges[i + 1],
            "snapshots": leg_snapshots[i],
            "metrics": {
                name: _stats(sk)
                for name, sk in sorted(leg_sketches[i].items())
            },
            "evicted": lossy,
            "spool_errors": leg_spool_errors[i],
            "lossy": bool(lossy) or leg_spool_errors[i] > 0,
        })

    # leg-over-leg regression flags on p99 (latency: a rise is a
    # regression), skipping empty legs
    regressions = []
    for prev, cur in zip(legs_out, legs_out[1:]):
        for name, stats in cur["metrics"].items():
            ps = prev["metrics"].get(name)
            if not ps or ps["p99_seconds"] <= 0 or stats["n"] == 0:
                continue
            rise = stats["p99_seconds"] / ps["p99_seconds"] - 1.0
            if rise > threshold:
                regressions.append({
                    "metric": name,
                    "from_leg": prev["leg"],
                    "to_leg": cur["leg"],
                    "prev_p99_seconds": ps["p99_seconds"],
                    "p99_seconds": stats["p99_seconds"],
                    "rise": rise,
                })

    return {
        "nodes": sorted(per_node),
        "n_legs": n_legs,
        "leg_edges": edges,
        "threshold": threshold,
        "legs": legs_out,
        "fleet": {
            name: dict(_stats(sk), sketch=sk.to_dict())
            for name, sk in sorted(fleet.items())
        },
        "per_node_final": per_node_final,
        "regressions": regressions,
        "warnings": warnings,
    }


def print_summary(report: dict, out=sys.stdout) -> None:
    print(
        f"[soak] nodes={len(report['nodes'])} legs={report.get('n_legs', 0)}"
        f" regressions={len(report['regressions'])}",
        file=out,
    )
    for warn in report.get("warnings") or []:
        print(f"[soak] WARNING: {warn}", file=out)
    key_metrics = [
        f"{_CRIT_PREFIX}/commit",
        f"{_QUORUM_PREFIX}/precommit_two_thirds",
    ]
    for metric in key_metrics:
        fl = (report.get("fleet") or {}).get(metric)
        if fl:
            print(
                f"[soak] fleet {metric}: n={fl['n']} "
                f"p50={fl['p50_seconds']:.4f}s p99={fl['p99_seconds']:.4f}s",
                file=out,
            )
        rows = []
        for leg in report.get("legs") or []:
            st = leg["metrics"].get(metric)
            if st is None:
                continue
            flag = " LOSSY" if leg["lossy"] else ""
            rows.append(
                f"    leg {leg['leg']} h({leg['height_lo']},"
                f"{leg['height_hi']}] n={st['n']} "
                f"p50={st['p50_seconds']:.4f}s "
                f"p99={st['p99_seconds']:.4f}s{flag}"
            )
        if rows:
            print(f"[soak] {metric} by leg:", file=out)
            for row in rows:
                print(row, file=out)
    for reg in report.get("regressions") or []:
        print(
            f"[soak] REGRESSION {reg['metric']}: leg {reg['from_leg']} -> "
            f"{reg['to_leg']} p99 {reg['prev_p99_seconds']:.4f}s -> "
            f"{reg['p99_seconds']:.4f}s (+{reg['rise']:.0%})",
            file=out,
        )


# --- input loading ---------------------------------------------------------


def load_spools(paths: Sequence[str]) -> Dict[str, List[dict]]:
    """Read spool head paths into per-node snapshot lists.  The node name
    comes from the snapshots themselves (node_id), falling back to the
    path; two spools of the same node merge in order."""
    per_node: Dict[str, List[dict]] = {}
    for path in paths:
        out = read_spool(path)
        if out["corrupt_frames"]:
            print(
                f"soak-report: {path}: {out['corrupt_frames']} corrupt "
                f"frame(s) skipped",
                file=sys.stderr,
            )
        for snap in out["snapshots"]:
            node = snap.get("node_id") or path
            per_node.setdefault(node, []).append(snap)
    return per_node


def _fetch(endpoints: List[str], limit: Optional[int]) -> Dict[str, List[dict]]:
    from tendermint_tpu_torch.rpc.client import HTTPClient

    per_node: Dict[str, List[dict]] = {}
    for i, ep in enumerate(endpoints):
        dump = HTTPClient(ep).dump_telemetry(limit)
        node = dump.get("node_id") or f"node{i}"
        per_node.setdefault(node, []).extend(dump.get("records") or [])
    return per_node


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--spools", default=None,
                    help="comma-separated spool head paths (offline)")
    ap.add_argument("--endpoints", default=None,
                    help="comma-separated RPC endpoints (live dump_telemetry)")
    ap.add_argument("--limit", type=int, default=None,
                    help="newest N snapshots per endpoint (live mode)")
    ap.add_argument("--legs", type=int, default=DEFAULT_LEGS)
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="leg-over-leg p99 rise flagged beyond this "
                         "fraction (default 0.25)")
    ap.add_argument("-o", "--output", default="soak_report.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the report is built on the host")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card: NoCudaDeviceError

    if bool(args.spools) == bool(args.endpoints):
        print("exactly one of --spools / --endpoints required",
              file=sys.stderr)
        return 2
    if args.spools:
        per_node = load_spools(
            [p.strip() for p in args.spools.split(",") if p.strip()]
        )
    else:
        per_node = _fetch(
            [e.strip() for e in args.endpoints.split(",") if e.strip()],
            args.limit,
        )
    report = build_report(per_node, legs=args.legs, threshold=args.threshold)
    with open(args.output, "w") as f:
        json.dump(report, f)
    print_summary(report)
    print(f"[soak] report -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
