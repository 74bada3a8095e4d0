"""Cross-node flight/trace merger: the port's copy of the reference's
``scripts/trace_merge.py``.

Fuses ``FlightRecorder.snapshot()`` payloads (per-height consensus
lifecycle records) and optionally span-tracer dumps into ONE Chrome
trace-event JSON — one track (pid) per node — for chrome://tracing or
ui.perfetto.dev.  Each node's track carries two threads: tid 0 "consensus"
(lifecycle instants + height spans) and tid 1 "waterfall"
(per-committed-height commit-latency waterfalls as nested phase slices,
built by libs/critpath.py from the same records).

Clock alignment: every flight record carries wall-clock timestamps, but node
wall clocks disagree (NTP skew).  A commit of height H with hash X is the
same *instant class* on every node that committed it, so shared (height,
commit-hash) anchors give per-node offsets: each node's skew is the median of
(reference_commit_t - node_commit_t) over shared anchors, with the first
dump as reference.  Span-tracer events are perf_counter-based
(process-local); a trace dump ships a {wall_ns, perf_ns} anchor pair taken
at dump time, which places them on the same wall timeline before the same
skew correction is applied.

The port has no RPC server yet, so the CLI reads the dumps from JSON files
(one ``cs.flight.snapshot()`` each) instead of fetching ``dump_flight``:

    python -m tendermint_tpu_torch.tools.trace_merge node0.json node1.json \
        [-o merged_trace.json]

The core (`compute_skews` / `merge` / `anchor_spread`) is importable — the
tests and ``chip_smoke.py`` drive it with in-process dumps.  The CLI
streams via `write_merged`, which serialises events one at a time
(byte-identical to `json.dump(merge(...), f)`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.libs import critpath, quorumtrace

_FLIGHT_TID = 0  # every flight-recorder track uses tid 0 ("consensus")
_WATERFALL_TID = 1  # commit-latency waterfall slices (libs/critpath.py)


def _commit_anchors(dump: dict) -> Dict[Tuple[int, str], int]:
    """(height, commit_hash) -> commit wall time ns for one node's dump."""
    out = {}
    for rec in dump.get("records", []):
        c = rec.get("commit")
        if c and c.get("hash"):
            out[(rec["height"], c["hash"])] = c["t"]
    return out


def compute_skews(dumps: List[dict]) -> List[int]:
    """Per-node clock skew in ns relative to dumps[0]: ADD skews[i] to node
    i's wall timestamps to land on the reference timeline.  Nodes sharing no
    commit anchor with the reference get skew 0 (flagged by the caller)."""
    if not dumps:
        return []
    ref = _commit_anchors(dumps[0])
    skews = [0]
    for dump in dumps[1:]:
        own = _commit_anchors(dump)
        deltas = [ref[a] - own[a] for a in own.keys() & ref.keys()]
        skews.append(int(statistics.median(deltas)) if deltas else 0)
    return skews


# below this many shared anchors the median is one sample (or none): the
# skew is a guess, and the merged view must SAY so instead of silently
# rendering misaligned tracks that look like real latency
MIN_SHARED_ANCHORS = 2


def alignment_warnings(dumps: List[dict]) -> List[str]:
    """Human-readable diagnostics for degenerate anchor overlap.  Empty means
    every non-reference node shares >= MIN_SHARED_ANCHORS commit anchors with
    the reference, i.e. the skew medians are trustworthy."""
    if not dumps:
        return ["nothing to merge: no flight dumps"]
    if len(dumps) == 1:
        return []  # single node: its own clock IS the timeline
    warns = []
    ref = _commit_anchors(dumps[0])
    ref_name = dumps[0].get("node_id") or "node0"
    if not ref:
        warns.append(
            f"reference node {ref_name} has no commit anchors (no committed "
            f"heights in its dump) — cross-node clock alignment is impossible; "
            f"all tracks stay on their own clocks"
        )
    for i, dump in enumerate(dumps[1:], start=1):
        name = dump.get("node_id") or f"node{i}"
        shared = len(_commit_anchors(dump).keys() & ref.keys())
        if shared == 0:
            warns.append(
                f"{name}: no commit anchors shared with {ref_name} — skew "
                f"unknown, timestamps left uncorrected (skew 0); expect "
                f"misaligned tracks"
            )
        elif shared < MIN_SHARED_ANCHORS:
            warns.append(
                f"{name}: only {shared} commit anchor shared with {ref_name} "
                f"— skew rests on a single sample; capture more committed "
                f"heights for a robust median"
            )
    return warns


def anchor_spread(dumps: List[dict], skews: List[int]) -> Dict[int, float]:
    """Per-height max disagreement (seconds) of skew-corrected commit times
    across nodes — the residual alignment error.  Only heights committed by
    >= 2 nodes with the same hash appear."""
    by_anchor: Dict[Tuple[int, str], List[int]] = {}
    for dump, skew in zip(dumps, skews):
        for anchor, t in _commit_anchors(dump).items():
            by_anchor.setdefault(anchor, []).append(t + skew)
    return {
        h: (max(ts) - min(ts)) / 1e9
        for (h, _hash), ts in by_anchor.items()
        if len(ts) >= 2
    }


def _us(t_ns: int, skew_ns: int) -> float:
    return (t_ns + skew_ns) / 1000.0


def _waterfall_events(rec: dict, pid: int, skew_ns: int) -> List[dict]:
    """Commit-latency waterfall for one committed height as NESTED Chrome
    slices: a parent `waterfall h` X slice spanning the height's wall time
    on the waterfall track, with one child X slice per timeline phase
    (children nest by ts/dur containment on the same pid/tid — the Chrome
    trace nesting rule).  Uncommitted heights emit nothing."""
    wf = critpath.build_waterfall(rec)
    if wf is None:
        return []
    # all endpoints converted to µs FIRST, durations taken as float
    # differences of those endpoints: at wall-clock magnitude (~1e15 µs)
    # float64 resolves ~0.25µs, so mixing ns-difference durations with
    # µs-converted starts would let children escape their parent by a
    # rounding ulp and break strict nesting validation
    p0 = _us(wf["t_start_ns"], skew_ns)
    p1 = max(_us(wf["t_end_ns"], skew_ns), p0)
    events = [{
        "name": f"waterfall {wf['height']}", "cat": "critpath", "ph": "X",
        "pid": pid, "tid": _WATERFALL_TID,
        "ts": p0, "dur": p1 - p0,
        "args": {
            "height": wf["height"],
            "critical_path": wf["critical_path"],
            "commit_seconds": wf["commit_seconds"],
            "other_seconds": wf["other_seconds"],
            "wal_append_seconds": wf["phases"]["wal_append"],
            "wal_fsync_seconds": wf["phases"]["wal_fsync"],
            "verify_dispatch_seconds": wf["verify_dispatch_seconds"],
        },
    }]
    for seg in wf["segments"]:
        s0 = min(max(_us(seg["t0_ns"], skew_ns), p0), p1)
        s1 = min(max(_us(seg["t1_ns"], skew_ns), s0), p1)
        events.append({
            "name": seg["phase"], "cat": "critpath", "ph": "X",
            "pid": pid, "tid": _WATERFALL_TID,
            "ts": s0, "dur": s1 - s0,
            "args": {
                "height": wf["height"],
                "seconds": wf["phases"][seg["phase"]],
                "critical": seg["phase"] == wf["critical_path"],
            },
        })
    return events


def _flight_events(dump: dict, pid: int, skew_ns: int) -> List[dict]:
    node = dump.get("node_id") or f"node{pid}"
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": _FLIGHT_TID,
         "args": {"name": node}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": _FLIGHT_TID,
         "args": {"name": "consensus"}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": _WATERFALL_TID,
         "args": {"name": "waterfall"}},
    ]

    def instant(name: str, t_ns: int, **args) -> None:
        ev = {"name": name, "cat": "flight", "ph": "i", "s": "t",
              "pid": pid, "tid": _FLIGHT_TID, "ts": _us(t_ns, skew_ns)}
        if args:
            ev["args"] = args
        events.append(ev)

    for rec in dump.get("records", []):
        h = rec["height"]
        stamps = []
        for r in rec.get("rounds", []):
            instant("new_round", r["t"], height=h, round=r["round"])
            stamps.append(r["t"])
        p = rec.get("proposal")
        if p:
            instant("proposal", p["t"], height=h, round=p["round"],
                    peer=p["peer"])
            stamps.append(p["t"])
        bp = rec.get("block_parts")
        if bp:
            instant("block_parts_complete", bp["t"], height=h)
            stamps.append(bp["t"])
        for kind in ("prevote", "precommit"):
            vs = rec.get(kind) or {}
            for which in ("first", "last"):
                mark = vs.get(which)
                if mark and (which == "first" or vs.get("count", 0) > 1):
                    instant(f"{kind}_{which}", mark["t"], height=h,
                            round=mark["round"], peer=mark["peer"],
                            validator_index=mark["validator_index"])
                    stamps.append(mark["t"])
        pol = rec.get("polka")
        if pol:
            instant("polka", pol["t"], height=h, round=pol["round"])
            stamps.append(pol["t"])
        c = rec.get("commit")
        if c:
            instant("commit", c["t"], height=h, round=c["round"],
                    hash=c["hash"])
            stamps.append(c["t"])
        ex = rec.get("exec")
        if ex:
            events.append({
                "name": "abci_execute", "cat": "flight", "ph": "X",
                "pid": pid, "tid": _FLIGHT_TID,
                "ts": _us(ex["t"], skew_ns),
                "dur": max(ex["dur_ns"], 0) / 1000.0,
                "args": {"height": h},
            })
            stamps.extend([ex["t"], ex["t"] + max(ex["dur_ns"], 0)])
        if stamps:
            t0, t1 = min(stamps), max(stamps)
            events.append({
                "name": f"height {h}", "cat": "flight", "ph": "X",
                "pid": pid, "tid": _FLIGHT_TID,
                "ts": _us(t0, skew_ns), "dur": (t1 - t0) / 1000.0,
                "args": {
                    "height": h,
                    "rounds": len(rec.get("rounds", [])),
                    "prevotes": (rec.get("prevote") or {}).get("count", 0),
                    "precommits": (rec.get("precommit") or {}).get("count", 0),
                },
            })
        events.extend(_waterfall_events(rec, pid, skew_ns))
    return events


def _flow_events(dumps: List[dict], skews: List[int]) -> List[dict]:
    """Chrome flow arrows from each vote's signer to each receiver: one
    `s`/`f` pair per (journey, receiver), the `s` on the origin's track at
    the corrected sign stamp and the `f` on the receiver's track at its
    corrected first-sighting stamp.  Endpoints convert to µs FIRST and the
    finish clamps to >= the start in µs space — the same float64-ulp
    argument as the waterfall slices (a reversed arrow is a validator
    error, not a rendering quirk)."""
    pid_of = {
        (d.get("node_id") or f"node{i}"): i for i, d in enumerate(dumps)
    }
    skew_map = {
        (d.get("node_id") or f"node{i}"): skews[i]
        for i, d in enumerate(dumps)
    }
    journeys = quorumtrace.build_journeys(dumps, skew_map)
    events: List[dict] = []
    for j in journeys:
        origin = j["origin"]
        if origin is None or j["signed_ns"] is None or origin not in pid_of:
            continue  # no signer dump: nothing to draw the arrow from
        origin_pid = pid_of[origin]
        s_us = j["signed_ns"] / 1000.0  # skew already applied by the fuser
        name = f"vote {j['kind']}"
        for node, mark in sorted(j["arrivals"].items()):
            if node == origin or node not in pid_of:
                continue
            flow_id = (
                f"vote-{j['height']}-{j['kind']}-"
                f"{j['validator_index']}-{pid_of[node]}"
            )
            f_us = max(mark.get("t_mono_ns", mark["t_ns"]) / 1000.0, s_us)
            args = {
                "height": j["height"],
                "validator_index": j["validator_index"],
            }
            events.append({
                "name": name, "cat": "flow", "ph": "s", "id": flow_id,
                "pid": origin_pid, "tid": _FLIGHT_TID, "ts": s_us,
                "args": args,
            })
            events.append({
                "name": name, "cat": "flow", "ph": "f", "bp": "e",
                "id": flow_id, "pid": pid_of[node], "tid": _FLIGHT_TID,
                "ts": f_us, "args": dict(args, peer=mark.get("peer", "")),
            })
    return events


def _trace_events(payload: dict, pid: int, skew_ns: int) -> List[dict]:
    """Retag one node's dump_trace events onto its merged track.  Trace ts
    are perf_counter µs; the dump-time {wall_ns, perf_ns} anchor converts
    them to wall µs before the cross-node skew correction."""
    anchor = payload.get("anchor") or {}
    if "wall_ns" not in anchor or "perf_ns" not in anchor:
        return []
    wall_offset_us = (anchor["wall_ns"] - anchor["perf_ns"] + skew_ns) / 1000.0
    out = []
    for ev in payload.get("traceEvents", []):
        ev = dict(ev)
        ev["pid"] = pid
        if ev.get("ph") != "M":
            ev["ts"] = ev.get("ts", 0.0) + wall_offset_us
        out.append(ev)
    return out


def iter_merged_events(dumps: List[dict],
                       traces: Optional[List[Optional[dict]]] = None,
                       skews: Optional[List[int]] = None):
    """Yield the merged traceEvents lazily, in exactly the order merge()
    materialises them: each node's flight track, its retagged dump_trace
    events, then the cross-node flow arrows last (they need every dump).
    Peak residency is one node's track plus the arrows — not the fleet."""
    skews = compute_skews(dumps) if skews is None else skews
    for pid, (dump, skew) in enumerate(zip(dumps, skews)):
        yield from _flight_events(dump, pid, skew)
        if traces is not None and pid < len(traces) and traces[pid]:
            yield from _trace_events(traces[pid], pid, skew)
    # cross-node pass: vote-propagation arrows (signer -> each receiver)
    yield from _flow_events(dumps, skews)


def _other_data(dumps: List[dict], skews: List[int]) -> dict:
    return {
        "nodes": [d.get("node_id") or f"node{i}"
                  for i, d in enumerate(dumps)],
        "skews_ns": list(skews),
        "alignment_warnings": alignment_warnings(dumps),
    }


def merge(dumps: List[dict], traces: Optional[List[Optional[dict]]] = None,
          skews: Optional[List[int]] = None) -> dict:
    """Fuse per-node dump_flight payloads (and optional index-aligned
    dump_trace payloads) into one Chrome trace-event dict."""
    skews = compute_skews(dumps) if skews is None else skews
    return {
        "traceEvents": list(iter_merged_events(dumps, traces, skews=skews)),
        "displayTimeUnit": "ms",
        "otherData": _other_data(dumps, skews),
    }


def write_merged(f, dumps: List[dict],
                 traces: Optional[List[Optional[dict]]] = None,
                 skews: Optional[List[int]] = None) -> int:
    """Stream the merge() document to a text file object one event at a
    time, byte-identical to ``json.dump(merge(...), f)`` — the scaffolding
    strings reproduce json.dump's default separators (``", "`` / ``": "``)
    and top-level key order, and each event is serialised with the same
    defaults.  Returns the event count (the CLI reports it without ever
    holding the list)."""
    skews = compute_skews(dumps) if skews is None else skews
    f.write('{"traceEvents": [')
    count = 0
    for ev in iter_merged_events(dumps, traces, skews=skews):
        if count:
            f.write(", ")
        json.dump(ev, f)
        count += 1
    f.write('], "displayTimeUnit": "ms", "otherData": ')
    json.dump(_other_data(dumps, skews), f)
    f.write("}")
    return count


# --- CLI -------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("dumps", nargs="+",
                    help="flight snapshot JSON files, the reference node first")
    ap.add_argument("-o", "--output", default="merged_trace.json")
    args = ap.parse_args(argv)

    dumps = []
    for path in args.dumps:
        with open(path) as f:
            dumps.append(json.load(f))
    skews = compute_skews(dumps)
    with open(args.output, "w") as f:
        n_events = write_merged(f, dumps, skews=skews)
    spread = anchor_spread(dumps, skews)
    worst = max(spread.values()) if spread else None
    print(
        f"merged {len(dumps)} nodes, {n_events} events "
        f"-> {args.output}"
    )
    print(f"skews_ns={skews} shared_heights={len(spread)} "
          f"worst_anchor_spread_s={worst}")
    for warn in alignment_warnings(dumps):
        print(f"WARNING: {warn}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
