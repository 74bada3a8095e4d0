"""Commit-path latency bench: the port's counterpart of the reference's
``scripts/bench_commit_path.py`` (``make critpath-bench``): signing-to-commit
p99 under adversarial load, with the per-phase breakdown.

    python3 -m tendermint_tpu_torch.tools.bench_commit_path            # the card
    python3 -m tendermint_tpu_torch.tools.bench_commit_path --device cpu \\
        [--scenarios vote_storm,mempool_flood] [--min-heights 6] [--round-dir DIR]

Drives the seeded sim fabric (``sim.run_scenario``) through the two storm
scenarios that stress the write path, ``vote_storm`` (duplicate and
equivocation squalls through the vote feed) and ``mempool_flood`` (a spam
flood against per-peer QoS), with every node's flight recorder on, then
pools the per-height commit-latency waterfalls that the critical-path
analyzer (``libs/critpath.py``) built during the run (each node's
``critpath_dumps``).

Headline: ``commit_p99_seconds``, the p99 of per-height signing-to-commit
wall time (new-round entry -> +2/3 precommits) across every node and every
scenario; the per-phase p50/p99 table shows where the p99 lives.
``summarize(results)`` computes both from ``ScenarioResult``s a caller
already has.

With ``--round-dir`` the next ``CRITPATH_rNN.json`` goes there in the
reference's format (``scripts/bench_check.py --prefix CRITPATH --dir``
reads it); without it no round file is written (the reference writes into
its checkout, beside its CPU rounds).

On ``--device`` (default ``cuda``; ``tools/smoke_verify``): on the card the
vote and tx feeds and every LastCommit check go to the root's guarded
verifier (K1 + K2), and the run must reach the card; ``cpu`` verifies on
the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tendermint_tpu_torch.libs.critpath import PHASES, percentile
from tendermint_tpu_torch.sim import SCENARIOS, run_scenario
from tendermint_tpu_torch.tools.smoke_verify import SmokeVerify, finish, write_round


def pool(results):
    """Per-height samples pooled across nodes and scenarios: commit
    latencies, per-phase seconds and critical-phase counts, straight from
    the waterfalls."""
    commits = []
    phases = {p: [] for p in PHASES}
    criticals = {}
    for result in results:
        for dump in result.critpath_dumps:
            for wf in dump.get("records", []):
                commits.append(wf["commit_seconds"])
                for p in PHASES:
                    phases[p].append(wf["phases"][p])
                cp = wf["critical_path"]
                criticals[cp] = criticals.get(cp, 0) + 1
    return commits, phases, criticals


def phase_table(phases, commits) -> str:
    """The per-phase breakdown as a Markdown table."""
    lines = ["| phase | p50 (ms) | p99 (ms) | share of p50 commit |", "|---|---|---|---|"]
    c50 = percentile(commits, 50) or 1.0
    for p in PHASES:
        xs = phases[p]
        p50, p99 = percentile(xs, 50), percentile(xs, 99)
        lines.append(f"| {p} | {1e3 * p50:.2f} | {1e3 * p99:.2f} | {100.0 * p50 / c50:.0f}% |")
    lines.append(f"| **commit (signing-to-commit)** | **{1e3 * percentile(commits, 50):.2f}** "
                 f"| **{1e3 * percentile(commits, 99):.2f}** | 100% |")
    return "\n".join(lines)


def summarize(results) -> dict:
    """The bench's numbers over ``ScenarioResult``s: {"parsed": the round's
    parsed dict, "tail": its headline JSON line, "table": the phase table,
    "commits": the pooled sample count}."""
    commits, phases, criticals = pool(results)
    parsed = {
        "commit_p99_seconds": round(percentile(commits, 99), 6),
        "commit_p50_seconds": round(percentile(commits, 50), 6),
        "commit_heights": len(commits),
        "scenarios": {r.name: {"ok": r.ok, "heights": r.heights} for r in results},
        "critical_path_counts": criticals,
        "phases": {p: {"p50_seconds": round(percentile(phases[p], 50), 6),
                       "p99_seconds": round(percentile(phases[p], 99), 6)}
                   for p in PHASES},
    }
    tail = json.dumps({
        "metric": "commit_p99_seconds",
        "value": parsed["commit_p99_seconds"],
        "unit": "s",
        "commit_p50_seconds": parsed["commit_p50_seconds"],
        "commit_heights": parsed["commit_heights"],
        "critical_path_counts": criticals,
    })
    return {"parsed": parsed, "tail": tail, "table": phase_table(phases, commits),
            "commits": len(commits)}


def run_scenarios(names, device) -> list:
    results = []
    for name in names:
        result = run_scenario(SCENARIOS[name](), device=device)
        results.append(result)
        print(json.dumps({
            "stage": name, "ok": result.ok, "failures": result.failures,
            "elapsed_s": result.elapsed_s, "heights": result.heights,
            "waterfalls": sum(d.get("total_records", 0) for d in result.critpath_dumps),
        }), flush=True)
    return results


def run(argv=None) -> dict:
    """The bench; returns {"ok", "failures", "seconds", "heights",
    "launches", "results" (the ``ScenarioResult``s), "summary", "round"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--scenarios", default="vote_storm,mempool_flood",
                    help="comma-separated sim scenario names to drive")
    ap.add_argument("--min-heights", type=int, default=6,
                    help="pooled waterfall floor: fewer committed heights than this across "
                         "the whole run is a failed bench")
    ap.add_argument("--round-dir", default=None,
                    help="write the next CRITPATH_rNN.json here (default: no round file)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's verify path) or cpu (the host)")
    args = ap.parse_args(argv)
    names = [s.strip() for s in args.scenarios.split(",") if s.strip()]
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise SystemExit(f"unknown scenario(s) {unknown} (have: {', '.join(sorted(SCENARIOS))})")
    t0 = time.perf_counter()
    out, failures = {}, []
    with SmokeVerify(args.device) as sv:
        results = run_scenarios(names, sv.device)
        failures += sv.card_failures()
        out["launches"] = sv.launches()
        print(f"# verified {sv.summary()}", file=sys.stderr, flush=True)
    out.update(results=results, heights={r.name: r.heights for r in results})
    summary = out["summary"] = summarize(results)
    # a scenario's check failures mean the storm itself misbehaved: said
    # loudly, but only an empty waterfall pool fails the bench (the latency
    # comes from the heights that did commit)
    for result in results:
        for failure in result.failures:
            print(f"WARNING: {result.name}: {failure}", file=sys.stderr)
    if summary["commits"] < args.min_heights:
        failures.append(f"only {summary['commits']} committed-height waterfalls pooled "
                        f"(need >= {args.min_heights})")
    if not failures:
        print(summary["tail"], flush=True)
        print("\n" + summary["table"] + "\n", flush=True)
        if args.round_dir:
            out["round"] = write_round(args.round_dir, "CRITPATH",
                                       {"rc": 0, "tail": summary["tail"],
                                        "parsed": summary["parsed"]}, "bench-commit-path")
    return finish("bench-commit-path", out, failures, t0)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
