"""The chaos/Byzantine scenario matrix on the port: the counterpart of the
reference's ``scripts/chaos_smoke.py``.

    python3 -m tendermint_tpu_torch.tools.chaos_smoke                 # the card
    python3 -m tendermint_tpu_torch.tools.chaos_smoke --device cpu --only vote_storm
    ... --budget-s 420 --out-dir DIR

Runs every named scenario of ``sim/scenarios.py`` (real ConsensusStates +
mempool/evidence reactors over the seeded fault-injecting ``SimNet``
fabric) in one process, on ``--device`` (default ``cuda``: the vote and tx
feeds and every LastCommit check go to the configuration root's guarded
verifier, K1 + K2 and K3; ``cpu``: the host, as the reference runs):

  * each scenario asserts safety (no conflicting commits at any height),
    liveness (its own progress condition) and replayability (every seeded
    fault decision re-derives from the scenario seed);
  * without ``--only``, ``baseline_determinism`` runs twice more and the
    two runs' per-node commit hashes must be identical over the
    round-0-clean prefix: same seed, same chain;
  * on a failure the scenario's seed is printed (re-run with it for the
    identical fault schedule) and the nodes' flight recorders are merged
    into a Chrome trace (``chaos_<scenario>_trace.json`` under
    ``--out-dir``).

An overall wall-clock budget bounds the run even if a scenario wedges;
every scenario also carries its own timeout. Exit 0 = all green. Without a
card and without ``--device cpu`` it exits non-zero naming
``NoCudaDeviceError``, as the port's command line does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.sim import SCENARIOS, round0_clean_top, run_scenario
from tendermint_tpu_torch.tools import trace_merge

DEFAULT_BUDGET_S = 420.0


def _emit_failure_trace(result, out_dir: str) -> str:
    """Merge the failed run's flight dumps into one Chrome trace file."""
    dumps = [d for d in result.flight_dumps if d.get("records")]
    path = os.path.join(out_dir, f"chaos_{result.name}_trace.json")
    merged = trace_merge.merge(dumps) if dumps else {
        "traceEvents": [], "otherData": {"note": "no flight records"},
    }
    with open(path, "w") as f:
        json.dump(merged, f)
    return path


def _run_one(name: str, make, out_dir: str, device) -> bool:
    t0 = time.monotonic()
    result = run_scenario(make(), device=device)
    elapsed = time.monotonic() - t0
    summary = result.fault_summary
    if result.ok:
        print(f"[chaos-smoke] PASS {name:<22} {elapsed:6.1f}s "
              f"heights={result.heights} "
              f"seeded_decisions={summary.get('seeded_decisions', 0)}")
        return True
    print(f"[chaos-smoke] FAIL {name} ({elapsed:.1f}s): replay with "
          f"seed={result.seed}", file=sys.stderr)
    for failure in result.failures:
        print(f"[chaos-smoke]   {name}: {failure}", file=sys.stderr)
    trace_path = _emit_failure_trace(result, out_dir)
    print(f"[chaos-smoke]   merged trace -> {trace_path}", file=sys.stderr)
    return False


def commit_hash_mismatches(r1, r2, top: int) -> list:
    """Every (node, height) of 1..``top`` whose commit hash differs between
    two runs of one seed."""
    out = []
    for node in range(len(r1.commit_hashes)):
        for h in range(1, top + 1):
            a = r1.commit_hashes[node].get(h)
            b = r2.commit_hashes[node].get(h)
            if a != b:
                out.append(f"node {node} height {h}: {a} != {b} across two "
                           f"runs of seed {r1.seed}")
    return out


def _determinism_cross_check(out_dir: str, device) -> bool:
    """Run baseline_determinism twice more: identical seed must yield
    identical per-node commit hashes across runs. Determinism only holds
    while every commit forms at round 0 (a round > 0 commit means a
    real-time timeout fired under host load and proposer rotation may
    legitimately diverge), so the comparison covers the round-0-clean
    prefix, retrying once if load truncated it."""
    make = SCENARIOS["baseline_determinism"]
    target = make().target_height
    problems = []
    r1 = r2 = None
    top = 0
    for _ in range(2):
        r1 = run_scenario(make(), device=device)
        r2 = run_scenario(make(), device=device)
        # safety/replay problems are bugs; liveness misses are wall-clock
        problems = [f"run1: {f}" for f in r1.failures if not f.startswith("liveness")]
        problems += [f"run2: {f}" for f in r2.failures if not f.startswith("liveness")]
        top = min(round0_clean_top(r1), round0_clean_top(r2))
        if problems or (r1.ok and r2.ok and top >= target):
            break
        print(f"[chaos-smoke] NOTE determinism x2: host load perturbed the "
              f"run (round-0-clean prefix h<={top}); retrying", file=sys.stderr)
    if not problems:
        if top < 2:
            problems.append(f"round-0-clean prefix only reached h={top}; nothing "
                            f"meaningful to compare (seed {r1.seed})")
        problems += commit_hash_mismatches(r1, r2, top)
    if problems:
        print(f"[chaos-smoke] FAIL determinism x2: seed={r1.seed}", file=sys.stderr)
        for p in problems:
            print(f"[chaos-smoke]   determinism x2: {p}", file=sys.stderr)
        for r in (r1, r2):
            if not r.ok:
                print(f"[chaos-smoke]   merged trace -> "
                      f"{_emit_failure_trace(r, out_dir)}", file=sys.stderr)
        return False
    print(f"[chaos-smoke] PASS {'determinism x2':<22} identical commit "
          f"hashes across runs (h<= {top})")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--only", help="comma-separated scenario names")
    ap.add_argument("--budget-s", type=float, default=DEFAULT_BUDGET_S,
                    help="overall wall-clock budget (default %(default)ss)")
    ap.add_argument("--out-dir", default=os.getcwd(),
                    help="where failure traces are written (default: the cwd)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's verify path) or cpu (the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # no card: NoCudaDeviceError

    names = list(SCENARIOS)
    if args.only:
        names = [n.strip() for n in args.only.split(",") if n.strip()]
        unknown = [n for n in names if n not in SCENARIOS]
        if unknown:
            print(f"unknown scenario(s): {unknown}; have {list(SCENARIOS)}",
                  file=sys.stderr)
            return 2

    deadline = time.monotonic() + args.budget_s
    print(f"[chaos-smoke] {len(names)} scenarios on {device}, "
          f"budget {args.budget_s:.0f}s")
    ok = True
    for name in names:
        if time.monotonic() > deadline:
            print(f"[chaos-smoke] FAIL: wall-clock budget exhausted before "
                  f"{name!r} (ran out at {args.budget_s:.0f}s)", file=sys.stderr)
            ok = False
            break
        ok = _run_one(name, SCENARIOS[name], args.out_dir, device) and ok

    if ok and not args.only and time.monotonic() < deadline:
        ok = _determinism_cross_check(args.out_dir, device)

    if not ok:
        print("[chaos-smoke] FAILED", file=sys.stderr)
        return 1
    print("[chaos-smoke] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
