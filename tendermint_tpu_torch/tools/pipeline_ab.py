"""Time ``WindowPipeline`` as it ships, its worker planning only while the
guarded executor packs and uploads, against the same pipeline with the
worker also packing ahead onto the card, in turns, on state sync's backfill
shape: a signed 512-height x 64-validator window (``testutil/window.py``,
seed 7) streamed as 16 sub-windows of 32 heights.

    python3 -m tendermint_tpu_torch.tools.pipeline_ab [pairs=4] [audit=0.05,0]

For each audit rate (``[verify] audit_sample_rate``) the configuration root
is installed on the card, each variant runs once to warm, then ``pairs``
pairs in the order plan, ahead, ahead, plan, plan, ahead, ... Each call's
wall (host clock) and its ``planner.pack``, ``planner.pack_device``,
``planner.dispatch`` and ``planner.audit`` span sums are printed, then the
medians of each variant and of the per-pair differences. Every call's
concatenated verdict must equal the flat window's. The card's name and
power limit come first.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.node.verify_root import configure_verify, reset_verify
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.testutil import window as tw

H, V, SUBWINDOW = 512, 64, 32
SPANS = ("planner.pack", "planner.pack_device", "planner.dispatch", "planner.audit")
KEYS = ("ok", "tally", "committed", "sigs_ok")


@contextlib.contextmanager
def packing_ahead(dev: torch.device):
    """The worker thread also packs and uploads each planned window onto
    ``dev``; the guarded executor then finds the pack cached on the plan."""
    real = planner.plan_window

    def plan_and_pack(votes, powers, totals):
        plan = real(votes, powers, totals)
        if threading.current_thread().name == "planner-pack" and plan.all_ed25519():
            with trace.span("planner.pack_device", H=plan.H, n=plan.n_lanes):
                planner.pack_device(plan, dev)
        return plan

    planner.plan_window = plan_and_pack
    try:
        yield
    finally:
        planner.plan_window = real


def one_call(rows, dev, ahead: bool):
    votes, powers, totals = rows
    specs = ((votes[s: s + SUBWINDOW], powers[s: s + SUBWINDOW], totals[s: s + SUBWINDOW])
             for s in range(0, len(votes), SUBWINDOW))
    trace.reset()
    with packing_ahead(dev) if ahead else contextlib.nullcontext():
        t0 = time.perf_counter()
        it = planner.WindowPipeline(use_device=True, depth=planner.pipeline_depth()).run(specs)
        try:
            verdicts = list(it)
        finally:
            it.close()
        wall = time.perf_counter() - t0
    spans = {n: 0.0 for n in SPANS}
    for ev in trace.export():
        if ev.get("ph") == "X" and ev["name"] in spans:
            spans[ev["name"]] += ev["dur"] / 1e6
    return verdicts, wall, spans


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("pipeline A/B: no CUDA device")
    args = dict(a.split("=", 1) for a in argv)
    pairs = int(args.get("pairs", 4))
    rates = [float(r) for r in args.get("audit", "0.05,0").split(",")]
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    win = tw.build_window(H, V, seed=7)
    rows = win.rows()
    print(f"built and signed {H} x {V} in {time.perf_counter() - t0:.1f} s", flush=True)
    variants = {False: "plan", True: "ahead"}
    for rate in rates:
        configure_verify(VerifyConfig(audit_sample_rate=rate), device=dev)
        want = planner.verify_window(*rows, use_device=True)
        trace.enable()
        try:
            walls = {False: [], True: []}
            for ahead in (False, True):  # warm
                one_call(rows, dev, ahead)
            for i in range(pairs):
                for ahead in ((False, True) if i % 2 == 0 else (True, False)):
                    verdicts, wall, spans = one_call(rows, dev, ahead)
                    for k in KEYS:
                        got = np.concatenate([getattr(v, k) for v in verdicts])
                        if not np.array_equal(got, getattr(want, k)):
                            raise SystemExit(f"{variants[ahead]}: {k} differs from the window")
                    walls[ahead].append(wall)
                    print(f"audit {rate} pair {i} {variants[ahead]}: wall "
                          f"{wall * 1e3:.1f} ms; " + ", ".join(
                              f"{n} {s * 1e3:.1f}" for n, s in spans.items()), flush=True)
        finally:
            trace.disable()
            reset_verify()
        med = {a: statistics.median(w) * 1e3 for a, w in walls.items()}
        diff = statistics.median(b - a for a, b in zip(walls[False], walls[True])) * 1e3
        print(f"audit {rate}: median wall plan {med[False]:.1f} ms, ahead {med[True]:.1f} ms; "
              f"median of (ahead - plan) over {pairs} pairs {diff:.1f} ms; spread plan "
              f"{(max(walls[False]) - min(walls[False])) * 1e3:.1f} ms, ahead "
              f"{(max(walls[True]) - min(walls[True])) * 1e3:.1f} ms; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
