"""Time K4 as the port launches it, on the 10,000-validator ed25519
commit's MSM inputs, in several rounds of back-to-back calls.

    python3 -m tendermint_tpu_torch.tools.k4_time [label=NAME] [rounds=N]

The inputs are ``ed25519_msm.rlc_inputs`` of the commit's parsed rows
(seed 1234, as chip_smoke.py's k4 phase). K4 is first held limb for limb
against ``msm_plain``; then each round times ``ITERS`` back-to-back calls
of the whole of K4 (``msm``) and of its tree levels alone (``msm_levels``)
with CUDA events, a spin kernel holding the stream while the host enqueues
them. Prints each round's ms, their median, and the card's name and power
limit; the last line is one JSON object. To compare two versions of K4,
run this module from each tree in turns within one call.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys

import torch

from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.ops import ed25519_msm as em
from tendermint_tpu_torch.testutil import commit as tc

N_ROWS, SEED = 10_000, 1234
ITERS, ROUNDS = 50, 7
SPIN_CYCLES = 50_000_000  # ~25 ms: longer than enqueueing ITERS calls


def timed(fn) -> float:
    """Mean device ms of fn() over ITERS back-to-back calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main(argv) -> int:
    args = dict(a.split("=", 1) for a in argv)
    label, rounds = args.get("label", "tree"), int(args.get("rounds", ROUNDS))
    if not torch.cuda.is_available():
        raise SystemExit("K4 time: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sc_ = tc.build_commit(N_ROWS)
    items = [(v.pub_key.bytes(), pc.sign_bytes(sc_.chain_id), pc.signature)
             for v, pc in zip(sc_.valset.validators, sc_.commit.precommits)]
    rows = [p[1:] for p in ed._parse_batch(items)[0]]
    sched, pool, sb = em.rlc_inputs(rows, random.Random(SEED))
    ins = em.device_inputs(sched, pool, sb, dev)
    got = em.msm(*ins)
    want = em.msm_plain(*ins)
    if not all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want)):
        raise SystemExit(f"{label}: K4 differs from msm_plain")
    if int(got[0].item()) != 1:
        raise SystemExit(f"{label}: K4 rejects the commit")
    rowbuf = em.msm_rows(ins[0], ins[1])
    levels = lambda: em.msm_levels(rowbuf, ins[1], ins[2], ins[0].shape[0])  # noqa: E731
    whole = lambda: em.msm(*ins)  # noqa: E731
    for fn in (whole, levels):
        fn()
    k4_ms, levels_ms = [], []
    for _ in range(rounds):
        k4_ms.append(timed(whole))
        levels_ms.append(timed(levels))
    out = {"label": label, "card": card, "levels": [int(a.shape[0]) for a in ins[1]],
           "k4_ms": k4_ms, "levels_ms": levels_ms,
           "k4_median_ms": statistics.median(k4_ms),
           "levels_median_ms": statistics.median(levels_ms)}
    print(f"{label}: {card}; K4 exact against msm_plain; K4 median {out['k4_median_ms']:.4f} "
          f"ms, levels median {out['levels_median_ms']:.4f} ms over {rounds} rounds of "
          f"{ITERS}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
