"""tm-bench — tx load generator + throughput stats
(ref: tools/tm-bench/main.go:21, statistics.go:132-141; the port's copy of
the reference package's ``tools/tm_bench.py``, over the port's RPC client).

Spams broadcast_tx_async at target rate over N connections for T seconds,
watches NewBlock events over the websocket, and reports Txs/sec and
Blocks/sec (avg/stddev/max) exactly like the reference's summary table.

Usage:
    python -m tendermint_tpu_torch.tools.tm_bench [-T 10] [-r 1000] [-c 1] \
        [--output-format plain|json] tcp://127.0.0.1:26657
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List

from tendermint_tpu_torch.rpc.client import HTTPClient, WSEventClient


def _spammer(addr: str, rate: int, duration: float, stop, sent_counter: List[int], idx: int):
    client = HTTPClient(addr)
    interval = 1.0 / max(1, rate)
    deadline = time.monotonic() + duration
    i = 0
    while time.monotonic() < deadline and not stop.is_set():
        tx = f"bench-{idx}-{i}-{os.getpid()}=x{time.monotonic_ns()}".encode()
        try:
            client.broadcast_tx_async(tx)
            sent_counter[idx] += 1
        except Exception:
            time.sleep(0.05)
            continue
        i += 1
        # pace toward the target rate (busy loops melt small nodes)
        next_at = deadline - duration + i * interval
        delay = next_at - time.monotonic()
        if delay > 0:
            time.sleep(delay)


def run_bench(
    addr: str, duration: float = 10.0, rate: int = 1000, connections: int = 1
) -> Dict:
    stop = threading.Event()
    sent = [0] * connections

    # watch blocks over WS while spamming
    ws = WSEventClient(addr)
    ws.subscribe("tm.event = 'NewBlock'")
    blocks: List[dict] = []

    def _watch():
        while not stop.is_set():
            try:
                ev = ws.next_event(timeout=0.5)
            except Exception:
                continue
            header = ev["data"]["value"]["block"]["header"]
            blocks.append(
                {"height": header["height"], "num_txs": header["num_txs"],
                 "at": time.monotonic()}
            )

    watcher = threading.Thread(target=_watch, daemon=True)
    watcher.start()

    threads = [
        threading.Thread(
            target=_spammer, args=(addr, rate // connections, duration, stop, sent, i),
            daemon=True,
        )
        for i in range(connections)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    time.sleep(1.0)  # drain the last block(s)
    stop.set()
    elapsed = time.monotonic() - t0
    ws.close()

    # per-second tallies (statistics.go groups per second)
    per_sec_txs: Dict[int, int] = defaultdict(int)
    per_sec_blocks: Dict[int, int] = defaultdict(int)
    for b in blocks:
        sec = int(b["at"] - t0)
        per_sec_txs[sec] += b["num_txs"]
        per_sec_blocks[sec] += 1
    secs = range(int(elapsed) + 1)
    tx_rates = [per_sec_txs.get(s, 0) for s in secs]
    block_rates = [per_sec_blocks.get(s, 0) for s in secs]

    def _stats(xs):
        if not xs:
            return {"avg": 0, "stddev": 0, "max": 0}
        avg = sum(xs) / len(xs)
        var = sum((x - avg) ** 2 for x in xs) / len(xs)
        return {"avg": round(avg, 3), "stddev": round(math.sqrt(var), 3), "max": max(xs)}

    return {
        "duration_s": round(elapsed, 2),
        "txs_sent": sum(sent),
        "txs_committed": sum(b["num_txs"] for b in blocks),
        "blocks_seen": len(blocks),
        "txs_per_sec": _stats(tx_rates),
        "blocks_per_sec": _stats(block_rates),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("endpoint", nargs="?", default="tcp://127.0.0.1:26657")
    p.add_argument("-T", "--duration", type=float, default=10.0)
    p.add_argument("-r", "--rate", type=int, default=1000)
    p.add_argument("-c", "--connections", type=int, default=1)
    p.add_argument("--output-format", choices=["plain", "json"], default="plain")
    args = p.parse_args(argv)

    stats = run_bench(args.endpoint, args.duration, args.rate, args.connections)
    if args.output_format == "json":
        print(json.dumps(stats))
    else:
        print("===")
        print(
            f"Txs/sec    avg {stats['txs_per_sec']['avg']}  "
            f"stddev {stats['txs_per_sec']['stddev']}  max {stats['txs_per_sec']['max']}"
        )
        print(
            f"Blocks/sec avg {stats['blocks_per_sec']['avg']}  "
            f"stddev {stats['blocks_per_sec']['stddev']}  max {stats['blocks_per_sec']['max']}"
        )
        print(
            f"(sent {stats['txs_sent']} txs, committed {stats['txs_committed']}, "
            f"{stats['blocks_seen']} blocks in {stats['duration_s']}s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
