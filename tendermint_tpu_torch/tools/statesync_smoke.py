"""State-sync smoke: the port's counterpart of the reference's
``scripts/statesync_smoke.py`` (``make statesync-smoke``).

    python3 -m tendermint_tpu_torch.tools.statesync_smoke               # the card
    python3 -m tendermint_tpu_torch.tools.statesync_smoke --device cpu

Runs the whole restore path in one process:

  1. build a 13-height chain whose kvstore app publishes snapshots every 4
     heights into a SnapshotStore (``chunk_size=48``);
  2. start a serving StateSyncReactor over that store and a fresh restoring
     node (StateSyncer + StateSyncReactor) wired through
     ``testutil/statesync``'s in-process hub;
  3. wait for the restore: snapshot discovery -> chunk fetch/verify ->
     light-client header check -> app-hash check -> the backfill of the
     trailing commits [9..12] -> hand-off state;
  4. scrape a NodeMetrics registry and require the tendermint_statesync_*
     series with the values this restore produced (the gauges as set, the
     counters and histograms grown by this run), then lint the exposition
     with ``tools/metrics_lint``.

On ``--device`` (default ``cuda``; ``tools/smoke_verify``): on the card the
chain's LastCommit checks and the trust hop go to the root's guarded
verifier (K1 + K2) and the backfill to its guarded executor (K1 + K2 + the
K7 tally), and the run must reach the card; ``cpu`` verifies on the host.
Exit 0 means the pipeline works end to end on this machine.
"""

from __future__ import annotations

import argparse
import sys
import time

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.examples.kvstore import PersistentKVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.metrics import NodeMetrics, get_statesync_metrics
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.statesync import chunker
from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
from tendermint_tpu_torch.statesync.store import SnapshotStore
from tendermint_tpu_torch.statesync.syncer import StateSyncer
from tendermint_tpu_torch.testutil.chain import build_chain
from tendermint_tpu_torch.testutil.consensus import wait_for
from tendermint_tpu_torch.testutil.statesync import HubSwitch, hub_connect
from tendermint_tpu_torch.tools.metrics_lint import lint_text
from tendermint_tpu_torch.tools.smoke_verify import SmokeVerify, finish

N_HEIGHTS = 13
SNAPSHOT_INTERVAL = 4
CHUNK_SIZE = 48
BACKFILL_BLOCKS = 4


class _Failed(Exception):
    pass


def _check(ok, what):
    if not ok:
        raise _Failed(what)
    print(f"  ok: {what}", flush=True)


def _restore() -> dict:
    # 1. the producer chain with snapshots at heights 4, 8, 12 (height 13
    # exists so header(13) carries the trusted app hash for the height-12
    # snapshot)
    snap_store = SnapshotStore(MemDB())
    producer_apps = []

    def app_factory():
        app = PersistentKVStoreApp()
        app.configure_snapshots(snap_store, SNAPSHOT_INTERVAL, chunk_size=CHUNK_SIZE)
        producer_apps.append(app)
        return app

    print(f"building the {N_HEIGHTS}-height producer chain ...", flush=True)
    fx = build_chain(n_vals=4, n_heights=N_HEIGHTS, chain_id="ss-smoke", txs_per_block=3,
                     app_factory=app_factory)
    for app in producer_apps:
        app.wait_snapshots()  # production is async off the commit thread
    top = N_HEIGHTS - 1
    snap = snap_store.get(top, chunker.SNAPSHOT_FORMAT)
    _check(snap is not None and snap.chunks >= 2,
           f"producer published a multi-chunk snapshot at height {top}")

    # 2. the restoring node, on the process-wide StateSyncMetrics so that
    # the NodeMetrics scrape below carries the real restore series
    metrics = get_statesync_metrics()
    before = _series(metrics)
    app2 = PersistentKVStoreApp()
    conn2 = MultiAppConn(LocalClientCreator(app2))
    conn2.start()
    state_db2, block_store2 = MemDB(), BlockStore(MemDB())
    cfg = StateSyncConfig(
        enable=True,
        trust_height=1,
        trust_hash=fx.block_store.load_block_meta(1).header.hash().hex(),
        discovery_time=0.25,
        chunk_fetch_timeout=5.0,
        chunk_retries=4,
        backfill_blocks=BACKFILL_BLOCKS,
    )
    syncer = StateSyncer(cfg, fx.chain_id, fx.genesis, conn2.query, state_db2, block_store2,
                         metrics=metrics)
    synced = []
    client = StateSyncReactor(cfg, app_query=conn2.query, block_store=block_store2,
                              state_db=state_db2, syncer=syncer,
                              on_synced=lambda st, h: synced.append(st), metrics=metrics)
    server = StateSyncReactor(StateSyncConfig(), snapshot_store=snap_store,
                              block_store=fx.block_store, state_db=fx.state_db)
    sw_client, sw_server = HubSwitch("smoke-client"), HubSwitch("smoke-server")
    sw_client.add_reactor("statesync", client)
    sw_server.add_reactor("statesync", server)
    client.start()
    server.start()
    hub_connect(sw_client, sw_server)

    print("restoring from the snapshot over the hub ...", flush=True)
    t0 = time.perf_counter()
    try:
        _check(wait_for(lambda: synced or syncer.device_fault is not None, 120.0, 0.05)
               and synced,
               f"restore finished (progress={client.progress()}, "
               f"device fault {syncer.device_fault!r})")
        restore_s = time.perf_counter() - t0
        state = synced[0]
        meta = fx.block_store.load_block_meta(N_HEIGHTS)
        _check(state.last_block_height == top, f"hand-off state at snapshot height {top}")
        _check(state.app_hash == meta.header.app_hash,
               "restored app hash matches the light-client-verified header")
        info = conn2.query.info_sync(abci.RequestInfo())
        _check(info.last_block_height == top
               and info.last_block_app_hash == meta.header.app_hash,
               "ABCI Info agrees with the verified header")
        base = top - BACKFILL_BLOCKS + 1
        _check(block_store2.height() == top and block_store2.base() == base,
               f"trailing commit window [{base}..{top}] backfilled")
    finally:
        client.stop()
        server.stop()
        conn2.stop()

    # 3. the restored node's scrape: tendermint_statesync_* present with
    # this run's values, and lintable
    print("scraping NodeMetrics ...", flush=True)
    after = _series(metrics)
    text = NodeMetrics().registry.expose_text()
    for series, want in (
        ("tendermint_statesync_syncing 0", "syncing gauge settled to 0"),
        (f"tendermint_statesync_snapshot_height {snap.height}", "snapshot height gauge"),
        (f"tendermint_statesync_chunks_applied {snap.chunks}", "chunks-applied gauge"),
        ('tendermint_statesync_chunk_fetch_total{outcome="ok"}', "chunk fetch counter"),
        ("tendermint_statesync_backfill_heights_count", "backfill window histogram"),
        ("tendermint_statesync_restore_seconds_count", "restore latency histogram"),
    ):
        _check(series in text, f"scrape carries {series.split(' ')[0]} ({want})")
    _check(after["fetch_ok"] - before["fetch_ok"] >= snap.chunks,
           f"this restore fetched {after['fetch_ok'] - before['fetch_ok']:g} chunks ok "
           f"(the snapshot has {snap.chunks})")
    _check(after["backfill"] == (before["backfill"][0] + 1,
                                 before["backfill"][1] + BACKFILL_BLOCKS),
           f"this restore observed one backfill window of {BACKFILL_BLOCKS} heights")
    _check(after["restores"] == before["restores"] + 1, "this restore observed its latency")
    errs = lint_text(text)
    for e in errs:
        print(f"  lint: {e}", file=sys.stderr)
    _check(not errs, "exposition passes metrics_lint")
    return {"heights": N_HEIGHTS, "snapshot": snap.height, "chunks": snap.chunks,
            "restore_s": restore_s}


def _series(m) -> dict:
    """The restore's counter and histogram totals in the process-wide
    ``StateSyncMetrics``: a run reads its own growth from them."""
    _, bf_sum, bf_n = m.backfill_heights._series[()]
    return {
        "fetch_ok": m.chunk_fetch._values.get(("ok",), 0.0),
        "backfill": (bf_n, bf_sum),
        "restores": m.restore_seconds._series[()][2],
    }


def run(argv=None) -> dict:
    """The smoke; returns {"ok", "failures", "seconds", "heights",
    "launches", ...}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's verify path) or cpu (the host)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out, failures = {}, []
    with SmokeVerify(args.device) as sv:
        try:
            out.update(_restore())
        except _Failed as e:
            failures.append(str(e))
        failures += sv.card_failures()
        out["launches"] = sv.launches()
        print(f"[statesync-smoke] verified {sv.summary()}", flush=True)
    return finish("statesync-smoke", out, failures, t0)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
