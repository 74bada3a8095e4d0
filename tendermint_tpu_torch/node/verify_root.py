"""The configuration root of the verify path.

Counterpart of the ``[verify]`` wiring in the JAX package's node
(``node/node.py:172-191``): one call takes a ``VerifyConfig`` and

  1. resolves the device (``cuda`` unless the caller passes ``"cpu"``;
     with no device given and no CUDA present it raises
     ``NoCudaDeviceError``) and validates the knobs (``ed25519_path`` is
     "ladder" or "msm");
  2. builds every kernel the path launches (K1, K2, K3, and K4 for the
     MSM path, whichever path is configured: ``TM_ED25519_PATH`` can
     switch it later) with
     ``ops/_build.build_all`` before any guarded call, so that no first
     dispatch pays ``nvcc`` under the dispatch deadline (a build that ran
     into the deadline would become a timeout and a host fallback hiding
     the kernel); a build error raises out of here;
  3. configures the process-wide guard (``configure_device_guard``), the
     planner (``configure_planner``) and the process-wide verify path
     (``set_default_ed25519_path``, which the planner's executor and the
     commit window read);
  4. installs ``GuardedBatchVerifier(TorchBatchVerifier(device))`` as the
     default verifier (with the fe backend, carry schedule and verify path
     it records) and the planner's device executor on the same device.
     On the card both raise ``DeviceDispatchError`` where the reference
     would complete a failed dispatch on the host.

``vote_feed(cfg)`` builds the live-vote micro-batcher the reference's node
wires when ``[verify] vote_batch_window_ms > 0`` (``node/node.py:254-262``),
``mempool(cfg, proxy_app, app)`` the mempool of the ``[mempool]``
section with its batched CheckTx signature hook (``node/node.py:200-219``
and ``:263-283``), and ``block_executor(...)`` the evidence pool and the
block executor that owns that mempool (``node/node.py:220-230``), whose
``apply_block`` verifies each LastCommit through the installed verifier,
``blockchain_reactor(...)`` the fast-sync reactor over them
(``node/node.py:400-406``), whose windows go to the installed verifier,
``handshake(...)`` the ABCI handshake that brings the app up to the stores
(``node/node.py:105-110``), and ``consensus_state(...)`` the consensus state
machine over them with its WAL, event bus and the ``[verify]`` vote feed
(``node/node.py:225-262``), and ``state_sync(...)`` the ``[statesync]``
section's snapshot store, producer and reactor (``node/node.py:84-101``,
``:393-429``), whose restore verifies its trust hops through the installed
verifier and its backfill through the installed device executor, and
hands the restored state to the fast-sync reactor (``:560-570``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple, Optional

import torch

from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
from tendermint_tpu_torch.config.consensus import ConsensusConfig
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.wal import WAL
from tendermint_tpu_torch.crypto import batch as _batch
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.mempool.tx_verify import BatchTxVerifier
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state_types import State
from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
from tendermint_tpu_torch.statesync.store import SnapshotStore
from tendermint_tpu_torch.statesync.syncer import StateSyncer
from tendermint_tpu_torch.types.events import EventBus

# the kernels of the verify path: K1 and K2 (ed25519), K3 (secp256k1), K4
# (the ed25519 MSM path)
PATH_KERNELS = ("ed25519_prologue", "ed25519_ladder", "secp256k1_ladder", "ed25519_msm")


@dataclass
class VerifyRoot:
    device: torch.device
    verifier: _batch.GuardedBatchVerifier
    executor: Callable
    build_seconds: Dict[str, float] = field(default_factory=dict)


def configure_verify(cfg: Optional[VerifyConfig] = None,
                     device: DeviceLike = None) -> VerifyRoot:
    """Apply the ``[verify]`` section and install the guarded verify path;
    returns what was installed."""
    cfg = cfg if cfg is not None else VerifyConfig()
    dev = resolve_device(device)
    _batch._resolve_ed25519_path(cfg.ed25519_path)  # a bad value raises here
    _batch._choice(cfg.fe_backend, "vpu", _batch.FE_BACKENDS, "fe_backend")
    if str(cfg.planner_reduce or "device").lower() not in planner.REDUCE_MODES:
        raise ValueError(
            f"planner_reduce must be one of {planner.REDUCE_MODES}, "
            f"got {cfg.planner_reduce!r}")
    build_seconds = {}
    if dev.type == "cuda":
        build_seconds = _build.build_all(PATH_KERNELS)
        for name in PATH_KERNELS:
            _build.load(name)
    _brk.configure_device_guard(cfg)
    planner.configure_planner(cfg)
    _batch.set_default_ed25519_path(cfg.ed25519_path)
    # the verify path resolves as in the reference: TM_ED25519_PATH, then
    # the [verify] value just installed
    verifier = _batch.GuardedBatchVerifier(
        _batch.TorchBatchVerifier(dev, fe_backend=cfg.fe_backend))
    executor = planner.device_executor(dev)
    _batch.set_batch_verifier(verifier)
    planner.set_device_executor(executor)
    return VerifyRoot(dev, verifier, executor, build_seconds)


def reset_verify() -> None:
    """Uninstall what ``configure_verify`` installed and restore the
    guard's and the planner's defaults."""
    _batch.set_batch_verifier(None)
    planner.set_device_executor(None)
    _brk.reset_device_guard()
    planner.configure_planner(None)
    _batch.set_default_ed25519_path(None)


def vote_feed(cfg: Optional[VerifyConfig] = None,
              device: DeviceLike = None) -> Optional[planner.VoteFeed]:
    """The live-vote feed of the ``[verify]`` section: None when
    ``vote_batch_window_ms`` is 0, else ``VoteFeed(window_s=ms / 1000,
    max_rows=vote_batch_rows)``. On the card with no verifier given, its
    flushes run the installed verifier (the root's guarded one)."""
    cfg = cfg if cfg is not None else VerifyConfig()
    ms = float(cfg.vote_batch_window_ms or 0.0)
    if ms <= 0:
        return None
    return planner.VoteFeed(window_s=ms / 1000.0, max_rows=cfg.vote_batch_rows,
                            device=device)


class MempoolRoot(NamedTuple):
    mempool: Mempool
    feed: Optional[planner.TxFeed]  # None: the app verifies serially
    verifier: Optional[BatchTxVerifier]


def mempool(cfg: Optional[MempoolConfig], proxy_app, app, metrics=None, *,
            height: int = 0, checktx_batch_wait: float = 0.005,
            device: DeviceLike = None) -> MempoolRoot:
    """The node's mempool from the ``[mempool]`` section: ``Mempool`` on
    ``proxy_app.mempool`` (a started ``proxy/app_conn.MultiAppConn``) at
    ``height``; and when ``tx_batch_window_ms > 0`` and ``app`` publishes a
    ``tx_sig_extractor``, a ``planner.TxFeed(window_s=ms / 1000,
    max_rows=tx_batch_rows, device=device)`` behind a ``BatchTxVerifier``
    keyed by the mempool's height, installed as the verdict-bearing hook.
    On the card with no verifier given, the feed's flushes run the
    installed verifier (the root's guarded one). ``checktx_batch_wait`` is
    the Mempool's own knob (the reference's node leaves it at its default).
    The mempool WAL is not ported: a ``wal_path`` raises."""
    cfg = cfg if cfg is not None else MempoolConfig()
    if cfg.wal_path:
        raise NotImplementedError("the mempool WAL is not ported (wal_path must be empty)")
    mp = Mempool(
        proxy_app.mempool,
        height=height,
        size=cfg.size,
        cache_size=cfg.cache_size,
        recheck=cfg.recheck,
        metrics=metrics,
        lane_bounds=cfg.lane_bounds,
        checktx_batch=cfg.checktx_batch,
        checktx_batch_wait=checktx_batch_wait,
        recheck_batch=cfg.recheck_batch,
    )
    extractor = getattr(app, "tx_sig_extractor", None)
    if float(cfg.tx_batch_window_ms or 0.0) <= 0 or extractor is None:
        return MempoolRoot(mp, None, None)
    feed = planner.TxFeed(window_s=cfg.tx_batch_window_ms / 1000.0,
                          max_rows=cfg.tx_batch_rows, device=device)
    ver = BatchTxVerifier(feed, extractor, height_fn=mp.height)
    mp.set_batch_check_hook(ver, verdicts=True)
    return MempoolRoot(mp, feed, ver)


class ExecutorRoot(NamedTuple):
    evidence_pool: EvidencePool
    block_executor: BlockExecutor


def block_executor(state_db, evidence_db, proxy_app, mempool, state, event_bus=None,
                   metrics=None) -> ExecutorRoot:
    """The node's evidence pool over ``evidence_db`` and its
    ``BlockExecutor`` on ``proxy_app.consensus`` (a started
    ``MultiAppConn``), owning ``mempool`` (``mempool(...).mempool``) and
    publishing to ``event_bus``. The executor's verifier is None: each
    block's LastCommit goes to the installed verifier, on the card the
    configuration root's guarded one (K1 + K2, K3). ``metrics`` is a
    ``libs/metrics.StateMetrics``."""
    evpool = EvidencePool(state_db, evidence_db, state)
    return ExecutorRoot(evpool, BlockExecutor(state_db, proxy_app.consensus, mempool, evpool,
                                              event_bus, verifier=None, metrics=metrics))


def blockchain_reactor(state, block_exec, block_store, fast_sync: bool = True,
                       consensus_reactor=None, metrics=None) -> BlockchainReactor:
    """The node's fast-sync reactor (``node/node.py:400-406``) over
    ``block_exec`` (``block_executor(...).block_executor``) and
    ``block_store``, starting from ``state``. Its verifier is None and its
    window is sized by the set being verified: every window's commits go to
    the installed verifier, on the card the configuration root's guarded
    one (K1 + K2, K3). ``consensus_reactor.switch_to_consensus(state, n)``
    is called once the pool is caught up; ``metrics`` needs only
    ``fast_syncing`` and ``reset_block_timer()`` (the node's metrics are
    ROADMAP item 17)."""
    return BlockchainReactor(state, block_exec, block_store, fast_sync=fast_sync,
                             consensus_reactor=consensus_reactor, verifier=None,
                             verify_window=None, metrics=metrics)


def handshake(state_db, state: State, block_store, genesis_doc, proxy_app) -> State:
    """The node's ABCI handshake (``node/node.py:105-110``): the
    ``Handshaker`` replays the blocks that ``proxy_app``'s app (a started
    ``MultiAppConn``) misses from ``block_store`` and the saved state, and
    the state it returns is saved. A block that both the app and the state
    miss goes through ``apply_block`` (its LastCommit through the installed
    verifier)."""
    state = Handshaker(state_db, state, block_store, genesis_doc).handshake(proxy_app)
    sm_store.save_state(state_db, state)
    return state


class ConsensusRoot(NamedTuple):
    consensus_state: ConsensusState
    event_bus: EventBus
    vote_feed: Optional[planner.VoteFeed]  # None: peer votes verify serially
    wal: Optional[WAL]


def consensus_state(cfg: Optional[ConsensusConfig], verify_cfg: Optional[VerifyConfig],
                    state: State, block_exec: BlockExecutor, block_store, mempool,
                    evidence_pool, *, wal_file: Optional[str] = None, event_bus=None,
                    priv_validator=None, metrics=None,
                    device: DeviceLike = None) -> ConsensusRoot:
    """The node's consensus state machine (``node/node.py:225-262``) from
    the ``[consensus]`` section over ``block_exec``
    (``block_executor(...).block_executor``), ``block_store``, ``mempool``
    and ``evidence_pool``, starting from ``state``: its WAL at ``wal_file``
    (None: no WAL), ``event_bus`` (default the executor's, else a new one,
    started), ``priv_validator``, and the ``[verify]`` vote feed
    (``vote_feed(verify_cfg, device)``) set with ``set_vote_feed`` when
    ``vote_batch_window_ms > 0``: live peer votes then verify through it, on
    the card through the installed guarded verifier (K1 + K2, K3). The
    caller starts the state machine, and closes the feed after stopping it.
    ``metrics`` is a ``libs/metrics.ConsensusMetrics``."""
    cfg = cfg if cfg is not None else ConsensusConfig()
    if cfg.wait_for_txs():
        mempool.enable_txs_available()
    wal = WAL(wal_file, metrics=metrics) if wal_file else None
    cs = ConsensusState(cfg, state.copy(), block_exec, block_store, mempool, evidence_pool,
                        wal=wal, metrics=metrics)
    bus = event_bus if event_bus is not None else (block_exec.event_bus or EventBus())
    if not bus.is_running:
        bus.start()
    cs.set_event_bus(bus)
    if priv_validator is not None:
        cs.set_priv_validator(priv_validator)
    feed = vote_feed(verify_cfg, device=device)
    if feed is not None:
        cs.set_vote_feed(feed)
    return ConsensusRoot(cs, bus, feed, wal)


class StateSyncRoot(NamedTuple):
    reactor: StateSyncReactor
    syncer: Optional[StateSyncer]  # None: this node serves and does not restore
    snapshot_store: SnapshotStore


def state_sync(cfg: Optional[StateSyncConfig], genesis_doc, proxy_app, state: State,
               state_db, block_store, *, app=None, mempool=None,
               blockchain_reactor=None, metrics=None) -> Optional[StateSyncRoot]:
    """The node's state sync from the ``[statesync]`` section; None when
    ``enable`` is off and ``snapshot_interval`` is 0.

    The serving side (``node/node.py:84-101``): a ``SnapshotStore`` over
    a new ``MemDB`` (the port's only store) and, when
    ``snapshot_interval > 0``, ``app.configure_snapshots`` at the section's
    interval, chunk size, keep count and format. The restoring side
    (``:393-429``), when ``enable`` is on and ``state`` holds no block: a
    ``StateSyncer`` over ``proxy_app.query`` (a started ``MultiAppConn``),
    ``state_db`` and ``block_store`` whose trust hops go to the installed
    verifier and whose backfill goes to the installed device executor (on
    the card the configuration root's: K1 + K2, and K1 + K2 + the K7 tally).
    The ``StateSyncReactor``'s ``on_synced`` does what ``:560-570`` does:
    ``mempool.update(height, [])``, then
    ``blockchain_reactor.start_from_statesync(state)`` (the reactor of
    ``blockchain_reactor(..., fast_sync=False)``). The caller wires the
    reactor to its peers and starts it. ``metrics`` is a
    ``libs/metrics.StateSyncMetrics``."""
    cfg = cfg if cfg is not None else StateSyncConfig()
    if not cfg.enable and cfg.snapshot_interval <= 0:
        return None
    store = SnapshotStore(MemDB())
    if cfg.snapshot_interval > 0 and hasattr(app, "configure_snapshots"):
        app.configure_snapshots(store, cfg.snapshot_interval, cfg.snapshot_chunk_size,
                                cfg.snapshot_keep_recent, snapshot_format=cfg.snapshot_format)
    syncer = None
    if cfg.enable and state.last_block_height == 0:
        syncer = StateSyncer(cfg, genesis_doc.chain_id, genesis_doc, proxy_app.query, state_db,
                             block_store, metrics=metrics)

    def on_synced(restored: State, height: int) -> None:
        if mempool is not None:
            try:
                mempool.update(height, [])
            except Exception:
                logging.getLogger("statesync").exception(
                    "mempool height update after restore failed")
        if blockchain_reactor is not None:
            blockchain_reactor.start_from_statesync(restored)

    reactor = StateSyncReactor(cfg, app_query=proxy_app.query, snapshot_store=store,
                               block_store=block_store, state_db=state_db, syncer=syncer,
                               on_synced=on_synced, metrics=metrics)
    return StateSyncRoot(reactor, syncer, store)
