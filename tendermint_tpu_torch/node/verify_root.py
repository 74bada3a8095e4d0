"""The configuration root of the verify path.

Counterpart of the ``[verify]`` wiring in the JAX package's node
(``node/node.py:172-191``): one call takes a ``VerifyConfig`` and

  1. resolves the device (``cuda`` unless the caller passes ``"cpu"``;
     with no device given and no CUDA present it raises
     ``NoCudaDeviceError``) and validates the knobs (``ed25519_path`` is
     "ladder" or "msm");
  2. builds every kernel the path launches (K1, K2, K3, K4 for the MSM
     path, whichever path is configured: ``TM_ED25519_PATH`` can switch it
     later, and K5 and K6 for a verifier given a mesh) with
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
section with its WAL and its batched CheckTx signature hook
(``node/node.py:200-219`` and ``:263-283``), and ``block_executor(...)`` the evidence pool and the
block executor that owns that mempool (``node/node.py:220-230``), whose
``apply_block`` verifies each LastCommit through the installed verifier,
``blockchain_reactor(...)`` the fast-sync reactor over them
(``node/node.py:400-406``), whose windows go to the installed verifier,
``handshake(...)`` the ABCI handshake that brings the app up to the stores
(``node/node.py:105-110``), and ``consensus_state(...)`` the consensus state
machine over them with its WAL, event bus and the ``[verify]`` vote feed
(``node/node.py:225-262``) and its ``[instrumentation]`` section's flight
recorder, liveness watchdog and telemetry spool (``:286-326``,
``:652-667``), and ``state_sync(...)`` the ``[statesync]``
section's snapshot store, producer and reactor (``node/node.py:84-101``,
``:393-429``), whose restore verifies its trust hops through the installed
verifier and its backfill through the installed device executor, and
hands the restored state to the fast-sync reactor (``:560-570``).

``switch(...)`` builds the node's p2p switch from the ``[p2p]`` section
(``node/node.py:461-540``: the ``MConnection`` settings, the ``NodeInfo``,
the ``MultiplexTransport`` and the ``Switch``), ``add_reactor`` registers a
reactor on it and advertises its channels, ``consensus_reactor(...)`` is the
consensus reactor over a consensus state (``:397``), and ``start_switch``
listens, starts the switch and its reactors and dials ``persistent_peers``
as persistent peers (``:636-645``). A consensus state built with the switch
gives it to its liveness watchdog, whose stall report then names peers.

``mempool_reactor(...)`` is the mempool's gossip reactor with its
``[mempool]`` QoS gate (``node/node.py:430-435``), ``evidence_reactor(...)``
the evidence pool's (``:436-439``), and ``node_reactors(...)`` the node's
whole reactor set on a switch as ``:380-441`` builds it and ``:551-558``
registers it: a node with no block and ``[statesync] enable`` restores from
a snapshot, hands off to fast sync and then to consensus; any other node
fast-syncs (unless it is the only validator) or, with ``fast_sync`` off,
starts consensus at once. ``pex_reactor(...)`` is the peer exchange and its
address book when ``[p2p] pex`` is on (``:442-477``), which the node
registers after that set (``:557-558``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple, Optional

import torch

from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
from tendermint_tpu_torch.config.consensus import ConsensusConfig
from tendermint_tpu_torch.config.instrumentation import InstrumentationConfig
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.config.p2p import P2PConfig
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.wal import WAL
from tendermint_tpu_torch.crypto import batch as _batch
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
from tendermint_tpu_torch.libs.autofile import Group
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.libs.metrics import TelemetryMetrics
from tendermint_tpu_torch.libs.telemetry import TelemetrySpool
from tendermint_tpu_torch.libs.watchdog import LivenessWatchdog
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.mempool.tx_verify import BatchTxVerifier
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.p2p.conn.connection import MConnConfig
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.pex import AddrBook, PEXReactor
from tendermint_tpu_torch.p2p.node_info import NodeInfo, ProtocolVersion
from tendermint_tpu_torch.p2p.switch import Switch, SwitchConfig
from tendermint_tpu_torch.p2p.transport import MultiplexTransport
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state_types import State
from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
from tendermint_tpu_torch.statesync.store import SnapshotStore
from tendermint_tpu_torch.statesync.syncer import StateSyncer
from tendermint_tpu_torch.types.events import EventBus

# the kernels of the verify path: K1 and K2 (ed25519), K3 (secp256k1), K4
# (the ed25519 MSM path), K5 and K6 (a verifier's mesh route)
PATH_KERNELS = ("ed25519_prologue", "ed25519_ladder", "secp256k1_ladder", "ed25519_msm",
                "ed25519_verify", "secp256k1_verify")


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


def install_host_verify() -> None:
    """Verify on the host from here on: ``HostBatchVerifier`` as the
    installed verifier and a device executor that runs each window on it
    (the CPU tests' nets: the plain versions crawl under a running node's
    threads). ``reset_verify`` undoes it."""

    def host_executor(plan, mesh=None):
        return planner._execute_host(plan, _batch.HostBatchVerifier())

    _batch.set_batch_verifier(_batch.HostBatchVerifier())
    planner.set_device_executor(host_executor)


def host_verify_requested(device: DeviceLike) -> bool:
    """Whether ``TM_BATCH_VERIFIER=host`` asks for the host verifier, as the
    reference's multi-process tests set it (``tests/test_localnet.py:25``).
    Accepted only off the card: with ``device`` not the CPU it raises
    ``ValueError``, so that no environment variable moves a card process
    onto the host."""
    if os.environ.get("TM_BATCH_VERIFIER", "").lower() != "host":
        return False
    if device is None or torch.device(device).type != "cpu":
        raise ValueError(
            f"TM_BATCH_VERIFIER=host asks for the host verifier, but the device is "
            f"{device or 'cuda'}: it is accepted only with --device cpu")
    return True


def host_verify_from_env(device: DeviceLike) -> bool:
    """``install_host_verify`` when ``host_verify_requested(device)``; called
    after the root is configured. True if it installed it."""
    if not host_verify_requested(device):
        return False
    install_host_verify()
    return True


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
            device: DeviceLike = None, root_dir: str = "") -> MempoolRoot:
    """The node's mempool from the ``[mempool]`` section: ``Mempool`` on
    ``proxy_app.mempool`` (a started ``proxy/app_conn.MultiAppConn``) at
    ``height``; and when ``tx_batch_window_ms > 0`` and ``app`` publishes a
    ``tx_sig_extractor``, a ``planner.TxFeed(window_s=ms / 1000,
    max_rows=tx_batch_rows, device=device)`` behind a ``BatchTxVerifier``
    keyed by the mempool's height, installed as the verdict-bearing hook.
    On the card with no verifier given, the feed's flushes run the
    installed verifier (the root's guarded one). ``checktx_batch_wait`` is
    the Mempool's own knob (the reference's node leaves it at its default).
    With a ``root_dir`` and a ``wal_path`` the mempool writes its WAL, a
    ``libs/autofile.Group`` at ``<root_dir>/<wal_path>`` (node.go's
    InitWAL); without a root there is none, as in the reference. A remote
    app (``proxy_app`` on a socket) publishes no extractor: ``app`` is None
    and its CheckTx verifies in the app."""
    cfg = cfg if cfg is not None else MempoolConfig()
    wal = None
    if root_dir and cfg.wal_path:
        wal = Group(os.path.join(root_dir, cfg.wal_path))
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
        wal_group=wal,
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
    is called once the pool is caught up; ``metrics``, where given, needs
    only ``fast_syncing`` and ``reset_block_timer()``."""
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
    # unstarted; None when [instrumentation] turns them off
    watchdog: Optional[LivenessWatchdog] = None
    telemetry_spool: Optional[TelemetrySpool] = None


def consensus_state(cfg: Optional[ConsensusConfig], verify_cfg: Optional[VerifyConfig],
                    state: State, block_exec: BlockExecutor, block_store, mempool,
                    evidence_pool, *, wal_file: Optional[str] = None, event_bus=None,
                    priv_validator=None, metrics=None,
                    device: DeviceLike = None,
                    instrumentation: Optional[InstrumentationConfig] = None,
                    node_id: str = "", root_dir: Optional[str] = None,
                    switch: Optional[Switch] = None,
                    telemetry_metrics: Optional[TelemetryMetrics] = None) -> ConsensusRoot:
    """The node's consensus state machine (``node/node.py:225-262``) from
    the ``[consensus]`` section over ``block_exec``
    (``block_executor(...).block_executor``), ``block_store``, ``mempool``
    and ``evidence_pool``, starting from ``state``: its WAL at ``wal_file``
    (None: no WAL), ``event_bus`` (default the executor's, else a new one,
    started), ``priv_validator``, and the ``[verify]`` vote feed
    (``vote_feed(verify_cfg, device)``) set with ``set_vote_feed`` when
    ``vote_batch_window_ms > 0``: live peer votes then verify through it, on
    the card through the installed guarded verifier (K1 + K2, K3).

    The ``[instrumentation]`` section (default ``InstrumentationConfig()``)
    names the state's flight recorder ``node_id`` and enables it when
    ``flight_recorder`` is on (``TM_FLIGHT`` may have already); builds a
    ``LivenessWatchdog`` over the state and ``switch`` (``switch(...)``'s)
    when ``watchdog`` is on (its stall report names the missing validators
    and their power, and with a switch each peer and the age of its last
    receive); and builds a ``TelemetrySpool`` at
    ``telemetry_spool_path`` (relative to ``root_dir``) when
    ``telemetry_spool`` is on, whose snapshots carry its own status. The
    caller starts the state machine, the watchdog and the spool, stops
    them, and closes the feed after stopping the state machine. ``metrics``
    is a ``libs/metrics.ConsensusMetrics`` or the node's ``NodeMetrics``
    (whose consensus series have the same names); the spool writes
    ``telemetry_metrics`` (the node's ``NodeMetrics.telemetry``), default a
    ``libs/metrics.TelemetryMetrics`` on ``metrics``' registry."""
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
    inst = instrumentation if instrumentation is not None else InstrumentationConfig()
    cs.flight.node_id = node_id
    if inst.flight_recorder:
        cs.flight.enable()
    watchdog = None
    if inst.watchdog:
        watchdog = LivenessWatchdog(cs, switch=switch, metrics=metrics,
                                    interval=inst.watchdog_interval,
                                    stall_factor=inst.watchdog_stall_factor,
                                    min_stall_seconds=inst.watchdog_min_stall_seconds)
    spool = None
    if inst.telemetry_spool:
        path = inst.telemetry_spool_path
        if not os.path.isabs(path):
            if root_dir is None:
                raise ValueError(
                    f"telemetry_spool_path {path!r} is relative and no root_dir is given")
            path = os.path.join(root_dir, path)
        spool = TelemetrySpool(
            path, node_id=node_id,
            interval_heights=inst.telemetry_spool_interval_heights,
            interval_seconds=inst.telemetry_spool_interval_seconds,
            head_size_limit=inst.telemetry_spool_head_size_limit,
            total_size_limit=inst.telemetry_spool_total_size_limit,
            ring_capacity=inst.telemetry_spool_ring_capacity,
            metrics=(telemetry_metrics if telemetry_metrics is not None
                     else TelemetryMetrics(metrics.registry) if metrics is not None else None),
            height_fn=lambda: cs.rs.height,
        )
        spool.set_source("spool", spool.status)
    return ConsensusRoot(cs, bus, feed, wal, watchdog, spool)


class StateSyncRoot(NamedTuple):
    reactor: StateSyncReactor
    syncer: Optional[StateSyncer]  # None: this node serves and does not restore
    snapshot_store: SnapshotStore


def snapshot_store(cfg: Optional[StateSyncConfig], db=None, app=None) -> Optional[SnapshotStore]:
    """The ``[statesync]`` section's snapshot store (``node/node.py:84-103``):
    None when ``enable`` is off and ``snapshot_interval`` is 0; else a
    ``SnapshotStore`` over ``db`` (default a new ``MemDB``) and, when
    ``snapshot_interval > 0``, ``app.configure_snapshots`` at the section's
    interval, chunk size, keep count and format."""
    cfg = cfg if cfg is not None else StateSyncConfig()
    if not cfg.enable and cfg.snapshot_interval <= 0:
        return None
    store = SnapshotStore(db if db is not None else MemDB())
    if cfg.snapshot_interval > 0 and hasattr(app, "configure_snapshots"):
        app.configure_snapshots(store, cfg.snapshot_interval, cfg.snapshot_chunk_size,
                                cfg.snapshot_keep_recent, snapshot_format=cfg.snapshot_format)
    return store


def state_sync(cfg: Optional[StateSyncConfig], genesis_doc, proxy_app, state: State,
               state_db, block_store, *, app=None, mempool=None,
               blockchain_reactor=None, metrics=None,
               snapshots: Optional[SnapshotStore] = None) -> Optional[StateSyncRoot]:
    """The node's state sync from the ``[statesync]`` section; None when
    ``enable`` is off and ``snapshot_interval`` is 0.

    The serving side (``node/node.py:84-101``): ``snapshots`` when given
    (a ``snapshot_store(...)`` the caller built, as the node does before
    its handshake), else ``snapshot_store(cfg, app=app)`` over a new
    ``MemDB``. The restoring side
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
    store = snapshots if snapshots is not None else snapshot_store(cfg, app=app)
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


def _listen_host_port(laddr: str) -> str:
    return laddr[len("tcp://"):] if laddr.startswith("tcp://") else laddr


def switch(cfg: Optional[P2PConfig], node_key: NodeKey, chain_id: str, *, metrics=None,
           moniker: str = "node") -> Switch:
    """The node's p2p switch from the ``[p2p]`` section (``node/node.py:461-540``):
    the ``MConnection`` settings (``send_rate``, ``recv_rate``,
    ``max_packet_msg_payload_size``, ``flush_throttle_timeout``), a
    ``MultiplexTransport`` for ``node_key`` with the section's handshake and
    dial deadlines, and a ``Switch`` with its peer caps and
    ``allow_duplicate_ip``, and the ``NodeInfo`` (network ``chain_id``);
    ``add_reactor`` registers reactors and advertises their channels.
    ``metrics`` is the node's ``libs/metrics.NodeMetrics``. The peer
    exchange is a reactor of its own (``pex_reactor``). Unstarted:
    ``start_switch`` listens, starts it and dials the persistent peers."""
    cfg = cfg if cfg is not None else P2PConfig()
    mconfig = MConnConfig(
        send_rate=cfg.send_rate,
        recv_rate=cfg.recv_rate,
        max_packet_msg_payload_size=cfg.max_packet_msg_payload_size,
        flush_throttle=cfg.flush_throttle_timeout,
    )
    node_info = NodeInfo(
        protocol_version=ProtocolVersion(),
        id=node_key.id(),
        listen_addr=_listen_host_port(cfg.laddr),
        network=chain_id,
        version="tpu-0.1.0",
        channels=b"",
        moniker=moniker,
    )
    transport = MultiplexTransport(node_info, node_key, handshake_timeout=cfg.handshake_timeout,
                                   dial_timeout=cfg.dial_timeout)
    sw = Switch(
        transport,
        SwitchConfig(
            max_num_inbound_peers=cfg.max_num_inbound_peers,
            max_num_outbound_peers=cfg.max_num_outbound_peers,
            allow_duplicate_ip=cfg.allow_duplicate_ip,
        ),
        mconfig,
        metrics=metrics,
    )
    return sw


def add_reactor(sw: Switch, name: str, reactor) -> None:
    """Register ``reactor`` on ``sw`` (before it starts) and advertise every
    registered channel in its ``NodeInfo`` (``makeNodeInfo``, node.go:785: a
    peer drops traffic on channels a node does not advertise)."""
    sw.add_reactor(name, reactor)
    sw.transport.node_info = dataclasses.replace(
        sw.transport.node_info, channels=bytes(d.id for d in sw._chan_descs))


def pex_reactor(cfg: Optional[P2PConfig], root_dir: str = "") -> tuple:
    """The peer exchange when the ``[p2p]`` section turns ``pex`` on
    (``node/node.py:442-477``): an ``AddrBook`` at ``addr_book_file`` under
    ``root_dir`` (in memory without one) with ``addr_book_strict``, and a
    ``PEXReactor`` over it that starts from ``seeds`` and crawls in
    ``seed_mode``. Returns (book, reactor), or (None, None) with ``pex``
    off. The reactor sweeps every ``ensure_period`` seconds (the
    reference's 30 s); ``add_reactor`` registers it on channel 0x00."""
    cfg = cfg if cfg is not None else P2PConfig()
    if not cfg.pex:
        return None, None
    book = AddrBook(cfg.addr_book_path(root_dir) if root_dir else None,
                    strict=cfg.addr_book_strict)
    seeds = [NetAddress.parse(s) for s in cfg.seeds.split(",") if s.strip()]
    return book, PEXReactor(book, seeds=seeds, seed_mode=cfg.seed_mode)


def consensus_reactor(consensus_state: ConsensusState, fast_sync: bool = False,
                      metrics=None) -> ConsensusReactor:
    """The node's consensus reactor (``node/node.py:397``) over
    ``consensus_state`` (``consensus_state(...).consensus_state``): it
    starts the state machine when it starts, unless ``fast_sync`` defers
    that to ``switch_to_consensus``. Peers' proposals, parts and votes go to
    the state's receive queue: each gossiped vote through its ``[verify]``
    vote feed when one is set. ``metrics`` is the node's
    ``libs/metrics.NodeMetrics``, which counts the vote sightings by peer."""
    return ConsensusReactor(consensus_state, fast_sync=fast_sync, metrics=metrics)


def listen(sw: Switch, cfg: Optional[P2PConfig] = None) -> NetAddress:
    """Bind the ``[p2p]`` section's ``laddr`` (port 0 takes a free port) and
    advertise the bound address in the switch's ``NodeInfo``. Returns the
    address peers dial (``id@host:port``)."""
    cfg = cfg if cfg is not None else P2PConfig()
    addr = sw.transport.listen(_listen_host_port(cfg.laddr))
    sw.transport.node_info = dataclasses.replace(
        sw.transport.node_info, listen_addr=f"{addr.host}:{addr.port}")
    return addr


def start_switch(sw: Switch, cfg: Optional[P2PConfig] = None) -> None:
    """What the node's start does with its switch (``node/node.py:636-645``):
    listen on ``laddr`` unless ``listen`` already has, start the switch
    (and with it its reactors: the consensus reactor starts the state
    machine), then dial every ``persistent_peers`` address but our own with
    ``dial_peers_async(persistent=True)``, so a dropped peer is redialed."""
    cfg = cfg if cfg is not None else P2PConfig()
    if sw.transport.listen_address is None:
        listen(sw, cfg)
    sw.start()
    addrs = [NetAddress.parse(a) for a in cfg.persistent_peers.split(",") if a.strip()]
    addrs = [a for a in addrs if a.id != sw.node_id]
    if addrs:
        sw.dial_peers_async(addrs, persistent=True)


def mempool_reactor(cfg: Optional[MempoolConfig], mempool: Mempool, consensus_reactor=None,
                    metrics=None) -> MempoolReactor:
    """The node's mempool gossip reactor (``node/node.py:430-435``) over
    ``mempool`` (``mempool(...).mempool``): a broadcast walker a peer that
    holds a tx back while the peer's height (``consensus_reactor.peer_height``)
    lags it, and with ``[mempool] qos_enabled`` (the default) the QoS gate on
    every received tx before ``check_tx``. A received
    tx's CheckTx runs the mempool's verdict hook, on the card the installed
    guarded verifier (K1 + K2, K3). ``metrics`` is the node's
    ``libs/metrics.NodeMetrics`` (the ``mempool_qos_*`` series)."""
    cfg = cfg if cfg is not None else MempoolConfig()
    lookup = consensus_reactor.peer_height if consensus_reactor is not None else None
    return MempoolReactor(mempool, peer_height_lookup=lookup, config=cfg, metrics=metrics)


def evidence_reactor(evidence_pool: EvidencePool, consensus_reactor=None) -> EvidenceReactor:
    """The node's evidence gossip reactor (``node/node.py:436-439``) over
    ``evidence_pool`` (``block_executor(...).evidence_pool``): a walker a peer
    that holds evidence back while the peer is below its height (or its
    height is unknown) by ``consensus_reactor.peer_height``. Evidence is
    verified on the host, as in the reference."""
    lookup = consensus_reactor.peer_height if consensus_reactor is not None else None
    return EvidenceReactor(evidence_pool, peer_height_lookup=lookup)


class NodeReactors(NamedTuple):
    consensus: ConsensusReactor
    blockchain: BlockchainReactor
    mempool: MempoolReactor
    evidence: EvidenceReactor
    statesync: Optional[StateSyncRoot]  # None: [statesync] enable off and no snapshots
    fast_sync: bool  # the node fast-syncs from its start
    restoring: bool  # the node restores a snapshot first


def node_reactors(sw: Switch, consensus_state: ConsensusState, state: State, block_exec,
                  block_store, mempool: Mempool, evidence_pool: EvidencePool, *,
                  genesis_doc, proxy_app, state_db, app=None, priv_validator=None,
                  fast_sync: bool = True, mempool_cfg: Optional[MempoolConfig] = None,
                  statesync_cfg: Optional[StateSyncConfig] = None, metrics=None,
                  statesync_metrics=None,
                  snapshots: Optional[SnapshotStore] = None) -> NodeReactors:
    """The node's reactor set on ``sw`` (``switch(...)``, unstarted), as
    ``node/node.py:380-441`` builds it and ``:551-558`` registers it, each
    channel advertised (``add_reactor``):

    * ``fast_sync`` is off when the only validator is ``priv_validator``
      (``:386-390``: there is no one to sync from);
    * ``restoring`` = ``statesync_cfg.enable`` and ``state`` holds no block;
    * the consensus reactor over ``consensus_state``
      (``consensus_state(...).consensus_state``) defers the state machine
      while the node fast-syncs or restores (``fast_sync or restoring``);
    * the fast-sync reactor (``blockchain_reactor``) starts its pool only
      for ``fast_sync and not restoring``: a restore hands it the restored
      state (``start_from_statesync``);
    * the state sync reactor (``state_sync``) when ``enable`` is on or
      ``snapshot_interval > 0``;
    * the mempool and evidence reactors, holding back by the consensus
      reactor's ``peer_height``.

    Registered in the reference's order: consensus, blockchain, mempool,
    evidence, statesync. A joining node's device work goes to the installed
    verifier and device executor: the trust hops (K1 + K2), the backfill
    (K1 + K2 + the K7 tally), the fast-sync windows and the LastCommit
    checks (K1 + K2, K3), the vote feed's flushes. ``metrics`` is the node's
    ``NodeMetrics``; ``statesync_metrics`` a ``StateSyncMetrics``;
    ``snapshots`` the node's ``snapshot_store(...)`` (default one over a
    new ``MemDB``)."""
    ss_cfg = statesync_cfg if statesync_cfg is not None else StateSyncConfig()
    if fast_sync and state.validators.size == 1 and priv_validator is not None:
        if priv_validator.get_pub_key().address() == state.validators.validators[0].address:
            fast_sync = False
    restoring = bool(ss_cfg.enable) and state.last_block_height == 0
    cons = consensus_reactor(consensus_state, fast_sync=fast_sync or restoring, metrics=metrics)
    bc = blockchain_reactor(state.copy(), block_exec, block_store,
                            fast_sync=fast_sync and not restoring, consensus_reactor=cons)
    ss = state_sync(ss_cfg, genesis_doc, proxy_app, state, state_db, block_store, app=app,
                    mempool=mempool, blockchain_reactor=bc, metrics=statesync_metrics,
                    snapshots=snapshots)
    mr = mempool_reactor(mempool_cfg, mempool, cons, metrics=metrics)
    er = evidence_reactor(evidence_pool, cons)
    add_reactor(sw, "consensus", cons)
    add_reactor(sw, "blockchain", bc)
    add_reactor(sw, "mempool", mr)
    add_reactor(sw, "evidence", er)
    if ss is not None:
        add_reactor(sw, "statesync", ss.reactor)
    return NodeReactors(cons, bc, mr, er, ss, fast_sync and not restoring, restoring)
