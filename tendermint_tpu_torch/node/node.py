"""Node — composition root wiring every service (ref: node/node.go:152-567;
the port's counterpart of the reference package's ``node/node.py``).

A node is started from a home directory (``config.base.root_dir``): its
stores under ``data/`` on ``db_backend`` (sqlite by default), its genesis
(``config/genesis.json``, then cached in the state store), its
``privval/file_pv.FilePV`` (or, with ``priv_validator_laddr``, the remote
signer that dials in: ``privval/remote_signer.py``), its node key, its
consensus WAL. The services
are assembled from the port's configuration root (``node/verify_root.py``)
in the reference's order: stores -> the three ABCI connections -> the
snapshot store -> the handshake -> the event bus and the tx indexer -> the
mempool (and its WAL) -> evidence and the block executor -> consensus
(WAL, vote feed, instruments) -> p2p (switch, the reactor set and, with
``[p2p] pex``, the peer exchange and its address book) -> the
RPC server, the light-client frontend and the gRPC broadcast API at
``rpc.grpc_laddr`` (started in ``on_start``). ``proxy_app`` names an app of
the node's process or a socket (``tcp://``, ``unix://``) or ``grpc://``
address of an app in another; a remote app publishes no CheckTx signature
extractor, so its CheckTx does not reach the card (the reference's rule). A node without
``p2p.laddr`` runs consensus alone (node.go:246-252's single-validator
path). The hand-off after a snapshot restore (the reference node's
``_on_statesync_complete``) is the ``on_synced`` of
``verify_root.state_sync``: the mempool's height, then fast sync.

The ``[verify]`` root (``verify_root.configure_verify``) is process-wide:
the first ``Node`` of a process configures it on ``device`` (``None``: the
card, and without one ``NoCudaDeviceError``; tests pass ``"cpu"``), and
every other ``Node`` alive in the process with an equal ``[verify]``
section and device reuses it; one with another section or device raises
``ValueError``. The root stays installed when the last node stops (the
reference's guard settings are process-global too); the next ``Node``
configures it again.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
from typing import Optional

from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.config import Config
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.libs.db.kv import new_db
from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.libs.telemetry import node_sources
from tendermint_tpu_torch.libs.watchdog import LivenessWatchdog
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.proxy.app_conn import (
    ClientCreator,
    MultiAppConn,
    default_client_creator,
)
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.txindex.kv import KVTxIndexer, NullTxIndexer, TxIndexerService
from tendermint_tpu_torch.types.events import EVENT_NEW_BLOCK, EventBus, query_for_event
from tendermint_tpu_torch.types.genesis import GenesisDoc

NODE_VERSION = "tpu-0.1.0"

# the process's [verify] root and the nodes that use it
_ROOT_MTX = threading.Lock()
_ROOT = {"root": None, "key": None, "nodes": 0}


def _acquire_root(cfg: VerifyConfig, device: DeviceLike) -> verify_root.VerifyRoot:
    """The process's ``[verify]`` root for a new node: configured by the
    first live node, reused by the others with an equal section and
    device."""
    dev = resolve_device(device)
    key = (dataclasses.astuple(cfg), str(dev))
    with _ROOT_MTX:
        if _ROOT["nodes"] > 0:
            if _ROOT["key"] != key:
                raise ValueError(
                    f"a Node of this process runs the [verify] root {_ROOT['key']}; a node "
                    f"with [verify] {key} cannot share it (one verify path a process)")
            _ROOT["nodes"] += 1
            return _ROOT["root"]
        root = verify_root.configure_verify(cfg, dev)
        _ROOT.update(root=root, key=key, nodes=1)
        return root


def _release_root() -> None:
    with _ROOT_MTX:
        _ROOT["nodes"] = max(0, _ROOT["nodes"] - 1)
        if _ROOT["nodes"] == 0:
            _ROOT.update(root=None, key=None)


def _abci_filter(proxy_app, path_prefix: str, timeout: float = 5.0):
    """A p2p filter that asks the app (``/p2p/filter/...`` queries, an OK
    code admits; node.go:383-421): a stalled query times out and rejects."""
    from tendermint_tpu_torch.abci import types as abci_t

    def f(value: str):
        out: "queue.Queue" = queue.Queue(1)

        def run():
            try:
                out.put(proxy_app.query.query_sync(
                    abci_t.RequestQuery(path=f"{path_prefix}/{value}")))
            except Exception as e:  # surfaced as rejection
                out.put(e)

        threading.Thread(target=run, daemon=True, name="abci-peer-filter").start()
        try:
            res = out.get(timeout=timeout)
        except queue.Empty:
            return "filter query timed out"
        if isinstance(res, Exception):
            return f"filter query failed: {res}"
        if res.code != abci_t.CODE_TYPE_OK:
            return f"rejected by app (code {res.code})"
        return None

    return f


def _signer_endpoint(base):
    """The node's end of the remote signer (``node/node.py:112-152``): a
    ``SignerValidatorEndpoint`` listening at ``base.priv_validator_laddr``,
    pinned to ``priv_validator_signer_pubkey`` (hex) when set (``tcp://``
    only: a unix socket has no authenticated handshake to pin), started, and
    returned once a signer has dialed in; when none dials within its
    deadline (``remote_signer.ACCEPT_DEADLINE``) it is stopped and
    ``RuntimeError`` raised."""
    from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
    from tendermint_tpu_torch.privval import remote_signer

    expected = None
    if base.priv_validator_signer_pubkey:
        if base.priv_validator_laddr.startswith("unix"):
            raise ValueError(
                "priv_validator_signer_pubkey requires a tcp:// priv_validator_laddr "
                "(unix sockets have no authenticated handshake to pin)")
        expected = PubKeyEd25519(bytes.fromhex(base.priv_validator_signer_pubkey))
    endpoint = remote_signer.SignerValidatorEndpoint(base.priv_validator_laddr,
                                                     expected_signer_pubkey=expected)
    endpoint.start()
    if not endpoint.wait_for_signer(remote_signer.ACCEPT_DEADLINE):
        try:
            endpoint.stop()
        except Exception:
            pass
        raise RuntimeError(
            f"no remote signer dialed {base.priv_validator_laddr} before the deadline")
    return endpoint


class Node(BaseService):
    def __init__(
        self,
        config: Config,
        priv_validator=None,
        client_creator: Optional[ClientCreator] = None,
        genesis_doc: Optional[GenesisDoc] = None,
        db_provider=None,
        *,
        device: DeviceLike = None,
        logger: Optional[logging.Logger] = None,
    ):
        super().__init__("Node", logger)
        self.config = config
        self._dbs = []  # the stores this node opened (closed if it fails to build)
        self.verify_root = _acquire_root(config.verify, device)
        self.device = self.verify_root.device
        self.proxy_app = None
        self._root_released = False
        self.signer_endpoint = None
        try:
            self._build(config, priv_validator, client_creator, genesis_doc, db_provider)
        except BaseException:
            for svc in (self.proxy_app, self.signer_endpoint):
                if svc is not None and svc.is_running:
                    svc.stop()
            self._close_dbs()
            self._release()
            raise

    def _build(self, config, priv_validator, client_creator, genesis_doc, db_provider) -> None:
        root = config.base.root_dir

        def _db(name: str):
            if db_provider is not None:
                return db_provider(name)
            db = new_db(name, config.base.db_backend, config.base.db_path())
            self._dbs.append(db)
            return db

        # stores
        self.block_store_db = _db("blockstore")
        self.block_store = BlockStore(self.block_store_db)
        self.state_db = _db("state")

        # genesis (cached in the state store like node.go:831-856)
        if genesis_doc is None:
            raw = self.state_db.get(b"genesisDoc")
            if raw is not None:
                genesis_doc = GenesisDoc.from_json(raw.decode())
            else:
                genesis_doc = GenesisDoc.from_file(config.base.genesis_path())
        self.state_db.set(b"genesisDoc", genesis_doc.to_json().encode())
        self.genesis_doc = genesis_doc
        state = sm_store.load_state_from_db_or_genesis(self.state_db, genesis_doc)

        # app connections
        creator = client_creator or default_client_creator(
            config.base.proxy_app, config.base.proxy_app)
        self.app = getattr(creator, "_app", None)
        self.proxy_app = MultiAppConn(creator)
        self.proxy_app.start()

        # the state-sync snapshot store (serves restoring peers; feeds the
        # producer when snapshot_interval > 0), before the handshake replays
        ss = config.statesync
        self.snapshot_store = (verify_root.snapshot_store(ss, _db("snapshots"), self.app)
                               if ss.enable or ss.snapshot_interval > 0 else None)

        # handshake: sync the app with the stores and the state
        state = verify_root.handshake(self.state_db, state, self.block_store, genesis_doc,
                                      self.proxy_app)

        # the remote signer when [base] priv_validator_laddr is set
        # (node.go:225-242: the node listens for the signer's dial-in)
        if config.base.priv_validator_laddr:
            self.signer_endpoint = priv_validator = _signer_endpoint(config.base)
        self.priv_validator = priv_validator

        # event bus + indexer
        self.event_bus = EventBus()
        if config.tx_index.indexer == "kv":
            self.tx_indexer = KVTxIndexer(_db("tx_index"))
        else:
            self.tx_indexer = NullTxIndexer()
        self.indexer_service = TxIndexerService(self.tx_indexer, self.event_bus)

        # metrics (node.go:100-113; scraped at the RPC server's /metrics)
        self.metrics = NodeMetrics() if config.instrumentation.prometheus else None
        if self.metrics is not None:
            m = self.metrics
            self.event_bus.set_on_drop(lambda client_id: m.pubsub_dropped.add(1.0, (client_id,)))

        # mempool (its [mempool] batched CheckTx hook), evidence, executor
        mp_root = verify_root.mempool(config.mempool, self.proxy_app, self.app, self.metrics,
                                      height=state.last_block_height, device=self.device,
                                      root_dir=root)
        self.mempool, self.tx_feed, self.tx_verifier = mp_root
        self.evidence_pool, self.block_exec = verify_root.block_executor(
            self.state_db, _db("evidence"), self.proxy_app, self.mempool, state,
            event_bus=self.event_bus, metrics=self.metrics)

        # p2p: the switch first, so that the watchdog names peers
        self.switch = None
        self.node_key = None
        if config.p2p.laddr:
            self.node_key = NodeKey.load_or_generate(config.base.node_key_path())
            self.switch = verify_root.switch(config.p2p, self.node_key, genesis_doc.chain_id,
                                             metrics=self.metrics, moniker=config.base.moniker)
            if config.base.filter_peers:
                self.switch.transport.conn_filters.append(
                    _abci_filter(self.proxy_app, "/p2p/filter/addr"))
                self.switch.peer_filters.append(_abci_filter(self.proxy_app, "/p2p/filter/id"))

        # consensus: WAL, the [verify] vote feed, the [instrumentation]
        wal_file = (os.path.join(root, config.consensus.wal_path)
                    if root and config.consensus.wal_path else None)
        self.consensus_root = verify_root.consensus_state(
            config.consensus, config.verify, state, self.block_exec, self.block_store,
            self.mempool, self.evidence_pool, wal_file=wal_file, event_bus=self.event_bus,
            priv_validator=priv_validator, metrics=self.metrics, device=self.device,
            instrumentation=config.instrumentation,
            node_id=self.node_key.id() if self.node_key is not None else config.base.moniker,
            root_dir=root, switch=self.switch,
            telemetry_metrics=self.metrics.telemetry if self.metrics is not None else None)
        self.consensus_state = self.consensus_root.consensus_state
        self.vote_feed = self.consensus_root.vote_feed
        self.watchdog: Optional[LivenessWatchdog] = self.consensus_root.watchdog
        self.telemetry_spool = self.consensus_root.telemetry_spool
        if self.telemetry_spool is not None:
            for name, fn in node_sources(self).items():
                self.telemetry_spool.set_source(name, fn)

        # the reactor set (node.go:372-471)
        self.reactors = None
        self.addr_book = self.pex_reactor = None
        self.consensus_reactor = None
        self.blockchain_reactor = None
        self.statesync_reactor = None
        self.mempool_reactor = None
        if self.switch is not None:
            self.reactors = verify_root.node_reactors(
                self.switch, self.consensus_state, state, self.block_exec, self.block_store,
                self.mempool, self.evidence_pool, genesis_doc=genesis_doc,
                proxy_app=self.proxy_app, state_db=self.state_db, app=self.app,
                priv_validator=priv_validator, fast_sync=config.base.fast_sync,
                mempool_cfg=config.mempool, statesync_cfg=config.statesync,
                metrics=self.metrics, snapshots=self.snapshot_store)
            self.consensus_reactor = self.reactors.consensus
            self.blockchain_reactor = self.reactors.blockchain
            self.mempool_reactor = self.reactors.mempool
            if self.reactors.statesync is not None:
                self.statesync_reactor = self.reactors.statesync.reactor
            # the peer exchange on channel 0x00, registered last as the
            # reference registers it (node.go:557-558)
            self.addr_book, self.pex_reactor = verify_root.pex_reactor(config.p2p, root)
            if self.pex_reactor is not None:
                verify_root.add_reactor(self.switch, "pex", self.pex_reactor)

        self.rpc_server = None
        self._rpc_env = None
        self.grpc_broadcast = None

        # [frontend]: multi-client light-client serving over this node's
        # own stores (lite/proxy.py LiteProxy + frontend/ package)
        self.frontend = None
        self.lite_server = None
        if config.frontend.enable:
            from tendermint_tpu_torch.lite.proxy import LiteProxy

            fe = config.frontend
            self.frontend = LiteProxy(
                genesis_doc.chain_id,
                trust_db=_db("lite_trust"),
                trusted_height=fe.trusted_height if fe.trusted_height > 0 else None,
                trusted_hash=bytes.fromhex(fe.trusted_hash) if fe.trusted_hash else None,
                block_store=self.block_store,
                state_db=self.state_db,
                batch_window_s=fe.batch_window_s,
                batch_max_rows=fe.batch_max_rows,
                cache_size=fe.cache_size,
                use_device=fe.use_device,
            )

    @classmethod
    def from_home(cls, home: str, config: Optional[Config] = None, client_creator=None,
                  *, device: DeviceLike = None) -> "Node":
        """The node of home directory ``home`` (``tendermint node``): its
        ``FilePV`` (``config/priv_validator.json``, made when missing), node
        key and genesis from ``config/``, its stores under ``data/``.
        ``config`` defaults to ``default_config()``; its root becomes
        ``home``."""
        from tendermint_tpu_torch.config.config import default_config
        from tendermint_tpu_torch.privval.file_pv import FilePV

        cfg = (config if config is not None else default_config()).set_root(home)
        pv = FilePV.load_or_generate(cfg.base.priv_validator_path())
        return cls(cfg, priv_validator=pv, client_creator=client_creator, device=device)

    # lifecycle -------------------------------------------------------------
    def on_start(self) -> None:
        if not self.event_bus.is_running:
            self.event_bus.start()
        self.indexer_service.start()
        if self.metrics is not None:
            sub = self.event_bus.subscribe(
                "node-metrics", query_for_event(EVENT_NEW_BLOCK), maxsize=100)
            threading.Thread(target=self._metrics_pump, args=(sub,), name="metrics-pump",
                             daemon=True).start()
        if self.config.rpc.laddr:
            from tendermint_tpu_torch.rpc.core.env import RPCEnv
            from tendermint_tpu_torch.rpc.server import RPCServer

            self._rpc_env = RPCEnv(self)
            self.rpc_server = RPCServer(self.config.rpc.laddr, self._rpc_env)
            self.rpc_server.start()
        if self.frontend is not None and self.config.frontend.laddr:
            from tendermint_tpu_torch.lite.proxy import serve_proxy

            self.lite_server = serve_proxy(self.frontend, self.config.frontend.laddr)
            threading.Thread(target=self.lite_server.serve_forever, name="lite-frontend",
                             daemon=True).start()
        if self.config.rpc.grpc_laddr:
            from tendermint_tpu_torch.abci.grpc import BroadcastAPIServer

            self.grpc_broadcast = BroadcastAPIServer(self.config.rpc.grpc_laddr, self)
            self.grpc_broadcast.start()
        if self.switch is not None:
            # the consensus reactor starts (or fast sync defers) the state
            # machine; persistent peers are dialed after listening
            verify_root.start_switch(self.switch, self.config.p2p)
            if self.metrics is not None:
                threading.Thread(target=self._p2p_metrics_pump, name="p2p-metrics",
                                 daemon=True).start()
        else:
            self.consensus_state.start()
        if self.watchdog is not None:
            self.watchdog.start()
        if self.telemetry_spool is not None:
            self.telemetry_spool.start()
        self.logger.info("node started chain_id=%s", self.genesis_doc.chain_id)

    def _metrics_pump(self, sub) -> None:
        while not self._quit.is_set():
            try:
                msg = sub.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                rs = self.consensus_state.get_round_state()
                self.metrics.record_block(msg.data.block, rs.validators)
            except Exception:
                pass

    def _p2p_metrics_pump(self) -> None:
        while True:
            try:
                self.metrics.peers.set(self.switch.peers.size())
                for peer in self.switch.peers.list():
                    self.metrics.set_peer_pending(peer.id, peer.pending_send_bytes())
                if self.blockchain_reactor is not None:
                    self.metrics.fast_syncing.set(1 if self.blockchain_reactor.fast_sync else 0)
            except Exception:
                pass
            if self._quit.wait(1.0):
                return

    def on_stop(self) -> None:
        # the spool first while the analyzers are still live: its stop()
        # writes one final "shutdown" snapshot closing the run's last leg
        for svc in (self.telemetry_spool, self.watchdog):
            if svc is not None:
                try:
                    svc.stop()
                except Exception:
                    self.logger.exception("stopping %s failed", type(svc).__name__)
        services = [self.switch] if self.switch is not None else []
        services += [self.consensus_state, self.rpc_server, self.grpc_broadcast,
                     self.indexer_service, self.event_bus, self.proxy_app,
                     self.signer_endpoint]
        for svc in services:
            if svc is None or not svc.is_running:
                continue
            try:
                svc.stop()
            except Exception:
                self.logger.exception("stopping %s failed", svc.name)
            if svc is self.consensus_state and svc._started:
                svc._done.wait(30.0)
        if self.lite_server is not None:
            try:
                self.lite_server.shutdown()
                self.lite_server.server_close()
            except Exception:
                pass
        if self._rpc_env is not None:
            self._rpc_env._close()
        for closer in (self.frontend, self.vote_feed, self.tx_feed):
            if closer is not None:
                try:
                    closer.close()
                except Exception:
                    pass
        if self.vote_feed is not None:
            self.vote_feed.join(30.0)
        # the stores stay open, as the reference's: a stopped node's chain
        # can still be read
        self._release()

    def _close_dbs(self) -> None:
        for db in self._dbs:
            try:
                db.close()
            except Exception:
                pass
        self._dbs = []

    def _release(self) -> None:
        if not self._root_released:
            self._root_released = True
            _release_root()

    # info -------------------------------------------------------------------
    def status(self) -> dict:
        """The reference's status. ``catching_up`` is the consensus
        reactor's fast-sync flag (Go's rule: on while the node restores a
        snapshot or fast-syncs, off once it runs consensus)."""
        rs = self.consensus_state.get_round_state()
        latest_height = self.block_store.height()
        meta = self.block_store.load_block_meta(latest_height) if latest_height else None
        pub = self.priv_validator.get_pub_key() if self.priv_validator else None
        vals = self.consensus_state.rs.validators
        return {
            "node_info": {
                "network": self.genesis_doc.chain_id,
                "moniker": self.config.base.moniker,
                "version": NODE_VERSION,
            },
            "sync_info": {
                "latest_block_height": latest_height,
                "latest_block_hash": meta.block_id.hash.hex().upper() if meta else "",
                "latest_app_hash": meta.header.app_hash.hex().upper() if meta else "",
                "latest_block_time_ns": meta.header.time_ns if meta else 0,
                "catching_up": (self.consensus_reactor.fast_sync
                                if self.consensus_reactor is not None else False),
            },
            "validator_info": {
                "address": pub.address().hex().upper() if pub else "",
                "voting_power": (
                    vals.get_by_address(pub.address())[1].voting_power
                    if pub and vals.has_address(pub.address()) else 0
                ),
            },
            "consensus_state": {
                "height": rs.height,
                "round": rs.round,
                "step": rs.step.name,
            },
        }


def init_home(home: str, genesis_doc: GenesisDoc, *, priv_key: Optional[PrivKeyEd25519] = None,
              node_key: Optional[NodeKey] = None):
    """Write a home directory (``tendermint init``): ``config/genesis.json``,
    ``config/priv_validator.json`` (a ``FilePV`` of ``priv_key``, default a
    new key), ``config/node_key.json`` (``node_key``, default a new one) and
    an empty ``data/``. Returns the ``FilePV``."""
    from tendermint_tpu_torch.config.config import BaseConfig
    from tendermint_tpu_torch.privval.file_pv import FilePV

    base = BaseConfig(root_dir=home)
    for d in (os.path.dirname(base.genesis_path()), base.db_path()):
        os.makedirs(d, exist_ok=True)
    genesis_doc.save_as(base.genesis_path())
    pv = FilePV(priv_key if priv_key is not None else PrivKeyEd25519.generate(),
                base.priv_validator_path())
    pv.save()
    (node_key if node_key is not None else NodeKey(PrivKeyEd25519.generate())).save_as(
        base.node_key_path())
    return pv
