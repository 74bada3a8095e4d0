"""SimNode: one full validator node assembled for the simulator; the port's
copy of the reference package's ``sim/node.py``.

Everything is real: ConsensusState + ConsensusReactor, Mempool +
MempoolReactor, EvidencePool + EvidenceReactor, BlockExecutor over a
kvstore ABCI app, per-node in-memory stores. Only the transport is
simulated (``p2p/inproc.py`` over a ``SimNet`` fabric) and the wall clock is
injectable (``sim/clock.py``).

Where the port differs: each node is wired through ``node/verify_root`` as
``testutil/consensus_net.build_node`` wires a node, not from bare feeds.
``verify_root.mempool`` gives the mempool its ``TxFeed`` and
``BatchTxVerifier`` when ``[mempool] tx_batch_window_ms > 0`` and the app
publishes a ``tx_sig_extractor``; ``verify_root.consensus_state`` gives the
state machine its ``[verify]`` vote feed when ``vote_batch_window_ms > 0``.
Both feeds take the node's ``device``: on the card (the default) their
flushes run the installed verifier, the configuration root's guarded one
(K1 + K2, K3), and so does every block's LastCommit check; with
``device="cpu"`` the feeds take the host RLC and ``build_sim_net`` installs
``HostBatchVerifier`` when nothing is installed, as the reference's does.
Every node of a process shares the installed verifier and its breaker.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.config import test_config
from tendermint_tpu_torch.config.instrumentation import InstrumentationConfig
from tendermint_tpu_torch.consensus.messages import VoteMessage, encode_msg
from tendermint_tpu_torch.consensus.reactor import VOTE_CHANNEL
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.crypto import batch as _batch
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.libs.watchdog import LivenessWatchdog
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.p2p.inproc import InProcSwitch
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.sim.byzantine import EquivocatingPV
from tendermint_tpu_torch.sim.clock import SimClock
from tendermint_tpu_torch.sim.simnet import SimNet
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.types.events import EventBus
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.priv_validator import MockPV

SIM_CHAIN_ID = "sim-chain"
SIM_GENESIS_TIME_NS = 1_700_000_000_000_000_000

# the flight recorder on (every sim node records), the watchdog left to
# SimNode.start_watchdog
SIM_INSTRUMENTATION = InstrumentationConfig(flight_recorder=True, watchdog=False)


def make_sim_genesis(n_vals: int, power: int = 10):
    """Deterministic genesis: seeded keys, fixed genesis time, identical
    across runs so commit hashes are comparable run-to-run."""
    pvs = [MockPV(PrivKeyEd25519.generate(bytes([i + 1]) * 32))
           for i in range(n_vals)]
    doc = GenesisDoc(
        chain_id=SIM_CHAIN_ID,
        genesis_time_ns=SIM_GENESIS_TIME_NS,
        validators=[GenesisValidator(pv.get_pub_key(), power) for pv in pvs],
    )
    doc.validate_and_complete()
    return doc, pvs


class SimNode:
    """One simulated validator: real consensus stack over the fabric, its
    feeds on ``device`` (None: the card)."""

    def __init__(self, index: int, node_id: str, doc: GenesisDoc, pv,
                 fabric: SimNet, config=None, app=None,
                 clock: Optional[SimClock] = None,
                 state_db=None, block_store=None,
                 wal_path: Optional[str] = None, handshake: bool = False,
                 device: DeviceLike = None):
        self.index = index
        self.node_id = node_id
        self.doc = doc
        self.pv = pv
        self.fabric = fabric
        self.clock = clock or SimClock()
        self.config = cfg = config or test_config()
        self.wal_path = wal_path
        self.device = resolve_device(device)

        # crash_restart hands back the dead node's stores: rebuild state
        # from the DB instead of genesis, and let the ABCI handshake
        # re-apply any blocks the (fresh) app is missing.
        if state_db is not None:
            self.state_db = state_db
            st = sm_store.load_state_from_db_or_genesis(self.state_db, doc)
        else:
            st = state_from_genesis(doc)
            self.state_db = MemDB()
            sm_store.save_state(self.state_db, st)
        self.block_store = (block_store if block_store is not None
                            else BlockStore(MemDB()))

        self.app = app or KVStoreApp()
        self.conn = MultiAppConn(LocalClientCreator(self.app))
        self.conn.start()
        self.handshake_blocks = 0
        if handshake:
            hs = Handshaker(self.state_db, st, self.block_store, doc)
            st = hs.handshake(self.conn)
            sm_store.save_state(self.state_db, st)
            self.handshake_blocks = hs.n_blocks
        # per-node registry so scenarios can assert on QoS/lane counters
        self.metrics = NodeMetrics()
        # [mempool] tx_batch_window_ms > 0 and an app with a
        # tx_sig_extractor: batched CheckTx signature ingest (exposed so
        # scenarios can assert dispatch counts)
        mp = verify_root.mempool(cfg.mempool, self.conn, self.app, metrics=self.metrics,
                                 device=self.device)
        self.mempool, self.tx_feed, self.tx_verifier = mp
        self.bus = EventBus()
        self.bus.start()
        self.evpool, block_exec = verify_root.block_executor(
            self.state_db, MemDB(), self.conn, self.mempool, st.copy(), event_bus=self.bus)
        # [verify] vote_batch_window_ms > 0: batched live-vote verification
        # (exposed so scenarios can assert the feed engaged)
        root = verify_root.consensus_state(
            cfg.consensus, cfg.verify, st, block_exec, self.block_store, self.mempool,
            self.evpool, wal_file=wal_path, event_bus=self.bus, priv_validator=pv,
            metrics=self.metrics, device=self.device, instrumentation=SIM_INSTRUMENTATION,
            node_id=node_id)
        self.cs, self.vote_feed = root.consensus_state, root.vote_feed
        if self.vote_feed is not None:
            # ticket stamps share the node's (possibly skewed) clock so
            # flush spans fuse onto the node's flight-record timeline
            self.vote_feed.now_ns = self.clock
        self.cs.now_ns = self.clock
        self.cs.flight.now_ns = self.clock

        self.reactor = verify_root.consensus_reactor(self.cs, metrics=self.metrics)
        self.mempool_reactor = MempoolReactor(
            self.mempool, peer_height_lookup=self.reactor.peer_height,
            config=cfg.mempool, metrics=self.metrics, now_ns=self.clock,
        )
        self.evidence_reactor = EvidenceReactor(
            self.evpool, peer_height_lookup=self.reactor.peer_height
        )
        self.switch = InProcSwitch(node_id, fabric)
        self.switch.add_reactor("consensus", self.reactor)
        self.switch.add_reactor("mempool", self.mempool_reactor)
        self.switch.add_reactor("evidence", self.evidence_reactor)
        fabric.register(self.switch)

        self.watchdog: Optional[LivenessWatchdog] = None
        self._equiv_thread: Optional[threading.Thread] = None
        self._equiv_stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self.switch.start()

    def stop(self) -> None:
        self._equiv_stop.set()
        if self.watchdog is not None:
            self.watchdog.stop()
        try:
            if self.switch.is_running:
                self.switch.stop()  # stops reactors, which stop the cs
        except Exception:
            pass
        try:
            self.bus.stop()
        except Exception:
            pass
        for feed in (self.vote_feed, self.tx_feed):
            if feed is not None:
                try:
                    feed.close()
                except Exception:
                    pass

    def crash(self) -> None:
        """Kill the node mid-flight, keeping its durable state (state_db,
        block_store, WAL file) for a replacement SimNode to rebuild from.
        Every WAL write already flushed (see WAL.write), so the file on
        disk is exactly what a kill -9 would leave behind."""
        self.stop()
        try:
            self.conn.stop()
        except Exception:
            pass

    def start_watchdog(self, **kwargs) -> LivenessWatchdog:
        self.watchdog = LivenessWatchdog(
            self.cs, switch=self.switch, now_ns=self.clock, **kwargs
        )
        self.watchdog.start()
        return self.watchdog

    def start_equivocation_pump(self, interval: float = 0.02) -> None:
        """Broadcast the EquivocatingPV's double-signed votes to all peers
        on the consensus VOTE channel: honest nodes mint the evidence."""
        if not isinstance(self.pv, EquivocatingPV):
            raise TypeError("node's priv validator is not an EquivocatingPV")

        def pump():
            while not self._equiv_stop.is_set():
                for vote in self.pv.drain_conflicting():
                    self.switch.broadcast(
                        VOTE_CHANNEL, encode_msg(VoteMessage(vote))
                    )
                time.sleep(interval)

        self._equiv_thread = threading.Thread(
            target=pump, name=f"equiv-pump-{self.node_id}", daemon=True
        )
        self._equiv_thread.start()

    # -- inspection ----------------------------------------------------------
    @property
    def height(self) -> int:
        return self.cs.rs.height

    def committed_hashes(self) -> Dict[int, str]:
        """height -> block hash hex for every block in our store."""
        out = {}
        base = max(1, self.block_store.base())
        for h in range(base, self.block_store.height() + 1):
            meta = self.block_store.load_block_meta(h)
            if meta is not None:
                out[h] = meta.block_id.hash.hex().upper()
        return out

    def commit_rounds(self) -> Dict[int, int]:
        """height -> round the commit formed at. Any round > 0 means a
        real-time timeout fired (host load), which is exactly the case
        where same-seed runs may legitimately diverge."""
        out = {}
        base = max(1, self.block_store.base())
        for h in range(base, self.block_store.height() + 1):
            commit = self.block_store.load_seen_commit(h)
            if commit is not None:
                out[h] = commit.round()
        return out

    def committed_evidence_heights(self) -> List[int]:
        """Heights of blocks in our store that carry committed evidence."""
        out = []
        base = max(1, self.block_store.base())
        for h in range(base, self.block_store.height() + 1):
            block = self.block_store.load_block(h)
            if block is not None and block.evidence.evidence:
                out.append(h)
        return out


def install_sim_verify(config=None, device: DeviceLike = None) -> None:
    """The verifier a sim net's nodes share, installed once before the first
    commit verify when nothing is installed: on the card the configuration
    root of ``config``'s ``[verify]`` section (``verify_root.configure_verify``,
    which builds the kernels first, so no dispatch pays ``nvcc``); with
    ``device="cpu"`` ``HostBatchVerifier``, as the reference's
    ``build_sim_net`` pins it (a lazily resolved default would otherwise
    raise ``NoCudaDeviceError`` inside a node's receive routine). An
    installed verifier wins."""
    if _batch.installed_batch_verifier() is not None:
        return
    dev = resolve_device(device)
    if dev.type == "cpu":
        _batch.set_batch_verifier(_batch.HostBatchVerifier())
    else:
        verify_root.configure_verify(config.verify if config is not None else None, dev)


def build_sim_net(
    n_vals: int,
    seed: int = 0,
    config=None,
    app_factory: Optional[Callable[[int], object]] = None,
    clock_factory: Optional[Callable[[int], SimClock]] = None,
    byzantine: Optional[Dict[int, Callable]] = None,
    *,
    device: DeviceLike = None,
):
    """N-node full-mesh simulated net on ``device`` (None: the card).
    ``byzantine`` maps a validator index (in sorted valset order) to a
    PrivValidator wrapper, e.g. ``{3: lambda pv: EquivocatingPV(pv)}``.
    Returns (fabric, nodes); neither is started."""
    dev = resolve_device(device)
    install_sim_verify(config, dev)

    fabric = SimNet(seed=seed)
    doc, pvs = make_sim_genesis(n_vals)
    st = state_from_genesis(doc)
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    sorted_pvs = [by_addr[v.address] for v in st.validators.validators]

    nodes = []
    for i in range(n_vals):
        pv = sorted_pvs[i]
        if byzantine and i in byzantine:
            pv = byzantine[i](pv)
        nodes.append(
            SimNode(
                index=i,
                node_id=f"sim{i}",
                doc=doc,
                pv=pv,
                fabric=fabric,
                config=config,
                app=app_factory(i) if app_factory is not None else None,
                clock=clock_factory(i) if clock_factory is not None else None,
                device=dev,
            )
        )
    fabric.connect_full_mesh()
    return fabric, nodes
