"""StateSyncReactor on channel 0x60, the port's copy of the reference
package's ``statesync/reactor.py``: it serves snapshots, chunks and light
blocks to restoring peers, and hosts the ``StateSyncer``'s peer I/O when
this node is the one restoring.

Serving side: chunk responses go out through a sender thread whose budget
a ``flowrate.Monitor`` paces (``chunk_send_rate`` bytes/s), so that a
restoring peer fetching the whole snapshot does not starve the other
channels. Light-block requests are answered from this node's block store
and state DB through ``lite/provider.NodeProvider``.

Client side: blocking ``fetch_chunk`` / ``fetch_light_block`` keyed waits
that the receive thread completes; the syncer drives them from its own
routine.

The reactor runs on the real ``p2p/switch.Switch`` and its ``Peer``s
(``node/verify_root.node_reactors``) and on ``testutil/statesync.py``'s
in-process hub fakes.

Where the port differs:

* when the syncer halts on a device fault on the card
  (``StateSyncer.device_fault``), the reactor records it as its own
  ``device_fault``, ``progress()["error"]`` names it, and ``on_synced`` is
  not called;
* a peer that does not advertise the state sync channel (``Peer.has_channel``:
  a node that neither restores nor serves) is not a peer of the restore,
  and a request its peer refuses to queue (``try_send`` false: the peer is
  stopping, or its send queue is full) fails at once. The reference asks
  every peer of the switch and waits out ``chunk_fetch_timeout`` on each
  request the switch never sent; its hub fakes, where every peer runs every
  reactor and ``try_send`` always queues, cannot show that.
"""

from __future__ import annotations

import threading
import time
from queue import Empty, Full, Queue
from typing import Dict, List, Optional, Set, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.flowrate import Monitor
from tendermint_tpu_torch.libs.metrics import get_statesync_metrics
from tendermint_tpu_torch.lite.provider import DBProvider, NodeProvider, ProviderError
from tendermint_tpu_torch.lite.types import FullCommit
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.statesync.messages import (
    ChunkRequestMessage,
    ChunkResponseMessage,
    LightBlockRequestMessage,
    LightBlockResponseMessage,
    SnapshotsRequestMessage,
    SnapshotsResponseMessage,
    encode_msg,
    unmarshal_msg,
)

STATESYNC_CHANNEL = 0x60
MAX_MSG_SIZE = 10485760  # 10 MB: bounds a chunk and a manifest per message

MAX_OFFERS_PER_PEER = 16
SEND_QUEUE_SIZE = 256


class StateSyncReactor(Reactor):
    def __init__(
        self,
        config,  # config/statesync.StateSyncConfig
        app_query=None,  # proxy AppConnQuery: the ABCI snapshot handshake
        snapshot_store=None,  # SnapshotStore: the preferred serving source
        block_store=None,  # light blocks for restoring peers
        state_db=None,
        syncer=None,  # StateSyncer when this node restores
        on_synced=None,  # callback(state, height) after a successful restore
        metrics=None,  # a StateSyncMetrics; default the process-wide one
    ):
        super().__init__(name="StateSyncReactor")
        self.config = config
        self.app_query = app_query
        self.snapshot_store = snapshot_store
        self.block_store = block_store
        self.state_db = state_db
        self.syncer = syncer
        self.on_synced = on_synced
        self.metrics = metrics or get_statesync_metrics()

        # client side (the restoring node)
        self._mtx = threading.Lock()
        # (height, format, hash) -> (Snapshot, ids of the peers offering it)
        self._offers: Dict[Tuple[int, int, bytes], Tuple[abci.Snapshot, Set[str]]] = {}
        self._banned: Set[str] = set()
        # keyed blocking waits the receive thread completes:
        #   chunk key ("chunk", height, format, index); light key ("lb", height)
        self._pending: Dict[tuple, dict] = {}

        # serving side
        self._send_q: "Queue[tuple]" = Queue(SEND_QUEUE_SIZE)
        self._flow = Monitor()
        self._synced_height = 0
        self._sync_error: Optional[str] = None
        # the device fault that halted the restore (on the card only)
        self.device_fault: Optional[BaseException] = None

    # -- Reactor interface ------------------------------------------------------------
    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(id=STATESYNC_CHANNEL, priority=5, send_queue_capacity=64,
                                  recv_message_capacity=MAX_MSG_SIZE)]

    def on_start(self) -> None:
        threading.Thread(target=self._sender_routine, name="ss-sender", daemon=True).start()
        if self.syncer is not None:
            threading.Thread(target=self._sync_routine, name="ss-sync", daemon=True).start()

    def on_stop(self) -> None:
        # release every blocked fetch so that the syncer sees the quit flag
        with self._mtx:
            pending = list(self._pending.values())
        for p in pending:
            p["event"].set()

    def add_peer(self, peer) -> None:
        if self.is_syncing():
            peer.try_send(STATESYNC_CHANNEL, encode_msg(SnapshotsRequestMessage()))

    def remove_peer(self, peer, reason) -> None:
        with self._mtx:
            for _, peers in self._offers.values():
                peers.discard(peer.id)

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            msg = unmarshal_msg(msg_bytes)
        except Exception as e:
            self.logger.error("bad statesync msg from %s: %s", peer.id[:8], e)
            if self.switch is not None:
                self.switch.stop_peer_for_error(peer, f"bad statesync msg: {e}")
            return
        if isinstance(msg, SnapshotsRequestMessage):
            self._serve_snapshots(peer)
        elif isinstance(msg, SnapshotsResponseMessage):
            self._record_offers(peer, msg.snapshots)
        elif isinstance(msg, ChunkRequestMessage):
            self._enqueue_chunk(peer, msg)
        elif isinstance(msg, ChunkResponseMessage):
            self._complete(("chunk", msg.height, msg.format, msg.index), peer,
                           chunk=msg.chunk, missing=msg.missing)
        elif isinstance(msg, LightBlockRequestMessage):
            self._serve_light_block(peer, msg.height)
        elif isinstance(msg, LightBlockResponseMessage):
            self._complete(("lb", msg.height), peer, raw=msg.full_commit)
        else:
            self.logger.error("unknown statesync msg %r", type(msg))

    # -- serving side -----------------------------------------------------------------
    def _list_local_snapshots(self) -> List[abci.Snapshot]:
        if self.snapshot_store is not None:
            return self.snapshot_store.list(limit=MAX_OFFERS_PER_PEER)
        if self.app_query is not None:
            return self.app_query.list_snapshots_sync().snapshots[:MAX_OFFERS_PER_PEER]
        return []

    def _serve_snapshots(self, peer) -> None:
        try:
            snaps = self._list_local_snapshots()
        except Exception:
            self.logger.exception("listing snapshots failed")
            snaps = []
        self.metrics.served.add(1.0, ("snapshots",))
        peer.try_send(STATESYNC_CHANNEL, encode_msg(SnapshotsResponseMessage(snaps)))

    def _load_local_chunk(self, height: int, format: int, index: int):
        if self.snapshot_store is not None:
            chunk = self.snapshot_store.load_chunk(height, format, index)
            if chunk is not None:
                return chunk
        if self.app_query is not None:
            res = self.app_query.load_snapshot_chunk_sync(
                abci.RequestLoadSnapshotChunk(height=height, format=format, chunk=index))
            if res.chunk:
                return res.chunk
        return None

    def _enqueue_chunk(self, peer, msg: ChunkRequestMessage) -> None:
        """Runs on the peer's receive thread: the (possibly paced) load and
        send happen on the sender thread."""
        try:
            self._send_q.put_nowait((peer, msg))
        except Full:
            # drop: the requester re-requests on its timeout
            self.logger.info("chunk send queue full, dropping request")

    def _sender_routine(self) -> None:
        rate = getattr(self.config, "chunk_send_rate", 0)
        while not self._quit.is_set():
            try:
                peer, msg = self._send_q.get(timeout=0.2)
            except Empty:
                continue
            try:
                chunk = self._load_local_chunk(msg.height, msg.format, msg.index)
            except Exception:
                self.logger.exception("loading chunk failed")
                chunk = None
            resp = ChunkResponseMessage(height=msg.height, format=msg.format, index=msg.index,
                                        chunk=chunk or b"", missing=chunk is None)
            if chunk and rate > 0:
                # token-bucket pacing: block until the whole chunk fits the
                # budget (the Monitor sleeps in small slices)
                want, granted = len(chunk), 0
                while granted < want and not self._quit.is_set():
                    got = self._flow.limit(want - granted, rate)
                    self._flow.update(got)
                    granted += got
            self.metrics.served.add(1.0, ("chunk",))
            peer.try_send(STATESYNC_CHANNEL, encode_msg(resp))

    def _serve_light_block(self, peer, height: int) -> None:
        raw = b""
        chain_id = self._chain_id()
        if self.block_store is not None and self.state_db is not None:
            try:
                if chain_id:
                    raw = NodeProvider(self.block_store, self.state_db).full_commit_at(
                        chain_id, height).marshal()
            except ProviderError:
                pass
            except Exception:
                self.logger.exception("serving light block %d failed", height)
        if not raw and self.state_db is not None and chain_id:
            # the block store may be pruned (or this node restored by state
            # sync): a light-client trust store under the same state DB can
            # still serve the exact height
            try:
                raw = DBProvider(self.state_db).latest_full_commit(
                    chain_id, height, height).marshal()
            except ProviderError:
                pass
            except Exception:
                self.logger.exception("trust-store fallback for light block %d failed", height)
        self.metrics.served.add(1.0, ("light_block",))
        peer.try_send(STATESYNC_CHANNEL,
                      encode_msg(LightBlockResponseMessage(height=height, full_commit=raw)))

    def _chain_id(self) -> str:
        if self.syncer is not None:
            return self.syncer.chain_id
        if self.block_store is not None:
            meta = self.block_store.load_block_meta(self.block_store.height())
            if meta is not None:
                return meta.header.chain_id
        return ""

    # -- client side (driven by the StateSyncer) ----------------------------------------
    def is_syncing(self) -> bool:
        return self.syncer is not None and self._synced_height == 0

    def broadcast_snapshot_request(self) -> None:
        if self.switch is not None:
            self.switch.broadcast(STATESYNC_CHANNEL, encode_msg(SnapshotsRequestMessage()))

    def _record_offers(self, peer, snapshots: List[abci.Snapshot]) -> None:
        with self._mtx:
            if peer.id in self._banned:
                return
            for s in snapshots[:MAX_OFFERS_PER_PEER]:
                key = (s.height, s.format, s.hash)
                if key in self._offers:
                    self._offers[key][1].add(peer.id)
                else:
                    self._offers[key] = (s, {peer.id})

    def snapshot_offers(self) -> List[Tuple[abci.Snapshot, Set[str]]]:
        """Snapshot offers with live, unbanned peers, tallest first."""
        with self._mtx:
            live = self._peer_ids_locked()
            out = [(s, {p for p in peers if p in live}) for (s, peers) in self._offers.values()]
        out = [(s, peers) for (s, peers) in out if peers]
        out.sort(key=lambda it: (it[0].height, it[0].format), reverse=True)
        return out

    def discard_offer(self, snapshot: abci.Snapshot) -> None:
        with self._mtx:
            self._offers.pop((snapshot.height, snapshot.format, snapshot.hash), None)

    def _peer_ids_locked(self) -> Set[str]:
        if self.switch is None:
            return set()
        return {p.id for p in self.switch.peers.list()
                if p.id not in self._banned and p.has_channel(STATESYNC_CHANNEL)}

    def peer_ids(self) -> Set[str]:
        with self._mtx:
            return self._peer_ids_locked()

    def ban_peer(self, peer_id: str, reason: str) -> None:
        """Punish, and never use again this sync (a bad chunk or offer)."""
        with self._mtx:
            self._banned.add(peer_id)
            for _, peers in self._offers.values():
                peers.discard(peer_id)
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is not None:
            self.switch.stop_peer_for_error(peer, reason)

    def _complete(self, key: tuple, peer, **fields) -> None:
        with self._mtx:
            p = self._pending.get(key)
            if p is None or (p["peer"] is not None and p["peer"] != peer.id):
                return  # unsolicited or stale: ignore
            p.update(fields)
            p["from"] = peer.id
            p["event"].set()

    def _request(self, peer_id: str, key: tuple, msg, timeout: float) -> Optional[dict]:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is None:
            return None
        p = {"event": threading.Event(), "peer": peer_id}
        with self._mtx:
            self._pending[key] = p
        try:
            if not peer.try_send(STATESYNC_CHANNEL, encode_msg(msg)):
                return None  # never sent: nothing to wait for
            if not p["event"].wait(timeout) or self._quit.is_set():
                return None
            return p
        finally:
            with self._mtx:
                if self._pending.get(key) is p:
                    del self._pending[key]

    def fetch_chunk(self, peer_id: str, height: int, format: int, index: int,
                    timeout: float) -> Optional[bytes]:
        """One chunk from one peer; None on a timeout, a missing chunk or a
        peer gone."""
        t0 = time.monotonic()
        p = self._request(peer_id, ("chunk", height, format, index),
                          ChunkRequestMessage(height=height, format=format, index=index), timeout)
        self.metrics.chunk_fetch_seconds.observe(time.monotonic() - t0)
        if p is None:
            self.metrics.chunk_fetch.add(1.0, ("timeout",))
            return None
        if p.get("missing") or "chunk" not in p:
            self.metrics.chunk_fetch.add(1.0, ("missing",))
            return None
        return p["chunk"]

    def fetch_light_block(self, peer_id: str, height: int, timeout: float) -> Optional[FullCommit]:
        p = self._request(peer_id, ("lb", height), LightBlockRequestMessage(height=height),
                          timeout)
        raw = (p or {}).get("raw")
        if not raw:
            return None
        try:
            return FullCommit.unmarshal(raw)
        except Exception:
            self.ban_peer(peer_id, f"unparseable light block {height}")
            return None

    def wait(self, seconds: float) -> bool:
        """The syncer's sleep, which ends on the reactor's stop; True: go on."""
        return not self._quit.wait(seconds)

    # -- the restore routine ----------------------------------------------------------
    def _sync_routine(self) -> None:
        t0 = time.monotonic()
        self.metrics.syncing.set(1)
        try:
            with trace.span("statesync.restore"):
                state = self.syncer.run(self)
        except Exception as e:
            fault = getattr(self.syncer, "device_fault", None)
            if fault is not None:
                self.device_fault = fault
                self._sync_error = f"halted on a device fault ({type(fault).__name__}): {fault}"
                self.logger.error("state sync %s; no peer blamed, nothing persisted",
                                  self._sync_error)
                return
            self._sync_error = str(e)
            self.logger.exception("state sync failed")
            return
        finally:
            self.metrics.syncing.set(0)
        if state is None:
            self._sync_error = "aborted"
            return
        self._synced_height = state.last_block_height
        self.metrics.restore_seconds.observe(time.monotonic() - t0)
        self.logger.info("state sync complete at height %d", state.last_block_height)
        if self.on_synced is not None:
            try:
                self.on_synced(state, state.last_block_height)
            except Exception:
                self.logger.exception("statesync handoff failed")

    # -- RPC progress -----------------------------------------------------------------
    def progress(self) -> dict:
        out = {
            "enabled": True,
            "syncing": self.is_syncing(),
            "synced_height": self._synced_height,
            "error": self._sync_error,
        }
        if self.syncer is not None:
            out.update(self.syncer.progress())
        return out
