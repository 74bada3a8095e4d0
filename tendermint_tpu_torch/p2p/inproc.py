"""In-process message-level transport: the seam the simulation harness
(``tendermint_tpu_torch/sim``) drives real reactors through. The port's
copy of the reference package's ``p2p/inproc.py``, but that ``connect``
calls every reactor's ``init_peer`` before ``add_peer``, as the port's
``Switch`` does before it starts a peer (Go's InitPeer).

The real ``Switch`` upgrades TCP sockets into authenticated ``Peer``s and
dispatches complete messages to reactors by channel. Reactors only ever
touch the narrow duck-typed surface (``peer.id``/``is_running``/``send``/
``try_send``/``status`` and ``switch.broadcast``/``stop_peer_for_error``/
``peers``/``node_id``), so an in-proc switch that mirrors that surface runs
the consensus, mempool and evidence reactors unmodified while a simulated
fabric decides which bytes arrive, when, and in what order.

Delivery: ``InProcPeer.send`` hands the encoded message to the fabric
(``fabric.send(src, dst, chan_id, msg)``); the fabric (normally
``sim.simnet.SimNet``) applies its link policy and eventually calls
``switch.deliver(chan_id, src_id, msg)`` on the destination, which enqueues
into that switch's inbox; one worker thread a switch dispatches to
``reactor.receive`` as ``Switch._on_peer_receive`` does, with the same
exception-to-``stop_peer_for_error`` discipline. Per-link FIFO is the
fabric's contract, not this file's.

Why ``init_peer`` matters here: a peer's first message (its NewRoundStep on
connecting) may reach the dispatcher before ``add_peer`` has run on this
side; a consensus reactor without the peer's state drops it, and a node
that never learns a peer's height sticks until that peer changes step.

The second difference from the reference: ``deliver`` keeps a message that
reaches a switch not yet started (the harness wires the mesh, then starts
the nodes one by one) where the reference's drops it. A node that starts
first and reaches a step with no timeout (prevote, waiting for +2/3 of any
votes) before the others run has announced each step into the void: its
peers never learn its height, send it nothing, and it waits at height 1
for ever while they commit (seen in ``churn``, 2 runs of 8 on the port).

The third: what arrived from a peer and still waits in the inbox when
that peer is removed (a partition's cut, a receive error) dies with the
connection, as unread bytes die with a TCP connection. The reference's
dispatcher takes such a message for a new inbound peer and connects it
during the partition, with a ``PeerState`` that then marks as delivered
every vote the partition drops; at the heal ``connect`` finds that peer and
makes no fresh one, nothing is resent, and a net whose halves each hold
exactly 2/3 of the prevotes waits for ever (``partition_heal_9``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.peer import PeerSet


class InProcPeer:
    """The remote node ``peer_id`` as seen from one InProcSwitch.

    Mirrors the Peer surface reactors rely on; ``send``/``try_send`` route
    through the owning switch's fabric. ``status()`` serves the watchdog's
    per-peer ``last_recv_age`` probe from the switch's receive stamps.
    """

    def __init__(self, owner: "InProcSwitch", peer_id: str):
        self._owner = owner
        self._id = peer_id
        self._running = threading.Event()
        self._running.set()

    @property
    def id(self) -> str:
        return self._id

    @property
    def is_running(self) -> bool:
        return self._running.is_set() and self._owner.is_running

    def stop(self) -> None:
        self._running.clear()

    def send(self, chan_id: int, msg: bytes) -> bool:
        if not self.is_running:
            return False
        return self._owner._fabric_send(self._id, chan_id, msg)

    # the fabric has its own queueing/drop policy; try_send == send here
    try_send = send

    def has_channel(self, chan_id: int) -> bool:
        return chan_id in self._owner._reactors_by_ch

    def pending_send_bytes(self) -> int:
        return 0

    def status(self) -> dict:
        last = self._owner.last_recv_at(self._id)
        age = None if last is None else max(0.0, time.monotonic() - last)
        return {"last_recv_age": age}

    def __repr__(self):
        return f"InProcPeer({self._id})"


class InProcSwitch(BaseService):
    """Switch lookalike over a simulated fabric.

    ``fabric`` must provide ``send(src_id, dst_id, chan_id, msg) -> bool``;
    it calls back into ``deliver`` when (and if) the message arrives.
    """

    def __init__(self, node_id: str, fabric):
        super().__init__(name=f"InProcSwitch-{node_id}")
        self._node_id = node_id
        self.fabric = fabric
        self.peers = PeerSet()
        self.reactors: Dict[str, Reactor] = {}
        self._chan_descs: List[ChannelDescriptor] = []
        self._reactors_by_ch: Dict[int, Reactor] = {}
        self._inbox: "queue.Queue" = queue.Queue(maxsize=10000)
        self._last_recv: Dict[str, float] = {}
        self._recv_mtx = threading.Lock()
        # serializes connect(): the harness's topology thread and the
        # dispatcher's accept-inbound path can race the same peer id, and
        # PeerSet.add treats a duplicate as an error
        self._connect_mtx = threading.Lock()
        # messages delivered so far, and for each removed peer the count at
        # its removal: what arrived before a peer's connection was torn
        # down dies with it, as unread bytes die with a TCP connection
        self._cut_mtx = threading.Lock()
        self._delivered = 0
        self._cut_at: Dict[str, int] = {}

    # -- identity / registry (Switch surface) -------------------------------
    @property
    def node_id(self) -> str:
        return self._node_id

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        for desc in reactor.get_channels():
            if desc.id in self._reactors_by_ch:
                raise ValueError(
                    f"channel {desc.id:#x} already claimed by "
                    f"{self._reactors_by_ch[desc.id].name}"
                )
            self._reactors_by_ch[desc.id] = reactor
            self._chan_descs.append(desc)
        self.reactors[name] = reactor
        reactor.set_switch(self)
        return reactor

    # -- lifecycle ----------------------------------------------------------
    def on_start(self) -> None:
        for reactor in self.reactors.values():
            reactor.start()
        # peers wired before start (the harness builds the whole mesh, then
        # starts nodes) got their init_peer at connect but no add_peer (the
        # reactors' guard ignores a peer before they run): announce them now,
        # as Switch does on dial
        for peer in self.peers.list():
            for reactor in self.reactors.values():
                try:
                    reactor.add_peer(peer)
                except Exception:
                    self.logger.exception("reactor %s add_peer", reactor.name)
        threading.Thread(
            target=self._dispatch_routine,
            name=f"inproc-dispatch-{self._node_id}",
            daemon=True,
        ).start()

    def on_stop(self) -> None:
        self._inbox.put(None)  # unblock the dispatcher
        for peer in self.peers.list():
            self._remove_peer(peer, reason="switch stopping")
        for reactor in reversed(list(self.reactors.values())):
            if reactor.is_running:
                try:
                    reactor.stop()
                except Exception:
                    self.logger.exception("stopping reactor %s", reactor.name)

    # -- topology (driven by the fabric/harness) ----------------------------
    def connect(self, peer_id: str) -> InProcPeer:
        """Register ``peer_id`` as a live peer and notify every reactor: the
        in-proc analogue of Switch._add_peer after a successful upgrade
        (``init_peer`` first, then ``add_peer``). Idempotent and safe to
        race from multiple threads."""
        with self._connect_mtx:
            existing = self.peers.get(peer_id)
            if existing is not None:
                return existing
            peer = InProcPeer(self, peer_id)
            self.peers.add(peer)
            for reactor in self.reactors.values():
                reactor.init_peer(peer)
        for reactor in self.reactors.values():
            try:
                reactor.add_peer(peer)
            except Exception:
                self.logger.exception("reactor %s add_peer", reactor.name)
        return peer

    def disconnect(self, peer_id: str, reason="disconnected") -> None:
        peer = self.peers.get(peer_id)
        if peer is not None:
            self._remove_peer(peer, reason)

    # -- messaging ----------------------------------------------------------
    def _fabric_send(self, dst_id: str, chan_id: int, msg: bytes) -> bool:
        if not self.is_running:
            return False
        try:
            return self.fabric.send(self._node_id, dst_id, chan_id, msg)
        except Exception:
            self.logger.exception("fabric send to %s", dst_id)
            return False

    def broadcast(self, chan_id: int, msg_bytes: bytes) -> None:
        for peer in self.peers.list():
            peer.try_send(chan_id, msg_bytes)

    def deliver(self, chan_id: int, src_id: str, msg_bytes: bytes) -> None:
        """Fabric-side entry point: enqueue one arrived message. Never
        blocks the fabric's scheduler: overflow drops (lossy network). A
        message that arrives before this switch starts waits in the inbox
        for the dispatcher, as bytes wait in a socket before the reader
        runs; only a stopped switch drops what arrives."""
        with self._mtx:
            if self._stopped:
                return
        with self._cut_mtx:
            self._delivered += 1
            seq = self._delivered
        try:
            self._inbox.put_nowait((chan_id, src_id, msg_bytes, seq))
        except queue.Full:
            self.logger.warning("inbox full: dropping %#x from %s",
                                chan_id, src_id)

    def _dispatch_routine(self) -> None:
        while not self._quit.is_set():
            item = self._inbox.get()
            if item is None:
                return
            try:
                self._dispatch_one(*item)
            except Exception:
                # the dispatcher is this node's only ear: it must survive
                # anything a single message (or a racing disconnect) throws
                self.logger.exception("dispatch of %#x from %s", item[0], item[1])

    def _dispatch_one(self, chan_id: int, src_id: str, msg_bytes: bytes, seq: int = 0) -> None:
        with self._cut_mtx:
            if seq <= self._cut_at.get(src_id, 0):
                # it arrived on a connection removed since (a partition, a
                # receive error): dropped with it, never a new inbound peer
                return
        peer = self.peers.get(src_id)
        if peer is None:
            # accept-inbound: traffic from a node we haven't (re)added, e.g.
            # the other side of a healed partition connected first and its
            # one-shot round-state announcement is this very message. As the
            # real Switch accepts an inbound dial; the fabric has already
            # vetted reachability.
            peer = self.connect(src_id)
        with self._recv_mtx:
            self._last_recv[src_id] = time.monotonic()
        reactor = self._reactors_by_ch.get(chan_id)
        if reactor is None:
            self.stop_peer_for_error(
                peer, f"message on unclaimed channel {chan_id:#x}"
            )
            return
        try:
            reactor.receive(chan_id, peer, msg_bytes)
        except Exception as e:
            self.logger.exception(
                "reactor %s receive on %#x from %s",
                reactor.name, chan_id, src_id,
            )
            self.stop_peer_for_error(peer, e)

    def last_recv_at(self, peer_id: str) -> Optional[float]:
        with self._recv_mtx:
            return self._last_recv.get(peer_id)

    # -- removal ------------------------------------------------------------
    def stop_peer_for_error(self, peer, reason) -> None:
        self.logger.info("stopping peer %s: %s", peer.id, reason)
        self._remove_peer(peer, reason)

    def stop_peer_gracefully(self, peer) -> None:
        self._remove_peer(peer, reason=None)

    def _remove_peer(self, peer, reason) -> None:
        removed = self.peers.remove(peer)
        peer.stop()
        if not removed:
            return
        with self._cut_mtx:
            self._cut_at[peer.id] = self._delivered
        for reactor in self.reactors.values():
            try:
                reactor.remove_peer(peer, reason)
            except Exception:
                self.logger.exception("reactor %s remove_peer", reactor.name)

    def num_peers(self) -> dict:
        return {"outbound": self.peers.size(), "inbound": 0, "dialing": 0}
