"""Switch: owns the peer set and the reactor registry; every inbound or
dialed connection becomes a Peer here, and every peer error funnels back
through ``stop_peer_for_error`` (ref p2p/switch.go:54). The port's copy of
the reference package's ``p2p/switch.py``, but that it calls every
reactor's ``init_peer`` before it starts a peer, as the Go switch calls
``InitPeer``: the reference package starts the peer first, so a message
that arrives before ``add_peer`` finds no peer state and is dropped.

Reference behaviors kept:

* reactors register channel descriptors at ``add_reactor`` — duplicate
  channel IDs are a programming error (switch.go:142);
* accept loop: drain the transport, filter (dup ID / dup IP / self), start
  the peer, then notify every reactor (switch.go addPeer :646);
* persistent peers are redialed with exponential backoff when they
  disconnect (switch.go reconnectToPeer :385-448);
* ``broadcast`` fans a message out to all connected peers on one channel
  (switch.go:232) — non-blocking per peer; gossip routines that need
  backpressure use ``peer.send`` directly.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnConfig
from tendermint_tpu_torch.p2p.errors import (
    P2PError,
    SwitchConnectToSelfError,
    SwitchDuplicatePeerIDError,
    SwitchDuplicatePeerIPError,
    SwitchPeerFilteredError,
    TransportClosedError,
)
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.peer import Peer, PeerSet
from tendermint_tpu_torch.p2p.transport import MultiplexTransport, UpgradedConn

RECONNECT_BASE_WAIT = 0.1  # shrunk from the reference's 5s for testability
RECONNECT_MAX_WAIT = 2.0  # backoff cap: a dead link must heal in seconds
# capped-wait attempts sized for a ~10 min retry horizon (the reference's
# 20 exponential + 10 slow attempts span comparable wall time)
RECONNECT_ATTEMPTS = 300


class SwitchConfig:
    def __init__(
        self,
        max_num_inbound_peers: int = 40,
        max_num_outbound_peers: int = 10,
        allow_duplicate_ip: bool = True,
        reconnect_base_wait: float = RECONNECT_BASE_WAIT,
    ):
        self.max_num_inbound_peers = max_num_inbound_peers
        self.max_num_outbound_peers = max_num_outbound_peers
        self.allow_duplicate_ip = allow_duplicate_ip
        self.reconnect_base_wait = reconnect_base_wait


class Switch(BaseService):
    def __init__(
        self,
        transport: MultiplexTransport,
        config: Optional[SwitchConfig] = None,
        mconfig: Optional[MConnConfig] = None,
        peer_filters=None,  # callables (node_id) -> rejection reason or None
        metrics=None,  # NodeMetrics or None
    ):
        super().__init__(name="Switch")
        self.transport = transport
        self.config = config or SwitchConfig()
        self.mconfig = mconfig or MConnConfig()
        self.metrics = metrics
        # post-handshake admission filters by authenticated node ID
        # (node.go:401-419 peerFilters — e.g. the ABCI /p2p/filter/id query)
        self.peer_filters = list(peer_filters or [])
        self.peers = PeerSet()
        self.reactors: Dict[str, Reactor] = {}
        self._chan_descs: List[ChannelDescriptor] = []
        self._reactors_by_ch: Dict[int, Reactor] = {}
        self._dialing: set = set()
        self._reconnecting: set = set()
        self._mtx = threading.Lock()

    # -- reactor registry ---------------------------------------------------------
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

    @property
    def node_info(self):
        return self.transport.node_info

    @property
    def node_id(self) -> str:
        return self.transport.node_info.id

    # -- lifecycle ----------------------------------------------------------------
    def on_start(self) -> None:
        for reactor in self.reactors.values():
            reactor.start()
        threading.Thread(
            target=self._accept_routine, name="switch-accept", daemon=True
        ).start()

    def on_stop(self) -> None:
        # transport first: no new upgrades may complete and land in
        # _accept_routine once peers/reactors are going down
        if self.transport.is_running:
            try:
                self.transport.stop()
            except Exception:
                self.logger.exception("stopping transport")
        else:
            # never listened: still unblock our accept routine
            self.transport._push_closed_sentinel()
        for peer in self.peers.list():
            self._stop_and_remove_peer(peer, reason="switch stopping")
        for reactor in reversed(list(self.reactors.values())):
            if reactor.is_running:
                try:
                    reactor.stop()
                except Exception:
                    self.logger.exception("stopping reactor %s", reactor.name)

    # -- inbound ------------------------------------------------------------------
    def _accept_routine(self) -> None:
        while not self._quit.is_set():
            try:
                up = self.transport.accept()
            except TransportClosedError:
                return
            except Exception:
                if self._quit.is_set():
                    return
                continue
            inbound = sum(1 for p in self.peers.list() if not p.outbound)
            if inbound >= self.config.max_num_inbound_peers:
                up.conn.close()
                continue
            try:
                self._add_peer(up)
            except Exception as e:
                self.logger.info("rejected inbound peer %s: %s", up.node_info.id[:8], e)
                up.conn.close()

    # -- dialing ------------------------------------------------------------------
    def dial_peer_with_address(self, addr: NetAddress, persistent: bool = False) -> Peer:
        """Synchronous dial+add (switch.go DialPeerWithAddress)."""
        if addr.id == self.node_id:
            raise SwitchConnectToSelfError(addr)
        if self.peers.has(addr.id):
            raise SwitchDuplicatePeerIDError(addr.id)
        if not persistent:
            outbound = sum(1 for p in self.peers.list() if p.outbound)
            if outbound >= self.config.max_num_outbound_peers:
                raise P2PError(
                    f"outbound peer cap reached ({outbound})"
                )
        with self._mtx:
            if addr.id in self._dialing:
                raise SwitchDuplicatePeerIDError(addr.id)
            self._dialing.add(addr.id)
        try:
            up = self.transport.dial(addr)
            return self._add_peer(up, persistent=persistent)
        finally:
            with self._mtx:
                self._dialing.discard(addr.id)

    def dial_peers_async(
        self, addrs: List[NetAddress], persistent: bool = False
    ) -> None:
        """Fire-and-forget dials with jitter (switch.go DialPeersAsync)."""
        for addr in addrs:
            def _dial(a=addr):
                time.sleep(random.random() * 0.05)
                try:
                    self.dial_peer_with_address(a, persistent=persistent)
                except Exception as e:
                    self.logger.info("dial %s failed: %s", a, e)
                    if persistent:
                        self._reconnect_to_peer(a)

            threading.Thread(target=_dial, name="switch-dial", daemon=True).start()

    def _reconnect_to_peer(self, addr: NetAddress) -> None:
        with self._mtx:
            if addr.id in self._reconnecting:
                return
            self._reconnecting.add(addr.id)

        def _loop():
            try:
                base = self.config.reconnect_base_wait
                for attempt in range(RECONNECT_ATTEMPTS):
                    if self._quit.is_set() or self.peers.has(addr.id):
                        return
                    wait = min(RECONNECT_MAX_WAIT, base * (1.5**attempt))
                    time.sleep(wait + random.random() * base)
                    try:
                        self.dial_peer_with_address(addr, persistent=True)
                        return
                    except SwitchDuplicatePeerIDError:
                        return
                    except Exception as e:
                        self.logger.debug(
                            "reconnect %s attempt %d failed: %s", addr, attempt, e
                        )
                self.logger.error("gave up reconnecting to %s", addr)
            finally:
                with self._mtx:
                    self._reconnecting.discard(addr.id)

        threading.Thread(target=_loop, name="switch-reconnect", daemon=True).start()

    # -- peer admission -------------------------------------------------------------
    def _conn_is_canonical(self, outbound: bool, peer_id: str) -> bool:
        """Of two simultaneous cross-connections between the same pair, both
        sides must agree which survives, or each keeps the one the other
        kills and the pair flaps forever. Canon: the conn DIALED by the
        lexicographically smaller node ID."""
        dialer = self.node_id if outbound else peer_id
        return dialer == min(self.node_id, peer_id)

    def _add_peer(self, up: UpgradedConn, persistent: bool = False) -> Peer:
        if up.node_info.id == self.node_id:
            up.conn.close()
            raise SwitchConnectToSelfError(up.socket_addr)
        existing = self.peers.get(up.node_info.id)
        if existing is not None:
            if self._conn_is_canonical(
                up.outbound, up.node_info.id
            ) and not self._conn_is_canonical(existing.outbound, existing.id):
                # the new conn is the agreed survivor: evict the old one,
                # and INHERIT its persistence — the replacement must keep the
                # reconnect guarantee the evicted conn carried
                self.logger.info(
                    "replacing non-canonical duplicate conn to %s",
                    up.node_info.id[:8],
                )
                persistent = persistent or existing.persistent
                self._stop_and_remove_peer(existing, "duplicate (non-canonical)")
            else:
                up.conn.close()
                raise SwitchDuplicatePeerIDError(up.node_info.id)
        if not self.config.allow_duplicate_ip and self.peers.has_ip(
            up.socket_addr.host
        ):
            up.conn.close()
            raise SwitchDuplicatePeerIPError(up.socket_addr.host)
        for pf in self.peer_filters:
            reason = pf(up.node_info.id)
            if reason:
                up.conn.close()
                raise SwitchPeerFilteredError(up.node_info.id, reason)

        peer = Peer(
            up.conn,
            up.node_info,
            self._chan_descs,
            on_receive=self._on_peer_receive,
            on_error=self.stop_peer_for_error,
            mconfig=self.mconfig,
            outbound=up.outbound,
            persistent=persistent,
            socket_addr=up.socket_addr,
            metrics=self.metrics,
        )
        # register BEFORE starting: an immediate transport error must find the
        # peer in the set so stop_peer_for_error can clean it up (otherwise a
        # dead peer would stay registered forever)
        try:
            self.peers.add(peer)
        except KeyError:
            up.conn.close()
            raise SwitchDuplicatePeerIDError(peer.id)
        # before the peer starts: its first message may come in before
        # add_peer, and a reactor must have its state for it by then
        # (switch.go addPeer calls InitPeer first; the reference package
        # starts the peer first and drops what arrives in between)
        for reactor in self.reactors.values():
            reactor.init_peer(peer)
        try:
            peer.start()
        except Exception as e:
            self.peers.remove(peer)
            up.conn.close()
            for reactor in self.reactors.values():
                reactor.remove_peer(peer, e)
            raise
        self.logger.info(
            "added peer %s (%s)", peer.id[:8], "out" if peer.outbound else "in"
        )
        for reactor in self.reactors.values():
            try:
                reactor.add_peer(peer)
            except Exception:
                self.logger.exception("reactor %s add_peer", reactor.name)
        return peer

    def _on_peer_receive(self, chan_id: int, peer: Peer, msg_bytes: bytes) -> None:
        reactor = self._reactors_by_ch.get(chan_id)
        if reactor is None:
            self.stop_peer_for_error(peer, f"message on unclaimed channel {chan_id:#x}")
            return
        if self.metrics is not None:
            self.metrics.messages_received.add(1, (f"{chan_id:#x}",))
        try:
            reactor.receive(chan_id, peer, msg_bytes)
        except Exception as e:
            self.logger.exception(
                "reactor %s receive on %#x from %s", reactor.name, chan_id, peer.id[:8]
            )
            self.stop_peer_for_error(peer, e)

    # -- removal ----------------------------------------------------------------
    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        if self.peers.get(peer.id) is not peer:
            # stale object (already replaced/removed): silence it without
            # touching the set entry that superseded it
            if peer.is_running:
                try:
                    peer.stop()
                except Exception:
                    pass
            return
        self.logger.info("stopping peer %s: %s", peer.id[:8], reason)
        self._stop_and_remove_peer(peer, reason)
        if peer.persistent and not self._quit.is_set():
            addr = peer.net_address()
            if addr is not None:
                self._reconnect_to_peer(addr)

    def stop_peer_gracefully(self, peer: Peer) -> None:
        self._stop_and_remove_peer(peer, reason=None)

    def _stop_and_remove_peer(self, peer: Peer, reason) -> None:
        removed = self.peers.remove(peer)  # identity-checked
        if peer.is_running:
            try:
                peer.stop()
            except Exception:
                pass
        if not removed:
            return
        if self.metrics is not None:
            # drop the per-peer label series so cardinality tracks live peers
            self.metrics.forget_peer(peer.id)
        for reactor in self.reactors.values():
            try:
                reactor.remove_peer(peer, reason)
            except Exception:
                self.logger.exception("reactor %s remove_peer", reactor.name)

    # -- messaging ----------------------------------------------------------------
    def broadcast(self, chan_id: int, msg_bytes: bytes) -> None:
        """Best-effort fan-out: non-blocking per peer, full queues drop
        (reference Broadcast is async per peer; critical paths gossip
        per-peer with peer.send)."""
        for peer in self.peers.list():
            peer.try_send(chan_id, msg_bytes)

    def num_peers(self) -> dict:
        peers = self.peers.list()
        return {
            "outbound": sum(1 for p in peers if p.outbound),
            "inbound": sum(1 for p in peers if not p.outbound),
            "dialing": len(self._dialing),
        }
