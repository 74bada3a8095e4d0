"""Peer: one authenticated, multiplexed remote node (ref p2p/peer.go), and
the concurrency-safe PeerSet the Switch tracks them in (ref
p2p/peer_set.go); the port's copy of the reference package's
``p2p/peer.py``. With ``metrics`` (a ``libs/metrics.NodeMetrics``) the
peer's connection counts its wire bytes by peer and channel and its sends
by channel.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnection, MConnConfig
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.node_info import NodeInfo


class Peer(BaseService):
    """Wraps an upgraded connection + the remote NodeInfo.

    `conn` must already be authenticated (SecretConnection) and handshaked
    (NodeInfo exchanged) by the transport — peers never exist half-upgraded
    (transport.go upgrade discipline).
    """

    def __init__(
        self,
        conn,
        node_info: NodeInfo,
        channel_descs: List[ChannelDescriptor],
        on_receive: Callable[[int, "Peer", bytes], None],
        on_error: Callable[["Peer", Exception], None],
        mconfig: Optional[MConnConfig] = None,
        outbound: bool = False,
        persistent: bool = False,
        socket_addr: Optional[NetAddress] = None,
        metrics=None,
    ):
        super().__init__(name=f"Peer-{node_info.id[:8]}")
        self.node_info = node_info
        self.outbound = outbound
        self.persistent = persistent
        self.socket_addr = socket_addr  # actual dialed/accepted address
        self.metrics = metrics  # NodeMetrics or None
        self._channels = set(node_info.channels)
        on_traffic = None
        if metrics is not None:
            pid = node_info.id
            on_traffic = lambda cid, s, r: metrics.record_peer_traffic(
                pid, cid, sent=s, received=r
            )
        self.mconn = MConnection(
            conn,
            channel_descs,
            on_receive=lambda cid, msg: on_receive(cid, self, msg),
            on_error=lambda err: on_error(self, err),
            config=mconfig,
            name=f"MConn-{node_info.id[:8]}",
            on_traffic=on_traffic,
        )

    # -- identity --------------------------------------------------------------
    @property
    def id(self) -> str:
        return self.node_info.id

    def net_address(self) -> Optional[NetAddress]:
        """The address to redial / advertise: the dialed address for outbound
        peers, the self-reported listen addr for inbound (peer.go NetAddress)."""
        if self.outbound and self.socket_addr is not None:
            return self.socket_addr
        try:
            return self.node_info.net_address()
        except (ValueError, AttributeError):
            return None

    # -- lifecycle ---------------------------------------------------------------
    def on_start(self) -> None:
        self.mconn.start()

    def on_stop(self) -> None:
        if self.mconn.is_running:
            try:
                self.mconn.stop()
            except Exception:
                pass

    # -- messaging ---------------------------------------------------------------
    def send(self, chan_id: int, msg: bytes) -> bool:
        if not self.is_running or chan_id not in self._channels:
            return False
        ok = self.mconn.send(chan_id, msg)
        if ok and self.metrics is not None:
            self.metrics.messages_sent.add(1, (f"{chan_id:#x}",))
        return ok

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        if not self.is_running or chan_id not in self._channels:
            return False
        ok = self.mconn.try_send(chan_id, msg)
        if ok and self.metrics is not None:
            self.metrics.messages_sent.add(1, (f"{chan_id:#x}",))
        return ok

    def pending_send_bytes(self) -> int:
        return self.mconn.pending_send_bytes()

    def has_channel(self, chan_id: int) -> bool:
        return chan_id in self._channels

    def status(self) -> dict:
        return self.mconn.status()

    def __repr__(self):
        return f"Peer({self.id[:8]}, {'out' if self.outbound else 'in'})"


class PeerSet:
    """Concurrency-safe keyed peer registry (peer_set.go)."""

    def __init__(self):
        self._mtx = threading.Lock()
        self._by_id: Dict[str, Peer] = {}

    def add(self, peer: Peer) -> None:
        with self._mtx:
            if peer.id in self._by_id:
                raise KeyError(f"duplicate peer {peer.id}")
            self._by_id[peer.id] = peer

    def has(self, peer_id: str) -> bool:
        with self._mtx:
            return peer_id in self._by_id

    def has_ip(self, ip: str) -> bool:
        with self._mtx:
            return any(
                p.socket_addr is not None and p.socket_addr.host == ip
                for p in self._by_id.values()
            )

    def get(self, peer_id: str) -> Optional[Peer]:
        with self._mtx:
            return self._by_id.get(peer_id)

    def remove(self, peer: Peer) -> bool:
        """Remove THIS peer object. Identity-checked: a stale peer's late
        error must not evict the replacement connection that took its ID."""
        with self._mtx:
            cur = self._by_id.get(peer.id)
            if cur is not peer:
                return False
            del self._by_id[peer.id]
            return True

    def list(self) -> List[Peer]:
        with self._mtx:
            return list(self._by_id.values())

    def size(self) -> int:
        with self._mtx:
            return len(self._by_id)
