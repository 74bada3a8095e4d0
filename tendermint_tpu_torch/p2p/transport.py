"""MultiplexTransport: TCP accept and dial with the two-step upgrade every
connection goes through before it may become a Peer (ref
p2p/transport.go:115, upgrade discipline :359-419), the port's copy of the
reference package's ``p2p/transport.py``:

1. **SecretConnection** handshake (authenticated encryption, peer identity =
   ed25519 pubkey) with a deadline;
2. **NodeInfo** exchange + validation + compatibility check; for outbound
   dials the authenticated ID must equal the dialed ID
   (transport.go:413 / errors.go ErrRejected auth failure).

Connection filters run before the upgrade (e.g. duplicate-IP,
transport.go:68-87). Accepted+upgraded conns are queued; the Switch drains
them with ``accept()``, mirroring the reference's acceptPeers goroutine and
channel.

Where the port differs: the upgrade and dial deadlines are arguments
(``handshake_timeout``, ``dial_timeout``), so that ``node/verify_root.switch``
can apply the ``[p2p]`` section's; they default to the reference's module
constants.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from tendermint_tpu_torch.encoding.codec import length_prefix
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.conn.secret_connection import (
    HandshakeError,
    RawConn,
    SecretConnection,
    read_length_prefixed_stream,
)
from tendermint_tpu_torch.p2p.errors import RejectedError, TransportClosedError
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.node_info import NodeInfo

# the Go reference uses 3s (transport.go:26); under multi-process startup
# contention a 3s budget flakes, and the config default is 20s
# (config.go HandshakeTimeout)
HANDSHAKE_TIMEOUT = 10.0
DIAL_TIMEOUT = 10.0
MAX_NODE_INFO_SIZE = 10 * 1024


@dataclass
class UpgradedConn:
    """A fully authenticated + handshaked connection, ready to become a Peer."""

    conn: SecretConnection
    node_info: NodeInfo
    socket_addr: NetAddress  # observed remote address (dialed or accepted)
    outbound: bool


class MultiplexTransport(BaseService):
    def __init__(
        self,
        node_info: NodeInfo,
        node_key: NodeKey,
        conn_filters: Optional[List[Callable[[str], Optional[str]]]] = None,
        accept_queue_size: int = 64,
        handshake_timeout: float = HANDSHAKE_TIMEOUT,
        dial_timeout: float = DIAL_TIMEOUT,
    ):
        """conn_filters: callables "ip:port" -> rejection reason or None
        (full remote address, matching the reference's filter protocol)."""
        super().__init__(name="MultiplexTransport")
        self.node_info = node_info
        self.node_key = node_key
        self.conn_filters = conn_filters or []
        self.handshake_timeout = handshake_timeout
        self.dial_timeout = dial_timeout
        self._listener: Optional[socket.socket] = None
        self._accept_q: "queue.Queue" = queue.Queue(maxsize=accept_queue_size)
        self._listen_addr: Optional[NetAddress] = None

    # -- listening ----------------------------------------------------------------
    def listen(self, addr: str) -> NetAddress:
        """Bind + start the accept loop. addr is host:port (port 0 = ephemeral)."""
        host, _, port = addr.rpartition(":")
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((host or "0.0.0.0", int(port)))
        ls.listen(64)
        self._listener = ls
        bound = ls.getsockname()
        self._listen_addr = NetAddress(self.node_info.id, bound[0], bound[1])
        if not self.is_running:
            self.start()
        threading.Thread(
            target=self._accept_loop, name="transport-accept", daemon=True
        ).start()
        return self._listen_addr

    @property
    def listen_address(self) -> Optional[NetAddress]:
        return self._listen_addr

    def _accept_loop(self) -> None:
        while not self._quit.is_set():
            try:
                sock, peer_addr = self._listener.accept()
            except OSError:
                break  # listener closed
            threading.Thread(
                target=self._upgrade_inbound,
                args=(sock, peer_addr),
                name="transport-upgrade",
                daemon=True,
            ).start()
        self._push_closed_sentinel()

    def _upgrade_inbound(self, sock: socket.socket, peer_addr) -> None:
        """Upgrade in a worker thread so one slow/malicious dialer can't stall
        the accept loop (reference upgrades concurrently too, transport.go:232)."""
        try:
            for f in self.conn_filters:
                # full ip:port, matching the reference's filter protocol
                # (node.go queries /p2p/filter/addr/<RemoteAddr().String()>)
                reason = f(f"{peer_addr[0]}:{peer_addr[1]}")
                if reason:
                    raise RejectedError(reason, is_filtered=True)
            conn, ni = self._upgrade(sock, dialed_id=None)
        except Exception as e:
            try:
                sock.close()
            except OSError:
                pass
            self.logger.debug("inbound upgrade failed from %s: %s", peer_addr, e)
            return
        up = UpgradedConn(
            conn=conn,
            node_info=ni,
            socket_addr=NetAddress(ni.id, peer_addr[0], peer_addr[1]),
            outbound=False,
        )
        try:
            self._accept_q.put(up, timeout=self.handshake_timeout)
        except queue.Full:
            conn.close()

    def accept(self, timeout: Optional[float] = None) -> UpgradedConn:
        """Next fully-upgraded inbound connection. Raises TransportClosedError
        once the transport stops."""
        if self._quit.is_set() and self._accept_q.empty():
            raise TransportClosedError("transport stopped")
        item = self._accept_q.get(timeout=timeout)
        if isinstance(item, Exception):
            self._push_closed_sentinel()  # re-arm for any other waiter
            raise item
        return item

    def _push_closed_sentinel(self) -> None:
        """Non-blocking: if the queue is full, pending items will be drained
        first and accept() re-checks _quit before ever blocking again."""
        try:
            self._accept_q.put_nowait(TransportClosedError("transport stopped"))
        except queue.Full:
            pass

    # -- dialing -------------------------------------------------------------------
    def dial(self, addr: NetAddress) -> UpgradedConn:
        """Connect + upgrade. The peer's authenticated ID must match addr.id."""
        sock = socket.create_connection(
            (addr.host, addr.port), timeout=self.dial_timeout
        )
        try:
            # filter on the RESOLVED remote address (getpeername), not the
            # configured hostname — the accept path sees numeric ip:port, and
            # a blocklist must match a dialed peer the same way
            peer = sock.getpeername()
            for f in self.conn_filters:
                reason = f(f"{peer[0]}:{peer[1]}")
                if reason:
                    raise RejectedError(reason, is_filtered=True)
            conn, ni = self._upgrade(sock, dialed_id=addr.id)
        except Exception:
            try:
                sock.close()
            except OSError:
                pass
            raise
        return UpgradedConn(conn=conn, node_info=ni, socket_addr=addr, outbound=True)

    # -- the upgrade itself ----------------------------------------------------------
    def _upgrade(
        self, sock: socket.socket, dialed_id: Optional[str]
    ) -> tuple[SecretConnection, NodeInfo]:
        raw = RawConn(sock)
        # absolute deadline over the whole upgrade: a per-recv timeout alone
        # would let a slow-loris dialer pin an upgrade thread forever
        raw.set_deadline(time.monotonic() + self.handshake_timeout)
        try:
            sconn = SecretConnection(raw, self.node_key.priv_key)
        except (HandshakeError, OSError, ConnectionError) as e:
            raise RejectedError(f"secret handshake: {e}", is_auth_failure=True) from e

        authed_id = sconn.remote_pubkey.address().hex()
        if dialed_id is not None and authed_id != dialed_id:
            sconn.close()
            raise RejectedError(
                f"dialed {dialed_id[:8]} but authenticated {authed_id[:8]}",
                is_auth_failure=True,
            )

        ni = self._exchange_node_info(sconn)
        try:
            ni.validate()
        except ValueError as e:
            sconn.close()
            raise RejectedError(f"invalid NodeInfo: {e}") from e
        if ni.id != authed_id:
            sconn.close()
            raise RejectedError(
                f"NodeInfo.ID {ni.id[:8]} != authenticated {authed_id[:8]}",
                is_auth_failure=True,
            )
        if ni.id == self.node_info.id:
            sconn.close()
            raise RejectedError("connect to self", is_self=True)
        try:
            self.node_info.compatible_with(ni)
        except ValueError as e:
            sconn.close()
            raise RejectedError(str(e), is_incompatible=True) from e
        raw.set_deadline(None)
        return sconn, ni

    def _exchange_node_info(self, sconn: SecretConnection) -> NodeInfo:
        sconn.write(length_prefix(self.node_info.to_bytes()))
        try:
            payload = read_length_prefixed_stream(
                sconn.read_exactly, MAX_NODE_INFO_SIZE
            )
            return NodeInfo.from_bytes(payload)
        except ConnectionError:
            raise
        except Exception as e:
            raise RejectedError(f"malformed NodeInfo: {e}") from e

    # -- lifecycle ----------------------------------------------------------------
    def on_stop(self) -> None:
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self._push_closed_sentinel()
