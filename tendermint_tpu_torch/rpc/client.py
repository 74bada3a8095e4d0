"""RPC client library (ref: rpc/client/ — HTTP client + event/WS client,
used by the reference's tools and integration tests; the port's copy of the
reference package's ``rpc/client.py``, on which ``lite/proxy.RPCProvider``
and ``tools/tm_bench.py`` stand).

``HTTPClient`` — JSON-RPC over HTTP, one method per core route.
``WSEventClient`` — the /websocket endpoint: subscribe to event-bus queries
and iterate events (client-side RFC 6455 with masked frames).
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import queue
import socket
import struct
import threading
from typing import Any, Dict, Iterator, List, Optional

from tendermint_tpu_torch.rpc.websocket import (
    MessageReader,
    OP_CLOSE,
    OP_PING,
    OP_PONG,
    OP_TEXT,
    accept_key,
    make_frame,
)


class RPCClientError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code


def _parse_laddr(addr: str) -> tuple:
    for scheme in ("tcp://", "http://"):
        if addr.startswith(scheme):
            addr = addr[len(scheme):]
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class HTTPClient:
    """rpc/client/httpclient.go — every method returns the route's result
    dict or raises RPCClientError."""

    def __init__(self, addr: str, timeout: float = 10.0):
        self.host, self.port = _parse_laddr(addr)
        self.timeout = timeout

    def call(self, method: str, **params) -> Any:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            body = json.dumps(
                {"jsonrpc": "2.0", "id": 1, "method": method, "params": params}
            )
            conn.request(
                "POST", "/", body=body, headers={"Content-Type": "application/json"}
            )
            resp = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        if "error" in resp and resp["error"]:
            err = resp["error"]
            raise RPCClientError(err.get("code", -1), err.get("message", ""))
        return resp.get("result")

    # -- info ---------------------------------------------------------------
    def status(self) -> dict:
        return self.call("status")

    def health(self) -> dict:
        return self.call("health")

    def genesis(self) -> dict:
        return self.call("genesis")

    def net_info(self) -> dict:
        return self.call("net_info")

    def block(self, height: Optional[int] = None) -> dict:
        return self.call("block", **({"height": height} if height else {}))

    def commit(self, height: Optional[int] = None) -> dict:
        return self.call("commit", **({"height": height} if height else {}))

    def validators(self, height: Optional[int] = None) -> dict:
        return self.call("validators", **({"height": height} if height else {}))

    def dump_consensus_state(self) -> dict:
        return self.call("dump_consensus_state")

    def consensus_state(self) -> dict:
        return self.call("consensus_state")

    def consensus_params(self, height: Optional[int] = None) -> dict:
        return self.call(
            "consensus_params", **({"height": height} if height else {})
        )

    def blockchain(self, min_height: int = 0, max_height: int = 0) -> dict:
        return self.call("blockchain", minHeight=min_height, maxHeight=max_height)

    def block_results(self, height: Optional[int] = None) -> dict:
        return self.call("block_results", **({"height": height} if height else {}))

    def dial_seeds(self, seeds: list) -> dict:
        return self.call("dial_seeds", seeds=seeds)

    def dial_peers(self, peers: list, persistent: bool = False) -> dict:
        return self.call("dial_peers", peers=peers, persistent=persistent)

    def unsafe_flush_mempool(self) -> dict:
        return self.call("unsafe_flush_mempool")

    # -- debug dumps (unsafe-gated server side) -----------------------------
    def dump_trace(self, limit: Optional[int] = None) -> dict:
        return self.call(
            "dump_trace", **({"limit": limit} if limit is not None else {})
        )

    def trace_reset(self, enable=None, capacity: Optional[int] = None) -> dict:
        params = {}
        if enable is not None:
            params["enable"] = enable
        if capacity is not None:
            params["capacity"] = capacity
        return self.call("trace_reset", **params)

    def dump_profile(self, limit: Optional[int] = None) -> dict:
        return self.call(
            "dump_profile", **({"limit": limit} if limit is not None else {})
        )

    def dump_flight(self, limit: Optional[int] = None) -> dict:
        return self.call(
            "dump_flight", **({"limit": limit} if limit is not None else {})
        )

    def flight_reset(self, enable=None, capacity: Optional[int] = None) -> dict:
        params = {}
        if enable is not None:
            params["enable"] = enable
        if capacity is not None:
            params["capacity"] = capacity
        return self.call("flight_reset", **params)

    def dump_critpath(self, limit: Optional[int] = None) -> dict:
        return self.call(
            "dump_critpath", **({"limit": limit} if limit is not None else {})
        )

    def critpath_reset(self, capacity: Optional[int] = None) -> dict:
        return self.call(
            "critpath_reset",
            **({"capacity": capacity} if capacity is not None else {}),
        )

    def dump_quorum(self, limit: Optional[int] = None) -> dict:
        return self.call(
            "dump_quorum", **({"limit": limit} if limit is not None else {})
        )

    def quorum_reset(self, capacity: Optional[int] = None) -> dict:
        return self.call(
            "quorum_reset",
            **({"capacity": capacity} if capacity is not None else {}),
        )

    def dump_telemetry(self, limit: Optional[int] = None) -> dict:
        return self.call(
            "dump_telemetry", **({"limit": limit} if limit is not None else {})
        )

    def telemetry_reset(self, capacity: Optional[int] = None) -> dict:
        return self.call(
            "telemetry_reset",
            **({"capacity": capacity} if capacity is not None else {}),
        )

    def dump_device_health(self) -> dict:
        return self.call("dump_device_health")

    def device_breaker_reset(self, reprobe: Optional[bool] = None) -> dict:
        return self.call(
            "device_breaker_reset",
            **({"reprobe": reprobe} if reprobe is not None else {}),
        )

    def unconfirmed_txs(self, limit: int = 30) -> dict:
        return self.call("unconfirmed_txs", limit=limit)

    def num_unconfirmed_txs(self) -> dict:
        return self.call("num_unconfirmed_txs")

    # -- txs ----------------------------------------------------------------
    def broadcast_tx_async(self, tx: bytes) -> dict:
        return self.call("broadcast_tx_async", tx=base64.b64encode(tx).decode())

    def broadcast_tx_sync(self, tx: bytes) -> dict:
        return self.call("broadcast_tx_sync", tx=base64.b64encode(tx).decode())

    def broadcast_tx_commit(self, tx: bytes) -> dict:
        return self.call("broadcast_tx_commit", tx=base64.b64encode(tx).decode())

    def tx(self, tx_hash: str, prove: bool = False) -> dict:
        return self.call("tx", hash=tx_hash, prove=prove)

    def tx_search(self, query: str, page: int = 1, per_page: int = 30) -> dict:
        return self.call("tx_search", query=query, page=page, per_page=per_page)

    # -- abci ---------------------------------------------------------------
    def abci_info(self) -> dict:
        return self.call("abci_info")

    def abci_query(self, path: str = "", data: bytes = b"", height: int = 0) -> dict:
        return self.call(
            "abci_query", path=path, data=data.hex(), height=height
        )

    def metrics_text(self) -> str:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request("GET", "/metrics")
            return conn.getresponse().read().decode()
        finally:
            conn.close()


class WSEventClient:
    """Client side of the /websocket subscribe endpoint."""

    def __init__(self, addr: str, timeout: float = 10.0):
        host, port = _parse_laddr(addr)
        self._sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        req = (
            f"GET /websocket HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
        )
        self._sock.sendall(req.encode())
        self._rfile = self._sock.makefile("rb")
        status = self._rfile.readline()
        if b"101" not in status:
            raise ConnectionError(f"websocket upgrade refused: {status!r}")
        while self._rfile.readline() not in (b"\r\n", b""):
            pass
        self._reader = MessageReader(self._rfile)
        self._next_id = 0
        self._events: "queue.Queue[dict]" = queue.Queue()
        self._acks: "queue.Queue[dict]" = queue.Queue()
        self._closed = threading.Event()
        threading.Thread(target=self._recv_loop, name="ws-client-recv", daemon=True).start()

    # -- frame IO -------------------------------------------------------------
    def _send_json(self, obj) -> None:
        payload = json.dumps(obj).encode()
        mask = os.urandom(4)
        n = len(payload)
        head = bytes([0x80 | OP_TEXT])
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 1 << 16:
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self._sock.sendall(head + mask + masked)

    def _recv_loop(self) -> None:
        try:
            while not self._closed.is_set():
                msg = self._reader.next()
                if msg is None:
                    return
                opcode, payload = msg
                if opcode == OP_PING:
                    self._sock.sendall(make_frame(OP_PONG, payload))
                    continue
                if opcode == OP_CLOSE:
                    return
                if opcode != OP_TEXT:
                    continue
                obj = json.loads(payload)
                if isinstance(obj.get("id"), str) and obj["id"].endswith("#event"):
                    self._events.put(obj)
                else:
                    self._acks.put(obj)
        except OSError:
            pass
        finally:
            self._closed.set()

    # -- API -------------------------------------------------------------------
    def subscribe(self, query: str, timeout: float = 10.0) -> None:
        self._next_id += 1
        self._send_json(
            {"jsonrpc": "2.0", "id": self._next_id, "method": "subscribe",
             "params": {"query": query}}
        )
        ack = self._acks.get(timeout=timeout)
        if ack.get("error"):
            raise RPCClientError(
                ack["error"].get("code", -1), ack["error"].get("message", "")
            )

    def unsubscribe(self, query: str, timeout: float = 10.0) -> None:
        self._next_id += 1
        self._send_json(
            {"jsonrpc": "2.0", "id": self._next_id, "method": "unsubscribe",
             "params": {"query": query}}
        )
        self._acks.get(timeout=timeout)

    def next_event(self, timeout: Optional[float] = None) -> dict:
        """The next pushed event's result {query, data:{type, value, tags}}."""
        return self._events.get(timeout=timeout)["result"]

    def events(self, timeout: float = 1.0) -> Iterator[dict]:
        while not self._closed.is_set():
            try:
                yield self.next_event(timeout=timeout)
            except queue.Empty:
                return

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
