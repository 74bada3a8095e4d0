"""ABCI clients (ref abci/client/), the port's copy of the reference
package's ``abci/client.py``.

  * ``LocalClient`` runs an in-proc app inline behind one mutex
    (local_client.go). Its async calls complete before they return: the
    global response callback (the mempool's) runs first, then
    ``ReqRes.complete`` and the request's own callback.
  * ``SocketClient`` talks to an app in another process over TCP or a unix
    socket, in uvarint-length-delimited JSON frames (``abci/types.py``'s
    ``msg_to_json``), the reference's bytes (socket_client.go's pipeline:
    async sends and Flush barriers). ``RequestCheckTx.sig_verified`` crosses
    as the codec carries it; a remote app publishes no signature extractor
    to the node, so it verifies its own CheckTx.

Each has ``<method>_sync`` / ``<method>_async`` wrappers (``echo_sync``,
``deliver_tx_async``, ...).
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Any, Callable, Optional, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.encoding.codec import encode_uvarint
from tendermint_tpu_torch.libs.service import BaseService


class ABCIClientError(Exception):
    pass


class ReqRes:
    """Pending request handle; its callback fires on completion."""

    def __init__(self, request: Any):
        self.request = request
        self.response: Any = None
        self._done = threading.Event()
        self._cb: Optional[Callable[[Any, Any], None]] = None
        self._cb_mtx = threading.Lock()

    def complete(self, response: Any) -> None:
        self.response = response
        self._done.set()
        with self._cb_mtx:
            cb = self._cb
        if cb:
            cb(self.request, response)

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise ABCIClientError("ABCI request timed out")
        return self.response

    def set_callback(self, cb: Callable[[Any, Any], None]) -> None:
        with self._cb_mtx:
            self._cb = cb
        if self._done.is_set():
            cb(self.request, self.response)


_METHODS = {
    abci.RequestEcho: "echo",
    abci.RequestInfo: "info",
    abci.RequestSetOption: "set_option",
    abci.RequestInitChain: "init_chain",
    abci.RequestQuery: "query",
    abci.RequestBeginBlock: "begin_block",
    abci.RequestCheckTx: "check_tx",
    abci.RequestDeliverTx: "deliver_tx",
    abci.RequestEndBlock: "end_block",
    abci.RequestCommit: "commit",
    abci.RequestListSnapshots: "list_snapshots",
    abci.RequestOfferSnapshot: "offer_snapshot",
    abci.RequestLoadSnapshotChunk: "load_snapshot_chunk",
    abci.RequestApplySnapshotChunk: "apply_snapshot_chunk",
}
_REQ_BY_STEM = {v: k for k, v in _METHODS.items()}


def _typed_wrapper(client, name: str):
    """``echo_sync`` / ``deliver_tx_async`` / ...: the request of the
    method's stem through ``request_sync`` or ``request_async``, memoized on
    ``client`` (``__getattr__`` runs on every miss)."""
    if name.endswith("_sync") or name.endswith("_async"):
        stem, _, kind = name.rpartition("_")
        req_cls = _REQ_BY_STEM.get(stem)
        if req_cls is not None:
            call = client.request_sync if kind == "sync" else client.request_async
            fn = lambda req=None: call(req or req_cls())  # noqa: E731
            setattr(client, name, fn)
            return fn
    raise AttributeError(name)


class LocalClient(BaseService):
    """Mutex-serialized direct calls into an in-proc Application
    (ref local_client.go)."""

    def __init__(self, app: abci.Application, mtx: Optional[threading.Lock] = None):
        super().__init__("abci.LocalClient")
        self._app = app
        self._mtx = mtx or threading.Lock()
        self._global_cb: Optional[Callable[[Any, Any], None]] = None

    def set_response_callback(self, cb: Callable[[Any, Any], None]) -> None:
        self._global_cb = cb

    def _call(self, req: Any) -> Any:
        if isinstance(req, abci.RequestFlush):
            return abci.ResponseFlush()
        with self._mtx:
            res = getattr(self._app, _METHODS[type(req)])(req)
        return res

    # the async shape, completed inline ------------------------------------------
    def request_async(self, req: Any) -> ReqRes:
        rr = ReqRes(req)
        res = self._call(req)
        if self._global_cb:
            self._global_cb(req, res)
        rr.complete(res)
        return rr

    def request_sync(self, req: Any) -> Any:
        # no ReqRes handle: the call completes inline
        res = self._call(req)
        if self._global_cb:
            self._global_cb(req, res)
        return res

    def flush_sync(self) -> None:
        pass

    def error(self) -> Optional[Exception]:
        return None

    def __getattr__(self, name: str):
        return _typed_wrapper(self, name)


class SocketClient(BaseService):
    """A remote app over a stream socket; frames are uvarint(len) + JSON.
    Requests pipeline; Flush makes the server answer everything queued
    (ref socket_client.go:406)."""

    def __init__(self, addr: str, must_connect: bool = True):
        super().__init__("abci.SocketClient")
        self.addr = addr
        self._sock: Optional[socket.socket] = None
        self._pending: "queue.Queue[ReqRes]" = queue.Queue()
        self._send_q: "queue.Queue[ReqRes]" = queue.Queue()
        self._req_mtx = threading.Lock()
        self._err: Optional[Exception] = None
        self._global_cb: Optional[Callable[[Any, Any], None]] = None
        self._must_connect = must_connect

    def on_start(self) -> None:
        self._sock = _dial(self.addr)
        threading.Thread(target=self._send_loop, name="abci-send", daemon=True).start()
        threading.Thread(target=self._recv_loop, name="abci-recv", daemon=True).start()

    def on_stop(self) -> None:
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass

    def set_response_callback(self, cb: Callable[[Any, Any], None]) -> None:
        self._global_cb = cb

    def error(self) -> Optional[Exception]:
        return self._err

    def _send_loop(self) -> None:
        while not self.quit_event.is_set():
            try:
                rr = self._send_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                payload = abci.msg_to_json(rr.request)
                self._sock.sendall(encode_uvarint(len(payload)) + payload)
            except OSError as e:
                self._err = e
                return

    def _recv_loop(self) -> None:
        buf = b""
        while not self.quit_event.is_set():
            try:
                frame, buf = _read_frame(self._sock, buf)
            except OSError as e:
                self._err = e
                return
            if frame is None:
                self._err = ABCIClientError("server closed connection")
                return
            res = abci.msg_from_json(frame)
            try:
                rr = self._pending.get_nowait()
            except queue.Empty:
                self._err = ABCIClientError("unexpected response")
                return
            if self._global_cb:
                self._global_cb(rr.request, res)
            rr.complete(res)

    def request_async(self, req: Any) -> ReqRes:
        rr = ReqRes(req)
        # both enqueues at once: callers interleaving them (peer filters,
        # the RPC's abci_query, the mempool) would pair responses with the
        # wrong requests
        with self._req_mtx:
            self._pending.put(rr)
            self._send_q.put(rr)
        return rr

    def request_sync(self, req: Any, timeout: float = 10.0) -> Any:
        rr = self.request_async(req)
        self.request_async(abci.RequestFlush())
        res = rr.wait(timeout)
        if isinstance(res, abci.ResponseException):
            raise ABCIClientError(res.error)
        return res

    def flush_sync(self, timeout: float = 10.0) -> None:
        self.request_async(abci.RequestFlush()).wait(timeout)

    def __getattr__(self, name: str):
        return _typed_wrapper(self, name)


def _dial(addr: str) -> socket.socket:
    """addr: 'tcp://host:port' or 'unix:///path'."""
    if addr.startswith("unix://"):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(addr[len("unix://"):])
        return s
    if addr.startswith("tcp://"):
        host, port = addr[len("tcp://"):].rsplit(":", 1)
        return socket.create_connection((host, int(port)))
    raise ValueError(f"unsupported ABCI address {addr!r}")


def _read_frame(sock: socket.socket, buf: bytes) -> Tuple[Optional[bytes], bytes]:
    """Read one uvarint-length-prefixed frame: (frame or None at EOF, the
    bytes left over)."""
    while True:
        n = shift = i = 0
        ok = False
        for i, b in enumerate(buf):
            n |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                ok = True
                break
            if shift > 35:
                raise OSError("frame length varint too long")
        if ok and len(buf) >= i + 1 + n:
            start = i + 1
            return buf[start:start + n], buf[start + n:]
        chunk = sock.recv(65536)
        if not chunk:
            return None, buf
        buf += chunk
