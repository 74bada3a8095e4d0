"""The ABCI socket server: serves an Application to nodes in other
processes (ref abci/server/socket_server.go; the port's copy of the
reference package's ``abci/server.py``).

Frames: uvarint(len) + the JSON message (``abci/types.py``). One thread a
connection; requests on a connection run in order, and one mutex over the
app serializes the connections (the reference's per-app lock). An app's
exception is answered with ``ResponseException``.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import _METHODS, _read_frame
from tendermint_tpu_torch.encoding.codec import encode_uvarint
from tendermint_tpu_torch.libs.service import BaseService


class ABCIServer(BaseService):
    def __init__(self, addr: str, app: abci.Application):
        super().__init__("abci.Server")
        self.addr = addr
        self._app = app
        self._app_mtx = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._conns = []

    def on_start(self) -> None:
        if self.addr.startswith("unix://"):
            path = self.addr[len("unix://"):]
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listener.bind(path)
        elif self.addr.startswith("tcp://"):
            host, port = self.addr[len("tcp://"):].rsplit(":", 1)
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, int(port)))
        else:
            raise ValueError(f"unsupported ABCI address {self.addr!r}")
        self._listener.listen(8)
        threading.Thread(target=self._accept_loop, name="abci-accept", daemon=True).start()

    @property
    def bound_port(self) -> Optional[int]:
        if self._listener and self._listener.family == socket.AF_INET:
            return self._listener.getsockname()[1]
        return None

    def on_stop(self) -> None:
        if self._listener:
            try:
                self._listener.close()
            except OSError:
                pass
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self.quit_event.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,), name="abci-conn",
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        buf = b""
        while not self.quit_event.is_set():
            try:
                frame, buf = _read_frame(conn, buf)
            except OSError:
                return
            if frame is None:
                return
            req = abci.msg_from_json(frame)
            try:
                if isinstance(req, abci.RequestFlush):
                    res = abci.ResponseFlush()
                else:
                    with self._app_mtx:
                        res = getattr(self._app, _METHODS[type(req)])(req)
            except Exception as e:  # an app's crash travels as ResponseException
                res = abci.ResponseException(error=str(e))
            payload = abci.msg_to_json(res)
            try:
                conn.sendall(encode_uvarint(len(payload)) + payload)
            except OSError:
                return
