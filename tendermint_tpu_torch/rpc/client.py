"""JSON-RPC over HTTP: the port's copy of ``HTTPClient.call`` / ``status``
and ``RPCClientError`` of the reference package's ``rpc/client.py``
(rpc/client/httpclient.go), which ``lite/proxy.RPCProvider`` stands on.
The other routes and the websocket client come with the RPC server."""

from __future__ import annotations

import http.client
import json
from typing import Any


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
    """Every method returns the route's result or raises RPCClientError;
    each call opens one connection with ``timeout`` seconds on its
    socket."""

    def __init__(self, addr: str, timeout: float = 10.0):
        self.host, self.port = _parse_laddr(addr)
        self.timeout = timeout

    def call(self, method: str, **params) -> Any:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method, "params": params})
            conn.request("POST", "/", body=body, headers={"Content-Type": "application/json"})
            resp = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        if "error" in resp and resp["error"]:
            err = resp["error"]
            raise RPCClientError(err.get("code", -1), err.get("message", ""))
        return resp.get("result")

    def status(self) -> dict:
        return self.call("status")
