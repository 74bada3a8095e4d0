"""JSON-RPC 2.0 over HTTP (+ GET URI routes) (ref: rpc/lib/server/).

POST / with {"jsonrpc":"2.0","method":...,"params":...} or GET /<method>?arg=v
— the same dual surface the reference exposes (the port's copy of the
reference package's ``rpc/server.py``).  Handlers come from
rpc.core.env.RPCEnv; public callables become routes (reflection dispatch like
rpc/lib/server's func-signature routing).
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.rpc.core.env import RPCEnv, RPCError


def _parse_laddr(laddr: str):
    if laddr.startswith("tcp://"):
        laddr = laddr[len("tcp://"):]
    host, port = laddr.rsplit(":", 1)
    return host or "0.0.0.0", int(port)


class RPCServer(BaseService):
    def __init__(self, laddr: str, env: RPCEnv):
        super().__init__("rpc.Server")
        self.laddr = laddr
        self.env = env
        self._httpd: Optional[ThreadingHTTPServer] = None

    @property
    def bound_port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def on_start(self) -> None:
        env = self.env
        logger = self.logger

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("rpc: " + fmt, *args)

            def _send(self, obj, status=200):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _call(self, method: str, params: dict, req_id):
                fn = getattr(env, method, None)
                if fn is None or method.startswith("_") or not callable(fn):
                    return self._send(
                        _err(req_id, -32601, f"method {method!r} not found")
                    )
                try:
                    with trace.span("rpc.dispatch", method=method):
                        result = fn(**params)
                    self._send({"jsonrpc": "2.0", "id": req_id, "result": result})
                except RPCError as e:
                    self._send(_err(req_id, e.code, e.message))
                except TypeError as e:
                    self._send(_err(req_id, -32602, f"invalid params: {e}"))
                except Exception as e:
                    logger.error("rpc %s failed: %s", method, e)
                    self._send(_err(req_id, -32603, str(e)))

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    return self._send(_err(None, -32700, "parse error"), 400)
                method = req.get("method", "")
                params = req.get("params") or {}
                if isinstance(params, list):
                    return self._send(
                        _err(req.get("id"), -32602, "positional params unsupported")
                    )
                self._call(method, params, req.get("id"))

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                method = parsed.path.strip("/")
                if method == "websocket":
                    return self._upgrade_websocket()
                if method == "metrics":
                    reg = getattr(env.node, "metrics", None)
                    if reg is None:
                        # 200 + comment, not 404: scrapers must be able to
                        # tell "instrumentation off" from "no such route"
                        body = (
                            b"# metrics disabled "
                            b"(instrumentation.prometheus = false)\n"
                        )
                    else:
                        body = reg.registry.expose_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if method == "":
                    # route listing, like the reference's index page
                    routes = sorted(
                        m for m in dir(env)
                        if not m.startswith("_") and callable(getattr(env, m))
                    )
                    return self._send({"jsonrpc": "2.0", "result": {"routes": routes}})
                params = {
                    k: _coerce(v[0])
                    for k, v in urllib.parse.parse_qs(parsed.query).items()
                }
                self._call(method, params, -1)

            def _upgrade_websocket(self):
                """RFC 6455 handshake, then hand the socket to a WSSession
                (the reference's /websocket endpoint, ws_handler.go)."""
                from tendermint_tpu_torch.rpc.websocket import WSSession, accept_key

                key = self.headers.get("Sec-WebSocket-Key")
                upgrade = (self.headers.get("Upgrade") or "").lower()
                if key is None or upgrade != "websocket":
                    return self._send(_err(None, -32600, "not a websocket upgrade"), 400)
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", accept_key(key))
                self.end_headers()
                self.close_connection = True
                WSSession(self, env.node.event_bus, logger).run()

        host, port = _parse_laddr(self.laddr)
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        self.logger.info("RPC listening on %s", self.laddr)

    def on_stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()


def _coerce(v: str):
    """GET query params arrive as strings; unquote the reference's conventions:
    0x-prefixed hex stays string, quoted strings unquote, ints parse."""
    if v.startswith('"') and v.endswith('"'):
        return v[1:-1]
    if v in ("true", "false"):
        return v == "true"
    try:
        return int(v)
    except ValueError:
        return v


def _err(req_id, code, message):
    return {
        "jsonrpc": "2.0",
        "id": req_id,
        "error": {"code": code, "message": message},
    }
