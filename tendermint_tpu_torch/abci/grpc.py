"""The gRPC transport for ABCI and the RPC's BroadcastAPI (ref
abci/client/grpc_client.go, abci/server/grpc_server.go, rpc/grpc/api.go's
Ping and BroadcastTx; the port's copy of the reference package's
``abci/grpc.py``, which it speaks to both ways).

No generated protobuf stubs: grpc's generic handlers with the JSON message
codec (``abci/types.msg_to_json``) as the serializer, the service and
method names of the reference package. The contract (the method set, the
request and response shapes, one RPC an ABCI call) is what is mirrored.
``grpcio`` is needed only once a gRPC transport is built: without it
``_require_grpc`` raises there, and every other module of the ABCI tree
still imports.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

try:
    import grpc

    _GRPC_ERR = None
except ImportError as _e:  # pragma: no cover - environment-dependent
    grpc = None
    _GRPC_ERR = _e

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.libs.service import BaseService

_SERVICE = "tendermint.abci.ABCIApplication"

# gRPC method name -> Application method name
_METHODS = {
    "Echo": "echo",
    "Flush": "flush",
    "Info": "info",
    "SetOption": "set_option",
    "DeliverTx": "deliver_tx",
    "CheckTx": "check_tx",
    "Query": "query",
    "Commit": "commit",
    "InitChain": "init_chain",
    "BeginBlock": "begin_block",
    "EndBlock": "end_block",
    "ListSnapshots": "list_snapshots",
    "OfferSnapshot": "offer_snapshot",
    "LoadSnapshotChunk": "load_snapshot_chunk",
    "ApplySnapshotChunk": "apply_snapshot_chunk",
}


def _require_grpc(what: str) -> None:
    if _GRPC_ERR is not None:
        raise ImportError(
            f"{what} needs the 'grpcio' package: {_GRPC_ERR}"
        )


class GRPCServer(BaseService):
    """Serves an Application over gRPC (abci/server/grpc_server.go)."""

    def __init__(self, addr: str, app: abci.Application):
        super().__init__("abci.GRPCServer")
        _require_grpc("abci.GRPCServer")
        self.addr = addr.replace("tcp://", "")
        self.app = app
        self._server: Optional[grpc.Server] = None
        self.bound_port: Optional[int] = None

    def on_start(self) -> None:
        from concurrent import futures

        mtx = threading.Lock()  # ABCI calls are serialized as LocalClient's

        def make_handler(app_method: str):
            if app_method == "flush":
                # Flush is the transport's, not an Application method (the
                # socket server answers it inline too)
                return lambda request, context: abci.ResponseFlush()

            def handler(request, context):
                with mtx:
                    try:
                        return getattr(self.app, app_method)(request)
                    except Exception as e:
                        # as the socket server: an app's crash travels as
                        # ResponseException on every transport
                        return abci.ResponseException(error=str(e))

            return handler

        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                make_handler(app_method),
                request_deserializer=abci.msg_from_json,
                response_serializer=abci.msg_to_json,
            )
            for name, app_method in _METHODS.items()
        }
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        self.bound_port = self._server.add_insecure_port(self.addr)
        if self.bound_port == 0:
            raise OSError(f"could not bind gRPC ABCI server to {self.addr}")
        self._server.start()
        self.logger.info("ABCI gRPC server on %s", self.addr)

    def on_stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1.0)


class GRPCClient(BaseService):
    """ABCI client over gRPC, the surface of SocketClient and LocalClient
    (abci/client/grpc_client.go): ``<method>_sync`` calls and a
    ``request_async`` that completes inline."""

    CONNECT_TIMEOUT = 5.0

    def __init__(self, addr: str, must_connect: bool = True):
        super().__init__("abci.GRPCClient")
        _require_grpc("abci.GRPCClient")
        self.addr = addr.replace("tcp://", "")
        self._must_connect = must_connect
        self._channel: Optional[grpc.Channel] = None
        self._stubs = {}
        self._cb = None
        self._err: Optional[Exception] = None

    def on_start(self) -> None:
        self._channel = grpc.insecure_channel(self.addr)
        if self._must_connect:
            # channels are lazy: fail at start as SocketClient does, not
            # inside the first handshake call
            grpc.channel_ready_future(self._channel).result(
                timeout=self.CONNECT_TIMEOUT
            )
        # one stub a method, built once (DeliverTx and CheckTx run a tx)
        self._stubs = {
            name: self._channel.unary_unary(
                f"/{_SERVICE}/{name}",
                request_serializer=abci.msg_to_json,
                response_deserializer=abci.msg_from_json,
            )
            for name in _METHODS
        }

    def on_stop(self) -> None:
        if self._channel is not None:
            self._channel.close()

    def set_response_callback(self, cb) -> None:
        self._cb = cb

    def error(self) -> Optional[Exception]:
        return self._err

    def _call(self, method: str, req: Any) -> Any:
        from tendermint_tpu_torch.abci.client import ABCIClientError

        stub = self._stubs[method]
        try:
            res = stub(req)
        except grpc.RpcError as e:
            self._err = e
            raise
        if isinstance(res, abci.ResponseException):
            # the app crashed: the error SocketClient raises
            raise ABCIClientError(res.error)
        if self._cb is not None:
            self._cb(req, res)
        return res

    def request_sync(self, req: Any) -> Any:
        name = type(req).__name__.removeprefix("Request")
        return self._call(name, req)

    def request_async(self, req: Any):
        from tendermint_tpu_torch.abci.client import ReqRes

        rr = ReqRes(req)
        rr.complete(self.request_sync(req))
        return rr

    def flush_sync(self) -> None:
        self._call("Flush", abci.RequestFlush())

    def flush_async(self) -> None:
        self.flush_sync()

    def __getattr__(self, name: str):
        # echo_sync / deliver_tx_sync / ... -> one gRPC call each
        # ("deliver_tx" capitalizes segment-wise to "DeliverTx")
        if name.endswith("_sync"):
            method = "".join(p.capitalize() for p in name[:-5].split("_"))
            return lambda req: self._call(method, req)
        if name.endswith("_async"):
            return self.request_async
        raise AttributeError(name)


# -- the RPC's BroadcastAPI (rpc/grpc/api.go): Ping and BroadcastTx ----------------

_BROADCAST_SERVICE = "tendermint.rpc.grpc.BroadcastAPI"


class BroadcastAPIServer(BaseService):
    """The gRPC BroadcastTx endpoint on a node's mempool, answering with
    the CheckTx result (node.go startRPC's grpccore.StartGRPCServer).
    ``Node`` runs it at ``rpc.grpc_laddr``."""

    def __init__(self, addr: str, node):
        super().__init__("rpc.GRPCBroadcast")
        _require_grpc("rpc.BroadcastAPIServer")
        self.addr = addr.replace("tcp://", "")
        self.node = node
        self._server = None
        self.bound_port: Optional[int] = None

    def on_start(self) -> None:
        import base64
        import json
        from concurrent import futures

        from tendermint_tpu_torch.rpc.core.env import RPCEnv, RPCError

        env = RPCEnv(self.node)

        def ping(request, context):
            return b"{}"

        def broadcast_tx(request, context):
            # the HTTP route's handler: one broadcast for both transports
            tx = bytes(json.loads(request)["tx"].encode("latin1"))
            try:
                out = env.broadcast_tx_sync(base64.b64encode(tx).decode())
            except RPCError as e:
                return json.dumps({"error": e.message}).encode()
            except Exception as e:
                return json.dumps({"error": str(e)}).encode()
            return json.dumps({"check_tx": out}).encode()

        handlers = {
            "Ping": grpc.unary_unary_rpc_method_handler(
                ping, request_deserializer=None, response_serializer=None
            ),
            "BroadcastTx": grpc.unary_unary_rpc_method_handler(
                broadcast_tx, request_deserializer=None, response_serializer=None
            ),
        }
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_BROADCAST_SERVICE, handlers),)
        )
        self.bound_port = self._server.add_insecure_port(self.addr)
        if self.bound_port == 0:
            raise OSError(f"could not bind gRPC broadcast server to {self.addr}")
        self._server.start()

    def on_stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1.0)


def broadcast_tx_via_grpc(addr: str, tx: bytes, timeout: float = 10.0) -> dict:
    """Client helper for the BroadcastAPI (rpc/grpc/client_server.go)."""
    _require_grpc("broadcast_tx_via_grpc")
    import json

    channel = grpc.insecure_channel(addr.replace("tcp://", ""))
    try:
        stub = channel.unary_unary(f"/{_BROADCAST_SERVICE}/BroadcastTx")
        res = stub(
            json.dumps({"tx": tx.decode("latin1")}).encode(), timeout=timeout
        )
        return json.loads(res)
    finally:
        channel.close()
