"""RemoteDB — the KV store served over gRPC (ref: libs/db/remotedb/ +
remotedb/grpcdb/: a DB service a node can keep on another machine).

Like the ABCI gRPC transport (abci/grpc.py), no generated protobuf stubs:
grpc's generic handler API with this framework's deterministic codec as the
message serializer (wire compatibility with the reference's proto schema is
a non-goal; the contract — named DBs behind one server, the full DB method
set over the network — is what's mirrored). Iterators are collected
server-side and returned in one response rather than streamed: remote
iteration in the reference exists for operator tooling over bounded ranges,
and a single framed response keeps the client's DB interface synchronous.

The port's copy of the reference package's ``libs/db/remote.py``, which it
serves and calls both ways. ``grpcio`` is needed only once a server or a
client is built: without it ``_require_grpc`` raises there, as
``abci/grpc.py``'s does, and the module still imports. ``new_db``'s
``remote`` backend is a ``RemoteDB`` (``libs/db/kv.py``).
"""

from __future__ import annotations

import hmac
import threading
from typing import Dict, Iterator, Optional, Tuple

try:
    import grpc

    _GRPC_ERR = None
    _ServerInterceptor = grpc.ServerInterceptor
except ImportError as _e:  # pragma: no cover - environment-dependent
    grpc = None
    _GRPC_ERR = _e
    _ServerInterceptor = object

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.libs.db.kv import DB, Batch, new_db
from tendermint_tpu_torch.libs.service import BaseService

_SERVICE = "tendermint.db.RemoteDB"
_METHODS = ("InitRemote", "Get", "Has", "Set", "SetSync", "Delete",
            "DeleteSync", "Iterator", "BatchWrite", "Stats")


def _require_grpc(what: str) -> None:
    if _GRPC_ERR is not None:
        raise ImportError(f"{what} needs the 'grpcio' package: {_GRPC_ERR}")


def _enc(*fields) -> bytes:
    w = Writer()
    for f in fields:
        if isinstance(f, bool):
            w.bool(f)
        elif isinstance(f, int):
            w.svarint(f)
        elif isinstance(f, str):
            w.string(f)
        elif f is None:
            w.bool(False)
        else:
            w.bytes(bytes(f))
    return w.build()


def _opt_bytes(w: Writer, b: Optional[bytes]) -> None:
    if b is None:
        w.bool(False)
    else:
        w.bool(True)
        w.bytes(b)


def _read_opt_bytes(r: Reader) -> Optional[bytes]:
    return r.bytes() if r.bool() else None


class _TokenAuthInterceptor(_ServerInterceptor):
    """Rejects any call whose `authorization` metadata doesn't carry the
    shared bearer token (constant-time compare).  The reference secures this
    exact surface with credentialed dials (grpcdb.go:31-41 TLS cert/key);
    the token is the transport-independent half — TLS wraps the channel
    below when cert/key are configured."""

    def __init__(self, token: str):
        self._want = f"Bearer {token}".encode()

        def _deny(request, context):
            context.abort(
                grpc.StatusCode.UNAUTHENTICATED, "missing or invalid db token"
            )

        self._deny_handler = grpc.unary_unary_rpc_method_handler(
            _deny,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )

    def intercept_service(self, continuation, handler_call_details):
        for key, value in handler_call_details.invocation_metadata or ():
            if key == "authorization":
                got = value.encode() if isinstance(value, str) else value
                if hmac.compare_digest(got, self._want):
                    return continuation(handler_call_details)
                break
        return self._deny_handler


class RemoteDBServer(BaseService):
    """Serves named databases; a client InitRemote(name, type, dir) selects
    (creating on first use) which one its handle operates on — the handle's
    identity travels as the name on every call (the reference binds one DB
    per connection; a name per request is the stateless equivalent).

    auth_token: required bearer token; None serves unauthenticated (loopback
    dev only).  tls_cert/tls_key: PEM file paths — when given the port is a
    TLS port (clients pass the CA cert as tls_ca), matching the reference's
    credentialed listener (remotedb/grpcdb/grpcdb.go ListenAndServe)."""

    def __init__(self, addr: str, dir: str = ".",
                 auth_token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None):
        super().__init__("db.RemoteDBServer")
        _require_grpc("RemoteDBServer")
        self.addr = addr.replace("tcp://", "")
        self.dir = dir
        self.auth_token = auth_token
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self._dbs: Dict[str, DB] = {}
        self._backends: Dict[str, str] = {}
        self._mtx = threading.Lock()
        self._server = None
        self.bound_port: Optional[int] = None

    def _db(self, name: str) -> DB:
        with self._mtx:
            db = self._dbs.get(name)
            if db is None:
                raise KeyError(f"remote db {name!r} not initialized")
            return db

    # -- handlers ----------------------------------------------------------
    _NAME_RE = None  # compiled lazily

    def _init_remote(self, req: bytes) -> bytes:
        import re

        r = Reader(req)
        # the client's dir is part of the reference protocol shape but the
        # SERVER owns placement: every store lives under self.dir
        name, typ, _client_dir = r.string(), r.string(), r.string()
        if RemoteDBServer._NAME_RE is None:
            RemoteDBServer._NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9._-]*$")
        # the name becomes a path component — an unauthenticated client must
        # not be able to traverse outside the server's data dir
        if (
            not RemoteDBServer._NAME_RE.match(name)
            or ".." in name
            or len(name) > 128
        ):
            raise ValueError(f"invalid remote db name {name!r}")
        with self._mtx:
            existing = self._backends.get(name)
            if existing is not None:
                if existing != typ:
                    # silently handing a memdb to a client that asked for a
                    # durable backend loses data with no error anywhere
                    raise ValueError(
                        f"remote db {name!r} already initialized with "
                        f"backend {existing!r}, not {typ!r}"
                    )
            else:
                self._dbs[name] = new_db(name, typ, self.dir)
                self._backends[name] = typ
        return _enc(True)

    def _get(self, req: bytes) -> bytes:
        r = Reader(req)
        db = self._db(r.string())
        v = db.get(r.bytes())
        w = Writer()
        _opt_bytes(w, v)
        return w.build()

    def _has(self, req: bytes) -> bytes:
        r = Reader(req)
        db = self._db(r.string())
        return _enc(bool(db.has(r.bytes())))

    def _set(self, req: bytes, sync: bool) -> bytes:
        r = Reader(req)
        db = self._db(r.string())
        k, v = r.bytes(), r.bytes()
        (db.set_sync if sync else db.set)(k, v)
        return _enc(True)

    def _delete(self, req: bytes, sync: bool) -> bytes:
        r = Reader(req)
        db = self._db(r.string())
        (db.delete_sync if sync else db.delete)(r.bytes())
        return _enc(True)

    def _iterator(self, req: bytes) -> bytes:
        r = Reader(req)
        db = self._db(r.string())
        start = _read_opt_bytes(r)
        end = _read_opt_bytes(r)
        reverse = r.bool()
        w = Writer()
        pairs = list(db.iterator(start, end, reverse))
        w.uvarint(len(pairs))
        for k, v in pairs:
            w.bytes(k)
            w.bytes(v)
        return w.build()

    def _batch_write(self, req: bytes) -> bytes:
        r = Reader(req)
        db = self._db(r.string())
        n = r.uvarint()
        ops = []
        for _ in range(n):
            op = r.string()
            k = r.bytes()
            v = r.bytes()
            ops.append((op, k, v))
        db.apply_batch(ops)
        return _enc(True)

    def _stats(self, req: bytes) -> bytes:
        r = Reader(req)
        db = self._db(r.string())
        st = db.stats()
        w = Writer()
        w.uvarint(len(st))
        for k, v in sorted(st.items()):
            w.string(k)
            w.string(v)
        return w.build()

    # -- lifecycle ---------------------------------------------------------
    def on_start(self) -> None:
        from concurrent import futures

        dispatch = {
            "InitRemote": self._init_remote,
            "Get": self._get,
            "Has": self._has,
            "Set": lambda b: self._set(b, sync=False),
            "SetSync": lambda b: self._set(b, sync=True),
            "Delete": lambda b: self._delete(b, sync=False),
            "DeleteSync": lambda b: self._delete(b, sync=True),
            "Iterator": self._iterator,
            "BatchWrite": self._batch_write,
            "Stats": self._stats,
        }

        def make_handler(fn):
            def handler(request, context):
                try:
                    return fn(request)
                except Exception as e:
                    context.abort(grpc.StatusCode.INTERNAL, str(e))

            return handler

        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                make_handler(fn),
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            )
            for name, fn in dispatch.items()
        }
        interceptors = (
            (_TokenAuthInterceptor(self.auth_token),) if self.auth_token else ()
        )
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=4), interceptors=interceptors
        )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        if self.tls_cert and self.tls_key:
            with open(self.tls_key, "rb") as f:
                key_pem = f.read()
            with open(self.tls_cert, "rb") as f:
                cert_pem = f.read()
            creds = grpc.ssl_server_credentials(((key_pem, cert_pem),))
            self.bound_port = self._server.add_secure_port(self.addr, creds)
        else:
            self.bound_port = self._server.add_insecure_port(self.addr)
        if self.bound_port == 0:
            raise OSError(f"could not bind RemoteDB server to {self.addr}")
        self._server.start()
        self.logger.info(
            "RemoteDB server on %s (auth=%s, tls=%s)",
            self.addr, bool(self.auth_token), bool(self.tls_cert),
        )

    def on_stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1.0)
        with self._mtx:
            for db in self._dbs.values():
                try:
                    db.close()
                except Exception:
                    pass


class RemoteDB(DB):
    """Client handle implementing the DB interface against a RemoteDBServer
    (ref remotedb.go NewRemoteDB + InitRemote)."""

    def __init__(self, addr: str, name: str, backend: str = "memdb",
                 dir: str = ".", timeout: float = 10.0,
                 auth_token: Optional[str] = None,
                 tls_ca: Optional[str] = None):
        _require_grpc("RemoteDB")
        self.addr = addr.replace("tcp://", "")
        self.name = name
        self._timeout = timeout
        self._metadata = (
            (("authorization", f"Bearer {auth_token}"),) if auth_token else ()
        )
        if tls_ca:
            with open(tls_ca, "rb") as f:
                creds = grpc.ssl_channel_credentials(root_certificates=f.read())
            self._channel = grpc.secure_channel(self.addr, creds)
        else:
            self._channel = grpc.insecure_channel(self.addr)
        try:
            grpc.channel_ready_future(self._channel).result(timeout=timeout)
            self._stubs = {
                m: self._channel.unary_unary(
                    f"/{_SERVICE}/{m}",
                    request_serializer=lambda b: b,
                    response_deserializer=lambda b: b,
                )
                for m in _METHODS
            }
            self._call("InitRemote", _enc(name, backend, dir))
        except BaseException:
            # a failed handshake/auth must not leak the live channel — a
            # reconnect-with-backoff caller would accumulate fds forever
            self._channel.close()
            raise

    def _call(self, method: str, payload: bytes) -> bytes:
        return self._stubs[method](
            payload, timeout=self._timeout, metadata=self._metadata
        )

    # -- DB interface ------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        resp = self._call("Get", _enc(self.name, key))
        return _read_opt_bytes(Reader(resp))

    def has(self, key: bytes) -> bool:
        return Reader(self._call("Has", _enc(self.name, key))).bool()

    def set(self, key: bytes, value: bytes) -> None:
        self._call("Set", _enc(self.name, key, value))

    def set_sync(self, key: bytes, value: bytes) -> None:
        self._call("SetSync", _enc(self.name, key, value))

    def delete(self, key: bytes) -> None:
        self._call("Delete", _enc(self.name, key))

    def delete_sync(self, key: bytes) -> None:
        self._call("DeleteSync", _enc(self.name, key))

    def iterator(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None,
        reverse: bool = False,
    ) -> Iterator[Tuple[bytes, bytes]]:
        w = Writer()
        w.string(self.name)
        _opt_bytes(w, start)
        _opt_bytes(w, end)
        w.bool(reverse)
        r = Reader(self._call("Iterator", w.build()))
        n = r.uvarint()
        return iter([(r.bytes(), r.bytes()) for _ in range(n)])

    def apply_batch(self, ops) -> None:
        w = Writer()
        w.string(self.name)
        w.uvarint(len(ops))
        for op, k, v in ops:
            w.string(op)
            w.bytes(k)
            w.bytes(v if v is not None else b"")
        self._call("BatchWrite", w.build())

    def close(self) -> None:
        self._channel.close()

    def stats(self) -> Dict[str, str]:
        r = Reader(self._call("Stats", _enc(self.name)))
        return {r.string(): r.string() for _ in range(r.uvarint())}
