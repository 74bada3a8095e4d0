"""Proxy app connections (ref proxy/app_conn.go, multi_app_conn.go,
client.go), the port's copy of the reference package's
``proxy/app_conn.py``.

One ABCI client per logical connection, each behind a typed facade:
  AppConnConsensus: InitChain, BeginBlock, DeliverTxAsync, EndBlock, Commit
  AppConnMempool:   CheckTxAsync (with the batched verdict) + Flush
  AppConnQuery:     Echo, Info, SetOption, Query, and the state-sync
                    snapshot handshake (ListSnapshots, OfferSnapshot,
                    LoadSnapshotChunk, ApplySnapshotChunk)
``MultiAppConn`` owns the three; ``LocalClientCreator`` gives each a
``LocalClient`` on one shared mutex, ``RemoteClientCreator`` a
``SocketClient`` of its own (or a ``GRPCClient`` for ``grpc://``);
``default_client_creator`` is the creator a node's ``proxy_app`` names.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient, ReqRes, SocketClient
from tendermint_tpu_torch.libs.service import BaseService


class AppConnConsensus:
    def __init__(self, client):
        self._c = client

    def set_response_callback(self, cb: Callable[[Any, Any], None]) -> None:
        self._c.set_response_callback(cb)

    def error(self) -> Optional[Exception]:
        return self._c.error()

    def init_chain_sync(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        return self._c.request_sync(req)

    def begin_block_sync(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        return self._c.request_sync(req)

    def deliver_tx_async(self, tx: bytes) -> ReqRes:
        return self._c.request_async(abci.RequestDeliverTx(tx=tx))

    def end_block_sync(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        return self._c.request_sync(req)

    def commit_sync(self) -> abci.ResponseCommit:
        return self._c.request_sync(abci.RequestCommit())


class AppConnMempool:
    def __init__(self, client):
        self._c = client

    def set_response_callback(self, cb: Callable[[Any, Any], None]) -> None:
        self._c.set_response_callback(cb)

    def error(self) -> Optional[Exception]:
        return self._c.error()

    def check_tx_async(self, tx: bytes, sig_verified: Optional[bool] = None) -> ReqRes:
        # sig_verified: the batched-ingest verdict (mempool/tx_verify.py);
        # None keeps the reference contract (the app verifies serially)
        return self._c.request_async(abci.RequestCheckTx(tx=tx, sig_verified=sig_verified))

    def flush_async(self) -> None:
        self._c.request_async(abci.RequestFlush())

    def flush_sync(self) -> None:
        self._c.flush_sync()


class AppConnQuery:
    def __init__(self, client):
        self._c = client

    def error(self) -> Optional[Exception]:
        return self._c.error()

    def echo_sync(self, msg: str) -> abci.ResponseEcho:
        return self._c.request_sync(abci.RequestEcho(message=msg))

    def info_sync(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return self._c.request_sync(req)

    def query_sync(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        return self._c.request_sync(req)

    def set_option_sync(self, req: abci.RequestSetOption) -> abci.ResponseSetOption:
        return self._c.request_sync(req)

    # the state-sync snapshot handshake rides the query connection (v0.34
    # adds a fourth connection; the method set is what matters here)
    def list_snapshots_sync(
            self, req: Optional[abci.RequestListSnapshots] = None) -> abci.ResponseListSnapshots:
        return self._c.request_sync(req or abci.RequestListSnapshots())

    def offer_snapshot_sync(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot:
        return self._c.request_sync(req)

    def load_snapshot_chunk_sync(
            self, req: abci.RequestLoadSnapshotChunk) -> abci.ResponseLoadSnapshotChunk:
        return self._c.request_sync(req)

    def apply_snapshot_chunk_sync(
            self, req: abci.RequestApplySnapshotChunk) -> abci.ResponseApplySnapshotChunk:
        return self._c.request_sync(req)


class ClientCreator:
    def new_abci_client(self):
        raise NotImplementedError


class LocalClientCreator(ClientCreator):
    """One shared mutex across all three connections (ref
    NewLocalClientCreator)."""

    def __init__(self, app: abci.Application):
        self._app = app
        self._mtx = threading.Lock()

    def new_abci_client(self):
        return LocalClient(self._app, self._mtx)


class RemoteClientCreator(ClientCreator):
    """A socket client a connection; 'grpc://host:port' selects the gRPC
    transport (ref DefaultClientCreator's transport switch,
    proxy/client.go). A remote app publishes no ``tx_sig_extractor`` to the
    node: its CheckTx verifies in the app."""

    def __init__(self, addr: str, must_connect: bool = True):
        self._addr = addr
        self._must_connect = must_connect

    def new_abci_client(self):
        if self._addr.startswith("grpc://"):
            from tendermint_tpu_torch.abci.grpc import GRPCClient

            return GRPCClient(self._addr[len("grpc://"):], self._must_connect)
        return SocketClient(self._addr, self._must_connect)


def default_client_creator(app_name: str, addr: str = "") -> ClientCreator:
    """'kvstore' | 'persistent_kvstore' | 'counter' | 'noop' in-proc, else a
    socket (or ``grpc://``) address (ref DefaultClientCreator)."""
    from tendermint_tpu_torch.abci.examples.kvstore import (
        CounterApp,
        KVStoreApp,
        PersistentKVStoreApp,
    )

    builtin = {
        "kvstore": KVStoreApp,
        "persistent_kvstore": PersistentKVStoreApp,
        "counter": CounterApp,
        "noop": abci.Application,
    }
    if app_name in builtin:
        return LocalClientCreator(builtin[app_name]())
    return RemoteClientCreator(addr or app_name)


class MultiAppConn(BaseService):
    """Owns the three connections (ref multi_app_conn.go)."""

    def __init__(self, creator: ClientCreator):
        super().__init__("proxy.MultiAppConn")
        self._creator = creator
        self.consensus: Optional[AppConnConsensus] = None
        self.mempool: Optional[AppConnMempool] = None
        self.query: Optional[AppConnQuery] = None
        self._clients = []

    def on_start(self) -> None:
        q = self._creator.new_abci_client()
        q.start()
        self.query = AppConnQuery(q)
        m = self._creator.new_abci_client()
        m.start()
        self.mempool = AppConnMempool(m)
        c = self._creator.new_abci_client()
        c.start()
        self.consensus = AppConnConsensus(c)
        self._clients = [q, m, c]

    def on_stop(self) -> None:
        for c in self._clients:
            try:
                c.stop()
            except Exception:
                pass
