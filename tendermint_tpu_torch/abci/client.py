"""The in-proc ABCI client (ref abci/client/local_client.go), the port's copy
of ``ReqRes`` and ``LocalClient`` from the reference package's
``abci/client.py``.

``LocalClient`` runs the app inline behind one mutex. Its async calls
complete before they return: the global response callback (the mempool's)
runs first, then ``ReqRes.complete`` and the request's own callback. The
socket client is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from tendermint_tpu_torch.abci import types as abci
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
