"""WebSocket endpoint: JSON-RPC subscribe/unsubscribe over RFC 6455
(ref: rpc/lib/server/ws_handler.go + the subscribe routes at
rpc/core/routes.go:11, events.go).

The port's copy of the reference package's ``rpc/websocket.py``.
Hand-rolled frame layer (no external websocket dependency): handshake,
masked client frames, text/ping/pong/close opcodes. Each connection runs a
reader loop (JSON-RPC requests) and pushes event-bus matches back as
notifications with id "<request id>#event", the reference's convention.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading
from typing import Any, Dict, Optional

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT = 0x1
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1(client_key.encode() + _WS_GUID).digest()
    return base64.b64encode(digest).decode()


OP_CONT = 0x0


def read_frame(rfile) -> Optional[tuple]:
    """One raw frame: (fin, opcode, payload), or None on EOF."""
    hdr = rfile.read(2)
    if len(hdr) < 2:
        return None
    fin_op, mask_len = hdr[0], hdr[1]
    fin = bool(fin_op & 0x80)
    opcode = fin_op & 0x0F
    masked = bool(mask_len & 0x80)
    length = mask_len & 0x7F
    if length == 126:
        (length,) = struct.unpack(">H", rfile.read(2))
    elif length == 127:
        (length,) = struct.unpack(">Q", rfile.read(8))
    if length > 1 << 20:
        return None  # refuse absurd frames
    mask = rfile.read(4) if masked else b""
    payload = rfile.read(length)
    if len(payload) < length:
        return None
    if masked:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return fin, opcode, payload


class MessageReader:
    """Reassembles RFC 6455 fragmentation (FIN=0 TEXT/BINARY + continuation
    frames). Control frames (ping/pong/close) may legally interleave with a
    fragmented message and are returned immediately — the partial fragment
    buffer lives on the instance, surviving across ``next()`` calls."""

    def __init__(self, rfile):
        self._rfile = rfile
        self._buffer = bytearray()
        self._buffered_op: Optional[int] = None

    def next(self) -> Optional[tuple]:
        """(opcode, payload) of the next complete message, or None on
        EOF/protocol error."""
        while True:
            frame = read_frame(self._rfile)
            if frame is None:
                return None
            fin, opcode, payload = frame
            if opcode in (OP_CLOSE, OP_PING, OP_PONG):
                return opcode, payload  # control frames are never fragmented
            if opcode == OP_CONT:
                if self._buffered_op is None:
                    return None  # continuation with nothing to continue
                self._buffer.extend(payload)
                if fin:
                    op, out = self._buffered_op, bytes(self._buffer)
                    self._buffered_op = None
                    self._buffer = bytearray()
                    return op, out
                continue
            if fin and self._buffered_op is None:
                return opcode, payload  # the common unfragmented case
            if self._buffered_op is not None:
                return None  # new data frame while a fragment is open
            self._buffered_op = opcode
            self._buffer.extend(payload)


def read_message(rfile) -> Optional[tuple]:
    """One-shot convenience for unfragmented streams (tests/clients).
    Sessions must hold a MessageReader so fragment state survives interleaved
    control frames."""
    return MessageReader(rfile).next()


def make_frame(opcode: int, payload: bytes) -> bytes:
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


# -- event JSON ----------------------------------------------------------------


def event_to_json(msg) -> Dict[str, Any]:
    """Serialize a pubsub Message into the reference's {type, value} shape."""
    from tendermint_tpu_torch.rpc.core.env import _header_json, _tx_res_json
    from tendermint_tpu_torch.types import events as ev

    data = msg.data
    if isinstance(data, ev.EventDataNewBlock):
        block = data.block
        value = {
            "block": {
                "header": _header_json(block.header),
                "data": {
                    "txs": [
                        base64.b64encode(bytes(t)).decode() for t in block.data.txs
                    ]
                },
            }
        }
        typ = "NewBlock"
    elif isinstance(data, ev.EventDataNewBlockHeader):
        value = {"header": _header_json(data.header)}
        typ = "NewBlockHeader"
    elif isinstance(data, ev.EventDataTx):
        value = {
            "TxResult": {
                "height": data.height,
                "index": data.index,
                "tx": base64.b64encode(bytes(data.tx)).decode(),
                "result": _tx_res_json(data.result),
            }
        }
        typ = "Tx"
    elif isinstance(data, ev.EventDataVote):
        v = data.vote
        value = {
            "Vote": {
                "height": v.height,
                "round": v.round,
                "type": int(v.vote_type),
                "validator_index": v.validator_index,
            }
        }
        typ = "Vote"
    elif isinstance(data, ev.EventDataRoundState):
        value = {"height": data.height, "round": data.round, "step": data.step}
        typ = "RoundState"
    else:
        value = {"repr": repr(data)}
        typ = type(data).__name__
    return {"type": typ, "value": value, "tags": dict(msg.tags)}


# -- per-connection session --------------------------------------------------------


class WSSession:
    """One websocket client: JSON-RPC requests in, responses + event
    notifications out (ws_handler.go wsConnection)."""

    def __init__(self, handler, event_bus, logger):
        self.rfile = handler.rfile
        self.wfile = handler.wfile
        self.bus = event_bus
        self.logger = logger
        self._wmtx = threading.Lock()
        self._client_id = f"ws-{id(self):x}"
        self._subs: Dict[str, tuple] = {}  # query str -> (Subscription, req_id)
        self._closed = threading.Event()

    # -- frame IO -----------------------------------------------------------------
    def _send_json(self, obj) -> bool:
        data = json.dumps(obj).encode()
        try:
            with self._wmtx:
                self.wfile.write(make_frame(OP_TEXT, data))
                self.wfile.flush()
            return True
        except OSError:
            self._closed.set()
            return False

    # -- main loop ---------------------------------------------------------------
    def run(self) -> None:
        reader = MessageReader(self.rfile)
        try:
            while not self._closed.is_set():
                msg = reader.next()
                if msg is None:
                    break
                opcode, payload = msg
                if opcode == OP_CLOSE:
                    with self._wmtx:
                        try:
                            self.wfile.write(make_frame(OP_CLOSE, payload[:2]))
                            self.wfile.flush()
                        except OSError:
                            pass
                    break
                if opcode == OP_PING:
                    with self._wmtx:
                        self.wfile.write(make_frame(OP_PONG, payload))
                        self.wfile.flush()
                    continue
                if opcode != OP_TEXT:
                    continue
                try:
                    req = json.loads(payload)
                except json.JSONDecodeError:
                    self._send_json(
                        {"jsonrpc": "2.0", "id": None,
                         "error": {"code": -32700, "message": "parse error"}}
                    )
                    continue
                self._handle(req)
        finally:
            self._closed.set()
            try:
                self.bus.unsubscribe_all(self._client_id)
            except Exception:
                pass

    def _handle(self, req: dict) -> None:
        method = req.get("method", "")
        params = req.get("params") or {}
        req_id = req.get("id")
        start_pump = None
        try:
            if method == "subscribe":
                start_pump = self._subscribe(params["query"], req_id)
                result: Any = {}
            elif method == "unsubscribe":
                self._unsubscribe(params["query"])
                result = {}
            elif method == "unsubscribe_all":
                for q in list(self._subs):
                    self._unsubscribe(q)
                result = {}
            else:
                self._send_json(
                    {"jsonrpc": "2.0", "id": req_id,
                     "error": {"code": -32601, "message": f"unknown ws method {method!r}"}}
                )
                return
            self._send_json({"jsonrpc": "2.0", "id": req_id, "result": result})
            if start_pump is not None:
                # pump starts only AFTER the ack frame is on the wire, so the
                # client never sees an event before its subscribe response
                start_pump()
        except Exception as e:
            self._send_json(
                {"jsonrpc": "2.0", "id": req_id,
                 "error": {"code": -32603, "message": str(e)}}
            )

    # -- subscriptions ----------------------------------------------------------
    def _subscribe(self, query: str, req_id):
        if query in self._subs:
            raise ValueError(f"already subscribed to {query!r}")
        sub = self.bus.subscribe(self._client_id, query, maxsize=100)
        self._subs[query] = (sub, req_id)

        def start():
            threading.Thread(
                target=self._pump, args=(sub, query, req_id),
                name="ws-pump", daemon=True,
            ).start()

        return start

    def _unsubscribe(self, query: str) -> None:
        if query not in self._subs:
            raise ValueError(f"not subscribed to {query!r}")
        sub, _ = self._subs.pop(query)
        sub.cancelled.set()
        try:
            self.bus.unsubscribe(self._client_id, query)
        except Exception:
            pass

    def _pump(self, sub, query: str, req_id) -> None:
        import queue as q

        while not self._closed.is_set() and not sub.cancelled.is_set():
            try:
                msg = sub.get(timeout=0.2)
            except q.Empty:
                continue
            payload = {
                "jsonrpc": "2.0",
                "id": f"{req_id}#event",
                "result": {"query": query, "data": event_to_json(msg)},
            }
            data = json.dumps(payload).encode()
            try:
                with self._wmtx:
                    # cancellation is flagged BEFORE the unsubscribe ack is
                    # written (same lock): re-checking here guarantees no
                    # event frame ever follows the ack
                    if sub.cancelled.is_set():
                        return
                    self.wfile.write(make_frame(OP_TEXT, data))
                    self.wfile.flush()
            except (OSError, ValueError):
                # ValueError: writing to a file the handler already closed —
                # a racing client disconnect, same meaning as a broken pipe
                self._closed.set()
                return
