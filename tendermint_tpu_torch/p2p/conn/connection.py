"""MConnection: N prioritized logical channels multiplexed over one
authenticated stream (ref p2p/conn/connection.go:70 MConnection, :622
Channel), the port's copy of the reference package's
``p2p/conn/connection.py``, with the same packet bytes on the wire (a type
byte; a message packet then carries its channel ID, an EOF byte and a
two-byte little-endian length before its chunk).

Semantics kept from the reference:

* messages are split into ≤1024-byte ``PacketMsg``s (channel ID + EOF flag +
  chunk), interleaved across channels by a priority-weighted round-robin that
  picks the channel with the least ``recently_sent/priority`` ratio
  (connection.go sendPacketMsg/selectChannel, :398);
* per-connection flow-rate limiting on send and recv (libs/flowrate);
* ping/pong keepalive — ping every ``ping_interval``, the connection errors
  out if no pong arrives within ``pong_timeout`` (connection.go:357-395);
* ``send()`` blocks until the channel queue has room (up to
  ``send_timeout``), ``try_send()`` never blocks (connection.go:262-301);
* receive delivers complete reassembled messages via
  ``on_receive(chan_id, msg_bytes)`` on the recv thread; any transport error
  fires ``on_error(err)`` once.

Threading model: one send thread + one recv thread per connection (the Go
version's sendRoutine/recvRoutine). The channel send queues are the only
producer-facing surface; everything else is internal.
"""

from __future__ import annotations

import queue
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.libs.flowrate import Monitor
from tendermint_tpu_torch.libs.service import AlreadyStoppedError, BaseService

# packet type tags on the wire (connection.go PacketPing/PacketPong/PacketMsg)
_PKT_PING = 0x01
_PKT_PONG = 0x02
_PKT_MSG = 0x03

MAX_PACKET_MSG_PAYLOAD_SIZE = 1024  # config.go MaxPacketMsgPayloadSize
NUM_BATCH_PACKET_MSGS = 10  # connection.go numBatchPacketMsgs


@dataclass
class ChannelDescriptor:
    """Static channel parameters a reactor registers (connection.go:601)."""

    id: int
    priority: int = 1
    send_queue_capacity: int = 1
    recv_message_capacity: int = 22 * 1024 * 1024  # defaultRecvMessageCapacity

    def __post_init__(self):
        if not (0 <= self.id <= 0xFF):
            raise ValueError(f"channel ID {self.id} out of byte range")
        if self.priority <= 0:
            raise ValueError("channel priority must be positive")


@dataclass
class MConnConfig:
    """connection.go MConnConfig / config.go P2P defaults."""

    send_rate: int = 512_000  # bytes/s (5_120_000 in the reference's defaults)
    recv_rate: int = 512_000
    max_packet_msg_payload_size: int = MAX_PACKET_MSG_PAYLOAD_SIZE
    flush_throttle: float = 0.1  # seconds (100ms default / 10ms test)
    ping_interval: float = 60.0
    pong_timeout: float = 45.0
    send_timeout: float = 10.0  # defaultSendTimeout

    @classmethod
    def test_config(cls) -> "MConnConfig":
        return cls(
            send_rate=5_120_000,
            recv_rate=5_120_000,
            flush_throttle=0.01,
            ping_interval=0.4,
            pong_timeout=0.35,
        )


class _Channel:
    """One logical channel's send-side state (connection.go:622)."""

    def __init__(self, desc: ChannelDescriptor, max_payload: int):
        self.desc = desc
        self.send_queue: "queue.Queue[bytes]" = queue.Queue(
            maxsize=max(1, desc.send_queue_capacity)
        )
        self.sending: bytes = b""  # message currently being packetized
        self.sent_pos = 0
        self.recently_sent = 0  # exponentially decayed byte count
        self.max_payload = max_payload
        # payload bytes queued but not yet packetized onto the wire;
        # incremented on producer threads, drained on the send thread
        self.pending_bytes = 0
        self._pending_mtx = threading.Lock()
        # recv-side reassembly
        self.recving = bytearray()

    # -- send side -----------------------------------------------------------
    def is_send_pending(self) -> bool:
        return bool(self.sending) or not self.send_queue.empty()

    def next_packet(self) -> tuple[bytes, bool]:
        """Pop the next ≤max_payload chunk; returns (chunk, eof)."""
        if not self.sending:
            self.sending = self.send_queue.get_nowait()
            self.sent_pos = 0
        chunk = self.sending[self.sent_pos : self.sent_pos + self.max_payload]
        self.sent_pos += len(chunk)
        eof = self.sent_pos >= len(self.sending)
        if eof:
            self.sending = b""
            self.sent_pos = 0
        self.recently_sent += len(chunk)
        with self._pending_mtx:
            self.pending_bytes = max(0, self.pending_bytes - len(chunk))
        return chunk, eof

    def add_pending(self, n: int) -> None:
        with self._pending_mtx:
            self.pending_bytes += n

    # -- recv side -----------------------------------------------------------
    def recv_packet(self, chunk: bytes, eof: bool) -> Optional[bytes]:
        """Append a packet; return the full message when EOF closes it."""
        if len(self.recving) + len(chunk) > self.desc.recv_message_capacity:
            raise ConnectionError(
                f"message on channel {self.desc.id:#x} exceeds recv capacity"
            )
        self.recving.extend(chunk)
        if eof:
            msg = bytes(self.recving)
            self.recving.clear()
            return msg
        return None

    def update_stats(self) -> None:
        self.recently_sent = int(self.recently_sent * 0.8)


class MConnection(BaseService):
    def __init__(
        self,
        conn,  # SecretConnection or RawConn: write()/read_exactly()/close()
        channel_descs: List[ChannelDescriptor],
        on_receive: Callable[[int, bytes], None],
        on_error: Callable[[Exception], None],
        config: Optional[MConnConfig] = None,
        name: str = "MConn",
        on_traffic: Optional[Callable[[int, int, int], None]] = None,
    ):
        super().__init__(name=name)
        self._conn = conn
        self.config = config or MConnConfig()
        self._channels: Dict[int, _Channel] = {
            d.id: _Channel(d, self.config.max_packet_msg_payload_size)
            for d in channel_descs
        }
        self._on_receive = on_receive
        self._on_error = on_error
        # on_traffic(chan_id, sent_bytes, received_bytes): per-channel wire
        # accounting at packet granularity (type byte + header + chunk), the
        # same bytes the flowrate monitors count for msg packets
        self._on_traffic = on_traffic
        self._send_monitor = Monitor()
        self._recv_monitor = Monitor()
        self._send_signal = threading.Event()  # "there may be work"
        self._pong_pending = threading.Event()  # we owe the peer a pong
        self._ping_sent_at: Optional[float] = None
        self._err_once = threading.Lock()
        self._errored = False
        self._threads: List[threading.Thread] = []
        # monotonic stamp of the last byte read off the wire (pings count):
        # the liveness watchdog reports per-peer last-receive ages from this
        self._last_recv_at = time.monotonic()

    # -- lifecycle -----------------------------------------------------------
    def on_start(self) -> None:
        for fn, nm in ((self._send_routine, "send"), (self._recv_routine, "recv")):
            t = threading.Thread(target=fn, name=f"{self.name}-{nm}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Idempotent: a connection may self-stop on transport error before
        (or while) its owner stops it."""
        try:
            super().stop()
        except AlreadyStoppedError:
            pass

    def on_stop(self) -> None:
        self._send_signal.set()
        try:
            self._conn.close()
        except OSError:
            pass
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    # -- public API ----------------------------------------------------------
    def send(self, chan_id: int, msg: bytes) -> bool:
        """Queue `msg` on channel; blocks up to send_timeout. False if the
        connection is down, the channel unknown, or the queue stayed full."""
        if not self.is_running:
            return False
        ch = self._channels.get(chan_id)
        if ch is None:
            self.logger.error("send to unknown channel %#x", chan_id)
            return False
        try:
            ch.send_queue.put(msg, timeout=self.config.send_timeout)
        except queue.Full:
            return False
        ch.add_pending(len(msg))
        self._send_signal.set()
        return True

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        """Non-blocking send (connection.go TrySend)."""
        if not self.is_running:
            return False
        ch = self._channels.get(chan_id)
        if ch is None:
            return False
        try:
            ch.send_queue.put_nowait(msg)
        except queue.Full:
            return False
        ch.add_pending(len(msg))
        self._send_signal.set()
        return True

    def can_send(self, chan_id: int) -> bool:
        ch = self._channels.get(chan_id)
        return ch is not None and not ch.send_queue.full()

    def pending_send_bytes(self) -> int:
        """Payload bytes queued across all channels but not yet on the wire."""
        return sum(ch.pending_bytes for ch in self._channels.values())

    def status(self) -> dict:
        return {
            "send_rate": self._send_monitor.status().inst_rate,
            "recv_rate": self._recv_monitor.status().inst_rate,
            "last_recv_age": round(time.monotonic() - self._last_recv_at, 3),
            "channels": {
                f"{cid:#x}": {
                    "send_queue": ch.send_queue.qsize(),
                    "recently_sent": ch.recently_sent,
                    "priority": ch.desc.priority,
                    "pending_bytes": ch.pending_bytes,
                }
                for cid, ch in self._channels.items()
            },
        }

    # -- error plumbing --------------------------------------------------------
    def _stop_for_error(self, err: Exception) -> None:
        with self._err_once:
            if self._errored:
                return
            self._errored = True
        if self.is_running:
            try:
                self.stop()
            except Exception:
                pass
        try:
            self._on_error(err)
        except Exception:
            self.logger.exception("on_error callback failed")

    # -- send side -------------------------------------------------------------
    def _send_routine(self) -> None:
        cfg = self.config
        last_ping = time.monotonic()
        last_stats = time.monotonic()
        buf = bytearray()
        try:
            while not self._quit.is_set():
                # wake on work, or at the flush/ping cadence
                self._send_signal.wait(timeout=cfg.flush_throttle)
                self._send_signal.clear()
                if self._quit.is_set():
                    return
                now = time.monotonic()

                if now - last_stats >= 2.0:
                    for ch in self._channels.values():
                        ch.update_stats()
                    last_stats = now

                if self._pong_pending.is_set():
                    self._pong_pending.clear()
                    buf.append(_PKT_PONG)

                if now - last_ping >= cfg.ping_interval:
                    buf.append(_PKT_PING)
                    if self._ping_sent_at is None:
                        self._ping_sent_at = now
                    last_ping = now
                if (
                    self._ping_sent_at is not None
                    and now - self._ping_sent_at > cfg.pong_timeout
                ):
                    raise ConnectionError("pong timeout")

                # batch up to NUM_BATCH_PACKET_MSGS packets per wakeup,
                # channel choice weighted by least recently_sent/priority
                sent_by_chan: Dict[int, int] = {}
                for _ in range(NUM_BATCH_PACKET_MSGS):
                    ch = self._select_channel()
                    if ch is None:
                        break
                    try:
                        chunk, eof = ch.next_packet()
                    except queue.Empty:
                        continue
                    buf.append(_PKT_MSG)
                    buf.append(ch.desc.id)
                    buf.append(0x01 if eof else 0x00)
                    buf.extend(struct.pack("<H", len(chunk)))
                    buf.extend(chunk)
                    # 5 = type + chan + eof + 2-byte length, matching what
                    # the recv side attributes for the same packet
                    sent_by_chan[ch.desc.id] = (
                        sent_by_chan.get(ch.desc.id, 0) + 5 + len(chunk)
                    )

                if buf:
                    self._send_monitor.limit(len(buf), cfg.send_rate)
                    self._conn.write(bytes(buf))
                    self._send_monitor.update(len(buf))
                    buf.clear()
                    if self._on_traffic is not None:
                        for cid, n in sent_by_chan.items():
                            self._on_traffic(cid, n, 0)
                # more queued? loop immediately
                if any(c.is_send_pending() for c in self._channels.values()):
                    self._send_signal.set()
        except Exception as e:
            if not self._quit.is_set():
                self._stop_for_error(e)

    def _select_channel(self) -> Optional[_Channel]:
        best, best_ratio = None, None
        for ch in self._channels.values():
            if not ch.is_send_pending():
                continue
            ratio = ch.recently_sent / ch.desc.priority
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    # -- recv side -------------------------------------------------------------
    def _recv_routine(self) -> None:
        cfg = self.config
        try:
            while not self._quit.is_set():
                self._recv_monitor.limit(
                    cfg.max_packet_msg_payload_size, cfg.recv_rate
                )
                pkt_type = self._conn.read_exactly(1)[0]
                self._recv_monitor.update(1)
                self._last_recv_at = time.monotonic()
                if pkt_type == _PKT_PING:
                    self._pong_pending.set()
                    self._send_signal.set()
                elif pkt_type == _PKT_PONG:
                    self._ping_sent_at = None
                elif pkt_type == _PKT_MSG:
                    hdr = self._conn.read_exactly(4)
                    chan_id, eof = hdr[0], hdr[1] != 0
                    (length,) = struct.unpack("<H", hdr[2:4])
                    if length > cfg.max_packet_msg_payload_size:
                        raise ConnectionError(f"oversized packet ({length})")
                    chunk = self._conn.read_exactly(length) if length else b""
                    self._recv_monitor.update(4 + length)
                    if self._on_traffic is not None:
                        # include the type byte counted above so per-channel
                        # sums reconcile with the recv monitor total
                        self._on_traffic(chan_id, 0, 5 + length)
                    ch = self._channels.get(chan_id)
                    if ch is None:
                        raise ConnectionError(f"unknown channel {chan_id:#x}")
                    msg = ch.recv_packet(chunk, eof)
                    if msg is not None:
                        self._on_receive(chan_id, msg)
                else:
                    raise ConnectionError(f"unknown packet type {pkt_type:#x}")
        except Exception as e:
            if not self._quit.is_set():
                self._stop_for_error(e)
