"""The consensus write-ahead log: every message is logged before it is
processed (ref consensus/wal.go), the port's copy of the reference
package's ``consensus/wal.py``.

Record framing: crc32(payload) fixed32 | uvarint(len) | payload, where the
payload is a timestamped consensus message (``messages.py``'s registry).
``#ENDHEIGHT`` markers delimit heights; ``search_for_end_height`` scans the
chunks backwards as the reference does (wal.go:159).

Reading runs the reference's pure-Python framing loop (the one that
``TM_NO_NATIVE_CODEC=1`` selects there): the same accept and reject rules
and the same error strings. The reference's C scanner
(``consensus/_wal_native.c``) is host code; the port has no copy of it.
Appends are traced as ``wal.append`` and fsyncs as ``wal.fsync``, each
tagged with the height that ``set_height`` last gave; the same spans feed
per-height cost accumulators (``height_costs`` / ``pop_height_costs``),
which the critical-path analyzer (``libs/critpath.py``) joins into each
committed height's waterfall.
"""

from __future__ import annotations

import io
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

from tendermint_tpu_torch.consensus.messages import (
    EndHeightMessage,
    decode_msg,
    encode_msg,
)
from tendermint_tpu_torch.encoding.codec import Reader, Writer, encode_uvarint, read_uvarint
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.autofile import Group
from tendermint_tpu_torch.libs.service import BaseService

MAX_MSG_SIZE_BYTES = 1024 * 1024  # 1MB (wal.go maxMsgSizeBytes)


class DataCorruptionError(Exception):
    """Recoverable WAL corruption point (wal.go IsDataCorruptionError)."""


@dataclass
class TimedWALMessage:
    time_ns: int
    msg: object

    def marshal(self) -> bytes:
        w = Writer()
        w.fixed64(self.time_ns)
        encode_msg(self.msg, w)
        return w.build()

    @classmethod
    def unmarshal(cls, data: bytes) -> "TimedWALMessage":
        r = Reader(data)
        return cls(time_ns=r.fixed64(), msg=decode_msg(r))


class WAL(BaseService):
    # per-height cost accumulators kept (oldest dropped past this); 64
    # heights comfortably covers any consumer lag on the finalize path
    HEIGHT_COST_KEEP = 64

    def __init__(self, wal_file: str, metrics=None):
        super().__init__("consensus.WAL")
        self.group = Group(wal_file)
        self.metrics = metrics  # libs/metrics.ConsensusMetrics or None
        # the height that tags the spans and the per-height cost join;
        # ConsensusState advances it
        self._height = 0
        self._height_costs: Dict[int, dict] = {}
        self._cost_mtx = threading.Lock()

    # height attribution ---------------------------------------------------
    def set_height(self, height: int) -> None:
        self._height = int(height)

    def _account(self, kind: str, seconds: float) -> None:
        with self._cost_mtx:
            c = self._height_costs.get(self._height)
            if c is None:
                c = {"append_seconds": 0.0, "fsync_seconds": 0.0,
                     "appends": 0, "fsyncs": 0}
                self._height_costs[self._height] = c
                while len(self._height_costs) > self.HEIGHT_COST_KEEP:
                    self._height_costs.pop(min(self._height_costs))
            c[f"{kind}_seconds"] += seconds
            c[f"{kind}s"] += 1

    def height_costs(self, height: int) -> Optional[dict]:
        """Accumulated WAL costs for one height, or None."""
        with self._cost_mtx:
            c = self._height_costs.get(int(height))
            return dict(c) if c is not None else None

    def pop_height_costs(self, height: int) -> Optional[dict]:
        """Like height_costs but removes the accumulator: the critpath
        analyzer consumes each height exactly once at finalize."""
        with self._cost_mtx:
            return self._height_costs.pop(int(height), None)

    # writes ---------------------------------------------------------------
    def write(self, msg: object) -> None:
        """Buffered append (fsync'd lazily)."""
        if not self.is_running:
            return
        payload = TimedWALMessage(time.time_ns(), msg).marshal()
        if len(payload) > MAX_MSG_SIZE_BYTES:
            raise ValueError(f"WAL msg too big: {len(payload)}")
        rec = struct.pack("<I", zlib.crc32(payload)) + encode_uvarint(len(payload)) + payload
        t0 = time.monotonic()
        with trace.span("wal.append", bytes=len(rec), height=self._height):
            self.group.write(rec)
            self.group.flush()
        dt = time.monotonic() - t0
        self._account("append", dt)
        if self.metrics is not None:
            self.metrics.wal_append_seconds.observe(dt)

    def write_sync(self, msg: object) -> None:
        """Append + fsync (internal msgs and #ENDHEIGHT use this)."""
        self.write(msg)
        if self.is_running:
            t0 = time.monotonic()
            with trace.span("wal.fsync", height=self._height):
                self.group.sync()
            dt = time.monotonic() - t0
            self._account("fsync", dt)
            if self.metrics is not None:
                self.metrics.wal_fsync_seconds.observe(dt)

    def on_start(self) -> None:
        self.group.maybe_rotate()

    def on_stop(self) -> None:
        try:
            self.group.sync()
        except ValueError:
            pass
        self.group.close()

    # reads ----------------------------------------------------------------
    def _iter_records(self, start_index: int) -> Iterator[TimedWALMessage]:
        reader = self.group.new_reader(start_index)
        buf = reader.read()
        reader.close()
        pos = 0
        n = len(buf)
        while pos < n:
            if n - pos < 4:
                raise DataCorruptionError("truncated crc")
            (crc,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            r = io.BytesIO(buf[pos : pos + 10])
            try:
                length = read_uvarint(r)
            except (EOFError, ValueError) as e:
                raise DataCorruptionError(f"bad length varint: {e}") from e
            pos += r.tell()
            if length > MAX_MSG_SIZE_BYTES:
                raise DataCorruptionError(f"length {length} too big")
            if pos + length > n:
                raise DataCorruptionError("truncated payload")
            payload = buf[pos : pos + length]
            pos += length
            if zlib.crc32(payload) != crc:
                raise DataCorruptionError("crc mismatch")
            try:
                yield TimedWALMessage.unmarshal(payload)
            except (EOFError, ValueError) as e:
                raise DataCorruptionError(f"undecodable payload: {e}") from e

    def iter_all(self) -> Iterator[TimedWALMessage]:
        return self._iter_records(self.group.min_index)

    def search_for_end_height(
        self, height: int
    ) -> Optional[Iterator[TimedWALMessage]]:
        """Iterator positioned right AFTER EndHeightMessage(height), or None
        (wal.go:159 scans chunks backwards; we scan chunks newest-first and
        replay forward within the chunk)."""
        for idx in range(self.group.max_index, self.group.min_index - 1, -1):
            found_at: Optional[int] = None
            msgs = []
            try:
                for i, tm in enumerate(self._iter_records(idx)):
                    msgs.append(tm)
                    if isinstance(tm.msg, EndHeightMessage) and tm.msg.height == height:
                        found_at = i
            except DataCorruptionError:
                if found_at is None:
                    continue
            if found_at is not None:
                remaining = msgs[found_at + 1 :]

                def _gen(start_chunk=idx, tail=remaining):
                    for tm in tail:
                        yield tm
                    for later in range(start_chunk + 1, self.group.max_index + 1):
                        yield from self._iter_records(later)

                return _gen()
        return None


class NilWAL:
    """No-op WAL (wal.go nilWAL) for tests/tools."""

    def write(self, msg) -> None: ...

    def write_sync(self, msg) -> None: ...

    def set_height(self, height: int) -> None: ...

    def height_costs(self, height: int):
        return None

    def pop_height_costs(self, height: int):
        return None

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def search_for_end_height(self, height: int):
        return None

    @property
    def is_running(self) -> bool:
        return True
