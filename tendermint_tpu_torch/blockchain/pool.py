"""BlockPool: fans block requests out across peers and hands back
contiguous runs of blocks for windowed verification (ref
blockchain/pool.go:62), the port's copy of the reference package's
``blockchain/pool.py``.

Differences from the reference, on purpose:

* the reference runs one goroutine per in-flight height (up to 600,
  pool.go:33); here a single scheduler thread owns all request state —
  same fan-out and retry behavior, thread-count O(1) instead of O(window);
* consumers take a whole *window* of consecutive blocks (``peek_window``)
  instead of PeekTwoBlocks — the batched (heights × validators) device
  verify is the entire point of this framework's fast sync (SURVEY §7.8).

Retry/punishment semantics kept: a request that times out is reassigned to
another peer and the slow peer reported via ``error_cb`` (pool.go:129-151);
``redo_request`` punishes the peer that supplied an invalid block.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.libs.service import BaseService

REQUEST_WINDOW = 128  # in-flight heights (ref: maxTotalRequesters 600)
MAX_PENDING_PER_PEER = 20  # pool.go maxPendingRequestsPerPeer
REQUEST_TIMEOUT = 15.0  # seconds before a request is reassigned + peer reported
MIN_RECV_RATE = 0  # bytes/s floor (pool.go minRecvRate, 0 = disabled here)


@dataclass
class _Request:
    height: int
    peer_id: str = ""
    sent_at: float = 0.0
    block: Optional[object] = None  # filled by add_block
    tries: int = 0


@dataclass
class _PoolPeer:
    id: str
    height: int  # tallest block the peer claims
    pending: int = 0
    timed_out: bool = False


class BlockPool(BaseService):
    def __init__(
        self,
        start_height: int,
        request_cb: Callable[[int, str], None],
        error_cb: Callable[[str, str], None],
        window: int = REQUEST_WINDOW,
        request_timeout: float = REQUEST_TIMEOUT,
    ):
        """request_cb(height, peer_id): dispatch a BlockRequest (reactor).
        error_cb(peer_id, reason): peer misbehaved/timed out (reactor stops it)."""
        super().__init__(name="BlockPool")
        self._mtx = threading.Lock()
        self.height = start_height  # next height to be consumed
        self._requests: Dict[int, _Request] = {}
        self._peers: Dict[str, _PoolPeer] = {}
        self._request_cb = request_cb
        self._error_cb = error_cb
        self._window = window
        self._timeout = request_timeout
        self._started_at = time.monotonic()
        self._num_synced = 0

    # -- lifecycle ------------------------------------------------------------
    def on_start(self) -> None:
        threading.Thread(
            target=self._scheduler, name="blockpool-sched", daemon=True
        ).start()

    # -- peer tracking ----------------------------------------------------------
    def set_peer_height(self, peer_id: str, height: int) -> None:
        with self._mtx:
            p = self._peers.get(peer_id)
            if p is None:
                self._peers[peer_id] = _PoolPeer(peer_id, height)
            elif height > p.height:
                p.height = height

    def remove_peer(self, peer_id: str) -> None:
        with self._mtx:
            self._peers.pop(peer_id, None)
            for req in self._requests.values():
                if req.peer_id == peer_id and req.block is None:
                    req.peer_id = ""  # scheduler reassigns

    @property
    def max_peer_height(self) -> int:
        with self._mtx:
            return max((p.height for p in self._peers.values()), default=0)

    def num_peers(self) -> int:
        with self._mtx:
            return len(self._peers)

    # -- block intake ------------------------------------------------------------
    def add_block(self, peer_id: str, block) -> bool:
        """A BlockResponse arrived. False = unsolicited/mismatched (caller
        may punish)."""
        with self._mtx:
            req = self._requests.get(block.height)
            if req is None or req.block is not None:
                return False
            if req.peer_id != peer_id:
                return False
            req.block = block
            peer = self._peers.get(peer_id)
            if peer is not None:
                peer.pending = max(0, peer.pending - 1)
            return True

    def no_block(self, peer_id: str, height: int) -> None:
        """Peer explicitly has no such block — reassign, and lower the peer's
        claimed height below it so the scheduler doesn't immediately re-pick
        the same peer for the same height (100Hz request ping-pong)."""
        with self._mtx:
            peer = self._peers.get(peer_id)
            if peer is not None and peer.height >= height:
                peer.height = height - 1
            req = self._requests.get(height)
            if req is not None and req.peer_id == peer_id and req.block is None:
                self._unassign(req)

    # -- consumption ---------------------------------------------------------------
    def peek_window(self, max_blocks: int, start_offset: int = 0) -> List[object]:
        """The longest run of ready consecutive blocks from
        self.height + start_offset (≤ max_blocks). The windowed analogue of
        pool.go PeekTwoBlocks; a nonzero offset peeks the NEXT window while
        the current one is still being applied (the reactor's speculative
        verify dispatch)."""
        out = []
        with self._mtx:
            start = self.height + start_offset
            for h in range(start, start + max_blocks):
                req = self._requests.get(h)
                if req is None or req.block is None:
                    break
                out.append(req.block)
        return out

    def pop_first(self) -> None:
        """First block consumed (applied) — advance (pool.go PopRequest)."""
        with self._mtx:
            self._requests.pop(self.height, None)
            self.height += 1
            self._num_synced += 1

    def redo_request(self, height: int) -> Optional[str]:
        """Block at `height` failed verification: drop it, re-fetch from
        someone else; returns the offending peer id (pool.go RedoRequest)."""
        with self._mtx:
            req = self._requests.get(height)
            if req is None:
                return None
            bad_peer = req.peer_id
            req.block = None
            self._unassign(req)
            return bad_peer or None

    @property
    def num_synced(self) -> int:
        with self._mtx:
            return self._num_synced

    def is_caught_up(self) -> bool:
        """pool.go IsCaughtUp: our next height reached the tallest peer's
        height (the tip block itself is consensus's job — its commit does
        not exist yet)."""
        with self._mtx:
            max_h = max((p.height for p in self._peers.values()), default=0)
            if max_h == 0:
                # no peer has reported a real height yet (genesis-fresh net,
                # or peers connected but still at height 0): grace period so
                # a live chain's first real status can arrive
                return time.monotonic() - self._started_at > 5.0
            return self.height >= max_h

    # -- scheduler ---------------------------------------------------------------
    def _scheduler(self) -> None:
        while not self._quit.is_set():
            sends: List[tuple] = []
            errors: List[tuple] = []
            now = time.monotonic()
            with self._mtx:
                max_h = max((p.height for p in self._peers.values()), default=0)
                # spawn requesters for the window
                for h in range(self.height, min(self.height + self._window, max_h + 1)):
                    if h not in self._requests:
                        self._requests[h] = _Request(h)
                # assign / retry
                for req in self._requests.values():
                    if req.block is not None:
                        continue
                    if req.peer_id and now - req.sent_at > self._timeout:
                        bad = req.peer_id
                        errors.append((bad, f"block request {req.height} timed out"))
                        self._peers.pop(bad, None)
                        # unassign ALL of the dead peer's in-flight requests,
                        # not just this one — siblings would otherwise each
                        # wait out their own full timeout
                        for other in self._requests.values():
                            if other.peer_id == bad and other.block is None:
                                self._unassign(other)
                    if not req.peer_id:
                        peer = self._pick_peer(req.height)
                        if peer is not None:
                            req.peer_id = peer.id
                            req.sent_at = now
                            req.tries += 1
                            peer.pending += 1
                            sends.append((req.height, peer.id))
            for height, peer_id in sends:
                try:
                    self._request_cb(height, peer_id)
                except Exception:
                    self.logger.exception("request_cb failed")
            for peer_id, reason in errors:
                try:
                    self._error_cb(peer_id, reason)
                except Exception:
                    self.logger.exception("error_cb failed")
            self._quit.wait(0.01)

    def _pick_peer(self, height: int) -> Optional[_PoolPeer]:
        cands = [
            p
            for p in self._peers.values()
            if p.height >= height and p.pending < MAX_PENDING_PER_PEER
        ]
        return random.choice(cands) if cands else None

    def _unassign(self, req: _Request) -> None:
        peer = self._peers.get(req.peer_id)
        if peer is not None:
            peer.pending = max(0, peer.pending - 1)
        req.peer_id = ""
        req.sent_at = 0.0
