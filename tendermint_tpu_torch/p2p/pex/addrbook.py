"""AddrBook — persisted peer-address store with new/old bucketing
(ref: p2p/pex/addrbook.go, 850 LoC).

Semantics kept from the reference:

* addresses live in hashed buckets, NEW (heard about) vs OLD (connected to
  successfully at least once — "markGood" promotes);
* per-bucket capacity with eviction of the worst entry (most attempts,
  oldest success);
* ``pick_address(bias)`` samples OLD vs NEW by bias% (pex's dial source);
* JSON persistence (addrbook.json), loaded on construction.

Bucket count/size mirror addrbook.go (256 new / 64 old buckets, 64 slots).

The port's copy of the reference package's ``p2p/pex/addrbook.py``: the
same JSON layout and the same ``_bucket_of`` hash, so a book written by
one package loads in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tendermint_tpu_torch.p2p.netaddress import NetAddress

NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
BUCKET_SIZE = 64
MAX_ATTEMPTS = 10  # give up on an address after this many failed dials


@dataclass
class KnownAddress:
    """addrbook.go knownAddress."""

    addr: NetAddress
    src: NetAddress
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    bucket_type: str = "new"  # "new" | "old"
    # monotonic twin of last_attempt for interval math (a wall-clock step
    # backwards must not freeze redials); NOT persisted — 0.0 after a load
    # means "never attempted this process lifetime", which only re-dials
    # sooner, never later
    last_attempt_mono: float = 0.0

    def to_json(self) -> dict:
        return {
            "addr": str(self.addr),
            "src": str(self.src),
            "attempts": self.attempts,
            "last_attempt": self.last_attempt,
            "last_success": self.last_success,
            "bucket_type": self.bucket_type,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "KnownAddress":
        return cls(
            addr=NetAddress.parse(obj["addr"]),
            src=NetAddress.parse(obj["src"]),
            attempts=obj.get("attempts", 0),
            last_attempt=obj.get("last_attempt", 0.0),
            last_success=obj.get("last_success", 0.0),
            bucket_type=obj.get("bucket_type", "new"),
        )


class AddrBook:
    def __init__(self, file_path: Optional[str] = None, strict: bool = True):
        """strict: refuse non-routable addresses (addr_book_strict config);
        turn off for localhost testnets."""
        self._mtx = threading.Lock()
        self._file = file_path
        self._strict = strict
        self._by_id: Dict[str, KnownAddress] = {}
        self._our_ids: set = set()
        if file_path and os.path.exists(file_path):
            self._load()

    # -- identity ----------------------------------------------------------------
    def add_our_address(self, addr: NetAddress) -> None:
        with self._mtx:
            self._our_ids.add(addr.id)

    def is_our_address(self, addr: NetAddress) -> bool:
        with self._mtx:
            return addr.id in self._our_ids

    # -- mutation ----------------------------------------------------------------
    def add_address(self, addr: NetAddress, src: NetAddress) -> bool:
        """Record addr heard from src (addrbook.go AddAddress). False when
        rejected (ours, non-routable in strict mode, or already old)."""
        if not addr.id:
            return False
        with self._mtx:
            if addr.id in self._our_ids:
                return False
            if self._strict and not addr.routable():
                return False
            ka = self._by_id.get(addr.id)
            if ka is not None:
                if ka.bucket_type == "old":
                    return False  # old entries win
                # refresh the new entry's address (peers can move)
                ka.addr = addr
                return True
            # evict if the (virtual) bucket is full: worst = most attempts
            bucket = [
                k for k in self._by_id.values()
                if k.bucket_type == "new"
                and self._bucket_of(k.addr) == self._bucket_of(addr)
            ]
            if len(bucket) >= BUCKET_SIZE:
                worst = max(bucket, key=lambda k: (k.attempts, -k.last_success))
                self._by_id.pop(worst.addr.id, None)
            self._by_id[addr.id] = KnownAddress(addr=addr, src=src)
            return True

    def mark_attempt(self, addr: NetAddress) -> None:
        with self._mtx:
            ka = self._by_id.get(addr.id)
            if ka is not None:
                ka.attempts += 1
                ka.last_attempt = time.time()
                ka.last_attempt_mono = time.monotonic()
                if ka.attempts >= MAX_ATTEMPTS and ka.bucket_type == "new":
                    self._by_id.pop(addr.id, None)  # hopeless: drop

    def mark_good(self, addr: NetAddress) -> None:
        """Successful connection: promote to OLD (addrbook.go MarkGood)."""
        with self._mtx:
            ka = self._by_id.get(addr.id)
            if ka is None:
                ka = KnownAddress(addr=addr, src=addr)
                self._by_id[addr.id] = ka
            ka.attempts = 0
            ka.last_success = time.time()
            ka.bucket_type = "old"

    def remove_address(self, addr: NetAddress) -> None:
        with self._mtx:
            self._by_id.pop(addr.id, None)

    # -- queries ------------------------------------------------------------------
    def has_address(self, addr: NetAddress) -> bool:
        with self._mtx:
            return addr.id in self._by_id

    def is_good(self, addr: NetAddress) -> bool:
        with self._mtx:
            ka = self._by_id.get(addr.id)
            return ka is not None and ka.bucket_type == "old"

    def size(self) -> int:
        with self._mtx:
            return len(self._by_id)

    def pick_address(self, new_bias_pct: int = 30) -> Optional[NetAddress]:
        """Random address, biased new-vs-old (addrbook.go PickAddress)."""
        with self._mtx:
            new = [k for k in self._by_id.values() if k.bucket_type == "new"]
            old = [k for k in self._by_id.values() if k.bucket_type == "old"]
            pools = []
            if random.randint(0, 99) < new_bias_pct:
                pools = [new, old]
            else:
                pools = [old, new]
            for pool in pools:
                if pool:
                    return random.choice(pool).addr
            return None

    def get_selection(self, max_count: int = 250) -> List[NetAddress]:
        """Random sample for a PEX response (addrbook.go GetSelection: up to
        23% of book, capped)."""
        with self._mtx:
            addrs = [k.addr for k in self._by_id.values()]
        random.shuffle(addrs)
        n = min(len(addrs), max(1, len(addrs) * 23 // 100), max_count)
        return addrs[:n]

    def get_selection_with_bias(
        self, new_bias_pct: int = 30, max_count: int = 250
    ) -> List[NetAddress]:
        """Selection biased new-vs-old by percentage — what a seed answers
        crawl requests with (addrbook.go GetSelectionWithBias, used at
        pex_reactor.go:186 with biasTowardsNewAddrs=30)."""
        with self._mtx:
            new = [k.addr for k in self._by_id.values() if k.bucket_type == "new"]
            old = [k.addr for k in self._by_id.values() if k.bucket_type == "old"]
        total = len(new) + len(old)
        if total == 0:
            return []
        n = min(total, max(1, total * 23 // 100), max_count)
        random.shuffle(new)
        random.shuffle(old)
        # round the new-portion UP: a bias toward new addrs must survive
        # tiny selections (n=1 would otherwise always pick old — for a seed
        # that means answering a crawler with its own address)
        want_new = min(len(new), -(-n * new_bias_pct // 100))
        sel = new[:want_new] + old[: n - want_new]
        if len(sel) < n:  # one pool ran short: top up from the other
            sel += new[want_new : want_new + n - len(sel)]
        random.shuffle(sel)
        return sel

    def list_known(self) -> List[KnownAddress]:
        """Snapshot of every known address with its attempt timestamps —
        the seed crawler's work list (addrbook.go ListOfKnownAddresses)."""
        with self._mtx:
            return [
                KnownAddress(
                    addr=k.addr, src=k.src, attempts=k.attempts,
                    last_attempt=k.last_attempt, last_success=k.last_success,
                    bucket_type=k.bucket_type,
                    last_attempt_mono=k.last_attempt_mono,
                )
                for k in self._by_id.values()
            ]

    # -- persistence ---------------------------------------------------------------
    def save(self) -> None:
        if not self._file:
            return
        with self._mtx:
            entries = [k.to_json() for k in self._by_id.values()]
        tmp = self._file + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self._file)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"addrs": entries}, f)
        os.replace(tmp, self._file)

    def _load(self) -> None:
        try:
            with open(self._file) as f:
                data = json.load(f)
            for obj in data.get("addrs", []):
                ka = KnownAddress.from_json(obj)
                self._by_id[ka.addr.id] = ka
        except Exception:
            pass  # corrupt book: start fresh (reference panics; we resync)

    # -- internals -----------------------------------------------------------------
    @staticmethod
    def _bucket_of(addr: NetAddress) -> int:
        h = hashlib.sha256(f"{addr.host}".encode()).digest()
        return h[0]
