"""The interfaces the block executor needs and their mocks (ref
state/services.go), the port's copy of the reference package's
``state/services.py``: ``Mempool`` and ``MockMempool``, ``EvidencePool``
and ``MockEvidencePool``, and ``BlockStoreBase``."""

from __future__ import annotations

import threading
from typing import List


class Mempool:
    """Interface the BlockExecutor requires (services.go:34)."""

    def lock(self) -> None: ...

    def unlock(self) -> None: ...

    def size(self) -> int: ...

    def check_tx(self, tx: bytes, callback=None, on_fault=None) -> None: ...

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]: ...

    def update(self, height: int, txs, pre_check=None, post_check=None) -> None: ...

    def flush(self) -> None: ...

    def flush_app_conn(self) -> None: ...

    def txs_available(self): ...

    def enable_txs_available(self) -> None: ...


class MockMempool(Mempool):
    def __init__(self):
        self._mtx = threading.Lock()

    def lock(self) -> None:
        self._mtx.acquire()

    def unlock(self) -> None:
        self._mtx.release()

    def size(self) -> int:
        return 0

    def check_tx(self, tx: bytes, callback=None, on_fault=None) -> None:
        pass

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        return []

    def update(self, height: int, txs, pre_check=None, post_check=None) -> None:
        pass

    def flush(self) -> None:
        pass

    def flush_app_conn(self) -> None:
        pass

    def txs_available(self):
        return None

    def enable_txs_available(self) -> None:
        pass


class EvidencePool:
    """Interface (services.go:90)."""

    def pending_evidence(self, max_bytes: int) -> list: ...

    def add_evidence(self, ev) -> None: ...

    def update(self, block, state) -> None: ...

    def is_committed(self, ev) -> bool: ...


class MockEvidencePool(EvidencePool):
    def __init__(self):
        self.added: list = []  # kept for tests; never proposed

    def pending_evidence(self, max_bytes: int) -> list:
        return []

    def add_evidence(self, ev) -> None:
        self.added.append(ev)

    def update(self, block, state) -> None:
        pass

    def is_committed(self, ev) -> bool:
        return False


class BlockStoreBase:
    """Interface of the block store (services.go BlockStoreRPC/BlockStore)."""

    def height(self) -> int: ...

    def load_block(self, height: int): ...

    def save_block(self, block, parts, seen_commit) -> None: ...
