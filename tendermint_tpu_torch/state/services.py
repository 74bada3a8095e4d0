"""The mempool interface the block executor needs, and its mock (ref
state/services.go): the port's copy of ``Mempool`` and ``MockMempool``
from the reference package's ``state/services.py``."""

from __future__ import annotations

import threading
from typing import List


class Mempool:
    """Interface the BlockExecutor requires (services.go:34)."""

    def lock(self) -> None: ...

    def unlock(self) -> None: ...

    def size(self) -> int: ...

    def check_tx(self, tx: bytes, callback=None) -> None: ...

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

    def check_tx(self, tx: bytes, callback=None) -> None:
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
