"""FullCommit providers (ref lite/provider.go, lite/dbprovider.go:16; the
port's copy of the reference package's ``lite/provider.py``).

``DBProvider`` is the trust store the DynamicVerifier saves verified
commits into. The reference's ``NodeProvider`` reads a full node's block
store and state store, which the port has not taken over yet (ROADMAP
queue 1 item 12); ``lite/proxy.RPCProvider`` and any object with the
``Provider`` methods serve as sources meanwhile.
"""

from __future__ import annotations

import struct

from tendermint_tpu_torch.lite.types import FullCommit, LiteError


class ProviderError(LiteError):
    """Commit not found (lite/errors.go ErrCommitNotFound)."""


class Provider:
    def latest_full_commit(self, chain_id: str, min_height: int,
                           max_height: int) -> FullCommit:
        """The tallest FullCommit within [min_height, max_height]."""
        raise NotImplementedError

    def full_commit_at(self, chain_id: str, height: int) -> FullCommit:
        return self.latest_full_commit(chain_id, height, height)


class DBProvider(Provider):
    """Trust store over a key-value store (``libs/db/kv.MemDB``)."""

    _PREFIX = b"lite:fc:"

    def __init__(self, db):
        self._db = db

    def _key(self, chain_id: str, height: int) -> bytes:
        # big-endian height, so that the keys sort by height
        return self._PREFIX + chain_id.encode() + b":" + struct.pack(">q", height)

    def save_full_commit(self, fc: FullCommit) -> None:
        chain_id = fc.signed_header.header.chain_id
        self._db.set_sync(self._key(chain_id, fc.height), fc.marshal())

    def latest_full_commit(self, chain_id: str, min_height: int,
                           max_height: int) -> FullCommit:
        lo = self._key(chain_id, min_height)
        hi = self._key(chain_id, max_height + 1)
        # reverse iteration decodes only the tallest entry: bisection calls
        # this on every hop
        for _, v in self._db.iterator(lo, hi, reverse=True):
            return FullCommit.unmarshal(v)
        raise ProviderError(f"no full commit for {chain_id} in [{min_height},{max_height}]")
