"""FullCommit providers (ref lite/provider.go, lite/dbprovider.go:16; the
port's copy of the reference package's ``lite/provider.py``).

``DBProvider`` is the trust store the DynamicVerifier saves verified
commits into; ``NodeProvider`` is a source over a full node's block store
and state store (``blockchain/store.BlockStore``, ``state/store.py``),
served in process as the reference's RPC client provider serves them over
the network.
"""

from __future__ import annotations

import struct

from tendermint_tpu_torch.lite.types import FullCommit, LiteError, SignedHeader
from tendermint_tpu_torch.state import store as sm_store


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


class NodeProvider(Provider):
    """A source over a full node's block store and state store (ref
    lite/client/provider.go, read in process)."""

    def __init__(self, block_store, state_db):
        self._store = block_store
        self._state_db = state_db

    def latest_full_commit(self, chain_id: str, min_height: int,
                           max_height: int) -> FullCommit:
        for h in range(min(max_height, self._store.height()), min_height - 1, -1):
            try:
                return self.full_commit_at(chain_id, h)
            except ProviderError:
                continue
        raise ProviderError(f"no full commit for {chain_id} in [{min_height},{max_height}]")

    def full_commit_at(self, chain_id: str, height: int) -> FullCommit:
        meta = self._store.load_block_meta(height)
        commit = self._store.load_block_commit(height) or self._store.load_seen_commit(height)
        if meta is None or commit is None:
            raise ProviderError(f"height {height} not in store")
        try:
            vals = sm_store.load_validators(self._state_db, height)
            next_vals = sm_store.load_validators(self._state_db, height + 1)
        except Exception as e:
            raise ProviderError(f"no validators for height {height}: {e}") from e
        return FullCommit(signed_header=SignedHeader(header=meta.header, commit=commit),
                          validators=vals, next_validators=next_vals)
