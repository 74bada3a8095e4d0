"""State sync: snapshot and chunk bootstrap with light-client trust and a
planner-batched commit backfill (v0.34 lineage), the port's copy of the
reference package's ``statesync`` package.

  chunker   fixed-size chunking and the Merkle chunk manifest
  store     persisted snapshots and chunks (the producer side)
  messages  the wire messages of the state-sync channel (0x60)
  reactor   serves snapshots, chunks and light blocks; hosts the syncer
  syncer    discovery -> light-client verify -> restore -> backfill
"""

from tendermint_tpu_torch.statesync.chunker import (
    chunk_hashes_from_metadata,
    chunk_state,
    make_snapshot,
    manifest_root,
    verify_chunk,
)
from tendermint_tpu_torch.statesync.reactor import STATESYNC_CHANNEL, StateSyncReactor
from tendermint_tpu_torch.statesync.store import SnapshotStore
from tendermint_tpu_torch.statesync.syncer import StateSyncError, StateSyncer

__all__ = [
    "STATESYNC_CHANNEL",
    "SnapshotStore",
    "StateSyncError",
    "StateSyncReactor",
    "StateSyncer",
    "chunk_hashes_from_metadata",
    "chunk_state",
    "make_snapshot",
    "manifest_root",
    "verify_chunk",
]
