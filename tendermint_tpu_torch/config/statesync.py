"""The ``[statesync]`` configuration section.

The port's copy of the JAX package's ``config/config.py``
``StateSyncConfig``: every field under the same name and with the same
default. ``enable`` turns on the restore state machine for an empty node;
``snapshot_interval > 0`` turns on snapshot production on any node whose
app supports it. The trust root (``trust_height`` + ``trust_hash``, hex of
the header hash at that height) comes from social consensus (a block
explorer, another operator), as in the reference's ``[statesync]``
section. ``node/verify_root.state_sync`` builds both sides from it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class StateSyncConfig:
    enable: bool = False
    trust_height: int = 0
    trust_hash: str = ""
    discovery_time: float = 1.0  # between snapshot-offer broadcasts (s)
    chunk_fetch_timeout: float = 10.0  # per chunk/light-block request (s)
    chunk_retries: int = 3  # attempts per chunk before giving up
    backfill_blocks: int = 16  # trailing commit window after restore
    chunk_send_rate: int = 0  # serving-side bytes/s cap; 0 = unlimited
    # producer side
    snapshot_interval: int = 0  # take a snapshot every N heights; 0 = off
    snapshot_chunk_size: int = 65536
    snapshot_keep_recent: int = 3
    # wire format for produced snapshots: 1 = raw chunks (reference),
    # 2 = per-chunk zlib (statesync/chunker.py SNAPSHOT_FORMAT_ZLIB).
    # Restoring nodes negotiate: an app that rejects a format with
    # REJECT_FORMAT makes the syncer retry the next advertised format.
    snapshot_format: int = 1
