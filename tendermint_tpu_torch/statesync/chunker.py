"""Snapshot chunking and the Merkle chunk manifest, the port's copy of the
reference package's ``statesync/chunker.py``.

A snapshot of the app state (one opaque byte blob) is split into
fixed-size chunks. The manifest is the list of 32-byte chunk leaf hashes
(``crypto/merkle.leaf_hash``); the snapshot's ``hash`` is the Merkle root
over those leaves. The manifest rides in ``Snapshot.metadata``
(concatenated hashes), so a restoring node verifies each arriving chunk
against its manifest entry and the manifest itself against the offered
snapshot hash: a corrupted chunk is caught the moment it arrives, before
the app sees it, and the peer that sent it can be punished. Format 2 is
format 1 with each wire chunk zlib-compressed; the manifest covers the
wire chunks.
"""

from __future__ import annotations

import zlib
from typing import List, Sequence

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto import merkle

SNAPSHOT_FORMAT = 1  # opaque app-state blob, fixed-size chunks
SNAPSHOT_FORMAT_ZLIB = 2  # same chunking, each wire chunk zlib-compressed
SUPPORTED_FORMATS = (SNAPSHOT_FORMAT, SNAPSHOT_FORMAT_ZLIB)
DEFAULT_CHUNK_SIZE = 65536
HASH_SIZE = 32


def chunk_state(data: bytes, chunk_size: int = DEFAULT_CHUNK_SIZE) -> List[bytes]:
    """Split an app-state blob into fixed-size chunks (the last one
    ragged). An empty blob is one empty chunk: a snapshot of no chunks
    would make the restore loop and the ABCI apply handshake degenerate."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if not data:
        return [b""]
    return [data[i:i + chunk_size] for i in range(0, len(data), chunk_size)]


def manifest_root(chunk_hashes: Sequence[bytes]) -> bytes:
    """The Merkle root over chunk leaf hashes (the snapshot's ``hash``)."""
    root, _ = merkle.proofs_from_leaf_hashes(list(chunk_hashes))
    return root


def make_snapshot(height: int, data: bytes, chunk_size: int = DEFAULT_CHUNK_SIZE, *,
                  format: int = SNAPSHOT_FORMAT) -> tuple:
    """Chunk ``data`` and build the (Snapshot, chunks) pair for ``height``.
    The manifest covers the wire chunks (compressed for format 2), so the
    transport's check and the app's per-chunk check do not depend on the
    format; only the final join decodes."""
    if format not in SUPPORTED_FORMATS:
        raise ValueError(f"unsupported snapshot format {format}")
    chunks = chunk_state(data, chunk_size)
    if format == SNAPSHOT_FORMAT_ZLIB:
        chunks = [zlib.compress(c) for c in chunks]
    hashes = [merkle.leaf_hash(c) for c in chunks]
    snap = abci.Snapshot(height=height, format=format, chunks=len(chunks),
                         hash=manifest_root(hashes), metadata=b"".join(hashes))
    return snap, chunks


def decode_chunk(chunk: bytes, format: int) -> bytes:
    """Wire chunk -> app-state bytes for ``format``. Raises ValueError on an
    unknown format or a chunk that does not decompress (a manifest-valid
    chunk that fails here means the producer was corrupt, not the wire)."""
    if format == SNAPSHOT_FORMAT:
        return chunk
    if format == SNAPSHOT_FORMAT_ZLIB:
        try:
            return zlib.decompress(chunk)
        except zlib.error as e:
            raise ValueError(f"zlib chunk did not decompress: {e}") from e
    raise ValueError(f"unsupported snapshot format {format}")


def chunk_hashes_from_metadata(snapshot: abci.Snapshot) -> List[bytes]:
    """The manifest out of ``Snapshot.metadata``; raises ValueError when the
    metadata cannot be the manifest of ``snapshot.chunks`` chunks or its
    Merkle root disagrees with the advertised hash (an offer from a lying
    peer dies here, before any chunk is fetched)."""
    md = snapshot.metadata
    if len(md) != snapshot.chunks * HASH_SIZE:
        raise ValueError(
            f"snapshot manifest is {len(md)} bytes, want {snapshot.chunks}x{HASH_SIZE}")
    hashes = [md[i:i + HASH_SIZE] for i in range(0, len(md), HASH_SIZE)]
    if not hashes:
        raise ValueError("snapshot has no chunks")
    if manifest_root(hashes) != snapshot.hash:
        raise ValueError("snapshot manifest root != snapshot hash")
    return hashes


def verify_chunk(chunk: bytes, index: int, chunk_hashes: Sequence[bytes]) -> bool:
    """One arriving chunk against its manifest entry."""
    return 0 <= index < len(chunk_hashes) and merkle.leaf_hash(chunk) == chunk_hashes[index]
