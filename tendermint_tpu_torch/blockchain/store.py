"""BlockStore: persisted blocks, parts and commits (ref
blockchain/store.go), the port's copy of the reference package's
``blockchain/store.py``.

Its keys, all in one store:
  H:<height>      -> BlockMeta (block id and header)
  P:<height>:<i>  -> part i of the block
  C:<height>      -> the commit of the block at <height> (block
                     <height> + 1's LastCommit, once that block is saved)
  SC:<height>     -> the seen commit (the +2/3 precommits seen locally)
  BH              -> the store's height
  BB              -> the store's base, the lowest height kept (above 1
                     after a state-sync restore or pruning)
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.libs.db.kv import DB
from tendermint_tpu_torch.types.block import Block, Commit, Header
from tendermint_tpu_torch.types.core import BlockID
from tendermint_tpu_torch.types.part_set import Part, PartSet


@dataclass
class BlockMeta:
    block_id: BlockID
    header: Header

    def marshal(self) -> bytes:
        w = Writer()
        self.block_id.encode(w)
        self.header.encode(w)
        return w.build()

    @classmethod
    def unmarshal(cls, data: bytes) -> "BlockMeta":
        r = Reader(data)
        return cls(block_id=BlockID.decode(r), header=Header.decode(r))


class BlockStore:
    def __init__(self, db: DB):
        self._db = db
        self._mtx = threading.RLock()
        raw = db.get(b"BH")
        self._height = int(raw.decode()) if raw else 0
        raw = db.get(b"BB")
        self._base = int(raw.decode()) if raw else (1 if self._height else 0)

    def height(self) -> int:
        with self._mtx:
            return self._height

    def base(self) -> int:
        """The lowest height kept (store.go Base); 0 for an empty store. A
        node restored from a snapshot starts at its first backfilled height."""
        with self._mtx:
            return self._base

    # loads ----------------------------------------------------------------
    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        raw = self._db.get(b"H:%d" % height)
        return BlockMeta.unmarshal(raw) if raw else None

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        parts = []
        for i in range(meta.block_id.parts_header.total):
            raw = self._db.get(b"P:%d:%d" % (height, i))
            if raw is None:
                return None
            parts.append(Part.unmarshal(raw))
        return Block.unmarshal(b"".join(p.bytes_ for p in parts))

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        raw = self._db.get(b"P:%d:%d" % (height, index))
        return Part.unmarshal(raw) if raw else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """The commit of the block at ``height``, from block height + 1's
        LastCommit (store.go LoadBlockCommit)."""
        raw = self._db.get(b"C:%d" % height)
        return Commit.unmarshal(raw) if raw else None

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        raw = self._db.get(b"SC:%d" % height)
        return Commit.unmarshal(raw) if raw else None

    # saves ----------------------------------------------------------------
    def save_block(self, block: Block, parts: PartSet, seen_commit: Commit) -> None:
        """store.go SaveBlock: the meta, the parts, the block's LastCommit
        (as height - 1's commit) and this height's seen commit."""
        if block is None:
            raise ValueError("BlockStore can only save a non-nil block")
        height = block.height
        with self._mtx:
            if height != self._height + 1:
                raise ValueError(
                    f"BlockStore can only save contiguous blocks. "
                    f"Wanted {self._height + 1}, got {height}"
                )
            if not parts.is_complete():
                raise ValueError("BlockStore can only save complete part sets")
            block_id = BlockID(hash=block.hash(), parts_header=parts.header())
            batch = self._db.batch()
            batch.set(b"H:%d" % height, BlockMeta(block_id, block.header).marshal())
            for i in range(parts.total):
                batch.set(b"P:%d:%d" % (height, i), parts.get_part(i).marshal())
            if block.last_commit.is_commit():
                batch.set(b"C:%d" % (height - 1), block.last_commit.marshal())
            batch.set(b"SC:%d" % height, seen_commit.marshal())
            batch.set(b"BH", str(height).encode())
            if self._base == 0:
                batch.set(b"BB", str(height).encode())
            batch.write()
            self._height = height
            if self._base == 0:
                self._base = height

    def save_statesync_backfill(self, metas: List[BlockMeta], commits) -> None:
        """Seed an empty store from a state-sync backfill window: the metas
        and commits of a run of heights ending at the restore height. No
        parts are kept (the blocks were never fetched), so ``load_block``
        gives None there; the metas, the commits and the top's seen commit
        serve the consensus hand-off and light clients. Later
        ``save_block`` calls continue above the top."""
        if len(metas) != len(commits) or not metas:
            raise ValueError("backfill needs aligned, non-empty metas/commits")
        heights = [m.header.height for m in metas]
        if heights != list(range(heights[0], heights[0] + len(heights))):
            raise ValueError(f"backfill heights not contiguous: {heights}")
        with self._mtx:
            if self._height != 0:
                raise ValueError(
                    f"can only seed an empty store (height {self._height})"
                )
            batch = self._db.batch()
            for meta, commit in zip(metas, commits):
                h = meta.header.height
                batch.set(b"H:%d" % h, meta.marshal())
                batch.set(b"C:%d" % h, commit.marshal())
            top = heights[-1]
            batch.set(b"SC:%d" % top, commits[-1].marshal())
            batch.set(b"BH", str(top).encode())
            batch.set(b"BB", str(heights[0]).encode())
            batch.write()
            self._height = top
            self._base = heights[0]

    def prune(self, retain_height: int) -> int:
        """Delete everything below ``retain_height`` (store.go PruneBlocks);
        the number of heights pruned. The top block always stays."""
        with self._mtx:
            if retain_height <= self._base:
                return 0
            retain_height = min(retain_height, self._height)
            pruned = 0
            batch = self._db.batch()
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is not None:
                    for i in range(meta.block_id.parts_header.total):
                        batch.delete(b"P:%d:%d" % (h, i))
                batch.delete(b"H:%d" % h)
                batch.delete(b"C:%d" % h)
                batch.delete(b"SC:%d" % h)
                pruned += 1
            batch.set(b"BB", str(retain_height).encode())
            batch.write()
            self._base = retain_height
            return pruned
