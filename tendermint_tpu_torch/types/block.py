"""Commit: the +2/3 precommits for a block; precommits[i] indexes the
validator set and may be None (ref types/block.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.types.core import BlockID
from tendermint_tpu_torch.types.vote import Vote


@dataclass
class Commit:
    block_id: BlockID = field(default_factory=BlockID)
    precommits: List[Optional[Vote]] = field(default_factory=list)

    def _first(self) -> Optional[Vote]:
        for pc in self.precommits:
            if pc is not None:
                return pc
        return None

    def height(self) -> int:
        v = self._first()
        return v.height if v else 0

    def round(self) -> int:
        v = self._first()
        return v.round if v else 0
