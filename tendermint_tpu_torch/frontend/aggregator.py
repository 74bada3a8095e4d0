"""Cross-client verification aggregator.

The port's copy of the JAX package's ``frontend/aggregator.py``.
``BatchingVerifier`` fits the ``verifier=`` seam of
``crypto/batch.verify_generic``: it serves a caller's ed25519 column batch
by parking it as ONE row in a shared ``parallel.planner.LaneFeed``, so
commit verifications from many concurrent clients fold into one lane-packed
planner dispatch (the feed's guard applies unchanged). Verdict semantics do
not change: ``ValidatorSet.verify_commit`` keeps its own structural checks
and quorum tally over the returned per-lane verdicts; only the signature
primitive is shared.

Anything that is not an ed25519 column batch (secp256k1, the odd
structurally broken item) goes to the process-default verifier, exactly as
a ``verifier=None`` call resolves it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from tendermint_tpu_torch.crypto.batch import get_batch_verifier
from tendermint_tpu_torch.parallel.planner import LaneFeed


class BatchingVerifier:
    """A verify_generic verifier backed by a shared LaneFeed."""

    def __init__(self, feed: LaneFeed, result_timeout: Optional[float] = 60.0):
        self._feed = feed
        self._timeout = result_timeout

    def verify_ed25519_raw(
        self,
        pubs: Sequence[bytes],
        msgs: Sequence[bytes],
        sigs: Sequence[bytes],
    ) -> np.ndarray:
        n = len(pubs)
        if n == 0:
            return np.zeros((0,), dtype=bool)
        # powers and total are placeholders: the caller owns the quorum
        # math, the feed only returns per-lane verdicts in row order
        ticket = self._feed.submit(list(zip(pubs, msgs, sigs)), [1] * n, n)
        return ticket.result(self._timeout).ok

    def verify_ed25519(self, items) -> np.ndarray:
        return self.verify_ed25519_raw(
            [it.pubkey for it in items],
            [it.msg for it in items],
            [it.sig for it in items],
        )

    def __getattr__(self, name):
        return getattr(get_batch_verifier(), name)
