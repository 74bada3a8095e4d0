"""The mempool side of batched transaction-ingest verification: the port's
copy of the reference package's ``mempool/tx_verify.py``.

``BatchTxVerifier`` is the verdict-bearing CheckTx hook: for each CheckTx
or recheck window it extracts every tx's ``(pubkey, sign_bytes, sig)``
with an app-supplied extractor (``abci/examples/kvstore.
extract_signed_tx_sig``), submits them to a ``parallel/planner.TxFeed``
keyed by the window, flushes, and waits on the tickets: one guarded
dispatch a window. Verdicts are cached by tx hash, so a recheck of
admitted txs answers from the cache and never verifies a signature twice.

An unsigned or odd tx leaves that tx's verdict ``None``: the app decides
it. Off the card (``feed.device`` is the CPU), a closed feed, a failed
flush or a ticket timeout also leave the verdict ``None``, as in the
reference. On the card they raise out of the call instead of handing the
signatures back to a host check: a failed submit or flush raises what it
raised (``DeviceDispatchError`` for a failed, hung or audit-failed
dispatch), and a ticket that is not resolved within ``timeout_s``, or the
guard's dispatch deadline if that is longer, raises
``DeviceDispatchError('timeout')``.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, List, Optional

from tendermint_tpu_torch.crypto.hashing import sha256 as tmhash
from tendermint_tpu_torch.libs.breaker import DeviceDispatchError, guard_config, on_card


class BatchTxVerifier:
    """extract -> feed -> tickets -> per-tx verdicts, with a bounded
    tx-hash verdict cache for rechecks.

    extractor: ``tx -> (pub, sign_bytes, sig) | None`` (None: the app
    decides the verdict serially).
    height_fn: ``() -> int``, the mempool's height, which leads the feed's
    group keys.
    """

    def __init__(self, feed, extractor: Callable, *,
                 timeout_s: float = 5.0, cache_size: int = 10000,
                 height_fn: Optional[Callable[[], int]] = None):
        self.feed = feed
        self.extractor = extractor
        self.timeout_s = float(timeout_s)
        self.height_fn = height_fn
        self._cache_size = max(1, int(cache_size))
        self._cache: "collections.OrderedDict[bytes, bool]" = (
            collections.OrderedDict()
        )
        self._mtx = threading.Lock()
        self._seq = 0
        self.windows = 0  # hook calls (CheckTx and recheck windows)
        self.submitted = 0  # txs dispatched to the feed
        self.cache_hits = 0  # verdicts served from the tx-hash cache
        self.unsigned = 0  # txs the extractor declined (the app decides)
        self.feed_errors = 0  # submit, flush or timeout failures

    @property
    def device(self):
        """The feed's device: ``on_card(verifier)`` holds when its flushes
        run on the card, where the mempool raises a failed window instead
        of handing it to the app's serial check."""
        return getattr(self.feed, "device", None)

    def __call__(self, batch_txs: List[bytes]) -> List[Optional[bool]]:
        n = len(batch_txs)
        verdicts: List[Optional[bool]] = [None] * n
        with self._mtx:
            self.windows += 1
            self._seq += 1
            seq = self._seq
        height = 0
        if self.height_fn is not None:
            try:
                height = int(self.height_fn())
            except Exception:
                height = 0
        group_key = (height, seq)
        card = on_card(self.feed)
        tickets = []  # (batch index, tx hash, ticket)
        for i, tx in enumerate(batch_txs):
            h = tmhash(tx)
            with self._mtx:
                cached = self._cache.get(h)
            if cached is not None:
                verdicts[i] = cached
                self.cache_hits += 1
                continue
            try:
                item = self.extractor(tx)
            except Exception:
                item = None
            if item is None:
                self.unsigned += 1
                continue
            pub, msg, sig = item
            try:
                tickets.append((i, h, self.feed.submit(group_key, pub, msg, sig)))
            except Exception:
                self.feed_errors += 1
                if card:
                    raise
                continue
            self.submitted += 1
        if tickets:
            # the window is a whole mempool batch: collapse the feed's
            # deadline so admission never waits it out
            self.feed.flush_now()
            timeout = self.timeout_s
            if card:
                # a dispatch the guard still supervises is not yet a failure
                timeout = max(timeout, guard_config().dispatch_deadline)
            for i, h, ticket in tickets:
                try:
                    ok = bool(ticket.result(timeout=timeout).ok)
                except DeviceDispatchError:
                    self.feed_errors += 1
                    raise
                except TimeoutError as e:
                    self.feed_errors += 1
                    if card:
                        raise DeviceDispatchError("timeout", "tx feed flush") from e
                    continue
                except Exception:
                    self.feed_errors += 1
                    if card:
                        raise
                    continue
                verdicts[i] = ok
                with self._mtx:
                    self._cache[h] = ok
                    while len(self._cache) > self._cache_size:
                        self._cache.popitem(last=False)
        return verdicts
