"""Mempool: pending txs validated by the app's CheckTx (ref
mempool/mempool.go), the port's copy of the reference package's
``mempool/mempool.py``.

A concurrent list of good txs feeds block proposals
(``reap_max_bytes_max_gas``); a bounded cache of seen tx hashes rejects
duplicates; the survivors are rechecked after every commit (``update``).
On top of the reference shape:

* **priority lanes**: ``ResponseCheckTx.priority`` (else ``gas_wanted``)
  picks a lane through ``lane_bounds``. Reap serves higher lanes first,
  FIFO within a lane; a full pool evicts the oldest tx of the lowest
  strictly lower lane instead of rejecting. With no lanes a full pool
  raises ``MempoolFullError`` synchronously.
* **micro-batched CheckTx / recheck**: with ``checktx_batch > 1``
  submissions coalesce into one app-conn flush window (closed when full or
  after ``checktx_batch_wait`` seconds on a timer thread);
  ``recheck_batch > 0`` chunks the post-commit recheck the same way.
  ``batch_check_hook`` sees each window's raw txs: observational by
  default; ``set_batch_check_hook(hook, verdicts=True)`` makes it the
  verdict-bearing seam (``mempool/tx_verify.BatchTxVerifier`` over
  ``parallel/planner.TxFeed``): each window's app sends wait for the hook's
  per-tx signature verdicts, which ride ``RequestCheckTx.sig_verified`` so
  the app pays no serial verify.
* **recheck cursor resync**: a tx removed mid-recheck resynchronizes the
  cursor through the hash index.

Where the reference and the port differ: a failed verdict-bearing hook (it
raises, or returns a verdict list of the wrong length) is logged by the
reference, which hands the window to the app's serial verify. The port
does that only off the card. When the hook's feed is on the card
(``libs/breaker.on_card(hook)``) the window's txs reach no app: they are
taken out of the cache (a resubmission is not ``TxInCacheError``), a
recheck window's txs also out of the pool, and the error (the guard's
``DeviceDispatchError``, what the feed raised, or a ``DeviceDispatchError``
for a wrong-length list) is raised to the caller whose call ran the flush:
``check_tx``, ``update`` or an explicit flush. A flush on the wait timer's
thread has no caller: it keeps the error and the next ``check_tx``,
``update``, ``flush_app_conn`` or ``_flush_checktx_batch`` raises it.
The mempool WAL (``wal_path``) is not ported yet.
"""

from __future__ import annotations

import collections
import inspect
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto.hashing import sha256 as tmhash
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.breaker import DeviceDispatchError, on_card
from tendermint_tpu_torch.libs.clist import CElement, CList
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.state.services import Mempool as MempoolIface


class MempoolError(Exception):
    pass


class TxInCacheError(MempoolError):
    def __init__(self):
        super().__init__("tx already exists in cache")


class MempoolFullError(MempoolError):
    def __init__(self, size: int, max_size: int):
        super().__init__(f"mempool is full: {size} >= {max_size}")


# nonzero ResponseCheckTx.code stamped on a tx rejected because the pool is
# full and no lower-lane tx can be evicted for it (multi-lane configs defer
# the full decision to the response callback, where the lane is known)
CODE_MEMPOOL_FULL = 0xF001


@dataclass
class MempoolTx:
    height: int  # height when tx was validated
    gas_wanted: int
    tx: bytes
    priority: int = 0
    lane: int = 0


class TxCache:
    """Bounded FIFO set of seen tx hashes (ref mempool.go txCache)."""

    def __init__(self, size: int):
        self._size = size
        self._map: Dict[bytes, None] = {}
        self._queue: collections.deque = collections.deque()
        self._mtx = threading.Lock()

    def push(self, tx: bytes) -> bool:
        """False if already present."""
        h = tmhash(tx)
        with self._mtx:
            if h in self._map:
                return False
            if len(self._queue) >= self._size:
                old = self._queue.popleft()
                self._map.pop(old, None)
            self._queue.append(h)
            self._map[h] = None
            return True

    def remove(self, tx: bytes) -> None:
        h = tmhash(tx)
        with self._mtx:
            if h in self._map:
                del self._map[h]
                try:
                    self._queue.remove(h)
                except ValueError:
                    pass

    def reset(self) -> None:
        with self._mtx:
            self._map.clear()
            self._queue.clear()


class Mempool(MempoolIface):
    def __init__(
        self,
        proxy_app,  # AppConnMempool
        height: int = 0,
        size: int = 5000,
        cache_size: int = 10000,
        max_tx_bytes: int = 1024 * 1024,
        recheck: bool = True,
        metrics=None,
        logger=None,
        lane_bounds: Sequence[int] = (),
        checktx_batch: int = 1,
        checktx_batch_wait: float = 0.005,
        recheck_batch: int = 0,
    ):
        self._proxy = proxy_app
        self._txs = CList()
        self._tx_map: Dict[bytes, CElement] = {}  # tx hash -> element
        self._height = height
        self._rechecking = False
        self._recheck_cursor: Optional[CElement] = None
        self._recheck_end: Optional[CElement] = None
        self._recheck_pending = 0
        self._stale_recheck = 0
        self._notified_txs_available = False
        self._txs_available: Optional[threading.Event] = None
        self._max_size = size
        self._max_tx_bytes = max_tx_bytes
        self._recheck_enabled = recheck
        self.cache = TxCache(cache_size)
        self._mtx = threading.RLock()  # the consensus Lock/Unlock boundary
        self.metrics = metrics  # libs/metrics.MempoolMetrics
        # priority lanes: ascending thresholds; priority >= bounds[i] rides
        # lane i+1. Lane dicts hold CElement -> None in insertion (FIFO)
        # order beside the CList.
        self._lane_bounds = tuple(sorted(lane_bounds))
        self._lanes: List[Dict[CElement, None]] = [
            {} for _ in range(len(self._lane_bounds) + 1)
        ]
        # micro-batching (1 = flush per submission, the reference behavior)
        self._checktx_batch = max(1, int(checktx_batch))
        self._checktx_batch_wait = checktx_batch_wait
        self._recheck_batch = max(0, int(recheck_batch))
        self._pending_flush = 0
        self._pending_since = 0.0
        self._flush_timer: Optional[threading.Timer] = None
        # the CheckTx/recheck window seam (set_batch_check_hook)
        self.batch_check_hook: Optional[Callable[[List[bytes]], None]] = None
        self._hook_verdicts = False
        self._batch_txs: List[bytes] = []
        self._batch_cbs: List[Optional[Callable]] = []
        self._proxy_takes_verdict: Optional[bool] = None
        # a failed window of the timer's thread, raised by the next call
        self._deferred_error: Optional[BaseException] = None
        self.logger = logger or logging.getLogger("tm.mempool")
        self._proxy.set_response_callback(self._res_cb)

    # locking (held by BlockExecutor.commit) -------------------------------
    def lock(self) -> None:
        self._mtx.acquire()

    def unlock(self) -> None:
        self._mtx.release()

    def set_batch_check_hook(self, hook: Optional[Callable], *, verdicts: bool = False) -> None:
        """Install the CheckTx-window hook.

        ``verdicts=False`` keeps the observational contract: the hook is
        called with each window's raw txs after the app requests were
        queued. ``verdicts=True`` makes it the verdict-bearing seam
        (``mempool/tx_verify.BatchTxVerifier``): the window's app sends wait
        for the hook's per-tx verdict list (True = signature verified good,
        False = verified bad, None = unknown), and each verdict rides its
        request's ``sig_verified``. The app still owns the response (nonce
        and state checks, reject codes)."""
        self.batch_check_hook = hook
        self._hook_verdicts = bool(hook is not None and verdicts)

    def _send_checktx(self, tx: bytes, sig_verified=None):
        """One app-conn CheckTx send carrying the batched verdict; a conn
        without the parameter (test fakes) gets the bare call. The probe is
        by signature, not try/except: a local conn runs the app inline, so a
        TypeError out of the app must not trigger a resend."""
        if self._proxy_takes_verdict is None:
            try:
                params = inspect.signature(self._proxy.check_tx_async).parameters
                self._proxy_takes_verdict = "sig_verified" in params
            except (TypeError, ValueError):
                self._proxy_takes_verdict = False
        if self._proxy_takes_verdict:
            return self._proxy.check_tx_async(tx, sig_verified=sig_verified)
        return self._proxy.check_tx_async(tx)

    def _window_verdicts(self, hook, batch_txs: List[bytes], what: str):
        """The hook's verdicts for one window, or None (the app verifies
        serially) when it fails off the card. On the card a failed hook
        raises what it raised, and a list of the wrong length raises
        ``DeviceDispatchError``."""
        card = on_card(hook)
        try:
            verdicts = hook(batch_txs)
        except Exception:
            if card:
                raise
            self.logger.exception("batch check hook failed%s; falling back to serial verify",
                                  what)
            return None
        if verdicts is not None and len(verdicts) != len(batch_txs):
            if card:
                raise DeviceDispatchError(
                    "error", f"batch check hook: {len(verdicts)} verdicts for "
                    f"{len(batch_txs)} txs")
            self.logger.error("batch check hook returned %d verdicts for %d txs%s; ignored",
                              len(verdicts), len(batch_txs), what)
            return None
        return verdicts

    def _raise_deferred_error(self) -> None:
        """Raise, once, a failure the wait timer's thread kept."""
        with self._mtx:
            err, self._deferred_error = self._deferred_error, None
        if err is not None:
            raise err

    # info -----------------------------------------------------------------
    def size(self) -> int:
        return len(self._txs)

    def height(self) -> int:
        """Height the pool last validated against (the tx feed's group key
        leads with it)."""
        return self._height

    def n_lanes(self) -> int:
        return len(self._lanes)

    def lane_of(self, priority: int) -> int:
        lane = 0
        for bound in self._lane_bounds:
            if priority >= bound:
                lane += 1
            else:
                break
        return lane

    def lane_sizes(self) -> List[int]:
        with self._mtx:
            return [len(lane) for lane in self._lanes]

    def flush_app_conn(self) -> None:
        self._proxy.flush_sync()
        self._raise_deferred_error()

    def flush(self) -> None:
        """Drop all txs + cache (unsafe_flush_mempool RPC)."""
        with self._mtx:
            self.cache.reset()
            el = self._txs.front()
            while el is not None:
                nxt = el.next()
                self._txs.remove(el)
                el = nxt
            self._tx_map.clear()
            for lane in self._lanes:
                lane.clear()
            self._update_lane_metrics()

    def txs_front(self) -> Optional[CElement]:
        return self._txs.front()

    def txs_wait_chan(self):
        return self._txs

    # txs available notification -------------------------------------------
    def enable_txs_available(self) -> None:
        self._txs_available = threading.Event()

    def txs_available(self) -> Optional[threading.Event]:
        return self._txs_available

    def _notify_txs_available(self) -> None:
        if self.size() == 0:
            return
        if self._txs_available is not None and not self._notified_txs_available:
            self._notified_txs_available = True
            self._txs_available.set()

    # element bookkeeping ---------------------------------------------------
    def _add_tx(self, memtx: MempoolTx) -> CElement:
        el = self._txs.push_back(memtx)
        self._tx_map[tmhash(memtx.tx)] = el
        self._lanes[memtx.lane][el] = None
        return el

    def _remove_el(self, el: CElement, *, from_cache: bool) -> None:
        if el.removed:
            return
        self._txs.remove(el)
        memtx = el.value
        self._tx_map.pop(tmhash(memtx.tx), None)
        self._lanes[memtx.lane].pop(el, None)
        if from_cache:
            self.cache.remove(memtx.tx)

    def _update_lane_metrics(self) -> None:
        if self.metrics is None or len(self._lanes) <= 1:
            return
        for i, lane in enumerate(self._lanes):
            self.metrics.mempool_lane_txs.set(len(lane), (str(i),))

    def _evict_for_lane(self, lane: int) -> bool:
        """Make room for an incoming lane-`lane` tx: drop the oldest tx from
        the lowest occupied lane strictly below it. False = nothing
        evictable (the newcomer is rejected instead)."""
        for low in range(lane):
            if self._lanes[low]:
                victim = next(iter(self._lanes[low]))
                self._remove_el(victim, from_cache=True)
                self.logger.debug("evicted lane-%d tx for lane-%d arrival", low, lane)
                if self.metrics is not None:
                    self.metrics.mempool_qos_evicted_total.add(1.0, (str(low),))
                return True
        return False

    # CheckTx ---------------------------------------------------------------
    def check_tx(self, tx: bytes, callback: Optional[Callable] = None) -> None:
        """Queue tx for app validation; good txs enter the list
        (mempool.go:301).

        Single-lane configs keep the reference contract: a full pool raises
        ``MempoolFullError`` synchronously. With lanes configured the full
        decision needs the tx's priority, so it is deferred to the response
        callback: the tx either evicts a lower-lane victim or comes back
        with ``code=CODE_MEMPOOL_FULL``.
        """
        self._raise_deferred_error()
        flush = False
        with self._mtx:
            if self.size() >= self._max_size and len(self._lanes) == 1:
                raise MempoolFullError(self.size(), self._max_size)
            if len(tx) > self._max_tx_bytes:
                raise MempoolError(f"tx too large ({len(tx)} bytes)")
            if not self.cache.push(tx):
                raise TxInCacheError()
            if self._hook_verdicts:
                # verdict-bearing seam: the app send waits for the flush,
                # where the batched signature verdict rides the request
                self._batch_cbs.append(callback)
            else:
                rr = self._proxy.check_tx_async(tx)
                if callback is not None:
                    rr.set_callback(lambda req, res: callback(res))
            if self._pending_flush == 0:
                self._pending_since = time.perf_counter()
            self._pending_flush += 1
            self._batch_txs.append(tx)
            if self._checktx_batch <= 1 or self._pending_flush >= self._checktx_batch:
                flush = True
            elif self._flush_timer is None:
                t = threading.Timer(self._checktx_batch_wait, self._flush_deadline)
                t.daemon = True
                self._flush_timer = t
                t.start()
        if flush:
            self._flush_window()

    def _flush_deadline(self) -> None:
        # the batch-wait timer: flush whatever has accumulated
        with self._mtx:
            self._flush_timer = None
        try:
            self._flush_window()
        except Exception as e:
            if not on_card(self.batch_check_hook):
                raise
            # no caller on this thread: the next call raises it
            with self._mtx:
                if self._deferred_error is None:
                    self._deferred_error = e

    def _flush_checktx_batch(self) -> None:
        """Close the current micro-batch now (the explicit flush), then
        raise a failure the wait timer's thread kept."""
        self._flush_window()
        self._raise_deferred_error()

    def _flush_window(self) -> None:
        """One app-conn flush window for every CheckTx accumulated since the
        last one."""
        with self._mtx:
            n = self._pending_flush
            if n == 0:
                return
            self._pending_flush = 0
            batch_txs, self._batch_txs = self._batch_txs, []
            batch_cbs, self._batch_cbs = self._batch_cbs, []
            if self._flush_timer is not None:
                self._flush_timer.cancel()
                self._flush_timer = None
            pack_s = time.perf_counter() - self._pending_since
            hook = self.batch_check_hook
            verdict_mode = self._hook_verdicts and hook is not None
            if hook is not None and not verdict_mode:
                hook(batch_txs)
        if verdict_mode:
            # the hook runs OUTSIDE the lock: it blocks on the tx feed's
            # window, and admission must not hold the consensus Lock/Unlock
            # boundary hostage for it
            try:
                verdicts = self._window_verdicts(hook, batch_txs, "")
            except Exception:
                # on the card: the window is not admitted, and a
                # resubmission must not be TxInCacheError
                for tx in batch_txs:
                    self.cache.remove(tx)
                raise
            with self._mtx:
                for i, tx in enumerate(batch_txs):
                    rr = self._send_checktx(tx, None if verdicts is None else verdicts[i])
                    cb = batch_cbs[i] if i < len(batch_cbs) else None
                    if cb is not None:
                        rr.set_callback(lambda req, res, _cb=cb: _cb(res))
        t0 = time.perf_counter()
        self._proxy.flush_async()
        run_s = time.perf_counter() - t0
        if self._checktx_batch > 1:
            get_profiler().record("mempool.checktx_batch", bucket=(n,), lanes_present=n,
                                  pack_seconds=pack_s, run_seconds=run_s)
        if self.metrics is not None:
            self.metrics.mempool_checktx_batch_size.observe(n)

    def _res_cb(self, req, res) -> None:
        if isinstance(res, abci.ResponseCheckTx):
            with self._mtx:
                if self._stale_recheck > 0:
                    # a commit aborted the recheck round these belong to;
                    # responses arrive in send order, so the next N CheckTx
                    # responses are exactly the aborted round's leftovers
                    self._stale_recheck -= 1
                    return
                if self._rechecking:
                    self._res_cb_recheck(req, res)
                else:
                    self._res_cb_normal(req, res)
                self._update_lane_metrics()
            if self.metrics is not None:
                self.metrics.mempool_size.set(self.size())

    def _res_cb_normal(self, req: abci.RequestCheckTx, res: abci.ResponseCheckTx) -> None:
        tx = req.tx
        if res.code == abci.CODE_TYPE_OK:
            priority = res.priority if res.priority else res.gas_wanted
            lane = self.lane_of(priority)
            if self.size() >= self._max_size:
                # full: admit by evicting below, else reject this tx; the
                # rejection is stamped on the response so callbacks surface
                # it to the submitter
                if not self._evict_for_lane(lane):
                    self.logger.debug("full mempool rejected lane-%d tx", lane)
                    if self.metrics is not None:
                        self.metrics.mempool_failed_txs.add(1)
                    self.cache.remove(tx)
                    res.code = CODE_MEMPOOL_FULL
                    res.log = f"mempool is full: {self.size()} >= {self._max_size}"
                    return
            memtx = MempoolTx(height=self._height, gas_wanted=res.gas_wanted, tx=tx,
                              priority=priority, lane=lane)
            self._add_tx(memtx)
            if self.metrics is not None:
                self.metrics.mempool_tx_size_bytes.observe(len(tx))
            self.logger.debug("added good tx size=%d", self.size())
            self._notify_txs_available()
        else:
            self.logger.debug("rejected bad tx code=%d log=%s", res.code, res.log)
            if self.metrics is not None:
                self.metrics.mempool_failed_txs.add(1)
            self.cache.remove(tx)

    def _res_cb_recheck(self, req: abci.RequestCheckTx, res: abci.ResponseCheckTx) -> None:
        if self.metrics is not None:
            self.metrics.mempool_recheck_times.add(1)
        self._recheck_pending -= 1
        cursor = self._recheck_cursor
        el: Optional[CElement] = None
        if cursor is not None and not cursor.removed and cursor.value.tx == req.tx:
            el = cursor
        else:
            # desync: the cursor's tx was removed mid-recheck (committed
            # while responses were in flight). Resynchronize on the live
            # element for THIS response via the hash index; a response for
            # a tx no longer in the pool is dropped.
            el = self._tx_map.get(tmhash(req.tx))
            if el is not None and el.removed:
                el = None
            if el is not None:
                self.logger.warning("recheck transaction mismatch; cursor resynchronized")
            else:
                self.logger.debug("recheck response for tx no longer in pool; dropped")
        if el is not None:
            if res.code != abci.CODE_TYPE_OK:
                # committed state invalidated this tx
                self._remove_el(el, from_cache=True)
            # removed elements keep their next pointer, so this advances
            # correctly even when the walk crossed removed territory
            self._recheck_cursor = el.next()
        if self._recheck_pending <= 0:
            self._end_recheck()

    def _end_recheck(self) -> None:
        self._recheck_cursor = None
        self._recheck_end = None
        self._rechecking = False

    # Reap ------------------------------------------------------------------
    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        """Collect txs for a proposal under byte/gas budgets (mempool.go:471).

        Lanes serve high to low, FIFO within a lane; single-lane configs
        degrade to pure insertion order (the reference behavior)."""
        with self._mtx:
            total_bytes = 0
            total_gas = 0
            out: List[bytes] = []
            for lane in reversed(self._lanes):
                for el in lane:
                    memtx = el.value
                    sz = len(memtx.tx) + 8  # frame overhead allowance
                    if max_bytes > -1 and total_bytes + sz > max_bytes:
                        return out
                    if max_gas > -1 and total_gas + memtx.gas_wanted > max_gas:
                        return out
                    total_bytes += sz
                    total_gas += memtx.gas_wanted
                    out.append(memtx.tx)
            return out

    def reap_max_txs(self, n: int) -> List[bytes]:
        with self._mtx:
            out: List[bytes] = []
            for lane in reversed(self._lanes):
                for el in lane:
                    if len(out) >= n >= 0:
                        return out
                    out.append(el.value.tx)
            return out

    # Update (after commit; the mempool locked by the executor) -------------
    def update(self, height: int, txs, pre_check=None, post_check=None) -> None:
        """Remove committed txs, recheck the rest (mempool.go:531); then
        raise a failure the wait timer's thread kept."""
        self._height = height
        if self._rechecking:
            # the previous round never finished (async app conn): its
            # in-flight responses describe pre-commit state, so mark them
            # stale rather than letting them race the new round's cursor
            self._stale_recheck += self._recheck_pending
            self._recheck_pending = 0
            self._end_recheck()
        self._notified_txs_available = False
        if self._txs_available is not None:
            self._txs_available.clear()
        for tx in txs:
            tx = bytes(tx)
            self.cache.push(tx)  # committed: keep in cache so re-adds fail
            el = self._tx_map.get(tmhash(tx))
            if el is not None:
                self._remove_el(el, from_cache=False)
        self._update_lane_metrics()
        if self._recheck_enabled and self.size() > 0:
            self._recheck_txs()
        else:
            self._notify_txs_available()
        self._raise_deferred_error()

    def _recheck_txs(self) -> None:
        with trace.span("mempool.recheck", n=self.size()):
            self._recheck_cursor = self._txs.front()
            self._recheck_end = self._txs.back()
            self._recheck_pending = self.size()
            self._rechecking = True
            batch = self._recheck_batch or self.size()
            # snapshot first: with a local app conn, responses arrive inline
            # and mutate the list while we would still be walking it
            survivors = [memtx.tx for memtx in self._txs]
            hook = self.batch_check_hook
            for lo in range(0, len(survivors), batch):
                window = survivors[lo: lo + batch]
                t_pack = time.perf_counter()
                verdicts = None
                if self._hook_verdicts:
                    # verdict-bearing recheck: the survivors passed
                    # admission, so the hook answers from its tx-hash
                    # verdict cache and the app re-runs its state checks
                    try:
                        verdicts = self._window_verdicts(hook, window, " on recheck")
                    except Exception:
                        self._abort_recheck(survivors[lo:])
                        raise
                self._recheck_window(window, verdicts, t_pack)
        self._notify_txs_available()

    def _recheck_window(self, batch_txs: List[bytes], verdicts, t_pack: float) -> None:
        hook = self.batch_check_hook
        if not self._hook_verdicts:
            for tx in batch_txs:
                self._proxy.check_tx_async(tx)
            if hook is not None:
                hook(batch_txs)
        else:
            # sends stay in walk order so the recheck cursor's FIFO
            # contract holds
            for i, tx in enumerate(batch_txs):
                self._send_checktx(tx, None if verdicts is None else verdicts[i])
        pack_s = time.perf_counter() - t_pack
        t0 = time.perf_counter()
        self._proxy.flush_async()
        run_s = time.perf_counter() - t0
        if self._recheck_batch > 0:
            get_profiler().record("mempool.recheck_batch", bucket=(len(batch_txs),),
                                  lanes_present=len(batch_txs), pack_seconds=pack_s,
                                  run_seconds=run_s)
        if self.metrics is not None:
            self.metrics.mempool_checktx_batch_size.observe(len(batch_txs))

    def _abort_recheck(self, unsent: List[bytes]) -> None:
        """A recheck window failed on the card: its txs and the later
        windows' were sent to no app, so they leave the pool and the cache
        (they were not revalidated against the committed state) and the
        round stops waiting for them."""
        with self._mtx:
            for tx in unsent:
                el = self._tx_map.get(tmhash(tx))
                if el is not None:
                    self._remove_el(el, from_cache=True)
            self._recheck_pending -= len(unsent)
            if self._recheck_pending <= 0:
                self._end_recheck()
            self._update_lane_metrics()

