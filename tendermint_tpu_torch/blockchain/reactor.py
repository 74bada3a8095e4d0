"""BlockchainReactor: fast sync with batched multi-height commit
verification (ref blockchain/reactor.go:216-327), the port's copy of the
reference package's ``blockchain/reactor.py``.

The reference's pool routine peeks two blocks and verifies one commit per
iteration (reactor.go:289-306). Here the pool yields a whole run of
consecutive blocks and all their commits are verified in one planned
dispatch (``verify_block_window``): every (height, validator) signature of
the window goes through ``parallel/planner.verify_window``'s verifier
route, ``crypto/batch.verify_generic`` and the verifier given, else the
installed one (on the card the configuration root's
``GuardedBatchVerifier``: K1 + K2 once for the window's ed25519 lanes, K3
for secp256k1 lanes). Verified blocks are saved and applied with
``trusted_last_commit=True``; meanwhile the next window verifies on a
daemon worker thread (the speculative window).

Where the port differs: on the card (``breaker.on_card`` of the verifier a
window or ``apply_block`` uses: the reactor's, else the installed one) a
``DeviceDispatchError`` or ``DeviceAuditMismatch`` halts fast sync. Out of
the synchronous window, a harvested or a discarded speculative slot, or the
first synced block's LastCommit check, it is recorded as
``device_fault``; the pool stops; no peer is stopped, no request is redone
and the node does not switch to consensus; the store and the state stay at
the last height that applied (on the card the LastCommit that predates the
windows is checked before its block is saved). The reference instead
punishes the supplying peer for a block that does not apply and retries
any other window error every 10 ms, which on the card would blame an honest
peer for a device fault, or hide one behind a log line. Off the card the
reference's behaviour stays.

A mesh (the multi-GPU lane split) is ROADMAP queue 1 item 4b (iii):
``mesh=`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import CancelledError, Future
from typing import List, Optional, Tuple

from tendermint_tpu_torch.blockchain.messages import (
    BlockRequestMessage,
    BlockResponseMessage,
    NoBlockResponseMessage,
    StatusRequestMessage,
    StatusResponseMessage,
    encode_msg,
    unmarshal_msg,
)
from tendermint_tpu_torch.blockchain.pool import BlockPool
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state.execution import _verifier_on_card
from tendermint_tpu_torch.types.core import BlockID
from tendermint_tpu_torch.types.validator_set import CommitError

BLOCKCHAIN_CHANNEL = 0x40
MAX_MSG_SIZE = 104857600  # 100 MB protocol block ceiling (types/params.go:11)

TRY_SYNC_INTERVAL = 0.01  # reference trySyncTicker 10ms
STATUS_UPDATE_INTERVAL = 2.0  # reference 10s; shrunk for test nets
SWITCH_TO_CONSENSUS_INTERVAL = 0.5  # reference 1s
# Heights verified per dispatch: the largest window that fits, so that one
# launch and one synchronisation amortize over window x valset signatures;
# auto_verify_window shrinks it for large sets (the reference's choice,
# blockchain/reactor.py:46-54).
VERIFY_WINDOW = 512
MAX_WINDOW_SIGS = 512 * 1024  # |window| x |valset| ceiling per dispatch

_MESH = "a mesh (the multi-GPU lane split) is ported by ROADMAP queue 1 item 4b (iii)"


def auto_verify_window(n_validators: int, window: int = VERIFY_WINDOW) -> int:
    """Window size bounded so window x valset <= MAX_WINDOW_SIGS (a 10k-val
    set still gets 52-height batches; a 64-val set the full default)."""
    if n_validators <= 0:
        return window
    return max(1, min(window, MAX_WINDOW_SIGS // max(1, n_validators)))


class WindowVerifyError(Exception):
    def __init__(self, bad_index: int, reason: str):
        super().__init__(f"block window invalid at offset {bad_index}: {reason}")
        self.bad_index = bad_index


class FatalSyncError(Exception):
    """A block with a valid +2/3 commit failed state validation or
    application. Retrying can never succeed (the same window would
    re-verify and re-fail forever); the reference panics here
    (blockchain/reactor.go:327 via ApplyBlock); fast sync halts."""


def verify_block_window(
    state,
    blocks: List,
    verifier=None,
    parts_out: Optional[List] = None,
    mesh=None,
) -> Tuple[int, Optional[WindowVerifyError]]:
    """Verify the commits of blocks[0..n-2]: block i's commit is
    blocks[i + 1].last_commit, signed by the set whose hash block i carries
    (reactor.go:306's VerifyCommit, across the whole window at once).

    The per-precommit rules and the power collection are
    ``ValidatorSet.collect_commit_sigs``'s; packing, the verify dispatch and
    the +2/3 tallies are ``parallel/planner.verify_window``'s verifier route
    (``verify_generic`` and ``verifier``, else the installed one).

    Returns (n_verified, err): the first n_verified blocks' commits are
    verified; err is set if block n_verified is invalid (a block of a later
    set just ends the window). ``parts_out`` receives each verified block's
    PartSet so that the apply loop does not rebuild it.
    """
    if mesh is not None:
        raise NotImplementedError(_MESH)
    valset = state.validators
    chain_id = state.chain_id
    n = len(blocks) - 1
    if n <= 0:
        return 0, None

    # 1. host prechecks, and the end of the window at the first set change
    usable = 0
    structural: Optional[WindowVerifyError] = None
    votes_rows: List[list] = []
    power_rows: List[list] = []
    local_parts: List = []
    for i in range(n):
        block, next_block = blocks[i], blocks[i + 1]
        if block.header.validators_hash != valset.hash():
            if i == 0:
                # offset 0 is always our current set: a mismatch there is a
                # bad block, not a later set
                structural = WindowVerifyError(0, "wrong validators_hash")
            break
        commit = next_block.last_commit
        parts = block.make_part_set()
        block_id = BlockID(hash=block.hash(), parts_header=parts.header())
        try:
            pubkeys, msgs, sigs, powers = valset.collect_commit_sigs(
                chain_id, block_id, block.height, commit
            )
        except CommitError as e:
            structural = WindowVerifyError(i, str(e))
            break
        vrow, prow = planner.rows_from_commit(
            commit.precommits, pubkeys, msgs, sigs, powers
        )
        votes_rows.append(vrow)
        power_rows.append(prow)
        local_parts.append(parts)
        usable += 1

    if usable == 0:
        return 0, structural

    # 2. one planned dispatch for the whole window
    total = valset.total_voting_power()
    with get_profiler().window(blocks[0].height, heights=usable):
        verdict = planner.verify_window(
            votes_rows, power_rows, [total] * usable, verifier=verifier, use_device=False,
        )

    # 3. the per-height verdict; stop at the first invalid commit
    for i in range(usable):
        # any invalid signature fails the whole commit (verify_commit parity)
        if not bool(verdict.sigs_ok[i]):
            if parts_out is not None:
                parts_out.extend(local_parts[:i])
            return i, WindowVerifyError(i, "invalid signature in commit")
        if not bool(verdict.committed[i]):
            if parts_out is not None:
                parts_out.extend(local_parts[:i])
            return i, WindowVerifyError(i, "insufficient voting power")
    if parts_out is not None:
        parts_out.extend(local_parts[:usable])
    return usable, structural


class BlockchainReactor(Reactor):
    def __init__(
        self,
        state,  # sm.State: the sync starting point
        block_exec,  # BlockExecutor
        block_store,
        fast_sync: bool = True,
        consensus_reactor=None,  # .switch_to_consensus(state, n) when caught up
        verifier=None,  # BatchVerifier for the windows; None: the installed one
        verify_window: Optional[int] = None,  # None: auto by the set's size
        mesh=None,
        metrics=None,  # .fast_syncing gauge and .reset_block_timer()
    ):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        super().__init__(name="BlockchainReactor")
        self.metrics = metrics
        self.initial_state = state
        self.state = state.copy()
        self.block_exec = block_exec
        self.store = block_store
        self.fast_sync = fast_sync
        self.consensus_reactor = consensus_reactor
        self.verifier = verifier
        # a given window is fixed; None sizes each dispatch by the set being
        # verified (it can change during sync)
        self._fixed_window = verify_window
        self.pool = BlockPool(
            start_height=self.store.height() + 1,
            request_cb=self._send_block_request,
            error_cb=self._stop_peer_by_id,
        )
        self.blocks_synced = 0
        self._trusted_commit_heights: set = set()
        self._switched = threading.Event()
        # the device fault that halted fast sync (on the card only)
        self.device_fault: Optional[BaseException] = None
        # pipelined speculative verify: while the apply loop walks window N,
        # windows N+1..N+k verify on daemon worker threads (k =
        # planner.pipeline_depth() - 1; the default depth 2 keeps one window
        # in flight). Each slot: (first_height, valset hash the speculation
        # assumed, future, parts, blocks); slots chain consecutively, so a
        # harvest mismatch at the head voids every slot behind it.
        self._spec: list = []

    # -- Reactor interface --------------------------------------------------------
    def get_channels(self):
        return [
            ChannelDescriptor(
                id=BLOCKCHAIN_CHANNEL, priority=10, send_queue_capacity=1000,
                recv_message_capacity=MAX_MSG_SIZE,
            )
        ]

    def on_start(self) -> None:
        if self.fast_sync:
            if self.metrics is not None:
                self.metrics.fast_syncing.set(1)
            self.pool.start()
            threading.Thread(
                target=self._pool_routine, name="bc-pool", daemon=True
            ).start()

    def on_stop(self) -> None:
        if self.pool.is_running:
            try:
                self.pool.stop()
            except Exception:
                pass
        specs, self._spec = self._spec, []  # snapshot: the pool routine races
        for spec in specs:
            spec[2].cancel()  # work not yet started never runs

    def start_from_statesync(self, state) -> None:
        """Hand-off from a snapshot restore: adopt the restored state and
        fast-sync from the store's height (the reactor was built with
        fast_sync=False, so its pool never started from height 1). The pool
        is rebuilt because its start height was fixed at construction."""
        self.initial_state = state
        self.state = state.copy()
        self.fast_sync = True
        self._switched.clear()
        self.pool = BlockPool(
            start_height=self.store.height() + 1,
            request_cb=self._send_block_request,
            error_cb=self._stop_peer_by_id,
        )
        if self.metrics is not None:
            self.metrics.fast_syncing.set(1)
        self.pool.start()
        threading.Thread(
            target=self._pool_routine, name="bc-pool", daemon=True
        ).start()
        # peers that connected during the restore never exchanged status on
        # this channel's sync path: ask for heights now
        if self.switch is not None:
            self.switch.broadcast(
                BLOCKCHAIN_CHANNEL,
                encode_msg(StatusRequestMessage(self.store.height())),
            )

    def add_peer(self, peer) -> None:
        peer.try_send(
            BLOCKCHAIN_CHANNEL, encode_msg(StatusResponseMessage(self.store.height()))
        )

    def remove_peer(self, peer, reason) -> None:
        self.pool.remove_peer(peer.id)

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        msg = unmarshal_msg(msg_bytes)
        if isinstance(msg, BlockRequestMessage):
            block = self.store.load_block(msg.height)
            if block is not None:
                peer.try_send(BLOCKCHAIN_CHANNEL, encode_msg(BlockResponseMessage(block)))
            else:
                peer.try_send(
                    BLOCKCHAIN_CHANNEL, encode_msg(NoBlockResponseMessage(msg.height))
                )
        elif isinstance(msg, BlockResponseMessage):
            self.pool.add_block(peer.id, msg.block)
        elif isinstance(msg, NoBlockResponseMessage):
            self.pool.no_block(peer.id, msg.height)
        elif isinstance(msg, StatusRequestMessage):
            peer.try_send(
                BLOCKCHAIN_CHANNEL, encode_msg(StatusResponseMessage(self.store.height()))
            )
        elif isinstance(msg, StatusResponseMessage):
            self.pool.set_peer_height(peer.id, msg.height)
        else:
            self.logger.error("unknown blockchain msg %r", type(msg))

    # -- pool callbacks --------------------------------------------------------------
    def _send_block_request(self, height: int, peer_id: str) -> None:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is None:
            self.pool.remove_peer(peer_id)
            return
        peer.try_send(BLOCKCHAIN_CHANNEL, encode_msg(BlockRequestMessage(height)))

    def _stop_peer_by_id(self, peer_id: str, reason: str) -> None:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is not None:
            self.switch.stop_peer_for_error(peer, reason)
        else:
            self.pool.remove_peer(peer_id)

    # -- the device-fault contract -----------------------------------------------------
    def _card_fault(self, exc: BaseException, verifier) -> bool:
        """True, with the fault recorded, when ``exc`` is a guarded
        dispatch's failure and ``verifier`` (else the installed one) is on
        the card."""
        if isinstance(exc, _brk.DeviceDispatchError) and _verifier_on_card(verifier):
            if self.device_fault is None:
                self.device_fault = exc
            return True
        return False

    def _exec_on_card(self) -> bool:
        return _verifier_on_card(getattr(self.block_exec, "verifier", None))

    def _halt_on_device_fault(self) -> None:
        self.logger.error(
            "fast sync halted at height %d: device fault on the card (%s); no peer "
            "blamed", self.store.height(), self.device_fault,
        )
        try:
            self.pool.stop()
        except Exception:
            pass
        specs, self._spec = self._spec, []
        for spec in specs:
            spec[2].cancel()

    # -- the sync loop ---------------------------------------------------------------
    def _pool_routine(self) -> None:
        """reactor.go:216 poolRoutine, with windowed verify -> apply."""
        last_status = 0.0
        last_switch_check = 0.0
        while not self._quit.is_set():
            now = time.monotonic()
            if now - last_status > STATUS_UPDATE_INTERVAL:
                last_status = now
                if self.switch is not None:
                    self.switch.broadcast(
                        BLOCKCHAIN_CHANNEL,
                        encode_msg(StatusRequestMessage(self.store.height())),
                    )
            if now - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL:
                last_switch_check = now
                if self.pool.is_caught_up() and self.pool.num_peers() > 0:
                    self._switch_to_consensus()
                    return
            try:
                self._try_sync_window()
            except FatalSyncError:
                self.logger.error(
                    "FATAL: fast sync halted: a verified block failed to "
                    "apply; manual intervention required (the reference panics "
                    "here)", exc_info=True,
                )
                try:
                    self.pool.stop()
                except Exception:
                    pass
                return
            except Exception:
                if self.device_fault is not None:
                    self._halt_on_device_fault()
                    return
                self.logger.exception("fast sync window failed")
            self._quit.wait(TRY_SYNC_INTERVAL)

    @property
    def verify_window(self) -> int:
        if self._fixed_window is not None:
            return self._fixed_window
        return auto_verify_window(self.state.validators.size)

    # -- speculative (double-buffered) verify --------------------------------------
    def _discard_speculation(self, slots) -> None:
        """Cancel or drain invalidated slots. A running verify must drain:
        racing it against a fresh synchronous verify would dispatch its
        window twice. A device fault on the card out of a drained slot is
        raised once every slot has drained."""
        fault = None
        for _, _, fut, _, _ in slots:
            get_verify_metrics().speculative.add(1.0, ("miss",))
            if not fut.cancel():
                try:
                    fut.result()
                except BaseException as e:
                    if fault is None and self._card_fault(e, self.verifier):
                        fault = e
        if fault is not None:
            raise fault

    def _take_speculative(self) -> Optional[tuple]:
        """Harvest the in-flight verification of window N+1 if it still
        applies: the same start height, and the set the speculation assumed
        survived window N's apply (a set change voids it, and any 'wrong
        validators_hash' verdict it gave, which must never punish a peer).
        A head mismatch voids every chained slot behind it."""
        if not self._spec:
            return None
        head = self._spec.pop(0)
        first_h, vhash, fut, parts_list, blocks = head
        if first_h != self.pool.height or self.state.validators.hash() != vhash:
            rest, self._spec = self._spec, []
            self._discard_speculation([head] + rest)
            return None
        try:
            n_ok, err = fut.result()
        except CancelledError:
            # on_stop cancelled the slot from another thread mid-harvest
            get_verify_metrics().speculative.add(1.0, ("miss",))
            return None
        get_verify_metrics().speculative.add(1.0, ("hit",))
        return blocks, parts_list, n_ok, err

    def _start_speculative(self, offset: int) -> None:
        """Top the speculation chain up to its depth while window N applies.
        Chained slots start where the previous slot's window ends; a partial
        apply shows up as a head mismatch at harvest and voids the chain."""
        depth = max(1, planner.pipeline_depth() - 1)
        while len(self._spec) < depth:
            if self._spec:
                last_first, _, _, _, last_blocks = self._spec[-1]
                offset = (last_first - self.pool.height) + len(last_blocks) - 1
            nxt = self.pool.peek_window(
                self.verify_window + 1, start_offset=offset)
            if len(nxt) < 2:
                return
            st = self.state  # apply never mutates this snapshot
            parts_list: list = []
            fut: Future = Future()

            def _run(nxt=nxt, st=st, parts_list=parts_list, fut=fut):
                # honor a cancel that lands before the thread runs; once
                # running, fut.cancel() is False and harvest or discard
                # drain instead of racing a second dispatch
                if not fut.set_running_or_notify_cancel():
                    return
                try:
                    with trace.span(
                        "fastsync.window", h0=nxt[0].height, n=len(nxt) - 1,
                        mode="speculative",
                    ):
                        fut.set_result(
                            verify_block_window(st, nxt, self.verifier, parts_list)
                        )
                except BaseException as e:
                    fut.set_exception(e)

            threading.Thread(target=_run, name="bc-verify", daemon=True).start()
            self._spec.append(
                (nxt[0].height, st.validators.hash(), fut, parts_list, nxt))

    def _try_sync_window(self) -> None:
        try:
            spec = self._take_speculative()
            if spec is not None:
                blocks, parts_list, n_ok, err = spec
            else:
                blocks = self.pool.peek_window(self.verify_window + 1)
                if len(blocks) < 2:
                    return
                parts_list = []
                with trace.span(
                    "fastsync.window", h0=blocks[0].height, n=len(blocks) - 1,
                    mode="sync",
                ):
                    n_ok, err = verify_block_window(
                        self.state, blocks, verifier=self.verifier, parts_out=parts_list,
                    )
        except _brk.DeviceDispatchError as e:
            self._card_fault(e, self.verifier)
            raise
        try:
            get_verify_metrics().window_heights.observe(float(n_ok))
        except Exception:
            pass
        for i in range(n_ok):
            self._trusted_commit_heights.add(blocks[i].height)
        if err is not None:
            bad = blocks[err.bad_index]
            self.logger.error("invalid block %d in sync: %s", bad.height, err)
            # punish whoever supplied the bad block and its commit
            for h in (bad.height, bad.height + 1):
                peer_id = self.pool.redo_request(h)
                if peer_id:
                    self._stop_peer_by_id(peer_id, f"sent bad block {h}")
        elif n_ok > 0:
            # verify window N+1 on the worker while the loop below applies
            # window N (its device wait releases the interpreter lock)
            self._start_speculative(offset=n_ok)
        if n_ok == 0:
            return
        with trace.span("fastsync.apply", h0=blocks[0].height, n=n_ok):
            self._apply_verified(blocks, parts_list, n_ok)

    def _unappliable(self, block, e: BaseException) -> FatalSyncError:
        """The commit was valid but the block does not apply: punish its
        supplier for the record; the caller halts (retrying loops forever)."""
        peer_id = self.pool.redo_request(block.height)
        if peer_id:
            self._stop_peer_by_id(peer_id, f"sent unappliable block {block.height}")
        return FatalSyncError(f"verified block {block.height} failed to apply: {e}")

    def _apply_verified(self, blocks, parts_list, n_ok: int) -> None:
        for i in range(n_ok):
            block = blocks[i]
            parts = parts_list[i]
            block_id = BlockID(hash=block.hash(), parts_header=parts.header())
            # the first synced block's own LastCommit predates the windows:
            # apply_block verifies it in full
            trusted = block.height - 1 in self._trusted_commit_heights
            if not trusted and self._exec_on_card():
                # on the card, before the block is saved, so that a device
                # fault leaves the store at the state's height
                try:
                    self.block_exec.validate_block(self.state, block)
                except Exception as e:
                    if self._card_fault(e, getattr(self.block_exec, "verifier", None)):
                        raise
                    raise self._unappliable(block, e) from e
                trusted = True
            self.store.save_block(block, parts, blocks[i + 1].last_commit)
            try:
                self.state = self.block_exec.apply_block(
                    self.state, block_id, block, trusted_last_commit=trusted,
                )
            except Exception as e:
                if self._card_fault(e, getattr(self.block_exec, "verifier", None)):
                    raise
                raise self._unappliable(block, e) from e
            self.pool.pop_first()
            self.blocks_synced += 1
            self._trusted_commit_heights.discard(block.height - 2)
            if self.blocks_synced % 100 == 0:
                self.logger.info(
                    "fast sync at height %d (%d peers)",
                    self.pool.height, self.pool.num_peers(),
                )

    def _switch_to_consensus(self) -> None:
        if self._switched.is_set():
            return
        self._switched.set()
        self.logger.info(
            "caught up (height %d, synced %d): switching to consensus",
            self.store.height(), self.blocks_synced,
        )
        self.fast_sync = False
        if self.metrics is not None:
            self.metrics.fast_syncing.set(0)
            # the block timer predates the fast-synced blocks: without a
            # reset the first consensus block records the whole sync
            self.metrics.reset_block_timer()
        if self.pool.is_running:
            try:
                self.pool.stop()
            except Exception:
                pass
        specs, self._spec = self._spec, []
        for spec in specs:
            if not spec[2].cancel():
                # drain, bounded: the device should be idle before consensus
                # starts its own verifies, but a wedged dispatch must not
                # hold the switch hostage (the daemon worker dies with the
                # process)
                try:
                    spec[2].result(timeout=30.0)
                except BaseException as e:
                    if self._card_fault(e, self.verifier):
                        self._halt_on_device_fault()
                        return
                    self.logger.warning(
                        "speculative verify did not drain before consensus "
                        "switchover (wedged device dispatch?)"
                    )
        if self.consensus_reactor is not None:
            self.consensus_reactor.switch_to_consensus(
                self.state.copy(), self.blocks_synced
            )
