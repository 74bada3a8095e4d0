"""StateSyncer: the restore state machine, the port's copy of the reference
package's ``statesync/syncer.py``.

  discover -> pick a snapshot -> light-client trust (``lite/verifier``
  against the configured trust root) -> the ABCI offer/apply chunk
  handshake -> the app-hash check against the light-client-verified
  header -> the backfill of the trailing commit window (planner
  sub-windows through ``WindowPipeline``) -> persist blocks, validators and
  state -> hand the reconstructed ``State`` to fast sync.

The trailing window exists because a restored node must still serve a
LastCommit to consensus (``reconstruct_last_commit``) and recent blocks to
peers; its ragged (height, valset) rows are the fast-sync window's shape,
so the backfill shares the planner.

The device work: every trust hop goes through ``DynamicVerifier`` with
the syncer's ``batch_verifier`` (None: the installed one, on the card the
configuration root's ``GuardedBatchVerifier``: K1 + K2 once a hop), and
the backfill through ``planner.WindowPipeline(use_device=True,
depth=pipeline_depth())``, whose windows go to the guarded device executor
(K1 + K2 + the K7 tally, one dispatch per 32-height sub-window).

Where the port differs: on the card (``breaker.on_card`` of the verifier
or executor in use: the syncer's verifier, else the installed one, for
the trust hops; the installed executor for the backfill) a
``DeviceDispatchError`` or ``DeviceAuditMismatch`` out of a trust hop or
the backfill halts the restore. It is recorded as ``device_fault`` and
raised past the snapshot loop, so the snapshot is not rejected, no peer is
banned and nothing is persisted; the reactor does not hand off. The app
has taken the chunks by then and stays restored, as the reference leaves
it after any late failure. Off the card the reference's behaviour stays.
With ``mesh=`` (a ``parallel.mesh.DeviceMesh``) the backfill's
``WindowPipeline`` splits each sub-window's lanes over the mesh's devices,
as the reference passes its mesh to its pipeline.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.blockchain.store import BlockMeta
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.metrics import get_statesync_metrics
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.lite.provider import DBProvider, Provider, ProviderError
from tendermint_tpu_torch.lite.types import FullCommit, LiteError
from tendermint_tpu_torch.lite.verifier import DynamicVerifier
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.execution import _verifier_on_card
from tendermint_tpu_torch.state.state_types import State
from tendermint_tpu_torch.statesync import chunker
from tendermint_tpu_torch.types.validator_set import CommitError

class StateSyncError(Exception):
    """The restore cannot proceed (bad trust root, app abort, no peers...)."""


class _SnapshotRejected(Exception):
    """This snapshot is unusable; try the next offer (not fatal)."""


class _ReactorProvider(Provider):
    """A lite ``Provider`` sourcing FullCommits from state-sync peers (the
    reactor's light-block request/response)."""

    def __init__(self, reactor, timeout: float):
        self._reactor = reactor
        self._timeout = timeout

    def latest_full_commit(self, chain_id: str, min_height: int,
                           max_height: int) -> FullCommit:
        return self.full_commit_at(chain_id, max_height)

    def full_commit_at(self, chain_id: str, height: int) -> FullCommit:
        for peer_id in sorted(self._reactor.peer_ids()):
            fc = self._reactor.fetch_light_block(peer_id, height, self._timeout)
            if fc is None:
                continue
            if fc.signed_header.header.chain_id != chain_id:
                self._reactor.ban_peer(peer_id, "light block for wrong chain")
                continue
            if fc.height != height:
                self._reactor.ban_peer(peer_id, "light block height mismatch")
                continue
            return fc
        raise ProviderError(f"no peer served light block {height}")


class StateSyncer:
    # heights per planner sub-window: small enough that the pipeline's
    # worker packs N+1 while N's dispatch is in flight, large enough to fill
    # lane buckets across ragged sets
    BACKFILL_SUBWINDOW = 32

    def __init__(
        self,
        config,  # config/statesync.StateSyncConfig
        chain_id: str,
        genesis,  # GenesisDoc: consensus params and version for the state
        app_query,  # proxy AppConnQuery: the ABCI snapshot handshake
        state_db,
        block_store,
        batch_verifier=None,  # the trust hops' verifier; None: the installed one
        mesh=None,  # DeviceMesh for the backfill's device route
        metrics=None,
        logger: Optional[logging.Logger] = None,
    ):
        self.config = config
        self.chain_id = chain_id
        self.genesis = genesis
        self.app_query = app_query
        self.state_db = state_db
        self.block_store = block_store
        self.batch_verifier = batch_verifier
        self.mesh = mesh
        self.metrics = metrics or get_statesync_metrics()
        self.logger = logger or logging.getLogger("statesync")
        # the device fault that halted the restore (on the card only)
        self.device_fault: Optional[BaseException] = None
        self._progress: Dict[str, object] = {
            "snapshot_height": 0,
            "chunks_total": 0,
            "chunks_applied": 0,
            "backfill_heights": 0,
        }

    def progress(self) -> dict:
        return dict(self._progress)

    # -- the state machine ----------------------------------------------------------
    def run(self, reactor) -> Optional[State]:
        """The reconstructed State, or None if the reactor stopped before a
        snapshot could be restored. Raises StateSyncError on unrecoverable
        failures (bad trust root, app ABORT...) and, on the card, the
        device fault that halted the restore."""
        rejected: Set[Tuple[int, int, bytes]] = set()
        while True:
            picked = self._discover(reactor, rejected)
            if picked is None:
                return None  # the reactor is stopping
            snapshot, offer_peers = picked
            try:
                return self._restore_one(reactor, snapshot, offer_peers)
            except _SnapshotRejected as e:
                self.logger.info("snapshot at height %d rejected: %s", snapshot.height, e)
                rejected.add((snapshot.height, snapshot.format, snapshot.hash))
                reactor.discard_offer(snapshot)

    def _halt_on_card(self, exc: BaseException, on_card: bool) -> None:
        """Record ``exc`` as the device fault when it is a guarded dispatch's
        failure on the card; the caller re-raises it either way."""
        if isinstance(exc, _brk.DeviceDispatchError) and on_card and self.device_fault is None:
            self.device_fault = exc
            self.logger.error("state sync halted: device fault on the card (%s)", exc)

    # -- discovery --------------------------------------------------------------------
    def _discover(self, reactor, rejected) -> Optional[tuple]:
        while True:
            reactor.broadcast_snapshot_request()
            if not reactor.wait(self.config.discovery_time):
                return None
            for snapshot, peers in reactor.snapshot_offers():
                if (snapshot.height, snapshot.format, snapshot.hash) in rejected:
                    continue
                if snapshot.format not in chunker.SUPPORTED_FORMATS:
                    continue
                if snapshot.height <= 0 or snapshot.chunks <= 0:
                    continue
                self.logger.info("discovered snapshot height=%d chunks=%d (%d peers)",
                                 snapshot.height, snapshot.chunks, len(peers))
                return snapshot, peers

    # -- one restore attempt ------------------------------------------------------------
    def _restore_one(self, reactor, snapshot, offer_peers) -> Optional[State]:
        H = snapshot.height
        self._progress["snapshot_height"] = H
        self.metrics.snapshot_height.set(H)

        # the manifest before any network or device work: a lying offer
        # (hash != Merkle root of the advertised manifest) dies here
        try:
            chunk_hashes = chunker.chunk_hashes_from_metadata(snapshot)
        except ValueError as e:
            for pid in offer_peers:
                reactor.ban_peer(pid, f"bad snapshot manifest: {e}")
            raise _SnapshotRejected(f"bad manifest: {e}")

        # light-client trust: header(H+1) carries the app hash after block
        # H, which the restored app state must reproduce
        with trace.span("statesync.light_verify", height=H):
            fc_h, fc_h1 = self._establish_trust(reactor, H)
        trusted_app_hash = fc_h1.signed_header.header.app_hash

        res = self.app_query.offer_snapshot_sync(
            abci.RequestOfferSnapshot(snapshot=snapshot, app_hash=trusted_app_hash))
        if res.result == abci.OFFER_SNAPSHOT_ABORT:
            raise StateSyncError("app aborted snapshot restore")
        if res.result == abci.OFFER_SNAPSHOT_REJECT_SENDER:
            for pid in offer_peers:
                reactor.ban_peer(pid, "snapshot sender rejected by app")
            raise _SnapshotRejected("sender rejected by app")
        if res.result == abci.OFFER_SNAPSHOT_REJECT_FORMAT:
            # format negotiation: this (height, format, hash) goes on the
            # rejected set and discovery retries the next advertised format
            raise _SnapshotRejected(f"app rejected snapshot format {snapshot.format}")
        if res.result != abci.OFFER_SNAPSHOT_ACCEPT:
            raise _SnapshotRejected(f"app result {res.result}")

        with trace.span("statesync.chunks", height=H, n=snapshot.chunks):
            self._fetch_and_apply_chunks(reactor, snapshot, chunk_hashes)

        # the restored app must report exactly the trusted height and hash
        info = self.app_query.info_sync(abci.RequestInfo())
        if info.last_block_height != H:
            raise StateSyncError(f"restored app at height {info.last_block_height}, want {H}")
        if info.last_block_app_hash != trusted_app_hash:
            raise StateSyncError(
                "restored app hash does not match light-client-verified header: "
                f"{info.last_block_app_hash.hex()} != {trusted_app_hash.hex()}")
        self.logger.info("restored app state at height %d, app hash verified", H)

        # the trailing commit window: fetch, chain to the trusted header,
        # verify through the planner, persist
        with trace.span("statesync.backfill", height=H):
            fcs = self._fetch_backfill(reactor, fc_h)
            self._verify_backfill_window(fcs)
            self._persist_backfill(fcs)

        state = self._build_state(fc_h, fc_h1)
        self._persist_state(state, fcs)
        return state

    # -- light client ---------------------------------------------------------------------
    def _establish_trust(self, reactor, height: int):
        cfg = self.config
        if cfg.trust_height <= 0 or not cfg.trust_hash:
            raise StateSyncError("statesync requires a trust root (trust_height + trust_hash)")
        if cfg.trust_height > height:
            raise StateSyncError(f"trust height {cfg.trust_height} above snapshot {height}")
        source = _ReactorProvider(reactor, cfg.chunk_fetch_timeout)
        dv = DynamicVerifier(self.chain_id, DBProvider(self.state_db), source,
                             batch_verifier=self.batch_verifier)
        try:
            root = source.full_commit_at(self.chain_id, cfg.trust_height)
        except ProviderError as e:
            raise _SnapshotRejected(f"no peer served the trust root: {e}")
        got = root.signed_header.header.hash()
        if got != bytes.fromhex(cfg.trust_hash):
            # a social-consensus root mismatch is never a retry: the
            # operator configured a hash the network disagrees with
            raise StateSyncError(
                f"trust root mismatch at height {cfg.trust_height}: "
                f"header {got.hex()} != configured {cfg.trust_hash}")
        try:
            dv.init_from_full_commit(root)
            fc_h = source.full_commit_at(self.chain_id, height)
            dv.verify(fc_h.signed_header)
            fc_h1 = source.full_commit_at(self.chain_id, height + 1)
            dv.verify(fc_h1.signed_header)
        except (LiteError, ProviderError, CommitError) as e:
            raise _SnapshotRejected(f"light-client verification failed: {e}")
        except _brk.DeviceDispatchError as e:
            self._halt_on_card(e, _verifier_on_card(self.batch_verifier))
            raise
        return fc_h, fc_h1

    # -- chunks -----------------------------------------------------------------------------
    def _fetch_and_apply_chunks(self, reactor, snapshot, chunk_hashes) -> None:
        cfg = self.config
        H, fmt, total = snapshot.height, snapshot.format, snapshot.chunks
        self._progress["chunks_total"] = total
        self._progress["chunks_applied"] = 0
        self.metrics.chunks_expected.set(total)
        self.metrics.chunks_applied.set(0)
        pending = list(range(total))
        applied: Set[int] = set()
        rr = 0  # round-robin cursor over peers
        while pending:
            index = pending.pop(0)
            if index in applied:
                continue
            chunk = None
            for _ in range(max(1, cfg.chunk_retries)):
                peers = sorted(reactor.peer_ids())
                if not peers:
                    raise _SnapshotRejected("no peers left to fetch chunks")
                peer_id = peers[rr % len(peers)]
                rr += 1
                got = reactor.fetch_chunk(peer_id, H, fmt, index, cfg.chunk_fetch_timeout)
                if got is None:
                    continue
                if not chunker.verify_chunk(got, index, chunk_hashes):
                    # a hash mismatch: punish, then re-request from another peer
                    self.metrics.chunk_fetch.add(1.0, ("bad",))
                    reactor.ban_peer(peer_id, f"chunk {index} hash mismatch")
                    continue
                self.metrics.chunk_fetch.add(1.0, ("ok",))
                self.metrics.chunk_bytes.add(float(len(got)))
                chunk = got
                break
            if chunk is None:
                raise _SnapshotRejected(f"could not fetch chunk {index}")
            res = self.app_query.apply_snapshot_chunk_sync(
                abci.RequestApplySnapshotChunk(index=index, chunk=chunk))
            if res.result == abci.APPLY_CHUNK_ABORT:
                raise StateSyncError("app aborted during chunk apply")
            if res.result in (abci.APPLY_CHUNK_RETRY_SNAPSHOT, abci.APPLY_CHUNK_REJECT_SNAPSHOT):
                raise _SnapshotRejected(f"app chunk result {res.result}")
            if res.result == abci.APPLY_CHUNK_RETRY:
                pending.insert(0, index)
                continue
            if res.result != abci.APPLY_CHUNK_ACCEPT:
                raise _SnapshotRejected(f"app chunk result {res.result}")
            for i in res.refetch_chunks:
                applied.discard(i)
                if i not in pending:
                    pending.append(i)
            for pid in res.reject_senders:
                reactor.ban_peer(pid, "sender rejected by app")
            applied.add(index)
            self._progress["chunks_applied"] = len(applied)
            self.metrics.chunks_applied.set(len(applied))

    # -- backfill -----------------------------------------------------------------------------
    def _backfill_base(self, height: int) -> int:
        return max(1, height - max(1, self.config.backfill_blocks) + 1)

    def _fetch_backfill(self, reactor, fc_h: FullCommit) -> List[FullCommit]:
        """FullCommits for [base..H], hash-chained downward from the
        light-client-verified header at H: header(h).hash() must equal
        header(h+1).last_block_id.hash, so every fetched header inherits the
        trusted one's integrity before any signature work."""
        H = fc_h.height
        base = self._backfill_base(H)
        source = _ReactorProvider(reactor, self.config.chunk_fetch_timeout)
        fcs: List[FullCommit] = [fc_h]
        for h in range(H - 1, base - 1, -1):
            try:
                fc = source.full_commit_at(self.chain_id, h)
                fc.validate_full(self.chain_id)
            except (ProviderError, LiteError) as e:
                # trailing history is best-effort: an archive gap above the
                # snapshot peers' pruning horizon shrinks the window
                self.logger.info("backfill stops at %d: %s", h + 1, e)
                break
            if fc.signed_header.header.hash() != fcs[-1].signed_header.header.last_block_id.hash:
                raise _SnapshotRejected(f"backfill header {h} breaks the hash chain")
            fcs.append(fc)
        fcs.reverse()
        self._progress["backfill_heights"] = len(fcs)
        self.metrics.backfill_heights.observe(float(len(fcs)))
        return fcs

    def _backfill_specs(self, fcs: List[FullCommit]):
        """The planner specs of the window, one per BACKFILL_SUBWINDOW
        heights: each height's rows against its own set and total power."""
        for s in range(0, len(fcs), self.BACKFILL_SUBWINDOW):
            votes_rows, power_rows, totals = [], [], []
            for fc in fcs[s:s + self.BACKFILL_SUBWINDOW]:
                sh = fc.signed_header
                try:
                    pubkeys, msgs, sigs, powers = fc.validators.collect_commit_sigs(
                        self.chain_id, sh.commit.block_id, fc.height, sh.commit)
                except CommitError as e:
                    raise _SnapshotRejected(f"bad backfill commit at {fc.height}: {e}")
                vrow, prow = planner.rows_from_commit(
                    sh.commit.precommits, pubkeys, msgs, sigs, powers)
                votes_rows.append(vrow)
                power_rows.append(prow)
                totals.append(fc.validators.total_voting_power())
            yield votes_rows, power_rows, totals

    def _verify_backfill_window(self, fcs: List[FullCommit]) -> None:
        """The backfill's commits through the planner: ragged sets across
        the window lane-pack into bucketed tiles with each height tallied
        against its own total power, and ``WindowPipeline`` plans
        sub-window N+1 on its worker while N dispatches. The quorum rule is
        the planner's ``WindowVerdict``, shared with fast sync."""
        if not fcs:
            raise _SnapshotRejected("empty backfill window")
        pipe = planner.WindowPipeline(mesh=self.mesh, verifier=self.batch_verifier,
                                      use_device=True, depth=planner.pipeline_depth())
        off = 0
        try:
            # one profiler row for the whole backfill: the sub-window
            # dispatches fold into it
            with get_profiler().window(fcs[0].height, heights=len(fcs)):
                for verdict in pipe.run(self._backfill_specs(fcs)):
                    sub = fcs[off:off + len(verdict.committed)]
                    for i, fc in enumerate(sub):
                        if not bool(verdict.sigs_ok[i]):
                            raise _SnapshotRejected(
                                f"invalid signature in backfill commit at {fc.height}")
                        if not bool(verdict.committed[i]):
                            raise _SnapshotRejected(
                                f"insufficient voting power in backfill commit at {fc.height}")
                    off += len(sub)
        except _brk.DeviceDispatchError as e:
            self._halt_on_card(e, planner._dispatch_on_card(planner._installed_executor(),
                                                            self.mesh))
            raise

    def _persist_backfill(self, fcs: List[FullCommit]) -> None:
        metas = [BlockMeta(block_id=fc.signed_header.commit.block_id,
                           header=fc.signed_header.header) for fc in fcs]
        self.block_store.save_statesync_backfill(metas, [fc.signed_header.commit for fc in fcs])

    # -- the state ------------------------------------------------------------------------------
    def _build_state(self, fc_h: FullCommit, fc_h1: FullCommit) -> State:
        H = fc_h.height
        h_hdr = fc_h.signed_header.header
        h1_hdr = fc_h1.signed_header.header
        vals_changed = H + 2 if fc_h1.validators.hash() != fc_h1.next_validators.hash() else H + 1
        return State(
            chain_id=self.chain_id,
            version=h_hdr.version,
            last_block_height=H,
            last_block_total_tx=h_hdr.total_txs,
            last_block_id=fc_h.signed_header.commit.block_id,
            last_block_time_ns=h_hdr.time_ns,
            next_validators=fc_h1.next_validators.copy(),
            validators=fc_h1.validators.copy(),
            last_validators=fc_h.validators.copy(),
            last_height_validators_changed=vals_changed,
            consensus_params=self.genesis.consensus_params,
            last_height_consensus_params_changed=H + 1,
            last_results_hash=h1_hdr.last_results_hash,
            app_hash=h1_hdr.app_hash,
        )

    def _persist_state(self, state: State, fcs: List[FullCommit]) -> None:
        """``save_state`` alone writes only pointer records for heights the
        node never executed; a restored node needs full validator records at
        the window heights and H+1 (consensus reconstructs the LastCommit,
        ``NodeProvider`` serves peers, evidence checks historical sets)."""
        H = state.last_block_height
        for fc in fcs:
            sm_store.save_validators_info(self.state_db, fc.height, fc.height, fc.validators)
        sm_store.save_validators_info(self.state_db, H + 1, H + 1, state.validators)
        if state.last_height_validators_changed == H + 2:
            sm_store.save_validators_info(self.state_db, H + 2, H + 2, state.next_validators)
        sm_store.save_consensus_params_info(self.state_db, H + 1, H + 1, state.consensus_params)
        sm_store.save_state(self.state_db, state)
