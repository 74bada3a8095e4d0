#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device  the card's name and power limit (nvidia-smi) and torch's name;
  2. build   the four CUDA kernels and the multiply probe from the
             checkout's sources, in parallel, with each one's registers,
             spills and stack frame; then the probe's IMAD.WIDE and IMAD
             rates (products a clock an SM): the IMAD.WIDE rate prices
             K2's and K3's bounds;
  3. K1      the prologue kernel against its plain version on the card,
             2,048 seeded rows at each message length 0, 33, 104, 111, 112
             and 200, exact; h also against hashlib + bigint mod L; then
             200 seeded rows, a ragged last block, into outputs with
             sentinel tails that must stay unwritten;
  4. K2      the ed25519 ladder kernel against its plain version on the
             card, 256 rows (the 20-row Go-edge window and seeded
             signatures), exact; verdicts against the port's ``_verify_pure``;
             then 200 seeded rows, a ragged last block, into outputs with
             sentinel tails that must stay unwritten;
  5. main    a 10,000-validator ed25519 commit through
             ValidatorSet.verify_commit -> TorchBatchVerifier -> K1 -> K2:
             the commit passes, a flipped signature bit and an under-quorum
             commit are rejected, both kernels launched; wall and device
             times; each kernel against its plain version at the main
             path's shapes, with times and bounds, and K1's and K2's
             geometry, registers and shared memory;
  6. K3      the secp256k1 ladder kernel against its plain version on the
             card, 256 rows (the 23-row secp256k1 edge window, seeded
             signatures and rows that take the r + n branch), exact on the
             verdict and on X and Z; verdicts against the port's oracle
             ``crypto.secp256k1.verify``; then 200 seeded rows, a ragged
             last block, into outputs with sentinel tails that must stay
             unwritten;
  7. secp    a 10,000-validator secp256k1 commit through the same
             verify_commit -> TorchBatchVerifier.verify_secp256k1 -> K3: the
             commit passes, a flipped signature byte and an under-quorum
             commit are rejected, K3 launched; wall, host breakdown and
             device times; K3 against its plain version at those shapes,
             with its geometry, registers and shared memory;
  8. default the 10,000-validator ed25519 commit of phase 5 once more,
             through verify_commit with no verifier given: the default that
             the configuration root installs (node/verify_root.py, default
             [verify]: GuardedBatchVerifier(TorchBatchVerifier) with its
             5 % audit on the host oracle). K1 and K2 launched once, no
             device fallback; p50 wall over 3 calls beside the seconds of
             its device dispatch and of its audit;
  9. mixed   a 1,000-validator commit of mixed ed25519 and secp256k1 keys:
             it passes with K1, K2 and K3 each launched, and a flipped
             secp256k1 row and a flipped ed25519 row are each rejected;
             then once through the configuration root's guarded verifier
             (node/verify_root.py, default [verify]), K1, K2 and K3 each
             launched once and no device fallback;
  10. window a fast-sync window of 512 heights x 64 validators (32,768
             lanes in one dispatch) with planted faults, through
             parallel/planner.verify_window on both routes: the device
             executor (K1 -> K2 -> the int64 tally on the card) and the
             guarded verifier (verify_generic -> GuardedBatchVerifier ->
             K1 -> K2). Both give the same verdict grid, tallies,
             committed and sigs_ok, equal to what the construction implies
             and, on 256 sampled lanes, to the oracle; K1 and K2 launched
             once per message-length group per dispatch; no device
             fallback, the breaker closed, no audit mismatch. p50 walls
             over 3 calls with their breakdowns (plan, pack, dispatch,
             audit), K1 and K2 at the window's b against their plain
             versions, and the tally's device time beside its byte bound
             on a ``torch_ops`` JSON line of its own (the tally is torch
             int64 ops, not a kernel);
  11. backfill the window of phase 10 streamed as state sync's backfill
             streams it (statesync/syncer.py): 16 sub-windows of 32 heights
             through planner.WindowPipeline(use_device=True,
             depth=pipeline_depth()), the worker planning ahead while the
             guarded executor packs, uploads and dispatches. 16 verdicts
             whose concatenation equals phase 10's verdict; K1 and K2 once
             a sub-window and message-length group, the tally once a
             sub-window, and on the first sub-window's launch inputs exact
             against their plain versions; no device fallback, the breaker
             closed, no audit mismatch. p50 wall over 3 calls against the
             flat window's, beside the sums of its plan, pack, dispatch and
             audit spans (each including its waits for the interpreter
             lock);
  12. rpc    the RPC ?verify=1 burst (rpc/core/env.py): 64 threads each
             submit one row of the window (heights 0-63) to one
             planner.LaneFeed(profile_kind="rpc_lane_feed") on its defaults
             (2 ms window, 64 rows, the verifier route: the root's guarded
             verifier, K1 -> K2). Every row verdict equals phase 10's row;
             K1 and K2 once a feed dispatch, and on the first dispatch's
             launch inputs exact against their plain versions; no fallback,
             the breaker closed.
             p50 burst wall over 3 bursts with its audit span. Then 8
             concurrent verify_commit calls on 8 heights' commits through
             frontend.aggregator.BatchingVerifier(feed), each ending as a
             direct verify_commit on the same commit does;
  13. multisig BASELINE.json config 5: 1,000 validators, each a 3-of-5
             ed25519 threshold key (testutil/multisig.py, seed 7), through
             verify_generic with an explicit TorchBatchVerifier() and then
             the root's guarded verifier: all accept, 3,000 sub-signatures
             in one K1 and one K2 launch a call, exact against their plain
             versions on that launch's inputs; with one sub-signature
             flipped and one aggregate below its threshold, exactly those two
             rows reject and host_fallback{multisig_structural} rises by 1.
             p50 walls of both verifiers, the host's flatten-and-unmarshal
             time and the guarded call's audit span.
  14. lite    the light-client frontend: a chain of 128 heights of 100
             validators (the Cosmos SDK's DefaultMaxValidators), power 10,
             seed 11, 34 of the 100 replaced at heights 33, 65 and 97
             (testutil/lite_chain.py), so every long trust hop raises
             TooMuchChangeError and bisects. Two traffic shapes, each on a
             fresh lite.proxy.LiteProxy(source=..., pinned at height 1)
             behind serve_proxy on 127.0.0.1, its frontend's LaneFeed on
             the root's guarded verifier (K1 -> K2): (a) the tip burst of
             scripts/bench_lite.py, 64 clients each GETting /verify_commit
             and /light_block for the last 4 heights, rotated; (b) 64
             clients each certifying one seeded height in [2, 128]. Each
             answer is certified; every light_block equals, byte for byte,
             a serial DynamicVerifier's on HostBatchVerifier, and both reach
             the same trust frontier; K1 and K2 launched, exact against
             their plain versions on one launch's inputs; no fallback, the
             breaker closed, no audit mismatch. Per shape: the wall, p50 and
             p99 request latency, certified headers a second, the
             frontend's stats(), the cache's hit/miss/wait counts,
             heights_verified, the verify.audit and verify.dispatch span
             sums and the launches. Then three rejections through the
             batched path, 4 concurrent clients each: a stranger set served
             from height 60 (LiteError, validators_hash), the commit at 90
             stripped below 2/3 (CommitError, voting power) and a flipped
             signature bit at the first bisection midpoint (CommitError,
             invalid signature); nothing cached, nothing trusted.
  15. votes  the live-vote storm of scripts/bench_votes.py at its headline
             width: 256 validators of power 10, seed 7, 6 waves, rounds 0
             and 1, prevotes and precommits, its fault mix (garbage
             signatures, equivocations, re-gossiped duplicates, mutated
             block ids; testutil/votes.py). The serial path (VoteSet.add_vote
             with host verification), then wave by wave prevalidate ->
             planner.VoteFeed(window_s=0.05, max_rows=512) -> flush_now ->
             add_vote(verified=True) on two routes: the defaults on the card
             (the root's guarded verifier, K1 -> K2) and use_device=True
             (the device executor, K1 -> K2 -> the tally). On each route the
             outcome labels, evidence pairs and the final state of all four
             sets equal the serial path's, the round-1 precommit set's
             make_commit() passes verify_commit and is rejected with one
             signature bit flipped, K1 and K2 launched and exact against
             their plain versions on one flush's launch inputs, no fallback,
             the breaker closed. Then a storm on a set in which every 8th
             validator holds a secp256k1 key, on the verifier route: the
             same equalities, and K3 launched and exact too. Votes a second
             (serial and each route), dispatches, flushes by reason, rows
             and lanes a dispatch, occupancy, the queue wait from
             flush_records() and the verify/planner span sums;
  16. txs    the signed stage of scripts/bench_mempool.py: 64 ed25519
             senders, 512 signed txs in CheckTx windows of 128 through
             mempool.tx_verify.BatchTxVerifier(planner.TxFeed(window_s=0.005,
             max_rows=64), extract_signed_tx_sig) on the card, then its
             mixed stream (valid, garbage-signature, wrong-nonce and mutant
             txs) and tests/test_tx_batch.py's (with a secp256k1 and an
             undecodable tx). Every verdict equals a serial decode +
             verify_bytes (None for the undecodable one); K1, K2 and K3
             launched and exact on one launch's inputs; a recheck of the
             accepted txs answers every one from the cache with no launch;
             no fallback, the breaker closed. Serial and batched txs a
             second, dispatches and rows a dispatch.
  17. k4     the ed25519 MSM kernel (K4, ops/csrc/ed25519_msm.cu) against
             its plain version ed25519_msm.msm_ref on the card, on one
             schedule each at the adversarial window's size (the Go-edge
             window's first 16 rows: verdict 0) and at the 10,000-validator
             commit's (n 10,000, m 20,000, c 8, nwin 32: verdict 1), RLC
             seed 1234; verdict and canonical final point exact. K4's ms
             with each sub-launch's (every tree level, the fold, the
             finish), the plain version's, and the bound at the probe's
             IMAD.WIDE rate over the products the schedule that ran needs;
  18. msm    ed25519_path = "msm": the adversarial 16 rows through
             ed25519_cuda.rlc_verify_batch on the card equal the expected
             verdicts and the K1 + K2 ladder's; the whole Go-edge window
             equals the CPU run at the same seed and _verify_pure; the
             10,000-validator commit through verify_commit with
             TorchBatchVerifier(ed25519_path="msm") passes with K1 = 1, K4 =
             1 and K2 = 0 and verdicts equal to the ladder's (p50 wall over
             3 with its parse, prologue_h, schedule, pool, K4 spans), a
             flipped signature is rejected through the localization (K2
             once), and the commit through the guarded verifier of
             configure_verify(VerifyConfig(ed25519_path="msm")) passes with
             K1 = 1, K4 = 1, K2 = 0, no fallback, the breaker closed; then
             the default [verify] root is installed again;
  19. commit_window the window of phase 10 packed by
             parallel/commit_verify.pack_commit_window and verified by
             verify_commit_window on the ladder path (the K8 step: K1 -> K2
             once a message-length group, the int64 tally on the card) and
             on the msm path (one K4 launch, the dirty window localized by
             chunk RLCs to K1 -> K2), then planner.verify_window(
             use_device=True) under the msm default (its two msm calls with
             a dispatch deadline of 120 s: the dirty window outlasts the
             default 30): ok, tally and committed
             equal phase 10's planner verdict on all three, no fallback,
             the breaker closed, no audit mismatch; walls with their parts
             (msm.localize is the chunk localization), and the K8 tally's
             device time beside its byte bound on the ``torch_ops`` line.
  20. mempool the mempool's CheckTx path as the node wires it
             (node/verify_root.mempool): a [mempool] section at its defaults
             (size 5,000, cache 10,000, lanes (1, 1024), recheck on) with
             scripts/bench_mempool.py --signed's batching (CheckTx windows of
             128, a 50 ms wait, TxFeed(5 ms, 64 rows) on the root's guarded
             verifier), each Mempool over a local connection to a fresh
             SignedKVStoreApp. (1) the bench's 512 signed txs of 64 senders
             through a serial mempool (the defaults: checktx_batch 1, no
             hook, the app verifies) and the node-wired one, each timed from
             the first check_tx to the last callback; (2) the bench's mixed
             stream on both, then tests/test_tx_batch.py's (a secp256k1 and
             an undecodable tx) on fresh ones: per-tx codes, pool order,
             lane sizes and reap order equal the serial mempool's, and
             app.serial_verifies is 0; (3) a fresh node-wired mempool filled
             with 5,000 signed txs (64 senders, round robin), timed; (4)
             app.commit and update(2, []): all 5,000 stay, the recheck
             answers from BatchTxVerifier's cache, no kernel launches. K1
             and K2 launched in each timed part, K3 on test_tx_batch's
             stream, each exact on one launch's inputs; no fallback, the
             breaker closed, no audit mismatch. Rates, dispatches, rows a
             dispatch and the verify.audit share of each part's wall.
  21. block_exec the state layer and block execution, on a default
             [verify] root of its own. (1) A chain of 100 ed25519
             validators of power 10 (the Cosmos SDK's DefaultMaxValidators,
             seed 11) over a SignedKVStoreApp, its mempool wired as phase 20
             wires it and its executor by node/verify_root.block_executor
             (the evidence pool, verifier None: the root's guarded one). At
             each of 16 heights 64 signed txs of 64 senders go through
             check_tx (K1 + K2 through TxFeed), create_proposal_block reaps
             them, the 100 validators sign the block's precommits (the next
             LastCommit) and apply_block applies it, launching K1 + K2 once
             for the 100-row LastCommit from height 2 on (exact on height
             2's inputs). Every DeliverTx OK, last_block_total_tx 1,024, the
             pool empty, app.serial_verifies 1,024 (DeliverTx only), every
             stored ABCIResponses' results hash equal to the state's, every
             block and seen commit back from the BlockStore. Blocks a second
             and apply_block's parts (state.validate with verify.dispatch
             and verify.audit, state.exec, state.update, state.commit,
             state.save). (2) Phase 5's 10,000 keys as a genesis (power 10):
             block 1, then block 2 whose 10,000-row LastCommit goes through
             validate_block and the root's guarded verifier, K1 = K2 = 1 at
             b = 10,240, exact on that launch's inputs; apply_block p50 over
             3 applications to the height-1 state (a fresh state DB and app
             each) with its parts and whether the key caches were warm; a
             flipped LastCommit bit raises InvalidBlockError and leaves the
             state DB at height 1. (3) A BlockExecutor on part 1's mempool
             whose verifier is a fresh guarded one with its breaker tripped
             raises DeviceDispatchError, not InvalidBlockError, with no
             launch, the state DB at height 1 and the mempool's lock free.
             No fallback, the default breaker closed, no audit mismatch.

The window phase's routes and the backfill phase take the p50 of 2 traced
calls after the first (3 before phase 21 came; about 22 s).

Each path's launch counts are set to 0 just before it and read just after;
the kernels line carries the main path's as ``launches``, the lite
phase's shapes' as ``lite_launches``, the votes phase's routes' as
``votes_launches`` (verifier, executor, secp: the mixed-key storm) and the
txs phase's as ``txs_launches``, phases 18 and 19's as ``msm_launches`` and
``commit_window_launches``, phase 20's parts' as ``mempool_launches``
(rate, parity, secp, fill, recheck) and phase 21's as
``block_exec_launches`` (chain: CheckTx and apply_block; 10k: the first
application of block 2); K4's own ``launches`` are
the msm route's 10,000-validator commit's. The line before the last two is the
``kernels`` JSON, then the card's name
and power limit, then ``{"ok": true, "device": {...}}``. Exits 2 when no
CUDA device is present.
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import http.client
import json
import random
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.examples.kvstore import (
    KVStoreApp,
    SignedKVStoreApp,
    extract_signed_tx_sig,
)
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import secp256k1 as secp
from tendermint_tpu_torch.crypto.batch import (
    GuardedBatchVerifier,
    HostBatchVerifier,
    SigItem,
    TorchBatchVerifier,
    get_batch_verifier,
    verify_generic,
)
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, PubKeySecp256k1
from tendermint_tpu_torch.frontend.aggregator import BatchingVerifier
from tendermint_tpu_torch.libs import breaker, trace
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.metrics import (
    StateMetrics,
    get_frontend_metrics,
    get_verify_metrics,
)
from tendermint_tpu_torch.lite import DBProvider, DynamicVerifier, LiteError
from tendermint_tpu_torch.lite.proxy import LiteProxy, serve_proxy
from tendermint_tpu_torch.mempool.mempool import MempoolError
from tendermint_tpu_torch.mempool.tx_verify import BatchTxVerifier
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.node.verify_root import configure_verify
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import ed25519_msm as em
from tendermint_tpu_torch.ops import fe
from tendermint_tpu_torch.ops import imad_probe
from tendermint_tpu_torch.ops import secp256k1_cuda as sc
from tendermint_tpu_torch.parallel import commit_verify as cv
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.execution import BlockExecutor, InvalidBlockError
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.testutil import lite_chain as lc
from tendermint_tpu_torch.testutil import multisig as tm
from tendermint_tpu_torch.testutil import secp_signer
from tendermint_tpu_torch.testutil import votes as tv
from tendermint_tpu_torch.testutil import window as tw
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.validator_set import CommitError
from tendermint_tpu_torch.types.vote import Vote

N_VALIDATORS = 10_000  # BASELINE.json config 2 (and config 4 at its width)
N_MIXED = 1_000
K1_ROWS = 2048
K1_LENGTHS = (0, 33, 104, 111, 112, 200)
K1_RAGGED_ROWS = 200  # not a multiple of the rows a K1 block serves
K2_ROWS = 256
K2_RAGGED_ROWS = 200  # not a multiple of the rows a K2 block serves
K3_ROWS = 256
K3_RN_PAIRS = 4  # row pairs that take the r + n branch (rnok 1, then 0)
K3_RAGGED_ROWS = 200  # not a multiple of the rows a K3 block serves
WALL_REPS = 5
TIME_ITERS = 20
# the reference's fast-sync defaults: VERIFY_WINDOW = 512 heights
# (blockchain/reactor.py:54) of bench_fastsync.py's 64 validators
# (BASELINE.json config 3); 32,768 lanes, lane bucket 32,768, segments 512
WINDOW_H, WINDOW_V = 512, 64
WINDOW_REPS = 3
# the window's routes (phase 10) and the backfill stream (phase 11) take the
# p50 of 2 traced calls after the first (3 before the block_exec phase came:
# about 22 s of the script's wall paid for it)
WINDOW_ROUTE_REPS = 2
ORACLE_LANES = 256
# state sync's backfill sub-window (statesync/syncer.py BACKFILL_SUBWINDOW)
BACKFILL_SUBWINDOW = 32
# the RPC burst: one row per concurrent ?verify=1 query, heights 0-63
RPC_ROWS = 64
RPC_COMMITS = 8
MULTISIG_VALS = tm.N_VALS  # BASELINE.json config 5: 1k multisig validators
RESULT_TIMEOUT = 300.0
# the light-client frontend: the Cosmos SDK staking default
# DefaultMaxValidators = 100 (x/staking/types/params.go), power 10 each, 128
# heights; 34 of the 100 replaced at 33, 65 and 97, so an old set holds at
# most 66 % of a later commit's power and every long hop bisects.
# scripts/bench_lite.py's 64 clients on the last 4 heights.
LITE_VALS, LITE_HEIGHTS, LITE_SEED = 100, 128, 11
LITE_CHANGES, LITE_CHANGE_N = (33, 65, 97), 34
LITE_CLIENTS, LITE_TIPS, LITE_REJECT_CLIENTS = 64, 4, 4
# the rejections: a stranger set served from height 60, the commit at 90
# stripped below 2/3, a flipped bit at the first bisection midpoint
LITE_STRANGER_FROM, LITE_STRIPPED = 60, 90
# scripts/bench_votes.py at its headline width: 256 validators of power 10,
# seed 7, 6 waves, rounds 0 and 1, its window and rows (_make_feed); the
# mixed-key storm gives every 8th validator a secp256k1 key
VOTE_VALS, VOTE_POWER, VOTE_SEED, VOTE_WAVES = 256, 10, 7, 6
VOTE_WINDOW_S, VOTE_MAX_ROWS, VOTE_SECP_EVERY = 0.05, 512, 8
# scripts/bench_mempool.py --signed: 64 senders, 512 txs in CheckTx windows
# of 128, TxFeed(window_s=0.005, max_rows=64)
TX_N, TX_SENDERS, TX_WINDOW, TX_WINDOW_S, TX_MAX_ROWS = 512, 64, 128, 0.005, 64
# the mempool phase: the [mempool] defaults (size 5,000, cache 10,000, lanes
# (1, 1024), recheck on) with scripts/bench_mempool.py --signed's batching
# (CheckTx windows of 128, a 50 ms wait, TxFeed(5 ms, 64 rows)); the pool is
# then filled to its configured size by 64 senders, round robin
MP_BATCH, MP_WAIT, MP_WINDOW_MS, MP_ROWS = 128, 0.05, 5.0, 64
MP_FILL = MempoolConfig().size
# the block_exec phase: a chain of the Cosmos SDK's DefaultMaxValidators (100,
# power 10, seed 11) fed by the node-wired mempool at the mempool phase's
# settings, 16 heights of 64 signed txs (64 senders, nonces in order); then
# BASELINE.json config 2's 10,000-validator LastCommit through validate_block
BX_VALS, BX_POWER, BX_SEED = 100, 10, 11
BX_HEIGHTS, BX_TXS = 16, 64
BX_REPS = 3
BX_TIME0 = 1_700_000_000_000_000_000
BX_SPANS = ("state.validate", "verify.dispatch", "verify.audit", "state.exec",
            "state.begin_block_info", "state.update", "state.commit", "state.save")

# Rates for the least time the card could take: HBM bandwidth (H100 SXM
# data sheet); 32-bit integer add, logic, shift and multiply-add each retire
# at 64 per clock per SM (CUDA C++ Programming Guide throughput table,
# compute capability 9.0), which prices K1's instructions. K2's and K3's
# 32x32 -> 64 products (IMAD.WIDE) are priced at the rate the multiply
# probe (ops/imad_probe.py) measures in the same run; the bound at the
# table's 64 a clock is printed beside it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLK_PER_SM = 64

# K1's integer work per SHA-512 block, in 32-bit instructions (64-bit words
# in register pairs): a round has two Sigma functions (three 64-bit rotates
# of two funnel shifts each, one LOP3 a half for the three-way xor), Ch and
# Maj (one LOP3 a half each) and five adds of up to three 64-bit inputs
# (IADD3 + IADD3.X); each of the 64 schedule words has two sigma functions
# (two rotates and a shift, one LOP3 a half) and two three-input adds; then
# eight state adds.
SHA512_BLOCK_OPS = 80 * (2 * 8 + 2 * 2 + 5 * 2) + 64 * (2 * 8 + 2 * 2) + 8 * 2
# K1's Barrett reduction mod L in radix 2^16: q1 * mu, low half of q3 * L
BARRETT_PRODUCTS = 17 * 17 + 17 * 18 // 2

REPLACES = {
    "ed25519_prologue": "tendermint_tpu/ops/ed25519_pallas.py:622",
    "ed25519_ladder": "tendermint_tpu/ops/ed25519_pallas.py:354",
    "secp256k1_ladder": "tendermint_tpu/ops/secp256k1_pallas.py:283",
}
KERNELS = tuple(REPLACES)
# K4 runs on the msm path only (phases 17-19), beside the three above
K4, K4_REPLACES = "ed25519_msm", "tendermint_tpu/ops/ed25519_msm.py:255"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


SPIN_CYCLES = 50_000_000  # ~25 ms at 1.98 GHz: longer than enqueueing 20 calls


def cuda_ms(fn, iters: int = TIME_ITERS, warmup: int = 3) -> float:
    """Mean device ms of fn() over iters back-to-back calls (CUDA events).
    A spin kernel holds the stream while the host enqueues the calls, so a
    kernel shorter than its own launch overhead is timed on the device
    alone, not at the host's enqueue rate."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_p50_ms(fn, iters: int = TIME_ITERS, warmup: int = 3) -> float:
    """Median device ms of fn(), each call timed by its own events."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def max_abs_diff(a_list, b_list) -> int:
    worst = 0
    for a, b in zip(a_list, b_list):
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() if a.numel() else 0
        worst = max(worst, int(d))
    return worst


@contextlib.contextmanager
def captured_packs():
    """Record the K1 + K2 inputs of every message-length group packed while
    active: ``ed25519_cuda.packed_inputs``, which the planner's device
    executor and ``TorchBatchVerifier`` both call for each launch. Records
    only; launches nothing."""
    packs, real = [], ec.packed_inputs

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        packs.append(out[0])
        return out

    ec.packed_inputs = record
    try:
        yield packs
    finally:
        ec.packed_inputs = real


def hold_k1_k2(inputs, err: dict, what: str) -> tuple:
    """K1 and K2 on one launch's packed inputs against their plain versions,
    exact; the differences fold into ``err`` (the kernels line). Returns
    (b, K1's inputs, K2's inputs)."""
    consts, negax, ay, pubw, sigw, tmpl, vidx, vwords = inputs
    k1_in = (tmpl, vidx, vwords, pubw, sigw)
    k1_out = ec.prologue(*k1_in)
    err["ed25519_prologue"] = max(err["ed25519_prologue"],
                                  max_abs_diff(k1_out, ec.prologue_ref(*k1_in)))
    k2_in = (consts, negax, ay) + tuple(k1_out)
    k2_out = ec.ladder(*k2_in)
    err["ed25519_ladder"] = max(err["ed25519_ladder"],
                                max_abs_diff(k2_out, ec.ladder_ref(*k2_in)))
    check(max(err.values()) == 0, f"{what}: kernel differs from its plain version: {err}")
    return negax.shape[1], k1_in, k2_in


def as_arrays(pubs, sigs):
    n = len(pubs)
    return (np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32),
            np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64))


def group_inputs(pubs_a, msgs, sigs_a, dev):
    """Packed kernel inputs for one uniform-length group."""
    neg_ax, ay, valid = ec._decompress_valset(pubs_a)
    valid = valid & ((sigs_a[:, 63] & 224) == 0)
    inputs, b = ec.packed_inputs(pubs_a, msgs, sigs_a, neg_ax, ay, valid,
                                 len(msgs[0]), dev)
    return inputs, valid


def k1_rows(rng, n: int, ln: int):
    """n seeded rows of message length ln: (pubs, sigs, msgs, K1's five
    inputs as numpy arrays). Lengths 104, 112 and 200 share one template
    with a varying fixed64 at byte 17; at the others every byte varies."""
    pubs_a = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs_a = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    if ln in (104, 112, 200):
        m = np.tile(rng.integers(0, 256, ln, dtype=np.uint8), (n, 1))
        m[:, 17:25] = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    else:
        m = rng.integers(0, 256, (n, ln), dtype=np.uint8)
    msgs = [m[i].tobytes() for i in range(n)]
    tmpl, vrows, vwords = ec.pack_variable_words(pubs_a, msgs, sigs_a, ln, n)
    return pubs_a, sigs_a, msgs, (tmpl, vrows, vwords, np.ascontiguousarray(pubs_a).view("<u4"),
                                  np.ascontiguousarray(sigs_a).view("<u4"))


def phase_k1(dev, rng) -> int:
    lanes, rpb, blocks, smem = ec.k1_geometry(K1_ROWS)
    phase(f"K1 prologue vs plain: {K1_ROWS} rows x lengths {K1_LENGTHS}; {lanes} thread a "
          f"row, {rpb} rows a block, {blocks} blocks, {smem} B dynamic shared memory a block; "
          f"{registers('ed25519_prologue')}")
    worst = 0
    for ln in K1_LENGTHS:
        pubs_a, sigs_a, msgs, host = k1_rows(rng, K1_ROWS, ln)
        tmpl, vrows = host[0], host[1]
        args = [ec._put(a, dev) for a in host]
        got = ec.prologue(*args)
        torch.cuda.synchronize()
        want = ec.prologue_ref(*args)
        d = max_abs_diff(got, want)
        check(d == 0, f"K1 differs from its plain version at length {ln}: {d}")
        worst = max(worst, d)
        digh = got[1].cpu().numpy()
        for i in rng.choice(K1_ROWS, 64, replace=False):
            h = int.from_bytes(hashlib.sha512(
                sigs_a[i, :32].tobytes() + pubs_a[i].tobytes() + msgs[i]).digest(),
                "little") % ed.L
            got_h = 0
            for t in range(ec.NWIN):
                got_h = (got_h << 4) | int(digh[t, i])
            check(got_h == h, f"K1 h != SHA-512 mod L at length {ln}, row {i}")
        print(f"  length {ln:3d}: rows {tmpl.shape[0]} k {vrows.shape[0]} exact", flush=True)
    return max(worst, phase_k1_ragged(dev, rng))


def phase_k1_ragged(dev, rng) -> int:
    """K1 on K1_RAGGED_ROWS seeded rows of the main path's length, which
    end inside a block: the outputs are views of longer buffers with
    sentinel tails, which rows past b must leave unwritten."""
    b = K1_RAGGED_ROWS
    lanes, rpb, blocks, _ = ec.k1_geometry(b)
    ins = tuple(ec._put(a, dev) for a in k1_rows(rng, b, 104)[3])
    sizes = (ec.NWIN, ec.NWIN, ec.NLIMB, 1)
    bufs = sentinel_outputs(dev, tuple(n * b for n in sizes))
    outs = tuple(buf[:n * b].view(n, b) for buf, n in zip(bufs, sizes))
    ec.prologue_into(ins, outs)
    torch.cuda.synchronize()
    worst = max_abs_diff(outs, ec.prologue_ref(*ins))
    check(worst == 0, f"K1 differs from its plain version at b = {b}: {worst}")
    check(tails_intact(bufs), "K1 wrote past row b")
    print(f"  ragged b = {b}: {blocks} blocks of {rpb} rows ({blocks * rpb - b} past b), "
          f"exact (digs, digh, rlimb, rsign); rows past b left unwritten", flush=True)
    return worst


def phase_k2(dev, rng) -> int:
    phase(f"K2 ladder vs plain: {K2_ROWS} rows incl. the Go-edge window")
    pubs, msgs, sigs, fixed = tc.go_edge_window(seed=1)
    n_edge = len(pubs)
    for i in range(K2_ROWS - n_edge):
        priv = ed.gen_privkey(rng.bytes(32))
        ln = tc.EDGE_LENGTHS[i % 2]
        msg = rng.bytes(ln)
        sig = bytearray(ed.sign(priv, msg))
        if i % 7 == 3:
            sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(bytes(sig))
    pubs_a, sigs_a = as_arrays(pubs, sigs)
    lens = np.array([len(m) for m in msgs])
    verdict = np.zeros(K2_ROWS, dtype=bool)
    worst = 0
    for ln in np.unique(lens):
        idx = np.nonzero(lens == ln)[0]
        inputs, valid = group_inputs(pubs_a[idx], [msgs[i] for i in idx],
                                     sigs_a[idx], dev)
        consts, negax, ay, pubw, sigw, tmpl, vidx, vwords = inputs
        digs, digh, rlimb, rsign = ec.prologue(tmpl, vidx, vwords, pubw, sigw)
        got = ec.ladder(consts, negax, ay, digs, digh, rlimb, rsign)
        torch.cuda.synchronize()
        want = ec.ladder_ref(consts, negax, ay, digs, digh, rlimb, rsign)
        d = max_abs_diff(got, want)
        check(d == 0, f"K2 differs from its plain version at length {ln}: {d}")
        worst = max(worst, d)
        verdict[idx] = (got[0][: len(idx)].cpu().numpy() != 0) & valid
        renc = got[1].cpu().numpy().astype(np.uint32)
        for j, i in enumerate(idx):
            if verdict[i]:
                enc = renc[:, j].astype("<u4").tobytes()
                check(enc == sigs[i][:32], f"K2 accepted row {i} but enc(R') != R")
    sample = list(range(n_edge)) + list(range(n_edge, K2_ROWS, 16))
    for i in sample:
        want_v = ed._verify_pure(pubs[i], msgs[i], sigs[i])
        check(bool(verdict[i]) == want_v, f"K2 row {i}: {verdict[i]} vs oracle {want_v}")
        if i in fixed and fixed[i] is not None:
            check(want_v == fixed[i], f"edge row {i} oracle {want_v} != {fixed[i]}")
    print(f"  exact on {K2_ROWS} rows; {len(sample)} verdicts match _verify_pure "
          f"({int(verdict.sum())} accepted)", flush=True)
    return max(worst, phase_k2_ragged(dev, rng))


TAIL, SENTINEL = 64, 0x5A5A5A5A


def sentinel_outputs(dev, sizes):
    """Buffers of ``n + TAIL`` words filled with SENTINEL, for each n in
    ``sizes``: a kernel writes the first n, the tails must keep it."""
    return [torch.full((n + TAIL,), SENTINEL, dtype=torch.int32, device=dev) for n in sizes]


def tails_intact(bufs) -> bool:
    return all(bool((t[-TAIL:] == SENTINEL).all()) for t in bufs)


def phase_k2_ragged(dev, rng) -> int:
    """K2 on K2_RAGGED_ROWS seeded rows, which end inside a block: the
    outputs are views of longer buffers with sentinel tails, which rows past
    b must leave unwritten."""
    b = K2_RAGGED_ROWS
    lanes, rpb, blocks, _ = ec.k2_geometry(b)
    negax, ay, rlimb = (rng.integers(0, 1 << 25, (ec.NLIMB, b)) for _ in range(3))
    digs, digh = (rng.integers(0, 16, (ec.NWIN, b)) for _ in range(2))
    rsign = rng.integers(0, 2, (1, b))
    ins = tuple(ec._put(a, dev) for a in (ec._CONSTS, negax, ay, digs, digh, rlimb, rsign))
    bufs = sentinel_outputs(dev, (b, 8 * b))
    outs = (bufs[0][:b], bufs[1][:8 * b].view(8, b))
    ec.ladder_into(ins, *outs)
    torch.cuda.synchronize()
    worst = max_abs_diff(outs, ec.ladder_ref(*ins))
    check(worst == 0, f"K2 differs from its plain version at b = {b}: {worst}")
    check(tails_intact(bufs), "K2 wrote past row b")
    print(f"  ragged b = {b}: {blocks} blocks of {rpb} rows ({blocks * rpb - b} past b), "
          f"exact (ok, renc); rows past b left unwritten", flush=True)
    return worst


def expect_commit_error(fn, prefix: str) -> str:
    try:
        fn()
    except CommitError as e:
        check(str(e).startswith(prefix), f"CommitError {e!r}, want {prefix!r}")
        return str(e)
    raise SmokeFailure(f"no CommitError, want {prefix!r}")


def host_p50_ms(fn) -> float:
    """Median host-clock ms of fn() over WALL_REPS calls."""
    samples = []
    for _ in range(WALL_REPS):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples) * 1e3


def reset_launches() -> None:
    ec.reset_launches()
    sc.reset_launches()
    em.reset_launches()


def read_launches() -> dict:
    return {**ec.launches, **sc.launches, **em.launches}


def flipped(sc_: tc.SignedCommit, i: int):
    """The commit with a bit of precommit i's signature flipped: inside s
    for ed25519 (bit 300) and in the last byte of a DER signature (s)."""
    sig = sc_.commit.precommits[i].signature
    return tc.flip_signature_bit(sc_.commit, i, 300 if len(sig) == 64 else 8 * (len(sig) - 1))


def drive_commit(sc_: tc.SignedCommit, verifier, tampered_rows) -> dict:
    """verify_commit on the signed commit: it passes (one first call, then
    WALL_REPS timed), a flipped signature in each of ``tampered_rows`` is
    rejected, and 2/3 of the precommits (not above 2/3 of equal powers)
    are rejected. The launch counts are set to 0 just before and read just
    after."""
    n = sc_.valset.size
    verify = lambda commit: sc_.valset.verify_commit(
        sc_.chain_id, sc_.block_id, sc_.height, commit, verifier=verifier)
    reset_launches()
    t0 = time.perf_counter()
    verify(sc_.commit)
    first_ms = (time.perf_counter() - t0) * 1e3
    walls = []
    for _ in range(WALL_REPS):
        t0 = time.perf_counter()
        verify(sc_.commit)
        walls.append(time.perf_counter() - t0)
    for i in tampered_rows:
        expect_commit_error(lambda: verify(flipped(sc_, i)), "invalid signature in commit")
    msg = expect_commit_error(lambda: verify(tc.drop_precommits(sc_.commit, (2 * n) // 3)),
                              "insufficient voting power")
    launches = read_launches()
    p50 = statistics.median(walls) * 1e3
    print(f"  verify_commit: passes; first {first_ms:.1f} ms; p50 {p50:.3f} ms over "
          f"{WALL_REPS}; {len(tampered_rows)} tampered and under-quorum rejected ({msg}); "
          f"launches {launches}", flush=True)
    return {"first_ms": first_ms, "p50_ms": p50, "launches": launches}


def registers(name: str) -> str:
    """The compiler's register line for kernel ``name`` in this build."""
    return next((ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln), "registers not reported")


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def least_ms(ins, outs, ops: float, rate: float):
    """The least time for the work: each input read once and each output
    written once at the HBM rate, against ``ops`` operations at ``rate`` a
    second; (ms, what bounds it)."""
    t_bytes = (nbytes(ins) + nbytes(outs)) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_ed25519_main(dev, op_rate: float, mul_rate: float, err: dict) -> dict:
    phase(f"main path: {N_VALIDATORS}-validator ed25519 commit")
    t0 = time.perf_counter()
    sc_ = tc.build_commit(N_VALIDATORS)
    print(f"  built and signed in {time.perf_counter() - t0:.1f} s", flush=True)
    verifier = TorchBatchVerifier()
    check(verifier.device.type == "cuda", "verifier is not on cuda")
    run = drive_commit(sc_, verifier, [N_VALIDATORS // 3])
    for name in ("ed25519_prologue", "ed25519_ladder"):
        check(run["launches"][name] > 0, f"kernel {name} was not launched on the main path")

    # the main path's resident inputs, for device timings and the checks
    pubs_a, sigs_a = as_arrays(
        [v.pub_key.bytes() for v in sc_.valset.validators],
        [pc.signature for pc in sc_.commit.precommits])
    msgs = [pc.sign_bytes(sc_.chain_id) for pc in sc_.commit.precommits]
    inputs, valid = group_inputs(pubs_a, msgs, sigs_a, dev)
    consts, negax, ay, pubw, sigw, tmpl, vidx, vwords = inputs
    b = negax.shape[1]
    packed_p50 = cuda_p50_ms(lambda: ec._device_verify_packed(*inputs))
    print(f"  packed dispatch (K1 + K2, inputs resident), b = {b}: "
          f"p50 {packed_p50:.3f} ms", flush=True)

    # where verify_commit's wall time goes (host clock, p50 of WALL_REPS)
    raw_pubs = [v.pub_key.bytes() for v in sc_.valset.validators]
    breakdown = {
        "collect_commit_sigs_ms": host_p50_ms(lambda: sc_.valset.collect_commit_sigs(
            sc_.chain_id, sc_.block_id, sc_.height, sc_.commit)),
        "verify_ed25519_raw_ms": host_p50_ms(
            lambda: verifier.verify_ed25519_raw(raw_pubs, msgs, [
                pc.signature for pc in sc_.commit.precommits])),
        "pack_and_upload_ms": host_p50_ms(lambda: group_inputs(pubs_a, msgs, sigs_a, dev)),
        "device_packed_p50_ms": packed_p50,
    }
    print("  breakdown: " + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()),
          flush=True)

    k1_in = (tmpl, vidx, vwords, pubw, sigw)
    k1_out = ec.prologue(*k1_in)
    k1_ref = ec.prologue_ref(*k1_in)
    err["ed25519_prologue"] = max(err["ed25519_prologue"], max_abs_diff(k1_out, k1_ref))
    k2_in = (consts, negax, ay) + tuple(k1_out)
    k2_out = ec.ladder(*k2_in)
    k2_ref = ec.ladder_ref(*k2_in)
    err["ed25519_ladder"] = max(err["ed25519_ladder"], max_abs_diff(k2_out, k2_ref))
    check(max(err.values()) == 0, f"kernel differs from its plain version: {err}")
    check(bool((k2_out[0][:N_VALIDATORS].cpu().numpy() != 0).all()),
          "main-path verdicts not all accepted")

    # K1's SHA-512 runs on the integer pipe beside its Barrett products on
    # the multiply pipe, so the larger of the two counts; K2 counts the
    # products it needs, NLIMB^2 a multiplication and NLIMB(NLIMB+1)/2 a
    # squaring.
    nblocks = tmpl.shape[0] // 32
    k1_ops = max(nblocks * SHA512_BLOCK_OPS, BARRETT_PRODUCTS) * b
    muls, squarings = ec.ladder_fe_ops()
    k2_ops = (muls * fe.NLIMB ** 2 + squarings * fe.NLIMB * (fe.NLIMB + 1) // 2) * b
    k1_ms = cuda_ms(lambda: ec.prologue(*k1_in))
    lanes, rpb, blocks, smem = ec.k1_geometry(b)
    print(f"  K1 {k1_ms:.4f} ms at b = {b}: {lanes} thread a row, {rpb} rows a block, "
          f"{blocks} blocks, {smem} B dynamic shared memory a block; "
          f"{registers('ed25519_prologue')}", flush=True)
    k2_ms = cuda_ms(lambda: ec.ladder(*k2_in))
    lanes, rpb, blocks, smem = ec.k2_geometry(b)
    print(f"  K2 {k2_ms:.4f} ms at b = {b}: {lanes} lanes a row, {rpb} rows a block, "
          f"{blocks} blocks, {smem} B dynamic shared memory a block; "
          f"{registers('ed25519_ladder')}", flush=True)
    return {
        "launches": run["launches"],
        "ms": {"ed25519_prologue": k1_ms,
               "ed25519_ladder": k2_ms},
        "plain_ms": {"ed25519_prologue": cuda_ms(lambda: ec.prologue_ref(*k1_in), 2, 1),
                     "ed25519_ladder": cuda_ms(lambda: ec.ladder_ref(*k2_in), 1, 1)},
        "bounds": {"ed25519_prologue": least_ms(k1_in, k1_out, k1_ops, op_rate),
                   "ed25519_ladder": least_ms(k2_in, k2_out, k2_ops, mul_rate)},
        "table_bound": {"ed25519_ladder": least_ms(k2_in, k2_out, k2_ops, op_rate)},
        "b": b,
        "p50_ms": run["p50_ms"],
        "commit": sc_,
    }


def phase_k3(dev, rng) -> int:
    phase(f"K3 secp256k1 ladder vs plain: {K3_ROWS} rows incl. the edge window "
          f"and {K3_RN_PAIRS} r + n row pairs")
    pubs, digs, sigs, fixed = tc.secp_edge_window(seed=1)
    n_edge = len(pubs)
    m = K3_ROWS - 2 * K3_RN_PAIRS
    for i in range(m - n_edge):
        priv = secp.gen_privkey(rng.bytes(32))
        dig = rng.bytes(32)
        sig = bytearray(secp_signer.sign(priv, dig))
        if i % 7 == 3:
            sig[-1 - int(rng.integers(0, 8))] ^= 1 << int(rng.integers(0, 8))
        pubs.append(secp_signer.pubkey_compressed(priv))
        digs.append(dig)
        sigs.append(bytes(sig))
    host, forced = sc.pack_rows(pubs, digs, sigs, K3_ROWS)
    qx, qy, d1, d2, rl, rnl, rnok = (h.copy() for h in host)
    # x(R) = r + n is reached by an honest signature with probability about
    # 2^-128: each pair repeats clean row k's point and digits with
    # rnl = x(R) (its r) and rl = r + 1, once with rnok = 1 (accept) and
    # once with rnok = 0 (reject)
    for k in range(K3_RN_PAIRS):
        for j, flag in ((m + 2 * k, 1), (m + 2 * k + 1, 0)):
            for a in (qx, qy, d1, d2):
                a[j] = a[k]
            rnl[j] = rl[k]
            rl[j] = sc._limbs_batch([sc.F.limbs_to_int(rl[k].tolist()) + 1])[0]
            rnok[j] = flag
    ins = sc.upload((qx, qy, d1, d2, rl, rnl, rnok), dev)
    got = sc.ladder(*ins)
    torch.cuda.synchronize()
    worst = max_abs_diff(got, sc.ladder_ref(*ins))
    check(worst == 0, f"K3 differs from its plain version: {worst}")
    ok = got[0].cpu().numpy() != 0
    for k in range(K3_RN_PAIRS):
        check(ok[m + 2 * k] and not ok[m + 2 * k + 1], f"K3 r + n pair {k}: "
              f"{ok[m + 2 * k]}, {ok[m + 2 * k + 1]}, want True, False")
    verdict = np.where(forced[:m] >= 0, forced[:m].astype(bool), ok[:m])
    sample = list(range(n_edge)) + list(range(n_edge, m, 16))
    for i in sample:
        want_v = secp.verify(pubs[i], digs[i], sigs[i])
        check(bool(verdict[i]) == want_v, f"K3 row {i}: {verdict[i]} vs oracle {want_v}")
        if i in fixed:
            check(want_v == fixed[i], f"edge row {i} oracle {want_v} != {fixed[i]}")
    print(f"  exact on {K3_ROWS} rows (ok, X, Z); r + n pairs accepted with rnok "
          f"and rejected without; {len(sample)} verdicts match secp256k1.verify "
          f"({int(verdict.sum())} of {m} accepted)", flush=True)
    return max(worst, phase_k3_ragged(dev, rng))


def phase_k3_ragged(dev, rng) -> int:
    """K3 on K3_RAGGED_ROWS seeded rows, which end inside a block: the
    outputs are views of longer buffers with sentinel tails, which rows past
    b must leave unwritten."""
    b = K3_RAGGED_ROWS
    lanes, rpb, blocks, _ = sc.k3_geometry(b)
    qx, qy, rl, rnl = (rng.integers(0, 1 << 22, (b, sc.NLIMB)).astype(np.uint32)
                       for _ in range(4))
    d1, d2 = (rng.integers(0, 16, (b, sc.NWIN)).astype(np.uint32) for _ in range(2))
    rnok = rng.integers(0, 2, (b,)).astype(np.uint32)
    ins = sc.upload((qx, qy, d1, d2, rl, rnl, rnok), dev)
    bufs = sentinel_outputs(dev, (b, sc.NLIMB * b, sc.NLIMB * b))
    outs = (bufs[0][:b], bufs[1][:sc.NLIMB * b].view(sc.NLIMB, b),
            bufs[2][:sc.NLIMB * b].view(sc.NLIMB, b))
    sc.ladder_into(ins, *outs)
    torch.cuda.synchronize()
    worst = max_abs_diff(outs, sc.ladder_ref(*ins))
    check(worst == 0, f"K3 differs from its plain version at b = {b}: {worst}")
    check(tails_intact(bufs), "K3 wrote past row b")
    print(f"  ragged b = {b}: {blocks} blocks of {rpb} rows ({blocks * rpb - b} past b), "
          f"exact (ok, X, Z); rows past b left unwritten", flush=True)
    return worst


def phase_secp_main(dev, op_rate: float, mul_rate: float, err: dict) -> dict:
    phase(f"secp256k1 path: {N_VALIDATORS}-validator secp256k1 commit")
    t0 = time.perf_counter()
    sc_ = tc.build_commit(N_VALIDATORS, key_type="secp256k1")
    print(f"  built and signed in {time.perf_counter() - t0:.1f} s", flush=True)
    verifier = TorchBatchVerifier()
    run = drive_commit(sc_, verifier, [N_VALIDATORS // 3])
    check(run["launches"]["secp256k1_ladder"] > 0, "K3 was not launched on the secp256k1 path")

    pks, msgs, sigs, _ = sc_.valset.collect_commit_sigs(
        sc_.chain_id, sc_.block_id, sc_.height, sc_.commit)
    pubs = [pk.bytes() for pk in pks]
    items = [SigItem(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    b = sc._bucket(N_VALIDATORS)
    host, forced = sc.pack_rows(pubs, [sha256(m) for m in msgs], sigs, b)
    check(bool((forced[:N_VALIDATORS] == -1).all()), "an honest row was decided on the host")
    ins = sc.upload(host, dev)

    def upload_sync():
        sc.upload(host, dev)
        torch.cuda.synchronize()

    breakdown = {
        "collect_commit_sigs_ms": host_p50_ms(lambda: sc_.valset.collect_commit_sigs(
            sc_.chain_id, sc_.block_id, sc_.height, sc_.commit)),
        "verify_secp256k1_ms": host_p50_ms(lambda: verifier.verify_secp256k1(items)),
        "sha256_and_prep_item_ms": host_p50_ms(lambda: [
            sc.prep_item(p, sha256(m), s) for p, m, s in zip(pubs, msgs, sigs)]),
        "sha256_prep_and_pack_ms": host_p50_ms(lambda: sc.pack_rows(
            pubs, [sha256(m) for m in msgs], sigs, b)),
        "upload_ms": host_p50_ms(upload_sync),
        "k3_device_p50_ms": cuda_p50_ms(lambda: sc.ladder(*ins)),
    }
    print(f"  b = {b}; breakdown: " + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()),
          flush=True)

    out = sc.ladder(*ins)
    err["secp256k1_ladder"] = max(err["secp256k1_ladder"],
                                  max_abs_diff(out, sc.ladder_ref(*ins)))
    check(err["secp256k1_ladder"] == 0, f"K3 differs from its plain version: {err}")
    check(bool((out[0][:N_VALIDATORS].cpu().numpy() != 0).all()),
          "secp256k1 verdicts not all accepted")
    # the products the function needs: NLIMB^2 a multiplication,
    # NLIMB(NLIMB+1)/2 a squaring, NLIMB a multiplication by b3
    muls, squarings, smalls = sc.ladder_fe_ops()
    ops = (muls * sc.NLIMB ** 2 + squarings * sc.NLIMB * (sc.NLIMB + 1) // 2
           + smalls * sc.NLIMB) * b
    k3_ms = cuda_ms(lambda: sc.ladder(*ins))
    lanes, rpb, blocks, smem = sc.k3_geometry(b)
    print(f"  K3 {k3_ms:.4f} ms at b = {b}: {lanes} lanes a row, {rpb} rows a block, "
          f"{blocks} blocks, {smem} B dynamic shared memory a block; {registers(sc.NAME)}",
          flush=True)
    return {
        "launches": run["launches"],
        "ms": k3_ms,
        "plain_ms": cuda_ms(lambda: sc.ladder_ref(*ins), 1, 1),
        "bound": least_ms(ins, out, ops, mul_rate),
        "table_bound": least_ms(ins, out, ops, op_rate),
        "b": b,
    }


def fallbacks() -> float:
    """Device fallbacks counted so far, every reason together."""
    return sum(get_verify_metrics().device_fallback._values.values())


def audits(outcome: str) -> float:
    return get_verify_metrics().device_audit._values.get((outcome,), 0.0)


def retries() -> float:
    """Device dispatches retried so far (a timeout or a device error)."""
    return sum(get_verify_metrics().device_retries._values.values())


def check_guard_clean(fallbacks_before: float, what: str) -> None:
    check(fallbacks() == fallbacks_before, f"{what}: a device dispatch fell back to the "
          f"host: {get_verify_metrics().device_fallback._values}")
    check(breaker.get_device_breaker().state == breaker.CLOSED,
          f"{what}: breaker {breaker.get_device_breaker().state}")
    check(audits("mismatch") == 0, f"{what}: audit mismatch")


def phase_default_commit(root, sc_: tc.SignedCommit) -> dict:
    phase(f"default: the {N_VALIDATORS}-validator ed25519 commit through the default "
          f"(guarded) verifier")
    check(get_batch_verifier() is root.verifier,
          "the default verifier is not the configuration root's guarded one")
    verify = lambda: sc_.valset.verify_commit(  # noqa: E731
        sc_.chain_id, sc_.block_id, sc_.height, sc_.commit)
    before = fallbacks()
    audit_ok0 = audits("ok")
    reset_launches()
    t0 = time.perf_counter()
    verify()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    for name in ("ed25519_prologue", "ed25519_ladder"):
        check(launches[name] == 1, f"default commit launched {name} {launches[name]} times")
    check(launches["secp256k1_ladder"] == 0, "K3 launched on an ed25519 commit")
    walls, parts = [], {"verify.dispatch": [], "verify.audit": []}
    trace.enable()
    try:
        for _ in range(WINDOW_REPS):
            trace.reset()
            t0 = time.perf_counter()
            verify()
            walls.append(time.perf_counter() - t0)
            for n, v in span_seconds(parts).items():
                parts[n].append(v)
    finally:
        trace.disable()
    check_guard_clean(before, "default commit")
    audited = audits("ok") - audit_ok0
    check(audited > 0, "no audited lane on the default commit")
    p50 = statistics.median(walls) * 1e3
    part_ms = {n: statistics.median(v) * 1e3 for n, v in parts.items()}
    print(f"  verify_commit (default verifier): passes; first {first_ms:.1f} ms; p50 "
          f"{p50:.1f} ms over {WINDOW_REPS}; device dispatch p50 "
          f"{part_ms['verify.dispatch']:.3f} ms, audit p50 {part_ms['verify.audit']:.1f} ms "
          f"({audited / (WINDOW_REPS + 1):.0f} lanes a call); launches {launches}; "
          f"no fallback; breaker closed", flush=True)
    return {"first_ms": first_ms, "p50_ms": p50, **part_ms}


def phase_mixed(root) -> dict:
    phase(f"mixed path: {N_MIXED}-validator ed25519 + secp256k1 commit")
    t0 = time.perf_counter()
    sc_ = tc.build_commit(N_MIXED, key_type="mixed")
    kinds = [type(v.pub_key) for v in sc_.valset.validators]
    n_secp = kinds.count(PubKeySecp256k1)
    print(f"  built and signed in {time.perf_counter() - t0:.1f} s: {n_secp} secp256k1, "
          f"{N_MIXED - n_secp} ed25519 keys", flush=True)
    rows = [kinds.index(PubKeySecp256k1), kinds.index(PubKeyEd25519)]
    run = drive_commit(sc_, TorchBatchVerifier(), rows)
    for name in KERNELS:
        check(run["launches"][name] > 0, f"kernel {name} was not launched on the mixed path")

    # the same commit once through the configuration root's guarded verifier
    before = fallbacks()
    reset_launches()
    t0 = time.perf_counter()
    sc_.valset.verify_commit(sc_.chain_id, sc_.block_id, sc_.height, sc_.commit,
                             verifier=root.verifier)
    guarded_ms = (time.perf_counter() - t0) * 1e3
    guarded = read_launches()
    for name in KERNELS:
        check(guarded[name] == 1, f"guarded mixed commit launched {name} {guarded[name]} times")
    check_guard_clean(before, "guarded mixed commit")
    print(f"  guarded verifier (configuration root): passes in {guarded_ms:.1f} ms; launches "
          f"{guarded}; no fallback; guard {root.verifier.snapshot()}", flush=True)
    return run


def span_seconds(names) -> dict:
    """Seconds per span name in the tracer's ring since its last reset."""
    out = {n: 0.0 for n in names}
    for ev in trace.export():
        if ev.get("ph") == "X" and ev["name"] in out:
            out[ev["name"]] += ev["dur"] / 1e6
    return out


def drive_window(votes, powers, totals, use_device: bool, n_groups: int):
    """verify_window on one route: a first call with the launch counts set
    to 0 just before and read just after (K1 and K2 once per message-length
    group), then WINDOW_ROUTE_REPS timed calls, each traced; returns the first
    verdict, the launches, the p50 wall and the p50 of each span."""
    spans = ("planner.pack", "planner.pack_device", "planner.dispatch", "planner.audit",
             "verify.dispatch", "verify.audit")
    reset_launches()
    planner.tally_launches["planner_tally"] = 0
    t0 = time.perf_counter()
    verdict = planner.verify_window(votes, powers, totals, use_device=use_device)
    first_s = time.perf_counter() - t0
    launches = {**read_launches(), **planner.tally_launches}
    for name in ("ed25519_prologue", "ed25519_ladder"):
        check(launches[name] == n_groups, f"window route use_device={use_device}: {name} "
              f"launched {launches[name]} times, want {n_groups}")
    check(launches["secp256k1_ladder"] == 0, "K3 launched on an ed25519 window")
    check(launches["planner_tally"] == (1 if use_device else 0),
          f"tally launches {launches['planner_tally']}")
    walls, parts = [], {n: [] for n in spans}
    trace.enable()
    try:
        for _ in range(WINDOW_ROUTE_REPS):
            trace.reset()
            t0 = time.perf_counter()
            again = planner.verify_window(votes, powers, totals, use_device=use_device)
            walls.append(time.perf_counter() - t0)
            for n, v in span_seconds(spans).items():
                parts[n].append(v)
            for k in ("ok", "tally", "committed", "sigs_ok"):
                check(np.array_equal(getattr(again, k), getattr(verdict, k)),
                      f"window {k} changed between calls")
    finally:
        trace.disable()
    return verdict, launches, first_s, statistics.median(walls), {
        n: statistics.median(v) for n, v in parts.items() if any(v)}


def phase_window(root, dev, err: dict) -> dict:
    phase(f"window: {WINDOW_H} heights x {WINDOW_V} validators through the planner, "
          f"both routes")
    t0 = time.perf_counter()
    win = tw.build_window(WINDOW_H, WINDOW_V, seed=7)
    print(f"  built and signed {WINDOW_H * WINDOW_V} precommits in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # planted faults: at V = 64, 21 dropped precommits leave 430 of 640
    # (> 426.67: commits), 22 leave 420 (does not)
    hs = [WINDOW_H * k // 6 for k in range(1, 6)]  # 85, 170, 256, 341, 426 at H = 512
    most = -(-WINDOW_V // 3) - 1  # the most precommits a height may miss and commit
    tw.flip_bit(win, hs[0], WINDOW_V // 9)
    tw.drop_precommits(win, hs[1], most)
    tw.drop_precommits(win, hs[2], most + 1)
    tw.short_signature(win, hs[3], WINDOW_V // 13)
    tw.absent_height(win, hs[4])
    t0 = time.perf_counter()
    votes, powers, totals = win.rows()
    rows_ms = (time.perf_counter() - t0) * 1e3
    want = tw.expected(win)
    check(bool(want["committed"][hs[1]]) and not want["committed"][hs[2]],
          "quorum construction")
    print(f"  faults: a flipped bit at height {hs[0]}, {most} and {most + 1} dropped precommits "
          f"at {hs[1]} and {hs[2]}, a 63-byte signature at {hs[3]}, all absent at {hs[4]}",
          flush=True)

    plan = planner.plan_window(votes, powers, totals)
    n_groups = n_length_groups(votes)
    before = fallbacks()
    audit_ok0 = audits("ok")
    results = {}
    for route, use_device in (("device", True), ("verifier", False)):
        verdict, launches, first_s, p50, parts = drive_window(
            votes, powers, totals, use_device, n_groups)
        for k in ("ok", "tally", "committed", "sigs_ok"):
            check(np.array_equal(getattr(verdict, k), want[k]),
                  f"{route} route: {k} differs from the construction")
        results[route] = {"verdict": verdict, "launches": launches, "first_s": first_s,
                          "p50_s": p50, "parts": parts}
        print(f"  {route} route: first {first_s * 1e3:.1f} ms; p50 {p50 * 1e3:.1f} ms over "
              f"{WINDOW_ROUTE_REPS}; launches {launches}; breakdown (p50 s) "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
    a, b = results["device"]["verdict"], results["verifier"]["verdict"]
    for k in ("ok", "tally", "committed", "sigs_ok"):
        check(np.array_equal(getattr(a, k), getattr(b, k)), f"routes differ on {k}")
    check_guard_clean(before, "window")
    check(audits("ok") > audit_ok0, "no audited lane on the window")
    print(f"  both routes equal each other and the construction: {int(want['committed'].sum())} "
          f"of {WINDOW_H} heights commit, {int((~want['sigs_ok']).sum())} with a bad signature; "
          f"no fallback; breaker closed; audit ok {audits('ok') - audit_ok0:.0f} lanes, "
          f"0 mismatches", flush=True)

    rng = np.random.default_rng(11)
    coords = np.argwhere([[pc is not None for pc in c.precommits] for c in win.commits])
    for h, v in coords[rng.choice(len(coords), min(ORACLE_LANES, len(coords)), replace=False)]:
        pub, msg, sig = votes[h][v]
        check(bool(a.ok[h, v]) == ed._verify_pure(pub.bytes(), msg, sig),
              f"window lane ({h}, {v}) differs from the oracle")
    print(f"  {ORACLE_LANES} sampled present lanes equal _verify_pure", flush=True)

    # the device route's inputs at the window's shapes: K1, K2, the tally
    t0 = time.perf_counter()
    pack = planner.pack_device(plan, dev)
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) * 1e3
    B, S = pack.shape
    lanes, m, inputs = pack.groups[0]
    vwords = inputs[7]
    b, k1_in, k2_in = hold_k1_k2(inputs, err, "window")
    k1_ms = cuda_ms(lambda: ec.prologue(*k1_in))
    k2_ms = cuda_ms(lambda: ec.ladder(*k2_in))
    ok = planner._planner_step(pack, "host")
    t_in = (ok, pack.power, pack.is_vote, pack.seg_ids, pack.totals)
    t_out = planner.segment_tally(*t_in)
    ok_l = ok.cpu().numpy()[:plan.n_lanes]
    want_t = planner._host_reduce(plan, ok_l)
    got_t = [t.cpu().numpy()[:plan.H] for t in t_out]
    tally_err = max(int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max(initial=0))
                    for g, w in zip(got_t, want_t))
    check(tally_err == 0, f"the device tally differs from _host_reduce by {tally_err}")
    tally_ms = cuda_ms(lambda: planner.segment_tally(*t_in))
    reduce_ms = host_p50_ms(lambda: planner._host_reduce(plan, ok_l))
    tally_bound_ms = (nbytes(t_in) + nbytes(t_out)) / HBM_BYTES_PER_S * 1e3
    print(f"  lanes {plan.n_lanes} in bucket B = {B}, segments S = {S}; {n_groups} message-length "
          f"group(s), K1/K2 b = {b}, vwords {tuple(vwords.shape)}; rows() {rows_ms:.1f} ms; "
          f"pack_device (key caches warm) {pack_ms:.1f} ms", flush=True)
    print(f"  K1 {k1_ms:.4f} ms and K2 {k2_ms:.4f} ms at b = {b} (exact against their plain "
          f"versions); tally {tally_ms:.4f} ms against a byte bound of {tally_bound_ms:.6f} ms "
          f"at 3.35 TB/s (int64 index_add_, exact against _host_reduce, {reduce_ms:.3f} ms on "
          f"the host)", flush=True)
    return {
        "routes": {r: {k: v for k, v in res.items() if k != "verdict"}
                   for r, res in results.items()},
        "win": win, "rows": (votes, powers, totals), "verdict": a, "fault_heights": hs,
        "k1_ms": k1_ms, "k2_ms": k2_ms, "b": b,
        "tally": {"name": "planner_tally", "route": "torch",
                  "source": "tendermint_tpu_torch/parallel/planner.py",
                  "replaces": "tendermint_tpu/parallel/planner.py:433",
                  "launches": results["device"]["launches"]["planner_tally"],
                  "max_abs_err": tally_err, "ms": tally_ms, "plain_ms": reduce_ms,
                  "bound_ms": tally_bound_ms,
                  "bound_by": "bytes", "B": B, "S": S},
    }


VERDICT_KEYS = ("ok", "tally", "committed", "sigs_ok")


def n_length_groups(votes) -> int:
    """Message-length groups of a window's wellformed lanes: the device
    route launches K1 and K2 once for each."""
    plan = planner.plan_window(votes, [[0] * len(r) for r in votes], [0] * len(votes))
    return len({len(plan.msgs[j]) for j in np.flatnonzero(plan.wellformed)})


def backfill_specs(votes, powers, totals):
    """State sync's sub-windows, generated as statesync/syncer.py does."""
    for s in range(0, len(votes), BACKFILL_SUBWINDOW):
        e = s + BACKFILL_SUBWINDOW
        yield votes[s:e], powers[s:e], totals[s:e]


def run_pipeline(specs):
    it = planner.WindowPipeline(use_device=True, depth=planner.pipeline_depth()).run(specs)
    try:
        return list(it)
    finally:
        it.close()


def phase_backfill(window, err: dict) -> dict:
    votes, powers, totals = window["rows"]
    n_sub = -(-len(votes) // BACKFILL_SUBWINDOW)
    phase(f"backfill: the {len(votes)}-height window as {n_sub} sub-windows of "
          f"{BACKFILL_SUBWINDOW} heights through WindowPipeline (depth "
          f"{planner.pipeline_depth()})")
    groups = sum(n_length_groups(v) for v, _, _ in backfill_specs(votes, powers, totals))
    before = fallbacks()
    audit_ok0 = audits("ok")
    reset_launches()
    planner.tally_launches["planner_tally"] = 0
    t0 = time.perf_counter()
    with captured_packs() as packs:
        verdicts = run_pipeline(backfill_specs(votes, powers, totals))
    first_s = time.perf_counter() - t0
    launches = {**read_launches(), **planner.tally_launches}
    b, _, _ = hold_k1_k2(packs[0], err, "backfill")
    check(len(verdicts) == n_sub, f"{len(verdicts)} sub-window verdicts, want {n_sub}")
    for name in ("ed25519_prologue", "ed25519_ladder"):
        check(launches[name] == groups, f"backfill launched {name} {launches[name]} times, "
              f"want {groups} (one a sub-window and message-length group)")
    check(launches["secp256k1_ladder"] == 0, "K3 launched on the backfill")
    check(launches["planner_tally"] == n_sub, f"tally launches {launches['planner_tally']}")
    want = window["verdict"]
    for k in VERDICT_KEYS:
        got = np.concatenate([getattr(v, k) for v in verdicts])
        check(np.array_equal(got, getattr(want, k)),
              f"backfill {k} differs from the window's verify_window verdict")
    spans = ("planner.pack", "planner.pack_device", "planner.dispatch", "planner.audit")
    walls, parts = [], {n: [] for n in spans}
    trace.enable()
    try:
        for _ in range(WINDOW_ROUTE_REPS):
            trace.reset()
            t0 = time.perf_counter()
            again = run_pipeline(backfill_specs(votes, powers, totals))
            walls.append(time.perf_counter() - t0)
            for n, v in span_seconds(spans).items():
                parts[n].append(v)
            for k in VERDICT_KEYS:
                check(all(np.array_equal(getattr(a, k), getattr(b, k))
                          for a, b in zip(again, verdicts)), f"backfill {k} changed")
    finally:
        trace.disable()
    check_guard_clean(before, "backfill")
    check(audits("ok") > audit_ok0, "no audited lane on the backfill")
    p50 = statistics.median(walls)
    part_s = {n: statistics.median(v) for n, v in parts.items()}
    flat = window["routes"]["device"]["p50_s"]
    print(f"  {n_sub} verdicts equal the window's; first {first_s * 1e3:.1f} ms; p50 "
          f"{p50 * 1e3:.1f} ms over {WINDOW_ROUTE_REPS}, {p50 / flat - 1:+.1%} against the "
          f"flat window's device route ({flat * 1e3:.1f} ms); launches {launches}; no fallback; "
          f"breaker closed", flush=True)
    print(f"  K1/K2 exact against their plain versions on the first sub-window's launch "
          f"inputs, b = {b}", flush=True)
    print(f"  spans (p50 of the sums over a call, each including its waits for the "
          f"interpreter lock): plan in the worker (planner.pack) "
          f"{part_s['planner.pack'] * 1e3:.1f} ms; in the guarded executor, pack + upload "
          f"(planner.pack_device) {part_s['planner.pack_device'] * 1e3:.1f} ms and dispatch "
          f"(planner.dispatch) {part_s['planner.dispatch'] * 1e3:.1f} ms; audit "
          f"(planner.audit) {part_s['planner.audit'] * 1e3:.1f} ms; plan + pack "
          f"{(part_s['planner.pack'] + part_s['planner.pack_device']) * 1e3:.1f} ms and all four "
          f"{sum(part_s.values()) * 1e3:.1f} ms against the wall {p50 * 1e3:.1f} ms",
          flush=True)
    return {"first_s": first_s, "p50_s": p50, "parts": part_s, "launches": launches}


def rpc_burst(rows, totals, heights):
    """One burst: a thread per height submits its row to one fresh LaneFeed
    on its defaults, all released together; returns (verdicts, wall s,
    feed)."""
    feed = planner.LaneFeed(profile_kind="rpc_lane_feed")
    out = [None] * len(heights)
    errors = []
    gate = threading.Barrier(len(heights) + 1)

    def query(i, h):
        try:
            vrow, prow = rows[h]
            gate.wait(RESULT_TIMEOUT)
            out[i] = feed.submit(vrow, prow, totals[h]).result(RESULT_TIMEOUT)
        except BaseException as e:  # reported by the caller
            errors.append(e)

    ts = [threading.Thread(target=query, args=(i, h)) for i, h in enumerate(heights)]
    try:
        for t in ts:
            t.start()
        gate.wait(RESULT_TIMEOUT)
        t0 = time.perf_counter()
        for t in ts:
            t.join(RESULT_TIMEOUT)
        wall = time.perf_counter() - t0
    finally:
        feed.close()
    check(not errors, f"rpc query failed: {errors[:1]}")
    check(not any(t.is_alive() for t in ts), "an rpc query did not finish")
    return out, wall, feed


def commit_outcome(fn):
    try:
        fn()
    except CommitError as e:
        return str(e)
    return None


def phase_rpc(root, window, err: dict) -> dict:
    phase(f"rpc: a burst of {RPC_ROWS} concurrent ?verify=1 rows through one LaneFeed, then "
          f"{RPC_COMMITS} concurrent verify_commit calls through BatchingVerifier")
    votes, powers, totals = window["rows"]
    want = window["verdict"]
    rows = list(zip(votes, powers))
    heights = list(range(RPC_ROWS))
    groups = n_length_groups([votes[h] for h in heights])
    before = fallbacks()
    reset_launches()
    with captured_packs() as packs:
        got, first_wall, feed = rpc_burst(rows, totals, heights)
    launches = read_launches()
    b, _, _ = hold_k1_k2(packs[0], err, "rpc burst")
    for i, h in enumerate(heights):
        v = got[i]
        check(np.array_equal(v.ok, want.ok[h, :len(votes[h])]) and v.tally == want.tally[h]
              and v.committed == bool(want.committed[h]) and v.sigs_ok == bool(want.sigs_ok[h]),
              f"rpc row {h} differs from the window's verdict")
    for name in ("ed25519_prologue", "ed25519_ladder"):
        check(launches[name] == groups * feed.dispatches,
              f"rpc burst launched {name} {launches[name]} times for {feed.dispatches} dispatches")
    check(launches["secp256k1_ladder"] == 0, "K3 launched on the rpc burst")
    shapes = [(feed.dispatches, feed.windows_out)]
    walls, audit_s = [], []
    trace.enable()
    try:
        for _ in range(WINDOW_REPS):
            trace.reset()
            again, wall, f = rpc_burst(rows, totals, heights)
            walls.append(wall)
            audit_s.append(span_seconds(("verify.audit",))["verify.audit"])
            shapes.append((f.dispatches, f.windows_out))
            check(all(np.array_equal(a.ok, b.ok) for a, b in zip(again, got)),
                  "rpc verdicts changed between bursts")
    finally:
        trace.disable()
    check_guard_clean(before, "rpc burst")
    p50 = statistics.median(walls)
    print(f"  {RPC_ROWS} row verdicts equal the window's; first burst {first_wall * 1e3:.1f} ms; "
          f"p50 {p50 * 1e3:.1f} ms over {WINDOW_REPS}, audit (verify.audit) p50 "
          f"{statistics.median(audit_s) * 1e3:.1f} ms; (dispatches, windows_out) per burst "
          f"{shapes}; first burst's launches {launches}; no fallback; breaker closed",
          flush=True)
    print(f"  K1/K2 exact against their plain versions on the first feed dispatch's launch "
          f"inputs, b = {b}", flush=True)

    # concurrent commits through one BatchingVerifier: each ends as a direct
    # verify_commit on the same commit does (returns, or the same error)
    win = window["win"]
    hs = window["fault_heights"]
    # clean heights, and the flipped bit, the two drops and the 63-byte
    # signature of phase 10 (not its all-absent height: no commit to check)
    cases = sorted({0, 1, *hs[:4], len(votes) // 5, len(votes) // 2 + 1})[:RPC_COMMITS]

    def verify(h, verifier):
        return commit_outcome(lambda: win.valset.verify_commit(
            win.chain_id, win.block_ids[h], win.height0 + h, win.commits[h], verifier=verifier))

    direct = [verify(h, root.verifier) for h in cases]
    feed = planner.LaneFeed(profile_kind="rpc_lane_feed")
    bv = BatchingVerifier(feed, result_timeout=RESULT_TIMEOUT)
    batched = [None] * len(cases)

    def run(i):
        batched[i] = verify(cases[i], bv)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(cases))]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(RESULT_TIMEOUT)
    finally:
        feed.close()
    check(not any(t.is_alive() for t in ts), "a verify_commit through the feed did not finish")
    check(batched == direct, f"BatchingVerifier outcomes {batched} != direct {direct}")
    check(any(d is None for d in direct) and any(d is not None for d in direct),
          "the commit cases should both pass and fail")
    check_guard_clean(before, "BatchingVerifier commits")
    print(f"  {len(cases)} verify_commit calls at heights {cases} through BatchingVerifier end as "
          f"direct calls do: {direct}; feed rows {feed.rows_in}, dispatches {feed.dispatches}",
          flush=True)
    return {"first_s": first_wall, "p50_s": p50, "launches": launches, "shapes": shapes}


def drive_multisig(ms, verifier, n_sigs: int, what: str, err: dict):
    """verify_generic over the multisig set: one first call with the launch
    counts set to 0 just before and read just after (K1 and K2 once), K1
    and K2 then held against their plain versions on that launch's inputs,
    then WINDOW_REPS traced calls; returns the launches, first and p50 ms,
    the p50 audit ms and the launch's b."""
    reset_launches()
    t0 = time.perf_counter()
    with captured_packs() as packs:
        ok = verify_generic(ms.pubkeys, ms.msgs, ms.sigs, verifier=verifier)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    b, _, _ = hold_k1_k2(packs[0], err, what)
    check(bool(ok.all()), f"{what}: {int((~ok).sum())} valid aggregates rejected")
    for name in ("ed25519_prologue", "ed25519_ladder"):
        check(launches[name] == 1, f"{what}: {name} launched {launches[name]} times for "
              f"{n_sigs} sub-signatures, want 1")
    check(launches["secp256k1_ladder"] == 0, f"{what}: K3 launched")
    walls, audit_ms = [], []
    trace.enable()
    try:
        for _ in range(WINDOW_REPS):
            trace.reset()
            t0 = time.perf_counter()
            verify_generic(ms.pubkeys, ms.msgs, ms.sigs, verifier=verifier)
            walls.append(time.perf_counter() - t0)
            audit_ms.append(span_seconds(("verify.audit",))["verify.audit"] * 1e3)
    finally:
        trace.disable()
    return launches, first_ms, statistics.median(walls) * 1e3, statistics.median(audit_ms), b


def structural_fallbacks() -> float:
    return get_verify_metrics().host_fallback._values.get(("multisig_structural",), 0.0)


def phase_multisig(root, err: dict) -> dict:
    phase(f"multisig: {MULTISIG_VALS} validators, each a {tm.K}-of-{tm.N_KEYS} ed25519 "
          f"threshold key, through verify_generic")
    t0 = time.perf_counter()
    ms = tm.build(MULTISIG_VALS)
    print(f"  built and signed in {time.perf_counter() - t0:.1f} s", flush=True)
    n_sigs = MULTISIG_VALS * tm.K
    before = fallbacks()
    plain = drive_multisig(ms, TorchBatchVerifier(), n_sigs, "TorchBatchVerifier", err)
    guarded = drive_multisig(ms, root.verifier, n_sigs, "guarded verifier", err)
    flatten_ms = host_p50_ms(lambda: [pk.flatten(m, s) for pk, m, s in
                                      zip(ms.pubkeys, ms.msgs, ms.sigs)])
    flip, below = MULTISIG_VALS // 3, 2 * MULTISIG_VALS // 3
    sigs = list(ms.sigs)
    sigs[flip] = tm.flip_sub_signature(sigs[flip], 1)
    sigs[below] = tm.below_threshold(sigs[below])
    s0 = structural_fallbacks()
    reset_launches()
    got = verify_generic(ms.pubkeys, ms.msgs, sigs, verifier=root.verifier)
    faulted = read_launches()
    check(np.flatnonzero(~got).tolist() == [flip, below],
          f"rejected rows {np.flatnonzero(~got).tolist()}, want {[flip, below]}")
    check(structural_fallbacks() == s0 + 1, "multisig_structural did not rise by 1")
    check(faulted["ed25519_prologue"] == faulted["ed25519_ladder"] == 1,
          f"faulted call launches {faulted}")
    check_guard_clean(before, "multisig")
    print(f"  TorchBatchVerifier(): all {MULTISIG_VALS} accept; {n_sigs} sub-signatures in one call, "
          f"launches {plain[0]}; first {plain[1]:.1f} ms, p50 {plain[2]:.1f} ms over "
          f"{WINDOW_REPS}; K1/K2 exact against their plain versions on its launch inputs, "
          f"b = {plain[4]}", flush=True)
    print(f"  guarded verifier (configuration root): all accept, launches {guarded[0]}; first "
          f"{guarded[1]:.1f} ms, p50 {guarded[2]:.1f} ms, audit (verify.audit) p50 "
          f"{guarded[3]:.1f} ms; flatten and unmarshal on the host p50 {flatten_ms:.1f} ms",
          flush=True)
    print(f"  a flipped sub-signature (row {flip}) and an aggregate below its threshold (row "
          f"{below}) reject, nothing else; multisig_structural +1; launches {faulted}; no "
          f"fallback; breaker closed", flush=True)
    return {"plain": plain, "guarded": guarded, "flatten_ms": flatten_ms}


def lite_metric_counts() -> dict:
    m = get_frontend_metrics()
    ev = m.cache_events._values
    return {"hit": ev.get(("hit",), 0.0), "miss": ev.get(("miss",), 0.0),
            "wait": ev.get(("wait",), 0.0),
            "heights_verified": m.heights_verified._values.get((), 0.0)}


def serial_lite(chain, heights_b, heights_a) -> dict:
    """The serial reference: ONE port DynamicVerifier on HostBatchVerifier,
    seeded at height 1, certifying (b)'s heights in ascending order, then
    (a)'s. Returns the certified FullCommit bytes by height and the trust
    frontier after each shape's heights."""
    src = chain.provider()
    dv = DynamicVerifier(chain.chain_id, DBProvider(MemDB()), src,
                         batch_verifier=HostBatchVerifier())
    dv.init_from_full_commit(src.full_commit_at(chain.chain_id, 1))
    out = {"bytes": {}}
    for shape, heights in (("b", heights_b), ("a", heights_a)):
        for h in sorted(set(heights)):
            fc = src.full_commit_at(chain.chain_id, h)
            dv.verify(fc.signed_header)
            out["bytes"][h] = fc.marshal()
        out[shape] = dv.trusted.latest_full_commit(chain.chain_id, 1, 1 << 60).height
    return out


def pinned_proxy(chain, source=None) -> LiteProxy:
    """A LiteProxy over the chain (or ``source``), pinned at height 1."""
    return LiteProxy(chain.chain_id, source=source or chain.provider(), trusted_height=1,
                     trusted_hash=chain.full_commit(1).signed_header.header.hash())


@contextlib.contextmanager
def served_proxy(chain):
    """A pinned LiteProxy served on 127.0.0.1; shut down and closed on exit."""
    proxy = pinned_proxy(chain)
    httpd = serve_proxy(proxy, "127.0.0.1:0")
    t = threading.Thread(target=httpd.serve_forever, name="lite-proxy", daemon=True)
    t.start()
    try:
        yield proxy, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        proxy.close()
        t.join(RESULT_TIMEOUT)


def lite_get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=RESULT_TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def drive_lite_shape(chain, serial, plans, frontier: int, err: dict, what: str) -> dict:
    """One traffic shape on a fresh proxy: client i GETs /verify_commit and
    /light_block for each height of plans[i], all clients released
    together. Every answer is certified, every light_block equals the
    serial reference's bytes, the trust frontier equals the serial one,
    K1 and K2 launched and exact on one launch's inputs, the guard clean.
    Returns the shape's numbers."""
    before = fallbacks()
    counts0 = lite_metric_counts()
    lat, bad, errors = [], [], []
    gate = threading.Barrier(len(plans) + 1)
    with served_proxy(chain) as (proxy, port):

        def client(heights):
            try:
                gate.wait(RESULT_TIMEOUT)
                for h in heights:
                    for route in ("verify_commit", "light_block"):
                        t0 = time.perf_counter()
                        code, body = lite_get(port, f"/{route}?height={h}")
                        lat.append(time.perf_counter() - t0)
                        if code != 200:
                            bad.append((route, h, code, body))
                        elif route == "light_block" and base64.b64decode(
                                body["result"]["full_commit"]) != serial["bytes"][h]:
                            bad.append((route, h, "bytes differ from the serial reference"))
                        elif route == "verify_commit" and body["result"]["height"] != h:
                            bad.append((route, h, body))
            except BaseException as e:  # reported below
                errors.append(e)

        ts = [threading.Thread(target=client, args=(hs,)) for hs in plans]
        for t in ts:
            t.start()
        reset_launches()
        trace.enable()
        trace.reset(1 << 17)
        try:
            with captured_packs() as packs:
                gate.wait(RESULT_TIMEOUT)
                t0 = time.perf_counter()
                for t in ts:
                    t.join(RESULT_TIMEOUT)
                wall = time.perf_counter() - t0
            launches = read_launches()
            spans = span_seconds(("verify.audit", "verify.dispatch", "frontend.certify"))
            dropped = trace.dropped()
        finally:
            trace.disable()
        check(not errors and not any(t.is_alive() for t in ts),
              f"{what}: a client failed or hung: {errors[:1]}")
        check(not bad, f"{what}: {len(bad)} bad answers, first {bad[:1]}")
        got_frontier = proxy.trusted.latest_full_commit(chain.chain_id, 1, 1 << 60).height
        check(got_frontier == frontier,
              f"{what}: trust frontier {got_frontier}, serial reference {frontier}")
        stats = proxy.stats()
    for name in ("ed25519_prologue", "ed25519_ladder"):
        check(launches[name] >= 1, f"{what}: {name} was not launched")
    check(launches["secp256k1_ladder"] == 0, f"{what}: K3 launched")
    b, _, _ = hold_k1_k2(packs[0], err, what)
    check_guard_clean(before, what)
    counts = {k: v - counts0[k] for k, v in lite_metric_counts().items()}
    lat_ms = np.asarray(lat) * 1e3
    headers = sum(len(hs) for hs in plans)
    out = {"wall_s": wall, "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)), "requests": len(lat),
           "headers_per_s": headers / wall, "stats": stats, "cache": counts,
           "spans": spans, "launches": launches, "b": b, "frontier": got_frontier,
           "groups": len(packs), "trace_dropped": dropped}
    print(f"  {what}: {len(plans)} clients, {len(lat)} requests, {headers} certified headers "
          f"in {wall * 1e3:.1f} ms ({headers / wall:.1f} headers a second); latency p50 "
          f"{out['p50_ms']:.1f} ms, p99 {out['p99_ms']:.1f} ms; the audit (one feed worker) "
          f"{spans['verify.audit'] / wall:.1%} of the wall", flush=True)
    print(f"    stats {json.dumps(stats)}; cache hit/miss/wait {counts['hit']:.0f}/"
          f"{counts['miss']:.0f}/{counts['wait']:.0f}; heights_verified "
          f"{counts['heights_verified']:.0f}; spans verify.audit {spans['verify.audit'] * 1e3:.1f} "
          f"ms, verify.dispatch {spans['verify.dispatch'] * 1e3:.1f} ms, frontend.certify "
          f"{spans['frontend.certify'] * 1e3:.1f} ms (summed over threads; {dropped} dropped)",
          flush=True)
    print(f"    launches {launches} ({len(packs)} message-length groups packed); frontier "
          f"{got_frontier} = the serial reference's; light_block bytes equal its; K1/K2 exact "
          f"on the first launch's inputs, b = {b}; no fallback; breaker closed", flush=True)
    return out


def lite_rejection(chain, doctor, heights, err_type, match: str, what: str) -> None:
    """LITE_REJECT_CLIENTS concurrent clients certify ``heights`` through a
    proxy over a doctoring source: each gets ``err_type`` matching
    ``match``; afterwards nothing is cached and nothing beyond the pin is
    trusted."""
    before = fallbacks()
    proxy = pinned_proxy(chain, lc.DoctoringProvider(chain.provider(), doctor))
    try:
        got = [None] * len(heights)

        def client(i):
            try:
                proxy.certified_commit(heights[i])
            except BaseException as e:  # checked below
                got[i] = e

        ts = [threading.Thread(target=client, args=(i,)) for i in range(len(heights))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(RESULT_TIMEOUT)
        check(not any(t.is_alive() for t in ts), f"{what}: a client hung")
        for e in got:
            check(isinstance(e, err_type) and match in str(e),
                  f"{what}: got {e!r}, want {err_type.__name__} matching {match!r}")
        check(len(proxy.frontend.cache) == 0, f"{what}: a failed certification was cached")
        top = proxy.trusted.latest_full_commit(chain.chain_id, 1, 1 << 60).height
        check(top == 1, f"{what}: trust reached height {top}")
    finally:
        proxy.close()
    check_guard_clean(before, what)
    print(f"  {what}: {len(heights)} concurrent clients at heights {heights} each got "
          f"{err_type.__name__} ({match!r}); nothing cached, nothing trusted past the pin",
          flush=True)


def phase_lite(root, err: dict) -> dict:
    phase(f"lite: a {LITE_VALS}-validator, {LITE_HEIGHTS}-height chain (34 of 100 replaced at "
          f"{LITE_CHANGES}) through LiteProxy + serve_proxy, the frontend's feed over the "
          f"root's guarded verifier")
    check(get_batch_verifier() is root.verifier,
          "the default verifier is not the configuration root's guarded one")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    chain = lc.build_lite_chain(LITE_VALS, LITE_HEIGHTS, change_heights=LITE_CHANGES,
                                n_change=LITE_CHANGE_N, seed=LITE_SEED)
    print(f"  built and signed {LITE_VALS * LITE_HEIGHTS} precommits in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tips = list(range(LITE_HEIGHTS - LITE_TIPS + 1, LITE_HEIGHTS + 1))
    # (a) as scripts/bench_lite.py: each client the last heights, rotated
    plan_a = [tips[i % LITE_TIPS:] + tips[:i % LITE_TIPS] for i in range(LITE_CLIENTS)]
    rng = np.random.default_rng(LITE_SEED)
    plan_b = [[int(h)] for h in rng.integers(2, LITE_HEIGHTS + 1, LITE_CLIENTS)]
    t0 = time.perf_counter()
    serial = serial_lite(chain, [hs[0] for hs in plan_b], tips)
    print(f"  serial reference (one DynamicVerifier on HostBatchVerifier): "
          f"{len(serial['bytes'])} heights certified in {time.perf_counter() - t0:.1f} s; "
          f"frontiers {serial['b']} / {serial['a']}", flush=True)
    shape_a = drive_lite_shape(chain, serial, plan_a, serial["a"], err, "(a) tip burst")
    shape_b = drive_lite_shape(chain, serial, plan_b, serial["b"], err, "(b) scattered")
    strangers = lc.stranger_set(LITE_VALS, seed=LITE_SEED + 1)

    def swap_valset(h, fc):
        if h >= LITE_STRANGER_FROM:
            fc.validators = strangers
        return fc

    lite_rejection(chain, swap_valset, np.linspace(
        LITE_STRANGER_FROM, LITE_HEIGHTS, LITE_REJECT_CLIENTS).astype(int).tolist(),
        LiteError, "validators_hash", f"stranger set from height {LITE_STRANGER_FROM}")
    keep = 2 * LITE_VALS // 3  # 66 of 100 equal powers: not above 2/3
    lite_rejection(chain, lambda h, fc: lc.strip_precommits(fc, range(keep, LITE_VALS))
                   if h == LITE_STRIPPED else fc, [LITE_STRIPPED] * LITE_REJECT_CLIENTS,
                   CommitError, "voting power",
                   f"commit at height {LITE_STRIPPED} stripped below 2/3")
    mid = (1 + LITE_HEIGHTS) // 2  # the first bisection midpoint from the pin
    lite_rejection(chain, lambda h, fc: lc.flip_signature_bit(fc, 0) if h == mid else fc,
                   [LITE_HEIGHTS - 1, LITE_HEIGHTS] * (LITE_REJECT_CLIENTS // 2), CommitError,
                   "invalid signature", f"a flipped signature bit at midpoint {mid}")
    seconds = time.perf_counter() - t_phase
    print(f"  lite phase {seconds:.1f} s", flush=True)
    return {"a": shape_a, "b": shape_b, "seconds": seconds}


@contextlib.contextmanager
def captured_k3():
    """Record the K3 inputs of every secp256k1 batch uploaded while active
    (``secp256k1_cuda.upload``, which ``verify_batch`` calls once a
    launch). Records only; launches nothing."""
    ins, real = [], sc.upload

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        ins.append(out)
        return out

    sc.upload = record
    try:
        yield ins
    finally:
        sc.upload = real


def hold_k3(ins, err: dict, what: str) -> int:
    """K3 on one launch's inputs against its plain version, exact; the
    difference folds into ``err``. Returns the launch's b."""
    worst = max_abs_diff(sc.ladder(*ins), sc.ladder_ref(*ins))
    err["secp256k1_ladder"] = max(err["secp256k1_ladder"], worst)
    check(worst == 0, f"{what}: K3 differs from its plain version: {worst}")
    return ins[1].shape[1]


def vote_commit_check(sets, what: str) -> None:
    """The round-1 precommit set's commit passes verify_commit on the
    root's guarded verifier; with one precommit's signature bit flipped it
    is rejected."""
    vset = sets[(1, SignedMsgType.PRECOMMIT)]
    commit = vset.make_commit()
    verify = lambda c: vset.val_set.verify_commit(  # noqa: E731
        vset.chain_id, commit.block_id, vset.height, c)
    verify(commit)
    i = next(j for j, pc in enumerate(commit.precommits)
             if pc is not None and pc.block_id == commit.block_id)
    sig = commit.precommits[i].signature
    bad = tc.flip_signature_bit(commit, i, 300 if len(sig) == 64 else 8 * (len(sig) - 1))
    expect_commit_error(lambda: verify(bad), "invalid signature")
    print(f"  {what}: make_commit() of the round-1 precommits passes verify_commit "
          f"({sum(pc is not None for pc in commit.precommits)} precommits); flipped "
          f"precommit {i} rejected", flush=True)


def drive_votes(vs, waves, want, what: str, err: dict, **feed_kw) -> dict:
    """The storm through prevalidate -> VoteFeed -> add_vote(verified=True)
    on the card, wave by wave, twice (the first with launch counts set to 0
    just before and read just after, and K1/K2 (K3) held against their
    plain versions on one launch's inputs; the second traced). Outcomes,
    evidence and the final state of all four sets equal the serial run's;
    the guard stays clean."""
    n_votes = sum(len(w) for w in waves)
    before = fallbacks()
    out = {}
    for rep in range(2):
        flushes = []
        feed = planner.VoteFeed(window_s=VOTE_WINDOW_S, max_rows=VOTE_MAX_ROWS,
                                on_flush=lambda *a: flushes.append(a), **feed_kw)
        sets = tv.fresh_sets(vs)
        reset_launches()
        planner.tally_launches["planner_tally"] = 0
        if rep:
            trace.enable()
            trace.reset()
        try:
            with captured_packs() as packs, captured_k3() as k3_ins:
                t0 = time.perf_counter()
                outcomes, evidence = tv.run_batched(sets, waves, feed, timeout=RESULT_TIMEOUT)
                wall = time.perf_counter() - t0
        finally:
            feed.close()
            feed.join(RESULT_TIMEOUT)
            if rep:
                spans = span_seconds(("verify.dispatch", "verify.audit", "planner.dispatch",
                                      "planner.audit"))
                trace.disable()
        launches = {**read_launches(), **planner.tally_launches}
        check(outcomes == want["outcomes"], f"{what}: outcomes differ from the serial path's")
        check(tv.evidence_key(evidence) == want["evidence"], f"{what}: evidence differs")
        check(tv.vote_set_state(sets) == want["state"], f"{what}: vote-set state differs")
        recs = feed.flush_records()["records"]
        if rep == 0:
            out = {"first_s": wall, "launches": launches, "sets": sets,
                   "dispatches": feed.dispatches}
            check(packs, f"{what}: no ed25519 launch captured")
            b, _, _ = hold_k1_k2(packs[0], err, what)
            out["k3_b"] = hold_k3(k3_ins[0], err, what) if k3_ins else 0
            out["b"] = b
            continue
        out.update(wall_s=wall, spans=spans, feed=feed, flushes=flushes, recs=recs,
                   launches2=launches)
    check_guard_clean(before, what)
    feed, flushes, recs = out["feed"], out["flushes"], out["recs"]
    rows = [f[2] for f in flushes]
    lanes = [f[3].lanes_present for f in flushes]
    occ = [f[3].occupancy for f in flushes]
    print(f"  {what}: {n_votes} votes equal the serial path's (outcomes, evidence, four "
          f"sets); first run {out['first_s'] * 1e3:.1f} ms ({n_votes / out['first_s']:.2f} "
          f"votes/s, key caches cold), second {out['wall_s'] * 1e3:.1f} ms "
          f"({n_votes / out['wall_s']:.2f} votes/s, warm); dispatches {feed.dispatches} (first run "
          f"{out['dispatches']}), flushes {feed.flushes}; rows a dispatch {statistics.mean(rows):.2f}, lanes a dispatch "
          f"{statistics.mean(lanes):.1f}, occupancy {statistics.mean(occ):.4f}; queue wait "
          f"(flush_records) p50 {statistics.median(r['wait_mean_s'] for r in recs) * 1e3:.2f} "
          f"ms, max {max(r['wait_max_s'] for r in recs) * 1e3:.2f} ms; spans "
          f"{ {k: round(v * 1e3, 3) for k, v in out['spans'].items()} } ms; first run's "
          f"launches {out['launches']}; K1/K2 exact on one launch's inputs (b = {out['b']})"
          + (f", K3 (b = {out['k3_b']})" if out["k3_b"] else "")
          + "; no fallback; breaker closed", flush=True)
    return out


def serial_votes(vs, waves, what: str) -> dict:
    sets = tv.fresh_sets(vs)
    t0 = time.perf_counter()
    outcomes, evidence = tv.run_serial(sets, waves)
    wall = time.perf_counter() - t0
    n_votes = sum(len(w) for w in waves)
    labels = {}
    for o in outcomes:
        labels[o[0]] = labels.get(o[0], 0) + 1
    print(f"  {what} serial (VoteSet.add_vote, host verification): {n_votes} votes in "
          f"{wall * 1e3:.1f} ms, {n_votes / wall:.2f} votes/s; outcomes {labels}; "
          f"evidence pairs {len(evidence)}", flush=True)
    return {"outcomes": outcomes, "evidence": tv.evidence_key(evidence),
            "state": tv.vote_set_state(sets), "wall_s": wall, "sets": sets}


def phase_votes(root, err: dict) -> dict:
    phase(f"votes: scripts/bench_votes.py's storm, {VOTE_VALS} validators, seed {VOTE_SEED}, "
          f"{VOTE_WAVES} waves, through VoteFeed on both routes")
    check(get_batch_verifier() is root.verifier,
          "the default verifier is not the configuration root's guarded one")
    t0 = time.perf_counter()
    vs, pvs = tv.make_vals(VOTE_VALS, power=VOTE_POWER)
    waves = tv.build_storm(vs, pvs, seed=VOTE_SEED, waves=VOTE_WAVES)
    n_votes = sum(len(w) for w in waves)
    print(f"  built and signed {n_votes} votes in {time.perf_counter() - t0:.1f} s", flush=True)
    want = serial_votes(vs, waves, "ed25519 storm")
    vote_commit_check(want["sets"], "serial sets")
    runs = {}
    for route, kw in (("verifier", {}), ("executor", {"use_device": True})):
        run = drive_votes(vs, waves, want, f"route {route}", err, **kw)
        for name in ("ed25519_prologue", "ed25519_ladder"):
            check(run["launches"][name] > 0, f"route {route}: {name} not launched")
        check(run["launches"]["secp256k1_ladder"] == 0, f"route {route}: K3 launched")
        check(run["launches"]["planner_tally"] == (run["dispatches"]
                                                   if route == "executor" else 0),
              f"route {route}: tally launches {run['launches']['planner_tally']}")
        vote_commit_check(run["sets"], f"route {route}")
        runs[route] = run

    t0 = time.perf_counter()
    svs, spvs = tv.make_vals(VOTE_VALS, power=VOTE_POWER, secp_every=VOTE_SECP_EVERY)
    swaves = tv.build_storm(svs, spvs, seed=VOTE_SEED, waves=VOTE_WAVES)
    n_secp = sum(type(v.pub_key) is PubKeySecp256k1 for v in svs.validators)
    print(f"  built and signed the storm of a set with {n_secp} secp256k1 validators (every "
          f"{VOTE_SECP_EVERY}th) in {time.perf_counter() - t0:.1f} s", flush=True)
    swant = serial_votes(svs, swaves, "mixed-key storm")
    run = drive_votes(svs, swaves, swant, "mixed keys, route verifier", err)
    for name in KERNELS:
        check(run["launches"][name] > 0, f"mixed-key storm: {name} not launched")
    vote_commit_check(run["sets"], "mixed keys")
    runs["secp"] = run
    serial_rate = n_votes / want["wall_s"]
    n_mixed = sum(len(w) for w in swaves)
    rate = lambda n, r: f"{n / r['first_s']:.2f} first run, {n / r['wall_s']:.2f} warm"  # noqa: E731
    print(f"  votes {n_votes}; serial {serial_rate:.2f} votes/s; batched "
          f"{rate(n_votes, runs['verifier'])} (verifier route) and "
          f"{rate(n_votes, runs['executor'])} (executor route) votes/s; mixed keys "
          f"serial {n_mixed / swant['wall_s']:.2f}, batched {rate(n_mixed, run)} votes/s "
          f"(the warm run follows the first on the same keys)", flush=True)
    return runs


def serial_tx_verdicts(txs):
    out = []
    for tx in txs:
        item = extract_signed_tx_sig(tx)
        out.append(None if item is None else item[0].verify_bytes(item[1], item[2]))
    return out


def phase_txs(root, err: dict) -> dict:
    phase(f"txs: scripts/bench_mempool.py --signed, {TX_SENDERS} senders, {TX_N} txs in "
          f"windows of {TX_WINDOW}, then the mixed streams, through BatchTxVerifier + TxFeed")
    check(get_batch_verifier() is root.verifier,
          "the default verifier is not the configuration root's guarded one")
    t0 = time.perf_counter()
    _, txs, mixed = tv.signed_stream(TX_N, TX_SENDERS)
    stream = txs + mixed + tv.mixed_stream()
    print(f"  built and signed {len(stream)} txs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    want = serial_tx_verdicts(stream)
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial_tx_verdicts(txs)
    serial_signed_s = time.perf_counter() - t0
    before = fallbacks()
    feed = planner.TxFeed(window_s=TX_WINDOW_S, max_rows=TX_MAX_ROWS)
    ver = BatchTxVerifier(feed, extract_signed_tx_sig)
    try:
        reset_launches()
        with captured_packs() as packs, captured_k3() as k3_ins:
            got, walls = [], []
            for lo in range(0, len(stream), TX_WINDOW):
                t0 = time.perf_counter()
                got += ver(stream[lo: lo + TX_WINDOW])
                walls.append(time.perf_counter() - t0)
        launches = read_launches()
        check(got == want, "tx verdicts differ from the serial decode + verify_bytes")
        check(got[-1] is None and got.count(None) == 1, "the undecodable tx is not None")
        for name in KERNELS:
            check(launches[name] > 0, f"txs: {name} not launched")
        b, _, _ = hold_k1_k2(packs[0], err, "txs")
        k3_b = hold_k3(k3_ins[0], err, "txs")
        dispatches, rows = feed.dispatches, feed.rows_out
        accepted = [tx for tx, ok in zip(stream, got) if ok]
        hits0, submitted0 = ver.cache_hits, ver.submitted
        reset_launches()
        again = []
        for lo in range(0, len(accepted), TX_WINDOW):
            again += ver(accepted[lo: lo + TX_WINDOW])
        check(again == [True] * len(accepted), "recheck verdicts changed")
        check(ver.cache_hits - hits0 == len(accepted) and ver.submitted == submitted0,
              f"recheck: {ver.cache_hits - hits0} cache hits for {len(accepted)} txs")
        check(all(v == 0 for v in read_launches().values()), "the recheck launched a kernel")
        check(feed.dispatches == dispatches, "the recheck dispatched")
        check(ver.feed_errors == 0, f"feed errors {ver.feed_errors}")
    finally:
        feed.close()
        feed.join(RESULT_TIMEOUT)
    check_guard_clean(before, "txs")
    signed_windows = TX_N // TX_WINDOW
    batched_signed_s = sum(walls[:signed_windows])
    print(f"  {len(stream)} verdicts equal a serial decode + verify_bytes ({got.count(True)} "
          f"accepted, {got.count(False)} rejected, 1 undecodable); serial {TX_N / serial_signed_s:.2f} "
          f"txs/s on the {TX_N} signed txs ({len(stream) / serial_s:.2f} on all); batched "
          f"{TX_N / batched_signed_s:.2f} txs/s ({len(stream) / sum(walls):.2f} on all); "
          f"dispatches {dispatches}, rows a dispatch {rows / dispatches:.2f}, windows "
          f"{ver.windows - len(range(0, len(accepted), TX_WINDOW))}; launches {launches}; "
          f"K1/K2 exact on one launch's inputs (b = {b}), K3 (b = {k3_b}); recheck of "
          f"{len(accepted)} accepted txs answered from the cache with no launch; no fallback; "
          f"breaker closed", flush=True)
    return {"launches": launches, "serial_txs_s": TX_N / serial_signed_s,
            "batched_txs_s": TX_N / batched_signed_s}


class NodeMempool:
    """A mempool as the node wires it (node/verify_root.mempool) over a
    started local app connection to a fresh SignedKVStoreApp: with
    ``batched`` the phase's section (the TxFeed + BatchTxVerifier hook on the
    card), else the [mempool] defaults (checktx_batch 1, no hook: the app
    verifies serially)."""

    def __init__(self, dev, batched: bool):
        self.app = SignedKVStoreApp()
        self.conn = MultiAppConn(LocalClientCreator(self.app))
        self.conn.start()
        cfg = (MempoolConfig(checktx_batch=MP_BATCH, tx_batch_window_ms=MP_WINDOW_MS,
                             tx_batch_rows=MP_ROWS) if batched else MempoolConfig())
        self.mp, self.feed, self.ver = verify_root.mempool(
            cfg, self.conn, self.app, checktx_batch_wait=MP_WAIT, device=dev)
        check((self.feed is not None) == batched, "the wiring did not follow [mempool]")

    def push(self, txs) -> tuple:
        """Every tx through check_tx, the trailing window flushed: (codes,
        seconds from the first check_tx to the last callback)."""
        codes, last = [None] * len(txs), [0.0]

        def done(i):
            def cb(res):
                codes[i] = res.code
                last[0] = time.perf_counter()
            return cb

        t0 = time.perf_counter()
        for i, tx in enumerate(txs):
            try:
                self.mp.check_tx(tx, done(i))
            except MempoolError:
                codes[i] = -1
        self.mp._flush_checktx_batch()
        deadline = time.perf_counter() + RESULT_TIMEOUT
        while any(c is None for c in codes):
            check(time.perf_counter() < deadline, "CheckTx callbacks did not settle")
            time.sleep(0.001)
        return codes, max(last[0], t0) - t0

    def state(self) -> tuple:
        """What parity compares: the pool in list order, the lane sizes and
        the reap order."""
        return ([m.tx for m in self.mp._txs], self.mp.lane_sizes(),
                self.mp.reap_max_bytes_max_gas(-1, -1))

    def close(self) -> None:
        if self.feed is not None:
            self.feed.close()
            self.feed.join(RESULT_TIMEOUT)
        self.conn.stop()


def mempool_part(node: NodeMempool, txs, what: str, k3: bool = False) -> dict:
    """``txs`` through the node-wired mempool with the launch counts set to 0
    just before and read just after, traced: codes, wall, launches, the
    verify.audit seconds and the feed's dispatches and rows in the part;
    K1 and K2 (and K3) launched and exact on one launch's inputs."""
    d0, r0 = node.feed.dispatches, node.feed.rows_out
    reset_launches()
    trace.enable()
    trace.reset()
    try:
        with captured_packs() as packs, captured_k3() as k3_ins:
            codes, wall = node.push(txs)
    finally:
        audit = span_seconds(("verify.audit",))["verify.audit"]
        trace.disable()
    launches = read_launches()
    for name in ("ed25519_prologue", "ed25519_ladder") + (("secp256k1_ladder",) if k3 else ()):
        check(launches[name] > 0, f"mempool {what}: {name} not launched")
    check(packs, f"mempool {what}: no ed25519 launch captured")
    return {"codes": codes, "wall_s": wall, "launches": launches, "audit_s": audit,
            "dispatches": node.feed.dispatches - d0, "rows": node.feed.rows_out - r0,
            "packs": packs, "k3_ins": k3_ins}


def phase_mempool(root, dev, err: dict) -> dict:
    """Phase 20: the mempool's CheckTx path as a node wires it. The serial
    rate is taken at 512 txs only (about 2.5 s at 200 txs/s; 5,000 would
    take about 25 s); the filled pool's rate is the batched path's alone."""
    phase(f"mempool: Mempool + SignedKVStoreApp as the node wires them ([mempool] "
          f"defaults, windows of {MP_BATCH}, TxFeed({MP_WINDOW_MS:g} ms, {MP_ROWS} rows)); "
          f"rate and parity against the serial mempool, the fill to {MP_FILL} txs and "
          f"its recheck")
    t_phase = time.perf_counter()
    check(get_batch_verifier() is root.verifier,
          "the default verifier is not the configuration root's guarded one")
    fill_n = MP_FILL
    t0 = time.perf_counter()
    _, txs, mixed = tv.signed_stream(TX_N, TX_SENDERS)
    _, fill, _ = tv.signed_stream(fill_n, TX_SENDERS)
    test_mixed = tv.mixed_stream()
    print(f"  built and signed {len(txs) + len(mixed) + len(fill) + len(test_mixed)} txs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    before = fallbacks()
    out, parts = {}, {}
    serial, batched = NodeMempool(dev, False), NodeMempool(dev, True)
    try:
        # 1. rate: the bench's 512 valid txs, serial then batched
        s_codes, s_wall = serial.push(txs)
        part = mempool_part(batched, txs, "rate")
        check(s_codes == part["codes"] == [0] * TX_N, "mempool rate: a valid tx was rejected")
        b, _, _ = hold_k1_k2(part["packs"][0], err, "mempool rate")
        out["serial_txs_s"], out["batched_txs_s"] = TX_N / s_wall, TX_N / part["wall_s"]
        parts["rate"] = part
        # 2. parity: the bench's mixed stream on the same pools, then
        # tests/test_tx_batch.py's (a secp256k1 and an undecodable tx) on
        # fresh ones
        s_mixed, _ = serial.push(mixed)
        part = mempool_part(batched, mixed, "bench mixed")
        check(part["codes"] == s_mixed, "mempool: the mixed stream's codes differ")
        check(batched.state() == serial.state(), "mempool: pool, lanes or reap order differ")
        check(batched.app.serial_verifies == 0,
              f"mempool: the app paid {batched.app.serial_verifies} serial verifies")
        parts["parity"] = part
        n_pool, lanes = batched.mp.size(), batched.mp.lane_sizes()
    finally:
        serial.close()
        batched.close()
    serial, batched = NodeMempool(dev, False), NodeMempool(dev, True)
    try:
        t_codes, _ = serial.push(test_mixed)
        part = mempool_part(batched, test_mixed, "test mixed", k3=True)
        check(part["codes"] == t_codes, "mempool: test_tx_batch's stream's codes differ")
        check(batched.state() == serial.state(), "mempool: pool, lanes or reap order differ "
              "on test_tx_batch's stream")
        check(batched.app.serial_verifies == 0 and batched.ver.unsigned == 1,
              "mempool: the app verified serially on test_tx_batch's stream")
        k3_b = hold_k3(part["k3_ins"][0], err, "mempool")
        parts["secp"] = part
    finally:
        serial.close()
        batched.close()
    # 3. the fill to the configured size; 4. its recheck after a commit
    node = NodeMempool(dev, True)
    try:
        part = mempool_part(node, fill, "fill")
        check(part["codes"] == [0] * fill_n and node.mp.size() == fill_n,
              f"mempool fill: {node.mp.size()} of {fill_n} admitted")
        hold_k1_k2(part["packs"][0], err, "mempool fill")
        parts["fill"] = part
        out["fill_txs_s"] = fill_n / part["wall_s"]
        hits0, sub0, disp0 = node.ver.cache_hits, node.ver.submitted, node.feed.dispatches
        node.app.commit(abci.RequestCommit())
        reset_launches()
        t0 = time.perf_counter()
        node.mp.lock()
        try:
            node.mp.update(2, [])
        finally:
            node.mp.unlock()
        recheck_s = time.perf_counter() - t0
        launches = read_launches()
        check(node.mp.size() == fill_n, f"mempool recheck: {node.mp.size()} of {fill_n} stay")
        check(all(v == 0 for v in launches.values()), f"the recheck launched {launches}")
        check(node.ver.cache_hits - hits0 == fill_n and node.ver.submitted == sub0
              and node.feed.dispatches == disp0, "the recheck did not answer from the cache")
        check(node.app.serial_verifies == 0 and node.ver.feed_errors == 0,
              "mempool fill: serial verifies or feed errors")
        parts["recheck"] = {"launches": launches}
    finally:
        node.close()
    check_guard_clean(before, "mempool")
    for what in ("rate", "parity", "secp", "fill"):
        p = parts[what]
        print(f"  {what}: {len(p['codes'])} txs in {p['wall_s'] * 1e3:.1f} ms "
              f"({len(p['codes']) / p['wall_s']:.2f} txs/s); dispatches {p['dispatches']}, rows "
              f"a dispatch {p['rows'] / max(1, p['dispatches']):.2f}; verify.audit "
              f"{p['audit_s'] * 1e3:.1f} ms ({p['audit_s'] / p['wall_s']:.1%} of the wall); "
              f"launches {p['launches']}", flush=True)
    print(f"  serial {out['serial_txs_s']:.2f} txs/s, batched {out['batched_txs_s']:.2f} txs/s "
          f"({out['batched_txs_s'] / out['serial_txs_s']:.2f}x) on the {TX_N} signed txs; the "
          f"mixed streams' codes, pool, lanes and reap order equal the serial mempool's "
          f"({n_pool} pooled, lanes {lanes}), app.serial_verifies 0; fill {fill_n} txs at "
          f"{out['fill_txs_s']:.2f} txs/s; recheck of {fill_n} from the cache in "
          f"{recheck_s * 1e3:.1f} ms with no launch; K1/K2 exact on one launch's inputs "
          f"(b = {b}), K3 (b = {k3_b}); no fallback; breaker closed; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    out["launches"] = {what: p["launches"] for what, p in parts.items()}
    return out


# -- phase 21: the state layer and block execution ------------------------------------


def bx_privs(n: int, seed: int) -> list:
    """n seeded ed25519 private keys (64 bytes: seed || pubkey)."""
    raw = np.random.default_rng(seed).bytes(32 * n)
    return [ed.gen_privkey(raw[32 * i: 32 * (i + 1)]) for i in range(n)]


def bx_genesis(chain_id: str, privs) -> tuple:
    """The genesis state of one validator of power BX_POWER a key, and the
    keys by address."""
    pubs = [PubKeyEd25519(p[32:]) for p in privs]
    doc = GenesisDoc(chain_id=chain_id, genesis_time_ns=BX_TIME0,
                     validators=[GenesisValidator(pk, BX_POWER) for pk in pubs])
    return state_from_genesis(doc), {pk.address(): p for pk, p in zip(pubs, privs)}


def bx_commit(st, block, block_id: BlockID, by_addr) -> Commit:
    """Every validator of ``st`` precommits ``block`` a second after its
    time (so the next block's median time passes the monotonic check): the
    next block's LastCommit. The sign-bytes are the same for every
    validator; each signs them with its own key."""
    ts = block.header.time_ns + 1_000_000_000
    vals = st.validators.validators
    msg = Vote(SignedMsgType.PRECOMMIT, block.height, 0, ts, block_id, b"",
               0).sign_bytes(st.chain_id)
    return Commit(block_id=block_id, precommits=[
        Vote(SignedMsgType.PRECOMMIT, block.height, 0, ts, block_id, v.address, i,
             ed.sign(by_addr[v.address], msg)) for i, v in enumerate(vals)])


def bx_block(st, height: int, txs, last_commit: Commit) -> tuple:
    block = st.make_block(height, txs, last_commit, [], st.validators.get_proposer().address)
    return block, BlockID(block.hash(), block.make_part_set().header())


def bx_apply(ex: BlockExecutor, st, block_id: BlockID, block) -> tuple:
    """``apply_block`` traced, with the launch counts set to 0 just before
    and read just after: (state, wall s, seconds by span, launches)."""
    reset_launches()
    trace.enable()
    trace.reset()
    try:
        t0 = time.perf_counter()
        new = ex.apply_block(st, block_id, block)
        wall = time.perf_counter() - t0
        parts = span_seconds(BX_SPANS)
    finally:
        trace.disable()
    return new, wall, parts, read_launches()


def bx_parts_line(parts: list) -> str:
    return ", ".join(f"{n} {statistics.median(p[n] for p in parts) * 1e3:.1f}"
                     for n in BX_SPANS)


def bx_consensus_conn(app):
    conn = MultiAppConn(LocalClientCreator(app))
    conn.start()
    return conn


def bx_chain(node: NodeMempool, err: dict) -> dict:
    """Part 1: BX_HEIGHTS heights of BX_TXS signed txs each through the
    node-wired mempool (CheckTx: K1 + K2 through TxFeed), reaped by
    ``create_proposal_block``, signed by the BX_VALS validators and applied;
    each apply_block from height 2 on verifies its 100-row LastCommit with one
    K1 + K2 launch through the root's guarded verifier."""
    st, by_addr = bx_genesis("block-exec-chain", bx_privs(BX_VALS, BX_SEED))
    state_db = MemDB()
    sm_store.save_state(state_db, st)
    evpool, ex = verify_root.block_executor(state_db, MemDB(), node.conn, node.mp, st,
                                            metrics=StateMetrics())
    check(ex.verifier is None and ex.mempool is node.mp, "the executor is not the node's")
    bs = BlockStore(MemDB())
    t0 = time.perf_counter()
    _, txs, _ = tv.signed_stream(BX_HEIGHTS * BX_TXS, BX_TXS)
    sign_s = time.perf_counter() - t0
    launches = {"checktx": dict.fromkeys(read_launches(), 0),
                "apply": dict.fromkeys(read_launches(), 0)}
    last, saved, walls, parts, checktx_s = Commit(), [], [], [], 0.0
    t_chain = time.perf_counter()
    for h in range(1, BX_HEIGHTS + 1):
        reset_launches()
        codes, wall = node.push(txs[(h - 1) * BX_TXS: h * BX_TXS])
        checktx_s += wall
        got = read_launches()
        check(codes == [0] * BX_TXS, f"block_exec height {h}: CheckTx codes {codes}")
        check(got["ed25519_prologue"] > 0 and got["ed25519_ladder"] > 0,
              f"block_exec height {h}: CheckTx launched {got}")
        for k, v in got.items():
            launches["checktx"][k] += v
        block, ps = ex.create_proposal_block(h, st, last, st.validators.get_proposer().address)
        check(len(block.data.txs) == BX_TXS, f"height {h}: reaped {len(block.data.txs)} txs")
        bid = BlockID(block.hash(), ps.header())
        t0 = time.perf_counter()
        commit = bx_commit(st, block, bid, by_addr)
        sign_s += time.perf_counter() - t0
        bs.save_block(block, ps, commit)
        with captured_packs() as packs:
            st, wall, part, got = bx_apply(ex, st, bid, block)
        want = 0 if h == 1 else 1
        check(got["ed25519_prologue"] == want and got["ed25519_ladder"] == want
              and got["secp256k1_ladder"] == 0,
              f"block_exec height {h}: apply_block launched {got}, want K1 = K2 = {want}")
        if h == 2:
            b, _, _ = hold_k1_k2(packs[0], err, "block_exec chain LastCommit")
        for k, v in got.items():
            launches["apply"][k] += v
        responses = sm_store.load_abci_responses(state_db, h)
        check([r.code for r in responses.deliver_tx] == [0] * BX_TXS,
              f"block_exec height {h}: a DeliverTx failed")
        check(responses.results_hash() == st.last_results_hash,
              f"block_exec height {h}: the stored results hash differs from the state's")
        saved.append((block.hash(), commit.marshal()))
        walls.append(wall)
        if h > 1:
            parts.append(part)
        last = commit
    chain_s = time.perf_counter() - t_chain
    n_tx = BX_HEIGHTS * BX_TXS
    check(st.last_block_total_tx == n_tx, f"last_block_total_tx {st.last_block_total_tx}")
    check(node.mp.size() == 0, f"the pool holds {node.mp.size()} txs at the end")
    check(node.app.serial_verifies == n_tx,
          f"app.serial_verifies {node.app.serial_verifies}, want the {n_tx} DeliverTx verifies")
    check(sm_store.load_state(state_db).marshal() == st.marshal(), "the stored state differs")
    check(evpool.state is st, "the evidence pool did not follow the state")
    for h, (bh, cm) in enumerate(saved, start=1):
        check(bs.load_block(h).hash() == bh and bs.load_seen_commit(h).marshal() == cm,
              f"the block store does not give back height {h}")
    apply_s = sum(walls)
    out = {"blocks_s": BX_HEIGHTS / apply_s, "chain_blocks_s": BX_HEIGHTS / chain_s,
           "apply_p50_ms": statistics.median(walls[1:]) * 1e3,
           "parts_ms": {n: statistics.median(p[n] for p in parts) * 1e3 for n in BX_SPANS},
           "launches": {k: launches["checktx"][k] + launches["apply"][k]
                        for k in launches["apply"]}}
    print(f"  chain: {BX_HEIGHTS} heights x {BX_TXS} txs, {BX_VALS} validators; every "
          f"DeliverTx OK, last_block_total_tx {n_tx}, pool empty, app.serial_verifies "
          f"{node.app.serial_verifies} (DeliverTx only), results hashes and the block store "
          f"check; apply_block {out['blocks_s']:.2f} blocks/s ({apply_s * 1e3:.1f} ms for "
          f"{BX_HEIGHTS}), the whole loop {out['chain_blocks_s']:.2f} blocks/s "
          f"({chain_s:.1f} s: CheckTx {checktx_s:.1f} s, signing {sign_s:.1f} s)", flush=True)
    print(f"  chain apply_block p50 {out['apply_p50_ms']:.1f} ms at heights 2-{BX_HEIGHTS}; "
          f"parts (p50 ms) {bx_parts_line(parts)}; launches CheckTx {launches['checktx']}, "
          f"apply_block {launches['apply']}; K1/K2 exact on the height-2 LastCommit's "
          f"inputs (b = {b})", flush=True)
    return out


def bx_10k(sc_: tc.SignedCommit, node: NodeMempool, dev, err: dict) -> dict:
    """Parts 2 and 3: phase 5's 10,000 keys as a genesis; block 2's
    10,000-row LastCommit through validate_block and the root's guarded
    verifier, applied 3 times to the height-1 state in a fresh state DB and
    app each time; a flipped bit; then the tripped breaker."""
    t0 = time.perf_counter()
    st0, by_addr = bx_genesis("block-exec-10k", sc_.privs)
    check(st0.validators.hash() == sc_.valset.hash(), "the genesis set is not phase 5's")
    setup_s = time.perf_counter() - t0

    def fresh(st, **kw):
        db = MemDB()
        sm_store.save_state(db, st)
        conn = bx_consensus_conn(KVStoreApp())
        return db, conn, BlockExecutor(db, conn.consensus, **kw)

    db, conn, ex = fresh(st0)
    block1, bid1 = bx_block(st0, 1, [], Commit())
    st1 = ex.apply_block(st0, bid1, block1)
    conn.stop()
    t0 = time.perf_counter()
    commit1 = bx_commit(st0, block1, bid1, by_addr)
    sign_s = time.perf_counter() - t0
    block2, bid2 = bx_block(st1, 2, [], commit1)
    key = hashlib.sha256(b"".join(v.pub_key.bytes()
                                  for v in st1.last_validators.validators)).digest()
    warm = {"host": key in ec._valset_cache,
            "device": any(k[0] == key for k in ec._dev_valset_cache)}
    walls, parts = [], []
    for rep in range(BX_REPS):
        db, conn, ex = fresh(st1)
        try:
            with captured_packs() as packs:
                st2, wall, part, got = bx_apply(ex, st1, bid2, block2)
        finally:
            conn.stop()
        check(st2.last_block_height == 2 and sm_store.load_state(db).last_block_height == 2,
              "block 2 did not apply")
        walls.append(wall)
        parts.append(part)
        if rep == 0:
            launches = got
            check(got["ed25519_prologue"] == 1 and got["ed25519_ladder"] == 1
                  and got["secp256k1_ladder"] == 0,
                  f"the 10k LastCommit launched {got}, want K1 = K2 = 1")
            b, _, _ = hold_k1_k2(packs[0], err, "block_exec 10k LastCommit")
            check(b >= N_VALIDATORS, f"the 10k LastCommit ran at b = {b}")
    # a flipped bit: an invalid block, nothing saved
    block_bad, bid_bad = bx_block(st1, 2, [], tc.flip_signature_bit(commit1, 7, 300))
    db, conn, ex = fresh(st1)
    before = list(db.iterator())
    try:
        ex.apply_block(st1, bid_bad, block_bad)
        raise SmokeFailure("a flipped LastCommit bit applied")
    except InvalidBlockError as e:
        check("invalid signature" in str(e), f"the flipped bit raised {e!r}")
    finally:
        conn.stop()
    check(list(db.iterator()) == before and sm_store.load_state(db).last_block_height == 1,
          "the rejected block changed the state DB")
    # a device fault: a guarded verifier whose breaker is tripped, with part 1's mempool
    br = breaker.CircuitBreaker(threshold=1, backoff_base=600.0, backoff_max=600.0)
    br.record_failure("error")
    tripped = GuardedBatchVerifier(TorchBatchVerifier(dev), breaker=br)
    check(tripped.on_card, "the tripped verifier is not on the card")
    db, conn, ex = fresh(st1, mempool=node.mp, verifier=tripped)
    before = list(db.iterator())
    reset_launches()
    try:
        ex.apply_block(st1, bid2, block2)
        raise SmokeFailure("block 2 applied through a tripped breaker")
    except InvalidBlockError as e:
        raise SmokeFailure(f"a device fault read as an invalid block: {e}") from e
    except breaker.DeviceDispatchError as e:
        fault = str(e)
    finally:
        conn.stop()
    check(list(db.iterator()) == before and sm_store.load_state(db).last_block_height == 1,
          "the device fault changed the state DB")
    check(all(v == 0 for v in read_launches().values()), "the tripped breaker launched")
    check(node.mp._mtx.acquire(timeout=5.0), "the mempool's lock cannot be taken")
    node.mp._mtx.release()
    out = {"p50_ms": statistics.median(walls) * 1e3, "first_ms": walls[0] * 1e3,
           "parts_ms": {n: statistics.median(p[n] for p in parts) * 1e3 for n in BX_SPANS},
           "launches": launches, "warm": warm}
    print(f"  10k: genesis of phase 5's {N_VALIDATORS} keys in {setup_s:.1f} s, the LastCommit "
          f"signed in {sign_s:.1f} s; block 2 applies with K1 = K2 = 1 (b = {b}), exact on "
          f"that launch's inputs; apply_block p50 {out['p50_ms']:.1f} ms over {BX_REPS} "
          f"(first {out['first_ms']:.1f} ms), key caches warm before the first: {warm}",
          flush=True)
    print(f"  10k parts (p50 ms): {bx_parts_line(parts)}", flush=True)
    print(f"  a flipped LastCommit bit: InvalidBlockError, the state DB at height 1; a "
          f"tripped breaker: DeviceDispatchError ({fault}), no launch, the state DB at "
          f"height 1, the mempool's lock free", flush=True)
    return out


def phase_block_exec(root, dev, sc_: tc.SignedCommit, err: dict) -> dict:
    """Phase 21: the state layer and block execution on the card, on a root
    of its own at the [verify] defaults."""
    phase(f"block_exec: BlockExecutor over the node-wired mempool, {BX_HEIGHTS} heights of "
          f"{BX_VALS} validators, then a {N_VALIDATORS}-validator LastCommit through "
          f"validate_block, a flipped bit and a tripped breaker")
    t_phase = time.perf_counter()
    check(get_batch_verifier() is root.verifier,
          "the default verifier is not the configuration root's guarded one")
    before = fallbacks()
    node = NodeMempool(dev, True)
    try:
        chain = bx_chain(node, err)
        tenk = bx_10k(sc_, node, dev, err)
    finally:
        node.close()
    check_guard_clean(before, "block_exec")
    print(f"  no fallback; breaker closed; no audit mismatch; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"chain": chain, "10k": tenk,
            "launches": {"chain": chain["launches"], "10k": tenk["launches"]}}


# the adversarial matrix of tests/test_msm_path.py: the Go-edge window's
# first 16 rows (10 clean, then forged s, mutant R, s + L, sig[63] | 0xE0,
# non-canonical R, another key's signature)
ADV_ROWS = 16
MSM_SEED = 1234
K4_ITERS = 5
# 32x32 -> 64 products of K4's point formulas: an addition is 9 field
# multiplications of 100 products, a doubling 4 squarings of 55 and 4
# multiplications, a mixed addition 7 multiplications
PT_ADD_PRODUCTS, PT_DOUBLE_PRODUCTS, PT_MADD_PRODUCTS = 900, 4 * 55 + 4 * 100, 700


def k4_products(sched) -> int:
    """The products the schedule that ran needs: the tree's additions, the
    fold's, Horner's (nwin - 1 additions, (nwin - 1) c doublings), [s_b]B's
    (64 mixed additions, 256 doublings) and the final addition."""
    tree, fold = em.schedule_adds(sched)
    adds = tree + fold + (sched.nwin - 1) + 1
    doubles = (sched.nwin - 1) * sched.c + 4 * 64
    return adds * PT_ADD_PRODUCTS + doubles * PT_DOUBLE_PRODUCTS + 64 * PT_MADD_PRODUCTS


def flat_tensors(ins):
    pool, ias, ibs, bkt, sb = ins
    return [pool, *ias, *ibs, bkt, sb]


def time_k4_parts(ins, sched) -> dict:
    """Device ms of each of K4's sub-launches (CUDA events, K4_ITERS calls
    each): every tree level, the fold and the finish."""
    pool, ias, ibs, bkt, sb = ins
    rows = em.msm_rows(pool, ias)
    em.msm_levels(rows, ias, ibs, pool.shape[0])
    levels = [cuda_ms(lambda ia=ia, ib=ib, s=s, d=d: em.msm_level(rows, ia, ib, s, d),
                      K4_ITERS, 1)
              for ia, ib, (s, d) in zip(ias, ibs, em.level_spans(ias, pool.shape[0]))]
    fold = cuda_ms(lambda: em.msm_fold(rows, bkt), K4_ITERS, 1)
    acc = em.msm_fold(rows, bkt)
    finish = cuda_ms(lambda: em.msm_finish(acc, sb, sched.c), K4_ITERS, 1)
    return {"levels_ms": levels, "fold_ms": fold, "finish_ms": finish,
            "level_rows": [int(a.shape[0]) for a in ias]}


def window_items(window: dict) -> list:
    """The window phase's present cells as (pub, msg, sig) rows, in the
    order the commit window's msm route hands them to the MSM."""
    return [(x[0].bytes(), x[1], x[2]) for row in window["rows"][0] for x in row
            if x is not None]


def phase_k4(dev, sc_: tc.SignedCommit, window: dict, mul_rate: float, err: dict) -> dict:
    phase(f"k4: the ed25519 MSM kernel vs plain at the adversarial window's size ({ADV_ROWS} "
          f"rows), the {N_VALIDATORS}-validator commit's and the {WINDOW_H} x {WINDOW_V} "
          f"window's, seed {MSM_SEED}")
    pubs, msgs, sigs, _ = tc.go_edge_window(seed=0)
    shapes = {
        "adversarial": list(zip(pubs[:ADV_ROWS], msgs[:ADV_ROWS], sigs[:ADV_ROWS])),
        "commit": [(v.pub_key.bytes(), pc.sign_bytes(sc_.chain_id), pc.signature)
                   for v, pc in zip(sc_.valset.validators, sc_.commit.precommits)],
        # the window as it is, forged lanes and all: K4 rejects it, and the
        # non-identity final point it reaches must equal msm_ref's limb for limb
        "window": window_items(window),
    }
    verdicts = {"adversarial": 0, "commit": 1, "window": 0}
    out = {}
    for label, items in shapes.items():
        t0 = time.perf_counter()
        rows = [p[1:] for p in ed._parse_batch(items)[0]]
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sched, pool, sb = em.rlc_inputs(rows, random.Random(MSM_SEED))
        inputs_s = time.perf_counter() - t0
        ins = em.device_inputs(sched, pool, sb, dev)
        got = em.msm(*ins)
        torch.cuda.synchronize()
        ref = em.msm_ref(*ins)
        e = max_abs_diff(got, ref)
        err["ed25519_msm"] = max(err["ed25519_msm"], e)
        check(e == 0, f"k4 {label}: K4 differs from msm_ref by {e}")
        check(int(got[0].item()) == verdicts[label], f"k4 {label}: verdict {int(got[0].item())}")
        ms = cuda_ms(lambda: em.msm(*ins), K4_ITERS, 1)
        parts = time_k4_parts(ins, sched)
        plain_ms = cuda_ms(lambda: em.msm_ref(*ins), 1, 0)
        products = k4_products(sched)
        bound = least_ms(flat_tensors(ins), list(got), products, mul_rate)
        tree, fold = em.schedule_adds(sched)
        nz = int(sum(np.count_nonzero(a) for a in sched.ias))
        print(f"  {label}: n {len(rows)}, m {2 * len(rows)}, c {sched.c}, nwin {sched.nwin}, "
              f"pool {pool.shape[0]} rows, {len(sched.ias)} levels {parts['level_rows']}, "
              f"tree adds {tree} ({nz} entries), fold adds {fold}; parse {parse_s:.3f} s, "
              f"z draws + schedule + pool {inputs_s:.3f} s; K4 {ms:.4f} ms (levels "
              + ", ".join(f"{t:.4f}" for t in parts["levels_ms"])
              + f"; fold {parts['fold_ms']:.4f}; finish {parts['finish_ms']:.4f}); plain "
              f"{plain_ms:.1f} ms; bound {bound[0]:.4f} ms by {bound[1]} ({products:.3g} "
              f"products); verdict {int(got[0].item())}, exact", flush=True)
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound": bound, "parts": parts,
                      "products": products, "c": sched.c, "nwin": sched.nwin,
                      "tree_adds": tree, "fold_adds": fold}
    print(f"  K4: {registers('ed25519_msm')}", flush=True)
    return out


def msm_spans() -> tuple:
    return ("msm.parse", "msm.prologue_h", "msm.schedule", "msm.pool", "msm.k4",
            "msm.localize", "verify.dispatch", "verify.audit", "verify.window_dispatch",
            "planner.dispatch", "planner.audit")


def traced(fn):
    """fn() once with the tracer on; returns (result, wall s, seconds a span)."""
    trace.enable()
    trace.reset()
    try:
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
        return res, wall, {k: v for k, v in span_seconds(msm_spans()).items() if v}
    finally:
        trace.disable()


def phase_msm(dev, sc_: tc.SignedCommit, err: dict) -> dict:
    phase(f"msm: ed25519_path = msm; the adversarial window, the Go-edge window and the "
          f"{N_VALIDATORS}-validator commit through one MSM")
    pubs, msgs, sigs, fixed = tc.go_edge_window(seed=0)
    expected = np.array([fixed[i] for i in range(ADV_ROWS)])
    pa, sa = as_arrays(pubs[:ADV_ROWS], sigs[:ADV_ROWS])
    reset_launches()
    adv = ec.rlc_verify_batch(pa, msgs[:ADV_ROWS], sa, device=dev, seed=MSM_SEED)
    adv_launches = read_launches()
    check(np.array_equal(adv, expected), f"msm adversarial verdicts {adv.astype(int)}")
    check(np.array_equal(adv, ec.verify_batch(pa, msgs[:ADV_ROWS], sa, device=dev)),
          "msm adversarial verdicts differ from the K1 + K2 ladder's")
    check(adv_launches["ed25519_msm"] == 1 and adv_launches["ed25519_ladder"] >= 1,
          f"adversarial launches {adv_launches}")  # K1 + K2 once a message length
    pe, se = as_arrays(pubs, sigs)
    edge = ec.rlc_verify_batch(pe, msgs, se, device=dev, seed=MSM_SEED)
    edge_cpu = ec.rlc_verify_batch(pe, msgs, se, device="cpu", seed=MSM_SEED)
    check(np.array_equal(edge, edge_cpu), "the Go-edge window differs between card and CPU")
    check(edge.tolist() == [ed._verify_pure(*t) for t in zip(pubs, msgs, sigs)],
          "the Go-edge window differs from _verify_pure")
    print(f"  adversarial {ADV_ROWS} rows: verdicts equal expected and the ladder's; launches "
          f"{adv_launches}; the Go-edge window ({len(pubs)} rows) equals the CPU run and "
          f"_verify_pure", flush=True)

    verify = lambda v, commit=sc_.commit: sc_.valset.verify_commit(  # noqa: E731
        sc_.chain_id, sc_.block_id, sc_.height, commit, verifier=v)
    raw = ([v.pub_key.bytes() for v in sc_.valset.validators],
           [pc.sign_bytes(sc_.chain_id) for pc in sc_.commit.precommits],
           [pc.signature for pc in sc_.commit.precommits])
    v = TorchBatchVerifier(ed25519_path="msm")
    check(v.device == dev and v.ed25519_path == "msm", "msm verifier")
    reset_launches()
    t0 = time.perf_counter()
    verify(v)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    check((launches["ed25519_prologue"], launches["ed25519_msm"],
           launches["ed25519_ladder"]) == (1, 1, 0), f"msm commit launches {launches}")
    check(np.array_equal(v.verify_ed25519_raw(*raw),
                         TorchBatchVerifier().verify_ed25519_raw(*raw)),
          "msm verdicts differ from the ladder's on the commit")
    walls, parts = [], []
    for _ in range(WINDOW_REPS):
        _, wall, sp = traced(lambda: verify(v))
        walls.append(wall)
        parts.append(sp)
    p50 = statistics.median(walls) * 1e3
    part_ms = {k: statistics.median(p.get(k, 0.0) for p in parts) * 1e3 for k in parts[0]}
    reset_launches()
    _, bad_wall, bad_parts = traced(lambda: expect_commit_error(
        lambda: verify(v, flipped(sc_, N_VALIDATORS // 3)), "invalid signature in commit"))
    bad_launches = read_launches()
    check(bad_launches["ed25519_msm"] == 1 and bad_launches["ed25519_ladder"] == 1,
          f"dirty commit launches {bad_launches}")
    print(f"  verify_commit (TorchBatchVerifier(ed25519_path='msm')): passes; first "
          f"{first_ms:.1f} ms; p50 {p50:.1f} ms over {WINDOW_REPS}; parts (p50 ms) "
          + ", ".join(f"{k} {t:.1f}" for k, t in part_ms.items())
          + f"; launches {launches}; a flipped signature rejected in {bad_wall * 1e3:.1f} ms "
          f"(localize {bad_parts.get('msm.localize', 0.0) * 1e3:.1f} ms), launches "
          f"{bad_launches}", flush=True)

    root = configure_verify(VerifyConfig(ed25519_path="msm"), device=dev)
    check(root.verifier.device.ed25519_path == "msm", "the root's verifier is not on msm")
    before = fallbacks()
    reset_launches()
    _, g_wall, g_parts = traced(lambda: verify(root.verifier))
    guarded = read_launches()
    check((guarded["ed25519_prologue"], guarded["ed25519_msm"],
           guarded["ed25519_ladder"]) == (1, 1, 0), f"guarded msm launches {guarded}")
    check_guard_clean(before, "guarded msm commit")
    print(f"  guarded verifier (configure_verify(VerifyConfig(ed25519_path='msm'))): passes in "
          f"{g_wall * 1e3:.1f} ms (audit {g_parts.get('verify.audit', 0.0) * 1e3:.1f} ms); "
          f"launches {guarded}; no fallback; breaker closed", flush=True)
    return {"launches": launches, "adversarial_launches": adv_launches,
            "dirty_launches": bad_launches, "guarded_launches": guarded,
            "first_ms": first_ms, "p50_ms": p50, "parts_ms": part_ms,
            "guarded_ms": g_wall * 1e3}


def phase_commit_window(dev, window: dict, err: dict) -> dict:
    votes, powers, totals = window["rows"]
    H, V = len(votes), len(votes[0])
    phase(f"commit_window: the {H} x {V} window through parallel/commit_verify on the ladder "
          f"(K8) and msm paths, and verify_window under the msm default")
    raw_votes = [[None if x is None else (x[0].bytes(), x[1], x[2]) for x in row]
                 for row in votes]
    check(len(set(totals)) == 1, "the window's heights carry different total powers")
    total = totals[0]
    t0 = time.perf_counter()
    win = cv.pack_commit_window(raw_votes, powers)
    pack_s = time.perf_counter() - t0
    want = window["verdict"]
    n_groups = n_length_groups(votes)
    before = fallbacks()

    def same(got, what):
        for k, g in zip(("ok", "tally", "committed"), got):
            check(np.array_equal(g, getattr(want, k)), f"{what}: {k} differs from the planner's")

    reset_launches()
    cv.tally_launches["window_tally"] = 0
    got, first_s, _ = traced(lambda: cv.verify_commit_window(win, total, device=dev))
    same(got, "commit window (ladder)")
    launches = {**read_launches(), **cv.tally_launches}
    check(launches["ed25519_prologue"] == n_groups and launches["ed25519_ladder"] == n_groups
          and launches["window_tally"] == 1 and launches["ed25519_msm"] == 0,
          f"commit window launches {launches}")
    walls, parts = [], []
    for _ in range(WINDOW_REPS):
        again, wall, sp = traced(lambda: cv.verify_commit_window(win, total, device=dev))
        same(again, "commit window (ladder) again")
        walls.append(wall)
        parts.append(sp)
    ladder_p50 = statistics.median(walls)
    ladder_parts = {k: statistics.median(p.get(k, 0.0) for p in parts) for k in parts[0]}
    print(f"  ladder (K8): pack_commit_window {pack_s:.2f} s; first {first_s:.2f} s; p50 "
          f"{ladder_p50:.3f} s over {WINDOW_REPS}; parts (p50 s) "
          + ", ".join(f"{k} {t:.4f}" for k, t in ladder_parts.items())
          + f"; launches {launches}", flush=True)

    # the K8 tally at the window's shapes, against its host version
    ok_d = torch.from_numpy(got[0]).to(dev)
    power_d = torch.from_numpy(win.power).to(dev)
    t_out = cv.window_tally(ok_d, power_d, total)
    host = np.where(got[0], win.power, 0).sum(-1)
    tally_err = int(np.abs(t_out[0].cpu().numpy() - host).max(initial=0))
    check(tally_err == 0, f"the K8 tally differs from the host's by {tally_err}")
    tally_ms = cuda_ms(lambda: cv.window_tally(ok_d, power_d, total))
    host_ms = host_p50_ms(lambda: np.where(got[0], win.power, 0).sum(-1))
    tally_bound = (nbytes((ok_d, power_d)) + nbytes(t_out)) / HBM_BYTES_PER_S * 1e3

    # the msm route as a node configures it: [verify] ed25519_path = "msm"
    # and every other knob at its default (the 30 s dispatch deadline)
    msm_root = configure_verify(VerifyConfig(ed25519_path="msm"), device=dev)
    check(msm_root.verifier.deadline == 30.0, "the msm root's dispatch deadline is not 30 s")
    retries_before = retries()
    try:
        reset_launches()
        got_m, msm_s, msm_parts = traced(lambda: cv.verify_commit_window(win, total, device=dev))
        same(got_m, "commit window (msm)")
        msm_launches = read_launches()
        check(msm_launches["ed25519_msm"] == 1 and msm_launches["ed25519_ladder"] >= 1,
              f"msm commit window launches {msm_launches}")
        reset_launches()
        plan_v, plan_s, plan_parts = traced(
            lambda: planner.verify_window(votes, powers, totals, use_device=True))
        plan_launches = read_launches()
        for k in VERDICT_KEYS:
            check(np.array_equal(getattr(plan_v, k), getattr(want, k)),
                  f"verify_window under msm: {k} differs")
        check(plan_launches["ed25519_msm"] == 1, f"planner msm launches {plan_launches}")
        check_guard_clean(before, "commit window")
        check(retries() == retries_before, "an msm window dispatch was retried (a timeout or "
              "a device error under the default deadline)")
    finally:
        configure_verify(VerifyConfig(), device=dev)
    print(f"  msm: verify_commit_window {msm_s:.2f} s, parts (s) "
          + ", ".join(f"{k} {t:.3f}" for k, t in msm_parts.items())
          + f"; launches {msm_launches}", flush=True)
    print(f"  msm: verify_window(use_device=True) {plan_s:.2f} s, parts (s) "
          + ", ".join(f"{k} {t:.3f}" for k, t in plan_parts.items())
          + f"; launches {plan_launches}; all equal the planner's ladder verdict; no "
          f"fallback or retry under the default 30 s deadline; breaker closed", flush=True)
    print(f"  K8 tally {tally_ms:.4f} ms against a byte bound of {tally_bound:.6f} ms "
          f"(torch int64, exact against the host's {host_ms:.3f} ms)", flush=True)
    return {
        "launches": launches, "msm_launches": msm_launches, "planner_msm_launches": plan_launches,
        "ladder_p50_s": ladder_p50, "msm_s": msm_s, "planner_msm_s": plan_s,
        "tally": {"name": "window_tally", "route": "torch",
                  "source": "tendermint_tpu_torch/parallel/commit_verify.py",
                  "replaces": "tendermint_tpu/parallel/commit_verify.py:129",
                  "launches": launches["window_tally"], "max_abs_err": tally_err,
                  "ms": tally_ms, "plain_ms": host_ms, "bound_ms": tally_bound,
                  "bound_by": "bytes", "H": H, "V": V},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)

    phase("device")
    smi_line = smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"  nvidia-smi: {smi_line}; torch: {torch.cuda.get_device_name(0)}; "
          f"SMs {props.multi_processor_count}; max SM clock {max_sm_mhz} MHz; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    op_rate = props.multi_processor_count * max_sm_mhz * 1e6 * INT32_OPS_PER_CLK_PER_SM

    phase("build")
    secs = _build.build_all()
    for name, s in secs.items():
        print(f"  {name}: {s:.1f} s", flush=True)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print(f"    {line.strip()}")
    rates = imad_probe.products_per_clock(dev)
    mul_rate = props.multi_processor_count * max_sm_mhz * 1e6 * rates["imad_wide"]
    print(f"  multiply probe: IMAD.WIDE {rates['imad_wide']:.2f}, IMAD {rates['imad']:.2f} "
          f"a clock an SM (median of {props.multi_processor_count} SMs); K2's and K3's "
          f"bounds price a product at the IMAD.WIDE rate", flush=True)

    err = {"ed25519_prologue": phase_k1(dev, rng), "ed25519_ladder": phase_k2(dev, rng)}
    ed_main = phase_ed25519_main(dev, op_rate, mul_rate, err)
    err["secp256k1_ladder"] = phase_k3(dev, rng)
    secp_main = phase_secp_main(dev, op_rate, mul_rate, err)
    root = configure_verify(VerifyConfig(), device=dev)
    check(root.verifier.deadline == 30.0 and root.verifier.audit_rate == 0.05,
          "the configuration root did not apply the default [verify] section")
    default = phase_default_commit(root, ed_main["commit"])
    mixed = phase_mixed(root)
    window = phase_window(root, dev, err)
    phase_backfill(window, err)
    phase_rpc(root, window, err)
    phase_multisig(root, err)
    lite = phase_lite(root, err)
    votes = phase_votes(root, err)
    txs = phase_txs(root, err)
    err[K4] = 0
    k4 = phase_k4(dev, ed_main["commit"], window, mul_rate, err)
    msm = phase_msm(dev, ed_main["commit"], err)
    configure_verify(VerifyConfig(), device=dev)  # back to the default [verify]
    cwin = phase_commit_window(dev, window, err)
    # the mempool phase sets its path up through a default [verify] root of its own
    mempool = phase_mempool(configure_verify(VerifyConfig(), device=dev), dev, err)
    # so does the block_exec phase
    bx = phase_block_exec(configure_verify(VerifyConfig(), device=dev), dev, ed_main["commit"],
                          err)
    print(f"  {smi_line}", flush=True)

    ms = {**ed_main["ms"], "secp256k1_ladder": secp_main["ms"]}
    plain_ms = {**ed_main["plain_ms"], "secp256k1_ladder": secp_main["plain_ms"]}
    bounds = {**ed_main["bounds"], "secp256k1_ladder": secp_main["bound"]}
    launches = {**ed_main["launches"], "secp256k1_ladder":
                secp_main["launches"]["secp256k1_ladder"]}
    for name in KERNELS:
        b = secp_main["b"] if name == "secp256k1_ladder" else ed_main["b"]
        print(f"  {name}: {ms[name]:.4f} ms (plain {plain_ms[name]:.1f} ms, bound "
              f"{bounds[name][0]:.4f} ms by {bounds[name][1]}, {bounds[name][0] / ms[name]:.1%} "
              f"of it) at b = {b}; mixed-path launches {mixed['launches'][name]}", flush=True)
    table = {**ed_main["table_bound"], "secp256k1_ladder": secp_main["table_bound"]}
    for name, (t, _) in table.items():
        print(f"  {name} at the table's {INT32_OPS_PER_CLK_PER_SM} products a clock: bound "
              f"{t:.4f} ms, {t / ms[name]:.1%} of it", flush=True)

    kernels = []
    for name in KERNELS:
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tendermint_tpu_torch/ops/csrc/{_build.SOURCES[name]}",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": None,  # no single PyTorch call computes these functions
            "lite_launches": {shape: lite[shape]["launches"][name] for shape in ("a", "b")},
            "votes_launches": {route: votes[route]["launches"][name] for route in votes},
            "txs_launches": txs["launches"][name],
            "mempool_launches": {what: n[name] for what, n in mempool["launches"].items()},
            "block_exec_launches": {what: n[name] for what, n in bx["launches"].items()},
            "msm_launches": msm["launches"][name],
            "commit_window_launches": {"ladder": cwin["launches"][name],
                                       "msm": cwin["msm_launches"][name],
                                       "planner_msm": cwin["planner_msm_launches"][name]},
        })
    k4c = k4["commit"]
    kernels.append({
        "name": K4,
        "route": "cuda",
        "source": f"tendermint_tpu_torch/ops/csrc/{_build.SOURCES[K4]}",
        "replaces": K4_REPLACES,
        # the main path of K4 is the msm route's 10k commit (phase 18)
        "launches": msm["launches"][K4],
        "max_abs_err": err[K4],
        "ms": k4c["ms"],
        "plain_ms": k4c["plain_ms"],
        "bound_ms": k4c["bound"][0],
        "bound_by": k4c["bound"][1],
        "library_ms": None,  # no single PyTorch call computes this function
        "sub_ms": {"levels": k4c["parts"]["levels_ms"], "fold": k4c["parts"]["fold_ms"],
                   "finish": k4c["parts"]["finish_ms"]},
        "adversarial_ms": k4["adversarial"]["ms"],
        # the 512 x 64 window's schedule (the commit window's msm route)
        "window_ms": k4["window"]["ms"],
        "window_plain_ms": k4["window"]["plain_ms"],
        "window_bound_ms": k4["window"]["bound"][0],
        "window_sub_ms": {"levels": k4["window"]["parts"]["levels_ms"],
                          "fold": k4["window"]["parts"]["fold_ms"],
                          "finish": k4["window"]["parts"]["finish_ms"]},
        "lite_launches": {shape: lite[shape]["launches"][K4] for shape in ("a", "b")},
        "votes_launches": {route: votes[route]["launches"][K4] for route in votes},
        "txs_launches": txs["launches"][K4],
        "mempool_launches": {what: n[K4] for what, n in mempool["launches"].items()},
        "block_exec_launches": {what: n[K4] for what, n in bx["launches"].items()},
        "msm_launches": {"commit": msm["launches"][K4],
                         "adversarial": msm["adversarial_launches"][K4],
                         "dirty_commit": msm["dirty_launches"][K4],
                         "guarded": msm["guarded_launches"][K4]},
        "commit_window_launches": {"ladder": cwin["launches"][K4],
                                   "msm": cwin["msm_launches"][K4],
                                   "planner_msm": cwin["planner_msm_launches"][K4]},
    })
    print(f"  {N_VALIDATORS}-validator ed25519 verify_commit p50: {ed_main['p50_ms']:.3f} ms "
          f"through TorchBatchVerifier, {default['p50_ms']:.1f} ms through the default "
          f"guarded verifier (audit {default['verify.audit']:.1f} ms of it)", flush=True)
    print(f"  {N_VALIDATORS}-validator ed25519 verify_commit p50 on the msm path: "
          f"{msm['p50_ms']:.1f} ms (K4 {k4c['ms']:.4f} ms of it); the {WINDOW_H} x {WINDOW_V} "
          f"commit window {cwin['ladder_p50_s']:.3f} s on the ladder (K8), {cwin['msm_s']:.2f} s "
          f"on the msm path", flush=True)
    print(f"  block_exec: the {BX_VALS}-validator chain at {bx['chain']['blocks_s']:.2f} "
          f"blocks/s (apply_block p50 {bx['chain']['apply_p50_ms']:.1f} ms); the "
          f"{N_VALIDATORS}-validator LastCommit's apply_block p50 {bx['10k']['p50_ms']:.1f} ms "
          f"(validate {bx['10k']['parts_ms']['state.validate']:.1f} ms of it)", flush=True)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"torch_ops": [window["tally"], cwin["tally"]]}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
