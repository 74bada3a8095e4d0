#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device  the card's name and power limit (nvidia-smi) and torch's name;
             then the host, read only: the CPU model, os.cpu_count and
             sched_getaffinity, the cgroup's cpu.max, the load average,
             torch's threads, and 100 calls of crypto/ed25519._verify_pure
             on one signature, timed (what makes one machine's host-bound
             phases slower than another's);
  2. build   the six CUDA kernels and the multiply probe from the
             checkout's sources, in parallel, with each one's registers,
             spills and stack frame; then the probe's IMAD.WIDE and IMAD
             rates (products a clock an SM): the IMAD.WIDE rate prices
             K2's and K3's bounds. Beside them the three host C
             accelerators (encoding/native.py: the codec, the SHA-256 and
             Merkle hasher, the WAL scanner), which the port's imports
             built with cc into build/tendermint_tpu_torch/native/: each
             one's build seconds and path and have_shani(); it fails if
             one did not load or TM_NO_NATIVE_CODEC is set, so that no
             phase runs on the Python fallback;
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
             device fallback; the wall of a traced call beside the
             seconds of its device dispatch and of its audit;
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
             fallback, the breaker closed, no audit mismatch. Walls of
             one traced call each with their breakdowns (plan, pack,
             dispatch, audit), K1 and K2 at the window's b against their plain
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
             closed, no audit mismatch. The wall of one traced call against
             the flat window's, beside the sums of its plan, pack, dispatch and
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
             The wall of a traced burst with its audit span. Then 8
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
             and /light_block for the last 4 heights, rotated; (b) 16
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
  17. k4     the ed25519 MSM kernel (K4, ops/csrc/ed25519_msm.cu) on the
             card, on one schedule each at the adversarial window's size
             (the Go-edge window's first 16 rows: verdict 0), at the
             10,000-validator commit's (n 10,000, m 20,000, c 8, nwin 32:
             verdict 1) and at the window phase's 512 x 64 window's
             (verdict 0), RLC seed 1234: verdict and canonical final point
             exact against ed25519_msm.msm_plain, the plain version of
             K4's own schedule, and the verdict and group element of
             msm_ref, the reference's schedule (not at the window). K4's
             ms with each sub-launch's (every tree level alone and all back
             to back, the fold with [s_b]B, the finish), msm_plain's and msm_ref's
             (their exactness runs), the bound at the probe's IMAD.WIDE
             rate over the products the reference's schedule needs on
             these inputs (this design's beside it), each K4 function's
             registers, stack and spills (none allowed), and the longest
             chain of dependent point operations;
  18. msm    ed25519_path = "msm": the adversarial 16 rows through
             ed25519_cuda.rlc_verify_batch on the card equal the expected
             verdicts and the K1 + K2 ladder's; the whole Go-edge window
             equals the CPU run at the same seed and _verify_pure; the
             10,000-validator commit through verify_commit with
             TorchBatchVerifier(ed25519_path="msm") passes with K1 = 1, K4 =
             1 and K2 = 0 and verdicts equal to the ladder's (the wall of a
             traced call with its parse, prologue_h, schedule, pool, K4
             spans), a
             flipped signature is rejected through the localization (K2
             once), and the commit through the guarded verifier of
             configure_verify(VerifyConfig(ed25519_path="msm")) passes with
             K1 = 1, K4 = 1, K2 = 0, no fallback, the breaker closed; then
             the default [verify] root is installed again;
  19. commit_window the window of phase 10 packed by
             parallel/commit_verify.pack_commit_window and verified by
             verify_commit_window on the ladder path (the K8 step: K1 -> K2
             once a message-length group, the int64 tally on the card), then
             on the msm path the window's first 128 heights (8,192 rows, the
             flipped bit at 85 included; the whole window before phase 23
             came): verify_commit_window (one K4 launch, the rejected batch
             localized through one K1 -> K2 pass) and planner.verify_window(
             use_device=True) under the msm default, both at the default 30 s
             deadline: ok, tally and committed equal phase 10's planner
             verdict (on those heights for the msm calls), no fallback,
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
             each of 8 heights 64 signed txs of 64 senders go through
             check_tx (K1 + K2 through TxFeed), create_proposal_block reaps
             them, the 100 validators sign the block's precommits (the next
             LastCommit) and apply_block applies it, launching K1 + K2 once
             for the 100-row LastCommit from height 2 on (exact on height
             2's inputs). Every DeliverTx OK, last_block_total_tx 512, the
             pool empty, app.serial_verifies 512 (DeliverTx only), every
             stored ABCIResponses' results hash equal to the state's, every
             block and seen commit back from the BlockStore. Blocks a second
             and apply_block's parts (state.validate with verify.dispatch
             and verify.audit, state.exec, state.update, state.commit,
             state.save). (2) Phase 5's 10,000 keys as a genesis (power 10):
             block 1, then block 2 whose 10,000-row LastCommit goes through
             validate_block and the root's guarded verifier, K1 = K2 = 1 at
             b = 10,240, exact on that launch's inputs; apply_block p50 over
             2 applications to the height-1 state (a fresh state DB and app
             each) with its parts and whether the key caches were warm; a
             flipped LastCommit bit raises InvalidBlockError and leaves the
             state DB at height 1. (3) A BlockExecutor on part 1's mempool
             whose verifier is a fresh guarded one with its breaker tripped
             raises DeviceDispatchError, not InvalidBlockError, with no
             launch, the state DB at height 1 and the mempool's lock free.
             No fallback, the default breaker closed, no audit mismatch.
  22. fastsync fast sync, on a default [verify] root of its own: BASELINE.json
             config 3 at scripts/bench_fastsync.py's width, 64 validators
             of power 10 over KVStoreApp, a chain of 513 blocks (1,025 before
             phase 25 came) built by
             tools/bench_fastsync.build (set-up, each LastCommit through an
             explicit TorchBatchVerifier). (a) tools/bench_fastsync.replay at
             the reference's VERIFY_WINDOW of 512 (one full window) through
             the root's guarded verifier, an explicit TorchBatchVerifier()
             and the free NullVerifier (the host's ceiling), and its serial
             baseline (verify_commit + apply_block a height) over 64 blocks
             on the guarded verifier: blocks a second with the
             fastsync.window, planner.pack, verify.dispatch, verify.audit,
             fastsync.apply and state.* spans; every run ends at height
             512 with the chain's app hash and state bytes; K1 = K2 = 1 a
             window (b = 32,768), exact on the explicit run's first launch.
             (b) the node's reactor (node/verify_root.blockchain_reactor
             over the node-wired executor and mempool, verifier None) syncs
             the chain's first 130 blocks from testutil/fastsync's loopback
             peer through the messages: the wall from start() to the
             consensus hand-off, the windows it dispatched (first height,
             heights), verify_speculative_total and verify_window_heights;
             the store and the handed-over state equal the chain's at 129,
             K1 = K2 = one a window, no peer stopped. Then the same sync with
             the installed guarded verifier's device failing from its second
             dispatch: it halts with device_fault set, no peer stopped, no
             hand-off, the store and the state at the first window's height.
             No fallback, the default breaker closed, no audit mismatch.
  23. consensus the consensus state machine, on a [verify] root of its own
             with the vote feed on at the reference's vote_storm settings
             (vote_batch_window_ms = 2, vote_batch_rows = 64): 100 ed25519
             validators of power 10 (the Cosmos SDK's DefaultMaxValidators)
             at the TestConsensusConfig timeouts (skip_timeout_commit on),
             KVStoreApp, a real WAL in a temporary directory; one node built
             by node/verify_root (handshake, then consensus_state: the WAL,
             the event bus, the [verify] vote feed, the [instrumentation]
             section) and 99 ValidatorStubs feeding it through
             send_peer_msg. (a) 4 heights (8 before phase 27 came) with
             the flight recorder on and the liveness watchdog started,
             each with a proposal (once the
             node has entered the height's round: the node's own when it
             proposes, else the stub proposer's through
             testutil/consensus.decide_proposal, one fresh tx in the
             mempool first) and then 99 signed prevotes and
             99 signed precommits (signed once the proposal is known,
             outside each height's timed wall): every height commits, every
             block and seen commit come back from the BlockStore, the WAL
             holds #ENDHEIGHT 1-8; K1 and K2 exact on one flush's inputs and
             on one LastCommit's; blocks a second and a height's p50 wall,
             votes through the feed against votes verified serially by
             reason, flushes by reason with rows and lanes a flush, K1 + K2
             launches a height split into flushes and LastCommit checks
             (four a height from height 2: enter_prevote, enter_precommit,
             _finalize_commit and apply_block each validate the block), and
             the consensus.finalize_commit, wal.*, verify.* and state.*
             span sums; then each height's waterfall (libs/critpath: the six
             timeline phases, other_seconds, the wal_append, wal_fsync and
             verify_dispatch overlays, the critical phase) and quorum curve
             (libs/quorumtrace: time to 1/3 and 2/3 of the power for
             prevotes and precommits, the pivotal validator, the vote-feed
             flushes joined to the height). It fails unless both analyzers
             count no error, every height's timeline phases plus other make
             its wall within 1e-6 s, verify_dispatch (the K1 + K2 flushes'
             time) is above 0 from height 2, every 2/3 crossing lies at or
             before the height's commit stamp, the watchdog counts no
             stall, and tools/trace_merge's merge of the flight dump passes
             testutil/consensus_net.validate_chrome_trace. (b) The same
             genesis with the feed and the recorder off, 2 heights, every
             peer vote verified on the host inside add_vote: blocks a
             second, the app hash at each height equal to (a)'s, nothing
             recorded. (c) A fresh
             KVStoreApp over (a)'s stores with (a)'s state kept at height 7:
             the handshake replays blocks 1-7 against the app and applies
             block 8 (K1 + K2 once for its 100-row LastCommit, exact); the
             state equals (a)'s at 8, the app at 8. (d) A node of (a)'s
             shape whose installed guarded verifier has its breaker tripped:
             the first flush raises, the state machine halts with
             device_fault set, no vote of that flush is added or verified
             on the host, the store stays at 0. No fallback, the default
             breaker closed, no audit mismatch.
  24. statesync state sync, on a default [verify] root of its own: a chain
             of 100 ed25519 validators of power 10 (the Cosmos SDK's
             DefaultMaxValidators), 66 heights of 256 kvstore txs a block,
             whose PersistentKVStoreApp snapshots every 32 heights at the
             [statesync] defaults (65,536-byte chunks, keep 3, format 1;
             set-up, the free verifier). A fresh node wired by
             node/verify_root (the mempool, the executor, the fast-sync
             reactor with fast_sync off, state_sync at the [statesync]
             defaults with enable on, trust_height 32 and header 32's hash)
             restores the tallest snapshot (64) from three in-process peers
             (testutil/statesync.py's hub), one of which serves corrupt
             chunks: the trust hops through the root's guarded
             verifier (K1 + K2 twice a hop), the chunks, the backfill of
             heights 49-64 through WindowPipeline on the guarded executor
             (K1 + K2 + the K7 tally once); the reference's assertions
             (tests/test_statesync.py:539): the corrupt sender banned, the
             state fields equal the producer's at 64, the app at 64 with
             header 65's app hash, the store's base 49 with every meta and
             commit, the validator records at 49-65, the progress. Then the
             hand-off: start_from_statesync fast-syncs height 65 from a
             loopback peer (K1 + K2 for its window and for the first
             block's LastCommit) and switches to a recorded consensus stub
             with the producer's state at 65. The restore's wall from
             start() to on_synced with its statesync.*, planner.* and
             verify.* spans, the chunk bytes a second, the hand-off's wall,
             K1 and K2 exact on the backfill's inputs. Then
             the restore on a fresh node with three honest peers and the
             default breaker tripped once the app's restore completes,
             before the backfill: it halts with
             device_fault (breaker_open), no state, validator record or
             block saved, no peer banned, no hand-off, the backfill
             launches nothing. No fallback, the breaker closed, no audit
             mismatch.
  25. localnet BASELINE.json config 1, the 4-validator kvstore localnet of
             docker-compose.yml, on a [verify] root of its own with the vote
             feed on (phase 23's settings): four validators of power 10, each
             a node/node.Node in this process started from its own home
             directory (testutil/node_net.make_node_net: genesis, FilePV,
             node key, sqlite stores under data/; the Node assembled from
             node/verify_root's pieces on the nodes' one shared [verify]
             root: the mempool, the executor, the handshake, consensus_state
             with its own WAL, vote feed, NodeMetrics and the flight
             recorder on, and node_reactors' whole set in node.py's order:
             consensus, blockchain, mempool with its QoS gate at the
             [mempool] defaults, evidence, statesync, and the peer exchange
             (pex on, its book not strict, sweeping every second);
             validator 3's key behind a remote signer, a
             SignerServiceEndpoint this process runs on a thread that dials
             the node's priv_validator_laddr over TCP and a secret
             connection; a PersistentKVStoreApp
             through the client creator that snapshots every 4 heights, a
             cut of the reference's default 0; its RPC server and its
             switch on 127.0.0.1 port 0) at the [consensus] defaults
             (timeout_commit 1 s) and the [p2p] defaults with
             allow_duplicate_ip = true (as a local testnet sets it), the
             other three nodes as persistent_peers: every connection a TCP dial, a secret
             connection (STS_BACKEND printed: cryptography where the host has
             it, crypto/sts_fallback otherwise; the H100 hosts measured in
             PERF.md have it), the NodeInfo exchange and an MConnection. A
             kvstore tx a height through broadcast_tx_commit on node 0's
             RPC over HTTP (gossip carries it to the others, through their
             QoS gates; the route's height and deliver_tx checked, and node
             3's tx and tx_search find it), validator 1's
             double sign at height 2 into node 0's evidence pool. Every
             validator reaches every height with the same block and app
             hashes; each tx of heights 1-6 reaches every other mempool by
             gossip and commits on every node; the evidence commits on every
             node; tm_monitor's NetworkMonitor over the four RPCs agrees with
             each node's /status height, its VERIFY column reads the ladder
             and its DEVICE column a closed breaker with no fallback; no QoS
             drop; no peer stopped for an error, but for at most
             one simultaneous-dial duplicate a pair before height 1 (its
             connection not the canonical one, closed by the other end by
             switch.py's canonical rule; printed); K1 + K2 launched by every
             validator from height 2 on through its vote feed and its
             LastCommit checks; the flight recorder's journeys hold first
             sends and arrivals and the gossip ledger links every ordered
             pair of validators; K1 and K2 exact on a captured launch. At
             height 6 (two past the snapshot at 4, so that both its next
             header and a fast-sync window exist) a fifth node joins: a
             non-validator with an empty store at the [statesync] defaults
             with enable on, trusting header 1 of node 0's store, knowing
             node 0 as its seed and no persistent peer: it learns the other
             validators by the peer exchange and dials them (or they, having
             learned it, dial in), and has all four as peers before it has
             followed. It restores the newest snapshot (trust hops K1 +
             K2 through the root's guarded verifier, the chunks, the backfill
             through the guarded executor: K1 + K2 + the K7 tally), hands
             off to fast sync (a window, K1 + K2, and its first block's
             LastCommit) and to consensus, reaches the validators' tip and
             follows 2 more heights with their block and app hashes; no peer
             stopped or banned but for a simultaneous dial closed by the
             canonical rule. Validator 3's precommit is in every committed
             LastCommit, each accepted by every node's K1 + K2 check and by
             the host. Every K1/K2 launch of the phase is counted
             by its source (each validator's flushes and LastCommit checks;
             the joining node's trust hops, backfill, fast-sync windows, its
             first block's LastCommit, flushes and LastCommit checks: each
             caller tags its thread, and a supervised dispatch carries the
             tag to its worker), and no launch is untagged. Then the RPC
             over the running net: 16 concurrent clients ask node 0 for
             /commit?verify=1 at every height with a canonical commit and
             /validators?verify=1 once each (the RPC's LaneFeed on the
             guarded device executor: K1 + K2 + the K7 tally; every verdict,
             tally and sigs_ok equal to the host's verify_commit), inside
             unsafe_start_profiler / unsafe_stop_profiler, whose Chrome
             trace must name K1's and K2's kernels; the port's RPCProvider +
             DynamicVerifier verify node 1's chain from 1 over
             lite_full_commit (K1 + K2); a WSEventClient on node 2, subscribed
             before the first height, saw NewBlock at every height; node 3's
             /metrics holds the reference's names; dump_device_health shows
             the breaker closed and no fallback; the joining node's status
             said catching_up at its start and not at the end. Prints the
             handshake's seconds a connection, the remote signer's round
             trips (count, p50, max), the join's seconds to all four
             validators as peers and how each was learned, tm_monitor's
             columns, blocks a second and a
             height's p50 wall, launches by source, flushes by reason, rows
             and lanes a flush, bytes sent and received a peer (NodeMetrics),
             txs received by gossip, QoS admitted and dropped by reason, the
             evidence's commit height, the restore's wall with its
             statesync.* spans, the hand-off's wall, the blocks fast-synced
             and the phase's seconds. No fallback, the breaker closed, no
             audit mismatch.
  26. cli     BASELINE.json config 1 as docker-compose.yml's containers run
             it, through the command line (cmd/tendermint.py,
             testutil/cli_net.py): `testnet --v 4 --chain-id cli-localnet`
             into a temporary directory, this process serving a
             KVStoreApp over abci/server.ABCIServer on tcp://127.0.0.1:0,
             and four `tendermint node` processes spawned at once on the
             card (the default --device): nodes 0-2 on --proxy_app
             kvstore, node 3 on that socket; each with the testnet's
             persistent peers, --p2p.allow_duplicate_ip true,
             --consensus.timeout_commit 0.3 (tests/test_localnet.py:65),
             the vote feed at phase 25's 2 ms, the unsafe routes and
             /metrics on; a `lite --chain-id cli-localnet` process on node
             0, spawned beside them. Once all four have 3 peers and height
             3: a tx through broadcast_tx_commit on node 3 (its CheckTx and
             DeliverTx cross the socket; abci_query on nodes 0 and 3 and
             the served app find it); the blocks and app hashes equal at
             every common height; /commit?verify=1 on node 1 at 1-3 equal
             to the host's verify_commit; every height from 1 to node 0's
             tip through the lite process, certified and equal to node 0's
             commit; node 3 SIGKILLed, nodes 0-2 commit 2 more heights,
             node 3 restarted with the same command reaches their tip with
             their app hash; tm_bench for 2 s at 50 tx/s on node 0's
             process, every tx it sent committed or in its mempool. Each
             node's dump_device_health shows the guarded verifier on the
             card, the breaker closed and no fallback event; every node runs
             the [p2p] default, the peer exchange on, and saves its address
             book at exit; its /metrics
             device-backend verify calls above 0 and no device fallback;
             the lite process's /frontend_stats its dispatches. Then
             SIGTERM to every process: each exits 0 within 10 s. Prints
             each process's seconds from spawn to its first RPC answer,
             blocks a second and a height's p50 (node 0's block times),
             the lite process's wall, the restart's seconds to the tip, and
             each process's GPU memory from nvidia-smi
             --query-compute-apps, each line with the card's name and
             power limit.
  27. sim     the chaos simulator (sim/, p2p/inproc.py) on a default
             [verify] root of its own: 4-validator SimNets whose nodes are
             wired by node/verify_root and share the root's guarded
             verifier. (a) baseline_determinism (seed 1, frozen clocks) on
             the card, then the same seed with every LastCommit check on
             HostBatchVerifier (side by side in two threads before phase
             30 came; a late precommit then fell out of the host net's
             LastCommits in 3 of 8 attempts): every node's
             commit hash equal over the deterministic prefix (round 0,
             every LastCommit canonical; testutil/sim_determinism), K1 +
             K2 launched by the card's LastCommit checks. (b) vote_storm
             (seed 12: a drop/duplicate/reorder storm, a double-signing
             validator, the vote feed at 2 ms / 64 rows): the evidence
             committed and marked in every pool, every node's vote feed
             dispatched on the card through the installed verifier, no
             fallback, the breaker closed, K1 and K2 held exact on the
             first launch's inputs. (c) testutil/sim_fault's card fault:
             FaultyDevice(TorchBatchVerifier) behind one guarded verifier
             the nodes share answers SIM_FAULT_OK calls, then fails every
             call: every node halts on DeviceDispatchError with no host
             fallback, no store passes the height being decided, every
             verdict before the fault equals the host's. Prints each part's
             seconds and launches.
  28. mesh    the multi-device lane split (parallel/mesh.py) on a
             DeviceMesh of four shards (cuda:0 four times on one card, the
             distinct cards in turn where there are more), on a [verify]
             root of its own whose audit samples 0.5 % of a dispatch's
             lanes. (a) K5 (K2's windowed two-lane ed25519 ladder, its
             digits from the scalars' bit words) against its plain version
             (the reference's bit-serial ladder) on the card at N = 10,240:
             the 10k commit's rows, its last 20 the Go edge window's (a
             flipped bit, a non-canonical R, an s with its top bits set, an
             order-8 key), exact on every row, the verdicts Go's; then on
             the first 2,560 and 3,072 rows (a quarter of N, and the shard
             the mesh route launches), exact against the same rows of the
             plain run; each time over 20 launches beside its bound over
             this design's products and over the reference's (at the
             IMAD.WIDE rate), with registers, stack and spills.
             (b) K6 (K3's design) the same way on the 10k secp256k1 commit with the
             secp256k1 edge window's rows. (c) both 10k commits through
             TorchBatchVerifier(mesh=): K5 and K6 once a shard, the verdicts
             the unsharded verifier's. (d) the 512 x 64 window of phase 10
             through verify_windows(mesh) in both reduce modes,
             verify_commit_window on the 2 x 2 (height, val) mesh and
             verify_block_window(mesh) over phase 22's 513 blocks: every
             lane verdict and int64 tally the flat path's, K1 + K2 once a
             shard (and the tally, on the device reduce), four shards in
             record_device_shards and a planner_mesh / window_mesh ledger
             entry, no fallback, the breaker closed. One card checks the
             split; it cannot time it.
  29. smokes  the port's operator smokes (tendermint_tpu_torch/tools), each
             on a default [verify] root of its own (tools/smoke_verify),
             as an operator runs them: (a) statesync_smoke (a 13-height
             chain, snapshots every 4, the trust hop and the backfill of
             [9..12]); (b) flight_smoke (4 validators, 2 silenced, the
             watchdog's stall within 6 s, the merged Chrome trace); (c)
             critpath_smoke (node 0 on a file WAL, every waterfall
             reconciled to 1e-6 s); (d) quorum_smoke (build_sim_net with
             the vote feed at 2 ms / 64 rows, validator 3 silenced, 25 %
             duplicates), K1 and K2 held exact on its first launch's
             inputs; (e) soak_smoke at 42 heights (the fault over (14,
             24], the crash at 28, a snapshot every 2; 63 before phase 30
             came); (f)
             bench_commit_path.summarize over phase 27's vote_storm result
             and one mempool_flood run (no second vote storm). Each part
             must exit green with K1 + K2 launched, no fallback, the
             breaker closed and no audit mismatch; round files go to a
             temporary directory the phase removes. Prints each part's
             seconds, heights and launches, (f)'s pooled commit p50/p99
             and phase table and (e)'s fleet commit p50/p99.
  30. native the host C accelerators on phase 22's chain (no second
             chain): tools/bench_native.write_inputs lays out its 513
             blocks' bytes and a WAL of the chain's precommits and
             #ENDHEIGHT markers (10,000 records or more) with a truncated
             copy; (a) and (b) tools/bench_native.run here, on the
             natives, and in a PythonChild, a fresh child interpreter with
             TM_NO_NATIVE_CODEC=1 that imports while (c) runs and is timed
             after the natives: every block's decode and encode, the
             part-set rehash, Header.hash, ValidatorSet.hash at 10,000
             validators and the WAL decode (each timed with the garbage
             collector off) must give equal digests (the
             truncated WAL the same prefix and error string), and each
             pair's seconds and factor are printed beside the card's name
             and power limit; phase 22's null, explicit and serial
             blocks/s and phase 21's are printed beside PERF.md section 5's
             earlier ranges (other machines: not a gain). (c) one window of
             NATIVE_WINDOW heights decoded by the native Reader and
             verified by blockchain/reactor.verify_block_window on a
             default [verify] root of the phase's own: one K1 and one K2
             launch, K1/K2 exact on that pack, the verdict equal to the
             same window decoded by _PyReader, no fallback, the breaker
             closed, no audit mismatch.

The window phase's routes and the backfill phase each make one traced call
(the p50 of 3 before phase 21, of 2 before phase 22: the fastsync replay
times the same 512 x 64 verifier route). To pay for phase 22 the default,
rpc, multisig and msm phases also take one traced call after the first
(3 before), the commit window's ladder its traced first call alone (4
calls before), phase 21 2 applications of the 10k LastCommit (3; 1 since
phase 27), the host-clock walls 3 repeats (5), and each kernel's plain time
on its main
path (K1, K2, K3 and K4) is the plain version's run for the exactness check
(two or three more runs before). Phase 23 is paid for by phase 19's msm
calls, which take the window's first 128 heights, not all 512; phase 24
by phase 23's serial run, 2 heights (4 before); phase 25 by phase 22's
chain, 513 blocks (1,025 before); phase 26 by phase 25's tm_bench (moved
into phase 26), phase 21's chain, 8 heights (16 before), and phase 22's
reactor, 129 heights (256 before), and the lite phase's scattered shape,
16 clients (32 before); phase 27 by phase 23's batched run, 4 heights (8
before) and phase 21's 10k LastCommit, applied once (twice before). Each
phase's line carries the seconds since the script began.

Each path's launch counts are set to 0 just before it and read just after;
the kernels line carries the main path's as ``launches``, the lite
phase's shapes' as ``lite_launches``, the votes phase's routes' as
``votes_launches`` (verifier, executor, secp: the mixed-key storm) and the
txs phase's as ``txs_launches``, phases 18 and 19's as ``msm_launches`` and
``commit_window_launches``, phase 20's parts' as ``mempool_launches``
(rate, parity, secp, fill, recheck), phase 21's as
``block_exec_launches`` (chain: CheckTx and apply_block; 10k: the first
application of block 2), phase 22's as ``fastsync_launches`` (guarded,
explicit, baseline, reactor) and phase 23's as ``consensus_launches`` ((a),
(b) and (c), each split into flushes and LastCommit checks) and phase
24's as ``statesync_launches`` (trust, backfill, handoff) and phase 25's
as ``localnet_launches`` (the validators' flushes and LastCommit checks,
and the joining node's by source under ``join``) and phase 26's as
``cli_launches`` (read from each process over its RPC: each node's
device-backend verify calls, one K1 and one K2 launch each, and the lite
process's frontend dispatches) and phase 27's as ``sim_launches``
(determinism: the card's LastCommit checks; vote_storm: its flushes and
LastCommit checks; fault: the answered calls) and phase 28's as
``mesh_launches`` (the verifier's two commits, the planner's two reduce
modes, the commit window, fast sync) and phase 29's as ``smoke_launches``
(statesync, flight, critpath, quorum, soak, bench) and phase 30's as
``native_launches`` (c); K4's own ``launches`` are the msm
route's 10,000-validator commit's, K5's and K6's the verifier's mesh
route's (phase 28 (c)). The line before the last two is the
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
import os
import platform
import queue
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.server import ABCIServer
from tendermint_tpu_torch.abci.examples.kvstore import (
    KVStoreApp,
    PersistentKVStoreApp,
    SignedKVStoreApp,
    extract_signed_tx_sig,
)
from tendermint_tpu_torch.blockchain import pool as bc_pool
from tendermint_tpu_torch.blockchain import reactor as bc_reactor
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.config import Config, default_config
from tendermint_tpu_torch.config.consensus import ConsensusConfig, consensus_test_config
from tendermint_tpu_torch.config.instrumentation import InstrumentationConfig
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.consensus.cstypes import RoundStepType
from tendermint_tpu_torch.consensus.messages import EndHeightMessage, VoteMessage
from tendermint_tpu_torch.consensus import wal as cwal
from tendermint_tpu_torch.consensus.wal import WAL
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import secp256k1 as secp
from tendermint_tpu_torch.crypto import sts_fallback
from tendermint_tpu_torch.crypto.batch import (
    GuardedBatchVerifier,
    HostBatchVerifier,
    SigItem,
    TorchBatchVerifier,
    get_batch_verifier,
    set_batch_verifier,
    verify_generic,
)
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PubKeyEd25519, PubKeySecp256k1
from tendermint_tpu_torch.encoding import codec as tcodec
from tendermint_tpu_torch.encoding import native as tnative
from tendermint_tpu_torch.frontend.aggregator import BatchingVerifier
from tendermint_tpu_torch.libs import breaker, trace
from tendermint_tpu_torch.libs.critpath import TIMELINE_PHASES, verify_seconds_for_height
from tendermint_tpu_torch.libs.quorumtrace import build_journeys, gossip_ledger
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.libs.metrics import (
    ConsensusMetrics,
    StateMetrics,
    StateSyncMetrics,
    get_frontend_metrics,
    get_verify_metrics,
)
from tendermint_tpu_torch.lite import DBProvider, DynamicVerifier, LiteError
from tendermint_tpu_torch.lite.proxy import LiteProxy, RPCProvider, serve_proxy
from tendermint_tpu_torch.mempool.mempool import MempoolError
from tendermint_tpu_torch.mempool.reactor import decode_tx_msg
from tendermint_tpu_torch.mempool.tx_verify import BatchTxVerifier
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.node.verify_root import configure_verify
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import ed25519_msm as em
from tendermint_tpu_torch.ops import ed25519_verify as k5v
from tendermint_tpu_torch.ops import fe
from tendermint_tpu_torch.ops import fe_secp256k1 as F
from tendermint_tpu_torch.ops import imad_probe
from tendermint_tpu_torch.ops import secp256k1_cuda as sc
from tendermint_tpu_torch.ops import secp256k1_verify as k6v
from tendermint_tpu_torch.p2p import errors as p2p_errors
from tendermint_tpu_torch.p2p.conn import secret_connection as p2p_sts
from tendermint_tpu_torch.p2p.transport import MultiplexTransport
from tendermint_tpu_torch.parallel import commit_verify as cv
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.parallel.mesh import DeviceMesh
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.rpc import client as rpc_client
from tendermint_tpu_torch.rpc.client import HTTPClient, WSEventClient
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.execution import BlockExecutor, InvalidBlockError
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
from tendermint_tpu_torch.statesync.store import SnapshotStore
from tendermint_tpu_torch import sim
from tendermint_tpu_torch.testutil import chain as tchain
from tendermint_tpu_torch.testutil import cli_net
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.testutil import consensus as tcs
from tendermint_tpu_torch.testutil import lite_chain as lc
from tendermint_tpu_torch.testutil import multisig as tm
from tendermint_tpu_torch.testutil import sim_determinism, sim_fault
from tendermint_tpu_torch.testutil import node_net as nn
from tendermint_tpu_torch.testutil import secp_signer
from tendermint_tpu_torch.testutil import votes as tv
from tendermint_tpu_torch.testutil import window as tw
from tendermint_tpu_torch.testutil.consensus_net import validate_chrome_trace
from tendermint_tpu_torch.testutil.fastsync import LoopbackSwitch, ServingPeer
from tendermint_tpu_torch.testutil.statesync import CorruptingStore, hub_net
from tendermint_tpu_torch.tools import bench_fastsync as bf
from tendermint_tpu_torch.tools import bench_native
from tendermint_tpu_torch.tools import chaos_smoke
from tendermint_tpu_torch.tools import (
    bench_commit_path,
    critpath_smoke,
    flight_smoke,
    quorum_smoke,
    soak_smoke,
    statesync_smoke,
)
from tendermint_tpu_torch.tools import tm_bench
from tendermint_tpu_torch.tools.tm_monitor import NetworkMonitor, _fmt_device, _fmt_verify
from tendermint_tpu_torch.tools import trace_merge
from tendermint_tpu_torch.types.block import Block, Commit
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType
from tendermint_tpu_torch.types.events import EventBus
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
# host-clock repeats after a first call (5 before the fastsync phase came)
WALL_REPS = 3
TIME_ITERS = 20
# the reference's fast-sync defaults: VERIFY_WINDOW = 512 heights
# (blockchain/reactor.py:54) of bench_fastsync.py's 64 validators
# (BASELINE.json config 3); 32,768 lanes, lane bucket 32,768, segments 512
WINDOW_H, WINDOW_V = 512, 64
# phase 19's two msm-path calls take the window's first 128 heights (8,192
# rows, its first fault, a flipped bit at height 85, included); the whole
# window before the consensus phase came (16-18 s a call, the host's parse)
MSM_WINDOW_H = 128
# traced repeats after a first call in the default, rpc, multisig and msm
# phases; the commit window's ladder counts its traced first call among them
# (3 before the fastsync phase came: each guarded repeat is mostly the
# audit's host oracle, 2-9 s)
WINDOW_REPS = 1
# the window's routes (phase 10) and the backfill stream (phase 11): the
# first call is traced and WINDOW_ROUTE_REPS more follow it (3 before the
# block_exec phase came, 2 before the fastsync phase: the fastsync phase's
# replay times the same 512 x 64 verifier route, and these calls paid for it)
WINDOW_ROUTE_REPS = 0
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
# scripts/bench_lite.py's 64 clients on the last 4 heights; 16 scattered
# clients (32 before the cli phase came, 64 before that), since the serial
# reference certifies each distinct height of theirs on the host (~1.1-1.5 s
# a height) within the smoke's time limit.
LITE_VALS, LITE_HEIGHTS, LITE_SEED = 100, 128, 11
LITE_CHANGES, LITE_CHANGE_N = (33, 65, 97), 34
LITE_CLIENTS, LITE_SCATTERED, LITE_TIPS, LITE_REJECT_CLIENTS = 64, 16, 4, 4
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
# settings, 8 heights of 64 signed txs (64 senders, nonces in order; 16
# before the cli phase came); then BASELINE.json config 2's 10,000-validator
# LastCommit through validate_block
BX_VALS, BX_POWER, BX_SEED = 100, 10, 11
BX_HEIGHTS, BX_TXS = 8, 64
BX_REPS = 1  # 3 before the fastsync phase came, 2 before the sim phase
BX_TIME0 = 1_700_000_000_000_000_000
BX_SPANS = ("state.validate", "verify.dispatch", "verify.audit", "state.exec",
            "state.begin_block_info", "state.update", "state.commit", "state.save")
# the fastsync phase: BASELINE.json config 3 at scripts/bench_fastsync.py's
# width (64 validators of power 10, KVStoreApp); 513 blocks, so that the
# reference's VERIFY_WINDOW = 512 gives one full window (1,025 blocks, two
# windows, before the localnet phase came); the node's reactor syncs the
# first 130 from a loopback peer (129 heights, more than one of the pool's
# 128-height request windows; 257 before the cli phase came)
FS_VALS, FS_BLOCKS, FS_WINDOW, FS_REACTOR_BLOCKS = 64, 513, 512, 130
FS_SYNC_TIMEOUT = 300.0
FS_TRACE_CAPACITY = 1 << 17
FS_SPANS = ("fastsync.window", "planner.pack", "verify.dispatch", "verify.audit",
            "fastsync.apply", "state.validate", "state.exec", "state.update", "state.commit",
            "state.save")
# the consensus phase: 100 ed25519 validators of power 10 (the Cosmos SDK's
# DefaultMaxValidators, the block_exec and lite width) at the TestConsensusConfig
# timeouts, the vote feed at the reference's vote_storm settings
# (sim/scenarios.py:352-358: [verify] vote_batch_window_ms = 2, vote_batch_rows
# = 64); 4 heights batched (8 before the sim phase came), 2 serially (4 before
# the statesync phase came: a serial height is about 1.1 s of host verifies)
CS_VALS, CS_HEIGHTS, CS_SERIAL_HEIGHTS = 100, 4, 2
CS_WINDOW_MS, CS_ROWS = 2.0, 64
CS_TIMEOUT = 120.0
CS_SPANS = ("consensus.finalize_commit", "wal.append", "wal.fsync", "verify.dispatch",
            "verify.audit", "state.validate", "state.exec", "state.update", "state.commit",
            "state.save")
# the statesync phase: the Cosmos SDK's DefaultMaxValidators (100, power 10),
# 66 heights of 256 kvstore txs a block, PersistentKVStoreApp's snapshots at
# the [statesync] defaults (65,536-byte chunks, keep 3, format 1) every 32
# heights (the reference's interval default is 0, off): snapshots at 32 and
# 64; a fresh node at the [statesync] defaults trusts header 32 and restores
# 64 from three peers, one of which serves corrupt chunks
SS_VALS, SS_POWER, SS_HEIGHTS, SS_TXS, SS_INTERVAL, SS_TRUST = 100, 10, 66, 256, 32, 32
SS_MIN_CHUNKS = 4
SS_TIMEOUT = 120.0
SS_SPANS = ("statesync.restore", "statesync.light_verify", "statesync.chunks",
            "statesync.backfill", "planner.pack", "planner.pack_device", "planner.dispatch",
            "planner.audit", "verify.dispatch", "verify.audit")
# the localnet phase: BASELINE.json config 1 (docker-compose.yml's 4-validator
# kvstore localnet), power 10, the [consensus] defaults, the vote feed at phase
# 23's settings, 6 heights (8 before the RPC checks came)
LN_VALS, LN_HEIGHTS, LN_WINDOW_MS, LN_ROWS = 4, 6, 2.0, 64
LN_TIMEOUT = 120.0
LN_FRAME_REPS = 50
# ... with the node's whole reactor set: the validators' PersistentKVStoreApp
# snapshots every 4 heights (the reference's interval default is 0, off); a
# tx a height into node 0 alone (gossip carries it); validator 1's double
# sign at height 2 into node 0's evidence pool. At 6 a fifth node, a
# non-validator with an empty store at the [statesync] defaults (trusting
# header 1 of node 0's store), joins by state sync over TCP and must follow 2
# more heights. It restores the snapshot at 4 (two past it, so that header 5
# and a fast-sync window exist)
LN_SNAPSHOT_INTERVAL, LN_JOIN_AT, LN_FOLLOW, LN_TRUST = 4, LN_HEIGHTS, 2, 1
LN_EVIDENCE_HEIGHT, LN_OFFENDER = 2, 1
LN_JOIN_TIMEOUT = 60.0
LN_SS_SPANS = ("statesync.restore", "statesync.light_verify", "statesync.chunks",
               "statesync.backfill")
# the peer exchange on every node, each PEX reactor sweeping every second (the
# reference's 30 s would cost the join a sweep; every node needs one period,
# as a receiver drops a peer that asks more often than a third of its own,
# and at 0.5 s a receive thread stalled a third of a second under the RPC
# burst read two requests a period apart as a flood in one CPU rehearsal of
# three);
# the fifth node knows node 0 as its seed and no persistent peer. Validator
# 3's key sits behind a remote signer (a SignerServiceEndpoint on a thread,
# over TCP and a secret connection); tm_monitor watches the four RPCs
LN_PEX_PERIOD, LN_SIGNER = 1.0, 3
LN_MONITOR_TIMEOUT = 20.0
LN_JOIN_SOURCES = ("trust", "backfill", "fastsync", "fastsync_last_commit", "flushes",
                   "last_commit")
# then the RPC: 16 clients x /commit?verify=1 at every height (and
# /validators?verify=1 once each) on node 0, the lite client on node 1, a
# NewBlock websocket on node 2 and /metrics on node 3 (tm_bench moved to the
# cli phase)
LN_RPC_CLIENTS = 16
LN_RPC_SOURCES = ("burst", "lite")
# K1's and K2's __global__ functions, as a CUDA trace names them
LN_KERNEL_NAMES = {"ed25519_prologue": "prologue_kernel", "ed25519_ladder": "ladder_kernel"}
# the reference's metric names a node's /metrics must hold (tests/test_ws_metrics.py)
LN_METRIC_NAMES = (
    "# TYPE tendermint_consensus_height gauge", "tendermint_consensus_validators 4",
    "tendermint_mempool_size", "tendermint_state_block_processing_time_count",
    "tendermint_consensus_block_interval_seconds_bucket",
    "# TYPE tendermint_verify_batch_size histogram",
    "# TYPE tendermint_consensus_step_duration_seconds histogram",
    "# TYPE tendermint_consensus_wal_fsync_seconds histogram",
    "# TYPE tendermint_p2p_peer_receive_bytes_total counter",
    "# TYPE tendermint_p2p_peer_send_bytes_total counter",
    "# TYPE tendermint_p2p_messages_received_total counter",
    "# TYPE tendermint_mempool_tx_size_bytes histogram", "# TYPE tendermint_p2p_peers gauge")

# the cli phase: BASELINE.json config 1 as docker-compose.yml runs it, four
# `tendermint node` processes from a `testnet` tree (power 1 each, the
# testnet's), --consensus.timeout_commit 0.3 as the reference's multi-process
# test (tests/test_localnet.py:65), the vote feed at phase 25's window; to
# height 3, then node 3 killed while the others commit 2 more, restarted to
# their tip; tm_bench for 2 s at 50 tx/s on node 0's process
CLI_VALS, CLI_HEIGHTS, CLI_AHEAD, CLI_CHAIN = 4, 3, 2, "cli-localnet"
CLI_TIMEOUT_COMMIT, CLI_WINDOW_MS = 0.3, LN_WINDOW_MS
CLI_TIMEOUT, CLI_STOP_S = 120.0, 10.0
CLI_TX = b"cli-socket=1"
CLI_BENCH_S, CLI_BENCH_RATE = 2.0, 50

# phase 29: the operator smokes (tendermint_tpu_torch/tools); the soak at
# 42 heights (the reference's 210 cut to a fifth; 63 before phase 30 came),
# its marks in proportion
SMOKE_SOAK_HEIGHTS = 42
SMOKE_PARTS = ("statesync", "flight", "critpath", "quorum", "soak", "bench")
NATIVE_WINDOW = 64  # phase 30 (c): heights in its one window (4,096 lanes, ~205 audited)
NATIVE_PAIRS = ("decode", "encode", "part_set", "header_hash", "valset_hash", "wal")
# PERF.md section 5's earlier ranges, taken on other machines: blocks/s
NATIVE_EARLIER = {"null": "690.77-931.77", "explicit": "670.55-816.25",
                  "serial": "39.74-43.87", "block_exec": "3.30"}

# phase 27: the chaos simulator (tendermint_tpu_torch/sim)
SIM_FAULT_OK = 8  # answered calls of (c)'s card device before it fails
SIM_ATTEMPTS = 2  # (a) is retried once when a wall-clock race cut its deterministic prefix short

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


T_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== [{time.perf_counter() - T_START:.1f} s] {name}", flush=True)


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


def cuda_once(fn):
    """fn() once, timed by CUDA events: (its result, device ms)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    k5v.reset_launches()
    k6v.reset_launches()


def read_launches() -> dict:
    return {**ec.launches, **sc.launches, **em.launches, **k5v.launches, **k6v.launches}


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


def kernel_resources(name: str) -> dict:
    """Each entry function of library ``name`` in the compiler's report of
    its build, by mangled name: its register line, registers, and the stack
    and spill bytes of its own frame."""
    out, fn = {}, None
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            fn = re.search(r"function '(\w+)'", line).group(1)
            out[fn] = {}
        elif fn and "stack frame" in line and "registers" not in out[fn]:
            stack, spill_st, spill_ld = (int(v) for v in re.findall(r"(\d+) bytes", line)[:3])
            out[fn].update(stack=stack, spill=spill_st + spill_ld)
        elif fn and "registers" in line:
            out[fn].update(registers=int(re.search(r"Used (\d+) registers", line).group(1)),
                           line=line.strip())
    return out


def registers(name: str) -> str:
    """The compiler's register line for library ``name``'s first kernel."""
    return next((r["line"] for r in kernel_resources(name).values() if "line" in r),
                "registers not reported")


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
    k1_ref, k1_plain_ms = cuda_once(lambda: ec.prologue_ref(*k1_in))
    err["ed25519_prologue"] = max(err["ed25519_prologue"], max_abs_diff(k1_out, k1_ref))
    k2_in = (consts, negax, ay) + tuple(k1_out)
    k2_out = ec.ladder(*k2_in)
    k2_ref, k2_plain_ms = cuda_once(lambda: ec.ladder_ref(*k2_in))
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
        # the plain versions' times are their runs for the exactness check
        "plain_ms": {"ed25519_prologue": k1_plain_ms, "ed25519_ladder": k2_plain_ms},
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
    ref, plain_ms = cuda_once(lambda: sc.ladder_ref(*ins))
    err["secp256k1_ladder"] = max(err["secp256k1_ladder"], max_abs_diff(out, ref))
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
        "plain_ms": plain_ms,  # its run for the exactness check
        "bound": least_ms(ins, out, ops, mul_rate),
        "table_bound": least_ms(ins, out, ops, op_rate),
        "b": b,
        "commit": sc_,
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
    """verify_window on one route: a first call, traced, with the launch
    counts set to 0 just before and read just after (K1 and K2 once per
    message-length group), then WINDOW_ROUTE_REPS more traced calls; returns
    the first verdict, the launches, the first call's wall, the p50 wall and
    the p50 of each span over every call."""
    spans = ("planner.pack", "planner.pack_device", "planner.dispatch", "planner.audit",
             "verify.dispatch", "verify.audit")
    reset_launches()
    planner.tally_launches["planner_tally"] = 0
    walls, parts = [], {n: [] for n in spans}
    trace.enable()
    try:
        for rep in range(1 + WINDOW_ROUTE_REPS):
            trace.reset()
            t0 = time.perf_counter()
            again = planner.verify_window(votes, powers, totals, use_device=use_device)
            walls.append(time.perf_counter() - t0)
            for n, v in span_seconds(spans).items():
                parts[n].append(v)
            if rep == 0:
                verdict = again
                launches = {**read_launches(), **planner.tally_launches}
            for k in ("ok", "tally", "committed", "sigs_ok"):
                check(np.array_equal(getattr(again, k), getattr(verdict, k)),
                      f"window {k} changed between calls")
    finally:
        trace.disable()
    for name in ("ed25519_prologue", "ed25519_ladder"):
        check(launches[name] == n_groups, f"window route use_device={use_device}: {name} "
              f"launched {launches[name]} times, want {n_groups}")
    check(launches["secp256k1_ladder"] == 0, "K3 launched on an ed25519 window")
    check(launches["planner_tally"] == (1 if use_device else 0),
          f"tally launches {launches['planner_tally']}")
    return verdict, launches, walls[0], statistics.median(walls), {
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
              f"{1 + WINDOW_ROUTE_REPS} traced; launches {launches}; breakdown (p50 s) "
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
    spans = ("planner.pack", "planner.pack_device", "planner.dispatch", "planner.audit")
    walls, parts = [], {n: [] for n in spans}
    trace.enable()
    try:
        for rep in range(1 + WINDOW_ROUTE_REPS):
            trace.reset()
            t0 = time.perf_counter()
            with captured_packs() as packs:
                again = run_pipeline(backfill_specs(votes, powers, totals))
            walls.append(time.perf_counter() - t0)
            for n, v in span_seconds(spans).items():
                parts[n].append(v)
            if rep == 0:
                verdicts, first_packs = again, packs
                launches = {**read_launches(), **planner.tally_launches}
            for k in VERDICT_KEYS:
                check(all(np.array_equal(getattr(a, k), getattr(b, k))
                          for a, b in zip(again, verdicts)), f"backfill {k} changed")
    finally:
        trace.disable()
    first_s = walls[0]
    b, _, _ = hold_k1_k2(first_packs[0], err, "backfill")
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
    check_guard_clean(before, "backfill")
    check(audits("ok") > audit_ok0, "no audited lane on the backfill")
    p50 = statistics.median(walls)
    part_s = {n: statistics.median(v) for n, v in parts.items()}
    flat = window["routes"]["device"]["p50_s"]
    print(f"  {n_sub} verdicts equal the window's; first {first_s * 1e3:.1f} ms; p50 "
          f"{p50 * 1e3:.1f} ms over {1 + WINDOW_ROUTE_REPS} traced, {p50 / flat - 1:+.1%} "
          f"against the flat window's device route ({flat * 1e3:.1f} ms); launches {launches}; "
          f"no fallback; breaker closed", flush=True)
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
    plan_b = [[int(h)] for h in rng.integers(2, LITE_HEIGHTS + 1, LITE_SCATTERED)]
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
    """The products the reference's schedule needs on these inputs, the
    bound's yardstick whatever K4's design: the tree's additions, the
    run/acc fold's, Horner's (nwin - 1 additions, (nwin - 1) c doublings),
    [s_b]B's off the 16-entry table (64 mixed additions, 256 doublings) and
    the final addition."""
    tree, fold = em.schedule_adds(sched)
    adds = tree + fold + (sched.nwin - 1) + 1
    doubles = (sched.nwin - 1) * sched.c + 4 * 64
    return adds * PT_ADD_PRODUCTS + doubles * PT_DOUBLE_PRODUCTS + 64 * PT_MADD_PRODUCTS


def k4_design_products(sched) -> int:
    """The products K4's own schedule does: the tree's additions, the
    suffix scan's and its tree's a window (em.fold_adds), the comb's 64
    mixed additions and 63 additions, Horner's and the final addition."""
    tree, _ = em.schedule_adds(sched)
    scan, fold_tree = em.fold_adds(sched.bkt.shape[1])
    adds = tree + sched.nwin * (scan + fold_tree) + 63 + (sched.nwin - 1) + 1
    doubles = (sched.nwin - 1) * sched.c
    return adds * PT_ADD_PRODUCTS + doubles * PT_DOUBLE_PRODUCTS + 64 * PT_MADD_PRODUCTS


K4_FUNCS = ("msm_level", "msm_fold", "msm_finish")


def flat_tensors(ins):
    pool, ias, ibs, bkt, sb = ins
    return [pool, *ias, *ibs, bkt, sb]


def time_k4_parts(ins, sched) -> dict:
    """Device ms of each of K4's sub-launches (CUDA events, K4_ITERS calls
    each): every tree level alone, all of them back to back as K4 runs them,
    the fold (with [s_b]B) and the finish."""
    pool, ias, ibs, bkt, sb = ins
    rows = em.msm_rows(pool, ias)
    em.msm_levels(rows, ias, ibs, pool.shape[0])
    levels = [cuda_ms(lambda ia=ia, ib=ib, s=s, d=d: em.msm_level(rows, ia, ib, s, d),
                      K4_ITERS, 1)
              for ia, ib, (s, d) in zip(ias, ibs, em.level_spans(ias, pool.shape[0]))]
    tree = cuda_ms(lambda: em.msm_levels(rows, ias, ibs, pool.shape[0]), K4_ITERS, 1)
    fold = cuda_ms(lambda: em.msm_fold(rows, bkt, sb), K4_ITERS, 1)
    acc, sbp = em.msm_fold(rows, bkt, sb)
    finish = cuda_ms(lambda: em.msm_finish(acc, sbp, sched.c), K4_ITERS, 1)
    return {"levels_ms": levels, "tree_ms": tree, "fold_ms": fold, "finish_ms": finish,
            "level_rows": [int(a.shape[0]) for a in ias]}


def window_items(window: dict) -> list:
    """The window phase's present cells as (pub, msg, sig) rows, in the
    order the commit window's msm route hands them to the MSM."""
    return [(x[0].bytes(), x[1], x[2]) for row in window["rows"][0] for x in row
            if x is not None]


def phase_k4(dev, sc_: tc.SignedCommit, window: dict, mul_rate: float, err: dict) -> dict:
    phase(f"k4: the ed25519 MSM kernel vs its plain version (msm_plain: limb for limb) and "
          f"the reference's schedule (msm_ref: verdict and group element) at the adversarial "
          f"window's size ({ADV_ROWS} rows), the {N_VALIDATORS}-validator commit's and the "
          f"{WINDOW_H} x {WINDOW_V} window's, seed {MSM_SEED}")
    pubs, msgs, sigs, _ = tc.go_edge_window(seed=0)
    shapes = {
        "adversarial": list(zip(pubs[:ADV_ROWS], msgs[:ADV_ROWS], sigs[:ADV_ROWS])),
        "commit": [(v.pub_key.bytes(), pc.sign_bytes(sc_.chain_id), pc.signature)
                   for v, pc in zip(sc_.valset.validators, sc_.commit.precommits)],
        # the window as it is, forged lanes and all: K4 rejects it, and the
        # non-identity final point it reaches must equal msm_plain's limb for limb
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
        plain, plain_ms = cuda_once(lambda: em.msm_plain(*ins))
        e = max_abs_diff(got, plain)
        err[K4] = max(err[K4], e)
        check(e == 0, f"k4 {label}: K4 differs from msm_plain by {e}")
        check(int(got[0].item()) == verdicts[label], f"k4 {label}: verdict {int(got[0].item())}")
        # the reference's serial schedule, on the card; not at the window,
        # where it takes some 5 s (the smoke's time limit)
        ref_ms = None
        if label != "window":
            ref, ref_ms = cuda_once(lambda: em.msm_ref(*ins))
            check(torch.equal(got[0].cpu(), ref[0].cpu()),
                  f"k4 {label}: verdict differs from msm_ref's")
            check(em.same_point(got[1].cpu(), ref[1].cpu()),
                  f"k4 {label}: the final point is not msm_ref's group element")
        ms = cuda_ms(lambda: em.msm(*ins), K4_ITERS, 1)
        parts = time_k4_parts(ins, sched)
        products, design = k4_products(sched), k4_design_products(sched)
        bound = least_ms(flat_tensors(ins), list(got), products, mul_rate)
        tree, fold = em.schedule_adds(sched)
        scan, fold_tree = em.fold_adds(sched.bkt.shape[1])
        chain = em.chain_ops(sched)
        vs_ref = ("" if ref_ms is None else f"msm_ref {ref_ms:.1f} ms, the same verdict and "
                  f"group element; ")
        print(f"  {label}: n {len(rows)}, m {2 * len(rows)}, c {sched.c}, nwin {sched.nwin}, "
              f"pool {pool.shape[0]} rows, {len(sched.ias)} levels {parts['level_rows']}, tree "
              f"adds {tree}; fold adds {sched.nwin * (scan + fold_tree)} "
              f"({scan} scan + {fold_tree} tree a window; the reference's {fold}); parse "
              f"{parse_s:.3f} s, z draws + schedule + pool {inputs_s:.3f} s; K4 {ms:.4f} ms "
              f"(levels " + ", ".join(f"{t:.4f}" for t in parts["levels_ms"])
              + f"; all {len(sched.ias)} back to back {parts['tree_ms']:.4f}; fold + [s_b]B "
              f"{parts['fold_ms']:.4f}; finish {parts['finish_ms']:.4f}); msm_plain "
              f"{plain_ms:.1f} ms, exact; {vs_ref}bound "
              f"{bound[0]:.4f} ms by {bound[1]} ({products:.3g} products of the reference's "
              f"schedule; this design's {design:.3g}), {bound[0] / ms:.1%} of it; longest "
              f"chain {chain['total']} dependent point operations (levels {chain['levels']}, "
              f"fold {chain['fold']} beside [s_b]B {chain['comb']}, Horner {chain['horner']}, "
              f"final 1; the reference's schedule {chain['reference_total']}); verdict "
              f"{int(got[0].item())}", flush=True)
        out[label] = {"ms": ms, "plain_ms": plain_ms, "ref_ms": ref_ms, "bound": bound,
                      "parts": parts, "products": products, "design_products": design,
                      "chain": chain, "c": sched.c, "nwin": sched.nwin, "tree_adds": tree,
                      "fold_adds": sched.nwin * (scan + fold_tree)}
    res = {f: r for fn, r in kernel_resources(K4).items() for f in K4_FUNCS
           if f"{f}_kernel" in fn}
    print("  K4 (ptxas): " + "; ".join(f"{f} {r['registers']} registers, {r['stack']} bytes "
                                       f"stack, {r['spill']} bytes spilled"
                                       for f, r in res.items()), flush=True)
    check(set(res) == set(K4_FUNCS), f"K4's compiler report names {sorted(res)}")
    check(all(r["stack"] == 0 and r["spill"] == 0 for r in res.values()),
          "a K4 kernel has a local-memory stack or spills")
    out["resources"] = res
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
    got, first_s, first_sp = traced(lambda: cv.verify_commit_window(win, total, device=dev))
    same(got, "commit window (ladder)")
    launches = {**read_launches(), **cv.tally_launches}
    check(launches["ed25519_prologue"] == n_groups and launches["ed25519_ladder"] == n_groups
          and launches["window_tally"] == 1 and launches["ed25519_msm"] == 0,
          f"commit window launches {launches}")
    walls, parts = [first_s], [first_sp]
    for _ in range(WINDOW_REPS - 1):
        again, wall, sp = traced(lambda: cv.verify_commit_window(win, total, device=dev))
        same(again, "commit window (ladder) again")
        walls.append(wall)
        parts.append(sp)
    ladder_p50 = statistics.median(walls)
    ladder_parts = {k: statistics.median(p.get(k, 0.0) for p in parts) for k in parts[0]}
    print(f"  ladder (K8): pack_commit_window {pack_s:.2f} s; first {first_s:.2f} s; p50 "
          f"{ladder_p50:.3f} s over {WINDOW_REPS} traced (the first included); parts (p50 s) "
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
    # and every other knob at its default (the 30 s dispatch deadline), on
    # the window's first MSM_WINDOW_H heights
    hm = MSM_WINDOW_H
    win_m = cv.pack_commit_window(raw_votes[:hm], powers[:hm])
    msm_root = configure_verify(VerifyConfig(ed25519_path="msm"), device=dev)
    check(msm_root.verifier.deadline == 30.0, "the msm root's dispatch deadline is not 30 s")
    retries_before = retries()
    try:
        reset_launches()
        got_m, msm_s, msm_parts = traced(lambda: cv.verify_commit_window(win_m, total,
                                                                         device=dev))
        for k, g in zip(("ok", "tally", "committed"), got_m):
            check(np.array_equal(g, getattr(want, k)[:hm]),
                  f"commit window (msm): {k} differs from the planner's")
        msm_launches = read_launches()
        check(msm_launches["ed25519_msm"] == 1 and msm_launches["ed25519_ladder"] >= 1,
              f"msm commit window launches {msm_launches}")
        reset_launches()
        plan_v, plan_s, plan_parts = traced(
            lambda: planner.verify_window(votes[:hm], powers[:hm], totals[:hm],
                                          use_device=True))
        plan_launches = read_launches()
        for k in VERDICT_KEYS:
            check(np.array_equal(getattr(plan_v, k), getattr(want, k)[:hm]),
                  f"verify_window under msm: {k} differs")
        check(plan_launches["ed25519_msm"] == 1, f"planner msm launches {plan_launches}")
        check_guard_clean(before, "commit window")
        check(retries() == retries_before, "an msm window dispatch was retried (a timeout or "
              "a device error under the default deadline)")
    finally:
        configure_verify(VerifyConfig(), device=dev)
    print(f"  msm, the first {hm} heights: verify_commit_window {msm_s:.2f} s, parts (s) "
          + ", ".join(f"{k} {t:.3f}" for k, t in msm_parts.items())
          + f"; launches {msm_launches}", flush=True)
    print(f"  msm, the first {hm} heights: verify_window(use_device=True) {plan_s:.2f} s, "
          f"parts (s) "
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


# -- phase 22: fast sync ------------------------------------------------------------


class FsConsensus:
    """The consensus reactor's hand-off, recorded."""

    def __init__(self):
        self.switched = threading.Event()
        self.state, self.blocks_synced, self.at = None, None, None

    def switch_to_consensus(self, state, blocks_synced: int) -> None:
        self.state, self.blocks_synced = state, blocks_synced
        self.at = time.perf_counter()
        self.switched.set()


class FsMetrics:
    """The two members of the node's metrics the reactor uses."""

    def __init__(self):
        self.fast_syncing = SimpleNamespace(set=lambda v: setattr(self, "syncing", v))
        self.syncing, self.timer_resets = None, 0

    def reset_block_timer(self) -> None:
        self.timer_resets += 1


class FailingDevice:
    """A device verifier on the card whose dispatches fail from the
    ``fail_from``-th on (earlier ones go to ``inner``)."""

    def __init__(self, inner, fail_from: int):
        self.inner, self.device, self.fail_from, self.calls = inner, inner.device, fail_from, 0

    def verify_ed25519_raw(self, pubs, msgs, sigs):
        self.calls += 1
        if self.calls >= self.fail_from:
            raise RuntimeError("injected device failure")
        return self.inner.verify_ed25519_raw(pubs, msgs, sigs)

    def verify_ed25519(self, items):
        return self.verify_ed25519_raw([i.pubkey for i in items], [i.msg for i in items],
                                       [i.sig for i in items])


@contextlib.contextmanager
def fs_windows():
    """Record (first height, heights verified) of every verify_block_window
    call the reactor makes while active, synchronous and speculative."""
    got, mtx, real = [], threading.Lock(), bc_reactor.verify_block_window

    def record(st, blocks, *args, **kwargs):
        out = real(st, blocks, *args, **kwargs)
        with mtx:
            got.append((blocks[0].height, out[0]))
        return out

    bc_reactor.verify_block_window = record
    try:
        yield got
    finally:
        bc_reactor.verify_block_window = real


def fs_state_line(st) -> tuple:
    return st.last_block_height, st.app_hash, st.marshal()


def fs_replay(chain, verifier, what: str, want, capture: bool = False) -> dict:
    """tools/bench_fastsync.replay at window FS_WINDOW, traced, with the
    launch counts set to 0 just before and read just after; it must end at
    ``want``'s height, app hash and state bytes."""
    reset_launches()
    trace.reset()
    trace.enable()
    try:
        with captured_packs() as packs:
            run = bf.replay(chain, verifier, FS_WINDOW)
        parts = span_seconds(FS_SPANS)
        check(trace.dropped() == 0, f"fastsync {what}: the trace ring dropped spans")
    finally:
        trace.disable()
    launches = read_launches()
    check(fs_state_line(run.state) == fs_state_line(want),
          f"fastsync {what}: the replay ended at height {run.state.last_block_height} with a "
          f"state that differs from the chain's at {want.last_block_height}")
    check(run.windows == [FS_WINDOW] * ((FS_BLOCKS - 1) // FS_WINDOW),
          f"fastsync {what}: windows {run.windows}")
    print(f"  {what}: {run.blocks_s:.2f} blocks/s ({run.seconds:.2f} s for "
          f"{FS_BLOCKS - 1}, windows {run.windows}); launches {launches}; spans (s) "
          + ", ".join(f"{n} {v:.3f}" for n, v in parts.items()), flush=True)
    return {"blocks_s": run.blocks_s, "seconds": run.seconds, "parts": parts,
            "launches": launches, "packs": packs if capture else None}


def fs_node(chain, verifier_cls=None):
    """A fresh node at genesis: a state DB, an app, the mempool, the
    executor and block store as node/verify_root wires them, and its
    fast-sync reactor with a recorded consensus hand-off, syncing from a
    loopback peer that serves the chain's first FS_REACTOR_BLOCKS blocks."""
    st0 = state_from_genesis(chain.fx.genesis)
    state_db = MemDB()
    sm_store.save_state(state_db, st0)
    app = KVStoreApp()
    conn = bx_consensus_conn(app)
    mp = verify_root.mempool(MempoolConfig(), conn, app).mempool
    _, ex = verify_root.block_executor(state_db, MemDB(), conn, mp, st0)
    store = BlockStore(MemDB())
    cons, metrics = FsConsensus(), FsMetrics()
    reactor = verify_root.blockchain_reactor(st0, ex, store, consensus_reactor=cons,
                                             metrics=metrics)
    check(reactor.verifier is None and reactor._fixed_window is None,
          "the node's reactor does not use the installed verifier and the auto window")
    sw = LoopbackSwitch(reactor)
    peer = ServingPeer("serving-peer", chain.fx.block_store, height=FS_REACTOR_BLOCKS)
    return SimpleNamespace(reactor=reactor, store=store, cons=cons, metrics=metrics, sw=sw,
                           peer=peer, conn=conn)


def fs_wait(cond, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def fs_reactor(chain, want) -> dict:
    """(b): the node-wired reactor syncs FS_REACTOR_BLOCKS blocks from the
    loopback peer and hands its state to consensus."""
    m = get_verify_metrics()
    spec0 = dict(m.speculative._values)
    hist0 = [list(m.window_heights._series[()][0]), m.window_heights._series[()][1],
             m.window_heights._series[()][2]]
    node = fs_node(chain)
    node.sw.connect(node.peer)
    reset_launches()
    with fs_windows() as windows:
        t0 = time.perf_counter()
        node.reactor.start()
        try:
            check(node.cons.switched.wait(FS_SYNC_TIMEOUT),
                  f"fastsync reactor: no switch to consensus in {FS_SYNC_TIMEOUT} s (store at "
                  f"{node.store.height()}, fault {node.reactor.device_fault})")
        finally:
            node.reactor.stop()
            node.conn.stop()
    wall = node.cons.at - t0
    launches = read_launches()
    top = FS_REACTOR_BLOCKS - 1
    check(node.store.height() == top and node.cons.blocks_synced == top,
          f"fastsync reactor: store at {node.store.height()}, synced {node.cons.blocks_synced}")
    check(fs_state_line(node.cons.state) == fs_state_line(want),
          f"fastsync reactor: the handed-over state differs from the chain's at {top}")
    for h in (1, top // 2, top):
        check(node.store.load_block(h).hash() == chain.blocks[h - 1].hash(),
              f"fastsync reactor: stored block {h} differs from the chain's")
    check(node.sw.stopped == [], f"fastsync reactor: peers stopped {node.sw.stopped}")
    check(node.reactor.device_fault is None and node.metrics.syncing == 0
          and node.metrics.timer_resets == 1, "fastsync reactor: fault or metrics")
    dispatched = [w for w in windows if w[1] > 0]
    for name in ("ed25519_prologue", "ed25519_ladder"):
        check(launches[name] == len(dispatched), f"fastsync reactor: {name} launched "
              f"{launches[name]} times for {len(dispatched)} window dispatches")
    check(all(n <= bc_pool.REQUEST_WINDOW - 1 for _, n in windows),
          f"fastsync reactor: a window above the pool's {bc_pool.REQUEST_WINDOW}: {windows}")
    spec = {k[0]: v - spec0.get(k, 0.0) for k, v in m.speculative._values.items()}
    series = m.window_heights._series[()]
    hist = {"buckets": dict(zip([str(int(b)) for b in m.window_heights.buckets] + ["+Inf"],
                                [a - b for a, b in zip(series[0], hist0[0])])),
            "sum": series[1] - hist0[1], "count": series[2] - hist0[2]}
    out = {"wall_s": wall, "blocks_s": top / wall, "windows": windows, "speculative": spec,
           "window_heights": hist, "launches": launches}
    print(f"  (b) reactor: {top} blocks from the loopback peer in {wall:.2f} s ({top / wall:.2f} "
          f"blocks/s, start() to switch_to_consensus); windows (first height, heights) "
          f"{windows}; verify_speculative_total {spec}; verify_window_heights {hist}; "
          f"launches {launches}; store at {top}, the handed-over state equals the chain's, "
          f"no peer stopped", flush=True)
    return out


def fs_fault(chain, root, dev) -> dict:
    """(b), with the installed guarded verifier's device failing from its
    second dispatch on: fast sync halts with device_fault set, no peer
    stopped, no hand-off, the store at the state's height."""
    br = breaker.CircuitBreaker(threshold=1, backoff_base=600.0, backoff_max=600.0)
    failing = FailingDevice(TorchBatchVerifier(dev), fail_from=2)
    guarded = GuardedBatchVerifier(failing, breaker=br)
    check(guarded.on_card, "the failing verifier is not on the card")
    node = fs_node(chain)
    node.sw.connect(node.peer)
    set_batch_verifier(guarded)
    try:
        with fs_windows() as windows:
            node.reactor.start()
            try:
                check(fs_wait(lambda: node.cons.switched.is_set()
                              or (node.reactor.device_fault is not None
                                  and not node.reactor.pool.is_running), FS_SYNC_TIMEOUT),
                      "fastsync fault: the reactor neither halted nor switched")
            finally:
                node.reactor.stop()
                node.conn.stop()
    finally:
        set_batch_verifier(root.verifier)
    fault = node.reactor.device_fault
    check(isinstance(fault, breaker.DeviceDispatchError), f"fastsync fault: {fault!r}")
    check(node.sw.stopped == [] and not node.cons.switched.is_set(),
          f"fastsync fault: peers stopped {node.sw.stopped}, switched "
          f"{node.cons.switched.is_set()}")
    first = windows[0][1] if windows else -1
    check(node.store.height() == node.reactor.state.last_block_height == first,
          f"fastsync fault: store at {node.store.height()}, state at "
          f"{node.reactor.state.last_block_height}, the first window verified {first}")
    print(f"  fault: the guarded verifier's device fails from its 2nd dispatch: halted with "
          f"device_fault {fault}; windows {windows}; the store and the state at {first} (the "
          f"first window); no peer stopped, no switch to consensus", flush=True)
    return {"store_height": first, "windows": windows, "fault": str(fault)}


def phase_fastsync(root, dev, err: dict) -> dict:
    """Phase 22: fast sync on the card, on a default [verify] root of its own."""
    phase(f"fastsync: a {FS_BLOCKS}-block chain of {FS_VALS} validators replayed at window "
          f"{FS_WINDOW} (guarded, explicit, null, serial), then the node's reactor over "
          f"{FS_REACTOR_BLOCKS} blocks from a loopback peer, and a device fault mid-sync")
    t_phase = time.perf_counter()
    check(get_batch_verifier() is root.verifier,
          "the default verifier is not the configuration root's guarded one")
    top = FS_REACTOR_BLOCKS - 1
    # set-up: the build applies every block with the free verifier; the
    # replays and the reactor verify every commit it signed
    chain = bf.build(FS_BLOCKS, FS_VALS, verifier=bf.NullVerifier(), keep=(top, FS_BLOCKS - 1))
    want = chain.states[FS_BLOCKS - 1]
    print(f"  built a {FS_BLOCKS}-block chain of {FS_VALS} validators in {chain.build_s:.1f} s "
          f"(set-up: {FS_BLOCKS * FS_VALS} signatures, every block applied)", flush=True)
    before = fallbacks()
    audit_ok0 = audits("ok")
    trace.reset(FS_TRACE_CAPACITY)
    runs = {"guarded": fs_replay(chain, None, "(a) guarded (the root's)", want),
            "explicit": fs_replay(chain, TorchBatchVerifier(dev), "(a) explicit "
                                  "TorchBatchVerifier()", want, capture=True),
            "null": fs_replay(chain, bf.NullVerifier(), "(a) null (the host's ceiling)", want)}
    n_win = (FS_BLOCKS - 1) // FS_WINDOW
    for what in ("guarded", "explicit"):
        got = runs[what]["launches"]
        check(got["ed25519_prologue"] == n_win and got["ed25519_ladder"] == n_win
              and got["secp256k1_ladder"] == 0,
              f"fastsync {what}: launches {got}, want K1 = K2 = {n_win}")
    check(all(v == 0 for v in runs["null"]["launches"].values()), "the null replay launched")
    b, _, _ = hold_k1_k2(runs["explicit"]["packs"][0], err, "fastsync window")
    check(b == FS_WINDOW * FS_VALS, f"the window's K1/K2 ran at b = {b}")
    sample = min(bf.BASELINE_SAMPLE_BLOCKS, FS_BLOCKS - 1)
    reset_launches()
    base = bf.baseline(chain, None, sample)
    base_launches = read_launches()
    check(base_launches["ed25519_prologue"] == sample,
          f"the serial baseline launched {base_launches}")
    print(f"  (a) serial baseline (verify_commit + apply_block a height, the root's guarded "
          f"verifier): {base:.2f} blocks/s over {sample}; launches "
          f"{base_launches}; K1/K2 exact on the explicit run's first window (b = {b})",
          flush=True)
    check_guard_clean(before, "fastsync replay")
    check(audits("ok") > audit_ok0, "no audited lane in the fastsync replay")
    reactor = fs_reactor(chain, chain.states[top])
    check_guard_clean(before, "fastsync reactor")
    fault = fs_fault(chain, root, dev)
    check(breaker.get_device_breaker().state == breaker.CLOSED,
          "the default breaker is not closed after the fault run")
    seconds = time.perf_counter() - t_phase
    print(f"  no fallback; breaker closed; no audit mismatch; phase {seconds:.1f} s", flush=True)
    return {"runs": {k: {n: v for n, v in r.items() if n != "packs"} for k, r in runs.items()},
            "baseline_blocks_s": base, "reactor": reactor, "fault": fault, "seconds": seconds,
            "chain": chain,
            "launches": {"guarded": runs["guarded"]["launches"],
                         "explicit": runs["explicit"]["launches"],
                         "baseline": base_launches, "reactor": reactor["launches"]}}


# -- phase 23: the consensus state machine -----------------------------------------------


def cs_vote_height(msg: bytes) -> int:
    """The height in a vote's sign-bytes (a type byte, then fixed64)."""
    return int.from_bytes(msg[1:9], "little", signed=True)


@contextlib.contextmanager
def captured_packs_by_height():
    """As ``captured_packs``, each pack with the height of its first
    message: a flush packs the votes of the height being decided, a
    LastCommit check the precommits of the height before."""
    packs, real = [], ec.packed_inputs

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        packs.append((cs_vote_height(args[1][0]), out[0]))
        return out

    ec.packed_inputs = record
    try:
        yield packs
    finally:
        ec.packed_inputs = real


@contextlib.contextmanager
def counted_host_verifies():
    """Every single-vote verify on the host, as (height, validator index)."""
    got, real = [], Vote.verify

    def verify(self, chain_id, pub_key):
        got.append((self.height, self.validator_index))
        return real(self, chain_id, pub_key)

    Vote.verify = verify
    try:
        yield got
    finally:
        Vote.verify = real


def cs_node(doc, pvs, ours: int, verify_cfg: VerifyConfig, dev, wal_dir: str,
            inst: InstrumentationConfig = None):
    """A node as node/verify_root wires one: a state DB and a KVStoreApp at
    genesis, the mempool and the executor (verifier None: the installed
    one), a block store, the ABCI handshake, then ``consensus_state`` with a
    real WAL in ``wal_dir``, the event bus, validator ``ours``'s key,
    ``verify_cfg``'s vote feed and the ``[instrumentation]`` section
    ``inst`` (default: the recorder off, no watchdog). The executor's
    ``validate_block`` records the heights whose LastCommit it checks (one
    K1 + K2 launch each)."""
    st0 = state_from_genesis(doc)
    state_db = MemDB()
    sm_store.save_state(state_db, st0)
    app = KVStoreApp()
    conn = bx_consensus_conn(app)
    mp = verify_root.mempool(MempoolConfig(), conn, app).mempool
    bus = EventBus()
    bus.start()
    evpool, ex = verify_root.block_executor(state_db, MemDB(), conn, mp, st0, event_bus=bus)
    bs = BlockStore(MemDB())
    st = verify_root.handshake(state_db, st0, bs, doc, conn)
    wal_file = os.path.join(wal_dir, "cs.wal", "wal")
    metrics = ConsensusMetrics()
    root = verify_root.consensus_state(
        consensus_test_config(), verify_cfg, st, ex, bs, mp, evpool, wal_file=wal_file,
        event_bus=bus, priv_validator=pvs[ours], metrics=metrics, device=dev,
        instrumentation=inst if inst is not None else InstrumentationConfig(watchdog=False),
        node_id="node0", root_dir=wal_dir)
    check(root.consensus_state.block_exec is ex and root.event_bus is bus
          and ex.verifier is None, "the consensus state is not wired to the node's executor")
    checks, real = [], ex.validate_block

    def validate_block(state, block, trusted_last_commit=False):
        if block.height > 1 and not trusted_last_commit:
            checks.append(block.height)
        return real(state, block, trusted_last_commit=trusted_last_commit)

    ex.validate_block = validate_block
    stubs = [tcs.ValidatorStub(pv, i) for i, pv in enumerate(pvs) if i != ours]
    return SimpleNamespace(cs=root.consensus_state, feed=root.vote_feed, wal_file=wal_file,
                           state_db=state_db, bs=bs, conn=conn, app=app, mp=mp, bus=bus,
                           stubs=stubs, by_addr={s.address: s for s in stubs}, checks=checks,
                           watchdog=root.watchdog, metrics=metrics)


def cs_stop(node) -> None:
    if node.watchdog is not None:
        node.watchdog.stop()
    if node.cs.is_running:
        node.cs.stop()
    check(node.cs._done.wait(CS_TIMEOUT), "consensus: the receive routine did not stop")
    if node.feed is not None:
        node.feed.close()
        node.feed.join(CS_TIMEOUT)
    node.conn.stop()
    node.bus.stop()


def cs_propose(node, h: int) -> tuple:
    """Height ``h``'s proposal: the node's own when it is the proposer, else
    the stub proposer's (``decide_proposal``, one fresh tx in the mempool
    first), sent once the node has entered the height's round (a complete
    proposal taken at NEW_HEIGHT would skip the round entry, and with it
    the flight recorder's start of the height). Returns (block id, the node
    proposed)."""
    cs = node.cs
    check(tcs.wait_for(lambda: cs.rs.height == h and cs.rs.step != RoundStepType.NEW_HEIGHT,
                       CS_TIMEOUT),
          f"consensus: height {h} never started (fault {cs.device_fault})")
    proposer = cs.get_round_state().validators.get_proposer().address
    if proposer != cs.priv_validator.address:
        stub = node.by_addr[proposer]
        node.mp.check_tx(b"cs-h%d=v%d" % (h, h))
        prop, block, parts = tcs.decide_proposal(cs, stub, h, 0)
        cs.set_proposal_and_block(prop, block, parts, f"peer{stub.index}")
        return prop.block_id, False
    check(tcs.wait_for(lambda: cs.get_round_state().proposal_block is not None
                       and cs.get_round_state().height == h, CS_TIMEOUT),
          f"consensus: the node's own proposal at {h} never completed")
    rs = cs.get_round_state()
    return BlockID(rs.proposal_block.hash(), rs.proposal_block_parts.header()), True


def cs_sign(node, bid: BlockID, h: int,
            types=(SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT)) -> list:
    """The stubs' prevotes, then their precommits, for ``bid``."""
    return [(VoteMessage(s.sign_vote(t, bid, h, 0)), f"peer{s.index}")
            for t in types for s in node.stubs]


def cs_run(node, heights: int, what: str, packs_at: int = 0) -> dict:
    """Drive ``heights`` heights: a proposal, then the stubs' signed votes
    (signed once the proposal is known, outside the timed part), sent
    through ``send_peer_msg``; a height's wall runs from its first vote sent
    to the state at that height. Launch counts are set to 0 before the run
    and read after it; the state at each height is kept."""
    cs = node.cs
    walls, sign_s, states, own = [], 0.0, {}, []
    packs = []
    reset_launches()
    node.mp.check_tx(b"cs-h1=v1")
    cs.start()
    t_run = time.perf_counter()
    for h in range(1, heights + 1):
        ctx = captured_packs_by_height() if h == packs_at else contextlib.nullcontext([])
        with ctx as got:
            bid, mine = cs_propose(node, h)
            own.append(mine)
            t0 = time.perf_counter()
            msgs = cs_sign(node, bid, h)
            sign_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            for m, peer in msgs:
                cs.send_peer_msg(m, peer)
            check(tcs.wait_for(lambda: cs.get_state().last_block_height >= h, CS_TIMEOUT,
                               interval=0.001),
                  f"consensus {what}: height {h} never committed (fault {cs.device_fault})")
            walls.append(time.perf_counter() - t0)
        packs.extend(got)
        states[h] = cs.get_state()
        check(states[h].last_block_height == h, f"consensus {what}: the state passed {h}")
    run_s = time.perf_counter() - t_run
    return {"walls": walls, "sign_s": sign_s, "states": states, "own": own, "run_s": run_s,
            "blocks_s": heights / sum(walls), "p50_ms": statistics.median(walls) * 1e3,
            "packs": packs}


def cs_check_store(node, heights: int, what: str) -> None:
    for h in range(1, heights + 1):
        block, meta, seen = (node.bs.load_block(h), node.bs.load_block_meta(h),
                             node.bs.load_seen_commit(h))
        check(block is not None and meta is not None and seen is not None,
              f"consensus {what}: block {h} or its seen commit is not in the store")
        check(block.hash() == meta.block_id.hash == seen.block_id.hash and seen.round() == 0,
              f"consensus {what}: the stored block {h} is not the one its commit names")


def cs_split(node, launches: dict, dispatches: int, what: str) -> dict:
    """K1 and K2 launches split into flushes (one a feed dispatch: a flush
    is one message-length group) and LastCommit checks (one each)."""
    k1, k2 = launches["ed25519_prologue"], launches["ed25519_ladder"]
    lc = len(node.checks)
    check(k1 == k2 == dispatches + lc and launches["secp256k1_ladder"] == 0
          and launches[K4] == 0,
          f"consensus {what}: launches {launches}, {dispatches} feed dispatches, {lc} "
          f"LastCommit checks")
    return {"flushes": dispatches, "last_commit": lc}


def flushes_in_overlays(wfs: dict, feed, what: str) -> tuple:
    """Every vote-feed flush's profiler entry is annotated with the heights
    it verified (its first and its span), and each height's
    verify_dispatch overlay is exactly what critpath's join gives over the
    entries recorded before that height's analysis: a prefix of the
    entries in record order, whose cut never moves back from one height to
    the next. Returns the flushes recorded after the analysis of a height
    they served, and their seconds for it."""
    entries = [e for e in get_profiler().entries() if e["kind"] == feed.profile_kind]
    check(len(entries) == feed.dispatches
          and all(e["height_base"] in wfs and e["height_base"] + max(e["heights"], 1) - 1
                  in wfs for e in entries),
          f"{what}: {len(entries)} flush entries for {feed.dispatches} dispatches, heights "
          f"{sorted({(e['height_base'], e['heights']) for e in entries})}")
    late, late_s, cut = 0, 0.0, 0
    for h in sorted(wfs):
        want = wfs[h]["verify_dispatch_seconds"]
        k = cut
        while abs(verify_seconds_for_height(entries[:k], h) - want) > 1e-9 and k < len(entries):
            k += 1
        check(abs(verify_seconds_for_height(entries[:k], h) - want) <= 1e-9,
              f"{what}: height {h}'s overlay {want} s is no prefix of its flushes after entry "
              f"{cut}")
        rest = [verify_seconds_for_height([e], h) for e in entries[k:]]
        late += sum(1 for x in rest if x > 0)
        late_s += sum(rest)
        cut = k
    return late, late_s


def cs_instruments(node) -> dict:
    """(a)'s per-height instruments: each committed height's waterfall
    (libs/critpath) and quorum curve (libs/quorumtrace), printed and held
    to the identities they promise; the flight dump merged into a Chrome
    trace that must validate."""
    cs = node.cs
    cp, qt, fl = cs.critpath.snapshot(), cs.quorumtrace.snapshot(), cs.flight.snapshot()
    check(cp["analysis_errors"] == 0 and qt["analysis_errors"] == 0,
          f"consensus (a): analysis errors critpath {cp['analysis_errors']}, quorum "
          f"{qt['analysis_errors']}")
    wfs = {wf["height"]: wf for wf in cp["records"]}
    qrs = {r["height"]: r for r in qt["records"]}
    flights = {r["height"]: r for r in fl["records"]}
    check(set(range(1, CS_HEIGHTS + 1)) <= set(wfs) and set(range(1, CS_HEIGHTS + 1)) <= set(qrs),
          f"consensus (a): waterfalls for {sorted(wfs)}, quorum records for {sorted(qrs)}")
    print(f"  (a) instruments (flight recorder on, watchdog started; ms): height: wall = "
          + " + ".join(TIMELINE_PHASES) + " + other | wal_append, wal_fsync, verify_dispatch | "
          "critical | prevote, precommit: 1/3, 2/3 (pivotal) | flushes joined", flush=True)
    critical = []
    for h in range(1, CS_HEIGHTS + 1):
        wf, qr = wfs[h], qrs[h]
        ph = wf["phases"]
        resid = sum(ph[p] for p in TIMELINE_PHASES) + wf["other_seconds"] - wf["wall_seconds"]
        check(abs(resid) <= 1e-6, f"consensus (a): height {h}'s phases miss its wall by {resid} s")
        check(h < 2 or wf["verify_dispatch_seconds"] > 0,
              f"consensus (a): no verify_dispatch time at height {h}")
        commit_t = flights[h]["commit"]["t"]
        curves = {}
        for kind in ("prevote", "precommit"):
            c = qr["curves"][kind]["crossings"]
            check(c["two_thirds"] is not None and c["two_thirds"]["t_ns"] <= commit_t,
                  f"consensus (a): height {h}'s {kind} 2/3 crossing {c['two_thirds']} is not at "
                  f"or before its commit stamp {commit_t}")
            curves[kind] = (c["third"]["seconds"], c["two_thirds"]["seconds"],
                            qr["curves"][kind]["pivotal_validator"])
        reasons = {}
        for f in qr["flushes"]:
            reasons[f["reason"]] = reasons.get(f["reason"], 0) + 1
        critical.append(wf["critical_path"])
        print(f"    {h}: {wf['wall_seconds'] * 1e3:.2f} = "
              + " + ".join(f"{ph[p] * 1e3:.2f}" for p in TIMELINE_PHASES)
              + f" + {wf['other_seconds'] * 1e3:.3f} | {ph['wal_append'] * 1e3:.2f}, "
              f"{ph['wal_fsync'] * 1e3:.2f}, {wf['verify_dispatch_seconds'] * 1e3:.2f} | "
              f"{wf['critical_path']} | "
              + ", ".join(f"{t * 1e3:.2f}, {tt * 1e3:.2f} ({pv})" for t, tt, pv in curves.values())
              + f" | {len(qr['flushes'])} {reasons}", flush=True)
    late, late_s = flushes_in_overlays(wfs, node.feed, "consensus (a)")
    stalls = node.watchdog.status()["stalls_total"]
    text = node.metrics.registry.expose_text()
    check(stalls == 0 and "tendermint_consensus_stalls_total 0" in text,
          f"consensus (a): the watchdog counted {stalls} stalls")
    merged = trace_merge.merge([fl])
    errors = validate_chrome_trace(merged, 1, min_commits_per_node=CS_HEIGHTS)
    check(not errors, f"consensus (a): the merged flight trace does not validate: {errors[:5]}")
    n_wf = sum(1 for e in merged["traceEvents"] if e.get("cat") == "critpath")
    print(f"    analysis errors 0 and 0; every height's timeline phases + other = its wall "
          f"within 1e-6 s; verify_dispatch > 0 from height 2; every flush annotated with its "
          f"heights, each overlay exactly its height's flushes up to its analysis ({late} "
          f"flushes, {late_s * 1e3:.2f} ms, finished after it); every 2/3 crossing at or before "
          f"its commit stamp; stalls 0 (the watchdog's EWMA "
          f"{node.watchdog.status()['block_interval_ewma_seconds']} s); the merged trace "
          f"validates ({len(merged['traceEvents'])} events, {n_wf} waterfall slices)",
          flush=True)
    return {"critical": critical}


def cs_batched(doc, pvs, ours, cfg, dev, wal_dir, err) -> dict:
    """(a): CS_HEIGHTS heights through the vote feed, with the flight
    recorder on and the liveness watchdog started through the
    [instrumentation] section."""
    node = cs_node(doc, pvs, ours, cfg, dev, wal_dir,
                   InstrumentationConfig(flight_recorder=True, watchdog=True))
    feed, cs = node.feed, node.cs
    check(cs.flight.enabled and node.watchdog is not None and node.watchdog.cons is cs,
          "consensus (a): the [instrumentation] section did not wire the recorder and watchdog")
    # the critical path reads the process profiler's entries: start it empty
    get_profiler().reset()
    node.watchdog.start()
    check(feed is not None and cs._vote_feed is feed and feed.window_s == CS_WINDOW_MS / 1e3
          and feed.max_rows == CS_ROWS, "the vote feed is not the [verify] section's")
    if dev.type == "cuda":
        check(feed.device.type == "cuda" and feed.verifier is None,
              "the vote feed does not run the installed verifier on the card")
    trace.reset(FS_TRACE_CAPACITY)
    trace.enable()
    try:
        run = cs_run(node, CS_HEIGHTS, "(a)", packs_at=2)
        spans = span_seconds(CS_SPANS)
        check(trace.dropped() == 0, "consensus (a): the trace ring dropped spans")
    finally:
        trace.disable()
        cs_stop(node)
    launches = read_launches()
    check(cs.device_fault is None, f"consensus (a): device fault {cs.device_fault}")
    cs_check_store(node, CS_HEIGHTS, "(a)")
    ends = sorted({tm.msg.height for tm in WAL(node.wal_file).iter_all()
                   if isinstance(tm.msg, EndHeightMessage)})
    check(set(range(1, CS_HEIGHTS + 1)) <= set(ends), f"consensus (a): the WAL's #ENDHEIGHT {ends}")
    split = cs_split(node, launches, feed.dispatches, "(a)")
    recs = feed.flush_records()["records"]
    per_height = []
    for h in range(1, CS_HEIGHTS + 1):
        fl = sum(1 for r in recs if r["groups"] and r["groups"][0][0] == h)
        per_height.append({"flushes": fl, "last_commit": node.checks.count(h)})
    check(sum(p["flushes"] for p in per_height) == feed.dispatches == len(recs),
          f"consensus (a): {len(recs)} flush records for {feed.dispatches} dispatches")
    check(all(p["last_commit"] == 4 for p in per_height[1:]) and per_height[0]["last_commit"] == 0,
          f"consensus (a): LastCommit checks a height {per_height}")
    flush_pack = next(p for hh, p in run["packs"] if hh == 2)
    lc_pack = next(p for hh, p in run["packs"] if hh == 1)
    b_f, _, _ = hold_k1_k2(flush_pack, err, "consensus flush")
    b_c, _, _ = hold_k1_k2(lc_pack, err, "consensus LastCommit")
    serial = {k: v for k, v in sorted(cs.serial_votes.items())}
    rows = [r["rows"] for r in recs]
    lanes = [r["votes"] for r in recs]
    out = {**{k: v for k, v in run.items() if k not in ("packs", "states")},
           "votes_in": feed.votes_in, "serial_votes": serial,
           "flushes": dict(feed.flushes), "rows_per_flush": statistics.mean(rows),
           "lanes_per_flush": statistics.mean(lanes), "max_lanes": max(lanes),
           "launches": launches, "split": split, "per_height": per_height, "spans": spans,
           "wal_end_heights": ends, "b_flush": b_f, "b_last_commit": b_c,
           "app_hashes": [run["states"][h].app_hash.hex() for h in range(1, CS_HEIGHTS + 1)]}
    check(feed.votes_in + cs.serial_votes["last_commit"] == len(node.stubs) * 2 * CS_HEIGHTS
          and cs.serial_votes["unknown_verdict"] == 0,
          f"consensus (a): {feed.votes_in} votes in the feed, serial {serial}")
    out["instruments"] = cs_instruments(node)
    print(f"  (a) batched: {CS_HEIGHTS} heights, {out['blocks_s']:.2f} blocks/s (a height's "
          f"wall from its first vote sent to its state, p50 {out['p50_ms']:.1f} ms; walls "
          + ", ".join(f"{w * 1e3:.1f}" for w in run["walls"])
          + f" ms); the stubs' signing {run['sign_s']:.2f} s outside them; own proposals at "
          f"{[h for h, m in enumerate(run['own'], 1) if m]}; votes through the feed "
          f"{feed.votes_in}, serial by reason {serial}; flushes {dict(feed.flushes)}, "
          f"{len(recs)} dispatches, rows a flush {out['rows_per_flush']:.2f}, lanes a flush "
          f"{out['lanes_per_flush']:.1f} (max {out['max_lanes']}); launches {launches} = "
          f"{split['flushes']} flushes + {split['last_commit']} LastCommit checks; per height "
          f"{[(p['flushes'], p['last_commit']) for p in per_height]}; spans (s) "
          + ", ".join(f"{n} {v:.3f}" for n, v in spans.items())
          + f"; the WAL's #ENDHEIGHT {ends}; every block and seen commit back from the store; "
          f"K1/K2 exact on a flush's inputs (b = {b_f}) and a LastCommit's (b = {b_c}); "
          f"PR 20 ran 1.93-2.46 blocks/s, p50 423.7-556.7 ms (H100, recorder off)",
          flush=True)
    return {"out": out, "states": run["states"], "node": node}


def cs_serial(doc, pvs, ours, dev, wal_dir, want_states) -> dict:
    """(b): the same genesis with the feed off, CS_SERIAL_HEIGHTS heights."""
    node = cs_node(doc, pvs, ours, VerifyConfig(), dev, wal_dir)
    check(node.feed is None and node.cs._vote_feed is None, "consensus (b): a vote feed is set")
    check(not node.cs.flight.enabled and node.watchdog is None,
          "consensus (b): the flight recorder is on or a watchdog built")
    try:
        run = cs_run(node, CS_SERIAL_HEIGHTS, "(b)")
    finally:
        cs_stop(node)
    check(len(node.cs.flight) == 0 and len(node.cs.critpath) == 0 and len(node.cs.quorumtrace) == 0,
          "consensus (b): the recorder off recorded something")
    launches = read_launches()
    split = cs_split(node, launches, 0, "(b)")
    for h in range(1, CS_SERIAL_HEIGHTS + 1):
        check(run["states"][h].app_hash == want_states[h].app_hash,
              f"consensus (b): the app hash at {h} differs from (a)'s")
    serial = {k: v for k, v in sorted(node.cs.serial_votes.items())}
    check(serial.get("no_feed", 0) >= len(node.stubs) * 2 * (CS_SERIAL_HEIGHTS - 1),
          f"consensus (b): serial votes {serial}")
    print(f"  (b) serial: {CS_SERIAL_HEIGHTS} heights, {run['blocks_s']:.2f} blocks/s (p50 "
          f"{run['p50_ms']:.1f} ms); every peer vote verified on the host inside add_vote "
          f"(serial by reason {serial}); launches {launches} = {split['last_commit']} "
          f"LastCommit checks; the app hash at each height equals (a)'s; the recorder off "
          f"recorded nothing", flush=True)
    return {"blocks_s": run["blocks_s"], "p50_ms": run["p50_ms"], "walls": run["walls"],
            "serial_votes": serial, "launches": launches, "split": split}


def cs_handshake(doc, a, err) -> dict:
    """(c): a fresh KVStoreApp over (a)'s stores with (a)'s state kept at
    CS_HEIGHTS - 1: the handshake replays the blocks before against the app
    and applies the last (K1 + K2 once for its LastCommit)."""
    top = CS_HEIGHTS
    db = MemDB()
    for k, v in a["node"].state_db.iterator():
        db.set(k, v)
    sm_store.save_state(db, a["states"][top - 1])
    app = KVStoreApp()
    conn = bx_consensus_conn(app)
    try:
        reset_launches()
        with captured_packs() as packs:
            t0 = time.perf_counter()
            st = verify_root.handshake(db, a["states"][top - 1].copy(), a["node"].bs, doc, conn)
            wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        conn.stop()
    check(launches["ed25519_prologue"] == launches["ed25519_ladder"] == 1
          and launches["secp256k1_ladder"] == launches[K4] == 0,
          f"consensus (c): launches {launches}")
    b, _, _ = hold_k1_k2(packs[0], err, "consensus handshake")
    check(b >= CS_VALS and st.marshal() == a["states"][top].marshal() and app.height == top,
          f"consensus (c): the handshake ended at {st.last_block_height} (app {app.height}) "
          f"with a state that differs from (a)'s at {top}")
    check(sm_store.load_state(db).marshal() == st.marshal(), "consensus (c): the state not saved")
    print(f"  (c) handshake: blocks 1-{top - 1} replayed against a fresh app, block {top} "
          f"applied in {wall * 1e3:.1f} ms in all; launches {launches} (its {b}-row bucket of "
          f"the {CS_VALS}-row LastCommit), exact; the state equals (a)'s at {top}, the app at "
          f"{app.height}", flush=True)
    return {"wall_ms": wall * 1e3, "launches": launches,
            "split": {"flushes": 0, "last_commit": launches["ed25519_prologue"]}}


def cs_fault(doc, pvs, ours, cfg, dev, wal_dir, root) -> dict:
    """(d): a node of (a)'s shape whose installed guarded verifier has its
    breaker tripped: the first flush raises and the state machine halts."""
    br = breaker.CircuitBreaker(threshold=1, backoff_base=600.0, backoff_max=600.0)
    br.record_failure("error")
    tripped = GuardedBatchVerifier(TorchBatchVerifier(dev), breaker=br)
    check(tripped.on_card and not br.allow(), "the tripped verifier is not on the card")
    node = cs_node(doc, pvs, ours, cfg, dev, wal_dir)
    cs = node.cs
    set_batch_verifier(tripped)
    try:
        reset_launches()
        with counted_host_verifies() as host:
            cs.start()
            bid, mine = cs_propose(node, 1)
            for m, peer in cs_sign(node, bid, 1, (SignedMsgType.PREVOTE,)):
                cs.send_peer_msg(m, peer)
            check(cs._done.wait(CS_TIMEOUT), "consensus (d): the state machine did not halt")
        launches = read_launches()
    finally:
        set_batch_verifier(root.verifier)
        cs_stop(node)
    fault = cs.device_fault
    stub_idx = {s.index for s in node.stubs}
    added = sum(1 for i in stub_idx if cs.rs.votes.prevotes(0).get_by_index(i) is not None)
    check(isinstance(fault, breaker.DeviceDispatchError), f"consensus (d): {fault!r}")
    check(added == 0 and not [v for v in host if v[1] in stub_idx]
          and cs.serial_votes["unknown_verdict"] == 0,
          f"consensus (d): {added} stub votes added, host verifies {len(host)}")
    check(node.bs.height() == 0 and cs.get_state().last_block_height == 0 and mine,
          f"consensus (d): the store at {node.bs.height()}")
    check(all(v == 0 for v in launches.values()), f"consensus (d): launches {launches}")
    print(f"  (d) fault: the installed guarded verifier's breaker tripped: the first flush "
          f"raised and the state machine halted with device_fault {fault}; no stub vote "
          f"added ({node.feed.votes_in} in the feed), none verified on the host; the store at "
          f"0; no launch", flush=True)
    return {"fault": str(fault), "votes_in": node.feed.votes_in}


def phase_consensus(dev, err: dict) -> dict:
    """Phase 23: the consensus state machine, on a [verify] root of its own
    with the vote feed on (the reference's vote_storm settings)."""
    phase(f"consensus: {CS_VALS} validators of power 10, one node wired by "
          f"node/verify_root.consensus_state and {CS_VALS - 1} stubs; {CS_HEIGHTS} heights "
          f"through the vote feed ({CS_WINDOW_MS:g} ms, {CS_ROWS} rows), {CS_SERIAL_HEIGHTS} "
          f"serially, the handshake, a device fault")
    t_phase = time.perf_counter()
    cfg = VerifyConfig(vote_batch_window_ms=CS_WINDOW_MS, vote_batch_rows=CS_ROWS)
    root = configure_verify(cfg, device=dev)
    check(get_batch_verifier() is root.verifier, "the root's guarded verifier is not installed")
    doc, pvs = tcs.make_genesis(CS_VALS)
    vals = state_from_genesis(doc).validators
    by_addr = {pv.address: pv for pv in pvs}
    sorted_pvs = [by_addr[v.address] for v in vals.validators]
    ours = [v.address for v in vals.validators].index(vals.get_proposer().address)
    before = fallbacks()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cs-") as tmp:
        a = cs_batched(doc, sorted_pvs, ours, cfg, dev, os.path.join(tmp, "a"), err)
        check_guard_clean(before, "consensus (a)")
        b = cs_serial(doc, sorted_pvs, ours, dev, os.path.join(tmp, "b"), a["states"])
        c = cs_handshake(doc, a, err)
        check_guard_clean(before, "consensus (b), (c)")
        d = cs_fault(doc, sorted_pvs, ours, cfg, dev, os.path.join(tmp, "d"), root)
    check(breaker.get_device_breaker().state == breaker.CLOSED,
          "the default breaker is not closed after the consensus phase")
    seconds = time.perf_counter() - t_phase
    print(f"  no fallback; breaker closed; no audit mismatch; phase {seconds:.1f} s", flush=True)
    return {"a": a["out"], "b": b, "c": c, "d": d, "seconds": seconds,
            "launches": {"a": a["out"]["split"], "b": b["split"], "c": c["split"]}}


# -- phase 24: state sync -----------------------------------------------------------------


def ss_producer(cfg: StateSyncConfig):
    """The producer chain: SS_HEIGHTS heights of SS_TXS kvstore txs a block,
    signed by SS_VALS validators; the app snapshots every SS_INTERVAL heights
    at the [statesync] defaults. Its blocks are applied with the free
    verifier (set-up); returns the fixture, the snapshot store and the state
    after each height."""
    snap_store = SnapshotStore(MemDB())
    apps, states = [], {}

    def app_factory():
        app = PersistentKVStoreApp()
        app.configure_snapshots(snap_store, SS_INTERVAL, cfg.snapshot_chunk_size,
                                cfg.snapshot_keep_recent, snapshot_format=cfg.snapshot_format)
        apps.append(app)
        return app

    def on_height(h, st):
        states[h - 1] = st
        return [f"k{h}-{j}=v{h}".encode() for j in range(SS_TXS)]

    fx = tchain.build_chain(n_vals=SS_VALS, n_heights=SS_HEIGHTS, chain_id="statesync-chain",
                            app_factory=app_factory, on_height=on_height,
                            verifier=bf.NullVerifier(), check_votes=False)
    states[SS_HEIGHTS] = fx.state
    for app in apps:
        app.wait_snapshots()
        check(app.snapshot_failures == 0, "statesync: a snapshot's production failed")
    return fx, snap_store, states


def ss_node(fx, cfg: StateSyncConfig):
    """A fresh node at genesis as node/verify_root wires one: a state DB, a
    PersistentKVStoreApp, the mempool, the executor (verifier None), an
    empty block store, the fast-sync reactor (fast_sync off, its hand-off
    recorded) on a loopback peer that serves the producer's blocks, and
    ``state_sync`` from ``cfg`` (its restore on the installed verifier and
    executor)."""
    st0 = state_from_genesis(fx.genesis)
    state_db = MemDB()
    sm_store.save_state(state_db, st0)
    app = SsRestoringApp()
    conn = bx_consensus_conn(app)
    mp = verify_root.mempool(MempoolConfig(), conn, app).mempool
    _, ex = verify_root.block_executor(state_db, MemDB(), conn, mp, st0)
    store = BlockStore(MemDB())
    cons = FsConsensus()
    bc = verify_root.blockchain_reactor(st0, ex, store, fast_sync=False, consensus_reactor=cons,
                                        metrics=FsMetrics())
    sw = LoopbackSwitch(bc)
    sw.connect(ServingPeer("serving-peer", fx.block_store))
    metrics = StateSyncMetrics()
    root = verify_root.state_sync(cfg, fx.genesis, conn, st0, state_db, store, app=app,
                                  mempool=mp, blockchain_reactor=bc, metrics=metrics)
    check(root is not None and root.syncer is not None and root.syncer.batch_verifier is None,
          "statesync: the node does not restore through the installed verifier")
    node = SimpleNamespace(app=app, conn=conn, mp=mp, ex=ex, store=store, state_db=state_db,
                           bc=bc, sw=sw, cons=cons, metrics=metrics, ss=root.reactor,
                           syncer=root.syncer, synced=None, synced_at=None, launches_at={})
    real = root.reactor.on_synced

    def on_synced(state, height):
        node.synced, node.synced_at = state, time.perf_counter()
        node.launches_at["synced"] = {**read_launches(), **planner.tally_launches}
        node.app_at_sync = (node.app.height, node.app._app_hash())
        real(state, height)

    root.reactor.on_synced = on_synced

    def restored():
        # the trust hops are done: their launches are the counts so far
        node.restored_ns = time.perf_counter_ns()
        node.launches_at["backfill"] = {**read_launches(), **planner.tally_launches}
        if node.trip_before_backfill:
            breaker.get_device_breaker().trip("statesync smoke: before the backfill")

    node.trip_before_backfill, node.restored_ns = False, None
    app.on_restored = restored
    return node


class SsRestoringApp(PersistentKVStoreApp):
    """The kvstore app, calling ``on_restored`` when the chunk it applies
    completes the restore. The protocol puts that moment between the trust
    hops (the snapshot's offer carries the app hash they verified) and the
    backfill (which begins once the restored app's Info matches); the phase
    checks that order against the statesync.* spans."""

    on_restored = None

    def apply_snapshot_chunk(self, req):
        h0 = self.height
        res = super().apply_snapshot_chunk(req)
        if self.height != h0 and self.on_restored is not None:
            self.on_restored()
        return res


def ss_restore(fx, snap_store, cfg, trip: bool = False, corrupt: bool = True):
    """The node restores from three hub peers (with ``corrupt``,
    ``peer-evil`` serves corrupt chunks); returns once it handed off or
    halted, with the launch counts when the app's restore completed (before
    the backfill), at ``on_synced`` and at the end."""
    node = ss_node(fx, cfg)
    node.trip_before_backfill = trip
    serve = StateSyncConfig()
    evil = CorruptingStore(snap_store) if corrupt else snap_store
    peers = [("peer-a", StateSyncReactor(serve, snapshot_store=snap_store,
                                         block_store=fx.block_store, state_db=fx.state_db)),
             ("peer-b", StateSyncReactor(serve, snapshot_store=snap_store,
                                         block_store=fx.block_store, state_db=fx.state_db)),
             ("peer-evil", StateSyncReactor(serve, snapshot_store=evil,
                                            block_store=fx.block_store, state_db=fx.state_db))]
    reset_launches()
    planner.tally_launches["planner_tally"] = 0
    node.bc.start()
    t0 = time.perf_counter()
    switches = hub_net([("peer-node", node.ss)] + peers)
    try:
        check(fs_wait(lambda: node.cons.switched.is_set() or node.ss.progress()["error"],
                      SS_TIMEOUT),
              f"statesync: neither a hand-off nor an error in {SS_TIMEOUT} s "
              f"({node.ss.progress()})")
    finally:
        for _, r in peers:
            r.stop()
        node.ss.stop()
        node.bc.stop()
        node.conn.stop()
    node.t0, node.switches, node.evil = t0, switches, evil
    node.launches_end = {**read_launches(), **planner.tally_launches}
    return node


def ss_between_trust_and_backfill(t_ns: int, events) -> bool:
    """Whether ``t_ns`` (perf_counter_ns, the tracer's clock) falls after
    every statesync.light_verify span and before every statesync.backfill
    span, with at least one of each."""
    t_us = t_ns / 1000.0
    trust = [e for e in events if e.get("ph") == "X" and e["name"] == "statesync.light_verify"]
    fill = [e for e in events if e.get("ph") == "X" and e["name"] == "statesync.backfill"]
    return (bool(trust) and bool(fill) and all(e["ts"] + e["dur"] <= t_us for e in trust)
            and all(e["ts"] >= t_us for e in fill))


def ss_diff(a: dict, b: dict) -> dict:
    return {k: a[k] - b.get(k, 0) for k in a}


def ss_check_restore(node, fx, states, snap) -> None:
    """The reference's assertions (tests/test_statesync.py:539), at H."""
    H = snap.height
    st, m = node.synced, node.metrics
    check("peer-evil" in node.ss._banned and node.evil.corrupted == 1,
          f"statesync: the corrupt sender was not banned ({node.ss._banned})")
    check(m.chunk_fetch._values.get(("bad",), 0) >= 1
          and m.chunk_fetch._values.get(("ok",), 0) >= snap.chunks,
          f"statesync: chunk fetches {m.chunk_fetch._values}")
    want = states[H]
    for f in ("last_block_height", "chain_id", "last_block_id", "app_hash",
              "last_results_hash", "last_block_time_ns", "last_block_total_tx"):
        check(getattr(st, f) == getattr(want, f), f"statesync: the restored state's {f}")
    for f in ("validators", "next_validators", "last_validators"):
        check(getattr(st, f).hash() == getattr(want, f).hash(),
              f"statesync: the restored state's {f}")
    check(st.app_hash == fx.block_store.load_block_meta(H + 1).header.app_hash,
          "statesync: the app hash is not header H+1's")
    check(node.app_at_sync == (H, want.app_hash),
          f"statesync: the app at {node.app_at_sync[0]} when the restore ended")
    base = max(1, H - StateSyncConfig().backfill_blocks + 1)
    check(node.store.base() == base and node.store.load_seen_commit(H) is not None,
          f"statesync: the store's base {node.store.base()}")
    for h in range(base, H + 1):
        check(node.store.load_block_meta(h) is not None
              and node.store.load_block_commit(h) is not None
              and node.store.load_block_meta(h).header.hash()
              == fx.block_store.load_block_meta(h).header.hash(),
              f"statesync: backfilled height {h}")
    for h in range(base, H + 2):
        check(sm_store.load_validators(node.state_db, h).hash() == fx.state.validators.hash(),
              f"statesync: the validator record at {h}")
    prog = node.ss.progress()
    check(prog["synced_height"] == H and prog["chunks_applied"] == snap.chunks
          and prog["error"] is None and node.ss.device_fault is None,
          f"statesync: progress {prog}")


def ss_fault(fx, snap_store, cfg) -> dict:
    """The restore again on a fresh node with the default breaker tripped
    once the app's restore completes, before the backfill: it halts with
    device_fault, nothing
    persisted, no ban, no hand-off."""
    node = ss_restore(fx, snap_store, cfg, trip=True, corrupt=False)
    breaker.get_device_breaker().reset()
    fault = node.ss.device_fault
    H = node.syncer.progress()["snapshot_height"]
    check(isinstance(fault, breaker.DeviceDispatchError) and fault.reason == "breaker_open",
          f"statesync fault: {fault!r}")
    check(type(fault).__name__ in (node.ss.progress()["error"] or ""),
          f"statesync fault: progress {node.ss.progress()}")
    check(node.restored_ns is not None, "statesync fault: the app's restore never completed")
    check(node.synced is None and not node.cons.switched.is_set(),
          "statesync fault: handed off")
    check(node.ss._banned == set() and all(sw.stopped == [] for sw in node.switches[1:])
          and node.switches[0].stopped == [], "statesync fault: a peer was banned")
    check(node.store.height() == 0 and node.store.base() == 0,
          f"statesync fault: the block store at {node.store.height()}")
    check(sm_store.load_state(node.state_db).last_block_height == 0,
          "statesync fault: a state was saved")
    try:
        sm_store.load_validators(node.state_db, H)
        check(False, f"statesync fault: a validator record at {H} was saved")
    except sm_store.NoValSetForHeightError:
        pass
    tail = ss_diff(node.launches_end, node.launches_at["backfill"])
    check(tail["ed25519_prologue"] == tail["ed25519_ladder"] == tail["planner_tally"] == 0,
          f"statesync fault: the backfill launched {tail}")
    print(f"  fault: the default breaker tripped before the backfill: halted with "
          f"device_fault {fault}; the app restored at {node.app.height} (it took the chunks, "
          f"as the reference leaves it); no state, validator record or block saved, no peer "
          f"banned (three honest peers), no hand-off; the backfill launched nothing",
          flush=True)
    return {"fault": str(fault), "app_height": node.app.height}


def phase_statesync(root, dev, err: dict) -> dict:
    """Phase 24: state sync on the card, on a default [verify] root of its own."""
    phase(f"statesync: a {SS_HEIGHTS}-height chain of {SS_VALS} validators, {SS_TXS} kvstore "
          f"txs a block, snapshots every {SS_INTERVAL}; a fresh node trusting header "
          f"{SS_TRUST} restores the tallest from three peers (one serving corrupt chunks), "
          f"backfills, fast-syncs the next height and hands off; then a tripped breaker")
    t_phase = time.perf_counter()
    check(get_batch_verifier() is root.verifier,
          "the default verifier is not the configuration root's guarded one")
    defaults = StateSyncConfig()
    fx, snap_store, states = ss_producer(defaults)
    snaps = snap_store.list()
    sizes = {s.height: sum(len(snap_store.load_chunk(s.height, s.format, i))
                           for i in range(s.chunks)) for s in snaps}
    check([s.height for s in snaps] == list(range(SS_INTERVAL * (SS_HEIGHTS // SS_INTERVAL),
                                                  0, -SS_INTERVAL)),
          f"statesync: snapshots at {[s.height for s in snaps]}")
    snap = snaps[0]
    check(snap.chunks >= SS_MIN_CHUNKS, f"statesync: the snapshot spans {snap.chunks} chunks")
    print(f"  built in {time.perf_counter() - t_phase:.1f} s (set-up); snapshots "
          + ", ".join(f"{s.height}: {sizes[s.height]:,} bytes in {s.chunks} chunks"
                      for s in snaps), flush=True)
    cfg = StateSyncConfig(enable=True, trust_height=SS_TRUST,
                          trust_hash=fx.block_store.load_block_meta(SS_TRUST).header.hash().hex())
    before = fallbacks()
    audit_ok0 = audits("ok")
    trace.reset(FS_TRACE_CAPACITY)
    trace.enable()
    try:
        with captured_packs() as packs:
            node = ss_restore(fx, snap_store, cfg)
        spans = span_seconds(SS_SPANS)
        events = trace.export()
        check(trace.dropped() == 0, "statesync: the trace ring dropped spans")
    finally:
        trace.disable()
    check(node.synced is not None and node.cons.switched.is_set(),
          f"statesync: no hand-off ({node.ss.progress()}, fault {node.bc.device_fault})")
    H = snap.height
    ss_check_restore(node, fx, states, snap)
    check(node.restored_ns is not None and ss_between_trust_and_backfill(node.restored_ns, events),
          "statesync: the app's restore did not complete between the trust hops and the "
          "backfill, so the launches cannot be split there")
    restore_s = node.synced_at - node.t0
    handoff_s = node.cons.at - node.synced_at
    top = node.cons.state
    check(node.cons.blocks_synced == SS_HEIGHTS - 1 - H and node.store.height() == SS_HEIGHTS - 1
          and top.last_block_height == SS_HEIGHTS - 1,
          f"statesync: the hand-off synced {node.cons.blocks_synced} (store "
          f"{node.store.height()})")
    for f in ("app_hash", "last_block_id", "last_results_hash"):
        check(getattr(top, f) == getattr(states[SS_HEIGHTS - 1], f),
              f"statesync: the handed-over state's {f}")
    check(node.sw.stopped == [] and node.bc.device_fault is None,
          f"statesync: fast sync stopped {node.sw.stopped}")
    at_bf, at_sync = node.launches_at["backfill"], node.launches_at["synced"]
    trust = dict(at_bf)
    backfill = ss_diff(at_sync, at_bf)
    handoff = ss_diff(node.launches_end, at_sync)
    window = range(max(1, H - defaults.backfill_blocks + 1), H + 1)
    groups = len({len(pc.sign_bytes(fx.chain_id)) for h in window
                  for pc in fx.block_store.load_block_commit(h).precommits if pc is not None})
    n_sub = -(-len(window) // BACKFILL_SUBWINDOW)
    check(trust["ed25519_prologue"] == trust["ed25519_ladder"] >= 2
          and trust["planner_tally"] == 0 and trust["secp256k1_ladder"] == trust[K4] == 0,
          f"statesync: the trust hops launched {trust}")
    check(backfill["ed25519_prologue"] == backfill["ed25519_ladder"] == groups
          and backfill["planner_tally"] == n_sub and backfill["secp256k1_ladder"] == 0
          and backfill[K4] == 0,
          f"statesync: the backfill launched {backfill}, want K1 = K2 = {groups} (one a "
          f"sub-window and message-length group), the tally {n_sub}")
    check(handoff["ed25519_prologue"] == handoff["ed25519_ladder"] >= 2
          and handoff["planner_tally"] == 0,
          f"statesync: the hand-off launched {handoff}, want its window and the first "
          f"synced block's LastCommit")
    b_t = packs[0][1].shape[1]
    b_b, _, _ = hold_k1_k2(packs[trust["ed25519_prologue"]], err, "statesync backfill")
    check_guard_clean(before, "statesync")
    check(audits("ok") > audit_ok0, "statesync: no audited lane")
    chunk_bytes = sizes[H]
    chunk_rate = chunk_bytes / spans["statesync.chunks"]
    print(f"  restore of {H}: {restore_s:.3f} s from start() to on_synced (the discovery "
          f"wait {defaults.discovery_time:g} s of it); spans (s) "
          + ", ".join(f"{n} {v:.3f}" for n, v in spans.items())
          + f"; {chunk_bytes:,} chunk bytes at {chunk_rate / 1e6:.2f} MB/s over the chunks "
          f"span; the corrupt sender banned; the state, the app ({node.app.height}), the "
          f"backfill [{node.store.base()}..{H}] and the validator records equal the "
          f"producer's", flush=True)
    print(f"  launches: trust hops {trust['ed25519_prologue']} K1 + K2 (two a hop: the hop's "
          f"verify_commit and the certification's; b = {b_t}); backfill "
          f"{groups} K1 + K2 (b = {b_b}) and {backfill['planner_tally']} K7 tally; hand-off "
          f"{handoff['ed25519_prologue']} K1 + K2 (its window and the first block's "
          f"LastCommit); K1/K2 exact on the backfill's inputs", flush=True)
    print(f"  hand-off: start_from_statesync fast-synced {node.cons.blocks_synced} block(s) to "
          f"{top.last_block_height} and switched in {handoff_s * 1e3:.1f} ms; the state equals "
          f"the producer's; no peer stopped", flush=True)
    fault = ss_fault(fx, snap_store, cfg)
    check(breaker.get_device_breaker().state == breaker.CLOSED,
          "the default breaker is not closed after the fault run")
    seconds = time.perf_counter() - t_phase
    print(f"  no fallback; breaker closed; no audit mismatch; phase {seconds:.1f} s", flush=True)
    return {"restore_s": restore_s, "handoff_s": handoff_s, "spans": spans,
            "chunk_bytes": chunk_bytes, "chunks": snap.chunks, "chunk_rate": chunk_rate,
            "sizes": sizes, "fault": fault, "seconds": seconds,
            "launches": {"trust": trust, "backfill": backfill, "handoff": handoff}}


# -- phase 25: the localnet --------------------------------------------------------------


@contextlib.contextmanager
def timed_upgrades():
    """The seconds of every connection upgrade the transports run while
    active (the secret connection's handshake and the NodeInfo exchange),
    dialed and accepted alike."""
    got, mtx, real = [], threading.Lock(), MultiplexTransport._upgrade

    def upgrade(self, sock, dialed_id):
        t0 = time.perf_counter()
        out = real(self, sock, dialed_id)
        with mtx:
            got.append(time.perf_counter() - t0)
        return out

    MultiplexTransport._upgrade = upgrade
    try:
        yield got
    finally:
        MultiplexTransport._upgrade = real


def ln_frame_ms(aead_cls) -> tuple:
    """ms to seal and to open one secret-connection frame with ``aead_cls``
    (a ChaCha20-Poly1305 of either backend), before the nodes start."""
    aead = aead_cls(bytes(range(32)))
    frame, nonce = bytes(p2p_sts.TOTAL_FRAME_SIZE), bytes(12)
    t0 = time.perf_counter()
    for _ in range(LN_FRAME_REPS):
        sealed = aead.encrypt(nonce, frame, None)
    t1 = time.perf_counter()
    for _ in range(LN_FRAME_REPS):
        aead.decrypt(nonce, sealed, None)
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3 / LN_FRAME_REPS, (t2 - t1) * 1e3 / LN_FRAME_REPS


def ln_stopped_peers(nodes, wrap=None, into=None, ids=None) -> tuple:
    """Every peer a node's switch stops for an error, as (time, node, peer
    node, reason, whether its connection is the canonical one), and every
    duplicate connection a switch closes by its canonical rule (switch.py's
    _add_peer: a new connection refused, or an old one evicted), as (node,
    peer node). A call for a peer object the set no longer holds stops
    nothing (switch.py's stale-peer rule) and is not counted. Only the
    switches of ``wrap`` (default all) are recorded, into ``into`` when
    given. ``ids`` (node ID -> index) is shared by later calls, so that a
    switch wrapped earlier names a node added since."""
    idx = ids if ids is not None else {}
    idx.update({n.switch.node_id: i for i, n in enumerate(nodes)})
    stopped, closed = into if into is not None else ([], [])
    for i, n in enumerate(nodes):
        if wrap is not None and n not in wrap:
            continue
        sw = n.switch
        real_stop, real_add, real_remove = (sw.stop_peer_for_error, sw._add_peer,
                                            sw._stop_and_remove_peer)

        def record(peer, reason, i=i, sw=sw, real=real_stop):
            if sw.peers.get(peer.id) is peer:
                stopped.append((time.perf_counter(), i, idx.get(peer.id), reason,
                                sw._conn_is_canonical(peer.outbound, peer.id)))
            return real(peer, reason)

        def add_peer(up, persistent=False, i=i, real=real_add):
            try:
                return real(up, persistent=persistent)
            except p2p_errors.SwitchDuplicatePeerIDError as e:
                closed.append((i, idx.get(e.peer_id)))
                raise

        def remove(peer, reason, i=i, real=real_remove):
            if reason == "duplicate (non-canonical)":
                closed.append((i, idx.get(peer.id)))
            return real(peer, reason)

        sw.stop_peer_for_error, sw._add_peer, sw._stop_and_remove_peer = record, add_peer, remove
    return stopped, closed


def ln_unexcused_stops(stopped: list, closed: list, before: float) -> tuple:
    """Split the stops of ``ln_stopped_peers`` into the dial races it
    excuses and the rest. Both ends of a pair dial each other at once; each
    switch keeps the connection the smaller node ID dialed and closes the
    other, so an end that took the other one first sees it close and
    redials. A stop is excused only if it came before ``before`` (height 1),
    its reason is that close, its connection is not the canonical one, the
    other end closed a duplicate from this node by the canonical rule, and
    it is the first such stop of its pair."""
    races, rest, pairs = [], [], set()
    for t, i, j, reason, canonical in stopped:
        pair = frozenset((i, j))
        closed_conn = (isinstance(reason, (BrokenPipeError, ConnectionResetError))
                       or (type(reason) is ConnectionError and str(reason) == "connection closed"))
        if (t <= before and closed_conn and not canonical and (j, i) in closed
                and pair not in pairs):
            pairs.add(pair)
            races.append((i, j, repr(reason)))
        else:
            rest.append((round(t - before, 3), i, j, repr(reason), canonical))
    return races, rest


def ln_gossip(nodes, others=()) -> dict:
    """The flight recorders' gossip stamps of the committed heights: each
    height's and kind's vote journeys with a first send from their signer,
    each node's first arrivals, and the gossip ledger's links by node (a
    node of ``others``, which records nothing, may be a link's peer)."""
    ids = [n.switch.node_id for n in nodes]
    idx = {nid: i for i, nid in enumerate(ids + [n.switch.node_id for n in others])}
    dumps = [n.consensus_state.flight.snapshot() for n in nodes]
    journeys = [j for j in build_journeys(dumps) if 1 <= j["height"] <= LN_HEIGHTS]
    ledger = gossip_ledger(dumps, journeys=journeys)
    links = {(idx.get(lk["peer"]), idx[lk["node"]]) for lk in ledger["links"]
             if lk["first_sightings"] > 0}
    # a link is a gossiping peer and a receiving node, two nodes of the net;
    # every node took first sightings from two peers at least and gave them
    # to two at least (which peer is first with a vote is a race)
    check(all(p is not None and p != q for p, q in links)
          and all(sum(1 for p, q in links if q == i) >= 2
                  and sum(1 for p, q in links if p == i) >= 2 for i in range(len(nodes))),
          f"localnet: the gossip ledger links {sorted(links, key=str)}")
    sent, arrived = {}, {}
    for j in journeys:
        key = (j["height"], j["kind"])
        if j["origin"] == ids[j["validator_index"]] and j["first_send"] is not None:
            sent[key] = sent.get(key, 0) + 1
        arrived[key] = arrived.get(key, 0) + len(j["arrivals"])
    for h in range(1, LN_HEIGHTS + 1):
        for kind in ("prevote", "precommit"):
            # a quorum of the signers sent their own vote, and each node took
            # two others' at least
            check(sent.get((h, kind), 0) >= 3 and arrived.get((h, kind), 0) >= 2 * len(nodes),
                  f"localnet: height {h}'s {kind} journeys: {sent.get((h, kind), 0)} first "
                  f"sends, {arrived.get((h, kind), 0)} arrivals")
    lat = [lk["window_latency_p50_s"] for lk in ledger["links"]
           if lk["window_latency_p50_s"] is not None]
    return {"journeys": len(journeys), "sends": sum(sent.values()),
            "arrivals": sum(arrived.values()), "links": len(links),
            "first_sightings": ledger["first_sightings"], "duplicates": ledger["duplicates"],
            "link_latency_p50_ms": statistics.median(lat) * 1e3 if lat else None}


def ln_frames(nodes) -> int:
    """Secret-connection frames sealed so far by every node to every peer
    (each connection's send nonce counts them)."""
    return sum(p.mconn._conn._send_nonce._counter for n in nodes for p in n.switch.peers.list())


def ln_peer_bytes(nodes) -> dict:
    """Wire bytes sent and received a peer by each node (NodeMetrics'
    tendermint_p2p_peer_*_bytes_total), summed over channels."""
    out = {}
    for i, n in enumerate(nodes):
        sent, recv = {}, {}
        for (pid, _), v in n.metrics.peer_send_bytes._values.items():
            sent[pid] = sent.get(pid, 0.0) + v
        for (pid, _), v in n.metrics.peer_receive_bytes._values.items():
            recv[pid] = recv.get(pid, 0.0) + v
        check(len(sent) == len(recv) == LN_VALS - 1 and min(sent.values()) > 0
              and min(recv.values()) > 0, f"localnet: node {i}'s peer bytes {sent} {recv}")
        out[i] = {"sent": statistics.mean(sent.values()), "received": statistics.mean(recv.values())}
    return out


class TaggedLaunches(dict):
    """A launch-count dict (``ed25519_cuda.launches``, ``planner.tally_launches``)
    that also counts every increment by the source tag of the thread that
    made it (``tls.tag``; ``untagged`` when none is set)."""

    def __init__(self, inner, tls, by, mtx):
        super().__init__(inner)
        self._tls, self._by, self._mtx = tls, by, mtx

    def __setitem__(self, k, v):
        with self._mtx:
            old = self.get(k, 0)
            super().__setitem__(k, v)
            if v > old:
                d = self._by.setdefault(getattr(self._tls, "tag", None) or "untagged", {})
                d[k] = d.get(k, 0) + (v - old)


def ln_tagged(fn, tag, tls):
    """``fn`` run with the calling thread's source tag set to ``tag`` (a
    string, or a callable giving it at the call)."""
    def call(*args, **kwargs):
        prev = getattr(tls, "tag", None)
        tls.tag = tag() if callable(tag) else tag
        try:
            return fn(*args, **kwargs)
        finally:
            tls.tag = prev
    return call


@contextlib.contextmanager
def ln_launch_sources():
    """K1, K2 and K7 launches by source while active: the launch counters
    count each increment under the launching thread's tag, and a supervised
    dispatch (``breaker.supervised_call``, whose worker thread launches on
    the card) carries its caller's tag into its worker. Yields (the
    thread-local the callers tag, the counts by tag)."""
    tls, by, mtx = threading.local(), {}, threading.Lock()
    real_ec, real_tally, real_sup = ec.launches, planner.tally_launches, breaker.supervised_call

    def supervised(fn, deadline, name="device-dispatch"):
        tag = getattr(tls, "tag", None)
        return real_sup(ln_tagged(fn, tag, tls), deadline, name)

    ec.launches = TaggedLaunches(real_ec, tls, by, mtx)
    planner.tally_launches = TaggedLaunches(real_tally, tls, by, mtx)
    breaker.supervised_call = supervised
    try:
        yield tls, by
    finally:
        breaker.supervised_call = real_sup
        real_ec.update(ec.launches)
        real_tally.update(planner.tally_launches)
        ec.launches, planner.tally_launches = real_ec, real_tally


def ln_tag_node(n, who: str, tls, switched=None) -> None:
    """Tag the launches of node ``n``'s vote-feed flushes (``who:flushes``)
    and LastCommit checks (``who:last_commit``; before ``switched`` is set,
    ``who:fastsync_last_commit``: fast sync's check of its first block)."""
    if n.vote_feed is not None:
        n.vote_feed._dispatch = ln_tagged(n.vote_feed._dispatch, f"{who}:flushes", tls)
    ex = n.consensus_state.block_exec
    ex.validate_block = ln_tagged(
        ex.validate_block, lambda: (f"{who}:last_commit" if switched is None or switched.is_set()
                                    else f"{who}:fastsync_last_commit"), tls)


def ln_gossip_counts(nodes) -> list:
    """Per node, the txs its mempool reactor takes off the wire (decoded,
    before the QoS gate), as a list each."""
    got = []
    for n in nodes:
        r, seen = n.reactors.mempool, []
        real = r.receive

        def receive(chan_id, peer, msg_bytes, real=real, seen=seen):
            seen.append(decode_tx_msg(msg_bytes))
            return real(chan_id, peer, msg_bytes)

        r.receive = receive
        got.append(seen)
    return got


def ln_qos(nodes) -> dict:
    """Every node's QoS decisions (NodeMetrics): admitted, and dropped by
    reason."""
    admitted, dropped = 0.0, {}
    for n in nodes:
        admitted += sum(n.metrics.mempool_qos_admitted_total._values.values())
        for (reason,), v in n.metrics.mempool_qos_dropped_total._values.items():
            dropped[reason] = dropped.get(reason, 0.0) + v
    return {"admitted": admitted, "dropped": dropped}


def ln_check_wiring(n, who: str, dev, restoring: bool = False) -> None:
    """Node ``n`` is wired as node/verify_root wires a node's reactor set."""
    r, sw = n.reactors, n.switch
    check(list(sw.reactors) == ["consensus", "blockchain", "mempool", "evidence", "statesync",
                                "pex"]
          and sw.reactors["pex"] is n.pex_reactor and n.pex_reactor.ensure_period == LN_PEX_PERIOD
          and n.pex_reactor.book is n.addr_book and not n.pex_reactor.seed_mode
          and sw.reactors["consensus"] is r.consensus is n.consensus_reactor and n.consensus_reactor.cons is n.consensus_state
          and sw.reactors["mempool"] is r.mempool and r.mempool.qos is not None
          and sw.reactors["evidence"] is r.evidence and r.statesync is not None
          and sw.reactors["statesync"] is r.statesync.reactor
          and set(sw.node_info.channels) == {d.id for d in sw._chan_descs}
          and r.restoring == restoring and (r.statesync.syncer is not None) == restoring,
          f"localnet: {who} is not wired as node/verify_root.node_reactors wires a node")
    check(n.vote_feed is not None and n.consensus_state._vote_feed is n.vote_feed
          and n.vote_feed.window_s == LN_WINDOW_MS / 1e3 and n.consensus_root.wal is not None,
          f"localnet: {who}'s consensus state is not wired as node/verify_root wires one")
    if dev.type == "cuda":
        check(n.vote_feed.device.type == "cuda" and n.vote_feed.verifier is None,
              f"localnet: {who}'s vote feed does not run the installed verifier on the card")


def ln_config(flight: bool) -> Config:
    """A localnet node's configuration: the defaults ([consensus] at its
    defaults, sqlite stores) with the vote feed at phase 23's settings, the
    flight recorder ``flight``, the watchdog off and the validators'
    snapshots every LN_SNAPSHOT_INTERVAL heights; node_net adds the local
    [p2p] and RPC addresses, the unsafe routes and the metrics."""
    cfg = default_config()
    cfg.verify = VerifyConfig(vote_batch_window_ms=LN_WINDOW_MS, vote_batch_rows=LN_ROWS)
    cfg.instrumentation.flight_recorder = flight
    cfg.instrumentation.watchdog = False
    cfg.statesync = StateSyncConfig(snapshot_interval=LN_SNAPSHOT_INTERVAL)
    return cfg


def ln_addr(node) -> str:
    return f"tcp://127.0.0.1:{node.rpc_server.bound_port}"


def ln_get(node, path: str):
    """A GET URI route of ``node``'s RPC server: (seconds, the JSON)."""
    conn = http.client.HTTPConnection("127.0.0.1", node.rpc_server.bound_port,
                                      timeout=RESULT_TIMEOUT)
    t0 = time.perf_counter()
    try:
        conn.request("GET", path)
        body = conn.getresponse().read()
    finally:
        conn.close()
    return time.perf_counter() - t0, json.loads(body)


def ln_broadcast(node, tx: bytes, out: dict) -> threading.Thread:
    """``broadcast_tx_commit`` of ``tx`` on ``node``'s RPC over HTTP, on a
    thread of its own; ``out[tx]`` gets (seconds, the result or the
    error)."""
    def run():
        t0 = time.perf_counter()
        try:
            res = HTTPClient(ln_addr(node), timeout=LN_TIMEOUT).broadcast_tx_commit(tx)
        except Exception as e:  # checked by the phase
            res = e
        out[tx] = (time.perf_counter() - t0, res)

    t = threading.Thread(target=run, name="ln-broadcast", daemon=True)
    t.start()
    return t


def ln_join(nodes, tmp, dev, tls, stops, ids) -> dict:
    """The fifth node: a non-validator home with an empty store that knows
    node 0 as its seed and no persistent peer, finds the other validators by
    the peer exchange, restores by state sync over TCP, hands off to fast sync
    and then to consensus, reaches the tip and follows LN_FOLLOW more
    heights; its RPC status reports catching_up until it runs consensus.
    Its switch's stops go into ``stops`` (``ln_stopped_peers``' lists)."""
    meta = nodes[0].block_store.load_block_meta(LN_TRUST)
    ss_cfg = StateSyncConfig(enable=True, trust_height=LN_TRUST,
                             trust_hash=meta.header.hash().hex())
    t_build = time.perf_counter()
    j = nn.add_joining_node(nodes, tmp, ln_config(flight=False),
                            LocalClientCreator(PersistentKVStoreApp()), statesync=ss_cfg,
                            device=dev, start=False, pex_period=LN_PEX_PERIOD, seed_only=True)
    ln_check_wiring(j, "the joining node", dev, restoring=True)
    seed = nodes[0].switch.transport.listen_address
    check(j.config.p2p.persistent_peers == "" and [str(a) for a in j.pex_reactor.seeds]
          == [str(seed)], "localnet: the joining node knows more than node 0 as its seed")
    val_ids = {n.switch.node_id: i for i, n in enumerate(nodes)}
    peers_seen, watching = {}, threading.Event()

    def watch_peers():
        # the moment the joining node has all the validators as peers
        while not watching.is_set():
            if set(val_ids) <= {p.id for p in j.switch.peers.list()}:
                peers_seen["t"] = time.perf_counter()
                return
            time.sleep(0.005)
    ln_stopped_peers(nodes + [j], wrap=[j], into=stops, ids=ids)
    received = ln_gossip_counts([j])[0]
    vals = nodes[0].consensus_state.get_state().validators
    check(not vals.has_address(j.priv_validator.get_pub_key().address())
          and j.block_store.height() == 0 and j.reactors.consensus.fast_sync
          and not j.reactors.blockchain.fast_sync and j.reactors.statesync.syncer.batch_verifier
          is None, "localnet: the joining node is not an empty non-validator that restores")
    ss = j.reactors.statesync
    stamps, switched = {}, threading.Event()
    real_synced, real_switch = ss.reactor.on_synced, j.consensus_reactor.switch_to_consensus

    def on_synced(state, height):
        stamps["synced"] = time.perf_counter()
        real_synced(state, height)

    def switch_to_consensus(state, blocks_synced=0):
        stamps["switched"], stamps["switched_at"] = time.perf_counter(), state.last_block_height
        switched.set()
        return real_switch(state, blocks_synced)

    ss.reactor.on_synced, j.consensus_reactor.switch_to_consensus = on_synced, switch_to_consensus
    ln_tag_node(j, "join", tls, switched)
    ss.syncer._establish_trust = ln_tagged(ss.syncer._establish_trust, "join:trust", tls)
    ss.syncer._verify_backfill_window = ln_tagged(ss.syncer._verify_backfill_window,
                                                  "join:backfill", tls)
    trace.reset(FS_TRACE_CAPACITY)
    trace.enable()
    watcher = threading.Thread(target=watch_peers, name="ln-join-peers", daemon=True)
    try:
        t0 = time.perf_counter()
        j.start()
        watcher.start()
        catching = [HTTPClient(ln_addr(j)).status()["sync_info"]["catching_up"]]
        check(tcs.wait_for(lambda: switched.is_set() or ss.reactor.progress()["error"]
                           or j.reactors.blockchain.device_fault is not None,
                           LN_JOIN_TIMEOUT, interval=0.005),
              f"localnet: the joining node neither handed off nor failed in {LN_JOIN_TIMEOUT} s: "
              f"{ss.reactor.progress()}")
        spans = span_seconds(LN_SS_SPANS)
        check(trace.dropped() == 0, "localnet: the trace ring dropped spans")
    finally:
        trace.disable()
    prog = ss.reactor.progress()
    check(switched.is_set() and prog["error"] is None and ss.reactor.device_fault is None
          and j.reactors.blockchain.device_fault is None,
          f"localnet: the join failed: {prog}, fast sync {j.reactors.blockchain.device_fault}")
    H = prog["snapshot_height"]
    check(prog["synced_height"] == H and H in (LN_JOIN_AT - LN_JOIN_AT % LN_SNAPSHOT_INTERVAL,
                                                LN_JOIN_AT - LN_JOIN_AT % LN_SNAPSHOT_INTERVAL
                                                - LN_SNAPSHOT_INTERVAL),
          f"localnet: the joining node restored snapshot {H}")
    synced = j.reactors.blockchain.blocks_synced
    check(stamps["switched_at"] == H + synced and synced >= 1,
          f"localnet: fast sync synced {synced} blocks after {H}, switched at "
          f"{stamps['switched_at']}")
    # the tip: every validator's height once the node has switched
    tip = min(n.block_store.height() for n in nodes)
    check(tcs.wait_for(lambda: j.block_store.height() >= tip, LN_JOIN_TIMEOUT, interval=0.005),
          f"localnet: the joining node at {j.block_store.height()}, not at the tip {tip}")
    stamps["tip"] = time.perf_counter()
    # it follows once the peer exchange has given it every validator as a
    # peer (each answer names one address of a small book, so that takes a
    # few sweeps)
    watcher.join(LN_JOIN_TIMEOUT)
    watching.set()
    check("t" in peers_seen,
          f"localnet: the joining node did not have the {len(nodes)} validators as peers "
          f"{LN_JOIN_TIMEOUT} s after its start: {[p.id for p in j.switch.peers.list()]}")
    top = max(tip, min(n.block_store.height() for n in nodes)) + LN_FOLLOW
    stamps["follow_from"] = time.perf_counter()
    check(tcs.wait_for(lambda: min(n.block_store.height() for n in nodes + [j]) >= top,
                       LN_JOIN_TIMEOUT, interval=0.005),
          f"localnet: the joining node did not follow to {top}: "
          f"{[n.block_store.height() for n in nodes + [j]]}")
    stamps["followed"] = time.perf_counter()
    # how each validator became its peer: the seed of its config; dialed
    # after a peer's PEX answer named it; or it dialed in after learning
    # the joining node by PEX
    learned = {}

    def how_learned() -> bool:
        # one snapshot of the book and the peers (a peer is in the set
        # before its reactors' add_peer has run)
        book = {k.addr.id: k for k in j.addr_book.list_known()}
        for nid, i in val_ids.items():
            k, p = book.get(nid), j.switch.peers.get(nid)
            if k is None or p is None:
                how = "unknown"
            elif nid == seed.id and str(k.src) == str(seed):
                how = "seed"
            elif k.src.id != nid:
                how = f"pex from node{val_ids.get(k.src.id, '?')}"
            else:
                how = "dialed in (pex)"
            learned[i] = f"{how}, {'outbound' if p is not None and p.outbound else 'inbound'}"
        return not any(v.startswith("unknown") for v in learned.values())

    check(tcs.wait_for(how_learned, LN_JOIN_TIMEOUT, interval=0.05)
          and learned[0].startswith("seed"),
          f"localnet: how the joining node's peers were learned: {learned}")
    catching.append(HTTPClient(ln_addr(j)).status()["sync_info"]["catching_up"])
    check(catching == [True, False],
          f"localnet: the joining node's status catching_up at its start and at {top}: {catching}")
    bs = j.block_store
    check(bs.base() == max(1, H - StateSyncConfig().backfill_blocks + 1),
          f"localnet: the joining node's base {bs.base()}")
    for h in range(bs.base(), top + 1):
        want = nodes[0].block_store.load_block_meta(h).header
        check(bs.load_block_meta(h).header.hash() == want.hash()
              and bs.load_block_meta(h).header.app_hash == want.app_hash,
              f"localnet: the joining node's header at {h} differs from node 0's")
        if h > H:
            check(bs.load_block(h).hash() == nodes[0].block_store.load_block(h).hash(),
                  f"localnet: the joining node's block {h} differs")
    check(j.consensus_state.device_fault is None,
          f"localnet: the joining node's device fault {j.consensus_state.device_fault}")
    return {"node": j, "snapshot": H, "synced": synced, "tip": tip, "top": top,
            "build_s": t0 - t_build, "restore_s": stamps["synced"] - t0,
            "handoff_s": stamps["switched"] - stamps["synced"], "tip_s": stamps["tip"] - t0,
            "follow_s": stamps["followed"] - stamps["follow_from"], "spans": spans,
            "received": received, "peers_s": peers_seen["t"] - t0, "learned": learned}


def ln_time_signer(node) -> list:
    """The round trips of ``node``'s remote signer as the node sees them:
    each request its ``SignerValidatorEndpoint`` sends (a sign, a ping, the
    key), its seconds appended to the list returned."""
    ep, times = node.signer_endpoint, []
    real = ep._request

    def request(payload):
        t0 = time.perf_counter()
        try:
            return real(payload)
        finally:
            times.append(time.perf_counter() - t0)

    ep._request = request
    return times


def ln_monitor(monitor, nodes, dev, fallbacks_before: float) -> list:
    """tm_monitor's view of ``nodes`` once it agrees with them: each
    node's monitored height equal to its /status at one poll, online, its
    DEVICE column the breaker closed with no new fallback and, on the card,
    its VERIFY column ``ladder``. Returns the nodes' snapshots."""
    clients = [HTTPClient(ln_addr(n), timeout=5.0) for n in nodes]

    def agrees():
        for m, c in zip(monitor.nodes, clients):
            if not (m.online and m.device_state == 0
                    and m.device_fallbacks == int(fallbacks_before)
                    and (dev.type != "cuda" or m.verify_path == "ladder")):
                return False
            if m.height != int(c.status()["sync_info"]["latest_block_height"]):
                return False
        return True

    ok = tcs.wait_for(agrees, LN_MONITOR_TIMEOUT, interval=0.05)
    snaps = [m.snapshot() for m in monitor.nodes]
    check(ok, "localnet: tm_monitor never agreed with the nodes' /status, a closed breaker, "
              f"no fallback and the ladder: {snaps}")
    return snaps


def ln_host_verdict(node, h: int) -> dict:
    """The host's verdict on the stored commit at ``h`` against its
    validator set: ``verify_commit`` on ``HostBatchVerifier``, and the
    tally of the signatures that verify."""
    commit = node.block_store.load_block_commit(h) or node.block_store.load_seen_commit(h)
    vals = sm_store.load_validators(node.state_db, h)
    chain_id = node.genesis_doc.chain_id
    pubs, msgs, sigs, powers = vals.collect_commit_sigs(chain_id, commit.block_id, h, commit)
    ok = [bool(x) for x in verify_generic(pubs, msgs, sigs, verifier=HostBatchVerifier())]
    try:
        vals.verify_commit(chain_id, commit.block_id, h, commit, verifier=HostBatchVerifier())
        verified = True
    except CommitError:
        verified = False
    return {"verified": verified, "sigs_ok": all(ok),
            "tally": sum(p for p, o in zip(powers, ok) if o)}


def ln_rpc_burst(node, heights, tls, tmp) -> dict:
    """LN_RPC_CLIENTS concurrent clients ask ``node`` for /commit?verify=1 at
    every height of ``heights`` and /validators?verify=1 at one each, around
    an unsafe_start_profiler / unsafe_stop_profiler trace; every verdict
    must equal the host's."""
    feed = node._rpc_env._lane_feed()
    feed._dispatch = ln_tagged(feed._dispatch, "rpc:burst", tls)
    d0 = feed.dispatches
    t_w = time.perf_counter()
    want = {h: ln_host_verdict(node, h) for h in heights}
    host_s = time.perf_counter() - t_w
    start_s, started = ln_get(node, "/unsafe_start_profiler?dir=%22" + os.path.join(tmp, "trace")
                              + "%22")
    check(started.get("result", {}).get("tracing") is True,
          f"localnet: unsafe_start_profiler: {started}")
    out, mtx = [], threading.Lock()

    def client(c: int) -> None:
        paths = [(h, f"/commit?height={h}&verify=1") for h in heights]
        hv = heights[c % len(heights)]
        paths.append((hv, f"/validators?height={hv}&verify=1"))
        for h, path in paths:
            secs, res = ln_get(node, path)
            with mtx:
                out.append((h, path, secs, res))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,), name=f"ln-rpc-{c}", daemon=True)
               for c in range(LN_RPC_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(LN_TIMEOUT)
    wall = time.perf_counter() - t0
    stop_s, stopped = ln_get(node, "/unsafe_stop_profiler")
    check(len(out) == LN_RPC_CLIENTS * (len(heights) + 1),
          f"localnet: {len(out)} burst answers, want {LN_RPC_CLIENTS * (len(heights) + 1)}")
    for h, path, _, res in out:
        v = res.get("result", {}).get("verification")
        check(v is not None and {k: v[k] for k in ("verified", "sigs_ok", "tally")} == want[h],
              f"localnet: {path} gave {res}, the host {want[h]}")
    trace_file = stopped.get("result", {}).get("file")
    check(trace_file is not None and os.path.exists(trace_file),
          f"localnet: unsafe_stop_profiler: {stopped}")
    t_l = time.perf_counter()
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    load_s = time.perf_counter() - t_l
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    named = {k: any(LN_KERNEL_NAMES[k] in n for n in kernels) for k in LN_KERNEL_NAMES}
    check(all(named.values()), f"localnet: the profiler trace's kernels {sorted(kernels)[:20]}")
    by_h = {}
    for h, path, secs, _ in out:
        if path.startswith("/commit"):
            by_h.setdefault(h, []).append(secs)
    rows = [res["result"]["verification"]["batch_rows"] for *_, res in out]
    return {"answers": len(out), "wall_s": wall, "dispatches": feed.dispatches - d0,
            "p50_ms": statistics.median(statistics.median(v) for v in by_h.values()) * 1e3,
            "rows_mean": statistics.mean(rows), "rows_max": max(rows),
            "trace_events": len(events), "trace_kernels": sorted(kernels),
            "profiler_s": {"host_verdicts": host_s, "start": start_s, "stop": stop_s,
                           "load": load_s}}


def ln_indexed(node, txs) -> dict:
    """By tx: the height ``node``'s ``tx`` route gives for its hash, and
    whether ``tx_search`` at that height lists it (None where the route
    errs)."""
    c, out = HTTPClient(ln_addr(node)), {}
    for tx in txs:
        hx = hashlib.sha256(tx).hexdigest().upper()
        try:
            h = c.tx(hx)["height"]
            found = c.tx_search(f"tx.height = {h}")["txs"]
            out[tx] = (h, any(r["hash"] == hx for r in found))
        except Exception as e:  # checked by the phase
            out[tx] = (None, repr(e))
    return out


def ln_lite(node, top: int, tls) -> dict:
    """The port's RPCProvider + DynamicVerifier on the installed verifier
    verify ``node``'s chain from height 1 to ``top`` over lite_full_commit;
    each certified header equals the node's."""
    src = RPCProvider(ln_addr(node))
    chain_id = node.genesis_doc.chain_id
    dv = DynamicVerifier(chain_id, DBProvider(MemDB()), src)

    def run():
        dv.init_from_full_commit(src.full_commit_at(chain_id, 1))
        for h in range(2, top + 1):
            dv.verify(src.full_commit_at(chain_id, h).signed_header)

    t0 = time.perf_counter()
    ln_tagged(run, "rpc:lite", tls)()
    secs = time.perf_counter() - t0
    latest = dv.trusted.latest_full_commit(chain_id, 1, 1 << 60)
    check(latest.height == top and latest.signed_header.header.hash()
          == node.block_store.load_block_meta(top).header.hash(),
          f"localnet: the lite client trusts {latest.height}, want {top}")
    return {"heights": top, "seconds": secs}


def phase_localnet(dev, err: dict) -> dict:
    """Phase 25: BASELINE.json config 1, four Nodes started from home
    directories (testutil/node_net) over TCP with RPC on, their [verify]
    root with the vote feed on; txs through broadcast_tx_commit on node 0's
    RPC; then a fifth node joins by state sync, and the RPC routes are
    driven: the ?verify=1 burst under the profiler, the lite client over
    lite_full_commit, a NewBlock websocket, /metrics and
    dump_device_health."""
    phase(f"localnet: {LN_VALS} validators of power 10, each a node/node.Node from a home "
          f"directory (testutil/node_net: sqlite stores, FilePV, node key, genesis) with its "
          f"own WAL, vote feed ({LN_WINDOW_MS:g} ms, {LN_ROWS} rows), RPC server and reactor "
          f"set (consensus, blockchain, mempool with its QoS gate, evidence, statesync, the "
          f"peer exchange sweeping every {LN_PEX_PERIOD:g} s; PersistentKVStoreApp snapshots "
          f"every {LN_SNAPSHOT_INTERVAL}), validator {LN_SIGNER} signing through a remote "
          f"signer over TCP, tm_monitor over the four RPCs, listening at "
          f"127.0.0.1 port 0 and dialing the others as persistent peers (TCP, secret "
          f"connection, MConnection); {LN_HEIGHTS} heights at the [consensus] defaults, a tx "
          f"a height through broadcast_tx_commit on node 0's RPC, validator {LN_OFFENDER}'s "
          f"double sign at {LN_EVIDENCE_HEIGHT} into node 0's evidence pool; at {LN_JOIN_AT} a "
          f"fifth node that knows node 0 as its seed finds the others by PEX, joins by state "
          f"sync and follows {LN_FOLLOW} heights; then the RPC: "
          f"{LN_RPC_CLIENTS} clients x /commit?verify=1 under the profiler, the lite client, "
          f"the websocket, /metrics and dump_device_health")
    t_phase = time.perf_counter()
    before = fallbacks()
    # the verify families are the process's: the msm phases' dispatches
    # would make tm_monitor's VERIFY column read "mixed" for these nodes,
    # where a node in a process of its own starts with none
    with get_verify_metrics().fe_dispatch._mtx:
        get_verify_metrics().fe_dispatch._values.clear()
    # the guard's events of earlier phases (their tripped breakers) stay in
    # the process's ring: dump_device_health is read from here on
    seq0 = max((e["seq"] for e in get_profiler().events()), default=-1)
    txs = [b"localnet-h%d=v%d" % (h, h) for h in range(1, LN_JOIN_AT + LN_FOLLOW + 1)]
    # the homes outlive the nodes: the checks below read their stores
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ln-")
    with timed_upgrades() as ups, ln_launch_sources() as (tls, by_tag):
        nodes = nn.make_node_net(LN_VALS, tmp, ln_config(flight=True),
                                 lambda i: LocalClientCreator(PersistentKVStoreApp()),
                                 device=dev, start=False, pex_period=LN_PEX_PERIOD,
                                 remote_signers=(LN_SIGNER,))
        signer = nodes[LN_SIGNER].remote_signer
        check(nodes[LN_SIGNER].consensus_state.priv_validator is nodes[LN_SIGNER].signer_endpoint
              and signer.endpoint.is_running
              and all(n.signer_endpoint is None for i, n in enumerate(nodes) if i != LN_SIGNER),
              f"localnet: validator {LN_SIGNER} does not sign through its remote signer")
        signer_rt = ln_time_signer(nodes[LN_SIGNER])
        root = nodes[0].verify_root
        check(all(n.verify_root is root for n in nodes) and get_batch_verifier() is root.verifier,
              "localnet: the nodes do not share one [verify] root whose verifier is installed")
        for i, n in enumerate(nodes):
            ln_check_wiring(n, f"node {i}", dev)
            ln_tag_node(n, "validators", tls)
        real_window = bc_reactor.verify_block_window
        bc_reactor.verify_block_window = ln_tagged(real_window, "join:fastsync", tls)
        received = ln_gossip_counts(nodes)
        ln_ids = {}
        stopped, closed = ln_stopped_peers(nodes, ids=ln_ids)
        seal_ms, open_ms = ln_frame_ms(p2p_sts.ChaCha20Poly1305)
        fb_seal_ms, fb_open_ms = ln_frame_ms(sts_fallback.ChaCha20Poly1305)
        print(f"  built in {time.perf_counter() - t_phase:.1f} s (set-up); STS_BACKEND "
              f"{p2p_sts.STS_BACKEND}: a {p2p_sts.TOTAL_FRAME_SIZE}-byte frame sealed in "
              f"{seal_ms:.4f} ms and opened in {open_ms:.4f} ms (crypto/sts_fallback's: "
              f"{fb_seal_ms:.3f} and {fb_open_ms:.3f} ms; means of {LN_FRAME_REPS}, this "
              f"process alone)", flush=True)
        reset_launches()
        stamps, frames, join, ev, ws, monitor = {}, {}, None, None, None, None
        results, senders = {}, []
        try:
            with captured_packs() as packs:
                t0 = time.perf_counter()
                # node 2 first: its websocket sees every height (no height
                # commits before a second node is up)
                nodes[2].start()
                ws = WSEventClient(ln_addr(nodes[2]))
                ws.subscribe("tm.event = 'NewBlock'")
                for n in (nodes[0], nodes[1], nodes[3]):
                    n.start()
                monitor = NetworkMonitor([ln_addr(n) for n in nodes])
                senders.append(ln_broadcast(nodes[0], txs[0], results))
                for h in range(1, LN_JOIN_AT + 1):
                    check(tcs.wait_for(lambda: all(n.block_store.height() >= h
                                                   for n in nodes), LN_TIMEOUT, interval=0.002),
                          f"localnet: height {h} never committed on every node: "
                          f"{[(n.consensus_state.get_state().last_block_height, n.consensus_state.device_fault) for n in nodes]}")
                    stamps[h] = time.perf_counter()
                    frames[h] = ln_frames(nodes)
                    senders.append(ln_broadcast(nodes[0], txs[h], results))
                    if h == LN_EVIDENCE_HEIGHT + 1:
                        # every node holds the validators of the evidence's height
                        ev = nn.duplicate_vote_evidence(nodes, LN_OFFENDER, LN_EVIDENCE_HEIGHT)
                        nodes[0].evidence_pool.add_evidence(ev)
                    if h == LN_HEIGHTS:
                        # before the join: its peer changes the peers and bytes
                        peers = [n.switch.peers.size() for n in nodes]
                        stopped_run, closed_run = list(stopped), list(closed)
                        peer_bytes = ln_peer_bytes(nodes)
                t_mon = time.perf_counter()
                mon_snaps = ln_monitor(monitor, nodes, dev, before)
                mon_s = time.perf_counter() - t_mon
                join = ln_join(nodes, tmp, dev, tls, (stopped, closed), ln_ids)
                j = join["node"]
                for t in senders:
                    t.join(LN_TIMEOUT)
                # the last txs commit, every node holds the evidence's block
                check(tcs.wait_for(lambda: all(nn.committed_in(n, lambda t: t == txs[LN_JOIN_AT])
                                               for n in nodes), LN_TIMEOUT, interval=0.005),
                      "localnet: the last tx into node 0 did not commit everywhere")
                stopped_join = [s for s in stopped if s not in stopped_run]
                peers_join = [n.switch.peers.size() for n in nodes + [j]]
                # the RPC routes over the running net
                t_rpc = time.perf_counter()
                top_rpc = nodes[0].block_store.height()
                # the heights whose canonical commit node 0 stores (the tip's
                # is its seen commit, which the next block replaces)
                heights = list(range(1, top_rpc))
                print(f"  the net's heights 1-{LN_JOIN_AT} and the join in "
                      f"{t_rpc - t0:.1f} s; the RPC checks follow", flush=True)
                burst = ln_rpc_burst(nodes[0], heights, tls, tmp)
                print(f"  the burst in {time.perf_counter() - t_rpc:.1f} s: "
                      f"{burst['profiler_s']}", flush=True)
                lite = ln_lite(nodes[1], top_rpc, tls)
                indexed = ln_indexed(nodes[3], txs[:LN_HEIGHTS])
                metrics_text = HTTPClient(ln_addr(nodes[3])).metrics_text()
                health = HTTPClient(ln_addr(nodes[0])).dump_device_health()
                print(f"  the lite client, /metrics and dump_device_health by "
                      f"{time.perf_counter() - t_rpc:.1f} s", flush=True)
                seen = set()
                while True:
                    try:
                        seen.add(ws.next_event(timeout=0.5)["data"]["value"]["block"]["header"]
                                 ["height"])
                    except queue.Empty:
                        break
                rpc_s = time.perf_counter() - t_rpc
        finally:
            bc_reactor.verify_block_window = real_window
            if ws is not None:
                ws.close()
            if monitor is not None:
                monitor.stop()
            nn.stop_node_net(nodes + ([join["node"]] if join is not None else []))
        tags = {k: dict(v) for k, v in by_tag.items()}
    launches = read_launches()
    races, rest = ln_unexcused_stops(stopped_run, closed_run, stamps[1])
    check(not rest and peers == [LN_VALS - 1] * LN_VALS,
          f"localnet: peers {peers}; peers stopped for an error (seconds after height 1, node, "
          f"peer, reason, canonical): {rest}; excused dial races {races}; duplicates closed by "
          f"the canonical rule (node, peer): {closed_run}")
    # the joining node dials the validators its PEX answers name while a
    # validator that learned it by PEX may dial it: the same simultaneous
    # dial as before height 1, excused by the same rule
    races_join, rest_join = ln_unexcused_stops(stopped_join, closed, float("inf"))
    check(not rest_join and peers_join == [LN_VALS] * (LN_VALS + 1),
          f"localnet: after the join, peers {peers_join}; peers stopped for an error "
          f"{rest_join}; excused dial races {races_join}")
    # validator LN_SIGNER signed through its remote signer: its precommit is
    # in every committed LastCommit, the host verifies each of them, and
    # every node's LastCommit check (K1 + K2) accepted those heights
    addr_s = nodes[LN_SIGNER].remote_signer.pv.get_pub_key().address()
    idx_s, _ = nodes[0].consensus_state.get_state().validators.get_by_address(addr_s)
    top_s = min(n.block_store.height() for n in nodes)
    for h in range(2, top_s + 1):
        pc = nodes[0].block_store.load_block(h).last_commit.precommits[idx_s]
        check(pc is not None and pc.validator_address == addr_s and pc.signature,
              f"localnet: validator {LN_SIGNER}'s precommit missing from LastCommit {h}")
        check(ln_host_verdict(nodes[0], h - 1)["sigs_ok"],
              f"localnet: a signature of LastCommit {h} does not verify on the host")
    accepted = {i: sorted({h for h in n.checks if 2 <= h <= top_s})
                for i, n in enumerate(nodes + [join["node"]])}
    check(all(accepted[i] == list(range(2, top_s + 1)) for i in range(LN_VALS))
          and accepted[LN_VALS] and accepted[LN_VALS][-1] == top_s,
          f"localnet: the LastCommit checks holding validator {LN_SIGNER}'s precommit, by "
          f"node: {accepted}")
    check(signer.requests == len(signer_rt) and len(signer_rt) >= 2 * (top_s - 1)
          and signer.error is None,
          f"localnet: the remote signer served {signer.requests} requests, the node timed "
          f"{len(signer_rt)}; dial error {signer.error}")
    check(all(n.consensus_state.device_fault is None for n in nodes),
          f"localnet: device faults {[n.consensus_state.device_fault for n in nodes]}")
    mp_faults = [n.reactors.mempool.device_fault for n in nodes + [join["node"]]]
    check(mp_faults == [None] * (LN_VALS + 1),
          f"localnet: CheckTx window faults on gossiped txs {mp_faults}")
    top = min(n.block_store.height() for n in nodes)
    for h in range(1, top + 1):
        blocks = [n.block_store.load_block(h) for n in nodes]
        check(len({b.hash() for b in blocks}) == 1 and len({b.header.app_hash for b in blocks}) == 1,
              f"localnet: the nodes' blocks at {h} differ")
    # the txs: sent to node 0 alone by broadcast_tx_commit, gossip carried
    # each into every other node's mempool, and each committed on every
    # node at the height the route returned; node 3's index finds each
    tx_heights, commit_s = {}, []
    for h in range(1, LN_HEIGHTS + 1):
        tx = txs[h - 1]
        at = [nn.committed_in(n, lambda t, tx=tx: t == tx) for n in nodes]
        check(len(set(at)) == 1 and at[0] is not None, f"localnet: tx {tx!r} committed at {at}")
        check(all(tx in received[i] for i in range(1, LN_VALS)),
              f"localnet: tx {tx!r} did not reach every mempool by gossip")
        secs, res = results.get(tx, (None, None))
        check(isinstance(res, dict) and res["height"] == at[0] and res["check_tx"]["code"] == 0
              and res["deliver_tx"]["code"] == 0
              and res["hash"] == hashlib.sha256(tx).hexdigest().upper(),
              f"localnet: broadcast_tx_commit of {tx!r} gave {res}, committed at {at[0]}")
        check(indexed[tx] == (at[0], True),
              f"localnet: node 3's tx / tx_search of {tx!r}: {indexed[tx]}, committed at {at[0]}")
        tx_heights[h] = at[0]
        commit_s.append(secs)
    ev_at = [nn.committed_in(n, lambda e: isinstance(e, type(ev)) and e.hash() == ev.hash())
             for n in nodes]
    check(len(set(ev_at)) == 1 and ev_at[0] is not None
          and all(n.evidence_pool.is_committed(ev) for n in nodes),
          f"localnet: the evidence committed at {ev_at}")
    qos = ln_qos(nodes + [join["node"]])
    check(not any(qos["dropped"].values()) and qos["admitted"] > 0,
          f"localnet: QoS admitted {qos['admitted']}, dropped {qos['dropped']}")
    check(set(range(1, top_rpc + 1)) <= seen,
          f"localnet: node 2's NewBlock websocket missed heights "
          f"{sorted(set(range(1, top_rpc + 1)) - seen)}")
    missing = [m for m in LN_METRIC_NAMES if m not in metrics_text]
    check(not missing, f"localnet: node 3's /metrics lacks {missing}")
    bad_events = [e for e in health["events"] if e["kind"] != "breaker" and e["seq"] > seq0]
    check(health["breaker"]["state"] == "closed" and not bad_events
          and health["verifier"]["installed"],
          f"localnet: dump_device_health: breaker {health['breaker']['state']}, events "
          f"{bad_events}")
    gossiped = [len(r) for r in received] + [len(join["received"])]
    vals = tags.get("validators:flushes", {}), tags.get("validators:last_commit", {})
    dispatches = sum(n.vote_feed.dispatches for n in nodes)
    checks_n = sum(len(n.checks) for n in nodes)
    k1, k2 = launches["ed25519_prologue"], launches["ed25519_ladder"]
    check("untagged" not in tags and sum(t.get("ed25519_prologue", 0) for t in tags.values()) == k1
          and sum(t.get("ed25519_ladder", 0) for t in tags.values()) == k2
          and launches["secp256k1_ladder"] == 0 and launches[K4] == 0,
          f"localnet: launches {launches} by source {tags}")
    check(vals[0].get("ed25519_prologue", 0) == vals[0].get("ed25519_ladder", 0) == dispatches
          and vals[1].get("ed25519_prologue", 0) == vals[1].get("ed25519_ladder", 0) == checks_n,
          f"localnet: the validators' launches {vals}, {dispatches} feed dispatches, {checks_n} "
          f"LastCommit checks")
    jt = {src: tags.get(f"join:{src}", {}) for src in LN_JOIN_SOURCES}
    jl = {src: {"k1": t.get("ed25519_prologue", 0), "k2": t.get("ed25519_ladder", 0),
                "k7": t.get("planner_tally", 0)} for src, t in jt.items()}
    check(all(jl[s]["k1"] == jl[s]["k2"] >= 1 for s in ("trust", "backfill", "fastsync"))
          and jl["backfill"]["k7"] >= 1 and all(jl[s]["k7"] == 0 for s in jl if s != "backfill"),
          f"localnet: the joining node's launches by source {jl}")
    jn = join["node"]
    check(jl["flushes"]["k1"] == jn.vote_feed.dispatches
          and jl["last_commit"]["k1"] + jl["fastsync_last_commit"]["k1"] == len(jn.checks),
          f"localnet: the joining node's launches {jl}, {jn.vote_feed.dispatches} feed "
          f"dispatches, {len(jn.checks)} LastCommit checks")
    rl = {src: {"k1": tags.get(f"rpc:{src}", {}).get("ed25519_prologue", 0),
                "k2": tags.get(f"rpc:{src}", {}).get("ed25519_ladder", 0),
                "k7": tags.get(f"rpc:{src}", {}).get("planner_tally", 0)}
          for src in LN_RPC_SOURCES}
    check(rl["burst"]["k1"] == rl["burst"]["k2"] >= burst["dispatches"] >= 1
          and rl["burst"]["k7"] == burst["dispatches"]
          and rl["lite"]["k1"] == rl["lite"]["k2"] >= 1 and rl["lite"]["k7"] == 0,
          f"localnet: the RPC's launches by source {rl}, {burst['dispatches']} burst dispatches")
    per_node = []
    for i, n in enumerate(nodes):
        recs = n.vote_feed.flush_records()["records"]
        rows = {h: sum(1 for r in recs if r["groups"] and r["groups"][0][0] == h)
                for h in range(1, LN_HEIGHTS + 1)}
        lcs = {h: n.checks.count(h) for h in range(1, LN_HEIGHTS + 1)}
        check(all(rows[h] > 0 and lcs[h] > 0 for h in range(2, LN_HEIGHTS + 1)),
              f"localnet: node {i} launched no flush or no LastCommit check at some height "
              f"from 2: flushes {rows}, checks {lcs}")
        per_node.append({"flushes": rows, "last_commit": lcs,
                         "reasons": dict(n.vote_feed.flushes),
                         "rows": [r["rows"] for r in recs], "lanes": [r["votes"] for r in recs],
                         "serial": dict(n.consensus_state.serial_votes),
                         "votes_in": n.vote_feed.votes_in})
    b_first, _, _ = hold_k1_k2(packs[0], err, "localnet first launch")
    b_last, _, _ = hold_k1_k2(packs[-1], err, "localnet last launch")
    gossip = ln_gossip(nodes, [join["node"]])
    check_guard_clean(before, "localnet")
    walls = [stamps[h] - stamps[h - 1] for h in range(2, LN_HEIGHTS + 1)]
    blocks_s = (LN_HEIGHTS - 1) / (stamps[LN_HEIGHTS] - stamps[1])
    seconds = time.perf_counter() - t_phase
    reasons, rows, lanes = {}, [], []
    for p in per_node:
        for k, v in p["reasons"].items():
            reasons[k] = reasons.get(k, 0) + v
        rows += p["rows"]
        lanes += p["lanes"]
    heights_run = LN_HEIGHTS - 1
    flush_per_h = sum(sum(p["flushes"][h] for h in range(2, LN_HEIGHTS + 1))
                      for p in per_node) / (LN_VALS * heights_run)
    lc_per_h = sum(sum(p["last_commit"][h] for h in range(2, LN_HEIGHTS + 1))
                   for p in per_node) / (LN_VALS * heights_run)
    print(f"  handshakes: {len(ups)} upgrades (secret connection + NodeInfo), "
          f"{statistics.median(ups):.4f} s a connection (p50; max {max(ups):.4f} s); "
          f"{LN_HEIGHTS} heights on all {LN_VALS} nodes, height 1 at {stamps[1] - t0:.2f} s "
          f"after the start (the dials included); {blocks_s:.3f} blocks/s over heights 2-"
          f"{LN_HEIGHTS}, a height's wall p50 {statistics.median(walls) * 1e3:.1f} ms ("
          + ", ".join(f"{w * 1e3:.1f}" for w in walls) + " ms; the last node's commit to "
          f"the last node's commit)", flush=True)
    print(f"  the validators' launches: {vals[0].get('ed25519_prologue', 0)} K1 + K2 in "
          f"{dispatches} feed flushes + {vals[1].get('ed25519_prologue', 0)} in {checks_n} "
          f"LastCommit checks (heights 1-{top}); a node a height over 2-{LN_HEIGHTS}: "
          f"{flush_per_h:.2f} flushes + {lc_per_h:.2f} LastCommit checks; flushes by reason "
          f"{reasons}; rows a flush {statistics.mean(rows):.2f}, lanes a flush "
          f"{statistics.mean(lanes):.2f} (max {max(lanes)}); votes through the feeds "
          f"{[p['votes_in'] for p in per_node]}, serial by reason "
          f"{[p['serial'] for p in per_node]}; K1/K2 exact on the first and the last launch "
          f"(b = {b_first}, {b_last}); all launches {launches}", flush=True)
    frames_h = (frames[LN_HEIGHTS] - frames[1]) / (LN_HEIGHTS - 1)
    print(f"  frames sealed a height over heights 2-{LN_HEIGHTS}, all nodes: {frames_h:.1f} (each "
          f"also opened once: {frames_h * (fb_seal_ms + fb_open_ms):.1f} ms of interpreter time "
          f"a height at crypto/sts_fallback's rate, {frames_h * (seal_ms + open_ms):.2f} ms at "
          f"{p2p_sts.STS_BACKEND}'s)", flush=True)
    print(f"  bytes a peer at {LN_HEIGHTS} (NodeMetrics, sent / received, mean over a node's 3 "
          f"peers): " + "; ".join(f"node{i} {v['sent']:,.0f} / {v['received']:,.0f}"
                                  for i, v in peer_bytes.items())
          + f"; the flight recorders: {gossip['journeys']} vote journeys, {gossip['sends']} "
          f"first sends, {gossip['arrivals']} arrivals, {gossip['links']} ledger links "
          f"({gossip['first_sightings']} first sightings, {gossip['duplicates']} duplicates, "
          f"a link's sign-to-arrival p50 {gossip['link_latency_p50_ms']:.1f} ms)", flush=True)
    print(f"  mempool gossip: txs 1-{LN_HEIGHTS} through broadcast_tx_commit on node 0 alone "
          f"reached every other mempool and committed at heights {list(tx_heights.values())} on "
          f"every node (the route's height and deliver_tx code 0; node 3's tx and tx_search find "
          f"each); broadcast_tx_commit's wall p50 {statistics.median(commit_s) * 1e3:.1f} ms ("
          + ", ".join(f"{s * 1e3:.0f}" for s in commit_s) + " ms); txs received by gossip by "
          f"node (the joining node last) {gossiped}; QoS admitted {qos['admitted']:.0f}, dropped "
          f"{qos['dropped'] or 0}; the evidence (validator {LN_OFFENDER}'s double sign at "
          f"{LN_EVIDENCE_HEIGHT}) committed at height {ev_at[0]} on every node", flush=True)
    sp = join["spans"]
    rt = sorted(signer_rt)
    print(f"  validator {LN_SIGNER} on a remote signer (SignerServiceEndpoint over TCP and a "
          f"{p2p_sts.STS_BACKEND} secret connection): {len(rt)} round trips (signs of votes "
          f"and proposals, its key), p50 {statistics.median(rt) * 1e3:.2f} ms, max "
          f"{rt[-1] * 1e3:.2f} ms; its precommit in every LastCommit of 2-{top_s}, each "
          f"accepted by every node's K1 + K2 check ({sum(len(v) for v in accepted.values())} "
          f"checks)", flush=True)
    print(f"  tm_monitor over the four RPCs agreed with /status in {mon_s:.2f} s: "
          + "; ".join(f"{m['moniker']} height {m['height']} VERIFY "
                      f"{_fmt_verify(m['verify_ms'], m['verify_path'])} DEVICE "
                      f"{_fmt_device(m['device_state'], m['device_fallbacks'])} CRIT {m['crit']} "
                      f"QUORUM {m['quorum']}" for m in mon_snaps), flush=True)
    print(f"  join by a seed: node 0 its only address; all {LN_VALS} validators its peers "
          f"{join['peers_s']:.3f} s after its start (PEX sweeping every {LN_PEX_PERIOD:g} s), "
          f"learned: " + ", ".join(f"node{i} {v}" for i, v in sorted(join["learned"].items()))
          + f"; {len(races_join)} simultaneous dials closed by the canonical rule", flush=True)
    print(f"  join at {LN_JOIN_AT}: restored snapshot {join['snapshot']} (the newest at "
          f"{LN_JOIN_AT - LN_JOIN_AT % LN_SNAPSHOT_INTERVAL}) in {join['restore_s']:.3f} s from "
          f"the node's start to on_synced (the node built in {join['build_s']:.3f} s; the "
          f"discovery wait {StateSyncConfig().discovery_time:g} s of it); spans (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in sp.items())
          + f"; the hand-off to consensus {join['handoff_s'] * 1e3:.1f} ms after it, "
          f"{join['synced']} block(s) fast-synced; at the tip {join['tip']} "
          f"{join['tip_s']:.3f} s after the start, then, every validator a peer, "
          f"{LN_FOLLOW} heights in "
          f"{join['follow_s']:.3f} s with the validators' block and app hashes; its RPC status "
          f"catching_up true at its start and false at the end", flush=True)
    print(f"  the joining node's K1 + K2 (K7) launches: trust hops {jl['trust']['k1']}, backfill "
          f"{jl['backfill']['k1']} (K7 {jl['backfill']['k7']}), fast-sync windows "
          f"{jl['fastsync']['k1']} + its first block's LastCommit "
          f"{jl['fastsync_last_commit']['k1']}, flushes {jl['flushes']['k1']}, LastCommit "
          f"checks {jl['last_commit']['k1']}", flush=True)
    print(f"  RPC ({rpc_s:.1f} s): {LN_RPC_CLIENTS} clients x /commit?verify=1 at heights 1-"
          f"{top_rpc - 1} + /validators?verify=1, {burst['answers']} answers in "
          f"{burst['wall_s'] * 1e3:.1f} ms, every verdict the host's; a height's p50 "
          f"{burst['p50_ms']:.1f} ms; {burst['dispatches']} LaneFeed dispatches, batch_rows "
          f"mean {burst['rows_mean']:.1f} max {burst['rows_max']}; K1 {rl['burst']['k1']}, K2 "
          f"{rl['burst']['k2']}, K7 {rl['burst']['k7']}; the profiler trace "
          f"({burst['trace_events']} events) names the kernels "
          f"{[k for k in burst['trace_kernels'] if any(v in k for v in LN_KERNEL_NAMES.values())][:4]}"
          f"; the lite client verified heights 1-{lite['heights']} of node 1 over "
          f"lite_full_commit in {lite['seconds'] * 1e3:.1f} ms (K1 + K2 {rl['lite']['k1']}); "
          f"node 2's websocket saw NewBlock at every height; node 3's /metrics holds the "
          f"{len(LN_METRIC_NAMES)} names; dump_device_health: breaker "
          f"{health['breaker']['state']}, no fallback", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"  every node at {top} with the same block and app hashes; no peer stopped for an "
          f"error ({len(races)} simultaneous-dial duplicates closed by the canonical rule before "
          f"height 1 and redialed, (node, peer, reason): {races}; {len(closed_run)} duplicates "
          f"closed in all); no fallback; breaker closed; no audit mismatch; phase "
          f"{seconds:.1f} s", flush=True)
    return {"sts_backend": p2p_sts.STS_BACKEND, "handshake_s": statistics.median(ups),
            "seal_ms": seal_ms, "open_ms": open_ms, "fallback_seal_ms": fb_seal_ms,
            "fallback_open_ms": fb_open_ms, "frames_per_height": frames_h,
            "blocks_s": blocks_s, "p50_ms": statistics.median(walls) * 1e3, "walls": walls,
            "flushes_per_height": flush_per_h, "last_commit_per_height": lc_per_h,
            "reasons": reasons, "rows_per_flush": statistics.mean(rows),
            "lanes_per_flush": statistics.mean(lanes), "peer_bytes": peer_bytes,
            "gossip": gossip, "seconds": seconds, "dial_races": len(races),
            "join": {k: join[k] for k in ("snapshot", "synced", "restore_s", "handoff_s",
                                           "tip_s", "follow_s", "peers_s")},
            "signer": {"round_trips": len(rt), "p50_ms": statistics.median(rt) * 1e3,
                       "max_ms": rt[-1] * 1e3},
            "rpc": {"burst": burst, "lite": lite,
                    "commit_p50_ms": statistics.median(commit_s) * 1e3},
            "launches": {"flushes": vals[0].get("ed25519_prologue", 0),
                         "last_commit": vals[1].get("ed25519_prologue", 0),
                         "join": {s: v["k1"] for s, v in jl.items()},
                         "rpc": {s: v["k1"] for s, v in rl.items()}}}


def cli_metric(text: str, name: str, **labels) -> float:
    """The sum of the series of ``name`` in Prometheus text whose labels
    include ``labels`` (0.0 when there is none)."""
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name) or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        series, _, lbl = head.partition("{")
        if series != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', lbl))
        if all(got.get(k) == v for k, v in labels.items()):
            total += float(value)
    return total


def cli_gpu_apps() -> list:
    """The compute processes nvidia-smi lists on the card, (pid, used
    memory) as it gives them. In a container its pids are the host's, not
    this process's (the H100 machine names every process pid 1), so the rows
    are kept as they are, one a process."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [tuple(p.strip() for p in line.split(",")) for line in out.splitlines()
            if line.strip()]


def cli_mem_used(device: str) -> float:
    """The card's used memory in MiB (nvidia-smi); NaN off the card."""
    if device == "cpu":
        return float("nan")
    return float(smi("memory.used").split()[0])


def cli_host_verdict(addr: str, chain_id: str, h: int) -> dict:
    """The host's verdict on a node's commit at ``h`` (its lite_full_commit
    over RPC) against its validator set: ``verify_commit`` on
    ``HostBatchVerifier`` and the tally of the signatures that verify."""
    fc = RPCProvider(addr).full_commit_at(chain_id, h)
    commit, vals = fc.signed_header.commit, fc.validators
    pubs, msgs, sigs, powers = vals.collect_commit_sigs(chain_id, commit.block_id, h, commit)
    ok = [bool(x) for x in verify_generic(pubs, msgs, sigs, verifier=HostBatchVerifier())]
    try:
        vals.verify_commit(chain_id, commit.block_id, h, commit, verifier=HostBatchVerifier())
        verified = True
    except CommitError:
        verified = False
    return {"verified": verified, "sigs_ok": all(ok),
            "tally": sum(p for p, o in zip(powers, ok) if o)}


def cli_bench(net, i: int) -> dict:
    """tm_bench at CLI_BENCH_RATE tx/s for CLI_BENCH_S s against node
    ``i``'s process: every tx it sent is in a block or in that node's
    mempool after it."""
    sent, mtx, real = [], threading.Lock(), rpc_client.HTTPClient.broadcast_tx_async

    def record(self, tx):
        out = real(self, tx)
        with mtx:
            sent.append(bytes(tx))
        return out

    addr = f"tcp://127.0.0.1:{net.rpc_port(i)}"
    rpc_client.HTTPClient.broadcast_tx_async = record
    try:
        stats = tm_bench.run_bench(addr, duration=CLI_BENCH_S, rate=CLI_BENCH_RATE,
                                   connections=1)
    finally:
        rpc_client.HTTPClient.broadcast_tx_async = real
    c = HTTPClient(addr)
    # the pool first: a tx leaves it only after its block is stored
    pooled = {base64.b64decode(t) for t in c.unconfirmed_txs(limit=100_000)["txs"]}
    committed, lost = 0, []
    for tx in sent:
        try:
            c.tx(hashlib.sha256(tx).hexdigest().upper())
            committed += 1
        except Exception:  # not indexed: it must be pooled
            if tx not in pooled:
                lost.append(tx)
    check(stats["txs_sent"] == len(sent) > 0 and not lost,
          f"cli: tm_bench sent {len(sent)} txs ({stats}), {len(lost)} neither committed nor "
          f"pooled")
    stats["committed"] = committed
    return stats


def cli_process_health(net, name: str, port: int, backend: str) -> dict:
    """One node process's guard and counters over its RPC: dump_device_health
    (the installed guarded verifier on ``backend``, the breaker closed, no
    fallback or failure event) and /metrics (device-backend verify calls
    above 0, no device fallback)."""
    c = HTTPClient(f"tcp://127.0.0.1:{port}")
    health = c.dump_device_health()
    text = c.metrics_text()
    calls = cli_metric(text, "tendermint_verify_calls_total", backend=backend)
    fallbacks_n = cli_metric(text, "tendermint_verify_device_fallback_total")
    bad = [e for e in health["events"] if e["kind"] != "breaker"]
    v = health["verifier"]
    # off the card (a rehearsal) TM_BATCH_VERIFIER=host installs the host's
    check(health["breaker"]["state"] == "closed" and not bad and v["installed"]
          and (backend == "host" or (v.get("guard") is not None and v["backend"] == backend)),
          f"cli: {name}'s dump_device_health: breaker {health['breaker']['state']}, verifier "
          f"{v}, events {bad}")
    check(calls > 0 and fallbacks_n == 0,
          f"cli: {name}'s /metrics: {calls} verify calls on {backend}, {fallbacks_n} device "
          f"fallbacks")
    return {"calls": calls, "fallbacks": fallbacks_n}


def cli_wait_stamped(net, h: int, nodes, stamps: dict) -> bool:
    """Wait until every node of ``nodes`` is at ``h``, polling node
    ``nodes[0]``'s height every 20 ms; ``stamps`` gets the wall time at which
    each of its heights was first seen."""
    deadline = time.monotonic() + CLI_TIMEOUT
    while time.monotonic() < deadline:
        top, now = net.height(nodes[0]), time.perf_counter()
        for k in range(1, top + 1):
            stamps.setdefault(k, now)
        if top >= h and all(net.height(i) >= h for i in nodes[1:]):
            return True
        time.sleep(0.02)
    return False


def phase_cli(dev, err: dict) -> dict:
    """Phase 26: BASELINE.json config 1 as its containers run it: a testnet
    written by the CLI, four `tendermint node` processes on the card (node
    3 on a socket app this process serves), a `lite` process, a killed and
    restarted node, tm_bench, and SIGTERM to all."""
    device = dev.type
    backend = "host" if device == "cpu" else device
    phase(f"cli: `testnet --v {CLI_VALS} --chain-id {CLI_CHAIN}`, then {CLI_VALS} `tendermint "
          f"node` processes on --device {device} (nodes 0-2 on the in-process kvstore, node 3 "
          f"on a socket KVStoreApp this process serves over ABCIServer; --consensus."
          f"timeout_commit {CLI_TIMEOUT_COMMIT:g} as tests/test_localnet.py, the vote feed at "
          f"{CLI_WINDOW_MS:g} ms, the unsafe routes and /metrics on), a `lite` process on "
          f"node 0; to height {CLI_HEIGHTS}, a tx through node 3's socket app, ?verify=1 on "
          f"node 1, every height through the lite process, node 3 killed and restarted, "
          f"tm_bench on node 0, SIGTERM to all")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    app = KVStoreApp()
    srv = ABCIServer("tcp://127.0.0.1:0", app)
    srv.start()
    env = dict(os.environ)
    if device != "cpu":
        env.pop("TM_BATCH_VERIFIER", None)
    net = cli_net.CLINet(tmp, CLI_VALS, chain_id=CLI_CHAIN, device=device, env=env,
                         timeout_commit=CLI_TIMEOUT_COMMIT, node_flags=[
                             "--rpc.unsafe", "true", "--instrumentation.prometheus", "true",
                             "--verify.vote_batch_window_ms", str(CLI_WINDOW_MS)])
    apps, rcs = [], {}
    used = {"before": cli_mem_used(device)}
    try:
        t0 = time.perf_counter()
        for i in range(CLI_VALS):
            net.spawn_node(i, "kvstore" if i < CLI_VALS - 1
                           else f"tcp://127.0.0.1:{srv.bound_port}")
        procs = [net.node(i) for i in range(CLI_VALS)]
        up = [p.wait_answer("/health", CLI_TIMEOUT) for p in procs]
        # the lite process while the nodes reach height 3 (its start beside
        # theirs would slow all five: `import torch` is most of a start)
        lite = net.spawn_lite(0)
        check(cli_net.wait_for(lambda: all(net.n_peers(i) >= CLI_VALS - 1
                                           for i in range(CLI_VALS)), CLI_TIMEOUT),
              f"cli: peers {[net.n_peers(i) for i in range(CLI_VALS)]}\n{net.tails()}")
        stamps = {}
        check(cli_wait_stamped(net, CLI_HEIGHTS, list(range(CLI_VALS)), stamps),
              f"cli: heights {[net.height(i) for i in range(CLI_VALS)]}\n{net.tails()}")
        t_up = time.perf_counter() - t0
        up.append(lite.wait_answer("/frontend_stats", CLI_TIMEOUT))
        check(all(up), f"cli: processes up {up}\n{net.tails()}")
        apps = cli_gpu_apps()
        used["running"] = cli_mem_used(device)
        answers = {name: p.first_answer_s for name, p in net.procs.items()}
        # a tx through node 3's socket app: its CheckTx and DeliverTx cross the socket
        c3 = HTTPClient(f"tcp://127.0.0.1:{net.rpc_port(3)}")
        res = c3.broadcast_tx_commit(CLI_TX)
        check(res["check_tx"]["code"] == 0 and res["deliver_tx"]["code"] == 0,
              f"cli: broadcast_tx_commit on node 3: {res}")
        key, value = CLI_TX.split(b"=")
        found = {}
        for i in (0, CLI_VALS - 1):
            check(cli_net.wait_for(lambda i=i: net.height(i) >= res["height"], CLI_TIMEOUT),
                  f"cli: node {i} did not reach the tx's height {res['height']}")
            q = HTTPClient(f"tcp://127.0.0.1:{net.rpc_port(i)}").abci_query(data=key)
            found[i] = base64.b64decode(q["response"]["value"])
        local = app.query(abci.RequestQuery(data=key, path="/store")).value
        check(found == {0: value, CLI_VALS - 1: value} and local == value,
              f"cli: abci_query of {key!r}: {found}, the socket app's store {local!r}")
        # node 3 killed; the others commit two more; node 3 restarted with the
        # same command, and the checks of nodes 0-2 run while it starts
        net.kill(CLI_VALS - 1)
        h = max(net.height(i) for i in range(CLI_VALS - 1))
        check(cli_wait_stamped(net, h + CLI_AHEAD, list(range(CLI_VALS - 1)), stamps),
              f"cli: without node 3, heights {[net.height(i) for i in range(CLI_VALS - 1)]}")
        t_r = time.perf_counter()
        node3 = net.restart_node(CLI_VALS - 1)
        target = max(net.height(i) for i in range(CLI_VALS - 1))
        # ?verify=1 on node 1 against the host's verify_commit
        addr1 = f"tcp://127.0.0.1:{net.rpc_port(1)}"
        verdicts = {}
        for h in range(1, CLI_HEIGHTS + 1):
            v = net.rpc(1, f"/commit?height={h}&verify=1")["verification"]
            want = cli_host_verdict(addr1, CLI_CHAIN, h)
            verdicts[h] = {k: v[k] for k in ("verified", "sigs_ok", "tally")}
            check(verdicts[h] == want, f"cli: node 1's /commit?height={h}&verify=1 gave {v}, "
                                       f"the host {want}")
        # every height through the lite process, each equal to node 0's
        top = net.height(0)
        t_l = time.perf_counter()
        lite_out = {h: cli_net.rpc_get(lite.port, f"/commit?height={h}", timeout=CLI_TIMEOUT)
                    for h in range(1, top + 1)}
        lite_s = time.perf_counter() - t_l
        for h, got in lite_out.items():
            want = net.rpc(0, f"/commit?height={h}")["signed_header"]
            check(got.get("verified") is True and got["header"]["height"] == h
                  and got["header"]["app_hash"] == want["header"]["app_hash"]
                  and got["commit"]["block_id_hash"] == want["commit"]["block_id"]["hash"],
                  f"cli: the lite process's /commit?height={h}: {got}, node 0's {want}")
        lite_stats = cli_net.rpc_get(lite.port, "/frontend_stats")
        check(lite_stats["dispatches"] > 0, f"cli: the lite process's stats {lite_stats}")
        # its first answer (the checks above took less than its start)
        check(node3.wait_answer("/health", CLI_TIMEOUT),
              f"cli: the restarted node 3 did not answer\n{node3.tail()}")
        answers["node3 restarted"] = node3.first_answer_s
        check(cli_net.wait_for(lambda: net.height(CLI_VALS - 1) >= target, CLI_TIMEOUT),
              f"cli: the restarted node 3 at {net.height(CLI_VALS - 1)}, the tip {target}\n"
              f"{node3.tail()}")
        restart_s = time.perf_counter() - t_r
        # tm_bench once all four run again (with node 3 down every fourth
        # height waits out its proposer's timeout_propose)
        bench = cli_bench(net, 0)
        # the four nodes' blocks and app hashes agree at every height to node
        # 3's tip (its blocks to `target` fast-synced, the tx's block included)
        for h in range(1, net.height(CLI_VALS - 1) + 1):
            heads = [net.rpc(i, f"/commit?height={h}")["signed_header"] for i in range(CLI_VALS)]
            check(len({x["header"]["app_hash"] for x in heads}) == 1
                  and len({x["commit"]["block_id"]["hash"] for x in heads}) == 1,
                  f"cli: the nodes' blocks or app hashes at {h} differ")
        # each process's guard and counters, read before they stop
        health = {f"node{i}": cli_process_health(net, f"node {i}", net.rpc_port(i), backend)
                  for i in range(CLI_VALS)}
        # the chain's walls: node 0's heights as this process first saw them
        # (polled every 20 ms) while the net ran to CLI_HEIGHTS and then on
        # three nodes; heights first seen in one poll, or that passed between
        # two waits, have no wall
        walls = [stamps[k] - stamps[k - 1] for k in sorted(stamps)
                 if k - 1 in stamps and stamps[k] > stamps[k - 1]]
        ks = sorted(k for k in stamps if k >= 2)
        blocks_s = len(walls) / sum(walls)
        pids = {name: p.pid for name, p in net.procs.items()}
        t_stop = time.perf_counter()
        rcs = net.stop_all(CLI_STOP_S)
        stop_s = time.perf_counter() - t_stop
        used["after"] = cli_mem_used(device)
        check(all(rc == 0 for rc in rcs.values()),
              f"cli: exit codes on SIGTERM {rcs} (within {CLI_STOP_S:g} s)\n{net.tails()}")
        # each node ran the [p2p] default, the peer exchange on: its PEX
        # reactor saved the address book when the node stopped
        books = [os.path.join(net.home(i), "config", "addrbook.json") for i in range(CLI_VALS)]
        check(all(os.path.exists(b) for b in books),
              f"cli: no address book saved by the peer exchange: "
              f"{[b for b in books if not os.path.exists(b)]}")
    except BaseException:
        print(net.tails(), flush=True)
        raise
    finally:
        net.stop_all(CLI_STOP_S)
        srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    smi_line = smi("name,power.limit") if device != "cpu" else "cpu"
    print(f"  [{smi_line}] seconds from spawn to the first RPC answer: "
          + ", ".join(f"{k} {v:.2f}" for k, v in answers.items() if v is not None)
          + f"; all {CLI_VALS} nodes at {CLI_HEIGHTS} with 3 peers {t_up:.2f} s after the "
          f"spawn", flush=True)
    print(f"  [{smi_line}] {blocks_s:.3f} blocks/s over {len(walls)} heights of node 0 "
          f"({ks[0]}-{ks[-1]}, as this process saw them), a height's p50 "
          f"{statistics.median(walls) * 1e3:.1f} ms; the tx through "
          f"node 3's socket app committed at {res['height']} and abci_query finds it on nodes 0 "
          f"and 3; ?verify=1 on node 1 at 1-{CLI_HEIGHTS} {verdicts} (the host's); the lite "
          f"process certified heights 1-{len(lite_out)} in {lite_s * 1e3:.1f} ms "
          f"({lite_stats['dispatches']} dispatches, {lite_stats['rows_in']} rows); node 3 "
          f"restarted to the tip {target} in {restart_s:.2f} s", flush=True)
    print(f"  [{smi_line}] tm_bench ({CLI_BENCH_S:g} s at {CLI_BENCH_RATE} tx/s, 1 connection, "
          f"node 0's process, after node 3's restart): sent {bench['txs_sent']}, committed "
          f"{bench['committed']}, "
          f"{bench['blocks_seen']} blocks in {bench['duration_s']} s; Txs/sec avg "
          f"{bench['txs_per_sec']['avg']}; Blocks/sec avg {bench['blocks_per_sec']['avg']}",
          flush=True)
    per = (used["running"] - used["before"]) / len(pids)
    print(f"  [{smi_line}] GPU memory: the card's used memory {used['before']:.0f} MiB before "
          f"the spawn, {used['running']:.0f} MiB with the {len(pids)} processes running "
          f"({per:.0f} MiB a process on average), {used['after']:.0f} MiB after they exit; "
          f"nvidia-smi --query-compute-apps lists (pid, memory) {apps} (the container's pids "
          f"are not the card's, so no row names its process); verify calls on {backend} "
          f"by node {[h['calls'] for h in health.values()]}, device fallbacks 0; SIGTERM: "
          f"exit codes {rcs}, seconds to exit "
          f"{ {k: round(p.exit_s, 2) for k, p in net.procs.items() if p.exit_s is not None} } "
          f"({stop_s:.2f} s for all); the peer exchange on in every node (the [p2p] "
          f"default; each saved its address book at exit); phase {seconds:.1f} s", flush=True)
    return {"seconds": seconds, "first_answer_s": answers, "blocks_s": blocks_s,
            "p50_ms": statistics.median(walls) * 1e3, "lite_s": lite_s,
            "lite_heights": len(lite_out), "restart_s": restart_s, "bench": bench,
            "calls": {k: v["calls"] for k, v in health.items()},
            "lite_dispatches": lite_stats["dispatches"],
            "gpu_apps": apps, "gpu_used_mib": used, "gpu_mib_per_process": per}


# -- phase 27: the chaos simulator ----------------------------------------------------------


def sim_feeds(run) -> list:
    """Each node's vote feed as (dispatches, votes in, device type, its own
    verifier or None: the installed one)."""
    return [(n.vote_feed.dispatches, n.vote_feed.votes_in, n.vote_feed.device.type,
             None if n.vote_feed.verifier is None else type(n.vote_feed.verifier).__name__)
            for n in run.nodes if n.vote_feed is not None]


def sim_with_check(scenario, extra):
    """``scenario`` whose check hook also calls ``extra(run)`` (which may
    record what the run leaves behind) and adds its failures."""
    check_ = scenario.check

    def both(run):
        return list(check_(run) if check_ is not None else []) + list(extra(run) or [])

    scenario.check = both
    return scenario


def sim_host_executors(scenario):
    """``scenario`` with every node's LastCommit checks on the host
    (``BlockExecutor.verifier``): a net that verifies on the host while the
    card's root stays installed for a net beside it."""
    setup_ = scenario.setup

    def setup(run):
        if setup_ is not None:
            setup_(run)
        for n in run.nodes:
            n.cs.block_exec.verifier = HostBatchVerifier()

    scenario.setup = setup
    return scenario


def sim_baseline(dev) -> dict:
    """(a): baseline_determinism on the card, then the same seed with every
    LastCommit check on the host; the commit hashes of every node over the
    deterministic prefix (round 0, every LastCommit canonical:
    testutil/sim_determinism) must be equal. The two nets run one after the
    other: side by side in one interpreter, the host net's Python verifies
    left a late precommit out of a LastCommit in 3 of 8 attempts over five
    runs of the whole script, on both codec paths."""
    target = sim.SCENARIOS["baseline_determinism"]().target_height
    for attempt in range(1, SIM_ATTEMPTS + 1):
        host_sc = sim_determinism.recording_canonical_commits(
            sim_host_executors(sim.SCENARIOS["baseline_determinism"]()))
        card_sc = sim_determinism.recording_canonical_commits(
            sim.SCENARIOS["baseline_determinism"]())
        t0 = time.perf_counter()
        reset_launches()
        card = sim.run_scenario(card_sc, device=dev)
        host = sim.run_scenario(host_sc, device=dev)
        launches = read_launches()
        wall = time.perf_counter() - t0
        hard = [f for f in card.failures + host.failures if not f.startswith("liveness")]
        check(not hard, f"sim (a): {hard}")
        # the deterministic prefix: round 0 and canonical LastCommits
        top = min(sim_determinism.deterministic_top(card, card_sc, sim.round0_clean_top),
                  sim_determinism.deterministic_top(host, host_sc, sim.round0_clean_top))
        if card.ok and host.ok and top >= target:
            break
        print(f"  (a) attempt {attempt}: the deterministic prefix reached h={top} (not canonical "
              f"{card_sc.not_canonical} / {host_sc.not_canonical}; card {card.failures}, "
              f"host {host.failures})", flush=True)
    check(top >= target, f"sim (a): the deterministic prefix reached only h={top}")
    bad = chaos_smoke.commit_hash_mismatches(card, host, top)
    check(not bad, f"sim (a): commit hashes differ between the card and the host: {bad}")
    check(launches["ed25519_prologue"] > 0 and launches["ed25519_ladder"] > 0,
          f"sim (a): no K1 + K2 launch on the card's LastCommit checks: {launches}")
    hashes = [card.commit_hashes[0][h][:12] for h in range(1, top + 1)]
    print(f"  (a) baseline_determinism, seed {card.seed}: the card's net and the host's, one "
          f"after the other in {wall:.1f} s; heights {card.heights} / {host.heights}; every node's commit "
          f"hash equal over the deterministic prefix 1..{top} ({', '.join(hashes)}); the card's "
          f"LastCommit checks launched {launches}", flush=True)
    return {"seconds": wall, "top": top, "launches": launches}


def sim_vote_storm(dev, err: dict) -> dict:
    """(b): vote_storm on the card: evidence committed and marked in every
    pool (the scenario's own check), every node's vote feed dispatched on
    the card through the installed guarded verifier, no fallback; K1 and K2
    held exact on one launch's inputs."""
    seen = {}

    def feeds(run):
        seen["feeds"] = sim_feeds(run)
        seen["evidence"] = [n.committed_evidence_heights() for n in run.nodes]
        seen["serial"] = [dict(n.cs.serial_votes) for n in run.nodes]

    before = fallbacks()
    t0 = time.perf_counter()
    reset_launches()
    with captured_packs() as packs:
        res = sim.run_scenario(sim_with_check(sim.SCENARIOS["vote_storm"](), feeds), device=dev)
    launches = read_launches()
    wall = time.perf_counter() - t0
    check(res.ok, f"sim (b): vote_storm failed (seed {res.seed}): {res.failures}")
    check(len(seen["feeds"]) == len(res.heights) and all(
        d > 0 and kind == "cuda" and own is None for d, _, kind, own in seen["feeds"]),
        f"sim (b): a node's vote feed did not dispatch on the card: {seen['feeds']}")
    check_guard_clean(before, "sim (b)")
    check(launches["ed25519_prologue"] > 0 and launches["ed25519_ladder"] > 0,
          f"sim (b): no K1 + K2 launch: {launches}")
    check(packs, "sim (b): no packed K1 + K2 inputs recorded")
    b, _, _ = hold_k1_k2(packs[0], err, "sim vote_storm")
    dispatches = sum(d for d, _, _, _ in seen["feeds"])
    print(f"  (b) vote_storm, seed {res.seed}: {wall:.1f} s, heights {res.heights}; evidence "
          f"committed at {seen['evidence']} and marked in every pool; vote feeds (dispatches, "
          f"votes in) {[(d, v) for d, v, _, _ in seen['feeds']]} on the card through the "
          f"installed guarded verifier; serial votes by reason {seen['serial'][0]} (node 0); "
          f"seeded fault decisions {res.fault_summary.get('seeded_decisions')}; launches "
          f"{launches} for {dispatches} flushes and the LastCommit checks; no fallback; K1/K2 "
          f"exact on the first launch's inputs (b = {b})", flush=True)
    return {"seconds": wall, "launches": launches, "dispatches": dispatches,
            "heights": res.heights, "result": res}


def sim_card_fault(dev) -> dict:
    """(c): FaultyDevice around the card's verifier behind the one guarded
    verifier every node shares: SIM_FAULT_OK answered calls, then every call
    fails. The net halts on DeviceDispatchError with no host fallback, no
    store passes the height being decided when the fault fired, and every
    verdict before the fault equals the host's (the scenario's own check)."""
    seen = {}

    def record(run):
        seen["faults"] = [None if n.cs.device_fault is None else type(n.cs.device_fault).__name__
                          for n in run.nodes]
        seen["stores"] = [n.block_store.height() for n in run.nodes]
        seen["calls"] = len(run.recorder.calls)
        seen["failures"] = run.device.snapshot()["failures"]
        seen["on_card"] = run.guarded.on_card

    before = fallbacks()
    default_breaker = breaker.get_device_breaker()
    t0 = time.perf_counter()
    reset_launches()
    res = sim.run_scenario(sim_with_check(sim_fault.card_fault_scenario(
        lambda: TorchBatchVerifier(dev), n_ok=SIM_FAULT_OK), record), device=dev)
    launches = read_launches()
    wall = time.perf_counter() - t0
    check(res.ok, f"sim (c): {res.failures}")
    check(seen["on_card"] and "DeviceDispatchError" in seen["faults"],
          f"sim (c): no halt on DeviceDispatchError: {seen}")
    check(fallbacks() == before, "sim (c): a dispatch fell back to the host")
    check(breaker.get_device_breaker() is default_breaker
          and default_breaker.state == breaker.CLOSED,
          "sim (c): the default breaker changed")
    check(launches["ed25519_prologue"] > 0 and launches["ed25519_ladder"] > 0,
          f"sim (c): no K1 + K2 launch before the fault: {launches}")
    print(f"  (c) an injected device fault on the card: FaultyDevice(TorchBatchVerifier) behind "
          f"the nodes' shared guarded verifier (on the card) answered {seen['calls']} calls, "
          f"every verdict the host's, then failed {seen['failures']} call(s); halts "
          f"{seen['faults']}; consensus heights at the fault {res.marks['fault']['heights']}, "
          f"when the net had stopped {res.marks['halted']['heights']}, stores {seen['stores']}; "
          f"no host fallback; launches {launches}; {wall:.1f} s", flush=True)
    return {"seconds": wall, "launches": launches, "faults": seen["faults"]}


def phase_sim(dev, err: dict) -> dict:
    """Phase 27: the chaos simulator (sim/, p2p/inproc.py) on the card, on a
    default [verify] root of its own."""
    phase(f"sim: 4-validator SimNets on the card's default [verify] root: (a) "
          f"baseline_determinism and a host-verifier run of its seed, (b) vote_storm, (c) a "
          f"device fault after {SIM_FAULT_OK} answered calls of the shared guarded verifier")
    t_phase = time.perf_counter()
    root = configure_verify(VerifyConfig(), device=dev)
    check(get_batch_verifier() is root.verifier, "the root's guarded verifier is not installed")
    a = sim_baseline(dev)
    b = sim_vote_storm(dev, err)
    c = sim_card_fault(dev)
    check(get_batch_verifier() is root.verifier, "sim: the root's verifier was not reinstalled")
    seconds = time.perf_counter() - t_phase
    print(f"  phase {seconds:.1f} s: (a) {a['seconds']:.1f}, (b) {b['seconds']:.1f}, "
          f"(c) {c['seconds']:.1f}", flush=True)
    return {"a": a, "b": b, "c": c, "seconds": seconds,
            "launches": {"determinism": a["launches"], "vote_storm": b["launches"],
                         "fault": c["launches"]}}



# -- phase 28: the multi-device lane split, K5 and K6 ------------------------

MESH_SHARDS = 4
MESH_AUDIT_RATE = 0.005  # the phase's guarded dispatches audit 0.5 % of their lanes
K5_REPLACES = "tendermint_tpu/ops/ed25519_verify.py:343"
K6_REPLACES = "tendermint_tpu/ops/secp256k1_verify.py:330"
MESH_KERNELS = ("ed25519_verify", "secp256k1_verify")
# K5 and K6 alone at shard sizes: a quarter of N = 10,240, and the shard the
# mesh route launches for the 10k commit (the reference's bucket, 12,288,
# over four devices)
MESH_SHARD_ROWS = (2_560, 3_072)


def mesh_devices() -> list:
    """Four shards: cuda:0 four times on one card, the distinct cards in
    turn where there are more."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", k % n) for k in range(MESH_SHARDS)]


def edge_rows(rows: list, edges: list) -> list:
    """``rows`` with its last len(edges) rows replaced by ``edges``."""
    return rows[: len(rows) - len(edges)] + edges


def ladder_resources(name: str) -> dict:
    """Registers, stack and spills of library ``name``'s ladder kernel."""
    return next((r for r in kernel_resources(name).values() if "registers" in r), {})


def mesh_ladder(name: str, head: str, verify_rows, geometry, ins, ref, plain_ms: float, ops,
                per_row: int, mul_rate: float, err: dict) -> dict:
    """K5 or K6 on every row of ``ins`` (N) and on its first b rows for
    each b of MESH_SHARD_ROWS: exact against the same rows of the full
    plain run ``ref`` (rows are independent) and timed, each with its bound
    over this design's products (``per_row`` a row, whatever the scalars)
    and, beside it, over the reference's bit-serial products on those rows
    (``ops(b)``, more); prints ``head``'s line."""
    n = ins[0].shape[1]
    sizes = {}
    for b in (n, *MESH_SHARD_ROWS):
        sub = ins if b == n else tuple(t[:, :b].contiguous() for t in ins)
        got = verify_rows(*sub)
        worst = max_abs_diff((got,), (ref[:b],))
        err[name] = max(err.get(name, 0), worst)
        check(worst == 0, f"{name} at b = {b} differs from its plain version: {worst}")
        sizes[b] = {"ms": cuda_ms(lambda: verify_rows(*sub)),
                    "bound": least_ms(sub, (got,), per_row * b, mul_rate),
                    "reference_bound": least_ms(sub, (got,), ops(b), mul_rate)}
    res = sizes.pop(n)
    ms, bound, ref_bound = res["ms"], res["bound"], res["reference_bound"]
    lanes, rpb, blocks, smem = geometry(n)
    print(f"  {head}; {ms:.4f} ms at N = {n} (20 launches; plain {plain_ms:.1f} ms), bound "
          f"{bound[0]:.4f} ms by {bound[1]} over this design's {per_row:,} products a row "
          f"({bound[0] / ms:.1%} of it), {ref_bound[0]:.4f} ms over the reference's "
          f"{ops(n):,} ({ref_bound[0] / ms:.1%}); "
          + "; ".join(f"b = {b}: {v['ms']:.4f} ms, exact, {v['bound'][0] / v['ms']:.1%} of "
                      f"{v['bound'][0]:.4f} ({v['reference_bound'][0] / v['ms']:.1%} of "
                      f"{v['reference_bound'][0]:.4f})" for b, v in sizes.items())
          + f"; {lanes} lanes a row, {rpb} rows a block, {blocks} blocks, {smem:,} bytes of "
          f"shared memory; {registers(name)}", flush=True)
    return {**res, "plain_ms": plain_ms, "products": per_row * n, "reference_products": ops(n),
            "shards": sizes, "resources": ladder_resources(name), "b": n}


def mesh_k5(dev, sc_: tc.SignedCommit, mul_rate: float, err: dict) -> dict:
    """(a): K5 at N = 10,240 on the 10k commit's rows, its last 20 the Go
    edge window's (a flipped bit, a non-canonical R, an s with a top bit
    set, an order-8 key), against its plain version on the card."""
    e_pubs, e_msgs, e_sigs, verdicts = tc.go_edge_window(seed=0)
    pubs = edge_rows([v.pub_key.bytes() for v in sc_.valset.validators], e_pubs)
    msgs = edge_rows([pc.sign_bytes(sc_.chain_id) for pc in sc_.commit.precommits], e_msgs)
    sigs = edge_rows([pc.signature for pc in sc_.commit.precommits], e_sigs)
    pubs_a, sigs_a = as_arrays(pubs, sigs)
    *host, valid = k5v.host_prologue(pubs_a, msgs, sigs_a)
    b = ec._bucket(len(pubs))
    host = [ec._pad_rows(np.asarray(a), b) for a in host]
    ins = k5v.upload(host, dev)
    out = k5v.verify_rows(*ins)
    ref, plain_ms = cuda_once(lambda: k5v.verify_ref(*ins))  # held against it in mesh_ladder
    ok = (out[: len(pubs)].cpu().numpy() != 0) & valid
    n_edge = len(e_pubs)
    check(bool(ok[: -n_edge].all()), "K5: a commit row was rejected")
    for j, want_v in verdicts.items():
        want_v = ed._verify_pure(e_pubs[j], e_msgs[j], e_sigs[j]) if want_v is None else want_v
        check(bool(ok[len(pubs) - n_edge + j]) == want_v,
              f"K5 edge row {j}: {ok[len(pubs) - n_edge + j]}, want {want_v}")

    def ops(rows: int) -> int:  # the reference's bit-serial products over the first rows
        muls, squarings = k5v.k5_fe_ops(host[2][:rows], host[3][:rows])
        return muls * fe.NLIMB ** 2 + squarings * fe.NLIMB * (fe.NLIMB + 1) // 2

    d_muls, d_squarings = ec.ladder_fe_ops()
    per_row = d_muls * fe.NLIMB ** 2 + d_squarings * fe.NLIMB * (fe.NLIMB + 1) // 2
    return mesh_ladder("ed25519_verify", f"(a) K5 exact on every row, the {n_edge} Go edge "
                       f"rows' verdicts Go's", k5v.verify_rows, k5v.k5_geometry, ins, ref,
                       plain_ms, ops, per_row, mul_rate, err)


def mesh_k6(dev, sc_: tc.SignedCommit, mul_rate: float, err: dict) -> dict:
    """(b): K6 at N = 10,240 on the 10k secp256k1 commit's rows, its last
    23 the secp256k1 edge window's, against its plain version on the card."""
    pks, msgs, sigs, _ = sc_.valset.collect_commit_sigs(
        sc_.chain_id, sc_.block_id, sc_.height, sc_.commit)
    e_pubs, e_digs, e_sigs, verdicts = tc.secp_edge_window(seed=1)
    pubs = edge_rows([pk.bytes() for pk in pks], e_pubs)
    digs = edge_rows([sha256(m) for m in msgs], e_digs)
    sigs = edge_rows(list(sigs), e_sigs)
    b = ec._bucket(len(pubs))
    host, forced = k6v.pack_rows(pubs, digs, sigs, b)
    ins = k6v.upload(host, dev)
    out = k6v.verify_rows(*ins)
    ref, plain_ms = cuda_once(lambda: k6v.verify_ref(*ins))  # held against it in mesh_ladder
    ok = out[: len(pubs)].cpu().numpy() != 0
    got = np.where(forced[: len(pubs)] >= 0, forced[: len(pubs)].astype(bool), ok)
    n_edge = len(e_pubs)
    check(bool(got[: -n_edge].all()), "K6: a commit row was rejected")
    for j, want_v in verdicts.items():
        check(bool(got[len(pubs) - n_edge + j]) == want_v,
              f"K6 edge row {j}: {got[len(pubs) - n_edge + j]}, want {want_v}")

    def products(muls: int, squarings: int, smalls: int) -> int:
        return muls * F.NLIMB ** 2 + squarings * F.NLIMB * (F.NLIMB + 1) // 2 + smalls * F.NLIMB

    def ops(rows: int) -> int:  # the reference's bit-serial products over the first rows
        return products(*k6v.k6_fe_ops(host[2][:rows], host[3][:rows]))

    return mesh_ladder("secp256k1_verify", f"(b) K6 exact on every row, the {n_edge} edge rows' "
                       f"verdicts the oracle's", k6v.verify_rows, k6v.k6_geometry, ins, ref,
                       plain_ms, ops, products(*sc.ladder_fe_ops()), mul_rate, err)


def mesh_verifier(dev, mesh, ed_sc: tc.SignedCommit, secp_sc: tc.SignedCommit) -> dict:
    """(c): both 10k commits through TorchBatchVerifier(mesh=): K5 and K6
    once a shard, the verdicts the unsharded verifier's (K1 + K2, K3); the
    launch counts set to 0 just before the mesh calls and read just after."""
    out = {}
    for what, sc_, verify in (
            ("ed25519", ed_sc, lambda v, cols: v.verify_ed25519_raw(*cols)),
            ("secp256k1", secp_sc, lambda v, cols: v.verify_secp256k1(
                [SigItem(p, m, g) for p, m, g in zip(*cols)]))):
        pks, msgs, sigs, _ = sc_.valset.collect_commit_sigs(
            sc_.chain_id, sc_.block_id, sc_.height, sc_.commit)
        sigs = list(sigs)
        sigs[N_VALIDATORS // 3] = bytes(flipped(sc_, N_VALIDATORS // 3).precommits[
            N_VALIDATORS // 3].signature)
        cols = ([pk.bytes() for pk in pks], msgs, sigs)
        want = verify(TorchBatchVerifier(dev), cols)
        meshed = TorchBatchVerifier(mesh=mesh)
        check(meshed.kernel_route == "xla" and meshed.backend == dev.type,
              f"the mesh verifier's route {meshed.kernel_route}, label {meshed.backend}")
        reset_launches()
        t0 = time.perf_counter()
        got = verify(meshed, cols)
        wall = time.perf_counter() - t0
        launches = read_launches()
        name = "ed25519_verify" if what == "ed25519" else "secp256k1_verify"
        check(launches[name] == MESH_SHARDS and sum(launches.values()) == MESH_SHARDS,
              f"(c) {what}: launches {launches}, want {name} once a shard")
        check(np.array_equal(got, want) and int((~got).sum()) == 1,
              f"(c) {what}: the mesh verdicts differ from the unsharded verifier's")
        print(f"  (c) {what}: {N_VALIDATORS} rows through TorchBatchVerifier(mesh) in "
              f"{wall * 1e3:.1f} ms, verdicts equal the unsharded verifier's (the flipped row "
              f"rejected); launches {launches}: {launches[name] // MESH_SHARDS} a shard",
              flush=True)
        out[what] = {"launches": launches, "wall_s": wall}
    return out


def shard_ticks(labels) -> dict:
    m = get_verify_metrics()
    return {lbl: m.device_dispatches._values.get((lbl,), 0.0) for lbl in labels}


def mesh_windows(dev, mesh, mesh2d, window: dict, fs_chain) -> dict:
    """(d): the 512 x 64 window through verify_windows(mesh) in both reduce
    modes, verify_commit_window on the 2 x 2 (height, val) mesh, and
    verify_block_window(mesh) over the fast-sync cell's 513 blocks, each
    equal to its flat path; guarded (no fallback, the breaker closed) and
    recorded as four shards."""
    votes, powers, totals = window["rows"]
    want = window["verdict"]
    before = fallbacks()
    labels = mesh.labels()
    out = {}
    for reduce in ("device", "host"):
        planner.set_reduce_mode(reduce)
        ticks0 = shard_ticks(labels)
        reset_launches()
        planner.tally_launches["planner_tally"] = 0
        t0 = time.perf_counter()
        try:
            got = planner.verify_windows([(votes, powers, totals)], mesh=mesh,
                                         use_device=True)[0]
        finally:
            planner.set_reduce_mode("device")
        wall = time.perf_counter() - t0
        launches = {**read_launches(), **planner.tally_launches}
        for k in VERDICT_KEYS:
            check(np.array_equal(getattr(got, k), getattr(want, k)),
                  f"(d) planner mesh ({reduce}): {k} differs from the flat path's")
        check(got.tally.dtype == np.int64, "(d) the mesh tally is not int64")
        ticks = {k: v - ticks0[k] for k, v in shard_ticks(labels).items()}
        check(list(ticks.values()) == [1.0] * MESH_SHARDS,
              f"(d) record_device_shards: {ticks}")
        check(get_profiler().entries()[-1]["kind"] == "planner_mesh"
              and get_profiler().entries()[-1]["n_devices"] == MESH_SHARDS,
              "(d) the dispatch is not recorded as planner_mesh over four shards")
        k1 = launches["ed25519_prologue"]
        check(k1 >= MESH_SHARDS and launches["ed25519_ladder"] == k1
              and launches["planner_tally"] == (MESH_SHARDS if reduce == "device" else 0),
              f"(d) planner mesh ({reduce}): launches {launches}")
        print(f"  (d) verify_windows(mesh), reduce {reduce}: {wall:.2f} s; lanes and int64 "
              f"tallies equal the flat path's; shards {ticks}; launches {launches}", flush=True)
        out[f"planner_{reduce}"] = launches
    raw = [[None if x is None else (x[0].bytes(), x[1], x[2]) for x in row] for row in votes]
    win = cv.pack_commit_window(raw, powers)
    ticks0 = shard_ticks(mesh2d.labels())
    reset_launches()
    cv.tally_launches["window_tally"] = 0
    t0 = time.perf_counter()
    got = cv.verify_commit_window(win, totals[0], mesh=mesh2d)
    wall = time.perf_counter() - t0
    launches = {**read_launches(), **cv.tally_launches}
    for k, g in zip(("ok", "tally", "committed"), got):
        check(np.array_equal(g, getattr(want, k)), f"(d) window_mesh: {k} differs")
    ticks = {k: v - ticks0[k] for k, v in shard_ticks(mesh2d.labels()).items()}
    check(list(ticks.values()) == [1.0] * MESH_SHARDS, f"(d) window_mesh shards: {ticks}")
    check(launches["window_tally"] == MESH_SHARDS
          and launches["ed25519_ladder"] == launches["ed25519_prologue"] >= MESH_SHARDS,
          f"(d) window_mesh launches {launches}")
    print(f"  (d) verify_commit_window on the {mesh2d.devices.shape} (height, val) mesh: "
          f"{wall:.2f} s, equal to the flat path's; shards {ticks}; launches {launches}",
          flush=True)
    out["commit_window"] = launches
    st0 = state_from_genesis(fs_chain.fx.genesis)
    blocks = fs_chain.blocks[:FS_WINDOW + 1]
    flat_parts, mesh_parts = [], []
    flat = bc_reactor.verify_block_window(st0, blocks, parts_out=flat_parts)
    ticks0 = shard_ticks(labels)
    reset_launches()
    planner.tally_launches["planner_tally"] = 0
    t0 = time.perf_counter()
    sharded = bc_reactor.verify_block_window(st0, blocks, parts_out=mesh_parts, mesh=mesh)
    wall = time.perf_counter() - t0
    launches = {**read_launches(), **planner.tally_launches}
    check(flat == sharded == (FS_WINDOW, None), f"(d) fast sync: {flat} vs {sharded}")
    check([p.header() for p in flat_parts] == [p.header() for p in mesh_parts],
          "(d) fast sync: the mesh window's parts differ")
    ticks = {k: v - ticks0[k] for k, v in shard_ticks(labels).items()}
    check(list(ticks.values()) == [1.0] * MESH_SHARDS, f"(d) fast sync shards: {ticks}")
    check(launches["planner_tally"] == MESH_SHARDS, f"(d) fast sync launches {launches}")
    print(f"  (d) verify_block_window(mesh) over {len(blocks)} blocks: {wall:.2f} s, "
          f"{sharded[0]} commits verified as on the flat path; shards {ticks}; launches "
          f"{launches}", flush=True)
    out["fastsync"] = launches
    check_guard_clean(before, "mesh")
    return out


def phase_mesh(dev, mul_rate: float, ed_sc: tc.SignedCommit, secp_sc: tc.SignedCommit,
               window: dict, fs_chain, err: dict) -> dict:
    """Phase 28: the multi-device lane split on a DeviceMesh of four shards
    (cuda:0 four times on one card), K5 and K6 against their plain
    versions, the verifier's mesh route and the mesh paths of the planner,
    the commit window and fast sync, on a [verify] root of its own whose
    audit samples 0.5 % of a dispatch's lanes."""
    devs = mesh_devices()
    phase(f"mesh: DeviceMesh of {[str(d) for d in devs]}: (a) K5 and (b) K6 vs plain at "
          f"N = 10,240 with the edge rows and at b = {MESH_SHARD_ROWS}, (c) both 10k commits through "
          f"TorchBatchVerifier(mesh), (d) the {WINDOW_H} x {WINDOW_V} window through "
          f"verify_windows (both reduce modes), verify_commit_window (2 x 2) and "
          f"verify_block_window over {FS_WINDOW + 1} blocks")
    t_phase = time.perf_counter()
    mesh = DeviceMesh(devs)
    mesh2d = DeviceMesh(devs, (2, 2), ("height", "val"))
    root = configure_verify(VerifyConfig(audit_sample_rate=MESH_AUDIT_RATE), device=dev)
    check(get_batch_verifier() is root.verifier, "the mesh root's verifier is not installed")
    a = mesh_k5(dev, ed_sc, mul_rate, err)
    b = mesh_k6(dev, secp_sc, mul_rate, err)
    c = mesh_verifier(dev, mesh, ed_sc, secp_sc)
    d = mesh_windows(dev, mesh, mesh2d, window, fs_chain)
    check(breaker.get_device_breaker().state == breaker.CLOSED, "mesh: the breaker is not closed")
    seconds = time.perf_counter() - t_phase
    print(f"  one card holds every shard: the split is checked here, not timed; no fallback, "
          f"breaker closed; phase {seconds:.1f} s", flush=True)
    return {"k5": a, "k6": b, "seconds": seconds,
            "launches": {"verifier_ed25519": c["ed25519"]["launches"],
                         "verifier_secp256k1": c["secp256k1"]["launches"], **d}}


HOST_CALIB_CALLS = 100  # crypto/ed25519._verify_pure on one row, ~0.7 s on a 2.x GHz core


def read_text(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return "unreadable"


def host_facts() -> dict:
    """What makes one chip machine's host faster than another's, read and
    timed without changing anything: the CPU model, the cores the process
    may run on, the cgroup's CPU quota, the load, torch's threads, and the
    seconds of a fixed pure-Python workload (HOST_CALIB_CALLS calls of the
    port's _verify_pure on one signature)."""
    info = {}
    for line in read_text("/proc/cpuinfo").splitlines():
        k, _, v = line.partition(":")
        info.setdefault(k.strip(), v.strip())
    model = (f"{info.get('model name', '?')} ({platform.machine()}; vendor "
             f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')} model "
             f"{info.get('model', '?')} stepping {info.get('stepping', '?')}; cpu MHz "
             f"{info.get('cpu MHz', '?')}; cache {info.get('cache size', '?')})")
    quota = read_text("/sys/fs/cgroup/cpu.max")
    if quota == "unreadable":  # cgroup v1
        quota = (f"{read_text('/sys/fs/cgroup/cpu/cpu.cfs_quota_us')} / "
                 f"{read_text('/sys/fs/cgroup/cpu/cpu.cfs_period_us')}")
    priv = PrivKeyEd25519.generate(b"\x07" * 32)
    msg = b"host calibration"
    sig, pub = priv.sign(msg), priv.pub_key().bytes()
    t0 = time.perf_counter()
    for _ in range(HOST_CALIB_CALLS):
        check(ed._verify_pure(pub, msg, sig), "host: the calibration signature did not verify")
    calib_s = time.perf_counter() - t0
    return {"cpu": model, "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "cpu_max": quota,
            "loadavg": [round(x, 2) for x in os.getloadavg()],
            "torch_threads": torch.get_num_threads(), "calib_s": calib_s,
            "calib_ms_a_call": calib_s / HOST_CALIB_CALLS * 1e3}


# -- phase 29: the operator smokes -------------------------------------------


def smoke_part(name: str, module, argv: list, err: dict, smi_line: str) -> dict:
    """One smoke through its command line's ``run`` on the card: green,
    K1 + K2 launched, no fallback, the breaker closed, no audit mismatch.
    The launch counts are set to 0 just before and read just after; the
    quorum smoke's first launch holds K1 and K2 against their plain
    versions."""
    before = fallbacks()
    reset_launches()
    planner.tally_launches["planner_tally"] = 0
    t0 = time.perf_counter()
    with (captured_packs() if name == "quorum" else contextlib.nullcontext([])) as packs:
        res = module.run(argv)
    wall = time.perf_counter() - t0
    launches = {**read_launches(), **planner.tally_launches}
    check(res["ok"], f"smokes ({name}): {res['failures']}")
    check(launches["ed25519_prologue"] > 0 and launches["ed25519_ladder"] > 0,
          f"smokes ({name}): no K1 + K2 launch: {launches}")
    if name == "statesync":
        check(launches["planner_tally"] >= 1,
              f"smokes (statesync): the backfill ran no K7 tally on the card: {launches}")
    check_guard_clean(before, f"smokes ({name})")
    out = {"seconds": wall, "launches": launches, "result": res}
    exact = ""
    if name == "quorum":
        check(packs, "smokes (quorum): no packed K1 + K2 inputs recorded")
        b, k1_in, k2_in = hold_k1_k2(packs[0], err, "smokes quorum")
        out["pair_ms"] = cuda_ms(lambda: ec.prologue(*k1_in)) + cuda_ms(lambda: ec.ladder(*k2_in))
        out["b"] = b
        exact = (f"; K1/K2 exact on the first launch's inputs (b = {b}), K1 + K2 "
                 f"{out['pair_ms']:.4f} ms a launch pair there")
    print(f"  ({name}) {wall:.1f} s, heights {res.get('heights')}, K1 + K2 launches "
          f"{launches['ed25519_prologue']} + {launches['ed25519_ladder']}, K7 "
          f"{launches['planner_tally']}{exact} [{smi_line}]", flush=True)
    return out


def phase_smokes(dev, storm, err: dict, smi_line: str) -> dict:
    """Phase 29: the operator smokes on the card, each through its own
    ``--device cuda`` command line on a default [verify] root of its own;
    (f) pools phase 27's vote_storm result with one mempool_flood run."""
    phase(f"smokes: statesync, flight, critpath, quorum, soak at {SMOKE_SOAK_HEIGHTS} heights "
          f"and the commit-path bench on the card, each on a default [verify] root of its own")
    t_phase = time.perf_counter()
    prev = get_batch_verifier()
    rounds = tempfile.mkdtemp(prefix="smoke_rounds_")
    parts = {}
    try:
        cuda = ["--device", str(dev)]
        parts["statesync"] = smoke_part("statesync", statesync_smoke, cuda, err, smi_line)
        parts["flight"] = smoke_part("flight", flight_smoke, cuda, err, smi_line)
        parts["critpath"] = smoke_part("critpath", critpath_smoke, cuda, err, smi_line)
        parts["quorum"] = smoke_part("quorum", quorum_smoke, cuda + ["--round-dir", rounds], err,
                                     smi_line)
        parts["soak"] = smoke_part("soak", soak_smoke, cuda + [
            "--target-height", str(SMOKE_SOAK_HEIGHTS), "--round-dir", rounds], err, smi_line)
        soak = parts["soak"]["result"]
        check(soak["marks"] == soak_smoke.marks(SMOKE_SOAK_HEIGHTS)
              and soak["marks"]["fault_at"] == 14 and soak["marks"]["crash_at"] == 28
              and soak["marks"]["spool_interval"] == 2,
              f"smokes (soak): marks {soak['marks']}")
        parts["bench"] = smoke_part("bench", bench_commit_path, cuda + [
            "--scenarios", "mempool_flood", "--round-dir", rounds], err, smi_line)
        written = sorted(os.listdir(rounds))
        check(written == ["CRITPATH_r01.json", "QUORUM_r01.json", "SOAK_r01.json"],
              f"smokes: round files {written}")
    finally:
        shutil.rmtree(rounds, ignore_errors=True)
    check(get_batch_verifier() is prev, "smokes: the phase's verifier was not put back")
    pooled = bench_commit_path.summarize([storm] + parts["bench"]["result"]["results"])
    check(pooled["commits"] >= 6, f"smokes (bench): {pooled['commits']} pooled waterfalls")
    parsed = pooled["parsed"]
    fleet = soak["parsed"]
    seconds = time.perf_counter() - t_phase
    print(f"  (f) vote_storm (phase 27) + mempool_flood: {pooled['commits']} waterfalls, commit "
          f"p50 {parsed['commit_p50_seconds'] * 1e3:.1f} ms, p99 "
          f"{parsed['commit_p99_seconds'] * 1e3:.1f} ms [{smi_line}]", flush=True)
    for line in pooled["table"].splitlines():
        print(f"    {line}", flush=True)
    print(f"  (e) soak fleet commit p50 {fleet['soak_commit_p50_seconds'] * 1e3:.1f} ms, p99 "
          f"{fleet['soak_commit_p99_seconds'] * 1e3:.1f} ms over {fleet['soak_commit_samples']} "
          f"commits [{smi_line}]", flush=True)
    # the kernels' share of each wall: its K2 launches (one K1 each) at the
    # quorum flush's launch-pair time, a small-b shape as every part's
    pair_ms = parts["quorum"]["pair_ms"]
    shares = {n: parts[n]["launches"]["ed25519_ladder"] * pair_ms / (parts[n]["seconds"] * 1e3)
              for n in SMOKE_PARTS}
    print(f"  K1 + K2 at {pair_ms:.4f} ms a pair (b = {parts['quorum']['b']}): "
          + ", ".join(f"({n}) {shares[n]:.2%}" for n in SMOKE_PARTS)
          + f" of each wall [{smi_line}]", flush=True)
    print(f"  phase {seconds:.1f} s: " + ", ".join(
        f"({n}) {parts[n]['seconds']:.1f}" for n in SMOKE_PARTS) + f" [{smi_line}]", flush=True)
    return {"seconds": seconds, "launches": {n: parts[n]["launches"] for n in SMOKE_PARTS},
            "parts": {n: {"seconds": parts[n]["seconds"],
                          "heights": parts[n]["result"].get("heights")} for n in SMOKE_PARTS},
            "bench": parsed, "soak": fleet, "pair_ms": pair_ms, "shares": shares}


# -- the host C accelerators (built at import, checked in the build phase) --


NATIVE_MODULES = {"codec": "tendermint_tpu_torch.encoding._codec_native",
                  "hash": "tendermint_tpu_torch.crypto._hash_native",
                  "wal": "tendermint_tpu_torch.consensus._wal_native"}


def load_natives() -> dict:
    """The three natives, loaded: the codec and the hasher bind at the
    port's import, the WAL scanner at its first use (here). Fails on any
    fallback, so that no phase measures the Python paths."""
    check(not os.environ.get("TM_NO_NATIVE_CODEC"),
          "TM_NO_NATIVE_CODEC is set: the run would measure the Python paths")
    check(cwal._get_native_scan() is not None, "the native WAL scanner did not load")
    check(tcodec.Writer is not tcodec._PyWriter and tcodec.Reader is not tcodec._PyReader,
          "the native codec did not load")
    check(merkle._native is not None, "the native hasher did not load")
    out = {}
    for what, name in NATIVE_MODULES.items():
        mod = tnative.modules.get(name)
        check(mod is not None, f"the native {what} is not loaded as {name}")
        out[what] = {"path": os.path.relpath(mod.__file__), "seconds": tnative.build_seconds[name]}
        check(out[what]["path"].startswith(os.path.join("build", "tendermint_tpu_torch", "native")),
              f"the native {what} was loaded from {out[what]['path']}")
    out["have_shani"] = bool(merkle._native.have_shani())
    return out


# -- phase 30: the host C accelerators on phase 22's chain ------------------------------


def native_window(dev, chain, err: dict, smi_line: str) -> dict:
    """(c): one window decoded by the native Reader, verified through
    verify_block_window on a default [verify] root of the phase's own."""
    root = configure_verify(VerifyConfig(), device=dev)
    check(get_batch_verifier() is root.verifier and root.verifier.audit_rate == 0.05,
          "native (c): the default verifier is not the root's guarded one")
    raw = [b.marshal() for b in chain.blocks[:NATIVE_WINDOW + 1]]
    st = state_from_genesis(chain.fx.genesis)
    before = fallbacks()
    audit_ok0 = audits("ok")
    t0 = time.perf_counter()
    blocks = [Block.decode(tcodec.Reader(b)) for b in raw]
    decode_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    with captured_packs() as packs:
        n_ok, bad = bc_reactor.verify_block_window(st, blocks)
    verify_s = time.perf_counter() - t0
    launches = read_launches()
    check(n_ok == NATIVE_WINDOW and bad is None,
          f"native (c): the window verified {n_ok} of {NATIVE_WINDOW} heights ({bad})")
    check(launches["ed25519_prologue"] == 1 and launches["ed25519_ladder"] == 1
          and all(v == 0 for k, v in launches.items()
                  if k not in ("ed25519_prologue", "ed25519_ladder")),
          f"native (c): launches {launches}, want one K1 and one K2")
    check_guard_clean(before, "native (c)")
    check(audits("ok") > audit_ok0, "native (c): no audited lane")
    b, _, _ = hold_k1_k2(packs[0], err, "native (c)")
    check(b == NATIVE_WINDOW * st.validators.size, f"native (c): K1/K2 ran at b = {b}")
    py_blocks = [Block.decode(tcodec._PyReader(b)) for b in raw]
    check([x.hash() for x in py_blocks] == [x.hash() for x in blocks],
          "native (c): the blocks decoded by _PyReader hash otherwise")
    want = bc_reactor.verify_block_window(st, py_blocks, verifier=TorchBatchVerifier(dev))
    check((want[0], str(want[1])) == (n_ok, str(bad)),
          f"native (c): the _PyReader window's verdict {want} differs from {(n_ok, bad)}")
    print(f"  (c) {NATIVE_WINDOW} heights x {st.validators.size} validators decoded by the "
          f"native Reader in {decode_s * 1e3:.1f} ms, verify_block_window on the phase's "
          f"default root {verify_s:.3f} s: {n_ok} heights, launches {launches}; K1/K2 exact at "
          f"b = {b}; the same verdict from the _PyReader decode; no fallback, breaker closed, "
          f"no audit mismatch [{smi_line}]", flush=True)
    return {"launches": launches, "b": b, "decode_s": decode_s, "verify_s": verify_s}


def phase_native(dev, fs: dict, bx: dict, natives: dict, err: dict, smi_line: str) -> dict:
    """Phase 30: the host C accelerators against the Python paths on phase
    22's chain, then one window of it on the card."""
    chain = fs["chain"]
    phase(f"native: the codec, the hasher and the WAL scanner on phase 22's {len(chain.blocks)} "
          f"blocks of {FS_VALS} validators, natively here and on the Python paths in a fresh "
          f"child interpreter, and one {NATIVE_WINDOW}-height window on the card")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="native_")
    walls = {}
    try:
        t0 = time.perf_counter()
        sizes = bench_native.write_inputs(tmp, chain.blocks)
        walls["inputs"] = time.perf_counter() - t0
        check(sizes["records"] >= bench_native.WAL_MIN_RECORDS,
              f"native: the WAL holds {sizes['records']} records")
        with bench_native.PythonChild(tmp) as child:
            # (c) on the card while the child imports; then the natives
            # here and the Python paths there, one after the other
            t0 = time.perf_counter()
            card = native_window(dev, chain, err, smi_line)
            walls["card"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            child.wait_ready()
            walls["child_ready"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            nat = bench_native.run(tmp)
            walls["native"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            py = child.result()
            walls["python"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(nat["path"] == "native" and py["path"] == "python",
          f"native: the paths ran {nat['path']} and {py['path']}")
    for what in nat["digest"]:
        check(nat["digest"][what] == py["digest"][what],
              f"native (a): {what} differs between the native and the Python paths: "
              f"{nat['digest'][what]} != {py['digest'][what]}")
    check(nat["counts"] == py["counts"], f"native (a): counts {nat['counts']} != {py['counts']}")
    trunc = nat["digest"]["truncated"]
    check(not trunc.endswith(" None"), f"native (a): the truncated WAL decoded whole: {trunc}")
    print(f"  (a) equal on both paths: {nat['counts']['blocks']} blocks decoded and re-encoded "
          f"({sizes['block_bytes']:,} bytes), {nat['counts']['parts']} parts rehashed, the "
          f"headers' and a {nat['counts']['validators']:,}-validator set's hashes, "
          f"{nat['counts']['records']:,} WAL records ({sizes['wal_bytes']:,} bytes); the "
          f"truncated copy: {trunc.split(' ', 1)[0]} records, then "
          f"'{trunc.split(' ', 1)[1]}' on both [{smi_line}]", flush=True)
    pairs = {w: {"native_s": nat["seconds"][w], "python_s": py["seconds"][w],
                 "factor": py["seconds"][w] / nat["seconds"][w]} for w in NATIVE_PAIRS}
    for w, p in pairs.items():
        print(f"  (b) {w}: native {p['native_s']:.6f} s, Python {p['python_s']:.6f} s, "
              f"{p['factor']:.2f}x [{smi_line}]", flush=True)
    runs = fs["runs"]
    print(f"  on the natives: phase 22's null replay {runs['null']['blocks_s']:.2f} blocks/s "
          f"(earlier {NATIVE_EARLIER['null']}), explicit {runs['explicit']['blocks_s']:.2f} "
          f"({NATIVE_EARLIER['explicit']}), serial {fs['baseline_blocks_s']:.2f} "
          f"({NATIVE_EARLIER['serial']}); phase 21's chain {bx['chain']['blocks_s']:.2f} "
          f"(earlier {NATIVE_EARLIER['block_exec']}); the earlier ranges are other machines' "
          f"[{smi_line}]", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"  the natives: " + ", ".join(
        f"{w} {natives[w]['path']} (built in {natives[w]['seconds']:.2f} s)"
        for w in NATIVE_MODULES) + f", have_shani {natives['have_shani']}; phase "
          f"{seconds:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f") [{smi_line}]", flush=True)
    return {"seconds": seconds, "pairs": pairs, "sizes": sizes, "launches": card["launches"],
            "card": card, "walls": walls}


def profiler_warmup(out: dict) -> None:
    """One empty torch.profiler session (CPU and CUDA activity). The first
    of a process initializes the profiler and CUPTI (7-20 s on the H100,
    PERF.md §5); later ones start in milliseconds. ``main`` runs it on a
    thread while nvcc builds the kernels, so that phase 25's
    unsafe_start_profiler route costs its own time only; ``out["seconds"]``
    gets its time."""
    t0 = time.perf_counter()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    prof.stop()
    out["seconds"] = time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    global T_START
    t_start = T_START = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)

    phase("device")
    smi_line = smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"  nvidia-smi: {smi_line}; torch: {torch.cuda.get_device_name(0)}; "
          f"SMs {props.multi_processor_count}; max SM clock {max_sm_mhz} MHz; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    host = host_facts()
    print(f"  host: {host['cpu']}; os.cpu_count {host['cpu_count']}, sched_getaffinity "
          f"{host['affinity']}; cgroup cpu.max {host['cpu_max']}; loadavg {host['loadavg']}; "
          f"torch threads {host['torch_threads']}; {HOST_CALIB_CALLS} calls of "
          f"crypto/ed25519._verify_pure in {host['calib_s']:.3f} s "
          f"({host['calib_ms_a_call']:.3f} ms a call)", flush=True)
    op_rate = props.multi_processor_count * max_sm_mhz * 1e6 * INT32_OPS_PER_CLK_PER_SM

    phase("build")
    warm = {}
    warm_t = threading.Thread(target=profiler_warmup, args=(warm,), name="profiler-warmup",
                              daemon=True)
    warm_t.start()
    secs = _build.build_all()
    natives = load_natives()
    warm_t.join(RESULT_TIMEOUT)
    check("seconds" in warm, "the profiler's warm-up did not end")
    print(f"  the torch profiler's first session (its initialization) in "
          f"{warm['seconds']:.1f} s, beside the build", flush=True)
    for name, s in secs.items():
        print(f"  {name}: {s:.1f} s", flush=True)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print(f"    {line.strip()}")
    for what in NATIVE_MODULES:
        print(f"  native {what}: {natives[what]['path']}, built in "
              f"{natives[what]['seconds']:.2f} s at import (0: reused) [{smi_line}]", flush=True)
    print(f"  the hasher's block function: {'SHA-NI' if natives['have_shani'] else 'portable'} "
          f"(have_shani() {natives['have_shani']})", flush=True)
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
    # and the fastsync phase
    fs = phase_fastsync(configure_verify(VerifyConfig(), device=dev), dev, err)
    # the consensus phase installs a root of its own with the vote feed on
    cons = phase_consensus(dev, err)
    # the statesync phase sets its path up through a default [verify] root of its own
    ssync = phase_statesync(configure_verify(VerifyConfig(), device=dev), dev, err)
    # the localnet phase installs a root of its own with the vote feed on
    localnet = phase_localnet(dev, err)
    # the cli phase: node processes of their own, each with its own root
    cli = phase_cli(dev, err)
    # the sim phase: SimNets on a default [verify] root of its own
    simr = phase_sim(dev, err)
    # the mesh phase: a [verify] root of its own, four shards
    mesh = phase_mesh(dev, mul_rate, ed_main["commit"], secp_main["commit"], window,
                      fs["chain"], err)
    # the smokes phase: each smoke on a default [verify] root of its own
    configure_verify(VerifyConfig(), device=dev)
    smokes = phase_smokes(dev, simr["b"]["result"], err, smi_line)
    # the native phase: phase 22's chain, a default [verify] root of its own
    nat = phase_native(dev, fs, bx, natives, err, smi_line)
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
            "fastsync_launches": {what: n[name] for what, n in fs["launches"].items()},
            "consensus_launches": {
                run: (split if name in ("ed25519_prologue", "ed25519_ladder")
                      else {"flushes": 0, "last_commit": 0})
                for run, split in cons["launches"].items()},
            "statesync_launches": {part: n[name] for part, n in ssync["launches"].items()},
            "localnet_launches": (localnet["launches"]
                                  if name in ("ed25519_prologue", "ed25519_ladder")
                                  else {"flushes": 0, "last_commit": 0,
                                        "join": {s: 0 for s in LN_JOIN_SOURCES},
                                        "rpc": {s: 0 for s in LN_RPC_SOURCES}}),
            # the cli phase's processes: each node's device-backend verify
            # calls (one K1 and one K2 launch each) and the lite process's
            # frontend dispatches, read over their RPC
            "cli_launches": ({"verify_calls": cli["calls"],
                              "lite_dispatches": cli["lite_dispatches"]}
                             if name in ("ed25519_prologue", "ed25519_ladder")
                             else {"verify_calls": {k: 0 for k in cli["calls"]},
                                   "lite_dispatches": 0}),
            # the sim phase's nets: (a) the card's LastCommit checks, (b)
            # vote_storm's flushes and LastCommit checks, (c) the fault run's
            # answered calls
            "sim_launches": {part: n[name] for part, n in simr["launches"].items()},
            "msm_launches": msm["launches"][name],
            "commit_window_launches": {"ladder": cwin["launches"][name],
                                       "msm": cwin["msm_launches"][name],
                                       "planner_msm": cwin["planner_msm_launches"][name]},
            "mesh_launches": {part: n[name] for part, n in mesh["launches"].items()},
            "smoke_launches": {part: n[name] for part, n in smokes["launches"].items()},
            "native_launches": nat["launches"][name],
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
        "sub_ms": {"levels": k4c["parts"]["levels_ms"], "tree": k4c["parts"]["tree_ms"],
                   "fold": k4c["parts"]["fold_ms"], "finish": k4c["parts"]["finish_ms"]},
        # the reference's schedule (msm_ref) on the same inputs
        "ref_ms": k4c["ref_ms"],
        "adversarial_ms": k4["adversarial"]["ms"],
        # the 512 x 64 window's schedule (the commit window's msm route)
        "window_ms": k4["window"]["ms"],
        "window_plain_ms": k4["window"]["plain_ms"],
        "window_bound_ms": k4["window"]["bound"][0],
        "window_sub_ms": {"levels": k4["window"]["parts"]["levels_ms"],
                          "tree": k4["window"]["parts"]["tree_ms"],
                          "fold": k4["window"]["parts"]["fold_ms"],
                          "finish": k4["window"]["parts"]["finish_ms"]},
        "lite_launches": {shape: lite[shape]["launches"][K4] for shape in ("a", "b")},
        "votes_launches": {route: votes[route]["launches"][K4] for route in votes},
        "txs_launches": txs["launches"][K4],
        "mempool_launches": {what: n[K4] for what, n in mempool["launches"].items()},
        "block_exec_launches": {what: n[K4] for what, n in bx["launches"].items()},
        "fastsync_launches": {what: n[K4] for what, n in fs["launches"].items()},
        "consensus_launches": {run: {"flushes": 0, "last_commit": 0}
                               for run in cons["launches"]},
        "statesync_launches": {part: n[K4] for part, n in ssync["launches"].items()},
        "localnet_launches": {"flushes": 0, "last_commit": 0,
                              "join": {s: 0 for s in LN_JOIN_SOURCES},
                              "rpc": {s: 0 for s in LN_RPC_SOURCES}},
        "cli_launches": {"verify_calls": {k: 0 for k in cli["calls"]}, "lite_dispatches": 0},
        "sim_launches": {part: n[K4] for part, n in simr["launches"].items()},
        "msm_launches": {"commit": msm["launches"][K4],
                         "adversarial": msm["adversarial_launches"][K4],
                         "dirty_commit": msm["dirty_launches"][K4],
                         "guarded": msm["guarded_launches"][K4]},
        "commit_window_launches": {"ladder": cwin["launches"][K4],
                                   "msm": cwin["msm_launches"][K4],
                                   "planner_msm": cwin["planner_msm_launches"][K4]},
        "mesh_launches": {part: n[K4] for part, n in mesh["launches"].items()},
        "smoke_launches": {part: n[K4] for part, n in smokes["launches"].items()},
        "native_launches": nat["launches"][K4],
    })
    # K5 and K6: the verifier's mesh route (phase 28) is their main path
    for name, replaces, res, part in (
            ("ed25519_verify", K5_REPLACES, mesh["k5"], "verifier_ed25519"),
            ("secp256k1_verify", K6_REPLACES, mesh["k6"], "verifier_secp256k1")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tendermint_tpu_torch/ops/csrc/{_build.SOURCES[name]}",
            "replaces": replaces,
            "launches": mesh["launches"][part][name],
            "max_abs_err": err[name],
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound"][0],
            "bound_by": res["bound"][1],
            "library_ms": None,  # no single PyTorch call computes this function
            "b": res["b"],
            # the bound above counts the windowed design's own products;
            # this one the reference's bit-serial products on these rows
            "products": res["products"],
            "reference_bound_ms": res["reference_bound"][0],
            "reference_products": res["reference_products"],
            "shard_ms": {b: v["ms"] for b, v in res["shards"].items()},
            "shard_bound_ms": {b: v["bound"][0] for b, v in res["shards"].items()},
            "shard_reference_bound_ms": {b: v["reference_bound"][0]
                                         for b, v in res["shards"].items()},
            "resources": res["resources"],
            "mesh_launches": {p: n[name] for p, n in mesh["launches"].items()},
            "smoke_launches": {p: n[name] for p, n in smokes["launches"].items()},
            "native_launches": nat["launches"][name],
        })
    print(f"  {N_VALIDATORS}-validator ed25519 verify_commit p50: {ed_main['p50_ms']:.3f} ms "
          f"through TorchBatchVerifier, {default['p50_ms']:.1f} ms through the default "
          f"guarded verifier (audit {default['verify.audit']:.1f} ms of it)", flush=True)
    print(f"  {N_VALIDATORS}-validator ed25519 verify_commit p50 on the msm path: "
          f"{msm['p50_ms']:.1f} ms (K4 {k4c['ms']:.4f} ms of it); the {WINDOW_H} x {WINDOW_V} "
          f"commit window {cwin['ladder_p50_s']:.3f} s on the ladder (K8), its first "
          f"{MSM_WINDOW_H} heights {cwin['msm_s']:.2f} s on the msm path", flush=True)
    print(f"  block_exec: the {BX_VALS}-validator chain at {bx['chain']['blocks_s']:.2f} "
          f"blocks/s (apply_block p50 {bx['chain']['apply_p50_ms']:.1f} ms); the "
          f"{N_VALIDATORS}-validator LastCommit's apply_block p50 {bx['10k']['p50_ms']:.1f} ms "
          f"(validate {bx['10k']['parts_ms']['state.validate']:.1f} ms of it)", flush=True)
    runs = fs["runs"]
    print(f"  fastsync: the {FS_BLOCKS}-block replay at window {FS_WINDOW} "
          f"{runs['guarded']['blocks_s']:.2f} blocks/s guarded, "
          f"{runs['explicit']['blocks_s']:.2f} explicit, {runs['null']['blocks_s']:.2f} null, "
          f"the serial baseline {fs['baseline_blocks_s']:.2f}; the reactor "
          f"{fs['reactor']['blocks_s']:.2f} blocks/s over {FS_REACTOR_BLOCKS - 1}; phase "
          f"{fs['seconds']:.1f} s", flush=True)
    crit = {}
    for phase_name in cons["a"]["instruments"]["critical"]:
        crit[phase_name] = crit.get(phase_name, 0) + 1
    print(f"  consensus: {CS_VALS} validators, {cons['a']['blocks_s']:.2f} blocks/s through "
          f"the vote feed (a height's p50 {cons['a']['p50_ms']:.1f} ms; critical phases "
          f"{crit}), {cons['b']['blocks_s']:.2f} serially; the handshake's block {CS_HEIGHTS} in "
          f"{cons['c']['wall_ms']:.1f} ms; phase {cons['seconds']:.1f} s", flush=True)
    print(f"  statesync: the restore of {ssync['chunks']} chunks ({ssync['chunk_bytes']:,} "
          f"bytes) in {ssync['restore_s']:.3f} s, the hand-off in "
          f"{ssync['handoff_s'] * 1e3:.1f} ms; K7 {ssync['launches']['backfill']['planner_tally']} "
          f"on the backfill; phase {ssync['seconds']:.1f} s", flush=True)
    print(f"  localnet: {LN_VALS} nodes over TCP on the {localnet['sts_backend']} STS backend, "
          f"{localnet['blocks_s']:.3f} blocks/s (a height's p50 {localnet['p50_ms']:.1f} ms), "
          f"a handshake {localnet['handshake_s']:.4f} s; the join by a seed had the "
          f"{LN_VALS} validators as peers {localnet['join']['peers_s']:.3f} s after its start, "
          f"restored "
          f"{localnet['join']['snapshot']} in {localnet['join']['restore_s']:.3f} s, "
          f"fast-synced {localnet['join']['synced']} block(s) and was at the tip "
          f"{localnet['join']['tip_s']:.3f} s after its start; the ?verify=1 burst "
          f"{localnet['rpc']['burst']['wall_s'] * 1e3:.1f} ms ({localnet['rpc']['burst']['answers']} "
          f"answers, {localnet['rpc']['burst']['dispatches']} dispatches), broadcast_tx_commit p50 "
          f"{localnet['rpc']['commit_p50_ms']:.1f} ms, the lite client "
          f"{localnet['rpc']['lite']['seconds'] * 1e3:.1f} ms for {localnet['rpc']['lite']['heights']} "
          f"heights; validator {LN_SIGNER}'s remote signer {localnet['signer']['round_trips']} "
          f"round trips, p50 {localnet['signer']['p50_ms']:.2f} ms, max "
          f"{localnet['signer']['max_ms']:.2f} ms; phase {localnet['seconds']:.1f} s",
          flush=True)
    print(f"  cli: {CLI_VALS} node processes and a lite process on the card, "
          f"{cli['blocks_s']:.3f} blocks/s (a height's p50 {cli['p50_ms']:.1f} ms), spawn to "
          f"the first answer {max(cli['first_answer_s'].values()):.2f} s at most, the lite "
          f"process {cli['lite_s'] * 1e3:.1f} ms for {cli['lite_heights']} heights, the restart "
          f"{cli['restart_s']:.2f} s to the tip, tm_bench {cli['bench']['txs_per_sec']['avg']} "
          f"tx/s; phase {cli['seconds']:.1f} s", flush=True)
    print(f"  sim: (a) {simr['a']['seconds']:.1f} s for the card's and the host's "
          f"baseline_determinism one after the other (equal hashes over 1..{simr['a']['top']}), (b) "
          f"vote_storm {simr['b']['seconds']:.1f} s ({simr['b']['dispatches']} flushes on the "
          f"card), (c) the card fault {simr['c']['seconds']:.1f} s (halts {simr['c']['faults']}); "
          f"phase {simr['seconds']:.1f} s", flush=True)
    print(f"  mesh: K5 {mesh['k5']['ms']:.4f} ms and K6 {mesh['k6']['ms']:.4f} ms at N = "
          f"{mesh['k5']['b']}, "
          + ", ".join(f"{mesh['k5']['shards'][b]['ms']:.4f} and {mesh['k6']['shards'][b]['ms']:.4f}"
                      f" at b = {b}" for b in MESH_SHARD_ROWS)
          + "; four shards on the planner (both reduce modes), the commit "
          f"window, fast sync and the verifier, each equal to its flat path; phase "
          f"{mesh['seconds']:.1f} s", flush=True)
    print(f"  smokes: " + ", ".join(
        f"{n} {smokes['parts'][n]['seconds']:.1f} s" for n in SMOKE_PARTS)
          + f"; the commit path's p50 {smokes['bench']['commit_p50_seconds'] * 1e3:.1f} ms, p99 "
          f"{smokes['bench']['commit_p99_seconds'] * 1e3:.1f} ms; the soak's fleet p99 "
          f"{smokes['soak']['soak_commit_p99_seconds'] * 1e3:.1f} ms; phase "
          f"{smokes['seconds']:.1f} s [{smi_line}]", flush=True)
    print(f"  native: " + ", ".join(f"{w} {p['factor']:.2f}x" for w, p in nat["pairs"].items())
          + f" (Python seconds over native); (c) K1 + K2 {nat['launches']['ed25519_prologue']} + "
          f"{nat['launches']['ed25519_ladder']}; phase {nat['seconds']:.1f} s [{smi_line}]",
          flush=True)
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
