"""Fast-sync replay on the port (BASELINE.json config 3, "blockchain/
fast-sync replay of 50k-block chain, batched multi-height commit verify"):
the port's counterpart of the replay in ``scripts/bench_fastsync.py``.

    python3 -m tendermint_tpu_torch.tools.bench_fastsync [n_blocks] [n_vals] [window]
    python3 -m tendermint_tpu_torch.tools.bench_fastsync [n_blocks] [n_vals] --sweep
    ... --null-verify      # a free all-true verifier: the host pipeline's ceiling
    ... --device=cpu       # the kernels' plain versions (default: the card)

Builds a signed chain (``testutil/chain.build_chain``, ``KVStoreApp``, power
10 a validator; set-up, not timed), then measures blocks a second:

  * the baseline: per height ``verify_commit`` + ``apply_block`` over
    ``BASELINE_SAMPLE_BLOCKS`` blocks, on the same verifier as the replay;
  * the replay: ``blockchain/reactor.verify_block_window`` over windows of
    ``window`` heights (every (height, validator) signature of a window in
    one dispatch), then ``apply_block(trusted_last_commit=True)`` for each
    verified block.

The verifier is the configuration root's (``node/verify_root.configure_verify``
at the default ``[verify]``: ``GuardedBatchVerifier(TorchBatchVerifier)``,
K1 + K2 once a window), ``HostBatchVerifier`` with
``TM_BATCH_VERIFIER=host``, or ``NullVerifier`` with ``--null-verify``.
Prints one JSON line, ``{"metric": "fastsync_replay_{N}x{V}", "value":
blocks/s, "unit": "blocks/s", "vs_baseline": ..., "verifier": ...}``, or
with ``--sweep`` one line a window size. ``chip_smoke.py`` calls
``build``, ``replay`` and ``baseline``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.blockchain.reactor import auto_verify_window, verify_block_window
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto.batch import HostBatchVerifier, TorchBatchVerifier
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.node.verify_root import configure_verify
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state_types import State, state_from_genesis
from tendermint_tpu_torch.testutil.chain import ChainFixture, build_chain
from tendermint_tpu_torch.types.core import BlockID

N_BLOCKS, N_VALS, WINDOW = 2048, 64, 512
SWEEP_WINDOWS = [16, 64, 128, 256, 512, 1024]
BASELINE_SAMPLE_BLOCKS = 64  # serial blocks to time (extrapolated)
CHAIN_ID = "bench-sync"


class NullVerifier:
    """All-true, zero-cost: isolates the host pipeline's ceiling."""

    name = "null"

    def verify_ed25519(self, items):
        return np.ones((len(items),), dtype=bool)

    verify_secp256k1 = verify_ed25519

    def verify_ed25519_raw(self, pubs, msgs, sigs):
        # the column form, the fast path the production verifiers take
        return np.ones((len(pubs),), dtype=bool)


@dataclass
class Chain:
    fx: ChainFixture
    blocks: List  # heights 1..n, as a syncing node receives them
    states: Dict[int, State] = field(default_factory=dict)  # the kept heights
    build_s: float = 0.0


def build(n_blocks: int = N_BLOCKS, n_vals: int = N_VALS, verifier=None,
          keep: Sequence[int] = (), chain_id: str = CHAIN_ID) -> Chain:
    """The signed chain: ``n_vals`` validators, ``n_blocks`` empty blocks,
    each applied with its LastCommit verified by ``verifier`` (None: the
    installed one). ``states[h]`` is the state after height h for each h of
    ``keep``."""
    states: Dict[int, State] = {}

    def on_height(h, st):
        if h - 1 in keep:
            states[h - 1] = st
        return []

    t0 = time.perf_counter()
    fx = build_chain(n_vals=n_vals, n_heights=n_blocks, chain_id=chain_id, on_height=on_height,
                     verifier=verifier, check_votes=False)
    if n_blocks in keep:
        states[n_blocks] = fx.state
    build_s = time.perf_counter() - t0
    blocks = [fx.block_store.load_block(h) for h in range(1, n_blocks + 1)]
    return Chain(fx, blocks, states, build_s)


def fresh_executor(genesis):
    """A genesis state saved in a fresh state DB, and an executor over a
    fresh ``KVStoreApp``."""
    st = state_from_genesis(genesis)
    db = MemDB()
    sm_store.save_state(db, st)
    conn = MultiAppConn(LocalClientCreator(KVStoreApp()))
    conn.start()
    return st, BlockExecutor(db, conn.consensus)


def baseline(chain: Chain, verifier=None, sample: int = BASELINE_SAMPLE_BLOCKS) -> float:
    """Blocks a second of the reference's serial shape: one
    ``verify_commit`` a height, then ``apply_block`` with the commit
    trusted, over the first ``sample`` blocks."""
    blocks = chain.blocks
    st, ex = fresh_executor(chain.fx.genesis)
    sample = min(sample, len(blocks) - 1)
    t0 = time.perf_counter()
    for i in range(sample):
        block, next_block = blocks[i], blocks[i + 1]
        parts = block.make_part_set()
        block_id = BlockID(hash=block.hash(), parts_header=parts.header())
        st.validators.verify_commit(chain.fx.chain_id, block_id, block.height,
                                    next_block.last_commit, verifier=verifier)
        st = ex.apply_block(st, block_id, block, trusted_last_commit=True)
    return sample / (time.perf_counter() - t0)


@dataclass
class Replay:
    blocks_s: float
    state: State
    windows: List[int]  # heights verified by each window
    seconds: float


def replay(chain: Chain, verifier=None, window: int = WINDOW) -> Replay:
    """The windowed verify -> apply pipeline from genesis over the whole
    chain (the tip's commit is in no block: n - 1 blocks apply). Each window
    is traced as ``fastsync.window``, its applies as ``fastsync.apply``."""
    blocks = chain.blocks
    st, ex = fresh_executor(chain.fx.genesis)
    windows: List[int] = []
    t0 = time.perf_counter()
    pos = 0
    while pos < len(blocks) - 1:
        win = blocks[pos: pos + window + 1]
        parts_list: list = []
        with trace.span("fastsync.window", h0=win[0].height, n=len(win) - 1, mode="replay"):
            n_ok, err = verify_block_window(st, win, verifier=verifier, parts_out=parts_list)
        if err is not None or n_ok == 0:
            raise RuntimeError(f"verification failed at height {win[0].height}: {err}")
        with trace.span("fastsync.apply", h0=win[0].height, n=n_ok):
            for i in range(n_ok):
                block = win[i]
                block_id = BlockID(hash=block.hash(), parts_header=parts_list[i].header())
                st = ex.apply_block(st, block_id, block, trusted_last_commit=True)
        windows.append(n_ok)
        pos += n_ok
    seconds = time.perf_counter() - t0
    return Replay(pos / seconds, st, windows, seconds)


def _verifier(null: bool, device: Optional[str]):
    """(verifier for the replay, its name): the free one, the host oracle
    with TM_BATCH_VERIFIER=host, else None after installing the
    configuration root (its guarded verifier)."""
    if null:
        return NullVerifier(), "null"
    if os.environ.get("TM_BATCH_VERIFIER", "").lower() == "host":
        return HostBatchVerifier(), "host"
    root = configure_verify(VerifyConfig(), device=device)
    return None, root.verifier.name


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if not a.startswith("--")]
    n_blocks = int(pos[0]) if len(pos) > 0 else N_BLOCKS
    n_vals = int(pos[1]) if len(pos) > 1 else N_VALS
    window = int(pos[2]) if len(pos) > 2 else WINDOW
    sweep = "--sweep" in argv
    null = "--null-verify" in argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), None)
    if n_blocks < 2:
        raise SystemExit("need at least 2 blocks (commit N lives in block N+1)")

    verifier, name = _verifier(null, device)
    chain = build(n_blocks, n_vals, verifier=TorchBatchVerifier(device))
    print(f"# chain: {n_blocks} blocks x {n_vals} validators (built in {chain.build_s:.1f} s)",
          file=sys.stderr)
    base_rate = baseline(chain, verifier)
    print(f"# baseline (serial {name} verify): {base_rate:.0f} blocks/s", file=sys.stderr)
    # warm the verify path on the first window from a fresh genesis state
    verify_block_window(state_from_genesis(chain.fx.genesis),
                        chain.blocks[: min(window, len(chain.blocks))], verifier=verifier)
    tag = "_null" if null else ""
    if sweep:
        auto_w = auto_verify_window(n_vals)
        for w in sorted(set(SWEEP_WINDOWS + [auto_w])):
            if w >= n_blocks:
                continue
            rate = replay(chain, verifier, w).blocks_s
            print(json.dumps({
                "metric": f"fastsync_replay{tag}_{n_blocks}x{n_vals}_w{w}",
                "value": round(rate, 1), "unit": "blocks/s",
                "vs_baseline": round(rate / base_rate, 2), "auto_window": auto_w,
            }), flush=True)
        return 0
    rate = replay(chain, verifier, window).blocks_s
    print(json.dumps({
        "metric": f"fastsync_replay{tag}_{n_blocks}x{n_vals}",
        "value": round(rate, 1), "unit": "blocks/s",
        "vs_baseline": round(rate / base_rate, 2), "verifier": name,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
