"""WAL file replay for debugging: the ``replay`` and ``replay_console``
commands (ref consensus/replay_file.go:33 RunReplayFile, :42 ReplayFile;
the port's copy of the reference package's ``consensus/replay_file.py``).

Builds a ``ConsensusState`` from the home directory's stores and feeds the
WAL's messages back through the real handlers. A proposal block of the
state's next height goes through ``validate_block``: its LastCommit through
the installed verifier, on the card the configuration root's guarded one
(K1 + K2, K3). Console mode steps interactively (next / next N / locate /
quit), the reference's replay_console.
"""

from __future__ import annotations

import sys

from tendermint_tpu_torch.consensus.messages import (
    EndHeightMessage,
    EventRoundStep,
    MsgInfo,
    TimeoutInfo,
)
from tendermint_tpu_torch.consensus.replay import replay_one_message
from tendermint_tpu_torch.consensus.wal import WAL
from tendermint_tpu_torch.device import DeviceLike


def run_replay_file(config, console: bool = False, *, device: DeviceLike = None) -> int:
    """Build a replay-mode ConsensusState from ``config``'s home directory
    and walk its WAL (consensus/replay_file.go RunReplayFile). The
    process's ``[verify]`` root is configured on ``device`` first (``None``:
    the card, and without one ``NoCudaDeviceError``)."""
    import os

    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.consensus.state import ConsensusState
    from tendermint_tpu_torch.libs.db.kv import new_db
    from tendermint_tpu_torch.mempool.mempool import Mempool
    from tendermint_tpu_torch.node import verify_root
    from tendermint_tpu_torch.proxy.app_conn import MultiAppConn, default_client_creator
    from tendermint_tpu_torch.state import store as sm_store
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.services import MockEvidencePool
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    verify_root.configure_verify(config.verify, device)
    verify_root.host_verify_from_env(device)
    root = config.base.root_dir

    def _db(name):
        return new_db(name, config.base.db_backend, config.base.db_path())

    state_db = _db("state")
    block_store = BlockStore(_db("blockstore"))
    genesis = GenesisDoc.from_file(config.base.genesis_path())
    state = sm_store.load_state_from_db_or_genesis(state_db, genesis)

    proxy = MultiAppConn(default_client_creator(config.base.proxy_app, config.base.proxy_app))
    proxy.start()
    mempool = Mempool(proxy.mempool)
    block_exec = BlockExecutor(state_db, proxy.consensus, mempool)

    cs = ConsensusState(config.consensus, state.copy(), block_exec, block_store, mempool,
                        MockEvidencePool())
    cs.replay_mode = True
    cs.update_to_state(state)
    return replay_file(cs, os.path.join(root, config.consensus.wal_path), console=console)


def replay_file(cs, wal_path: str, console: bool = False) -> int:
    """Feed every WAL record through the consensus handlers
    (replay_file.go:42). Returns the number of messages replayed."""
    wal = WAL(wal_path)
    n = 0
    budget = 0  # console: messages to run before prompting again
    for tm in wal.iter_all():
        if isinstance(tm.msg, EndHeightMessage):
            print(f"#ENDHEIGHT {tm.msg.height}")
            continue
        if console and budget <= 0:
            budget = _prompt(cs)
            if budget < 0:
                return n
        _describe(tm.msg)
        try:
            replay_one_message(cs, tm)
        except Exception as e:
            print(f"!! replay error at message {n}: {e}", file=sys.stderr)
            raise
        n += 1
        budget -= 1
    print(f"replayed {n} WAL messages; final: "
          f"h={cs.rs.height} r={cs.rs.round} step={cs.rs.step.name}")
    return n


def _describe(rec) -> None:
    if isinstance(rec, MsgInfo):
        src = rec.peer_id or "self"
        print(f"  msg[{type(rec.msg).__name__}] from {src}")
    elif isinstance(rec, TimeoutInfo):
        print(f"  timeout h={rec.height} r={rec.round} step={rec.step}")
    elif isinstance(rec, EventRoundStep):
        print(f"  step h={rec.height} r={rec.round} step={rec.step}")


def _prompt(cs) -> int:
    """The interactive console (replay_file.go:103-170): next [N] / locate /
    quit. Returns how many messages to replay (-1 = quit)."""
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            return -1
        if line in ("q", "quit"):
            return -1
        if line in ("", "n", "next"):
            return 1
        if line.startswith(("n ", "next ")):
            try:
                return int(line.split()[1])
            except ValueError:
                print("usage: next [N]")
                continue
        if line in ("l", "locate", "status"):
            print(f"h={cs.rs.height} r={cs.rs.round} step={cs.rs.step.name} "
                  f"locked_round={cs.rs.locked_round}")
            continue
        print("commands: next [N], locate, quit")
