"""A localnet of ``node/node.Node``s started from home directories.

``make_node_net(n, base_dir)`` writes ``n`` home directories under
``base_dir`` (``node<i>/``, each with ``config/genesis.json`` — one genesis,
``testutil/consensus.make_genesis``'s: n validators of power 10 —,
``config/priv_validator.json``, a ``FilePV`` of the i-th validator of the
sorted set, ``config/node_key.json`` and ``data/``), then builds a ``Node``
in each with ``Node.from_home``. Each node's ``[p2p]`` listens on
127.0.0.1 port 0 with the peer exchange off and duplicate IPs allowed, as a
local testnet sets it, and dials the others as persistent peers; its RPC
server listens on 127.0.0.1 port 0 (``node.rpc_server.bound_port`` once
started). The validators start consensus at once (``fast_sync`` off), as
``testutil/consensus_net.make_consensus_net``'s do. ``add_joining_node``
writes one more home, a non-validator with an empty store that restores by
state sync when its ``[statesync]`` section enables it (then fast-syncs and
switches to consensus), and dials every node of the net.

Each node's ``checks`` lists the heights whose LastCommit its executor
checked (one verify a check), as ``consensus_net``'s nodes do.
``testutil/consensus_net.py`` stays for the CPU tests that build a net by
hand.

With ``pex_period`` the nodes run the peer exchange (``[p2p] pex`` on, the
address book not strict, as a local testnet sets it) and each PEX reactor
sweeps every ``pex_period`` seconds (the reference's 30 s would hold a
test for a sweep); ``add_joining_node(..., seed_only=True)`` then knows
node 0 as its seed and no persistent peer, and finds the others by PEX.
``remote_signers`` lists validators whose key sits behind a remote signer
(``RemoteSigner``: a ``SignerServiceEndpoint`` over TCP that dials the
node's ``priv_validator_laddr``).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import socket
import threading
import time
from typing import Callable, List, Optional

from tendermint_tpu_torch.config.config import Config, default_config
from tendermint_tpu_torch.config.p2p import P2PConfig
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.node.node import Node, init_home
from tendermint_tpu_torch.proxy.app_conn import ClientCreator
from tendermint_tpu_torch.testutil.consensus import make_genesis
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.vote import Vote

# the [p2p] section of a local testnet: the defaults with the peer exchange
# off and duplicate IPs allowed, on 127.0.0.1 port 0
LOCAL_P2P = P2PConfig(laddr="tcp://127.0.0.1:0", pex=False, allow_duplicate_ip=True)
LOCAL_RPC = "tcp://127.0.0.1:0"


def node_config(base: Optional[Config], moniker: str, pex: bool = False) -> Config:
    """A node's configuration: a copy of ``base`` (default
    ``default_config()``) with the local testnet's ``[p2p]`` and RPC
    addresses, ``moniker``, the ``unsafe`` routes and the Prometheus
    metrics on; with ``pex``, the peer exchange on over a book that takes
    local addresses."""
    cfg = copy.deepcopy(base) if base is not None else default_config()
    cfg.base.moniker = moniker
    cfg.p2p = dataclasses.replace(LOCAL_P2P)
    if pex:
        cfg.p2p.pex, cfg.p2p.addr_book_strict = True, False
    cfg.rpc.laddr = LOCAL_RPC
    cfg.rpc.unsafe = True
    cfg.instrumentation.prometheus = True
    return cfg


def _track_checks(node: Node) -> None:
    node.checks = []
    real = node.block_exec.validate_block

    def validate_block(state, block, trusted_last_commit=False):
        if block.height > 1 and not trusted_last_commit:
            node.checks.append(block.height)
        return real(state, block, trusted_last_commit=trusted_last_commit)

    node.block_exec.validate_block = validate_block


def free_port() -> int:
    """A TCP port of 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


class RemoteSigner:
    """A validator's key behind a remote signer: a ``FilePV`` of ``priv``
    at ``path`` served by a ``SignerServiceEndpoint`` that dials ``laddr``
    (the node's ``priv_validator_laddr``) over TCP and a secret connection,
    from a thread of its own that retries until the node listens (a
    ``Node`` blocks in its build until the signer dials). ``requests``
    counts the requests served; ``stop()`` ends it."""

    def __init__(self, priv, path: str, laddr: str, timeout: float = 30.0):
        from tendermint_tpu_torch.privval.file_pv import FilePV
        from tendermint_tpu_torch.privval.remote_signer import SignerServiceEndpoint

        self.laddr = laddr
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.pv = FilePV(priv, path)
        self.pv.save()
        self.endpoint = SignerServiceEndpoint(laddr, self.pv)
        self.requests = 0
        real = self.endpoint._handle

        def handle(data: bytes) -> bytes:
            self.requests += 1
            return real(data)

        self.endpoint._handle = handle
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._dial, args=(timeout,),
                                        name="remote-signer-dial", daemon=True)
        self._thread.start()

    def _dial(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.endpoint.start()
                return
            except OSError as e:
                if time.monotonic() >= deadline:
                    self.error = e
                    return
                time.sleep(0.02)

    def stop(self) -> None:
        self._thread.join(5.0)
        if self.endpoint.is_running:
            self.endpoint.stop()


def _listen(node: Node) -> str:
    """Bind the node's switch (port 0 takes a free port); the address its
    peers dial."""
    return str(verify_root.listen(node.switch, node.config.p2p))


def _pex(node: Node, pex_period: Optional[float]) -> None:
    if pex_period is not None:
        node.pex_reactor.ensure_period = pex_period


def make_node_net(n_vals: int, base_dir: str, config: Optional[Config] = None,
                  client_creator: Optional[Callable[[int], ClientCreator]] = None, *,
                  device="cpu", start: bool = True, pex_period: Optional[float] = None,
                  remote_signers=()) -> List[Node]:
    """``n_vals`` validator nodes over one genesis from home directories
    under ``base_dir``, each at ``node_config(config, "node<i>")`` with fast
    sync off and ``client_creator(i)``'s app (default the config's
    ``proxy_app``), every one listening and holding the others as
    persistent peers; started unless ``start`` is False (then
    ``start_node_net``). With ``pex_period`` the peer exchange is on and
    sweeps every ``pex_period`` seconds. Each validator of
    ``remote_signers`` signs through a ``RemoteSigner`` (its node's
    ``remote_signer``; ``stop_node_net`` stops it) dialing a free port of
    its ``priv_validator_laddr``."""
    doc, pvs = make_genesis(n_vals)
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    from tendermint_tpu_torch.state.state_types import state_from_genesis

    sorted_pvs = [by_addr[v.address] for v in state_from_genesis(doc).validators.validators]
    nodes: List[Node] = []
    try:
        for i in range(n_vals):
            home = os.path.join(base_dir, f"node{i}")
            init_home(home, doc, priv_key=sorted_pvs[i]._priv)
            cfg = node_config(config, f"node{i}", pex=pex_period is not None)
            cfg.base.fast_sync = False
            signer = None
            if i in remote_signers:
                cfg.base.priv_validator_laddr = f"tcp://127.0.0.1:{free_port()}"
                signer = RemoteSigner(sorted_pvs[i]._priv,
                                      os.path.join(base_dir, f"signer{i}", "priv_validator.json"),
                                      cfg.base.priv_validator_laddr)
            try:
                node = Node.from_home(home, cfg, client_creator(i) if client_creator else None,
                                      device=device)
            except BaseException:
                if signer is not None:
                    signer.stop()
                raise
            node.remote_signer = signer
            _pex(node, pex_period)
            _track_checks(node)
            nodes.append(node)
        addrs = [_listen(n) for n in nodes]
        for i, node in enumerate(nodes):
            node.config.p2p.persistent_peers = ",".join(
                a for j, a in enumerate(addrs) if j != i)
    except BaseException:
        stop_node_net(nodes)
        raise
    if start:
        start_node_net(nodes)
    return nodes


def start_node_net(nodes: List[Node]) -> None:
    for node in nodes:
        node.start()


def add_joining_node(nodes: List[Node], base_dir: str, config: Optional[Config] = None,
                     client_creator: Optional[ClientCreator] = None, *,
                     statesync: Optional[StateSyncConfig] = None, device="cpu",
                     start: bool = True, pex_period: Optional[float] = None,
                     seed_only: bool = False) -> Node:
    """One more node for the running net ``nodes``: a non-validator home
    (its own key, the net's genesis) under ``base_dir``, at
    ``node_config(config, "node<n>")`` with fast sync on and the
    ``[statesync]`` section ``statesync`` (default off: it fast-syncs from
    genesis), dialing every node of ``nodes`` as a persistent peer (they do
    not dial it); with ``seed_only`` it knows node 0 as its seed and no
    persistent peer, and finds the rest by the peer exchange (which
    ``pex_period`` turns on, as ``make_node_net``'s). Started unless
    ``start`` is False."""
    i = len(nodes)
    home = os.path.join(base_dir, f"node{i}")
    init_home(home, nodes[0].genesis_doc)
    cfg = node_config(config, f"node{i}", pex=pex_period is not None)
    cfg.base.fast_sync = True
    cfg.statesync = statesync if statesync is not None else StateSyncConfig()
    if seed_only:
        cfg.p2p.seeds = str(nodes[0].switch.transport.listen_address)
    node = Node.from_home(home, cfg, client_creator, device=device)
    try:
        _pex(node, pex_period)
        _track_checks(node)
        _listen(node)
        if not seed_only:
            cfg.p2p.persistent_peers = ",".join(
                str(n.switch.transport.listen_address) for n in nodes)
    except BaseException:
        stop_node_net([node])
        raise
    if start:
        node.start()
    return node


def stop_node_net(nodes: List[Node]) -> None:
    """Stop every started node (and release a built one's stores and
    ``[verify]`` root)."""
    for node in nodes:
        if node is None:
            continue
        if node.is_running:
            node.stop()
        elif not node._stopped:
            node.on_stop()  # built, never started: what is running stops
        if getattr(node, "remote_signer", None) is not None:
            node.remote_signer.stop()


def wait_for(cond: Callable[[], bool], timeout: float, interval: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def committed_in(node: Node, pred) -> Optional[int]:
    """The height of the first block in ``node``'s store (from its base)
    holding a tx or an evidence for which ``pred(item)`` holds, else None."""
    bs = node.block_store
    for h in range(max(1, bs.base()), bs.height() + 1):
        block = bs.load_block(h)
        if block is None:
            continue
        if any(pred(bytes(t)) for t in block.data.txs) or any(
                pred(ev) for ev in block.evidence.evidence):
            return h
    return None


def duplicate_vote_evidence(nodes: List[Node], offender: int, height: int,
                            timestamp_ns: Optional[int] = None) -> DuplicateVoteEvidence:
    """Validator ``offender``'s double sign at ``height``: two round-0
    prevotes for two made-up blocks, signed with its key (as
    ``consensus_net.duplicate_vote_evidence``; the ``FilePV``'s own sign
    would refuse the second)."""
    priv = nodes[offender].priv_validator._priv
    pub = priv.pub_key()
    idx, _ = nodes[0].consensus_state.get_state().validators.get_by_address(pub.address())
    ts = time.time_ns() if timestamp_ns is None else timestamp_ns
    chain_id = nodes[0].genesis_doc.chain_id
    votes = []
    for h in (b"\x11" * 32, b"\x22" * 32):
        v = Vote(vote_type=SignedMsgType.PREVOTE, height=height, round=0, timestamp_ns=ts,
                 block_id=BlockID(hash=h, parts_header=PartSetHeader(1, b"\x33" * 32)),
                 validator_address=pub.address(), validator_index=idx)
        votes.append(v.with_signature(priv.sign(v.sign_bytes(chain_id))))
    return DuplicateVoteEvidence(pub_key=pub, vote_a=votes[0], vote_b=votes[1])


def make_single_node(home: str, *, chain_id: str = "ws-chain", config: Optional[Config] = None,
                     db_backend: str = "memdb", client_creator=None, device="cpu") -> Node:
    """A single-validator node (a new key of power 10) from home directory
    ``home``, as the reference's ``tests/test_ws_metrics.py`` builds its
    live node: the ``kvstore`` app, no p2p, RPC at 127.0.0.1 port 0, the test
    consensus timeouts with a WAL, the metrics and the unsafe routes on, and
    ``db_backend`` stores. ``config`` (default ``test_config()``) gives the
    other sections. Unstarted; on a home that already holds one, the same
    node again (its key, genesis and stores)."""
    from tendermint_tpu_torch.config.config import test_config
    from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    cfg = copy.deepcopy(config) if config is not None else test_config()
    cfg.set_root(home)
    cfg.base.proxy_app = "kvstore"
    cfg.base.db_backend = db_backend
    cfg.rpc.laddr = LOCAL_RPC
    cfg.rpc.unsafe = True
    cfg.p2p.laddr = ""
    cfg.consensus.wal_path = "data/cs.wal/wal"
    cfg.instrumentation.prometheus = True
    if not os.path.exists(cfg.base.genesis_path()):
        key = PrivKeyEd25519.generate()
        doc = GenesisDoc(chain_id=chain_id, genesis_time_ns=1_700_000_000_000_000_000,
                         validators=[GenesisValidator(key.pub_key(), 10)])
        doc.validate_and_complete()
        init_home(home, doc, priv_key=key)
    return Node.from_home(home, cfg, client_creator, device=device)


def install_host_verify() -> None:
    """Verify on the host from here on (``verify_root.install_host_verify``:
    ``HostBatchVerifier`` and a host device executor); the CPU tests' nets.
    ``verify_root.reset_verify`` undoes it."""
    verify_root.install_host_verify()
