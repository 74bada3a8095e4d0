"""The node's configuration: one struct with a section a module (ref
config/config.go; the port's copy of the reference package's
``config/config.py``).

``BaseConfig``, ``RPCConfig``, ``FrontendConfig`` and ``TxIndexConfig``
are copied here, each field under the reference's name and with its
default. The other sections are the port's section modules
(``config/{consensus,mempool,p2p,statesync,verify,instrumentation}.py``),
which ``node/verify_root.py`` applies. Durations are seconds (float).

Every field of the reference's configuration is ported: the remote signer
(``base.priv_validator_laddr``, ``privval/remote_signer.py``), the peer
exchange and its address book (``[p2p] pex``, ``seeds``, ``seed_mode``),
and the ``remote`` db backend. ``[p2p] private_peer_ids``, ``upnp`` and
``test_fuzz`` are read and wired to nothing, as in the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from tendermint_tpu_torch.config.consensus import ConsensusConfig, consensus_test_config
from tendermint_tpu_torch.config.instrumentation import InstrumentationConfig
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.config.p2p import P2PConfig
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.config.verify import VerifyConfig

@dataclass
class BaseConfig:
    root_dir: str = ""
    chain_id: str = ""
    moniker: str = "anonymous"
    fast_sync: bool = True
    db_backend: str = "sqlite"  # role of goleveldb in the reference
    db_dir: str = "data"
    log_level: str = "info"
    genesis_file: str = "config/genesis.json"
    priv_validator_file: str = "config/priv_validator.json"
    # remote signer listen address (tcp://host:port or unix://path) — when
    # set, the node listens here for the signer's dial-in (node/node.py)
    priv_validator_laddr: str = ""
    priv_validator_signer_pubkey: str = ""
    node_key_file: str = "config/node_key.json"
    abci: str = "socket"
    proxy_app: str = "tcp://127.0.0.1:26658"
    prof_laddr: str = ""
    filter_peers: bool = False

    def genesis_path(self) -> str:
        return os.path.join(self.root_dir, self.genesis_file)

    def priv_validator_path(self) -> str:
        return os.path.join(self.root_dir, self.priv_validator_file)

    def node_key_path(self) -> str:
        return os.path.join(self.root_dir, self.node_key_file)

    def db_path(self) -> str:
        """The stores' directory; for the ``remote`` backend, ``db_dir`` is
        the store server's address (``host:port``) and is taken as it is."""
        if self.db_backend == "remote":
            return self.db_dir
        return os.path.join(self.root_dir, self.db_dir)


@dataclass
class RPCConfig:
    laddr: str = "tcp://0.0.0.0:26657"
    grpc_laddr: str = ""
    grpc_max_open_connections: int = 900
    unsafe: bool = False
    max_open_connections: int = 900
    # load-shedding budget for broadcast_tx_*: at most this many in-flight
    # submissions across async + sync + commit before new ones are rejected
    # with a fast mempool-overloaded error. 0 = unbounded.
    broadcast_max_in_flight: int = 256


@dataclass
class FrontendConfig:
    """[frontend]: the multi-client light-client serving frontend. When
    enabled the node runs a ``lite/proxy.LiteProxy`` over its own stores
    and, if ``laddr`` is set, serves its HTTP surface (/verify_commit,
    /light_block, ...)."""

    enable: bool = False
    # listen address for the HTTP surface, host:port; "" = the frontend is
    # built (RPC frontend_status works) but no socket is opened
    laddr: str = ""
    # aggregation window: how long a flush waits for more client rows
    batch_window_s: float = 0.002
    # rows per planner dispatch (one row = one commit's signature batch)
    batch_max_rows: int = 64
    # verified-header LRU entries
    cache_size: int = 4096
    # run batched dispatches on the device executor (subject to [verify]'s
    # guard); False = the verifier route
    use_device: bool = False
    # optional social-consensus trust pin; 0/"" = trust-on-first-use
    trusted_height: int = 0
    trusted_hash: str = ""


@dataclass
class TxIndexConfig:
    indexer: str = "kv"  # "kv" | "null"
    index_tags: str = ""
    index_all_tags: bool = False


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    verify: VerifyConfig = field(default_factory=VerifyConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(default_factory=InstrumentationConfig)

    def set_root(self, root: str) -> "Config":
        self.base.root_dir = root
        return self


def default_config() -> Config:
    return Config()


def test_config() -> Config:
    """Shrunken timeouts for tests (ref config.go:592-594
    TestConsensusConfig), fast sync off."""
    c = Config()
    c.base.fast_sync = False
    c.consensus = consensus_test_config()
    return c
