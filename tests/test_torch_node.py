"""The port's node (node/node.py), its configuration (config/config.py) and
``libs/telemetry.node_sources``, against the reference's.

* A single-validator ``Node`` from a home directory on the CPU commits on
  memdb and on sqlite; on sqlite a new ``Node`` over the same home
  replays the app through the handshake and the WAL and goes on at the
  next height with the same chain; on memdb the home keeps its genesis, key
  and the FilePV's last-sign state but not the chain.
* ``status()`` has the reference's keys and value types, beside a
  reference node's.
* ``Config`` and every section equal the reference's field for field;
  each field whose module came later builds a node that runs it (the
  remote signer, ``rpc.grpc_laddr``, ``mempool.wal_path``, the peer
  exchange), and a node whose socket app is not there fails to connect, as
  the reference's does.
* ``device=None`` without a card raises ``NoCudaDeviceError``.
* The ``[verify]`` root is one a process: nodes with an equal section share
  it, one with another section raises, and a stopped node's root is not torn
  down under the others.
* The node's wiring: the reactor set in the reference's order, the snapshot
  store on the node's own store, the telemetry spool's sources (the
  reference's ``node_sources`` names), the metrics only with
  ``prometheus``, the indexer by ``[tx_index]``, the light-client frontend
  by ``[frontend]``.
"""

import dataclasses
import json
import os

import pytest
import torch

from tendermint_tpu.config import config as rconfig
from tendermint_tpu.libs import telemetry as rtelemetry
from tendermint_tpu.privval.file_pv import FilePV as RFilePV
from tendermint_tpu.types.genesis import GenesisDoc as RGenesisDoc
from tendermint_tpu_torch.config import config as pconfig
from tendermint_tpu_torch.config.p2p import P2PConfig
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs import telemetry
from tendermint_tpu_torch.libs.db.kv import MemDB, SQLiteDB
from tendermint_tpu_torch.lite.proxy import LiteProxy
from tendermint_tpu_torch.node import node as node_mod
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.node.node import Node, init_home
from tendermint_tpu_torch.privval.file_pv import FilePV
from tendermint_tpu_torch.state.txindex.kv import KVTxIndexer, NullTxIndexer
from tendermint_tpu_torch.testutil import node_net
from tendermint_tpu_torch.testutil.consensus import make_genesis

DEADLINE = 30.0


@pytest.fixture(autouse=True)
def _clean():
    yield
    verify_root.reset_verify()
    assert node_mod._ROOT["nodes"] == 0, "a test left a node holding the [verify] root"


def started(node):
    node_net.install_host_verify()
    node.start()
    return node


@pytest.mark.parametrize("backend", ["memdb", "sqlite"])
def test_a_node_from_a_home_commits_and_restarts_on_it(tmp_path, backend):
    home = str(tmp_path / "home")
    node = started(node_net.make_single_node(home, db_backend=backend))
    try:
        assert node_net.wait_for(lambda: node.block_store.height() >= 3, DEADLINE)
    finally:
        node.stop()
    h0 = node.block_store.height()
    metas = {h: node.block_store.load_block_meta(h) for h in range(1, h0 + 1)}
    app_hash = node.status()["sync_info"]["latest_app_hash"]
    # the home's files are the node's
    assert FilePV.load(os.path.join(home, "config", "priv_validator.json")).last_height >= h0
    again = node_net.make_single_node(home, db_backend=backend)
    if backend == "memdb":
        # the chain went with the process; the key, genesis and the signer's
        # last-sign state stayed
        try:
            assert again.block_store.height() == 0
            assert again.genesis_doc.to_json() == node.genesis_doc.to_json()
            assert again.priv_validator.last_height >= h0
        finally:
            node_net.stop_node_net([again])
        return
    try:
        # the stores are the node's: the handshake replayed the app to them
        assert again.block_store.height() == h0
        assert again.status()["sync_info"]["latest_app_hash"] == app_hash
        assert again.consensus_state.get_state().last_block_height == h0
        started(again)
        assert node_net.wait_for(lambda: again.block_store.height() >= h0 + 2, DEADLINE)
        for h, meta in metas.items():
            assert again.block_store.load_block_meta(h).header.hash() == meta.header.hash()
        assert again.block_store.load_block(h0 + 1).header.last_block_id.hash == (
            metas[h0].block_id.hash)
    finally:
        again.stop()


def test_a_node_restarted_mid_height_replays_its_wal(tmp_path):
    """Stopped right after a commit, the next node over the home resumes
    from the WAL: its first new block is the next height, signed once (the
    FilePV never double-signs)."""
    home = str(tmp_path / "home")
    node = started(node_net.make_single_node(home, db_backend="sqlite"))
    try:
        assert node_net.wait_for(lambda: node.block_store.height() >= 2, DEADLINE)
    finally:
        node.stop()
    wal = os.path.join(home, "data", "cs.wal", "wal")
    assert os.path.exists(wal) and os.path.getsize(wal) > 0
    h0 = node.block_store.height()
    again = started(node_net.make_single_node(home, db_backend="sqlite"))
    try:
        assert node_net.wait_for(lambda: again.block_store.height() >= h0 + 1, DEADLINE)
        assert again.block_store.load_block(h0 + 1).header.height == h0 + 1
    finally:
        again.stop()


def _shape(x):
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    return type(x).__name__


def test_status_has_the_reference_s_keys(tmp_path):
    from tendermint_tpu.node.node import Node as RNode

    node = started(node_net.make_single_node(str(tmp_path / "port")))
    rhome = str(tmp_path / "ref")
    os.makedirs(os.path.join(rhome, "config"))
    rcfg = rconfig.default_config().set_root(rhome)
    rcfg.base.proxy_app, rcfg.base.db_backend = "kvstore", "memdb"
    rcfg.rpc.laddr, rcfg.p2p.laddr = "", ""
    rcfg.consensus = rconfig.test_config().consensus
    rpv = RFilePV.generate(os.path.join(rhome, "config", "pv.json"))
    rdoc = RGenesisDoc.from_json(node.genesis_doc.to_json())
    rdoc.validators[0] = dataclasses.replace(rdoc.validators[0], pub_key=rpv.get_pub_key())
    rnode = RNode(rcfg, priv_validator=rpv, genesis_doc=rdoc)
    rnode.start()
    try:
        assert node_net.wait_for(lambda: node.block_store.height() >= 1
                                 and rnode.block_store.height() >= 1, DEADLINE)
        got, want = node.status(), rnode.status()
        assert _shape(got) == _shape(want)
        assert got["node_info"] == {**want["node_info"], "moniker": got["node_info"]["moniker"]}
        assert got["sync_info"]["catching_up"] is False is want["sync_info"]["catching_up"]
        assert got["validator_info"]["voting_power"] == 10
    finally:
        node.stop()
        rnode.stop()


SECTIONS = ["base", "rpc", "p2p", "mempool", "consensus", "statesync", "verify", "frontend",
            "tx_index", "instrumentation"]


@pytest.mark.parametrize("section", SECTIONS)
def test_each_section_equals_the_reference_s(section):
    port, ref = pconfig.default_config(), rconfig.default_config()
    assert dataclasses.asdict(getattr(port, section)) == dataclasses.asdict(getattr(ref, section))
    port_t, ref_t = pconfig.test_config(), rconfig.test_config()
    assert dataclasses.asdict(getattr(port_t, section)) == dataclasses.asdict(
        getattr(ref_t, section))


def test_the_config_has_the_reference_s_sections_and_paths():
    assert [f.name for f in dataclasses.fields(pconfig.Config)] == [
        f.name for f in dataclasses.fields(rconfig.Config)] == SECTIONS
    p, r = pconfig.default_config().set_root("/h"), rconfig.default_config().set_root("/h")
    for fn in ("genesis_path", "priv_validator_path", "node_key_path", "db_path"):
        assert getattr(p.base, fn)() == getattr(r.base, fn)()


def _local(**kw):
    cfg = pconfig.test_config()
    cfg.base.proxy_app = "kvstore"
    cfg.p2p = P2PConfig(laddr="", pex=False)
    for path, value in kw.items():
        section, field = path.split("__")
        setattr(getattr(cfg, section), field, value)
    return cfg


# (fields, what the built node shows): every field that was refused until
# its module came is accepted now
PORTED = [
    (dict(base__priv_validator_laddr="tcp://127.0.0.1:{port}"), "remote_signer"),
    (dict(rpc__grpc_laddr="tcp://127.0.0.1:26670"), "grpc"),
    (dict(base__proxy_app="tcp://127.0.0.1:1"), "socket_app"),
    (dict(mempool__wal_path="data/mempool.wal"), "mempool_wal"),
    (dict(p2p__laddr="tcp://127.0.0.1:0", p2p__pex=True), "pex"),
]


@pytest.mark.parametrize("fields,what", PORTED,
                         ids=["remote_signer", "grpc", "socket_app", "mempool_wal", "pex"])
def test_validate_ported_refuses_what_is_not_ported(tmp_path, fields, what):
    """Every field the node refused until its module was ported builds a
    node now, which runs it as the reference's does."""
    from tendermint_tpu_torch.privval.remote_signer import SignerValidatorEndpoint

    port = node_net.free_port()
    cfg = _local(**{k: v.format(port=port) if isinstance(v, str) else v
                    for k, v in fields.items()})
    cfg.set_root(str(tmp_path))
    doc, pvs = make_genesis(1)

    def build():
        return Node(cfg, genesis_doc=doc, db_provider=lambda name: MemDB(), device="cpu")

    if what == "socket_app":
        # nothing listens there: the socket client fails to connect while
        # the node builds, and the node gives the root back
        with pytest.raises(ConnectionRefusedError):
            build()
        assert node_mod._ROOT["nodes"] == 0
        return
    signer = (node_net.RemoteSigner(pvs[0]._priv, str(tmp_path / "signer" / "pv.json"),
                                    cfg.base.priv_validator_laddr)
              if what == "remote_signer" else None)
    node = build()
    try:
        if what == "remote_signer":
            assert isinstance(node.priv_validator, SignerValidatorEndpoint)
            assert node.priv_validator.get_pub_key().bytes() == pvs[0].get_pub_key().bytes()
            assert node.consensus_state.priv_validator is node.signer_endpoint
        elif what == "grpc":
            assert node.config.rpc.grpc_laddr and node.grpc_broadcast is None  # on start
        elif what == "mempool_wal":
            assert node.mempool._wal is not None
        else:
            assert node.switch.reactors["pex"] is node.pex_reactor
            assert node.pex_reactor.book is node.addr_book
            assert 0x00 in node.switch.transport.node_info.channels
            assert node.addr_book._file == os.path.join(str(tmp_path), "config", "addrbook.json")
    finally:
        node_net.stop_node_net([node])
        if signer is not None:
            signer.stop()
    assert node_mod._ROOT["nodes"] == 0


def test_a_client_creator_stands_for_the_proxy_app():
    from tendermint_tpu_torch.abci.client import SocketClient
    from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
    from tendermint_tpu_torch.abci.grpc import GRPCClient
    from tendermint_tpu_torch.proxy.app_conn import RemoteClientCreator, default_client_creator

    remote = default_client_creator("tcp://127.0.0.1:26658")
    assert isinstance(remote, RemoteClientCreator) and not hasattr(remote, "_app")
    assert isinstance(remote.new_abci_client(), SocketClient)
    assert isinstance(default_client_creator("grpc://127.0.0.1:26658").new_abci_client(),
                      GRPCClient)
    assert isinstance(default_client_creator("kvstore")._app, KVStoreApp)


def test_without_a_card_device_none_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    home = str(tmp_path / "home")
    doc, _ = make_genesis(1)
    init_home(home, doc)
    with pytest.raises(NoCudaDeviceError):
        Node.from_home(home, _local())
    assert node_mod._ROOT["nodes"] == 0


def test_nodes_share_one_verify_root(tmp_path):
    a = node_net.make_single_node(str(tmp_path / "a"))
    b = node_net.make_single_node(str(tmp_path / "b"))
    try:
        assert a.verify_root is b.verify_root and node_mod._ROOT["nodes"] == 2
        assert tbatch.get_batch_verifier() is a.verify_root.verifier
        other = pconfig.test_config()
        other.verify = VerifyConfig(audit_sample_rate=0.5)
        with pytest.raises(ValueError, match="one verify path a process"):
            node_net.make_single_node(str(tmp_path / "c"), config=other)
        node_net.stop_node_net([a])
        # b still holds it: the root stays, and it is still b's
        assert node_mod._ROOT["nodes"] == 1 and tbatch.get_batch_verifier() is b.verify_root.verifier
        with pytest.raises(ValueError):
            node_net.make_single_node(str(tmp_path / "d"), config=other)
    finally:
        node_net.stop_node_net([a, b])
    assert node_mod._ROOT["nodes"] == 0
    c = node_net.make_single_node(str(tmp_path / "c"), config=other)  # free again
    try:
        assert c.verify_root.verifier.audit_rate == 0.5
    finally:
        node_net.stop_node_net([c])


def test_init_home_writes_what_the_reference_reads(tmp_path):
    from tendermint_tpu.p2p.key import NodeKey as RNodeKey

    doc, pvs = make_genesis(2)
    home = str(tmp_path / "home")
    pv = init_home(home, doc, priv_key=pvs[0]._priv)
    base = pconfig.BaseConfig(root_dir=home)
    assert os.path.isdir(base.db_path())
    rdoc = RGenesisDoc.from_file(base.genesis_path())
    assert rdoc.to_json() == doc.to_json()
    rpv = RFilePV.load(base.priv_validator_path())
    assert rpv.get_pub_key().bytes() == pv.get_pub_key().bytes() == pvs[0].get_pub_key().bytes()
    with open(base.node_key_path()) as f:
        assert json.load(f)
    assert RNodeKey.load(base.node_key_path()).id()


def test_the_node_wires_what_verify_root_builds(tmp_path):
    cfg = pconfig.test_config()
    cfg.p2p = P2PConfig(laddr="tcp://127.0.0.1:0", pex=False)
    cfg.statesync.snapshot_interval = 2
    cfg.instrumentation.telemetry_spool = True
    cfg.frontend.enable = True
    cfg.tx_index.indexer = "null"
    node = node_net.make_single_node(str(tmp_path / "home"), config=cfg, db_backend="sqlite")
    try:
        assert node.config.p2p.laddr == ""  # make_single_node runs no p2p
    finally:
        node_net.stop_node_net([node])
    cfg.base.proxy_app = "persistent_kvstore"
    home = str(tmp_path / "p2p")
    doc, pvs = make_genesis(1)
    init_home(home, doc, priv_key=pvs[0]._priv)
    node = Node.from_home(home, cfg, device="cpu")
    try:
        sw = node.switch
        assert list(sw.reactors) == ["consensus", "blockchain", "mempool", "evidence", "statesync"]
        assert sw.reactors["consensus"] is node.consensus_reactor
        assert node.consensus_reactor.cons is node.consensus_state
        assert sw.reactors["statesync"] is node.statesync_reactor
        assert node.reactors.fast_sync is False  # the only validator does not fast-sync
        # the snapshot store is on the node's own sqlite store, and the app
        # produces into it before the handshake replays
        assert isinstance(node.snapshot_store._db, SQLiteDB)
        assert node.reactors.statesync.snapshot_store is node.snapshot_store
        assert (node.app._snapshot_store, node.app._snapshot_interval) == (node.snapshot_store, 2)
        assert node.metrics is None and isinstance(node.tx_indexer, NullTxIndexer)
        assert isinstance(node.frontend, LiteProxy)
        assert node.telemetry_spool is not None and node.watchdog is not None
        assert set(node.telemetry_spool._sources) >= set(telemetry.node_sources(node))
        assert node.consensus_state.flight.node_id == node.node_key.id()
    finally:
        node_net.stop_node_net([node])


def test_node_sources_name_the_reference_s_sections(tmp_path):
    node = node_net.make_single_node(str(tmp_path / "home"))
    try:
        got = telemetry.node_sources(node)

        class Shim:  # the reference reads only consensus_state
            consensus_state = node.consensus_state

        assert list(got) == list(rtelemetry.node_sources(Shim()))
        out = {k: fn() for k, fn in got.items()}
        assert out["stats"]["height"] == node.consensus_state.rs.height
        assert set(out["evicted"]) == {"flight", "profile", "critpath", "quorum"}
        json.dumps(out)
    finally:
        node_net.stop_node_net([node])


def test_the_kv_indexer_serves_the_node_by_default(tmp_path):
    node = started(node_net.make_single_node(str(tmp_path / "home")))
    try:
        assert isinstance(node.tx_indexer, KVTxIndexer) and isinstance(node.tx_indexer._db, MemDB)
        node.mempool.check_tx(b"idx=1")
        import hashlib

        h = hashlib.sha256(b"idx=1").digest()
        assert node_net.wait_for(lambda: node.tx_indexer.get(h) is not None, DEADLINE)
        assert node.tx_indexer.get(h).result.code == 0
    finally:
        node.stop()
