"""Nets of ``node/node.Node``s from home directories (testutil/node_net.py).

* A 2 + 2 net of port and reference ``Node``s over TCP (each node from its
  own home, one genesis, the host verifying) commits the same blocks; a
  client of either package reads a node of either package, and each
  package's light client (``RPCProvider`` + ``DynamicVerifier``) verifies
  the other package's node over ``lite_full_commit``.
* Four port validators and a fifth node that joins by state sync, as
  ``chip_smoke.py``'s phase 25 runs them on the card: the joining node's
  status reports ``catching_up`` until it runs consensus, and it follows
  the validators with their blocks; txs sent through ``broadcast_tx_commit``
  on node 0 commit on every node and node 3's index finds them.
"""

import base64
import os

import pytest

from tendermint_tpu.config import config as rconfig
from tendermint_tpu.libs.db.kv import MemDB as RMemDB
from tendermint_tpu.lite import DBProvider as RDBProvider
from tendermint_tpu.lite import DynamicVerifier as RDynamicVerifier
from tendermint_tpu.lite.proxy import RPCProvider as RRPCProvider
from tendermint_tpu.node.node import Node as RNode
from tendermint_tpu.privval.file_pv import FilePV as RFilePV
from tendermint_tpu.rpc.client import HTTPClient as RHTTPClient
from tendermint_tpu_torch.config import config as pconfig
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.lite import DBProvider, DynamicVerifier
from tendermint_tpu_torch.lite.proxy import RPCProvider
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.node.node import Node, init_home
from tendermint_tpu_torch.rpc.client import HTTPClient
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.testutil import node_net
from tendermint_tpu_torch.testutil.consensus import make_genesis

DEADLINE = 60.0


@pytest.fixture(autouse=True)
def _clean():
    yield
    verify_root.reset_verify()


def _addr(node) -> str:
    return f"tcp://127.0.0.1:{node.rpc_server.bound_port}"


def _ref_node(home: str, peers):
    cfg = rconfig.test_config().set_root(home)
    cfg.base.proxy_app, cfg.base.db_backend = "kvstore", "memdb"
    cfg.base.moniker = os.path.basename(home)
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex, cfg.p2p.allow_duplicate_ip = False, True
    cfg.p2p.persistent_peers = ",".join(peers)
    cfg.instrumentation.watchdog = False
    node = RNode(cfg, priv_validator=RFilePV.load(cfg.base.priv_validator_path()))
    node.start()
    return node


def _stop_all(nodes):
    for n in nodes:
        try:
            if n.is_running:
                n.stop()
        except Exception:
            pass
    node_net.stop_node_net([n for n in nodes if isinstance(n, Node)])


def test_a_mixed_net_of_port_and_reference_nodes_commits_the_same_blocks(tmp_path):
    doc, pvs = make_genesis(4)
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    order = [by_addr[v.address] for v in state_from_genesis(doc).validators.validators]
    homes = [str(tmp_path / f"node{i}") for i in range(4)]
    for home, pv in zip(homes, order):
        init_home(home, doc, priv_key=pv._priv)
    cfg = pconfig.test_config()
    cfg.base.proxy_app, cfg.base.db_backend = "kvstore", "memdb"
    cfg.instrumentation.watchdog = False
    port, ref, nodes = [], [], []
    try:
        for i in (0, 2):
            node = Node.from_home(homes[i], node_net.node_config(cfg, f"node{i}"), device="cpu")
            port.append(node)
        node_net.install_host_verify()
        paddrs = [str(verify_root.listen(n.switch, n.config.p2p)) for n in port]
        r1 = _ref_node(homes[1], paddrs)
        ref.append(r1)
        raddr1 = str(r1.switch.transport.listen_address)
        ref.append(_ref_node(homes[3], paddrs + [raddr1]))
        raddrs = [raddr1, str(ref[1].switch.transport.listen_address)]
        for i, node in enumerate(port):
            node.config.p2p.persistent_peers = ",".join([paddrs[1 - i]] + raddrs)
            node.start()
        nodes = [port[0], ref[0], port[1], ref[1]]
        assert node_net.wait_for(lambda: all(n.block_store.height() >= 4 for n in nodes),
                                 DEADLINE), [n.block_store.height() for n in nodes]
        for h in range(1, 5):
            blocks = [n.block_store.load_block(h) for n in nodes]
            assert len({b.hash() for b in blocks}) == 1, h
            assert len({b.header.app_hash for b in blocks}) == 1, h
        # a client of either package reads a node of either package
        for client_cls in (HTTPClient, RHTTPClient):
            for n in nodes:
                c = client_cls(_addr(n))
                assert c.status()["node_info"]["network"] == doc.chain_id
                assert c.block(3)["block"]["header"]["height"] == 3
                assert c.commit(3)["signed_header"]["commit"]["block_id"]["hash"] == (
                    n.block_store.load_block_meta(3).block_id.hash.hex().upper())
        res = RHTTPClient(_addr(port[0])).broadcast_tx_commit(b"mixed=1")
        assert res["deliver_tx"]["code"] == 0
        assert node_net.wait_for(
            lambda: all(node_net.committed_in(n, lambda t: t == b"mixed=1") if isinstance(
                n, Node) else _ref_committed(n, b"mixed=1") for n in nodes), DEADLINE)
        # each package's light client verifies the other's node
        for provider, dbp, dv_cls, db_cls, node in (
                (RRPCProvider, RDBProvider, RDynamicVerifier, RMemDB, port[0]),
                (RPCProvider, DBProvider, DynamicVerifier, MemDB, ref[0])):
            src = provider(_addr(node))
            dv = dv_cls(doc.chain_id, dbp(db_cls()), src)
            dv.init_from_full_commit(src.full_commit_at(doc.chain_id, 1))
            for h in range(2, 5):
                dv.verify(src.full_commit_at(doc.chain_id, h).signed_header)
            latest = dv.trusted.latest_full_commit(doc.chain_id, 1, 1 << 60)
            assert latest.height == 4 and latest.signed_header.header.hash() == (
                node.block_store.load_block_meta(4).header.hash())
    finally:
        _stop_all(ref + port)


def _ref_committed(node, tx) -> bool:
    bs = node.block_store
    return any(tx in [bytes(t) for t in bs.load_block(h).data.txs]
               for h in range(1, bs.height() + 1))


def test_a_node_joins_the_net_by_state_sync(tmp_path):
    cfg = pconfig.test_config()
    cfg.base.proxy_app = "persistent_kvstore"
    cfg.statesync.snapshot_interval = 2
    cfg.instrumentation.watchdog = False
    nodes, joiner = node_net.make_node_net(4, str(tmp_path), cfg, start=False), None
    try:
        node_net.install_host_verify()
        node_net.start_node_net(nodes)
        c0 = HTTPClient(_addr(nodes[0]))
        sent = [c0.broadcast_tx_commit(b"join-%d=v" % i) for i in range(3)]
        assert all(r["deliver_tx"]["code"] == 0 for r in sent)
        assert node_net.wait_for(lambda: all(n.block_store.height() >= 5 for n in nodes),
                                 DEADLINE)
        meta = nodes[0].block_store.load_block_meta(1)
        ss = StateSyncConfig(enable=True, trust_height=1, trust_hash=meta.header.hash().hex())
        jcfg = pconfig.test_config()
        jcfg.base.proxy_app = "persistent_kvstore"
        jcfg.instrumentation.watchdog = False
        joiner = node_net.add_joining_node(nodes, str(tmp_path), jcfg, statesync=ss,
                                           start=False)
        assert joiner.reactors.restoring and joiner.status()["sync_info"]["catching_up"]
        joiner.start()
        tip = max(n.block_store.height() for n in nodes)
        assert node_net.wait_for(lambda: joiner.block_store.height() >= tip + 1
                                 and not joiner.consensus_reactor.fast_sync, DEADLINE)
        assert HTTPClient(_addr(joiner)).status()["sync_info"]["catching_up"] is False
        assert joiner.statesync_reactor.progress()["synced_height"] >= 2
        for h in range(joiner.block_store.base(), tip + 1):
            assert joiner.block_store.load_block_meta(h).header.hash() == (
                nodes[0].block_store.load_block_meta(h).header.hash())
        # node 3's index finds every tx at the height the route returned
        c3 = HTTPClient(_addr(nodes[3]))
        for r in sent:
            assert node_net.wait_for(lambda: _indexed(c3, r["hash"]), 10)
            assert c3.tx(r["hash"])["height"] == r["height"]
            found = c3.tx_search(f"tx.height = {r['height']}")["txs"]
            assert r["hash"] in [t["hash"] for t in found]
            assert base64.b64decode(c3.tx(r["hash"])["tx"]).startswith(b"join-")
    finally:
        node_net.stop_node_net(nodes + ([joiner] if joiner is not None else []))


def _indexed(client, tx_hash) -> bool:
    try:
        client.tx(tx_hash)
        return True
    except Exception:
        return False
