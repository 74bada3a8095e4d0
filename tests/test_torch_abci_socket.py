"""The socket ABCI transport (abci/client.SocketClient, abci/server.ABCIServer),
the remote client creator, abci-cli and the mempool WAL, against the
reference's.

* The reference's ``tests/test_periphery.py::TestAbciCli`` and
  ``tests/test_state.py::TestABCIClients::test_socket_client_server_roundtrip``
  restated on the port; abci-cli's output equals the reference's on one
  script.
* Every request type through a port ``SocketClient`` against a reference
  ``ABCIServer`` and a reference ``SocketClient`` against a port
  ``ABCIServer`` answers as a ``LocalClient`` of the same app does; the
  frames each client sends and each server answers are byte-equal across the
  packages.
* An app's exception reaches the caller as ``ABCIClientError``, and a
  block's DeliverTx that crashes a remote app fails the block with
  ``ProxyAppConnError``, as the reference's.
* A net of two port nodes, one on the in-process kvstore and one on a
  kvstore served over a socket, commits the same blocks and app hashes.
* The mempool WAL holds each admitted tx, byte for byte as the reference's.

Exact: every comparison is of bytes or of equal values.
"""

import logging
import os
import socket
import subprocess
import sys

import pytest

from tendermint_tpu.abci import types as rabci
from tendermint_tpu.abci.client import SocketClient as RSocketClient
from tendermint_tpu.abci.examples.kvstore import KVStoreApp as RKVStoreApp
from tendermint_tpu.abci.server import ABCIServer as RABCIServer
from tendermint_tpu.libs.autofile import Group as RGroup
from tendermint_tpu.mempool.mempool import Mempool as RMempool
from tendermint_tpu.proxy.app_conn import MultiAppConn as RMultiAppConn
from tendermint_tpu.proxy.app_conn import LocalClientCreator as RLocalClientCreator
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import (
    ABCIClientError,
    LocalClient,
    SocketClient,
    _read_frame,
)
from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.abci.server import ABCIServer
from tendermint_tpu_torch.config import config as pconfig
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.encoding.codec import encode_uvarint
from tendermint_tpu_torch.libs.autofile import Group
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.mempool.mempool import Mempool, TxInCacheError
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.proxy.app_conn import (
    LocalClientCreator,
    MultiAppConn,
    RemoteClientCreator,
)
from tendermint_tpu_torch.state.execution import ProxyAppConnError, exec_block_on_proxy_app
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.testutil import node_net
from tendermint_tpu_torch.testutil.consensus import make_genesis
from tendermint_tpu_torch.types.block import Commit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 60.0


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["TM_BATCH_VERIFIER"] = "host"
    return env


@pytest.fixture()
def served():
    """Start servers; each is stopped at the end."""
    out = []

    def start(srv):
        srv.start()
        out.append(srv)
        return f"tcp://127.0.0.1:{srv.bound_port}"

    yield start
    for srv in out:
        if srv.is_running:
            srv.stop()


def _requests():
    """One of every request type, in an order a kvstore answers
    meaningfully (the snapshot calls hit the base Application's defaults)."""
    return [
        abci.RequestEcho(message="hello"),
        abci.RequestInfo(version="0.26.2"),
        abci.RequestSetOption(key="serial", value="on"),
        abci.RequestInitChain(time_ns=7, chain_id="sock-chain",
                              validators=[abci.ValidatorUpdate(pub_key=b"\x01" * 32,
                                                               power=10)]),
        abci.RequestBeginBlock(hash=b"\x02" * 32,
                               header=abci.ABCIHeader(chain_id="sock-chain", height=1),
                               last_commit_info=abci.LastCommitInfo(
                                   round=0, votes=[abci.VoteInfo(address=b"\xaa" * 20,
                                                                 power=10)])),
        abci.RequestCheckTx(tx=b"a=1"),
        abci.RequestCheckTx(tx=b"b=2", sig_verified=True),
        abci.RequestCheckTx(tx=b"c=3", sig_verified=False),
        abci.RequestDeliverTx(tx=b"a=1"),
        abci.RequestDeliverTx(tx=b"b=2"),
        abci.RequestEndBlock(height=1),
        abci.RequestCommit(),
        abci.RequestQuery(data=b"a", path="/store"),
        abci.RequestQuery(data=b"zz", path="/store", prove=True),
        abci.RequestListSnapshots(),
        abci.RequestOfferSnapshot(snapshot=abci.Snapshot(height=1, format=1, chunks=1,
                                                         hash=b"h", metadata=b"m"),
                                  app_hash=b"\x03" * 32),
        abci.RequestLoadSnapshotChunk(height=1, format=1, chunk=0),
        abci.RequestApplySnapshotChunk(index=0, chunk=b"c", sender="peer"),
        abci.RequestFlush(),
    ]


def _raw_call(addr: str, payload: bytes) -> bytes:
    """One frame to a server over a raw socket; the response frame's bytes."""
    host, port = addr[len("tcp://"):].rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(encode_uvarint(len(payload)) + payload)
        frame, _ = _read_frame(s, b"")
    return frame


def test_every_request_type_answers_as_the_local_client_does_across_the_packages(served):
    local = LocalClient(KVStoreApp())
    p_srv = served(ABCIServer("tcp://127.0.0.1:0", KVStoreApp()))
    r_srv = served(RABCIServer("tcp://127.0.0.1:0", RKVStoreApp()))
    p_raw = served(ABCIServer("tcp://127.0.0.1:0", KVStoreApp()))
    r_raw = served(RABCIServer("tcp://127.0.0.1:0", RKVStoreApp()))
    port_to_ref = SocketClient(r_srv)
    ref_to_port = RSocketClient(p_srv)
    port_to_ref.start()
    ref_to_port.start()
    try:
        for req in _requests():
            frame = abci.msg_to_json(req)
            rreq = rabci.msg_from_json(frame)
            # the request's frame is the reference's
            assert rabci.msg_to_json(rreq) == frame, type(req).__name__
            want = (abci.ResponseFlush() if isinstance(req, abci.RequestFlush)
                    else local.request_sync(req))
            got_p = port_to_ref.request_sync(req)
            got_r = ref_to_port.request_sync(rreq)
            assert abci.msg_to_json(got_p) == abci.msg_to_json(want), type(req).__name__
            assert rabci.msg_to_json(got_r) == abci.msg_to_json(want), type(req).__name__
            # the servers' answers to the same frame, byte for byte
            assert _raw_call(p_raw, frame) == _raw_call(r_raw, frame), type(req).__name__
    finally:
        port_to_ref.stop()
        ref_to_port.stop()


def test_the_clients_send_the_same_bytes():
    """What a port SocketClient writes on the wire equals what a reference
    one writes for the same requests, sig_verified included."""
    reqs = [r for r in _requests() if not isinstance(r, abci.RequestFlush)]
    got = {}
    for name, cls, conv in (("port", SocketClient, lambda r: r),
                            ("ref", RSocketClient,
                             lambda r: rabci.msg_from_json(abci.msg_to_json(r)))):
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        c = cls(f"tcp://127.0.0.1:{lst.getsockname()[1]}")
        c.start()
        conn, _ = lst.accept()
        for r in reqs:
            c.request_async(conv(r))
        frames, buf = [], b""
        conn.settimeout(10)
        while len(frames) < len(reqs):
            frame, buf = _read_frame(conn, buf)
            assert frame is not None
            frames.append(frame)
        c.stop()
        conn.close()
        lst.close()
        got[name] = frames
    assert got["port"] == got["ref"]
    assert got["port"] == [abci.msg_to_json(r) for r in reqs]


def test_socket_client_server_roundtrip(served):
    """tests/test_state.py::TestABCIClients::test_socket_client_server_roundtrip
    restated on the port."""
    app = KVStoreApp()
    cli = SocketClient(served(ABCIServer("tcp://127.0.0.1:0", app)))
    cli.start()
    try:
        assert cli.request_sync(abci.RequestEcho(message="hi")).message == "hi"
        assert cli.request_sync(abci.RequestDeliverTx(tx=b"k=v")).code == abci.CODE_TYPE_OK
        cli.request_sync(abci.RequestCommit())
        assert cli.request_sync(abci.RequestQuery(data=b"k")).value == b"v"
        for i in range(20):  # the async pipeline and a flush
            cli.request_async(abci.RequestDeliverTx(tx=b"x%d=%d" % (i, i)))
        cli.flush_sync()
        assert app.size == 21
        # the typed wrappers, as the reference's
        assert cli.echo_sync(abci.RequestEcho(message="w")).message == "w"
        assert cli.info_sync().last_block_height == 1
    finally:
        cli.stop()


def test_a_unix_socket_serves_too(tmp_path):
    addr = f"unix://{tmp_path}/app.sock"
    srv = ABCIServer(addr, KVStoreApp())
    srv.start()
    cli = RSocketClient(addr)
    cli.start()
    try:
        assert srv.bound_port is None
        assert cli.request_sync(rabci.RequestEcho(message="unix")).message == "unix"
    finally:
        cli.stop()
        srv.stop()


@pytest.mark.parametrize("server_cls", [ABCIServer, RABCIServer], ids=["port", "reference"])
def test_an_app_exception_is_an_abci_client_error(served, server_cls):
    class CrashyApp(KVStoreApp):
        def deliver_tx(self, req):
            raise RuntimeError("app exploded")

    app = CrashyApp() if server_cls is ABCIServer else type(
        "RCrashy", (RKVStoreApp,), {"deliver_tx": CrashyApp.deliver_tx})()
    cli = SocketClient(served(server_cls("tcp://127.0.0.1:0", app)))
    cli.start()
    try:
        with pytest.raises(ABCIClientError, match="app exploded"):
            cli.request_sync(abci.RequestDeliverTx(tx=b"x"))
        # the connection stays usable after an app's error
        assert cli.request_sync(abci.RequestEcho(message="ok")).message == "ok"
    finally:
        cli.stop()


def test_a_lost_app_connection_is_the_client_s_error(served):
    srv = ABCIServer("tcp://127.0.0.1:0", KVStoreApp())
    cli = SocketClient(served(srv))
    cli.start()
    try:
        assert cli.request_sync(abci.RequestEcho(message="up")).message == "up"
        srv.stop()
        with pytest.raises(ABCIClientError):
            cli.request_sync(abci.RequestEcho(message="down"), timeout=2.0)
        assert cli.error() is not None
    finally:
        cli.stop()


def test_multi_app_conn_over_a_socket(served):
    addr = served(RABCIServer("tcp://127.0.0.1:0", RKVStoreApp()))
    conn = MultiAppConn(RemoteClientCreator(addr))
    conn.start()
    try:
        assert conn.query.echo_sync("z").message == "z"
        assert conn.query.info_sync(abci.RequestInfo()).version == "0.1.0"
        rr = conn.mempool.check_tx_async(b"m=1", sig_verified=True)
        conn.mempool.flush_async()
        assert rr.wait(10).code == abci.CODE_TYPE_OK
    finally:
        conn.stop()


# -- abci-cli (tests/test_periphery.py::TestAbciCli restated) ---------------------------------


def _abci_cli(pkg: str, *args, script: bytes = b""):
    return subprocess.run([sys.executable, "-m", f"{pkg}.cmd.abci_cli", *args], input=script,
                          capture_output=True, cwd=REPO, env=_env(), timeout=60)


def test_abci_cli_batch_against_the_local_kvstore_prints_what_the_reference_prints():
    script = b'deliver_tx "k1=v1"\ncommit\nquery "k1"\ninfo\necho "hi there"\n'
    res = _abci_cli("tendermint_tpu_torch", "--app", "kvstore", "batch", script=script)
    ref = _abci_cli("tendermint_tpu", "--app", "kvstore", "batch", script=script)
    out = res.stdout.decode()
    assert res.returncode == 0, res.stderr.decode()
    assert "value: 0x" + b"v1".hex().upper() in out
    assert "last_block_height: 1" in out
    assert out == ref.stdout.decode()


@pytest.mark.parametrize("server_cls", [ABCIServer, RABCIServer], ids=["port", "reference"])
def test_abci_cli_against_a_socket_server(served, server_cls):
    app = KVStoreApp() if server_cls is ABCIServer else RKVStoreApp()
    addr = served(server_cls("tcp://127.0.0.1:0", app))
    res = _abci_cli("tendermint_tpu_torch", "--address", addr, "echo", "hello-over-socket")
    assert res.returncode == 0, res.stderr.decode()
    ref = _abci_cli("tendermint_tpu", "--address", addr, "echo", "hello-over-socket")
    assert res.stdout == ref.stdout
    res = _abci_cli("tendermint_tpu_torch", "--address", addr, "deliver_tx", "s=1")
    assert res.returncode == 0 and res.stdout.decode() == "-> code: 0\n"
    assert app.size == 1


# -- the node on a socket app ---------------------------------------------------------------


@pytest.fixture()
def _reset():
    yield
    verify_root.reset_verify()


def test_a_node_on_a_socket_app_commits_the_blocks_and_app_hashes_of_a_local_one(tmp_path,
                                                                                   served,
                                                                                   _reset):
    """Two validators of one genesis (each holds half the power: every block
    needs both), node 0 on the in-process kvstore, node 1 on a kvstore of
    its own served over a socket: each height's block and app hash agree,
    and txs through node 1's RPC reach its app through the socket."""
    remote_app = KVStoreApp()
    addr = served(ABCIServer("tcp://127.0.0.1:0", remote_app))
    cfg = pconfig.test_config()
    cfg.base.proxy_app, cfg.base.db_backend = "kvstore", "memdb"
    cfg.instrumentation.watchdog = False
    creators = [LocalClientCreator(KVStoreApp()), RemoteClientCreator(addr)]
    nodes = node_net.make_node_net(2, str(tmp_path), cfg, lambda i: creators[i], start=False)
    try:
        assert nodes[1].app is None and nodes[1].tx_feed is None
        node_net.install_host_verify()
        node_net.start_node_net(nodes)
        from tendermint_tpu_torch.rpc.client import HTTPClient

        c1 = HTTPClient(f"tcp://127.0.0.1:{nodes[1].rpc_server.bound_port}")
        sent = [c1.broadcast_tx_commit(b"sock-%d=v%d" % (i, i)) for i in range(3)]
        assert all(r["check_tx"]["code"] == 0 and r["deliver_tx"]["code"] == 0 for r in sent)
        top = max(r["height"] for r in sent) + 1
        assert node_net.wait_for(lambda: all(n.block_store.height() >= top for n in nodes),
                                 DEADLINE), [n.block_store.height() for n in nodes]
        for h in range(1, top + 1):
            metas = [n.block_store.load_block_meta(h) for n in nodes]
            assert metas[0].block_id.hash == metas[1].block_id.hash, h
            assert metas[0].header.app_hash == metas[1].header.app_hash, h
        assert remote_app.size == 3
        q = remote_app.query(abci.RequestQuery(data=b"sock-2", path="/store"))
        assert q.value == b"v2"
    finally:
        node_net.stop_node_net(nodes)


# -- the mempool WAL ------------------------------------------------------------------------


def test_the_mempool_wal_holds_each_admitted_tx_as_the_reference_s(tmp_path):
    txs = [b"w1=1", b"w2=2", b"w1=1", b"w3=3"]  # the repeat is TxInCacheError
    out = {}
    for name, mp_cls, grp_cls, conn_cls, creator, app_cls, cache_err in (
            ("port", Mempool, Group, MultiAppConn, LocalClientCreator, KVStoreApp,
             TxInCacheError),
            ("ref", RMempool, RGroup, RMultiAppConn, RLocalClientCreator, RKVStoreApp,
             Exception)):
        conn = conn_cls(creator(app_cls()))
        conn.start()
        wal = grp_cls(str(tmp_path / name / "mempool.wal"))
        mp = mp_cls(conn.mempool, wal_group=wal)
        for tx in txs:
            try:
                mp.check_tx(tx)
            except cache_err:
                pass
        conn.stop()
        with open(tmp_path / name / "mempool.wal", "rb") as f:
            out[name] = f.read()
    assert out["port"] == out["ref"] == b"w1=1\nw2=2\nw3=3\n"


def test_the_node_s_mempool_writes_its_wal_under_the_home(tmp_path):
    conn = MultiAppConn(LocalClientCreator(KVStoreApp()))
    conn.start()
    try:
        cfg = MempoolConfig(wal_path="data/mempool.wal/wal")
        mp = verify_root.mempool(cfg, conn, None, device="cpu", root_dir=str(tmp_path)).mempool
        mp.check_tx(b"home=1")
        with open(tmp_path / "data" / "mempool.wal" / "wal", "rb") as f:
            assert f.read() == b"home=1\n"
    finally:
        conn.stop()


@pytest.mark.parametrize("server_cls", [ABCIServer, RABCIServer], ids=["port", "reference"])
def test_a_remote_app_s_crash_in_a_block_is_a_proxy_app_conn_error(served, server_cls):
    """A socket app that raises on a DeliverTx: the block fails with the
    reference's ProxyAppConnError once EndBlock has flushed the pipeline."""
    def explode(self, req):
        raise RuntimeError("app exploded")

    base = KVStoreApp if server_cls is ABCIServer else RKVStoreApp
    app = type("Crashy", (base,), {"deliver_tx": explode})()
    conn = MultiAppConn(RemoteClientCreator(served(server_cls("tcp://127.0.0.1:0", app))))
    conn.start()
    try:
        doc, _ = make_genesis(1)
        st = state_from_genesis(doc)
        block = st.make_block(1, [b"a=1", b"b=2"], Commit(),
                              proposer_address=st.validators.get_proposer().address)
        with pytest.raises(ProxyAppConnError, match="DeliverTx failed: app exploded"):
            exec_block_on_proxy_app(conn.consensus, block, st.validators, MemDB(),
                                    logging.getLogger("test"))
    finally:
        conn.stop()
