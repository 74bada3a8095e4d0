"""ABCI over gRPC and the gRPC BroadcastAPI (abci/grpc.py), the reference's
``tests/test_abci_grpc.py`` restated on the port, and the port against the
reference both ways: a port ``GRPCClient`` against a reference
``GRPCServer`` and the reverse, each answering as a ``LocalClient`` of the
same app; the BroadcastAPI of a port ``Node`` at ``rpc.grpc_laddr`` through
either package's ``broadcast_tx_via_grpc``. Exact: responses compare as
their JSON bytes. Skips only where ``grpcio`` is absent.
"""

import pytest

grpc = pytest.importorskip("grpc")

from tendermint_tpu.abci import grpc as rgrpc  # noqa: E402
from tendermint_tpu.abci import types as rabci  # noqa: E402
from tendermint_tpu.abci.examples.kvstore import KVStoreApp as RKVStoreApp  # noqa: E402
from tendermint_tpu_torch.abci import types as abci  # noqa: E402
from tendermint_tpu_torch.abci.client import ABCIClientError, LocalClient  # noqa: E402
from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp  # noqa: E402
from tendermint_tpu_torch.abci.grpc import (  # noqa: E402
    BroadcastAPIServer,
    GRPCClient,
    GRPCServer,
    broadcast_tx_via_grpc,
)
from tendermint_tpu_torch.node import verify_root  # noqa: E402
from tendermint_tpu_torch.testutil import node_net  # noqa: E402

DEADLINE = 30.0


class TestABCIOverGRPC:
    @pytest.fixture()
    def pair(self):
        srv = GRPCServer("127.0.0.1:0", KVStoreApp())
        srv.start()
        client = GRPCClient(f"127.0.0.1:{srv.bound_port}")
        client.start()
        yield client
        client.stop()
        srv.stop()

    def test_echo_info(self, pair):
        assert pair.echo_sync(abci.RequestEcho(message="over-grpc")).message == "over-grpc"
        assert pair.info_sync(abci.RequestInfo()).last_block_height == 0

    def test_deliver_commit_query_roundtrip(self, pair):
        assert pair.deliver_tx_sync(abci.RequestDeliverTx(tx=b"g=h")).code == 0
        assert pair.commit_sync(abci.RequestCommit()).data
        assert pair.query_sync(abci.RequestQuery(data=b"g", path="/store")).value == b"h"

    def test_check_tx_and_flush(self, pair):
        assert pair.check_tx_sync(abci.RequestCheckTx(tx=b"x=1")).code == 0
        pair.flush_sync()

    def test_multi_app_conn_over_grpc(self):
        """The node's proxy layer speaks gRPC when given grpc:// addresses."""
        from tendermint_tpu_torch.proxy.app_conn import MultiAppConn, RemoteClientCreator

        srv = GRPCServer("127.0.0.1:0", KVStoreApp())
        srv.start()
        conn = MultiAppConn(RemoteClientCreator(f"grpc://127.0.0.1:{srv.bound_port}"))
        conn.start()
        try:
            assert conn.query.info_sync(abci.RequestInfo()).version == "0.1.0"
        finally:
            conn.stop()
            srv.stop()


REQUESTS = [
    abci.RequestEcho(message="x"),
    abci.RequestInfo(),
    abci.RequestSetOption(key="k", value="v"),
    abci.RequestInitChain(chain_id="g"),
    abci.RequestBeginBlock(header=abci.ABCIHeader(chain_id="g", height=1)),
    abci.RequestCheckTx(tx=b"a=1", sig_verified=True),
    abci.RequestDeliverTx(tx=b"a=1"),
    abci.RequestEndBlock(height=1),
    abci.RequestCommit(),
    abci.RequestQuery(data=b"a", path="/store"),
    abci.RequestListSnapshots(),
    abci.RequestLoadSnapshotChunk(height=1, format=1, chunk=0),
]


@pytest.mark.parametrize("direction", ["port_client_ref_server", "ref_client_port_server"])
def test_the_packages_speak_grpc_to_each_other(direction):
    local = LocalClient(KVStoreApp())
    if direction == "port_client_ref_server":
        srv, cli_cls, conv = rgrpc.GRPCServer("127.0.0.1:0", RKVStoreApp()), GRPCClient, None
    else:
        srv, cli_cls, conv = GRPCServer("127.0.0.1:0", KVStoreApp()), rgrpc.GRPCClient, True
    srv.start()
    client = cli_cls(f"127.0.0.1:{srv.bound_port}")
    client.start()
    try:
        for req in REQUESTS:
            want = abci.msg_to_json(local.request_sync(req))
            sent = rabci.msg_from_json(abci.msg_to_json(req)) if conv else req
            got = client.request_sync(sent)
            enc = rabci.msg_to_json(got) if conv else abci.msg_to_json(got)
            assert enc == want, type(req).__name__
        client.flush_sync()
    finally:
        client.stop()
        srv.stop()


@pytest.fixture()
def _reset():
    yield
    verify_root.reset_verify()


class TestBroadcastAPI:
    @pytest.mark.parametrize("helper", ["port", "reference"])
    def test_grpc_broadcast_tx_commits(self, tmp_path, _reset, helper):
        """A port node's BroadcastAPI at rpc.grpc_laddr: a tx through either
        package's broadcast_tx_via_grpc passes CheckTx and commits."""
        cfg = node_net.node_config(None, "grpc")
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
        node = node_net.make_single_node(str(tmp_path / "n"), chain_id="grpc-chain", config=cfg)
        node_net.install_host_verify()
        node.start()
        try:
            assert node.grpc_broadcast.is_running
            fn = broadcast_tx_via_grpc if helper == "port" else rgrpc.broadcast_tx_via_grpc
            tx = b"grpc=" + helper.encode()
            res = fn(f"127.0.0.1:{node.grpc_broadcast.bound_port}", tx)
            assert res["check_tx"]["code"] == 0
            assert node_net.wait_for(lambda: node_net.committed_in(node, lambda t: t == tx)
                                     is not None, DEADLINE)
        finally:
            node.stop()
        assert not node.grpc_broadcast.is_running

    def test_the_server_takes_a_node(self, tmp_path, _reset):
        node = node_net.make_single_node(str(tmp_path / "n"))
        node_net.install_host_verify()
        node.start()
        try:
            srv = BroadcastAPIServer("tcp://127.0.0.1:0", node)
            srv.start()
            assert srv.addr == "127.0.0.1:0" and srv.bound_port > 0
            srv.stop()
        finally:
            node.stop()


class TestAppCrashOverGRPC:
    def test_app_exception_raises_abci_client_error(self):
        class CrashyApp(KVStoreApp):
            def deliver_tx(self, req):
                raise RuntimeError("app exploded")

        srv = GRPCServer("127.0.0.1:0", CrashyApp())
        srv.start()
        client = GRPCClient(f"127.0.0.1:{srv.bound_port}")
        client.start()
        try:
            with pytest.raises(ABCIClientError, match="app exploded"):
                client.deliver_tx_sync(abci.RequestDeliverTx(tx=b"x"))
            # the connection stays usable after an app's error
            assert client.echo_sync(abci.RequestEcho(message="ok")).message == "ok"
        finally:
            client.stop()
            srv.stop()


def test_a_missing_grpcio_raises_where_a_transport_is_built(monkeypatch):
    from tendermint_tpu_torch.abci import grpc as pgrpc

    monkeypatch.setattr(pgrpc, "_GRPC_ERR", ImportError("no module named grpc"))
    for build in (lambda: GRPCServer("127.0.0.1:0", KVStoreApp()),
                  lambda: GRPCClient("127.0.0.1:1"),
                  lambda: broadcast_tx_via_grpc("127.0.0.1:1", b"x")):
        with pytest.raises(ImportError, match="grpcio"):
            build()
