"""The port's remote store (``libs/db/remote.py``) against the reference's.

* ``tests/test_libs.py``'s three remote-store cases run once on each
  package: the whole DB interface over gRPC with named stores, the name
  checks and the backend pin; the bearer token; TLS.
* Across the packages: a port client against a reference server and a
  reference client against a port server make the same calls with the same
  answers; both refuse what the other refuses.
* ``new_db``'s ``remote`` backend is a ``RemoteDB`` on the server at
  ``dir``, and a port ``Node`` whose ``db_backend`` is ``remote`` keeps its
  stores on a ``RemoteDBServer`` and commits.
"""

import os
from types import SimpleNamespace

import grpc
import pytest

from tendermint_tpu.libs.db import remote as r_remote
from tendermint_tpu_torch.config import config as pconfig
from tendermint_tpu_torch.libs.db import kv, remote
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.testutil import node_net

from tests.test_libs import _self_signed_cert

REF = SimpleNamespace(name="reference", remote=r_remote)
PORT = SimpleNamespace(name="port", remote=remote)
PACKAGES = [REF, PORT]
by_pkg = pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)


@by_pkg
class TestRemoteDB:
    def test_remotedb_over_grpc(self, pkg, tmp_path):
        srv = pkg.remote.RemoteDBServer("127.0.0.1:0", dir=str(tmp_path))
        srv.start()
        try:
            addr = f"127.0.0.1:{srv.bound_port}"
            db = pkg.remote.RemoteDB(addr, "t1", "memdb")
            db.set(b"b", b"2")
            db.set_sync(b"a", b"1")
            db.set(b"c", b"3")
            assert db.get(b"b") == b"2" and db.get(b"zz") is None
            assert db.has(b"a") and not db.has(b"zz")
            db.delete(b"b")
            assert list(db.iterator()) == [(b"a", b"1"), (b"c", b"3")]
            assert list(db.iterator(reverse=True)) == [(b"c", b"3"), (b"a", b"1")]
            assert list(db.iterator(start=b"b")) == [(b"c", b"3")]
            db.apply_batch([("set", b"x", b"9"), ("delete", b"a", b"")])
            assert db.get(b"x") == b"9" and db.get(b"a") is None
            assert int(db.stats()["keys"]) == 2
            db2 = pkg.remote.RemoteDB(addr, "t2", "memdb")
            assert db2.get(b"x") is None
            with pytest.raises(grpc.RpcError):
                pkg.remote.RemoteDB(addr, "../../evil", "fsdb")
            with pytest.raises(grpc.RpcError):
                pkg.remote.RemoteDB(addr, "t1", "fsdb")
            db3 = pkg.remote.RemoteDB(addr, "t1", "memdb")
            assert db3.get(b"x") == b"9"
            db.close(), db2.close(), db3.close()
        finally:
            srv.stop()

    def test_remotedb_token_auth(self, pkg, tmp_path):
        srv = pkg.remote.RemoteDBServer("127.0.0.1:0", dir=str(tmp_path), auth_token="s3cret")
        srv.start()
        try:
            addr = f"127.0.0.1:{srv.bound_port}"
            with pytest.raises(grpc.RpcError) as ei:
                pkg.remote.RemoteDB(addr, "t", "memdb")
            assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
            with pytest.raises(grpc.RpcError) as ei:
                pkg.remote.RemoteDB(addr, "t", "memdb", auth_token="wrong")
            assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
            db = pkg.remote.RemoteDB(addr, "t", "memdb", auth_token="s3cret")
            db.set(b"k", b"v")
            assert db.get(b"k") == b"v"
            db.close()
        finally:
            srv.stop()

    def test_remotedb_tls(self, pkg, tmp_path):
        cert, key = _self_signed_cert(tmp_path, "127.0.0.1")
        srv = pkg.remote.RemoteDBServer("127.0.0.1:0", dir=str(tmp_path), auth_token="tok",
                                        tls_cert=cert, tls_key=key)
        srv.start()
        try:
            addr = f"127.0.0.1:{srv.bound_port}"
            db = pkg.remote.RemoteDB(addr, "t", "memdb", auth_token="tok", tls_ca=cert)
            db.set(b"k", b"v")
            assert db.get(b"k") == b"v"
            db.close()
            with pytest.raises(Exception):
                pkg.remote.RemoteDB(addr, "t", "memdb", auth_token="tok", timeout=3.0)
        finally:
            srv.stop()


def _session(pkg, addr, name):
    """One client session: every DB call and what it answered; the
    refusals as their gRPC status codes."""
    out = []
    db = pkg.remote.RemoteDB(addr, name, "sqlite", auth_token="t")
    try:
        for i in range(20):
            db.set(b"k%02d" % i, b"v%d" % (i * i))
        db.set_sync(b"a", b"\x00\xff")
        db.delete(b"k03")
        db.delete_sync(b"k05")
        out.append(db.get(b"k04"))
        out.append(db.get(b"k03"))
        out.append((db.has(b"a"), db.has(b"zz")))
        out.append(list(db.iterator()))
        out.append(list(db.iterator(b"k10", b"k15", reverse=True)))
        db.apply_batch([("set", b"b", b"1"), ("delete", b"k07", None), ("set", b"", b"e")])
        out.append(list(db.iterator(end=b"k01")))
        out.append(sorted(db.stats()))
    finally:
        db.close()
    for bad in (("../x", "memdb"), (name, "memdb")):
        with pytest.raises(grpc.RpcError) as ei:
            pkg.remote.RemoteDB(addr, bad[0], bad[1], auth_token="t")
        out.append((ei.value.code(), ei.value.details()))
    return out


@pytest.mark.parametrize("client,server", [(PORT, REF), (REF, PORT)],
                         ids=["port_client_reference_server", "reference_client_port_server"])
def test_a_client_of_one_package_works_against_a_server_of_the_other(tmp_path, client, server):
    runs = []
    for c, s in ((client, server), (REF, REF)):
        d = tmp_path / f"{c.name}-{s.name}"
        d.mkdir()
        srv = s.remote.RemoteDBServer("127.0.0.1:0", dir=str(d), auth_token="t")
        srv.start()
        try:
            runs.append(_session(c, f"127.0.0.1:{srv.bound_port}", "store"))
        finally:
            srv.stop()
        assert os.path.exists(d / "store.db")  # the server placed the sqlite store
    assert runs[0] == runs[1]


def test_new_db_remote_is_a_store_on_the_server(tmp_path):
    srv = remote.RemoteDBServer("127.0.0.1:0", dir=str(tmp_path))
    srv.start()
    try:
        addr = f"127.0.0.1:{srv.bound_port}"
        db = kv.new_db("state", "remote", addr)
        assert isinstance(db, remote.RemoteDB) and db.name == "state"
        db.set(b"k", b"v")
        other = kv.new_db("state", "remote", f"tcp://{addr}")
        assert other.get(b"k") == b"v"
        db.close(), other.close()
        assert srv._backends == {"state": kv.REMOTE_BACKEND}
    finally:
        srv.stop()


def test_without_grpcio_the_remote_store_names_it(monkeypatch):
    monkeypatch.setattr(remote, "_GRPC_ERR", ImportError("No module named 'grpc'"))
    with pytest.raises(ImportError, match="grpcio"):
        kv.new_db("x", "remote", "127.0.0.1:1")
    with pytest.raises(ImportError, match="grpcio"):
        remote.RemoteDBServer("127.0.0.1:0")


def test_a_port_node_keeps_its_stores_on_a_remote_server(tmp_path):
    srv = remote.RemoteDBServer("127.0.0.1:0", dir=str(tmp_path / "server"))
    srv.start()
    node = None
    try:
        cfg = pconfig.test_config()
        cfg.base.db_dir = f"127.0.0.1:{srv.bound_port}"
        node = node_net.make_single_node(str(tmp_path / "home"), config=cfg, db_backend="remote",
                                         device="cpu")
        assert node.config.base.db_path() == cfg.base.db_dir
        assert all(isinstance(db, remote.RemoteDB) for db in node._dbs)
        node_net.install_host_verify()
        node.start()
        assert node_net.wait_for(lambda: node.block_store.height() >= 3, 60.0)
        assert {"blockstore", "state", "tx_index"} <= set(srv._backends)
        assert os.path.exists(tmp_path / "server" / "blockstore.db")
    finally:
        if node is not None:
            node_net.stop_node_net([node])
        verify_root.reset_verify()
        srv.stop()
