"""The port's tx indexer (state/txindex/kv.py) and durable stores
(libs/db/kv.py: SQLiteDB, PrefixDB, new_db) against the reference's.

Every case of ``tests/test_txindex.py`` runs once on each package. An
index written by either package into a sqlite file reads in the other,
record for record, and both write the same rows for the same results. The
stores' cases run on both packages' ``MemDB``, ``SQLiteDB`` and
``PrefixDB`` with equal answers; ``new_db`` refuses the backends the port
does not have.
"""

import os
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu.abci import types as rabci
from tendermint_tpu.config import config as rconfig
from tendermint_tpu.libs.db import kv as rkv
from tendermint_tpu.state.txindex import kv as rtxindex
from tendermint_tpu.types import events as revents
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.config import config as pconfig
from tendermint_tpu_torch.libs.db import kv
from tendermint_tpu_torch.state.txindex import kv as txindex
from tendermint_tpu_torch.types import events

REF = SimpleNamespace(name="reference", abci=rabci, db=rkv, ix=rtxindex, events=revents,
                      config=rconfig)
PORT = SimpleNamespace(name="port", abci=abci, db=kv, ix=txindex, events=events,
                       config=pconfig)
PACKAGES = [REF, PORT]
by_package = pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)


def result(pkg, height, index, tx, tags=()):
    return pkg.ix.TxResult(
        height=height, index=index, tx=tx,
        result=pkg.abci.ResponseDeliverTx(
            code=0, tags=[pkg.abci.KVPair(key=k, value=v) for k, v in tags]))


STREAM = [(3, 0, b"x=1", [(b"app.kind", b"transfer")]),
          (4, 0, b"y=2", [(b"app.kind", b"mint"), (b"app.creator", b"alice")]),
          (4, 1, b"z=3", [(b"app.kind", b"transfer")]),
          (9, 5, b"w=4", [])]


@by_package
class TestKVTxIndexer:
    def test_index_get_roundtrip(self, pkg):
        ix = pkg.ix.KVTxIndexer(pkg.db.MemDB())
        r = result(pkg, 5, 0, b"a=1", tags=[(b"app.creator", b"alice")])
        ix.index(r)
        got = ix.get(r.hash())
        assert got is not None
        assert (got.height, got.index, got.tx) == (5, 0, b"a=1")
        assert got.result.code == 0
        assert ix.get(b"\x00" * 32) is None

    def test_search_by_tag_and_height(self, pkg):
        ix = pkg.ix.KVTxIndexer(pkg.db.MemDB())
        for h, i, tx, tags in STREAM[:3]:
            ix.index(result(pkg, h, i, tx, tags))
        assert [r.tx for r in ix.search("app.kind = 'transfer'")] == [b"x=1", b"z=3"]
        assert sorted(r.tx for r in ix.search("tx.height = 4")) == [b"y=2", b"z=3"]
        assert [r.tx for r in ix.search("app.kind = 'transfer' AND tx.height = 4")] == [b"z=3"]

    def test_search_by_hash(self, pkg):
        ix = pkg.ix.KVTxIndexer(pkg.db.MemDB())
        r = result(pkg, 7, 2, b"q=9")
        ix.index(r)
        assert [x.tx for x in ix.search(f"tx.hash = '{r.hash().hex()}'")] == [b"q=9"]


@by_package
class TestNullTxIndexer:
    def test_disabled_backend_stores_nothing(self, pkg):
        ix = pkg.ix.NullTxIndexer()
        r = result(pkg, 1, 0, b"k=v")
        ix.index(r)
        assert ix.get(r.hash()) is None
        assert ix.search("tx.height = 1") == []


@by_package
class TestConfigSelection:
    @pytest.mark.parametrize("which", ["kv", "null"])
    def test_node_backend_branch(self, pkg, which):
        """The node picks the backend off config.tx_index.indexer (kv by
        default, anything else null)."""
        cfg = pkg.config.default_config()
        assert cfg.tx_index.indexer == "kv"
        cfg.tx_index.indexer = which
        indexer = (pkg.ix.KVTxIndexer(pkg.db.MemDB()) if cfg.tx_index.indexer == "kv"
                   else pkg.ix.NullTxIndexer())
        assert isinstance(indexer, pkg.ix.KVTxIndexer if which == "kv" else pkg.ix.NullTxIndexer)


@by_package
class TestIndexerService:
    def test_indexes_from_event_bus(self, pkg):
        bus = pkg.events.EventBus()
        bus.start()
        ix = pkg.ix.KVTxIndexer(pkg.db.MemDB())
        svc = pkg.ix.TxIndexerService(ix, bus)
        svc.start()
        try:
            bus.publish_event_tx(9, 0, b"tx-bytes", pkg.abci.ResponseDeliverTx(code=0, tags=[]))
            r = result(pkg, 9, 0, b"tx-bytes")
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and ix.get(r.hash()) is None:
                time.sleep(0.02)
            got = ix.get(r.hash())
            assert got is not None and got.height == 9
        finally:
            svc.stop()
            bus.stop()


def test_both_packages_write_the_same_rows(tmp_path):
    rows = {}
    for pkg in PACKAGES:
        db = pkg.db.MemDB()
        ix = pkg.ix.KVTxIndexer(db)
        for h, i, tx, tags in STREAM:
            ix.index(result(pkg, h, i, tx, tags))
        rows[pkg.name] = list(db.iterator())
    assert rows["reference"] == rows["port"] and len(rows["port"]) == 4 + 4 + 4


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference-to-port", "port-to-reference"])
def test_an_index_written_by_one_package_reads_in_the_other(writer, reader, tmp_path):
    wdb = writer.db.SQLiteDB("tx_index", str(tmp_path))
    wix = writer.ix.KVTxIndexer(wdb)
    for h, i, tx, tags in STREAM:
        wix.index(result(writer, h, i, tx, tags))
    wdb.close()
    rdb = reader.db.new_db("tx_index", "sqlite", str(tmp_path))
    rix = reader.ix.KVTxIndexer(rdb)
    try:
        for h, i, tx, tags in STREAM:
            got = rix.get(result(reader, h, i, tx).hash())
            assert (got.height, got.index, got.tx) == (h, i, tx)
            assert [(t.key, t.value) for t in got.result.tags] == tags
        assert [r.tx for r in rix.search("app.kind = 'transfer'")] == [b"x=1", b"z=3"]
        assert [r.tx for r in rix.search("app.creator = 'alice' AND tx.height = 4")] == [b"y=2"]
    finally:
        rdb.close()


def _exercise(db):
    db.set(b"b", b"2")
    db.set(b"a", b"1")
    db.set_sync(b"c", b"3")
    batch = db.batch()
    batch.set(b"d", b"4").delete(b"a").set(b"e\xff", b"5")
    batch.write()
    db.delete(b"zz")  # absent: no error
    return (db.get(b"a"), db.get(b"d"), db.has(b"c"), db.has(b"a"),
            list(db.iterator()), list(db.iterator(b"c", b"e")),
            list(db.iterator(None, b"d", reverse=True)), list(db.iterator(b"c", reverse=True)))


@pytest.mark.parametrize("backend", ["memdb", "sqlite", "prefix"])
def test_the_stores_answer_as_the_reference_s(backend, tmp_path):
    out = {}
    for pkg in PACKAGES:
        d = str(tmp_path / pkg.name)
        if backend == "prefix":
            inner = pkg.db.MemDB()
            inner.set(b"other", b"x")
            inner.set(b"p/\xff", b"y")
            db = pkg.db.PrefixDB(inner, b"p/")
        else:
            db = pkg.db.new_db("store", backend, d)
        out[pkg.name] = _exercise(db)
        if backend == "sqlite":  # durable: a new connection reads the same
            db.close()
            again = pkg.db.SQLiteDB("store", d)
            assert list(again.iterator()) == out[pkg.name][4]
            again.close()
    assert out["reference"] == out["port"]


def test_new_db_refuses_the_unported_backends(tmp_path):
    """Every backend is ported: ``remote`` is a store on the server at
    ``dir`` (or, without ``grpcio``, an ``ImportError`` naming it)."""
    from tendermint_tpu_torch.libs.db import remote
    from tendermint_tpu_torch.libs.db.fsdb import FSDB

    if remote._GRPC_ERR is not None:
        with pytest.raises(ImportError, match="grpcio"):
            kv.new_db("x", "remote", "127.0.0.1:1")
    else:
        srv = remote.RemoteDBServer("127.0.0.1:0", dir=str(tmp_path / "srv"))
        srv.start()
        try:
            db = kv.new_db("x", "remote", f"127.0.0.1:{srv.bound_port}")
            assert isinstance(db, remote.RemoteDB)
            db.set(b"k", b"v")
            assert db.get(b"k") == b"v"
            db.close()
        finally:
            srv.stop()
    # fsdb is ported: a file a key under <dir>/<name>.db, as the reference's
    fs = kv.new_db("fs", "fsdb", str(tmp_path))
    assert isinstance(fs, FSDB) and os.path.isdir(os.path.join(str(tmp_path), "fs.db"))
    with pytest.raises(ValueError, match="unknown db backend"):
        kv.new_db("x", "nope", str(tmp_path))
    assert isinstance(kv.new_db("x", "goleveldb", str(tmp_path)), kv.SQLiteDB)
