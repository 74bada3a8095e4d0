"""The periphery of the command line: WAL replay (consensus/replay_file.py),
the light-client proxy command (lite/proxy.run_lite_proxy) and the
file-per-key store (libs/db/fsdb.py), against the reference's.

* ``TestReplayFile``: a port node's WAL replays from its home; each
  package's ``run_replay_file`` on a copy of the other's home ends at the
  same height, round and step and replays as many messages as on its own.
* ``TestLiteProxy``: the reference's ``tests/test_periphery.py::TestLiteProxy``
  restated on a port node; ``run_lite_proxy`` (the ``lite`` command, in a
  process of its own) serves verified commits over HTTP, exits 0 on
  SIGTERM, and its sqlite trust store under ``<home>/data`` reopens with the
  trust it kept.
* ``TestDB``: the reference's ``tests/test_libs.py`` ``TestDB`` fsdb cases
  (``:49``, ``:87``, ``:102``) on the port's ``FSDB``, and a directory one
  package writes read by the other.

Exact: heights, bytes and verdicts compare equal.
"""

import http.client
import json
import os
import re
import shutil
import signal
import subprocess
import sys

import pytest

from tendermint_tpu.config import config as rconfig
from tendermint_tpu.consensus import replay_file as rreplay_file
from tendermint_tpu.libs.db.fsdb import FSDB as RFSDB
from tendermint_tpu_torch.config import config as pconfig
from tendermint_tpu_torch.consensus import replay_file
from tendermint_tpu_torch.libs.db.fsdb import FSDB
from tendermint_tpu_torch.libs.db.kv import MemDB, new_db
from tendermint_tpu_torch.lite import DBProvider, LiteError
from tendermint_tpu_torch.lite.provider import ProviderError
from tendermint_tpu_torch.lite.proxy import LiteProxy
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.testutil import cli_net, node_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 30.0


@pytest.fixture(autouse=True)
def _clean():
    yield
    verify_root.reset_verify()


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["TM_BATCH_VERIFIER"] = "host"
    return env


def _port_home(home: str, height: int = 3) -> None:
    """A port single-validator node on sqlite with its WAL, run to
    ``height`` and stopped."""
    node = node_net.make_single_node(home, chain_id="replay-chain", db_backend="sqlite")
    node_net.install_host_verify()
    node.start()
    try:
        assert node_net.wait_for(lambda: node.block_store.height() >= height, DEADLINE)
    finally:
        node.stop()


def _final(out: str):
    m = re.search(r"replayed (\d+) WAL messages; final: h=(\d+) r=(\d+) step=(\w+)", out)
    assert m, out[-500:]
    return int(m.group(1)), int(m.group(2)), int(m.group(3)), m.group(4)


def _replay(pkg: str, home: str, capsys):
    """``run_replay_file`` of ``pkg`` over ``home``: (messages, height,
    round, step)."""
    if pkg == "port":
        cfg = pconfig.default_config().set_root(home)
        cfg.consensus = pconfig.test_config().consensus
        mod, kw = replay_file, {"device": "cpu"}
    else:
        cfg = rconfig.default_config()
        cfg.set_root(home)
        cfg.consensus = rconfig.test_config().consensus
        mod, kw = rreplay_file, {}
    cfg.base.proxy_app = "kvstore"
    cfg.p2p.laddr = ""
    cfg.consensus.wal_path = "data/cs.wal/wal"
    capsys.readouterr()
    n = mod.run_replay_file(cfg, console=False, **kw)
    got = _final(capsys.readouterr().out)
    assert got[0] == n > 0
    return got


class TestReplayFile:
    def test_a_port_node_s_wal_replays_to_its_recorded_height(self, tmp_path, capsys,
                                                             monkeypatch):
        monkeypatch.setenv("TM_BATCH_VERIFIER", "host")
        home = str(tmp_path / "port")
        _port_home(home)
        from tendermint_tpu_torch.blockchain.store import BlockStore

        db = new_db("blockstore", "sqlite", os.path.join(home, "data"))
        top = BlockStore(db).height()
        db.close()
        copies = {}
        for pkg in ("port", "reference"):
            copies[pkg] = str(tmp_path / f"copy-{pkg}")
            shutil.copytree(home, copies[pkg])
        got = {pkg: _replay(pkg, copies[pkg], capsys) for pkg in copies}
        assert got["port"] == got["reference"]
        assert got["port"][1] >= top + 1  # the height the node was at, or past it

    def test_the_port_replays_a_reference_node_s_home(self, tmp_path, capsys, monkeypatch):
        monkeypatch.setenv("TM_BATCH_VERIFIER", "host")
        home = str(tmp_path / "ref")
        run = subprocess.run([sys.executable, os.path.join(REPO, "tests", "crash_runner.py"),
                              home, "3"], capture_output=True, text=True, cwd=REPO,
                             env=_env(), timeout=150)
        assert run.returncode == 0, run.stderr[-1500:]
        copies = {}
        for pkg in ("port", "reference"):
            copies[pkg] = str(tmp_path / f"copy-{pkg}")
            shutil.copytree(home, copies[pkg])
        got = {pkg: _replay(pkg, copies[pkg], capsys) for pkg in copies}
        assert got["port"] == got["reference"]

    def test_the_console_steps_and_quits(self, tmp_path, capsys, monkeypatch):
        monkeypatch.setenv("TM_BATCH_VERIFIER", "host")
        home = str(tmp_path / "port")
        _port_home(home, height=2)
        answers = iter(["locate", "next 2", "", "quit"])
        monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
        cfg = pconfig.default_config().set_root(home)
        cfg.base.proxy_app = "kvstore"
        cfg.p2p.laddr = ""
        assert replay_file.run_replay_file(cfg, console=True, device="cpu") == 3
        assert "locked_round=" in capsys.readouterr().out


# -- the light-client proxy ------------------------------------------------------------------


@pytest.fixture()
def live_node(tmp_path):
    node = node_net.make_single_node(str(tmp_path / "n"), chain_id="lite-proxy-chain")
    node_net.install_host_verify()
    node.start()
    try:
        assert node_net.wait_for(lambda: node.block_store.height() >= 4, DEADLINE)
        yield node
    finally:
        node.stop()


class TestLiteProxy:
    def test_proxy_serves_verified_commits(self, live_node):
        """tests/test_periphery.py::TestLiteProxy restated on a port node."""
        node = live_node
        addr = f"tcp://127.0.0.1:{node.rpc_server.bound_port}"
        proxy = LiteProxy("lite-proxy-chain", addr)
        st = proxy.status()
        assert st["verified"] and st["latest_block_height"] >= 2
        cm = proxy.commit(2)
        assert cm["verified"] and cm["header"]["height"] == 2
        with pytest.raises((LiteError, ProviderError)):  # the wrong chain
            LiteProxy("other-chain", addr).status()
        # the operator's root of trust: the right pinned hash verifies ...
        h2 = node.block_store.load_block_meta(2).block_id.hash
        assert LiteProxy("lite-proxy-chain", addr, trusted_height=2,
                         trusted_hash=h2).status()["verified"]
        # ... a wrong one aborts the seeding
        with pytest.raises(ProviderError):
            LiteProxy("lite-proxy-chain", addr, trusted_height=2,
                      trusted_hash=b"\x13" * 32).status()
        # a pin against an existing store: a matching entry passes, a
        # missing one fails
        shared = MemDB()
        LiteProxy("lite-proxy-chain", addr, trust_db=shared).status()
        h1 = node.block_store.load_block_meta(1).block_id.hash
        assert LiteProxy("lite-proxy-chain", addr, trust_db=shared, trusted_height=1,
                         trusted_hash=h1).status()["verified"]
        with pytest.raises(ProviderError):
            LiteProxy("lite-proxy-chain", addr, trust_db=shared, trusted_height=3,
                      trusted_hash=b"\x13" * 32).status()

    def test_run_lite_proxy_serves_and_its_trust_store_reopens(self, live_node, tmp_path):
        """The ``lite`` command (``run_lite_proxy``) in a process of its own,
        twice over one home: it serves certified commits, and the second run
        reopens the sqlite trust store the first one filled."""
        node = live_node
        addr = f"tcp://127.0.0.1:{node.rpc_server.bound_port}"
        home = str(tmp_path / "lite")
        env = dict(os.environ, TM_BATCH_VERIFIER="host", PYTHONPATH=REPO)
        kept = {}
        for run in range(2):
            port = cli_net.free_port()
            proc = subprocess.Popen(
                cli_net.CLI + ["--home", home, "lite", "--chain-id", "lite-proxy-chain",
                               "--node", addr, "--laddr", f"tcp://127.0.0.1:{port}",
                               "--device", "cpu"],
                cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            try:
                assert cli_net.wait_for(lambda: _get(port, "/frontend_stats") is not None,
                                        DEADLINE)
                for h in (1, 2, 3):
                    got = _get(port, f"/commit?height={h}")["result"]
                    meta = node.block_store.load_block_meta(h)
                    assert got["verified"] and got["commit"]["block_id_hash"] == (
                        meta.block_id.hash.hex().upper())
                assert "error" in _get(port, "/commit?height=999", ok=False)
                proc.send_signal(signal.SIGTERM)
                assert proc.wait(10) == 0
            finally:
                if proc.poll() is None:
                    proc.kill()
            # the trust store under <home>/data: the first run's trust, kept
            db = new_db("lite_trust", "sqlite", os.path.join(home, "data"))
            kept[run] = DBProvider(db).latest_full_commit("lite-proxy-chain", 1, 1 << 60).height
            db.close()
        assert kept[0] >= 3 and kept[1] >= kept[0]


def _get(port: int, path: str, ok: bool = True):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        body = json.loads(r.read())
    except OSError:
        return None
    finally:
        conn.close()
    assert (r.status == 200) == ok, body
    return body


# -- fsdb (tests/test_libs.py TestDB's fsdb cases restated) ----------------------------------


class TestDB:
    def test_crud_and_iteration(self, tmp_path):
        db = new_db("test", "fsdb", str(tmp_path))
        db.set(b"b", b"2")
        db.set(b"a", b"1")
        db.set(b"c", b"3")
        assert db.get(b"b") == b"2"
        assert db.get(b"zz") is None
        db.delete(b"b")
        assert not db.has(b"b")
        assert list(db.iterator()) == [(b"a", b"1"), (b"c", b"3")]
        assert list(db.iterator(reverse=True)) == [(b"c", b"3"), (b"a", b"1")]
        db.set(b"b", b"2")
        assert list(db.iterator(start=b"b")) == [(b"b", b"2"), (b"c", b"3")]
        assert list(db.iterator(end=b"b")) == [(b"a", b"1")]
        db.batch().set(b"x", b"9").delete(b"a").write()
        assert db.get(b"x") == b"9" and db.get(b"a") is None

    def test_fsdb_durability_and_odd_keys(self, tmp_path):
        """fsdb.go: a file a key, escaped names, survives a reopen."""
        db = FSDB(str(tmp_path / "fs"))
        odd = b"a/b \x00%.key"  # path separators, spaces, NUL, percent
        db.set_sync(odd, b"v1")
        db.set(b"plain", b"v2")
        db.set(b"..", b"dots")
        assert db.get(odd) == b"v1"
        db2 = FSDB(str(tmp_path / "fs"))  # reopen: the files are the store
        assert db2.get(odd) == b"v1" and db2.get(b"plain") == b"v2"
        assert [k for k, _ in db2.iterator()] == sorted([odd, b"plain", b".."])
        db2.delete(odd)
        assert not db2.has(odd)

    def test_fsdb_key_named_like_tmp_file(self, tmp_path):
        """Writing key b'foo' must not touch key b'foo.tmp'."""
        db = FSDB(str(tmp_path / "fs"))
        db.set(b"foo.tmp", b"v1")
        db.set(b"foo", b"v2")
        assert db.get(b"foo.tmp") == b"v1"
        assert db.get(b"foo") == b"v2"
        assert sorted(k for k, _ in db.iterator()) == [b"foo", b"foo.tmp"]
        assert db.stats()["keys"] == "2"

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_a_directory_one_package_writes_the_other_reads(self, tmp_path, writer):
        w_cls, r_cls = (FSDB, RFSDB) if writer == "port" else (RFSDB, FSDB)
        keys = [b"k", b"a/b", b"..", b"%!tmp", b"\xff\x00", b"x" * 40]
        w, other = w_cls(str(tmp_path / "fs")), r_cls(str(tmp_path / "fs-other"))
        for i, k in enumerate(keys):
            w.set(k, b"v%d" % i)
            other.set(k, b"v%d" % i)
        # the names on disk are the same scheme's
        assert sorted(os.listdir(tmp_path / "fs")) == sorted(os.listdir(tmp_path / "fs-other"))
        r = r_cls(str(tmp_path / "fs"))
        assert list(r.iterator()) == list(w.iterator())
        assert [r.get(k) for k in keys] == [b"v%d" % i for i in range(len(keys))]
