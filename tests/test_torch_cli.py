"""The port's command line (cmd/tendermint.py) against the reference's.

* Each command through the port's ``main([...])`` and the reference's on
  copies of one home directory prints the same (home paths aside) and
  leaves the same files: ``version``, ``show_validator``, ``show_node_id``,
  ``gen_node_key``, ``unsafe_reset_priv_validator``, ``unsafe_reset_all``,
  ``gen_validator``'s shape, ``lite``'s flag checks.
* ``init`` and ``testnet`` (all three address modes) write files that the
  other package loads: ``priv_validator.json``, ``node_key.json``,
  ``genesis.json``, ``peers.txt``.
* ``node`` without ``--device cpu`` exits non-zero naming
  ``NoCudaDeviceError`` within 30 s and leaves no port listening;
  ``TM_BATCH_VERIFIER=host`` with ``--device cuda`` is refused by ``node``,
  ``lite``, ``replay`` and ``replay_console``; ``probe_upnp`` with no UPnP
  gateway prints and exits as the reference's.
* ``node --device cpu`` with ``TM_BATCH_VERIFIER=host`` commits, and
  SIGTERM or SIGINT stops it with exit code 0.

Exact: output and files compare equal.
"""

import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from tendermint_tpu.cmd import tendermint as rcli
from tendermint_tpu.p2p.key import NodeKey as RNodeKey
from tendermint_tpu.privval.file_pv import FilePV as RFilePV
from tendermint_tpu.types.genesis import GenesisDoc as RGenesisDoc
from tendermint_tpu_torch.cmd import tendermint as cli
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.privval.file_pv import FilePV
from tendermint_tpu_torch.testutil import cli_net
from tendermint_tpu_torch.types.genesis import GenesisDoc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "tendermint_tpu_torch.cmd.tendermint"]


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv_of, homes, capsys):
    """The port's and the reference's main on their own copy of a home:
    (rc, stdout with the home's path replaced by HOME) for each."""
    got = {}
    for name, main in (("port", cli.main), ("ref", rcli.main)):
        rc, out, _ = _run(main, argv_of(homes[name]), capsys)
        got[name] = (rc, out.replace(homes[name], "HOME"))
    return got


@pytest.fixture()
def homes(tmp_path, capsys):
    """One home written by the reference's init (a chain id, a signed
    height in the FilePV, data in data/), copied for each package."""
    src = str(tmp_path / "src")
    assert rcli.main(["--home", src, "init", "--chain-id", "cli-chain"]) == 0
    assert rcli.main(["--home", src, "gen_node_key"]) == 0
    pv = RFilePV.load(os.path.join(src, "config", "priv_validator.json"))
    pv.last_height, pv.last_round, pv.last_step = 7, 1, 2
    pv.save()
    with open(os.path.join(src, "data", "blob"), "w") as f:
        f.write("x")
    out = {}
    for name in ("port", "ref"):
        out[name] = str(tmp_path / name)
        shutil.copytree(src, out[name])
    capsys.readouterr()
    return out


@pytest.mark.parametrize("cmd", ["version", "show_validator", "show_node_id", "gen_node_key"])
def test_a_read_command_prints_what_the_reference_prints(homes, capsys, cmd):
    got = _both(lambda h: ["--home", h, cmd], homes, capsys)
    assert got["port"] == got["ref"] and got["port"][0] == 0 and got["port"][1]


@pytest.mark.parametrize("cmd", ["unsafe_reset_priv_validator", "unsafe_reset_all"])
def test_a_reset_prints_and_leaves_what_the_reference_s_does(homes, capsys, cmd):
    got = _both(lambda h: ["--home", h, cmd], homes, capsys)
    assert got["port"] == got["ref"] and got["port"][0] == 0
    files = {}
    for name, home in homes.items():
        with open(os.path.join(home, "config", "priv_validator.json")) as f:
            pv = json.load(f)
        files[name] = (pv, sorted(os.listdir(os.path.join(home, "data"))))
    assert files["port"] == files["ref"]
    assert files["port"][0]["last_height"] == 0
    assert files["port"][1] == ([] if cmd == "unsafe_reset_all" else ["blob"])


def test_gen_validator_prints_a_key_the_reference_reads(capsys):
    from tendermint_tpu.crypto.keys import PrivKeyEd25519 as RPriv

    rc, out, _ = _run(cli.main, ["gen_validator"], capsys)
    _, ref_out, _ = _run(rcli.main, ["gen_validator"], capsys)
    got, ref = json.loads(out), json.loads(ref_out)
    assert rc == 0 and set(got) == set(ref) and got["priv_key"]["type"] == "ed25519"
    import base64

    key = RPriv(base64.b64decode(got["priv_key"]["value"]))
    assert key.pub_key().address().hex().upper() == got["address"]
    assert key.pub_key().to_json_obj() == got["pub_key"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_init_writes_what_the_other_package_loads(tmp_path, capsys, writer):
    home = str(tmp_path / "h")
    main = cli.main if writer == "port" else rcli.main
    rc, out, _ = _run(main, ["--home", home, "init", "--chain-id", "init-chain"], capsys)
    assert rc == 0 and "Generated genesis file" in out
    pv_path = os.path.join(home, "config", "priv_validator.json")
    g_path = os.path.join(home, "config", "genesis.json")
    for pv_cls, g_cls in ((FilePV, GenesisDoc), (RFilePV, RGenesisDoc)):
        pv, doc = pv_cls.load(pv_path), g_cls.from_file(g_path)
        assert doc.chain_id == "init-chain"
        assert doc.validators[0].pub_key.bytes() == pv.get_pub_key().bytes()
    # a second init finds what is there, in both packages
    _, again, _ = _run(cli.main, ["--home", home, "init"], capsys)
    _, ref_again, _ = _run(rcli.main, ["--home", home, "init"], capsys)
    assert again == ref_again and "Found genesis file" in again


@pytest.mark.parametrize("mode", [[], ["--starting-ip-address", "192.168.10.2"],
                                  ["--hostname-prefix", "tm"]], ids=["ports", "ips", "hosts"])
def test_testnet_writes_a_tree_the_other_package_loads(tmp_path, capsys, mode):
    trees = {}
    for name, main in (("port", cli.main), ("ref", rcli.main)):
        out = str(tmp_path / name)
        rc, text, _ = _run(main, ["testnet", "--v", "3", "--output-dir", out, "--chain-id",
                                  "tn", "--starting-port", "30000", *mode], capsys)
        assert rc == 0
        trees[name] = (out, text)
    shapes = {}
    for name, (out, text) in trees.items():
        peers = open(os.path.join(out, "node0", "config", "peers.txt")).read()
        ids = []
        for i in range(3):
            cfg = os.path.join(out, f"node{i}", "config")
            assert open(os.path.join(cfg, "peers.txt")).read() == peers
            # each package loads the other's files
            for pv_cls, nk_cls, g_cls in ((FilePV, NodeKey, GenesisDoc),
                                          (RFilePV, RNodeKey, RGenesisDoc)):
                pv = pv_cls.load(os.path.join(cfg, "priv_validator.json"))
                nk = nk_cls.load(os.path.join(cfg, "node_key.json"))
                doc = g_cls.from_file(os.path.join(cfg, "genesis.json"))
                assert doc.chain_id == "tn" and len(doc.validators) == 3
                assert pv.get_pub_key().bytes() in [v.pub_key.bytes() for v in doc.validators]
            ids.append(nk.id())
        assert peers.strip() == ",".join(
            f"{nid}@{addr}" for nid, addr in zip(ids, re.findall(r"@([^,\s]+)", peers)))
        shapes[name] = (re.sub(r"[0-9a-f]{40}@", "ID@", peers),
                        text.replace(out, "OUT").count("\n"),
                        sorted(os.listdir(out)))
    assert shapes["port"] == shapes["ref"]


def test_lite_checks_its_trust_flags_as_the_reference(capsys):
    for argv in (["lite", "--chain-id", "c", "--trusted-height", "3"],
                 ["lite", "--chain-id", "c", "--trusted-height", "3", "--trusted-hash", "zz"],
                 ["lite", "--chain-id", "c", "--trusted-height", "3", "--trusted-hash", "ab"]):
        got = [_run(main, argv + extra, capsys)
               for main, extra in ((cli.main, ["--device", "cpu"]), (rcli.main, []))]
        assert got[0][0] == got[1][0] == 1 and got[0][2] == got[1][2] != ""


class _NoGatewaySocket:
    """A UDP socket on a net with no UPnP gateway: the M-SEARCH goes out,
    no answer comes."""

    def __init__(self, *a, **kw):
        pass

    def settimeout(self, t):
        pass

    def sendto(self, data, addr):
        return len(data)

    def recvfrom(self, n):
        raise socket.timeout("timed out")

    def close(self):
        pass


def test_probe_upnp_names_its_roadmap_item(capsys, monkeypatch):
    """``probe_upnp`` runs p2p/upnp.probe as the reference's does: with no
    gateway its output and exit code equal the reference's."""
    import socket

    monkeypatch.setattr(socket, "socket", _NoGatewaySocket)
    got = _run(cli.main, ["probe_upnp"], capsys)
    want = _run(rcli.main, ["probe_upnp"], capsys)
    assert got == want and got[0] == 0
    assert json.loads(got[1])["found_gateway"] is False


@pytest.mark.parametrize("argv", [["node"], ["lite", "--chain-id", "c"], ["replay"],
                                  ["replay_console"]], ids=lambda a: a[0])
def test_the_host_verifier_is_refused_on_the_card(tmp_path, capsys, monkeypatch, argv):
    monkeypatch.setenv("TM_BATCH_VERIFIER", "host")
    for dev in ([], ["--device", "cuda"], ["--device", "cuda:0"]):
        rc, _, err = _run(cli.main, ["--home", str(tmp_path), *argv, *dev], capsys)
        assert rc == 1 and "TM_BATCH_VERIFIER=host" in err and "--device cpu" in err


def _bindable(port: int) -> bool:
    import socket

    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False


def _env(**kw):
    env = dict(os.environ)
    env.pop("TM_BATCH_VERIFIER", None)
    env["PYTHONPATH"] = REPO
    env.update(kw)
    return env


def test_node_without_a_card_exits_naming_no_cuda_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    home = str(tmp_path / "h")
    assert cli.main(["--home", home, "init", "--chain-id", "nocard"]) == 0
    rpc, p2p = cli_net.free_port(), cli_net.free_port()
    t0 = time.monotonic()
    run = subprocess.run(CLI + ["--home", home, "node", "--rpc.laddr", f"tcp://127.0.0.1:{rpc}",
                                "--p2p.laddr", f"tcp://127.0.0.1:{p2p}"],
                         capture_output=True, text=True, cwd=REPO, env=_env(), timeout=30)
    assert run.returncode != 0 and "NoCudaDeviceError" in run.stderr, run.stderr[-1000:]
    assert time.monotonic() - t0 < 30
    assert _bindable(rpc) and _bindable(p2p)


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT], ids=["SIGTERM", "SIGINT"])
def test_a_cpu_node_commits_and_stops_on_a_signal_with_exit_code_0(tmp_path, sig):
    home = str(tmp_path / "h")
    assert cli.main(["--home", home, "init", "--chain-id", "sig"]) == 0
    rpc = cli_net.free_port()
    log = open(tmp_path / "node.log", "wb")
    proc = subprocess.Popen(CLI + ["--home", home, "node", "--p2p.laddr", "none",
                                   "--rpc.laddr", f"tcp://127.0.0.1:{rpc}", "--device", "cpu",
                                   "--consensus.timeout_commit", "0.1", "--log_level", "error"],
                            cwd=REPO, env=_env(TM_BATCH_VERIFIER="host"), stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        assert cli_net.wait_for(lambda: int(cli_net.rpc_get(rpc, "/status", 1.0)[
            "sync_info"]["latest_block_height"]) >= 2, 60), open(tmp_path / "node.log").read()
        proc.send_signal(sig)
        assert proc.wait(10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    assert _bindable(rpc)
    # the node kept its WAL under the home
    assert os.path.getsize(os.path.join(home, "data", "cs.wal", "wal")) > 0


def test_replay_through_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TM_BATCH_VERIFIER", "host")
    from tendermint_tpu_torch.node import verify_root
    from tendermint_tpu_torch.testutil import node_net

    home = str(tmp_path / "h")
    node = node_net.make_single_node(home, db_backend="sqlite")
    node_net.install_host_verify()
    node.start()
    try:
        assert node_net.wait_for(lambda: node.block_store.height() >= 2, 30)
    finally:
        node.stop()
    try:
        rc, out, _ = _run(cli.main, ["--home", home, "replay", "--device", "cpu"], capsys)
    finally:
        verify_root.reset_verify()
    assert rc == 0 and "replayed" in out
