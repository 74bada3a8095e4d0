"""The port's ``tools/tm_monitor.py`` against the reference's.

* ``tests/test_rpc_client_tools.py::test_tm_monitor_tracks_node`` and
  ``tests/test_msm_path.py::TestObservability::test_monitor_verify_path_column``
  run once on each package (each monitor over its own package's live node).
* The column helpers (``_verify_path``, ``_fmt_verify``, ``_fmt_device``,
  ``_quorum_column``, ``_spool_column``, ``_crit_column``,
  ``_fmt_bytes``) give the reference's strings on seeded metric maps.
* One chain of a port node and a reference node: the port's monitor and the
  reference's, each over both nodes, give the same snapshot keys, health and
  per-node columns; ``main --json`` prints the same keys.
"""

import io
import json
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.config import config as rconfig
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.node.node import Node as RNode
from tendermint_tpu.privval.file_pv import FilePV as RFilePV
from tendermint_tpu.tools import tm_monitor as r_mon
from tendermint_tpu_torch.config import config as pconfig
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.node.node import Node, init_home
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.testutil import node_net
from tendermint_tpu_torch.testutil.consensus import make_genesis
from tendermint_tpu_torch.tools import tm_monitor as mon

from tests.test_ws_metrics import live_node as ref_live_node  # noqa: F401 (a fixture)

DEADLINE = 60.0
REF = SimpleNamespace(name="reference", mon=r_mon)
PORT = SimpleNamespace(name="port", mon=mon)


@pytest.fixture(autouse=True)
def _host_verify():
    rset_batch_verifier(RHostBatchVerifier())
    yield
    verify_root.reset_verify()


@pytest.fixture()
def port_live_node(tmp_path):
    node = node_net.make_single_node(str(tmp_path / "pnode"))
    node_net.install_host_verify()
    node.start()
    try:
        assert node_net.wait_for(lambda: node.block_store.height() >= 1, 30)
        yield node
    finally:
        node.stop()


@pytest.fixture(params=["reference", "port"])
def monitored(request):
    """(the package, its live node)."""
    if request.param == "port":
        return PORT, request.getfixturevalue("port_live_node")
    return REF, request.getfixturevalue("ref_live_node")


def test_tm_monitor_tracks_node(monitored):
    pkg, node = monitored
    addr = f"tcp://127.0.0.1:{node.rpc_server.bound_port}"
    net = pkg.mon.NetworkMonitor([addr, "tcp://127.0.0.1:1"])  # the second: dead
    try:
        assert node_net.wait_for(lambda: net.nodes[0].online and net.nodes[0].height >= 1, 20)
        snap = net.snapshot()
        assert snap["health"] == "moderate"
        assert snap["num_online"] == 1
        assert snap["nodes"][0]["moniker"] != "?"
        assert node_net.wait_for(lambda: net.nodes[1].last_error is not None, 20)
        snap = net.snapshot()
        dead = snap["nodes"][1]
        assert dead["online"] is False
        assert dead["last_error"]
        assert dead["downtime_s"] is not None and dead["downtime_s"] >= 0
        alive = snap["nodes"][0]
        assert alive["last_error"] is None
        assert alive["downtime_s"] is None
        assert "verify_ms" in alive and "traffic_bytes" in alive
    finally:
        net.stop()


@pytest.mark.parametrize("pkg", [REF, PORT], ids=lambda p: p.name)
def test_monitor_verify_path_column(pkg):
    key = ('tendermint_verify_fe_backend_total{backend="planner_msm",'
           'carry_mode="lazy",ed25519_path="msm",fe_backend="vpu"}')
    assert pkg.mon._verify_path({key: 3.0}) == "msm"
    assert pkg.mon._verify_path({}) == "-"
    other = key.replace('"msm"', '"ladder"')
    assert pkg.mon._verify_path({key: 3.0, other: 1.0}) == "mixed"
    assert pkg.mon._verify_path({key: 0.0, other: 1.0}) == "ladder"
    assert pkg.mon._fmt_verify(12, "msm") == "12ms/msm"
    assert pkg.mon._fmt_verify(12, "-") == "12ms"


def _metric_maps(seed: int):
    rng = np.random.default_rng(seed)
    phases = ["propose_wait", "block_parts", "prevote_quorum", "precommit_quorum",
              "wal_append", "wal_fsync", "abci_exec", "commit_persist", "other_x"]
    out = []
    for _ in range(40):
        m = {}
        for p in phases:
            if rng.random() < 0.5:
                fam = "tendermint_consensus_height_phase_seconds"
                m[f'{fam}_sum{{phase="{p}"}}'] = float(rng.random() * 5)
                m[f'{fam}_count{{phase="{p}"}}'] = float(rng.integers(0, 4))
        for path in ("ladder", "msm"):
            if rng.random() < 0.5:
                m[f'tendermint_verify_fe_backend_total{{backend="b",ed25519_path="{path}"}}'] = (
                    float(rng.integers(0, 3)))
        for kind in ("prevote", "precommit"):
            fam = "tendermint_consensus_quorum_time_to_two_thirds_seconds"
            if rng.random() < 0.5:
                m[f'{fam}_sum{{type="{kind}"}}'] = float(rng.random())
                m[f'{fam}_count{{type="{kind}"}}'] = float(rng.integers(0, 3))
        for name in ("tendermint_telemetry_snapshots_total", "tendermint_telemetry_spool_bytes",
                     "tendermint_telemetry_write_errors_total",
                     "tendermint_telemetry_dropped_snapshots_total"):
            if rng.random() < 0.4:
                m[name] = float(rng.integers(0, 5000000))
        out.append(m)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_columns_equal_the_reference_on_seeded_metrics(seed):
    for m in _metric_maps(seed):
        for fn in ("_verify_path", "_quorum_column", "_spool_column", "_crit_column"):
            assert getattr(mon, fn)(m) == getattr(r_mon, fn)(m), (fn, m)
    rng = np.random.default_rng(50 + seed)
    for _ in range(50):
        ms, n = round(float(rng.random() * 500), 1), float(rng.integers(0, 1 << 34))
        path = ["-", "", "ladder", "msm", "mixed"][int(rng.integers(0, 5))]
        state, fb = int(rng.integers(-1, 5)), int(rng.integers(0, 3))
        assert mon._fmt_verify(ms, path) == r_mon._fmt_verify(ms, path)
        assert mon._fmt_device(state, fb) == r_mon._fmt_device(state, fb)
        assert mon._fmt_bytes(n) == r_mon._fmt_bytes(n)
    assert mon._CRIT_ABBREV == r_mon._CRIT_ABBREV and mon._DEVICE_LABEL == r_mon._DEVICE_LABEL


def _mixed_pair(tmp_path):
    """A port validator and a reference validator of one 2-validator chain
    over TCP, each with RPC and its metrics on; both needed to commit."""
    doc, pvs = make_genesis(2)
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    order = [by_addr[v.address] for v in state_from_genesis(doc).validators.validators]
    homes = [str(tmp_path / f"node{i}") for i in range(2)]
    for home, pv in zip(homes, order):
        init_home(home, doc, priv_key=pv._priv)
    cfg = pconfig.test_config()
    cfg.base.proxy_app, cfg.base.db_backend = "kvstore", "memdb"
    cfg.instrumentation.watchdog = False
    port = Node.from_home(homes[0], node_net.node_config(cfg, "node0"), device="cpu")
    node_net.install_host_verify()
    paddr = str(verify_root.listen(port.switch, port.config.p2p))
    rcfg = rconfig.test_config().set_root(homes[1])
    rcfg.base.proxy_app, rcfg.base.db_backend = "kvstore", "memdb"
    rcfg.base.moniker = "node1"
    rcfg.rpc.laddr = rcfg.p2p.laddr = "tcp://127.0.0.1:0"
    rcfg.p2p.pex, rcfg.p2p.allow_duplicate_ip = False, True
    rcfg.p2p.persistent_peers = paddr
    rcfg.instrumentation.watchdog = False
    rcfg.instrumentation.prometheus = True
    ref = RNode(rcfg, priv_validator=RFilePV.load(rcfg.base.priv_validator_path()))
    return port, ref


def test_monitors_of_both_packages_over_one_mixed_chain(tmp_path):
    port, ref = _mixed_pair(tmp_path)
    nets = []
    try:
        ref.start()
        port.start()
        addrs = [f"tcp://127.0.0.1:{n.rpc_server.bound_port}" for n in (port, ref)]
        nets = [mon.NetworkMonitor(addrs), r_mon.NetworkMonitor(addrs)]
        assert node_net.wait_for(lambda: all(n.online and n.height >= 3 and n.verify_ms >= 0
                                             for net in nets for n in net.nodes), DEADLINE)
        snaps = [net.snapshot() for net in nets]
        assert snaps[0].keys() == snaps[1].keys()
        assert [s["health"] for s in snaps] == ["full", "full"]
        assert snaps[0]["num_online"] == snaps[1]["num_online"] == 2
        for i, node in enumerate((port, ref)):
            a, b = snaps[0]["nodes"][i], snaps[1]["nodes"][i]
            assert a.keys() == b.keys()
            for k in ("addr", "moniker", "network", "online", "last_error", "downtime_s",
                      "verify_path", "device_state", "device_fallbacks", "spool"):
                assert a[k] == b[k], (i, k, a[k], b[k])
            assert abs(a["height"] - b["height"]) <= 1
            assert a["height"] <= node.block_store.height() + 1
        assert [n["moniker"] for n in snaps[0]["nodes"]] == ["node0", "node1"]
        outs = []
        for main in (mon.main, r_mon.main):
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert main([",".join(addrs), "--json", "--interval", "1.5",
                             "--iterations", "1"]) == 0
            outs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
        assert outs[0].keys() == outs[1].keys()
        assert [n.keys() for n in outs[0]["nodes"]] == [n.keys() for n in outs[1]["nodes"]]
    finally:
        for net in nets:
            net.stop()
        for n in (ref, port):
            if n.is_running:
                n.stop()
        node_net.stop_node_net([port])
