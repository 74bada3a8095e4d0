"""The port's RPC server (rpc/server.py, rpc/websocket.py, rpc/core/env.py),
client (rpc/client.py) and tm_bench (tools/tm_bench.py) over a port node,
against the reference's.

* ``tests/test_rpc_client_tools.py::TestHTTPClient`` and
  ``TestTools::test_tm_bench_reports_throughput``, and every class of
  ``tests/test_ws_metrics.py``, restated against a port ``live_node``: a
  single-validator ``node/node.Node`` from a home directory on the CPU,
  verifying on the host (``testutil/node_net.install_host_verify``).
* Route by route, the port's ``RPCEnv`` against the reference's over one
  chain: a port node commits it, its stores' records are copied into the
  reference's stores, and each package's app is replayed to it by its own
  handshake; ``block``, ``blockchain``, ``block_results``, ``commit``,
  ``validators``, ``lite_full_commit`` (its bytes), ``tx``, ``tx_search``,
  ``abci_query``, ``abci_info``, ``consensus_params`` and ``genesis`` give
  equal JSON.
* ``tests/test_mempool_qos.py::TestRPCLoadShed`` on each package, and
  ``tests/test_msm_path.py::TestRpcVerifiedCommit`` against the port node.
* The profiler routes write a Chrome trace of the CPU activity.
"""

import base64
import hashlib
import http.client
import json
import os
import queue
import socket
import struct
import threading
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu.abci.examples.kvstore import KVStoreApp as RKVStoreApp
from tendermint_tpu.blockchain.store import BlockStore as RBlockStore
from tendermint_tpu.config.config import MempoolConfig as RMempoolConfig
from tendermint_tpu.consensus.replay import Handshaker as RHandshaker
from tendermint_tpu.libs.db.kv import MemDB as RMemDB
from tendermint_tpu.libs.metrics import NodeMetrics as RNodeMetrics
from tendermint_tpu.mempool import mempool as rmempool
from tendermint_tpu.mempool import reactor as rreactor
from tendermint_tpu.proxy import app_conn as rapp_conn
from tendermint_tpu.rpc.core import env as renv
from tendermint_tpu.sim.clock import SimClock
from tendermint_tpu.state import store as rsm_store
from tendermint_tpu.state.txindex.kv import KVTxIndexer as RKVTxIndexer
from tendermint_tpu.types.genesis import GenesisDoc as RGenesisDoc
from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.mempool import mempool as pmempool
from tendermint_tpu_torch.mempool import reactor as preactor
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.proxy import app_conn as papp_conn
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError, WSEventClient
from tendermint_tpu_torch.rpc.core import env as penv
from tendermint_tpu_torch.rpc.websocket import OP_TEXT, read_message
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.txindex.kv import KVTxIndexer
from tendermint_tpu_torch.testutil import node_net
from tendermint_tpu_torch.tools.tm_bench import run_bench
from tendermint_tpu_torch.types.genesis import GenesisDoc


def wait_for(predicate, timeout: float = 10.0, interval: float = 0.01) -> bool:
    return node_net.wait_for(predicate, timeout, interval)


# -- a minimal masked-frame WS client (tests/test_ws_metrics.py's) -----------------


class WSClient:
    def __init__(self, host, port, path="/websocket"):
        self.sock = socket.create_connection((host, port), timeout=10)
        key = base64.b64encode(os.urandom(16)).decode()
        req = (
            f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
        )
        self.sock.sendall(req.encode())
        self.rfile = self.sock.makefile("rb")
        status = self.rfile.readline()
        assert b"101" in status, status
        while self.rfile.readline() not in (b"\r\n", b""):
            pass

    def send_json(self, obj) -> None:
        payload = json.dumps(obj).encode()
        mask = os.urandom(4)
        head = bytes([0x80 | OP_TEXT])
        n = len(payload)
        if n < 126:
            head += bytes([0x80 | n])
        else:
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.sock.sendall(head + mask + masked)

    def recv_json(self, timeout=15):
        self.sock.settimeout(timeout)
        msg = read_message(self.rfile)
        assert msg is not None, "connection closed"
        opcode, payload = msg
        assert opcode == OP_TEXT, opcode
        return json.loads(payload)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# -- node fixture ------------------------------------------------------------------


@pytest.fixture()
def live_node(tmp_path):
    """tests/test_ws_metrics.py's live node on the port: one validator from
    a home directory, RPC at 127.0.0.1 port 0, a real WAL, metrics and the
    unsafe routes on; the host verifies."""
    node = node_net.make_single_node(str(tmp_path / "node"))
    node_net.install_host_verify()
    node.start()
    try:
        assert wait_for(lambda: node.block_store.height() >= 1, timeout=30)
        yield node
    finally:
        node.stop()
        verify_root.reset_verify()


def _rpc_get(node, path):
    conn = http.client.HTTPConnection("127.0.0.1", node.rpc_server.bound_port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


@pytest.fixture()
def client(live_node):
    return HTTPClient(f"tcp://127.0.0.1:{live_node.rpc_server.bound_port}")


class TestWebSocketSubscribe:
    def test_subscribe_new_block_events(self, live_node):
        ws = WSClient("127.0.0.1", live_node.rpc_server.bound_port)
        try:
            ws.send_json(
                {"jsonrpc": "2.0", "id": 7, "method": "subscribe",
                 "params": {"query": "tm.event = 'NewBlock'"}}
            )
            ack = ws.recv_json()
            assert ack["id"] == 7 and "error" not in ack
            ev = ws.recv_json()
            assert ev["id"] == "7#event"
            data = ev["result"]["data"]
            assert data["type"] == "NewBlock"
            assert data["value"]["block"]["header"]["height"] >= 1
        finally:
            ws.close()

    def test_subscribe_tx_event_on_broadcast(self, live_node):
        ws = WSClient("127.0.0.1", live_node.rpc_server.bound_port)
        try:
            ws.send_json(
                {"jsonrpc": "2.0", "id": 1, "method": "subscribe",
                 "params": {"query": "tm.event = 'Tx'"}}
            )
            assert "error" not in ws.recv_json()
            tx = b"ws-key=ws-val"
            live_node.mempool.check_tx(tx)
            ev = ws.recv_json(timeout=30)
            assert ev["result"]["data"]["type"] == "Tx"
            got_tx = base64.b64decode(ev["result"]["data"]["value"]["TxResult"]["tx"])
            assert got_tx == tx
        finally:
            ws.close()

    def test_unsubscribe_stops_events(self, live_node):
        ws = WSClient("127.0.0.1", live_node.rpc_server.bound_port)
        try:
            ws.send_json(
                {"jsonrpc": "2.0", "id": 2, "method": "subscribe",
                 "params": {"query": "tm.event = 'NewBlock'"}}
            )
            assert "error" not in ws.recv_json()
            ws.recv_json()  # at least one event flows
            ws.send_json(
                {"jsonrpc": "2.0", "id": 3, "method": "unsubscribe",
                 "params": {"query": "tm.event = 'NewBlock'"}}
            )
            # drain until the unsubscribe ack (events may be in flight)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                msg = ws.recv_json()
                if msg.get("id") == 3:
                    break
            else:
                pytest.fail("no unsubscribe ack")
            # after the ack: no further events
            with pytest.raises(Exception):
                ws.recv_json(timeout=1.0)
        finally:
            ws.close()

    def test_bad_query_returns_error(self, live_node):
        ws = WSClient("127.0.0.1", live_node.rpc_server.bound_port)
        try:
            ws.send_json(
                {"jsonrpc": "2.0", "id": 4, "method": "nope", "params": {}}
            )
            assert ws.recv_json()["error"]["code"] == -32601
        finally:
            ws.close()


class TestPrometheusMetrics:
    def test_metrics_scrape(self, live_node):
        assert wait_for(lambda: live_node.block_store.height() >= 2, timeout=30)
        # let the metrics pump observe at least one block
        assert wait_for(
            lambda: b"tendermint_consensus_height" in _rpc_get(live_node, "/metrics")[1],
            timeout=15,
        )
        status, body = _rpc_get(live_node, "/metrics")
        assert status == 200
        text = body.decode()
        for needle in (
            "# TYPE tendermint_consensus_height gauge",
            "tendermint_consensus_validators 1",
            "tendermint_mempool_size",
            "tendermint_state_block_processing_time_count",
            "tendermint_consensus_block_interval_seconds_bucket",
            # verify pipeline: height-2+ commits batch through the process
            # verifier, so the attached tendermint_verify_* family has data
            "# TYPE tendermint_verify_batch_size histogram",
            "tendermint_verify_batch_size_bucket",
            'tendermint_verify_dispatch_seconds_bucket{backend="host"',
            'tendermint_verify_calls_total{backend="host",algo="ed25519"}',
        ):
            assert needle in text, f"missing {needle}\n{text[:1500]}"
        # height gauge tracks the chain
        height_line = next(
            l for l in text.splitlines()
            if l.startswith("tendermint_consensus_height ")
        )
        assert float(height_line.split()[-1]) >= 1
        # the host verifier has recorded at least one commit's signatures
        calls_line = next(
            l for l in text.splitlines()
            if l.startswith('tendermint_verify_calls_total{backend="host"')
        )
        assert float(calls_line.split()[-1]) >= 1

    def test_metrics_route_200_when_disabled(self, live_node):
        """Scrapers must distinguish 'instrumentation off' (200 + comment)
        from 'no such route' (404)."""
        saved = live_node.metrics
        live_node.metrics = None
        try:
            status, body = _rpc_get(live_node, "/metrics")
            assert status == 200
            assert body.startswith(b"# metrics disabled")
        finally:
            live_node.metrics = saved


class TestDebugRoutes:
    def test_unsafe_dump_threads(self, live_node):
        status, body = _rpc_get(live_node, "/unsafe_dump_threads")
        assert status == 200
        import json as _json

        out = _json.loads(body)["result"]
        assert out["n_threads"] >= 3
        assert any("consensus" in name.lower() or "MainThread" in name
                   for name in out["stacks"])

    def test_unsafe_routes_gated(self, live_node):
        live_node.config.rpc.unsafe = False
        try:
            _, body = _rpc_get(live_node, "/unsafe_dump_threads")
            import json as _json

            assert "error" in _json.loads(body)
        finally:
            live_node.config.rpc.unsafe = True


class TestTraceExport:
    def test_trace_reset_and_dump(self, live_node):
        """Enable the tracer over RPC, let consensus commit a block, and pull
        a Chrome trace with consensus-step and WAL-fsync spans."""
        from tendermint_tpu_torch.libs import trace

        # the ring at its default size, whatever an earlier test in this
        # process left; the height is read only once tracing is on: read
        # before, a block landing in between satisfied the wait with next
        # to nothing traced
        _, body = _rpc_get(live_node, f"/trace_reset?enable=true&capacity={trace.DEFAULT_CAPACITY}")
        try:
            res = json.loads(body)["result"]
            assert res["enabled"] is True and res["capacity"] == trace.DEFAULT_CAPACITY
            h0 = live_node.block_store.height()
            # a whole height must run while tracing: its steps, its own
            # votes' WAL fsyncs and its commit
            assert wait_for(
                lambda: live_node.block_store.height() >= h0 + 2, timeout=30
            )
            status, body = _rpc_get(live_node, "/dump_trace")
            assert status == 200
            doc = json.loads(body)["result"]
            assert doc["displayTimeUnit"] == "ms"
            events = doc["traceEvents"]
            names = {e["name"] for e in events}
            assert "consensus.step" in names
            assert "wal.fsync" in names
            assert "thread_name" in names  # metadata events
            # every event is well-formed Chrome trace JSON
            for e in events:
                assert e["ph"] in ("X", "i", "M")
                if e["ph"] == "X":
                    assert e["dur"] >= 0 and "ts" in e
                if e["ph"] == "i":
                    assert e["s"] == "t"
            step = next(e for e in events if e["name"] == "consensus.step")
            assert step["args"]["height"] >= 1
        finally:
            trace.disable()
            trace.reset()

    def test_trace_routes_gated(self, live_node):
        from tendermint_tpu_torch.libs import trace

        live_node.config.rpc.unsafe = False
        try:
            for route in ("/dump_trace", "/trace_reset"):
                _, body = _rpc_get(live_node, route)
                assert "error" in json.loads(body)
            assert not trace.enabled()
        finally:
            live_node.config.rpc.unsafe = True


class TestHotPathMetricsScrape:
    def test_new_families_on_live_node(self, live_node):
        """The hot-path families land on /metrics of a running node: the
        consensus loop drives step_duration, the WAL drives fsync timings,
        and a checked tx drives the mempool size histogram.  (No p2p peers
        here, so the per-peer families expose TYPE lines only.)"""
        assert wait_for(lambda: live_node.block_store.height() >= 2, timeout=30)
        live_node.mempool.check_tx(b"hot-key=hot-val")
        assert wait_for(
            lambda: b"tendermint_mempool_tx_size_bytes_count 1"
            in _rpc_get(live_node, "/metrics")[1],
            timeout=15,
        )
        text = _rpc_get(live_node, "/metrics")[1].decode()
        for needle in (
            "# TYPE tendermint_consensus_step_duration_seconds histogram",
            "# TYPE tendermint_consensus_vote_arrival_latency_seconds histogram",
            "# TYPE tendermint_consensus_wal_append_seconds histogram",
            "# TYPE tendermint_consensus_wal_fsync_seconds histogram",
            "# TYPE tendermint_p2p_peer_receive_bytes_total counter",
            "# TYPE tendermint_p2p_peer_send_bytes_total counter",
            "# TYPE tendermint_p2p_peer_pending_send_bytes gauge",
            "# TYPE tendermint_p2p_messages_received_total counter",
            "# TYPE tendermint_p2p_messages_sent_total counter",
            "# TYPE tendermint_mempool_tx_size_bytes histogram",
            "# TYPE tendermint_mempool_failed_txs counter",
            "# TYPE tendermint_mempool_recheck_times counter",
            "# TYPE tendermint_consensus_rounds gauge",
        ):
            assert needle in text, f"missing {needle}"
        # a committing node has left NEW_HEIGHT/COMMIT steps behind it
        count_line = next(
            l for l in text.splitlines()
            if l.startswith("tendermint_consensus_step_duration_seconds_count")
        )
        assert float(count_line.split()[-1]) >= 1
        # WAL fsyncs every commit
        fsync_line = next(
            l for l in text.splitlines()
            if l.startswith("tendermint_consensus_wal_fsync_seconds_count")
        )
        assert float(fsync_line.split()[-1]) >= 1
        # single-validator consensus signs prevotes+precommits each height
        vote_line = next(
            l for l in text.splitlines()
            if l.startswith(
                'tendermint_consensus_vote_arrival_latency_seconds_count'
            )
        )
        assert float(vote_line.split()[-1]) >= 1


class TestProfileExport:
    def test_dump_profile_and_reset(self, live_node):
        from tendermint_tpu_torch.libs.profile import get_profiler

        p = get_profiler()
        capacity = p._capacity  # the route below shrinks the process's ring
        p.reset()
        try:
            with p.window(42, heights=3):
                p.record("pallas", bucket=(4, 16), lanes_present=3,
                         lanes_dispatched=4, pack_seconds=0.01,
                         run_seconds=0.2, compiled=True, bytes_to_device=512)
            status, body = _rpc_get(live_node, "/dump_profile")
            assert status == 200
            out = json.loads(body)["result"]
            assert out["dropped"] == 0
            assert len(out["entries"]) == 1
            row = out["ledger"][0]
            assert row["height_base"] == 42
            assert row["heights"] == 3
            assert row["compiles"] == 1
            assert row["bytes_to_device"] == 512
            assert row["occupancy"] == 0.75
            # reset clears and resizes the ring
            _, body = _rpc_get(live_node, "/profile_reset?capacity=2")
            assert "error" not in json.loads(body)
            out = json.loads(_rpc_get(live_node, "/dump_profile")[1])["result"]
            assert out["entries"] == [] and out["ledger"] == []
            for _ in range(3):
                p.record("host")
            out = json.loads(_rpc_get(live_node, "/dump_profile")[1])["result"]
            assert len(out["entries"]) == 2 and out["dropped"] == 1
        finally:
            p.reset(capacity)

    def test_profile_reset_rejects_bad_capacity(self, live_node):
        _, body = _rpc_get(live_node, "/profile_reset?capacity=0")
        assert "error" in json.loads(body)

    def test_profile_routes_gated(self, live_node):
        live_node.config.rpc.unsafe = False
        try:
            for route in ("/dump_profile", "/profile_reset"):
                _, body = _rpc_get(live_node, route)
                assert "error" in json.loads(body)
        finally:
            live_node.config.rpc.unsafe = True


class TestFlightExport:
    def test_flight_reset_dump_and_limit(self, live_node):
        """Enable the per-node flight recorder over RPC, let a couple of
        heights commit, and pull limited + full dumps."""
        _, body = _rpc_get(live_node, "/flight_reset?enable=true")
        try:
            assert json.loads(body)["result"]["enabled"] is True
            h0 = live_node.block_store.height()
            assert wait_for(
                lambda: live_node.block_store.height() >= h0 + 2, timeout=30
            )
            status, body = _rpc_get(live_node, "/dump_flight")
            assert status == 200
            out = json.loads(body)["result"]
            assert out["enabled"] is True
            assert out["truncated"] is False
            assert out["total_records"] == len(out["records"]) >= 2
            # default-on watchdog contributes the stall key (healthy: null)
            assert "stall" in out and out["stall"] is None
            # the newest record may still be mid-height: assert on a fully
            # executed one (commit stamps before apply_block finishes)
            done = [r for r in out["records"] if r["exec"] is not None]
            assert done, "no executed height in flight records"
            rec = done[-1]
            assert rec["commit"] is not None and rec["commit"]["hash"]
            assert rec["prevote"]["count"] >= 1  # single validator: own vote
            assert rec["prevote"]["by_peer"].get("local", 0) >= 1
            assert rec["exec"]["dur_ns"] >= 0
            # limit keeps the newest record and flags the cut
            cut = json.loads(
                _rpc_get(live_node, "/dump_flight?limit=1")[1]
            )["result"]
            assert len(cut["records"]) == 1 and cut["truncated"] is True
            # >= not ==: the node may have started a new height in between
            assert cut["records"][0]["height"] >= out["records"][-1]["height"]
        finally:
            _rpc_get(live_node, "/flight_reset?enable=false")

    def test_dump_trace_limit_and_anchor(self, live_node):
        from tendermint_tpu_torch.libs import trace

        _rpc_get(live_node, "/trace_reset?enable=true")
        try:
            h0 = live_node.block_store.height()
            assert wait_for(
                lambda: live_node.block_store.height() >= h0 + 1, timeout=30
            )
            out = json.loads(
                _rpc_get(live_node, "/dump_trace?limit=5")[1]
            )["result"]
            spans = [e for e in out["traceEvents"] if e["ph"] != "M"]
            assert len(spans) <= 5
            assert out["total_events"] > 5 and out["truncated"] is True
            # the wall/perf anchor pair trace_merge.py rebases with
            anchor = out["anchor"]
            assert anchor["wall_ns"] > 0 and anchor["perf_ns"] > 0
        finally:
            trace.disable()
            trace.reset()

    def test_flight_routes_gated(self, live_node):
        live_node.config.rpc.unsafe = False
        try:
            for route in ("/dump_flight", "/flight_reset"):
                _, body = _rpc_get(live_node, route)
                assert "error" in json.loads(body)
        finally:
            live_node.config.rpc.unsafe = True

    def test_flight_rejects_bad_args(self, live_node):
        _, body = _rpc_get(live_node, "/flight_reset?capacity=0")
        assert "error" in json.loads(body)
        _, body = _rpc_get(live_node, "/dump_flight?limit=-1")
        assert "error" in json.loads(body)

    def test_health_and_dump_consensus_state_carry_watchdog(self, live_node):
        _, body = _rpc_get(live_node, "/health")
        h = json.loads(body)["result"]
        assert h["stalled"] is False and h["stalls_total"] == 0
        _, body = _rpc_get(live_node, "/dump_consensus_state")
        out = json.loads(body)["result"]
        assert out["stall"]["stalled"] is False


# -- tests/test_rpc_client_tools.py, restated -----------------------------------------


class TestHTTPClient:
    def test_status_and_health(self, client):
        h = client.health()
        assert h == {} or h["stalled"] is False
        st = client.status()
        assert st["node_info"]["network"] == "ws-chain"
        assert st["sync_info"]["latest_block_height"] >= 1

    def test_block_commit_validators(self, client):
        st = client.status()
        h = min(2, st["sync_info"]["latest_block_height"])
        assert client.block(h)["block"]["header"]["height"] == h
        assert client.commit(h)["signed_header"]["header"]["height"] == h
        assert len(client.validators(h)["validators"]) == 1

    def test_broadcast_tx_commit_and_query(self, client):
        res = client.broadcast_tx_commit(b"clientlib=works")
        assert res["deliver_tx"]["code"] == 0
        assert res["height"] >= 1
        q = client.abci_query(path="/store", data=b"clientlib")
        assert base64.b64decode(q["response"]["value"]) == b"works"
        # the indexer's lookup by hash
        assert wait_for(lambda: _found(client, res["hash"]), timeout=10)
        assert client.tx(res["hash"])["height"] == res["height"]

    def test_error_surfaces(self, client):
        with pytest.raises(RPCClientError):
            client.block(10_000_000)

    def test_blockchain_info(self, client):
        assert wait_for(lambda: client.status()["sync_info"]["latest_block_height"] >= 2,
                        timeout=30)
        info = client.blockchain()
        assert info["last_height"] >= 2
        metas = info["block_metas"]
        assert 1 <= len(metas) <= 20
        heights = [m["header"]["height"] for m in metas]
        assert heights == sorted(heights, reverse=True)
        one = client.blockchain(min_height=1, max_height=1)
        assert [m["header"]["height"] for m in one["block_metas"]] == [1]
        with pytest.raises(RPCClientError):
            client.blockchain(min_height=5, max_height=2)

    def test_block_results(self, client):
        res = client.broadcast_tx_commit(b"results=route")
        br = client.block_results(res["height"])
        assert br["height"] == res["height"]
        dtxs = br["results"]["DeliverTx"]
        assert len(dtxs) == 1 and dtxs[0]["code"] == 0
        with pytest.raises(RPCClientError):
            client.block_results(10_000_000)

    def test_consensus_state_and_params(self, client):
        hrs = client.consensus_state()["round_state"]["height/round/step"]
        assert len(hrs.split("/")) == 3
        cp = client.consensus_params()
        assert cp["consensus_params"]["block_size"]["max_bytes"] > 0
        assert cp["consensus_params"]["evidence"]["max_age"] > 0

    @pytest.mark.parametrize("with_consensus_state", [True, False])
    def test_consensus_params_between_a_block_and_its_state(self, live_node,
                                                           with_consensus_state):
        """The default height is the consensus state's (its last block's
        height + 1), or without one the one after the last block whose
        state is saved: a block store one block ahead of the state (the
        window between a block's save and its state's) still answers, with
        the params the state saved, where the block store's height + 1 had
        none yet (about 8 % of calls on a live single-validator node)."""
        st = sm_store.load_state(live_node.state_db)
        # the live node's state frozen into a store of its own: the params
        # record where they last changed, then the state and the next
        # height's records, as save_state writes them
        db = MemDB()
        changed = st.last_height_consensus_params_changed
        sm_store.save_consensus_params_info(db, changed, changed, st.consensus_params)
        sm_store.save_state(db, st)
        ahead = SimpleNamespace(height=lambda: st.last_block_height + 1)
        node = SimpleNamespace(block_store=ahead, state_db=db)
        if with_consensus_state:
            node.consensus_state = SimpleNamespace(get_last_height=lambda: st.last_block_height)
        env = penv.RPCEnv(node)
        out = env.consensus_params()
        assert out["block_height"] == st.last_block_height + 1
        assert (out["consensus_params"]["block_size"]["max_bytes"]
                == st.consensus_params.block_size.max_bytes > 0)
        with pytest.raises(penv.RPCError):  # what the block store's height + 1 asked for
            env.consensus_params(height=st.last_block_height + 2)

    def test_unsafe_flush_mempool(self, client):
        client.unsafe_flush_mempool()

    def test_unsafe_heap_profile_route(self, client):
        import tempfile

        res = client.call("unsafe_write_heap_profile", filename="heap-route.txt")
        assert res["filename"] == os.path.join(
            tempfile.gettempdir(), f"tm-tpu-profiles-{os.getuid()}", "heap-route.txt")
        assert os.path.exists(res["filename"])
        with pytest.raises(RPCClientError):
            client.call("unsafe_write_heap_profile", filename="../../etc/overwrite")
        stop = client.call("unsafe_stop_heap_profiler")
        assert stop["was_tracing"] is True
        assert client.call("unsafe_stop_heap_profiler")["was_tracing"] is False

    def test_device_health_routes(self, client):
        try:
            health = client.dump_device_health()
            snap = health["breaker"]
            assert snap["state"] in ("closed", "open", "half_open", "quarantined")
            assert "failures_total" in snap and "history" in snap
            assert health["config"]["breaker_threshold"] >= 1
            assert health["verifier"]["installed"] is True
            assert isinstance(health["events"], list)
            # quarantine the process breaker, then clear it over RPC: the
            # operator runbook for an audit_mismatch latch
            brk.get_device_breaker().quarantine("audit_mismatch:test")
            assert client.dump_device_health()["breaker"]["state"] == "quarantined"
            res = client.device_breaker_reset()
            assert res["breaker"]["state"] == "closed"
            assert brk.get_device_breaker().state == brk.CLOSED
        finally:
            brk.reset_device_guard()

    def test_reprobe_without_a_card_is_an_error(self, client):
        """The port's reset with ``reprobe``: it re-resolves the card and,
        with none, answers NoCudaDeviceError; no CPU verifier is installed."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device answers the reprobe")
        before = client.dump_device_health()["verifier"]
        with pytest.raises(RPCClientError, match="NoCudaDeviceError"):
            client.device_breaker_reset(reprobe=True)
        assert client.dump_device_health()["verifier"] == before
        assert client.device_breaker_reset(reprobe=False)["breaker"]["state"] == "closed"

    def test_dial_routes_require_switch(self, client):
        with pytest.raises(RPCClientError):
            client.dial_seeds(["deadbeef@127.0.0.1:1"])
        with pytest.raises(RPCClientError):
            client.dial_peers(["deadbeef@127.0.0.1:1"], persistent=True)

    def test_ws_event_client(self, live_node):
        ws = WSEventClient(f"tcp://127.0.0.1:{live_node.rpc_server.bound_port}")
        try:
            ws.subscribe("tm.event = 'NewBlock'")
            assert ws.next_event(timeout=20)["data"]["type"] == "NewBlock"
        finally:
            ws.close()


def _found(client, tx_hash) -> bool:
    try:
        client.tx(tx_hash)
        return True
    except RPCClientError:
        return False


class TestTools:
    def test_tm_bench_reports_throughput(self, live_node):
        addr = f"tcp://127.0.0.1:{live_node.rpc_server.bound_port}"
        stats = run_bench(addr, duration=3.0, rate=200, connections=2)
        assert stats["txs_sent"] > 0
        assert stats["blocks_seen"] > 0
        assert stats["txs_committed"] > 0
        assert stats["txs_per_sec"]["avg"] > 0


class TestRpcVerifiedCommit:
    """tests/test_msm_path.py::TestRpcVerifiedCommit on the port: /commit
    and /validators with ``verify`` re-verify the stored commit through the
    LaneFeed burst path."""

    def test_commit_and_validators_verified(self, client):
        assert wait_for(lambda: client.status()["sync_info"]["latest_block_height"] >= 3,
                        timeout=30.0)
        h = 2
        ver = client.call("commit", height=h, verify=1)["verification"]
        assert ver["verified"] is True and ver["sigs_ok"] is True
        assert ver["tally"] > 0 and ver["tally"] * 3 > ver["total_power"] * 2
        assert ver["batch_rows"] >= 1
        assert client.call("validators", height=h, verify=1)["verification"]["verified"] is True
        assert "verification" not in client.call("commit", height=h)

    def test_a_concurrent_burst_rides_the_lane_feed(self, live_node, client):
        """8 clients at once: each verdict verified, the feed's dispatches
        at most the rows it took (rows fold into shared dispatches)."""
        assert wait_for(lambda: live_node.block_store.height() >= 3, timeout=30.0)
        out, errs = [], []

        def ask():
            try:
                out.append(client.call("commit", height=2, verify=True)["verification"])
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=ask) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        feed = live_node._rpc_env._feed
        assert not errs and len(out) == 8 and all(v["verified"] for v in out)
        assert feed.rows_in == 8 and 1 <= feed.dispatches <= 8


class TestProfilerRoutes:
    def test_the_profiler_writes_a_cpu_trace(self, live_node, tmp_path):
        # the process's first torch.profiler session starts slowly (about
        # 2.5 s alone on a CPU, past 10 s under a loaded run) and the route
        # waits up to _TorchTrace.START_WAIT_S for it: the client waits as
        # long, not the default 10 s
        client = HTTPClient(f"tcp://127.0.0.1:{live_node.rpc_server.bound_port}",
                            timeout=penv._TorchTrace.START_WAIT_S + 30.0)
        d = str(tmp_path / "trace")
        assert client.call("unsafe_start_profiler", dir=d) == {"tracing": True, "dir": d}
        with pytest.raises(RPCClientError, match="already running"):
            client.call("unsafe_start_profiler", dir=d)
        import torch

        torch.ones(64, 64) @ torch.ones(64, 64)
        res = client.call("unsafe_stop_profiler")
        assert res["tracing"] is False and os.path.dirname(res["file"]) == d
        with open(res["file"]) as f:
            trace = json.load(f)
        assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]
        with pytest.raises(RPCClientError, match="no profiler trace"):
            client.call("unsafe_stop_profiler")
        # the reference's aliases
        assert client.call("unsafe_start_cpu_profiler", filename=d)["tracing"] is True
        assert client.call("unsafe_stop_cpu_profiler")["tracing"] is False

    def test_the_profiler_routes_are_gated(self, live_node, client):
        live_node.config.rpc.unsafe = False
        try:
            for route in ("unsafe_start_profiler", "unsafe_stop_profiler"):
                with pytest.raises(RPCClientError, match="unsafe"):
                    client.call(route)
        finally:
            live_node.config.rpc.unsafe = True


# -- tests/test_mempool_qos.py::TestRPCLoadShed, on each package ---------------------


class _RecordingBus:
    def __init__(self):
        self.subscribed = []
        self.unsubscribed = []

    def subscribe(self, sub_id, query):
        self.subscribed.append(sub_id)
        return queue.Queue()

    def unsubscribe(self, sub_id):
        self.unsubscribed.append(sub_id)


REF = SimpleNamespace(name="reference", env=renv, conn=rapp_conn, mp=rmempool,
                      reactor=rreactor, app=RKVStoreApp, metrics=RNodeMetrics)
PORT = SimpleNamespace(name="port", env=penv, conn=papp_conn, mp=pmempool,
                       reactor=preactor, app=KVStoreApp, metrics=NodeMetrics)


def make_rpc_env(pkg, budget=1, mempool_size=100, closing=None):
    conn = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(pkg.app()))
    conn.start()
    mp = pkg.mp.Mempool(conn.mempool, size=mempool_size)
    node = SimpleNamespace(
        config=SimpleNamespace(rpc=SimpleNamespace(broadcast_max_in_flight=budget)),
        mempool=mp, metrics=pkg.metrics(), event_bus=_RecordingBus())
    return pkg.env.RPCEnv(node), node


def b64tx(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


@pytest.mark.parametrize("pkg", [REF, PORT], ids=lambda p: p.name)
class TestRPCLoadShed:
    def test_sync_sheds_at_budget_then_recovers(self, pkg):
        env, node = make_rpc_env(pkg, budget=1)
        with env._broadcast_slot("sync"):  # one request in flight
            with pytest.raises(pkg.env.RPCError) as ei:
                env.broadcast_tx_sync(b64tx(b"shed=1"))
        assert ei.value.code == pkg.env.ERR_MEMPOOL_OVERLOADED == -32001
        assert "overloaded" in ei.value.message
        assert env.broadcast_shed == {"sync": 1}
        assert ('tendermint_mempool_qos_shed_total{route="sync"} 1'
                in node.metrics.registry.expose_text())
        res = env.broadcast_tx_sync(b64tx(b"shed=1"))  # the slot is back
        assert res["code"] == 0
        assert node.mempool.size() == 1

    def test_commit_shed_never_leaks_subscription(self, pkg):
        env, node = make_rpc_env(pkg, budget=1)
        with env._broadcast_slot("commit"):
            with pytest.raises(pkg.env.RPCError) as ei:
                env.broadcast_tx_commit(b64tx(b"c=1"))
        assert ei.value.code == pkg.env.ERR_MEMPOOL_OVERLOADED
        assert node.event_bus.subscribed == []  # shed before subscribe
        assert env.broadcast_shed == {"commit": 1}

    def test_async_shed_and_budget_zero_is_unbounded(self, pkg):
        env, _ = make_rpc_env(pkg, budget=1)
        with env._broadcast_slot("async"):
            with pytest.raises(pkg.env.RPCError):
                env.broadcast_tx_async(b64tx(b"a=1"))
        env2, node2 = make_rpc_env(pkg, budget=0)
        with env2._broadcast_slot("async"):
            res = env2.broadcast_tx_async(b64tx(b"a=1"))  # 0 = unbounded
        assert res["code"] == 0
        assert node2.mempool.size() == 1

    def test_full_mempool_maps_to_overloaded_error(self, pkg):
        env, node = make_rpc_env(pkg, budget=8, mempool_size=1)
        env.broadcast_tx_sync(b64tx(b"fits=1"))
        with pytest.raises(pkg.env.RPCError) as ei:
            env.broadcast_tx_sync(b64tx(b"spill=1"))
        assert ei.value.code == pkg.env.ERR_MEMPOOL_OVERLOADED
        assert node.mempool.size() == 1

    def test_dump_mempool_qos_route(self, pkg):
        env, node = make_rpc_env(pkg, budget=4)
        node.config.rpc.unsafe = True
        cfg = dict(qos_enabled=True, qos_peer_tx_rate=2.0, qos_peer_tx_burst=2.0,
                   qos_peer_byte_rate=1000.0, qos_peer_byte_burst=1000.0,
                   qos_global_tx_rate=0.0, qos_mute_after=0)
        mcfg = (MempoolConfig if pkg is PORT else RMempoolConfig)(**cfg)
        node.mempool_reactor = pkg.reactor.MempoolReactor(
            node.mempool, config=mcfg, now_ns=SimClock(frozen_at_ns=10 ** 9))
        node.mempool_reactor.receive(0, SimpleNamespace(id="p1"),
                                     pkg.reactor.encode_tx_msg(b"q=1"))
        out = env.dump_mempool_qos()
        assert out["qos"]["enabled"] is True
        assert out["qos"]["peers"]["p1"]["admitted"] == 1
        assert out["mempool"]["size"] == 1
        assert out["rpc"]["budget"] == 4 and out["rpc"]["in_flight"] == 0


def test_load_shedding_answers_alike_on_both_packages():
    """One stream of submissions against a budget of 2 with one slot held:
    the same answers and shed counters on each package."""
    got = {}
    for pkg in (REF, PORT):
        env, node = make_rpc_env(pkg, budget=2, mempool_size=3)
        answers = []
        with env._broadcast_slot("commit"):
            for i, route in enumerate(["sync", "async", "sync", "async", "sync"]):
                try:
                    res = getattr(env, f"broadcast_tx_{route}")(b64tx(b"k%d=v" % i))
                    answers.append((route, res["code"], res["hash"]))
                except pkg.env.RPCError as e:
                    answers.append((route, e.code, e.message))
        got[pkg.name] = (answers, dict(env.broadcast_shed), node.mempool.size())
    assert got["reference"] == got["port"]


# -- the routes, route by route, against the reference's over one chain ---------------


def _copy_into(src, dst) -> None:
    for k, v in src.iterator():
        dst.set(k, v)


@pytest.fixture(scope="module")
def one_chain(tmp_path_factory):
    """A port node's chain of a few heights with tagged kvstore txs, its
    records in each package's stores, each package's app replayed to it by
    its own handshake; an ``RPCEnv`` of each over them."""
    home = str(tmp_path_factory.mktemp("one-chain"))
    node = node_net.make_single_node(home)
    node_net.install_host_verify()
    txs = [b"alpha=1", b"beta=2", b"gamma=3", b"alpha=4"]
    node.start()
    try:
        c = HTTPClient(f"tcp://127.0.0.1:{node.rpc_server.bound_port}")
        heights = [c.broadcast_tx_commit(tx)["height"] for tx in txs]
        top = max(heights) + 1
        assert wait_for(lambda: node.block_store.height() >= top, timeout=30)
        # the indexer has every tx before the stores are copied
        assert wait_for(lambda: all(node.tx_indexer.get(hashlib.sha256(tx).digest())
                                    for tx in txs), timeout=10)
    finally:
        node.stop()
        verify_root.reset_verify()
    stores = {"bs": node.block_store_db, "state": node.state_db, "tx": node.tx_indexer._db}
    doc_json = node.genesis_doc.to_json()

    def standin(pkg_mem, store_cls, ix_cls, doc, conn_mod, app_cls, handshaker, load_state):
        dbs = {k: pkg_mem() for k in stores}
        for k, db in stores.items():
            _copy_into(db, dbs[k])
        bs = store_cls(dbs["bs"])
        conn = conn_mod.MultiAppConn(conn_mod.LocalClientCreator(app_cls()))
        conn.start()
        st = load_state(dbs["state"])
        handshaker(dbs["state"], st, bs, doc).handshake(conn)
        return SimpleNamespace(block_store=bs, state_db=dbs["state"], genesis_doc=doc,
                               tx_indexer=ix_cls(dbs["tx"]), proxy_app=conn,
                               config=SimpleNamespace(rpc=SimpleNamespace(unsafe=False)))

    from tendermint_tpu_torch.consensus.replay import Handshaker

    port = standin(MemDB, BlockStore, KVTxIndexer, GenesisDoc.from_json(doc_json), papp_conn,
                   KVStoreApp, Handshaker, sm_store.load_state)
    ref = standin(RMemDB, RBlockStore, RKVTxIndexer, RGenesisDoc.from_json(doc_json), rapp_conn,
                  RKVStoreApp, RHandshaker, rsm_store.load_state)
    yield SimpleNamespace(port=penv.RPCEnv(port), ref=renv.RPCEnv(ref), txs=txs, heights=heights,
                          top=node.block_store.height())
    port.proxy_app.stop()
    ref.proxy_app.stop()


def _json(x):
    return json.loads(json.dumps(x))


ROUTES = ["block", "blockchain", "block_results", "commit", "validators", "lite_full_commit",
          "tx", "tx_search", "abci_query", "abci_info", "consensus_params", "genesis"]


@pytest.mark.parametrize("route", ROUTES)
def test_the_route_answers_as_the_reference_s(one_chain, route):
    top = one_chain.top
    calls = {
        "block": [dict(height=h) for h in range(1, top + 1)] + [{}],
        "blockchain": [{}, dict(minHeight=1, maxHeight=2), dict(minHeight=2, maxHeight=top)],
        "block_results": [dict(height=h) for h in range(1, top + 1)],
        "commit": [dict(height=h) for h in range(1, top + 1)],
        "validators": [dict(height=h) for h in range(1, top + 1)] + [{}],
        "lite_full_commit": [dict(height=h) for h in range(1, top)],
        "tx": [dict(hash=hashlib.sha256(tx).hexdigest().upper()) for tx in one_chain.txs],
        "tx_search": [dict(query=f"tx.height = {h}") for h in one_chain.heights]
        + [dict(query="app.key = 'alpha'"), dict(query="app.key = 'alpha'", per_page=1, page=2),
           dict(query=f"tx.hash = '{hashlib.sha256(b'beta=2').hexdigest()}'")],
        "abci_query": [dict(path="/store", data=k.hex()) for k in (b"alpha", b"beta", b"nope")],
        "abci_info": [{}],
        "consensus_params": [dict(height=h) for h in (1, top)] + [{}],
        "genesis": [{}],
    }[route]
    for kw in calls:
        got, want = getattr(one_chain.port, route)(**kw), getattr(one_chain.ref, route)(**kw)
        assert _json(got) == _json(want), (route, kw)
    if route == "tx_search":
        assert len(one_chain.port.tx_search("app.key = 'alpha'")["txs"]) == 2
    if route == "lite_full_commit":
        # the bytes decode through the port's RPCProvider into the node's header
        from tendermint_tpu_torch.encoding.codec import Reader
        from tendermint_tpu_torch.types.block import Header

        raw = one_chain.port.lite_full_commit(height=1)
        header = Header.decode(Reader(base64.b64decode(raw["header"])))
        assert header.height == 1


def test_a_missing_height_errs_alike(one_chain):
    for route, kw in (("block", dict(height=10_000)), ("commit", dict(height=10_000)),
                      ("lite_full_commit", dict(height=10_000)),
                      ("block_results", dict(height=10_000)),
                      ("tx", dict(hash="00" * 32))):
        errs = []
        for env, mod in ((one_chain.port, penv), (one_chain.ref, renv)):
            with pytest.raises(mod.RPCError) as ei:
                getattr(env, route)(**kw)
            errs.append((ei.value.code, ei.value.message))
        assert errs[0] == errs[1], route


def test_the_route_tables_are_the_reference_s():
    """Every public route of the reference's RPCEnv is one of the port's."""
    def routes(cls):
        return {m for m in dir(cls) if not m.startswith("_") and callable(getattr(cls, m))}

    assert routes(renv.RPCEnv) == routes(penv.RPCEnv)
