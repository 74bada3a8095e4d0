"""The reference's ``tests/test_localnet.py`` restated on the port's command
line (testutil/cli_net.py): ``testnet`` writes the tree, four ``node``
processes (``--device cpu`` with ``TM_BATCH_VERIFIER=host``, as the
reference's test sets it) peer over TCP and commit together; node 3 runs on a
kvstore this test serves over a socket; a tx through node 3 crosses that
socket; with node 3 killed the other three commit on, and node 3 restarted
with the same command catches up with their app hash; SIGTERM stops every
process with exit code 0. Ports are picked free at run time. Bounded at
120 s.
"""

import base64
import os
import time

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.abci.server import ABCIServer
from tendermint_tpu_torch.testutil.cli_net import CLINet, wait_for

N = 4  # one killed leaves 3/4 > 2/3
BOUND_S = 120.0


def test_four_process_net_commits_and_recovers(tmp_path):
    t0 = time.monotonic()
    env = dict(os.environ, TM_BATCH_VERIFIER="host", JAX_PLATFORMS="cpu")
    net = CLINet(str(tmp_path), N, chain_id="localnet", device="cpu", env=env)
    app = KVStoreApp()
    srv = ABCIServer("tcp://127.0.0.1:0", app)
    srv.start()
    rcs = {}
    try:
        for i in range(N):
            net.spawn_node(i, "kvstore" if i < N - 1 else f"tcp://127.0.0.1:{srv.bound_port}")
        # all peer up and commit together over TCP
        assert wait_for(lambda: all(net.n_peers(i) >= N - 1 for i in range(N)), 60), (
            [net.n_peers(i) for i in range(N)], net.tails())
        assert net.wait_height(3, timeout=60), ([net.height(i) for i in range(N)], net.tails())
        # a tx through node 3: its CheckTx and DeliverTx cross the socket
        res = net.rpc(3, "/broadcast_tx_commit?tx=" + base64.b64encode(b"sock=1").decode(), 30)
        assert res["check_tx"]["code"] == 0 and res["deliver_tx"]["code"] == 0, res
        assert app.query(abci.RequestQuery(data=b"sock", path="/store")).value == b"1"
        assert wait_for(lambda: base64.b64decode(net.rpc(0, "/abci_query?data=%22736f636b%22")[
            "response"]["value"]) == b"1", 30)

        # kill node 3; the other 3/4 keep committing
        net.kill(3)
        h = max(net.height(i) for i in range(N - 1))
        assert net.wait_height(h + 2, range(N - 1), 60)

        # restart it: it rejoins (fast sync) and catches up with their app hash
        net.restart_node(3)
        target = max(net.height(i) for i in range(N - 1))
        assert wait_for(lambda: net.height(3) >= target, 60), (net.height(3), target,
                                                               net.tails())
        hashes = {net.rpc(i, f"/commit?height={target}")["signed_header"]["header"]["app_hash"]
                  for i in (0, 3)}
        assert len(hashes) == 1
        rcs = net.stop_all(10.0)
    finally:
        net.stop_all(10.0)
        srv.stop()
    assert rcs == {f"node{i}": 0 for i in range(N)}, net.tails()
    assert time.monotonic() - t0 < BOUND_S
