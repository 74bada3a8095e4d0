"""The RPC routes' device-fault contract (ROADMAP queue 3, "Deliberate
differences"), on a faked card and off it.

On the card a device fault never becomes a host verdict and is never
swallowed:

* ``commit`` / ``validators`` with ``verify``: the burst's ``LaneFeed``
  takes the guarded device executor; a dispatch the guard fails
  (``DeviceDispatchError``, or ``DeviceAuditMismatch`` after a quarantine)
  is a JSON-RPC error -32603 that names the fault, with no
  ``verification``; the breaker stays as the guard set it
  (``dump_device_health``).
* ``broadcast_tx_sync`` / ``broadcast_tx_commit``: a tx whose CheckTx
  window fails, on the caller's thread or on the mempool's wait timer, gets
  a -32603 error naming the device fault well inside the 10 s CheckTx wait
  (bounded here at 2 s); the in-flight slot is freed and
  ``broadcast_tx_commit``'s subscription released.

Off the card both behave as the reference's: the burst takes the verifier
route and its guard falls back to the host, and a failed CheckTx hook hands
the window to the app's serial verify. An app's rejection and a
``MempoolError`` map as the reference maps them.

The card is faked as in ``tests/test_torch_mempool_feed.py``: an executor,
a verifier device or a verdict hook whose ``.device`` is CUDA.
"""

import base64
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tendermint_tpu.abci.examples import kvstore as rkv
from tendermint_tpu.mempool import mempool as rmempool
from tendermint_tpu.proxy import app_conn as rapp_conn
from tendermint_tpu.rpc.core import env as renv
from tendermint_tpu_torch.abci.examples import kvstore as kv
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.mempool import mempool as pmempool
from tendermint_tpu_torch.mempool.tx_verify import BatchTxVerifier
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.proxy import app_conn as papp_conn
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
from tendermint_tpu_torch.rpc.core import env as penv
from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.testutil import node_net
from tendermint_tpu_torch.types.events import EventBus

FAULT_BOUND_S = 2.0  # the bound on an on-card fault's answer (the wait is 10 s)
PRIVS = [PrivKeyEd25519.generate(bytes([i + 7]) * 32) for i in range(4)]
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def _clean():
    brk.reset_device_guard()
    yield
    verify_root.reset_verify()


@pytest.fixture
def closing():
    items = []
    yield items.append
    for it in reversed(items):
        try:
            it.stop() if hasattr(it, "stop") else it.close()
        except Exception:
            pass


def b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


# -- ?verify=1 ------------------------------------------------------------------------


def card_executor(fault: str):
    """A device executor on a faked card: ``raise`` fails every dispatch;
    ``flip`` returns the host's verdicts with every lane flipped (the audit
    then quarantines the device path)."""
    def exe(plan, mesh=None):
        if fault == "raise":
            raise RuntimeError("kernel launch failed")
        v = planner._execute_host(plan, tbatch.HostBatchVerifier())
        v.ok = ~np.asarray(v.ok)
        return v
    exe.device = CUDA
    return exe


@pytest.fixture
def verify_node(tmp_path):
    """A live single-validator node at height 3 or more, the host verifying;
    its RPC's lane feed not made yet."""
    node = node_net.make_single_node(str(tmp_path / "node"))
    node_net.install_host_verify()
    node.start()
    try:
        assert node_net.wait_for(lambda: node.block_store.height() >= 3, 30)
        yield node
    finally:
        node.stop()


@pytest.mark.parametrize("fault,err", [("raise", "DeviceDispatchError"),
                                       ("flip", "DeviceAuditMismatch")])
@pytest.mark.parametrize("route", ["commit", "validators"])
def test_on_the_card_a_failed_burst_is_an_rpc_error_with_no_verdict(verify_node, fault, err,
                                                                      route):
    brk.configure_device_guard(dispatch_deadline=0, audit_sample_rate=1.0, retries=0,
                               breaker_threshold=1)
    planner.set_device_executor(card_executor(fault))
    client = HTTPClient(f"tcp://127.0.0.1:{verify_node.rpc_server.bound_port}")
    with pytest.raises(RPCClientError) as ei:
        client.call(route, height=2, verify=1)
    assert ei.value.code == -32603 and err in str(ei.value)
    assert verify_node._rpc_env._feed.use_device is True
    # the route without verify still answers, and the guard's state shows
    assert "verification" not in client.call(route, height=2)
    health = client.dump_device_health()
    assert health["breaker"]["state"] == ("quarantined" if fault == "flip" else "open")
    assert any(e["kind"] in ("device_failure", "audit_mismatch") for e in health["events"])


def test_off_the_card_the_burst_takes_the_verifier_route_and_falls_back(verify_node):
    """The reference's behaviour: a failing device under the guard falls
    back to the host, and the verdict is the host's."""
    brk.configure_device_guard(dispatch_deadline=0, retries=0)

    class Failing:
        device = torch.device("cpu")
        name = backend = "failing"

        def verify_ed25519(self, items):
            raise RuntimeError("device lost")

        verify_ed25519_raw = verify_secp256k1 = verify_ed25519

    guarded = tbatch.GuardedBatchVerifier(Failing())
    tbatch.set_batch_verifier(guarded)
    exe = card_executor("raise")
    exe.device = torch.device("cpu")  # off the card
    planner.set_device_executor(exe)
    client = HTTPClient(f"tcp://127.0.0.1:{verify_node.rpc_server.bound_port}")
    ver = client.call("commit", height=2, verify=1)["verification"]
    assert ver["verified"] is True and ver["sigs_ok"] is True and ver["tally"] == 10
    assert verify_node._rpc_env._feed.use_device is None  # the verifier route
    assert brk.get_device_breaker().snapshot()["failures_total"] >= 1


# -- broadcast_tx_* -------------------------------------------------------------------


class CardHook:
    """A verdict hook on a faked card: a ``BatchTxVerifier`` over a CPU
    ``TxFeed`` whose verifier is a guarded one on a failing device
    (``raise``: the guard raises ``DeviceDispatchError`` and counts a
    breaker failure) or over a feed that never answers (``hang``: the
    verifier's timeout)."""

    device = CUDA

    def __init__(self, fault, closing):
        self.fault = fault
        if fault == "hang":
            class Silent:
                device = CUDA

                def submit(self, *a, **k):
                    return planner.TxTicket()

                def flush_now(self):
                    pass

            self.ver = BatchTxVerifier(Silent(), kv.extract_signed_tx_sig, timeout_s=0.05)
            return

        class FailingCard:
            device = CUDA
            name = backend = "failing-card"

            def verify_ed25519(self, items):
                raise RuntimeError("kernel launch failed")

            verify_ed25519_raw = verify_secp256k1 = verify_ed25519

        feed = planner.TxFeed(window_s=0.002, device="cpu",
                              verifier=tbatch.GuardedBatchVerifier(FailingCard()))
        closing(feed)
        self.ver = BatchTxVerifier(feed, kv.extract_signed_tx_sig)

    def __call__(self, txs):
        return self.ver(txs)


def card_env(closing, fault, *, batch, budget=4, on_card=True):
    app = kv.SignedKVStoreApp()
    conn = papp_conn.MultiAppConn(papp_conn.LocalClientCreator(app))
    conn.start()
    closing(conn)
    mp = pmempool.Mempool(conn.mempool, checktx_batch=batch, checktx_batch_wait=0.02)
    hook = CardHook(fault, closing)
    if not on_card:
        hook.device = torch.device("cpu")
    mp.set_batch_check_hook(hook, verdicts=True)
    bus = EventBus()
    bus.start()
    closing(bus)
    node = SimpleNamespace(config=SimpleNamespace(rpc=SimpleNamespace(
        broadcast_max_in_flight=budget, unsafe=True)), mempool=mp, metrics=NodeMetrics(),
        event_bus=bus)
    return penv.RPCEnv(node), node, app


def subscribers(bus) -> int:
    return sum(len(v) for v in bus._server._subs.values())


@pytest.mark.parametrize("fault", ["raise", "hang"])
@pytest.mark.parametrize("where", ["caller", "timer"])
@pytest.mark.parametrize("route", ["sync", "commit"])
def test_on_the_card_a_failed_checktx_window_answers_at_once(closing, fault, where, route):
    brk.configure_device_guard(dispatch_deadline=0, retries=0, breaker_threshold=1)
    env, node, app = card_env(closing, fault, batch=1 if where == "caller" else 8)
    subs0 = subscribers(node.event_bus)
    tx = kv.make_signed_tx(PRIVS[0], 1, b"f=1")
    t0 = time.perf_counter()
    with pytest.raises(penv.RPCError) as ei:
        getattr(env, f"broadcast_tx_{route}")(b64(tx))
    took = time.perf_counter() - t0
    assert took < FAULT_BOUND_S, took
    assert ei.value.code == -32603 and "device" in ei.value.message
    assert "DeviceDispatchError" in ei.value.message
    # the slot and the subscription are released; nothing was admitted
    assert env._broadcast_in_flight == 0 and subscribers(node.event_bus) == subs0
    assert node.mempool.size() == 0 and app.serial_verifies == 0
    if fault == "raise":  # the guard's breaker as it left it
        assert brk.get_device_breaker().state == brk.OPEN
    if where == "timer":  # the kept failure reaches the next call, once
        with pytest.raises(penv.RPCError, match="DeviceDispatchError"):
            env.broadcast_tx_async(b64(kv.make_signed_tx(PRIVS[1], 1, b"g=1")))


def test_on_the_card_a_timer_fault_reaches_every_waiting_caller(closing):
    """Four broadcast_tx_sync callers in one window that fails on the wait
    timer: each gets the device fault's error inside the bound."""
    brk.configure_device_guard(dispatch_deadline=0, retries=0)
    env, node, _ = card_env(closing, "raise", batch=8)
    out = []

    def call(i):
        t0 = time.perf_counter()
        try:
            env.broadcast_tx_sync(b64(kv.make_signed_tx(PRIVS[i], 1, b"w%d=1" % i)))
            out.append(("ok", time.perf_counter() - t0))
        except penv.RPCError as e:
            out.append((e.message, time.perf_counter() - t0))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len(out) == 4
    assert all("DeviceDispatchError" in m and s < FAULT_BOUND_S for m, s in out), out
    assert env._broadcast_in_flight == 0


def test_on_the_card_over_http_the_fault_is_a_jsonrpc_error(closing):
    brk.configure_device_guard(dispatch_deadline=0, retries=0)
    env, node, _ = card_env(closing, "raise", batch=8)
    server = RPCServer("tcp://127.0.0.1:0", env)
    server.start()
    closing(server)
    client = HTTPClient(f"tcp://127.0.0.1:{server.bound_port}")
    with pytest.raises(RPCClientError) as ei:
        client.broadcast_tx_commit(kv.make_signed_tx(PRIVS[0], 1, b"h=1"))
    assert ei.value.code == -32603 and "DeviceDispatchError" in str(ei.value)


@pytest.mark.parametrize("where", ["caller", "timer"])
def test_off_the_card_a_failed_hook_falls_back_to_the_app(closing, where):
    """The reference's behaviour: the window goes to the app's serial
    verify and the tx is admitted."""
    brk.configure_device_guard(dispatch_deadline=0, retries=0)
    env, node, app = card_env(closing, "hang", batch=1 if where == "caller" else 8,
                              on_card=False)
    res = env.broadcast_tx_sync(b64(kv.make_signed_tx(PRIVS[2], 1, b"o=1")))
    assert res["code"] == 0 and node.mempool.size() == 1 and app.serial_verifies == 1


# -- an app's error and a MempoolError map as the reference's ---------------------


def both_envs(closing):
    out = []
    for conn_mod, mp_mod, app_mod, env_mod in ((papp_conn, pmempool, kv, penv),
                                               (rapp_conn, rmempool, rkv, renv)):
        conn = conn_mod.MultiAppConn(conn_mod.LocalClientCreator(app_mod.SignedKVStoreApp()))
        conn.start()
        closing(conn)
        mp = mp_mod.Mempool(conn.mempool, size=2)
        node = SimpleNamespace(config=SimpleNamespace(rpc=SimpleNamespace(
            broadcast_max_in_flight=8)), mempool=mp, metrics=None, event_bus=None)
        out.append((env_mod.RPCEnv(node), env_mod))
    return out


def test_app_errors_and_mempool_errors_map_as_the_reference_s(closing):
    good = kv.make_signed_tx(PRIVS[0], 1, b"a=1")
    bad_sig = bytearray(kv.make_signed_tx(PRIVS[1], 1, b"b=1"))
    bad_sig[-1] ^= 1
    answers = []
    for env, mod in both_envs(closing):
        got = []
        for tx in (good, bytes(bad_sig), good, b"x" * (2 << 20), b"not-a-signed-tx"):
            try:
                res = env.broadcast_tx_sync(b64(tx))
                got.append(("ok", res["code"], res["hash"]))
            except mod.RPCError as e:
                got.append(("rpc", e.code, e.message))
            except Exception as e:  # the server's -32603 with the message
                got.append(("error", type(e).__name__, str(e)))
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[0][0][1] == 0 and answers[0][1][1] != 0
    assert answers[0][2][:2] == ("rpc", -32603)  # a cache hit
