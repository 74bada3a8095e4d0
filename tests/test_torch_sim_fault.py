"""The port's simulator under device faults: ``FaultyDevice`` behind the
guarded verifier, off the card and on a faked card.

* ``device_flap`` and ``signed_flood`` on the port (``device="cpu"``), with
  the reference's ``FaultyDevice(HostBatchVerifier())``: off the card the
  guard falls back to the host as the reference's does. ``signed_flood``'s
  CheckTx windows run the installed verifier, as they do on the card (a
  feed given no verifier runs the installed one there); on the CPU a feed
  defaults to the host RLC, which the flap never reaches, and then only a
  LastCommit check that happens to fall inside the flap's few milliseconds
  meets it (the reference's own scenario misses it about one run in three
  on a CPU host).
* The mempool keeps two CheckTx windows' sends in submission order when
  their hooks finish out of order (``signed_flood``'s serial oracle needs a
  sender's nonce 2 after its nonce 1).
* On a faked card (a host verifier whose ``.device`` is CUDA, the pattern
  of ``tests/test_torch_consensus_fault.py``'s ``OnCard``):
  ``testutil/sim_fault.card_fault_scenario``, a ``FaultyDevice`` that
  answers some calls and then fails behind the one guarded verifier every
  node shares. Its guard is on the card, so the fault halts every node that
  dispatches after it with ``DeviceDispatchError`` (no host fallback), no
  store passes the height being decided, and every verdict before the
  fault equals the host's.
"""

import threading
import time

import pytest
import torch

from tendermint_tpu.crypto import batch as r_batch
from tendermint_tpu_torch.abci.examples import kvstore as kv
from tendermint_tpu_torch.crypto import batch as p_batch
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.sim import SCENARIOS, run_scenario
from tendermint_tpu_torch.testutil import sim_fault


@pytest.fixture(autouse=True)
def _verifiers():
    r_prev = r_batch._default
    yield
    verify_root.reset_verify()
    r_batch.set_batch_verifier(r_prev)


class CardHost(p_batch.HostBatchVerifier):
    """A host verifier that claims the card (only ``.device`` is read)."""

    device = torch.device("cuda")


def test_device_flap_off_the_card():
    result = run_scenario(SCENARIOS["device_flap"](), device="cpu")
    assert result.ok, f"seed={result.seed} failures={result.failures}"
    assert [m for m in result.marks] == ["fail", "recover_fail", "hang", "recover_hang",
                                         "corrupt", "operator_reset"]


def _feeds_on_the_installed_verifier(scenario):
    setup = scenario.setup

    def wired(run):
        setup(run)
        for n in run.nodes:
            if n.tx_feed is not None:
                n.tx_feed.verifier = p_batch.get_batch_verifier()

    scenario.setup = wired
    return scenario


def test_signed_flood_off_the_card():
    result = run_scenario(_feeds_on_the_installed_verifier(SCENARIOS["signed_flood"]()),
                          device="cpu")
    assert result.ok, f"seed={result.seed} failures={result.failures}"


class _SlowFirstHook:
    """A verdict-bearing CheckTx hook whose first window answers last."""

    def __init__(self):
        self.calls = 0
        self.first_waits = threading.Event()

    def __call__(self, txs):
        self.calls += 1
        if self.calls == 1:
            self.first_waits.set()
            time.sleep(0.3)
        return [None] * len(txs)  # the app verifies


def test_checktx_windows_reach_the_app_in_submission_order():
    app = kv.SignedKVStoreApp()
    conn = MultiAppConn(LocalClientCreator(app))
    conn.start()
    try:
        mp = Mempool(conn.mempool, checktx_batch=2, checktx_batch_wait=5.0)
        hook = _SlowFirstHook()
        mp.set_batch_check_hook(hook, verdicts=True)
        key = PrivKeyEd25519.generate(b"\x05" * 32)
        codes = {}
        # window 1 (nonces 1, 2) is closed by the submitting thread and waits
        # in its hook; window 2 (nonces 3, 4) closes on another thread and
        # its hook answers at once
        t = threading.Thread(target=lambda: [
            mp.check_tx(kv.make_signed_tx(key, n, b"k%d=v" % n),
                        lambda res, n=n: codes.__setitem__(n, res.code)) for n in (1, 2)])
        t.start()
        assert hook.first_waits.wait(10.0)
        for n in (3, 4):
            mp.check_tx(kv.make_signed_tx(key, n, b"k%d=v" % n),
                        lambda res, n=n: codes.__setitem__(n, res.code))
        t.join(10.0)
        assert codes == {1: 0, 2: 0, 3: 0, 4: 0}
        assert mp.size() == 4 and hook.calls == 2
    finally:
        conn.stop()


def _wire_card(run, guarded):
    # the feeds on the faked card: their flushes run the shared guarded
    # verifier, as a card feed given no verifier does
    for n in run.nodes:
        n.vote_feed.verifier = guarded
        n.vote_feed.device = torch.device("cuda")
        assert brk.on_card(n.vote_feed)


@pytest.mark.parametrize("n_ok", [6, 24])
def test_a_card_fault_halts_the_net(n_ok):
    """A fault in the first heights' flushes (after 6 answered calls) and a
    height later (after 24): every node that dispatches after it halts, and
    the net stops."""
    result = run_scenario(sim_fault.card_fault_scenario(CardHost, n_ok=n_ok, wire=_wire_card),
                          device="cpu")
    assert result.ok, f"failures={result.failures}"
    assert "fault" in result.marks and "halted" in result.marks
    assert result.marks["halted"]["heights"] == result.heights


def test_the_fault_run_falls_back_off_the_card():
    """The same schedule around a host verifier (off the card): the guard
    completes each failed dispatch on the host, as the reference's does, and
    the net does not halt: it passes the height of the fault."""
    sc = sim_fault.card_fault_scenario(p_batch.HostBatchVerifier, n_ok=6, halt_timeout=4.0)
    sc.drive = lambda run: [] if run.wait_for(
        lambda: "fault" in run.marks and min(run.heights()) > max(run.marks["fault"]["heights"]),
        30.0) else [f"no progress past the fault: {run.heights()} {run.marks}"]
    sc.check = lambda run: [repr(n.cs.device_fault) for n in run.nodes if n.cs.device_fault]
    result = run_scenario(sc, device="cpu")
    assert result.ok, result.failures
