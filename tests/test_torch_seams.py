"""The port plugged into the reference's seams (in a test only; port code
never imports the reference):

* the port's device executor (on the CPU: the plain versions of K1 and K2
  and the int64 tally), installed through the reference's
  ``planner.set_device_executor``, makes the reference's
  ``verify_window(use_device=True)`` — its guard, its audit — give the
  reference's host verdicts;
* the port's ``GuardedBatchVerifier(TorchBatchVerifier("cpu"))``,
  installed through the reference's ``crypto.batch.set_batch_verifier``,
  makes the reference's ``blockchain.reactor.verify_block_window`` give the
  host verifier's answers on tests/test_fastsync.py's 4-validator,
  12-height chain: a valid, a tampered and an under-quorum window.

Both seams are restored in teardown. Exact equality throughout."""

import dataclasses

import numpy as np
import pytest
import torch

from tendermint_tpu.blockchain.reactor import verify_block_window
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.libs import breaker as jbrk
from tendermint_tpu.parallel import planner as jplanner
from tendermint_tpu.state.state_types import state_from_genesis
from tendermint_tpu.testutil.chain import build_chain
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.libs import breaker as tbrk
from tendermint_tpu_torch.parallel import planner


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on tensors of a few hundred elements, where
    torch's thread pool buys nothing; one thread keeps this file from
    crowding the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_executor_seam():
    jbrk.reset_device_guard()
    yield
    jplanner.set_device_executor(None)
    jbrk.reset_device_guard()


def _window(sizes, tag, forged=(), absent=(), malformed=()):
    rng = np.random.default_rng(900 + tag)
    votes, powers, totals = [], [], []
    for h, V in enumerate(sizes):
        vrow, prow = [], []
        for v in range(V):
            priv = ted.gen_privkey(rng.bytes(32))
            msg = b"seam-%d-%d-%d" % (tag, h, v)
            sig = ted.sign(priv, msg)
            if (h, v) in forged:
                sig = sig[:9] + bytes([sig[9] ^ 1]) + sig[10:]
            if (h, v) in malformed:
                sig = sig[:63]
            vrow.append(None if (h, v) in absent else (priv[32:], msg, sig))
            prow.append(h + v + 1)
        votes.append(vrow)
        powers.append(prow)
        totals.append(sum(prow) + h)
    return votes, powers, totals


@pytest.mark.parametrize("reduce", planner.REDUCE_MODES)
def test_port_executor_through_the_reference_seam(reference_executor_seam, reduce):
    votes, powers, totals = _window([1, 4, 16, 3], tag=1, forged={(2, 5)},
                                    absent={(1, 0), (3, 2)}, malformed={(2, 9)})
    want = jplanner.verify_window(votes, powers, totals,
                                  verifier=jbatch.HostBatchVerifier(), use_device=False)
    # unsupervised: the plain versions on a loaded CPU can outlast 30 s
    jbrk.configure_device_guard(audit_sample_rate=1.0, dispatch_deadline=0)
    executor = planner.device_executor("cpu")
    calls = []

    def port_executor(plan, mesh=None):
        calls.append(plan.n_lanes)
        return executor(plan, mesh)

    jplanner.set_device_executor(port_executor)
    planner.set_reduce_mode(reduce)
    try:
        got = jplanner.verify_window(votes, powers, totals,
                                     verifier=jbatch.HostBatchVerifier(), use_device=True)
    finally:
        planner.set_reduce_mode("device")
    assert calls == [want.lanes_present]
    for k in ("ok", "tally", "committed", "sigs_ok"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.lanes_dispatched == 64
    # the reference's audit re-verified every wellformed lane and agreed
    assert jbrk.get_device_breaker().state == jbrk.CLOSED
    assert not want.sigs_ok[2] and want.sigs_ok[1]


@pytest.fixture(scope="module")
def chain():
    return build_chain(n_vals=4, n_heights=12, chain_id="vbw-chain")


@pytest.fixture
def port_verifier_installed():
    saved = jbatch._default
    tbrk.reset_device_guard()
    guarded = tbatch.GuardedBatchVerifier(tbatch.TorchBatchVerifier("cpu"), audit_rate=1.0,
                                          deadline=0)  # unsupervised, as above
    jbatch.set_batch_verifier(guarded)
    yield guarded
    jbatch.set_batch_verifier(saved)
    tbrk.reset_device_guard()


def _blocks(chain):
    return [chain.block_store.load_block(h) for h in range(1, chain.height + 1)]


def _tamper(blocks):
    pc = blocks[5].last_commit.precommits[0]
    blocks[5].last_commit.precommits[0] = dataclasses.replace(pc, signature=b"\x00" * 64)


def _under_quorum(blocks):
    pcs = blocks[8].last_commit.precommits
    pcs[2] = None
    pcs[3] = None


@pytest.mark.parametrize("case, mutate, n_ok", [
    ("valid", None, 11), ("tampered", _tamper, 4), ("under_quorum", _under_quorum, 7)])
def test_port_verifier_through_the_reference_seam(chain, port_verifier_installed,
                                                   case, mutate, n_ok):
    st = state_from_genesis(chain.genesis)
    blocks = _blocks(chain)
    if mutate:
        mutate(blocks)
    got = verify_block_window(st, blocks)
    host = verify_block_window(st, blocks, verifier=jbatch.HostBatchVerifier())
    assert got[0] == host[0] == n_ok
    assert (got[1] is None) == (host[1] is None) == (case == "valid")
    if got[1] is not None:
        assert (got[1].bad_index, str(got[1])) == (host[1].bad_index, str(host[1]))
    g = port_verifier_installed
    assert g.snapshot()["dispatches"] == 1 and g.snapshot()["audit_mismatches"] == 0
    assert g.device.stats["ed25519"].dispatches == 1
    assert g.breaker.state == tbrk.CLOSED
