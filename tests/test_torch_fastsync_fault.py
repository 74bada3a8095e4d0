"""Fast sync's device-fault contract (``blockchain/reactor.py``), on a faked
card and off it.

On the card (a guarded verifier whose device is CUDA: a device that raises,
one that answers wrongly for the audit to catch, a tripped breaker) a
``DeviceDispatchError`` or ``DeviceAuditMismatch`` halts fast sync, out of
the synchronous window, a harvested speculative slot, a discarded one, or
the check of the first synced block's LastCommit (the executor's
verifier): it leaves ``_try_sync_window`` unwrapped and recorded as
``device_fault``; ``_pool_routine`` stops the pool and returns; no peer is
stopped, no request is redone, consensus is not switched to; the store and
the state stay at the last height that applied. Off the card the
reference's behaviour holds on both packages: ``FatalSyncError`` with the
supplier punished for a block that does not apply, and a window error
logged and retried. Every wait is bounded.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu_torch.blockchain import pool
from tendermint_tpu_torch.blockchain import reactor
from tendermint_tpu_torch.blockchain import store as bstore
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.db import kv as kvdb
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.types.core import BlockID

from tests.test_torch_fastsync import PKGS, PORT, direct_reactor, fresh_executor

CHAIN_ID = "fault-chain"
DEADLINE = 60.0


@pytest.fixture(autouse=True)
def _verifiers():
    rset_batch_verifier(RHostBatchVerifier())
    root = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield root
    verify_root.reset_verify()


_CHAINS = {}


def fault_chain(ns, n_heights=16):
    key = (ns.name, n_heights)
    if key not in _CHAINS:
        _CHAINS[key] = ns.chain.build_chain(n_vals=4, n_heights=n_heights, chain_id=CHAIN_ID,
                                            **ns.build_kw)
    return _CHAINS[key]


class CardDevice:
    """A device verifier on a faked card: host verdicts, except for a batch
    that ``fails(msgs)`` picks, where ``raise`` raises and ``wrong`` answers
    every lane False (the audit catches it)."""

    device = torch.device("cuda")

    def __init__(self, mode="raise", fails=lambda msgs: True):
        self.mode, self.fails, self.calls = mode, fails, 0
        self.host = tbatch.HostBatchVerifier()

    def verify_ed25519_raw(self, pubs, msgs, sigs):
        self.calls += 1
        if self.fails(msgs):
            if self.mode == "raise":
                raise RuntimeError("kernel launch failed")
            return np.zeros(len(pubs), dtype=bool)
        return self.host.verify_ed25519_raw(pubs, msgs, sigs)

    def verify_ed25519(self, items):
        return self.verify_ed25519_raw([i.pubkey for i in items], [i.msg for i in items],
                                       [i.sig for i in items])

    def verify_secp256k1(self, items):
        return self.verify_ed25519(items)


def guarded(mode="raise", fails=lambda msgs: True, breaker=None, device="cuda"):
    dev = CardDevice(mode, fails)
    dev.device = torch.device(device)
    return tbatch.GuardedBatchVerifier(
        dev, breaker=breaker or brk.CircuitBreaker(threshold=1), deadline=0, retries=0,
        audit_rate=1.0)


def tripped():
    br = brk.CircuitBreaker(threshold=1, backoff_base=600.0, backoff_max=600.0)
    br.record_failure("error")
    assert not br.allow()
    return br


def from_height(fx, h0):
    """A batch picker: True when a sign-bytes of a commit of height >= h0 is in it."""
    late = {fx.block_store.load_block(h + 1).last_commit.precommits[0].sign_bytes(fx.chain_id)
            for h in range(h0, fx.height)}
    return lambda msgs: any(m in late for m in msgs)


class Switch:
    def __init__(self, *peer_ids):
        self.peers = {p: type("Peer", (), {"id": p})() for p in peer_ids}
        self.stopped = []

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append((peer.id, reason))
        self.peers.pop(peer.id, None)

    def broadcast(self, chan_id, msg_bytes):
        pass


def run_routine(bc):
    """``_pool_routine`` on a thread with the pool started; returns once it
    does (bounded)."""
    bc.pool.start()
    t = threading.Thread(target=bc._pool_routine, daemon=True)
    t.start()
    t.join(DEADLINE)
    assert not t.is_alive(), "the pool routine did not return"


def drain(bc):
    """Wait for the reactor's speculative verifies in flight, so that no
    worker thread outlives the test."""
    for spec in list(bc._spec):
        if not spec[2].cancel():
            spec[2].exception(DEADLINE)


def assert_halted(bc, sw, st_store, height, err):
    assert isinstance(bc.device_fault, err)
    assert not bc.pool.is_running
    assert sw.stopped == []
    assert st_store.height() == bc.state.last_block_height == height
    assert not bc._switched.is_set() and bc.fast_sync


FAULTS = {
    "dispatch": (lambda: guarded("raise"), brk.DeviceDispatchError),
    "audit": (lambda: guarded("wrong"), brk.DeviceAuditMismatch),
    "breaker": (lambda: guarded("raise", breaker=tripped()), brk.DeviceDispatchError),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_the_sync_window_halts_fast_sync(fault):
    make, err = FAULTS[fault]
    fx = fault_chain(PORT)
    v = make()
    assert v.on_card
    bc, st_store = direct_reactor(PORT, fx, 4, v, peer_id="peerA")
    with pytest.raises(err):
        bc._try_sync_window()  # unwrapped
    assert isinstance(bc.device_fault, err)
    # through the pool routine, on a fresh reactor and verifier
    bc, st_store = direct_reactor(PORT, fx, 4, make(), peer_id="peerA")
    sw = Switch("peerA")
    bc.set_switch(sw)
    run_routine(bc)
    assert_halted(bc, sw, st_store, 0, err)
    # nothing redone: every block is still in the pool, its supplier kept
    assert [b.height for b in bc.pool.peek_window(100)] == list(range(1, fx.height + 1))
    assert all(r.peer_id == "peerA" for r in bc.pool._requests.values())


def test_a_fault_of_a_harvested_slot_halts_after_the_applied_window():
    fx = fault_chain(PORT)
    v = guarded("raise", fails=from_height(fx, 5))
    bc, st_store = direct_reactor(PORT, fx, 4, v, peer_id="peerA")
    sw = Switch("peerA")
    bc.set_switch(sw)
    bc._try_sync_window()  # verifies 1..4, speculates on 5..8, applies 1..4
    assert st_store.height() == 4 and len(bc._spec) == 1
    bc._spec[0][2].exception(DEADLINE)  # the speculative dispatch has failed
    run_routine(bc)
    assert_halted(bc, sw, st_store, 4, brk.DeviceDispatchError)
    assert [b.height for b in bc.pool.peek_window(100)] == list(range(5, fx.height + 1))


def test_a_fault_of_a_discarded_slot_halts(monkeypatch):
    """Pipeline depth 3 keeps two slots in flight after window 1..4: slot A
    (5..8) and slot B (9..12). A harvests a bad signature at height 6 (its
    supplier punished, as the reference does) and applies 5 only, so B no
    longer starts at the pool's height and is discarded; B's dispatch
    failed on the card, and the drain raises it. The slots verify at once:
    a breaker that opens on B's failure could fail A's dispatch first, so
    the guard's breaker here opens on the tenth failure only."""
    monkeypatch.setattr(planner, "_pipeline_depth", 3)
    fx = fault_chain(PORT)
    bc, st_store = direct_reactor(PORT, fx, 4, guarded("raise", fails=from_height(fx, 9),
                                                       breaker=brk.CircuitBreaker(threshold=10)),
                                  peer_id="peerA")
    blk = bc.pool._requests[7].block  # its LastCommit is height 6's commit
    blk.last_commit.precommits[0] = dataclasses.replace(blk.last_commit.precommits[0],
                                                        signature=bytes(64))
    sw = Switch("peerA")
    bc.set_switch(sw)
    bc._try_sync_window()  # 1..4; slots A and B in flight
    assert st_store.height() == 4 and [s[0] for s in bc._spec] == [5, 9]
    for s in bc._spec:
        s[2].exception(DEADLINE)  # both dispatches have ended
    bc._try_sync_window()  # harvests A: 5 applies, 6 is bad
    assert st_store.height() == 5 and sw.stopped == [("peerA", "sent bad block 6")]
    with pytest.raises(brk.DeviceDispatchError):
        bc._try_sync_window()  # B is discarded: its drained fault is raised
    assert bc._spec == [] and isinstance(bc.device_fault, brk.DeviceDispatchError)
    # the same through the pool routine
    bc, st_store = direct_reactor(PORT, fx, 4, guarded("raise", fails=from_height(fx, 9),
                                                       breaker=brk.CircuitBreaker(threshold=10)),
                                  peer_id="peerA")
    blk = bc.pool._requests[7].block
    blk.last_commit.precommits[0] = dataclasses.replace(blk.last_commit.precommits[0],
                                                        signature=bytes(64))
    sw = Switch("peerA")
    bc.set_switch(sw)
    run_routine(bc)
    assert isinstance(bc.device_fault, brk.DeviceDispatchError) and not bc.pool.is_running
    assert sw.stopped == [("peerA", "sent bad block 6")]  # the bad block's, not the fault's
    assert st_store.height() == bc.state.last_block_height == 5
    assert not bc._switched.is_set()


def test_a_fault_of_the_first_synced_block_leaves_the_store_at_the_state():
    """A node restarted at height 4: block 5's LastCommit predates the
    windows and is verified by the executor's verifier (on the card) before
    block 5 is saved; its failure halts with the store and the state at 4."""
    fx = fault_chain(PORT)
    host = tbatch.HostBatchVerifier()
    st, ex = fresh_executor(PORT, fx.genesis, verifier=host)
    st_store = bstore.BlockStore(kvdb.MemDB())
    for h in range(1, 5):
        block = fx.block_store.load_block(h)
        parts = block.make_part_set()
        st_store.save_block(block, parts, fx.block_store.load_block(h + 1).last_commit)
        st = ex.apply_block(st, BlockID(block.hash(), parts.header()), block)
    ex.verifier = guarded("raise")
    bc = reactor.BlockchainReactor(st, ex, st_store, verifier=host, verify_window=4)
    for h in range(5, fx.height + 1):
        bc.pool._requests[h] = pool._Request(height=h, block=fx.block_store.load_block(h),
                                             peer_id="peerA")
    sw = Switch("peerA")
    bc.set_switch(sw)
    run_routine(bc)
    assert_halted(bc, sw, st_store, 4, brk.DeviceDispatchError)
    assert [b.height for b in bc.pool.peek_window(100)] == list(range(5, fx.height + 1))


# -- off the card: the reference's behaviour, on both packages -------------------------


class FailingApply:
    """An executor whose apply_block fails at ``height``."""

    def __init__(self, inner, height):
        self.inner, self.height, self.verifier = inner, height, None

    def validate_block(self, state, block, trusted_last_commit=False):
        return self.inner.validate_block(state, block, trusted_last_commit)

    def apply_block(self, state, block_id, block, trusted_last_commit=False):
        if block.height == self.height:
            raise ValueError("app refused the block")
        return self.inner.apply_block(state, block_id, block, trusted_last_commit)


@PKGS
def test_off_the_card_an_unappliable_block_is_fatal_and_punished(pkg):
    fx = fault_chain(pkg)
    bc, st_store = direct_reactor(pkg, fx, 4, None, peer_id="peerA")
    bc.block_exec = FailingApply(bc.block_exec, 3)
    sw = Switch("peerA")
    bc.set_switch(sw)
    with pytest.raises(pkg.reactor.FatalSyncError, match="verified block 3 failed to apply"):
        bc._try_sync_window()
    assert sw.stopped == [("peerA", "sent unappliable block 3")]
    assert st_store.height() == 3 and bc.state.last_block_height == 2  # saved, not applied
    drain(bc)
    bc2, _ = direct_reactor(pkg, fx, 4, None, peer_id="peerA")
    bc2.block_exec = FailingApply(bc2.block_exec, 3)
    bc2.set_switch(Switch("peerA"))
    run_routine(bc2)  # halts on FatalSyncError
    drain(bc2)
    assert not bc2.pool.is_running
    assert getattr(bc2, "device_fault", None) is None


def test_off_the_card_a_device_error_of_apply_block_is_the_references_fatal_error():
    """The executor's verifier off the card: apply_block wraps its
    DeviceDispatchError as InvalidBlockError, and fast sync punishes and
    halts as the reference does."""

    class OffCard:
        def verify_ed25519_raw(self, pubs, msgs, sigs):
            raise brk.DeviceDispatchError("error", "a test verifier")

    fx = fault_chain(PORT)
    host = tbatch.HostBatchVerifier()
    st, ex = fresh_executor(PORT, fx.genesis, verifier=host)
    st_store = bstore.BlockStore(kvdb.MemDB())
    block1 = fx.block_store.load_block(1)
    parts = block1.make_part_set()
    st_store.save_block(block1, parts, fx.block_store.load_block(2).last_commit)
    st = ex.apply_block(st, BlockID(block1.hash(), parts.header()), block1)
    ex.verifier = OffCard()
    bc = reactor.BlockchainReactor(st, ex, st_store, verifier=host, verify_window=4)
    for h in range(2, fx.height + 1):
        bc.pool._requests[h] = pool._Request(height=h, block=fx.block_store.load_block(h),
                                             peer_id="peerA")
    sw = Switch("peerA")
    bc.set_switch(sw)
    with pytest.raises(reactor.FatalSyncError) as ei:
        bc._try_sync_window()
    assert isinstance(ei.value.__cause__, execution.InvalidBlockError)
    assert sw.stopped == [("peerA", "sent unappliable block 2")]
    assert bc.device_fault is None


@PKGS
def test_off_the_card_a_window_error_is_logged_and_retried(pkg, caplog):
    class Raising:
        def __init__(self):
            self.calls = 0

        def verify_ed25519(self, items):
            self.calls += 1
            raise RuntimeError("verifier unavailable")

        verify_secp256k1 = verify_ed25519

    fx = fault_chain(pkg)
    v = Raising()
    bc, st_store = direct_reactor(pkg, fx, 4, v, peer_id="peerA")
    sw = Switch("peerA")
    bc.set_switch(sw)
    bc.pool.start()
    t = threading.Thread(target=bc._pool_routine, daemon=True)
    with caplog.at_level("ERROR"):
        t.start()
        deadline = time.monotonic() + DEADLINE
        while v.calls < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        bc.stop() if bc.is_running else bc._quit.set()
        t.join(DEADLINE)
    assert not t.is_alive()
    assert v.calls >= 3  # retried every TRY_SYNC_INTERVAL
    assert "fast sync window failed" in caplog.text
    assert sw.stopped == [] and st_store.height() == 0
    assert getattr(bc, "device_fault", None) is None
    bc.pool.stop()


def test_off_the_card_a_guarded_dispatch_failure_completes_on_the_host():
    """The guarded verifier off the card falls back to the host oracle:
    the window verifies and fast sync goes on."""
    fx = fault_chain(PORT)
    v = guarded("raise", device="cpu")
    assert not v.on_card
    bc, st_store = direct_reactor(PORT, fx, 4, v)
    bc._try_sync_window()
    assert st_store.height() == 4 and bc.device_fault is None
    bc.on_stop()
