"""The block executor's verification boundary and its failure contract
(``state/execution.py``, ``state/validation.py``,
``node/verify_root.block_executor``).

``validate_block`` checks each LastCommit through the port's guarded
verifier on ``device="cpu"`` (the kernels' plain versions) at
``dispatch_deadline=0``: a valid chain applies, a flipped signature bit and
an under-quorum LastCommit are ``InvalidBlockError``, and
``trusted_last_commit=True`` skips the signature check only. On a faked
card (a verifier or a mempool hook whose device is CUDA) a device fault
leaves ``apply_block`` as ``DeviceDispatchError`` or ``DeviceAuditMismatch``
with nothing applied or saved, and a recheck window that fails inside
``Mempool.update`` raises after the app's Commit with the mempool unlocked,
the height's ABCI responses saved and the state not. Off the card the
reference's wrapping holds. Every wait is bounded.
"""

import threading

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.abci.examples import kvstore as kv
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.metrics import StateMetrics, get_verify_metrics
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.state import store
from tendermint_tpu_torch.state.execution import (
    BlockExecutor,
    InvalidBlockError,
    update_validators,
)
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.state.validation import BlockValidationError
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.validator_set import CommitError
from tendermint_tpu_torch.types.vote import Vote

CHAIN_ID = "exec-boundary"
TIME0 = 1_700_000_000_000_000_000
N_VALS = 4
LOCK_TIMEOUT = 10.0


@pytest.fixture
def root():
    r = verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield r
    verify_root.reset_verify()


def genesis(n=N_VALS):
    pvs = [MockPV(PrivKeyEd25519.generate(bytes([i + 1]) * 32)) for i in range(n)]
    doc = GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=TIME0,
                     validators=[GenesisValidator(pv.get_pub_key(), 10) for pv in pvs])
    doc.validate_and_complete()
    return doc, pvs


class Node:
    """A state DB at genesis, an app over a local connection, a mempool on
    it and an executor; ``pvs`` sign for the validators."""

    def __init__(self, verifier=None, app=None, mempool_kw=None):
        doc, self.pvs = genesis()
        self.state = state_from_genesis(doc)
        self.db = MemDB()
        store.save_state(self.db, self.state)
        self.app = app or kv.KVStoreApp()
        self.conn = MultiAppConn(LocalClientCreator(self.app))
        self.conn.start()
        self.mempool = Mempool(self.conn.mempool, **(mempool_kw or {}))
        self.executor = BlockExecutor(self.db, self.conn.consensus, mempool=self.mempool,
                                      verifier=verifier)

    def block(self, st, height, txs, last_commit):
        block = st.make_block(height, txs, last_commit,
                              proposer_address=st.validators.get_proposer().address)
        return block, BlockID(hash=block.hash(), parts_header=block.make_part_set().header())

    def commit_for(self, st, block, block_id, skip=()):
        by_addr = {pv.get_pub_key().address(): pv for pv in self.pvs}
        pcs = []
        for i, val in enumerate(st.validators.validators):
            if i in skip:
                pcs.append(None)
                continue
            pcs.append(by_addr[val.address].sign_vote(CHAIN_ID, Vote(
                SignedMsgType.PRECOMMIT, block.height, 0, block.header.time_ns + 1_000_000,
                block_id, val.address, i)))
        return Commit(block_id=block_id, precommits=pcs)

    def apply(self, st, height, txs, last_commit, **kw):
        block, bid = self.block(st, height, txs, last_commit)
        new = self.executor.apply_block(st, bid, block, **kw)
        return new, self.commit_for(st, block, bid)

    def height2(self, txs=(b"b=2",)):
        """(state after block 1, block 2, its id): block 2 carries block 1's
        commit as its LastCommit."""
        st1, c1 = self.apply(self.state, 1, [b"a=1"], Commit())
        block2, bid2 = self.block(st1, 2, list(txs), c1)
        return st1, block2, bid2

    def snapshot(self):
        return list(self.db.iterator())

    def close(self):
        self.conn.stop()


@pytest.fixture
def nodes():
    made = []

    def make(**kw):
        n = Node(**kw)
        made.append(n)
        return n
    yield make
    for n in made:
        n.close()


def with_last_commit(node, st1, block2, commit):
    """Block 2 rebuilt around another LastCommit (its hash and time
    follow)."""
    block, bid = node.block(st1, 2, list(block2.data.txs), commit)
    return block, bid


def lock_is_free(mp) -> bool:
    """Whether another thread can take the mempool's lock."""
    got = []

    def take():
        if mp._mtx.acquire(timeout=LOCK_TIMEOUT):
            got.append(True)
            mp._mtx.release()
    t = threading.Thread(target=take)
    t.start()
    t.join(LOCK_TIMEOUT + 5)
    return got == [True]


# -- validate_block through the guarded verifier ---------------------------------------


def test_a_valid_chain_applies_through_the_guarded_verifier(root, nodes):
    node = nodes()
    st, last = node.state, Commit()
    d0 = root.verifier.snapshot()["dispatches"]
    for h in range(1, 5):
        st, last = node.apply(st, h, [b"k%d=v" % h], last)
    assert st.last_block_height == 4 and st.last_block_total_tx == 4
    assert store.load_state(node.db).marshal() == st.marshal()
    # heights 2-4 each verified their LastCommit in one guarded dispatch
    assert root.verifier.snapshot()["dispatches"] - d0 == 3


def test_a_flipped_last_commit_bit_is_an_invalid_block(root, nodes):
    node = nodes()
    st1, block2, _ = node.height2()
    bad = tc.flip_signature_bit(block2.last_commit, 1, 300)
    block, bid = with_last_commit(node, st1, block2, bad)
    before = node.snapshot()
    with pytest.raises(InvalidBlockError, match="invalid signature") as ei:
        node.executor.apply_block(st1, bid, block)
    assert isinstance(ei.value.__cause__, CommitError)
    assert node.snapshot() == before


def test_an_under_quorum_last_commit_is_an_invalid_block(root, nodes):
    node = nodes()
    st1, block2, _ = node.height2()
    c1 = block2.last_commit
    short = Commit(block_id=c1.block_id,
                   precommits=[pc if i < 2 else None for i, pc in enumerate(c1.precommits)])
    block, bid = with_last_commit(node, st1, block2, short)
    with pytest.raises(InvalidBlockError, match="insufficient voting power"):
        node.executor.apply_block(st1, bid, block)


def test_trusted_last_commit_skips_only_the_signature_check(root, nodes):
    node = nodes()
    st1, block2, _ = node.height2()
    bad = tc.flip_signature_bit(block2.last_commit, 1, 300)
    block, bid = with_last_commit(node, st1, block2, bad)
    d0 = root.verifier.snapshot()["dispatches"]
    st2 = node.executor.apply_block(st1.copy(), bid, block, trusted_last_commit=True)
    assert st2.last_block_height == 2
    assert root.verifier.snapshot()["dispatches"] == d0  # no signature was verified
    # the structural checks still run: a short commit and a wrong time
    node2 = nodes()
    st1b, block2b, _ = node2.height2()
    short = Commit(block_id=block2b.last_commit.block_id,
                   precommits=block2b.last_commit.precommits[:-1])
    blk, bid2 = with_last_commit(node2, st1b, block2b, short)
    with pytest.raises(InvalidBlockError, match="invalid commit size"):
        node2.executor.apply_block(st1b, bid2, blk, trusted_last_commit=True)
    blk, bid2 = node2.block(st1b, 2, [], block2b.last_commit)
    blk.header.time_ns += 1
    bid2 = BlockID(hash=blk.hash(), parts_header=blk.make_part_set().header())
    with pytest.raises(InvalidBlockError, match="invalid block time") as ei:
        node2.executor.apply_block(st1b, bid2, blk, trusted_last_commit=True)
    assert isinstance(ei.value.__cause__, BlockValidationError)


# -- the device-fault contract -----------------------------------------------------------


class CardDevice:
    """A device verifier on a faked card: ``raise`` fails every dispatch,
    ``wrong`` answers every lane False (the audit catches it)."""

    def __init__(self, mode, device="cuda"):
        self.mode = mode
        self.device = torch.device(device)
        self.calls = 0

    def verify_ed25519_raw(self, pubs, msgs, sigs):
        self.calls += 1
        if self.mode == "raise":
            raise RuntimeError("kernel launch failed")
        return np.zeros(len(pubs), dtype=bool)

    def verify_ed25519(self, items):
        return self.verify_ed25519_raw([i.pubkey for i in items], [i.msg for i in items],
                                       [i.sig for i in items])

    def verify_secp256k1(self, items):
        return self.verify_ed25519(items)


def guarded(mode, device="cuda", breaker=None):
    return tbatch.GuardedBatchVerifier(
        CardDevice(mode, device), breaker=breaker or brk.CircuitBreaker(threshold=1),
        deadline=0, retries=0, audit_rate=1.0)


def tripped():
    br = brk.CircuitBreaker(threshold=1, backoff_base=600.0, backoff_max=600.0)
    br.record_failure("error")
    assert not br.allow()
    return br


FAULTS = {
    "dispatch": (lambda: guarded("raise"), brk.DeviceDispatchError),
    "audit": (lambda: guarded("wrong"), brk.DeviceAuditMismatch),
    "breaker": (lambda: guarded("raise", breaker=tripped()), brk.DeviceDispatchError),
}


def _fault_on_card(nodes, make, given: bool):
    """Block 2 applied by an executor whose verifier (given, or installed
    with the executor's left None) is on the faked card."""
    v = make()
    assert v.on_card
    node = nodes()
    st1, block2, bid2 = node.height2()
    if given:
        node.executor.verifier = v
    else:
        tbatch.set_batch_verifier(v)
    return node, st1, block2, bid2


@pytest.mark.parametrize("given", [True, False], ids=["given", "installed"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_on_the_card_a_device_fault_leaves_apply_block_unwrapped(root, nodes, fault, given):
    make, err = FAULTS[fault]
    node, st1, block2, bid2 = _fault_on_card(nodes, make, given)
    before, app_height = node.snapshot(), node.app.height
    with pytest.raises(err) as ei:
        node.executor.apply_block(st1, bid2, block2)
    assert not isinstance(ei.value, InvalidBlockError)
    # nothing applied, nothing saved
    assert node.snapshot() == before and node.app.height == app_height
    assert store.load_state(node.db).last_block_height == 1
    with pytest.raises(store.NoABCIResponsesForHeightError):
        store.load_abci_responses(node.db, 2)
    assert lock_is_free(node.mempool)


def test_off_the_card_a_failing_device_falls_back_as_the_reference_does(root, nodes):
    """The guarded verifier off the card completes a failed dispatch on the
    host oracle: the block applies, one fallback counted."""
    m = get_verify_metrics().device_fallback
    before = sum(m._values.values())
    v = guarded("raise", "cpu")
    assert not v.on_card
    node = nodes(verifier=v)
    st1, block2, bid2 = node.height2()
    st2 = node.executor.apply_block(st1, bid2, block2)
    assert st2.last_block_height == 2
    assert sum(m._values.values()) == before + 1  # height 2's LastCommit; height 1 has none


def test_off_the_card_the_reference_wraps_every_validation_error(root, nodes):
    class OffCard:
        def verify_ed25519_raw(self, pubs, msgs, sigs):
            raise brk.DeviceDispatchError("error", "a test verifier")

    node = nodes(verifier=OffCard())
    st1, block2, bid2 = node.height2()
    with pytest.raises(InvalidBlockError, match="device dispatch failed") as ei:
        node.executor.apply_block(st1, bid2, block2)
    assert isinstance(ei.value.__cause__, brk.DeviceDispatchError)


class CardHook:
    """A CheckTx verdict hook on a faked card: every tx verified until
    ``fault``, then the guard's ``DeviceDispatchError``."""

    device = torch.device("cuda")

    def __init__(self):
        self.fault = False
        self.calls = 0

    def __call__(self, txs):
        self.calls += 1
        if self.fault:
            raise brk.DeviceDispatchError("error", "tx feed flush")
        return [True] * len(txs)


def test_a_failed_recheck_raises_after_commit_with_the_mempool_unlocked(root, nodes):
    node = nodes(app=kv.SignedKVStoreApp(),
                 mempool_kw=dict(checktx_batch=2, checktx_batch_wait=60.0))
    hook = CardHook()
    node.mempool.set_batch_check_hook(hook, verdicts=True)
    assert brk.on_card(hook)
    privs = [PrivKeyEd25519.generate(bytes([90 + i]) * 32) for i in range(2)]
    txs = [kv.make_signed_tx(p, 1, b"m%d=v" % i) for i, p in enumerate(privs)]
    codes = []
    for tx in txs:
        node.mempool.check_tx(tx, lambda res: codes.append(res.code))
    assert codes == [0, 0] and node.mempool.size() == 2
    before = node.snapshot()
    block, bid = node.block(node.state, 1, [txs[0]], Commit())
    hook.fault = True  # the recheck of txs[1] fails
    with pytest.raises(brk.DeviceDispatchError):
        node.executor.apply_block(node.state, bid, block)
    assert lock_is_free(node.mempool)
    assert node.app.height == 1  # the app committed
    responses = store.load_abci_responses(node.db, 1)  # saved before Commit
    assert [r.code for r in responses.deliver_tx] == [0]
    assert store.load_state(node.db).marshal() == node.state.marshal()  # not saved
    assert store.load_state(node.db).last_block_height == 0
    assert [kv for kv in node.snapshot() if kv not in before] == [
        (b"abciResponsesKey:1", responses.marshal())]


def test_off_the_card_a_recheck_hook_failure_falls_back_to_the_app(root, nodes):
    class OffCardHook(CardHook):
        device = torch.device("cpu")

    node = nodes(app=kv.SignedKVStoreApp(),
                 mempool_kw=dict(checktx_batch=2, checktx_batch_wait=60.0))
    hook = OffCardHook()
    node.mempool.set_batch_check_hook(hook, verdicts=True)
    privs = [PrivKeyEd25519.generate(bytes([95 + i]) * 32) for i in range(2)]
    txs = [kv.make_signed_tx(p, 1, b"o%d=v" % i) for i, p in enumerate(privs)]
    for tx in txs:
        node.mempool.check_tx(tx)
    block, bid = node.block(node.state, 1, [txs[0]], Commit())
    hook.fault = True
    st1 = node.executor.apply_block(node.state, bid, block)
    assert st1.last_block_height == 1 and node.mempool.size() == 1
    assert node.app.serial_verifies >= 1  # the recheck went to the app


# -- the validator-set caches -------------------------------------------------------------


@pytest.mark.parametrize("change", ["add", "update", "remove"])
def test_update_validators_on_a_copy_leaves_the_original_untouched(change):
    doc, _ = genesis(6)
    st = state_from_genesis(doc)
    vs = st.validators
    vs.get_by_address(vs.validators[0].address)  # fill the address cache
    before = (vs.hash(), [v.address for v in vs.validators], vs.marshal(),
              vs.get_proposer().address, list(vs._addresses))
    cp = vs.copy()
    assert cp._addresses is vs._addresses and cp._hash == vs._hash  # shared until changed
    new = PrivKeyEd25519.generate(b"\x77" * 32).pub_key()
    from tendermint_tpu_torch.abci import types as abci
    vu = {"add": abci.ValidatorUpdate("ed25519", new.bytes(), 5),
          "update": abci.ValidatorUpdate("ed25519", vs.validators[2].pub_key.bytes(), 99),
          "remove": abci.ValidatorUpdate("ed25519", vs.validators[3].pub_key.bytes(), 0)}[change]
    update_validators(cp, [vu])
    cp.increment_accum(1)
    assert cp.hash() != before[0]
    after = (vs.hash(), [v.address for v in vs.validators], vs.marshal(),
             vs.get_proposer().address, list(vs._addresses))
    assert after == before
    assert cp.size == {"add": 7, "update": 6, "remove": 5}[change]
    assert cp.has_address(new.address()) is (change == "add")


def test_update_validators_rejects_what_the_reference_rejects():
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.types.validator_set import _MAX_TOTAL_POWER

    doc, _ = genesis(2)
    vs = state_from_genesis(doc).validators
    stranger = PrivKeyEd25519.generate(b"\x78" * 32).pub_key().bytes()
    for vu, msg in ((abci.ValidatorUpdate("ed25519", stranger, -1), "negative"),
                    (abci.ValidatorUpdate("ed25519", stranger, _MAX_TOTAL_POWER + 1), "maximum"),
                    (abci.ValidatorUpdate("rsa", stranger, 1), "unknown pubkey type"),
                    (abci.ValidatorUpdate("ed25519", stranger, 0), "failed to remove")):
        with pytest.raises(ValueError, match=msg):
            update_validators(vs.copy(), [vu])


# -- the node's wiring --------------------------------------------------------------------


def test_block_executor_wiring_owns_the_mempool(root):
    doc, pvs = genesis()
    st = state_from_genesis(doc)
    state_db, ev_db = MemDB(), MemDB()
    store.save_state(state_db, st)
    app = kv.KVStoreApp()
    conn = MultiAppConn(LocalClientCreator(app))
    conn.start()
    try:
        mp = verify_root.mempool(None, conn, app, device="cpu").mempool
        metrics = StateMetrics()
        evpool, ex = verify_root.block_executor(state_db, ev_db, conn, mp, st,
                                                metrics=metrics)
        assert ex.verifier is None and ex.mempool is mp and ex.evpool is evpool
        assert ex.proxy_app is conn.consensus and evpool.state is st
        for i in range(3):
            mp.check_tx(b"w%d=%d" % (i, i))
        block, parts = ex.create_proposal_block(1, st, Commit(),
                                                st.validators.get_proposer().address)
        assert list(block.data.txs) == [b"w0=0", b"w1=1", b"w2=2"]
        bid = BlockID(hash=block.hash(), parts_header=parts.header())
        trace.enable()
        trace.reset()
        try:
            st1 = ex.apply_block(st, bid, block)
            names = {ev["name"] for ev in trace.export()}
        finally:
            trace.disable()
        assert {"state.validate", "state.exec", "state.update", "state.commit",
                "state.save", "state.begin_block_info"} <= names
        assert mp.size() == 0 and evpool.state is st1
        assert st1.last_block_total_tx == 3 and st1.app_hash == app._app_hash()
        assert metrics.block_processing_time._series[()][2] == 1  # one observation
    finally:
        conn.stop()
