"""State sync's device-fault contract (``statesync/syncer.py``,
``statesync/reactor.py``), on a faked card and off it.

On the card (a guarded verifier or a device executor whose device is CUDA:
a device that raises, one that answers wrongly for the audit to catch, a
tripped breaker) a ``DeviceDispatchError`` or ``DeviceAuditMismatch`` out of
a trust hop or the backfill halts the restore: the reactor records it as
``device_fault`` and ``progress()["error"]`` names it; the syncer stops at
the snapshot (it is not rejected for the next offer), no peer is banned,
nothing is persisted (no state, no validator records, an empty block
store) and ``on_synced`` is not called.
After a backfill fault the app has taken the chunks and stays restored, as
the reference leaves it after any late failure. Off the card the
reference's behaviour holds: the guards complete on the host and the
restore finishes. A tampered backfill signature is an invalid window, on
both packages and on the card: the snapshot is rejected, and the next one
restores. Every wait is bounded by a deadline.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.testutil.consensus import wait_for

from tests.test_torch_fastsync_fault import guarded, tripped
from tests.test_torch_statesync import PKGS, PORT, producer_chain

DEADLINE = 60.0
H = 12  # the tallest snapshot of the chain
WINDOW = range(9, 13)  # the backfill at backfill_blocks=4


@pytest.fixture(autouse=True)
def _verifiers():
    """As ``test_torch_statesync.py``, with a breaker that stays open once
    tripped (the breaker cases) and the audit on every window."""
    rset_batch_verifier(RHostBatchVerifier())
    root = verify_root.configure_verify(
        VerifyConfig(dispatch_deadline=0, breaker_backoff=600.0, breaker_backoff_max=600.0,
                     audit_sample_rate=1.0), device="cpu")
    yield root
    verify_root.reset_verify()


_CHAINS = {}


def chain_of(pkg):
    if pkg.name not in _CHAINS:
        _CHAINS[pkg.name] = producer_chain(pkg, chain_id="ss-fault")
    return _CHAINS[pkg.name]


class TamperedStore:
    """A block store whose stored commit at ``height`` carries a flipped
    signature (what a serving peer's light block at that height carries)."""

    def __init__(self, inner, height):
        self._inner, self._height = inner, height

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def load_block_commit(self, h):
        commit = self._inner.load_block_commit(h)
        if h != self._height or commit is None:
            return commit
        pcs = list(commit.precommits)
        pcs[1] = dataclasses.replace(pcs[1], signature=bytes(64))
        return dataclasses.replace(commit, precommits=pcs)


def start_restore(pkg, verifier=None, block_store=None):
    """A fresh node restoring the fault chain from one serving peer over the
    in-process hub, its trust hops through ``verifier`` (None: the
    installed one); returns once the restore ended either way."""
    fx, snap_store = chain_of(pkg)
    app2 = pkg.App()
    conn2 = pkg.conn.MultiAppConn(pkg.conn.LocalClientCreator(app2))
    conn2.start()
    state_db2, block_store2 = pkg.MemDB(), pkg.BlockStore(pkg.MemDB())
    cfg = pkg.Config(enable=True, trust_height=1,
                     trust_hash=fx.block_store.load_block_meta(1).header.hash().hex(),
                     discovery_time=0.25, chunk_fetch_timeout=5.0, backfill_blocks=4)
    kw = {} if pkg is not PORT else {"batch_verifier": verifier}
    syncer = pkg.Syncer(cfg, fx.chain_id, fx.genesis, conn2.query, state_db2, block_store2,
                        metrics=pkg.Metrics(), **kw)
    synced = []
    client = pkg.Reactor(cfg, app_query=conn2.query, block_store=block_store2,
                         state_db=state_db2, syncer=syncer,
                         on_synced=lambda st, h: synced.append(st), metrics=pkg.Metrics())
    server = pkg.Reactor(pkg.Config(), snapshot_store=snap_store,
                         block_store=block_store or fx.block_store, state_db=fx.state_db)
    switches = pkg.hub_net([("peer-client", client), ("peer-server", server)])
    try:
        assert wait_for(lambda: synced or client._sync_error is not None, timeout=DEADLINE), \
            client.progress()
    finally:
        client.stop()
        server.stop()
    return SimpleNamespace(fx=fx, app=app2, state_db=state_db2, block_store=block_store2,
                           client=client, synced=synced, switches=switches)


def assert_halted(got, err, app_height):
    c = got.client
    assert isinstance(c.device_fault, err)
    assert type(c.device_fault).__name__ in c.progress()["error"]
    assert got.synced == [] and c.progress()["synced_height"] == 0
    # the syncer stopped at the snapshot (it was not rejected for the next
    # offer); no peer is banned or stopped
    assert c.progress()["snapshot_height"] == H
    assert c._banned == set() and all(sw.stopped == [] for sw in got.switches)
    # nothing persisted
    assert sm_store.load_state(got.state_db) is None
    assert got.block_store.height() == 0 and got.block_store.base() == 0
    for h in list(WINDOW) + [H + 1]:
        with pytest.raises(sm_store.NoValSetForHeightError):
            sm_store.load_validators(got.state_db, h)
    assert got.app.height == app_height


def card_executor(mode):
    """A device executor on a faked card: the plain versions' verdict, or
    ``raise`` raises, ``wrong`` answers every lane wrongly."""
    cpu = planner.device_executor("cpu")

    def execute(plan, mesh=None):
        if mode == "raise":
            raise RuntimeError("kernel launch failed")
        v = cpu(plan, mesh)
        return dataclasses.replace(v, ok=~v.ok) if mode == "wrong" else v

    execute.device = torch.device("cuda")
    return execute


TRUST_FAULTS = {
    "dispatch": (lambda: guarded("raise"), brk.DeviceDispatchError),
    "audit": (lambda: guarded("wrong"), brk.DeviceAuditMismatch),
}


@pytest.mark.parametrize("fault", sorted(TRUST_FAULTS))
def test_a_fault_of_a_trust_hop_halts_the_restore(fault):
    """The installed verifier on the card fails the first hop (1 -> 12):
    the halt comes before the offer, so the app takes nothing."""
    make, err = TRUST_FAULTS[fault]
    v = make()
    assert v.on_card
    tbatch.set_batch_verifier(v)
    got = start_restore(PORT)
    assert_halted(got, err, app_height=0)
    assert isinstance(got.client.syncer.device_fault, err)


def test_a_tripped_breaker_halts_the_trust_hops_of_the_syncers_verifier():
    got = start_restore(PORT, verifier=guarded("raise", breaker=tripped()))
    assert_halted(got, brk.DeviceDispatchError, app_height=0)
    assert got.client.device_fault.reason == "breaker_open"


BACKFILL_FAULTS = {
    "dispatch": ("raise", brk.DeviceDispatchError),
    "audit": ("wrong", brk.DeviceAuditMismatch),
    "breaker": ("ok", brk.DeviceDispatchError),
}


@pytest.mark.parametrize("fault", sorted(BACKFILL_FAULTS))
def test_a_fault_of_the_backfill_halts_the_restore(fault):
    """The trust hops on the host, the backfill on a faked card's executor:
    the app has taken the chunks (it stays restored), nothing else is
    persisted."""
    mode, err = BACKFILL_FAULTS[fault]
    planner.set_device_executor(card_executor(mode))
    if fault == "breaker":
        brk.get_device_breaker().trip("test")
    got = start_restore(PORT, verifier=tbatch.HostBatchVerifier())
    assert_halted(got, err, app_height=H)
    assert got.client.progress()["chunks_applied"] == got.client.progress()["chunks_total"]


def test_off_the_card_the_guards_complete_on_the_host():
    """The same faults off the card (the faked devices on the CPU): the
    guarded verifier and the guarded executor complete on the host, as the
    reference's do, and the restore finishes."""
    before = dict(get_verify_metrics().device_fallback._values)
    tbatch.set_batch_verifier(guarded("raise", device="cpu"))
    ex = card_executor("raise")
    ex.device = torch.device("cpu")
    planner.set_device_executor(ex)
    got = start_restore(PORT)
    assert got.client.device_fault is None and got.client.progress()["error"] is None
    assert [s.last_block_height for s in got.synced] == [H]
    assert got.block_store.height() == H and got.block_store.base() == WINDOW[0]
    after = get_verify_metrics().device_fallback._values
    assert sum(after.values()) > sum(before.values())


@PKGS
def test_a_tampered_backfill_signature_rejects_the_snapshot(pkg):
    """A serving peer whose commit at 10 carries a bad signature: 12's
    backfill window [9..12] is invalid, so 12 is rejected (not a device
    fault, not a ban) and the restore goes on to the next offer, 8 (window
    [5..8]): offers go tallest first, so 8 restores only after 12 failed."""
    fx, _ = chain_of(pkg)
    got = start_restore(pkg, block_store=TamperedStore(fx.block_store, 10))
    assert [s.last_block_height for s in got.synced] == [8]
    assert got.client.progress()["error"] is None
    assert getattr(got.client, "device_fault", None) is None
    assert got.client._banned == set()
    assert got.block_store.height() == 8 and got.block_store.base() == 5
    assert got.app.height == 8


def test_a_tampered_backfill_signature_is_no_device_fault_on_the_card():
    """As above with the backfill on a faked card whose verdicts are
    right: the bad signature is an invalid window there too."""
    planner.set_device_executor(card_executor("ok"))
    fx, _ = chain_of(PORT)
    got = start_restore(PORT, verifier=tbatch.HostBatchVerifier(),
                        block_store=TamperedStore(fx.block_store, 10))
    assert [s.last_block_height for s in got.synced] == [8]
    assert got.client.device_fault is None and got.client.syncer.device_fault is None
    assert brk.get_device_breaker().state == brk.CLOSED
