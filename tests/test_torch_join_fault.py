"""The device-fault contract of a node that joins a running net
(``testutil/consensus_net.make_joining_node``, wired by
``node/verify_root.node_reactors``), on a faked card and off it.

On the card (a guarded verifier or a device executor whose device is CUDA) a
device fault in the joining node's trust hop, backfill or fast-sync window
halts that node: its restore or its fast sync records ``device_fault``; it
stops and bans no peer, persists nothing (no state past genesis, no block,
no validator record at the snapshot), hands nothing off (consensus does not
start), and the validators commit on. A device fault behind a gossiped tx
(the joining node's mempool hook on a faked card) stops no peer: the
mempool reactor keeps it as ``device_fault``. Off the card the guards
complete on the host, as the reference does, and the node joins.

One 4-validator net (``PersistentKVStoreApp`` snapshots every 2 heights,
the host verifier installed: the validators verify on the host) serves
every case of this module; each case joins one node to it and stops that
node. Every wait has a deadline; sockets are socketpairs.
"""

import pytest
import torch

from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp, PersistentKVStoreApp
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.testutil import consensus_net as cn
from tendermint_tpu_torch.testutil.consensus import wait_for

from tests.test_torch_fastsync_fault import guarded

DEADLINE = 60.0


def host_executor(plan, mesh=None):
    return planner._execute_host(plan, tbatch.HostBatchVerifier())


def card_executor(plan, mesh=None):
    """A device executor on a faked card whose launch fails."""
    raise RuntimeError("kernel launch failed")


card_executor.device = torch.device("cuda")


@pytest.fixture(autouse=True)
def _verifiers():
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())
    planner.set_device_executor(host_executor)
    yield
    verify_root.reset_verify()
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())


@pytest.fixture(scope="module")
def net():
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())
    nodes = cn.make_consensus_net(4, app_factory=lambda i: PersistentKVStoreApp(),
                                  statesync_cfg=StateSyncConfig(snapshot_interval=2))
    try:
        # snapshots at 2 and 4, and header 5 that the restore of 4 verifies
        assert wait_for(lambda: all(n.cs.block_store.height() >= 5 for n in nodes),
                        timeout=DEADLINE)
        yield nodes
    finally:
        cn.stop_consensus_net(nodes)


def stops(nodes):
    """Record every peer a switch of ``nodes`` stops for an error (a call for
    a peer object the set no longer holds stops nothing and is not counted)."""
    got = []
    for n in nodes:
        sw, real = n.switch, n.switch.stop_peer_for_error

        def record(peer, reason, sw=sw, real=real):
            if sw.peers.get(peer.id) is peer:
                got.append((sw.node_id, peer.id, str(reason)))
            return real(peer, reason)

        sw.stop_peer_for_error = record
    return got


def restore_cfg(nodes):
    meta = nodes[0].cs.block_store.load_block_meta(1)
    return StateSyncConfig(enable=True, trust_height=1, trust_hash=meta.header.hash().hex(),
                           discovery_time=0.25)


def join(nodes, statesync=True, before_start=None):
    """A joining node, unstarted; ``before_start(node)`` swaps in what the
    case fails; then started, with every switch's stops recorded."""
    j = cn.make_joining_node(nodes, PersistentKVStoreApp() if statesync else KVStoreApp(),
                             statesync_cfg=restore_cfg(nodes) if statesync else None,
                             start=False)
    if before_start is not None:
        before_start(j)
    stopped = stops(nodes + [j])
    cn.start_joining_node(j)
    return j, stopped


def assert_nothing_persisted(j, snapshot_height):
    assert sm_store.load_state(j.state_db).last_block_height == 0
    assert j.cs.block_store.height() == 0 and j.cs.block_store.base() == 0
    with pytest.raises(sm_store.NoValSetForHeightError):
        sm_store.load_validators(j.state_db, snapshot_height)


def assert_the_net_commits_on(nodes, stopped):
    h0 = min(n.cs.block_store.height() for n in nodes)
    assert wait_for(lambda: all(n.cs.block_store.height() >= h0 + 2 for n in nodes),
                    timeout=DEADLINE)
    assert stopped == [] and all(n.switch.peers.size() == 4 for n in nodes)


def halted_restore(nodes, before_start, err):
    j, stopped = join(nodes, before_start=before_start)
    ss = j.reactors.statesync.reactor
    try:
        assert wait_for(lambda: ss.device_fault is not None or ss.progress()["synced_height"],
                        timeout=DEADLINE), ss.progress()
        assert isinstance(ss.device_fault, err), ss.progress()
        assert type(ss.device_fault).__name__ in ss.progress()["error"]
        H = ss.progress()["snapshot_height"]
        assert ss._banned == set()
        assert not j.reactors.blockchain.pool.is_running and not j.cs.is_running
        assert j.reactors.consensus.fast_sync
        assert_nothing_persisted(j, H)
        assert_the_net_commits_on(nodes, stopped)
        assert j.switch.peers.size() == 4
        return j, H
    finally:
        cn.stop_consensus_net([j])


TRUST_FAULTS = {
    "dispatch": (lambda: guarded("raise"), brk.DeviceDispatchError),
    "audit": (lambda: guarded("wrong"), brk.DeviceAuditMismatch),
}


@pytest.mark.parametrize("fault", sorted(TRUST_FAULTS))
def test_on_the_card_a_trust_hop_fault_halts_the_joining_node(net, fault):
    make, err = TRUST_FAULTS[fault]

    def on_card(j):
        j.reactors.statesync.syncer.batch_verifier = make()

    j, _ = halted_restore(net, on_card, err)
    assert j.app.height == 0  # the halt came before the offer: the app took nothing


def test_on_the_card_a_backfill_fault_halts_the_joining_node(net):
    planner.set_device_executor(card_executor)
    j, H = halted_restore(net, None, brk.DeviceDispatchError)
    # the app took the chunks and stays restored, as the reference leaves it
    assert j.app.height == H


def test_on_the_card_a_fast_sync_window_fault_halts_the_joining_node(net):
    def on_card(j):
        j.reactors.blockchain.verifier = guarded("raise")

    j, stopped = join(net, statesync=False, before_start=on_card)
    bc = j.reactors.blockchain
    try:
        assert wait_for(lambda: bc.device_fault is not None, timeout=DEADLINE), (
            j.cs.block_store.height())
        assert isinstance(bc.device_fault, brk.DeviceDispatchError)
        assert wait_for(lambda: not bc.pool.is_running, timeout=DEADLINE)
        assert bc.fast_sync and not bc._switched.is_set() and not j.cs.is_running
        assert j.cs.block_store.height() == 0 and bc.state.last_block_height == 0
        assert_the_net_commits_on(net, stopped)
    finally:
        cn.stop_consensus_net([j])


@pytest.mark.parametrize("how", ["statesync", "fastsync"])
def test_off_the_card_the_guards_complete_on_the_host_and_the_node_joins(net, how):
    def off_card(j):
        failing = guarded("raise", device="cpu")
        if how == "statesync":
            j.reactors.statesync.syncer.batch_verifier = failing
        else:
            j.reactors.blockchain.verifier = failing

    j, stopped = join(net, statesync=how == "statesync", before_start=off_card)
    try:
        assert wait_for(lambda: j.cs.is_running, timeout=DEADLINE)
        tip = min(n.cs.block_store.height() for n in net)
        assert wait_for(lambda: j.cs.block_store.height() >= tip, timeout=DEADLINE)
        for h in range(max(1, j.cs.block_store.base()), tip + 1):
            assert j.cs.block_store.load_block_meta(h).header.hash() == \
                net[0].cs.block_store.load_block_meta(h).header.hash()
        assert j.reactors.blockchain.device_fault is None
        if how == "statesync":
            assert j.reactors.statesync.reactor.device_fault is None
        assert stopped == []
    finally:
        cn.stop_consensus_net([j])


class _CardHook:
    """The joining node's verdict hook on a faked card, failing."""

    device = torch.device("cuda")

    def __init__(self):
        self.calls = 0

    def __call__(self, txs):
        self.calls += 1
        raise brk.DeviceDispatchError("error", "tx feed flush")


def test_on_the_card_a_gossiped_txs_device_fault_stops_no_peer(net):
    hook = _CardHook()

    def on_card(j):
        j.cs.mempool.set_batch_check_hook(hook, verdicts=True)
        assert brk.on_card(j.cs.mempool.batch_check_hook)

    j, stopped = join(net, statesync=False, before_start=on_card)
    mr = j.reactors.mempool
    try:
        assert wait_for(lambda: j.switch.peers.size() == 4, timeout=DEADLINE)
        for k in range(3):
            net[k].cs.mempool.check_tx(b"card-fault-%d=v" % k)
        assert wait_for(lambda: mr.device_faults >= 1, timeout=DEADLINE)
        assert isinstance(mr.device_fault, brk.DeviceDispatchError) and hook.calls >= 1
        assert_the_net_commits_on(net, stopped)
        assert j.switch.peers.size() == 4
        assert wait_for(lambda: all(cn.committed_in(n, lambda t: t == b"card-fault-0=v")
                                    for n in net), timeout=DEADLINE)
    finally:
        cn.stop_consensus_net([j])
