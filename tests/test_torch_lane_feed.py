"""The port's ``LaneFeed`` and ``BatchingVerifier`` (parallel/planner.py,
frontend/aggregator.py) against the reference's: the same seeded rows
through both feeds, the reference on its host verifier (the
``HostBatchVerifier`` tests/conftest.py installs), the port's feed on its
defaults (the verifier route) over ``TorchBatchVerifier("cpu")`` (the plain
versions of K1 and K2) or on the device executor on the CPU. Row verdicts
must be equal, exactly. Restates the reference's ``TestLaneFeed``; a fold
is asserted only after a long window and ``flush_now()``, never on the wall
clock, and every feed is closed and every wait bounded."""

import threading
import time

import numpy as np
import pytest
import torch

from tendermint_tpu.parallel import planner as jplanner
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.frontend.aggregator import BatchingVerifier
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.parallel.mesh import DeviceMesh
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.types.validator_set import CommitError

LONG = 30.0  # a window no test waits out: folds happen on flush_now()
TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    brk.configure_device_guard(dispatch_deadline=0)
    planner.set_device_executor(planner.device_executor("cpu"))
    tbatch.set_batch_verifier(tbatch.TorchBatchVerifier("cpu"))
    yield
    planner.set_device_executor(None)
    tbatch.set_batch_verifier(None)
    brk.reset_device_guard()


@pytest.fixture
def feeds():
    """Feeds made by a test, closed after it whatever happened."""
    made = []

    def make(module=planner, **kw):
        feed = module.LaneFeed(**kw)
        made.append(feed)
        return feed

    yield make
    for feed in made:
        feed.close()


def _row(n_sigs, seed, forged=()):
    rng = np.random.default_rng(1300 + seed)
    row = []
    for j in range(n_sigs):
        priv = ted.gen_privkey(rng.bytes(32))
        msg = b"lane-feed-msg-%d-%d" % (seed, j)
        sig = ted.sign(priv, msg)
        row.append((priv[32:], msg, b"\x00" * 64 if j in forged else sig))
    return row


def _wait_rows(feed, n):
    deadline = time.monotonic() + TIMEOUT
    while feed.rows_in < n:
        assert time.monotonic() < deadline, f"{feed.rows_in} of {n} rows arrived"
        time.sleep(0.005)


def _burst(feed, rows, powers, total):
    """Submit every row, then flush: one dispatch by construction."""
    tickets = [feed.submit(r, p, total) for r, p in zip(rows, powers)]
    feed.flush_now()
    return [t.result(TIMEOUT) for t in tickets]


def _assert_rows_equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g.ok, w.ok)
        assert (g.tally, g.committed, g.sigs_ok) == (w.tally, w.committed, w.sigs_ok)
        assert (g.batch_rows, g.batch_lanes) == (w.batch_rows, w.batch_lanes)


# -- tests/test_frontend.py::TestLaneFeed ------------------------------------


def test_concurrent_submits_fold_into_shared_dispatches(feeds):
    feed = feeds(window_s=LONG, max_rows=64)
    rows = [_row(4, i + 1) for i in range(12)]
    verdicts = [None] * len(rows)

    def submit(i):
        verdicts[i] = feed.submit(rows[i], [1] * 4, 4).result(TIMEOUT)

    ts = [threading.Thread(target=submit, args=(i,)) for i in range(len(rows))]
    for t in ts:
        t.start()
    _wait_rows(feed, len(rows))
    feed.flush_now()
    for t in ts:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert feed.rows_in == len(rows) and feed.lanes_in == 4 * len(rows)
    assert (feed.dispatches, feed.windows_out) == (1, 1)
    for v in verdicts:
        assert v.sigs_ok and v.committed
        assert v.ok.shape == (4,) and v.ok.all()
        assert 0.0 < v.occupancy <= 1.0 and v.batch_rows == len(rows)


def test_row_verdicts_bit_identical_to_direct_verify_window(feeds):
    good = _row(4, 33)
    bad = _row(4, 34, forged=(1, 2))  # 2 of 4 equal voters: below 2/3
    want = [jplanner.verify_window([row], [[1] * 4], [4], use_device=False)
            for row in (good, bad)]
    got = _burst(feeds(window_s=LONG, max_rows=8), [good, bad], [[1] * 4] * 2, 4)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w.ok[0]), g.ok)
        assert int(w.tally[0]) == g.tally
        assert bool(w.committed[0]) == g.committed
        assert bool(w.sigs_ok[0]) == g.sigs_ok
    assert got[0].committed and not got[1].committed


def test_closed_feed_rejects_submits(feeds):
    feed = feeds(window_s=0.001)
    feed.close()
    with pytest.raises(RuntimeError, match="closed"):
        feed.submit(_row(1, 7), [1], 1)


def test_racing_flushes_fold_into_one_superdispatch(feeds):
    """Rows beyond max_rows do not queue a second dispatch: the worker
    chunks everything pending into windows of max_rows rows and folds them
    into one lane tile."""
    rows = [_row(3, 40 + i) for i in range(11)]
    feed = feeds(window_s=LONG, max_rows=4)
    got = _burst(feed, rows, [[1] * 3] * 11, 3)
    assert (feed.dispatches, feed.windows_out) == (1, 3)
    for row, g in zip(rows, got):
        w = jplanner.verify_window([row], [[1] * 3], [3], use_device=False)
        assert np.array_equal(np.asarray(w.ok[0]), g.ok)
        assert (int(w.tally[0]), bool(w.committed[0])) == (g.tally, g.committed)
        assert g.batch_rows == len(rows)


# -- the port against the reference's feed -----------------------------------


@pytest.mark.parametrize("use_device", [None, True])
def test_feed_equals_the_reference_feed(feeds, use_device):
    """One burst of 9 rows (max_rows 4: 3 folded windows) with absent,
    forged and malformed lanes through both packages' feeds: every row
    verdict is equal, on the port's verifier route (the default) and on
    its device route."""
    rows = [_row(3 + i % 3, 60 + i, forged=(1,) if i % 4 == 1 else ()) for i in range(9)]
    rows[2][0] = None
    rows[5][1] = (rows[5][1][0], rows[5][1][1], rows[5][1][2][:63])
    powers = [[(i + j) % 5 + 1 for j in range(len(r))] for i, r in enumerate(rows)]
    want = _burst(feeds(jplanner, window_s=LONG, max_rows=4, use_device=False),
                  rows, powers, 9)
    got_feed = feeds(window_s=LONG, max_rows=4, use_device=use_device)
    get_profiler().reset()
    got = _burst(got_feed, rows, powers, 9)
    _assert_rows_equal(got, want)
    lanes = got[0].batch_lanes
    occupancy = lanes / planner.lanes_bucket(lanes) if use_device else want[0].occupancy
    assert all(g.occupancy == occupancy for g in got)
    assert [g.sigs_ok for g in got] == [i % 4 != 1 and i != 5 for i in range(9)]
    entries = get_profiler().entries()
    assert [e["kind"] for e in entries] == ["planner" if use_device else "host", "lane_feed"]
    assert entries[-1]["n_windows"] == 3 and entries[-1]["heights"] == 9


def test_a_failed_flush_resolves_every_ticket_with_the_error(feeds):
    class Broken:
        def verify_ed25519_raw(self, pubs, msgs, sigs):
            raise RuntimeError("verifier down")

    feed = feeds(window_s=LONG, verifier=Broken())
    tickets = [feed.submit(_row(2, 90 + i), [1, 1], 2) for i in range(3)]
    feed.flush_now()
    for t in tickets:
        with pytest.raises(RuntimeError, match="verifier down"):
            t.result(TIMEOUT)
    assert feed.dispatches == 0


def test_close_flushes_pending_rows(feeds):
    feed = feeds(window_s=LONG)
    ticket = feed.submit(_row(2, 95), [1, 1], 2)
    feed.close()
    assert ticket.result(TIMEOUT).ok.all()
    feed._thread.join(TIMEOUT)
    assert feed._thread.name == "planner-lane-feed" and not feed._thread.is_alive()


def test_on_flush_sees_every_dispatch(feeds):
    seen = []
    feed = feeds(window_s=LONG, profile_kind="rpc_lane_feed",
                 on_flush=lambda v, n, s: seen.append((v.lanes_present, n)))
    get_profiler().reset()
    _burst(feed, [_row(2, 97), _row(3, 98)], [[1, 1], [1, 1, 1]], 3)
    assert seen == [(5, 2)]
    assert get_profiler().entries()[-1]["kind"] == "rpc_lane_feed"


def test_a_mesh_is_refused_at_construction():
    """A mesh is taken now: the feed's superdispatch budget scales with the
    mesh's devices and its dispatch splits the lanes over them (the
    device route, "planner_mesh"), with the verdict a flat call gives."""
    mesh = DeviceMesh(["cpu"] * 2)
    row = _row(3, 99)
    want = planner.verify_window([row], [[1, 1, 1]], [3], use_device=False,
                                 verifier=tbatch.HostBatchVerifier())
    feed = planner.LaneFeed(mesh=mesh, window_s=LONG)
    get_profiler().reset()
    try:
        assert feed.mesh is mesh
        assert planner.windows_per_dispatch(mesh) == 2 * planner.windows_per_dispatch()
        got = feed.submit(row, [1, 1, 1], 3)
        feed.flush_now()
        verdict = got.result(TIMEOUT)
        assert np.array_equal(verdict.ok, want.ok[0]) and verdict.committed == want.committed[0]
        assert [e["kind"] for e in get_profiler().entries()] == ["planner_mesh", "lane_feed"]
    finally:
        feed.close()


# -- BatchingVerifier --------------------------------------------------------


def _commits():
    """Six signed 4-validator commits of distinct sets: clean, a flipped
    signature, under quorum, and clean again."""
    scs = [tc.build_commit(4, seed=200 + i) for i in range(6)]
    cases = [sc.commit for sc in scs]
    cases[1] = tc.flip_signature_bit(cases[1], 2, 300)
    cases[3] = tc.drop_precommits(cases[3], 2)  # 20 of 40: not above 2/3
    return scs, cases


def _outcome(fn):
    try:
        fn()
    except CommitError as e:
        return str(e)
    return None


def test_batching_verifier_under_verify_commit(feeds):
    """Concurrent verify_commit calls through one BatchingVerifier fold
    into one feed dispatch, and each ends as a direct verify_commit on the
    same commit does: it returns, or it raises the same CommitError."""
    scs, cases = _commits()
    direct = tbatch.TorchBatchVerifier("cpu")
    want = [_outcome(lambda sc=sc, c=c: sc.valset.verify_commit(
        sc.chain_id, sc.block_id, sc.height, c, verifier=direct)) for sc, c in zip(scs, cases)]
    assert want[0] is None and want[1] == "invalid signature in commit"
    assert want[3].startswith("insufficient voting power")
    feed = feeds(window_s=LONG)
    bv = BatchingVerifier(feed, result_timeout=TIMEOUT)
    got = [None] * len(cases)

    def run(i):
        sc = scs[i]
        got[i] = _outcome(lambda: sc.valset.verify_commit(
            sc.chain_id, sc.block_id, sc.height, cases[i], verifier=bv))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(cases))]
    for t in ts:
        t.start()
    _wait_rows(feed, len(cases))
    feed.flush_now()
    for t in ts:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert got == want
    assert (feed.dispatches, feed.rows_in) == (1, len(cases))


def test_batching_verifier_delegates_what_is_not_an_ed25519_column(feeds):
    """A mixed commit: its ed25519 lanes ride the feed (verify_ed25519 over
    SigItems), its secp256k1 lanes go to the installed default verifier
    through __getattr__, as a verifier=None call would."""
    sc = tc.build_commit(6, seed=31, key_type="mixed")
    feed = feeds(window_s=0.0)
    bv = BatchingVerifier(feed, result_timeout=TIMEOUT)
    assert bv.verify_secp256k1.__self__ is tbatch.get_batch_verifier()
    assert sc.valset.verify_commit(sc.chain_id, sc.block_id, sc.height, sc.commit,
                                   verifier=bv) is None
    n_ed = sum(type(v.pub_key) is PubKeyEd25519 for v in sc.valset.validators)
    assert 0 < n_ed < 6 and feed.lanes_in == n_ed
    assert np.array_equal(bv.verify_ed25519_raw([], [], []), np.zeros(0, bool))
