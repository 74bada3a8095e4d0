"""The port's ``VoteFeed`` (parallel/planner.py) and ``node/verify_root.
vote_feed`` against the reference's: the cases of
``tests/test_vote_batch.py`` restated on ``device="cpu"``, the storms of
``testutil/votes.py`` through ``prevalidate`` -> the feed ->
``add_vote(verified=True)`` on both routes (the verifier route over
``TorchBatchVerifier("cpu")``, the plain versions of K1 and K2; the device
executor via ``device_executor("cpu")``) and on the feed's CPU default
(``RLCHostVerifier``). Outcomes, evidence and vote-set states must equal the
serial path's and the reference feed's, exactly. Every feed is closed, every
wait bounded; a fold is asserted only after a long window and
``flush_now()``; the guard runs with ``dispatch_deadline=0``."""

import threading
import time

import pytest
import torch

import tests.test_vote_batch as rvb
from tendermint_tpu.libs.metrics import MempoolBatchMetrics as RMempoolBatchMetrics
from tendermint_tpu.libs.metrics import VoteBatchMetrics as RVoteBatchMetrics
from tendermint_tpu.parallel import planner as rplanner
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PrivKeySecp256k1
from tendermint_tpu_torch.crypto.multisig import Multisignature, PubKeyMultisigThreshold
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import (
    MempoolBatchMetrics,
    VoteBatchMetrics,
    get_verify_metrics,
    get_vote_batch_metrics,
)
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.node.verify_root import vote_feed
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.testutil import votes as tv
from tendermint_tpu_torch.types.core import SignedMsgType
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import VoteSet

LONG = 30.0  # a window no test waits out: folds happen on flush_now()
TIMEOUT = 120.0
CHAIN = tv.TEST_CHAIN_ID
PREVOTE = SignedMsgType.PREVOTE
ROUTES = ("verifier", "executor", "rlc")
no_cuda = pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only default")


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
    """Feeds made by a test, closed and joined after it."""
    made = []

    def make(cls=planner.VoteFeed, **kw):
        feed = cls(**kw)
        made.append(feed)
        return feed

    yield make
    for feed in made:
        feed.close()
        feed.join(10.0)


def route_feed(make, route, **kw):
    """A CPU feed on one route: the verifier route over the plain versions
    of K1 and K2, the device executor, or the feed's default
    (``RLCHostVerifier``)."""
    if route == "verifier":
        return make(device="cpu", use_device=False,
                    verifier=tbatch.TorchBatchVerifier("cpu"), **kw)
    if route == "executor":
        return make(device="cpu", use_device=True, **kw)
    return make(device="cpu", use_device=False, **kw)


def _ref_batched(sets, storm, feed):
    """The reference's run_batched with a flush once the storm is in."""
    outcomes, evidence, pending = [], [], []
    for pos, (gk, vote) in enumerate(storm):
        vset = sets[gk]
        try:
            pv = vset.prevalidate(vote)
        except rvb.VoteError as e:
            outcomes.append((pos, (type(e).__name__, None)))
            continue
        if pv is None:
            outcomes.append((pos, ("added", False)))
            continue
        pending.append((pos, gk, vote, feed.submit(
            gk, pv.pub_key, vote.sign_bytes(vset.chain_id), vote.signature,
            power=pv.voting_power, total=vset.val_set.total_voting_power())))
    feed.flush_now()
    for pos, gk, vote, ticket in pending:
        vset = sets[gk]
        if not ticket.result(timeout=TIMEOUT).ok:
            try:
                outcomes.append((pos, ("added", False) if vset.prevalidate(vote) is None
                                 else ("ErrVoteInvalidSignature", None)))
            except rvb.VoteError as e:
                outcomes.append((pos, (type(e).__name__, None)))
            continue
        try:
            outcomes.append((pos, ("added", vset.add_vote(vote, verified=True))))
        except rvb.ErrVoteConflictingVotes as e:
            outcomes.append((pos, ("conflict", e.added)))
            evidence.append((gk, e.vote_a, e.vote_b))
        except rvb.VoteError as e:
            outcomes.append((pos, (type(e).__name__, None)))
    outcomes.sort()
    return [o for _, o in outcomes], evidence


def _last_seq() -> int:
    entries = get_profiler().entries()
    return entries[-1]["seq"] if entries else -1


def _entries_since(seq: int):
    return [e for e in get_profiler().entries() if e["seq"] > seq]


def _ref_state(sets):
    out = {}
    for gk, s in sets.items():
        maj = s.two_thirds_majority()
        out[tuple(int(x) for x in gk)] = (
            s.bit_array().marshal(), s.sum, None if maj is None else maj.key(),
            tuple(None if s.bit_array_by_block_id(b) is None
                  else s.bit_array_by_block_id(b).marshal()
                  for b in (rvb.BLOCK_A, rvb.BLOCK_B)))
    return out


# -- tests/test_vote_batch.py::TestStormParity --------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n_vals,seed", [(16, 7), (64, 21)])
def test_mixed_storm_bit_parity(feeds, route, n_vals, seed):
    vs, pvs = tv.make_vals(n_vals, keys=tv.KEYS_TEST)
    storm = [tv.build_flat_storm(vs, pvs, seed=seed)]
    serial_sets = tv.fresh_sets(vs, CHAIN)
    want, want_ev = tv.run_serial(serial_sets, storm)
    feed = route_feed(feeds, route, window_s=LONG, max_rows=16)
    sets = tv.fresh_sets(vs, CHAIN)
    got, got_ev = tv.run_batched(sets, storm, feed, timeout=TIMEOUT)
    assert got == want
    assert tv.evidence_key(got_ev) == tv.evidence_key(want_ev)
    assert tv.vote_set_state(sets) == tv.vote_set_state(serial_sets)
    # the worker may flush whenever max_rows * windows_per_dispatch() votes
    # wait, so the storm takes one or more dispatches of up to 4 rows each
    assert feed.votes_in > 16 * 4 and feed.dispatches == sum(feed.flushes.values()) >= 1
    assert feed.dispatches <= feed.rows_out <= 4 * feed.dispatches

    # the reference's feed on its own storm ends in the same place
    rvs, rpvs = rvb.make_vals(n_vals)
    rsets = rvb.fresh_sets(rvs)
    rfeed = rplanner.VoteFeed(use_device=False, window_s=LONG, max_rows=16)
    try:
        rgot, rev = _ref_batched(rsets, rvb.build_storm(rvs, rpvs, seed=seed), rfeed)
    finally:
        rfeed.close()
        rfeed.join(10.0)
    assert got == rgot
    assert tv.evidence_key(got_ev) == tv.evidence_key(rev)
    assert tv.vote_set_state(sets) == _ref_state(rsets)


def _secp_multisig_storm():
    ed_pvs = [MockPV(PrivKeyEd25519.generate(bytes([i + 1]) * 32)) for i in range(4)]
    secp_pv = MockPV(PrivKeySecp256k1.generate(b"\x77" * 32))
    ms_privs = [PrivKeyEd25519.generate(bytes([0x40 + i]) * 32) for i in range(3)]
    ms_pub = PubKeyMultisigThreshold(k=2, pubkeys=tuple(p.pub_key() for p in ms_privs))
    vals = [Validator(pv.get_pub_key(), 10) for pv in ed_pvs]
    vals.append(Validator(secp_pv.get_pub_key(), 10))
    vals.append(Validator(ms_pub, 10))
    vs = ValidatorSet(vals)

    def ms_sign(vote, good=True):
        sb = vote.sign_bytes(CHAIN)
        ms = Multisignature.new(3)
        pubs = [p.pub_key() for p in ms_privs]
        ms.add_signature_from_pubkey(ms_privs[0].sign(sb), pubs[0], pubs)
        second = ms_privs[2].sign(sb if good else b"not the vote")
        ms.add_signature_from_pubkey(second, pubs[2], pubs)
        return vote.with_signature(ms.marshal())

    storm = []
    for pv in ed_pvs + [secp_pv]:
        storm.append(((0, PREVOTE), tv.make_vote(pv, vs, 0, PREVOTE, tv.BLOCK_A, CHAIN)))
    ms_idx, _ = vs.get_by_address(ms_pub.address())
    for bid, good in ((tv.BLOCK_A, True), (tv.BLOCK_B, False)):
        vote = Vote(vote_type=PREVOTE, height=1, round=0, timestamp_ns=tv.TS,
                    block_id=bid, validator_address=ms_pub.address(),
                    validator_index=ms_idx)
        storm.append(((0, PREVOTE), ms_sign(vote, good)))
    return vs, storm


@pytest.mark.parametrize("route", ROUTES)
def test_secp_and_multisig_ride_host_lanes(feeds, route):
    """secp256k1 and multisig voters push their flush to the verifier
    route (``verify_generic``); verdicts equal the serial path's."""
    vs, storm = _secp_multisig_storm()
    serial_sets = tv.fresh_sets(vs, CHAIN, rounds=(0,))
    want, _ = tv.run_serial(serial_sets, [storm])
    feed = route_feed(feeds, route, window_s=LONG, max_rows=8)
    sets = tv.fresh_sets(vs, CHAIN, rounds=(0,))
    seq0 = _last_seq()
    got, _ = tv.run_batched(sets, [storm], feed, timeout=TIMEOUT)
    assert got == want
    assert tv.vote_set_state(sets) == tv.vote_set_state(serial_sets)
    assert feed.votes_in == 7 and feed.dispatches == 1
    assert ("ErrVoteInvalidSignature", None) in got  # the bad aggregate
    kinds = [e["kind"] for e in _entries_since(seq0)]
    assert "host" in kinds  # the plan's mixed keys took the verifier route


# -- TestFlushTriggers --------------------------------------------------------


def test_quorum_flush_never_waits_out_the_deadline(feeds):
    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    feed = feeds(device="cpu", use_device=False, window_s=LONG)
    vset = VoteSet(CHAIN, 1, 0, PREVOTE, vs)
    tickets = []
    t0 = time.monotonic()
    for i, pv in enumerate(pvs[:3]):
        vote = tv.make_vote(pv, vs, 0, PREVOTE, tv.BLOCK_A, CHAIN)
        p = vset.prevalidate(vote)
        tickets.append(feed.submit((0, PREVOTE), p.pub_key, vote.sign_bytes(CHAIN),
                                   vote.signature, power=p.voting_power,
                                   total=vs.total_voting_power(), urgent=(i == 2)))
    verdicts = [t.result(timeout=TIMEOUT) for t in tickets]
    assert time.monotonic() - t0 < LONG - 5
    assert all(v.ok for v in verdicts)
    assert {v.flush_reason for v in verdicts} == {"quorum"}
    assert feed.flushes["quorum"] == 1
    assert (verdicts[0].batch_rows, verdicts[0].batch_lanes) == (1, 3)
    assert 0 < verdicts[0].occupancy <= 1


def test_the_cap_counts_pending_votes(feeds):
    """The worker stops collecting once max_rows * windows_per_dispatch()
    votes wait, even when they fill fewer rows (the reference's cap)."""
    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    feed = feeds(device="cpu", use_device=False, window_s=LONG, max_rows=1)
    assert planner.windows_per_dispatch() == 4
    vset = VoteSet(CHAIN, 1, 0, PREVOTE, vs)
    tickets = []
    t0 = time.monotonic()
    for pv in pvs:
        vote = tv.make_vote(pv, vs, 0, PREVOTE, tv.BLOCK_A, CHAIN)
        p = vset.prevalidate(vote)
        tickets.append(feed.submit((0, PREVOTE), p.pub_key, vote.sign_bytes(CHAIN),
                                   vote.signature))
    verdicts = [t.result(timeout=TIMEOUT) for t in tickets]
    assert time.monotonic() - t0 < LONG - 5
    assert [v.flush_reason for v in verdicts] == ["deadline"] * 4
    assert all(v.ok and v.batch_rows == 1 for v in verdicts)
    assert (feed.dispatches, feed.rows_out) == (1, 1)


def test_deadline_flush_fires_without_urgency(feeds):
    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    feed = feeds(device="cpu", use_device=False, window_s=0.02)
    vote = tv.make_vote(pvs[0], vs, 0, PREVOTE, tv.BLOCK_A, CHAIN)
    p = VoteSet(CHAIN, 1, 0, PREVOTE, vs).prevalidate(vote)
    v = feed.submit((0, PREVOTE), p.pub_key, vote.sign_bytes(CHAIN), vote.signature,
                    power=p.voting_power, total=vs.total_voting_power()).result(timeout=TIMEOUT)
    assert v.ok and v.flush_reason == "deadline"
    assert feed.flushes["deadline"] == 1


# -- TestGuardFallback: a breaker held open off the card ----------------------


@pytest.mark.parametrize("route", ["executor", "guarded_verifier"])
def test_breaker_open_feed_still_resolves(feeds, route):
    """A quarantined breaker off the card: the executor's guard completes
    the flush on the host (the feed's RLC verifier), the guarded verifier
    on its host verifier; every ticket gets the right verdict."""
    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    if route == "executor":
        feed = feeds(device="cpu", use_device=True, window_s=LONG)
    else:
        feed = feeds(device="cpu", window_s=LONG,
                     verifier=tbatch.GuardedBatchVerifier(tbatch.TorchBatchVerifier("cpu")))
    fallbacks = get_verify_metrics().device_fallback
    before = fallbacks._values.get(("quarantined",), 0.0)
    brk.get_device_breaker().quarantine("vote_batch_test")
    try:
        vset = VoteSet(CHAIN, 1, 0, PREVOTE, vs)
        good = tv.make_vote(pvs[0], vs, 0, PREVOTE, tv.BLOCK_A, CHAIN)
        bad = tv.make_vote(pvs[1], vs, 0, PREVOTE, tv.BLOCK_A, CHAIN).with_signature(
            b"\x01" * 64)
        pg, pb = vset.prevalidate(good), vset.prevalidate(bad)
        tg = feed.submit((0, 1), pg.pub_key, good.sign_bytes(CHAIN), good.signature)
        tb = feed.submit((0, 1), pb.pub_key, bad.sign_bytes(CHAIN), bad.signature)
        feed.flush_now()
        assert tg.result(timeout=TIMEOUT).ok is True
        assert tb.result(timeout=TIMEOUT).ok is False
    finally:
        brk.get_device_breaker().reset()
    assert fallbacks._values.get(("quarantined",), 0.0) == before + 1


# -- TestLifecycle ------------------------------------------------------------


def test_close_drains_pending_and_exits_worker():
    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    feed = planner.VoteFeed(device="cpu", use_device=False, window_s=60.0)
    vote = tv.make_vote(pvs[0], vs, 0, PREVOTE, tv.BLOCK_A, CHAIN)
    p = VoteSet(CHAIN, 1, 0, PREVOTE, vs).prevalidate(vote)
    t = feed.submit((0, 1), p.pub_key, vote.sign_bytes(CHAIN), vote.signature)
    feed.close()
    v = t.result(timeout=TIMEOUT)  # the pending vote still flushed
    assert v.ok and v.flush_reason == "close"
    feed.join(10.0)
    assert feed._thread is not None and not feed._thread.is_alive()
    with pytest.raises(RuntimeError):
        feed.submit((0, 1), p.pub_key, b"m", b"s" * 64)


def test_close_without_submissions_leaks_nothing():
    before = {th.name for th in threading.enumerate()}
    feed = planner.VoteFeed(device="cpu", use_device=False)
    feed.close()
    feed.join(5.0)
    after = {th.name for th in threading.enumerate()} - before
    assert not {n for n in after if n.startswith("planner-vote-feed")}


# -- port-only surface ----------------------------------------------------------


def test_flush_records_and_stamps(feeds):
    clock = iter(range(1_000, 10_000_000_000, 250_000_000))
    feed = feeds(device="cpu", use_device=False, window_s=LONG, now_ns=lambda: next(clock))
    seq0 = _last_seq()
    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    tickets = []
    for rnd in (0, 1):
        vset = VoteSet(CHAIN, 1, rnd, PREVOTE, vs)
        vote = tv.make_vote(pvs[rnd], vs, rnd, PREVOTE, tv.BLOCK_A, CHAIN)
        p = vset.prevalidate(vote)
        tickets.append(feed.submit((1, rnd, PREVOTE), p.pub_key, vote.sign_bytes(CHAIN),
                                   vote.signature))
    feed.flush_now()
    for t in tickets:
        assert t.result(timeout=TIMEOUT).ok
    recs = feed.flush_records()
    assert recs["capacity"] == planner.VoteFeed.FLUSH_RECORD_CAPACITY == 256
    assert recs["dropped"] == 0 and len(recs["records"]) == 1
    rec = recs["records"][0]
    assert set(rec) == {"reason", "votes", "rows", "groups", "t_open_ns", "t_flush_ns",
                        "wait_max_s", "wait_mean_s"}
    assert (rec["reason"], rec["votes"], rec["rows"]) == ("quorum", 2, 2)
    assert rec["groups"] == [[1, 0, PREVOTE], [1, 1, PREVOTE]]
    assert rec["t_open_ns"] == tickets[0].submitted_ns == 1_000
    assert tickets[1].submitted_ns == 250_001_000
    assert rec["t_flush_ns"] == tickets[0].flushed_ns == tickets[1].flushed_ns == 500_001_000
    assert rec["wait_max_s"] == 0.5 and rec["wait_mean_s"] == 0.375
    entry = [e for e in _entries_since(seq0) if e["kind"] == "consensus.vote_batch"][-1]
    assert (entry["height_base"], entry["heights"], entry["lanes_present"]) == (1, 1, 2)


def test_flush_record_ring_is_bounded(feeds, monkeypatch):
    monkeypatch.setattr(planner.VoteFeed, "FLUSH_RECORD_CAPACITY", 2)
    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    feed = feeds(device="cpu", use_device=False, window_s=LONG)
    vote = tv.make_vote(pvs[0], vs, 0, PREVOTE, tv.BLOCK_A, CHAIN)
    p = VoteSet(CHAIN, 1, 0, PREVOTE, vs).prevalidate(vote)
    for _ in range(3):
        t = feed.submit((0, 1), p.pub_key, vote.sign_bytes(CHAIN), vote.signature,
                        urgent=True)
        assert t.result(timeout=TIMEOUT).ok
    recs = feed.flush_records()
    assert (recs["capacity"], recs["dropped"], len(recs["records"])) == (2, 1, 2)


def test_metric_families_equal_the_reference():
    """The vote and mempool batch families: the same names, help texts,
    labels and buckets as the reference's, and a flush lands in them."""
    for port_cls, ref_cls in ((VoteBatchMetrics, RVoteBatchMetrics),
                              (MempoolBatchMetrics, RMempoolBatchMetrics)):
        port, ref = port_cls(), ref_cls()
        port.record_flush("quorum", rows=3, lanes=40, occupancy=0.625)
        ref.record_flush("quorum", rows=3, lanes=40, occupancy=0.625)
        if hasattr(port, "record_wait"):
            port.record_wait(0.004)
            ref.record_wait(0.004)
            port.record_wait(-1.0)
            ref.record_wait(-1.0)
        assert port.registry.expose_text() == ref.registry.expose_text()
    text = VoteBatchMetrics().registry.expose_text()
    for name in ("rows", "lanes", "lane_occupancy", "flush_total", "wait_seconds"):
        assert f"tendermint_consensus_vote_batch_{name}" in text


def test_vote_flush_counts_in_the_process_metrics(feeds):
    m = get_vote_batch_metrics()
    before = m.flushes._values.get(("quorum",), 0.0)
    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    feed = feeds(device="cpu", use_device=False, window_s=LONG)
    vote = tv.make_vote(pvs[0], vs, 0, PREVOTE, tv.BLOCK_A, CHAIN)
    p = VoteSet(CHAIN, 1, 0, PREVOTE, vs).prevalidate(vote)
    feed.submit((0, 1), p.pub_key, vote.sign_bytes(CHAIN), vote.signature,
                urgent=True).result(timeout=TIMEOUT)
    assert m.flushes._values.get(("quorum",), 0.0) == before + 1


def test_the_cpu_default_verifier_is_rlc_and_a_mesh_raises():
    feed = planner.VoteFeed(device="cpu")
    assert isinstance(feed.verifier, tbatch.RLCHostVerifier)
    assert feed.device == torch.device("cpu")
    explicit = tbatch.HostBatchVerifier()
    assert planner.VoteFeed(device="cpu", verifier=explicit).verifier is explicit
    with pytest.raises(NotImplementedError):
        planner.VoteFeed(mesh=object(), device="cpu")


@no_cuda
def test_no_device_and_no_card_raises():
    with pytest.raises(NoCudaDeviceError):
        planner.VoteFeed()
    with pytest.raises(NoCudaDeviceError):
        planner.VoteFeed(device="cuda")


def test_vote_feed_helper_follows_the_verify_section():
    assert vote_feed(VerifyConfig()) is None
    assert vote_feed(VerifyConfig(vote_batch_window_ms=0.0), device="cpu") is None
    feed = vote_feed(VerifyConfig(vote_batch_window_ms=5.0, vote_batch_rows=32), device="cpu")
    try:
        assert isinstance(feed, planner.VoteFeed)
        assert (feed.window_s, feed.max_rows) == (0.005, 32)
        assert isinstance(feed.verifier, tbatch.RLCHostVerifier)
        assert feed.use_device is None and feed.profile_kind == "consensus.vote_batch"
    finally:
        feed.close()


@no_cuda
def test_vote_feed_helper_needs_the_card_by_default():
    with pytest.raises(NoCudaDeviceError):
        vote_feed(VerifyConfig(vote_batch_window_ms=2.0))


def test_a_failed_flush_raises_into_every_ticket(feeds):
    """A verifier that raises: every ticket of the flush raises it (on the
    card this is how ``DeviceDispatchError`` reaches the caller)."""

    class Broken(tbatch.HostBatchVerifier):
        def verify_ed25519_raw(self, pubs, msgs, sigs):
            raise brk.DeviceDispatchError("error", "test")

    vs, pvs = tv.make_vals(4, keys=tv.KEYS_TEST)
    feed = feeds(device="cpu", use_device=False, window_s=LONG, verifier=Broken())
    vset = VoteSet(CHAIN, 1, 0, PREVOTE, vs)
    tickets = []
    for pv in pvs[:2]:
        vote = tv.make_vote(pv, vs, 0, PREVOTE, tv.BLOCK_A, CHAIN)
        p = vset.prevalidate(vote)
        tickets.append(feed.submit((0, 1), p.pub_key, vote.sign_bytes(CHAIN), vote.signature))
    feed.flush_now()
    for t in tickets:
        with pytest.raises(brk.DeviceDispatchError):
            t.result(timeout=TIMEOUT)
    assert feed.dispatches == 0 and feed.flushes["quorum"] == 0
