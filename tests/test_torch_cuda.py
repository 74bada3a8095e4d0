"""The CUDA kernels against their plain versions on the card. CUDA kernels
have no interpret mode, so these tests carry the ``cuda`` marker and skip
where no CUDA device is present (run them on the GPU with
``python -m pytest tests/test_torch_cuda.py -q``; ``chip_smoke.py`` runs the
same checks at full size)."""

import random

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import secp256k1 as ts
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import ed25519_msm as em
from tendermint_tpu_torch.ops import ed25519_verify as k5
from tendermint_tpu_torch.ops import secp256k1_cuda as sc
from tendermint_tpu_torch.ops import secp256k1_verify as k6
from tendermint_tpu_torch.parallel.mesh import DeviceMesh
from tendermint_tpu_torch.testutil import commit as tc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the GPU")
    return torch.device("cuda", 0)


def _window():
    pubs, msgs, sigs, _ = tc.go_edge_window(seed=2)
    n = len(pubs)
    pa = np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32)
    sa = np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64)
    return pa, msgs, sa


@pytest.mark.parametrize("length", [0, 104, 111, 112, 200])
def test_prologue_kernel_vs_plain(cuda, length):
    rng = np.random.default_rng(length)
    n = 256
    pubs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    m = rng.integers(0, 256, (n, length), dtype=np.uint8)
    msgs = [m[i].tobytes() for i in range(n)]
    tmpl, vrows, vwords = ec.pack_variable_words(pubs, msgs, sigs, length, n)
    args = [ec._put(a, cuda) for a in (
        tmpl, vrows, vwords, np.ascontiguousarray(pubs).view("<u4"),
        np.ascontiguousarray(sigs).view("<u4"))]
    before = ec.launches["ed25519_prologue"]
    got = ec.prologue(*args)
    torch.cuda.synchronize()
    assert ec.launches["ed25519_prologue"] == before + 1
    for g, w in zip(got, ec.prologue_ref(*args)):
        assert torch.equal(g, w)


def test_prologue_ragged_edge_leaves_rows_past_b_unwritten(cuda):
    """K1 at b = 200, not a multiple of the rows a block serves: the last
    block's threads past b must write nothing. The outputs are views of
    longer buffers filled with a sentinel; the tails keep it."""
    b, pad, sentinel, length = 200, 64, 0x5A5A5A5A, 104
    assert b % ec.K1_ROWS_PER_BLOCK
    rng = np.random.default_rng(7)
    pubs = rng.integers(0, 256, (b, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (b, 64), dtype=np.uint8)
    m = np.tile(rng.integers(0, 256, length, dtype=np.uint8), (b, 1))
    m[:, 17:25] = rng.integers(0, 256, (b, 8), dtype=np.uint8)
    tmpl, vrows, vwords = ec.pack_variable_words(
        pubs, [m[i].tobytes() for i in range(b)], sigs, length, b)
    ins = tuple(ec._put(a, cuda) for a in (
        tmpl, vrows, vwords, np.ascontiguousarray(pubs).view("<u4"),
        np.ascontiguousarray(sigs).view("<u4")))
    sizes = (ec.NWIN, ec.NWIN, ec.NLIMB, 1)
    bufs = [torch.full((n * b + pad,), sentinel, dtype=torch.int32, device=cuda) for n in sizes]
    outs = tuple(t[:n * b].view(n, b) for t, n in zip(bufs, sizes))
    before = ec.launches["ed25519_prologue"]
    ec.prologue_into(ins, outs)
    torch.cuda.synchronize()
    assert ec.launches["ed25519_prologue"] == before + 1
    for g, w in zip(outs, ec.prologue_ref(*ins)):
        assert torch.equal(g.cpu(), w.cpu())
    for t in bufs:
        assert bool((t[-pad:] == sentinel).all())


def test_ladder_kernel_vs_plain(cuda):
    pa, msgs, sa = _window()
    lens = np.array([len(m) for m in msgs])
    for ln in np.unique(lens):
        idx = np.nonzero(lens == ln)[0]
        neg, ay, valid = ec._decompress_valset(pa[idx])
        inputs, _ = ec.packed_inputs(pa[idx], [msgs[i] for i in idx], sa[idx],
                                     neg, ay, valid, int(ln), cuda)
        consts, negax, ayd, pubw, sigw, tmpl, vidx, vwords = inputs
        k1 = ec.prologue(tmpl, vidx, vwords, pubw, sigw)
        got = ec.ladder(consts, negax, ayd, *k1)
        torch.cuda.synchronize()
        for g, w in zip(got, ec.ladder_ref(consts, negax, ayd, *k1)):
            assert torch.equal(g, w)


def test_ladder_ragged_edge_leaves_rows_past_b_unwritten(cuda):
    """K2 at b = 200, not a multiple of the rows a block serves: the last
    block computes past b and must write nothing there. The outputs are
    views of longer buffers filled with a sentinel; the tails keep it."""
    b, pad, sentinel = 200, 64, 0x5A5A5A5A
    assert b % ec.K2_ROWS_PER_BLOCK
    rng = np.random.default_rng(6)
    negax, ay, rlimb = (rng.integers(0, 1 << 25, (10, b)) for _ in range(3))
    digs, digh = (rng.integers(0, 16, (64, b)) for _ in range(2))
    rsign = rng.integers(0, 2, (1, b))
    ins = tuple(ec._put(a, cuda) for a in (ec._CONSTS, negax, ay, digs, digh, rlimb, rsign))
    bufs = [torch.full((n + pad,), sentinel, dtype=torch.int32, device=cuda) for n in (b, 8 * b)]
    ok, renc = bufs[0][:b], bufs[1][:8 * b].view(8, b)
    before = ec.launches["ed25519_ladder"]
    ec.ladder_into(ins, ok, renc)
    torch.cuda.synchronize()
    assert ec.launches["ed25519_ladder"] == before + 1
    for g, w in zip((ok, renc), ec.ladder_ref(*ins)):
        assert torch.equal(g.cpu(), w.cpu())
    for t in bufs:
        assert bool((t[-pad:] == sentinel).all())


def test_verify_batch_on_cuda_vs_oracle(cuda):
    pa, msgs, sa = _window()
    got = ec.verify_batch(pa, msgs, sa, device=cuda)
    want = [ted._verify_pure(pa[i].tobytes(), msgs[i], sa[i].tobytes()) for i in range(len(msgs))]
    assert got.tolist() == want


def test_secp256k1_ladder_kernel_vs_plain(cuda):
    """K3 against its plain version on the edge window padded with random
    limbs and digits (off-curve points exercise the same arithmetic), and
    on the r + n branch rows."""
    pubs, digs, sigs, _ = tc.secp_edge_window(seed=2)
    host, _ = sc.pack_rows(pubs, digs, sigs, 128)
    qx, qy, d1, d2, rl, rnl, rnok = (h.copy() for h in host)
    rng = np.random.default_rng(3)
    m = len(pubs) + 2
    for a in (qx, qy, rl):
        a[m:] = rng.integers(0, 1 << 22, a[m:].shape)
    for a in (d1, d2):
        a[m:] = rng.integers(0, 16, a[m:].shape)
    # rows m-2, m-1: rnl = x(R) of row 0, rl another value, rnok 1 and 0
    for j, flag in ((m - 2, 1), (m - 1, 0)):
        for a in (qx, qy, d1, d2):
            a[j] = a[0]
        rnl[j] = rl[0]
        rl[j] = sc._limbs_batch([sc.F.limbs_to_int(rl[0].tolist()) + 1])[0]
        rnok[j] = flag
    ins = sc.upload((qx, qy, d1, d2, rl, rnl, rnok), cuda)
    before = sc.launches["secp256k1_ladder"]
    got = sc.ladder(*ins)
    torch.cuda.synchronize()
    assert sc.launches["secp256k1_ladder"] == before + 1
    for g, w in zip(got, sc.ladder_ref(*ins)):
        assert torch.equal(g.cpu(), w.cpu())
    assert got[0][m - 2].item() == 1 and got[0][m - 1].item() == 0


def test_secp256k1_ladder_ragged_edge_leaves_rows_past_b_unwritten(cuda):
    """b = 200 is not a multiple of the rows a block serves: the last block
    computes past b and must write nothing there. The outputs are views of
    longer buffers filled with a sentinel; the tails keep it."""
    b, pad, sentinel = 200, 64, 0x5A5A5A5A
    assert b % sc.K3_ROWS_PER_BLOCK
    rng = np.random.default_rng(5)
    qx, qy, rl, rnl = (rng.integers(0, 1 << 22, (b, 10)).astype(np.uint32) for _ in range(4))
    d1, d2 = (rng.integers(0, 16, (b, 64)).astype(np.uint32) for _ in range(2))
    rnok = rng.integers(0, 2, (b,)).astype(np.uint32)
    ins = sc.upload((qx, qy, d1, d2, rl, rnl, rnok), cuda)
    bufs = [torch.full((n + pad,), sentinel, dtype=torch.int32, device=cuda)
            for n in (b, 10 * b, 10 * b)]
    ok, X, Z = bufs[0][:b], bufs[1][:10 * b].view(10, b), bufs[2][:10 * b].view(10, b)
    sc.ladder_into(ins, ok, X, Z)
    torch.cuda.synchronize()
    for g, w in zip((ok, X, Z), sc.ladder_ref(*ins)):
        assert torch.equal(g.cpu(), w.cpu())
    for t in bufs:
        assert bool((t[-pad:] == sentinel).all())


def test_secp256k1_verify_batch_on_cuda_vs_oracle(cuda):
    pubs, digs, sigs, verdicts = tc.secp_edge_window(seed=4)
    got = sc.verify_batch(pubs, digs, sigs, device=cuda)
    want = [ts.verify(p, d, g) for p, d, g in zip(pubs, digs, sigs)]
    assert got.tolist() == want == [verdicts[i] for i in range(len(pubs))]


def _ragged_signed_window():
    """A ragged window (valsets of 1, 4 and 16, two message lengths) with a
    flipped bit, an absent vote and a 63-byte signature."""
    rng = np.random.default_rng(21)
    votes, powers, totals = [], [], []
    for h, V in enumerate((1, 4, 16, 4)):
        vrow, prow = [], []
        for v in range(V):
            priv = ted.gen_privkey(rng.bytes(32))
            msg = b"cuda-window-%02d-%02d" % (h, v) + b"x" * (20 * (v % 2))
            sig = ted.sign(priv, msg)
            if (h, v) == (2, 3):
                sig = sig[:40] + bytes([sig[40] ^ 2]) + sig[41:]
            if (h, v) == (2, 7):
                sig = sig[:63]
            vrow.append(None if (h, v) == (1, 1) else (priv[32:], msg, sig))
            prow.append(1 + h + v)
        votes.append(vrow)
        powers.append(prow)
        totals.append(sum(prow))
    return votes, powers, totals


@pytest.mark.parametrize("reduce", ["device", "host"])
def test_planner_executor_on_cuda_equals_its_cpu_run(cuda, reduce):
    from tendermint_tpu_torch.parallel import planner

    votes, powers, totals = _ragged_signed_window()
    planner.set_reduce_mode(reduce)
    try:
        plain = planner.device_executor("cpu")(planner.plan_window(votes, powers, totals))
        before = dict(ec.launches)
        got = planner.device_executor(cuda)(planner.plan_window(votes, powers, totals))
        if cuda.type == "cuda":  # two message lengths: two groups
            for name in ("ed25519_prologue", "ed25519_ladder"):
                assert ec.launches[name] == before[name] + 2
    finally:
        planner.set_reduce_mode("device")
    for k in ("ok", "tally", "committed", "sigs_ok"):
        assert np.array_equal(getattr(got, k), getattr(plain, k)), k
    assert got.sigs_ok.tolist() == [True, True, False, True]
    assert got.lanes_dispatched == 64


def test_planner_device_tally_equals_host_reduce(cuda):
    from tendermint_tpu_torch.parallel import planner

    votes, powers, totals = _ragged_signed_window()
    plan = planner.plan_window(votes, powers, totals)
    pack = planner.pack_device(plan, cuda)
    ok = planner._planner_step(pack, "host")
    before = planner.tally_launches["planner_tally"]
    tally, committed, nbad = planner.segment_tally(
        ok, pack.power, pack.is_vote, pack.seg_ids, pack.totals)
    assert planner.tally_launches["planner_tally"] == before + 1
    assert tally.dtype == torch.int64 and tally.device.type == "cuda"
    want = planner._host_reduce(plan, ok.cpu().numpy()[: plan.n_lanes])
    for g, w in zip((tally, committed, nbad), want):
        assert np.array_equal(g.cpu().numpy()[: plan.H], w)


def test_guarded_verifier_on_cuda_raises_rather_than_use_the_host(cuda, monkeypatch):
    from tendermint_tpu_torch.crypto import batch as tbatch
    from tendermint_tpu_torch.libs import breaker as brk

    class NoHost:
        def __getattr__(self, name):
            raise AssertionError(f"the guard called the host's {name} on the card")

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    pubs, msgs, sigs = _window()
    g = tbatch.GuardedBatchVerifier(
        tbatch.TorchBatchVerifier(cuda), host=NoHost(), retries=1, audit_rate=1.0,
        breaker=brk.CircuitBreaker(threshold=2, backoff_base=60.0))
    assert g.on_card
    rows = [bytes(p) for p in pubs], msgs, [bytes(s) for s in sigs]
    assert np.array_equal(g.verify_ed25519_raw(*rows),
                          tbatch.TorchBatchVerifier("cpu").verify_ed25519_raw(*rows))
    monkeypatch.setattr(ec, "verify_batch", boom)
    with pytest.raises(brk.DeviceDispatchError) as e:
        g.verify_ed25519_raw(*rows)
    assert e.value.reason == "error" and g.breaker.state == brk.OPEN


def test_go_edge_window_through_the_cuda_executor(cuda):
    """Every Go verification edge as one window through the device executor
    on the card: K1 -> K2 -> the tally equal the CPU run of the plain
    versions, and Go's fixed verdicts."""
    from tendermint_tpu_torch.parallel import planner

    votes, powers, totals, fixed = tc.go_edge_window_spec()
    plain = planner.device_executor("cpu")(planner.plan_window(votes, powers, totals))
    before = dict(ec.launches)
    got = planner.device_executor(cuda)(planner.plan_window(votes, powers, totals))
    assert ec.launches["ed25519_ladder"] > before["ed25519_ladder"]
    for k in ("ok", "tally", "committed", "sigs_ok"):
        assert np.array_equal(getattr(got, k), getattr(plain, k)), k
    flat = got.ok.reshape(-1)
    for i, verdict in fixed.items():
        if verdict is not None:
            assert bool(flat[i]) == verdict, i


def test_pipeline_and_lane_feed_on_cuda(cuda):
    """The backfill's WindowPipeline (packing inside the guard on the card)
    and a LaneFeed burst through the configuration root's installs: verdicts
    equal the construction's, no fallback."""
    from tendermint_tpu_torch.libs import breaker as brk
    from tendermint_tpu_torch.libs.metrics import get_verify_metrics
    from tendermint_tpu_torch.node.verify_root import configure_verify, reset_verify
    from tendermint_tpu_torch.parallel import planner
    from tendermint_tpu_torch.testutil import window as tw

    win = tw.build_window(8, 4, seed=13)
    tw.flip_bit(win, 1, 2)
    tw.drop_precommits(win, 3, 2)
    tw.short_signature(win, 4, 0)
    votes, powers, totals = win.rows()
    want = tw.expected(win)
    configure_verify(device=cuda)
    feed = planner.LaneFeed(window_s=30.0)
    try:
        fell_back = sum(get_verify_metrics().device_fallback._values.values())
        before = dict(ec.launches)
        it = planner.WindowPipeline(use_device=True, depth=2).run(
            (votes[s:s + 2], powers[s:s + 2], totals[s:s + 2]) for s in range(0, 8, 2))
        try:
            got = list(it)
        finally:
            it.close()
        assert ec.launches["ed25519_prologue"] == before["ed25519_prologue"] + 4
        for k in ("ok", "tally", "committed", "sigs_ok"):
            assert np.array_equal(np.concatenate([getattr(g, k) for g in got]), want[k]), k
        tickets = [feed.submit(votes[h], powers[h], totals[h]) for h in range(8)]
        feed.flush_now()
        rows = [t.result(120.0) for t in tickets]
        assert feed.dispatches == 1
        for h, r in enumerate(rows):
            assert np.array_equal(r.ok, want["ok"][h]) and r.tally == want["tally"][h]
            assert (r.committed, r.sigs_ok) == (want["committed"][h], want["sigs_ok"][h])
        assert sum(get_verify_metrics().device_fallback._values.values()) == fell_back
        assert brk.get_device_breaker().state == brk.CLOSED
    finally:
        feed.close()
        reset_verify()


def test_multisig_route_on_cuda(cuda):
    """Multisig aggregates flatten into one K1 + K2 call on the card, with
    the CPU plain versions' verdicts."""
    from tendermint_tpu_torch.crypto import batch as tbatch
    from tendermint_tpu_torch.testutil import multisig as tm

    s = tm.build(8)
    sigs = list(s.sigs)
    sigs[2] = tm.flip_sub_signature(sigs[2], 1)
    sigs[5] = tm.below_threshold(sigs[5])
    plain = tbatch.verify_generic(s.pubkeys, s.msgs, sigs,
                                  verifier=tbatch.TorchBatchVerifier("cpu"))
    before = dict(ec.launches)
    got = tbatch.verify_generic(s.pubkeys, s.msgs, sigs, verifier=tbatch.TorchBatchVerifier(cuda))
    assert ec.launches["ed25519_prologue"] == before["ed25519_prologue"] + 1
    assert ec.launches["ed25519_ladder"] == before["ed25519_ladder"] + 1
    assert np.array_equal(got, plain) and np.flatnonzero(~got).tolist() == [2, 5]


def test_lite_frontend_on_cuda_equals_its_cpu_run(cuda):
    """A churn chain (7 validators, 3 replaced every 8 heights, so every
    long hop bisects) through LiteFrontend on the card, its feed over the
    configuration root's guarded verifier (K1 + K2), against the same
    frontend on the CPU over HostBatchVerifier: equal light_block bytes at
    every height asked and an equal trust frontier; no fallback."""
    from tendermint_tpu_torch.crypto import batch as tbatch
    from tendermint_tpu_torch.frontend import LiteFrontend
    from tendermint_tpu_torch.libs import breaker as brk
    from tendermint_tpu_torch.libs.metrics import get_verify_metrics
    from tendermint_tpu_torch.node.verify_root import configure_verify, reset_verify
    from tendermint_tpu_torch.testutil import lite_chain as lc

    ch = lc.build_lite_chain(7, 24, change_heights=(9, 17), n_change=3, seed=5)
    heights = (24, 5, 13, 20)

    def run(**kw):
        fe = LiteFrontend(ch.chain_id, ch.provider(), **kw)
        try:
            fe.init_trust(ch.full_commit(1))
            raws = [fe.light_block(h) for h in heights]
            return raws, fe.trusted.latest_full_commit(ch.chain_id, 1, 1 << 60).height
        finally:
            fe.close()

    want = run(inner_verifier=tbatch.HostBatchVerifier())
    configure_verify(device=cuda)
    try:
        fell_back = sum(get_verify_metrics().device_fallback._values.values())
        before = dict(ec.launches)
        got = run()
        for name in ("ed25519_prologue", "ed25519_ladder"):
            assert ec.launches[name] > before[name]
        assert sum(get_verify_metrics().device_fallback._values.values()) == fell_back
        assert brk.get_device_breaker().state == brk.CLOSED
    finally:
        reset_verify()
    assert got == want
    assert want[0] == [ch.full_commits[h] for h in heights]


@pytest.mark.parametrize("use_device", [False, True])
def test_vote_storm_on_cuda_equals_its_cpu_run(cuda, use_device):
    """The 64-validator wave storm through VoteFeed on the card (the
    verifier route over the configuration root's guarded verifier, or the
    device executor) against the same feed on the CPU (RLCHostVerifier):
    equal outcomes, evidence and vote-set states; K1 and K2 launched; no
    fallback, the breaker closed."""
    from tendermint_tpu_torch.libs import breaker as brk
    from tendermint_tpu_torch.libs.metrics import get_verify_metrics
    from tendermint_tpu_torch.node.verify_root import configure_verify, reset_verify
    from tendermint_tpu_torch.parallel import planner
    from tendermint_tpu_torch.testutil import votes as tv

    vs, pvs = tv.make_vals(64)
    storm = tv.build_storm(vs, pvs, seed=7, waves=6)

    def run(**kw):
        feed = planner.VoteFeed(window_s=30.0, max_rows=512, **kw)
        try:
            sets = tv.fresh_sets(vs)
            outcomes, evidence = tv.run_batched(sets, storm, feed, timeout=300.0)
            return outcomes, tv.evidence_key(evidence), tv.vote_set_state(sets)
        finally:
            feed.close()
            feed.join(10.0)

    want = run(device="cpu", use_device=False)
    configure_verify(device=cuda)
    try:
        fell_back = sum(get_verify_metrics().device_fallback._values.values())
        before = dict(ec.launches)
        got = run(use_device=use_device)
        for name in ("ed25519_prologue", "ed25519_ladder"):
            assert ec.launches[name] > before[name]
        assert sum(get_verify_metrics().device_fallback._values.values()) == fell_back
        assert brk.get_device_breaker().state == brk.CLOSED
    finally:
        reset_verify()
    assert got == want


def _k4_inputs(dev, n, seed, bad=()):
    """K4's inputs for the RLC of n seeded signatures (``bad`` forged in s)."""
    rng = np.random.default_rng(seed)
    items = []
    for j in range(n):
        priv = ted.gen_privkey(rng.bytes(32))
        msg = b"k4-%d-%d" % (seed, j)
        sig = bytearray(ted.sign(priv, msg))
        if j in bad:
            sig[40] ^= 1
        items.append((priv[32:], msg, bytes(sig)))
    rows = [r[1:] for r in ted._parse_batch(items)[0]]
    return em.device_inputs(*em.rlc_inputs(rows, random.Random(1234)), dev)


@pytest.mark.parametrize("n, bad", [(16, ()), (16, (3,)), (300, ()), (1100, (7, 900))])
def test_msm_kernel_vs_plain(cuda, n, bad):
    """K4 against msm_plain, the plain version of its own schedule, on one
    schedule, at every bucket width from c = 5 to c = 8: the verdict and the
    canonical final point exact, one launch a call; and against msm_ref,
    the reference's schedule: the same verdict and group element."""
    ins = _k4_inputs(cuda, n, n, bad)
    before = em.launches["ed25519_msm"]
    ok, pt = em.msm(*ins)
    torch.cuda.synchronize()
    assert em.launches["ed25519_msm"] == before + 1
    ok_plain, pt_plain = em.msm_plain(*ins)
    assert torch.equal(ok.cpu(), ok_plain.cpu()) and torch.equal(pt.cpu(), pt_plain.cpu())
    ok_ref, pt_ref = em.msm_ref(*ins)
    assert torch.equal(ok.cpu(), ok_ref.cpu()) and em.same_point(pt.cpu(), pt_ref.cpu())
    assert ok.item() == (0 if bad else 1)


def test_rlc_verify_batch_on_the_card(cuda):
    """The Go-edge window through one MSM on the card: K1, K4, and K1 + K2
    on the localized rows; the verdicts equal the CPU run's at the same
    seed and the ladder's."""
    pa, msgs, sa = _window()
    before = em.launches["ed25519_msm"]
    got = ec.rlc_verify_batch(pa, msgs, sa, device=cuda, seed=1234)
    assert em.launches["ed25519_msm"] == before + 1
    assert np.array_equal(got, ec.rlc_verify_batch(pa, msgs, sa, device="cpu", seed=1234))
    assert np.array_equal(got, ec.verify_batch(pa, msgs, sa, device=cuda))


def test_k5_kernel_vs_plain(cuda):
    """K5 (K2's windowed two-lane ed25519 ladder, its digits from the
    scalars' bit words) against its plain version (the reference's
    bit-serial ladder) on the card: the Go-edge window and seeded rows, 300
    rows in a ragged last block, exact on every row, one launch."""
    rng = np.random.default_rng(55)
    pubs, msgs, sigs, _ = tc.go_edge_window(seed=2)
    while len(pubs) < 300:
        priv = ted.gen_privkey(rng.bytes(32))
        msg = rng.bytes(int(rng.integers(0, 200)))
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(ted.sign(priv, msg))
    pa = np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 32)
    sa = np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, 64)
    *host, valid = k5.host_prologue(pa, msgs, sa)
    ins = k5.upload(host, cuda)
    before = k5.launches["ed25519_verify"]
    ok = k5.verify_rows(*ins)
    torch.cuda.synchronize()
    assert k5.launches["ed25519_verify"] == before + 1
    assert torch.equal(ok.cpu(), k5.verify_ref(*ins).cpu())
    assert np.array_equal((ok.cpu().numpy() != 0) & valid, ec.verify_batch(pa, msgs, sa,
                                                                          device=cuda))


def test_k6_kernel_vs_plain(cuda):
    """K6 (K3's windowed two-lane secp256k1 ladder, its digits from the
    scalars' bit words) against its plain version (the reference's
    bit-serial ladder) on the card: the secp256k1 edge window and seeded
    rows, 200 rows in a ragged last block, exact."""
    rng = np.random.default_rng(56)
    pubs, digs, sigs, _ = tc.secp_edge_window(seed=3)
    while len(pubs) < 200:
        priv = ts.gen_privkey(rng.bytes(32))
        dig = rng.bytes(32)
        pubs.append(ts.pubkey_compressed(priv))
        digs.append(dig)
        sigs.append(ts.sign(priv, dig))
    host, forced = k6.pack_rows(pubs, digs, sigs, len(pubs))
    ins = k6.upload(host, cuda)
    ok = k6.verify_rows(*ins)
    torch.cuda.synchronize()
    assert torch.equal(ok.cpu(), k6.verify_ref(*ins).cpu())
    got = np.where(forced >= 0, forced.astype(bool), ok.cpu().numpy() != 0)
    assert got.tolist() == [ts.verify(p, d, g) for p, d, g in zip(pubs, digs, sigs)]


def test_a_mesh_of_one_card(cuda):
    """Four shards on one card: K5 and K6 once a shard that holds rows, the
    verdicts the unsharded call's."""
    mesh = DeviceMesh([cuda] * 4)
    pa, msgs, sa = _window()
    before = k5.launches["ed25519_verify"]
    got = k5.verify_batch(pa, msgs, sa, mesh)
    # 20 rows in a bucket of 64: shards of 16, two of them hold rows
    assert k5.launches["ed25519_verify"] == before + 2
    assert np.array_equal(got, k5.verify_batch(pa, msgs, sa, device=cuda))
    pubs, digs, sigs, _ = tc.secp_edge_window(seed=4)
    assert np.array_equal(k6.verify_batch(pubs, digs, sigs, mesh),
                          k6.verify_batch(pubs, digs, sigs, device=cuda))
