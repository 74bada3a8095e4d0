"""The port's planner (tendermint_tpu_torch/parallel/planner.py) against the
reference's ``planner.verify_window`` with the reference's
``HostBatchVerifier``: the same seeded windows through both, on every
route of the port — the verifier route over ``TorchBatchVerifier("cpu")``
(the plain versions of K1 and K2) and the device executor on the CPU with
the tally reduced on the device and on the host. Verdict grids, int64
tallies, ``committed`` and ``sigs_ok`` must be equal, exactly."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.keys import PubKeyEd25519 as JEd
from tendermint_tpu.crypto.keys import PubKeySecp256k1 as JSecp
from tendermint_tpu.parallel import planner as jplanner
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import secp256k1 as tsecp
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519 as TEd
from tendermint_tpu_torch.crypto.keys import PubKeySecp256k1 as TSecp
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.testutil import secp_signer

ROUTES = ("verifier", "device/device", "device/host")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on tensors of a few hundred elements, where
    torch's thread pool buys nothing; one thread keeps this file from
    crowding the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    # the plain versions of K1 and K2 on a loaded CPU can outlast the
    # default 30 s dispatch deadline, which would end in a host fallback:
    # run the executor unsupervised (the guard has its own tests)
    brk.configure_device_guard(dispatch_deadline=0)
    planner.set_device_executor(planner.device_executor("cpu"))
    planner.set_reduce_mode("device")
    yield
    planner.set_device_executor(None)
    planner.set_reduce_mode("device")
    brk.reset_device_guard()


def _signed(n, tag, lengths=2):
    """n seeded (pub, msg, sig) triples; the messages take ``lengths``
    lengths, so that the device route packs that many groups."""
    rng = np.random.default_rng(500 + tag)
    out = []
    for i in range(n):
        priv = ted.gen_privkey(rng.bytes(32))
        msg = b"planner-%03d-%03d" % (tag, i) + rng.bytes(int(rng.integers(0, lengths)) * 20)
        out.append((priv[32:], msg, ted.sign(priv, msg)))
    return out


def _ragged_window(sizes, absent=(), forged=(), malformed=(), tag=0, lengths=2):
    triples = _signed(sum(sizes), tag, lengths)
    votes, powers, totals = [], [], []
    i = 0
    for h, V in enumerate(sizes):
        vrow, prow = [], []
        for v in range(V):
            pub, msg, sig = triples[i]
            i += 1
            if (h, v) in absent:
                vrow.append(None)
            elif (h, v) in forged:
                bad = bytearray(sig)
                bad[7] ^= 1
                vrow.append((pub, msg, bytes(bad)))
            elif (h, v) in malformed:
                vrow.append((pub, msg, sig[:63]))
            else:
                vrow.append((pub, msg, sig))
            prow.append((h + v) % 9 + 1)
        votes.append(vrow)
        powers.append(prow)
        totals.append(sum(prow))
    return votes, powers, totals


def _run(route, votes, powers, totals):
    use_device = route != "verifier"
    if use_device:
        planner.set_reduce_mode(route.split("/")[1])
    return planner.verify_window(votes, powers, totals,
                                 verifier=tbatch.TorchBatchVerifier("cpu"),
                                 use_device=use_device)


def _reference(votes, powers, totals):
    return jplanner.verify_window(votes, powers, totals,
                                  verifier=jbatch.HostBatchVerifier(), use_device=False)


def _assert_equal(got, want):
    assert got.tally.dtype == np.int64
    for k in ("ok", "tally", "committed", "sigs_ok"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.lanes_present == want.lanes_present


@pytest.mark.parametrize("route", ROUTES)
def test_ragged_1_4_16_window(route):
    votes, powers, totals = _ragged_window(
        [1, 4, 16, 4, 1, 16, 4, 1],
        absent={(1, 2), (2, 10), (5, 0)},
        forged={(2, 3), (3, 1)},
        malformed={(5, 9)},
        tag=1,
    )
    got = _run(route, votes, powers, totals)
    want = _reference(votes, powers, totals)
    _assert_equal(got, want)
    assert got.sigs_ok.tolist() == [True, True, False, False, True, False, True, True]
    if route != "verifier":
        assert got.lanes_dispatched == planner.lanes_bucket(got.lanes_present) == 64


@pytest.mark.parametrize("route", ROUTES)
def test_strict_two_thirds_boundary(route):
    votes, _, _ = _ragged_window([3], tag=3)
    votes[0][2] = None
    got = _run(route, votes, [[1, 1, 1]], [3])  # 2 * 3 == 3 * 2: no commit
    _assert_equal(got, _reference(votes, [[1, 1, 1]], [3]))
    assert (int(got.tally[0]), bool(got.committed[0]), bool(got.sigs_ok[0])) == (2, False, True)
    got2 = _run(route, votes, [[2, 1, 1]], [3])
    _assert_equal(got2, _reference(votes, [[2, 1, 1]], [3]))
    assert (int(got2.tally[0]), bool(got2.committed[0])) == (3, True)


@pytest.mark.parametrize("route", ROUTES)
def test_all_absent_height(route):
    votes, powers, totals = _ragged_window([4, 4, 2], tag=4)
    votes[1] = [None] * 4
    got = _run(route, votes, powers, totals)
    _assert_equal(got, _reference(votes, powers, totals))
    assert (int(got.tally[1]), bool(got.committed[1]), bool(got.sigs_ok[1])) == (0, False, True)


@pytest.mark.parametrize("route", ROUTES)
def test_int64_powers_do_not_wrap(route):
    """Powers near 2^59 and 2^61 per vote: tallies whose threefold passes
    2^62 (still inside int64), none of which fits 32 bits or a float64
    mantissa exactly."""
    big = [[1 << 59, (1 << 59) + 1, (1 << 59) + 3], [(1 << 61) - 1, 5]]
    votes, _, _ = _ragged_window([3, 2], tag=5)
    totals = [sum(big[0]), sum(big[1])]
    got = _run(route, votes, big, totals)
    _assert_equal(got, _reference(votes, big, totals))
    assert got.tally.tolist() == totals and got.committed.tolist() == [True, True]
    votes[0][0] = votes[0][1] = None
    got = _run(route, votes, big, totals)
    _assert_equal(got, _reference(votes, big, totals))
    assert got.tally.tolist() == [(1 << 59) + 3, totals[1]]
    assert got.committed.tolist() == [False, True]


def _mixed_window():
    """h0 ed25519 only, h1 secp256k1 only, h2 one of each (one of them
    forged); the port's key objects and the reference's over the same
    bytes."""
    rng = np.random.default_rng(77)
    ed_privs = [ted.gen_privkey(rng.bytes(32)) for _ in range(3)]
    sk_privs = [tsecp.gen_privkey(rng.bytes(32)) for _ in range(2)]
    msgs = [b"mixed-%d" % h for h in range(3)]
    rows = [
        [(p, msgs[0]) for p in ed_privs],
        [(p, msgs[1]) for p in sk_privs],
        [(ed_privs[0], msgs[2]), (sk_privs[0], msgs[2]), (sk_privs[1], msgs[2])],
    ]
    tvotes, jvotes = [], []
    for h, row in enumerate(rows):
        trow, jrow = [], []
        for v, (priv, msg) in enumerate(row):
            sig = tc.sign(priv, msg)
            if (h, v) == (2, 2):
                sig = sig[:-1] + bytes([sig[-1] ^ 1])
            if len(priv) == 64:
                tk, jk = TEd(priv[32:]), JEd(priv[32:])
            else:
                raw = secp_signer.pubkey_compressed(priv)
                tk, jk = TSecp(raw), JSecp(raw)
            trow.append((tk, msg, sig))
            jrow.append((jk, msg, sig))
        tvotes.append(trow)
        jvotes.append(jrow)
    return tvotes, jvotes, [[1] * 3, [1] * 2, [1] * 3], [3, 2, 3]


@pytest.mark.parametrize("route", ROUTES)
def test_mixed_key_window_takes_the_verifier_route(route):
    tvotes, jvotes, powers, totals = _mixed_window()
    calls = {"n": 0}
    cpu = planner.device_executor("cpu")

    def counting(plan, mesh=None):
        calls["n"] += 1
        return cpu(plan, mesh)

    planner.set_device_executor(counting)
    got = _run(route, tvotes, powers, totals)
    _assert_equal(got, _reference(jvotes, powers, totals))
    assert calls["n"] == 0  # secp256k1 lanes cannot ride the ed25519 kernels
    assert got.sigs_ok.tolist() == [True, True, False]
    assert got.committed.tolist() == [True, True, False]


@pytest.mark.parametrize("route", ROUTES)
def test_wrong_length_raw_key_fails_its_lane(route):
    votes, powers, totals = _ragged_window([3, 2], tag=70)
    pub, msg, sig = votes[0][1]
    votes[0][1] = (bytes(pub)[:31], msg, sig)
    got = _run(route, votes, powers, totals)
    _assert_equal(got, _reference(votes, powers, totals))
    assert got.ok[0].tolist() == [True, False, True]
    assert got.sigs_ok.tolist() == [False, True]


@pytest.mark.parametrize("route", ROUTES)
def test_verify_windows_equals_flat_verify_window(route):
    specs = [
        _ragged_window([1, 4], tag=40),
        _ragged_window([16, 2], forged={(1, 1)}, tag=41),
        _ragged_window([4], absent={(0, 3)}, tag=42),
    ]
    use_device = route != "verifier"
    if use_device:
        planner.set_reduce_mode(route.split("/")[1])
    verifier = tbatch.TorchBatchVerifier("cpu")
    got = planner.verify_windows(specs, verifier=verifier, use_device=use_device)
    assert len(got) == len(specs)
    for verdict, spec in zip(got, specs):
        _assert_equal(verdict, _reference(*spec))
        flat = planner.verify_window(*spec, verifier=verifier, use_device=use_device)
        for k in ("ok", "tally", "committed", "sigs_ok"):
            assert np.array_equal(getattr(verdict, k), getattr(flat, k))


def test_buckets_and_compile_count():
    planner.reset_cache()
    for tag, sizes in enumerate([[1, 4], [16, 3, 2], [8] * 8]):
        votes, powers, totals = _ragged_window(sizes, tag=10 + tag, lengths=1)
        v = planner.verify_window(votes, powers, totals, use_device=True)
        assert (v.lanes_dispatched, planner.segs_bucket(len(sizes))) == (64, 8)
    assert planner.compile_count() == 1
    votes, powers, totals = _ragged_window([40, 30], tag=20, lengths=1)
    assert planner.verify_window(votes, powers, totals, use_device=True).lanes_dispatched == 128
    assert planner.compile_count() == 2
    planner.reset_cache()
    assert planner.compile_count() == 0


@pytest.mark.parametrize("n", [0, 1, 64, 65, 4096, 4097, 8193, 32768])
def test_bucket_ladders_equal_the_reference(n):
    assert planner.lanes_bucket(n) == jplanner.lanes_bucket(n)
    assert planner.segs_bucket(n) == jplanner.segs_bucket(n)


def test_plan_equals_the_reference_plan():
    votes, powers, totals = _ragged_window([3, 5, 1], absent={(1, 1)}, malformed={(1, 3)}, tag=6)
    got, want = planner.plan_window(votes, powers, totals), jplanner.plan_window(votes, powers, totals)
    for k in ("H", "V", "coords", "seg_ids", "powers", "wellformed", "totals", "msgs", "sigs"):
        assert np.array_equal(np.asarray(getattr(got, k)), np.asarray(getattr(want, k))), k
    pack = planner.pack_device(got, planner.device_executor("cpu").device)
    B, S = pack.shape
    assert (B, S) == (64, 8) and got.dev is pack
    assert pack.seg_ids[got.n_lanes:].tolist() == [S - 1] * (B - got.n_lanes)
    assert pack.present_host.tolist() == (
        list(got.wellformed) + [False] * (B - got.n_lanes))


def test_segment_tally_equals_host_reduce():
    rng = np.random.default_rng(9)
    votes, powers, totals = _ragged_window([5, 7, 3, 1], tag=7)
    plan = planner.plan_window(votes, powers, totals)
    ok_l = rng.integers(0, 2, plan.n_lanes).astype(bool)
    pack = planner.pack_device(plan, torch.device("cpu"))
    ok = torch.zeros(pack.shape[0], dtype=torch.bool)
    ok[: plan.n_lanes] = torch.from_numpy(ok_l)
    tally, committed, nbad = planner.segment_tally(
        ok, torch.from_numpy(plan.powers).new_tensor(
            np.pad(plan.powers, (0, pack.shape[0] - plan.n_lanes))),
        pack.is_vote, pack.seg_ids, pack.totals)
    want = planner._host_reduce(plan, ok_l)
    for g, w in zip((tally, committed, nbad), want):
        assert np.array_equal(g.numpy()[: plan.H], w)


def test_configure_planner_knobs():
    class Cfg:
        pipeline_depth = 3
        windows_per_device = 6
        planner_reduce = "HOST"

    try:
        planner.configure_planner(Cfg())
        assert planner.reduce_mode() == "host"
        assert (planner.pipeline_depth(), planner.windows_per_dispatch()) == (3, 6)
        assert planner.WindowPipeline(use_device=False).depth == 3
        Cfg.planner_reduce = "gpu"
        with pytest.raises(ValueError):
            planner.configure_planner(Cfg())
        assert planner.reduce_mode() == "host"
        with pytest.raises(ValueError):
            planner.set_reduce_mode("gpu")
        Cfg.pipeline_depth, Cfg.windows_per_device, Cfg.planner_reduce = 0, -2, "device"
        planner.configure_planner(Cfg())  # floors of 1, as the reference's
        assert (planner.pipeline_depth(), planner.windows_per_dispatch()) == (1, 1)
        with pytest.raises(NotImplementedError, match=r"item 4b \(iii\)"):
            planner.windows_per_dispatch(mesh=object())
    finally:
        planner.configure_planner(None)
    assert planner.reduce_mode() == "device"
    assert (planner.pipeline_depth(), planner.windows_per_dispatch()) == (2, 4)


def test_mesh_is_not_ported():
    votes, powers, totals = _ragged_window([2], tag=8)
    plan = planner.plan_window(votes, powers, totals)
    with pytest.raises(NotImplementedError, match="item 4b"):
        planner.device_executor("cpu")(plan, mesh=object())


def _reference_profiler_kind():
    from tendermint_tpu.libs.profile import get_profiler as jprofiler

    return jprofiler().entries()[-1]["kind"]


def _key_window(key):
    """Two heights of raw ed25519 keys wrapped by ``key`` (a numpy row, a
    key object of another package), one forged lane."""
    votes, powers, totals = _ragged_window([3, 2], forged={(1, 0)}, tag=80, lengths=1)
    votes = [[(key(pub), msg, sig) for pub, msg, sig in row] for row in votes]
    return votes, powers, totals


KEY_WRAPPERS = {
    "numpy_row": lambda pub: np.frombuffer(pub, np.uint8),
    "reference_key_object": JEd,  # .bytes() but no __bytes__
}


@pytest.fixture
def reference_unsupervised():
    """The reference's first XLA compile on a loaded CPU can outlast its
    30 s dispatch deadline, which would end in a host fallback: run its
    device route unsupervised here too."""
    from tendermint_tpu.libs import breaker as jbrk

    jbrk.configure_device_guard(dispatch_deadline=0)
    yield
    jbrk.reset_device_guard()


@pytest.mark.parametrize("use_device", [True, False])
@pytest.mark.parametrize("wrapper", sorted(KEY_WRAPPERS))
def test_raw_keys_take_the_reference_route(reference_unsupervised, wrapper, use_device):
    """A lane key that is not a port PubKey counts as a raw ed25519 key, as
    in the reference: numpy rows take the guarded device route when asked
    (the reference's lanes_dispatched and profiler kind), and a key object
    with .bytes() but no __bytes__ verifies on both routes."""
    from tendermint_tpu_torch.libs.profile import get_profiler

    votes, powers, totals = _key_window(KEY_WRAPPERS[wrapper])
    want = jplanner.verify_window(votes, powers, totals, use_device=use_device)
    want_kind = _reference_profiler_kind()
    got = planner.verify_window(votes, powers, totals,
                                verifier=tbatch.TorchBatchVerifier("cpu"),
                                use_device=use_device)
    got_kind = get_profiler().entries()[-1]["kind"]
    _assert_equal(got, want)
    assert got.ok[0, :3].all() and not got.ok[1, 0] and got.ok[1, 1]
    assert (got.lanes_dispatched, got_kind) == (want.lanes_dispatched, want_kind)
    assert got_kind == ("planner" if use_device else "host")
    assert planner.plan_window(votes, powers, totals).all_ed25519()


@pytest.mark.parametrize("reduce", ["device", "host"])
def test_go_edge_window_through_the_device_executor(reduce):
    """ROADMAP's unchecked case: every Go verification edge as one window
    through the device executor (K1 -> K2 -> the tally, plain versions)
    against the reference planner's grid and tallies."""
    votes, powers, totals, fixed = tc.go_edge_window_spec()
    planner.set_reduce_mode(reduce)
    got = planner.device_executor("cpu")(planner.plan_window(votes, powers, totals))
    want = _reference(votes, powers, totals)
    _assert_equal(got, want)
    flat = got.ok.reshape(-1)
    for i, verdict in fixed.items():
        if verdict is not None:
            assert bool(flat[i]) == verdict, i
    assert got.lanes_dispatched == 64 and not got.sigs_ok.all()
