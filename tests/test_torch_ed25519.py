"""The port's ed25519 path (tendermint_tpu_torch/ops/ed25519_cuda.py) against
the JAX package: the reduced-window ladder against ``ladder_math``, the host
packing against its JAX counterparts, the key material and B table across
the two limb layouts, and full-width verdicts of the plain path against
``crypto.ed25519.verify``. All comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.ops import ed25519_pallas as jep
from tendermint_tpu.ops import ed25519_verify as jev
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import fe
from tendermint_tpu_torch.testutil import commit as tc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One core for the plain versions: the suite runs timing-sensitive node
    tests in parallel workers beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P = ted.P
NWIN_SMALL = 2


def _msb_digits(x: int, nwin: int) -> np.ndarray:
    return np.array([(x >> (4 * (nwin - 1 - t))) & 0xF for t in range(nwin)], np.uint32)


def _py_loop(lo, hi, body, init):
    acc = init
    for t in range(lo, hi):
        acc = body(t, acc)
    return acc


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    privs = [ted.gen_privkey(rng.bytes(32)) for _ in range(n)]
    return privs, np.frombuffer(b"".join(p[32:] for p in privs), np.uint8).reshape(n, 32)


def _jax_int(col) -> int:
    return sum(int(v) << (13 * i) for i, v in enumerate(np.asarray(col)))


def test_keygen_and_sign_match_the_jax_package():
    rng = np.random.default_rng(3)
    for _ in range(4):
        seed, msg = rng.bytes(32), rng.bytes(int(rng.integers(0, 200)))
        priv = ted.gen_privkey(seed)
        assert priv == jed.gen_privkey(seed)
        assert ted.sign(priv, msg) == jed.sign(priv, msg)


def test_reduced_window_ladder_vs_jax_ladder_math():
    """Same keys and digits through the port's ladder_point_ref and JAX's
    ladder_math with two windows (8-bit scalars); lane 0 has s = 0 and
    lane 1 has h = 0. Compared as affine integers."""
    n = 8
    rng = np.random.default_rng(78)
    _, pubs = _keys(n, 78)
    digs = np.zeros((NWIN_SMALL, n), np.uint32)
    digh = np.zeros((NWIN_SMALL, n), np.uint32)
    for i in range(n):
        s_small = 0 if i == 0 else int(rng.integers(1, 256))
        h_small = 0 if i == 1 else int(rng.integers(1, 256))
        digs[:, i] = _msb_digits(s_small, NWIN_SMALL)
        digh[:, i] = _msb_digits(h_small, NWIN_SMALL)

    jneg, jay, jvalid = jep._decompress_valset(pubs)
    assert jvalid.all()
    dj, hj = jnp.asarray(digs), jnp.asarray(digh)
    JX, JY, JZ, _ = (np.asarray(v) for v in jep.ladder_math(
        jnp.asarray(jep._CONSTS), jnp.asarray(jneg.T.copy()), jnp.asarray(jay.T.copy()),
        lambda t: dj[t: t + 1, :], lambda t: hj[t: t + 1, :],
        nwin=NWIN_SMALL, loop=_py_loop))

    neg, ay, valid = ec._decompress_valset(pubs)
    X, Y, Z, T = ec.ladder_point_ref(
        ec._put(ec._CONSTS, "cpu"), ec._put(neg.T, "cpu"), ec._put(ay.T, "cpu"),
        ec._put(digs, "cpu"), ec._put(digh, "cpu"), nwin=NWIN_SMALL)
    for i in range(n):
        gx, gy, gz, gt = (fe.limbs_to_int(c[i].tolist()) for c in (X, Y, Z, T))
        jx, jy, jz = _jax_int(JX[:, i]), _jax_int(JY[:, i]), _jax_int(JZ[:, i])
        zi, jzi = pow(gz, P - 2, P), pow(jz, P - 2, P)
        assert gx * zi % P == jx * jzi % P
        assert gy * zi % P == jy * jzi % P
        assert gt * gz % P == gx * gy % P  # extended invariant T = XY/Z


def test_decompress_valset_and_valset_from_jax():
    _, pubs = _keys(6, 9)
    pubs = pubs.copy()
    pubs[3] = np.frombuffer(tc.IDENTITY_KEY, np.uint8)
    pubs[4] = np.frombuffer((P + 1).to_bytes(32, "little"), np.uint8)  # y >= p
    pubs[5] = np.frombuffer(tc._undecompressable_key(), np.uint8)
    neg, ay, valid = ec._decompress_valset(pubs)
    cneg, cay, cvalid = ec.valset_from_jax(*jep._decompress_valset(pubs))
    assert valid.tolist() == [True] * 5 + [False]
    assert np.array_equal(neg, cneg) and np.array_equal(ay, cay)
    assert np.array_equal(valid, cvalid)


def test_b_table_equals_jax():
    for j in range(16):
        for c in range(3):
            assert fe.limbs_to_int(ec._B_NIELS[j, c].tolist()) == \
                _jax_int(jep._B_NIELS[j, c])
    d2 = ec._CONSTS[16 * 3 * fe.NLIMB:]
    assert fe.limbs_to_int(d2.tolist()) == _jax_int(jep._CONSTS[:, 48])


def test_raw_r_limbs_equal_jax():
    rng = np.random.default_rng(4)
    r32 = rng.integers(0, 256, (9, 32), dtype=np.uint8)
    r32[0] = 0xFF
    got = ec._bytes_to_raw_limbs(r32)
    want = jev._bytes_to_raw_limbs(r32)
    for i in range(r32.shape[0]):
        assert fe.limbs_to_int(got[i].tolist()) == _jax_int(want[i])


@pytest.mark.parametrize("lanes", [8, 128])
def test_bucket_equals_jax(lanes):
    for n in (1, 7, 8, 9, 100, 128, 129, 4096, 4097, 10_000, 10_240, 20_000):
        assert ec._bucket(n, lanes) == jep._bucket(n, lanes)


@pytest.mark.parametrize("case", ["timestamps", "identical", "all_vary", "len111", "len112"])
def test_pack_variable_words_equals_jax(case):
    rng = np.random.default_rng(12)
    n = 11
    ln = {"len111": 111, "len112": 112}.get(case, 104)
    pubs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    m = np.tile(rng.integers(0, 256, ln, dtype=np.uint8), (n, 1))
    if case in ("timestamps", "len111", "len112"):
        m[:, 17:25] = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    elif case == "all_vary":
        m = rng.integers(0, 256, (n, ln), dtype=np.uint8)
    msgs = [m[i].tobytes() for i in range(n)]
    b = ec._bucket(n, 8)
    got = ec.pack_variable_words(pubs, msgs, sigs, ln, b)
    want = jep.pack_variable_words(pubs, msgs, sigs, ln, b)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    if case == "identical":
        assert got[1].tolist() == [16]  # k = 1: the scatter still has a row


def _np(pubs, sigs):
    n = len(pubs)
    return (np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32),
            np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64))


def test_go_edge_window_verdicts_vs_jax_oracle():
    pubs, msgs, sigs, fixed = tc.go_edge_window(seed=0)
    want = [jed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    for i, v in fixed.items():
        if v is not None:
            assert want[i] == v, i
    pa, sa = _np(pubs, sigs)
    got = ec.verify_batch(pa, msgs, sa, device="cpu")
    assert got.tolist() == want
    assert want[12] and want[16] and want[17]  # s + L, identity keys accepted


@pytest.mark.parametrize("seed", range(4))
def test_single_verify_equals_the_reference_and_go(seed):
    """``crypto/ed25519.verify`` (a key's ``verify_bytes``, the host
    verifier) is the reference's: OpenSSL in the canonical zone,
    ``_verify_pure`` elsewhere; on the Go-edge window (s + L, non-canonical
    keys and R, identity and order-8 keys, undecompressable keys) each
    verdict equals the reference's and Go's."""
    from tendermint_tpu.crypto.keys import PubKeyEd25519 as RPub
    from tendermint_tpu_torch.crypto.batch import HostBatchVerifier
    from tendermint_tpu_torch.crypto.keys import PubKeyEd25519

    pubs, msgs, sigs, _ = tc.go_edge_window(seed=seed)
    rows = list(zip(pubs, msgs, sigs))
    want = [jed.verify(p, m, s) for p, m, s in rows]
    assert [ted.verify(p, m, s) for p, m, s in rows] == want
    assert [ted._verify_pure(p, m, s) for p, m, s in rows] == want
    assert [PubKeyEd25519(p).verify_bytes(m, s) for p, m, s in rows] == [
        RPub(p).verify_bytes(m, s) for p, m, s in rows] == want
    assert HostBatchVerifier().verify_ed25519_raw(pubs, msgs, sigs).tolist() == want


def test_single_verify_takes_openssl_in_the_canonical_zone(monkeypatch):
    if not ted._HAVE_CRYPTOGRAPHY:
        pytest.skip("the host has no cryptography package: verify is _verify_pure")
    privs, _ = _keys(1, 9)
    sig = ted.sign(privs[0], b"m")
    assert ted._in_canonical_zone(privs[0][32:], sig)

    def pure(*a):
        raise AssertionError("the canonical zone took the Python oracle")

    monkeypatch.setattr(ted, "_verify_pure", pure)
    assert ted.verify(privs[0][32:], b"m", sig)
    assert not ted.verify(privs[0][32:], b"n", sig)


def test_random_mixed_length_batch_vs_jax_oracle():
    rng = np.random.default_rng(21)
    privs, _ = _keys(12, 21)
    lengths = (0, 111, 112)
    pubs, msgs, sigs = [], [], []
    for i, priv in enumerate(privs):
        msg = rng.bytes(lengths[i % 3])
        sig = bytearray(ted.sign(priv, msg))
        if i % 4 == 1:
            sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(bytes(sig))
    pa, sa = _np(pubs, sigs)
    got = ec.verify_batch(pa, msgs, sa, device="cpu")
    assert got.tolist() == [jed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]


def test_plain_path_launches_no_kernel():
    ec.reset_launches()
    _, pubs = _keys(2, 5)
    ec.verify_batch(pubs, [b"a", b"b"], np.zeros((2, 64), np.uint8), device="cpu")
    assert ec.launches == {"ed25519_prologue": 0, "ed25519_ladder": 0}


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """A tensor off the CPU never reaches the plain version: meta tensors
    (no data, no CUDA) are refused before any launch."""
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ec.prologue(meta(32), meta(1), meta(8, 1), meta(8, 8), meta(8, 16))
    with pytest.raises(ValueError, match="several devices"):
        ec.ladder(meta(ec.NCONSTS), *(torch.zeros(s, dtype=torch.int32) for s in (
            (10, 8), (10, 8), (64, 8), (64, 8), (10, 8), (1, 8))))


def test_fe_mul_count():
    """ladder_fe_ops (the bound's operation count) equals the
    multiplications and squarings the plain ladder performs."""
    calls = {"mul": 0, "sq": 0}
    real_mul = fe.mul

    def counting(kind):
        def op(a, b):
            calls[kind] += 1
            return real_mul(a, b)
        return op

    _, pubs = _keys(1, 6)
    neg, ay, _ = ec._decompress_valset(pubs)
    z = ec._put(np.zeros((NWIN_SMALL, 1), np.uint32), "cpu")
    args = (ec._put(ec._CONSTS, "cpu"), ec._put(neg.T, "cpu"), ec._put(ay.T, "cpu"),
            z, z, ec._put(np.zeros((10, 1), np.uint32), "cpu"),
            ec._put(np.zeros((1, 1), np.uint32), "cpu"))
    fe_mul, fe_sq = fe.mul, fe.sq
    try:
        fe.mul = counting("mul")
        fe.sq = lambda a, sq=counting("sq"): sq(a, a)
        ec.ladder_ref(*args, nwin=NWIN_SMALL)
    finally:
        fe.mul, fe.sq = fe_mul, fe_sq
    assert (calls["mul"], calls["sq"]) == ec.ladder_fe_ops(NWIN_SMALL)
    assert sum(ec.ladder_fe_ops()) == 3411
