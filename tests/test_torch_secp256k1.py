"""The port's secp256k1 path (tendermint_tpu_torch/ops/secp256k1_cuda.py and
the entry points above it) against the JAX package on the CPU: keys and
hashing, point formulas, the reduced-window ladder against ``ladder_math``,
the G table and the kernel source's constants, ``prep_item``, full-width
verdicts against the XLA kernel and the oracle, the batch verifier,
``verify_generic`` on a mixed batch, and ``verify_commit`` on secp256k1 and
mixed validator sets. Every comparison is exact."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import hashing as jhash
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.crypto import secp256k1 as js
from tendermint_tpu.ops import secp256k1_pallas as jsp
from tendermint_tpu.ops import secp256k1_verify as jsv
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu.types.core import BlockID as JBlockID
from tendermint_tpu.types.core import PartSetHeader as JPSH
from tendermint_tpu.types.core import SignedMsgType as JType
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import hashing as thash
from tendermint_tpu_torch.crypto import keys as tkeys
from tendermint_tpu_torch.crypto import secp256k1 as ts
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import fe_secp256k1 as F
from tendermint_tpu_torch.ops import secp256k1_cuda as sc
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.testutil import secp_signer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One core for the plain versions: the suite runs timing-sensitive node
    tests in parallel workers beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P, N = ts.P, ts.N


def _privs(n, seed):
    rng = np.random.default_rng(seed)
    return [ts.gen_privkey(rng.bytes(32)) for _ in range(n)]


def _jax_int(col) -> int:
    return jsv.limbs_to_int(np.asarray(col))


# ---------------------------------------------------------------------------
# Keys, hashing, the oracle copy and the fixture signer
# ---------------------------------------------------------------------------


def test_hashing_and_keys_equal_jax():
    rng = np.random.default_rng(2)
    for ln in (0, 1, 55, 56, 64, 65, 200):
        data = rng.bytes(ln)
        assert thash.ripemd160(data) == jhash.ripemd160(data)
        assert thash._ripemd160_py(data) == jhash._ripemd160_py(data) == jhash.ripemd160(data)
    for priv in _privs(4, 2):
        tpriv, jpriv = tkeys.PrivKeySecp256k1(priv), jkeys.PrivKeySecp256k1(priv)
        assert tpriv.pub_key().bytes() == jpriv.pub_key().bytes()
        assert tpriv.pub_key().address() == jpriv.pub_key().address()
        assert tpriv.pub_key().type_name == jpriv.pub_key().type_name
        msg = rng.bytes(40)
        sig = tpriv.sign(msg)
        assert sig == jpriv.sign(msg)
        assert ts.verify(tpriv.pub_key().bytes(), sha256(msg), sig)
    with pytest.raises(ValueError):
        tkeys.PubKeySecp256k1(b"\x02" * 32)


def test_fixture_signer_equals_the_oracle():
    rng = np.random.default_rng(4)
    for priv in _privs(6, 4) + [(1).to_bytes(32, "big"), (N - 1).to_bytes(32, "big")]:
        digest = rng.bytes(32)
        assert secp_signer.pubkey_compressed(priv) == js.pubkey_compressed(priv)
        assert secp_signer.sign(priv, digest) == js.sign(priv, digest) == ts.sign(priv, digest)
    assert secp_signer.sign(priv, bytes(32)) == js.sign(priv, bytes(32))


def test_edge_window_verdicts_and_der_equal_jax():
    pubs, digs, sigs, verdicts = tc.secp_edge_window(seed=5)
    assert len(pubs) == 23 and set(verdicts) == set(range(23))
    for i in range(len(pubs)):
        want = js.verify(pubs[i], digs[i], sigs[i])
        assert ts.verify(pubs[i], digs[i], sigs[i]) == want == verdicts[i], i
        assert ts.der_decode_sig(sigs[i]) == js.der_decode_sig(sigs[i])
        assert ts.decompress_pubkey(pubs[i]) == js.decompress_pubkey(pubs[i])


# ---------------------------------------------------------------------------
# Point formulas, the G table, the reduced ladder
# ---------------------------------------------------------------------------


def _rows(*vals):
    return torch.tensor([F.int_to_limbs(v) for v in vals], dtype=torch.int64)


def _affine(pt, i=0):
    X, Y, Z = (F.limbs_to_int(c[i].tolist()) % P for c in pt)
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    return X * zi % P, Y * zi % P


def test_point_ops_vs_jax_pt_add_and_jmul():
    """Complete addition and doubling against the JAX package's row-layout
    pt_add and the oracle's Jacobian _jmul: add, double, the identity on
    either side, and P + (-P)."""
    rng = np.random.default_rng(11)
    ksub = jnp.asarray(jsp._K_SUB[:, None])
    col = lambda v: jnp.asarray(jsv.int_to_limbs(v)[:, None])
    jone, jzero = col(1), col(0)
    one, zero = _rows(1), _rows(0)
    ident = (zero, one, zero)
    for _ in range(4):
        k1, k2 = (int(rng.integers(1, 1 << 62)) for _ in range(2))
        A = js._to_affine(js._jmul(js._G, k1))
        B = js._to_affine(js._jmul(js._G, k2))
        pa, pb = (_rows(A[0]), _rows(A[1]), one), (_rows(B[0]), _rows(B[1]), one)
        ja, jb = (col(A[0]), col(A[1]), jone), (col(B[0]), col(B[1]), jone)
        cases = (
            (sc._pt_add(pa, pb), jsp.pt_add(ja, jb, ksub), k1 + k2),
            (sc._pt_double(pa), jsp.pt_add(ja, ja, ksub), 2 * k1),
            (sc._pt_add(pa, pa), jsp.pt_add(ja, ja, ksub), 2 * k1),
            (sc._pt_add(pa, ident), jsp.pt_add(ja, (jzero, jone, jzero), ksub), k1),
            (sc._pt_add(ident, pa), jsp.pt_add((jzero, jone, jzero), ja, ksub), k1),
        )
        for got, jgot, k in cases:
            want = js._to_affine(js._jmul(js._G, k))
            jX, jY, jZ = (_jax_int(np.asarray(c)[:, 0]) % P for c in jgot)
            zi = pow(jZ, -1, P)
            assert _affine(got) == want == (jX * zi % P, jY * zi % P)
        neg = (pa[0], _rows(P - A[1]), one)
        assert _affine(sc._pt_add(pa, neg)) is None
    assert _affine(sc._pt_double(ident)) is None
    assert _affine(sc._pt_add(ident, ident)) is None


def test_g_table_equals_jax():
    for j in range(16):
        for c in range(3):
            assert F.limbs_to_int(sc._G_TABLE[j, c].tolist()) == \
                _jax_int(jsp._CONSTS[:, 16 * c + j])
    assert sc.NCONSTS == 480


def _c_array(src: str, name: str):
    body = re.search(name + r"\[\w+\]\s*=\s*\{(.*?)\};", src, re.S).group(1)
    return [int(v, 16) for v in re.findall(r"0x[0-9a-fA-F]+", body)]


def _c_const(src: str, name: str) -> int:
    return int(re.search(name + r"\s*=\s*(0x[0-9a-fA-F]+|\d+)", src).group(1), 0)


def test_kernel_source_constants():
    # the kernel's source with the field header it includes
    src = _build._source_bytes(Path(sc.__file__).parent / "csrc" / "secp256k1_ladder.cu",
                               set()).decode()
    assert tuple(_c_array(src, "KSUB")) == F.K_SUB
    for name in ("TOP_LO", "TOP_HI", "FOLD_LO", "FOLD_HI", "FOLD19_LO",
                 "FOLD19_HI", "B3"):
        assert _c_const(src, name) == getattr(F, name), name


def _py_loop(lo, hi, body, init):
    acc = init
    for t in range(lo, hi):
        acc = body(t, acc)
    return acc


NWIN_SMALL = 3


def test_reduced_window_ladder_vs_jax_ladder_math():
    """Same keys and digits through the port's ladder_point_ref and JAX's
    ladder_math with three windows (12-bit scalars), run eagerly; lane 0
    has u1 = 0, lane 1 has u2 = 0 and lane 2 both. Compared projectively
    (X Z' = X' Z, Y Z' = Y' Z) and against the oracle."""
    n = 8
    rng = np.random.default_rng(78)
    pubs = [secp_signer.pubkey_compressed(p) for p in _privs(n, 78)]
    jq = [jsv._decompress_cached(p) for p in pubs]
    jqx = np.stack([q[0] for q in jq])
    jqy = np.stack([q[1] for q in jq])
    u1 = [int(rng.integers(1, 1 << 12)) for _ in range(n)]
    u2 = [int(rng.integers(1, 1 << 12)) for _ in range(n)]
    u1[0] = u1[2] = 0
    u2[1] = u2[2] = 0
    d1 = np.stack([jsp._digits_msb(u)[-NWIN_SMALL:] for u in u1], axis=1)
    d2 = np.stack([jsp._digits_msb(u)[-NWIN_SMALL:] for u in u2], axis=1)
    dj1, dj2 = jnp.asarray(d1), jnp.asarray(d2)
    JX, JY, JZ = (np.asarray(v) for v in jsp.ladder_math(
        jnp.asarray(jsp._CONSTS), jnp.asarray(jqx.T.copy()), jnp.asarray(jqy.T.copy()),
        lambda t: dj1[t: t + 1, :], lambda t: dj2[t: t + 1, :],
        nwin=NWIN_SMALL, loop=_py_loop))

    qx, qy = sc.points_from_jax(jqx, jqy)
    put = lambda a: sc._put(np.ascontiguousarray(a), "cpu")
    X, Y, Z = sc.ladder_point_ref(put(sc._CONSTS), put(qx.T), put(qy.T), put(d1),
                                  put(d2), nwin=NWIN_SMALL)
    for i in range(n):
        gx, gy, gz = (F.limbs_to_int(c[i].tolist()) % P for c in (X, Y, Z))
        jx, jy, jz = (_jax_int(c[:, i]) % P for c in (JX, JY, JZ))
        assert (gz == 0) == (jz == 0)
        assert gx * jz % P == jx * gz % P
        assert gy * jz % P == jy * gz % P
        Q = js.decompress_pubkey(pubs[i])
        want = js._to_affine(js._jadd(js._jmul(js._G, u1[i]),
                                      js._jmul((Q[0], Q[1], 1), u2[i])))
        assert _affine((X, Y, Z), i) == want
    assert _affine((X, Y, Z), 2) is None


def test_points_from_jax_equals_decompression():
    pubs = [secp_signer.pubkey_compressed(p) for p in _privs(5, 9)]
    jq = [jsv._decompress_cached(p) for p in pubs]
    qx, qy = sc.points_from_jax(np.stack([q[0] for q in jq]), np.stack([q[1] for q in jq]))
    for i, p in enumerate(pubs):
        tx, ty = sc._decompress_cached(p)
        assert np.array_equal(qx[i], tx) and np.array_equal(qy[i], ty)
    assert sc._decompress_cached(b"\x02" + bytes(32)) is None


# ---------------------------------------------------------------------------
# The host prologue
# ---------------------------------------------------------------------------


def _same_item(t, j) -> bool:
    if t[0] != j[0]:
        return False
    if t[0] == "forced":
        return t[1] == j[1]
    (tqx, tqy), (jqx, jqy) = t[1], j[1]
    return (F.limbs_to_int(tqx.tolist()) == _jax_int(jqx)
            and F.limbs_to_int(tqy.tolist()) == _jax_int(jqy) and t[2:] == j[2:])


def test_prep_item_equals_jax():
    pubs, digs, sigs, _ = tc.secp_edge_window(seed=6)
    kinds = set()
    for p, d, g in zip(pubs, digs, sigs):
        t, j = sc.prep_item(p, d, g), jsv.prep_item(p, d, g)
        assert _same_item(t, j)
        kinds.add(t[0] if t[0] == "kernel" else t[:2])
    assert kinds == {"kernel", ("forced", 0), ("forced", 1)}
    rng = np.random.default_rng(7)
    for _ in range(500):  # seeded byte mutations of valid DER signatures
        i = int(rng.integers(0, 10))
        sig = bytearray(sigs[i])
        sig[int(rng.integers(0, len(sig)))] ^= int(rng.integers(1, 256))
        assert _same_item(sc.prep_item(pubs[i], digs[i], bytes(sig)),
                          jsv.prep_item(pubs[i], digs[i], bytes(sig)))


def test_digits_and_limbs():
    rng = np.random.default_rng(8)
    xs = [int.from_bytes(rng.bytes(32), "big") for _ in range(6)] + [0, 2**256 - 1]
    for x, limbs, digits in zip(xs, sc._limbs_batch(xs), sc._digits_batch(xs)):
        assert F.limbs_to_int(limbs.tolist()) == x
        assert np.array_equal(digits, jsp._digits_msb(x))


# ---------------------------------------------------------------------------
# Full-width verdicts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def window():
    """The edge window's verdicts from the oracle and from the XLA kernel
    (one 32-row bucket: one compile for the module)."""
    pubs, digs, sigs, verdicts = tc.secp_edge_window(seed=1)
    oracle = [js.verify(p, d, g) for p, d, g in zip(pubs, digs, sigs)]
    xla = jsv.verify_batch(pubs, digs, sigs)
    return pubs, digs, sigs, verdicts, oracle, xla


def test_full_width_verdicts_vs_xla_and_oracle(window):
    pubs, digs, sigs, verdicts, oracle, xla = window
    assert oracle == [verdicts[i] for i in range(len(pubs))]
    got = sc.verify_batch(pubs, digs, sigs, device="cpu")
    assert got.tolist() == oracle == xla.tolist()


def test_r_plus_n_branch_of_the_plain_ladder(window):
    """x(R) = r + n is reached by an honest signature with probability
    about 2^-128, so the branch is tested at the ladder's level: rnl holds
    x(R), rl another value, and the row is accepted iff rnok is set."""
    pubs, digs, sigs = (w[:2] for w in window[:3])
    host, forced = sc.pack_rows(pubs, digs, sigs, 8)
    assert (forced[:2] == -1).all()
    qx, qy, d1, d2, rl, rnl, rnok = (h.copy() for h in host)
    rnl[:2] = rl[:2]
    rl[:2] = sc._limbs_batch([F.limbs_to_int(rl[i].tolist()) + 1 for i in range(2)])
    rnok[0], rnok[1] = 1, 0
    ok, X, Z = sc.ladder(*sc.upload((qx, qy, d1, d2, rl, rnl, rnok), torch.device("cpu")))
    assert ok[:2].tolist() == [1, 0]
    rnl[1] = rl[1]  # neither representative matches
    rnok[1] = 1
    ok2, _, _ = sc.ladder(*sc.upload((qx, qy, d1, d2, rl, rnl, rnok), torch.device("cpu")))
    assert ok2[:2].tolist() == [1, 0]


# ---------------------------------------------------------------------------
# Through the entry points
# ---------------------------------------------------------------------------


def _message_items():
    rng = np.random.default_rng(12)
    privs = _privs(10, 12)
    items = []
    for i, priv in enumerate(privs):
        msg = rng.bytes(40 + i)
        sig = secp_signer.sign(priv, sha256(msg))
        pub = secp_signer.pubkey_compressed(priv)
        if i == 2:
            sig = secp_signer.sign(priv, sha256(b"evil"))
        elif i == 4:
            pub = secp_signer.pubkey_compressed(privs[0])
        elif i == 6:
            r, s = ts.der_decode_sig(sig)
            sig = ts.der_encode_sig(r, N - s)
        elif i == 8:
            sig = sig[:-1]
        items.append((pub, msg, sig))
    return items


def test_batch_verifier_equals_jax(window):
    items = _message_items()
    v = tbatch.TorchBatchVerifier(device="cpu")
    got = v.verify_secp256k1([tbatch.SigItem(*it) for it in items])
    want = jbatch.TPUBatchVerifier(backend="xla").verify_secp256k1(
        [jbatch.SigItem(*it) for it in items])
    assert got.tolist() == list(want)
    assert got.tolist() == [i not in (2, 4, 6, 8) for i in range(10)]
    st = v.stats["secp256k1"]
    assert (st.dispatches, st.signatures, st.rejects) == (1, 10, 4)
    assert v.stats["ed25519"].dispatches == 0
    assert v.verify_secp256k1([]).shape == (0,)


def test_verify_generic_mixed_equals_jax():
    rng = np.random.default_rng(13)
    tpub, jpub, msgs, sigs = [], [], [], []
    for i in range(3):
        seed = rng.bytes(32)
        epriv = jed.gen_privkey(seed)
        spriv = ts.gen_privkey(rng.bytes(32))
        for kind, priv in (("ed", epriv), ("secp", spriv)):
            msg = rng.bytes(30 + i)
            sig = tc.sign(priv, msg)
            if i == 1:
                sig = tc.sign(priv, msg + b"!")
            pk = tc.pub_key(priv)
            tpub.append(pk)
            jpub.append((jkeys.PubKeyEd25519 if kind == "ed" else jkeys.PubKeySecp256k1)(pk.bytes()))
            msgs.append(msg)
            sigs.append(sig)
    tpub.append(tpub[0])  # an ed25519 key with a 63-byte signature
    jpub.append(jpub[0])
    msgs.append(msgs[0])
    sigs.append(sigs[0][:63])
    got = tbatch.verify_generic(tpub, msgs, sigs, verifier=tbatch.TorchBatchVerifier(device="cpu"))
    want = jbatch.verify_generic(jpub, msgs, sigs, verifier=jbatch.HostBatchVerifier())
    assert got.tolist() == list(want) == [True, True, False, False, True, True, False]


def _to_jax(sc_, commit):
    """The same validator set and commit as JAX package objects."""
    jkey = {tkeys.PubKeyEd25519: jkeys.PubKeyEd25519,
            tkeys.PubKeySecp256k1: jkeys.PubKeySecp256k1}
    vals = [jvs.Validator(jkey[type(v.pub_key)](v.pub_key.bytes()), v.voting_power)
            for v in sc_.valset.validators]
    conv = lambda b: JBlockID(b.hash, JPSH(b.parts_header.total, b.parts_header.hash))
    pcs = [None if pc is None else JVote(
        JType(int(pc.vote_type)), pc.height, pc.round, pc.timestamp_ns,
        conv(pc.block_id), pc.validator_address, pc.validator_index, pc.signature)
        for pc in commit.precommits]
    return jvs.ValidatorSet(vals), conv(sc_.block_id), JCommit(conv(commit.block_id), pcs)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under comparison, error or not
        return type(e).__name__, str(e)
    return "ok", ""


NV = 8


@pytest.fixture(scope="module", params=["secp256k1", "mixed"])
def signed(request):
    return tc.build_commit(NV, seed=21, key_type=request.param)


def _flip_s(sc_, key_cls):
    i = next(k for k, v in enumerate(sc_.valset.validators)
             if isinstance(v.pub_key, key_cls))
    sig = sc_.commit.precommits[i].signature
    return tc.flip_signature_bit(sc_.commit, i, bit=8 * (len(sig) - 1))


CASES = {
    "valid": (lambda s: s.commit, "ok", ""),
    "tampered_secp256k1": (lambda s: _flip_s(s, tkeys.PubKeySecp256k1),
                           "CommitError", "invalid signature in commit"),
    "insufficient_power": (lambda s: tc.drop_precommits(s.commit, (2 * NV) // 3),
                           "CommitError", "insufficient voting power"),
    "stray_vote": (lambda s: tc.stray_vote(s, 3), "ok", ""),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_commit_matches_jax(signed, case):
    make, kind, prefix = CASES[case]
    commit = make(signed)
    port = _outcome(lambda: signed.valset.verify_commit(
        signed.chain_id, signed.block_id, signed.height, commit,
        verifier=tbatch.TorchBatchVerifier(device="cpu")))
    jvalset, jbid, jcommit = _to_jax(signed, commit)
    ref = _outcome(lambda: jvalset.verify_commit(
        signed.chain_id, jbid, signed.height, jcommit, verifier=jbatch.HostBatchVerifier()))
    assert port == ref
    assert port[0] == kind and port[1].startswith(prefix)


def test_mixed_commit_holds_both_key_types_and_rejects_a_bad_ed25519_row():
    s = tc.build_commit(NV, seed=21, key_type="mixed")
    types = {type(v.pub_key) for v in s.valset.validators}
    assert types == {tkeys.PubKeyEd25519, tkeys.PubKeySecp256k1}
    commit = _flip_s(s, tkeys.PubKeyEd25519)
    v = tbatch.TorchBatchVerifier(device="cpu")
    port = _outcome(lambda: s.valset.verify_commit(s.chain_id, s.block_id, s.height,
                                                   commit, verifier=v))
    assert port == ("CommitError", "invalid signature in commit")
    assert v.stats["ed25519"].dispatches == v.stats["secp256k1"].dispatches == 1


# ---------------------------------------------------------------------------
# The wrapper and the operation count
# ---------------------------------------------------------------------------


def test_plain_path_launches_no_kernel_and_meta_is_refused():
    sc.reset_launches()
    pubs, digs, sigs, _ = tc.secp_edge_window(seed=3)
    host, _ = sc.pack_rows(pubs[13:19], digs[13:19], sigs[13:19], 8)  # forced rows
    qx, qy, d1, d2, rl, rnl, rnok = host
    d1, d2 = d1[:, -1:], d2[:, -1:]
    ok, X, Z = sc.ladder(*sc.upload((qx, qy, d1, d2, rl, rnl, rnok), torch.device("cpu")))
    assert ok.tolist() == [0] * 8 and X.shape == Z.shape == (10, 8)
    assert sc.launches == {"secp256k1_ladder": 0}
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sc.ladder(meta(sc.NCONSTS), meta(10, 8), meta(10, 8), meta(64, 8), meta(64, 8),
                  meta(10, 8), meta(10, 8), meta(1, 8))


def test_fe_op_count():
    """ladder_fe_ops (the bound's operation count) equals the
    multiplications, squarings and small multiplications the plain ladder
    performs."""
    calls = {"mul": 0, "sq": 0, "mul_small": 0}
    real = {k: getattr(F, k) for k in calls}

    def counting(kind):
        def op(*args):
            calls[kind] += 1
            return real[kind](*args) if kind != "sq" else real["mul"](*args, *args)
        return op

    pubs, digs, sigs, _ = tc.secp_edge_window(seed=3)
    host, _ = sc.pack_rows(pubs[:1], digs[:1], sigs[:1], 1)
    qx, qy, d1, d2, rl, rnl, rnok = host
    ins = sc.upload((qx, qy, d1[:, :1], d2[:, :1], rl, rnl, rnok), torch.device("cpu"))
    try:
        for k in calls:
            setattr(F, k, counting(k))
        sc.ladder_ref(*ins, nwin=1)
    finally:
        for k, fn in real.items():
            setattr(F, k, fn)
    assert (calls["mul"], calls["sq"], calls["mul_small"]) == sc.ladder_fe_ops(1)
    assert sc.ladder_fe_ops() == (3254, 512, 542)
