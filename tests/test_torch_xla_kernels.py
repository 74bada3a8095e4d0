"""K5 and K6, the port's counterparts of the JAX package's XLA kernels
(``ops/ed25519_verify._verify_kernel``, ``ops/secp256k1_verify._verify_kernel``),
against the reference on the CPU.

The plain versions (``ed25519_verify.verify_ref``, ``secp256k1_verify.verify_ref``)
take the same seeded packed rows as the reference's jitted kernels, sharded
over the suite's 8 forced host devices, and must give the same verdict on
every row; the host prologues must pack the same values. Restated on both
packages: ``tests/test_ops_ed25519.py::TestSharded`` and
``tests/test_ops_secp256k1.py::TestKernelParity::test_mesh_sharded``, with
the port on ``DeviceMesh(["cpu"] * 8)``, and ``TorchBatchVerifier(mesh=)``
against ``TPUBatchVerifier(mesh=, backend="xla")``. Each reference kernel
compiles once for the module (the sharded K5 at 64 rows, K6 at 32: every
reference call here lands in those buckets). On the card K5 and K6 run
K2's and K3's windowed two-lane ladders with their digits taken from the
scalars' bit words: the digits mirrored in Python (``window_digits``) must
be K1's and ``secp256k1_cuda._digits_batch``'s, and K2's and K3's windowed
plain versions (``ladder_ref``) fed K5's and K6's inputs must give the
verdicts of ``verify_ref`` and of the reference's kernel. No tolerance:
verdicts are exact."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import secp256k1 as js
from tendermint_tpu.ops import ed25519_verify as jk5
from tendermint_tpu.ops import secp256k1_verify as jk6
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import secp256k1 as ts
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import ed25519_verify as k5
from tendermint_tpu_torch.ops import fe
from tendermint_tpu_torch.ops import fe_secp256k1 as F
from tendermint_tpu_torch.ops import secp256k1_cuda as sc
from tendermint_tpu_torch.ops import secp256k1_verify as k6
from tendermint_tpu_torch.parallel.mesh import DeviceMesh
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.testutil import secp_signer

K5_ROWS, K6_ROWS = 64, 32  # the reference's buckets on an 8-device mesh
CPU = torch.device("cpu")
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on Hopper


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh8():
    devs = np.array(jax.devices("cpu"))
    if devs.size < 8:
        pytest.skip("needs the 8 forced host devices (tests/conftest.py)")
    return Mesh(devs[:8], ("batch",))


@pytest.fixture(scope="module")
def port_mesh():
    return DeviceMesh(["cpu"] * 8, (8,), ("batch",))


def window_digits(words: torch.Tensor, nbits: int = k5.NBITS) -> torch.Tensor:
    """K5's and K6's digits, as the kernels take them from (8, b)
    little-endian bit words: (64, b) MSB-first 4-bit windows, window t the
    field at bit 4 (63 - t), the top one cut to the bits below 2^nbits.
    int32."""
    w = ec._u32(words)
    rows = []
    for t in range(ec.NWIN):
        u = ec.NWIN - 1 - t
        mask = (1 << min(4, nbits - 4 * u)) - 1
        rows.append((w[u // 8] >> (4 * (u % 8))) & mask)
    return torch.stack(rows).to(torch.int32)


def _ref_call(fn, mesh, arrays):
    data = NamedSharding(mesh, PS(mesh.axis_names[0]))
    return np.asarray(fn(*[jax.device_put(np.asarray(a), data) for a in arrays]))


def _pad(a, b):
    a = np.asarray(a)
    return np.concatenate([a, np.zeros((b - a.shape[0],) + a.shape[1:], a.dtype)])


def _int13(limbs) -> int:
    return sum(int(v) << (13 * i) for i, v in enumerate(np.asarray(limbs)))


def _to_port(rows13, field) -> np.ndarray:
    """(n, 20) radix-2^13 limbs -> (n, 10) limbs of the port's ``field``."""
    return np.asarray([field.int_to_limbs(_int13(r)) for r in rows13], np.uint32).reshape(-1, 10)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def _ed_rows(n, seed):
    """The Go edge window's 20 rows, then seeded signatures of varied
    lengths, every ninth with a flipped bit: (pubs, msgs, sigs) arrays."""
    pubs, msgs, sigs, _ = tc.go_edge_window(seed=seed)
    rng = np.random.default_rng(100 + seed)
    while len(pubs) < n:
        priv = ted.gen_privkey(rng.bytes(32))
        msg = rng.bytes(int(rng.integers(0, 130)))
        sig = bytearray(ted.sign(priv, msg))
        if len(pubs) % 9 == 0:
            sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(bytes(sig))
    return (np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32).copy(), msgs,
            np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64).copy())


@pytest.fixture(scope="module")
def ref_k5(mesh8):
    fn = jk5._compiled_kernel(K5_ROWS, mesh8, "vpu", "lazy")
    return lambda arrays: _ref_call(fn, mesh8, [_pad(a, K5_ROWS) for a in arrays])


def test_k5_prologue_packs_the_reference_values():
    pubs, msgs, sigs = _ed_rows(K5_ROWS, seed=0)
    neg_ax, ay, sw, hw, rl, rs, valid = k5.host_prologue(pubs, msgs, sigs)
    jneg, jay, jsw, jhw, jrl, jrs, jvalid = jk5.host_prologue(pubs, msgs, sigs)
    assert np.array_equal(valid, jvalid) and not valid.all()
    assert np.array_equal(sw, jsw) and np.array_equal(hw, jhw) and np.array_equal(rs, jrs)
    for got, want in ((neg_ax, jneg), (ay, jay), (rl, jrl)):
        assert np.array_equal(got, _to_port(want, fe))


_K5_CASES: dict = {}


def _k5_case(ref_k5, seed):
    """The reference's packed rows (its host prologue) of ``_ed_rows``,
    their verdicts through its jitted, sharded ``_verify_kernel``, and the
    rows converted to the port's limbs as K5's inputs on the CPU; once a
    seed for the module."""
    if seed not in _K5_CASES:
        pubs, msgs, sigs = _ed_rows(K5_ROWS, seed=seed)
        jneg, jay, jsw, jhw, jrl, jrs, valid = jk5.host_prologue(pubs, msgs, sigs)
        want = ref_k5((jneg, jay, jsw, jhw, jrl, jrs))
        host = (_to_port(jneg, fe), _to_port(jay, fe), jsw, jhw, _to_port(jrl, fe), jrs)
        _K5_CASES[seed] = (pubs, msgs, sigs, valid, want, k5.upload(host, CPU))
    return _K5_CASES[seed]


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_plain_version_equals_the_reference_kernel(ref_k5, seed):
    """The reference's packed rows (its host prologue) through its jitted,
    sharded ``_verify_kernel`` and, converted to the port's limbs, through
    ``verify_rows`` on the CPU: the same raw verdict on every row, the
    Go edge rows among them."""
    pubs, msgs, sigs, valid, want, ins = _k5_case(ref_k5, seed)
    got = k5.verify_rows(*ins).numpy() != 0
    assert got.tolist() == want.tolist()
    oracle = [jed.verify(pubs[i].tobytes(), bytes(msgs[i]), sigs[i].tobytes())
              for i in range(K5_ROWS)]
    assert (got & valid).tolist() == oracle
    assert 0 < sum(oracle) < K5_ROWS


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_windowed_plain_version_gives_the_reference_verdicts(ref_k5, seed):
    """The schedule K5 runs on the card: K2's windowed plain version
    (``ed25519_cuda.ladder_ref``) on K5's inputs, its digits taken from the
    bit words as the kernel takes them, gives ``verify_ref``'s verdict and
    the reference kernel's on every row, the Go edge rows among them."""
    _, _, _, _, want, ins = _k5_case(ref_k5, seed)
    negax, ay, sw, hw, rlimb, rsign = ins
    windowed, _ = ec.ladder_ref(ec._consts_on(CPU), negax, ay, window_digits(sw),
                                window_digits(hw), rlimb, rsign)
    assert (windowed.numpy() != 0).tolist() == want.tolist()
    assert torch.equal(windowed, k5.verify_ref(*ins))
    assert 0 < int(windowed.sum()) < K5_ROWS


def test_k5_window_digits_are_k1s():
    """The digits K5 takes from s's and h's bit words are the ones K1
    computes for K2 from the signature and SHA-512(R || A || M) mod L, on
    every row; and a scalar with bit 252 set keeps it in the top window."""
    pubs, msgs, sigs = _mk(24, msg_len=70)
    neg_ax, ay, sw, hw, _, _, valid = k5.host_prologue(pubs, msgs, sigs)
    assert valid.all()
    inputs, b = ec.packed_inputs(pubs, msgs, sigs, neg_ax, ay, valid, 70, CPU)
    _, _, pubw, sigw, tmpl, vidx, vwords = inputs[1:]
    digs, digh, _, _ = ec.prologue(tmpl, vidx, vwords, pubw, sigw)
    for words, want in ((sw, digs), (hw, digh)):
        got = window_digits(ec._put(np.ascontiguousarray(words.T), CPU))
        assert torch.equal(got, want[:, :24])
    top = ec._put(np.asarray([[0] * 7 + [0xF0000000]], np.uint32).T, CPU)
    assert window_digits(top)[0].tolist() == [1]
    assert window_digits(top, 256)[0].tolist() == [15]


def test_k6_window_digits_are_k3s():
    """The digits K6 takes from u1's and u2's bit words are
    ``secp256k1_cuda._digits_batch``'s, K3's, for seeded and edge scalars."""
    rng = np.random.default_rng(29)
    xs = [int.from_bytes(rng.bytes(32), "big") % ts.N for _ in range(40)]
    xs += [1, 2, 15, 16, ts.N - 1, (1 << 255) + 3, (1 << 252) - 1, 0xF << 252]
    got = window_digits(ec._put(np.ascontiguousarray(k6._scalar_words(xs).T), CPU), 256)
    assert torch.equal(got, ec._put(np.ascontiguousarray(sc._digits_batch(xs).T), CPU))


@pytest.mark.parametrize("b", [1, 17, 2_560, 10_240])
def test_k5_k6_geometry(b):
    """K5's and K6's launch geometry is K2's and K3's: two lanes a row, 16
    rows a one-warp block, every row covered by one block and no block
    empty, the shared memory inside the card's limit."""
    for geometry, body, words in ((k5.k5_geometry, ec.k2_geometry, 4 * 10),
                                  (k6.k6_geometry, sc.k3_geometry, 3 * 10)):
        lanes, rpb, blocks, smem = geometry(b)
        assert (lanes, rpb, blocks, smem) == body(b)
        assert (lanes, rpb) == (2, 16) and lanes * rpb == 32
        assert blocks * rpb >= b > (blocks - 1) * rpb
        consts = ec.NCONSTS if geometry is k5.k5_geometry else sc.NCONSTS
        assert smem == (consts + 16 * words * rpb) * 4 <= SMEM_LIMIT
    with pytest.raises(ValueError):
        k5.k5_geometry(0)
    with pytest.raises(ValueError):
        k6.k6_geometry(0)


def _mk(n, msg_len=110, seed0=1):
    """tests/test_ops_ed25519.py's _mk: n valid triples."""
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        priv = ted.gen_privkey(bytes([seed0 + i % 250]) * 32)
        msg = bytes([i % 256]) * msg_len
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(ted.sign(priv, msg))
    return (np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32).copy(), msgs,
            np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64).copy())


def test_mesh_sharded_batch(ref_k5, mesh8, port_mesh):
    """tests/test_ops_ed25519.py::TestSharded::test_mesh_sharded_batch on
    both packages."""
    pubs, msgs, sigs = _mk(24)
    sigs[5, 0] ^= 1
    want = [jed.verify(pubs[i].tobytes(), msgs[i], sigs[i].tobytes()) for i in range(24)]
    assert jk5.verify_batch(pubs, msgs, sigs, mesh=mesh8).tolist() == want
    assert k5.verify_batch(pubs, msgs, sigs, port_mesh).tolist() == want
    assert want.count(False) == 1


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_k6(mesh8):
    fn = jk6._compiled_kernel(K6_ROWS, mesh8, "vpu", "lazy")
    return lambda arrays: _ref_call(fn, mesh8, [_pad(a, K6_ROWS) for a in arrays])


def _ref_pack(pubs, digs, sigs):
    """The reference's verify_batch packing (its prep_item), row-major:
    ((qx, qy, u1w, u2w, rl, rnl, rn_ok) of the kernel rows, their indices,
    forced) with forced -1 where its kernel decides."""
    rows, cols = [], [[] for _ in range(7)]
    forced = np.full((len(pubs),), -1, np.int8)
    for i, (p, d, g) in enumerate(zip(pubs, digs, sigs)):
        item = jk6.prep_item(bytes(p), bytes(d), bytes(g))
        if item[0] == "forced":
            forced[i] = item[1]
            continue
        _, (qx, qy), u1, u2, r = item
        rn_ok = r + jk6.N < jk6.P
        for c, v in zip(cols, (qx, qy, jk6._scalar_words(u1), jk6._scalar_words(u2),
                               jk6.int_to_limbs(r),
                               jk6.int_to_limbs(r + jk6.N if rn_ok else 0), rn_ok)):
            c.append(v)
        rows.append(i)
    return [np.asarray(c) for c in cols], np.asarray(rows, np.int64), forced


def _k6_rows_equal(ref_k6, pubs, digs, sigs):
    """Every kernel row through the reference's sharded kernel (chunks of
    its bucket) and the port's plain version (one call); the forced rows
    and their values equal. Returns (the port's verdicts, kernel rows, the
    reference kernel's verdicts on those rows, ``verify_rows``' raw output
    and K6's inputs on the CPU)."""
    jcols, rows, jforced = _ref_pack(pubs, digs, sigs)
    host, forced = k6.pack_rows(pubs, digs, sigs, len(pubs))
    assert np.array_equal(forced, jforced)
    assert np.array_equal(np.flatnonzero(forced == -1), rows)
    want = np.concatenate([ref_k6([c[k: k + K6_ROWS] for c in jcols])[: len(rows[k: k + K6_ROWS])]
                           for k in range(0, len(rows), K6_ROWS)])
    ins = k6.upload(host, CPU)
    raw = k6.verify_rows(*ins)
    got = raw.numpy() != 0
    assert got[rows].tolist() == want.tolist()
    return np.where(forced >= 0, forced.astype(bool), got), rows, want, raw, ins


@pytest.fixture(scope="module")
def k6_edge(ref_k6):
    """The secp256k1 edge window (range, parity, DER and high-s edges; the
    zero digest's u1 = 0 row, which the host decides) and clean rows,
    through ``_k6_rows_equal``."""
    pubs, digs, sigs, verdicts = tc.secp_edge_window(seed=1)
    rng = np.random.default_rng(11)
    while len(pubs) < K6_ROWS:
        priv = ts.gen_privkey(rng.bytes(32))
        dig = rng.bytes(32)
        pubs.append(secp_signer.pubkey_compressed(priv))
        digs.append(dig)
        sigs.append(secp_signer.sign(priv, dig))
    return (pubs, digs, sigs, verdicts), _k6_rows_equal(ref_k6, pubs, digs, sigs)


@pytest.fixture(scope="module")
def k6_der(ref_k6):
    """tests/test_torch_secp256k1.py's 500 seeded byte mutations of valid
    DER signatures, through ``_k6_rows_equal``."""
    pubs, digs, sigs, _ = tc.secp_edge_window(seed=6)
    rng = np.random.default_rng(7)
    mp, md, ms = [], [], []
    for _ in range(500):
        i = int(rng.integers(0, 10))
        sig = bytearray(sigs[i])
        sig[int(rng.integers(0, len(sig)))] ^= int(rng.integers(1, 256))
        mp.append(pubs[i])
        md.append(digs[i])
        ms.append(bytes(sig))
    return (mp, md, ms), _k6_rows_equal(ref_k6, mp, md, ms)


def test_k6_plain_version_equals_the_reference_kernel_on_the_edge_rows(k6_edge):
    """The secp256k1 edge window (range, parity, DER and high-s edges; the
    zero digest's u1 = 0 row, which the host decides) and clean rows."""
    (pubs, digs, sigs, verdicts), (got, rows, _, _, _) = k6_edge
    assert got.tolist() == [js.verify(p, d, g) for p, d, g in zip(pubs, digs, sigs)]
    assert [got[i] for i in sorted(verdicts)] == [verdicts[i] for i in sorted(verdicts)]
    assert 20 not in rows  # u1 = 0: decided on the host


def test_k6_plain_version_equals_the_reference_kernel_on_der_mutations(k6_der):
    """tests/test_torch_secp256k1.py's 500 seeded byte mutations of valid
    DER signatures: the rows that reach the kernel, row for row."""
    _, (got, rows, _, _, _) = k6_der
    assert len(rows) > 32 and not got[rows].all()


@pytest.mark.parametrize("case, some_accepted", [("k6_edge", True), ("k6_der", False)])
def test_k6_windowed_plain_version_gives_the_reference_verdicts(case, some_accepted, request):
    """The schedule K6 runs on the card: K3's windowed plain version
    (``secp256k1_cuda.ladder_ref``, the inversion-free check) on K6's
    inputs, its digits taken from the bit words as the kernel takes them,
    gives the reference kernel's verdict on every kernel row and
    ``verify_ref``'s on every row (the host's rows, zeroed, reject on
    both); every mutated row that reaches the kernel is rejected."""
    _, (_, rows, want, raw, ins) = request.getfixturevalue(case)
    qx, qy, u1w, u2w, rl, rnl, rnok = ins
    windowed, _, _ = sc.ladder_ref(sc._consts_on(CPU), qx, qy, window_digits(u1w, 256),
                                   window_digits(u2w, 256), rl, rnl, rnok)
    assert (windowed.numpy()[rows] != 0).tolist() == want.tolist()
    assert torch.equal(windowed, raw)
    assert bool(windowed.any()) == some_accepted and not windowed.numpy()[rows].all()


def test_mesh_sharded(ref_k6, mesh8, port_mesh):
    """tests/test_ops_secp256k1.py::TestKernelParity::test_mesh_sharded on
    both packages."""
    pubs, digs, sigs = [], [], []
    for i in range(8):
        priv = ts.gen_privkey(bytes([i + 1]) * 32)
        pubs.append(ts.pubkey_compressed(priv))
        digs.append(sha256(f"msg-{i}".encode()))
        sigs.append(ts.sign(priv, digs[-1]))
    r, sv = ts.der_decode_sig(sigs[3])
    sigs[3] = ts.der_encode_sig(r, sv ^ 1)
    want = [True] * 3 + [False] + [True] * 4
    assert list(jk6.verify_batch(pubs, digs, sigs, mesh=mesh8)) == want
    assert list(k6.verify_batch(pubs, digs, sigs, port_mesh)) == want


# ---------------------------------------------------------------------------
# The verifier's mesh route, the buckets, the kernels' constants
# ---------------------------------------------------------------------------


def test_torch_batch_verifier_mesh_equals_tpu_batch_verifier_xla(ref_k5, ref_k6, mesh8,
                                                                 port_mesh):
    """One ed25519 batch (the Go edge window) and one secp256k1 batch
    through ``TorchBatchVerifier(device="cpu", mesh=)`` (K5, K6 on the
    port's 8-shard mesh) and ``TPUBatchVerifier(mesh=, backend="xla")``."""
    pubs, msgs, sigs, _ = tc.go_edge_window(seed=4)
    ed_items = [(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    rng = np.random.default_rng(21)
    secp_items = []
    for i in range(12):
        priv = ts.gen_privkey(rng.bytes(32))
        msg = b"mesh-verifier-%d" % i
        sig = secp_signer.sign(priv, sha256(msg))
        if i % 5 == 2:
            sig = secp_signer.sign(priv, sha256(msg + b"!"))
        secp_items.append((secp_signer.pubkey_compressed(priv), msg, sig))
    port = tbatch.TorchBatchVerifier(device="cpu", mesh=port_mesh)
    ref = jbatch.TPUBatchVerifier(mesh=mesh8, backend="xla")
    assert (port.kernel_route, port.backend, ref.backend) == ("xla", "cpu", "xla")
    got_ed = port.verify_ed25519([tbatch.SigItem(*it) for it in ed_items])
    want_ed = ref.verify_ed25519([jbatch.SigItem(*it) for it in ed_items])
    assert got_ed.tolist() == want_ed.tolist() and 0 < want_ed.sum() < len(ed_items)
    got_secp = port.verify_secp256k1([tbatch.SigItem(*it) for it in secp_items])
    want_secp = ref.verify_secp256k1([jbatch.SigItem(*it) for it in secp_items])
    assert got_secp.tolist() == want_secp.tolist() and 0 < want_secp.sum() < 12
    assert port.stats["ed25519"].dispatches == port.stats["secp256k1"].dispatches == 1


def test_kernel_route_resolves_as_the_reference_backend():
    mesh = DeviceMesh(["cpu"] * 2)
    assert tbatch.TorchBatchVerifier("cpu").kernel_route == "pallas"
    v = tbatch.TorchBatchVerifier(mesh=mesh)
    assert (v.kernel_route, v.device, v.backend, v.mesh) == ("xla", CPU, "cpu", mesh)
    assert tbatch.TorchBatchVerifier("cpu", kernel_route="xla").kernel_route == "xla"
    lanes = tbatch.TorchBatchVerifier("cpu", mesh=mesh, kernel_route="pallas")
    assert lanes.kernel_route == "pallas"  # the lane kernels: the mesh is not consulted
    items = [tbatch.SigItem(*t) for t in zip(*tc.go_edge_window(seed=5)[:3])][:6]
    want = [ted._verify_pure(it.pubkey, it.msg, it.sig) for it in items]
    assert lanes.verify_ed25519(items).tolist() == want
    with pytest.raises(ValueError):
        tbatch.TorchBatchVerifier("cpu", kernel_route="mosaic")


@pytest.mark.parametrize("nd", range(1, 9))
def test_buckets_equal_the_reference(nd):
    jmesh = SimpleNamespace(devices=np.empty((nd,), object))  # all the reference reads
    pmesh = DeviceMesh(["cpu"] * nd)
    for n in (1, 24, 63, 64, 65, 100, 4095, 4097, 10_000, 12_289):
        assert k5._bucket(n) == jk5._bucket(n)
        assert k5._bucket(n, pmesh) == -(-jk5._bucket(n) // nd) * nd
        assert k6._bucket(n) == jk6._bucket(n)
        assert k6._bucket(n, pmesh) == jk6._bucket(n, jmesh)


def _source(name: str) -> str:
    """Kernel ``name``'s source with every header it includes."""
    return _build._source_bytes(_build.SRC_DIR / _build.SOURCES[name], set()).decode()


def test_kernel_sources_hold_the_plain_versions_constants():
    """K5 and K6 run K2's and K3's bodies, which read their constants from
    the kernel's constant input: ``ed25519_cuda._CONSTS`` (the niels table
    [0..15]B, then 2d) and ``secp256k1_cuda._CONSTS`` ([0..15]G). Each entry
    is held against the multiples of the plain versions' B and G, formed by
    the plain versions' own additions; the sources instantiate the shared
    bodies and keep no constant of their own."""
    src5, src6 = _source("ed25519_verify"), _source("secp256k1_verify")
    assert "ladder_kernel(const uint32_t* __restrict__ consts" in src5
    assert "launch_ladder<Digits::kWords>" in src5 and "__constant__" not in src5
    assert "launch_ladder<Digits::kRows>" in _source("ed25519_ladder")
    assert "ladder_kernel(const uint32_t* __restrict__ consts" in src6
    assert "launch_ladder<Digits::kWords>" in src6
    assert "launch_ladder<Digits::kRows>" in _source("secp256k1_ladder")
    assert re.search(r"constexpr int NCONSTS = 16 \* NIELS_W \+ NL;", src5)
    assert re.search(r"constexpr int NCONSTS = 16 \* PTW;", src6)

    # [j]B by verify_ref's extended additions from B_LIMBS, 2d D2_LIMBS
    assert ec.NCONSTS == 16 * 3 * 10 + 10
    assert ec._CONSTS[16 * 3 * 10:].tolist() == k5.D2_LIMBS
    row = lambda limbs: torch.tensor([limbs], dtype=torch.int64)
    d2 = row(k5.D2_LIMBS)
    bp = (row(k5.B_LIMBS["BX"]), row(k5.B_LIMBS["BY"]), fe.const(1, d2), row(k5.B_LIMBS["BT"]))
    acc = (torch.zeros_like(d2), fe.const(1, d2), fe.const(1, d2), torch.zeros_like(d2))
    two_d = fe.limbs_to_int(k5.D2_LIMBS)
    for j in range(16):
        zinv = fe.inv(acc[2])
        x, y = (fe.limbs_to_int(fe.canonical(fe.mul(c, zinv))[0].tolist()) for c in acc[:2])
        want = [fe.int_to_limbs((y + x) % fe.P), fe.int_to_limbs((y - x) % fe.P),
                fe.int_to_limbs(two_d * x * y % fe.P)]
        assert ec._CONSTS[: 16 * 30].reshape(16, 3, 10)[j].tolist() == want, j
        acc = k5._pt_add(acc, bp, d2)

    # [j]G by verify_ref's complete additions from G_LIMBS
    assert sc.NCONSTS == 16 * 3 * 10
    gp = (row(k6.G_LIMBS["GX"]), row(k6.G_LIMBS["GY"]), F.const(1, row(k6.G_LIMBS["GX"])))
    one = F.const(1, gp[0])
    acc = (torch.zeros_like(one), one, torch.zeros_like(one))
    table = sc._CONSTS.reshape(16, 3, 10)
    assert table[0].tolist() == [[0] * 10, F.int_to_limbs(1), [0] * 10]
    for j in range(1, 16):
        acc = k6._pt_add(acc, gp)
        zinv = k6.fe_inv(acc[2])
        want = [F.canonical(F.mul(c, zinv))[0].tolist() for c in acc[:2]] + [F.int_to_limbs(1)]
        assert table[j].tolist() == want, j

    assert F.limbs_to_int(k6.G_LIMBS["GX"]) == jk6.GX
    assert fe.limbs_to_int(k5.B_LIMBS["BY"]) == jed._BY
    assert k5.k5_fe_ops(np.zeros((2, 8), np.uint32), np.zeros((2, 8), np.uint32)) == (
        2 * (253 * 4 + 14), 2 * (253 * 4 + 254))
