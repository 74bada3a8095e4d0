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
reference call here lands in those buckets). No tolerance: verdicts are
exact."""

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
from tendermint_tpu_torch.ops import ed25519_verify as k5
from tendermint_tpu_torch.ops import fe
from tendermint_tpu_torch.ops import fe_secp256k1 as F
from tendermint_tpu_torch.ops import secp256k1_verify as k6
from tendermint_tpu_torch.parallel.mesh import DeviceMesh
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.testutil import secp_signer

K5_ROWS, K6_ROWS = 64, 32  # the reference's buckets on an 8-device mesh
CPU = torch.device("cpu")


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


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_plain_version_equals_the_reference_kernel(ref_k5, seed):
    """The reference's packed rows (its host prologue) through its jitted,
    sharded ``_verify_kernel`` and, converted to the port's limbs, through
    ``verify_rows`` on the CPU: the same raw verdict on every row, the
    Go edge rows among them."""
    pubs, msgs, sigs = _ed_rows(K5_ROWS, seed=seed)
    jneg, jay, jsw, jhw, jrl, jrs, valid = jk5.host_prologue(pubs, msgs, sigs)
    want = ref_k5((jneg, jay, jsw, jhw, jrl, jrs))
    host = (_to_port(jneg, fe), _to_port(jay, fe), jsw, jhw, _to_port(jrl, fe), jrs)
    got = k5.verify_rows(*k5.upload(host, CPU)).numpy() != 0
    assert got.tolist() == want.tolist()
    oracle = [jed.verify(pubs[i].tobytes(), bytes(msgs[i]), sigs[i].tobytes())
              for i in range(K5_ROWS)]
    assert (got & valid).tolist() == oracle
    assert 0 < sum(oracle) < K5_ROWS


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
    and their values equal. Returns (the port's verdicts, kernel rows)."""
    jcols, rows, jforced = _ref_pack(pubs, digs, sigs)
    host, forced = k6.pack_rows(pubs, digs, sigs, len(pubs))
    assert np.array_equal(forced, jforced)
    assert np.array_equal(np.flatnonzero(forced == -1), rows)
    want = np.concatenate([ref_k6([c[k: k + K6_ROWS] for c in jcols])[: len(rows[k: k + K6_ROWS])]
                           for k in range(0, len(rows), K6_ROWS)])
    got = k6.verify_rows(*k6.upload(host, CPU)).numpy() != 0
    assert got[rows].tolist() == want.tolist()
    return np.where(forced >= 0, forced.astype(bool), got), rows


def test_k6_plain_version_equals_the_reference_kernel_on_the_edge_rows(ref_k6):
    """The secp256k1 edge window (range, parity, DER and high-s edges; the
    zero digest's u1 = 0 row, which the host decides) and clean rows."""
    pubs, digs, sigs, verdicts = tc.secp_edge_window(seed=1)
    rng = np.random.default_rng(11)
    while len(pubs) < K6_ROWS:
        priv = ts.gen_privkey(rng.bytes(32))
        dig = rng.bytes(32)
        pubs.append(secp_signer.pubkey_compressed(priv))
        digs.append(dig)
        sigs.append(secp_signer.sign(priv, dig))
    got, rows = _k6_rows_equal(ref_k6, pubs, digs, sigs)
    assert got.tolist() == [js.verify(p, d, g) for p, d, g in zip(pubs, digs, sigs)]
    assert [got[i] for i in sorted(verdicts)] == [verdicts[i] for i in sorted(verdicts)]
    assert 20 not in rows  # u1 = 0: decided on the host


def test_k6_plain_version_equals_the_reference_kernel_on_der_mutations(ref_k6):
    """tests/test_torch_secp256k1.py's 500 seeded byte mutations of valid
    DER signatures: the rows that reach the kernel, row for row."""
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
    got, rows = _k6_rows_equal(ref_k6, mp, md, ms)
    assert len(rows) > 32 and not got[rows].all()


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


def _source_consts(path: Path, name: str):
    body = re.search(name + r"\[NL\] = \{([^}]*)\}", path.read_text()).group(1)
    return [int(v, 16) for v in body.replace("\n", " ").split(",")]


def test_kernel_sources_hold_the_plain_versions_constants():
    src5 = _build.SRC_DIR / _build.SOURCES["ed25519_verify"]
    for name, limbs in {**k5.B_LIMBS, "D2C": k5.D2_LIMBS}.items():
        assert _source_consts(src5, name) == limbs
    src6 = _build.SRC_DIR / _build.SOURCES["secp256k1_verify"]
    for name, limbs in k6.G_LIMBS.items():
        assert _source_consts(src6, name) == limbs
    assert F.limbs_to_int(k6.G_LIMBS["GX"]) == jk6.GX
    assert fe.limbs_to_int(k5.B_LIMBS["BY"]) == jed._BY
    assert k5.k5_fe_ops(np.zeros((2, 8), np.uint32), np.zeros((2, 8), np.uint32)) == (
        2 * (253 * 4 + 14), 2 * (253 * 4 + 254))
