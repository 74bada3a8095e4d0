"""The port's multi-device lane split (tendermint_tpu_torch/parallel/mesh.py
and the mesh paths of the planner, the commit window, fast sync and state
sync) against the JAX package's mesh paths on the CPU.

The reference runs on its suite's 8 forced host devices as a (2, 4)
``("height", "val")`` mesh; the port on ``DeviceMesh(["cpu"] * 8, (2, 4),
("height", "val"))``. Restated on both packages through the ``pkg``
parameter: ``tests/test_multichip.py::TestMeshSuperdispatch`` (its six
cases, both reduce modes) and ``test_windows_per_dispatch_scales_with_mesh``;
every verdict grid and int64 tally is compared with the flat path's,
exactly. The windows' messages are of one length (one K1 + K2 group a
shard), and every window lands in one (128 lanes, 8 segments) bucket: the
reference compiles its mesh step once for each reduce mode.
``tests/test_torch_mesh_sync.py`` holds the commit window's, fast sync's
and state sync's mesh cases, on these fixtures."""

import numpy as np
import pytest
import torch
from types import SimpleNamespace

import jax
from jax.sharding import Mesh

from tendermint_tpu.blockchain import reactor as rreactor
from tendermint_tpu.config.config import VerifyConfig as RVerifyConfig
from tendermint_tpu.crypto import keys as rkeys
from tendermint_tpu.libs import breaker as rbrk
from tendermint_tpu.parallel import commit_verify as rcv
from tendermint_tpu.parallel import planner as rplanner
from tendermint_tpu.state import state_types as rst
from tendermint_tpu.testutil import chain as rchain
from tendermint_tpu_torch.blockchain import reactor as treactor
from tendermint_tpu_torch.config.verify import VerifyConfig as TVerifyConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import keys as tkeys
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs import breaker as tbrk
from tendermint_tpu_torch.libs.metrics import Registry, VerifyMetrics
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.parallel import commit_verify as tcv
from tendermint_tpu_torch.parallel import planner as tplanner
from tendermint_tpu_torch.parallel.mesh import DeviceMesh
from tendermint_tpu_torch.state import state_types as tst
from tendermint_tpu_torch.testutil import chain as tchain

AXES = ("height", "val")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rmesh():
    devs = np.array(jax.devices("cpu"))
    if devs.size < 8:
        pytest.skip("needs the 8 forced host devices (tests/conftest.py)")
    return Mesh(devs[:8].reshape(2, 4), AXES)


@pytest.fixture(scope="module")
def tmesh():
    return DeviceMesh(["cpu"] * 8, (2, 4), AXES)


@pytest.fixture(autouse=True)
def _guards():
    """Both packages' guards reset around every test: the reference's
    first mesh dispatch compiles under its guard (a long deadline), the
    port runs its plain versions unsupervised; the port's executor and
    verifier on the CPU (the host oracle for the verifier route)."""
    rbrk.reset_device_guard()
    rbrk.configure_device_guard(dispatch_deadline=600.0)
    tbrk.reset_device_guard()
    tbrk.configure_device_guard(dispatch_deadline=0)
    tplanner.set_device_executor(tplanner.device_executor("cpu"))
    tbatch.set_batch_verifier(tbatch.HostBatchVerifier())
    yield
    for planner in (rplanner, tplanner):
        planner.configure_planner(None)
        planner.set_device_executor(None)
        planner.set_reduce_mode("device")
    tbatch.set_batch_verifier(None)
    rbrk.reset_device_guard()
    tbrk.reset_device_guard()


@pytest.fixture(params=["reference", "port"])
def pkg(request, rmesh, tmesh):
    if request.param == "reference":
        return SimpleNamespace(
            name="reference", planner=rplanner, brk=rbrk, cv=rcv, mesh=rmesh,
            reactor=rreactor, st=rst, chain=rchain, build_kw={}, VerifyConfig=RVerifyConfig,
            ed_key=lambda i: rkeys.PrivKeyEd25519.generate(bytes([i + 1]) * 32),
            secp_key=lambda i: rkeys.PrivKeySecp256k1.from_secret(bytes([i + 9]) * 32))
    return SimpleNamespace(
        name="port", planner=tplanner, brk=tbrk, cv=tcv, mesh=tmesh,
        reactor=treactor, st=tst, chain=tchain,
        build_kw={"verifier": tbatch.HostBatchVerifier()}, VerifyConfig=TVerifyConfig,
        ed_key=lambda i: tkeys.PrivKeyEd25519.generate(bytes([i + 1]) * 32),
        secp_key=lambda i: tkeys.PrivKeySecp256k1(bytes([i + 9]) * 32))


def _signed(n, tag=0):
    out = []
    for i in range(n):
        seed = bytes([(i % 251) + 1, (i // 251) + 1, (tag % 250) + 1]) * 16
        priv = ted.gen_privkey(seed[:32])
        msg = b"multichip-%02d-%03d" % (tag, i)
        out.append((priv[32:], msg, ted.sign(priv, msg)))
    return out


def _window(sizes, tag=0, absent=(), forged=(), totals=None):
    """tests/test_multichip.py's window spec: power 1 a lane, the strict
    +2/3 boundary steered by ``totals``."""
    triples = _signed(sum(sizes), tag=tag)
    votes, powers, tot = [], [], []
    i = 0
    for h, V in enumerate(sizes):
        vrow = []
        for v in range(V):
            pub, msg, sig = triples[i]
            i += 1
            if (h, v) in absent:
                vrow.append(None)
            elif (h, v) in forged:
                bad = bytearray(sig)
                bad[9] ^= 1
                vrow.append((pub, msg, bytes(bad)))
            else:
                vrow.append((pub, msg, sig))
        votes.append(vrow)
        powers.append([1] * V)
        tot.append(V)
    return votes, powers, list(totals) if totals is not None else tot


def _assert_same_verdict(got, want):
    assert got.ok.shape == want.ok.shape
    assert np.array_equal(got.ok, want.ok)
    assert got.tally.dtype == np.int64
    assert np.array_equal(got.tally, want.tally)
    assert np.array_equal(got.committed, want.committed)
    assert np.array_equal(got.sigs_ok, want.sigs_ok)


def _matrix_specs():
    """Ragged sets of 1, 4 and 64, an absence, a forgery, and the strict
    boundary (2 of 3: 6 > 6 is false)."""
    return [
        _window([1], tag=1),
        _window([4], tag=2, forged={(0, 3)}),
        _window([2], tag=3, totals=[3]),
        _window([64], tag=4),
        _window([2, 3], tag=5, absent={(1, 0)}),
    ]


# ---------------------------------------------------------------------------
# TestMeshSuperdispatch (tests/test_multichip.py), on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce_mode", ["device", "host"])
def test_bit_identical_to_flat_host_path(pkg, reduce_mode):
    specs = _matrix_specs()
    flat = [pkg.planner.verify_window(*s, use_device=False) for s in specs]
    pkg.planner.set_reduce_mode(reduce_mode)
    got = pkg.planner.verify_windows(specs, mesh=pkg.mesh, use_device=True)
    assert len(got) == len(flat)
    for g, w in zip(got, flat):
        _assert_same_verdict(g, w)
    snap = pkg.brk.get_device_breaker().snapshot()
    assert snap["failures_total"] == 0
    assert pkg.brk.get_device_breaker().state == pkg.brk.CLOSED


def test_mixed_key_windows_split_on_host_path(pkg):
    sk = [pkg.secp_key(i) for i in range(2)]
    edp = [pkg.ed_key(i) for i in range(3)]
    m0, m1 = b"mc-mixed-0", b"mc-mixed-1"
    specs = [
        _window([3], tag=6),
        ([[(p.pub_key(), m0, p.sign(m0)) for p in sk]], [[1, 1]], [2]),
        ([[(p.pub_key(), m1, p.sign(m1)) for p in edp]
          + [(sk[0].pub_key(), m1, sk[0].sign(m1))]], [[1] * 4], [4]),
    ]
    flat = [pkg.planner.verify_window(*s, use_device=False) for s in specs]
    got = pkg.planner.verify_windows(specs, mesh=pkg.mesh, use_device=True)
    for g, w in zip(got, flat):
        _assert_same_verdict(g, w)


def test_one_compile_per_bucket_across_mixed_stream(pkg):
    """Superdispatches of different window counts and widths in one (128,
    8) bucket: one compile (the reference's jit; the port's first dispatch
    of a (mesh, bucket, reduce) key)."""
    c0 = pkg.planner.compile_count()
    streams = [
        [_window([40], tag=10), _window([30], tag=11)],
        [_window([65], tag=12), _window([4], tag=13), _window([8], tag=14)],
        [_window([20, 20], tag=15), _window([25], tag=16), _window([25], tag=17)],
    ]
    for specs in streams:
        for g in pkg.planner.verify_windows(specs, mesh=pkg.mesh, use_device=True):
            assert g.committed.all() and g.sigs_ok.all()
    assert pkg.planner.compile_count() - c0 <= 1


def test_guard_wraps_superdispatch_per_dispatch(pkg):
    specs = _matrix_specs()
    flat = [pkg.planner.verify_window(*s, use_device=False) for s in specs]

    def explode(plan, mesh):
        raise RuntimeError("mesh dispatch crashed")

    pkg.planner.set_device_executor(explode)
    got = pkg.planner.verify_windows(specs, mesh=pkg.mesh, use_device=True)
    for g, w in zip(got, flat):
        _assert_same_verdict(g, w)
    assert pkg.brk.get_device_breaker().snapshot()["failures_total"] > 0


def test_corrupt_superdispatch_quarantines(pkg):
    pkg.brk.configure_device_guard(audit_sample_rate=1.0)
    specs = [_window([3], tag=20), _window([2], tag=21)]
    flat = [pkg.planner.verify_window(*s, use_device=False) for s in specs]

    def corrupt(plan, mesh):
        v = pkg.planner._execute_host(plan)
        v.ok = np.array(v.ok, copy=True)
        h, vv = int(plan.coords[0, 0]), int(plan.coords[0, 1])
        v.ok[h, vv] = not v.ok[h, vv]
        return v

    pkg.planner.set_device_executor(corrupt)
    got = pkg.planner.verify_windows(specs, mesh=pkg.mesh, use_device=True)
    for g, w in zip(got, flat):
        _assert_same_verdict(g, w)
    assert pkg.brk.get_device_breaker().state == pkg.brk.QUARANTINED


def test_windows_per_dispatch_scales_with_mesh(pkg):
    assert pkg.planner.windows_per_dispatch() == 4
    assert pkg.planner.windows_per_dispatch(pkg.mesh) == 32
    pkg.planner.configure_planner(pkg.VerifyConfig(windows_per_device=2))
    assert pkg.planner.windows_per_dispatch(pkg.mesh) == 16


@pytest.mark.parametrize("nd", range(1, 9))
def test_lanes_bucket_equals_the_reference(nd):
    ref_mesh = SimpleNamespace(devices=np.empty((nd,), object))  # what the reference reads
    mesh = DeviceMesh(["cpu"] * nd)
    for n in (0, 1, 63, 64, 65, 100, 4095, 4096, 4097, 32_661, 100_000):
        want = rplanner.lanes_bucket(n, ref_mesh)
        assert tplanner.lanes_bucket(n, mesh) == want and want % nd == 0
        assert tplanner.lanes_bucket(n) == rplanner.lanes_bucket(n)


def test_mesh_dispatch_records_a_shard_a_device(tmesh):
    """The port's mesh dispatch: labelled "planner_mesh" in the ledger
    with its eight shards, and each shard of the repeated CPU device
    counted under its own label in the per-device metrics."""
    vm = VerifyMetrics(Registry())
    vm.record_device_shards(tmesh.labels(), 16)
    assert tmesh.labels() == [f"cpu#{k}" for k in range(8)]
    assert {k: v for (k,), v in vm.device_dispatches._values.items()} == {
        f"cpu#{k}": 1.0 for k in range(8)}
    assert set(vm.device_lanes._values.values()) == {16.0}
    get_profiler().reset()
    tplanner.verify_window(*_window([9], tag=30), mesh=tmesh)
    entry = get_profiler().entries()[-1]
    assert (entry["kind"], entry["n_devices"], entry["bucket"]) == ("planner_mesh", 8, [64, 8])


# ---------------------------------------------------------------------------
# DeviceMesh
# ---------------------------------------------------------------------------


def test_device_mesh_reads_as_the_reference_mesh(rmesh, tmesh):
    assert tmesh.devices.shape == rmesh.devices.shape == (2, 4)
    assert tmesh.devices.size == rmesh.devices.size == 8
    assert tmesh.axis_names == rmesh.axis_names == AXES
    assert all(d == torch.device("cpu") for d in tmesh.devices.flat)
    same = DeviceMesh(["cpu"] * 8, (2, 4), AXES)
    assert same == tmesh and hash(same) == hash(tmesh) and {tmesh: 1}[same] == 1
    assert DeviceMesh(["cpu"] * 8) != tmesh  # the shape and names count
    assert DeviceMesh(["cpu"] * 8, (8,), ("lanes",)) == DeviceMesh(["cpu"] * 8)


def test_device_mesh_splits_rows_and_windows():
    mesh = DeviceMesh(["cpu"] * 4, (2, 2), AXES)
    assert mesh.split_rows(8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError):
        mesh.split_rows(6)
    shards = [torch.arange(lo, hi).to(d) for (lo, hi), d in zip(mesh.split_rows(8), mesh.flat)]
    assert mesh.gather(shards).tolist() == list(range(8))
    assert mesh.pad_window(3, 5) == (4, 6)
    blocks = [(h.start, h.stop, v.start, v.stop) for _, h, v in mesh.split_window(3, 5)]
    assert blocks == [(0, 2, 0, 3), (0, 2, 3, 6), (2, 4, 0, 3), (2, 4, 3, 6)]
    assert DeviceMesh(["cpu"] * 2).window_shape() == (2, 1)
    with pytest.raises(ValueError):
        DeviceMesh(["cpu"] * 3, (2, 2))
    with pytest.raises(ValueError):
        DeviceMesh(["cpu"] * 4, (2, 2), ("lanes",))
    with pytest.raises(ValueError):
        DeviceMesh([])


def test_device_mesh_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoCudaDeviceError):
        DeviceMesh(["cuda:0"] * 4)
    assert not DeviceMesh(["cpu"]).on_card()
