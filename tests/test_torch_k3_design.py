"""K3's lane schedule and launch geometry on the CPU
(tendermint_tpu_torch/ops/secp256k1_cuda.py, csrc/secp256k1_ladder.cu).

The kernel splits each point formula's independent products over the two
lanes of a row (``ADD_ROUNDS``, ``DOUBLE_ROUNDS``); evaluated round by round
on the plain field ops, each lane reading only the values it holds, the
schedule must give the limbs of ``_pt_add`` and ``_pt_double`` exactly.
Its 55-product squaring must give the columns of the 100-product multiply,
and its fold's 32-bit words must hold the certificate's bounds. The
geometry the wrapper passes must cover every row within the card's shared
memory, and the window-loop count of ``tools/k3_compare`` must follow the
loops and calls of a listing. Every comparison is exact."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import secp256k1 as ts
from tendermint_tpu_torch.ops import fe_secp256k1 as F
from tendermint_tpu_torch.ops import imad_probe
from tendermint_tpu_torch.ops import secp256k1_cuda as sc
from tendermint_tpu_torch.tools import k3_compare

P = F.P
S = F.closed_set()
SRC = (Path(sc.__file__).parent / "csrc" / "secp256k1_ladder.cu").read_text()
NPTS = 64
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on Hopper


def _sq_cols(a):
    """The columns of the kernel's 55-product squaring (fe_sq): the ten
    squares and the 45 doubled cross terms 2 a_i a_j, i < j."""
    cols = [0] * F.NCOLS
    for i in range(F.NLIMB):
        cols[2 * i] += a[i] * a[i]
        for j in range(i + 1, F.NLIMB):
            cols[i + j] += (2 * a[i]) * a[j]
    return cols


def _limbs(vals):
    return torch.tensor([F.int_to_limbs(v % P) for v in vals], dtype=torch.int64)


@pytest.fixture(scope="module")
def points():
    """64 seeded pairs (p, q) of projective points: multiples of G with
    random Z, the identity on either side, P + P and P + (-P)."""
    rng = np.random.default_rng(41)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(NPTS + 1)]
    aff = [ts._to_affine(ts._jmul(ts._G, k)) for k in ks]
    zs = [int.from_bytes(rng.bytes(32), "big") % (P - 1) + 1 for _ in range(NPTS + 1)]
    pts = [(x * z % P, y * z % P, z) for (x, y), z in zip(aff, zs)]
    ident = (0, 1, 0)
    ps, qs = pts[:NPTS], pts[1:]
    ps[0] = ident  # 0 + Q
    qs[1] = ident  # P + 0
    ps[2] = qs[2] = ident  # 0 + 0
    qs[3] = ps[3]  # P + P
    qs[4] = (ps[4][0], P - ps[4][1], ps[4][2])  # P + (-P)
    qs[5] = tuple(2 * c % P for c in ps[5])  # P + P in another representation
    col = lambda pts_, i: _limbs([pt[i] for pt in pts_])
    return tuple(col(ps, i) for i in range(3)), tuple(col(qs, i) for i in range(3))


SCHEDULES = {
    "add": (lambda p, q: sc.pt_add_rounds(p, q), lambda p, q: sc._pt_add(p, q)),
    "add_swapped": (lambda p, q: sc.pt_add_rounds(q, p), lambda p, q: sc._pt_add(q, p)),
    "double": (lambda p, q: sc.pt_double_rounds(p), lambda p, q: sc._pt_double(p)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lane_schedule_equals_point_formulas(points, case):
    p, q = points
    # carried, not canonical, inputs: the kernel's accumulator is one
    p, q = sc._pt_double(sc._pt_add(p, q)), sc._pt_add(q, sc._pt_double(q))
    run, want = SCHEDULES[case]
    for g, w in zip(run(p, q), want(p, q)):
        assert torch.equal(g, w)


def test_identity_and_inverse_sums_stay_the_identity(points):
    p, q = points
    X, Y, Z = sc.pt_add_rounds(p, q)
    assert [F.limbs_to_int(Z[i].tolist()) % P for i in (2, 4)] == [0, 0]
    assert F.limbs_to_int(Y[2].tolist()) % P != 0


# the products of each formula, as unordered operand pairs
ADD_PRODUCTS = {("X1", "X2"), ("Y1", "Y2"), ("Z1", "Z2"), ("X1+Y1", "X2+Y2"),
                ("Y1+Z1", "Y2+Z2"), ("X1+Z1", "X2+Z2"), ("t1'", "t3"), ("t4", "y3b"),
                ("t0x3", "y3b"), ("t1'", "z3"), ("t4", "z3"), ("t0x3", "t3")}
DOUBLE_PRODUCTS = {("Y", "Y"), ("Z", "Z"), ("Y", "Z"), ("X", "Y"), ("t2", "z3"),
                   ("t1", "z3"), ("t0'", "y3"), ("XY", "t0'")}


@pytest.mark.parametrize("name", ["add", "double"])
def test_lane_slots_cover_each_product_once(name):
    rounds, products = {"add": (sc.ADD_ROUNDS, ADD_PRODUCTS),
                        "double": (sc.DOUBLE_ROUNDS, DOUBLE_PRODUCTS)}[name]
    assert {tuple(sorted(pr)) for rnd in rounds for pr in rnd} == products
    assert sum(len(rnd) for rnd in rounds) == len(products)
    for round_ in rounds:
        slots = sc.lane_slots(len(round_))
        assert len(slots) == sc.K3_LANES_PER_ROW
        assert sorted(k for lane in slots for k in lane) == list(range(len(round_)))
        assert len({len(lane) for lane in slots}) == 1  # every slot full
    # the doubling's first slot holds only squares: the 55-product squaring
    assert all(a == b for a, b in sc.DOUBLE_ROUNDS[0][:2])


def test_squaring_columns_equal_multiply_columns():
    rng = np.random.default_rng(43)
    rows = [list(S), list(F.MASKS), [0] * F.NLIMB]
    rows += [[int(v) for v in rng.integers(0, np.array(S) + 1)] for _ in range(200)]
    rows += [[int(v) for v in rng.integers(0, 1 << 26, F.NLIMB)] for _ in range(50)]
    for a in rows:
        assert _sq_cols(a) == F.bound_mul_cols(a, a)
    # the doubled operand of the cross terms fits the kernel's 32-bit limbs
    assert 2 * max(S) < 2**32


def test_fold_words_fit_the_kernels_widths():
    """The kernel folds in 32-bit words after the columns: d_k < 2^30,
    r_k < 2^44, and after the first carry pass every limb and carry, and
    0x3D1 times the top carry, below 2^32."""
    cols = F.bound_mul_cols(S, S) + [0]
    assert max(cols) < 2**64
    d = [min(cols[k], F.M26) + (cols[k - 1] >> F.RADIX if k else 0) for k in range(20)]
    assert max(d) < 2**30
    r = [d[k] + F.FOLD_LO * d[k + 10] + (F.FOLD_HI * d[k + 9] if k else 0)
         for k in range(F.NLIMB)]
    r[0] += F.FOLD19_LO * d[19]
    r[1] += F.FOLD19_HI * d[19]
    assert max(r) < 2**44
    carries = [v >> w for v, w in zip(r, F.WIDTHS)]
    once = F.bound_carry(r)
    assert max(carries) < 2**28 and max(once) < 2**28
    assert F.TOP_LO * carries[9] + F.M26 < 2**32
    assert max(F.bound_carry(once)) < 2**32


@pytest.mark.parametrize("b", [1, 128, 200, 512, 10_240])
def test_k3_geometry_covers_every_row(b):
    lanes, rpb, blocks, smem = sc.k3_geometry(b)
    assert (lanes, rpb) == (sc.K3_LANES_PER_ROW, sc.K3_ROWS_PER_BLOCK)
    assert blocks == -(-b // rpb)
    assert blocks * rpb >= b and (blocks - 1) * rpb < b
    assert smem <= SMEM_LIMIT
    assert smem == 4 * (sc.NCONSTS + 16 * 3 * sc.NLIMB * rpb)
    threads = lanes * rpb
    assert threads % 32 == 0 and threads <= 1024


def test_k3_geometry_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        sc.k3_geometry(0)


def test_kernel_source_geometry_matches_the_wrapper():
    def const(name):
        return int(re.search(r"constexpr int " + name + r"\s*=\s*(\d+);", SRC).group(1))

    assert const("LPR") == sc.K3_LANES_PER_ROW
    assert const("RPB") == sc.K3_ROWS_PER_BLOCK
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in SRC
    assert "__launch_bounds__(THREADS" in SRC
    for body in ("__noinline__ Fe fe_sq", "__noinline__ Fe fe_mul", "__noinline__ Fe2 fe_mul2"):
        assert body in SRC


def test_ladder_into_launches_only_on_cuda():
    b = 8
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    ins = (z(sc.NCONSTS), z(10, b), z(10, b), z(64, b), z(64, b), z(10, b), z(10, b), z(1, b))
    before = sc.launches[sc.NAME]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sc.ladder_into(ins, z(b), z(10, b), z(10, b))
    with pytest.raises(ValueError, match="shape"):
        sc.ladder_into(ins, z(b + 1), z(10, b), z(10, b))
    assert sc.launches[sc.NAME] == before


def test_imad_probe_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        imad_probe.products_per_clock(torch.device("cpu"))


FAKE_SASS = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;
        /*0030*/                   CALL.REL.NOINC 0x00c0 ;
        /*0040*/               @P0 BRA 0x0020 ;
        /*0050*/                   SHFL.BFLY PT, R5, R4, 0x1, 0x1f ;
        /*0060*/                   LDS R6, [R7] ;
        /*0070*/               @P1 BRA 0x0050 ;
        /*0080*/                   SEL R8, R5, R6, P2 ;
        /*0090*/               @P3 BRA 0x0010 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0x00b0;
        /*00c0*/                   IMAD R9, R9, R9, RZ ;
        /*00d0*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_window_mix_counts_inner_loops_and_calls():
    # window loop 0x10..0x90: doubling loop 0x20..0x40 (x4, with a call of
    # two instructions), addition loop 0x50..0x70 (x2)
    mix = k3_compare.window_mix(FAKE_SASS)
    assert mix == {"alu": 2, "imad_wide": 4, "imad": 4, "control": 4 * 3 + 2 * 1 + 1,
                   "shfl": 2, "memory": 2}
    assert k3_compare.window_mix(FAKE_SASS.replace("@P1 BRA 0x0050", "NOP")) is None
