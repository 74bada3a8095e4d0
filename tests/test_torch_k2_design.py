"""K2's lane schedule and launch geometry on the CPU
(tendermint_tpu_torch/ops/ed25519_cuda.py, csrc/ed25519_ladder.cu).

The kernel splits each point formula's independent products over the two
lanes of a row (``DOUBLE_ROUNDS``, ``MADD_ROUNDS``, ``CACHED_ROUNDS``, and
for the table's odd entries the full add ``pt_add_rounds``); evaluated
round by round on the plain field ops, each lane reading only the values it
holds, the schedule must give the limbs of ``_pt_double``, ``_pt_madd``,
``_pt_add_cached`` and ``_pt_add`` exactly, and the table it builds must be
the plain version's. Its 55-product squaring (``sq_split``) must give the
columns of the 100-product multiply with every premultiplied operand inside
32 bits. The geometry the wrapper passes must cover every row within the
card's shared memory, and the compare tool's window-loop count must follow
K2's loop shapes. Every comparison is exact."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import fe
from tendermint_tpu_torch.tools import k3_compare

P = fe.P
S = fe.closed_set()
# K2's source with the field header it includes (csrc/ed25519_field.cuh)
SRC = "".join((Path(ec.__file__).parent / "csrc" / f).read_text()
              for f in ("ed25519_ladder.cu", "ed25519_field.cuh"))
NPTS = 64
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on Hopper
D2 = torch.tensor(fe.int_to_limbs(ted.D2), dtype=torch.int64)


def _limbs(vals):
    return torch.tensor([fe.int_to_limbs(v % P) for v in vals], dtype=torch.int64)


def _extended(aff, z):
    x, y = aff
    return (x * z % P, y * z % P, z, x * y % P * z % P)


def _cached(p):
    """Extended (X, Y, Z, T) -> cached (Y+X, Y-X, Z, 2d T), as
    ``ladder_point_ref`` forms its table."""
    X, Y, Z, T = p
    return fe.add(Y, X), fe.sub(Y, X), Z, fe.mul(T, D2)


@pytest.fixture(scope="module")
def points():
    """64 seeded pairs (p, q) of extended points, carried (not canonical):
    multiples of B with random Z, the identity on either side, P + P and
    P + (-P)."""
    rng = np.random.default_rng(61)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(NPTS + 1)]
    aff = [ted.pt_affine(ted.pt_scalar_mult(ted.B_EXT, k)) for k in ks]
    zs = [int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1 for _ in range(NPTS + 1)]
    pts = [_extended(a, z) for a, z in zip(aff, zs)]
    ps, qs = pts[:NPTS], pts[1:]
    ps[0] = ted.IDENT  # 0 + Q
    qs[1] = ted.IDENT  # P + 0
    ps[2] = qs[2] = ted.IDENT  # 0 + 0
    qs[3] = ps[3]  # P + P
    qs[4] = (P - ps[4][0], ps[4][1], ps[4][2], P - ps[4][3])  # P + (-P)
    qs[5] = tuple(2 * c % P for c in ps[5])  # P + P in another representation
    col = lambda pts_, i: _limbs([pt[i] for pt in pts_])
    p = tuple(col(ps, i) for i in range(4))
    q = tuple(col(qs, i) for i in range(4))
    # carried, not canonical, inputs: the kernel's accumulator is one
    return (ec._pt_double(ec._pt_add_cached(p, _cached(q))),
            ec._pt_add_cached(q, _cached(ec._pt_double(q))))


def _niels(q):
    """Affine niels (y+x, y-x, 2dxy) of extended points, exact limbs."""
    X, Y, Z, _ = ([fe.limbs_to_int(r.tolist()) for r in c] for c in q)
    out = [[], [], []]
    for x, y, z in zip(X, Y, Z):
        zi = pow(z % P, P - 2, P)
        x, y = x * zi % P, y * zi % P
        for k, v in enumerate((y + x, y - x, 2 * ted.D * x * y)):
            out[k].append(v)
    return tuple(_limbs(v) for v in out)


SCHEDULES = {
    "double": (lambda p, q: ec.pt_double_rounds(p), lambda p, q: ec._pt_double(p)),
    "cached": (lambda p, q: ec.pt_add_cached_rounds(p, _cached(q)),
               lambda p, q: ec._pt_add_cached(p, _cached(q))),
    "cached_swapped": (lambda p, q: ec.pt_add_cached_rounds(q, _cached(p)),
                       lambda p, q: ec._pt_add_cached(q, _cached(p))),
    "madd": (lambda p, q: ec.pt_madd_rounds(p, *_niels(q)),
             lambda p, q: ec._pt_madd(p, *_niels(q))),
    "add": (lambda p, q: ec.pt_add_rounds(p, q, D2), lambda p, q: ec._pt_add(p, q, D2)),
    "add_swapped": (lambda p, q: ec.pt_add_rounds(q, p, D2),
                    lambda p, q: ec._pt_add(q, p, D2)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lane_schedule_equals_point_formulas(points, case):
    p, q = points
    run, want = SCHEDULES[case]
    for g, w in zip(run(p, q), want(p, q)):
        assert torch.equal(g, w)


def test_identity_and_inverse_sums(points):
    """P + (-P) and 0 + 0 through the schedule give the identity
    (0 : Z : Z : 0) on carried inputs."""
    p, _ = points
    zero = torch.zeros_like(p[0])
    neg = (fe.sub(zero, p[0]), p[1], p[2], fe.sub(zero, p[3]))
    ident = (zero, fe.const(1, zero), fe.const(1, zero), zero)
    for a, b in ((p, neg), (ident, ident)):
        for X, Y, Z, T in (ec.pt_add_cached_rounds(a, _cached(b)), ec.pt_add_rounds(a, b, D2)):
            for i in range(NPTS):
                x, y, z, t = (fe.limbs_to_int(c[i].tolist()) % P for c in (X, Y, Z, T))
                assert x == 0 == t and y == z != 0


def test_table_build_is_the_plain_versions():
    """The kernel's table: the identity, -A, then the two-lane doubling of
    entry j/2 for even j and the two-lane full add of -A for odd j, in
    cached form, equals ``ladder_point_ref``'s table entry for entry, on
    seeded keys."""
    rng = np.random.default_rng(65)
    pubs = np.stack([np.frombuffer(ted.gen_privkey(rng.bytes(32))[32:], np.uint8)
                     for _ in range(16)])
    neg_ax, ay, valid = ec._decompress_valset(pubs)
    assert valid.all()
    ax, ay = (torch.from_numpy(a.astype(np.int64)) for a in (neg_ax, ay))
    one, zero = fe.const(1, ax), torch.zeros_like(ax)
    a1 = (ax, ay, one, fe.mul(ax, ay))
    plain, lanes = [(zero, one, one, zero), a1], [(zero, one, one, zero), a1]
    for j in range(2, 16):  # the plain version's loop, as ladder_point_ref runs it
        plain.append(ec._pt_double(plain[j // 2]) if j % 2 == 0
                     else ec._pt_add(plain[j - 1], a1, D2))
        lanes.append(ec.pt_double_rounds(lanes[j // 2]) if j % 2 == 0
                     else ec.pt_add_rounds(lanes[j - 1], a1, D2))
    for want, got in zip(plain, lanes):
        for w, g in zip(_cached(want), _cached(got)):
            assert torch.equal(w, g)


# the products of each formula, as unordered operand pairs
FINISH = {("E", "H"), ("F", "G"), ("E", "F"), ("G", "H")}
PRODUCTS = {
    "double": (ec.DOUBLE_ROUNDS, {("X", "X"), ("Y", "Y"), ("Z", "Z"), ("X+Y", "X+Y")} | FINISH),
    "madd": (ec.MADD_ROUNDS, {("Y-X", "ymx"), ("Y+X", "ypx"), ("T", "t2d")} | FINISH),
    "cached": (ec.CACHED_ROUNDS, {("Y-X", "ymx"), ("Y+X", "ypx"), ("T", "t2d"),
                                  ("2Z", "Z2")} | FINISH),
}


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_lane_slots_cover_each_product_once(name):
    rounds, products = PRODUCTS[name]
    assert {tuple(sorted(pr)) for rnd in rounds for pr in rnd} == products
    assert sum(len(rnd) for rnd in rounds) == len(products)
    for round_ in rounds:
        slots = ec.lane_slots(len(round_))
        assert len(slots) == ec.LANES_PER_ROW
        assert sorted(k for lane in slots for k in lane) == list(range(len(round_)))
        # every slot full, but for the odd product of the mixed add's round 1
        assert max(map(len, slots)) - min(map(len, slots)) == len(round_) % 2
        assert max(map(len, slots)) == 2
    if name == "double":  # both slots of round 1 are squares: 55-product bodies
        assert all(a == b for a, b in rounds[0])


def test_slot_products_a_window():
    """8 squaring slots and 16 multiply slots a lane a window (4 doublings,
    a mixed add, a cached add): 2,040 products a lane."""
    rounds = [ec.DOUBLE_ROUNDS] * 4 + [ec.MADD_ROUNDS, ec.CACHED_ROUNDS]
    sq = mul = 0
    for rnds in rounds:
        for rnd in rnds:
            for s in range(max(map(len, ec.lane_slots(len(rnd))))):
                pair = rnd[2 * s: 2 * s + 2]
                if all(a == b for a, b in pair):
                    sq += 1
                else:
                    mul += 1
    assert (sq, mul) == (8, 16)
    assert sq * 55 + mul * 100 == 2040


def _sq_cols(a):
    """The columns of the kernel's 55-product squaring: one product a pair
    i <= j, of the operands premultiplied by ``sq_split``."""
    cols = [0] * fe.NLIMB
    n = 0
    for i in range(fe.NLIMB):
        for j in range(i, fe.NLIMB):
            li, rj = ec.sq_split(i, j)
            cols[(i + j) % fe.NLIMB] += (li * a[i]) * (rj * a[j])
            n += 1
    assert n == 55
    return cols


def test_squaring_columns_equal_multiply_columns():
    rng = np.random.default_rng(63)
    rows = [list(S), list(fe.MASKS), [0] * fe.NLIMB]
    rows += [[int(v) for v in rng.integers(0, np.array(S) + 1)] for _ in range(250)]
    for a in rows:
        assert _sq_cols(a) == fe.bound_mul_cols(a, a)


def test_squaring_operands_fit_32_bits():
    for i in range(fe.NLIMB):
        for j in range(i, fe.NLIMB):
            li, rj = ec.sq_split(i, j)
            assert li in (1, 2) and rj in (1, 2, 19, 38)
            assert li * S[i] < 2**32 and rj * S[j] < 2**32
    # the split matters: 76 on an even limb of the closed set would not fit
    assert 76 * S[0] >= 2**32 and 76 * S[1] < 2**32
    assert max(fe.bound_mul_cols(S, S)) < 2**64


@pytest.mark.parametrize("b", [1, 16, 128, 200, 512, 10_240])
def test_k2_geometry_covers_every_row(b):
    lanes, rpb, blocks, smem = ec.k2_geometry(b)
    assert (lanes, rpb) == (ec.LANES_PER_ROW, ec.K2_ROWS_PER_BLOCK)
    assert blocks == -(-b // rpb)
    assert blocks * rpb >= b and (blocks - 1) * rpb < b
    assert smem <= SMEM_LIMIT
    assert smem == 4 * (ec.NCONSTS + 16 * 4 * ec.NLIMB * rpb)
    threads = lanes * rpb
    assert threads % 32 == 0 and threads <= 1024


def test_k2_geometry_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        ec.k2_geometry(0)


def test_kernel_source_geometry_matches_the_wrapper():
    def const(name):
        return int(re.search(r"constexpr int " + name + r"\s*=\s*(\d+);", SRC).group(1))

    assert const("LPR") == ec.LANES_PER_ROW
    assert const("RPB") == ec.K2_ROWS_PER_BLOCK
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in SRC
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in SRC
    for body in ("__noinline__ Fe fe_sq", "__noinline__ Fe fe_mul",
                 "__noinline__ Fe2 fe_mul2", "__noinline__ Fe2 fe_sq2"):
        assert body in SRC


def test_ladder_into_launches_only_on_cuda():
    b = 8
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    ins = (z(ec.NCONSTS), z(10, b), z(10, b), z(64, b), z(64, b), z(10, b), z(1, b))
    before = ec.launches["ed25519_ladder"]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ec.ladder_into(ins, z(b), z(8, b))
    with pytest.raises(ValueError, match="shape"):
        ec.ladder_into(ins, z(b), z(8, b + 1))
    assert ec.launches["ed25519_ladder"] == before


# one thread a row (the first K2): a window loop 0x10..0x70 that holds one
# inner loop, the 4 doublings 0x20..0x40 with a call of two instructions;
# the additions are inline
ONE_LOOP_SASS = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;
        /*0030*/                   CALL.REL.NOINC 0x00a0 ;
        /*0040*/               @P0 BRA 0x0020 ;
        /*0050*/                   SHFL.BFLY PT, R5, R4, 0x1, 0x1f ;
        /*0060*/                   LDS R6, [R7] ;
        /*0070*/               @P3 BRA 0x0010 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x0090;
        /*00a0*/                   IMAD R9, R9, R9, RZ ;
        /*00b0*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_window_mix_counts_k2_loop_shapes():
    """The compare tool tries K2's loop shapes in turn (``k2_compare.K2``):
    the tree's kernel has K3's (4 doublings, then 2 additions), one thread
    a row only the doubling loop."""
    mix = k3_compare.window_mix(ONE_LOOP_SASS, (4,))
    assert mix == {"alu": 1, "imad_wide": 4, "imad": 4, "control": 4 * 3 + 1,
                   "shfl": 1, "memory": 1}
    assert k3_compare.window_mix(ONE_LOOP_SASS, (4, 2)) is None
    assert k3_compare.window_mix(ONE_LOOP_SASS) is None  # K3's shape by default
