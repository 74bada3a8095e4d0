// K3: the secp256k1 ECDSA double-scalar ladder, R = u1 G + u2 Q, and the
// inversion-free check of x(R) against r. Two adjacent lanes of a warp serve
// one signature row; a block of one warp serves 16 rows.
//
// Replaces: tendermint_tpu/ops/secp256k1_pallas.py::_ladder_kernel (launched
// by _ladder_call; math in ladder_math, pt_add and _build_g_table).
//
// What bounds it on the H100: integer instructions. Each row does 3,254
// field multiplications, 512 squarings and 542 multiplications by b3 = 21
// (secp256k1_cuda.ladder_fe_ops): about 359k products of 32x32 -> 64 bits
// (IMAD.WIDE, which an H100 SM retires at about 30 a clock against 64 for
// 32-bit instructions: ops/imad_probe.py) at 100 a multiplication, 55 a
// squaring and 10 a small multiplication, and beside them the 32-bit
// instructions of the carries, the fold, the additions, the operand selects
// and the exchanges between a row's lanes. It reads and writes under 900
// bytes a row. The field is ten 26-bit limbs (libsecp256k1's field_10x26,
// ops/fe_secp256k1.py) with 64-bit column sums, instead of the TPU's twenty
// 13-bit limbs; the product's high columns are carried down to limb width
// and then folded by 2^260 = 0x1000003D10 (mod p) in two parts, 0x3D10 at
// the same limb and 0x400 one limb up, so no 64-bit column is ever
// multiplied by the 2^36-size fold constant. Additions are
// Renes-Costello-Batina 2016 algorithm 7 (complete, a = 0); doublings its
// algorithm 9.
//
// What the design does about it:
//  * Two lanes a row. A commit has 10,000 signatures, so one thread a row
//    leaves most of the card idle and nothing hides a dependent multiply.
//    The two lanes of a row split each point formula's independent
//    products: an addition is two rounds of six, three a lane; a doubling
//    two rounds of four, two a lane (secp256k1_cuda.ADD_ROUNDS /
//    DOUBLE_ROUNDS: lane q computes product 2 s + q of a round in slot s).
//    A warp runs every instruction for all of its lanes, so the products
//    are paired so that each lane computes only the linear values (sums,
//    differences, x21 steps) its own next products read, with the two
//    lanes' different formulas written as one instruction stream: operands
//    picked by lane, and a - b as a + (2p - b). The lanes trade single
//    values with __shfl_xor_sync; both end each formula holding the whole
//    point.
//  * A slot whose products are all squares (the doubling's Y^2 | Z^2) uses
//    the 55-product squaring (the squares and the doubled cross terms). Its
//    columns are the same integers as the 100-product multiply's, so the
//    fold that follows is unchanged.
//  * The products are out of line, and a lane's two independent products of
//    a round go through one body (fe_mul2) so that their multiplies
//    interleave; inlining them measured slower. The window loops stay
//    rolled.
//  * The fold runs on 32-bit words wherever fe_secp256k1's bounds allow,
//    with explicit wide multiply-adds and funnel shifts.
//  * The per-row table [0..15]Q is built by the row's lanes and kept in
//    dynamic shared memory, laid out [entry][word][row] so that the rows of
//    a warp read different banks whatever their digits. The constant table
//    [0..15]G sits in front of it, laid out [word][entry], so that
//    different digits read different banks too. Digits pick table entries
//    by direct indexing: keys and digits are public, so the TPU's 16-way
//    masked select is not needed.
//  * Rows past b (the last block's ragged edge) compute row b - 1 again,
//    so that both lanes of every pair take part in the exchanges, and write
//    nothing.
// The check X = r Z or X = (r + n) Z needs no inversion; lanes 0 and 1 of
// the row compute the two products and lane 0 writes ok, X and Z.
//
// Every product is the same integer as in the plain version
// (secp256k1_cuda.ladder_point_ref, ladder_ref over fe_secp256k1.py; the
// lane schedule is secp256k1_cuda.pt_add_rounds / pt_double_rounds), so
// every intermediate is; the overflow bounds are certified by
// fe_secp256k1.certify().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 10;
constexpr int PTW = 3 * NL;              // words of a projective point
constexpr int NCONSTS = 16 * PTW;        // [0..15]G: X, Y, Z limbs per entry
constexpr int LPR = 2;                   // lanes that serve one row
constexpr int RPB = 16;                  // rows a block serves
constexpr int THREADS = LPR * RPB;
constexpr int TABLE_WORDS = 16 * PTW * RPB;  // [0..15]Q of the block's rows
constexpr int SMEM_BYTES = (NCONSTS + TABLE_WORDS) * 4;
// blocks an SM can hold by shared memory (228 KB, 1 KB reserved a block);
// the register budget is set so that as many fit
constexpr int MIN_BLOCKS = 233472 / (SMEM_BYTES + 1024);
constexpr unsigned FULL = 0xffffffffu;
static_assert(LPR == 2, "the exchanges pair two lanes");

constexpr uint32_t M26 = (1u << 26) - 1;
constexpr uint32_t M22 = (1u << 22) - 1;
constexpr uint32_t TOP_LO = 0x3D1, TOP_HI = 0x40;  // 2^256 mod p
constexpr uint32_t FOLD_LO = 0x3D10, FOLD_HI = 0x400;  // 2^260 mod p
constexpr uint32_t FOLD19_LO = 0xF44000, FOLD19_HI = 0x100000;  // 0x400 * 2^260
constexpr uint32_t B3 = 21;

// 2p spread over the limbs (fe_secp256k1.K_SUB)
__constant__ uint32_t KSUB[NL] = {0x7FFF85E, 0x7FFFF7E, 0x7FFFFFE, 0x7FFFFFE,
                                  0x7FFFFFE, 0x7FFFFFE, 0x7FFFFFE, 0x7FFFFFE,
                                  0x7FFFFFE, 0x7FFFFE};

__device__ __forceinline__ int width(int i) { return i == NL - 1 ? 22 : 26; }
__device__ __forceinline__ uint32_t lmask(int i) { return i == NL - 1 ? M22 : M26; }

struct Fe {
  uint32_t v[NL];
};

struct Pt {  // projective (X:Y:Z)
  Fe X, Y, Z;
};

// one parallel carry pass; the carry out of limb 9 weighs 2^256
__device__ __forceinline__ void carry_par(const uint32_t t[NL], uint32_t o[NL]) {
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = t[i] >> width(i);
  o[0] = (t[0] & M26) + TOP_LO * c[9];
  o[1] = (t[1] & M26) + c[0] + TOP_HI * c[9];
#pragma unroll
  for (int i = 2; i < NL; ++i) o[i] = (t[i] & lmask(i)) + c[i - 1];
}

__device__ __forceinline__ Fe fe_carried(const uint32_t t[NL]) {
  Fe o;
  carry_par(t, o.v);
  return o;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i] + b.v[i];
  return fe_carried(t);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i] + KSUB[i] - b.v[i];
  return fe_carried(t);
}

__device__ __forceinline__ Fe fe_mul_b3(const Fe& a) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = B3 * a.v[i];
  return fe_carried(t);
}

// r + a b as a 32x32 -> 64-bit multiply-add
__device__ __forceinline__ uint64_t madw(uint32_t a, uint32_t b, uint64_t r) {
  uint64_t o;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(o) : "r"(a), "r"(b), "l"(r));
  return o;
}

// bits [s, s + 32) of a 64-bit word (one funnel shift)
__device__ __forceinline__ uint32_t shr64(uint64_t x, int s) {
  return __funnelshift_r((uint32_t)x, (uint32_t)(x >> 32), s);
}

// the 19 product columns c[0..18] -> carried limbs: one parallel 26-bit
// pass over the 20 columns brings every column to limb width, then column
// k >= 10 folds by 0x3D10 at k - 10 and 0x400 at k - 9; two carry passes.
// Only the columns and the folded limbs need 64 bits: by fe_secp256k1's
// bounds d_k < 2^30, r_k < 2^44, and after the first carry pass every limb
// and carry is below 2^28, so the rest runs on 32-bit words (the same
// integers as the plain version's int64 schedule).
__device__ __forceinline__ Fe fe_fold(const uint64_t c[2 * NL]) {
  uint32_t d[2 * NL];
  d[0] = (uint32_t)c[0] & M26;
#pragma unroll
  for (int k = 1; k < 2 * NL - 1; ++k) d[k] = ((uint32_t)c[k] & M26) + shr64(c[k - 1], 26);
  d[2 * NL - 1] = shr64(c[2 * NL - 2], 26);
  uint64_t r[NL];
  r[0] = madw(d[19], FOLD19_LO, madw(d[10], FOLD_LO, d[0]));
  r[1] = madw(d[19], FOLD19_HI,
              madw(d[10], FOLD_HI, madw(d[11], FOLD_LO, d[1])));
#pragma unroll
  for (int k = 2; k < NL; ++k)
    r[k] = madw(d[k + 9], FOLD_HI, madw(d[k + 10], FOLD_LO, d[k]));
  uint32_t cr[NL], o[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) cr[i] = shr64(r[i], width(i));
  o[0] = ((uint32_t)r[0] & M26) + TOP_LO * cr[9];
  o[1] = ((uint32_t)r[1] & M26) + cr[0] + TOP_HI * cr[9];
#pragma unroll
  for (int i = 2; i < NL; ++i) o[i] = ((uint32_t)r[i] & lmask(i)) + cr[i - 1];
  return fe_carried(o);
}

// The products are out of line: one copy of each body keeps the window
// loop's code small; the operands travel in registers, by value.
__device__ __noinline__ Fe fe_mul(Fe a, Fe b) {
  uint64_t c[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += (uint64_t)a.v[i] * b.v[j];
  }
  return fe_fold(c);
}

struct Fe2 {
  Fe x, y;
};

// two independent products in one body, so that their multiplies interleave
__device__ __noinline__ Fe2 fe_mul2(Fe a0, Fe b0, Fe a1, Fe b1) {
  uint64_t c0[2 * NL], c1[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c0[k] = c1[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c0[i + j] += (uint64_t)a0.v[i] * b0.v[j];
      c1[i + j] += (uint64_t)a1.v[i] * b1.v[j];
    }
  }
  Fe2 o;
  o.x = fe_fold(c0);
  o.y = fe_fold(c1);
  return o;
}

// 55 products: the ten squares and the doubled cross terms (2 a_i < 2^28
// for carried limbs); every column is the same integer as fe_mul(a, a)'s
__device__ __noinline__ Fe fe_sq(Fe a) {
  uint32_t a2[NL];
  uint64_t c[2 * NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) a2[i] = a.v[i] << 1;
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c[2 * i] += (uint64_t)a.v[i] * a.v[i];
#pragma unroll
    for (int j = i + 1; j < NL; ++j) c[i + j] += (uint64_t)a2[i] * a.v[j];
  }
  return fe_fold(c);
}

__device__ __forceinline__ Fe fe_sel(bool c, const Fe& a, const Fe& b) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = c ? a.v[i] : b.v[i];
  return o;
}

__device__ __forceinline__ void seq_carry(uint32_t x[NL], bool fold) {
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    const uint32_t c = x[i] >> 26;
    x[i] &= M26;
    x[i + 1] += c;
  }
  if (fold) {
    const uint32_t c = x[9] >> 22;
    x[9] &= M22;
    x[0] += TOP_LO * c;
    x[1] += TOP_HI * c;
  }
}

// carried -> exact-width limbs of the value mod p (fe_secp256k1.canonical)
__device__ Fe fe_canonical(const Fe& a) {
  Fe x = a;
  for (int r = 0; r < 3; ++r) seq_carry(x.v, true);
  Fe t = x;
  t.v[0] += TOP_LO;
  t.v[1] += TOP_HI;
  seq_carry(t.v, false);
  const bool ge = (t.v[9] >> 22) != 0;
  t.v[9] &= M22;
  return ge ? t : x;
}

__device__ bool fe_is_zero(const Fe& a) {
  const Fe c = fe_canonical(a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= c.v[i];
  return acc == 0;
}

// the same value from the row's other lane
__device__ __forceinline__ Fe other(const Fe& a) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = __shfl_xor_sync(FULL, a.v[i], 1);
  return o;
}

// a + b, or a - b (a + (2p - b)) where neg, carried: the words of fe_add or
// fe_sub, so that the two lanes of a row run one instruction stream
__device__ __forceinline__ Fe fe_add_or_sub(const Fe& a, const Fe& b, bool neg) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i] + (neg ? KSUB[i] - b.v[i] : b.v[i]);
  return fe_carried(t);
}

// RCB16 algorithm 7: complete addition, a = 0. Lane 0 | lane 1 of a row
// compute, in round 1, t0 | t2, t1 | m5 and m3 | m4 (m3 = (X1+Y1)(X2+Y2),
// m4 = (Y1+Z1)(Y2+Z2), m5 = (X1+Z1)(X2+Z2)); then t3 | t4 and z3 | t1'; in
// round 2, t3 t1' | t4 y3b, t1' z3 | z3 t4 and t0x3 t3 | y3b t0x3. Each
// exchange trades one value with the other lane.
__device__ __forceinline__ Pt pt_add(const Pt& p, const Pt& r, bool lane1) {
  const Fe a0 = fe_sel(lane1, p.Z, p.X), b0 = fe_sel(lane1, r.Z, r.X);
  const Fe a1 = fe_sel(lane1, fe_add(p.X, p.Z), p.Y);
  const Fe b1 = fe_sel(lane1, fe_add(r.X, r.Z), r.Y);
  const Fe2 m01 = fe_mul2(a0, b0, a1, b1);
  const Fe m2 = fe_mul(fe_add(p.Y, a0), fe_add(r.Y, b0));
  const Fe o0 = other(m01.x), o1 = other(m01.y);
  const Fe t0 = fe_sel(lane1, o0, m01.x), t2 = fe_sel(lane1, m01.x, o0);
  const Fe t1 = fe_sel(lane1, o1, m01.y), m5 = fe_sel(lane1, m01.y, o1);
  const Fe u1 = fe_sub(m2, fe_add(t1, m01.x));  // t3 | t4
  const Fe t2b = fe_mul_b3(t2);
  const Fe u2 = fe_add_or_sub(t1, t2b, lane1);  // z3 | t1'
  const Fe y3b = fe_mul_b3(fe_sub(m5, fe_add(t0, t2)));
  const Fe t0x3 = fe_add(fe_add(t0, t0), t0);
  const Fe ou = other(u2);  // t1' | z3
  const Fe2 n01 = fe_mul2(u1, fe_sel(lane1, y3b, ou), ou, fe_sel(lane1, u1, u2));
  const Fe n2 = fe_mul(t0x3, fe_sel(lane1, y3b, u1));
  // X3 = t3 t1' - t4 y3b, Y3 = y3b t0x3 + t1' z3, Z3 = z3 t4 + t0x3 t3
  Fe sx;
#pragma unroll
  for (int i = 0; i < NL; ++i) sx.v[i] = lane1 ? KSUB[i] - n01.x.v[i] : n01.x.v[i];
  const Fe sy = fe_sel(lane1, n2, n01.y), sz = fe_sel(lane1, n01.y, n2);
  Pt o;
  o.X = fe_add(sx, other(sx));
  o.Y = fe_add(sy, other(sy));
  o.Z = fe_add(sz, other(sz));
  return o;
}

// RCB16 algorithm 9: complete doubling, a = 0. Lane 0 | lane 1 of a row
// compute, in round 1, Y^2 | Z^2 and Y Z | X Y; then z3 = 8 t0 | t0' =
// t0 - 3 t2 by the same three steps; in round 2, t2 z3 | t0' y3 and
// t1 z3 | t0' XY.
__device__ __forceinline__ Pt pt_double(const Pt& p, bool lane1) {
  const Fe s0 = fe_sq(fe_sel(lane1, p.Z, p.Y));                          // Y^2 | Z^2
  const Fe s1 = fe_mul(fe_sel(lane1, p.X, p.Y), fe_sel(lane1, p.Y, p.Z));  // Y Z | X Y
  const Fe o0 = other(s0);
  const Fe t0 = fe_sel(lane1, o0, s0);
  const Fe t2 = fe_mul_b3(fe_sel(lane1, s0, o0));
  const Fe w = fe_sel(lane1, t2, t0);
  const Fe v1 = fe_add(w, w);                                  // 2 t0 | 2 t2
  const Fe v2 = fe_add(v1, fe_sel(lane1, t2, v1));             // 4 t0 | 3 t2
  const Fe v3 = fe_add_or_sub(fe_sel(lane1, t0, v2), v2, lane1);  // z3 | t0'
  const Fe y3 = fe_add(t0, t2);
  const Fe2 n = fe_mul2(v3, fe_sel(lane1, y3, t2), v3, s1);
  // X3 = 2 t0' XY, Y3 = t2 z3 + t0' y3, Z3 = t1 z3
  const Fe o1 = other(n.y);
  const Fe xy = fe_sel(lane1, n.y, o1);
  Pt o;
  o.X = fe_add(xy, xy);
  o.Y = fe_add(n.x, other(n.x));
  o.Z = fe_sel(lane1, o1, n.y);
  return o;
}

__device__ __forceinline__ Fe load_fe(const uint32_t* src, int stride) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = src[i * stride];
  return o;
}

__device__ __forceinline__ uint32_t pt_word(const Pt& p, int w) {
  return w < NL ? p.X.v[w] : w < 2 * NL ? p.Y.v[w - NL] : p.Z.v[w - 2 * NL];
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ladder_kernel(const uint32_t* __restrict__ consts, const uint32_t* __restrict__ qx,
              const uint32_t* __restrict__ qy, const uint32_t* __restrict__ dig1,
              const uint32_t* __restrict__ dig2, const uint32_t* __restrict__ rl,
              const uint32_t* __restrict__ rnl, const uint32_t* __restrict__ rnok,
              uint32_t* __restrict__ ok, uint32_t* __restrict__ out_x,
              uint32_t* __restrict__ out_z, int b, int nwin) {
  // smem[w * 16 + j]: word w of [j]G; smem[NCONSTS + (j * PTW + w) * RPB + row]:
  // word w of the block row's [j]Q
  extern __shared__ uint32_t smem[];
  for (int i = threadIdx.x; i < NCONSTS; i += THREADS) smem[(i % PTW) * 16 + i / PTW] = consts[i];
  __syncthreads();
  const int q = threadIdx.x % LPR;
  const int lr = threadIdx.x / LPR;
  const int row = blockIdx.x * RPB + lr;
  const bool live = row < b;
  const int r = live ? row : b - 1;
  uint32_t* tq = smem + NCONSTS + lr;

  Fe zero, one;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    zero.v[i] = 0;
    one.v[i] = i == 0 ? 1u : 0u;
  }
  Pt acc;
  acc.X = zero;
  acc.Y = one;
  acc.Z = zero;
  const Pt ident = acc;
  Pt qp;  // the row's key Q
  qp.X = load_fe(qx + r, b);
  qp.Y = load_fe(qy + r, b);
  qp.Z = one;

  // per-row table [0..15]Q by complete additions through the identity; the
  // row's lanes share the writes
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    if (j > 0) acc = pt_add(acc, qp, q != 0);
#pragma unroll
    for (int w = 0; w < PTW; ++w) {
      if (w % LPR == q) tq[(j * PTW + w) * RPB] = pt_word(acc, w);
    }
  }
  __syncwarp();

  acc = ident;
#pragma unroll 1
  for (int t = 0; t < nwin; ++t) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) acc = pt_double(acc, q != 0);
    const int d1 = dig1[t * b + r] & 15u, d2 = dig2[t * b + r] & 15u;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const uint32_t* e = h == 0 ? smem + d1 : tq + d2 * PTW * RPB;
      const int stride = h == 0 ? 16 : RPB;
      Pt g;
      g.X = load_fe(e, stride);
      g.Y = load_fe(e + NL * stride, stride);
      g.Z = load_fe(e + 2 * NL * stride, stride);
      acc = pt_add(acc, g, q != 0);
    }
  }

  // x(R) = r (mod n) iff X = r Z or X = (r + n) Z (mod p), Z != 0: lane 0
  // checks r, lane 1 r + n
  const bool eq_mine =
      fe_is_zero(fe_sub(acc.X, fe_mul(load_fe((q == 0 ? rl : rnl) + r, b), acc.Z)));
  const bool eq_other = __shfl_xor_sync(FULL, (int)eq_mine, 1) != 0;
  if (live && q == 0) {
    ok[r] = (!fe_is_zero(acc.Z) && (eq_mine || (eq_other && rnok[r] != 0))) ? 1u : 0u;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      out_x[i * b + r] = acc.X.v[i];
      out_z[i * b + r] = acc.Z.v[i];
    }
  }
}

}  // namespace

// The geometry comes from the caller (secp256k1_cuda.k3_geometry) and must
// be the one this build serves; the dynamic shared memory limit is raised
// once per device.
extern "C" int secp256k1_ladder_launch(const void* consts, const void* qx,
                                       const void* qy, const void* dig1,
                                       const void* dig2, const void* rl,
                                       const void* rnl, const void* rnok, void* ok,
                                       void* out_x, void* out_z, int b, int nwin,
                                       int lanes_per_row, int rows_per_block, int blocks,
                                       int smem_bytes, void* stream) {
  if (lanes_per_row != LPR || rows_per_block != RPB || smem_bytes != SMEM_BYTES || b <= 0 ||
      nwin <= 0 || (long long)blocks * RPB < b || (long long)(blocks - 1) * RPB >= b)
    return (int)cudaErrorInvalidValue;
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(ladder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  ladder_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)consts, (const uint32_t*)qx, (const uint32_t*)qy,
      (const uint32_t*)dig1, (const uint32_t*)dig2, (const uint32_t*)rl,
      (const uint32_t*)rnl, (const uint32_t*)rnok, (uint32_t*)ok, (uint32_t*)out_x,
      (uint32_t*)out_z, b, nwin);
  return (int)cudaGetLastError();
}
