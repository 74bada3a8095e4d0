// K2: the Ed25519 double-scalar ladder, R' = [s]B + [h](-A), then Z^-1 and
// the canonical encoding of R'. Two adjacent lanes of a warp serve one
// signature row; a block of one warp serves 16 rows.
//
// Replaces: tendermint_tpu/ops/ed25519_pallas.py::_ladder_kernel (launched by
// _ladder_call; math in ladder_math and the point ops above it).
//
// What bounds it on the H100: integer instructions. Each row does 2,105
// field multiplications and 1,306 squarings (ed25519_cuda.ladder_fe_ops):
// about 282k products of 32x32 -> 64 bits (IMAD.WIDE, which an H100 SM
// retires at about 30 a clock against 64 for 32-bit instructions:
// ops/imad_probe.py) at 100 a multiplication and 55 a squaring, and beside
// them the 32-bit instructions of the carries, the additions, the operand
// selects and the exchanges between a row's lanes. It reads and writes
// under 700 bytes a row. Hopper multiplies 32x32 -> 64 natively and
// emulates 64x64 -> 128, so the field uses ten 32-bit limbs in radix 2^25.5
// (ops/fe.py) with 64-bit column sums instead of the TPU's twenty 13-bit
// limbs.
//
// What the design does about it:
//  * Two lanes a row. A commit has 10,000 signatures, so one thread a row
//    leaves most of the card idle and nothing hides a dependent multiply.
//    The two lanes of a row split each point formula's independent
//    products (ed25519_cuda.DOUBLE_ROUNDS / MADD_ROUNDS / CACHED_ROUNDS:
//    lane q computes product 2 s + q of a round in slot s): a doubling is
//    two squarings and then two products a lane, either add two products
//    and two products. Per window a lane runs 8 squaring slots and 16
//    multiply slots, 2,040 products, against 4,700 a row on one thread.
//    A warp runs every instruction for all of its lanes, so each lane
//    computes only the linear values its own next products read, with the
//    two lanes' different steps written as one instruction stream
//    (operands picked by lane, a - b as a + (2p - b)); the lanes trade
//    single values with __shfl_xor_sync. After every formula lane 0 holds
//    X, T, Y and lane 1 Z, Y, T, which is what every formula reads first.
//    The mixed add runs through the cached add's body: lane 1 keeps 2Z in
//    place of its second product of round 1.
//  * Squarings use 55 products: the ten squares and the 45 cross terms,
//    with the factors 2, 2 (odd x odd limbs) and 19 (wrapped columns)
//    split between the two 32-bit operands (ed25519_cuda.sq_split: 1 or 2
//    on the left, 1, 2, 19 or 38 on the right; 76 on an even limb would
//    overflow). Its columns are the same integers as the 100-product
//    multiply's, so the carry that follows is unchanged.
//  * The products are out of line, and a lane's two independent products of
//    a round go through one body (fe_mul2, fe_sq2) so that their multiplies
//    interleave; the loops stay rolled.
//  * The per-row table [0..15](-A) is built by the row's lanes as the plain
//    version builds it (the identity, -A, then 2 [j/2](-A) for even j and
//    [j-1](-A) + (-A) by the full add for odd j; the full add is the cached
//    add's first round with one more product on lane 1,
//    ed25519_cuda.pt_add_rounds), converted to cached form (Y+X, Y-X, Z,
//    2d T), and kept in dynamic shared memory, laid out [entry][word][row]
//    so that the rows of a warp read different banks whatever their
//    digits. The constant niels table [0..15]B and 2d sit in front of it,
//    laid out [word][entry], so that different digits read different banks
//    too. Digits pick table entries by direct indexing: keys and digits are
//    public, so the TPU's 16-way masked select is not needed.
//  * Rows past b (the last block's ragged edge) compute row b - 1 again,
//    so that both lanes of every pair take part in the exchanges, and write
//    nothing.
// The epilogue (Z^-1 by 254 squarings and 11 multiplications) runs on both
// lanes; lane 0 | lane 1 then compute X Z^-1 | Y Z^-1 in one slot, and lane
// 0 writes ok and the encoding.
//
// Every product is the same integer as in the plain version
// (ed25519_cuda.ladder_point_ref, ladder_ref over fe.py; the lane schedule
// is ed25519_cuda.pt_double_rounds / pt_madd_rounds / pt_add_cached_rounds /
// pt_add_rounds), so every intermediate is, and the table is the plain
// version's entry for entry; the overflow bounds are certified by
// fe.certify().

#include <cstdint>
#include <cuda_runtime.h>

#include "ed25519_field.cuh"

namespace {

constexpr int NIELS_W = 3 * NL;             // words of a niels entry (ypx, ymx, t2d)
constexpr int NCONSTS = 16 * NIELS_W + NL;  // niels table [0..15]B, then 2d
constexpr int CW = 4 * NL;                  // words of a table entry
constexpr int LPR = 2;                      // lanes that serve one row
constexpr int RPB = 16;                     // rows a block serves
constexpr int THREADS = LPR * RPB;
constexpr int TABLE_WORDS = 16 * CW * RPB;  // [0..15](-A) of the block's rows
constexpr int SMEM_BYTES = (NCONSTS + TABLE_WORDS) * 4;
// blocks an SM can hold by shared memory (228 KB, 1 KB reserved a block);
// the register budget is set so that as many fit
constexpr int MIN_BLOCKS = 233472 / (SMEM_BYTES + 1024);
constexpr unsigned FULL = 0xffffffffu;
static_assert(LPR == 2, "the exchanges pair two lanes");

// word offsets of an entry's coordinates: a niels entry (ypx, ymx, t2d); a
// table entry extended (X, Y, Z, T) while the table is built, then cached
// (ypx, ymx, Z, t2d) in place
constexpr int YPX = 0, YMX = NL, N_T2D = 2 * NL;
constexpr int E_X = 0, E_Y = NL, E_Z = 2 * NL, E_T = 3 * NL;
constexpr int C_Z = E_Z, C_T2D = E_T;

struct Fe2 {
  Fe x, y;
};

// A row's extended point (X:Y:Z:T) as its two lanes hold it: lane 0 X, Y,
// T and lane 1 Z, Y, T (u is X on lane 0, Z on lane 1)
struct LanePt {
  Fe u, y, t;
};

// a + b, or a - b (a + (2p - b)) where neg, carried: the words of fe_add or
// fe_sub, so that the two lanes of a row run one instruction stream
__device__ __forceinline__ Fe fe_add_or_sub(const Fe& a, const Fe& b, bool neg) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i] + (neg ? ksub(i) - b.v[i] : b.v[i]);
  return carry_par(t);
}

// two independent products in one body, so that their multiplies interleave
__device__ __noinline__ Fe2 fe_mul2(Fe a0, Fe b0, Fe a1, Fe b1) {
  uint64_t h0[NL] = {}, h1[NL] = {};
  mul_cols(a0, b0, h0);
  mul_cols(a1, b1, h1);
  Fe2 o;
  o.x = fe_carry(h0);
  o.y = fe_carry(h1);
  return o;
}

__device__ __noinline__ Fe2 fe_sq2(Fe a0, Fe a1) {
  uint64_t h0[NL] = {}, h1[NL] = {};
  sq_cols(a0, h0);
  sq_cols(a1, h1);
  Fe2 o;
  o.x = fe_carry(h0);
  o.y = fe_carry(h1);
  return o;
}

__device__ Fe fe_sqn(Fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = fe_sq(a);
  return a;
}

// z^(p-2), ref10's chain (fe.inv)
__device__ Fe fe_inv(const Fe& z) {
  Fe t0 = fe_sq(z);
  Fe t1 = fe_mul(z, fe_sqn(t0, 2));
  t0 = fe_mul(t0, t1);
  t1 = fe_mul(t1, fe_sq(t0));
  t1 = fe_mul(fe_sqn(t1, 5), t1);
  Fe t2 = fe_mul(fe_sqn(t1, 10), t1);
  t2 = fe_mul(fe_sqn(t2, 20), t2);
  t1 = fe_mul(fe_sqn(t2, 10), t1);
  t2 = fe_mul(fe_sqn(t1, 50), t1);
  t2 = fe_mul(fe_sqn(t2, 100), t2);
  t1 = fe_mul(fe_sqn(t2, 50), t1);
  return fe_mul(fe_sqn(t1, 5), t0);
}

__device__ __forceinline__ Fe fe_sel(bool c, const Fe& a, const Fe& b) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = c ? a.v[i] : b.v[i];
  return o;
}

// the same value from the row's other lane
__device__ __forceinline__ Fe other(const Fe& a) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = __shfl_xor_sync(FULL, a.v[i], 1);
  return o;
}

// Round 2 of every formula. Lane 0 holds first = E, second = H, oth = F;
// lane 1 first = F, second = G, oth = H. Lane 0 | lane 1 compute E H, E F |
// G F, G H (T3, X3 | Z3, Y3), then trade T3 | Y3.
__device__ __forceinline__ LanePt last_round(const Fe& first, const Fe& second,
                                             const Fe& oth, bool lane1) {
  const Fe m = fe_sel(lane1, second, first);
  const Fe2 p = fe_mul2(m, fe_sel(lane1, first, second), m, oth);
  const Fe o = other(fe_sel(lane1, p.y, p.x));
  LanePt r;
  r.u = fe_sel(lane1, p.x, p.y);
  r.y = fe_sel(lane1, p.y, o);
  r.t = fe_sel(lane1, o, p.x);
  return r;
}

// extended doubling (ed25519_cuda._pt_double) of the point whose u and y
// the lane holds. Lane 0 | lane 1 square X, X+Y | Y, Z; they trade
// A = X^2 | B = Y^2, form G = A - B and H = A + B, then E = H - S |
// F = 2 Z^2 + G, and trade E | F.
__device__ __forceinline__ LanePt pt_double(const Fe& u, const Fe& y, bool lane1) {
  const Fe s = fe_add(u, y);
  const Fe2 m = fe_sq2(fe_sel(lane1, y, u), fe_sel(lane1, u, s));
  const Fe o = other(m.x);
  const Fe A = fe_sel(lane1, o, m.x), B = fe_sel(lane1, m.x, o);
  const Fe G = fe_sub(A, B), H = fe_add(A, B);
  const Fe v = fe_add_or_sub(fe_sel(lane1, G, H), fe_sel(lane1, fe_add(m.y, m.y), m.y), !lane1);
  return last_round(v, fe_sel(lane1, G, H), fe_sel(lane1, H, other(v)), lane1);
}

// Additions (ed25519_cuda._pt_add_cached, _pt_madd, _pt_add) of a point
// whose operands b0, b1 the lane has loaded. Lane 0 | lane 1 compute
// (Y-X) b0, (Y+X) b1 | T b0, 2Z b1:
//  * cached add: b0, b1 = ymx, ypx | t2d, Z2;
//  * mixed add (madd: a niels entry, Z2 = 1): lane 1 keeps 2Z in place of
//    its second product;
//  * full add (full, the table's [j-1](-A) + (-A)): b0, b1 = Y2-X2, Y2+X2 |
//    2d, Z2, and lane 1 multiplies T 2d by T2 in one more slot.
// Then E = B - A, H = B + A | F = D - C, G = D + C, and they trade H | F.
__device__ __forceinline__ LanePt pt_add(const LanePt& p, const Fe& b0, const Fe& b1,
                                         bool madd, bool full, const Fe& t2, bool lane1) {
  const Fe x1 = fe_add(fe_sel(lane1, p.u, p.y), p.u);
  Fe2 m = fe_mul2(fe_sel(lane1, p.t, fe_sub(p.y, p.u)), b0, x1, b1);
  if (full) m.x = fe_sel(lane1, fe_mul(m.x, t2), m.x);
  const Fe d = fe_sel(lane1 && madd, x1, m.y);
  const Fe first = fe_sub(d, m.x), second = fe_add(d, m.x);
  return last_round(first, second, other(fe_sel(lane1, first, second)), lane1);
}

__device__ __forceinline__ Fe load_fe(const uint32_t* src, int stride) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = src[i * stride];
  return o;
}

__device__ __forceinline__ void store_fe(uint32_t* dst, const Fe& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) dst[i * RPB] = a.v[i];
}

// a table entry, extended: lane 0 writes X and T, lane 1 Z and Y. The
// select by reference puts the point in local memory for the table (a
// 120-byte stack frame); fe_sel's select by value, with no stack, measured
// about 1 % slower at b = 10,240 (tools/k2_compare.py)
__device__ __forceinline__ void store_ext(uint32_t* e, const LanePt& p, bool lane1) {
  store_fe(e + (lane1 ? E_Z : E_X) * RPB, p.u);
  store_fe(e + (lane1 ? E_Y : E_T) * RPB, lane1 ? p.y : p.t);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ladder_kernel(const uint32_t* __restrict__ consts, const uint32_t* __restrict__ negax,
              const uint32_t* __restrict__ ay, const uint32_t* __restrict__ digs,
              const uint32_t* __restrict__ digh, const uint32_t* __restrict__ rlimb,
              const uint32_t* __restrict__ rsign, uint32_t* __restrict__ ok,
              uint32_t* __restrict__ renc, int b, int nwin) {
  // smem[w * 16 + j]: word w of [j]B's niels entry; smem[16 * NIELS_W + i]:
  // limb i of 2d; smem[NCONSTS + (j * CW + w) * RPB + row]: word w of the
  // block row's [j](-A)
  extern __shared__ uint32_t smem[];
  for (int i = threadIdx.x; i < NCONSTS; i += THREADS)
    smem[i < 16 * NIELS_W ? (i % NIELS_W) * 16 + i / NIELS_W : i] = consts[i];
  __syncthreads();
  const int q = threadIdx.x % LPR;
  const bool lane1 = q != 0;
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
  const uint32_t* d2 = smem + 16 * NIELS_W;

  // per-row table [0..15](-A), extended: the identity, -A = (-x, y, 1, -x y),
  // then 2 [j/2](-A) for even j and [j-1](-A) + (-A) for odd j, the full
  // add reading -A's operands back from entry 1
  LanePt acc;  // the identity (0 : 1 : 1 : 0)
  acc.u = fe_sel(lane1, one, zero);
  acc.y = one;
  acc.t = zero;
  store_ext(tq, acc, lane1);
  {
    const Fe ax = load_fe(negax + r, b);
    acc.u = fe_sel(lane1, one, ax);
    acc.y = load_fe(ay + r, b);
    acc.t = fe_mul(ax, acc.y);
  }
  store_ext(tq + CW * RPB, acc, lane1);
  __syncwarp();
  const uint32_t* neg_a = tq + CW * RPB;
#pragma unroll 1
  for (int j = 2; j < 16; ++j) {
    if (j & 1) {
      // lane 0 | lane 1: Y2 - X2, Y2 + X2 | 2d, Z2 = 1
      const Fe x2 = load_fe(neg_a + E_X * RPB, RPB), y2 = load_fe(neg_a + E_Y * RPB, RPB);
      acc = pt_add(acc, fe_sel(lane1, load_fe(d2, 1), fe_sub(y2, x2)),
                   fe_sel(lane1, one, fe_add(y2, x2)), false, true,
                   load_fe(neg_a + E_T * RPB, RPB), lane1);
    } else {
      const uint32_t* e = tq + (j / 2) * CW * RPB;
      acc = pt_double(load_fe(e + (lane1 ? E_Z : E_X) * RPB, RPB), load_fe(e + E_Y * RPB, RPB),
                      lane1);
    }
    store_ext(tq + j * CW * RPB, acc, lane1);
    __syncwarp();
  }
  // to cached form in place (Y+X over X, Y-X over Y, 2d T over T): lane 0
  // entries 0..7, lane 1 entries 8..15
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    uint32_t* e = tq + (8 * q + k) * CW * RPB;
    const Fe X = load_fe(e + E_X * RPB, RPB), Y = load_fe(e + E_Y * RPB, RPB);
    const Fe t2d = fe_mul(load_fe(e + E_T * RPB, RPB), load_fe(d2, 1));
    store_fe(e + YPX * RPB, fe_add(Y, X));
    store_fe(e + YMX * RPB, fe_sub(Y, X));
    store_fe(e + C_T2D * RPB, t2d);
  }
  __syncwarp();

  acc.u = fe_sel(lane1, one, zero);
  acc.y = one;
  acc.t = zero;
#pragma unroll 1
  for (int t = 0; t < nwin; ++t) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) acc = pt_double(acc.u, acc.y, lane1);
    const int ds = digs[t * b + r] & 15u, dh = digh[t * b + r] & 15u;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const bool madd = h == 0;
      const uint32_t* e = madd ? smem + ds : tq + dh * CW * RPB;
      const int stride = madd ? 16 : RPB;
      const int o0 = lane1 ? (madd ? N_T2D : C_T2D) : YMX;
      const int o1 = (lane1 && !madd) ? C_Z : YPX;  // the niels ypx on lane 1 goes unused
      acc = pt_add(acc, load_fe(e + o0 * stride, stride), load_fe(e + o1 * stride, stride),
                   madd, false, zero, lane1);
    }
  }

  // Z^-1 on both lanes, then x = X Z^-1 | y = Y Z^-1
  const Fe oz = other(acc.u);
  const Fe zinv = fe_inv(fe_sel(lane1, acc.u, oz));
  const Fe c = fe_canonical(fe_mul(fe_sel(lane1, acc.y, acc.u), zinv));
  const Fe y = other(c);
  if (!live || lane1) return;
  const Fe& x = c;
  bool good = (x.v[0] & 1u) == rsign[r];
#pragma unroll
  for (int i = 0; i < NL; ++i) good = good && (y.v[i] == rlimb[i * b + r]);
  ok[r] = good ? 1u : 0u;

  // encoding of R': y | (x & 1) << 255, as 8 little-endian words
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = 0;
  int off = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int wi = off >> 5, sh = off & 31, wd = width(i);
    w[wi] |= y.v[i] << sh;
    if (sh + wd > 32) w[wi + 1] |= y.v[i] >> (32 - sh);
    off += wd;
  }
  w[7] |= (x.v[0] & 1u) << 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) renc[j * b + r] = w[j];
}

}  // namespace

// The geometry comes from the caller (ed25519_cuda.k2_geometry) and must be
// the one this build serves; the dynamic shared memory limit is raised once
// per device.
extern "C" int ed25519_ladder_launch(const void* consts, const void* negax,
                                     const void* ay, const void* digs,
                                     const void* digh, const void* rlimb,
                                     const void* rsign, void* ok, void* renc, int b,
                                     int nwin, int lanes_per_row, int rows_per_block,
                                     int blocks, int smem_bytes, void* stream) {
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
      (const uint32_t*)consts, (const uint32_t*)negax, (const uint32_t*)ay,
      (const uint32_t*)digs, (const uint32_t*)digh, (const uint32_t*)rlimb,
      (const uint32_t*)rsign, (uint32_t*)ok, (uint32_t*)renc, b, nwin);
  return (int)cudaGetLastError();
}
