// K4: one Pippenger multi-scalar multiplication a window, the device half of
// the random-linear-combination (RLC) verify path: the window is accepted iff
//
//   [s_b]B + sum_w 2^(c w) acc_w == identity,  acc_w = sum_{d=1}^{nb} d B_{w,d},
//
// with B_{w,d} the bucket sums of the -A_i and -R_i of its rows, nb = 2^c - 1,
// and the host's schedule (ed25519_msm._build_schedule) resolving every
// data-dependent step into index lists. Three kernels run in order on the
// caller's stream: msm_level (once a tree level), msm_fold (the bucket fold
// and [s_b]B) and msm_finish (Horner, the final addition and the verdict).
//
// Replaces: tendermint_tpu/ops/ed25519_msm.py::_msm_kernel (jitted by
// _compiled_msm, called from _device_rlc). That is XLA code with no Pallas
// inside. It computes the same group element by another schedule: its
// tree levels are the reference's, its fold and [s_b]B are not.
//
// What bounds it on the H100: 32x32 -> 64 products (IMAD.WIDE, about 30 a
// clock an SM: ops/imad_probe.py), 9 field multiplications of 100 products
// each a point addition. The tree does one addition a nonzero digit (about
// 495k at a 10,000-signature commit), over 100 MB of points read and
// written; spread over the card that is some 0.03-0.06 ms. The rest is
// short: 2 (2^c - 1) additions a window in the reference's fold, 279 point
// operations for Horner at c = 8, 320 for [s_b]B. Those are chains of
// dependent operations, so on this card they are bound by the latency of
// one point operation, not by the products.
//
// What the design does about it:
//  * The tree levels fill the card. One thread adds one output row, with
//    the formula inlined and the point in registers (no stack), in at most
//    128 registers, so that an SM holds 16 warps. A block of 128 rows
//    reads its rows' indices in one coalesced load, then stages both
//    operands of its rows in shared memory: ten lanes of a warp carry one
//    160-byte point as 16-byte loads, three points a warp pass, eleven
//    passes in flight before any store; the rows are laid out 41 words
//    apart so that a warp's threads read different banks. The sums go back
//    through shared memory as one contiguous, coalesced run of rows. Every
//    level is its own launch, the small trailing ones too: back to back on
//    one stream a small level costs about one addition's latency, and one
//    block that ran the last three levels of the 10k commit in one launch
//    (__syncthreads between them) saved 0.002-0.005 ms of K4's 0.52
//    (tools/k4_time.py), less than a second level kernel is worth.
//  * The fold is parallel within a window. acc = sum_d d B_d is
//    sum_{t=1}^{nb} S_t with S_t = sum_{d>=t} B_d: one block a window stages
//    its nb buckets in shared memory (255 x 164 bytes at c = 8, twice, to
//    ping-pong), takes the suffix sums by log2(nb + 1) doubling steps
//    (Hillis-Steele: x[t] += x[t + o] for o = 1, 2, 4, ...) and sums the
//    S_t by a pairwise tree, one thread an addition. The chain falls from
//    the reference's 510 dependent additions to 16; the work rises from
//    510 additions a window to 2,039 (1,785 in the scan, 254 in the tree).
//  * [s_b]B leaves the serial chain. A fixed-base comb: 64 tables of the
//    16 niels points [d 16^i]B (ed25519_msm.comb_table, 120 KB, made once
//    from the port's bigints), so [s_b]B is the sum of 64 looked-up points:
//    64 independent mixed additions to the identity, then a pairwise tree
//    of 63 additions, depth 7, in one more block of the fold's launch, so
//    that it runs beside the folds.
//  * Horner keeps its 248 doublings (the top window is multiplied by
//    2^248), so each operation is made shorter: four lanes of one warp
//    share a formula. Every lane holds the point in registers; lane q forms
//    the q-th independent product of a round (a doubling: X^2, Y^2, Z^2,
//    (X+Y)^2, then E F, G H, F G, E H; an addition: (Y1-X1)(Y2-X2),
//    (Y1+X1)(Y2+X2), T1 2d, 2 Z1 Z2, then T1 2d T2 on lane 2, then the same
//    second round) and the four trade their products with __shfl_sync. A
//    doubling is two products deep, an addition three, against eight and
//    nine on one thread.
//
// Field elements are the ten radix-2^25.5 limbs of ops/fe.py, a point is
// (X, Y, Z, T) in 40 consecutive words, and every formula is the plain
// version's (ed25519_cuda._pt_add / _pt_double / _pt_madd over fe.mul,
// fe.sq, fe.add, fe.sub), so every intermediate is the same integer as in
// ed25519_msm.msm_plain, the plain version of this schedule, and the final
// point is equal to it limb for limb. The field code is K2's, from
// ed25519_field.cuh, with its products inlined here.

#include <cstdint>
#include <cuda_runtime.h>

#include "ed25519_field.cuh"

namespace {

constexpr int PW = 4 * NL;            // words of an extended point
constexpr int SW = PW + 1;            // a point's stride in shared memory (odd)
constexpr int X_ = 0, Y_ = NL, Z_ = 2 * NL, T_ = 3 * NL;
constexpr int NIELS_W = 3 * NL;       // words of a niels entry (ypx, ymx, t2d)
constexpr int D2_OFF = 16 * NIELS_W;  // 2d follows the niels table in consts
constexpr int LEVEL_THREADS = 128;    // rows a level block adds
constexpr int LEVEL_MIN_BLOCKS = 4;   // 16 warps an SM: at most 128 registers
constexpr int FOLD_THREADS = 256;
constexpr int MAX_NB = 255;           // buckets a window (c <= 8)
constexpr int SB_DIGITS = 64;         // 4-bit digits of s_b, MSB first
constexpr int COMB_POS_W = 16 * NIELS_W;
constexpr int FOLD_SMEM = 2 * MAX_NB * SW * 4;
constexpr unsigned QUAD = 0xfu;

struct Pt {
  Fe x, y, z, t;
};

__device__ __forceinline__ Fe mul_i(const Fe& a, const Fe& b) {
  uint64_t h[NL] = {};
  mul_cols(a, b, h);
  return fe_carry(h);
}

__device__ __forceinline__ Fe sq_i(const Fe& a) {
  uint64_t h[NL] = {};
  sq_cols(a, h);
  return fe_carry(h);
}

__device__ __forceinline__ Fe ld(const uint32_t* p) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = p[i];
  return o;
}

__device__ __forceinline__ void st(uint32_t* p, const Fe& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) p[i] = a.v[i];
}

__device__ __forceinline__ Pt ld_pt(const uint32_t* p) {
  return Pt{ld(p + X_), ld(p + Y_), ld(p + Z_), ld(p + T_)};
}

__device__ __forceinline__ void copy_pt(uint32_t* d, const uint32_t* s) {
#pragma unroll
  for (int i = 0; i < PW; ++i) d[i] = s[i];
}

// round 2 of every formula, on one thread: (E F, G H, F G, E H) into out
__device__ __forceinline__ void finish_to(const Fe& E, const Fe& F, const Fe& G, const Fe& H,
                                          uint32_t* out) {
  st(out + X_, mul_i(E, F));
  st(out + Y_, mul_i(G, H));
  st(out + Z_, mul_i(F, G));
  st(out + T_, mul_i(E, H));
}

// p + q (_pt_add), both in shared memory, on one thread; out may be p's own
// slot: every read of p comes before the first write
__device__ __forceinline__ void pt_add_to(const uint32_t* p, const uint32_t* q,
                                          const uint32_t* d2, uint32_t* out) {
  const Fe A = mul_i(fe_sub(ld(p + Y_), ld(p + X_)), fe_sub(ld(q + Y_), ld(q + X_)));
  const Fe B = mul_i(fe_add(ld(p + Y_), ld(p + X_)), fe_add(ld(q + Y_), ld(q + X_)));
  const Fe C = mul_i(mul_i(ld(p + T_), ld(d2)), ld(q + T_));
  const Fe D = mul_i(fe_add(ld(p + Z_), ld(p + Z_)), ld(q + Z_));
  finish_to(fe_sub(B, A), fe_sub(D, C), fe_add(D, C), fe_add(B, A), out);
}

// p + the niels entry e (_pt_madd), on one thread
__device__ __forceinline__ void pt_madd_to(const uint32_t* p, const uint32_t* e, uint32_t* out) {
  const Fe A = mul_i(fe_sub(ld(p + Y_), ld(p + X_)), ld(e + NL));
  const Fe B = mul_i(fe_add(ld(p + Y_), ld(p + X_)), ld(e));
  const Fe C = mul_i(ld(p + T_), ld(e + 2 * NL));
  const Fe D = fe_add(ld(p + Z_), ld(p + Z_));
  finish_to(fe_sub(B, A), fe_sub(D, C), fe_add(D, C), fe_add(B, A), out);
}

// Copy `count` points into shared memory, point k (row row_of(k) of rows)
// at sm + k * SW: ten lanes of a warp carry a point as 16-byte loads, three
// points a warp pass, so a warp reads 160 contiguous bytes a point. A lane
// issues STAGE_BATCH loads before it stores any, so that the loads (an
// index, then the point it names) are in flight together.
constexpr int STAGE_BATCH = 11;

template <class RowOf>
__device__ __forceinline__ void stage(uint32_t* sm, const uint32_t* rows, int count,
                                      RowOf row_of) {
  const int lane = threadIdx.x & 31, sub = lane / 10, part = lane - 10 * sub;
  if (sub == 3) return;
  const int step = 3 * (blockDim.x >> 5);
#pragma unroll 1
  for (int k0 = (threadIdx.x >> 5) * 3 + sub; k0 < count; k0 += STAGE_BATCH * step) {
    uint4 v[STAGE_BATCH];
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      const int k = k0 + j * step;
      if (k < count)
        v[j] = reinterpret_cast<const uint4*>(rows + (long long)row_of(k) * PW)[part];
    }
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      const int k = k0 + j * step;
      if (k < count) {
        uint32_t* d = sm + k * SW + 4 * part;
        d[0] = v[j].x;
        d[1] = v[j].y;
        d[2] = v[j].z;
        d[3] = v[j].w;
      }
    }
  }
}

// Rows r0 .. r0 + n - 1 (r0 = blockIdx.x LEVEL_THREADS, n <= LEVEL_THREADS)
// of one tree level: rows[dst + r] = rows[src + ia[r]] + rows[src + ib[r]].
// The block's indices are read first, one coalesced load an operand; the a
// operands are staged at slots 0 .. n - 1, the b operands at n .. 2n - 1;
// thread r writes its sum over its a slot, and the block stores the n sums
// as one run.
__global__ void __launch_bounds__(LEVEL_THREADS, LEVEL_MIN_BLOCKS)
msm_level_kernel(uint32_t* rows, const int32_t* __restrict__ ia,
                 const int32_t* __restrict__ ib, const uint32_t* __restrict__ consts,
                 long long src, long long dst, int m) {
  __shared__ uint32_t sm[2 * LEVEL_THREADS * SW];
  __shared__ int32_t idx[2 * LEVEL_THREADS];
  const int r0 = blockIdx.x * LEVEL_THREADS, n = min(LEVEL_THREADS, m - r0), r = threadIdx.x;
  if (r < n) {
    idx[r] = ia[r0 + r];
    idx[n + r] = ib[r0 + r];
  }
  __syncthreads();
  stage(sm, rows, 2 * n, [&](int k) { return src + idx[k]; });
  __syncthreads();
  if (r < n) pt_add_to(sm + r * SW, sm + (n + r) * SW, consts + D2_OFF, sm + r * SW);
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(rows + (dst + r0) * PW);
  for (int i = threadIdx.x; i < n * (PW / 4); i += LEVEL_THREADS) {
    const int k = i / (PW / 4), part = i - k * (PW / 4);
    const uint32_t* s = sm + k * SW + 4 * part;
    out[i] = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// Sum of the n points at x[0 .. n - 1] by a pairwise tree: y[j] = x[2j] +
// x[2j + 1], an odd last point carried as it is; returns the buffer whose
// slot 0 holds the sum. Every thread of the block calls it.
__device__ __forceinline__ uint32_t* tree_sum(uint32_t* x, uint32_t* y, int n, const uint32_t* d2) {
#pragma unroll 1
  while (n > 1) {
    const int h = (n + 1) / 2;
#pragma unroll 1
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      if (2 * j + 1 < n)
        pt_add_to(x + 2 * j * SW, x + (2 * j + 1) * SW, d2, y + j * SW);
      else
        copy_pt(y + j * SW, x + 2 * j * SW);
    }
    __syncthreads();
    uint32_t* t = x;
    x = y;
    y = t;
    n = h;
  }
  return x;
}

// Blocks 0 .. nwin - 1: window w's acc = sum_{t=1}^{nb} S_t by the suffix
// scan and the tree; block nwin: [s_b]B off the comb. Both end in the one
// tree_sum below (one inlined copy of the addition the fewer).
__global__ void __launch_bounds__(FOLD_THREADS, 1)
msm_fold_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ bkt,
                const int32_t* __restrict__ sb_digs, const uint32_t* __restrict__ consts,
                const uint32_t* __restrict__ comb, uint32_t* __restrict__ acc_out,
                uint32_t* __restrict__ sb_out, int nwin, int nb) {
  extern __shared__ uint32_t fsm[];
  const uint32_t* d2 = consts + D2_OFF;
  uint32_t* x = fsm;
  uint32_t* y = fsm + MAX_NB * SW;
  const int tid = threadIdx.x;
  const bool sb_block = blockIdx.x == nwin;
  int n = nb;
  if (sb_block) {
    // position i = 0 .. 63 weighs 16^i: the identity plus the niels entry
    // [d_i 16^i]B, then the tree over the 64
    if (tid < SB_DIGITS) {
      uint32_t* p = y + tid * SW;
#pragma unroll
      for (int i = 0; i < PW; ++i) p[i] = (i == Y_ || i == Z_) ? 1u : 0u;
      const int d = sb_digs[SB_DIGITS - 1 - tid] & 15;
      pt_madd_to(p, comb + tid * COMB_POS_W + d * NIELS_W, x + tid * SW);
    }
    n = SB_DIGITS;
    __syncthreads();
  } else {
    const int32_t* wb = bkt + (long long)blockIdx.x * nb;
    stage(x, rows, nb, [&](int k) { return wb[k]; });
    __syncthreads();
    // after the step of offset o, x[t] holds buckets t + 1 .. t + 2o (to nb)
#pragma unroll 1
    for (int o = 1; o < nb; o <<= 1) {
#pragma unroll 1
      for (int t = tid; t < nb; t += FOLD_THREADS) {
        if (t + o < nb)
          pt_add_to(x + t * SW, x + (t + o) * SW, d2, y + t * SW);
        else
          copy_pt(y + t * SW, x + t * SW);
      }
      __syncthreads();
      uint32_t* tmp = x;
      x = y;
      y = tmp;
    }
  }
  const uint32_t* s = tree_sum(x, y, n, d2);
  uint32_t* out = sb_block ? sb_out : acc_out + (long long)blockIdx.x * PW;
  for (int i = tid; i < PW; i += FOLD_THREADS) out[i] = s[i];
}

// Four lanes, one formula: every lane holds the whole point
__device__ __forceinline__ Fe from(const Fe& a, int lane) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = __shfl_sync(QUAD, a.v[i], lane);
  return o;
}

__device__ __forceinline__ Fe sel4(int q, const Fe& a0, const Fe& a1, const Fe& a2,
                                   const Fe& a3) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    o.v[i] = q == 0 ? a0.v[i] : q == 1 ? a1.v[i] : q == 2 ? a2.v[i] : a3.v[i];
  return o;
}

// round 2: lane q forms the q-th of E F, G H, F G, E H
__device__ __forceinline__ Pt quad_finish(int q, const Fe& E, const Fe& F, const Fe& G,
                                          const Fe& H) {
  const Fe r = mul_i(sel4(q, E, G, F, E), sel4(q, F, H, G, H));
  return Pt{from(r, 0), from(r, 1), from(r, 2), from(r, 3)};
}

// _pt_double: lane q squares X, Y, Z or X + Y
__device__ __forceinline__ Pt quad_double(int q, const Pt& p) {
  const Fe r = sq_i(sel4(q, p.x, p.y, p.z, fe_add(p.x, p.y)));
  const Fe A = from(r, 0), B = from(r, 1), ZZ = from(r, 2), S = from(r, 3);
  const Fe H = fe_add(A, B), G = fe_sub(A, B);
  return quad_finish(q, fe_sub(H, S), fe_add(fe_add(ZZ, ZZ), G), G, H);
}

// _pt_add: lane q forms (Y1-X1)(Y2-X2), (Y1+X1)(Y2+X2), T1 2d or 2 Z1 Z2;
// then lane 2 multiplies by T2
__device__ __forceinline__ Pt quad_add(int q, const Pt& p, const Pt& o, const Fe& d2) {
  const Fe r = mul_i(sel4(q, fe_sub(p.y, p.x), fe_add(p.y, p.x), p.t, fe_add(p.z, p.z)),
                     sel4(q, fe_sub(o.y, o.x), fe_add(o.y, o.x), d2, o.z));
  const Fe c = mul_i(r, o.t);
  const Fe A = from(r, 0), B = from(r, 1), C = from(c, 2), D = from(r, 3);
  return quad_finish(q, fe_sub(B, A), fe_sub(D, C), fe_add(D, C), fe_add(B, A));
}

// Horner over the window sums from the top (c doublings and one addition a
// step), + [s_b]B, then the canonical final point and the verdict:
// canonical X == 0 and Y == Z. Four threads.
__global__ void __launch_bounds__(32)
msm_finish_kernel(const uint32_t* __restrict__ acc, const uint32_t* __restrict__ sbp,
                  const uint32_t* __restrict__ consts, uint32_t* __restrict__ ok,
                  uint32_t* __restrict__ pt_out, int nwin, int c) {
  const int q = threadIdx.x;
  const Fe d2 = ld(consts + D2_OFF);
  Pt tot = ld_pt(acc + (long long)(nwin - 1) * PW);
  // t = nwin - 2 .. 0: c doublings and acc[t]; t = -1: + [s_b]B
#pragma unroll 1
  for (int t = nwin - 2; t >= -1; --t) {
#pragma unroll 1
    for (int k = 0; t >= 0 && k < c; ++k) tot = quad_double(q, tot);
    tot = quad_add(q, tot, ld_pt(t >= 0 ? acc + (long long)t * PW : sbp), d2);
  }
  if (q != 0) return;
  const Fe x = fe_canonical(tot.x), y = fe_canonical(tot.y), z = fe_canonical(tot.z),
           t = fe_canonical(tot.t);
  bool good = true;
#pragma unroll
  for (int i = 0; i < NL; ++i) good = good && x.v[i] == 0 && y.v[i] == z.v[i];
  st(pt_out + X_, x);
  st(pt_out + Y_, y);
  st(pt_out + Z_, z);
  st(pt_out + T_, t);
  ok[0] = good ? 1u : 0u;
}

}  // namespace

// One tree level of m output rows: reads the level that starts at row src
// of ``rows``, writes rows dst .. dst + m - 1.
extern "C" int msm_level_launch(void* rows, const void* ia, const void* ib,
                                const void* consts, long long src, long long dst, int m,
                                void* stream) {
  if (m <= 0 || src < 0 || dst < src) return (int)cudaErrorInvalidValue;
  const int blocks = (m + LEVEL_THREADS - 1) / LEVEL_THREADS;
  msm_level_kernel<<<blocks, LEVEL_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)rows, (const int32_t*)ia, (const int32_t*)ib, (const uint32_t*)consts, src,
      dst, m);
  return (int)cudaGetLastError();
}

// The bucket folds and [s_b]B: bkt (nwin, nb) global rows of ``rows``, acc
// (nwin, 40), sb (40,). The dynamic shared memory limit is raised once a
// device.
extern "C" int msm_fold_launch(const void* rows, const void* bkt, const void* sb_digs,
                               const void* consts, const void* comb, void* acc, void* sb,
                               int nwin, int nb, void* stream) {
  if (nwin <= 0 || nb <= 0 || nb > MAX_NB || (nb & (nb + 1)))
    return (int)cudaErrorInvalidValue;
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(msm_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FOLD_SMEM);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  msm_fold_kernel<<<nwin + 1, FOLD_THREADS, FOLD_SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int32_t*)bkt, (const int32_t*)sb_digs,
      (const uint32_t*)consts, (const uint32_t*)comb, (uint32_t*)acc, (uint32_t*)sb, nwin, nb);
  return (int)cudaGetLastError();
}

// Horner over acc (nwin, 40) with c doublings a step, + sb (40,): ok (1,),
// the canonical final point pt (40,).
extern "C" int msm_finish_launch(const void* acc, const void* sb, const void* consts, void* ok,
                                 void* pt, int nwin, int c, void* stream) {
  if (nwin <= 0 || c <= 0 || c > 16) return (int)cudaErrorInvalidValue;
  msm_finish_kernel<<<1, 4, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const uint32_t*)sb, (const uint32_t*)consts, (uint32_t*)ok,
      (uint32_t*)pt, nwin, c);
  return (int)cudaGetLastError();
}
