// K4: one Pippenger multi-scalar multiplication a window, the device half of
// the random-linear-combination (RLC) verify path: the window is accepted iff
//
//   [s_b]B + sum_j [k_j] P_j == identity,
//
// with the P_j the -A_i and -R_i of its rows and the host's schedule
// (ed25519_msm._build_schedule) resolving every data-dependent step into
// index lists. Three kernels run in order on the caller's stream:
//
//  * msm_level, once a tree level: one thread an output row,
//    rows[dst + r] = rows[src + ia[r]] + rows[src + ib[r]] over one buffer
//    that holds the pool and every level after it, in the order the
//    schedule's global bucket indices address them;
//  * msm_fold, one block of nwin threads, one a window: the gather of the
//    window's 2^c - 1 bucket sums by the bucket grid, then the descending
//    run/acc double accumulation acc = sum_d d * bucket[d];
//  * msm_finish, one block: thread 0 folds the windows by Horner from the
//    top (c doublings and one add a step) while thread 1 computes [s_b]B
//    from the niels table [0..15]B (64 MSB-first 4-bit digits, 4 doublings
//    and one mixed add a digit); then thread 0 adds the two, writes the
//    canonical limbs of the final point and the verdict, canonical X == 0
//    and Y == Z.
//
// Replaces: tendermint_tpu/ops/ed25519_msm.py::_msm_kernel (jitted by
// _compiled_msm, called from _device_rlc). That is XLA code with no Pallas
// inside; its tree levels, bucket fold and Horner follow here step by step.
//
// What bounds it on the H100: 32x32 -> 64 products (IMAD.WIDE, about 30 a
// clock an SM: ops/imad_probe.py), 9 field multiplications of 100 products
// each a point addition; the tree does one addition a nonzero digit, the
// fold 2 (2^c - 1) a window. Spread over the card that is well under a
// tenth of a millisecond at a 10,000-signature commit. This first version
// does not come near it: the fold runs nwin threads of one block and the
// finish one thread, about 1,100 dependent point operations at c = 8, so
// those two kernels are serial chains of dependent multiplies while the
// tree levels fill the card. Making them parallel is later work.
//
// Field elements are the ten radix-2^25.5 limbs of ops/fe.py, a point is
// (X, Y, Z, T) in 40 consecutive words, and every formula is the plain
// version's (ed25519_cuda._pt_add / _pt_double / _pt_madd over fe.mul,
// fe.sq, fe.add, fe.sub), so every intermediate is the same integer as in
// ed25519_msm.msm_ref and the final point is equal limb for limb. The field
// code is K2's, from ed25519_field.cuh; one thread a formula.

#include <cstdint>
#include <cuda_runtime.h>

#include "ed25519_field.cuh"

namespace {

constexpr int PW = 4 * NL;                  // words of an extended point
constexpr int NIELS_W = 3 * NL;             // words of a niels entry (ypx, ymx, t2d)
constexpr int D2_OFF = 16 * NIELS_W;        // 2d follows the niels table in consts
constexpr int LEVEL_THREADS = 128;
constexpr int MAX_WINDOWS = 1024;
constexpr int SB_DIGITS = 64;

struct Pt {
  Fe x, y, z, t;
};

__device__ __forceinline__ Fe load_fe(const uint32_t* p) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = p[i];
  return o;
}

__device__ __forceinline__ void store_fe(uint32_t* p, const Fe& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) p[i] = a.v[i];
}

__device__ __forceinline__ Pt load_pt(const uint32_t* p) {
  return Pt{load_fe(p), load_fe(p + NL), load_fe(p + 2 * NL), load_fe(p + 3 * NL)};
}

__device__ __forceinline__ void store_pt(uint32_t* p, const Pt& a) {
  store_fe(p, a.x);
  store_fe(p + NL, a.y);
  store_fe(p + 2 * NL, a.z);
  store_fe(p + 3 * NL, a.t);
}

__device__ __forceinline__ Pt identity() {
  Fe zero, one;
#pragma unroll
  for (int i = 0; i < NL; ++i) zero.v[i] = one.v[i] = 0;
  one.v[0] = 1;
  return Pt{zero, one, one, zero};
}

// _pt_finish: E = B - A, F = D - C, G = D + C, H = B + A
__device__ Pt pt_finish(const Fe& A, const Fe& B, const Fe& C, const Fe& D) {
  const Fe E = fe_sub(B, A), F = fe_sub(D, C), G = fe_add(D, C), H = fe_add(B, A);
  return Pt{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H)};
}

// _pt_add: the complete extended addition with 2d
__device__ __noinline__ Pt pt_add(Pt p, Pt q, Fe d2) {
  const Fe A = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const Fe B = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const Fe C = fe_mul(fe_mul(p.t, d2), q.t);
  const Fe D = fe_mul(fe_add(p.z, p.z), q.z);
  return pt_finish(A, B, C, D);
}

// _pt_double
__device__ __noinline__ Pt pt_double(Pt p) {
  const Fe A = fe_sq(p.x), B = fe_sq(p.y), ZZ = fe_sq(p.z);
  const Fe C = fe_add(ZZ, ZZ), H = fe_add(A, B);
  const Fe E = fe_sub(H, fe_sq(fe_add(p.x, p.y)));
  const Fe G = fe_sub(A, B), F = fe_add(C, G);
  return Pt{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H)};
}

// _pt_madd: mixed addition of an affine niels point (y+x, y-x, 2dxy)
__device__ __noinline__ Pt pt_madd(Pt p, Fe ypx, Fe ymx, Fe t2d) {
  const Fe A = fe_mul(fe_sub(p.y, p.x), ymx);
  const Fe B = fe_mul(fe_add(p.y, p.x), ypx);
  const Fe C = fe_mul(p.t, t2d);
  return pt_finish(A, B, C, fe_add(p.z, p.z));
}

// one tree level: rows[dst + r] = rows[src + ia[r]] + rows[src + ib[r]]
__global__ void __launch_bounds__(LEVEL_THREADS) msm_level_kernel(
    uint32_t* __restrict__ rows, const int32_t* __restrict__ ia,
    const int32_t* __restrict__ ib, const uint32_t* __restrict__ consts, long long src,
    long long dst, int m) {
  const int r = blockIdx.x * LEVEL_THREADS + threadIdx.x;
  if (r >= m) return;
  const Fe d2 = load_fe(consts + D2_OFF);
  const Pt a = load_pt(rows + (src + ia[r]) * PW);
  const Pt b = load_pt(rows + (src + ib[r]) * PW);
  store_pt(rows + (dst + r) * PW, pt_add(a, b, d2));
}

// one thread a window: acc = sum_d d * bucket[d] by the descending run/acc
// accumulation over the window's row of the bucket grid
__global__ void msm_fold_kernel(const uint32_t* __restrict__ rows,
                                const int32_t* __restrict__ bkt,
                                const uint32_t* __restrict__ consts,
                                uint32_t* __restrict__ acc_out, int nwin, int nb) {
  const int w = threadIdx.x;
  if (w >= nwin) return;
  const Fe d2 = load_fe(consts + D2_OFF);
  Pt run = identity(), acc = identity();
#pragma unroll 1
  for (int t = 0; t < nb; ++t) {
    const Pt g = load_pt(rows + (long long)bkt[w * nb + nb - 1 - t] * PW);
    run = pt_add(run, g, d2);
    acc = pt_add(acc, run, d2);
  }
  store_pt(acc_out + w * PW, acc);
}

// thread 0: Horner over the window sums, top first; thread 1: [s_b]B; then
// thread 0 adds them and writes the canonical final point and the verdict
__global__ void msm_finish_kernel(const uint32_t* __restrict__ acc,
                                  const int32_t* __restrict__ sb_digs,
                                  const uint32_t* __restrict__ consts,
                                  uint32_t* __restrict__ ok, uint32_t* __restrict__ pt_out,
                                  int nwin, int c) {
  __shared__ uint32_t sb_words[PW];
  const Fe d2 = load_fe(consts + D2_OFF);
  Pt tot;
  if (threadIdx.x == 0) {
    tot = load_pt(acc + (nwin - 1) * PW);
#pragma unroll 1
    for (int t = 0; t < nwin - 1; ++t) {
#pragma unroll 1
      for (int k = 0; k < c; ++k) tot = pt_double(tot);
      tot = pt_add(tot, load_pt(acc + (nwin - 2 - t) * PW), d2);
    }
  } else if (threadIdx.x == 1) {
    Pt sb = identity();
#pragma unroll 1
    for (int t = 0; t < SB_DIGITS; ++t) {
#pragma unroll 1
      for (int k = 0; k < 4; ++k) sb = pt_double(sb);
      const uint32_t* e = consts + (sb_digs[t] & 15) * NIELS_W;
      sb = pt_madd(sb, load_fe(e), load_fe(e + NL), load_fe(e + 2 * NL));
    }
    store_pt(sb_words, sb);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const Pt f = pt_add(tot, load_pt(sb_words), d2);
  const Fe x = fe_canonical(f.x), y = fe_canonical(f.y), z = fe_canonical(f.z),
           t = fe_canonical(f.t);
  bool good = true;
#pragma unroll
  for (int i = 0; i < NL; ++i) good = good && x.v[i] == 0 && y.v[i] == z.v[i];
  store_pt(pt_out, Pt{x, y, z, t});
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

// The bucket fold: bkt (nwin, nb) global rows of ``rows``; acc (nwin, 40).
extern "C" int msm_fold_launch(const void* rows, const void* bkt, const void* consts,
                               void* acc, int nwin, int nb, void* stream) {
  if (nwin <= 0 || nwin > MAX_WINDOWS || nb <= 0) return (int)cudaErrorInvalidValue;
  const int threads = ((nwin + 31) / 32) * 32;
  msm_fold_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int32_t*)bkt, (const uint32_t*)consts, (uint32_t*)acc,
      nwin, nb);
  return (int)cudaGetLastError();
}

// Horner over acc (nwin, 40) with c doublings a step, [s_b]B from the 64
// digits, the final add: ok (1,), the canonical final point pt (40,).
extern "C" int msm_finish_launch(const void* acc, const void* sb_digs, const void* consts,
                                 void* ok, void* pt, int nwin, int c, void* stream) {
  if (nwin <= 0 || nwin > MAX_WINDOWS || c <= 0 || c > 16) return (int)cudaErrorInvalidValue;
  msm_finish_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)sb_digs, (const uint32_t*)consts, (uint32_t*)ok,
      (uint32_t*)pt, nwin, c);
  return (int)cudaGetLastError();
}
