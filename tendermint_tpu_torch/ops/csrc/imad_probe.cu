// Probe: how many 32x32 -> 64-bit multiply-adds (IMAD.WIDE.U32) one SM
// retires a clock, beside 32-bit multiply-adds (IMAD). chip_smoke.py prices
// the ladder kernels' products at the measured IMAD.WIDE rate. It is a
// measurement, not a port of a TPU kernel.
//
// One block of 1,024 threads per SM (its dynamic shared memory keeps a
// second block off the SM), each thread running CHAINS independent chains
// acc = lo(acc) * y + acc, UNROLL steps an iteration. Each block reads the
// SM's clock around its loop; products a clock = the block's products over
// its clocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int CHAINS = 8;
constexpr int UNROLL = 16;
constexpr int SMEM_BYTES = 160 * 1024;  // more than half an SM's shared memory

template <bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
probe_kernel(uint32_t y, int iters, long long* cycles, uint64_t* sink) {
  extern __shared__ uint32_t pad[];
  uint64_t acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) acc[k] = threadIdx.x * 2654435761u + k;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) {
        if (WIDE) {
          acc[k] = (uint64_t)(uint32_t)acc[k] * y + acc[k];
        } else {
          acc[k] = (uint32_t)acc[k] * y + (uint32_t)acc[k];
        }
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    cycles[blockIdx.x] = t1 - t0;
    pad[0] = 0;
  }
  uint64_t s = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s ^= acc[k];
  sink[blockIdx.x * THREADS + threadIdx.x] = s;
}

template <bool WIDE>
int launch(uint32_t y, int iters, long long* cycles, uint64_t* sink, int blocks,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<WIDE><<<blocks, THREADS, SMEM_BYTES, stream>>>(y, iters, cycles, sink);
  return (int)cudaGetLastError();
}

}  // namespace

// cycles: (blocks,) int64; sink: (blocks * 1024,) uint64. Products per
// block: 1024 * iters * UNROLL * CHAINS (imad_probe.PRODUCTS_PER_ITER).
extern "C" int imad_probe_launch(int wide, unsigned y, int iters, void* cycles, void* sink,
                                 int blocks, void* stream) {
  if (iters <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  return wide ? launch<true>(y, iters, (long long*)cycles, (uint64_t*)sink, blocks,
                             (cudaStream_t)stream)
              : launch<false>(y, iters, (long long*)cycles, (uint64_t*)sink, blocks,
                              (cudaStream_t)stream);
}
