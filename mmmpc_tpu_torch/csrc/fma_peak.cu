// Max-FMA microkernel for NVIDIA Hopper (sm_90a): kernel F of the port, the
// card's measured float32 peak (the operation side of every bound).
//
// Replaces the Pallas TPU kernel scripts/roofline.py::measure_vpu_peak ->
// kernel.  Per thread NACC independent accumulators and acc = acc * b + c
// (one fmaf, one rounding) for a runtime trip count `inner`; the inputs come
// from memory, so nothing folds, and the NACC chains are independent, so
// their latency overlaps.  The rate is the slope between two trip counts
// (mmmpc_tpu_torch/roofline.py), which cancels the launch, the loads and the
// stores.
//
// What bounds it: operations by construction (2 NACC inner FLOP per thread
// against (NACC + 2) + NACC floats moved).  The NACC loop is unrolled; the
// trip loop is unrolled by 8 only, which keeps the loop's own instructions
// (counter, compare, branch) at 3 per 8 NACC FFMAs.
//
// Layout: in (NACC + 2, n) with n = blocks * threads: the accumulators' start
// values, then b, then c; out (NACC, n).
#include <cuda_runtime.h>

namespace fma_peak {

template <int NACC>
__global__ void fma_peak_kernel(const float* __restrict__ in,
                                float* __restrict__ out, int inner) {
  const int n = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = in[i * n + t];
  const float b = in[NACC * n + t];
  const float c = in[(NACC + 1) * n + t];
#pragma unroll 8
  for (int it = 0; it < inner; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = fmaf(acc[i], b, c);
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) out[i * n + t] = acc[i];
}

template <int NACC>
int launch(const float* in, float* out, int inner, int blocks, int threads,
           void* stream) {
  fma_peak_kernel<NACC><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fma_peak

// The C entry of the NACC instance: device pointers, the trip count, the
// grid, the stream; returns cudaGetLastError() after the launch.
#define FMA_ENTRY(nacc)                                                        \
  extern "C" int fma_peak_##nacc(const float* in, float* out, int inner,       \
                                 int blocks, int threads, void* stream) {      \
    return fma_peak::launch<nacc>(in, out, inner, blocks, threads, stream);   \
  }

FMA_ENTRY(4)
FMA_ENTRY(8)
FMA_ENTRY(16)
FMA_ENTRY(32)
