// Batched Riccati backward sweep on precomputed expansion blocks, for NVIDIA
// Hopper (sm_90a): kernel E of the port.
//
// Replaces the Pallas TPU kernel mmmpc_tpu/ops/riccati.py::_kernel (called
// by riccati_backward_bm -> _invoke), which the JAX solver runs wherever the
// fused backward is off (solver/batched.py, use_fused_backward=False or an
// OCP without a lanes_bwd_factory).  Per scenario, from the terminal
// gradient / Hessian (Vx, Vxx), backward over the stages: the Q blocks
// through the dense A and B, plus the stage's blocks lx, lu, lxx, luu, lux,
// then one Riccati step (ric::riccati_step, shared with kernel D): Cholesky
// of Quu + reg I, kff, K, the value update with Quu without reg, Vxx
// symmetrised.  The plain PyTorch version is ops/riccati.py::
// plain_riccati_bm.
//
// Layouts are batch-last, as the JAX interface: lx (N, NX, B), lu (N, NU, B),
// lxx (N, NX, NX, B), luu (N, NU, NU, B), lux (N, NU, NX, B), A (N, NX, NX, B),
// Bm (N, NX, NU, B), term_g (NX, B), term_H (NX, NX, B), reg (B,) ->
// kff (N, NU, B), K (N, NU, NX, B).
//
// What bounds it on this card: bytes.  Each stage reads 2 NX^2 + NX NU +
// NU^2 + NU NX + NX + NU floats per scenario and writes NU (1 + NX): 291 + 50
// for (9, 5), 226.5 MB per call at N=20, B=8192 (67.6 us at 3.35 TB/s),
// against ~8.5 kFLOP per stage (~21 us at 67 TFLOP/s).  What the design does
// about it: one thread per scenario, so a warp's loads of one block entry
// are 32 consecutive floats (coalesced, batch last) and every byte is read
// exactly once; Vx and Vxx stay in registers across the horizon; A and B are
// read through the read-only path where the products need them rather than
// staged whole in registers next to Vxx and the Q blocks.  The stage chain
// is serial, so at B=8192 the kernel has 256 warps in flight (64-thread
// blocks, 128 blocks on 132 SMs) and is latency-bound before it is
// bandwidth-bound.
#include <cuda_runtime.h>

#include <cstddef>

#include "riccati_step.cuh"

namespace ric {

constexpr int THREADS = 64;

// Dense Jacobians of one stage in global memory, batch-last: entry (i, j)
// of this scenario at base[(i * cols + j) * B].
template <int NX, int NU>
struct JacDense {
  const float* __restrict__ A;
  const float* __restrict__ Bm;
  int B;
  __host__ __device__ static constexpr bool a_nz(int, int) { return true; }
  __host__ __device__ static constexpr bool b_nz(int, int) { return true; }
  __device__ __forceinline__ float a(int i, int j) const {
    return __ldg(A + (i * NX + j) * B);
  }
  __device__ __forceinline__ float b(int i, int j) const {
    return __ldg(Bm + (i * NU + j) * B);
  }
};

template <int NX, int NU>
__global__ void __launch_bounds__(THREADS)
riccati_bwd_kernel(const float* __restrict__ lx, const float* __restrict__ lu,
                   const float* __restrict__ lxx,
                   const float* __restrict__ luu,
                   const float* __restrict__ lux, const float* __restrict__ A,
                   const float* __restrict__ Bm,
                   const float* __restrict__ term_g,
                   const float* __restrict__ term_H,
                   const float* __restrict__ reg, float* __restrict__ kff,
                   float* __restrict__ K, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  QStage<NX, NU> q;
  float Vx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = __ldg(term_g + i * B + b);
#pragma unroll
    for (int j = 0; j < NX; ++j) q.xx[i][j] = __ldg(term_H + (i * NX + j) * B + b);
  }
  const float rg = __ldg(reg + b);

  for (int k = N - 1; k >= 0; --k) {
    const size_t s = static_cast<size_t>(k);
    const JacDense<NX, NU> jac{A + s * NX * NX * B + b, Bm + s * NX * NU * B + b,
                               B};
    riccati_step<NX, NU>(
        jac, [&]() {
          // Q += the stage's blocks
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            q.x[i] += __ldg(lx + (s * NX + i) * B + b);
#pragma unroll
            for (int j = 0; j < NX; ++j)
              q.xx[i][j] += __ldg(lxx + ((s * NX + i) * NX + j) * B + b);
          }
#pragma unroll
          for (int i = 0; i < NU; ++i) {
            q.u[i] += __ldg(lu + (s * NU + i) * B + b);
#pragma unroll
            for (int j = 0; j < NU; ++j)
              q.uu[i][j] += __ldg(luu + ((s * NU + i) * NU + j) * B + b);
#pragma unroll
            for (int j = 0; j < NX; ++j)
              q.ux[i][j] += __ldg(lux + ((s * NU + i) * NX + j) * B + b);
          }
        },
        q, Vx, rg, kff + s * NU * B + b, K + s * NU * NX * B + b, B);
  }
}

template <int NX, int NU>
int launch(const float* lx, const float* lu, const float* lxx,
           const float* luu, const float* lux, const float* A, const float* Bm,
           const float* term_g, const float* term_H, const float* reg,
           float* kff, float* K, int N, int B, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + THREADS - 1) / THREADS;
  riccati_bwd_kernel<NX, NU><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg, kff, K, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ric

// The C entry of the (nx, nu) instance: device pointers, N, B, the stream;
// returns cudaGetLastError() after the launch.
#define RIC_ENTRY(nx, nu)                                                      \
  extern "C" int ric_bwd_##nx##x##nu(                                          \
      const float* lx, const float* lu, const float* lxx, const float* luu,    \
      const float* lux, const float* A, const float* Bm, const float* term_g,  \
      const float* term_H, const float* reg, float* kff, float* K, int N,      \
      int B, void* stream) {                                                   \
    return ric::launch<nx, nu>(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H,  \
                               reg, kff, K, N, B, stream);                     \
  }

// The library of the port holds the four pairs of its controllers.  Built
// with -DRIC_PAIR_NX=nx -DRIC_PAIR_NU=nu, the source gives the one entry of
// that pair instead (ops/_cuda.py::build_riccati_pair, any other (nx, nu)
// on its first use).  RIC_ENTRY_ expands the two macros before RIC_ENTRY
// pastes them into the name.
#define RIC_ENTRY_(nx, nu) RIC_ENTRY(nx, nu)
#if defined(RIC_PAIR_NX) && defined(RIC_PAIR_NU)
RIC_ENTRY_(RIC_PAIR_NX, RIC_PAIR_NU)
#else
RIC_ENTRY(2, 1)
RIC_ENTRY(3, 3)
RIC_ENTRY(6, 2)
RIC_ENTRY(9, 5)
#endif
