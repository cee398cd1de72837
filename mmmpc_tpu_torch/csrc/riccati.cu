// Batched Riccati backward sweep on precomputed expansion blocks, for NVIDIA
// Hopper (sm_90a): kernel E of the port.
//
// Replaces the Pallas TPU kernel mmmpc_tpu/ops/riccati.py::_kernel (called
// by riccati_backward_bm -> _invoke), which the JAX solver runs wherever the
// fused backward is off (solver/batched.py, use_fused_backward=False or an
// OCP without a lanes_bwd_factory).  Per scenario, from the terminal
// gradient / Hessian (Vx, Vxx), backward over the stages: the Q blocks
// through the dense A and B, plus the stage's blocks lx, lu, lxx, luu, lux,
// then the Cholesky of Quu + reg I, kff, K, the value update with Quu
// without reg, Vxx symmetrised.  The plain PyTorch version is
// ops/riccati.py::plain_riccati_bm.
//
// Layouts are batch-last, as the JAX interface: lx (N, NX, B), lu (N, NU, B),
// lxx (N, NX, NX, B), luu (N, NU, NU, B), lux (N, NU, NX, B), A (N, NX, NX, B),
// Bm (N, NX, NU, B), term_g (NX, B), term_H (NX, NX, B), reg (B,) ->
// kff (N, NU, B), K (N, NU, NX, B).
//
// What bounds it on this card: bytes.  Each stage reads 2 NX^2 + NX NU +
// NU^2 + NU NX + NX + NU floats per scenario and writes NU (1 + NX): 291 + 50
// for (9, 5), 226.5 MB per call at N=20, B=8192 (67.6 us at 3.35 TB/s),
// against ~8.5 kFLOP per stage (~21 us at 67 TFLOP/s).  One thread per
// scenario held the whole value function and the Q blocks (255 registers
// and 1100 B of spill at (9, 5)), with 64 blocks at batch 8192 and one
// __ldg chain a thread in flight.  So the design, after kernel B's
// (wholebody_bwd.cu):
//
// - A team of T lanes of one warp per scenario, S = 128 / T scenarios a
//   block, at most 128 registers a thread (__launch_bounds__), no spill.
//   T comes from one rule, ric_team(nx, nu), for every pair: the least
//   power of two that takes the nx + nu row tasks in four rounds.  The
//   lanes of a warp read each row of Vxx, A and B once for all of the
//   warp's scenarios, so fewer lanes a scenario read less per scenario;
//   more rounds hold more rows in registers.  At (9, 5) T = 4 beat T = 8
//   (PERF.md, team_sweep.py) though it leaves 2 blocks an SM, not 4.
// - The step is ric::team_step (riccati_team.cuh, shared with kernel
//   D.endpoint): the row tasks of the Q blocks over the lanes, the factor
//   in every lane, the solve columns over the lanes, the value update row
//   by row, through the team's tile in shared memory.
// - A two-stage buffer in shared memory holds a stage's blocks lx, lu,
//   lxx, luu, lux, A, Bm of the block's scenarios, element-major with the
//   scenario fastest (each entry one contiguous run of S floats of the
//   batch axis), filled one stage ahead by cp.async (cp_async.cuh), the
//   terminal blocks first.  One __syncthreads a stage: after it stage k's
//   blocks have landed and every team is done with stage k+1, whose
//   buffer then takes stage k-1's loads while stage k computes.  A whole
//   stage of the block in flight, where one thread had one load at a time.
// - The lane of a solve column stores its gains as it solves them, so no
//   tile of gains waits for the next barrier.  None of the shared memory
//   grows with N.
// - A ragged batch: the lanes of a partial block run on the clamped
//   scenario index min(b, B - 1) and only stores are masked, so every
//   __syncthreads and __syncwarp is reached by every thread.
// - No tensor cores: the products are NX x NX per scenario, and TF32
//   keeps about three decimal digits, which a Riccati recursion through a
//   Cholesky cannot afford at these tolerances.
#include <cuda_runtime.h>

#include <cstddef>

#include "cp_async.cuh"
#include "riccati_team.cuh"

namespace ric {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 4;    // __launch_bounds__: <= 128 registers
constexpr int MAX_SMEM = 227 * 1024;

// Lanes a scenario at (nx, nu): the least power of two that takes the
// nx + nu row tasks in four rounds, at most 8.
__host__ __device__ constexpr int ric_team(int nx, int nu) {
  int t = 1;
  while (4 * t < nx + nu && t < 8) t *= 2;
  return t;
}

// A stage's blocks of one scenario, in the buffer's element order.
template <int NX, int NU>
struct Blocks {
  static constexpr int LX = 0, LU = LX + NX, LXX = LU + NU,
                       LUU = LXX + NX * NX, LUX = LUU + NU * NU,
                       A = LUX + NU * NX, B = A + NX * NX, N = B + NX * NU;
};

template <int NX, int NU>
__host__ __device__ constexpr int smem_floats(int scen) {
  return scen * (tile_stride<NX, NU>() + 2 * Blocks<NX, NU>::N);
}

// Scenarios a block: 128 / T, halved while the block's shared memory
// would not fit an SM (large pairs only).
template <int NX, int NU>
__host__ __device__ constexpr int ric_scen() {
  int s = THREADS / ric_team(NX, NU);
  while (s > 1 && smem_floats<NX, NU>(s) * 4 > MAX_SMEM) s /= 2;
  return s;
}

// The Jacobians of a stage in the stage buffer: entry e of the team's
// scenario at in[e * S].
template <int NX, int NU, int S>
struct JacBuf {
  using E = Blocks<NX, NU>;
  const float* in;
  static constexpr bool RUNTIME_ROWS = true;
  __host__ __device__ static constexpr bool a_nz(int, int) { return true; }
  __host__ __device__ static constexpr bool b_nz(int, int) { return true; }
  __device__ __forceinline__ float a(int i, int j) const {
    return in[(E::A + i * NX + j) * S];
  }
  __device__ __forceinline__ float b(int i, int j) const {
    return in[(E::B + i * NU + j) * S];
  }
  // entry p of row t of [A | B]^T; t past the last task reads a valid entry
  __device__ __forceinline__ float coef(int p, int t) const {
    const int e = t < NX ? E::A + p * NX + t
                         : E::B + p * NU + (t - NX < NU ? t - NX : NU - 1);
    return in[e * S];
  }
};

template <int NX, int NU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
riccati_team_kernel(const float* __restrict__ lx, const float* __restrict__ lu,
                    const float* __restrict__ lxx,
                    const float* __restrict__ luu,
                    const float* __restrict__ lux, const float* __restrict__ A,
                    const float* __restrict__ Bm,
                    const float* __restrict__ term_g,
                    const float* __restrict__ term_H,
                    const float* __restrict__ reg, float* __restrict__ kff,
                    float* __restrict__ K, int N, int B) {
  constexpr int T = ric_team(NX, NU), S = ric_scen<NX, NU>();
  constexpr int NT = NX + NU, R = rounds<NX, NU, T>();
  using E = Blocks<NX, NU>;
  extern __shared__ __align__(16) float smem[];
  float* inbuf = smem + S * tile_stride<NX, NU>();

  const int tid = threadIdx.x;
  const int team = tid / T, lane = tid % T;
  const int b0 = blockIdx.x * S;
  const int bs = min(b0 + team, B - 1);
  const bool store = b0 + team < B;
  TeamTile<NX, NU>& tt =
      *reinterpret_cast<TeamTile<NX, NU>*>(smem + team * tile_stride<NX, NU>());

  // The block's copies: thread tid moves scenario cs = tid % S (clamped to
  // the batch) of the elements ci, ci + T, ... of each block.
  const int cs = tid % S, ci = tid / S;
  const int cb = min(b0 + cs, B - 1);
  auto copy = [&](float* dst, int off, int n, const float* src) {
    for (int i = ci; i < n; i += T)
      wb::cp_async4(dst + (off + i) * S, src + static_cast<size_t>(i) * B + cb);
  };
  // stage k's blocks into buffer k & 1
  auto issue_stage = [&](int k) {
    float* dst = inbuf + (k & 1) * E::N * S + cs;
    const size_t s = static_cast<size_t>(k);
    copy(dst, E::LX, NX, lx + s * NX * B);
    copy(dst, E::LU, NU, lu + s * NU * B);
    copy(dst, E::LXX, NX * NX, lxx + s * NX * NX * B);
    copy(dst, E::LUU, NU * NU, luu + s * NU * NU * B);
    copy(dst, E::LUX, NU * NX, lux + s * NU * NX * B);
    copy(dst, E::A, NX * NX, A + s * NX * NX * B);
    copy(dst, E::B, NX * NU, Bm + s * NX * NU * B);
  };
  // the terminal blocks into buffer N & 1 (stage N-1 uses the other):
  // term_g at elements 0.., term_H after it
  {
    float* dst = inbuf + (N & 1) * E::N * S + cs;
    copy(dst, 0, NX, term_g);
    copy(dst, NX, NX * NX, term_H);
    wb::cp_async_commit();
  }
  issue_stage(N - 1);
  wb::cp_async_commit();
  const float rg = __ldg(reg + bs);
  wb::cp_async_wait<1>();
  __syncthreads();
  {
    const float* in = inbuf + (N & 1) * E::N * S + team;
    for (int e = lane; e < NX + NX * NX; e += T) {
      if (e < NX) tt.vx[e] = in[e * S];
      else (&tt.V[0][0])[e - NX] = in[e * S];
    }
  }

  for (int k = N - 1; k >= 0; --k) {
    wb::cp_async_wait<0>();
    __syncthreads();
    if (k > 0) issue_stage(k - 1);
    wb::cp_async_commit();
    const float* in = inbuf + (k & 1) * E::N * S + team;
    const size_t s = static_cast<size_t>(k);
    team_step<NX, NU, T>(
        JacBuf<NX, NU, S>{in},
        [&](float (&q)[R], float (&acc)[R][NX], float (&uu)[R][NU]) {
          // + lx / lu, + the row of lxx / lux, + the row of luu
#pragma unroll
          for (int rho = 0; rho < R; ++rho) {
            const int t = min(rho * T + lane, NT - 1);
            const bool xrow = t < NX;
            const int i = xrow ? 0 : t - NX;
            q[rho] += in[(xrow ? E::LX + t : E::LU + i) * S];
#pragma unroll
            for (int j = 0; j < NX; ++j)
              acc[rho][j] += in[(xrow ? E::LXX + t * NX + j : E::LUX + i * NX + j) * S];
            if ((rho + 1) * T > NX) {
#pragma unroll
              for (int j = 0; j < NU; ++j) uu[rho][j] += in[(E::LUU + i * NU + j) * S];
            }
          }
        },
        tt, rg, lane, kff + s * NU * B + bs, K + s * NU * NX * B + bs, B, store);
  }
}

// The launch at batch B: lanes a scenario, threads a block, blocks,
// dynamic shared-memory bytes.
struct Geometry {
  int team, threads, blocks, smem;
};

template <int NX, int NU>
Geometry geometry(int B) {
  constexpr int T = ric_team(NX, NU), S = ric_scen<NX, NU>();
  return {T, S * T, (B + S - 1) / S, smem_floats<NX, NU>(S) * 4};
}

// Lets the kernel take g.smem bytes of dynamic shared memory (above 48 KB
// only after cudaFuncSetAttribute).
template <int NX, int NU>
cudaError_t allow_smem(const Geometry& g) {
  if (g.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(riccati_team_kernel<NX, NU>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              g.smem);
}

template <int NX, int NU>
int launch(const float* lx, const float* lu, const float* lxx,
           const float* luu, const float* lux, const float* A, const float* Bm,
           const float* term_g, const float* term_H, const float* reg,
           float* kff, float* K, int N, int B, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const Geometry g = geometry<NX, NU>(B);
  const cudaError_t e = allow_smem<NX, NU>(g);
  if (e != cudaSuccess) return static_cast<int>(e);
  riccati_team_kernel<NX, NU>
      <<<g.blocks, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
          lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg, kff, K, N, B);
  return static_cast<int>(cudaGetLastError());
}

// out = {team, threads, blocks, smem bytes} of the launch at batch B, and
// the blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <int NX, int NU>
int report(int B, int* out) {
  const Geometry g = geometry<NX, NU>(B);
  out[0] = g.team;
  out[1] = g.threads;
  out[2] = g.blocks;
  out[3] = g.smem;
  cudaError_t e = allow_smem<NX, NU>(g);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[4], riccati_team_kernel<NX, NU>, g.threads, g.smem);
  return static_cast<int>(e);
}

}  // namespace ric

// The C entries of the (nx, nu) instance: the launch (device pointers, N,
// B, the stream; returns cudaGetLastError() after the launch) and its
// geometry at batch B (five ints, ric::report).
#define RIC_ENTRY(nx, nu)                                                      \
  extern "C" int ric_bwd_##nx##x##nu(                                          \
      const float* lx, const float* lu, const float* lxx, const float* luu,    \
      const float* lux, const float* A, const float* Bm, const float* term_g,  \
      const float* term_H, const float* reg, float* kff, float* K, int N,      \
      int B, void* stream) {                                                   \
    return ric::launch<nx, nu>(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H,  \
                               reg, kff, K, N, B, stream);                     \
  }                                                                            \
  extern "C" int ric_geometry_##nx##x##nu(int B, int* out) {                   \
    return ric::report<nx, nu>(B, out);                                        \
  }

// The library of the port holds the four pairs of its controllers.  Built
// with -DRIC_PAIR_NX=nx -DRIC_PAIR_NU=nu, the source gives the entries of
// that pair instead (ops/_cuda.py::build_riccati_pair, any other (nx, nu)
// on its first use).  RIC_ENTRY_ expands the two macros before RIC_ENTRY
// pastes them into the names.
#define RIC_ENTRY_(nx, nu) RIC_ENTRY(nx, nu)
#if defined(RIC_PAIR_NX) && defined(RIC_PAIR_NU)
RIC_ENTRY_(RIC_PAIR_NX, RIC_PAIR_NU)
#else
RIC_ENTRY(2, 1)
RIC_ENTRY(3, 3)
RIC_ENTRY(6, 2)
RIC_ENTRY(9, 5)
#endif
