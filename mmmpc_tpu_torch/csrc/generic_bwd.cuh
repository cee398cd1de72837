// Generic fused AL expansion + Riccati backward sweep, for NVIDIA Hopper
// (sm_90a), instantiated once per formulation (generic_<name>.cu).
//
// Replaces the Pallas TPU kernel mmmpc_tpu/ops/generic_bwd.py::kernel (built
// by make_generic_bwd_fused from a formulation's BwdHooks, with
// _al_rows_stage, _al_rows_term and ops/entry_algebra.py::riccati_stage).
// Per scenario: the terminal expansion gives (Vx, Vxx); then, backward over
// the stages, the Q blocks of the next value function through the
// dynamics Jacobians, plus the stage's scaled Gauss-Newton model and its PHR
// rows, one Riccati step (Cholesky of Quu + reg I, kff = -Quu^-1 Qu,
// K = -Quu^-1 Qux), the value update, and Vxx symmetrised: the step is
// ric::riccati_step (riccati_step.cuh), which kernel E shares with dense
// Jacobians.  The plain PyTorch version is ops/generic_bwd.py::plain_bwd.
//
// The formulation F supplies, besides the members listed in
// generic_common.cuh:
//   a_nz(i, j), b_nz(i, j)      constexpr: the structurally nonzero entries
//                               of A = df/dx and B = df/du
//   dyn_jac(x, u, c, A, Bm)     their values (entries outside the masks are
//                               never read)
//   stage_quad(x, u, k, c, q)   adds the scaled stage model into the Q blocks
//                               q.x, q.u, q.xx, q.uu, q.ux and declares its
//                               rows through q.box_x / q.box_u / q.row_x
//   term_quad(x, c, q)          the same for the terminal (q.x, q.xx)
// Every array index in the hooks and the loops here is a constant after
// unrolling, so the arrays live in registers and the masks fold at compile
// time (the counterpart of the TPU kernel's trace-time literal folding;
// nvcc may not fold x * 0.f, so zeros are skipped, never multiplied).
//
// What bounds it on this card: a serial recurrence of N stages per thread,
// each a few thousand dependent FLOPs on an NX x NX value function, and
// registers: Vxx and the Q blocks are live together.  At the bench batch of
// 8192 the grid is 64 blocks of 128 threads on 132 SMs.
#pragma once

#include "generic_common.cuh"
#include "riccati_step.cuh"

namespace gen {

// The Q blocks of one stage (q.xx holds Vxx between stages) and the PHR row
// assembly of ops/generic_bwd.py::_al_rows_stage / _al_rows_term: for a
// live row c <= 0 with multiplier lam, t = max(lam + mu c, 0) adds t dc to
// the gradient and mu [t > 0] dc dc^T to the Hessian.  Masked rows are
// skipped.
template <int NX, int NU>
struct QBlocks : ric::QStage<NX, NU> {
  using ric::QStage<NX, NU>::x;
  using ric::QStage<NX, NU>::u;
  using ric::QStage<NX, NU>::xx;
  using ric::QStage<NX, NU>::uu;
  const float* lam;  // the multipliers of the current rows: row r at lam[r * B]
  int B;
  float mu;

  // row whose gradient is sign * e_i in x
  __device__ __forceinline__ void box_x(int r, bool live, float val, int i,
                                        float sign) {
    if (!live) return;
    const float t = fmaxf(lam[r * B] + mu * val, 0.f);
    x[i] += sign * t;
    xx[i][i] += t > 0.f ? mu : 0.f;
  }
  // row whose gradient is sign * e_i in u
  __device__ __forceinline__ void box_u(int r, bool live, float val, int i,
                                        float sign) {
    if (!live) return;
    const float t = fmaxf(lam[r * B] + mu * val, 0.f);
    u[i] += sign * t;
    uu[i][i] += t > 0.f ? mu : 0.f;
  }
  // row with a dense gradient gx in x (none in u)
  __device__ __forceinline__ void row_x(int r, float val, const float* gx) {
    const float t = fmaxf(lam[r * B] + mu * val, 0.f);
    const float ma = t > 0.f ? mu : 0.f;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i] += t * gx[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const float h = ma * (gx[i] * gx[j]);
        xx[i][j] += h;
        if (j != i) xx[j][i] += h;
      }
    }
  }
};

// The formulation's dynamics Jacobians in registers, with its masks.
template <class F>
struct JacRegs {
  float A[F::NX][F::NX], Bm[F::NX][F::NU];
  __host__ __device__ static constexpr bool a_nz(int i, int j) {
    return F::a_nz(i, j);
  }
  __host__ __device__ static constexpr bool b_nz(int i, int j) {
    return F::b_nz(i, j);
  }
  __device__ __forceinline__ float a(int i, int j) const { return A[i][j]; }
  __device__ __forceinline__ float b(int i, int j) const { return Bm[i][j]; }
};

template <class F>
__global__ void __launch_bounds__(128)
generic_bwd_kernel(const __grid_constant__ Statics<F> st,
                   const float* __restrict__ pp, const float* __restrict__ X,
                   const float* __restrict__ U, const float* __restrict__ lam,
                   const float* __restrict__ lamt,
                   const float* __restrict__ reg, float* __restrict__ kff_out,
                   float* __restrict__ K_out, float mu, int N, int B) {
  constexpr int NX = F::NX, NU = F::NU, NC = F::NC;
  static_assert(F::NE == 0, "the generic kernels take no terminal equality");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const Ctx<F> c = make_ctx<F>(st, pp, N);
  const float rg = reg[b];
  QBlocks<NX, NU> q;
  q.B = B;
  q.mu = mu;
  float Vx[NX];

  // ---------------- terminal expansion -> Vx, Vxx (= q.xx) ----------------
  {
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i] = X[(N * NX + i) * B + b];
      q.x[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) q.xx[i][j] = 0.f;
    }
    q.lam = lamt + b;
    F::term_quad(x, c, q);
#pragma unroll
    for (int i = 0; i < NX; ++i) Vx[i] = q.x[i];
  }

  // ---------------- backward over the stages ----------------
  for (int k = N - 1; k >= 0; --k) {
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = X[(k * NX + i) * B + b];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = U[(k * NU + i) * B + b];
    JacRegs<F> jac;
    F::dyn_jac(x, u, c, jac.A, jac.Bm);

    // ---- one Riccati step, the stage's scaled model and PHR rows added
    // between the Q-block products and the Cholesky
    ric::riccati_step<NX, NU>(
        jac, [&]() {
          q.lam = lam + static_cast<long long>(k) * NC * B + b;
          F::stage_quad(x, u, k, c, q);
        },
        q, Vx, rg, kff_out + static_cast<long long>(k) * NU * B + b,
        K_out + static_cast<long long>(k) * NU * NX * B + b, B);
  }
}

template <class F>
int launch_bwd(const float* statics, const float* params, const float* X,
               const float* U, const float* lam, const float* lamt,
               const float* /*lame*/, const float* reg, float* kff, float* K,
               float mu, int N, int B, void* stream) {
  Statics<F> st;
  std::memcpy(st.v, statics, sizeof(st.v));
  if (B <= 0 || N <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  generic_bwd_kernel<F><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, params, X, U, lam, lamt, reg, kff, K, mu, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gen
