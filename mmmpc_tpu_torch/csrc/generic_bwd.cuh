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
// K = -Quu^-1 Qux), the value update, and Vxx symmetrised.  The plain
// PyTorch version is ops/generic_bwd.py::plain_bwd.
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

namespace gen {

// The Q blocks of one stage (q.xx holds Vxx between stages) and the PHR row
// assembly of ops/generic_bwd.py::_al_rows_stage / _al_rows_term: for a
// live row c <= 0 with multiplier lam, t = max(lam + mu c, 0) adds t dc to
// the gradient and mu [t > 0] dc dc^T to the Hessian.  Masked rows are
// skipped.
template <int NX, int NU>
struct QBlocks {
  float x[NX], u[NU];
  float xx[NX][NX], uu[NU][NU], ux[NU][NX];
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
    float A[NX][NX], Bm[NX][NU];
    F::dyn_jac(x, u, c, A, Bm);

    // ---- Q blocks of the next value function.  Sums start at -0.f, the
    // identity of float addition, so a single live term folds to itself.
    //   Qx = A^T Vx, Qu = B^T Vx, Quu = B^T Vxx B
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = -0.f;
#pragma unroll
      for (int p = 0; p < NX; ++p)
        if (F::a_nz(p, i)) s += A[p][i] * Vx[p];
      q.x[i] = s;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float s = -0.f;
#pragma unroll
      for (int p = 0; p < NX; ++p)
        if (F::b_nz(p, i)) s += Bm[p][i] * Vx[p];
      q.u[i] = s;
    }
    {
      float VB[NX][NU];
#pragma unroll
      for (int p = 0; p < NX; ++p) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          float s = -0.f;
#pragma unroll
          for (int r = 0; r < NX; ++r)
            if (F::b_nz(r, j)) s += q.xx[p][r] * Bm[r][j];
          VB[p][j] = s;
        }
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          float s = -0.f;
#pragma unroll
          for (int p = 0; p < NX; ++p)
            if (F::b_nz(p, i)) s += Bm[p][i] * VB[p][j];
          q.uu[i][j] = s;
        }
      }
    }
    // Vxx <- Vxx A in place, row by row
#pragma unroll
    for (int p = 0; p < NX; ++p) {
      float row[NX];
#pragma unroll
      for (int r = 0; r < NX; ++r) row[r] = q.xx[p][r];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = -0.f;
#pragma unroll
        for (int r = 0; r < NX; ++r)
          if (F::a_nz(r, j)) s += row[r] * A[r][j];
        q.xx[p][j] = s;
      }
    }
    // Qux = B^T (Vxx A)
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = -0.f;
#pragma unroll
        for (int p = 0; p < NX; ++p)
          if (F::b_nz(p, i)) s += Bm[p][i] * q.xx[p][j];
        q.ux[i][j] = s;
      }
    }
    // Qxx = A^T (Vxx A) in place, column by column
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float col[NX];
#pragma unroll
      for (int p = 0; p < NX; ++p) col[p] = q.xx[p][j];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float s = -0.f;
#pragma unroll
        for (int p = 0; p < NX; ++p)
          if (F::a_nz(p, i)) s += A[p][i] * col[p];
        q.xx[i][j] = s;
      }
    }

    // ---- + the scaled stage model and its PHR rows
    q.lam = lam + static_cast<long long>(k) * NC * B + b;
    F::stage_quad(x, u, k, c, q);

    // ---- Cholesky of Quu + reg I (pivot reciprocals: substitutions
    // multiply), then [kff | K] = -(Quu + reg I)^-1 [Qu | Qux]
    float Lc[NU][NU], Dinv[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = q.uu[i][j] + (i == j ? rg : 0.f);
#pragma unroll
        for (int p = 0; p < j; ++p) s -= Lc[i][p] * Lc[j][p];
        if (i == j) {
          const float r = sqrtf(s);
          Dinv[i] = 1.f / r;
          Lc[i][i] = r;
        } else {
          Lc[i][j] = s * Dinv[j];
        }
      }
    }
    float kf[NU], Kg[NU][NX];
#pragma unroll
    for (int cc = 0; cc < 1 + NX; ++cc) {
      float y[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float s = cc == 0 ? q.u[i] : q.ux[i][cc - 1];
#pragma unroll
        for (int p = 0; p < i; ++p) s -= Lc[i][p] * y[p];
        y[i] = s * Dinv[i];
      }
      float z[NU];
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int p = i + 1; p < NU; ++p) s -= Lc[p][i] * z[p];
        z[i] = s * Dinv[i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if (cc == 0) kf[i] = -z[i];
        else Kg[i][cc - 1] = -z[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      kff_out[(k * NU + i) * B + b] = kf[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) K_out[((k * NU + i) * NX + j) * B + b] = Kg[i][j];
    }

    // ---- value update (Quu without reg):
    //   Vx  = Qx + K^T (Quu kff + Qu) + Qux^T kff
    //   Vxx = Qxx + K^T M + Qux^T K with M = Quu K + Qux, symmetrised
    float w[NU];
#pragma unroll
    for (int p = 0; p < NU; ++p) {
      float s = q.u[p];
#pragma unroll
      for (int r = 0; r < NU; ++r) s += q.uu[p][r] * kf[r];
      w[p] = s;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = q.x[i];
#pragma unroll
      for (int p = 0; p < NU; ++p) s += Kg[p][i] * w[p] + q.ux[p][i] * kf[p];
      Vx[i] = s;
    }
    float Mk[NU][NX];
#pragma unroll
    for (int p = 0; p < NU; ++p) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = q.ux[p][j];
#pragma unroll
        for (int r = 0; r < NU; ++r) s += q.uu[p][r] * Kg[r][j];
        Mk[p][j] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = i; j < NX; ++j) {
        float vij = q.xx[i][j], vji = q.xx[j][i];
#pragma unroll
        for (int p = 0; p < NU; ++p) {
          vij += Kg[p][i] * Mk[p][j] + q.ux[p][i] * Kg[p][j];
          vji += Kg[p][j] * Mk[p][i] + q.ux[p][j] * Kg[p][i];
        }
        const float v = 0.5f * (vij + vji);
        q.xx[i][j] = v;
        q.xx[j][i] = v;
      }
    }
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
