// Generic fused forward rollout + parallel line search, for NVIDIA Hopper
// (sm_90a), instantiated once per formulation (generic_<name>.cu).
//
// Replaces the Pallas TPU kernel mmmpc_tpu/ops/generic_fwd.py::kernel (built
// by make_generic_fwd_linesearch from a formulation's LanesHooks).  For every
// scenario b and step size alpha it rolls the closed-loop policy over the
// horizon,
//     u_k     = clamp(U_k + alpha kff_k + K_k (x_k - X_k))
//     cost   += inv_scale stage(x_k, u_k) + PHR(stage rows, lam_k, mu)
//     x_{k+1} = dyn(x_k, u_k)
// and adds inv_scale terminal(x_N) + PHR(terminal rows, lam_t, mu).  A
// masked row has the value NEG_BIG and stays in the PHR sum, where it adds
// -lam^2 / (2 mu), as in the JAX package's core.al_stage.  The plain
// PyTorch version is ops/generic_fwd.py::plain_fwd.
//
// The formulation F supplies, besides the members listed in
// generic_common.cuh:
//   dyn(x, u, c, xn)            x_{k+1}
//   stage(x, u, k, c, g) -> raw stage cost; writes the NC row values g
//   terminal(x, c, gt)   -> raw terminal cost; writes the NCT row values gt
//
// What bounds it on this card: one thread runs a serial recurrence of N
// stages (a few sincosf and a few hundred dependent FLOPs per stage), so the
// time is that chain's latency; with one thread per (scenario, alpha) the
// bench shape (B = 8192, 3 step sizes) gives 192 blocks of 128 on 132 SMs.
// Bytes are small: X, U, kff, K, lam in, the candidates out.
//
// Design: as csrc/wholebody_fwd.cu, a loop over the stages inside the thread
// with x and the running cost in registers; batch-last loads and stores
// coalesce across the warp; the packed buffer is read through the read-only
// cache; the statics are a __grid_constant__ kernel argument.
#pragma once

#include "generic_common.cuh"

namespace gen {

template <class F>
__global__ void __launch_bounds__(128)
generic_fwd_kernel(const __grid_constant__ Statics<F> st,
                   const float* __restrict__ pp, const float* __restrict__ X,
                   const float* __restrict__ U, const float* __restrict__ kff,
                   const float* __restrict__ K, const float* __restrict__ lam,
                   const float* __restrict__ lamt, float* __restrict__ Xc,
                   float* __restrict__ Uc, float* __restrict__ xlast,
                   float* __restrict__ cost, float mu, int N, int B) {
  constexpr int NX = F::NX, NU = F::NU, NC = F::NC, NCT = F::NCT;
  static_assert(F::NE == 0, "the generic kernels take no terminal equality");
  const int n_alpha = static_cast<int>(st.v[GST_N_ALPHA]);
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(n_alpha) * B) return;
  const int a = static_cast<int>(t / B);
  const int b = static_cast<int>(t % B);

  const Ctx<F> c = make_ctx<F>(st, pp, N);
  const float alpha = st.v[GST_ALPHAS + a];
  const float inv2mu = 0.5f / mu;

  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = X[i * B + b];
  float acc = 0.f;

  for (int k = 0; k < N; ++k) {
    // ---- control: feedforward + feedback, clamped to the input box
    float dxk[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) dxk[j] = x[j] - X[(k * NX + j) * B + b];
    float u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float fb = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) fb += K[((k * NU + i) * NX + j) * B + b] * dxk[j];
      const float v = U[(k * NU + i) * B + b] + alpha * kff[(k * NU + i) * B + b] + fb;
      u[i] = clampf(v, st.v[Statics<F>::ULO + i], st.v[Statics<F>::UHI + i]);
    }

    // ---- scaled stage cost + PHR over its rows (masked rows included)
    float g[NC > 0 ? NC : 1];
    const float raw = F::stage(x, u, k, c, g);
    float pen = 0.f;
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const float l = lam[(k * NC + r) * B + b];
      const float tr = fmaxf(l + mu * g[r], 0.f);
      pen += tr * tr - l * l;
    }
    acc += c.inv_scale * raw + pen * inv2mu;

    // ---- outputs + carry
#pragma unroll
    for (int i = 0; i < NX; ++i) Xc[((k * n_alpha + a) * NX + i) * B + b] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) Uc[((k * n_alpha + a) * NU + i) * B + b] = u[i];
    float xn[NX];
    F::dyn(x, u, c, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }

  // ---- terminal AL cost
  float gt[NCT > 0 ? NCT : 1];
  const float rawN = F::terminal(x, c, gt);
  float pen = 0.f;
#pragma unroll
  for (int r = 0; r < NCT; ++r) {
    const float l = lamt[r * B + b];
    const float tr = fmaxf(l + mu * gt[r], 0.f);
    pen += tr * tr - l * l;
  }
  acc += c.inv_scale * rawN + pen * inv2mu;

#pragma unroll
  for (int i = 0; i < NX; ++i) xlast[(a * NX + i) * B + b] = x[i];
  cost[a * B + b] = acc;
}

template <class F>
int launch_fwd(const float* statics, const float* params, const float* X,
               const float* U, const float* kff, const float* K,
               const float* lam, const float* lamt, const float* /*lame*/,
               float* Xc, float* Uc, float* xlast, float* cost, float mu,
               int N, int B, void* stream) {
  Statics<F> st;
  std::memcpy(st.v, statics, sizeof(st.v));
  const long long total =
      static_cast<long long>(st.v[GST_N_ALPHA]) * static_cast<long long>(B);
  if (total <= 0 || N <= 0) return 0;
  const int threads = 128;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  generic_fwd_kernel<F><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, params, X, U, kff, K, lam, lamt, Xc, Uc, xlast, cost, mu, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gen
