// Fused forward rollout + parallel line search of the whole-body qref MPC,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mmmpc_tpu/ops/wholebody_fwd.py::_kernel
// (built by make_fwd_linesearch).  For every scenario b and step size alpha
// it rolls the closed-loop policy over the horizon,
//     u_k     = clamp(U_k + alpha kff_k + K_k (x_k - X_k))
//     cost   += inv_scale (tracking + S relu(max slack)^2) + PHR(boxes)
//     x_{k+1} = f(x_k, u_k)
// and adds the terminal AL cost on the last stage.  The plain PyTorch version
// of the same function is ops/wholebody_fwd.py::FwdLinesearch.plain.
//
// What bounds it on this card: each thread runs a serial recurrence of N
// stages (three sincosf, a few hundred dependent FLOPs per stage), so the
// time is the per-thread latency of that chain, not bytes: a call reads about
// 92 floats per (stage, scenario) and writes 14 per (stage, scenario, alpha),
// under 100 MB at the bench shape.  With one thread per (scenario, alpha)
// the bench shape gives 24576 threads, 768 warps: under 6 per SM on 132 SMs,
// too few to hide much of the chain's latency.
//
// Design: the TPU kernel's grid walked (batch tile, stage) with the carry in
// VMEM scratch; here a loop over the stages inside the thread keeps x, the
// cost and the FK in registers.  Loads and stores are batch-last and
// coalesce across the warp.  Shared weights, references and geometry are
// read from one packed buffer through the read-only cache; bounds, masks,
// step sizes and constants arrive by value as a kernel argument.  sincosf is
// evaluated exactly at every stage (the TPU kernel's incremental trig carry
// worked around its slow VPU transcendentals).
#include <cstring>

#include "wholebody_common.cuh"

namespace wb {

// u clamped to [lo, hi]; a NaN stays NaN (jnp.clip semantics).
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// e^T M e for a row-major n x n matrix in the packed buffer.
template <int n>
__device__ __forceinline__ float qform(const float* __restrict__ pp, int off,
                                       const float* e) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < n; ++j) row += ld(pp, off + i * n + j) * e[j];
    acc += e[i] * row;
  }
  return acc;
}

// PHR term of one box row: max(lam + mu c, 0)^2 - lam^2 (the 1/(2 mu) is
// applied once to the sum).  A masked row (infinite bound) has c = -inf in
// effect: only -lam^2 remains.
__device__ __forceinline__ float phr(float lam, float mu, float c, bool live) {
  const float t = live ? fmaxf(lam + mu * c, 0.f) : 0.f;
  return t * t - lam * lam;
}

__global__ void __launch_bounds__(128)
fwd_kernel(const Statics st, const float* __restrict__ pp,
           const float* __restrict__ X, const float* __restrict__ U,
           const float* __restrict__ kff, const float* __restrict__ K,
           const float* __restrict__ lam, const float* __restrict__ lamt,
           const float* __restrict__ lame, float* __restrict__ Xc,
           float* __restrict__ Uc, float* __restrict__ xlast,
           float* __restrict__ cost, float mu, int N, int B) {
  const int n_alpha = static_cast<int>(st.v[ST_N_ALPHA]);
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(n_alpha) * B) return;
  const int a = static_cast<int>(t / B);
  const int b = static_cast<int>(t % B);

  const float dt = st.v[ST_DT];
  const float inv_scale = st.v[ST_INV_SCALE];
  const float base_radius = st.v[ST_BASE_RADIUS];
  const int n_obs = static_cast<int>(st.v[ST_N_OBS]);
  const int n_hp = static_cast<int>(st.v[ST_N_HP]);
  float alpha = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_ALPHA; ++i)
    alpha = (i == a) ? st.v[ST_ALPHAS + i] : alpha;
  const Layout L = param_layout(N, n_obs, n_hp);
  const float S = ld(pp, L.S);
  const float inv2mu = 0.5f / mu;

  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = X[i * B + b];
  float acc = 0.f;
  FK f;

  for (int k = 0; k < N; ++k) {
    // ---- control: feedforward + feedback, clamped to ulim
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
      u[i] = clampf(v, st.v[ST_ULO + i], st.v[ST_UHI + i]);
    }

    // ---- slack group of x_k (ground + self-collision + half-planes)
    fk(x, f);
    float gmax = -INFINITY;
    ground_rows<false, 1>(x, pp, L, n_obs, base_radius, gmax, nullptr);
    self_rows<false, 1>(f, gmax, nullptr);
    halfplane_rows<false, 1>(f, pp, L, n_hp, gmax, nullptr);

    float xn[NX];
    step(x, u, dt, f.cp, f.sp, xn);
    if (k == N - 1) {
      // terminal self-collision rides stage N-1's slack group (the
      // reference's stale slack index)
      FK fn;
      fk(xn, fn);
      self_rows<false, 1>(fn, gmax, nullptr);
    }
    const float smax = gmax < 0.f ? 0.f : gmax;

    // ---- quadratic tracking costs
    float ex[NX], eu[NU], edu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) ex[i] = x[i] - ld(pp, L.xref + k * NX + i);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      eu[i] = u[i] - ld(pp, L.uref + k * NU + i);
      edu[i] = u[i] - ld(pp, L.ulast + k * NU + i);
    }
    const float track = qform<NX>(pp, L.Q, ex) + qform<NU>(pp, L.R, eu) +
                        qform<NU>(pp, L.W, edu);

    // ---- PHR penalty on the box rows [x_hi, x_lo, du_hi, du_lo]
    const float* lk = lam + static_cast<long long>(k) * NC * B + b;
    float pen = 0.f;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      pen += phr(lk[i * B], mu, x[i] - st.v[ST_XHI + i], st.v[ST_XMHI + i] != 0.f);
      pen += phr(lk[(NX + i) * B], mu, st.v[ST_XLO + i] - x[i],
                 st.v[ST_XMLO + i] != 0.f);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      pen += phr(lk[(2 * NX + i) * B], mu, edu[i] - st.v[ST_DUHI + i],
                 st.v[ST_DUMHI + i] != 0.f);
      pen += phr(lk[(2 * NX + NU + i) * B], mu, st.v[ST_DULO + i] - edu[i],
                 st.v[ST_DUMLO + i] != 0.f);
    }
    acc += inv_scale * (track + S * smax * smax) + pen * inv2mu;

    // ---- outputs + carry
#pragma unroll
    for (int i = 0; i < NX; ++i) Xc[((k * n_alpha + a) * NX + i) * B + b] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) Uc[((k * n_alpha + a) * NU + i) * B + b] = u[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }

  // ---- terminal AL cost: P tracking + S relu(max terminal slack)^2 + PHR
  // on the terminal boxes + the maskable position equality.  The terminal
  // slack group has no self-collision rows: they rode stage N-1's.
  fk(x, f);
  float gmax = -INFINITY;
  ground_rows<false, 1>(x, pp, L, n_obs, base_radius, gmax, nullptr);
  halfplane_rows<false, 1>(f, pp, L, n_hp, gmax, nullptr);
  const float smax = gmax < 0.f ? 0.f : gmax;

  float ex[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) ex[i] = x[i] - ld(pp, L.xref + N * NX + i);
  const float track = qform<NX>(pp, L.P, ex);

  float pen = 0.f;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    pen += phr(lamt[i * B + b], mu, x[i] - st.v[ST_XHI + i], st.v[ST_XMHI + i] != 0.f);
    pen += phr(lamt[(NX + i) * B + b], mu, st.v[ST_XLO + i] - x[i],
               st.v[ST_XMLO + i] != 0.f);
  }
  const float m = ld(pp, L.eqm);
  float peneq = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float h = m * ex[i];
    peneq += lame[i * B + b] * h + 0.5f * mu * h * h;
  }
  acc += inv_scale * (track + S * smax * smax) + pen * inv2mu + peneq;

#pragma unroll
  for (int i = 0; i < NX; ++i) xlast[(a * NX + i) * B + b] = x[i];
  cost[a * B + b] = acc;
}

}  // namespace wb

// C entry: statics is a HOST pointer (copied into the kernel argument); all
// other pointers are device memory.  Returns cudaGetLastError() after the
// launch.
extern "C" int wb_fwd_launch(const float* statics, const float* params,
                             const float* X, const float* U, const float* kff,
                             const float* K, const float* lam,
                             const float* lamt, const float* lame, float* Xc,
                             float* Uc, float* xlast, float* cost, float mu,
                             int N, int B, void* stream) {
  wb::Statics st;
  std::memcpy(st.v, statics, sizeof(st.v));
  const long long total =
      static_cast<long long>(st.v[wb::ST_N_ALPHA]) * static_cast<long long>(B);
  if (total <= 0 || N <= 0) return 0;
  const int threads = 128;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  wb::fwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, params, X, U, kff, K, lam, lamt, lame, Xc, Uc, xlast, cost, mu, N, B);
  return static_cast<int>(cudaGetLastError());
}

// Sizes of the two host-built blocks, for the wrappers' layout check.
extern "C" int wb_statics_size() { return wb::ST_SIZE; }

extern "C" int wb_params_size(int N, int n_obs, int n_hp) {
  return wb::param_layout(N, n_obs, n_hp).size;
}
