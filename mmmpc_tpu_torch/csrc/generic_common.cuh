// Device code shared by the two generic fused iLQR kernels
// (generic_fwd.cuh, generic_bwd.cuh) and the formulations that instantiate
// them (generic_<name>.cu): the statics block, the per-call context, small
// helpers, and the C entry points of one formulation.
//
// A formulation is a struct F with
//   static constexpr int NX, NU, NC, NCT, NE;   // NE (terminal equalities) = 0
//   enum { ..., N_EXTRA };                      // its own statics
//   struct Layout { ..., size; };               // offsets in the packed buffer
//   __host__ __device__ static Layout layout(int N, int n_obs, int n_hp);
// plus the forward hooks (dyn, stage, terminal; generic_fwd.cuh) and the
// backward hooks (a_nz, b_nz, dyn_jac, stage_quad, term_quad;
// generic_bwd.cuh).  Its Python twin (controllers/<name>.py) writes the
// packed buffer and the extra statics in the same order; every launch checks
// both sizes against gen_params_size_<name>() / gen_statics_size_<name>().
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cstring>

#include "wholebody_common.cuh"

namespace gen {

using wb::MAX_ALPHA;
constexpr float NEG_BIG = -1e9f;     // value of a masked constraint row
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

// ---- statics, passed by value as a kernel argument.  Layout =
// ops/generic_fwd.py::Formulation.statics: [dt, inv_scale, n_alpha, n_obs, n_hp,
// alphas (MAX_ALPHA), u_lo (NU), u_hi (NU), the formulation's N_EXTRA].
enum : int {
  GST_DT = 0,
  GST_INV_SCALE = 1,
  GST_N_ALPHA = 2,
  GST_N_OBS = 3,
  GST_N_HP = 4,
  GST_ALPHAS = 5,
  GST_ULO = GST_ALPHAS + MAX_ALPHA,
};

template <class F>
struct Statics {
  static constexpr int ULO = GST_ULO;
  static constexpr int UHI = GST_ULO + F::NU;
  static constexpr int EXTRA = GST_ULO + 2 * F::NU;
  static constexpr int SIZE = EXTRA + F::N_EXTRA;
  float v[SIZE];
};

// What the hooks read: the statics, the packed per-problem buffer and its
// layout, and the horizon.
template <class F>
struct Ctx {
  const Statics<F>& st;
  const float* __restrict__ pp;
  typename F::Layout L;
  float dt, inv_scale;
  int N, n_obs, n_hp;

  __device__ __forceinline__ float p(int i) const { return __ldg(pp + i); }
  // the formulation's own static i
  __device__ __forceinline__ float ex(int i) const {
    return st.v[Statics<F>::EXTRA + i];
  }
};

template <class F>
__device__ __forceinline__ Ctx<F> make_ctx(const Statics<F>& st,
                                           const float* pp, int N) {
  const int n_obs = static_cast<int>(st.v[GST_N_OBS]);
  const int n_hp = static_cast<int>(st.v[GST_N_HP]);
  return Ctx<F>{st, pp, F::layout(N, n_obs, n_hp), st.v[GST_DT],
                st.v[GST_INV_SCALE], N, n_obs, n_hp};
}

// e^T M e for a row-major n x n matrix in the packed buffer.
template <int n, class C>
__device__ __forceinline__ float qform(const C& c, int off, const float* e) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < n; ++j) row += c.p(off + i * n + j) * e[j];
    acc += e[i] * row;
  }
  return acc;
}

// u clamped to [lo, hi]; a NaN stays NaN (torch.clamp semantics).
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// a - 2 pi floor((a + pi) / 2 pi): the floored wrap into [-pi, pi) of
// utils/math.wrap_to_pi, written as the base controller's plain version
// writes it (fmodf would truncate toward zero instead).
__device__ __forceinline__ float wrap_pi(float a) {
  return a - TWO_PI_F * floorf((a + PI_F) / TWO_PI_F);
}

// relu(max) of the ground circles (r_obs + radius) - |(px, py) - obs| over
// the n_obs rows [x, y, r] at offset off; with sxy, also its (px, py)
// gradient with the even tie split of the VJP of jnp.max.
template <class C>
__device__ __forceinline__ float ground_slack(const C& c, int off, float px,
                                              float py, float radius,
                                              float* sxy) {
  wb::MaxAcc<2> m;
  m.init();
  for (int o = 0; o < c.n_obs; ++o) {
    const float dx = px - c.p(off + 3 * o);
    const float dy = py - c.p(off + 3 * o + 1);
    const float d = sqrtf(dx * dx + dy * dy + wb::EPS);
    const float g[2] = {-dx / d, -dy / d};
    m.add((c.p(off + 3 * o + 2) + radius) - d, g);
  }
  if (sxy != nullptr) {
    const float gs = m.grad_scale();
    sxy[0] = m.gsum[0] * gs;
    sxy[1] = m.gsum[1] * gs;
  }
  return m.smax();
}

}  // namespace gen

// The C entries of formulation F under the name `name`: launches of both
// kernels (statics is a HOST pointer, copied into the kernel argument; the
// other pointers are device memory; each returns cudaGetLastError() after
// the launch), and the two layout sizes for the wrappers' check.
#define GEN_ENTRIES(name, F)                                                  \
  extern "C" int gen_fwd_##name(                                              \
      const float* statics, const float* params, const float* X,             \
      const float* U, const float* kff, const float* K, const float* lam,    \
      const float* lamt, const float* lame, float* Xc, float* Uc,            \
      float* xlast, float* cost, float mu, int N, int B, void* stream) {     \
    return gen::launch_fwd<F>(statics, params, X, U, kff, K, lam, lamt,      \
                              lame, Xc, Uc, xlast, cost, mu, N, B, stream);  \
  }                                                                           \
  extern "C" int gen_bwd_##name(                                              \
      const float* statics, const float* params, const float* X,             \
      const float* U, const float* lam, const float* lamt, const float* lame, \
      const float* reg, float* kff, float* K, float mu, int N, int B,        \
      void* stream) {                                                         \
    return gen::launch_bwd<F>(statics, params, X, U, lam, lamt, lame, reg,   \
                              kff, K, mu, N, B, stream);                     \
  }                                                                           \
  extern "C" int gen_statics_size_##name() { return gen::Statics<F>::SIZE; } \
  extern "C" int gen_params_size_##name(int N, int n_obs, int n_hp) {        \
    return F::layout(N, n_obs, n_hp).size;                                   \
  }
