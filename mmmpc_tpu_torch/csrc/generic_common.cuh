// Device code shared by the two generic fused iLQR kernels
// (generic_fwd.cuh, generic_bwd.cuh) and the formulations that instantiate
// them (generic_<name>.cu): the statics block, the per-call context, small
// helpers, and the C entry points of one formulation.
//
// A formulation is a struct F with
//   static constexpr int NX, NU, NC, NCT, NE;   // NE (terminal equalities) = 0
//   static constexpr int NREF;                  // width of an X_ref row; Q, P
//                                               // are NREF x NREF
//   static constexpr bool HAS_ULAST;            // it takes U_last
//   enum { ..., N_EXTRA };                      // its own statics
//   struct Layout { ..., size; };               // offsets in the packed buffer
//   __host__ __device__ static Layout layout(int N, int n_obs, int n_hp);
// plus FWD_TEAM, the line search's lanes a candidate, and the hooks of its
// kernel (generic_fwd.cuh): with FWD_TEAM = 0 the one-thread kernel's dyn,
// stage and terminal, else the team kernel's fwd_team_rows, fwd_team_stage
// and fwd_team_terminal; and the backward hooks (a_nz, b_nz, dyn_jac,
// stage_quad, term_quad; generic_bwd.cuh) of the one-thread backward
// kernel.  A formulation that declares BWD_TEAM supplies a_nz, b_nz,
// dyn_jac and the team hooks team_term and team_rows in place of
// stage_quad and term_quad.
// Its Python twin (controllers/<name>.py) writes the packed buffer and the
// extra statics in the same order; every launch checks both sizes against
// gen_params_size_<name>() / gen_statics_size_<name>().
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

// A row-major matrix as the hooks read it, element i by m(i): in the
// packed params through the read-only cache (LdgMat) or in shared memory
// (SmemMat), at a stride (SrcMat: a per-robot operand of the per-scenario
// instance, or its slot in the packed params), or in a per-robot column of
// shared memory, scenario fastest (ColMat).
struct LdgMat {
  const float* __restrict__ p;
  __device__ __forceinline__ float operator()(int i) const { return __ldg(p + i); }
};
struct SmemMat {
  const float* p;
  __device__ __forceinline__ float operator()(int i) const { return p[i]; }
};
struct SrcMat {
  const float* __restrict__ p;
  long long row;
  __device__ __forceinline__ float operator()(int i) const { return __ldg(p + i * row); }
};
template <int SC>
struct ColMat {
  const float* p;
  __device__ __forceinline__ float operator()(int i) const { return p[i * SC]; }
};

// What the hooks read: the statics, the packed per-problem buffer and its
// layout, and the horizon.  Every context has the same readers: p(i), the
// packed buffer's element i; ex(i), the formulation's own static i; the
// references xref(row, i), uref(k, i), ulast(k, i); the matrices mat(off)
// of the packed buffer, and wq(), wp(), the weights Q and P.  Those of the
// shared instances (Ctx, SmemCtx) read all of them in the packed buffer;
// those of kernel C's per-scenario instance (generic_fwd.cuh) read the
// references and the weights where that instance stages them.
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
  __device__ __forceinline__ float xref(int row, int i) const {
    return p(L.xref + row * F::NREF + i);
  }
  __device__ __forceinline__ float uref(int k, int i) const {
    return p(L.uref + k * F::NU + i);
  }
  __device__ __forceinline__ float ulast(int k, int i) const {
    return p(L.ulast + k * F::NU + i);
  }
  __device__ __forceinline__ LdgMat mat(int off) const { return LdgMat{pp + off}; }
  __device__ __forceinline__ LdgMat wq() const { return mat(L.Q); }
  __device__ __forceinline__ LdgMat wp() const { return mat(L.P); }
};

// What the team kernels' hooks read: the statics and the packed params in
// shared memory, their layout, and the horizon (the members and readers of
// Ctx).
template <class F>
struct SmemCtx {
  const float* sv;
  const float* pp;
  typename F::Layout L;
  float dt, inv_scale;
  int N, n_obs, n_hp;

  __device__ __forceinline__ float p(int i) const { return pp[i]; }
  __device__ __forceinline__ float ex(int i) const {
    return sv[Statics<F>::EXTRA + i];
  }
  __device__ __forceinline__ float xref(int row, int i) const {
    return p(L.xref + row * F::NREF + i);
  }
  __device__ __forceinline__ float uref(int k, int i) const {
    return p(L.uref + k * F::NU + i);
  }
  __device__ __forceinline__ float ulast(int k, int i) const {
    return p(L.ulast + k * F::NU + i);
  }
  __device__ __forceinline__ SmemMat mat(int off) const { return SmemMat{pp + off}; }
  __device__ __forceinline__ SmemMat wq() const { return mat(L.Q); }
  __device__ __forceinline__ SmemMat wp() const { return mat(L.P); }
};

template <class F>
__device__ __forceinline__ Ctx<F> make_ctx(const Statics<F>& st,
                                           const float* pp, int N) {
  const int n_obs = static_cast<int>(st.v[GST_N_OBS]);
  const int n_hp = static_cast<int>(st.v[GST_N_HP]);
  return Ctx<F>{st, pp, F::layout(N, n_obs, n_hp), st.v[GST_DT],
                st.v[GST_INV_SCALE], N, n_obs, n_hp};
}

// ---- kernel C's per-scenario instance (K5): the line search of formulation
// F with the entries a robot may own (U_last where F has it, X_ref, U_ref,
// Q, P) read from operands of their own, batch-last, or shared.  The line
// search of generic_fwd.cuh instantiated with PerScenario<F> is that
// instance; F's hooks are the ones of its shared instance, through a
// context whose readers go where the instance stages each entry.
template <class F>
struct PerScenario : F {};

template <class F>
constexpr bool per_scenario_v = false;
template <class F>
constexpr bool per_scenario_v<PerScenario<F>> = true;

// Where the per-scenario instance reads an entry a robot may own: element
// i of scenario b at p[i * row + b * scen], which is the entry's operand,
// batch-last (row = B, scen = 1), or its slot in the packed params, the
// same for every scenario (row = 1, scen = 0).
struct PsSrc {
  const float* p;
  long long row, scen;
};
struct PsOps {
  PsSrc ulast, xref, uref, q, pw;
};

// The sources of one launch at batch B: op = {U_last, X_ref, U_ref, Q, P},
// each a device pointer, or null where the entry is shared (its slot in
// params).  False if F takes no U_last and one is given.
template <class F>
bool ps_sources(const float* params, const float* const* op, int N, int n_obs,
                int n_hp, int B, PsOps& o) {
  const typename F::Layout L = F::layout(N, n_obs, n_hp);
  auto src = [&](const float* p, int slot) {
    return p ? PsSrc{p, B, 1} : PsSrc{params + slot, 1, 0};
  };
  if constexpr (F::HAS_ULAST) {
    o.ulast = src(op[0], L.ulast);
  } else if (op[0] != nullptr) {
    return false;
  }
  o.xref = src(op[1], L.xref);
  o.uref = src(op[2], L.uref);
  o.q = src(op[3], L.Q);
  o.pw = src(op[4], L.P);
  return true;
}

// e^T M e for a row-major n x n matrix m (a context's mat, wq or wp).
template <int n, class M>
__device__ __forceinline__ float qform(const M& m, const float* e) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < n; ++j) row += m(i * n + j) * e[j];
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

constexpr unsigned TEAM_FULL = 0xffffffffu;

// sincosf of NA angles over the T lanes of a team: angle a on lane a % T in
// round a / T, ang(a) giving it there (a known at run time, so ang picks
// by selects), then exchanged by shuffles.  Every lane ends with every
// angle's sine and cosine, the bits of sincosf.
template <int T, int NA, class Ang>
__device__ __forceinline__ void sincos_team(Ang&& ang, int lane, float (&s)[NA],
                                            float (&c)[NA]) {
  constexpr int RA = (NA + T - 1) / T;
  float sa[RA], ca[RA];
#pragma unroll
  for (int ra = 0; ra < RA; ++ra)
    sincosf(ang(min(ra * T + lane, NA - 1)), &sa[ra], &ca[ra]);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    s[a] = __shfl_sync(TEAM_FULL, sa[a / T], a % T, T);
    c[a] = __shfl_sync(TEAM_FULL, ca[a / T], a % T, T);
  }
}

// A relu(max) accumulator merged across the T lanes of a team by a
// butterfly of shuffles: a larger max replaces, equal maxima add their
// counts and gradients, a NaN max stays NaN.  Every lane ends with the
// same accumulator.
template <int T, int NV>
__device__ __forceinline__ void max_acc_team(wb::MaxAcc<NV>& m) {
#pragma unroll
  for (int off = 1; off < T; off <<= 1) {
    const float og = __shfl_xor_sync(TEAM_FULL, m.gmax, off, T);
    const float oc = __shfl_xor_sync(TEAM_FULL, m.cnt, off, T);
    const bool nan = isnan(og) || isnan(m.gmax);
    const bool take = !nan && og > m.gmax;
    const bool add = nan || og == m.gmax;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float o = __shfl_xor_sync(TEAM_FULL, m.gsum[i], off, T);
      m.gsum[i] = take ? o : (add ? m.gsum[i] + o : m.gsum[i]);
    }
    m.cnt = take ? oc : (add ? m.cnt + oc : m.cnt);
    m.gmax = nan ? NAN : (take ? og : m.gmax);
  }
}

// relu(max) of the ground circles (r_obs + radius) - |(px, py) - obs| over
// the n_obs rows [x, y, r] at offset off, and its (px, py) gradient sxy
// with the even tie split of the VJP of jnp.max.  The gradient keeps
// divisions off D.base's chain, which they held for 10% of its time on the
// H100 (PERF.md): a circle's -(px, py - obs) / |.| takes rsqrtf beside the
// exact root of the value, and the split's scale MaxAcc::grad_scale
// multiplies by a correctly rounded reciprocal, which gives its quotient's
// bits (live is 0, 1/2 or 1).
template <class C>
__device__ __forceinline__ float ground_slack(const C& c, int off, float px,
                                              float py, float radius,
                                              float* sxy) {
  wb::MaxAcc<2> m;
  m.init();
  for (int o = 0; o < c.n_obs; ++o) {
    const float dx = px - c.p(off + 3 * o);
    const float dy = py - c.p(off + 3 * o + 1);
    const float dd = dx * dx + dy * dy + wb::EPS;
    const float d = sqrtf(dd);
    const float r = rsqrtf(dd);
    const float g[2] = {-dx * r, -dy * r};
    m.add((c.p(off + 3 * o + 2) + radius) - d, g);
  }
  const float live = m.gmax > 0.f ? 1.f : (m.gmax == 0.f ? 0.5f : 0.f);
  const float gs = m.cnt > 0.f ? live * __frcp_rn(m.cnt) : 0.f;
  sxy[0] = m.gsum[0] * gs;
  sxy[1] = m.gsum[1] * gs;
  return m.smax();
}

// The value of ground_slack over the T lanes of a team (the team line
// searches): circle o on lane o % T, each lane's max merged by a butterfly
// of shuffles when there is more than one circle (NaN stays NaN).  Lane 0
// ends with it; every lane does where there is more than one circle.
template <int T, class C>
__device__ __forceinline__ float ground_value_team(const C& c, int off, float px,
                                                   float py, float radius,
                                                   int lane) {
  float m = -INFINITY;
  for (int o = lane; o < c.n_obs; o += T) {
    const float dx = px - c.p(off + 3 * o);
    const float dy = py - c.p(off + 3 * o + 1);
    const float d = sqrtf(dx * dx + dy * dy + wb::EPS);
    const float v = (c.p(off + 3 * o + 2) + radius) - d;
    m = (v > m || isnan(v)) ? v : m;
  }
  if (c.n_obs > 1) {
#pragma unroll
    for (int step = 1; step < T; step <<= 1) {
      const float v = __shfl_xor_sync(TEAM_FULL, m, step, T);
      m = (v > m || isnan(v)) ? v : m;
    }
  }
  return m < 0.f ? 0.f : m;
}

}  // namespace gen

// The C entries of formulation F under the name `name`: launches of both
// kernels (statics is a HOST pointer, copied into the kernel argument; the
// other pointers are device memory; each returns cudaGetLastError() after
// the launch), the forward's launch geometry at batch B with n_alpha step
// sizes and the backward's at batch B (team, threads, blocks, shared-memory
// bytes), the launch and the geometry of the forward's per-scenario
// instance (gen_fwd_ps_*: the packed params with the shared entries, then
// U_last, X_ref, U_ref, Q, P, each batch-last or null where shared), the
// blocks an SM holds of either forward instance (gen_fwd_occupancy_*:
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, out[0]), and the two
// layout sizes for the wrappers' check.
#define GEN_ENTRIES(name, F)                                                  \
  extern "C" int gen_fwd_##name(                                              \
      const float* statics, const float* params, const float* X,             \
      const float* U, const float* kff, const float* K, const float* lam,    \
      const float* lamt, const float* lame, float* Xc, float* Uc,            \
      float* xlast, float* cost, float mu, int N, int B, void* stream) {     \
    return gen::launch_fwd<F>(statics, params, nullptr, X, U, kff, K, lam,   \
                              lamt, lame, Xc, Uc, xlast, cost, mu, N, B,     \
                              stream);                                        \
  }                                                                           \
  extern "C" int gen_bwd_##name(                                              \
      const float* statics, const float* params, const float* X,             \
      const float* U, const float* lam, const float* lamt, const float* lame, \
      const float* reg, float* kff, float* K, float mu, int N, int B,        \
      void* stream) {                                                         \
    return gen::launch_bwd<F>(statics, params, X, U, lam, lamt, lame, reg,   \
                              kff, K, mu, N, B, stream);                     \
  }                                                                           \
  extern "C" int gen_fwd_geometry_##name(int N, int n_obs, int n_hp,         \
                                         int n_alpha, int B, int* out) {      \
    const gen::FwdGeometry g =                                                \
        gen::fwd_geometry<F>(N, n_obs, n_hp, n_alpha, B);                     \
    out[0] = g.team;                                                          \
    out[1] = g.threads;                                                       \
    out[2] = g.blocks;                                                        \
    out[3] = g.smem;                                                          \
    return 0;                                                                 \
  }                                                                           \
  extern "C" int gen_bwd_geometry_##name(int N, int n_obs, int n_hp, int B,  \
                                         int* out) {                          \
    const gen::BwdGeometry g = gen::bwd_geometry<F>(N, n_obs, n_hp, B);      \
    out[0] = g.team;                                                          \
    out[1] = g.threads;                                                       \
    out[2] = g.blocks;                                                        \
    out[3] = g.smem;                                                          \
    return 0;                                                                 \
  }                                                                           \
  extern "C" int gen_fwd_ps_##name(                                           \
      const float* statics, const float* params, const float* ulast,         \
      const float* xref, const float* uref, const float* q, const float* p,  \
      const float* X, const float* U, const float* kff, const float* K,      \
      const float* lam, const float* lamt, const float* lame, float* Xc,     \
      float* Uc, float* xlast, float* cost, float mu, int N, int B,          \
      void* stream) {                                                         \
    const float* const ops[5] = {ulast, xref, uref, q, p};                    \
    return gen::launch_fwd<gen::PerScenario<F>>(                              \
        statics, params, ops, X, U, kff, K, lam, lamt, lame, Xc, Uc, xlast,   \
        cost, mu, N, B, stream);                                              \
  }                                                                           \
  extern "C" int gen_fwd_ps_geometry_##name(int N, int n_obs, int n_hp,      \
                                            int n_alpha, int B, int* out) {   \
    const gen::FwdGeometry g =                                                \
        gen::fwd_geometry<gen::PerScenario<F>>(N, n_obs, n_hp, n_alpha, B);   \
    out[0] = g.team;                                                          \
    out[1] = g.threads;                                                       \
    out[2] = g.blocks;                                                        \
    out[3] = g.smem;                                                          \
    return 0;                                                                 \
  }                                                                           \
  extern "C" int gen_fwd_occupancy_##name(int N, int n_obs, int n_hp,        \
                                          int n_alpha, int per_scenario,      \
                                          int* out) {                         \
    return per_scenario                                                       \
               ? gen::fwd_occupancy<gen::PerScenario<F>>(N, n_obs, n_hp,      \
                                                         n_alpha, out)        \
               : gen::fwd_occupancy<F>(N, n_obs, n_hp, n_alpha, out);         \
  }                                                                           \
  extern "C" int gen_statics_size_##name() { return gen::Statics<F>::SIZE; } \
  extern "C" int gen_params_size_##name(int N, int n_obs, int n_hp) {        \
    return F::layout(N, n_obs, n_hp).size;                                   \
  }
