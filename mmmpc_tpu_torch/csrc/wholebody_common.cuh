// Device code shared by the two fused whole-body qref kernels
// (wholebody_fwd.cu, wholebody_bwd.cu): the packed parameter layouts, the
// world-frame forward kinematics with its closed-form state partials, the
// slack-group rows, the streaming relu(max) with its even tie split, the
// dynamics step and its sparse Jacobians.
//
// States are x = [px, py, psi, dx, dy, dpsi, q1, q2, q3], inputs
// u = [dV, dw, dq1, dq2, dq3].  All arrays in device memory are batch-last:
// element (i, j, ..., b) of an (n_i, n_j, ..., B) array lies at
// ((i * n_j + j) ...) * B + b, so the threads of a warp, which hold
// neighbouring scenarios b, load and store neighbouring addresses.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wb {

constexpr int NX = 9;
constexpr int NU = 5;
constexpr int NC = 2 * NX + 2 * NU;  // stage PHR rows [x_hi, x_lo, du_hi, du_lo]
constexpr int NCT = 2 * NX;          // terminal PHR rows [x_hi, x_lo]
constexpr int MAX_ALPHA = 8;

// Panda-3DoF DH constants and base-link -> joint-1 offsets (models/arm.py,
// utils/configs.py).
constexpr float A2 = 0.316f;
constexpr float A3 = 0.0825f;
constexpr float A5 = 0.384f;
constexpr float A6 = 0.088f;
constexpr float A7 = 0.107f;
constexpr float BX = -0.007f;
constexpr float BZ = static_cast<float>(0.606 + 0.333);
constexpr float SELF_R = 0.05f;     // self-collision sphere radius
constexpr float EXPAND = 0.03f;     // half-plane push-out margin
constexpr float EPS = 1e-9f;        // safe_norm / safe_dist epsilon

// ---- statics: passed by value as a kernel argument.  Layout =
// ops/wholebody_fwd.py::_STATIC_FIELDS (the wrappers check its size against
// wb_statics_size()).  Masks are 0/1, counts are exact small integers; u
// bounds may be +-inf.
enum : int {
  ST_DT = 0,
  ST_INV_SCALE = 1,
  ST_BASE_RADIUS = 2,
  ST_N_ALPHA = 3,
  ST_N_OBS = 4,
  ST_N_HP = 5,
  ST_XLO = 6,
  ST_XHI = ST_XLO + NX,
  ST_XMLO = ST_XHI + NX,
  ST_XMHI = ST_XMLO + NX,
  ST_DULO = ST_XMHI + NX,
  ST_DUHI = ST_DULO + NU,
  ST_DUMLO = ST_DUHI + NU,
  ST_DUMHI = ST_DUMLO + NU,
  ST_ULO = ST_DUMHI + NU,
  ST_UHI = ST_ULO + NU,
  ST_ALPHAS = ST_UHI + NU,
  ST_SIZE = ST_ALPHAS + MAX_ALPHA,
};

struct Statics {
  float v[ST_SIZE];
};

// ---- the packed per-problem buffer in device memory.  Order =
// ops/wholebody_fwd.py::_PACKED_KEYS (the wrappers check its size against
// wb_params_size()); all row-major.
struct Layout {
  int S, eqm, Q, R, W, P, xref, uref, ulast, obs, hpp, hpn, hpm, size;
};

__host__ __device__ inline Layout param_layout(int N, int n_obs, int n_hp) {
  Layout L;
  int o = 0;
  L.S = o;     o += 1;
  L.eqm = o;   o += 1;
  L.Q = o;     o += NX * NX;
  L.R = o;     o += NU * NU;
  L.W = o;     o += NU * NU;
  L.P = o;     o += NX * NX;
  L.xref = o;  o += (N + 1) * NX;
  L.uref = o;  o += N * NU;
  L.ulast = o; o += N * NU;
  L.obs = o;   o += 3 * n_obs;
  L.hpp = o;   o += 3 * n_hp;
  L.hpn = o;   o += 3 * n_hp;
  L.hpm = o;   o += n_hp;
  L.size = o;
  return L;
}

__device__ __forceinline__ float ld(const float* __restrict__ p, int i) {
  return __ldg(p + i);
}

// ---- arm-frame forward kinematics, for the arm-only controller ----
// (x, z) of (j2, j3, ee) in the arm frame (y == 0) and their q-partials:
// the arm-frame algebra of fk below, written out again: routing fk through
// a shared helper changed how nvcc contracts the whole-body backward
// kernel's float arithmetic, and so its results.
struct ArmFK {
  float ax[3], az[3];  // arm-frame x / z of point p (j2, j3, ee)
  float axq[3][3];     // d ax[p] / d q_i
  float azq[3][3];     // d az[p] / d q_i
};

__device__ __forceinline__ void arm_fk(float q1, float q2, float q3, ArmFK& a) {
  float s1, c1, st, ct, sb, cb;
  sincosf(q1, &s1, &c1);
  const float th = q1 - q2;
  sincosf(th, &st, &ct);
  sincosf(th - q3, &sb, &cb);

  const float ax2 = A2 * s1 + A3 * c1;
  const float az2 = A2 * c1 - A3 * s1;
  const float D3 = A3 * st + A5 * ct;
  const float E3 = A3 * ct - A5 * st;
  const float ax3 = ax2 - A3 * ct + A5 * st;
  const float az3 = az2 + A3 * st + A5 * ct;
  const float P6 = -A6 * sb - A7 * cb;
  const float Q6 = -A6 * cb + A7 * sb;
  a.ax[0] = ax2;
  a.ax[1] = ax3;
  a.ax[2] = ax3 + A6 * cb - A7 * sb;
  a.az[0] = az2;
  a.az[1] = az3;
  a.az[2] = az3 - A6 * sb - A7 * cb;
  a.axq[0][0] = az2;            a.axq[0][1] = 0.f;           a.axq[0][2] = 0.f;
  a.axq[1][0] = az2 + D3;       a.axq[1][1] = -D3;           a.axq[1][2] = 0.f;
  a.axq[2][0] = az2 + D3 + P6;  a.axq[2][1] = -(D3 + P6);    a.axq[2][2] = -P6;
  a.azq[0][0] = -ax2;           a.azq[0][1] = 0.f;           a.azq[0][2] = 0.f;
  a.azq[1][0] = -ax2 + E3;      a.azq[1][1] = -E3;           a.azq[1][2] = 0.f;
  a.azq[2][0] = -ax2 + E3 + Q6; a.azq[2][1] = -(E3 + Q6);    a.azq[2][2] = -Q6;
}

// ---- forward kinematics: world points (j2, j3, ee) and their partials ----
struct FK {
  float cp, sp;        // cos / sin of the base yaw
  float pt[3][3];      // world point p (j2, j3, ee), coordinate c
  float r[3];          // arm-frame x of each point + BX (lever arm)
  float axq[3][3];     // d(arm-frame x of point p) / d q_i
  float azq[3][3];     // d(arm-frame z of point p) / d q_i
};

// Exact sincosf per angle: on this card a sincos costs a few instructions,
// so the TPU kernels' incremental trig carry (a VPU workaround) is not kept.
__device__ __forceinline__ void fk(const float* x, FK& f) {
  float s1, c1, st, ct, sb, cb;
  sincosf(x[6], &s1, &c1);
  const float th = x[6] - x[7];
  sincosf(th, &st, &ct);
  const float be = th - x[8];
  sincosf(be, &sb, &cb);
  sincosf(x[2], &f.sp, &f.cp);

  const float ax2 = A2 * s1 + A3 * c1;
  const float az2 = A2 * c1 - A3 * s1;
  const float D3 = A3 * st + A5 * ct;   // d(-A3 ct + A5 st)/d th
  const float E3 = A3 * ct - A5 * st;   // d( A3 st + A5 ct)/d th
  const float ax3 = ax2 - A3 * ct + A5 * st;
  const float az3 = az2 + A3 * st + A5 * ct;
  const float P6 = -A6 * sb - A7 * cb;  // d( A6 cb - A7 sb)/d be
  const float Q6 = -A6 * cb + A7 * sb;  // d(-A6 sb - A7 cb)/d be
  const float axe = ax3 + A6 * cb - A7 * sb;
  const float aze = az3 - A6 * sb - A7 * cb;

  const float ax[3] = {ax2, ax3, axe};
  const float az[3] = {az2, az3, aze};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    f.r[p] = ax[p] + BX;
    f.pt[p][0] = x[0] + f.r[p] * f.cp;
    f.pt[p][1] = x[1] + f.r[p] * f.sp;
    f.pt[p][2] = az[p] + BZ;
  }
  f.axq[0][0] = az2;            f.axq[0][1] = 0.f;           f.axq[0][2] = 0.f;
  f.axq[1][0] = az2 + D3;       f.axq[1][1] = -D3;           f.axq[1][2] = 0.f;
  f.axq[2][0] = az2 + D3 + P6;  f.axq[2][1] = -(D3 + P6);    f.axq[2][2] = -P6;
  f.azq[0][0] = -ax2;           f.azq[0][1] = 0.f;           f.azq[0][2] = 0.f;
  f.azq[1][0] = -ax2 + E3;      f.azq[1][1] = -E3;           f.azq[1][2] = 0.f;
  f.azq[2][0] = -ax2 + E3 + Q6; f.azq[2][1] = -(E3 + Q6);    f.azq[2][2] = -Q6;
}

// World point a0 j2 + a1 j3 + a2 ee.
__device__ __forceinline__ void combo(const FK& f, float a0, float a1, float a2,
                                      float P[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    P[c] = a0 * f.pt[0][c] + a1 * f.pt[1][c] + a2 * f.pt[2][c];
}

// g += (dP/dx)^T w for P = a0 j2 + a1 j3 + a2 ee.
__device__ __forceinline__ void add_point_grad(const FK& f, float a0, float a1,
                                               float a2, const float w[3],
                                               float g[NX]) {
  const float s = a0 + a1 + a2;
  const float R = a0 * f.r[0] + a1 * f.r[1] + a2 * f.r[2];
  g[0] += w[0] * s;
  g[1] += w[1] * s;
  g[2] += (-w[0] * f.sp + w[1] * f.cp) * R;
  const float wxy = w[0] * f.cp + w[1] * f.sp;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float AX = a0 * f.axq[0][q] + a1 * f.axq[1][q] + a2 * f.axq[2][q];
    const float AZ = a0 * f.azq[0][q] + a1 * f.azq[1][q] + a2 * f.azq[2][q];
    g[6 + q] += wxy * AX + w[2] * AZ;
  }
}

// Coefficients over (j2, j3, ee): self-collision check point minus ee for
// the checks [world origin, j2/2, j2, (j2+j3)/2], and the six half-plane
// sample points [j2/2, j2, (j2+j3)/2, j3, (j3+ee)/2, ee].
static __constant__ float SELF_DIFF[4][3] = {
    {0.f, 0.f, -1.f}, {0.5f, 0.f, -1.f}, {1.f, 0.f, -1.f}, {0.5f, 0.5f, -1.f}};
static __constant__ float HP_POINTS[6][3] = {
    {0.5f, 0.f, 0.f}, {1.f, 0.f, 0.f}, {0.5f, 0.5f, 0.f},
    {0.f, 1.f, 0.f},  {0.f, 0.5f, 0.5f}, {0.f, 0.f, 1.f}};

// ---- relu(max) over a stream of rows, with the even tie split of the VJP
// of jnp.max: the gradient is the mean of the gradients of the rows equal
// to the max, times 1 / 0.5 / 0 for max > 0 / == 0 / < 0.  A NaN row makes
// the max NaN.
template <int NV>
struct MaxAcc {
  float gmax;
  float cnt;
  float gsum[NV];

  __device__ __forceinline__ void init() {
    gmax = -INFINITY;
    cnt = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) gsum[i] = 0.f;
  }
  __device__ __forceinline__ void add(float v, const float* g) {
    const bool gt = v > gmax || isnan(v);
    const bool eq = v == gmax;
    gmax = gt ? v : gmax;
    cnt = gt ? 1.f : (eq ? cnt + 1.f : cnt);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      gsum[i] = gt ? g[i] : (eq ? gsum[i] + g[i] : gsum[i]);
  }
  __device__ __forceinline__ float smax() const {
    return gmax < 0.f ? 0.f : gmax;
  }
  __device__ __forceinline__ float grad_scale() const {
    // an empty group (no rows) has gradient 0, as a group of NEG_BIG rows
    const float live = gmax > 0.f ? 1.f : (gmax == 0.f ? 0.5f : 0.f);
    return cnt > 0.f ? live / cnt : 0.f;
  }
};

// Values only (forward kernel): running max with NaN propagation.
__device__ __forceinline__ void max_in(float& gmax, float v) {
  gmax = (v > gmax || isnan(v)) ? v : gmax;
}

// ---- slack-group rows ----
// Ground circles: (r_obs + r_base) - |(px, py) - obs|.
template <bool GRAD, int NV>
__device__ __forceinline__ void ground_rows(const float* x,
                                            const float* __restrict__ pp,
                                            const Layout& L, int n_obs,
                                            float base_radius, float& gmax,
                                            MaxAcc<NV>* acc) {
  for (int o = 0; o < n_obs; ++o) {
    const float dx = x[0] - ld(pp, L.obs + 3 * o);
    const float dy = x[1] - ld(pp, L.obs + 3 * o + 1);
    const float d = sqrtf(dx * dx + dy * dy + EPS);
    const float v = (ld(pp, L.obs + 3 * o + 2) + base_radius) - d;
    if (GRAD) {
      float g[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) g[i] = 0.f;
      g[0] = -dx / d;
      g[1] = -dy / d;
      acc->add(v, g);
    } else {
      max_in(gmax, v);
    }
  }
}

// Self-collision spheres: SELF_R - |check - ee|.
template <bool GRAD, int NV>
__device__ __forceinline__ void self_rows(const FK& f, float& gmax,
                                          MaxAcc<NV>* acc) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float v3[3];
    combo(f, SELF_DIFF[r][0], SELF_DIFF[r][1], SELF_DIFF[r][2], v3);
    const float n = sqrtf(v3[0] * v3[0] + v3[1] * v3[1] + v3[2] * v3[2] + EPS);
    const float v = SELF_R - n;
    if (GRAD) {
      float g[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) g[i] = 0.f;
      const float w[3] = {-v3[0] / n, -v3[1] / n, -v3[2] / n};
      add_point_grad(f, SELF_DIFF[r][0], SELF_DIFF[r][1], SELF_DIFF[r][2], w, g);
      acc->add(v, g);
    } else {
      max_in(gmax, v);
    }
  }
}

// Half-plane unions: for each sample point P, -max over live faces of
// n . (o - P), o the face point pushed out by EXPAND; NEG_BIG (never the
// max) when no face is live.  The gradient is the tie-split mean of the
// maximal faces' normals, pulled back through dP/dx.
template <bool GRAD, int NV>
__device__ __forceinline__ void halfplane_rows(const FK& f,
                                               const float* __restrict__ pp,
                                               const Layout& L, int n_hp,
                                               float& gmax, MaxAcc<NV>* acc) {
  float live = 0.f;
  for (int h = 0; h < n_hp; ++h) live += ld(pp, L.hpm + h);
  if (!(live > 0.f)) return;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float P[3];
    combo(f, HP_POINTS[r][0], HP_POINTS[r][1], HP_POINTS[r][2], P);
    float dmax = -INFINITY;
    for (int h = 0; h < n_hp; ++h) {
      float d = -1e9f;
      if (ld(pp, L.hpm + h) > 0.f) {
        d = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float nc = ld(pp, L.hpn + 3 * h + c);
          d += nc * ((ld(pp, L.hpp + 3 * h + c) - EXPAND * nc) - P[c]);
        }
      }
      dmax = (d > dmax || isnan(d)) ? d : dmax;
    }
    const float v = -dmax;
    if (GRAD) {
      float nsum[3] = {0.f, 0.f, 0.f};
      float cnt = 0.f;
      for (int h = 0; h < n_hp; ++h) {
        float d = -1e9f;
        if (ld(pp, L.hpm + h) > 0.f) {
          d = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float nc = ld(pp, L.hpn + 3 * h + c);
            d += nc * ((ld(pp, L.hpp + 3 * h + c) - EXPAND * nc) - P[c]);
          }
        }
        if (d == dmax) {
          cnt += 1.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) nsum[c] += ld(pp, L.hpn + 3 * h + c);
        }
      }
      float g[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) g[i] = 0.f;
      const float w[3] = {nsum[0] / cnt, nsum[1] / cnt, nsum[2] / cnt};
      add_point_grad(f, HP_POINTS[r][0], HP_POINTS[r][1], HP_POINTS[r][2], w, g);
      acc->add(v, g);
    } else {
      max_in(gmax, v);
    }
  }
}

// ---- dynamics ----
__device__ __forceinline__ void step(const float* x, const float* u, float dt,
                                     float cp, float sp, float* xn) {
  xn[0] = x[0] + dt * x[3];
  xn[1] = x[1] + dt * x[4];
  xn[2] = x[2] + dt * x[5];
  xn[3] = x[3] + dt * (u[0] * cp - x[4] * x[5]);
  xn[4] = x[4] + dt * (u[0] * sp + x[3] * x[5]);
  xn[5] = x[5] + dt * u[1];
  xn[6] = x[6] + dt * u[2];
  xn[7] = x[7] + dt * u[3];
  xn[8] = x[8] + dt * u[4];
}

// The live entries of A = I + E and B of wholebody_step's Jacobians
// (models/mobile_manipulator.py::wholebody_jacobians).
struct Jac {
  float dt, a32, a34, a35, a42, a43, a45, b30, b40;
};

__device__ __forceinline__ Jac jacobians(const float* x, const float* u,
                                         float dt, float cp, float sp) {
  Jac J;
  J.dt = dt;
  J.a32 = -dt * u[0] * sp;
  J.a34 = -dt * x[5];
  J.a35 = -dt * x[4];
  J.a42 = dt * u[0] * cp;
  J.a43 = dt * x[5];
  J.a45 = dt * x[3];
  J.b30 = dt * cp;
  J.b40 = dt * sp;
  return J;
}

// out = A^T v (out may not alias v).
__device__ __forceinline__ void At_v(const Jac& J, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < NX; ++i) out[i] = v[i];
  out[2] += J.a32 * v[3] + J.a42 * v[4];
  out[3] += J.dt * v[0] + J.a43 * v[4];
  out[4] += J.dt * v[1] + J.a34 * v[3];
  out[5] += J.dt * v[2] + J.a35 * v[3] + J.a45 * v[4];
}

// out = B^T v.
__device__ __forceinline__ void Bt_v(const Jac& J, const float* v, float* out) {
  out[0] = J.b30 * v[3] + J.b40 * v[4];
  out[1] = J.dt * v[5];
  out[2] = J.dt * v[6];
  out[3] = J.dt * v[7];
  out[4] = J.dt * v[8];
}

}  // namespace wb
