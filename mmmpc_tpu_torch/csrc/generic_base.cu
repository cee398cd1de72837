// The diff-drive base (controllers/base.py) on the generic fused kernels:
// x = [px, py, psi, dx, dy, dpsi], u = [dV, dw], tracking with the floored
// yaw wrap, the ground circles as the exact slack penalty M relu(max g)^2,
// and the five-wide box on (px, py, dx, dy, dpsi) at every stage and at the
// terminal.  Hooks of mmmpc_tpu/controllers/base.py::lanes_fwd_factory /
// lanes_bwd_factory.
//
// Both kernels run one thread a scenario (candidate): the line search on
// generic_fwd.cuh's one-thread kernel (C.base), the fused backward on
// generic_bwd.cuh's one-thread kernel with its stage buffer (D.base), its
// circles' gradient without divisions (ground_slack): 0.0292 ms a launch
// against 0.0377 before both.  On the team Riccati step (BWD_TEAM) D.base
// ran slower at every team size: 0.0694 / 0.0601 / 0.0573 / 0.0594 ms at
// 1 / 2 / 4 / 8 lanes a scenario (N=20, B=8192; H100 80GB HBM3, 700.00 W;
// PERF.md).
#include "generic_bwd.cuh"
#include "generic_fwd.cuh"

namespace gen {

struct Base {
  static constexpr int NX = 6, NU = 2, NC = 10, NCT = 10, NE = 0;
  // state index of box row r: (px, py, dx, dy, dpsi); the yaw is unbounded
  __host__ __device__ static constexpr int box(int r) { return r < 2 ? r : r + 1; }
  // extra statics (the Formulation's `extra` in controllers/base.py)
  enum : int { S_RADIUS = 0, S_XLO = 1, S_XHI = S_XLO + 5, N_EXTRA = S_XHI + 5 };
  // packed buffer (controllers/base.py::MPCBase._packed_shapes), row-major
  struct Layout { int Q, R, P, M, xref, uref, obs, size; };
  __host__ __device__ static Layout layout(int N, int n_obs, int) {
    Layout L;
    int o = 0;
    L.Q = o;    o += NX * NX;
    L.R = o;    o += NU * NU;
    L.P = o;    o += NX * NX;
    L.M = o;    o += 1;
    L.xref = o; o += (N + 1) * NX;
    L.uref = o; o += N * NU;
    L.obs = o;  o += 3 * n_obs;
    L.size = o;
    return L;
  }

  template <class C>
  __device__ static void state_err(const float* x, const C& c, int row, float* e) {
#pragma unroll
    for (int i = 0; i < NX; ++i) e[i] = x[i] - c.p(c.L.xref + row * NX + i);
    e[2] = wrap_pi(e[2]);
  }
  // box rows [v - hi (5), lo - v (5)] of v = x[BOX]
  template <class C>
  __device__ static void box_rows(const float* x, const C& c, float* g) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      g[r] = x[box(r)] - c.ex(S_XHI + r);
      g[5 + r] = c.ex(S_XLO + r) - x[box(r)];
    }
  }

  // ---- forward hooks
  template <class C>
  __device__ static void dyn(const float* x, const float* u, const C& c, float* xn) {
    float s, co;
    sincosf(x[2], &s, &co);
    xn[0] = x[0] + c.dt * x[3];
    xn[1] = x[1] + c.dt * x[4];
    xn[2] = x[2] + c.dt * x[5];
    xn[3] = x[3] + c.dt * (u[0] * co - x[4] * x[5]);
    xn[4] = x[4] + c.dt * (u[0] * s + x[3] * x[5]);
    xn[5] = x[5] + c.dt * u[1];
  }
  template <class C>
  __device__ static float stage(const float* x, const float* u, int k, const C& c, float* g) {
    float e[NX];
    state_err(x, c, k, e);
    const float eu[2] = {u[0] - c.p(c.L.uref + k * NU), u[1] - c.p(c.L.uref + k * NU + 1)};
    const float sm = ground_slack(c, c.L.obs, x[0], x[1], c.ex(S_RADIUS), nullptr);
    box_rows(x, c, g);
    return qform<NX>(c, c.L.Q, e) + qform<NU>(c, c.L.R, eu) + c.p(c.L.M) * sm * sm;
  }
  template <class C>
  __device__ static float terminal(const float* x, const C& c, float* gt) {
    float e[NX];
    state_err(x, c, c.N, e);
    const float sm = ground_slack(c, c.L.obs, x[0], x[1], c.ex(S_RADIUS), nullptr);
    box_rows(x, c, gt);
    return qform<NX>(c, c.L.P, e) + c.p(c.L.M) * sm * sm;
  }

  // ---- backward hooks: base_step's Jacobians (models/base.py::base_jacobians)
  __host__ __device__ static constexpr bool a_nz(int i, int j) {
    return i == j || (i < 3 && j == i + 3) || (i == 3 && (j == 2 || j == 4 || j == 5)) ||
           (i == 4 && (j == 2 || j == 3 || j == 5));
  }
  __host__ __device__ static constexpr bool b_nz(int i, int j) {
    return (j == 0 && (i == 3 || i == 4)) || (i == 5 && j == 1);
  }
  template <class C>
  __device__ static void dyn_jac(const float* x, const float* u, const C& c,
                                 float (&A)[NX][NX], float (&Bm)[NX][NU]) {
    float s, co;
    sincosf(x[2], &s, &co);
    const float dt = c.dt;
#pragma unroll
    for (int i = 0; i < NX; ++i) A[i][i] = 1.f;
    A[0][3] = dt;
    A[1][4] = dt;
    A[2][5] = dt;
    A[3][2] = -dt * (u[0] * s);
    A[3][4] = -dt * x[5];
    A[3][5] = -dt * x[4];
    A[4][2] = dt * (u[0] * co);
    A[4][3] = dt * x[5];
    A[4][5] = dt * x[3];
    Bm[3][0] = dt * co;
    Bm[4][0] = dt * s;
    Bm[5][1] = dt;
  }
  // two_s (W e + M smax sx) and two_s (W + M sx sx^T), sx nonzero on (px, py)
  template <class C, class Q>
  __device__ static void tracking(const float* x, const C& c, int row, int W, Q& q) {
    const float two_s = 2.f * c.inv_scale;
    float e[NX], sxy[2];
    state_err(x, c, row, e);
    const float sm = ground_slack(c, c.L.obs, x[0], x[1], c.ex(S_RADIUS), sxy);
    const float M = c.p(c.L.M);
    const float Msm = M * sm;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float we = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) we += c.p(W + i * NX + j) * e[j];
      q.x[i] += two_s * (i < 2 ? we + Msm * sxy[i] : we);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        const float w = c.p(W + i * NX + j);
        q.xx[i][j] += two_s * (i < 2 && j < 2 ? w + M * (sxy[i] * sxy[j]) : w);
      }
    }
  }
  template <class C, class Q>
  __device__ static void box_quad(const float* x, const C& c, Q& q) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      q.box_x(r, true, x[box(r)] - c.ex(S_XHI + r), box(r), 1.f);
      q.box_x(5 + r, true, c.ex(S_XLO + r) - x[box(r)], box(r), -1.f);
    }
  }
  template <class C, class Q>
  __device__ static void stage_quad(const float* x, const float* u, int k, const C& c, Q& q) {
    const float two_s = 2.f * c.inv_scale;
    tracking(x, c, k, c.L.Q, q);
    const float eu[2] = {u[0] - c.p(c.L.uref + k * NU), u[1] - c.p(c.L.uref + k * NU + 1)};
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      q.u[i] += two_s * (c.p(c.L.R + i * NU) * eu[0] + c.p(c.L.R + i * NU + 1) * eu[1]);
#pragma unroll
      for (int j = 0; j < NU; ++j) q.uu[i][j] += two_s * c.p(c.L.R + i * NU + j);
    }
    box_quad(x, c, q);
  }
  template <class C, class Q>
  __device__ static void term_quad(const float* x, const C& c, Q& q) {
    tracking(x, c, c.N, c.L.P, q);
    box_quad(x, c, q);
  }
};

}  // namespace gen

GEN_ENTRIES(base, gen::Base)
