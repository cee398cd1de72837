// The whole-body end-point controller (controllers/wholebody_endpoint.py) on
// the generic fused kernels: the 9-state / 5-input whole-body model tracking
// the world end-effector pose [x, y, z, psi] against a (N+1, 4) reference,
// input and input-rate costs, the ground circles as the slack penalty
// S relu(max g)^2, and the maskable state box (stage and terminal) and
// input-rate box (stage).  Hooks of
// mmmpc_tpu/controllers/wholebody_endpoint.py::lanes_fwd_factory /
// lanes_bwd_factory.  The whole-body FK, its partials and the dynamics step
// are csrc/wholebody_common.cuh's.
#include "generic_bwd.cuh"
#include "generic_fwd.cuh"

namespace gen {

struct Endpoint {
  static constexpr int NX = 9, NU = 5, NC = 2 * NX + 2 * NU, NCT = 2 * NX, NE = 0;
  // extra statics (the Formulation's `extra` in
  // controllers/wholebody_endpoint.py); masks are 0 / 1
  enum : int {
    S_RADIUS = 0,
    S_XLO = 1,
    S_XHI = S_XLO + NX,
    S_XMLO = S_XHI + NX,
    S_XMHI = S_XMLO + NX,
    S_DULO = S_XMHI + NX,
    S_DUHI = S_DULO + NU,
    S_DUMLO = S_DUHI + NU,
    S_DUMHI = S_DUMLO + NU,
    N_EXTRA = S_DUMHI + NU,
  };
  // packed buffer (MPCWholeBodyEndpoint._packed_shapes), row-major
  struct Layout { int Q, R, P, S, W, xref, uref, ulast, obs, size; };
  __host__ __device__ static Layout layout(int N, int n_obs, int) {
    Layout L;
    int o = 0;
    L.Q = o;     o += 16;
    L.R = o;     o += NU * NU;
    L.P = o;     o += 16;
    L.S = o;     o += 1;
    L.W = o;     o += NU * NU;
    L.xref = o;  o += (N + 1) * 4;
    L.uref = o;  o += N * NU;
    L.ulast = o; o += N * NU;
    L.obs = o;   o += 3 * n_obs;
    L.size = o;
    return L;
  }
  // structurally nonzero entries of the pose Jacobian Jp (4 x 9) and its
  // nonzero columns (px, py, psi, q1, q2, q3)
  __host__ __device__ static constexpr bool jp_nz(int p, int i) {
    return (p == 0 && (i == 0 || i == 2 || i >= 6)) || (p == 1 && (i == 1 || i == 2 || i >= 6)) ||
           (p == 2 && i >= 6) || (p == 3 && i == 2);
  }
  __host__ __device__ static constexpr bool col_nz(int i) { return i < 3 || i >= 6; }

  template <class C>
  __device__ static void pose_err(const float* x, const wb::FK& f, const C& c, int row, float* e) {
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = f.pt[2][i] - c.p(c.L.xref + row * 4 + i);
    e[3] = x[2] - c.p(c.L.xref + row * 4 + 3);
  }
  template <class C>
  __device__ static bool xlive(const C& c, int i, bool hi) {
    return c.ex((hi ? S_XMHI : S_XMLO) + i) != 0.f;
  }
  template <class C>
  __device__ static bool dulive(const C& c, int i, bool hi) {
    return c.ex((hi ? S_DUMHI : S_DUMLO) + i) != 0.f;
  }
  // rows [x - hi (9), lo - x (9)], NEG_BIG where masked
  template <class C>
  __device__ static void xbox(const float* x, const C& c, float* g) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      g[i] = xlive(c, i, true) ? x[i] - c.ex(S_XHI + i) : NEG_BIG;
      g[NX + i] = xlive(c, i, false) ? c.ex(S_XLO + i) - x[i] : NEG_BIG;
    }
  }

  // ---- forward hooks
  template <class C>
  __device__ static void dyn(const float* x, const float* u, const C& c, float* xn) {
    float sp, cp;
    sincosf(x[2], &sp, &cp);
    wb::step(x, u, c.dt, cp, sp, xn);
  }
  template <class C>
  __device__ static float stage(const float* x, const float* u, int k, const C& c, float* g) {
    wb::FK f;
    wb::fk(x, f);
    float e[4], eu[NU], edu[NU];
    pose_err(x, f, c, k, e);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      eu[i] = u[i] - c.p(c.L.uref + k * NU + i);
      edu[i] = u[i] - c.p(c.L.ulast + k * NU + i);
    }
    const float sm = ground_slack(c, c.L.obs, x[0], x[1], c.ex(S_RADIUS), nullptr);
    xbox(x, c, g);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      g[2 * NX + i] = dulive(c, i, true) ? edu[i] - c.ex(S_DUHI + i) : NEG_BIG;
      g[2 * NX + NU + i] = dulive(c, i, false) ? c.ex(S_DULO + i) - edu[i] : NEG_BIG;
    }
    return qform<4>(c, c.L.Q, e) + qform<NU>(c, c.L.R, eu) + qform<NU>(c, c.L.W, edu) +
           c.p(c.L.S) * sm * sm;
  }
  template <class C>
  __device__ static float terminal(const float* x, const C& c, float* gt) {
    wb::FK f;
    wb::fk(x, f);
    float e[4];
    pose_err(x, f, c, c.N, e);
    const float sm = ground_slack(c, c.L.obs, x[0], x[1], c.ex(S_RADIUS), nullptr);
    xbox(x, c, gt);
    return qform<4>(c, c.L.P, e) + c.p(c.L.S) * sm * sm;
  }

  // ---- backward hooks: wholebody_step's Jacobians
  // (models/mobile_manipulator.py::wholebody_jacobians)
  __host__ __device__ static constexpr bool a_nz(int i, int j) {
    return i == j || (i < 3 && j == i + 3) || (i == 3 && (j == 2 || j == 4 || j == 5)) ||
           (i == 4 && (j == 2 || j == 3 || j == 5));
  }
  __host__ __device__ static constexpr bool b_nz(int i, int j) {
    return (j == 0 && (i == 3 || i == 4)) || (i >= 5 && j == i - 4);
  }
  template <class C>
  __device__ static void dyn_jac(const float* x, const float* u, const C& c,
                                 float (&A)[NX][NX], float (&Bm)[NX][NU]) {
    float sp, cp;
    sincosf(x[2], &sp, &cp);
    const wb::Jac J = wb::jacobians(x, u, c.dt, cp, sp);
#pragma unroll
    for (int i = 0; i < NX; ++i) A[i][i] = 1.f;
    A[0][3] = J.dt;
    A[1][4] = J.dt;
    A[2][5] = J.dt;
    A[3][2] = J.a32;
    A[3][4] = J.a34;
    A[3][5] = J.a35;
    A[4][2] = J.a42;
    A[4][3] = J.a43;
    A[4][5] = J.a45;
    Bm[3][0] = J.b30;
    Bm[4][0] = J.b40;
#pragma unroll
    for (int i = 1; i < NU; ++i) Bm[4 + i][i] = J.dt;
  }
  // two_s (Jp^T W e + S smax sx) and two_s (Jp^T W Jp + S sx sx^T), sx
  // nonzero on (px, py); then the state-box rows
  template <class C, class Q>
  __device__ static void tracking(const float* x, const C& c, int row, int W, Q& q) {
    const float two_s = 2.f * c.inv_scale;
    wb::FK f;
    wb::fk(x, f);
    float e[4];
    pose_err(x, f, c, row, e);
    float Jp[4][NX];
    Jp[0][0] = 1.f;
    Jp[0][2] = -f.r[2] * f.sp;
    Jp[1][1] = 1.f;
    Jp[1][2] = f.r[2] * f.cp;
    Jp[3][2] = 1.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Jp[0][6 + i] = f.cp * f.axq[2][i];
      Jp[1][6 + i] = f.sp * f.axq[2][i];
      Jp[2][6 + i] = f.azq[2][i];
    }
    float sxy[2];
    const float sm = ground_slack(c, c.L.obs, x[0], x[1], c.ex(S_RADIUS), sxy);
    const float S = c.p(c.L.S);
    float We[4], WJ[4][NX];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < 4; ++l) s += c.p(W + p * 4 + l) * e[l];
      We[p] = s;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float t = -0.f;
#pragma unroll
        for (int l = 0; l < 4; ++l)
          if (jp_nz(l, j)) t += c.p(W + p * 4 + l) * Jp[l][j];
        WJ[p][j] = t;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (!col_nz(i)) continue;
      float g = -0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (jp_nz(p, i)) g += Jp[p][i] * We[p];
      q.x[i] += two_s * (i < 2 ? g + S * sm * sxy[i] : g);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        if (!col_nz(j)) continue;
        float h = -0.f;
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (jp_nz(p, i)) h += Jp[p][i] * WJ[p][j];
        q.xx[i][j] += two_s * (i < 2 && j < 2 ? h + S * (sxy[i] * sxy[j]) : h);
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      q.box_x(i, xlive(c, i, true), x[i] - c.ex(S_XHI + i), i, 1.f);
      q.box_x(NX + i, xlive(c, i, false), c.ex(S_XLO + i) - x[i], i, -1.f);
    }
  }
  template <class C, class Q>
  __device__ static void stage_quad(const float* x, const float* u, int k, const C& c, Q& q) {
    const float two_s = 2.f * c.inv_scale;
    tracking(x, c, k, c.L.Q, q);
    float eu[NU], edu[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      eu[i] = u[i] - c.p(c.L.uref + k * NU + i);
      edu[i] = u[i] - c.p(c.L.ulast + k * NU + i);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NU; ++j)
        s += c.p(c.L.R + i * NU + j) * eu[j] + c.p(c.L.W + i * NU + j) * edu[j];
      q.u[i] += two_s * s;
#pragma unroll
      for (int j = 0; j < NU; ++j)
        q.uu[i][j] += two_s * (c.p(c.L.R + i * NU + j) + c.p(c.L.W + i * NU + j));
      q.box_u(2 * NX + i, dulive(c, i, true), edu[i] - c.ex(S_DUHI + i), i, 1.f);
      q.box_u(2 * NX + NU + i, dulive(c, i, false), c.ex(S_DULO + i) - edu[i], i, -1.f);
    }
  }
  template <class C, class Q>
  __device__ static void term_quad(const float* x, const C& c, Q& q) {
    tracking(x, c, c.N, c.L.P, q);
  }
};

}  // namespace gen

GEN_ENTRIES(endpoint, gen::Endpoint)
