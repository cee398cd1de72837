// The 3-DoF arm (controllers/manipulator.py, joint-space reference) on the
// generic fused kernels: x = q, u = dq, q_{k+1} = q_k + dt dq_k, tracking of
// q, input and input-rate costs, the wedge of half-planes (arm frame, no
// expansion margin) as the slack penalty W relu(max g)^2 over the six
// sampled link points, and hard rows [q box (6), input-rate box (6),
// self-collision (4)] at every stage, [q box, self-collision] at the
// terminal.  Hooks of mmmpc_tpu/controllers/manipulator.py::lanes_fwd_factory
// / lanes_bwd_factory with is_cartesian_ref=False.
#include "generic_bwd.cuh"
#include "generic_fwd.cuh"

namespace gen {

struct Arm {
  static constexpr int NX = 3, NU = 3, NC = 16, NCT = 10, NE = 0;
  // extra statics (the Formulation's `extra` in controllers/manipulator.py)
  enum : int {
    S_W = 0,                // slack weight
    S_QLO = 1,
    S_QHI = S_QLO + 3,
    S_DDLO = S_QHI + 3,     // input-rate box
    S_DDHI = S_DDLO + 3,
    N_EXTRA = S_DDHI + 3,
  };
  // packed buffer (MPCManipulator3DoF._packed_shapes), row-major
  struct Layout { int Q, R, P, M, xref, uref, ulast, hpp, hpn, hpm, size; };
  __host__ __device__ static Layout layout(int N, int, int n_hp) {
    Layout L;
    int o = 0;
    L.Q = o;     o += 9;
    L.R = o;     o += 9;
    L.P = o;     o += 9;
    L.M = o;     o += 9;
    L.xref = o;  o += (N + 1) * 3;
    L.uref = o;  o += N * 3;
    L.ulast = o; o += N * 3;
    L.hpp = o;   o += 3 * n_hp;
    L.hpn = o;   o += 3 * n_hp;
    L.hpm = o;   o += n_hp;
    L.size = o;
    return L;
  }

  // relu(max over the sampled points of the half-plane union) of the arm
  // frame points (y == 0), and with sq its q-gradient (the tie-split mean of
  // the maximal faces' normals through dP/dq, the even tie split over the
  // points).  No live face: an empty group.
  template <class C>
  __device__ static float wedge_slack(const wb::ArmFK& a, const C& c, float* sq) {
    float live = 0.f;
    for (int h = 0; h < c.n_hp; ++h) live += c.p(c.L.hpm + h);
    wb::MaxAcc<3> m;
    m.init();
    if (live > 0.f) {
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        float px = 0.f, pz = 0.f;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          px += wb::HP_POINTS[r][p] * a.ax[p];
          pz += wb::HP_POINTS[r][p] * a.az[p];
        }
        float dmax = -INFINITY, en0 = 0.f, en2 = 0.f, cnt = 0.f;
        for (int h = 0; h < c.n_hp; ++h) {
          const float n0 = c.p(c.L.hpn + 3 * h), n1 = c.p(c.L.hpn + 3 * h + 1),
                      n2 = c.p(c.L.hpn + 3 * h + 2);
          const float d = c.p(c.L.hpm + h) > 0.f
                              ? n0 * (c.p(c.L.hpp + 3 * h) - px) + n1 * c.p(c.L.hpp + 3 * h + 1) +
                                    n2 * (c.p(c.L.hpp + 3 * h + 2) - pz)
                              : NEG_BIG;
          const bool gt = d > dmax || isnan(d);
          const bool eq = d == dmax;
          dmax = gt ? d : dmax;
          cnt = gt ? 1.f : (eq ? cnt + 1.f : cnt);
          en0 = gt ? n0 : (eq ? en0 + n0 : en0);
          en2 = gt ? n2 : (eq ? en2 + n2 : en2);
        }
        float g[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float AX = 0.f, AZ = 0.f;
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            AX += wb::HP_POINTS[r][p] * a.axq[p][i];
            AZ += wb::HP_POINTS[r][p] * a.azq[p][i];
          }
          g[i] = (en0 * AX + en2 * AZ) / cnt;
        }
        m.add(-dmax, g);
      }
    }
    if (sq != nullptr) {
      const float gs = m.grad_scale();
#pragma unroll
      for (int i = 0; i < 3; ++i) sq[i] = m.gsum[i] * gs;
    }
    return m.smax();
  }

  // self-collision row r: SELF_R - |check - ee| (arm frame), and its q-gradient
  __device__ static float selfcol(const wb::ArmFK& a, int r, float* g) {
    float vx = 0.f, vz = 0.f;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      vx += wb::SELF_DIFF[r][p] * a.ax[p];
      vz += wb::SELF_DIFF[r][p] * a.az[p];
    }
    const float n = sqrtf(vx * vx + vz * vz + wb::EPS);
    if (g != nullptr) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float AX = 0.f, AZ = 0.f;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          AX += wb::SELF_DIFF[r][p] * a.axq[p][i];
          AZ += wb::SELF_DIFF[r][p] * a.azq[p][i];
        }
        g[i] = -(vx * AX + vz * AZ) / n;
      }
    }
    return wb::SELF_R - n;
  }

  // rows [q - hi (3), lo - q (3)]
  template <class C>
  __device__ static void qbox(const float* x, const C& c, float* g) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = x[i] - c.ex(S_QHI + i);
      g[3 + i] = c.ex(S_QLO + i) - x[i];
    }
  }

  // ---- forward hooks
  template <class C>
  __device__ static void dyn(const float* x, const float* u, const C& c, float* xn) {
#pragma unroll
    for (int i = 0; i < 3; ++i) xn[i] = x[i] + c.dt * u[i];
  }
  template <class C>
  __device__ static float stage(const float* x, const float* u, int k, const C& c, float* g) {
    wb::ArmFK a;
    wb::arm_fk(x[0], x[1], x[2], a);
    float e[3], eu[3], edu[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      e[i] = x[i] - c.p(c.L.xref + k * 3 + i);
      eu[i] = u[i] - c.p(c.L.uref + k * 3 + i);
      edu[i] = u[i] - c.p(c.L.ulast + k * 3 + i);
    }
    const float sm = wedge_slack(a, c, nullptr);
    qbox(x, c, g);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[6 + i] = edu[i] - c.ex(S_DDHI + i);
      g[9 + i] = c.ex(S_DDLO + i) - edu[i];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) g[12 + r] = selfcol(a, r, nullptr);
    return qform<3>(c, c.L.Q, e) + qform<3>(c, c.L.R, eu) + qform<3>(c, c.L.M, edu) +
           c.ex(S_W) * sm * sm;
  }
  template <class C>
  __device__ static float terminal(const float* x, const C& c, float* gt) {
    wb::ArmFK a;
    wb::arm_fk(x[0], x[1], x[2], a);
    float e[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = x[i] - c.p(c.L.xref + c.N * 3 + i);
    const float sm = wedge_slack(a, c, nullptr);
    qbox(x, c, gt);
#pragma unroll
    for (int r = 0; r < 4; ++r) gt[6 + r] = selfcol(a, r, nullptr);
    return qform<3>(c, c.L.P, e) + c.ex(S_W) * sm * sm;
  }

  // ---- backward hooks: A = I, B = dt I
  __host__ __device__ static constexpr bool a_nz(int i, int j) { return i == j; }
  __host__ __device__ static constexpr bool b_nz(int i, int j) { return i == j; }
  template <class C>
  __device__ static void dyn_jac(const float*, const float*, const C& c,
                                 float (&A)[NX][NX], float (&Bm)[NX][NU]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      A[i][i] = 1.f;
      Bm[i][i] = c.dt;
    }
  }
  // two_s (W e + w smax sq) and two_s (W + w sq sq^T), then the q-box rows
  // 0-5 and the self-collision rows from row r_self on
  template <class C, class Q>
  __device__ static void tracking(const float* x, const C& c, int row, int W, int r_self, Q& q) {
    const float two_s = 2.f * c.inv_scale;
    wb::ArmFK a;
    wb::arm_fk(x[0], x[1], x[2], a);
    float e[3], sq[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = x[i] - c.p(c.L.xref + row * 3 + i);
    const float sm = wedge_slack(a, c, sq);
    const float w = c.ex(S_W);
    const float wsm = w * sm;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float we = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) we += c.p(W + i * 3 + j) * e[j];
      q.x[i] += two_s * (we + wsm * sq[i]);
#pragma unroll
      for (int j = 0; j < 3; ++j) q.xx[i][j] += two_s * (c.p(W + i * 3 + j) + w * (sq[i] * sq[j]));
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      q.box_x(i, true, x[i] - c.ex(S_QHI + i), i, 1.f);
      q.box_x(3 + i, true, c.ex(S_QLO + i) - x[i], i, -1.f);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float g[3];
      const float v = selfcol(a, r, g);
      q.row_x(r_self + r, v, g);
    }
  }
  template <class C, class Q>
  __device__ static void stage_quad(const float* x, const float* u, int k, const C& c, Q& q) {
    const float two_s = 2.f * c.inv_scale;
    tracking(x, c, k, c.L.Q, 12, q);
    float eu[3], edu[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      eu[i] = u[i] - c.p(c.L.uref + k * 3 + i);
      edu[i] = u[i] - c.p(c.L.ulast + k * 3 + i);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        s += c.p(c.L.R + i * 3 + j) * eu[j] + c.p(c.L.M + i * 3 + j) * edu[j];
      q.u[i] += two_s * s;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        q.uu[i][j] += two_s * (c.p(c.L.R + i * 3 + j) + c.p(c.L.M + i * 3 + j));
      q.box_u(6 + i, true, edu[i] - c.ex(S_DDHI + i), i, 1.f);
      q.box_u(9 + i, true, c.ex(S_DDLO + i) - edu[i], i, -1.f);
    }
  }
  template <class C, class Q>
  __device__ static void term_quad(const float* x, const C& c, Q& q) {
    tracking(x, c, c.N, c.L.P, 6, q);
  }
};

}  // namespace gen

GEN_ENTRIES(arm, gen::Arm)
