// The 1-D point-mass demo (controllers/demo.py) on the generic fused kernels:
// x = [p, v], u = [a], position / velocity tracking, a velocity box on the
// running states, no terminal rows.  Hooks of
// mmmpc_tpu/controllers/demo.py::lanes_fwd_factory / lanes_bwd_factory.
//
// Both kernels run one thread a candidate or scenario, each thread's stage
// inputs loaded ahead by cp.async into its own column of shared memory: the
// line search (C.demo) on generic_fwd.cuh's one-thread kernel, its inputs
// FWD_RING - 1 = 7 stages ahead, 0.00741 ms a launch against 0.0109 with its
// loads on the chain; the fused backward (D.demo) on generic_bwd.cuh's, one
// stage ahead (N=20, B=8192; H100 80GB HBM3, 700.00 W; PERF.md).
#include "generic_bwd.cuh"
#include "generic_fwd.cuh"

namespace gen {

struct Demo {
  static constexpr int NX = 2, NU = 1, NC = 2, NCT = 0, NE = 0;
  // the state reference; no U_last
  static constexpr int NREF = NX;
  static constexpr bool HAS_ULAST = false;
  // extra statics (the Formulation's `extra` in controllers/demo.py)
  enum : int { S_VLO = 0, S_VHI, N_EXTRA };
  // packed buffer (controllers/demo.py::MPC._packed_shapes), row-major
  struct Layout { int Q, R, P, xref, uref, size; };
  __host__ __device__ static Layout layout(int N, int, int) {
    Layout L;
    int o = 0;
    L.Q = o;    o += NX * NX;
    L.R = o;    o += NU * NU;
    L.P = o;    o += NX * NX;
    L.xref = o; o += (N + 1) * NX;
    L.uref = o; o += N * NU;
    L.size = o;
    return L;
  }

  // ---- the line search, one thread a candidate (generic_fwd.cuh,
  // generic_fwd_kernel).  On the team kernel, with hooks of its own, it ran
  // 0.01721 / 0.01688 / 0.02395 / 0.04117 ms a launch at 1 / 2 / 4 / 8
  // lanes a candidate, slower at every size than the one-thread kernel it
  // was to replace (0.0109-0.0111): its stage is a 2 x 2 and a 1 x 1 form
  // and two box rows, too little work for a team's exchanges, barrier and
  // stores (N=20, B=8192; H100 80GB HBM3, 700.00 W; PERF.md).
  static constexpr int FWD_TEAM = 0;
  template <class C>
  __device__ static void dyn(const float* x, const float* u, const C& c, float* xn) {
    xn[0] = x[0] + c.dt * x[1];
    xn[1] = x[1] + c.dt * u[0];
  }
  template <class C>
  __device__ static float stage(const float* x, const float* u, int k, const C& c, float* g) {
    const float ex[2] = {x[0] - c.xref(k, 0), x[1] - c.xref(k, 1)};
    const float eu[1] = {u[0] - c.uref(k, 0)};
    g[0] = x[1] - c.ex(S_VHI);
    g[1] = c.ex(S_VLO) - x[1];
    return qform<2>(c.wq(), ex) + qform<1>(c.mat(c.L.R), eu);
  }
  template <class C>
  __device__ static float terminal(const float* x, const C& c, float*) {
    const float ex[2] = {x[0] - c.xref(c.N, 0), x[1] - c.xref(c.N, 1)};
    return qform<2>(c.wp(), ex);
  }

  // ---- backward hooks: A = [[1, dt], [0, 1]], B = [[0], [dt]]
  __host__ __device__ static constexpr bool a_nz(int i, int j) { return i == j || (i == 0 && j == 1); }
  __host__ __device__ static constexpr bool b_nz(int i, int) { return i == 1; }
  template <class C>
  __device__ static void dyn_jac(const float*, const float*, const C& c,
                                 float (&A)[NX][NX], float (&Bm)[NX][NU]) {
    A[0][0] = 1.f;
    A[0][1] = c.dt;
    A[1][1] = 1.f;
    Bm[1][0] = c.dt;
  }
  template <class C, class Q>
  __device__ static void stage_quad(const float* x, const float* u, int k, const C& c, Q& q) {
    const float two_s = 2.f * c.inv_scale;
    const float ex[2] = {x[0] - c.p(c.L.xref + k * NX), x[1] - c.p(c.L.xref + k * NX + 1)};
    const float eu = u[0] - c.p(c.L.uref + k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      q.x[i] += two_s * (c.p(c.L.Q + i * NX) * ex[0] + c.p(c.L.Q + i * NX + 1) * ex[1]);
#pragma unroll
      for (int j = 0; j < NX; ++j) q.xx[i][j] += two_s * c.p(c.L.Q + i * NX + j);
    }
    q.u[0] += two_s * (c.p(c.L.R) * eu);
    q.uu[0][0] += two_s * c.p(c.L.R);
    q.box_x(0, true, x[1] - c.ex(S_VHI), 1, 1.f);
    q.box_x(1, true, c.ex(S_VLO) - x[1], 1, -1.f);
  }
  template <class C, class Q>
  __device__ static void term_quad(const float* x, const C& c, Q& q) {
    const float two_s = 2.f * c.inv_scale;
    const float ex[2] = {x[0] - c.p(c.L.xref + c.N * NX), x[1] - c.p(c.L.xref + c.N * NX + 1)};
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      q.x[i] += two_s * (c.p(c.L.P + i * NX) * ex[0] + c.p(c.L.P + i * NX + 1) * ex[1]);
#pragma unroll
      for (int j = 0; j < NX; ++j) q.xx[i][j] += two_s * c.p(c.L.P + i * NX + j);
    }
  }
};

}  // namespace gen

GEN_ENTRIES(demo, gen::Demo)
