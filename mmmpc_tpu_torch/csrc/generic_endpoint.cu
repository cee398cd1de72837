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

  // ---- the team backward (generic_bwd.cuh, generic_bwd_team_kernel): teams
  // of 8 lanes a scenario.  The lanes share the stage's FK (its four sincos
  // over four lanes, exchanged by shuffles) and its ground circles (one a
  // lane, merged across the team), then every lane computes the pose error
  // and Jp and adds the rows of its tasks, in the order of operations of
  // the JAX hooks (lanes_bwd_factory).  Rows picked at run time read x, u
  // and the multipliers from the stage buffer (in[e * S]: x, u, lam) and
  // pick Jp's column by selects.
  static constexpr int BWD_TEAM = 8;
  static constexpr unsigned FULL = 0xffffffffu;

  // wb::fk with its four sincos (q1, q1 - q2, q1 - q2 - q3, psi) split over
  // lanes 4m .. 4m + 3 of the team and exchanged by shuffles: the same
  // algebra, so every lane ends with fk's values.
  template <int T>
  __device__ static void fk_team(const float* x, int lane, wb::FK& f) {
    static_assert(T % 4 == 0 && T <= 32, "fk_team splits over four lanes");
    const int qd = lane & 3;
    const float th = x[6] - x[7];
    const float ang = qd == 0 ? x[6] : qd == 1 ? th : qd == 2 ? th - x[8] : x[2];
    float sa, ca;
    sincosf(ang, &sa, &ca);
    const int b = lane & ~3;
    const float s1 = __shfl_sync(FULL, sa, b, T), c1 = __shfl_sync(FULL, ca, b, T);
    const float st = __shfl_sync(FULL, sa, b + 1, T), ct = __shfl_sync(FULL, ca, b + 1, T);
    const float sb = __shfl_sync(FULL, sa, b + 2, T), cb = __shfl_sync(FULL, ca, b + 2, T);
    f.sp = __shfl_sync(FULL, sa, b + 3, T);
    f.cp = __shfl_sync(FULL, ca, b + 3, T);
    using namespace wb;
    const float ax2 = A2 * s1 + A3 * c1;
    const float az2 = A2 * c1 - A3 * s1;
    const float D3 = A3 * st + A5 * ct;
    const float E3 = A3 * ct - A5 * st;
    const float ax3 = ax2 - A3 * ct + A5 * st;
    const float az3 = az2 + A3 * st + A5 * ct;
    const float P6 = -A6 * sb - A7 * cb;
    const float Q6 = -A6 * cb + A7 * sb;
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

  // ground_slack with its circles over the lanes of the team, each into its
  // own relu(max) accumulator, merged by a butterfly of shuffles: a larger
  // max replaces, equal maxima add their counts and gradients, a NaN max
  // stays NaN.  Every lane ends with the same smax and sxy.
  template <int T, class C>
  __device__ static float ground_slack_team(const C& c, float px, float py,
                                            float* sxy, int lane) {
    wb::MaxAcc<2> m;
    m.init();
    for (int o = lane; o < c.n_obs; o += T) {
      const float dx = px - c.p(c.L.obs + 3 * o);
      const float dy = py - c.p(c.L.obs + 3 * o + 1);
      const float d = sqrtf(dx * dx + dy * dy + wb::EPS);
      const float g[2] = {-dx / d, -dy / d};
      m.add((c.p(c.L.obs + 3 * o + 2) + c.ex(S_RADIUS)) - d, g);
    }
#pragma unroll
    for (int off = 1; off < T; off <<= 1) {
      const float og = __shfl_xor_sync(FULL, m.gmax, off, T);
      const float oc = __shfl_xor_sync(FULL, m.cnt, off, T);
      const bool nan = isnan(og) || isnan(m.gmax);
      const bool take = !nan && og > m.gmax;
      const bool add = nan || og == m.gmax;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float o = __shfl_xor_sync(FULL, m.gsum[i], off, T);
        m.gsum[i] = take ? o : (add ? m.gsum[i] + o : m.gsum[i]);
      }
      m.cnt = take ? oc : (add ? m.cnt + oc : m.cnt);
      m.gmax = nan ? NAN : (take ? og : m.gmax);
    }
    const float gs = m.grad_scale();
    sxy[0] = m.gsum[0] * gs;
    sxy[1] = m.gsum[1] * gs;
    return m.smax();
  }

  // The tracking model of one stage (or the terminal) with weights W.
  template <int T>
  struct Track {
    float Jp[4][NX], We[4], WJ[4][NX], sxy[2], sm, S;

    template <class C>
    __device__ __forceinline__ Track(const float* x, const C& c, int row,
                                     int W, int lane) {
      wb::FK f;
      fk_team<T>(x, lane, f);
      float e[4];
      pose_err(x, f, c, row, e);
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
      sm = ground_slack_team<T>(c, x[0], x[1], sxy, lane);
      S = c.p(c.L.S);
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
    }

    // x row t = rho T + lane (a task past the x rows adds nothing): two_s
    // (Jp^T W e + S smax sx) into q, two_s (Jp^T W Jp + S sx sx^T) into acc
    __device__ __forceinline__ void add_row(int rho, int lane, float two_s,
                                            float& q, float (&acc)[NX]) const {
      const int t = rho * T + lane;
      const bool live = t < NX && col_nz(t);
      float jt[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        jt[p] = ric::pick<T, NX>(rho, lane, [&](int i) {
          return jp_nz(p, i) ? Jp[p][i] : 0.f;
        });
      const float st = t == 0 ? sxy[0] : sxy[1];
      float g = -0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) g += jt[p] * We[p];
      const float gx = two_s * (t < 2 ? g + S * sm * st : g);
      q = live ? q + gx : q;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        if (!col_nz(j)) continue;
        float h = -0.f;
#pragma unroll
        for (int p = 0; p < 4; ++p) h += jt[p] * WJ[p][j];
        const float hv = two_s * (t < 2 && j < 2 ? h + S * (st * sxy[j]) : h);
        acc[j] = live ? acc[j] + hv : acc[j];
      }
    }
  };

  // The state-box rows t and NX + t of x row t: the multipliers at
  // lam[r * S], x[t] = xt.
  template <class C>
  __device__ __forceinline__ static void team_box_x(int t, float xt,
                                                    const float* lam, int S,
                                                    const C& c, float mu,
                                                    float& q, float (&acc)[NX]) {
    const int tc = t < NX ? t : NX - 1;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const bool hi = side == 0;
      const bool live = t < NX && xlive(c, tc, hi);
      const float val = hi ? xt - c.ex(S_XHI + tc) : c.ex(S_XLO + tc) - xt;
      const float tv = fmaxf(lam[(hi ? tc : NX + tc) * S] + mu * val, 0.f);
      q = live ? q + (hi ? 1.f : -1.f) * tv : q;
      const float d = tv > 0.f ? mu : 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc[j] = live && j == t ? acc[j] + d : acc[j];
    }
  }

  // The terminal (tracking with P and the state-box rows) -> Vx, Vxx of
  // the lane's rows: in[e * S] holds x_N, then lamt.
  template <int T, class C>
  __device__ static void team_term(const float* in, int S, const C& c,
                                   float mu, int lane,
                                   ric::TeamTile<NX, NU>& tt) {
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = in[i * S];
    const Track<T> tr(x, c, c.N, c.L.P, lane);
    const float two_s = 2.f * c.inv_scale;
#pragma unroll
    for (int rho = 0; rho < (NX + T - 1) / T; ++rho) {
      const int t = rho * T + lane;
      float q = 0.f, acc[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) acc[j] = 0.f;
      tr.add_row(rho, lane, two_s, q, acc);
      team_box_x(t, in[(t < NX ? t : 0) * S], in + NX * S, S, c, mu, q, acc);
      if (t < NX) {
        tt.vx[t] = q;
#pragma unroll
        for (int j = 0; j < NX; ++j) tt.V[t][j] = acc[j];
      }
    }
  }

  // A stage's rows (tracking with Q, the R and W forms, every box row) of
  // the lane's tasks: in[e * S] holds x_k, u_k, lam_k.
  template <int T, class C>
  __device__ static void team_rows(const float* x, const float* in, int S, int k,
                                   const C& c, float mu, int lane,
                                   float (&q)[ric::rounds<NX, NU, T>()],
                                   float (&acc)[ric::rounds<NX, NU, T>()][NX],
                                   float (&uu)[ric::rounds<NX, NU, T>()][NU]) {
    constexpr int R = ric::rounds<NX, NU, T>();
    const float two_s = 2.f * c.inv_scale;
    const float* lam = in + (NX + NU) * S;
    {
      const Track<T> tr(x, c, k, c.L.Q, lane);
#pragma unroll
      for (int rho = 0; rho < R; ++rho) {
        if (rho * T >= NX) continue;     // no x row in this round
        const int t = rho * T + lane;
        tr.add_row(rho, lane, two_s, q[rho], acc[rho]);
        team_box_x(t, in[(t < NX ? t : 0) * S], lam, S, c, mu, q[rho], acc[rho]);
      }
    }
    float eu[NU], edu[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const float uj = in[(NX + j) * S];
      eu[j] = uj - c.p(c.L.uref + k * NU + j);
      edu[j] = uj - c.p(c.L.ulast + k * NU + j);
    }
#pragma unroll
    for (int rho = 0; rho < R; ++rho) {
      if ((rho + 1) * T <= NX) continue;  // no u row in this round
      const int t = rho * T + lane;
      const bool urow = t >= NX && t < NX + NU;
      const int i = urow ? t - NX : 0;
      const int Ri = c.L.R + i * NU, Wi = c.L.W + i * NU;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NU; ++j) s += c.p(Ri + j) * eu[j] + c.p(Wi + j) * edu[j];
      q[rho] = urow ? q[rho] + two_s * s : q[rho];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        uu[rho][j] = urow ? uu[rho][j] + two_s * (c.p(Ri + j) + c.p(Wi + j)) : uu[rho][j];
      // the rate-box rows 2 NX + i and 2 NX + NU + i
      const float ed = in[(NX + i) * S] - c.p(c.L.ulast + k * NU + i);
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const bool hi = side == 0;
        const bool live = urow && dulive(c, i, hi);
        const float val = hi ? ed - c.ex(S_DUHI + i) : c.ex(S_DULO + i) - ed;
        const float tv = fmaxf(lam[(hi ? 2 * NX + i : 2 * NX + NU + i) * S] + mu * val, 0.f);
        q[rho] = live ? q[rho] + (hi ? 1.f : -1.f) * tv : q[rho];
        const float d = tv > 0.f ? mu : 0.f;
#pragma unroll
        for (int j = 0; j < NU; ++j) uu[rho][j] = live && j == i ? uu[rho][j] + d : uu[rho][j];
      }
    }
  }

  // ---- the team line search (generic_fwd.cuh, generic_fwd_team_kernel):
  // teams of FWD_TEAM lanes a candidate.  The FK's four sincos over the
  // lanes (sincos_team), the step in every lane; the ground circles, the
  // rows of the Q, R and W forms and the PHR rows as items over the lanes.
  // Lanes a candidate: 2 was the fastest of 1, 2, 4 and 8 at batch 8192
  // on the H100 (PERF.md), as for kernel A.  It keeps an FK of its own
  // (fk_ee_team): D's fk_team splits over four lanes, and routing that and
  // D's circle merge through the shared team helpers slowed D.endpoint by
  // 8% on the H100 (PERF.md).
  static constexpr int FWD_TEAM = 2;
  // a candidate's vector: x, u, then the errors e (pose), eu, ed
  enum : int {
    FV_E = NX + NU,
    FV_EU = FV_E + 4,
    FV_ED = FV_EU + NU,
    FWD_NV = (FV_ED + NU) | 1,
  };
  static constexpr int FWD_ROWS = 4 * NC;

  // The PHR row table: {bound, sign, live, vector index} of the stage rows
  // [x_hi, x_lo, du_hi, du_lo] (the terminal rows are the first 2 NX).
  __device__ static void fwd_team_rows(const float* sv, float* rt) {
    const float* ex = sv + Statics<Endpoint>::EXTRA;
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const bool isx = r < 2 * NX;
      const bool hi = isx ? r < NX : r < 2 * NX + NU;
      const int e = isx ? (hi ? r : r - NX) : (hi ? r - 2 * NX : r - 2 * NX - NU);
      const int bound = isx ? (hi ? S_XHI : S_XLO) : (hi ? S_DUHI : S_DULO);
      const int mask = isx ? (hi ? S_XMHI : S_XMLO) : (hi ? S_DUMHI : S_DUMLO);
      rt[4 * r] = ex[bound + e];
      rt[4 * r + 1] = hi ? 1.f : -1.f;
      rt[4 * r + 2] = ex[mask + e] != 0.f ? 1.f : 0.f;
      rt[4 * r + 3] = __int_as_float(isx ? e : FV_ED + e);
    }
  }

  // The end effector's world point (wb::fk's pt[2]) and the base yaw's
  // cos / sin, the four sincos over the lanes of the team.
  template <int T>
  __device__ static void fk_ee_team(const float* x, int lane, float& cp, float& sp,
                                    float* pe) {
    const float th = x[6] - x[7];
    float s[4], cs[4];
    sincos_team<T, 4>(
        [&](int i) { return i == 0 ? x[6] : (i == 1 ? th : (i == 2 ? th - x[8] : x[2])); },
        lane, s, cs);
    using namespace wb;
    const float s1 = s[0], c1 = cs[0], st = s[1], ct = cs[1], sb = s[2], cb = cs[2];
    sp = s[3];
    cp = cs[3];
    const float ax2 = A2 * s1 + A3 * c1;
    const float az2 = A2 * c1 - A3 * s1;
    const float ax3 = ax2 - A3 * ct + A5 * st;
    const float az3 = az2 + A3 * st + A5 * ct;
    const float axe = ax3 + A6 * cb - A7 * sb;
    const float aze = az3 - A6 * sb - A7 * cb;
    const float r = axe + BX;
    pe[0] = x[0] + r * cp;
    pe[1] = x[1] + r * sp;
    pe[2] = aze + BZ;
  }

  // relu(max) of the ground circles over the lanes of the team (values
  // only; NaN stays NaN); every lane ends with it.
  template <int T, class C>
  __device__ static float ground_team(const C& c, float px, float py, int lane) {
    float m = -INFINITY;
    for (int o = lane; o < c.n_obs; o += T) {
      const float dx = px - c.p(c.L.obs + 3 * o);
      const float dy = py - c.p(c.L.obs + 3 * o + 1);
      const float d = sqrtf(dx * dx + dy * dy + wb::EPS);
      const float v = (c.p(c.L.obs + 3 * o + 2) + c.ex(S_RADIUS)) - d;
      m = (v > m || isnan(v)) ? v : m;
    }
#pragma unroll
    for (int off = 1; off < T; off <<= 1) {
      const float v = __shfl_xor_sync(TEAM_FULL, m, off, T);
      m = (v > m || isnan(v)) ? v : m;
    }
    return m < 0.f ? 0.f : m;
  }

  // The pose error of x against reference row `row` into the team's vector
  // (then __syncwarp: the vector is complete); the cost share of
  // S relu(max)^2 (lane 0) and of the pose form with weights W; with u,
  // x_{k+1} into xn.
  template <int T, class C>
  __device__ static float pose_team(const float* x, const float* u, int row, int W, const C& c,
                                    float* v, int lane, float* xn) {
    float cp, sp, pe[3];
    fk_ee_team<T>(x, lane, cp, sp, pe);
    if (u != nullptr) wb::step(x, u, c.dt, cp, sp, xn);
    float e[4];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = pe[i] - c.p(c.L.xref + row * 4 + i);
    e[3] = x[2] - c.p(c.L.xref + row * 4 + 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[FV_E + i] = e[i];
    __syncwarp();
    const float sm = ground_team<T>(c, x[0], x[1], lane);
    const float tr = lane == 0 ? c.p(c.L.S) * sm * sm : 0.f;
    return tr + qform_rows<T, 4>(c, W, e, v + FV_E, lane);
  }

  template <int T, class C>
  __device__ static float fwd_team_stage(const float* x, const float* u, int k, const C& c,
                                         float* v, const float* rt, const float* lam, int SC,
                                         float mu, int lane, float* xn) {
    float eu[NU], ed[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      eu[i] = u[i] - c.p(c.L.uref + k * NU + i);
      ed[i] = u[i] - c.p(c.L.ulast + k * NU + i);
      v[FV_EU + i] = eu[i];
      v[FV_ED + i] = ed[i];
    }
    float tr = pose_team<T>(x, u, k, c.L.Q, c, v, lane, xn);
    tr += qform_rows<T, NU>(c, c.L.R, eu, v + FV_EU, lane);
    tr += qform_rows<T, NU>(c, c.L.W, ed, v + FV_ED, lane);
    const float pen = phr_rows<T, NC>(rt, v, lam, SC, mu, lane);
    return c.inv_scale * tr + pen * (0.5f / mu);
  }

  template <int T, class C>
  __device__ static float fwd_team_terminal(const float* x, const C& c, float* v, const float* rt,
                                            const float* lamt, int SC, float mu, int lane) {
    const float tr = pose_team<T>(x, nullptr, c.N, c.L.P, c, v, lane, nullptr);
    const float pen = phr_rows<T, NCT>(rt, v, lamt, SC, mu, lane);
    return c.inv_scale * tr + pen * (0.5f / mu);
  }
};

}  // namespace gen

GEN_ENTRIES(endpoint, gen::Endpoint)
