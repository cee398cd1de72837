// The 3-DoF arm (controllers/manipulator.py) on the generic fused kernels:
// x = q, u = dq, q_{k+1} = q_k + dt dq_k, tracking of q (the joint-space
// reference, Arm<false>) or of the end point (the Cartesian reference,
// Arm<true>), input and input-rate costs, the wedge of half-planes (arm
// frame, no expansion margin) as the slack penalty W relu(max g)^2 over the
// six sampled link points, and hard rows [q box (6), input-rate box (6),
// self-collision (4)] at every stage, [q box, self-collision] at the
// terminal.  Hooks of mmmpc_tpu/controllers/manipulator.py::lanes_fwd_factory
// / lanes_bwd_factory, is_cartesian_ref = CART.  The Cartesian error is
// e = [x_ee - r0, -r1, z_ee - r2] (arm frame, y == 0) with Je = rows
// [dx_ee/dq; 0; dz_ee/dq], from the FK that every lane holds for the
// wedge and the self rows; Q and P are full 3 x 3 matrices.  The rows of
// each reference sit under `if constexpr`, so the joint-space instance
// computes nothing of the Cartesian one.  Both kernels run on teams of
// lanes: the line search (C.arm) on generic_fwd.cuh's team
// kernel, the fused backward (D.arm) on generic_bwd.cuh's, over the team
// Riccati step.
#include "generic_bwd.cuh"
#include "generic_fwd.cuh"

namespace gen {

template <bool CART>
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

  // CART's tracking error: the end point minus reference row `row`
  template <class C>
  __device__ __forceinline__ static void ee_error(const wb::ArmFK& a, const C& c, int row,
                                                  float* e) {
    const int r = c.L.xref + row * 3;
    e[0] = a.ax[2] - c.p(r);
    e[1] = 0.f - c.p(r + 1);
    e[2] = a.az[2] - c.p(r + 2);
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

  // Row r of wb::HP_POINTS (a wedge point's weights over the arm points)
  // and of wb::SELF_DIFF (a self row's), by selects: the teams pick r at
  // run time.
  __device__ __forceinline__ static void hp_weights(int r, float (&w)[3]) {
    w[0] = r == 0 || r == 2 ? 0.5f : (r == 1 ? 1.f : 0.f);
    w[1] = r == 2 || r == 4 ? 0.5f : (r == 3 ? 1.f : 0.f);
    w[2] = r == 4 ? 0.5f : (r == 5 ? 1.f : 0.f);
  }
  __device__ __forceinline__ static void self_weights(int r, float (&w)[3]) {
    w[0] = r == 0 ? 0.f : (r == 2 ? 1.f : 0.5f);
    w[1] = r == 3 ? 0.5f : 0.f;
    w[2] = -1.f;
  }

  // ---- the team backward (generic_bwd.cuh, generic_bwd_team_kernel):
  // teams of BWD_TEAM lanes a scenario.  The lanes share the stage's
  // expansion: the FK's three sincos (sincos_team), the six wedge points
  // (a point's max over the faces in the lane that owns it, the points'
  // relu(max) merged across the team), the four self-collision rows (each
  // on one lane, its value and gradient exchanged by shuffles); then every
  // lane adds the rows of its tasks in the order of operations of the JAX
  // hooks (lanes_bwd_factory): tracking with weights W plus the wedge's
  // two_s w sq sq^T, the q-box and self-collision rows to its x rows, the
  // R and M forms and the rate-box rows to its u rows.  Rows picked at run time read x, u and the multipliers
  // from the stage buffer (in[e * S]: x, u, lam) and the sampled rows by
  // selects (ric::pick).
  // Lanes a scenario: 4 was the fastest of 1, 2, 4 and 8 at batch 8192,
  // and the self-collision rows' shuffles faster than every lane computing
  // all four (the times of each in PERF.md).
  static constexpr int BWD_TEAM = 4;

  // arm_fk with its three sincos over the lanes of the team.
  template <int T>
  __device__ static void fk_team(const float* x, int lane, wb::ArmFK& a) {
    const float th = x[0] - x[1];
    float s[3], cs[3];
    sincos_team<T, 3>([&](int i) { return i == 0 ? x[0] : (i == 1 ? th : th - x[2]); },
                      lane, s, cs);
    using namespace wb;
    const float s1 = s[0], c1 = cs[0], st = s[1], ct = cs[1], sb = s[2], cb = cs[2];
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

  // wedge_slack and its q-gradient sq (the tie-split mean of the maximal
  // faces' normals through dP/dq, the even tie split over the points), the
  // six points over the lanes of the team (point r on lane r % T), each point's max over the faces in its lane (the faces in
  // the outer loop: a face is loaded once for the lane's points, and their
  // chains overlap).  First the values alone, their max merged across the
  // team: where it is below 0 in every team of the warp, the group's
  // gradient scale is 0 (no point is active, nor NaN), so smax = 0 and
  // sq = 0 and the gradient is not formed.  Else the points' relu(max)
  // accumulators with their tie-split gradients, merged by max_acc_team.
  // Every lane ends with the same smax and sq.
  template <int T, class C>
  __device__ static float wedge_team(const wb::ArmFK& a, const C& c, int lane, float* sq) {
    constexpr int RP = (6 + T - 1) / T;   // points a lane
    float live = 0.f;
    for (int h = 0; h < c.n_hp; ++h) live += c.p(c.L.hpm + h);
    float hw[RP][3], px[RP], pz[RP];
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) {
      const int r = min(rr * T + lane, 5);   // past 5: a copy, not taken
      hp_weights(r, hw[rr]);
      px[rr] = 0.f;
      pz[rr] = 0.f;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        px[rr] += hw[rr][p] * a.ax[p];
        pz[rr] += hw[rr][p] * a.az[p];
      }
    }
    // face h's distance from point rr, NEG_BIG for a masked face
    auto dist = [&](int h, int rr, float& n0, float& n2) {
      n0 = c.p(c.L.hpn + 3 * h);
      n2 = c.p(c.L.hpn + 3 * h + 2);
      return c.p(c.L.hpm + h) > 0.f
                 ? n0 * (c.p(c.L.hpp + 3 * h) - px[rr]) +
                       c.p(c.L.hpn + 3 * h + 1) * c.p(c.L.hpp + 3 * h + 1) +
                       n2 * (c.p(c.L.hpp + 3 * h + 2) - pz[rr])
                 : NEG_BIG;
    };
    wb::MaxAcc<3> m;
    m.init();
    if (live > 0.f) {
      float dmax[RP];
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) dmax[rr] = -INFINITY;
#pragma unroll 2
      for (int h = 0; h < c.n_hp; ++h) {
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) {
          float n0, n2;
          const float d = dist(h, rr, n0, n2);
          dmax[rr] = d > dmax[rr] || isnan(d) ? d : dmax[rr];
        }
      }
      float vmax = -INFINITY;
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        const float v = -dmax[rr];
        if (rr * T + lane < 6) vmax = v > vmax || isnan(v) ? v : vmax;
      }
#pragma unroll
      for (int off = 1; off < T; off <<= 1) {
        const float v = __shfl_xor_sync(TEAM_FULL, vmax, off, T);
        vmax = v > vmax || isnan(v) ? v : vmax;
      }
      if (__any_sync(TEAM_FULL, !(vmax < 0.f))) {
        float en0[RP], en2[RP], cnt[RP];
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) {
          dmax[rr] = -INFINITY;
          en0[rr] = en2[rr] = cnt[rr] = 0.f;
        }
        for (int h = 0; h < c.n_hp; ++h) {
#pragma unroll
          for (int rr = 0; rr < RP; ++rr) {
            float n0, n2;
            const float d = dist(h, rr, n0, n2);
            const bool gt = d > dmax[rr] || isnan(d);
            const bool eq = d == dmax[rr];
            dmax[rr] = gt ? d : dmax[rr];
            cnt[rr] = gt ? 1.f : (eq ? cnt[rr] + 1.f : cnt[rr]);
            en0[rr] = gt ? n0 : (eq ? en0[rr] + n0 : en0[rr]);
            en2[rr] = gt ? n2 : (eq ? en2[rr] + n2 : en2[rr]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) {
          if (rr * T + lane >= 6) continue;
          float g[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            float AX = 0.f, AZ = 0.f;
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              AX += hw[rr][p] * a.axq[p][i];
              AZ += hw[rr][p] * a.azq[p][i];
            }
            g[i] = (en0[rr] * AX + en2[rr] * AZ) / cnt[rr];
          }
          m.add(-dmax[rr], g);
        }
        max_acc_team<T>(m);
      }
    }
    const float gs = m.grad_scale();
#pragma unroll
    for (int i = 0; i < 3; ++i) sq[i] = m.gsum[i] * gs;
    return m.smax();
  }

  // The four self-collision rows (selfcol) in every lane: values sv[r],
  // q-gradients sg[r] (-(v . dv/dq) / |v|); row r on lane r % T, exchanged by shuffles.
  template <int T>
  __device__ static void self_team(const wb::ArmFK& a, int lane, float (&sv)[4],
                                   float (&sg)[4][3]) {
    constexpr int RS = (4 + T - 1) / T;
    float v[RS], g[RS][3];
#pragma unroll
    for (int rr = 0; rr < RS; ++rr) {
      const int r = min(rr * T + lane, 3);
      float dw[3];
      self_weights(r, dw);
      float vx = 0.f, vz = 0.f;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        vx += dw[p] * a.ax[p];
        vz += dw[p] * a.az[p];
      }
      const float n = sqrtf(vx * vx + vz * vz + wb::EPS);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float AX = 0.f, AZ = 0.f;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          AX += dw[p] * a.axq[p][i];
          AZ += dw[p] * a.azq[p][i];
        }
        g[rr][i] = -(vx * AX + vz * AZ) / n;
      }
      v[rr] = wb::SELF_R - n;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      sv[r] = __shfl_sync(TEAM_FULL, v[r / T], r % T, T);
#pragma unroll
      for (int i = 0; i < 3; ++i) sg[r][i] = __shfl_sync(TEAM_FULL, g[r / T][i], r % T, T);
    }
  }

  // The expansion of one stage (or the terminal) that the lanes share.
  template <int T>
  struct Expand {
    float e[3], sq[3], sm, sv[4], sg[4][3];
    float jx[3], jz[3];   // CART: rows 0 and 2 of Je (its row 1 is 0)

    template <class C>
    __device__ __forceinline__ Expand(const float* x, const C& c, int row, int lane) {
      wb::ArmFK a;
      fk_team<T>(x, lane, a);
      if constexpr (CART) {
        ee_error(a, c, row, e);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          jx[i] = a.axq[2][i];
          jz[i] = a.azq[2][i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) e[i] = x[i] - c.p(c.L.xref + row * 3 + i);
      }
      sm = wedge_team<T>(a, c, lane, sq);
      self_team<T>(a, lane, sv, sg);
    }

    // x row t = rho T + lane (a task past the x rows adds nothing): the
    // tracking with weights W (CART: (Je^T W e)_t and row t of Je^T W Je,
    // as lanes_bwd_factory's `tracking` sums them), the q-box rows
    // (multipliers lam[0..5]) and the self-collision rows (lam[r_self..]);
    // x[t] = xt
    template <class C>
    __device__ __forceinline__ void add_row(int rho, int lane, float xt, const C& c, int W,
                                            const float* lam, int S, int r_self, float mu,
                                            float& q, float (&acc)[NX]) const {
      const int t = rho * T + lane;
      const bool live = t < NX;
      const int tc = live ? t : NX - 1;
      const float two_s = 2.f * c.inv_scale;
      const float w = c.ex(S_W);
      const float wsm = w * sm;
      const float st = ric::pick<T, NX>(rho, lane, [&](int i) { return sq[i]; });
      if constexpr (CART) {
        const float jxt = ric::pick<T, NX>(rho, lane, [&](int i) { return jx[i]; });
        const float jzt = ric::pick<T, NX>(rho, lane, [&](int i) { return jz[i]; });
        float we0 = 0.f, we2 = 0.f;   // (W e)_0, (W e)_2
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          we0 += c.p(W + l) * e[l];
          we2 += c.p(W + 6 + l) * e[l];
        }
        q = live ? q + two_s * ((jxt * we0 + jzt * we2) + wsm * st) : q;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          // (W Je)_{0j}, (W Je)_{2j}
          const float wj0 = c.p(W) * jx[j] + c.p(W + 2) * jz[j];
          const float wj2 = c.p(W + 6) * jx[j] + c.p(W + 8) * jz[j];
          const float h = two_s * ((jxt * wj0 + jzt * wj2) + w * (st * sq[j]));
          acc[j] = live ? acc[j] + h : acc[j];
        }
      } else {
        float we = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) we += c.p(W + tc * 3 + j) * e[j];
        q = live ? q + two_s * (we + wsm * st) : q;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float h = two_s * (c.p(W + tc * 3 + j) + w * (st * sq[j]));
          acc[j] = live ? acc[j] + h : acc[j];
        }
      }
      // the q-box rows t (q - hi) and 3 + t (lo - q)
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const bool hi = side == 0;
        const float val = hi ? xt - c.ex(S_QHI + tc) : c.ex(S_QLO + tc) - xt;
        const float tv = fmaxf(lam[(hi ? tc : 3 + tc) * S] + mu * val, 0.f);
        q = live ? q + (hi ? 1.f : -1.f) * tv : q;
        const float d = tv > 0.f ? mu : 0.f;
#pragma unroll
        for (int j = 0; j < NX; ++j) acc[j] = live && j == t ? acc[j] + d : acc[j];
      }
      // the self-collision rows, dense in x
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float tv = fmaxf(lam[(r_self + r) * S] + mu * sv[r], 0.f);
        const float ma = tv > 0.f ? mu : 0.f;
        const float gt = ric::pick<T, NX>(rho, lane, [&](int i) { return sg[r][i]; });
        q = live ? q + tv * gt : q;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const float h = ma * (gt * sg[r][j]);
          acc[j] = live ? acc[j] + h : acc[j];
        }
      }
    }
  };

  // The terminal (tracking with P, the q-box and self-collision rows) ->
  // Vx, Vxx of the lane's rows: in[e * S] holds x_N, then lamt.
  template <int T, class C>
  __device__ static void team_term(const float* in, int S, const C& c, float mu, int lane,
                                   ric::TeamTile<NX, NU>& tt) {
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = in[i * S];
    const Expand<T> ex(x, c, c.N, lane);
#pragma unroll
    for (int rho = 0; rho < (NX + T - 1) / T; ++rho) {
      const int t = rho * T + lane;
      float q = 0.f, acc[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) acc[j] = 0.f;
      ex.add_row(rho, lane, in[(t < NX ? t : 0) * S], c, c.L.P, in + NX * S, S, 6, mu, q, acc);
      if (t < NX) {
        tt.vx[t] = q;
#pragma unroll
        for (int j = 0; j < NX; ++j) tt.V[t][j] = acc[j];
      }
    }
  }

  // A stage's rows (tracking with Q, the input and rate forms, every box
  // row) of the lane's tasks: in[e * S] holds x_k, u_k, lam_k.
  template <int T, class C>
  __device__ static void team_rows(const float* x, const float* in, int S, int k, const C& c,
                                   float mu, int lane, float (&q)[ric::rounds<NX, NU, T>()],
                                   float (&acc)[ric::rounds<NX, NU, T>()][NX],
                                   float (&uu)[ric::rounds<NX, NU, T>()][NU]) {
    constexpr int R = ric::rounds<NX, NU, T>();
    const float two_s = 2.f * c.inv_scale;
    const float* lam = in + (NX + NU) * S;
    {
      const Expand<T> ex(x, c, k, lane);
#pragma unroll
      for (int rho = 0; rho < R; ++rho) {
        if (rho * T >= NX) continue;     // no x row in this round
        const int t = rho * T + lane;
        ex.add_row(rho, lane, in[(t < NX ? t : 0) * S], c, c.L.Q, lam, S, 12, mu, q[rho],
                   acc[rho]);
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
      const int Ri = c.L.R + i * NU, Mi = c.L.M + i * NU;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NU; ++j) s += c.p(Ri + j) * eu[j] + c.p(Mi + j) * edu[j];
      q[rho] = urow ? q[rho] + two_s * s : q[rho];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        uu[rho][j] = urow ? uu[rho][j] + two_s * (c.p(Ri + j) + c.p(Mi + j)) : uu[rho][j];
      // the rate-box rows 6 + i and 9 + i
      const float ed = in[(NX + i) * S] - c.p(c.L.ulast + k * NU + i);
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const bool hi = side == 0;
        const float val = hi ? ed - c.ex(S_DDHI + i) : c.ex(S_DDLO + i) - ed;
        const float tv = fmaxf(lam[(hi ? 6 + i : 9 + i) * S] + mu * val, 0.f);
        q[rho] = urow ? q[rho] + (hi ? 1.f : -1.f) * tv : q[rho];
        const float d = tv > 0.f ? mu : 0.f;
#pragma unroll
        for (int j = 0; j < NU; ++j) uu[rho][j] = urow && j == i ? uu[rho][j] + d : uu[rho][j];
      }
    }
  }

  // ---- the team line search (generic_fwd.cuh, generic_fwd_team_kernel):
  // teams of FWD_TEAM lanes a candidate.  The FK's three sincos over the
  // lanes (fk_team), the step q + dt dq in every lane; the six wedge points
  // (values only, the faces in the outer loop), the four self rows (one a
  // lane), the rows of the Q, R and M forms and the PHR rows as items over
  // the lanes.  Lanes a candidate: 2 was the fastest of 1, 2, 4 and 8 at
  // batch 8192, 0.0537 / 0.0475 / 0.0718 / 0.1225 ms a launch against the
  // one-thread kernel's 0.0655-0.0669 (N=20; H100 80GB HBM3, 700.00 W;
  // PERF.md), as for C.endpoint.
  static constexpr int FWD_TEAM = 2;
  // a candidate's vector: x, u, then the errors e, eu, ed and the self
  // rows' values
  enum : int {
    FV_E = NX + NU,
    FV_EU = FV_E + 3,
    FV_ED = FV_EU + 3,
    FV_S = FV_ED + 3,
    FWD_NV = (FV_S + 4) | 1,
  };
  // the stage rows' table, then the terminal rows'
  static constexpr int FWD_ROWS = 4 * (NC + NCT);

  // The PHR row tables: {bound, sign, live, vector index} of the stage rows
  // [q_hi, q_lo, du_hi, du_lo, self] and of the terminal rows [q_hi, q_lo,
  // self]; a self row's value is in the vector (bound 0).
  __device__ static void fwd_team_rows(const float* sv, float* rt) {
    const float* ex = sv + Statics<Arm>::EXTRA;
#pragma unroll
    for (int r = 0; r < NC + NCT; ++r) {
      const int g = r < NC ? r : (r - NC < 6 ? r - NC : r - NC + 6);   // its stage row
      const int i = g % 3;
      const int kind = g / 3;   // 0 q_hi, 1 q_lo, 2 du_hi, 3 du_lo, 4.. self
      rt[4 * r] = kind == 0 ? ex[S_QHI + i] : kind == 1 ? ex[S_QLO + i]
                : kind == 2 ? ex[S_DDHI + i] : kind == 3 ? ex[S_DDLO + i] : 0.f;
      rt[4 * r + 1] = kind == 1 || kind == 3 ? -1.f : 1.f;
      rt[4 * r + 2] = 1.f;
      rt[4 * r + 3] = __int_as_float(kind < 2 ? i : (kind < 4 ? FV_ED + i : FV_S + g - 12));
    }
  }

  // relu(max) of the wedge's six points over the lanes of the team (point r
  // on lane r % T), each point's max over the faces in its lane with the
  // faces in the outer loop, merged across the team (values only; NaN
  // stays NaN).  No live face: an empty group (0).  Every lane ends with it.
  template <int T, class C>
  __device__ static float wedge_value_team(const wb::ArmFK& a, const C& c, int lane) {
    constexpr int RP = (6 + T - 1) / T;   // points a lane
    float live = 0.f;
    for (int h = 0; h < c.n_hp; ++h) live += c.p(c.L.hpm + h);
    float vmax = -INFINITY;
    if (live > 0.f) {
      float px[RP], pz[RP], dmax[RP];
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        const int r = min(rr * T + lane, 5);   // past 5: a copy, not taken
        float hw[3];
        hp_weights(r, hw);
        px[rr] = 0.f;
        pz[rr] = 0.f;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          px[rr] += hw[p] * a.ax[p];
          pz[rr] += hw[p] * a.az[p];
        }
        dmax[rr] = -INFINITY;
      }
#pragma unroll 2
      for (int h = 0; h < c.n_hp; ++h) {
        const float n0 = c.p(c.L.hpn + 3 * h), n1 = c.p(c.L.hpn + 3 * h + 1),
                    n2 = c.p(c.L.hpn + 3 * h + 2);
        const float p0 = c.p(c.L.hpp + 3 * h), p1 = c.p(c.L.hpp + 3 * h + 1),
                    p2 = c.p(c.L.hpp + 3 * h + 2);
        const bool on = c.p(c.L.hpm + h) > 0.f;
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) {
          const float d = on ? n0 * (p0 - px[rr]) + n1 * p1 + n2 * (p2 - pz[rr]) : NEG_BIG;
          dmax[rr] = d > dmax[rr] || isnan(d) ? d : dmax[rr];
        }
      }
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        const float v = -dmax[rr];
        if (rr * T + lane < 6) vmax = v > vmax || isnan(v) ? v : vmax;
      }
    }
#pragma unroll
    for (int off = 1; off < T; off <<= 1) {
      const float v = __shfl_xor_sync(TEAM_FULL, vmax, off, T);
      vmax = v > vmax || isnan(v) ? v : vmax;
    }
    return vmax < 0.f ? 0.f : vmax;
  }

  // The self rows' values SELF_R - |check - ee| (arm frame) into
  // v[FV_S + r], row r on lane r % T.
  template <int T>
  __device__ static void self_value_team(const wb::ArmFK& a, int lane, float* v) {
#pragma unroll
    for (int rr = 0; rr < (4 + T - 1) / T; ++rr) {
      const int r = rr * T + lane;
      const int rc = min(r, 3);
      float dw[3];
      self_weights(rc, dw);
      float vx = 0.f, vz = 0.f;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        vx += dw[p] * a.ax[p];
        vz += dw[p] * a.az[p];
      }
      if (r < 4) v[FV_S + r] = wb::SELF_R - sqrtf(vx * vx + vz * vz + wb::EPS);
    }
  }

  // The FK of x, the self rows into the team's vector (then __syncwarp:
  // the vector is complete) and the lane's share of W relu(max)^2 (lane 0)
  // and of the form e^T W e, e at v[FV_E].  CART: e is the end point minus
  // reference row `row`, written here into e and v[FV_E]; else the caller
  // wrote q minus it.
  template <int T, class C>
  __device__ static float track_team(const float* x, float* e, int row, int W, const C& c,
                                     float* v, int lane) {
    wb::ArmFK a;
    fk_team<T>(x, lane, a);
    if constexpr (CART) {
      ee_error(a, c, row, e);
#pragma unroll
      for (int i = 0; i < 3; ++i) v[FV_E + i] = e[i];
    }
    self_value_team<T>(a, lane, v);
    __syncwarp();
    const float sm = wedge_value_team<T>(a, c, lane);
    const float tr = lane == 0 ? c.ex(S_W) * sm * sm : 0.f;
    return tr + qform_rows<T, 3>(c, W, e, v + FV_E, lane);
  }

  template <int T, class C>
  __device__ static float fwd_team_stage(const float* x, const float* u, int k, const C& c,
                                         float* v, const float* rt, const float* lam, int SC,
                                         float mu, int lane, float* xn) {
    float e[3], eu[3], ed[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if constexpr (!CART) e[i] = x[i] - c.p(c.L.xref + k * 3 + i);
      eu[i] = u[i] - c.p(c.L.uref + k * 3 + i);
      ed[i] = u[i] - c.p(c.L.ulast + k * 3 + i);
      if constexpr (!CART) v[FV_E + i] = e[i];
      v[FV_EU + i] = eu[i];
      v[FV_ED + i] = ed[i];
      xn[i] = x[i] + c.dt * u[i];
    }
    float tr = track_team<T>(x, e, k, c.L.Q, c, v, lane);
    tr += qform_rows<T, 3>(c, c.L.R, eu, v + FV_EU, lane);
    tr += qform_rows<T, 3>(c, c.L.M, ed, v + FV_ED, lane);
    const float pen = phr_rows<T, NC>(rt, v, lam, SC, mu, lane);
    return c.inv_scale * tr + pen * (0.5f / mu);
  }

  template <int T, class C>
  __device__ static float fwd_team_terminal(const float* x, const C& c, float* v, const float* rt,
                                            const float* lamt, int SC, float mu, int lane) {
    float e[3];
    if constexpr (!CART) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        e[i] = x[i] - c.p(c.L.xref + c.N * 3 + i);
        v[FV_E + i] = e[i];
      }
    }
    const float tr = track_team<T>(x, e, c.N, c.L.P, c, v, lane);
    const float pen = phr_rows<T, NCT>(rt + 4 * NC, v, lamt, SC, mu, lane);
    return c.inv_scale * tr + pen * (0.5f / mu);
  }
};

}  // namespace gen

GEN_ENTRIES(arm, gen::Arm<false>)
GEN_ENTRIES(arm_cart, gen::Arm<true>)
