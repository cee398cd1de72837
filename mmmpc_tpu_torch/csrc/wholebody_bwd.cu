// Fused AL expansion + Riccati backward sweep of the whole-body qref MPC,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mmmpc_tpu/ops/wholebody_bwd.py::_kernel
// (built by make_bwd_fused, with _fk_partials, _slack_with_grads,
// _relu_max_grad and ops/entry_algebra.py::riccati_stage).  Per scenario:
// the terminal AL expansion gives (Vx, Vxx); then, backward over the stages,
// the Gauss-Newton expansion of the tracking, input and rate costs, the
// slack-group gradient from closed-form FK partials (even tie split), the
// PHR rows of the boxes, the sparse dynamics Jacobians A and B, and one
// Riccati step: Q blocks, Cholesky of Quu + reg I, kff = -Quu^-1 Qu,
// K = -Quu^-1 Qux, the value update, and Vxx symmetrised.  The plain PyTorch
// version of the same function is ops/wholebody_bwd.py::BwdFused.plain.
//
// What bounds it on this card: a serial recurrence of N stages per thread,
// each a few thousand dependent FLOPs on a 9 x 9 value function, so per-
// thread latency, and register spills: Vxx, the Q blocks, the Cholesky
// factor and the gains are about 250 live floats against a budget of 255
// registers a thread.  Bytes are small (about 42 floats in per stage and
// scenario, 50 out).  At the bench batch of 8192 with 128-thread blocks the
// grid is 64 blocks on 132 SMs: more than half of the SMs idle.
//
// Design: one thread per scenario, the stage loop inside the thread with
// (Vx, Vxx) carried in registers (or local memory where ptxas spills);
// batch-last loads and stores coalesce across the warp.  The sparse A = I + E
// and B are applied through their live entries only (struct Jac), the
// counterpart of the TPU kernel's trace-time literal folding.  The
// stale-slack-index rows of the reference (terminal self-collision on
// stage N-1) are chained through A and B at k = N-1.
#include <cstring>

#include "wholebody_common.cuh"

namespace wb {

// PHR row of the expansion: adds +-max(lam + mu c, 0) to the gradient entry
// and the active indicator to the Hessian diagonal count.
__device__ __forceinline__ void phr_row(float lam, float mu, float c, bool live,
                                        float sign, float& g, float& act) {
  if (!live) return;
  const float z = lam + mu * c;
  g += sign * fmaxf(z, 0.f);
  act += z > 0.f ? 1.f : 0.f;
}

__global__ void __launch_bounds__(128)
bwd_kernel(const Statics st, const float* __restrict__ pp,
           const float* __restrict__ X, const float* __restrict__ U,
           const float* __restrict__ lam, const float* __restrict__ lamt,
           const float* __restrict__ lame, const float* __restrict__ reg,
           float* __restrict__ kff_out, float* __restrict__ K_out, float mu,
           int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const float dt = st.v[ST_DT];
  const float two_s = 2.f * st.v[ST_INV_SCALE];
  const float base_radius = st.v[ST_BASE_RADIUS];
  const int n_obs = static_cast<int>(st.v[ST_N_OBS]);
  const int n_hp = static_cast<int>(st.v[ST_N_HP]);
  const Layout L = param_layout(N, n_obs, n_hp);
  const float S = ld(pp, L.S);
  const float rg = reg[b];

  float Vx[NX], Vxx[NX][NX];

  // ---------------- terminal expansion -> Vx, Vxx ----------------
  {
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = X[(N * NX + i) * B + b];
    FK f;
    fk(x, f);
    MaxAcc<NX> m;
    m.init();
    float unused = 0.f;
    // no self-collision rows: they rode stage N-1's slack group
    ground_rows<true, NX>(x, pp, L, n_obs, base_radius, unused, &m);
    halfplane_rows<true, NX>(f, pp, L, n_hp, unused, &m);
    const float smax = m.smax();
    const float gs = m.grad_scale();
    float sx[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) sx[i] = m.gsum[i] * gs;

    float ex[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) ex[i] = x[i] - ld(pp, L.xref + N * NX + i);
    float act[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += ld(pp, L.P + i * NX + j) * ex[j];
      Vx[i] = two_s * (acc + S * smax * sx[i]);
      act[i] = 0.f;
      phr_row(lamt[i * B + b], mu, x[i] - st.v[ST_XHI + i],
              st.v[ST_XMHI + i] != 0.f, 1.f, Vx[i], act[i]);
      phr_row(lamt[(NX + i) * B + b], mu, st.v[ST_XLO + i] - x[i],
              st.v[ST_XMLO + i] != 0.f, -1.f, Vx[i], act[i]);
    }
    // maskable terminal position equality h = m (x[:2] - ref)
    const float em = ld(pp, L.eqm);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float h = em * ex[i];
      Vx[i] += em * (lame[i * B + b] + mu * h);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float h = two_s * (ld(pp, L.P + i * NX + j) + S * sx[i] * sx[j]);
        if (i == j) {
          h += mu * act[i];
          if (i < 2) h += mu * em * em;
        }
        Vxx[i][j] = h;
      }
    }
  }

  // ---------------- backward over the stages ----------------
  for (int k = N - 1; k >= 0; --k) {
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = X[(k * NX + i) * B + b];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = U[(k * NU + i) * B + b];

    FK f;
    fk(x, f);
    const Jac J = jacobians(x, u, dt, f.cp, f.sp);

    // slack group: d/dx rows; u-gradients only from the stale-index rows
    MaxAcc<NX + NU> m;
    m.init();
    float unused = 0.f;
    ground_rows<true, NX + NU>(x, pp, L, n_obs, base_radius, unused, &m);
    self_rows<true, NX + NU>(f, unused, &m);
    halfplane_rows<true, NX + NU>(f, pp, L, n_hp, unused, &m);
    if (k == N - 1) {
      // terminal self-collision at x_N = f(x, u), chained through A and B
      float xn[NX];
      step(x, u, dt, f.cp, f.sp, xn);
      FK fn;
      fk(xn, fn);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v3[3];
        combo(fn, SELF_DIFF[r][0], SELF_DIFF[r][1], SELF_DIFF[r][2], v3);
        const float n = sqrtf(v3[0] * v3[0] + v3[1] * v3[1] + v3[2] * v3[2] + EPS);
        float tg[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) tg[i] = 0.f;
        const float w[3] = {-v3[0] / n, -v3[1] / n, -v3[2] / n};
        add_point_grad(fn, SELF_DIFF[r][0], SELF_DIFF[r][1], SELF_DIFF[r][2], w, tg);
        float g[NX + NU];
        At_v(J, tg, g);
        Bt_v(J, tg, g + NX);
        m.add(SELF_R - n, g);
      }
    }
    const float smax = m.smax();
    const float gs = m.grad_scale();
    float sx[NX], su[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) sx[i] = m.gsum[i] * gs;
#pragma unroll
    for (int i = 0; i < NU; ++i) su[i] = m.gsum[NX + i] * gs;

    // ---- gradient of the scaled AL stage cost
    const float Ssm = S * smax;
    float lx[NX], lu[NU], actx[NX], actu[NU];
    float ex[NX], eu[NU], edu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) ex[i] = x[i] - ld(pp, L.xref + k * NX + i);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      eu[i] = u[i] - ld(pp, L.uref + k * NU + i);
      edu[i] = u[i] - ld(pp, L.ulast + k * NU + i);
    }
    const float* lk = lam + static_cast<long long>(k) * NC * B + b;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += ld(pp, L.Q + i * NX + j) * ex[j];
      lx[i] = two_s * (acc + Ssm * sx[i]);
      actx[i] = 0.f;
      phr_row(lk[i * B], mu, x[i] - st.v[ST_XHI + i], st.v[ST_XMHI + i] != 0.f,
              1.f, lx[i], actx[i]);
      phr_row(lk[(NX + i) * B], mu, st.v[ST_XLO + i] - x[i],
              st.v[ST_XMLO + i] != 0.f, -1.f, lx[i], actx[i]);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NU; ++j)
        acc += ld(pp, L.R + i * NU + j) * eu[j] + ld(pp, L.W + i * NU + j) * edu[j];
      lu[i] = two_s * (acc + Ssm * su[i]);
      actu[i] = 0.f;
      phr_row(lk[(2 * NX + i) * B], mu, edu[i] - st.v[ST_DUHI + i],
              st.v[ST_DUMHI + i] != 0.f, 1.f, lu[i], actu[i]);
      phr_row(lk[(2 * NX + NU + i) * B], mu, st.v[ST_DULO + i] - edu[i],
              st.v[ST_DUMLO + i] != 0.f, -1.f, lu[i], actu[i]);
    }

    // ---- Q blocks.  Qx = lx + A^T Vx, Qu = lu + B^T Vx
    float Qx[NX], Qu[NU];
    At_v(J, Vx, Qx);
    Bt_v(J, Vx, Qu);
#pragma unroll
    for (int i = 0; i < NX; ++i) Qx[i] += lx[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) Qu[i] += lu[i];

    // VB = Vxx B (row p of Vxx times B), then Quu = luu + B^T VB
    float VB[NX][NU];
#pragma unroll
    for (int p = 0; p < NX; ++p) {
      VB[p][0] = Vxx[p][3] * J.b30 + Vxx[p][4] * J.b40;
      VB[p][1] = Vxx[p][5] * dt;
      VB[p][2] = Vxx[p][6] * dt;
      VB[p][3] = Vxx[p][7] * dt;
      VB[p][4] = Vxx[p][8] * dt;
    }
    float Quu[NU][NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float col[NX], out[NU];
#pragma unroll
      for (int p = 0; p < NX; ++p) col[p] = VB[p][j];
      Bt_v(J, col, out);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float l = two_s * (ld(pp, L.R + i * NU + j) + ld(pp, L.W + i * NU + j) +
                           S * su[i] * su[j]);
        if (i == j) l += mu * actu[i];
        Quu[i][j] = l + out[i];
      }
    }

    // Vxx <- Vxx A in place (row by row; only columns 2..5 change)
#pragma unroll
    for (int p = 0; p < NX; ++p) {
      const float m0 = Vxx[p][0], m1 = Vxx[p][1], m2 = Vxx[p][2],
                  m3 = Vxx[p][3], m4 = Vxx[p][4];
      Vxx[p][2] = m2 + m3 * J.a32 + m4 * J.a42;
      Vxx[p][3] = m3 + m0 * dt + m4 * J.a43;
      Vxx[p][4] = m4 + m1 * dt + m3 * J.a34;
      Vxx[p][5] = Vxx[p][5] + m2 * dt + m3 * J.a35 + m4 * J.a45;
    }
    // Qux = lux + B^T (Vxx A)
    float Qux[NU][NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float col[NX], out[NU];
#pragma unroll
      for (int p = 0; p < NX; ++p) col[p] = Vxx[p][j];
      Bt_v(J, col, out);
#pragma unroll
      for (int i = 0; i < NU; ++i) Qux[i][j] = two_s * S * su[i] * sx[j] + out[i];
    }
    // Vxx <- Qxx = lxx + A^T (Vxx A) in place (column by column)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float col[NX], out[NX];
#pragma unroll
      for (int p = 0; p < NX; ++p) col[p] = Vxx[p][j];
      At_v(J, col, out);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float l = two_s * (ld(pp, L.Q + i * NX + j) + S * sx[i] * sx[j]);
        if (i == j) l += mu * actx[i];
        Vxx[i][j] = l + out[i];
      }
    }

    // ---- Cholesky of Quu + reg I (pivot reciprocals: substitutions
    // multiply), then [kff | K] = -(Quu + reg I)^-1 [Qu | Qux]
    float Lc[NU][NU], Dinv[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = Quu[i][j] + (i == j ? rg : 0.f);
#pragma unroll
        for (int p = 0; p < j; ++p) s -= Lc[i][p] * Lc[j][p];
        if (i == j) {
          const float r = sqrtf(s);
          Dinv[i] = 1.f / r;
          Lc[i][i] = r;
        } else {
          Lc[i][j] = s * Dinv[j];
        }
      }
    }
    float kf[NU], Kg[NU][NX];
#pragma unroll
    for (int c = 0; c < 1 + NX; ++c) {
      float y[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float s = c == 0 ? Qu[i] : Qux[i][c - 1];
#pragma unroll
        for (int p = 0; p < i; ++p) s -= Lc[i][p] * y[p];
        y[i] = s * Dinv[i];
      }
      float z[NU];
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int p = i + 1; p < NU; ++p) s -= Lc[p][i] * z[p];
        z[i] = s * Dinv[i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if (c == 0) kf[i] = -z[i];
        else Kg[i][c - 1] = -z[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      kff_out[(k * NU + i) * B + b] = kf[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) K_out[((k * NU + i) * NX + j) * B + b] = Kg[i][j];
    }

    // ---- value update (Quu without reg):
    //   Vx  = Qx + K^T (Quu kff + Qu) + Qux^T kff
    //   Vxx = Qxx + K^T Quu K + K^T Qux + Qux^T K, then symmetrised
    float w[NU];
#pragma unroll
    for (int p = 0; p < NU; ++p) {
      float s = Qu[p];
#pragma unroll
      for (int q = 0; q < NU; ++q) s += Quu[p][q] * kf[q];
      w[p] = s;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = Qx[i];
#pragma unroll
      for (int p = 0; p < NU; ++p) s += Kg[p][i] * w[p] + Qux[p][i] * kf[p];
      Vx[i] = s;
    }
    // Vxx_n = Qxx + K^T M + Qux^T K with M = Quu K + Qux (= K^T Quu K +
    // K^T Qux + Qux^T K), symmetrised pairwise in place
    float Mk[NU][NX];
#pragma unroll
    for (int p = 0; p < NU; ++p) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = Qux[p][j];
#pragma unroll
        for (int q = 0; q < NU; ++q) s += Quu[p][q] * Kg[q][j];
        Mk[p][j] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = i; j < NX; ++j) {
        float vij = Vxx[i][j], vji = Vxx[j][i];
#pragma unroll
        for (int p = 0; p < NU; ++p) {
          vij += Kg[p][i] * Mk[p][j] + Qux[p][i] * Kg[p][j];
          vji += Kg[p][j] * Mk[p][i] + Qux[p][j] * Kg[p][i];
        }
        const float v = 0.5f * (vij + vji);
        Vxx[i][j] = v;
        Vxx[j][i] = v;
      }
    }
  }
}

}  // namespace wb

// C entry: statics is a HOST pointer (copied into the kernel argument); all
// other pointers are device memory.  Returns cudaGetLastError() after the
// launch.
extern "C" int wb_bwd_launch(const float* statics, const float* params,
                             const float* X, const float* U, const float* lam,
                             const float* lamt, const float* lame,
                             const float* reg, float* kff, float* K, float mu,
                             int N, int B, void* stream) {
  wb::Statics st;
  std::memcpy(st.v, statics, sizeof(st.v));
  if (B <= 0 || N <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  wb::bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, params, X, U, lam, lamt, lame, reg, kff, K, mu, N, B);
  return static_cast<int>(cudaGetLastError());
}
