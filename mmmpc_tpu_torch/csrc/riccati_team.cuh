// One backward Riccati step of a batched iLQR sweep, spread over a team of T
// lanes of one warp that works on one scenario.  Device code for NVIDIA
// Hopper (sm_90a), shared by the Riccati sweep on precomputed blocks
// (riccati.cu, kernel E) and the endpoint formulation's fused backward
// (generic_bwd.cuh's team kernel, kernel D.endpoint); the counterpart of
// ops/entry_algebra.py::riccati_stage + the Vxx symmetrisation, as
// riccati_step.cuh is for one thread.
//
// The team exchanges through its tile in shared memory (TeamTile), with
// __syncwarp between the phases.  On entry the tile holds the next stage's
// value function (V = Vxx, vx = Vx); on exit, this stage's.
//
// - Row tasks.  Task t < NX gives Qx[t] and row t of Qxx = A^T Vxx A; task
//   NX + i gives Qu[i] and rows i of Qux = B^T Vxx A and Quu = B^T Vxx B.
//   Lane l takes the tasks t = rho T + l of the rounds rho < R; its R
//   tasks run together, so each row of V, A and B is read once a lane.
//   w = row t of [A | B]^T Vxx first, then w A and w B.  The caller's hook
//   then adds the stage's own rows to the rows the lane owns.
// - The factor and the solves.  Every lane factors the NU x NU matrix
//   Quu + reg I itself (exact sqrtf and correctly rounded pivot
//   reciprocals, as riccati_step.cuh), so the factor is never exchanged;
//   the 1 + NX columns of [Qu | Qux] are solved by the lanes, a lane's
//   columns side by side, and the lane of a column stores its gains.
// - The value update, row by row: the lane of row r writes Vx[r] and
//   column r of M = Quu K + Qux over column r of Qux (it alone reads that
//   column), then row r of Vxx = Qxx + K^T M + Qux^T K, then row r of the
//   symmetrised 0.5 (v_rj + v_jr), the transposed entries from the tile.
//   Each value is computed by one lane, so every lane reads the same bits.
//   The sums run in riccati_step.cuh's order but for the Q blocks: w A
//   associates (A^T Vxx) A where the one-thread step takes A^T (Vxx A).
//
// The Jacobians come through an accessor J with
//   static constexpr bool a_nz(i, j), b_nz(i, j)   structural nonzeros
//   float a(i, j), b(i, j)                          their values
//   static constexpr bool RUNTIME_ROWS
// and, with RUNTIME_ROWS, float coef(p, t): entry p of row t of [A | B]^T
// at a task t known at run time (Jacobians in shared memory, kernel E).
// Without it (Jacobians in registers, kernel D) that entry is picked by
// selects over the tasks of the round, each a constant index once the
// rounds are unrolled: an entry that is a structural zero for every task
// of a round drops its terms at compile time (nvcc may not fold x * 0.f),
// and a lane whose task has a zero where another task of its round has
// not adds 0 * v.
#pragma once

namespace ric {

// The exchange tile of one team.
template <int NX, int NU>
struct TeamTile {
  float V[NX][NX];     // Vxx, carried between stages (symmetric)
  float Qxx[NX][NX];   // Qxx, then the unsymmetrised new Vxx
  float Qux[NU][NX];   // Qux; then column r holds M = Quu K + Qux
  float K[NU][NX];
  float Quu[NU][NU];
  float q[NX + NU];    // [Qx | Qu]
  float vx[NX];        // Vx
  float kf[NU];
};

// Floats between two teams' tiles: odd, so that the teams of a warp read
// the same entry of their tiles from different banks.
template <int NX, int NU>
__host__ __device__ constexpr int tile_stride() {
  return static_cast<int>(sizeof(TeamTile<NX, NU>) / sizeof(float)) | 1;
}

// Row tasks (NX + NU) in R rounds of T lanes.
template <int NX, int NU, int T>
__host__ __device__ constexpr int rounds() {
  return (NX + NU + T - 1) / T;
}

// Whether any task of round rho has a structurally nonzero entry p of its
// row of [A | B]^T.
template <int NX, int NU, int T, class J>
__host__ __device__ constexpr bool coef_live(int p, int rho) {
  bool live = false;
  for (int l = 0; l < T; ++l) {
    const int t = rho * T + l;
    if (t < NX) live = live || J::a_nz(p, t);
    else if (t < NX + NU) live = live || J::b_nz(p, t - NX);
  }
  return live;
}

// Entry p of row t = rho T + lane of [A | B]^T (0 past the last task).
template <int NX, int NU, int T, class J>
__device__ __forceinline__ float coef(const J& jac, int p, int rho, int lane) {
  if constexpr (J::RUNTIME_ROWS) {
    return jac.coef(p, rho * T + lane);
  } else {
    float c = 0.f;
#pragma unroll
    for (int l = 0; l < T; ++l) {
      const int t = rho * T + l;
      if (t < NX) {
        if (J::a_nz(p, t)) c = lane == l ? jac.a(p, t) : c;
      } else if (t < NX + NU) {
        if (J::b_nz(p, t - NX)) c = lane == l ? jac.b(p, t - NX) : c;
      }
    }
    return c;
  }
}

// The value f(t) of the lane's task t = rho T + lane, picked by selects
// over the round's tasks, each a constant index (0 past the last task):
// for values of a task held in registers.
template <int T, int NT, class F>
__device__ __forceinline__ float pick(int rho, int lane, F&& f) {
  float v = 0.f;
#pragma unroll
  for (int l = 0; l < T; ++l) {
    const int t = rho * T + l;
    if (t < NT) v = lane == l ? f(t) : v;
  }
  return v;
}

// One step at stage k.  rows(q, acc, uu) adds the stage's own rows to the
// lane's tasks: q[rho] (Qx[t] or Qu[t - NX]), acc[rho] (row t of Qxx or row
// t - NX of Qux) and, for a u task, uu[rho] (its row of Quu).  kff_out /
// K_out point at the team's scenario of stage k in the batch-last
// (N, NU, B) / (N, NU, NX, B) outputs; store is false on a lane of a
// clamped scenario past the batch.
template <int NX, int NU, int T, class J, class Rows>
__device__ __forceinline__ void team_step(const J& jac, Rows&& rows,
                                          TeamTile<NX, NU>& tt, float rg,
                                          int lane, float* kff_out,
                                          float* K_out, int B, bool store) {
  constexpr int NT = NX + NU;
  constexpr int R = rounds<NX, NU, T>();
  constexpr int R2 = (NX + T - 1) / T;       // rounds of the x rows
  constexpr int RC = (1 + NX + T - 1) / T;   // rounds of the solve columns

  // ---- row tasks: w = row t of [A | B]^T Vxx, vq = entry t of
  // [A | B]^T Vx.  Sums start at -0.f, the identity of float addition.
  float acc[R][NX], uu[R][NU], q[R];
  {
    float w[R][NX];
#pragma unroll
    for (int rho = 0; rho < R; ++rho) {
      q[rho] = -0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) w[rho][j] = -0.f;
    }
#pragma unroll
    for (int p = 0; p < NX; ++p) {
      bool any = false;
#pragma unroll
      for (int rho = 0; rho < R; ++rho)
        any = any || coef_live<NX, NU, T, J>(p, rho);
      if (!any) continue;
      float vrow[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) vrow[j] = tt.V[p][j];
      const float vp = tt.vx[p];
#pragma unroll
      for (int rho = 0; rho < R; ++rho) {
        if (!coef_live<NX, NU, T, J>(p, rho)) continue;
        const float c = coef<NX, NU, T>(jac, p, rho, lane);
        q[rho] += c * vp;
#pragma unroll
        for (int j = 0; j < NX; ++j) w[rho][j] += c * vrow[j];
      }
    }
    // acc = w A, uu = w B (u tasks only)
#pragma unroll
    for (int rho = 0; rho < R; ++rho) {
#pragma unroll
      for (int j = 0; j < NX; ++j) acc[rho][j] = -0.f;
#pragma unroll
      for (int j = 0; j < NU; ++j) uu[rho][j] = -0.f;
    }
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        if (!J::a_nz(r, j)) continue;
        const float arj = jac.a(r, j);
#pragma unroll
        for (int rho = 0; rho < R; ++rho) acc[rho][j] += w[rho][r] * arj;
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        if (!J::b_nz(r, j)) continue;
        const float brj = jac.b(r, j);
#pragma unroll
        for (int rho = 0; rho < R; ++rho)
          if ((rho + 1) * T > NX) uu[rho][j] += w[rho][r] * brj;
      }
    }
  }

  // ---- + the stage's own rows, then the lane's rows into the tile
  rows(q, acc, uu);
#pragma unroll
  for (int rho = 0; rho < R; ++rho) {
    const int t = rho * T + lane;
    if (t >= NT) continue;
    tt.q[t] = q[rho];
    if (t < NX) {
#pragma unroll
      for (int j = 0; j < NX; ++j) tt.Qxx[t][j] = acc[rho][j];
    } else if ((rho + 1) * T > NX) {
#pragma unroll
      for (int j = 0; j < NX; ++j) tt.Qux[t - NX][j] = acc[rho][j];
#pragma unroll
      for (int j = 0; j < NU; ++j) tt.Quu[t - NX][j] = uu[rho][j];
    }
  }
  __syncwarp();

  // ---- Cholesky of Quu + reg I in every lane (pivot reciprocals: the
  // substitutions multiply), then the columns of [kff | K] =
  // -(Quu + reg I)^-1 [Qu | Qux] over the lanes
  float Qu[NU][NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) Qu[i][j] = tt.Quu[i][j];
  }
  {
    float Lc[NU][NU], Dinv[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = Qu[i][j] + (i == j ? rg : 0.f);
#pragma unroll
        for (int p = 0; p < j; ++p) s -= Lc[i][p] * Lc[j][p];
        if (i == j) {
          const float r = sqrtf(s);
          Dinv[i] = __frcp_rn(r);   // 1 / r, correctly rounded
          Lc[i][i] = r;
        } else {
          Lc[i][j] = s * Dinv[j];
        }
      }
    }
    // the lane's columns c = rc T + lane side by side, so that their
    // substitution chains overlap; a column past the last is solved on
    // the last one and not stored
    float y[RC][NU], z[RC][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int rc = 0; rc < RC; ++rc) {
        const int c = min(rc * T + lane, NX);
        float s = c == 0 ? tt.q[NX + i] : tt.Qux[i][c - 1];
#pragma unroll
        for (int p = 0; p < i; ++p) s -= Lc[i][p] * y[rc][p];
        y[rc][i] = s * Dinv[i];
      }
    }
#pragma unroll
    for (int i = NU - 1; i >= 0; --i) {
#pragma unroll
      for (int rc = 0; rc < RC; ++rc) {
        float s = y[rc][i];
#pragma unroll
        for (int p = i + 1; p < NU; ++p) s -= Lc[p][i] * z[rc][p];
        z[rc][i] = s * Dinv[i];
      }
    }
#pragma unroll
    for (int rc = 0; rc < RC; ++rc) {
      const int c = rc * T + lane;
      if (c >= 1 + NX) continue;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if (c == 0) {
          tt.kf[i] = -z[rc][i];
          if (store) kff_out[i * B] = -z[rc][i];
        } else {
          tt.K[i][c - 1] = -z[rc][i];
          if (store) K_out[(i * NX + c - 1) * B] = -z[rc][i];
        }
      }
    }
  }
  __syncwarp();

  // ---- value update (Quu without reg):
  //   Vx  = Qx + K^T (Quu kff + Qu) + Qux^T kff
  //   Vxx = Qxx + K^T M + Qux^T K with M = Quu K + Qux, symmetrised
  float gc[R2][NU];
  {
    float kf[NU], wv[NU];
#pragma unroll
    for (int p = 0; p < NU; ++p) kf[p] = tt.kf[p];
#pragma unroll
    for (int p = 0; p < NU; ++p) {
      float s = tt.q[NX + p];
#pragma unroll
      for (int r = 0; r < NU; ++r) s += Qu[p][r] * kf[r];
      wv[p] = s;
    }
#pragma unroll
    for (int rr = 0; rr < R2; ++rr) {
      const int r = rr * T + lane;
      const int rc = r < NX ? r : NX - 1;
      float kc[NU];
#pragma unroll
      for (int p = 0; p < NU; ++p) {
        kc[p] = tt.K[p][rc];
        gc[rr][p] = tt.Qux[p][rc];
      }
      float s = tt.q[rc];
#pragma unroll
      for (int p = 0; p < NU; ++p) s += kc[p] * wv[p] + gc[rr][p] * kf[p];
      float m[NU];
#pragma unroll
      for (int p = 0; p < NU; ++p) {
        float t = gc[rr][p];
#pragma unroll
        for (int i = 0; i < NU; ++i) t += Qu[p][i] * kc[i];
        m[p] = t;
      }
      if (r < NX) {
        tt.vx[r] = s;
#pragma unroll
        for (int p = 0; p < NU; ++p) tt.Qux[p][r] = m[p];
      }
    }
  }
  __syncwarp();
  float v[R2][NX];
#pragma unroll
  for (int rr = 0; rr < R2; ++rr) {
    const int r = rr * T + lane;
    const int rc = r < NX ? r : NX - 1;
#pragma unroll
    for (int j = 0; j < NX; ++j) v[rr][j] = tt.Qxx[rc][j];
  }
#pragma unroll
  for (int p = 0; p < NU; ++p) {
    float mrow[NX], krow[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      mrow[j] = tt.Qux[p][j];
      krow[j] = tt.K[p][j];
    }
#pragma unroll
    for (int rr = 0; rr < R2; ++rr) {
      const int r = rr * T + lane;
      const float kr = tt.K[p][r < NX ? r : NX - 1], gr = gc[rr][p];
#pragma unroll
      for (int j = 0; j < NX; ++j) v[rr][j] += kr * mrow[j] + gr * krow[j];
    }
  }
  // a lane reads and writes only its own rows of Qxx up to here
#pragma unroll
  for (int rr = 0; rr < R2; ++rr) {
    const int r = rr * T + lane;
    if (r < NX) {
#pragma unroll
      for (int j = 0; j < NX; ++j) tt.Qxx[r][j] = v[rr][j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int rr = 0; rr < R2; ++rr) {
    const int r = rr * T + lane;
    if (r < NX) {
#pragma unroll
      for (int j = 0; j < NX; ++j) tt.V[r][j] = 0.5f * (v[rr][j] + tt.Qxx[j][r]);
    }
  }
}

}  // namespace ric
