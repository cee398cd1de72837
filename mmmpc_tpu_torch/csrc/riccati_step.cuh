// One backward Riccati step of a batched iLQR sweep, for the one-thread
// form of the generic fused backward kernel (generic_bwd.cuh): D.demo and
// D.base, whose small steps lose more to a team's exchange than its lanes
// save (E at (2, 1) and D.base on the team step ran slower; PERF.md).
// Kernel E and the team D kernels (D.arm, D.endpoint) step on
// riccati_team.cuh.  Device code for NVIDIA Hopper (sm_90a); the
// counterpart of ops/entry_algebra.py::riccati_stage + the Vxx
// symmetrisation.
//
// One thread owns one scenario.  From the next stage's value function (Vx,
// Vxx; Vxx held in q.xx) and the dynamics Jacobians:
//   Qx = A^T Vx, Qu = B^T Vx, Quu = B^T Vxx B, Qux = B^T Vxx A,
//   Qxx = A^T Vxx A,
// then the stage's own blocks are added by the caller's hook, then the
// Cholesky of Quu + reg I (exact sqrtf and pivot reciprocals: the
// substitutions multiply), [kff | K] = -(Quu + reg I)^-1 [Qu | Qux], the
// value update with Quu without reg, and Vxx symmetrised.
//
// The Jacobians come through an accessor J with
//   static constexpr bool a_nz(i, j), b_nz(i, j)   structural nonzeros
//   float a(i, j), b(i, j)                          their values
// Every index is a constant after unrolling, so an all-false mask entry
// drops its term at compile time (kernel D's sparse dynamics; nvcc may not
// fold x * 0.f, so zeros are skipped, never multiplied), and an all-true
// mask gives the dense products.
#pragma once

namespace ric {

// The Q blocks of one stage; between stages xx holds Vxx.
template <int NX, int NU>
struct QStage {
  float x[NX], u[NU];
  float xx[NX][NX], uu[NU][NU], ux[NU][NX];
};

// One step at stage k.  On entry q.xx = Vxx and Vx of stage k + 1; on exit
// Vx and q.xx hold stage k's value function.  add_stage() adds the stage's
// own gradient / Hessian blocks into q between the products and the
// Cholesky.  kff_out / K_out point at this scenario's entry of stage k in
// the batch-last (N, NU, B) / (N, NU, NX, B) outputs.
template <int NX, int NU, class J, class AddStage>
__device__ __forceinline__ void riccati_step(const J& jac, AddStage&& add_stage,
                                             QStage<NX, NU>& q, float (&Vx)[NX],
                                             float rg, float* kff_out,
                                             float* K_out, int B) {
  // ---- Q blocks of the next value function.  Sums start at -0.f, the
  // identity of float addition, so a single live term folds to itself.
  //   Qx = A^T Vx, Qu = B^T Vx, Quu = B^T Vxx B
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float s = -0.f;
#pragma unroll
    for (int p = 0; p < NX; ++p)
      if (J::a_nz(p, i)) s += jac.a(p, i) * Vx[p];
    q.x[i] = s;
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float s = -0.f;
#pragma unroll
    for (int p = 0; p < NX; ++p)
      if (J::b_nz(p, i)) s += jac.b(p, i) * Vx[p];
    q.u[i] = s;
  }
  {
    float VB[NX][NU];
#pragma unroll
    for (int p = 0; p < NX; ++p) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        float s = -0.f;
#pragma unroll
        for (int r = 0; r < NX; ++r)
          if (J::b_nz(r, j)) s += q.xx[p][r] * jac.b(r, j);
        VB[p][j] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        float s = -0.f;
#pragma unroll
        for (int p = 0; p < NX; ++p)
          if (J::b_nz(p, i)) s += jac.b(p, i) * VB[p][j];
        q.uu[i][j] = s;
      }
    }
  }
  // Vxx <- Vxx A in place, row by row
#pragma unroll
  for (int p = 0; p < NX; ++p) {
    float row[NX];
#pragma unroll
    for (int r = 0; r < NX; ++r) row[r] = q.xx[p][r];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = -0.f;
#pragma unroll
      for (int r = 0; r < NX; ++r)
        if (J::a_nz(r, j)) s += row[r] * jac.a(r, j);
      q.xx[p][j] = s;
    }
  }
  // Qux = B^T (Vxx A)
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = -0.f;
#pragma unroll
      for (int p = 0; p < NX; ++p)
        if (J::b_nz(p, i)) s += jac.b(p, i) * q.xx[p][j];
      q.ux[i][j] = s;
    }
  }
  // Qxx = A^T (Vxx A) in place, column by column
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    float col[NX];
#pragma unroll
    for (int p = 0; p < NX; ++p) col[p] = q.xx[p][j];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = -0.f;
#pragma unroll
      for (int p = 0; p < NX; ++p)
        if (J::a_nz(p, i)) s += jac.a(p, i) * col[p];
      q.xx[i][j] = s;
    }
  }

  // ---- + the stage's own blocks
  add_stage();

  // ---- Cholesky of Quu + reg I (pivot reciprocals: substitutions
  // multiply), then [kff | K] = -(Quu + reg I)^-1 [Qu | Qux]
  float Lc[NU][NU], Dinv[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = q.uu[i][j] + (i == j ? rg : 0.f);
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
  for (int cc = 0; cc < 1 + NX; ++cc) {
    float y[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float s = cc == 0 ? q.u[i] : q.ux[i][cc - 1];
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
      if (cc == 0) kf[i] = -z[i];
      else Kg[i][cc - 1] = -z[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    kff_out[i * B] = kf[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) K_out[(i * NX + j) * B] = Kg[i][j];
  }

  // ---- value update (Quu without reg):
  //   Vx  = Qx + K^T (Quu kff + Qu) + Qux^T kff
  //   Vxx = Qxx + K^T M + Qux^T K with M = Quu K + Qux, symmetrised
  float w[NU];
#pragma unroll
  for (int p = 0; p < NU; ++p) {
    float s = q.u[p];
#pragma unroll
    for (int r = 0; r < NU; ++r) s += q.uu[p][r] * kf[r];
    w[p] = s;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float s = q.x[i];
#pragma unroll
    for (int p = 0; p < NU; ++p) s += Kg[p][i] * w[p] + q.ux[p][i] * kf[p];
    Vx[i] = s;
  }
  float Mk[NU][NX];
#pragma unroll
  for (int p = 0; p < NU; ++p) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = q.ux[p][j];
#pragma unroll
      for (int r = 0; r < NU; ++r) s += q.uu[p][r] * Kg[r][j];
      Mk[p][j] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = i; j < NX; ++j) {
      float vij = q.xx[i][j], vji = q.xx[j][i];
#pragma unroll
      for (int p = 0; p < NU; ++p) {
        vij += Kg[p][i] * Mk[p][j] + q.ux[p][i] * Kg[p][j];
        vji += Kg[p][j] * Mk[p][i] + q.ux[p][j] * Kg[p][i];
      }
      const float v = 0.5f * (vij + vji);
      q.xx[i][j] = v;
      q.xx[j][i] = v;
    }
  }
}

}  // namespace ric
