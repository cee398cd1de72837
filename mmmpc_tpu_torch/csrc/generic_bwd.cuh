// Generic fused AL expansion + Riccati backward sweep, for NVIDIA Hopper
// (sm_90a), instantiated once per formulation (generic_<name>.cu).
//
// Replaces the Pallas TPU kernel mmmpc_tpu/ops/generic_bwd.py::kernel (built
// by make_generic_bwd_fused from a formulation's BwdHooks, with
// _al_rows_stage, _al_rows_term and ops/entry_algebra.py::riccati_stage).
// Per scenario: the terminal expansion gives (Vx, Vxx); then, backward over
// the stages, the Q blocks of the next value function through the
// dynamics Jacobians, plus the stage's scaled Gauss-Newton model and its PHR
// rows, one Riccati step (Cholesky of Quu + reg I, kff = -Quu^-1 Qu,
// K = -Quu^-1 Qux), the value update, and Vxx symmetrised.  A formulation
// without BWD_TEAM (demo, base) runs one thread a scenario on
// ric::riccati_step (riccati_step.cuh); one with it (arm, endpoint) runs
// the team kernel below on ric::team_step (riccati_team.cuh), which kernel
// E shares with dense Jacobians.  The plain PyTorch version is
// ops/generic_bwd.py::plain_bwd.
//
// The formulation F supplies, besides the members listed in
// generic_common.cuh:
//   a_nz(i, j), b_nz(i, j)      constexpr: the structurally nonzero entries
//                               of A = df/dx and B = df/du
//   dyn_jac(x, u, c, A, Bm)     their values (entries outside the masks are
//                               never read)
// and, for the one-thread kernel:
//   stage_quad(x, u, k, c, q)   adds the scaled stage model into the Q blocks
//                               q.x, q.u, q.xx, q.uu, q.ux and declares its
//                               box rows through q.box_x
//   term_quad(x, c, q)          the same for the terminal (q.x, q.xx)
// A formulation with BWD_TEAM supplies the team hooks team_term and
// team_rows (listed at the team kernel below) instead of these two.
// Every array index in the hooks and the loops here is a constant after
// unrolling, so the arrays live in registers and the masks fold at compile
// time (the counterpart of the TPU kernel's trace-time literal folding;
// nvcc may not fold x * 0.f, so zeros are skipped, never multiplied).
//
// What bounds the one-thread kernel on this card: a serial recurrence of N
// stages a thread, each a few hundred dependent FLOPs on an NX x NX value
// function in registers, so one warp's chain; the grid (64 blocks of 128
// threads at the bench batch of 8192) does not: blocks of 64 or 32 threads
// ran as fast (PERF.md).  Its stage inputs x_k, u_k, lam_k come through a
// two-stage buffer in shared memory, each thread's own column, filled by
// cp.async one stage ahead, so their loads leave the chain: D.base 0.0377
// -> 0.0324 ms a launch, D.demo 0.0142 -> 0.0073 (N=20, B=8192; H100 80GB
// HBM3, 700.00 W; PERF.md).  D.base stays here, not on the team kernel: on
// the team step it ran 0.0573-0.0694 ms at 1, 2, 4 or 8 lanes a scenario;
// for a (6, 2) step the exchange costs more than the lanes save.
#pragma once

#include <type_traits>

#include "cp_async.cuh"
#include "generic_common.cuh"
#include "riccati_step.cuh"
#include "riccati_team.cuh"

namespace gen {

// The Q blocks of one stage (q.xx holds Vxx between stages) and the PHR row
// assembly of ops/generic_bwd.py::_al_rows_stage / _al_rows_term: for a
// live row c <= 0 with multiplier lam, t = max(lam + mu c, 0) adds t dc to
// the gradient and mu [t > 0] dc dc^T to the Hessian.  Masked rows are
// skipped.
template <int NX, int NU>
struct QBlocks : ric::QStage<NX, NU> {
  using ric::QStage<NX, NU>::x;
  using ric::QStage<NX, NU>::xx;
  const float* lam;  // the multipliers of the current rows: row r at lam[r * B]
  int B;             // their stride
  float mu;

  // row whose gradient is sign * e_i in x
  __device__ __forceinline__ void box_x(int r, bool live, float val, int i,
                                        float sign) {
    if (!live) return;
    const float t = fmaxf(lam[r * B] + mu * val, 0.f);
    x[i] += sign * t;
    xx[i][i] += t > 0.f ? mu : 0.f;
  }
};

// The formulation's dynamics Jacobians in registers, with its masks.
template <class F>
struct JacRegs {
  float A[F::NX][F::NX], Bm[F::NX][F::NU];
  __host__ __device__ static constexpr bool a_nz(int i, int j) {
    return F::a_nz(i, j);
  }
  __host__ __device__ static constexpr bool b_nz(int i, int j) {
    return F::b_nz(i, j);
  }
  __device__ __forceinline__ float a(int i, int j) const { return A[i][j]; }
  __device__ __forceinline__ float b(int i, int j) const { return Bm[i][j]; }
};

constexpr int BWD_THREADS = 128;

// The one-thread kernel: thread b owns scenario b; its stage inputs are the
// column tid of the block's buffer (element-major, thread fastest), two
// parities.  No thread reads another's column, so cp.async's own wait
// orders a thread's copies before its reads and no barrier is needed; a
// thread past the batch returns at once.
template <class F>
__global__ void __launch_bounds__(BWD_THREADS, 4)
generic_bwd_kernel(const __grid_constant__ Statics<F> st,
                   const float* __restrict__ pp, const float* __restrict__ X,
                   const float* __restrict__ U, const float* __restrict__ lam,
                   const float* __restrict__ lamt,
                   const float* __restrict__ reg, float* __restrict__ kff_out,
                   float* __restrict__ K_out, float mu, int N, int B) {
  constexpr int NX = F::NX, NU = F::NU, NC = F::NC, NCT = F::NCT;
  constexpr int NIN = NX + NU + NC, S = BWD_THREADS;  // stage inputs, stride
  static_assert(F::NE == 0, "the generic kernels take no terminal equality");
  static_assert(NX + NCT <= NIN, "the terminal inputs fill one stage slot");
  __shared__ float inbuf[2 * NIN * S];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * blockDim.x + tid;
  if (b >= B) return;

  // element i of a batch-last array from row `first` on into the buffer
  auto copy_rows = [&](float* dst, const float* src, int first, int n) {
#pragma unroll
    for (int i = 0; i < n; ++i)
      wb::cp_async4(dst + i * S, src + static_cast<long long>(first + i) * B + b);
  };
  // stage k's inputs into parity k & 1
  auto issue_stage = [&](int k) {
    float* dst = inbuf + (k & 1) * NIN * S + tid;
    copy_rows(dst, X, k * NX, NX);
    copy_rows(dst + NX * S, U, k * NU, NU);
    copy_rows(dst + (NX + NU) * S, lam, k * NC, NC);
  };
  // the terminal inputs x_N, lamt into parity N & 1, then stage N - 1
  float* const term = inbuf + (N & 1) * NIN * S + tid;
  copy_rows(term, X, N * NX, NX);
  copy_rows(term + NX * S, lamt, 0, NCT);
  wb::cp_async_commit();
  issue_stage(N - 1);
  wb::cp_async_commit();

  const Ctx<F> c = make_ctx<F>(st, pp, N);
  const float rg = reg[b];
  QBlocks<NX, NU> q;
  q.B = S;
  q.mu = mu;
  float Vx[NX];

  // ---------------- terminal expansion -> Vx, Vxx (= q.xx) ----------------
  wb::cp_async_wait<1>();
  {
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i] = term[i * S];
      q.x[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) q.xx[i][j] = 0.f;
    }
    q.lam = term + NX * S;
    F::term_quad(x, c, q);
#pragma unroll
    for (int i = 0; i < NX; ++i) Vx[i] = q.x[i];
  }

  // ---------------- backward over the stages ----------------
  // Stage k's inputs have landed after the wait; stage k - 1's go into the
  // parity that stage k + 1 (or the terminal) has finished with.
  for (int k = N - 1; k >= 0; --k) {
    wb::cp_async_wait<0>();
    if (k > 0) issue_stage(k - 1);
    wb::cp_async_commit();
    const float* in = inbuf + (k & 1) * NIN * S + tid;
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = in[i * S];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = in[(NX + i) * S];
    JacRegs<F> jac;
    F::dyn_jac(x, u, c, jac.A, jac.Bm);

    // ---- one Riccati step, the stage's scaled model and PHR rows added
    // between the Q-block products and the Cholesky
    ric::riccati_step<NX, NU>(
        jac, [&]() {
          q.lam = in + (NX + NU) * S;
          F::stage_quad(x, u, k, c, q);
        },
        q, Vx, rg, kff_out + static_cast<long long>(k) * NU * B + b,
        K_out + static_cast<long long>(k) * NU * NX * B + b, B);
  }
}

// ---------------- the team kernel (formulations with BWD_TEAM) ----------------
//
// A formulation F that declares BWD_TEAM = T runs its backward sweep on
// ric::team_step (riccati_team.cuh), after kernel B's design
// (wholebody_bwd.cu): a team of T lanes of one warp per scenario, 128 / T
// scenarios a block, at most 128 registers a thread, the packed params and
// the statics in shared memory once a block, and a two-stage buffer of the
// stage inputs x_k, u_k, lam_k of the block's scenarios (element-major,
// scenario fastest) filled one stage ahead by cp.async, the terminal's
// inputs and the params first.  One __syncthreads a stage.  Every lane
// computes the stage's dynamics Jacobians (registers, F's masks: the team
// step folds them at compile time); F's stage model is the hooks' (they
// may share its work over the lanes):
//   team_term<T>(in, S, c, mu, lane, tile)           terminal -> V, vx
//   team_rows<T>(x, in, S, k, c, mu, lane, q, acc, uu)  the stage's rows
// add the rows of the lane's tasks.  A ragged batch runs on the clamped
// scenario index with masked stores.  The other formulations (demo, base)
// keep the one-thread kernel above.
template <class F, class = void>
struct BwdTeam {
  static constexpr int value = 0;
};
template <class F>
struct BwdTeam<F, std::void_t<decltype(F::BWD_TEAM)>> {
  static constexpr int value = F::BWD_TEAM;
};

// The formulation's Jacobians in registers, as the team step takes them.
template <class F>
struct TeamJac : JacRegs<F> {
  static constexpr bool RUNTIME_ROWS = false;
};

constexpr int TEAM_THREADS = 128;

template <class F>
__host__ __device__ constexpr int team_scen() {
  return TEAM_THREADS / BwdTeam<F>::value;
}

// Floats of the team kernel's shared memory: the tiles, the stage buffer,
// the statics, the packed params.
template <class F>
__host__ __device__ inline int team_smem_floats(int N, int n_obs, int n_hp) {
  constexpr int S = team_scen<F>();
  return S * ric::tile_stride<F::NX, F::NU>() + 2 * (F::NX + F::NU + F::NC) * S +
         Statics<F>::SIZE + F::layout(N, n_obs, n_hp).size;
}

template <class F>
__global__ void __launch_bounds__(TEAM_THREADS, 4)
generic_bwd_team_kernel(const __grid_constant__ Statics<F> st,
                        const float* __restrict__ pp,
                        const float* __restrict__ X,
                        const float* __restrict__ U,
                        const float* __restrict__ lam,
                        const float* __restrict__ lamt,
                        const float* __restrict__ reg,
                        float* __restrict__ kff_out,
                        float* __restrict__ K_out, float mu, int N, int B) {
  constexpr int NX = F::NX, NU = F::NU, NC = F::NC, NCT = F::NCT;
  constexpr int T = BwdTeam<F>::value, S = team_scen<F>();
  constexpr int NIN = NX + NU + NC;   // stage inputs: x_k, u_k, lam_k
  constexpr int R = ric::rounds<NX, NU, T>();
  static_assert(F::NE == 0, "the generic kernels take no terminal equality");
  static_assert(NX + NCT <= NIN, "the terminal inputs fill one stage slot");
  extern __shared__ __align__(16) float smem[];
  const int n_obs = static_cast<int>(st.v[GST_N_OBS]);
  const int n_hp = static_cast<int>(st.v[GST_N_HP]);
  const typename F::Layout L = F::layout(N, n_obs, n_hp);
  float* inbuf = smem + S * ric::tile_stride<NX, NU>();
  float* sv = inbuf + 2 * NIN * S;
  float* ps = sv + Statics<F>::SIZE;

  const int tid = threadIdx.x;
  const int team = tid / T, lane = tid % T;
  const int b0 = blockIdx.x * S;
  const int bs = min(b0 + team, B - 1);
  const bool store = b0 + team < B;
  ric::TeamTile<NX, NU>& tt = *reinterpret_cast<ric::TeamTile<NX, NU>*>(
      smem + team * ric::tile_stride<NX, NU>());

  // The block's copies: thread tid moves scenario cs = tid % S (clamped to
  // the batch) of the elements ci, ci + T, ...
  const int cs = tid % S, ci = tid / S;
  const int cb = min(b0 + cs, B - 1);
  auto issue_stage = [&](int k) {
    float* dst = inbuf + (k & 1) * NIN * S + cs;
    for (int i = ci; i < NIN; i += T) {
      const float* src =
          i < NX ? X + static_cast<long long>(k * NX + i) * B
          : i < NX + NU ? U + static_cast<long long>(k * NU + i - NX) * B
                        : lam + static_cast<long long>(k * NC + i - NX - NU) * B;
      wb::cp_async4(dst + i * S, src + cb);
    }
  };
  // the terminal inputs x_N, lamt into buffer N & 1, and the params
  {
    float* dst = inbuf + (N & 1) * NIN * S + cs;
    for (int i = ci; i < NX + NCT; i += T) {
      const float* src = i < NX ? X + static_cast<long long>(N * NX + i) * B
                                : lamt + static_cast<long long>(i - NX) * B;
      wb::cp_async4(dst + i * S, src + cb);
    }
    for (int i = tid; i < L.size; i += TEAM_THREADS) wb::cp_async4(ps + i, pp + i);
    wb::cp_async_commit();
  }
  issue_stage(N - 1);
  wb::cp_async_commit();
  for (int i = tid; i < Statics<F>::SIZE; i += TEAM_THREADS) sv[i] = st.v[i];
  const float rg = __ldg(reg + bs);
  wb::cp_async_wait<1>();
  __syncthreads();
  const SmemCtx<F> c{sv, ps, L, sv[GST_DT], sv[GST_INV_SCALE], N, n_obs, n_hp};

  // ---------------- terminal expansion -> Vx, Vxx ----------------
  F::template team_term<T>(inbuf + (N & 1) * NIN * S + team, S, c, mu, lane, tt);

  // ---------------- backward over the stages ----------------
  // One barrier a stage: after it stage k's inputs have landed and every
  // team is done with stage k+1, whose buffer takes stage k-1's loads.
  for (int k = N - 1; k >= 0; --k) {
    wb::cp_async_wait<0>();
    __syncthreads();
    if (k > 0) issue_stage(k - 1);
    wb::cp_async_commit();
    const float* in = inbuf + (k & 1) * NIN * S + team;
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = in[i * S];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = in[(NX + i) * S];
    TeamJac<F> jac;
    F::dyn_jac(x, u, c, jac.A, jac.Bm);
    ric::team_step<NX, NU, T>(
        jac,
        [&](float (&q)[R], float (&acc)[R][NX], float (&uu)[R][NU]) {
          F::template team_rows<T>(x, in, S, k, c, mu, lane, q, acc, uu);
        },
        tt, rg, lane, kff_out + static_cast<long long>(k) * NU * B + bs,
        K_out + static_cast<long long>(k) * NU * NX * B + bs, B, store);
  }
}

// The launch at batch B: lanes a scenario, threads a block, blocks,
// dynamic shared-memory bytes.
struct BwdGeometry {
  int team, threads, blocks, smem;
};

template <class F>
BwdGeometry bwd_geometry(int N, int n_obs, int n_hp, int B) {
  if constexpr (BwdTeam<F>::value > 0) {
    constexpr int S = team_scen<F>();
    return {BwdTeam<F>::value, TEAM_THREADS, (B + S - 1) / S,
            team_smem_floats<F>(N, n_obs, n_hp) * 4};
  } else {
    return {1, BWD_THREADS, (B + BWD_THREADS - 1) / BWD_THREADS, 0};
  }
}

template <class F>
int launch_bwd(const float* statics, const float* params, const float* X,
               const float* U, const float* lam, const float* lamt,
               const float* /*lame*/, const float* reg, float* kff, float* K,
               float mu, int N, int B, void* stream) {
  Statics<F> st;
  std::memcpy(st.v, statics, sizeof(st.v));
  if (B <= 0 || N <= 0) return 0;
  const BwdGeometry g = bwd_geometry<F>(
      N, static_cast<int>(st.v[GST_N_OBS]), static_cast<int>(st.v[GST_N_HP]), B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (BwdTeam<F>::value > 0) {
    if (g.smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          generic_bwd_team_kernel<F>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    generic_bwd_team_kernel<F><<<g.blocks, g.threads, g.smem, s>>>(
        st, params, X, U, lam, lamt, reg, kff, K, mu, N, B);
  } else {
    generic_bwd_kernel<F><<<g.blocks, g.threads, 0, s>>>(
        st, params, X, U, lam, lamt, reg, kff, K, mu, N, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gen
