// Generic fused forward rollout + parallel line search, for NVIDIA Hopper
// (sm_90a), instantiated once per formulation (generic_<name>.cu).
//
// Replaces the Pallas TPU kernel mmmpc_tpu/ops/generic_fwd.py::kernel (built
// by make_generic_fwd_linesearch from a formulation's LanesHooks).  For every
// scenario b and step size alpha it rolls the closed-loop policy over the
// horizon,
//     u_k     = clamp(U_k + alpha kff_k + K_k (x_k - X_k))
//     cost   += inv_scale stage(x_k, u_k) + PHR(stage rows, lam_k, mu)
//     x_{k+1} = dyn(x_k, u_k)
// and adds inv_scale terminal(x_N) + PHR(terminal rows, lam_t, mu).  A
// masked row has the value NEG_BIG and stays in the PHR sum, where it adds
// -lam^2 / (2 mu), as in the JAX package's core.al_stage.  The plain
// PyTorch version is ops/generic_fwd.py::plain_fwd.
//
// What bounds it on this card: a serial recurrence of N stages (a sincosf
// and a few dozen dependent FLOPs a stage on the chain, up to a few hundred
// off it), so the time is that chain's latency and how many chains an SM
// keeps in flight.  Bytes are small: X, U, kff, K, lam in, the candidates
// out.
//
// Two kernels, chosen by the formulation's FWD_TEAM, both with their stage
// inputs loaded ahead of the chain by cp.async.  The demo (FWD_TEAM = 0)
// runs one thread a candidate: its stage is so short that a team's
// exchanges and barriers cost more than its lanes save (0.01688 ms a
// launch at 2 lanes, 0.01721 / 0.02395 / 0.04117 at 1 / 4 / 8, against
// 0.00741 here).
// The base, the arm and the endpoint run the team kernel at 2 lanes a
// candidate, each scenario's inputs loaded once for its candidates; the
// sweeps that chose the sizes are in the hooks' comments.  N=20, B=8192;
// H100 80GB HBM3, 700.00 W; PERF.md.
//
// The per-scenario instance (K5: each robot its own X_ref, U_ref, Q, P and
// U_last, as the JAX package's vmapped solve takes them) is either kernel
// instantiated with PerScenario<F> (generic_common.cuh).  It reads the
// shared entries from the packed params as the shared instance does, and
// each entry a robot may own from its source (PsSrc: the robot's operand,
// batch-last, or the entry's slot in the packed params where it is
// shared), so the host copies nothing a robot.  The references are read
// one stage at a time: X_ref_k, U_ref_k and U_last_k are stage inputs of
// the ring, loaded ahead with X_k, U_k, kff_k, K_k, lam_k (X_ref_N as the
// ring's stage N).  Q and P are read at every stage: the team kernel
// stages each of its scenarios' Q and P once a block into a column of
// shared memory, the one-thread kernel reads its robot's through the
// read-only cache.  A block of the team kernel thus holds its packed
// params once and 2 NREF^2 floats a scenario beside its stage ring, not
// the whole packed buffer a scenario: 50,656 B for the endpoint (N=20,
// three obstacles), so 4 blocks an SM, as for its shared twin, which its
// 128 registers allow (0.0866 ms a launch against 0.1249-0.1262 for the
// column design; the demo's one-thread K5 ran 1.2x slower on this split;
// N=20, B=8192; H100 80GB HBM3, 700.00 W; PERF.md).  The buffers keep the
// stride FWD_SCEN: a block copies only its scen scenarios, and the idle
// columns cost shared bytes that no longer bound the blocks an SM.  F's
// hooks are the shared instance's, through a context whose readers go to
// the ring, the column or the packed params.
#pragma once

#include "cp_async.cuh"
#include "generic_common.cuh"

namespace gen {

// One scenario's inputs of a stage, in the stage buffers' element order;
// in the per-scenario instance also the stage's reference rows X_ref_k,
// U_ref_k and (where F takes it) U_last_k.
template <class F>
struct FwdIn {
  static constexpr int X = 0;
  static constexpr int U = X + F::NX;
  static constexpr int KFF = U + F::NU;
  static constexpr int K = KFF + F::NU;
  static constexpr int LAM = K + F::NU * F::NX;
  static constexpr int XREF = LAM + F::NC;
  static constexpr int UREF = XREF + F::NREF;
  static constexpr int ULAST = UREF + F::NU;
  static constexpr int SIZE =
      per_scenario_v<F> ? ULAST + (F::HAS_ULAST ? F::NU : 0) : XREF;
};

// ---------------- the one-thread kernel (FWD_TEAM = 0) ----------------
//
// One thread a candidate t = a B + b, 128 threads a block, the stage loop in
// the thread with x and the running cost in registers; the packed params
// through the read-only cache, the statics a __grid_constant__ argument.
// Each thread's stage inputs X_k, U_k, kff_k, K_k, lam_k go by cp.async
// into its own column of a ring of FWD_RING stages in shared memory,
// FWD_RING - 1 stages ahead (generic_bwd.cuh's one-thread kernel loads the
// same way, one stage ahead): a thread reads only what it copied, so no
// barrier is needed, and a thread past the batch returns at once.  A ring
// of 8 was the fastest of 2, 3, 4, 6, 8 and 12 for C.demo, 0.008298 /
// 0.01026 / 0.01024 / 0.007890 / 0.007579 / 0.007991 ms a launch (N=20,
// B=8192; H100 80GB HBM3, 700.00 W; PERF.md); 16 does not fit 48 KB.  F
// supplies
//   dyn(x, u, c, xn)            x_{k+1}
//   stage(x, u, k, c, g) -> raw stage cost; writes the NC row values g
//   terminal(x, c, gt)   -> raw terminal cost; writes the NCT row values gt
constexpr int FWD_THREADS = 128;
constexpr int FWD_RING = 8;

// The one-thread kernel's context in the per-scenario instance: the
// readers of Ctx, the references from the thread's column of the ring
// (stage row's slot), Q and P from the robot's sources.
template <class F>
struct PsCtx {
  using In = FwdIn<F>;
  const Statics<F>& st;
  const float* __restrict__ pp;
  typename F::Layout L;
  float dt, inv_scale;
  int N, n_obs, n_hp;
  const float* ring;   // the thread's column of the ring
  SrcMat q, pw;

  __device__ __forceinline__ float p(int i) const { return __ldg(pp + i); }
  __device__ __forceinline__ float ex(int i) const {
    return st.v[Statics<F>::EXTRA + i];
  }
  __device__ __forceinline__ float in(int row, int e) const {
    return ring[((row % FWD_RING) * In::SIZE + e) * FWD_THREADS];
  }
  __device__ __forceinline__ float xref(int row, int i) const { return in(row, In::XREF + i); }
  __device__ __forceinline__ float uref(int k, int i) const { return in(k, In::UREF + i); }
  __device__ __forceinline__ float ulast(int k, int i) const { return in(k, In::ULAST + i); }
  __device__ __forceinline__ LdgMat mat(int off) const { return LdgMat{pp + off}; }
  __device__ __forceinline__ SrcMat wq() const { return q; }
  __device__ __forceinline__ SrcMat wp() const { return pw; }
};

// The one-thread line search's context of scenario b: Ctx<F> on the
// packed buffer, PsCtx<F> in the per-scenario instance (ring: the thread's
// column of the stage ring).
template <class F>
__device__ __forceinline__ auto fwd_ctx(const Statics<F>& st, const float* pp,
                                        int N, int b, const PsOps& ops,
                                        const float* ring) {
  if constexpr (per_scenario_v<F>) {
    const int n_obs = static_cast<int>(st.v[GST_N_OBS]);
    const int n_hp = static_cast<int>(st.v[GST_N_HP]);
    return PsCtx<F>{st, pp, F::layout(N, n_obs, n_hp), st.v[GST_DT],
                    st.v[GST_INV_SCALE], N, n_obs, n_hp, ring,
                    SrcMat{ops.q.p + b * ops.q.scen, ops.q.row},
                    SrcMat{ops.pw.p + b * ops.pw.scen, ops.pw.row}};
  } else {
    return make_ctx<F>(st, pp, N);
  }
}

template <class F>
__global__ void __launch_bounds__(FWD_THREADS)
generic_fwd_kernel(const __grid_constant__ Statics<F> st,
                   const float* __restrict__ pp, const float* __restrict__ X,
                   const float* __restrict__ U, const float* __restrict__ kff,
                   const float* __restrict__ K, const float* __restrict__ lam,
                   const float* __restrict__ lamt, float* __restrict__ Xc,
                   float* __restrict__ Uc, float* __restrict__ xlast,
                   float* __restrict__ cost, float mu, int N, int B,
                   const __grid_constant__ PsOps ops) {
  constexpr int NX = F::NX, NU = F::NU, NC = F::NC, NCT = F::NCT;
  constexpr int S = FWD_THREADS;   // the ring's stride
  using In = FwdIn<F>;
  static_assert(F::NE == 0, "the generic kernels take no terminal equality");
  static_assert(FWD_RING >= 2, "the ring holds the stage read and the next");
  static_assert(FWD_RING * In::SIZE * S * 4 <= 48 * 1024,
                "the ring fits the static shared memory of a block");
  __shared__ float ring[FWD_RING * In::SIZE * S];
  const int n_alpha = static_cast<int>(st.v[GST_N_ALPHA]);
  const long long t = blockIdx.x * static_cast<long long>(S) + threadIdx.x;
  if (t >= static_cast<long long>(n_alpha) * B) return;
  const int a = static_cast<int>(t / B);
  const int b = static_cast<int>(t % B);

  // rows [0, n) of a batch-last array from row `first` on, into the
  // thread's column at dst
  auto copy_rows = [&](float* dst, const float* src, int first, int n) {
#pragma unroll
    for (int i = 0; i < n; ++i)
      wb::cp_async4(dst + i * S, src + static_cast<long long>(first + i) * B + b);
  };
  // per-scenario: rows [0, n) of source src from row `first` on
  auto copy_src = [&](float* dst, const PsSrc& src, int first, int n) {
#pragma unroll
    for (int i = 0; i < n; ++i)
      wb::cp_async4(dst + i * S, src.p + (first + i) * src.row + b * src.scen);
  };
  // stage k's inputs into slot k % FWD_RING, one commit group a stage;
  // per-scenario with the stage's reference rows, and X_ref_N as stage N
  auto issue_stage = [&](int k) {
    if (k < N) {
      float* dst = ring + (k % FWD_RING) * In::SIZE * S + threadIdx.x;
      copy_rows(dst + In::X * S, X, k * NX, NX);
      copy_rows(dst + In::U * S, U, k * NU, NU);
      copy_rows(dst + In::KFF * S, kff, k * NU, NU);
      copy_rows(dst + In::K * S, K, k * NU * NX, NU * NX);
      copy_rows(dst + In::LAM * S, lam, k * NC, NC);
      if constexpr (per_scenario_v<F>) {
        copy_src(dst + In::XREF * S, ops.xref, k * F::NREF, F::NREF);
        copy_src(dst + In::UREF * S, ops.uref, k * NU, NU);
        if constexpr (F::HAS_ULAST) copy_src(dst + In::ULAST * S, ops.ulast, k * NU, NU);
      }
    } else if constexpr (per_scenario_v<F>) {
      if (k == N)
        copy_src(ring + ((k % FWD_RING) * In::SIZE + In::XREF) * S + threadIdx.x,
                 ops.xref, k * F::NREF, F::NREF);
    }
    wb::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < FWD_RING - 1; ++k) issue_stage(k);

  const auto c = fwd_ctx<F>(st, pp, N, b, ops, ring + threadIdx.x);
  const float alpha = st.v[GST_ALPHAS + a];
  const float inv2mu = 0.5f / mu;

  float x[NX];
  float acc = 0.f;
  for (int k = 0; k < N; ++k) {
    // stage k has landed; stage k + FWD_RING - 1 goes into the slot that
    // stage k - 1 has finished with
    wb::cp_async_wait<FWD_RING - 2>();
    issue_stage(k + FWD_RING - 1);
    const float* in = ring + (k % FWD_RING) * In::SIZE * S + threadIdx.x;
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = in[(In::X + i) * S];
    }

    // ---- control: feedforward + feedback, clamped to the input box
    float dxk[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) dxk[j] = x[j] - in[(In::X + j) * S];
    float u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float fb = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) fb += in[(In::K + i * NX + j) * S] * dxk[j];
      const float v = in[(In::U + i) * S] + alpha * in[(In::KFF + i) * S] + fb;
      u[i] = clampf(v, st.v[Statics<F>::ULO + i], st.v[Statics<F>::UHI + i]);
    }

    // ---- scaled stage cost + PHR over its rows (masked rows included)
    float g[NC > 0 ? NC : 1];
    const float raw = F::stage(x, u, k, c, g);
    float pen = 0.f;
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const float l = in[(In::LAM + r) * S];
      const float tr = fmaxf(l + mu * g[r], 0.f);
      pen += tr * tr - l * l;
    }
    acc += c.inv_scale * raw + pen * inv2mu;

    // ---- outputs + carry
    const long long row = static_cast<long long>(k * n_alpha + a);
#pragma unroll
    for (int i = 0; i < NX; ++i) Xc[(row * NX + i) * B + b] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) Uc[(row * NU + i) * B + b] = u[i];
    float xn[NX];
    F::dyn(x, u, c, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }

  // ---- terminal AL cost (per-scenario: X_ref_N has landed)
  if constexpr (per_scenario_v<F>) wb::cp_async_wait<0>();
  float gt[NCT > 0 ? NCT : 1];
  const float rawN = F::terminal(x, c, gt);
  float pen = 0.f;
#pragma unroll
  for (int r = 0; r < NCT; ++r) {
    const float l = lamt[r * static_cast<long long>(B) + b];
    const float tr = fmaxf(l + mu * gt[r], 0.f);
    pen += tr * tr - l * l;
  }
  acc += c.inv_scale * rawN + pen * inv2mu;

#pragma unroll
  for (int i = 0; i < NX; ++i) xlast[(a * NX + i) * static_cast<long long>(B) + b] = x[i];
  cost[a * static_cast<long long>(B) + b] = acc;
}

// ---------------- the team kernel (FWD_TEAM = T > 0) ----------------
//
// A formulation F with FWD_TEAM = T > 0 runs its line search on the kernel
// below, after kernel A's design (wholebody_fwd.cu, whose head note says
// why):
//
// - A team of T lanes of one warp per candidate, 128 threads a block, at
//   most 128 registers a thread (__launch_bounds__).  The n_alpha
//   candidates of a scenario are neighbouring teams of one block, which
//   holds (128 / T) / n_alpha scenarios, at most FWD_SCEN; the teams left
//   over shadow the last candidate and store nothing.
// - Shared memory per block (FwdTeamSmem): F's table of its PHR rows
//   (built once a block by F::fwd_team_rows), a two-stage buffer of each
//   stage's inputs X_k, U_k, kff_k, K_k, lam_k of the block's scenarios
//   (element-major, scenario fastest) filled by cp.async one stage ahead,
//   each scenario's inputs loaded once and read by all of its candidates;
//   the terminal multipliers; the teams' vectors of the stage, two
//   parities, whose first NX + NU entries are x_k and u_k, the stage's
//   outputs, stored coalesced from there at the next stage; the statics;
//   the packed params; in the per-scenario instance each scenario's Q and
//   P (its reference rows ride in the stage buffer).  One __syncthreads a
//   stage.
// - The chain: the NU rows of U + alpha kff + K dx on the lanes, clamped,
//   u exchanged by shuffles; then F's stage hook takes the step in every
//   lane, so every lane holds the same x.
// - Off the chain, in F's hooks, as items over the lanes: the stage cost's
//   rows and the PHR rows, each into a partial cost of its lane (masked
//   rows stay in the sum, as the plain version keeps them).  The
//   partials are summed once, after the terminal cost, by a butterfly whose
//   every step adds a + b on one side and b + a on the other: every lane
//   ends with the same bits.
// - A ragged batch: the teams of a partial block run on the clamped
//   scenario index min(b, B - 1) and only stores are masked, so every
//   __syncthreads, __syncwarp and shuffle is reached by every thread.
//
// F supplies:
//   FWD_TEAM                lanes a candidate
//   FWD_NV                  floats of a team's vector (odd: the teams'
//                           vectors fall on different banks); x, u first
//   FWD_ROWS                floats of its PHR row table
//   fwd_team_rows(sv, rt)   fills the table from the statics sv
//   fwd_team_stage<T>(x, u, k, c, v, rt, lam, SC, mu, lane, xn)
//       -> the lane's share of inv_scale stage + PHR(stage rows) / (2 mu);
//          x_{k+1} into xn in every lane; v is the team's vector, with x
//          and u written, lam[r * SC] the stage's multipliers
//   fwd_team_terminal<T>(x, c, v, rt, lamt, SC, mu, lane)
//       -> the lane's share of the terminal AL cost
// The controls and the states take the plain version's order of operations
// (U + alpha kff + K dx, then F's step); the cost is summed in another
// order.

constexpr int FWD_TEAM_THREADS = 128;
// The most scenarios a block holds: the stride of the stage buffer.
constexpr int FWD_SCEN = 32;

// The scenarios of a block: its teams over the step sizes, at most
// FWD_SCEN.
__host__ __device__ constexpr int fwd_scen(int team, int n_alpha) {
  return (FWD_TEAM_THREADS / team) / n_alpha < FWD_SCEN
             ? (FWD_TEAM_THREADS / team) / n_alpha : FWD_SCEN;
}

// Offsets (floats) of the parts of a block's shared memory; the row table
// first, so that its float4 reads are aligned.
struct FwdTeamSmem {
  int rows, in, term, vec, sv, ps, col, size;
};

template <class F>
__host__ __device__ inline FwdTeamSmem fwd_team_smem(int N, int n_obs, int n_hp) {
  FwdTeamSmem m;
  int o = 0;
  m.rows = o;  o += F::FWD_ROWS;
  m.in = o;    o += 2 * FwdIn<F>::SIZE * FWD_SCEN;
  m.term = o;  o += F::NCT * FWD_SCEN;
  m.vec = o;   o += 2 * F::FWD_NV * (FWD_TEAM_THREADS / F::FWD_TEAM);
  m.sv = o;    o += Statics<F>::SIZE;
  m.ps = o;    o += F::layout(N, n_obs, n_hp).size;
  // the per-scenario instance: Q, then P, of each scenario
  m.col = o;   o += per_scenario_v<F> ? 2 * F::NREF * F::NREF * FWD_SCEN : 0;
  m.size = o;
  return m;
}

// The team kernel's context in the per-scenario instance: the readers of
// SmemCtx, the references from the stage buffer of the row's parity at the
// team's scenario (ring), Q and P from the scenario's column (col).
template <class F, int SC>
struct PsSmemCtx {
  using In = FwdIn<F>;
  const float* sv;
  const float* pp;
  typename F::Layout L;
  float dt, inv_scale;
  int N, n_obs, n_hp;
  const float* ring;
  const float* col;

  __device__ __forceinline__ float p(int i) const { return pp[i]; }
  __device__ __forceinline__ float ex(int i) const {
    return sv[Statics<F>::EXTRA + i];
  }
  __device__ __forceinline__ float in(int row, int e) const {
    return ring[(row & 1) * In::SIZE * SC + e * SC];
  }
  __device__ __forceinline__ float xref(int row, int i) const { return in(row, In::XREF + i); }
  __device__ __forceinline__ float uref(int k, int i) const { return in(k, In::UREF + i); }
  __device__ __forceinline__ float ulast(int k, int i) const { return in(k, In::ULAST + i); }
  __device__ __forceinline__ SmemMat mat(int off) const { return SmemMat{pp + off}; }
  __device__ __forceinline__ ColMat<SC> wq() const { return ColMat<SC>{col}; }
  __device__ __forceinline__ ColMat<SC> wp() const {
    return ColMat<SC>{col + F::NREF * F::NREF * SC};
  }
};

// The lane's share of e^T M e over the rows r = lane, lane + T, ... of the
// n x n matrix m (a context's mat, wq or wp): the full error e in
// registers, e[r] of the lane's rows from the team's vector ev.
template <int T, int n, class M>
__device__ __forceinline__ float qform_rows(const M& m, const float* e,
                                            const float* ev, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < (n + T - 1) / T; ++q) {
    const int r = min(lane + q * T, n - 1);   // past n: a copy, not added
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < n; ++j) row += m(r * n + j) * e[j];
    const float t = ev[r] * row;
    acc += lane + q * T < n ? t : 0.f;
  }
  return acc;
}

// The lane's share of the PHR sum over rows r = lane, lane + T, ... < n of
// the row table rt ({bound, sign, live, vector index} a row): the row's
// value is sign (v - bound), which is v - hi for an upper row and lo - v
// for a lower one; max(lam + mu c, 0)^2 - lam^2, a masked row -lam^2.
template <int T, int n>
__device__ __forceinline__ float phr_rows(const float* rt, const float* v,
                                          const float* lam, int stride,
                                          float mu, int lane) {
  float pen = 0.f;
#pragma unroll
  for (int q = 0; q < (n + T - 1) / T; ++q) {
    const int r = min(lane + q * T, n - 1);   // past n: a copy, not added
    const float4 t = *reinterpret_cast<const float4*>(rt + 4 * r);
    const float l = lam[r * stride];
    const float tr = t.z != 0.f ? fmaxf(l + mu * (t.y * (v[__float_as_int(t.w)] - t.x)), 0.f)
                                : 0.f;
    const float p = tr * tr - l * l;
    pen += lane + q * T < n ? p : 0.f;
  }
  return pen;
}

template <class F>
__global__ void __launch_bounds__(FWD_TEAM_THREADS, 4)
generic_fwd_team_kernel(const __grid_constant__ Statics<F> st,
                        const float* __restrict__ pp,
                        const float* __restrict__ X,
                        const float* __restrict__ U,
                        const float* __restrict__ kff,
                        const float* __restrict__ K,
                        const float* __restrict__ lam,
                        const float* __restrict__ lamt,
                        float* __restrict__ Xc, float* __restrict__ Uc,
                        float* __restrict__ xlast, float* __restrict__ cost,
                        float mu, int N, int B,
                        const __grid_constant__ PsOps ops) {
  constexpr int NX = F::NX, NU = F::NU, NC = F::NC, NCT = F::NCT;
  constexpr int T = F::FWD_TEAM, TEAMS = FWD_TEAM_THREADS / T;
  constexpr int SC = FWD_SCEN;             // the stage buffer's stride
  constexpr int ROWS = (NU + T - 1) / T;   // control rows a lane
  constexpr int NV = F::FWD_NV, NOUT = NX + NU;
  using In = FwdIn<F>;
  static_assert(F::NE == 0, "the generic kernels take no terminal equality");
  static_assert(NV >= NOUT, "a team's vector starts with x and u");
  extern __shared__ __align__(16) float smem[];
  const int na = static_cast<int>(st.v[GST_N_ALPHA]);
  const int n_obs = static_cast<int>(st.v[GST_N_OBS]);
  const int n_hp = static_cast<int>(st.v[GST_N_HP]);
  const int scen = fwd_scen(T, na);        // scenarios of this block
  const typename F::Layout L = F::layout(N, n_obs, n_hp);
  const FwdTeamSmem M = fwd_team_smem<F>(N, n_obs, n_hp);
  float* rt = smem + M.rows;      // PHR row table
  float* inbuf = smem + M.in;     // stage inputs, two parities
  float* tb = smem + M.term;      // terminal multipliers
  float* vec = smem + M.vec;      // the teams' vectors, two parities
  float* sv = smem + M.sv;        // statics
  float* ps = smem + M.ps;        // packed params
  float* col = smem + M.col;      // per-scenario: Q, P of each scenario

  const int tid = threadIdx.x;
  const int team = tid / T, lane = tid % T;
  const int s = min(team / na, scen - 1);  // idle teams shadow the last
  const int a = team % na;
  const int b0 = blockIdx.x * scen;
  const bool own = team < na * scen && b0 + s < B;   // stores its results

  // The block's copies of per-scenario arrays: thread tid moves scenario
  // cs = tid % scen (clamped to the batch) of the element rows ci,
  // ci + per, ...; buffers are element-major, scenario fastest.
  const int per = FWD_TEAM_THREADS / scen;
  const int cs = tid % scen, ci = tid / scen;
  const bool copier = ci < per;
  const int cb = min(b0 + cs, B - 1);
  // rows [0, n) of a batch-last array from row `first` on, into the
  // buffer's rows 0, 1, ... at dst
  auto copy_rows = [&](float* dst, const float* src, int first, int n) {
    if (!copier) return;
    const float* p = src + static_cast<long long>(first + ci) * B + cb;
    const long long step = static_cast<long long>(per) * B;
#pragma unroll 4
    for (int i = ci; i < n; i += per, p += step) wb::cp_async4(dst + i * SC, p);
  };
  // per-scenario: rows [0, n) of source src from row `first` on, into
  // the buffer's rows 0, 1, ... at dst
  auto copy_src = [&](float* dst, const PsSrc& src, int first, int n) {
    if (!copier) return;
    const float* p = src.p + (first + ci) * src.row + cb * src.scen;
    const long long step = per * src.row;
#pragma unroll 4
    for (int i = ci; i < n; i += per, p += step) wb::cp_async4(dst + i * SC, p);
  };
  // per-scenario: stage k's reference rows into buffer k & 1 (at k = N,
  // X_ref_N alone)
  auto issue_refs = [&](int k) {
    float* dst = inbuf + (k & 1) * In::SIZE * SC + cs;
    copy_src(dst + In::XREF * SC, ops.xref, k * F::NREF, F::NREF);
    if (k < N) {
      copy_src(dst + In::UREF * SC, ops.uref, k * NU, NU);
      if constexpr (F::HAS_ULAST) copy_src(dst + In::ULAST * SC, ops.ulast, k * NU, NU);
    }
  };
  // stage k's inputs into buffer k & 1
  auto issue_stage = [&](int k) {
    float* dst = inbuf + (k & 1) * In::SIZE * SC + cs;
    copy_rows(dst + In::X * SC, X, k * NX, NX);
    copy_rows(dst + In::U * SC, U, k * NU, NU);
    copy_rows(dst + In::KFF * SC, kff, k * NU, NU);
    copy_rows(dst + In::K * SC, K, k * NU * NX, NU * NX);
    copy_rows(dst + In::LAM * SC, lam, k * NC, NC);
    if constexpr (per_scenario_v<F>) issue_refs(k);
  };
  // stage k's outputs x_k, u_k from the vectors of its parity
  auto store_out = [&](int k) {
    if (!copier || b0 + cs >= B) return;
    const float* src = vec + (k & 1) * NV * TEAMS;
#pragma unroll 4
    for (int q = ci; q < na * NOUT; q += per) {
      const int aa = q / NOUT, e = q % NOUT;
      const float v = src[(cs * na + aa) * NV + e];
      if (e < NX)
        Xc[static_cast<long long>((k * na + aa) * NX + e) * B + b0 + cs] = v;
      else
        Uc[static_cast<long long>((k * na + aa) * NU + e - NX) * B + b0 + cs] = v;
    }
  };

  // ---- the params (per-scenario: and each scenario's Q and P), the
  // terminal multipliers and stage 0 in flight; the statics and the row
  // table meanwhile
  for (int i = tid; i < L.size; i += FWD_TEAM_THREADS) wb::cp_async4(ps + i, pp + i);
  if constexpr (per_scenario_v<F>) {
    constexpr int NQ = F::NREF * F::NREF;
    copy_src(col + cs, ops.q, 0, NQ);
    copy_src(col + NQ * SC + cs, ops.pw, 0, NQ);
  }
  copy_rows(tb + cs, lamt, 0, NCT);
  issue_stage(0);
  wb::cp_async_commit();
  for (int i = tid; i < Statics<F>::SIZE; i += FWD_TEAM_THREADS) sv[i] = st.v[i];
  if (tid == 0) F::fwd_team_rows(st.v, rt);
  const auto c = [&] {
    if constexpr (per_scenario_v<F>) {
      return PsSmemCtx<F, SC>{sv, ps, L, st.v[GST_DT], st.v[GST_INV_SCALE], N, n_obs,
                              n_hp, inbuf + s, col + s};
    } else {
      return SmemCtx<F>{sv, ps, L, st.v[GST_DT], st.v[GST_INV_SCALE], N, n_obs, n_hp};
    }
  }();
  const float alpha = st.v[GST_ALPHAS + a];

  float x[NX];
  float acc = 0.f;   // this lane's partial cost
  for (int k = 0; k < N; ++k) {
    wb::cp_async_wait<0>();
    __syncthreads();
    if (k + 1 < N) issue_stage(k + 1);
    if constexpr (per_scenario_v<F>) {
      if (k + 1 == N) issue_refs(N);   // X_ref_N, into the buffer of N's parity
    }
    wb::cp_async_commit();
    if (k > 0) store_out(k - 1);
    const float* in = inbuf + (k & 1) * In::SIZE * SC + s;
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = in[(In::X + i) * SC];
    }

    // ---- the chain: the rows of U + alpha kff + K dx on the lanes,
    // clamped, u exchanged by shuffles
    float dx[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) dx[j] = x[j] - in[(In::X + j) * SC];
    float ur[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = min(lane + r * T, NU - 1);   // past NU: a copy, unused
      float fb = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) fb += in[(In::K + i * NX + j) * SC] * dx[j];
      const float v = in[(In::U + i) * SC] + alpha * in[(In::KFF + i) * SC] + fb;
      ur[r] = clampf(v, sv[Statics<F>::ULO + i], sv[Statics<F>::UHI + i]);
    }
    float u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = __shfl_sync(TEAM_FULL, ur[i / T], i % T, T);

    // ---- the team's vector (every lane writes the same values), then
    // the step and the lane's share of the stage cost
    float* v = vec + (k & 1) * NV * TEAMS + team * NV;
#pragma unroll
    for (int i = 0; i < NX; ++i) v[i] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) v[NX + i] = u[i];
    float xn[NX];
    acc += F::template fwd_team_stage<T>(x, u, k, c, v, rt, in + In::LAM * SC, SC,
                                         mu, lane, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }

  // ---- the terminal AL cost of x_N
  wb::cp_async_wait<0>();
  __syncthreads();
  store_out(N - 1);
  {
    float* v = vec + (N & 1) * NV * TEAMS + team * NV;
#pragma unroll
    for (int i = 0; i < NX; ++i) v[i] = x[i];
    acc += F::template fwd_team_terminal<T>(x, c, v, rt, tb + s, SC, mu, lane);
  }

  // ---- the team's sum of the partial costs: a + b on one side of each
  // step, b + a on the other, so every lane holds the same bits
#pragma unroll
  for (int off = 1; off < T; off <<= 1)
    acc += __shfl_xor_sync(TEAM_FULL, acc, off, T);
  if (own) {
    const int b = b0 + s;
#pragma unroll
    for (int i = 0; i < NX; ++i)
      if (i % T == lane) xlast[(a * NX + i) * static_cast<long long>(B) + b] = x[i];
    if (lane == 0) cost[a * static_cast<long long>(B) + b] = acc;
  }
}

// The launch at batch B with n_alpha step sizes: lanes a candidate,
// threads a block, blocks, dynamic shared-memory bytes.
struct FwdGeometry {
  int team, threads, blocks, smem;
};

template <class F>
FwdGeometry fwd_geometry(int N, int n_obs, int n_hp, int n_alpha, int B) {
  if constexpr (F::FWD_TEAM > 0) {
    const int scen = fwd_scen(F::FWD_TEAM, n_alpha);
    return {F::FWD_TEAM, FWD_TEAM_THREADS, (B + scen - 1) / scen,
            fwd_team_smem<F>(N, n_obs, n_hp).size * 4};
  } else {
    const long long total = static_cast<long long>(n_alpha) * B;
    return {1, FWD_THREADS, static_cast<int>((total + FWD_THREADS - 1) / FWD_THREADS), 0};
  }
}

// The launch of the line search of F; ps: the per-scenario instance's
// operands {U_last, X_ref, U_ref, Q, P} (ps_sources; null in the shared
// instance, whose kernel reads no PsOps).
template <class F>
int launch_fwd(const float* statics, const float* params, const float* const* ps,
               const float* X, const float* U, const float* kff, const float* K,
               const float* lam, const float* lamt, const float* /*lame*/,
               float* Xc, float* Uc, float* xlast, float* cost, float mu,
               int N, int B, void* stream) {
  Statics<F> st;
  std::memcpy(st.v, statics, sizeof(st.v));
  const int na = static_cast<int>(st.v[GST_N_ALPHA]);
  if (na <= 0 || B <= 0 || N <= 0) return 0;
  if (na > MAX_ALPHA) return static_cast<int>(cudaErrorInvalidValue);
  const int n_obs = static_cast<int>(st.v[GST_N_OBS]);
  const int n_hp = static_cast<int>(st.v[GST_N_HP]);
  PsOps ops{};
  if constexpr (per_scenario_v<F>) {
    if (!ps_sources<F>(params, ps, N, n_obs, n_hp, B, ops))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdGeometry g = fwd_geometry<F>(N, n_obs, n_hp, na, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (F::FWD_TEAM > 0) {
    if (g.smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          generic_fwd_team_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    generic_fwd_team_kernel<F><<<g.blocks, g.threads, g.smem, s>>>(
        st, params, X, U, kff, K, lam, lamt, Xc, Uc, xlast, cost, mu, N, B, ops);
  } else {
    generic_fwd_kernel<F><<<g.blocks, g.threads, 0, s>>>(
        st, params, X, U, kff, K, lam, lamt, Xc, Uc, xlast, cost, mu, N, B, ops);
  }
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the launch of fwd_geometry that one SM holds, as the CUDA
// runtime reports them (out[0]); the error of raising the kernel's
// shared-memory limit past the device's.
template <class F>
int fwd_occupancy(int N, int n_obs, int n_hp, int n_alpha, int* out) {
  const FwdGeometry g = fwd_geometry<F>(N, n_obs, n_hp, n_alpha, 1);
  cudaError_t e = cudaSuccess;
  if constexpr (F::FWD_TEAM > 0) {
    if (g.smem > 48 * 1024)
      e = cudaFuncSetAttribute(generic_fwd_team_kernel<F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, generic_fwd_team_kernel<F>,
                                                        g.threads, g.smem);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, generic_fwd_kernel<F>,
                                                      g.threads, 0);
  }
  return static_cast<int>(e);
}

}  // namespace gen
