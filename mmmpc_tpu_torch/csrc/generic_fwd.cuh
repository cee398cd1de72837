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
// The formulation F supplies, besides the members listed in
// generic_common.cuh, for the one-thread kernel:
//   dyn(x, u, c, xn)            x_{k+1}
//   stage(x, u, k, c, g) -> raw stage cost; writes the NC row values g
//   terminal(x, c, gt)   -> raw terminal cost; writes the NCT row values gt
// A formulation with FWD_TEAM supplies the team hooks (listed at the team
// kernel below) instead of these three.
//
// What bounds it on this card: one thread runs a serial recurrence of N
// stages (a few sincosf and a few hundred dependent FLOPs per stage), so the
// time is that chain's latency; with one thread per (scenario, alpha) the
// bench shape (B = 8192, 3 step sizes) gives 192 blocks of 128 on 132 SMs.
// Bytes are small: X, U, kff, K, lam in, the candidates out.
//
// Design of the one-thread kernel (demo, base): a loop over the stages
// inside the thread with x and the running cost in registers; batch-last
// loads and stores coalesce across the warp; the packed buffer is read
// through the read-only cache; the statics are a __grid_constant__ kernel
// argument.  A formulation with FWD_TEAM (arm, endpoint) runs the team
// kernel below instead, on kernel A's design (wholebody_fwd.cu), which
// splits the chain's stage over the lanes of a team.
#pragma once

#include <type_traits>

#include "cp_async.cuh"
#include "generic_common.cuh"

namespace gen {

template <class F>
__global__ void __launch_bounds__(128)
generic_fwd_kernel(const __grid_constant__ Statics<F> st,
                   const float* __restrict__ pp, const float* __restrict__ X,
                   const float* __restrict__ U, const float* __restrict__ kff,
                   const float* __restrict__ K, const float* __restrict__ lam,
                   const float* __restrict__ lamt, float* __restrict__ Xc,
                   float* __restrict__ Uc, float* __restrict__ xlast,
                   float* __restrict__ cost, float mu, int N, int B) {
  constexpr int NX = F::NX, NU = F::NU, NC = F::NC, NCT = F::NCT;
  static_assert(F::NE == 0, "the generic kernels take no terminal equality");
  const int n_alpha = static_cast<int>(st.v[GST_N_ALPHA]);
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(n_alpha) * B) return;
  const int a = static_cast<int>(t / B);
  const int b = static_cast<int>(t % B);

  const Ctx<F> c = make_ctx<F>(st, pp, N);
  const float alpha = st.v[GST_ALPHAS + a];
  const float inv2mu = 0.5f / mu;

  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = X[i * B + b];
  float acc = 0.f;

  for (int k = 0; k < N; ++k) {
    // ---- control: feedforward + feedback, clamped to the input box
    float dxk[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) dxk[j] = x[j] - X[(k * NX + j) * B + b];
    float u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float fb = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) fb += K[((k * NU + i) * NX + j) * B + b] * dxk[j];
      const float v = U[(k * NU + i) * B + b] + alpha * kff[(k * NU + i) * B + b] + fb;
      u[i] = clampf(v, st.v[Statics<F>::ULO + i], st.v[Statics<F>::UHI + i]);
    }

    // ---- scaled stage cost + PHR over its rows (masked rows included)
    float g[NC > 0 ? NC : 1];
    const float raw = F::stage(x, u, k, c, g);
    float pen = 0.f;
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const float l = lam[(k * NC + r) * B + b];
      const float tr = fmaxf(l + mu * g[r], 0.f);
      pen += tr * tr - l * l;
    }
    acc += c.inv_scale * raw + pen * inv2mu;

    // ---- outputs + carry
#pragma unroll
    for (int i = 0; i < NX; ++i) Xc[((k * n_alpha + a) * NX + i) * B + b] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) Uc[((k * n_alpha + a) * NU + i) * B + b] = u[i];
    float xn[NX];
    F::dyn(x, u, c, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }

  // ---- terminal AL cost
  float gt[NCT > 0 ? NCT : 1];
  const float rawN = F::terminal(x, c, gt);
  float pen = 0.f;
#pragma unroll
  for (int r = 0; r < NCT; ++r) {
    const float l = lamt[r * B + b];
    const float tr = fmaxf(l + mu * gt[r], 0.f);
    pen += tr * tr - l * l;
  }
  acc += c.inv_scale * rawN + pen * inv2mu;

#pragma unroll
  for (int i = 0; i < NX; ++i) xlast[(a * NX + i) * B + b] = x[i];
  cost[a * B + b] = acc;
}

// ---------------- the team kernel (formulations with FWD_TEAM) ----------------
//
// A formulation F that declares FWD_TEAM = T runs its line search on the
// kernel below, after kernel A's design (wholebody_fwd.cu, whose head note
// says why):
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
//   the packed params.  One __syncthreads a stage.
// - The chain: the NU rows of U + alpha kff + K dx on the lanes, clamped,
//   u exchanged by shuffles; then F's stage hook takes the step in every
//   lane, so every lane holds the same x.
// - Off the chain, in F's hooks, as items over the lanes: the stage cost's
//   rows and the PHR rows, each into a partial cost of its lane (masked
//   rows stay in the sum, as the one-thread kernel keeps them).  The
//   partials are summed once, after the terminal cost, by a butterfly whose
//   every step adds a + b on one side and b + a on the other: every lane
//   ends with the same bits.
// - A ragged batch: the teams of a partial block run on the clamped
//   scenario index min(b, B - 1) and only stores are masked, so every
//   __syncthreads, __syncwarp and shuffle is reached by every thread.
//
// F supplies, in place of the one-thread kernel's dyn, stage and terminal:
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
// The controls and the states are computed as the one-thread kernel
// computes them; the cost is summed in another order.
template <class F, class = void>
struct FwdTeam {
  static constexpr int value = 0;
};
template <class F>
struct FwdTeam<F, std::void_t<decltype(F::FWD_TEAM)>> {
  static constexpr int value = F::FWD_TEAM;
};

constexpr int FWD_TEAM_THREADS = 128;
// The most scenarios a block holds: the stride of the stage buffer.
constexpr int FWD_SCEN = 32;

// The scenarios of a block: its teams over the step sizes, at most
// FWD_SCEN.
__host__ __device__ constexpr int fwd_scen(int team, int n_alpha) {
  return (FWD_TEAM_THREADS / team) / n_alpha < FWD_SCEN
             ? (FWD_TEAM_THREADS / team) / n_alpha : FWD_SCEN;
}

// One scenario's inputs of a stage, in the buffer's element order.
template <class F>
struct FwdIn {
  static constexpr int X = 0;
  static constexpr int U = X + F::NX;
  static constexpr int KFF = U + F::NU;
  static constexpr int K = KFF + F::NU;
  static constexpr int LAM = K + F::NU * F::NX;
  static constexpr int SIZE = LAM + F::NC;
};

// Offsets (floats) of the parts of a block's shared memory; the row table
// first, so that its float4 reads are aligned.
struct FwdTeamSmem {
  int rows, in, term, vec, sv, ps, size;
};

template <class F>
__host__ __device__ inline FwdTeamSmem fwd_team_smem(int N, int n_obs, int n_hp) {
  FwdTeamSmem m;
  int o = 0;
  m.rows = o;  o += F::FWD_ROWS;
  m.in = o;    o += 2 * FwdIn<F>::SIZE * FWD_SCEN;
  m.term = o;  o += F::NCT * FWD_SCEN;
  m.vec = o;   o += 2 * F::FWD_NV * (FWD_TEAM_THREADS / FwdTeam<F>::value);
  m.sv = o;    o += Statics<F>::SIZE;
  m.ps = o;    o += F::layout(N, n_obs, n_hp).size;
  m.size = o;
  return m;
}

// The lane's share of e^T M e over the rows r = lane, lane + T, ... of the
// n x n matrix M at offset off of the packed params: the full error e in
// registers, e[r] of the lane's rows from the team's vector ev.
template <int T, int n, class C>
__device__ __forceinline__ float qform_rows(const C& c, int off, const float* e,
                                            const float* ev, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < (n + T - 1) / T; ++q) {
    const int r = min(lane + q * T, n - 1);   // past n: a copy, not added
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < n; ++j) row += c.p(off + r * n + j) * e[j];
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
                        float mu, int N, int B) {
  constexpr int NX = F::NX, NU = F::NU, NC = F::NC, NCT = F::NCT;
  constexpr int T = FwdTeam<F>::value, TEAMS = FWD_TEAM_THREADS / T;
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
  // stage k's inputs into buffer k & 1
  auto issue_stage = [&](int k) {
    float* dst = inbuf + (k & 1) * In::SIZE * SC + cs;
    copy_rows(dst + In::X * SC, X, k * NX, NX);
    copy_rows(dst + In::U * SC, U, k * NU, NU);
    copy_rows(dst + In::KFF * SC, kff, k * NU, NU);
    copy_rows(dst + In::K * SC, K, k * NU * NX, NU * NX);
    copy_rows(dst + In::LAM * SC, lam, k * NC, NC);
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

  // ---- the params, the terminal multipliers and stage 0 in flight; the
  // statics and the row table meanwhile
  for (int i = tid; i < L.size; i += FWD_TEAM_THREADS) wb::cp_async4(ps + i, pp + i);
  copy_rows(tb + cs, lamt, 0, NCT);
  issue_stage(0);
  wb::cp_async_commit();
  for (int i = tid; i < Statics<F>::SIZE; i += FWD_TEAM_THREADS) sv[i] = st.v[i];
  if (tid == 0) F::fwd_team_rows(st.v, rt);
  const SmemCtx<F> c{sv, ps, L, st.v[GST_DT], st.v[GST_INV_SCALE], N, n_obs, n_hp};
  const float alpha = st.v[GST_ALPHAS + a];

  float x[NX];
  float acc = 0.f;   // this lane's partial cost
  for (int k = 0; k < N; ++k) {
    wb::cp_async_wait<0>();
    __syncthreads();
    if (k + 1 < N) issue_stage(k + 1);
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
  if constexpr (FwdTeam<F>::value > 0) {
    const int scen = fwd_scen(FwdTeam<F>::value, n_alpha);
    return {FwdTeam<F>::value, FWD_TEAM_THREADS, (B + scen - 1) / scen,
            fwd_team_smem<F>(N, n_obs, n_hp).size * 4};
  } else {
    const long long total = static_cast<long long>(n_alpha) * B;
    return {1, 128, static_cast<int>((total + 127) / 128), 0};
  }
}

template <class F>
int launch_fwd(const float* statics, const float* params, const float* X,
               const float* U, const float* kff, const float* K,
               const float* lam, const float* lamt, const float* /*lame*/,
               float* Xc, float* Uc, float* xlast, float* cost, float mu,
               int N, int B, void* stream) {
  Statics<F> st;
  std::memcpy(st.v, statics, sizeof(st.v));
  const int na = static_cast<int>(st.v[GST_N_ALPHA]);
  if (na <= 0 || B <= 0 || N <= 0) return 0;
  if (na > MAX_ALPHA) return static_cast<int>(cudaErrorInvalidValue);
  const FwdGeometry g = fwd_geometry<F>(
      N, static_cast<int>(st.v[GST_N_OBS]), static_cast<int>(st.v[GST_N_HP]), na, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (FwdTeam<F>::value > 0) {
    if (g.smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          generic_fwd_team_kernel<F>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    generic_fwd_team_kernel<F><<<g.blocks, g.threads, g.smem, s>>>(
        st, params, X, U, kff, K, lam, lamt, Xc, Uc, xlast, cost, mu, N, B);
  } else {
    generic_fwd_kernel<F><<<g.blocks, g.threads, 0, s>>>(
        st, params, X, U, kff, K, lam, lamt, Xc, Uc, xlast, cost, mu, N, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gen
