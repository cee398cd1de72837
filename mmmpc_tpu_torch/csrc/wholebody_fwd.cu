// Fused forward rollout + parallel line search of the whole-body qref MPC,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mmmpc_tpu/ops/wholebody_fwd.py::_kernel
// (built by make_fwd_linesearch).  For every scenario b and step size alpha
// (a candidate) it rolls the closed-loop policy over the horizon,
//     u_k     = clamp(U_k + alpha kff_k + K_k (x_k - X_k))
//     cost   += inv_scale (tracking + S relu(max slack)^2) + PHR(boxes)
//     x_{k+1} = f(x_k, u_k)
// and adds the terminal AL cost on the last stage.  The plain PyTorch version
// of the same function is ops/wholebody_fwd.py::FwdLinesearch.plain.
//
// What bounds it on this card: not bytes (each stage reads 92 floats per
// scenario and writes 14 per candidate, 89.5 MB a call at the bench shape,
// 27 us at 3.35 TB/s), but instruction issue and latency.  Only
// dx -> u -> x_{k+1} is a serial chain; the stage cost (the arm's FK, the
// slack rows, three quadratic forms, 28 PHR rows) feeds nothing but the sum.
// One thread per candidate ran all of it in the thread of the chain, with
// too few threads to hide its latency (24,576 at the bench shape, under 6
// warps per SM), each stage's inputs read once per candidate through the
// read-only cache and nothing prefetched.  So the design, after kernel B's
// (wholebody_bwd.cu):
//
// - A team of T lanes of one warp per candidate (T a template parameter,
//   launched at FWD_TEAM = 2), 128 threads a block, at most 128 registers
//   a thread (__launch_bounds__), with no spill.  The n_alpha candidates
//   of a scenario are neighbouring teams of one block, which holds
//   (128 / T) / n_alpha scenarios, at most FWD_SCEN; the teams left over
//   idle.  Fewer lanes a candidate ran faster (PERF.md): the work that
//   every lane repeats (the chain's step, the FK's algebra, the errors)
//   grows with T, and the card is full at batch 8192 with T = 2.
// - The chain, split: the five rows of U + alpha kff + K dx on lanes, u
//   exchanged by shuffles, then the step in every lane, so every lane
//   holds the same x.  The four sincos of the FK (q1, q1 - q2,
//   q1 - q2 - q3, psi) two on each lane, exchanged by shuffles.
// - Off the chain, as items over the lanes: the half-plane samples, the
//   ground circles, the self-collision spheres, and at k = N-1 the stale
//   terminal self-collision rows of x_N when bug-compatible (each family a
//   loop of its own, so
//   the lanes of a warp run one family at a time); the rows of the Q, R
//   and W forms and the 28 PHR rows.  The slack max is merged by a
//   butterfly of shuffles (exact; NaN stays NaN), the rows' terms go into
//   a partial cost of each lane, and the partials are summed across the
//   team once, after the terminal cost, by a butterfly whose every step
//   adds a + b on one side and b + a on the other: every lane ends with
//   the same bits.  The rows that a lane picks at run time read the
//   candidate's x, u and errors from the team's vector in shared memory;
//   the PHR rows' bounds, signs and masks from a table built per block.
// - Shared memory per block: the packed params (param_layout) and the
//   statics, the half-plane faces and the PHR row table, loaded once; a
//   two-stage buffer of each stage's inputs (X_k, U_k, kff_k, K_k, lam_k of
//   the block's scenarios, element-major, scenario fastest), filled by
//   cp.async one stage ahead, each scenario's inputs loaded once and read
//   by all of its candidates; the terminal multipliers; the teams' vectors
//   of the stage, two parities, whose first 14 entries are the stage's
//   outputs x_k and u_k.  One __syncthreads a stage: after it stage k's
//   inputs have landed, stage k+1's loads are issued, and stage k-1's
//   outputs are stored from the vectors of its parity, the block's
//   scenarios contiguous along the batch.
// - A ragged batch: the teams of a partial block run on the clamped
//   scenario index min(b, B - 1) and only stores are masked, so every
//   __syncthreads, __syncwarp and shuffle is reached by every thread.
// - Moving obstacles (statics ST_MOVING): the packed params hold an
//   obstacle row a stage (obs_rows), copied into shared memory with the
//   rest; stage k's circles read row k against x_k and the terminal ones
//   row N against x_N, as the TPU kernel's moving branch.  A static problem
//   has one row, which every stage reads (a row stride of 0).
// - Per-scenario entries (statics ST_PS, the fleet's: the TPU kernel's
//   ps_* operands), in the instances fwd_kernel<T, true, .>: any subset of
//   U_last, X_ref, U_ref (stage k's rows ride the stage buffer, 19 floats a
//   scenario more, loaded one stage ahead with the other inputs), X_ref's
//   row N, the diagonals of Q and P and eq_mask (the terminal slot, 28
//   floats a scenario more, loaded with the terminal multipliers).  A
//   shared reference or mask is copied into every scenario's column as
//   well, so the reads select nothing at run time; a per-scenario Q or P
//   enters the tracking cost as its diagonal, as in the TPU kernel.  The
//   instances fwd_kernel<T, false, .> of the shared params read none of
//   them.
// - The fixed terminal formulation (statics ST_BUG_COMPAT = 0, the TPU
//   kernel's bug_compat=False branch), in the instances
//   fwd_kernel<T, PS, false>: stage N-1 has no stale rows, and the
//   terminal group takes the self-collision rows of x_N after its circles
//   and half-planes.  The bug-compatible instances <T, PS, true> are the
//   code they were before the flag (a flag read at run time moved kernel
//   B's registers).
// - No tensor cores: the products are 9-wide per candidate.
//
// The slack rows, the controls and the states are computed as the
// one-thread kernel computed them; the cost is summed in another order.
// wholebody_common.cuh's helpers are used as they are (kernel B shares
// them); this kernel's own team variants are written below.
#include <cstring>
#include <type_traits>

#include "cp_async.cuh"
#include "wholebody_common.cuh"

namespace wb {

constexpr int FWD_THREADS = 128;
constexpr int FWD_MIN_BLOCKS = 4;   // __launch_bounds__: <= 128 registers
// Lanes a candidate: 2 was the fastest of 2, 4 and 8 at batch 8192 (the
// times of each in PERF.md); the FK's split is written for 2.
constexpr int FWD_TEAM = 2;
// The most scenarios a block holds: the stride of the stage buffer.
constexpr int FWD_SCEN = 32;
constexpr unsigned FWD_FULL = 0xffffffffu;
// One scenario's inputs of a stage, in the buffer's element order.
constexpr int IN_X = 0;
constexpr int IN_U = IN_X + NX;
constexpr int IN_KFF = IN_U + NU;
constexpr int IN_K = IN_KFF + NU;
constexpr int IN_LAM = IN_K + NU * NX;
constexpr int FWD_NIN = IN_LAM + NC;   // 92
constexpr int FWD_NTERM = NCT + 2;     // terminal multipliers: lamt, lame
// With per-scenario entries: stage k's references and previous inputs
// after the stage inputs, and X_ref's row N, the Q and P diagonals and
// eq_mask after the terminal multipliers.
constexpr int IN_XREF = FWD_NIN;
constexpr int IN_UREF = IN_XREF + NX;
constexpr int IN_ULAST = IN_UREF + NU;
constexpr int FWD_NIN_PS = IN_ULAST + NU;   // 111
constexpr int TM_XREF = FWD_NTERM;
constexpr int TM_QD = TM_XREF + NX;
constexpr int TM_PD = TM_QD + NX;
constexpr int TM_EQM = TM_PD + NX;
constexpr int FWD_NTERM_PS = TM_EQM + 1;    // 48
// A candidate's vector of a stage: x_k and u_k (its outputs, in the order
// of Xc and Uc), then the errors x - xref, u - uref, u - ulast.
constexpr int V_X = 0;
constexpr int V_U = V_X + NX;
constexpr int V_EX = V_U + NU;
constexpr int V_EU = V_EX + NX;
constexpr int V_ED = V_EU + NU;
constexpr int NV = V_ED + NU;          // 33: odd, so the teams' vectors
                                       // fall on different banks
constexpr int NOUT = NX + NU;
// A half-plane face: {n0, n1, n2, o0}, {o1, o2, mask, 0}, o the face point
// pushed out by EXPAND along its normal n.
constexpr int FWD_HF = 8;

// The scenarios of a block: its teams over the step sizes, at most
// FWD_SCEN.
__host__ __device__ constexpr int fwd_scen(int team, int n_alpha) {
  return (FWD_THREADS / team) / n_alpha < FWD_SCEN
             ? (FWD_THREADS / team) / n_alpha : FWD_SCEN;
}

// Offsets (floats) of the parts of a block's shared memory.  The stage
// buffer and the terminal multipliers take a stride of FWD_SCEN scenarios,
// so their offsets are constants.
struct FwdSmem {
  int hf, rows, in, term, vec, sv, ps, size;
};

__host__ __device__ inline FwdSmem fwd_smem(int team, int N, int n_obs,
                                            int n_hp, bool moving, bool ps) {
  FwdSmem m;
  int o = 0;
  m.hf = o;    o += FWD_HF * n_hp;
  m.rows = o;  o += 4 * NC;
  m.in = o;    o += 2 * (ps ? FWD_NIN_PS : FWD_NIN) * FWD_SCEN;
  m.term = o;  o += (ps ? FWD_NTERM_PS : FWD_NTERM) * FWD_SCEN;
  m.vec = o;   o += 2 * NV * (FWD_THREADS / team);
  m.sv = o;    o += ST_SIZE;
  m.ps = o;    o += param_layout(N, n_obs, n_hp, moving).size;
  m.size = o;
  return m;
}

// u clamped to [lo, hi]; a NaN stays NaN (jnp.clip semantics).
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// PHR term of one box row: max(lam + mu c, 0)^2 - lam^2 (the 1/(2 mu) is
// applied once to the sum).  A masked row (infinite bound) has c = -inf in
// effect: only -lam^2 remains.
__device__ __forceinline__ float phr(float lam, float mu, float c, bool live) {
  const float t = live ? fmaxf(lam + mu * c, 0.f) : 0.f;
  return t * t - lam * lam;
}

// Running max with NaN propagation.
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// The world points (j2, j3, ee) of the arm and the base yaw's cos / sin:
// fk of wholebody_common.cuh without the partials, its four sincos split
// over the team's two lanes and exchanged by shuffles.
struct Pts {
  float cp, sp;
  float pt[3][3];   // world point p (j2, j3, ee), coordinate c
};

template <int T>
__device__ __forceinline__ void fk_pts_team(const float* x, int lane,
                                            Pts& f) {
  static_assert(T == 2, "the FK's sincos are split over two lanes");
  // lane 0: q1 and q1 - q2 - q3; lane 1: q1 - q2 and psi
  const float th = x[6] - x[7];
  float sa, ca, sa2, ca2;
  sincosf(lane == 0 ? x[6] : th, &sa, &ca);
  sincosf(lane == 0 ? th - x[8] : x[2], &sa2, &ca2);
  const float s1 = __shfl_sync(FWD_FULL, sa, 0, T);
  const float c1 = __shfl_sync(FWD_FULL, ca, 0, T);
  const float st = __shfl_sync(FWD_FULL, sa, 1, T);
  const float ct = __shfl_sync(FWD_FULL, ca, 1, T);
  const float sb = __shfl_sync(FWD_FULL, sa2, 0, T);
  const float cb = __shfl_sync(FWD_FULL, ca2, 0, T);
  f.sp = __shfl_sync(FWD_FULL, sa2, 1, T);
  f.cp = __shfl_sync(FWD_FULL, ca2, 1, T);

  const float ax2 = A2 * s1 + A3 * c1;
  const float az2 = A2 * c1 - A3 * s1;
  const float ax3 = ax2 - A3 * ct + A5 * st;
  const float az3 = az2 + A3 * st + A5 * ct;
  const float axe = ax3 + A6 * cb - A7 * sb;
  const float aze = az3 - A6 * sb - A7 * cb;
  const float ax[3] = {ax2, ax3, axe};
  const float az[3] = {az2, az3, aze};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float r = ax[p] + BX;
    f.pt[p][0] = x[0] + r * f.cp;
    f.pt[p][1] = x[1] + r * f.sp;
    f.pt[p][2] = az[p] + BZ;
  }
}

// World point a0 j2 + a1 j3 + a2 ee.
__device__ __forceinline__ void pts_combo(const Pts& f, float a0, float a1,
                                          float a2, float P[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    P[c] = a0 * f.pt[0][c] + a1 * f.pt[1][c] + a2 * f.pt[2][c];
}

// ---- the slack rows, one item each (the rows of wholebody_common.cuh's
// ground_rows, self_rows and halfplane_rows, values only) ----
// Ground circle o of the obstacle row ob: (r_obs + r_base) - |(px, py) -
// obs|.
__device__ __forceinline__ float ground_value(int o, const float* x,
                                              const float* ob,
                                              float base_radius) {
  const float dx = x[0] - ob[3 * o];
  const float dy = x[1] - ob[3 * o + 1];
  const float d = sqrtf(dx * dx + dy * dy + EPS);
  return (ob[3 * o + 2] + base_radius) - d;
}

// Self-collision sphere r (SELF_DIFF[r]): SELF_R - |check - ee|.
__device__ __forceinline__ float self_value(int r, const Pts& f) {
  const float a0 = r == 0 ? 0.f : (r == 2 ? 1.f : 0.5f);
  const float a1 = r == 3 ? 0.5f : 0.f;
  float v3[3];
  pts_combo(f, a0, a1, -1.f, v3);
  return SELF_R - sqrtf(v3[0] * v3[0] + v3[1] * v3[1] + v3[2] * v3[2] + EPS);
}

// Half-plane sample r (HP_POINTS[r]): -max over live faces of n . (o - P),
// -1e9 (never the max) for a masked face.
__device__ __forceinline__ float hp_value(int r, const Pts& f, const float* hf,
                                          int n_hp) {
  const float a0 = r == 0 || r == 2 ? 0.5f : (r == 1 ? 1.f : 0.f);
  const float a1 = r == 2 || r == 4 ? 0.5f : (r == 3 ? 1.f : 0.f);
  const float a2 = r == 4 ? 0.5f : (r == 5 ? 1.f : 0.f);
  float P[3];
  pts_combo(f, a0, a1, a2, P);
  float dmax = -INFINITY;
#pragma unroll 4
  for (int h = 0; h < n_hp; ++h) {
    const float4 a = *reinterpret_cast<const float4*>(hf + FWD_HF * h);
    const float4 b = *reinterpret_cast<const float4*>(hf + FWD_HF * h + 4);
    const float d = b.z > 0.f
        ? a.x * (a.w - P[0]) + a.y * (b.x - P[1]) + a.z * (b.y - P[2])
        : -1e9f;
    dmax = max_nan(dmax, d);
  }
  return -dmax;
}

// The slack group's max across the team (every lane ends with it).
template <int T>
__device__ __forceinline__ float max_team(float m) {
#pragma unroll
  for (int off = 1; off < T; off <<= 1)
    m = max_nan(m, __shfl_xor_sync(FWD_FULL, m, off, T));
  return m;
}

// The ground circles (of the obstacle row ob) and half-plane samples of
// x's slack group over the lanes, into the lane's running max.
template <int T>
__device__ __forceinline__ float ground_hp_rows(const float* x, const Pts& f,
                                                const float* ob,
                                                const float* hf, int n_obs,
                                                int n_hp, int n_hpi,
                                                float base_radius, int lane) {
  float m = -INFINITY;
#pragma unroll
  for (int q = 0; q < (6 + T - 1) / T; ++q) {
    const int r = lane + q * T;
    if (r < n_hpi) m = max_nan(m, hp_value(r, f, hf, n_hp));
  }
  for (int o = lane; o < n_obs; o += T)
    m = max_nan(m, ground_value(o, x, ob, base_radius));
  return m;
}

// The lane's share of e^T M e over the rows r = lane, lane + T, ... of the
// n x n matrix M (row-major in shared memory): the full error e in
// registers, e[r] of the lane's rows from the team's vector ev.
template <int T, int n>
__device__ __forceinline__ float qform_rows(const float* M, const float* e,
                                            const float* ev, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < (n + T - 1) / T; ++q) {
    const int r = min(lane + q * T, n - 1);   // past n: a copy, not added
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < n; ++j) row += M[r * n + j] * e[j];
    const float t = ev[r] * row;
    acc += lane + q * T < n ? t : 0.f;
  }
  return acc;
}

// The lane's share of e^T diag(d) e over the rows r = lane, lane + T, ...:
// d[r] at d + r * stride, e[r] from the team's vector ev.
template <int T, int n>
__device__ __forceinline__ float diag_rows(const float* d, int stride,
                                           const float* ev, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < (n + T - 1) / T; ++q) {
    const int r = min(lane + q * T, n - 1);   // past n: a copy, not added
    const float t = d[r * stride] * ev[r] * ev[r];
    acc += lane + q * T < n ? t : 0.f;
  }
  return acc;
}

// The lane's share of the PHR sum over rows r = lane, lane + T, ... < n of
// the row table rt ({bound, sign, mask, vector index} a row): c = sign
// (v - bound), which is v - hi for an upper row and lo - v for a lower one.
template <int T, int n>
__device__ __forceinline__ float phr_rows(const float* rt, const float* v,
                                          const float* lam, int stride,
                                          float mu, int lane) {
  float pen = 0.f;
#pragma unroll
  for (int q = 0; q < (n + T - 1) / T; ++q) {
    const int r = min(lane + q * T, n - 1);   // past n: a copy, not added
    const float4 t = *reinterpret_cast<const float4*>(rt + 4 * r);
    const float c = t.y * (v[__float_as_int(t.w)] - t.x);
    const float p = phr(lam[r * stride], mu, c, t.z != 0.f);
    pen += lane + q * T < n ? p : 0.f;
  }
  return pen;
}

template <int T, bool PS, bool BUG>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS)
fwd_kernel(const Statics st, const float* __restrict__ pp,
           const float* __restrict__ X, const float* __restrict__ U,
           const float* __restrict__ kff, const float* __restrict__ K,
           const float* __restrict__ lam, const float* __restrict__ lamt,
           const float* __restrict__ lame, const PerScen psx,
           float* __restrict__ Xc, float* __restrict__ Uc,
           float* __restrict__ xlast, float* __restrict__ cost, float mu,
           int N, int B) {
  constexpr int TEAMS = FWD_THREADS / T;
  constexpr int SC = FWD_SCEN;             // the stage buffer's stride
  constexpr int ROWS = (NU + T - 1) / T;   // control rows a lane
  constexpr int NIN = PS ? FWD_NIN_PS : FWD_NIN;   // a stage's buffer rows
  extern __shared__ __align__(16) float smem[];
  const int na = static_cast<int>(st.v[ST_N_ALPHA]);
  const int n_obs = static_cast<int>(st.v[ST_N_OBS]);
  const int n_hp = static_cast<int>(st.v[ST_N_HP]);
  const bool moving = st.v[ST_MOVING] != 0.f;
  const int pmask = PS ? static_cast<int>(st.v[ST_PS]) : 0;
  const int scen = fwd_scen(T, na);        // scenarios of this block
  const Layout L = param_layout(N, n_obs, n_hp, moving);
  const FwdSmem M = fwd_smem(T, N, n_obs, n_hp, moving, PS);
  float* hf = smem + M.hf;        // half-plane faces
  float* rt = smem + M.rows;      // PHR row table
  float* inbuf = smem + M.in;     // stage inputs, two parities
  float* tb = smem + M.term;      // terminal multipliers (and PS inputs)
  float* vec = smem + M.vec;      // the teams' vectors, two parities
  float* sv = smem + M.sv;        // statics
  float* ps = smem + M.ps;        // packed params
  // stage k's obstacle row: ob0 + k * ostride (the one row if static)
  const float* ob0 = ps + L.obs;
  const int ostride = obs_row_stride(n_obs, moving);

  const int tid = threadIdx.x;
  const int team = tid / T, lane = tid % T;
  const int s = min(team / na, scen - 1);  // idle teams shadow the last
  const int a = team % na;
  const int b0 = blockIdx.x * scen;
  const bool own = team < na * scen && b0 + s < B;   // stores its results

  // The block's copies of per-scenario arrays: thread tid moves scenario
  // cs = tid % scen (clamped to the batch) of the element rows ci,
  // ci + per, ...; buffers are element-major, scenario fastest.
  const int per = FWD_THREADS / scen;
  const int cs = tid % scen, ci = tid / scen;
  const bool copier = ci < per;
  const int cb = min(b0 + cs, B - 1);
  // rows [0, n) of a batch-last array from row `first` on, into the
  // buffer's rows off, off + 1, ... at dst
  auto copy_rows = [&](float* dst, const float* src, int first, int n) {
    if (!copier) return;
    const float* p = src + static_cast<long long>(first + ci) * B + cb;
    const long long step = static_cast<long long>(per) * B;
#pragma unroll 4
    for (int i = ci; i < n; i += per, p += step) cp_async4(dst + i * SC, p);
  };
  // (PS) rows [first, first + n) of a reference: each scenario's own from
  // its operand, or the shared row of the packed params in every column
  auto ref_rows = [&](float* dst, bool own, const float* src, int off,
                      int first, int n) {
    if (own) {
      copy_rows(dst, src, first, n);
    } else if (copier) {
      for (int i = ci; i < n; i += per) cp_async4(dst + i * SC, pp + off + first + i);
    }
  };
  // stage k's inputs into buffer k & 1
  auto issue_stage = [&](int k) {
    float* dst = inbuf + (k & 1) * NIN * SC + cs;
    copy_rows(dst + IN_X * SC, X, k * NX, NX);
    copy_rows(dst + IN_U * SC, U, k * NU, NU);
    copy_rows(dst + IN_KFF * SC, kff, k * NU, NU);
    copy_rows(dst + IN_K * SC, K, k * NU * NX, NU * NX);
    copy_rows(dst + IN_LAM * SC, lam, k * NC, NC);
    if constexpr (PS) {
      ref_rows(dst + IN_XREF * SC, pmask & PS_XREF, psx.xref, L.xref, k * NX,
               NX);
      ref_rows(dst + IN_UREF * SC, pmask & PS_UREF, psx.uref, L.uref, k * NU,
               NU);
      ref_rows(dst + IN_ULAST * SC, pmask & PS_ULAST, psx.ulast, L.ulast,
               k * NU, NU);
    }
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
  // statics, the PHR row table and the faces meanwhile
  for (int i = tid; i < L.size; i += FWD_THREADS) cp_async4(ps + i, pp + i);
  copy_rows(tb + cs, lamt, 0, NCT);
  copy_rows(tb + NCT * SC + cs, lame, 0, 2);
  if constexpr (PS) {
    ref_rows(tb + TM_XREF * SC + cs, pmask & PS_XREF, psx.xref, L.xref,
             N * NX, NX);
    if (pmask & PS_Q) copy_rows(tb + TM_QD * SC + cs, psx.qd, 0, NX);
    if (pmask & PS_P) copy_rows(tb + TM_PD * SC + cs, psx.pd, 0, NX);
    ref_rows(tb + TM_EQM * SC + cs, pmask & PS_EQM, psx.eqm, L.eqm, 0, 1);
  }
  issue_stage(0);
  cp_async_commit();
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < ST_SIZE; ++i) sv[i] = st.v[i];
    // the PHR rows [x_hi, x_lo, du_hi, du_lo]; the terminal rows are the
    // first 2 NX
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const bool isx = r < 2 * NX;
      const bool hi = isx ? r < NX : r < 2 * NX + NU;
      const int e = isx ? (hi ? r : r - NX) : (hi ? r - 2 * NX : r - 2 * NX - NU);
      const int bound = isx ? (hi ? ST_XHI : ST_XLO) : (hi ? ST_DUHI : ST_DULO);
      const int mask = isx ? (hi ? ST_XMHI : ST_XMLO) : (hi ? ST_DUMHI : ST_DUMLO);
      rt[4 * r] = st.v[bound + e];
      rt[4 * r + 1] = hi ? 1.f : -1.f;
      rt[4 * r + 2] = st.v[mask + e] != 0.f ? 1.f : 0.f;
      rt[4 * r + 3] = __int_as_float(isx ? V_X + e : V_ED + e);
    }
  }
  for (int h = tid; h < n_hp; h += FWD_THREADS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float nc = __ldg(pp + L.hpn + 3 * h + c);
      hf[FWD_HF * h + c] = nc;
      hf[FWD_HF * h + 3 + c] = __ldg(pp + L.hpp + 3 * h + c) - EXPAND * nc;
    }
    hf[FWD_HF * h + 6] = __ldg(pp + L.hpm + h);
    hf[FWD_HF * h + 7] = 0.f;
  }

  const float dt = st.v[ST_DT];
  const float inv_scale = st.v[ST_INV_SCALE];
  const float base_radius = st.v[ST_BASE_RADIUS];
  const float inv2mu = 0.5f / mu;
  float hp_live = 0.f;
  for (int h = 0; h < n_hp; ++h) hp_live += __ldg(pp + L.hpm + h);
  const int n_hpi = hp_live > 0.f ? 6 : 0;   // half-plane samples

  float x[NX];
  float acc = 0.f;   // this lane's partial cost
  for (int k = 0; k < N; ++k) {
    cp_async_wait<0>();
    __syncthreads();
    if (k + 1 < N) issue_stage(k + 1);
    cp_async_commit();
    if (k > 0) store_out(k - 1);
    const float* in = inbuf + (k & 1) * NIN * SC + s;
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = in[(IN_X + i) * SC];
    }
    const float alpha = sv[ST_ALPHAS + a];

    // ---- the chain: the rows of U + alpha kff + K dx on the lanes,
    // clamped, u exchanged by shuffles; the step in every lane
    float dx[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) dx[j] = x[j] - in[(IN_X + j) * SC];
    float ur[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = min(lane + r * T, NU - 1);   // past NU: a copy, unused
      float fb = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) fb += in[(IN_K + i * NX + j) * SC] * dx[j];
      const float v = in[(IN_U + i) * SC] + alpha * in[(IN_KFF + i) * SC] + fb;
      ur[r] = clampf(v, sv[ST_ULO + i], sv[ST_UHI + i]);
    }
    float u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = __shfl_sync(FWD_FULL, ur[i / T], i % T, T);
    Pts f;
    fk_pts_team<T>(x, lane, f);
    float xn[NX];
    step(x, u, dt, f.cp, f.sp, xn);

    // ---- the team's vector of the stage (every lane writes the same
    // values): x_k, u_k, then the errors the rows read
    float ex[NX], eu[NU], ed[NU];
    {
      // the shared rows, or (PS) the scenario's columns of the buffer
      const float* xr = PS ? in + IN_XREF * SC : ps + L.xref + k * NX;
      const float* ur_ = PS ? in + IN_UREF * SC : ps + L.uref + k * NU;
      const float* ul = PS ? in + IN_ULAST * SC : ps + L.ulast + k * NU;
      constexpr int xs = PS ? SC : 1, us = xs, ls = xs;
#pragma unroll
      for (int i = 0; i < NX; ++i) ex[i] = x[i] - xr[i * xs];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        eu[i] = u[i] - ur_[i * us];
        ed[i] = u[i] - ul[i * ls];
      }
    }
    float* v = vec + (k & 1) * NV * TEAMS + team * NV;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      v[V_X + i] = x[i];
      v[V_EX + i] = ex[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      v[V_U + i] = u[i];
      v[V_EU + i] = eu[i];
      v[V_ED + i] = ed[i];
    }
    __syncwarp();

    // ---- the slack group of x_k over the lanes; at k = N-1 the terminal
    // self-collision rows ride it when bug-compatible (the reference's
    // stale slack index)
    float gmax = ground_hp_rows<T>(x, f, ob0 + k * ostride, hf, n_obs, n_hp,
                                   n_hpi, base_radius, lane);
    for (int r = lane; r < 4; r += T) gmax = max_nan(gmax, self_value(r, f));
    if (k == N - 1 && BUG) {
      Pts fn;
      fk_pts_team<T>(xn, lane, fn);
      for (int r = lane; r < 4; r += T) gmax = max_nan(gmax, self_value(r, fn));
    }
    gmax = max_team<T>(gmax);
    const float smax = gmax < 0.f ? 0.f : gmax;

    // ---- the lane's rows of the tracking forms and of the PHR sum
    float tr = lane == 0 ? ps[L.S] * smax * smax : 0.f;
    if (PS && (pmask & PS_Q))
      tr += diag_rows<T, NX>(tb + TM_QD * SC + s, SC, v + V_EX, lane);
    else
      tr += qform_rows<T, NX>(ps + L.Q, ex, v + V_EX, lane);
    tr += qform_rows<T, NU>(ps + L.R, eu, v + V_EU, lane);
    tr += qform_rows<T, NU>(ps + L.W, ed, v + V_ED, lane);
    const float pen = phr_rows<T, NC>(rt, v, in + IN_LAM * SC, SC, mu, lane);
    acc += inv_scale * tr + pen * inv2mu;
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }

  // ---- terminal AL cost of x_N: P tracking + S relu(max terminal slack)^2
  // + PHR on the terminal boxes + the maskable position equality.  The
  // terminal slack group has the self-collision rows of x_N unless they
  // rode stage N-1's (bug-compatible).
  cp_async_wait<0>();
  __syncthreads();
  store_out(N - 1);
  {
    Pts f;
    fk_pts_team<T>(x, lane, f);
    float ex[NX];
    const float* xr = PS ? tb + TM_XREF * SC + s : ps + L.xref + N * NX;
    constexpr int xs = PS ? SC : 1;
#pragma unroll
    for (int i = 0; i < NX; ++i) ex[i] = x[i] - xr[i * xs];
    float* v = vec + (N & 1) * NV * TEAMS + team * NV;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      v[V_X + i] = x[i];
      v[V_EX + i] = ex[i];
    }
    __syncwarp();
    float gl = ground_hp_rows<T>(x, f, ob0 + N * ostride, hf, n_obs, n_hp,
                                 n_hpi, base_radius, lane);
    if constexpr (!BUG)
      for (int r = lane; r < 4; r += T) gl = max_nan(gl, self_value(r, f));
    const float gmax = max_team<T>(gl);
    const float smax = gmax < 0.f ? 0.f : gmax;
    float tr = lane == 0 ? ps[L.S] * smax * smax : 0.f;
    if (PS && (pmask & PS_P))
      tr += diag_rows<T, NX>(tb + TM_PD * SC + s, SC, v + V_EX, lane);
    else
      tr += qform_rows<T, NX>(ps + L.P, ex, v + V_EX, lane);
    const float* lt = tb + s;
    const float pen = phr_rows<T, NCT>(rt, v, lt, SC, mu, lane);
    const float m = PS ? tb[TM_EQM * SC + s] : ps[L.eqm];
    float peneq = 0.f;
    for (int i = lane; i < 2; i += T) {
      const float h = m * v[V_EX + i];
      peneq += lt[(NCT + i) * SC] * h + 0.5f * mu * h * h;
    }
    acc += inv_scale * tr + pen * inv2mu + peneq;
  }

  // ---- the team's sum of the partial costs: a + b on one side of each
  // step, b + a on the other, so every lane holds the same bits
#pragma unroll
  for (int off = 1; off < T; off <<= 1)
    acc += __shfl_xor_sync(FWD_FULL, acc, off, T);
  if (own) {
    const int b = b0 + s;
#pragma unroll
    for (int i = 0; i < NX; ++i)
      if (i % T == lane) xlast[(a * NX + i) * static_cast<long long>(B) + b] = x[i];
    if (lane == 0) cost[a * static_cast<long long>(B) + b] = acc;
  }
}

// The launch at batch B with n_alpha step sizes: lanes a candidate, threads
// a block, blocks, dynamic shared-memory bytes.  wb_fwd_launch launches
// with it and wb_fwd_geometry reports it.
struct FwdGeometry {
  int team, threads, blocks, smem;
};

inline FwdGeometry fwd_geometry(int team, int N, int n_obs, int n_hp,
                                bool moving, bool ps, int n_alpha, int B) {
  const int scen = fwd_scen(team, n_alpha);
  return {team, FWD_THREADS, (B + scen - 1) / scen,
          fwd_smem(team, N, n_obs, n_hp, moving, ps).size *
              static_cast<int>(sizeof(float))};
}

template <int T, bool PS, bool BUG>
int fwd_launch(const Statics& st, const float* params, const float* X,
               const float* U, const float* kff, const float* K,
               const float* lam, const float* lamt, const float* lame,
               const PerScen& psx, float* Xc, float* Uc, float* xlast,
               float* cost, float mu, int N, int B, cudaStream_t stream) {
  const FwdGeometry g = fwd_geometry(
      T, N, static_cast<int>(st.v[ST_N_OBS]), static_cast<int>(st.v[ST_N_HP]),
      st.v[ST_MOVING] != 0.f, PS, static_cast<int>(st.v[ST_N_ALPHA]), B);
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd_kernel<T, PS, BUG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        g.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fwd_kernel<T, PS, BUG><<<g.blocks, g.threads, g.smem, stream>>>(
      st, params, X, U, kff, K, lam, lamt, lame, psx, Xc, Uc, xlast, cost, mu,
      N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wb

// Launch geometry at batch B with n_alpha step sizes (moving != 0: an
// obstacle row a stage; per_scenario: the statics' ST_PS mask): out =
// {lanes a candidate, threads a block, blocks, dynamic shared-memory
// bytes}, as wb_fwd_launch launches.
extern "C" int wb_fwd_geometry(int N, int n_obs, int n_hp, int moving,
                               int per_scenario, int n_alpha, int B,
                               int* out) {
  const wb::FwdGeometry g =
      wb::fwd_geometry(wb::FWD_TEAM, N, n_obs, n_hp, moving != 0,
                       per_scenario != 0, n_alpha, B);
  out[0] = g.team;
  out[1] = g.threads;
  out[2] = g.blocks;
  out[3] = g.smem;
  return 0;
}

// The kernel instance wb_fwd_launch picks for the statics' per-scenario
// mask and bug_compat flag.
template <int T>
const void* fwd_instance(bool ps, bool bug) {
  using wb::fwd_kernel;
  return ps ? (bug ? reinterpret_cast<const void*>(fwd_kernel<T, true, true>)
                   : reinterpret_cast<const void*>(fwd_kernel<T, true, false>))
            : (bug ? reinterpret_cast<const void*>(fwd_kernel<T, false, true>)
                   : reinterpret_cast<const void*>(fwd_kernel<T, false, false>));
}

// The blocks of the launch of wb_fwd_geometry that one SM holds, as the CUDA
// runtime reports them (out[0]), for the instance wb_fwd_launch picks; the
// error of raising the kernel's shared-memory limit past the device's.
extern "C" int wb_fwd_occupancy(int N, int n_obs, int n_hp, int moving,
                                int per_scenario, int bug_compat, int n_alpha,
                                int* out) {
  const wb::FwdGeometry g =
      wb::fwd_geometry(wb::FWD_TEAM, N, n_obs, n_hp, moving != 0,
                       per_scenario != 0, n_alpha, 1);
  const void* k = fwd_instance<wb::FWD_TEAM>(per_scenario != 0,
                                             bug_compat != 0);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, g.threads,
                                                      g.smem);
  return static_cast<int>(e);
}

// C entry: statics is a HOST pointer (copied into the kernel argument); all
// other pointers are device memory, the six per-scenario operands (U_last,
// X_ref, U_ref, Q and P diagonals, eq_mask) null where the statics' ST_PS
// mask has no bit.  A nonzero mask launches fwd_kernel<FWD_TEAM, true, .>,
// the statics' bug_compat picks the last template argument.
// Returns cudaGetLastError() after the launch (or the error of raising the
// kernel's shared-memory limit).
extern "C" int wb_fwd_launch(const float* statics, const float* params,
                             const float* X, const float* U, const float* kff,
                             const float* K, const float* lam,
                             const float* lamt, const float* lame,
                             const float* ulast, const float* xref,
                             const float* uref, const float* qd,
                             const float* pd, const float* eqm, float* Xc,
                             float* Uc, float* xlast, float* cost, float mu,
                             int N, int B, void* stream) {
  wb::Statics st;
  std::memcpy(st.v, statics, sizeof(st.v));
  const int na = static_cast<int>(st.v[wb::ST_N_ALPHA]);
  if (na <= 0 || B <= 0 || N <= 0) return 0;
  if (na > wb::MAX_ALPHA) return static_cast<int>(cudaErrorInvalidValue);
  const int mask = static_cast<int>(st.v[wb::ST_PS]);
  const wb::PerScen psx{ulast, xref, uref, qd, pd, eqm};
  if (!wb::per_scen_complete(mask, psx))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bug = st.v[wb::ST_BUG_COMPAT] != 0.f;
  constexpr int T = wb::FWD_TEAM;
  auto launch = [&](auto ps, auto bg) {
    return wb::fwd_launch<T, decltype(ps)::value, decltype(bg)::value>(
        st, params, X, U, kff, K, lam, lamt, lame, psx, Xc, Uc, xlast, cost,
        mu, N, B, s);
  };
  using Y = std::true_type;
  using F = std::false_type;
  if (mask != 0) return bug ? launch(Y{}, Y{}) : launch(Y{}, F{});
  return bug ? launch(F{}, Y{}) : launch(F{}, F{});
}

// Sizes of the two host-built blocks, for the wrappers' layout check.
extern "C" int wb_statics_size() { return wb::ST_SIZE; }

extern "C" int wb_params_size(int N, int n_obs, int n_hp, int moving) {
  return wb::param_layout(N, n_obs, n_hp, moving != 0).size;
}

