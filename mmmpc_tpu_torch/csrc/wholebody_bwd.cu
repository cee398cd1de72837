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
// The TPU kernel carries (Vx, Vxx) in scratch memory across a sequential
// grid axis over the stages; here that axis is a loop inside the block.
//
// What bounds it on this card: the latency of a serial chain of N stages
// per scenario, each a few thousand dependent operations on a 9 x 9 value
// function; bytes are small (42 floats in per stage and scenario, 50 out).
// One thread per scenario left the chain in one thread, with 255 registers
// and spills, 64 blocks at batch 8192 and at most one warp per SM
// sub-partition to hide it.  So the design spreads each stage over the
// lanes of a team and the teams over the card's warps:
//
// - A team of T lanes of one warp per scenario (T a template parameter,
//   launched at BWD_TEAM = 8), 128 threads a block, at most 128 registers
//   a thread (__launch_bounds__), with no spill.
// - The stage's AL expansion, split: the four sincos of the forward
//   kinematics on four lanes, exchanged by shuffles; the rows of the slack
//   group (half-plane samples, ground circles, self-collision spheres, and
//   at k = N-1 the stale terminal self-collision rows when bug-compatible)
//   as a list of items
//   over the lanes, each into its own relu(max) accumulator, merged across
//   the team by a butterfly of shuffles under MaxAcc's rules (a larger max
//   replaces, equal maxima add counts and gradient sums, NaN stays NaN), so
//   that grad_scale applies the even tie split as before.
// - The Riccati step, split by rows: the row tasks t < 9 (lane t mod T)
//   give Qx[t] and row t of Qxx = lxx + A^T Vxx A, the tasks 9 + i give
//   Qu[i] and rows i of Qux = lux + B^T Vxx A and Quu = luu + B^T Vxx B, one
//   code for both (the rows of [A | B]^T picked by selects).  Every lane
//   factors the 5 x 5 Quu + reg I itself, so the factor is never exchanged,
//   and solves one column of [Qu | Qux].  The value update
//   Vxx_n = Qxx + K^T (Quu K + Qux) + Qux^T K goes row by row, and the
//   symmetrisation 0.5 (v_ij + v_ji) (the reference's :529) reads the
//   transposed entry from the team's tile.  The team exchanges through its
//   tile in shared memory (TeamTile, rows padded to three float4) with
//   __syncwarp.
// - Shared memory per block, none of it growing with N but the params: the
//   packed params (param_layout), the statics and a table of the
//   half-plane faces, loaded once; the teams' tiles; a two-stage buffer of
//   the stage inputs (x_k, u_k, lam_k of the block's scenarios,
//   element-major, scenario fastest), filled by cp.async one stage ahead,
//   the terminal inputs and the params first.  One __syncthreads a stage:
//   after it stage k's inputs have landed, stage k-1's loads are issued to
//   fly while stage k computes, and stage k+1's gains are stored from the
//   tiles of its parity, the block's scenarios contiguous along the batch.
// - A ragged batch: the lanes of a partial block run on the clamped
//   scenario index min(b, B - 1) and only stores are masked, so every
//   __syncthreads, __syncwarp and shuffle is reached by every thread.
// - Moving obstacles (statics ST_MOVING): the packed params hold an
//   obstacle row a stage (obs_rows), in shared memory with the rest; the
//   terminal expansion's circles read row N, stage k's row k, as the TPU
//   kernel's moving branch.  A static problem has one row that every stage
//   reads (a row stride of 0).
// - Per-scenario entries (statics ST_PS, the fleet's: the TPU kernel's
//   ps_* operands), in the instances bwd_kernel<T, true, .>: any subset of
//   U_last, X_ref, U_ref, Q, P and eq_mask.  Stage k's X_ref, U_ref and
//   U_last rows ride the stage buffer (NPS = 19 floats a scenario more,
//   loaded one stage ahead with x, u and lam), X_ref's row N, the P
//   diagonal and eq_mask the terminal slot, the Q diagonal a column of its
//   own a scenario, loaded once.  A shared reference or mask is copied
//   into every scenario's column as well, so the reads select nothing at
//   run time.  A per-scenario Q or P is its diagonal, as in the TPU
//   kernel: each team writes it into a 9 x 9 matrix of its own (P's for
//   the terminal expansion, then Q's for the stages), which the rows read
//   in place of the shared matrix, the static kernel's code on another
//   pointer (branches on the diagonal spilled registers).
//   The instances bwd_kernel<T, false, .> of the shared params read none of
//   them.
// - The sparse A = I + E and B are applied through their live entries
//   (struct Jac), the counterpart of the TPU kernel's trace-time literal
//   folding.  The stale-slack-index rows of the reference (terminal
//   self-collision on stage N-1) are chained through A and B at k = N-1.
// - The fixed terminal formulation (statics ST_BUG_COMPAT = 0, the TPU
//   kernel's bug_compat=False branch), in the instances
//   bwd_kernel<T, PS, false>: stage N-1 runs the stage group of the other
//   stages, and the terminal expansion takes the self-collision rows of
//   x_N as items after its circles and half-planes, their gradients into
//   its accumulator, split over the team as a stage's rows are.  The
//   bug-compatible instances <T, PS, true> are the code they were before
//   the flag: read at run time, it moved this kernel's registers (128 to
//   125).
// - No tensor cores: the products are 9 x 9 and 5 x 9 per scenario and
//   sparse through A and B, a wgmma tile has 64 rows (mostly padding here),
//   and TF32 keeps about three decimal digits, which a 20-stage Riccati
//   recursion through a Cholesky cannot afford at these tolerances.
//
// wholebody_common.cuh's helpers are used as they are (kernel A shares
// them and must not move); what this kernel needs otherwise (the items,
// the team's FK, the merge) is written below.  The cp.async wrappers are
// in cp_async.cuh, shared with kernel A.
#include <cstring>
#include <type_traits>

#include "cp_async.cuh"
#include "wholebody_common.cuh"

namespace wb {

constexpr int BWD_THREADS = 128;
constexpr int BWD_MIN_BLOCKS = 4;   // __launch_bounds__: <= 128 registers
// Lanes a scenario.  The kernel is written for a team of 8, 16 or 32; 8 was
// the fastest at batch 8192 (the times of each in PERF.md).
constexpr int BWD_TEAM = 8;
constexpr int NIN = NX + NU + NC;   // stage inputs per scenario: x, u, lam
constexpr int NTERM = NX + NCT + 2; // terminal inputs: x_N, lamt, lame
constexpr int NT = NX + NU;         // row tasks of a stage: x rows, u rows
// With per-scenario entries: stage k's X_ref, U_ref and U_last rows after
// a stage's inputs, and X_ref's row N, the P diagonal and eq_mask after the
// terminal inputs (within the terminal slot's NIN + NPS rows).
constexpr int NPS = NX + 2 * NU;
constexpr int IN_XREF = NIN;
constexpr int IN_UREF = IN_XREF + NX;
constexpr int IN_ULAST = IN_UREF + NU;
constexpr int TM_XREF = NTERM;
constexpr int TM_PD = TM_XREF + NX;
constexpr int TM_EQM = TM_PD + NX;
static_assert(TM_EQM < NIN + NPS, "the terminal slot holds its PS rows");
constexpr int LD = 12;              // padded row: three float4
constexpr unsigned FULL = 0xffffffffu;
// The half-plane faces of the problem, once per block: per face two float4,
// {n0, n1, n2, o0} and {o1, o2, mask, 0}, o = the face point pushed out by
// EXPAND along its normal n.
constexpr int HF = 8;

// The exchange tile of one team (one scenario), in shared memory.  Rows of
// nine are padded to twelve floats, so a row is read as three float4.
struct TeamTile {
  float V[NX][LD];    // Vxx carried between stages (symmetric)
  float Qxx[NX][LD];  // Qxx, then the unsymmetrised new Vxx
  float Qux[NU][LD];
  float Km[2][NU][LD];  // K of stages of parity 0 / 1
  float M[NU][LD];    // Quu K + Qux
  float Quu[NU][8];
  float vx[LD];       // Vx
  float q[16];        // [Qx | Qu]
  float kf[2][8];     // kff of stages of parity 0 / 1
  float s[16];        // the slack group's scaled gradient (sx, su)
};

__host__ __device__ inline int bwd_smem_bytes(int team, int N, int n_obs,
                                              int n_hp, bool moving, bool ps) {
  const int scen = BWD_THREADS / team;
  const int floats = scen * static_cast<int>(sizeof(TeamTile) / sizeof(float)) +
                     2 * (ps ? NIN + NPS : NIN) * scen + HF * n_hp +
                     (ps ? NX * scen + NX * NX * scen : 0) + ST_SIZE +
                     param_layout(N, n_obs, n_hp, moving).size;
  return floats * static_cast<int>(sizeof(float));
}

// A padded row of nine from shared memory.
__device__ __forceinline__ void ld_row(const float* row, float out[NX]) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  out[8] = row[8];
}
__device__ __forceinline__ void st_row(float* row, const float v[NX]) {
  *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(row + 4) = make_float4(v[4], v[5], v[6], v[7]);
  row[8] = v[8];
}

// 1 / sqrt(q): the MUFU estimate and one Newton step, within an ulp or so of
// the correctly rounded sqrtf and division, at less latency on the stage's
// chain.  It is not needed for accuracy: the refined qref solve's worst
// robot ends within a few percent of the 1e-3 violation tolerance, and
// whether it passes turns on rounding alone.  Of five roundings of these
// reciprocals (PERF.md, bwd_rounding_variants.py) three passed, among them
// this one and correct rounding throughout, and two failed: the bare
// estimate throughout, and correct rounding in the Cholesky alone.
__device__ __forceinline__ float rsqrt_nr(float q) {
  const float y = rsqrtf(q);
  return y * (1.5f - 0.5f * q * y * y);
}

// PHR row of the expansion: adds +-max(lam + mu c, 0) to the gradient entry
// and the active indicator to the Hessian diagonal count.
__device__ __forceinline__ void phr_row(float lam, float mu, float c, bool live,
                                        float sign, float& g, float& act) {
  if (!live) return;
  const float z = lam + mu * c;
  g += sign * fmaxf(z, 0.f);
  act += z > 0.f ? 1.f : 0.f;
}

// fk of wholebody_common.cuh with its four sincos split over four lanes of
// the team (angles q1, q1 - q2, q1 - q2 - q3, psi), exchanged by shuffles.
template <int T>
__device__ __forceinline__ void fk_team(const float* x, int lane, FK& f) {
  const int q = lane & 3;
  const float th = x[6] - x[7];
  const float ang = q == 0 ? x[6] : q == 1 ? th : q == 2 ? th - x[8] : x[2];
  float sa, ca;
  sincosf(ang, &sa, &ca);
  const int b = lane & ~3;
  const float s1 = __shfl_sync(FULL, sa, b, T), c1 = __shfl_sync(FULL, ca, b, T);
  const float st = __shfl_sync(FULL, sa, b + 1, T), ct = __shfl_sync(FULL, ca, b + 1, T);
  const float sb = __shfl_sync(FULL, sa, b + 2, T), cb = __shfl_sync(FULL, ca, b + 2, T);
  f.sp = __shfl_sync(FULL, sa, b + 3, T);
  f.cp = __shfl_sync(FULL, ca, b + 3, T);

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

// The rows of the slack group, as items of a list that the team's lanes
// share: the ground circles, the four self-collision spheres, the six
// half-plane samples (when a face is live), then at k = N-1 the four stale
// terminal self-collision rows.  Item `it` of a lane adds to its own acc.
// Ground circle o of the obstacle row ob: (r_obs + r_base) - |(px, py) -
// obs|.
template <int NV>
__device__ __forceinline__ void ground_item(int o, const float* x,
                                            const float* ob, float base_radius,
                                            MaxAcc<NV>& acc) {
  const float dx = x[0] - ob[3 * o];
  const float dy = x[1] - ob[3 * o + 1];
  const float q = dx * dx + dy * dy + EPS;
  const float id = rsqrt_nr(q);   // 1 / d
  const float d = q * id;
  float g[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) g[i] = 0.f;
  g[0] = -dx * id;
  g[1] = -dy * id;
  acc.add((ob[3 * o + 2] + base_radius) - d, g);
}

// Self-collision sphere r (SELF_DIFF[r]): SELF_R - |check - ee|; its
// gradient w.r.t. x of fk's point, pulled back through A and B (gx, gu)
// for the stale rows.
__device__ __forceinline__ void self_coef(int r, float& a0, float& a1) {
  a0 = r == 0 ? 0.f : (r == 2 ? 1.f : 0.5f);
  a1 = r == 3 ? 0.5f : 0.f;
}

template <int NV>
__device__ __forceinline__ void self_item(int r, const FK& f, MaxAcc<NV>& acc) {
  float a0, a1;
  self_coef(r, a0, a1);
  float v3[3];
  combo(f, a0, a1, -1.f, v3);
  const float q = v3[0] * v3[0] + v3[1] * v3[1] + v3[2] * v3[2] + EPS;
  const float in = -rsqrt_nr(q);  // -1 / n
  const float n = -q * in;
  float g[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) g[i] = 0.f;
  const float w[3] = {v3[0] * in, v3[1] * in, v3[2] * in};
  add_point_grad(f, a0, a1, -1.f, w, g);
  acc.add(SELF_R - n, g);
}

// Half-plane sample r (HP_POINTS[r]): -max over live faces of n . (o - P),
// NEG_BIG (never the max) for a masked face; the tie-split mean of the
// maximal faces' normals, in one pass over the faces.
template <int NV>
__device__ __forceinline__ void halfplane_item(int r, const FK& f,
                                               const float* hf, int n_hp,
                                               MaxAcc<NV>& acc) {
  const float a0 = r == 0 || r == 2 ? 0.5f : (r == 1 ? 1.f : 0.f);
  const float a1 = r == 2 || r == 4 ? 0.5f : (r == 3 ? 1.f : 0.f);
  const float a2 = r == 4 ? 0.5f : (r == 5 ? 1.f : 0.f);
  float P[3];
  combo(f, a0, a1, a2, P);
  float dmax = -INFINITY, cnt = 0.f;
  float nsum[3] = {0.f, 0.f, 0.f};
  for (int h = 0; h < n_hp; ++h) {
    const float4 a = *reinterpret_cast<const float4*>(hf + HF * h);
    const float4 b = *reinterpret_cast<const float4*>(hf + HF * h + 4);
    const float d = b.z > 0.f
        ? a.x * (a.w - P[0]) + a.y * (b.x - P[1]) + a.z * (b.y - P[2])
        : -1e9f;
    const bool gt = d > dmax || isnan(d), eq = d == dmax;
    dmax = gt ? d : dmax;
    cnt = gt ? 1.f : (eq ? cnt + 1.f : cnt);
    nsum[0] = gt ? a.x : (eq ? nsum[0] + a.x : nsum[0]);
    nsum[1] = gt ? a.y : (eq ? nsum[1] + a.y : nsum[1]);
    nsum[2] = gt ? a.z : (eq ? nsum[2] + a.z : nsum[2]);
  }
  float g[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) g[i] = 0.f;
  const float ic = 1.f / cnt;
  const float w[3] = {nsum[0] * ic, nsum[1] * ic, nsum[2] * ic};
  add_point_grad(f, a0, a1, a2, w, g);
  acc.add(-dmax, g);
}

// Merge the lanes' partial relu(max) accumulators across the team
// (butterfly): a larger max replaces the others, equal maxima add their
// counts and gradient sums, and a NaN max stays NaN (the expansion is then
// NaN whatever the gradient).  Only the gradient entries I::at(0 .. I::n-1)
// can be nonzero.  Every lane ends with the same result.
template <int T, class I, int NV>
__device__ __forceinline__ void merge_team(MaxAcc<NV>& m) {
#pragma unroll
  for (int off = 1; off < T; off <<= 1) {
    const float og = __shfl_xor_sync(FULL, m.gmax, off, T);
    const float oc = __shfl_xor_sync(FULL, m.cnt, off, T);
    const bool nan = isnan(og) || isnan(m.gmax);
    const bool take = !nan && og > m.gmax;
    const bool add = nan || og == m.gmax;
#pragma unroll
    for (int n = 0; n < I::n; ++n) {
      const int e = I::at(n);
      const float o = __shfl_xor_sync(FULL, m.gsum[e], off, T);
      m.gsum[e] = take ? o : (add ? m.gsum[e] + o : m.gsum[e]);
    }
    m.cnt = take ? oc : (add ? m.cnt + oc : m.cnt);
    m.gmax = nan ? NAN : (take ? og : m.gmax);
  }
}

// The entries of a slack-row gradient that fk's points reach (px, py,
// psi, q1-q3), and all of them (the stale rows, through A and B).
struct FkIdx {
  static constexpr int n = 6;
  __device__ static constexpr int at(int k) { return k < 3 ? k : k + 3; }
};
struct AllIdx {
  static constexpr int n = NX + NU;
  __device__ static constexpr int at(int k) { return k; }
};

// The stage's slack group over the team (its circles those of the
// obstacle row ob): each lane runs its items of the list into its own
// accumulator, the team merges them, and the lanes write the scaled
// gradient (sx, su) to the tile.  NV = NX: the gradient in x alone (every
// su is 0); NV = NX + NU: in x and u, stage N-1's, with the stale rows when
// STALE (bug-compatible).  Returns smax.
template <int T, int NV, bool STALE>
__device__ __forceinline__ float stage_slack(
    const float* x, const float* u, const FK& f, const Jac& J, float dt,
    const float* ob, const float* hf, int n_obs, int n_hp, int n_hpi,
    float base_radius, int lane, TeamTile& tt) {
  MaxAcc<NV> m;
  m.init();
  for (int it = lane; it < n_hpi + n_obs + 4; it += T) {
    if (it < n_hpi) halfplane_item<NV>(it, f, hf, n_hp, m);
    else if (it < n_hpi + n_obs) ground_item<NV>(it - n_hpi, x, ob, base_radius, m);
    else self_item<NV>(it - n_hpi - n_obs, f, m);
  }
  if constexpr (STALE) {
    // terminal self-collision at x_N = f(x, u), chained through A and B
    // (a loop of its own, after f is dead but for its yaw)
    const float cp = f.cp, sp = f.sp;
    for (int r = lane; r < 4; r += T) {
      float xn[NX];
      step(x, u, dt, cp, sp, xn);
      FK fn;
      fk(xn, fn);
      MaxAcc<NX> t;
      t.init();
      self_item<NX>(r, fn, t);
      float g[NX + NU];
      At_v(J, t.gsum, g);
      Bt_v(J, t.gsum, g + NX);
      m.add(t.gmax, g);
    }
  }
  if constexpr (NV == NX + NU) merge_team<T, AllIdx>(m);
  else merge_team<T, FkIdx>(m);
  const float gs = m.grad_scale();
#pragma unroll
  for (int i = 0; i < NX + NU; ++i)
    if (lane == i % T) tt.s[i] = i < NV ? m.gsum[i < NV ? i : 0] * gs : 0.f;
  return m.smax();
}

template <int T, bool PS, bool BUG>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
bwd_kernel(const Statics st, const float* __restrict__ pp,
           const float* __restrict__ X, const float* __restrict__ U,
           const float* __restrict__ lam, const float* __restrict__ lamt,
           const float* __restrict__ lame, const PerScen psx,
           const float* __restrict__ reg, float* __restrict__ kff_out,
           float* __restrict__ K_out, float mu, int N, int B) {
  constexpr int SCEN = BWD_THREADS / T;   // scenarios (teams) a block
  constexpr int NB = PS ? NIN + NPS : NIN;   // a stage's buffer rows
  extern __shared__ __align__(16) float smem[];
  const int n_obs = static_cast<int>(st.v[ST_N_OBS]);
  const int n_hp = static_cast<int>(st.v[ST_N_HP]);
  const bool moving = st.v[ST_MOVING] != 0.f;
  const int pmask = PS ? static_cast<int>(st.v[ST_PS]) : 0;
  const Layout L = param_layout(N, n_obs, n_hp, moving);
  TeamTile* tiles = reinterpret_cast<TeamTile*>(smem);
  float* inbuf = smem + SCEN * (sizeof(TeamTile) / sizeof(float));
  float* hf = inbuf + 2 * NB * SCEN;      // half-plane faces
  float* qdb = hf + HF * n_hp;            // PS: the Q diagonals, NX rows
  float* dmb = qdb + (PS ? NX * SCEN : 0);  // PS: the teams' diagonal Q / P
  float* sv = dmb + (PS ? NX * NX * SCEN : 0);  // statics
  float* ps = sv + ST_SIZE;               // packed params
  // stage k's obstacle row: ob0 + k * ostride (the one row if static)
  const float* ob0 = ps + L.obs;
  const int ostride = obs_row_stride(n_obs, moving);

  const int tid = threadIdx.x;
  const int team = tid / T, lane = tid % T;
  const int b0 = blockIdx.x * SCEN;
  TeamTile& tt = tiles[team];

  // The block's copies of per-scenario arrays: thread tid moves scenario
  // cs = tid % SCEN (clamped to the batch) of the element rows
  // ci, ci + T, ...; buffers and tiles are element-major, scenario fastest.
  const int cs = tid % SCEN, ci = tid / SCEN;
  const int cb = min(b0 + cs, B - 1);
  // stage k's inputs into buffer k & 1
  auto issue_stage = [&](int k) {
    float* dst = inbuf + (k & 1) * NB * SCEN + cs;
    for (int i = ci; i < NIN; i += T) {
      const float* src =
          i < NX ? X + static_cast<long long>(k * NX + i) * B
          : i < NX + NU ? U + static_cast<long long>(k * NU + i - NX) * B
                        : lam + static_cast<long long>(k * NC + i - NX - NU) * B;
      cp_async4(dst + i * SCEN, src + cb);
    }
    if constexpr (PS) {
      // each scenario's own row, or the shared one
      for (int i = ci; i < NPS; i += T) {
        const bool x_ = i < NX, u_ = !x_ && i < NX + NU;
        const int r = x_ ? i : u_ ? i - NX : i - NX - NU;
        const int row = (x_ ? k * NX : k * NU) + r;
        const float* own = x_ ? psx.xref : u_ ? psx.uref : psx.ulast;
        const int bit = x_ ? PS_XREF : u_ ? PS_UREF : PS_ULAST;
        const int off = (x_ ? L.xref : u_ ? L.uref : L.ulast) + row;
        cp_async4(dst + (NIN + i) * SCEN,
                  (pmask & bit) ? own + static_cast<long long>(row) * B + cb
                                : pp + off);
      }
    }
  };
  // stage k's gains from the tiles of its parity
  auto store_gains = [&](int k) {
    if (b0 + cs >= B) return;
    const TeamTile& ts = tiles[cs];
    for (int q = ci; q < NU * (1 + NX); q += T) {
      const int i = q / (1 + NX), c = q % (1 + NX);
      if (c == 0)
        kff_out[static_cast<long long>(k * NU + i) * B + cb] = ts.kf[k & 1][i];
      else
        K_out[static_cast<long long>((k * NU + i) * NX + c - 1) * B + cb] =
            ts.Km[k & 1][i][c - 1];
    }
  };
  // terminal inputs into buffer N & 1 (stage N-1 uses the other)
  {
    float* dst = inbuf + (N & 1) * NB * SCEN + cs;
    for (int i = ci; i < NTERM; i += T) {
      const float* src =
          i < NX ? X + static_cast<long long>(N * NX + i) * B
          : i < NX + NCT ? lamt + static_cast<long long>(i - NX) * B
                         : lame + static_cast<long long>(i - NX - NCT) * B;
      cp_async4(dst + i * SCEN, src + cb);
    }
    if constexpr (PS) {
      // X_ref's row N and eq_mask (each scenario's own, or the shared), the
      // P diagonal; the Q diagonal
      for (int i = ci; i < 2 * NX + 1; i += T) {
        const int bit = i < NX ? PS_XREF : i < 2 * NX ? PS_P : PS_EQM;
        const float* src =
            i < NX ? psx.xref + static_cast<long long>(N * NX + i) * B + cb
            : i < 2 * NX ? psx.pd + static_cast<long long>(i - NX) * B + cb
                         : psx.eqm + cb;
        if (pmask & bit)
          cp_async4(dst + (TM_XREF + i) * SCEN, src);
        else if (bit != PS_P)
          cp_async4(dst + (TM_XREF + i) * SCEN,
                    pp + (i < NX ? L.xref + N * NX + i : L.eqm));
      }
      if (pmask & PS_Q)
        for (int i = ci; i < NX; i += T)
          cp_async4(qdb + i * SCEN + cs, psx.qd + static_cast<long long>(i) * B + cb);
    }
    for (int i = tid; i < L.size; i += BWD_THREADS) cp_async4(ps + i, pp + i);
    cp_async_commit();
  }
  issue_stage(N - 1);
  cp_async_commit();
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < ST_SIZE; ++i) sv[i] = st.v[i];
  }
  for (int h = tid; h < n_hp; h += BWD_THREADS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float nc = __ldg(pp + L.hpn + 3 * h + c);
      hf[HF * h + c] = nc;
      hf[HF * h + 3 + c] = __ldg(pp + L.hpp + 3 * h + c) - EXPAND * nc;
    }
    hf[HF * h + 6] = __ldg(pp + L.hpm + h);
    hf[HF * h + 7] = 0.f;
  }

  const float dt = st.v[ST_DT];
  const float two_s = 2.f * st.v[ST_INV_SCALE];
  const float base_radius = st.v[ST_BASE_RADIUS];
  const float rg = __ldg(reg + min(b0 + team, B - 1));
  float hp_live = 0.f;
  for (int h = 0; h < n_hp; ++h) hp_live += __ldg(pp + L.hpm + h);
  const int n_hpi = hp_live > 0.f ? 6 : 0;   // half-plane items
  cp_async_wait<1>();
  __syncthreads();
  const float S = ps[L.S];
  // (PS) the team's diagonal matrix: P's diagonal now, Q's after the
  // terminal expansion; the rows read it where the entry is per scenario
  float* dm = dmb + team * NX * NX;
  if constexpr (PS) {
    const float* tin = inbuf + (N & 1) * NB * SCEN + team;
    for (int i = lane; i < NX * NX; i += T) {
      const int r = i / NX;
      dm[i] = i == r * (NX + 1) && (pmask & PS_P) ? tin[(TM_PD + r) * SCEN]
                                                  : 0.f;
    }
    __syncwarp();
  }
  const float* Pm = PS && (pmask & PS_P) ? dm : ps + L.P;
  const float* Qm = PS && (pmask & PS_Q) ? dm : ps + L.Q;

  // ---------------- terminal expansion -> Vx, Vxx ----------------
  {
    const float* in = inbuf + (N & 1) * NB * SCEN + team;
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = in[i * SCEN];
    FK f;
    fk_team<T>(x, lane, f);
    MaxAcc<NX> m;
    m.init();
    if constexpr (BUG) {
      // no self-collision rows: they rode stage N-1's slack group
      for (int it = lane; it < n_obs + n_hpi; it += T) {
        if (it < n_obs) ground_item<NX>(it, x, ob0 + N * ostride, base_radius, m);
        else halfplane_item<NX>(it - n_obs, f, hf, n_hp, m);
      }
    } else {
      // the circles, the half-planes, then the self-collision rows
      for (int it = lane; it < n_obs + n_hpi + 4; it += T) {
        if (it < n_obs) ground_item<NX>(it, x, ob0 + N * ostride, base_radius, m);
        else if (it < n_obs + n_hpi) halfplane_item<NX>(it - n_obs, f, hf, n_hp, m);
        else self_item<NX>(it - n_obs - n_hpi, f, m);
      }
    }
    merge_team<T, FkIdx>(m);
    const float smax = m.smax();
    const float gs = m.grad_scale();
#pragma unroll
    for (int i = 0; i < NX; ++i)
      if (lane == i % T) tt.s[i] = m.gsum[i] * gs;
    __syncwarp();
    // the shared rows, or (PS) the scenario's column of the slot
    const float* xr = PS ? in + TM_XREF * SCEN : ps + L.xref + N * NX;
    constexpr int xs = PS ? SCEN : 1;
    const float em = PS ? in[TM_EQM * SCEN] : ps[L.eqm];
    for (int r = lane; r < NX; r += T) {
      const float* Pr = Pm + r * NX;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += Pr[j] * (x[j] - xr[j * xs]);
      const float sr = tt.s[r];
      float v = two_s * (acc + S * smax * sr);
      float act = 0.f;
      const float xv = in[r * SCEN];
      phr_row(in[(NX + r) * SCEN], mu, xv - sv[ST_XHI + r],
              sv[ST_XMHI + r] != 0.f, 1.f, v, act);
      phr_row(in[(2 * NX + r) * SCEN], mu, sv[ST_XLO + r] - xv,
              sv[ST_XMLO + r] != 0.f, -1.f, v, act);
      // maskable terminal position equality h = m (x[:2] - ref)
      if (r < 2)
        v += em * (in[(NX + NCT + r) * SCEN] + mu * (em * (xv - xr[r * xs])));
      tt.vx[r] = v;
      float h[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        h[j] = two_s * (Pr[j] + S * sr * tt.s[j]);
        if (j == r) {
          h[j] += mu * act;
          if (r < 2) h[j] += mu * em * em;
        }
      }
      st_row(tt.V[r], h);
    }
    if constexpr (PS) {
      __syncwarp();
      for (int r = lane; r < NX; r += T)
        dm[r * (NX + 1)] = (pmask & PS_Q) ? qdb[r * SCEN + team] : 0.f;
    }
  }

  // ---------------- backward over the stages ----------------
  // One barrier a stage: after it, stage k's inputs have landed, every
  // team is done with stage k+1 (so its input buffer takes stage k-1's
  // loads, which fly while stage k computes), and stage k+1's gains are
  // complete in their tiles (parity (k+1) & 1) and are stored.
  for (int k = N - 1; k >= 0; --k) {
    cp_async_wait<0>();
    __syncthreads();
    if (k > 0) issue_stage(k - 1);
    cp_async_commit();
    if (k < N - 1) store_gains(k + 1);
    const int par = k & 1;
    const float* in = inbuf + (k & 1) * NB * SCEN + team;
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = in[i * SCEN];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = in[(NX + i) * SCEN];

    // ---- the AL expansion: the slack group's rows split over the lanes
    Jac J;
    float smax;
    {
      FK f;
      fk_team<T>(x, lane, f);
      J = jacobians(x, u, dt, f.cp, f.sp);
      // stage N-1 in the 14-wide accumulator in the fixed instances too:
      // with stage_slack<T, NX> at every stage the fleet's fixed instance
      // spilled 4 bytes
      smax = k == N - 1
          ? stage_slack<T, NX + NU, BUG>(x, u, f, J, dt, ob0 + k * ostride,
                                         hf, n_obs, n_hp, n_hpi, base_radius,
                                         lane, tt)
          : stage_slack<T, NX, false>(x, u, f, J, dt, ob0 + k * ostride, hf,
                                      n_obs, n_hp, n_hpi, base_radius, lane,
                                      tt);
    }
    __syncwarp();
    const float Ssm = S * smax;

    // ---- row tasks t < NX: x row r = t (Qx[r], Qxx row r = lxx + A^T Vxx A);
    // t >= NX: u row i = t - NX (Qu[i], Qux row i = lux + B^T Vxx A, Quu row
    // i = luu + B^T Vxx B).  w = row t of [A | B]^T Vxx: the diagonal row
    // (x rows) plus up to three live entries, picked by t.
    for (int t = lane; t < NT; t += T) {
      const bool xrow = t < NX;
      const int i = t - NX;
      const float cd = xrow ? 1.f : 0.f;
      const int pd = xrow ? t : 0;
      const float ca = t == 2 ? J.a32 : (t >= 3 && t <= 5) ? dt
                     : t == NX ? J.b30 : t > NX ? dt : 0.f;
      const int pa = t == 2 ? 3 : (t >= 3 && t <= 5) ? t - 3
                   : t == NX ? 3 : t > NX ? 4 + i : 0;
      const float cb = t == 2 ? J.a42 : t == 3 ? J.a43 : t == 4 ? J.a34
                     : t == 5 ? J.a35 : t == NX ? J.b40 : 0.f;
      const int pb = (t == 2 || t == 3 || t == NX) ? 4 : 3;
      const float cc = t == 5 ? J.a45 : 0.f;
      float w[NX];
      {
        float a[NX], b[NX], c[NX], d[NX];
        ld_row(tt.V[pd], d);
        ld_row(tt.V[pa], a);
        ld_row(tt.V[pb], b);
        ld_row(tt.V[4], c);
#pragma unroll
        for (int j = 0; j < NX; ++j) w[j] = cd * d[j] + ca * a[j] + cb * b[j] + cc * c[j];
      }
      const float vq = cd * tt.vx[pd] + ca * tt.vx[pa] + cb * tt.vx[pb] + cc * tt.vx[4];
      // the row's gradient entry: Q (x - xref), or R (u - uref) + W (u - ulast)
      // (the shared rows, or (PS) the scenario's columns of the buffer)
      constexpr int rs = PS ? SCEN : 1;
      float acc = 0.f, val;
      if (xrow) {
        const float* Qr = Qm + t * NX;
        const float* xr = PS ? in + IN_XREF * SCEN : ps + L.xref + k * NX;
        constexpr int xs = rs;
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += Qr[j] * (in[j * SCEN] - xr[j * xs]);
        val = in[t * SCEN];
      } else {
        const float* Ri = ps + L.R + i * NU;
        const float* Wi = ps + L.W + i * NU;
        const float* ur = PS ? in + IN_UREF * SCEN : ps + L.uref + k * NU;
        const float* ul = PS ? in + IN_ULAST * SCEN : ps + L.ulast + k * NU;
        constexpr int us = rs, ls = rs;
#pragma unroll
        for (int j = 0; j < NU; ++j)
          acc += Ri[j] * (in[(NX + j) * SCEN] - ur[j * us]) +
                 Wi[j] * (in[(NX + j) * SCEN] - ul[j * ls]);
        val = in[t * SCEN] - ul[i * ls];
      }
      const float st_ = tt.s[t];
      float l = two_s * (acc + Ssm * st_);
      float act = 0.f;
      const int hi = xrow ? ST_XHI + t : ST_DUHI + i;
      const int lo = xrow ? ST_XLO + t : ST_DULO + i;
      const int mhi = xrow ? ST_XMHI + t : ST_DUMHI + i;
      const int mlo = xrow ? ST_XMLO + t : ST_DUMLO + i;
      phr_row(in[(NX + NU + (xrow ? t : t + NX)) * SCEN], mu, val - sv[hi],
              sv[mhi] != 0.f, 1.f, l, act);
      phr_row(in[(NX + NU + (xrow ? NX + t : t + NX + NU)) * SCEN], mu,
              sv[lo] - val, sv[mlo] != 0.f, -1.f, l, act);
      tt.q[t] = l + vq;
      if (!xrow) {
        const float* Ri = ps + L.R + i * NU;
        const float* Wi = ps + L.W + i * NU;
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          float lj = two_s * (Ri[j] + Wi[j] + S * st_ * tt.s[NX + j]);
          if (j == i) lj += mu * act;
          tt.Quu[i][j] = lj + (j == 0 ? J.b30 * w[3] + J.b40 * w[4] : dt * w[4 + j]);
        }
      }
      // w <- w A (only columns 2..5 change), then + the stage block
      {
        const float m0 = w[0], m1 = w[1], m2 = w[2], m3 = w[3], m4 = w[4];
        w[2] = m2 + m3 * J.a32 + m4 * J.a42;
        w[3] = m3 + m0 * dt + m4 * J.a43;
        w[4] = m4 + m1 * dt + m3 * J.a34;
        w[5] = w[5] + m2 * dt + m3 * J.a35 + m4 * J.a45;
      }
      const float* Qr = Qm + (xrow ? t : 0) * NX;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float lj = two_s * (cd * Qr[j] + S * st_ * tt.s[j]);
        if (j == t) lj += mu * act;
        w[j] += lj;
      }
      st_row(xrow ? tt.Qxx[t] : tt.Qux[i], w);
    }
    __syncwarp();

    // ---- Cholesky of Quu + reg I in every lane (pivot reciprocals from
    // rsqrt_nr, so the substitutions multiply), then a column of [kff | K] =
    // -(Quu + reg I)^-1 [Qu | Qux] a lane
    {
      float Lc[NU][NU], Dinv[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          float s = tt.Quu[i][j] + (i == j ? rg : 0.f);
#pragma unroll
          for (int p = 0; p < j; ++p) s -= Lc[i][p] * Lc[j][p];
          if (i == j) {
            Dinv[i] = rsqrt_nr(s);
            Lc[i][i] = s * Dinv[i];
          } else {
            Lc[i][j] = s * Dinv[j];
          }
        }
      }
      for (int c = lane; c < 1 + NX; c += T) {
        const float* rhs = c == 0 ? tt.q + NX : &tt.Qux[0][c - 1];
        const int stride = c == 0 ? 1 : LD;
        float y[NU];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          float s = rhs[i * stride];
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
        float* out = c == 0 ? tt.kf[par] : &tt.Km[par][0][c - 1];
#pragma unroll
        for (int i = 0; i < NU; ++i) out[i * stride] = -z[i];
      }
    }
    __syncwarp();

    // ---- value update (Quu without reg):
    //   Vx  = Qx + K^T (Quu kff + Qu) + Qux^T kff
    //   Vxx = Qxx + K^T M + Qux^T K, M = Quu K + Qux, then symmetrised
    {
      float kf[NU], w[NU];
#pragma unroll
      for (int p = 0; p < NU; ++p) kf[p] = tt.kf[par][p];
#pragma unroll
      for (int p = 0; p < NU; ++p) {
        float s = tt.q[NX + p];
#pragma unroll
        for (int q = 0; q < NU; ++q) s += tt.Quu[p][q] * kf[q];
        w[p] = s;
      }
      for (int r = lane; r < NX; r += T) {
        float kc[NU], gc[NU];
#pragma unroll
        for (int p = 0; p < NU; ++p) {
          kc[p] = tt.Km[par][p][r];
          gc[p] = tt.Qux[p][r];
        }
        float s = tt.q[r];
#pragma unroll
        for (int p = 0; p < NU; ++p) s += kc[p] * w[p] + gc[p] * kf[p];
        tt.vx[r] = s;
#pragma unroll
        for (int p = 0; p < NU; ++p) {
          float m = gc[p];
#pragma unroll
          for (int q = 0; q < NU; ++q) m += tt.Quu[p][q] * kc[q];
          tt.M[p][r] = m;
        }
      }
    }
    __syncwarp();
    for (int r = lane; r < NX; r += T) {
      float v[NX];
      ld_row(tt.Qxx[r], v);
#pragma unroll
      for (int p = 0; p < NU; ++p) {
        const float kr = tt.Km[par][p][r], gr = tt.Qux[p][r];
        float m[NX], kp[NX];
        ld_row(tt.M[p], m);
        ld_row(tt.Km[par][p], kp);
#pragma unroll
        for (int j = 0; j < NX; ++j) v[j] += kr * m[j] + gr * kp[j];
      }
      st_row(tt.Qxx[r], v);
    }
    __syncwarp();
    for (int r = lane; r < NX; r += T) {
      float v[NX];
      ld_row(tt.Qxx[r], v);
#pragma unroll
      for (int j = 0; j < NX; ++j) v[j] = 0.5f * (v[j] + tt.Qxx[j][r]);
      st_row(tt.V[r], v);
    }
  }
  __syncthreads();
  store_gains(0);
}

// The launch at batch B: threads a block, blocks, dynamic shared-memory
// bytes.  wb_bwd_launch launches with it and wb_bwd_geometry reports it.
struct Geometry {
  int threads, blocks, smem;
};
inline Geometry bwd_geometry(int N, int n_obs, int n_hp, bool moving, bool ps,
                             int B) {
  constexpr int scen = BWD_THREADS / BWD_TEAM;
  return {BWD_THREADS, (B + scen - 1) / scen,
          bwd_smem_bytes(BWD_TEAM, N, n_obs, n_hp, moving, ps)};
}

template <bool PS, bool BUG>
int bwd_launch(const Statics& st, const float* params, const float* X,
               const float* U, const float* lam, const float* lamt,
               const float* lame, const PerScen& psx, const float* reg,
               float* kff, float* K, float mu, int N, int B,
               cudaStream_t stream) {
  const Geometry g = bwd_geometry(
      N, static_cast<int>(st.v[ST_N_OBS]), static_cast<int>(st.v[ST_N_HP]),
      st.v[ST_MOVING] != 0.f, PS, B);
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_kernel<BWD_TEAM, PS, BUG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        g.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bwd_kernel<BWD_TEAM, PS, BUG><<<g.blocks, g.threads, g.smem, stream>>>(
      st, params, X, U, lam, lamt, lame, psx, reg, kff, K, mu, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wb

// Launch geometry at batch B (moving != 0: an obstacle row a stage;
// per_scenario: the statics' ST_PS mask): out = {lanes a scenario, threads
// a block, blocks, dynamic shared-memory bytes}, as wb_bwd_launch launches.
extern "C" int wb_bwd_geometry(int N, int n_obs, int n_hp, int moving,
                               int per_scenario, int B, int* out) {
  const wb::Geometry g =
      wb::bwd_geometry(N, n_obs, n_hp, moving != 0, per_scenario != 0, B);
  out[0] = wb::BWD_TEAM;
  out[1] = g.threads;
  out[2] = g.blocks;
  out[3] = g.smem;
  return 0;
}

// The kernel instance wb_bwd_launch picks for the statics' per-scenario
// mask and bug_compat flag.
const void* bwd_instance(bool ps, bool bug) {
  using wb::bwd_kernel;
  constexpr int T = wb::BWD_TEAM;
  return ps ? (bug ? reinterpret_cast<const void*>(bwd_kernel<T, true, true>)
                   : reinterpret_cast<const void*>(bwd_kernel<T, true, false>))
            : (bug ? reinterpret_cast<const void*>(bwd_kernel<T, false, true>)
                   : reinterpret_cast<const void*>(bwd_kernel<T, false, false>));
}

// The blocks of the launch of wb_bwd_geometry that one SM holds, as the CUDA
// runtime reports them (out[0]), for the instance wb_bwd_launch picks; the
// error of raising the kernel's shared-memory limit past the device's.
extern "C" int wb_bwd_occupancy(int N, int n_obs, int n_hp, int moving,
                                int per_scenario, int bug_compat, int* out) {
  const wb::Geometry g =
      wb::bwd_geometry(N, n_obs, n_hp, moving != 0, per_scenario != 0, 1);
  const void* k = bwd_instance(per_scenario != 0, bug_compat != 0);
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
// mask has no bit.  A nonzero mask launches bwd_kernel<BWD_TEAM, true, .>,
// the statics' bug_compat picks the last template argument.
// Returns cudaGetLastError() after the launch (or the error of raising the
// kernel's shared-memory limit).
extern "C" int wb_bwd_launch(const float* statics, const float* params,
                             const float* X, const float* U, const float* lam,
                             const float* lamt, const float* lame,
                             const float* ulast, const float* xref,
                             const float* uref, const float* qd,
                             const float* pd, const float* eqm,
                             const float* reg, float* kff, float* K, float mu,
                             int N, int B, void* stream) {
  wb::Statics st;
  std::memcpy(st.v, statics, sizeof(st.v));
  if (B <= 0 || N <= 0) return 0;
  const int mask = static_cast<int>(st.v[wb::ST_PS]);
  const wb::PerScen psx{ulast, xref, uref, qd, pd, eqm};
  if (!wb::per_scen_complete(mask, psx))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bug = st.v[wb::ST_BUG_COMPAT] != 0.f;
  auto launch = [&](auto ps, auto bg) {
    return wb::bwd_launch<decltype(ps)::value, decltype(bg)::value>(
        st, params, X, U, lam, lamt, lame, psx, reg, kff, K, mu, N, B, s);
  };
  using Y = std::true_type;
  using F = std::false_type;
  if (mask != 0) return bug ? launch(Y{}, Y{}) : launch(Y{}, F{});
  return bug ? launch(F{}, Y{}) : launch(F{}, F{});
}
