// mmrt — native host-side runtime for the mobile-manipulator MPC framework.
//
// The TPU (XLA) owns the compute path: batched AL-iLQR solves.  Around it,
// deployment needs a low-latency host runtime for per-tick orchestration:
// kinematics queries, the kinematic plant, reference windowing and command
// integration.  The reference delegates this role to native third-party
// code (PyBullet C++ via urdfenvs, CasADi C++ evaluation); here it is a
// small dependency-free C++ library exposed through ctypes
// (mmmpc_tpu/native), with bit-level parity against the JAX model functions
// asserted in tests/test_native.py.
//
// Conventions mirror mmmpc_tpu/models/* and mmmpc_tpu/sim/kinematic_plant.py:
//   state x = [px, py, psi, dx, dy, dpsi, q1, q2, q3]
//   input u = [dV, dw, dq1, dq2, dq3]
//   plant state (12) = [x_ctrl, y_ctrl, yaw, j1..j7, f1, f2]
//   action (11)      = [v, w, j1..j7 vel, f1, f2 vel]

#include <cmath>
#include <cstring>

namespace {

// DH constants (reference manipulator_3DoF.py:18-22)
constexpr double A2 = 0.316;
constexpr double A3 = 0.0825;
constexpr double A5 = 0.384;
constexpr double A6 = 0.088;
constexpr double A7 = 0.107;

// frame offsets (reference mobile_manipulator.py:14-15)
constexpr double BL2J1_X = -0.007;
constexpr double BL2J1_Z = 0.606 + 0.333;

// geometric-center offset (reference interface:439)
constexpr double CENTER_OFFSET = 0.157;

}  // namespace

extern "C" {

// Arm-frame FK: positions of end point, joint2, joint3 (y == 0).
void mm_arm_fk(const double q[3], double ee[3], double j2[3], double j3[3]) {
  const double q1 = q[0], q2v = q[1], q3v = q[2];
  const double s1 = std::sin(q1), c1 = std::cos(q1);
  const double th = q1 - q2v;
  const double st = std::sin(th), ct = std::cos(th);
  const double be = th - q3v;
  const double sb = std::sin(be), cb = std::cos(be);

  const double x2 = A2 * s1 + A3 * c1;
  const double z2 = A2 * c1 - A3 * s1;
  const double x3 = x2 - A3 * ct + A5 * st;
  const double z3 = z2 + A3 * st + A5 * ct;
  const double xe = x3 + A6 * cb - A7 * sb;
  const double ze = z3 - A6 * sb - A7 * cb;

  j2[0] = x2; j2[1] = 0.0; j2[2] = z2;
  j3[0] = x3; j3[1] = 0.0; j3[2] = z3;
  ee[0] = xe; ee[1] = 0.0; ee[2] = ze;
}

// World-frame whole-body FK (reference mobile_manipulator.py:17-55).
void mm_wholebody_fk(const double x[9], double pose_ee[4], double j2w[3],
                     double j3w[3]) {
  double ee[3], j2[3], j3[3];
  mm_arm_fk(x + 6, ee, j2, j3);
  const double c = std::cos(x[2]), s = std::sin(x[2]);
  const double re = ee[0] + BL2J1_X;
  const double r2 = j2[0] + BL2J1_X;
  const double r3 = j3[0] + BL2J1_X;
  pose_ee[0] = x[0] + re * c;
  pose_ee[1] = x[1] + re * s;
  pose_ee[2] = ee[2] + BL2J1_Z;
  pose_ee[3] = x[2];
  j2w[0] = x[0] + r2 * c; j2w[1] = x[1] + r2 * s; j2w[2] = j2[2] + BL2J1_Z;
  j3w[0] = x[0] + r3 * c; j3w[1] = x[1] + r3 * s; j3w[2] = j3[2] + BL2J1_Z;
}

// Euler step of the whole-body kinematics (reference base.py:17-26 +
// manipulator f_kinematics).
void mm_wholebody_step(const double x[9], const double u[5], double dt,
                       double out[9]) {
  const double psi = x[2], dx = x[3], dy = x[4], dpsi = x[5];
  out[0] = x[0] + dt * dx;
  out[1] = x[1] + dt * dy;
  out[2] = psi + dt * dpsi;
  out[3] = dx + dt * (u[0] * std::cos(psi) - dy * dpsi);
  out[4] = dy + dt * (u[0] * std::sin(psi) + dx * dpsi);
  out[5] = dpsi + dt * u[1];
  for (int i = 0; i < 3; ++i) out[6 + i] = x[6 + i] + dt * u[2 + i];
}

// Kinematic plant step (sim/kinematic_plant.py plant_step): velocity-driven
// unicycle about the control point; commanded v drives the reversed heading.
void mm_plant_step(const double s[12], const double a[11], double dt,
                   double out[12]) {
  const double yaw = s[2];
  const double v_eff = -a[0];
  out[0] = s[0] + dt * v_eff * std::cos(yaw);
  out[1] = s[1] + dt * v_eff * std::sin(yaw);
  out[2] = yaw + dt * a[1];
  for (int i = 3; i < 12; ++i) out[i] = s[i] + dt * a[i - 1];
}

// Plant observation (sim/kinematic_plant.py plant_observation): geometric
// center position, negated control-point velocities.
void mm_plant_observation(const double s[12], const double a[11],
                          double pos[12], double vel[12]) {
  const double yaw = s[2];
  const double cy = std::cos(yaw), sy = std::sin(yaw);
  pos[0] = s[0] - CENTER_OFFSET * cy;
  pos[1] = s[1] - CENTER_OFFSET * sy;
  pos[2] = yaw;
  for (int i = 3; i < 12; ++i) pos[i] = s[i];
  const double v_eff = -a[0];
  vel[0] = -(v_eff * cy);
  vel[1] = -(v_eff * sy);
  vel[2] = a[1];
  for (int i = 3; i < 12; ++i) vel[i] = a[i - 1];
}

// Nearest trajectory row to `point` over selected state indices
// (runtime/reference.py nearest_index; reference interface:353-375).
int mm_nearest_index(const double* traj, int n, int width,
                     const double* point, const int* idx, int nidx) {
  int best = 0;
  double best_d = 1e300;
  for (int i = 0; i < n; ++i) {
    double d = 0.0;
    for (int j = 0; j < nidx; ++j) {
      const double e = traj[i * width + idx[j]] - point[idx[j]];
      d += e * e;
    }
    if (d < best_d) { best_d = d; best = i; }
  }
  return best;
}

// Horizon window with repeat-last padding (runtime/reference.py
// local_ref_traj; reference interface:377-396).  out has (count, width).
void mm_local_ref_window(const double* traj, int n, int width, int min_idx,
                         int count, double* out) {
  for (int k = 0; k < count; ++k) {
    int i = min_idx + k;
    if (i > n - 1) i = n - 1;
    std::memcpy(out + k * width, traj + i * width, width * sizeof(double));
  }
}

// Acceleration-command integration with the sim's reversed-V convention
// (reference interface:473).
void mm_integrate_command(double vel_cmd[2], const double cmd[2],
                          double sim_dt) {
  vel_cmd[0] += sim_dt * cmd[0] * -1.0;
  vel_cmd[1] += sim_dt * cmd[1];
}

}  // extern "C"
