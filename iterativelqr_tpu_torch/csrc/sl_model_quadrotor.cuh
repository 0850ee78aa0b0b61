// Device functions of the quadrotor model
// (iterativelqr_tpu_torch/models/quadrotor.py) for the line-search rollout
// kernels (sl_forward.cu).
//
// Each function repeats the torch function's operations in their order.
// The problem's parameters arrive as doubles in the order of
// models/quadrotor.py::Parameters.flat and are cast to T once per thread, as
// the torch functions cast their float64 constants:
//   prm[0..2] goal position, prm[3..6] rotor thrust lower bounds,
//   prm[7..10] rotor thrust upper bounds.
#pragma once

#include <cuda_runtime.h>

namespace sl_models {

struct Quadrotor {
  static constexpr int NX = 12, NU = 4, NW = 0, NP = 11;
  static constexpr int NC_STAGE = 8, NC_TERM = 12;
  static constexpr int NC = 12;                      // the spec's padded nc
  static constexpr unsigned INEQ_STAGE = 0xFFu;      // all eight thrust bounds
  static constexpr unsigned INEQ_TERM = 0u;          // hover at the goal
  // K3 and K4 stream the step inputs (84 values a step) through the ring
  // (sl_forward.cu)
  static constexpr bool kStream = true;

  static constexpr double MASS = 1.0, GRAVITY = 9.81, ARM = 0.2, KT = 0.02;
  static constexpr double HOVER = MASS * GRAVITY / 4.0;

  // quadrotor_continuous
  template <typename T>
  __device__ static void continuous(const T* x, const T* u, T* f) {
    const T cr = cos(x[3]), sr = sin(x[3]);
    const T cp = cos(x[4]), sp = sin(x[4]);
    const T cy = cos(x[5]), sy = sin(x[5]);
    const T* w = x + 9;

    const T thrust = ((u[0] + u[1]) + u[2]) + u[3];
    // body-z axis in world frame (ZYX Euler)
    const T bz0 = cy * sp * cr + sy * sr;
    const T bz1 = sy * sp * cr - cy * sr;
    const T bz2 = cp * cr;
    const T tm = thrust / T(MASS);

    // torques from rotor layout (x-configuration)
    const T tau0 = T(ARM) * (u[1] - u[3]);
    const T tau1 = T(ARM) * (u[2] - u[0]);
    const T tau2 = T(KT) * (((u[0] - u[1]) + u[2]) - u[3]);
    const T in0 = T(0.01), in1 = T(0.01), in2 = T(0.02);
    const T iw0 = in0 * w[0], iw1 = in1 * w[1], iw2 = in2 * w[2];
    // w x (inertia w), in jnp.cross's order
    const T c0 = w[1] * iw2 - w[2] * iw1;
    const T c1 = w[2] * iw0 - w[0] * iw2;
    const T c2 = w[0] * iw1 - w[1] * iw0;

    // Euler angle kinematics (small-angle-safe form)
    const T tp = tan(x[4]);

    f[0] = x[6];
    f[1] = x[7];
    f[2] = x[8];
    f[3] = w[0] + sr * tp * w[1] + cr * tp * w[2];
    f[4] = cr * w[1] - sr * w[2];
    f[5] = (sr * w[1] + cr * w[2]) / cp;
    f[6] = bz0 * tm - T(0.0);
    f[7] = bz1 * tm - T(0.0);
    f[8] = bz2 * tm - T(GRAVITY);
    f[9] = (tau0 - c0) / in0;
    f[10] = (tau1 - c1) / in1;
    f[11] = (tau2 - c2) / in2;
  }

  // quadrotor_discrete: explicit midpoint (RK2), h = 0.05
  template <typename T>
  __device__ static void dyn(const T* x, const T* u, const T* /*w*/, const T* /*prm*/, T* xn) {
    T f1[NX], xm[NX], f2[NX];
    continuous(x, u, f1);
#pragma unroll
    for (int i = 0; i < NX; ++i) xm[i] = x[i] + T(0.5 * 0.05) * f1[i];
    continuous(xm, u, f2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + T(0.05) * f2[i];
  }

  // x - x_goal, x_goal = (goal, 0, ..., 0)
  template <typename T>
  __device__ static void goal_error(const T* x, const T* prm, T* e) {
#pragma unroll
    for (int i = 0; i < NX; ++i) e[i] = x[i] - (i < 3 ? prm[i] : T(0.0));
  }

  // the dot product of rows [lo, hi) of e with themselves, summed in order
  template <typename T>
  __device__ static T sq(const T* e, int lo, int hi) {
    T acc = T(0);
    for (int i = lo; i < hi; ++i) acc += e[i] * e[i];
    return acc;
  }

  template <typename T>
  __device__ static T stage_cost(const T* x, const T* u, const T* /*w*/, const T* prm) {
    T e[NX], du[NU];
    goal_error(x, prm, e);
#pragma unroll
    for (int a = 0; a < NU; ++a) du[a] = u[a] - T(HOVER);
    return ((T(1.0) * sq(e, 0, 3) + T(0.5) * sq(e, 3, 6))
            + T(0.1) * sq(e, 6, 12)) + T(0.05) * sq(du, 0, NU);
  }

  template <typename T>
  __device__ static T term_cost(const T* x, const T* /*w*/, const T* prm) {
    T e[NX];
    goal_error(x, prm, e);
    return T(1.0) * sq(e, 0, NX);
  }

  template <typename T>
  __device__ static void stage_con(const T* /*x*/, const T* u, const T* /*w*/, const T* prm, T* c) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      c[a] = prm[3 + a] - u[a];
      c[NU + a] = u[a] - prm[7 + a];
    }
  }

  template <typename T>
  __device__ static void term_con(const T* x, const T* /*w*/, const T* prm, T* c) {
    goal_error(x, prm, c);
  }
};

}  // namespace sl_models
