// Device functions of the car model (iterativelqr_tpu_torch/models/car.py)
// for the line-search rollout kernels (sl_forward.cu).
//
// Each function repeats the torch function's operations in their order.
// The problem's parameters arrive as doubles in the order of
// models/car.py::Parameters.flat and are cast to T once per thread, as
// the torch functions cast their float64 constants:
//   prm[0..2] goal, prm[3..4] control lower bound, prm[5..6] control upper
//   bound, prm[7..8] obstacle centre, prm[9] obstacle radius squared.
#pragma once

#include <cuda_runtime.h>

namespace sl_models {

struct Car {
  static constexpr int NX = 3, NU = 2, NW = 0, NP = 10;
  static constexpr int NC_STAGE = 5, NC_TERM = 4;
  static constexpr int NC = 5;                       // the spec's padded nc
  static constexpr unsigned INEQ_STAGE = 0x1Fu;      // all five rows
  static constexpr unsigned INEQ_TERM = 1u << 3;     // the obstacle row
  // K3 and K4 load the step inputs in the step: the RK2 chain is short,
  // and the ring's waits and producer warp cost about what they hide
  // (sl_forward.cu)
  static constexpr bool kStream = false;

  // car_continuous
  template <typename T>
  __device__ static void continuous(const T* x, const T* u, T* f) {
    f[0] = u[0] * cos(x[2]);
    f[1] = u[0] * sin(x[2]);
    f[2] = u[1];
  }

  // car_discrete: explicit midpoint (RK2), h = 0.1
  template <typename T>
  __device__ static void dyn(const T* x, const T* u, const T* /*w*/, const T* /*prm*/, T* xn) {
    T f1[NX], xm[NX], f2[NX];
    continuous(x, u, f1);
#pragma unroll
    for (int i = 0; i < NX; ++i) xm[i] = x[i] + T(0.5 * 0.1) * f1[i];
    continuous(xm, u, f2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + T(0.1) * f2[i];
  }

  template <typename T>
  __device__ static T goal_dist_sq(const T* x, const T* prm) {
    const T d0 = x[0] - prm[0], d1 = x[1] - prm[1], d2 = x[2] - prm[2];
    return d0 * d0 + d1 * d1 + d2 * d2;
  }

  // r^2 - |x[:2] - centre|^2 (<= 0 outside the obstacle)
  template <typename T>
  __device__ static T obstacle(const T* x, const T* prm) {
    const T e0 = x[0] - prm[7], e1 = x[1] - prm[8];
    return prm[9] - (e0 * e0 + e1 * e1);
  }

  template <typename T>
  __device__ static T stage_cost(const T* x, const T* u, const T* /*w*/, const T* prm) {
    return goal_dist_sq(x, prm) + T(1.0e-2) * (u[0] * u[0] + u[1] * u[1]);
  }

  template <typename T>
  __device__ static T term_cost(const T* x, const T* /*w*/, const T* prm) {
    return T(1000.0) * goal_dist_sq(x, prm);
  }

  template <typename T>
  __device__ static void stage_con(const T* x, const T* u, const T* /*w*/, const T* prm, T* c) {
    c[0] = prm[3] - u[0];
    c[1] = prm[4] - u[1];
    c[2] = u[0] - prm[5];
    c[3] = u[1] - prm[6];
    c[4] = obstacle(x, prm);
  }

  template <typename T>
  __device__ static void term_con(const T* x, const T* /*w*/, const T* prm, T* c) {
    c[0] = x[0] - prm[0];
    c[1] = x[1] - prm[1];
    c[2] = x[2] - prm[2];
    c[3] = obstacle(x, prm);
  }
};

}  // namespace sl_models
