// Device functions of the particle model (iterativelqr_tpu_torch/models/
// particle.py) for the line-search rollout kernels (sl_forward.cu).
//
// Each function repeats the torch function's operations in their order
// (particle_discrete's A x + B u with A = [[1, 1], [0, 1]], B = [0, 1],
// written out).  The problem's parameters arrive as doubles in the order of
// models/particle.py::Parameters.flat and are cast to T once per thread:
//   prm[0..1] the goal.
#pragma once

#include <cuda_runtime.h>

namespace sl_models {

struct Particle {
  static constexpr int NX = 2, NU = 1, NW = 0, NP = 2;
  static constexpr int NC_STAGE = 0, NC_TERM = 2;
  static constexpr int NC = 2;                  // the spec's padded nc
  static constexpr unsigned INEQ_STAGE = 0u, INEQ_TERM = 0u;
  // K3 and K4 load the step inputs in the step: a step is a handful of
  // adds, shorter than car's chain, where the ring's waits and producer
  // warp cost about what they hide (sl_forward.cu)
  static constexpr bool kStream = false;

  // particle_discrete: A x + B u
  template <typename T>
  __device__ static void dyn(const T* x, const T* u, const T* /*w*/, const T* /*prm*/, T* xn) {
    xn[0] = (x[0] + x[1]) + T(0) * u[0];
    xn[1] = (T(0) * x[0] + x[1]) + u[0];
  }

  template <typename T>
  __device__ static T stage_cost(const T* x, const T* u, const T* /*w*/, const T* /*prm*/) {
    return T(0.1) * (x[0] * x[0] + x[1] * x[1]) + T(0.1) * (u[0] * u[0]);
  }

  template <typename T>
  __device__ static T term_cost(const T* x, const T* /*w*/, const T* /*prm*/) {
    return T(0.1) * (x[0] * x[0] + x[1] * x[1]);
  }

  template <typename T>
  __device__ static void stage_con(const T*, const T*, const T*, const T*, T*) {}

  // goal_constraint: x - goal
  template <typename T>
  __device__ static void term_con(const T* x, const T* /*w*/, const T* prm, T* c) {
    c[0] = x[0] - prm[0];
    c[1] = x[1] - prm[1];
  }
};

}  // namespace sl_models
