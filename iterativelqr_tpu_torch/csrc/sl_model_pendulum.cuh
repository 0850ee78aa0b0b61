// Device functions of the pendulum model (iterativelqr_tpu_torch/models/
// pendulum.py) for the line-search rollout kernels (sl_forward.cu).
//
// Each function repeats the torch function's operations in their order.  A
// constant that the Python code forms from module floats (MASS * GRAVITY *
// LENGTH) is formed in double here and then cast to T, as torch casts a
// Python float that meets a tensor of type T.
#pragma once

#include <cuda_runtime.h>

namespace sl_models {

namespace pendulum_consts {
constexpr double kM = 1.0, kL = 0.5, kG = 9.81, kD = 0.1;
constexpr double kH = 0.05;                // pendulum_discrete's step
constexpr double kPi = 3.141592653589793;  // math.pi, the goal's angle
}  // namespace pendulum_consts

struct Pendulum {
  static constexpr int NX = 2, NU = 1, NW = 0, NP = 0;
  static constexpr int NC_STAGE = 0, NC_TERM = 2;
  static constexpr int NC = 2;                  // the spec's padded nc
  static constexpr unsigned INEQ_STAGE = 0u, INEQ_TERM = 0u;
  // K3 and K4 load the step inputs in the step: one sin a dynamics call
  // keeps the chain about as short as car's (sl_forward.cu)
  static constexpr bool kStream = false;

  // pendulum_continuous
  template <typename T>
  __device__ static void continuous(const T* x, T u0, T* f) {
    using namespace pendulum_consts;
    f[0] = x[1];
    f[1] = ((u0 - T(kD) * x[1]) - T(kM * kG * kL) * sin(x[0])) / T(kM * (kL * kL));
  }

  // pendulum_discrete: explicit midpoint (RK2)
  template <typename T>
  __device__ static void dyn(const T* x, const T* u, const T* /*w*/, const T* /*prm*/, T* xn) {
    using namespace pendulum_consts;
    T f1[NX], xm[NX], f2[NX];
    continuous(x, u[0], f1);
#pragma unroll
    for (int i = 0; i < NX; ++i) xm[i] = x[i] + T(0.5 * kH) * f1[i];
    continuous(xm, u[0], f2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + T(kH) * f2[i];
  }

  template <typename T>
  __device__ static T stage_cost(const T* x, const T* u, const T* /*w*/, const T* /*prm*/) {
    return T(0.1) * (x[1] * x[1]) + T(0.1) * (u[0] * u[0]);
  }

  template <typename T>
  __device__ static T term_cost(const T* x, const T* /*w*/, const T* /*prm*/) {
    return T(0.1) * (x[1] * x[1]);
  }

  template <typename T>
  __device__ static void stage_con(const T*, const T*, const T*, const T*, T*) {}

  // goal_constraint: x - (pi, 0)
  template <typename T>
  __device__ static void term_con(const T* x, const T* /*w*/, const T* /*prm*/, T* c) {
    c[0] = x[0] - T(pendulum_consts::kPi);
    c[1] = x[1] - T(0);
  }
};

}  // namespace sl_models
