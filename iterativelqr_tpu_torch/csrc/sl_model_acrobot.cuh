// Device functions of the acrobot model (iterativelqr_tpu_torch/models/
// acrobot.py) for the line-search rollout kernels (sl_forward.cu).
//
// Each function repeats the torch function's operations in their order.  A
// constant that the Python code forms from module floats (a product such as
// MASS2 * LENGTH1 * LENGTHCOM2) is formed in double here and then cast to T,
// as torch casts a Python float that meets a tensor of type T.
#pragma once

#include <cuda_runtime.h>

namespace sl_models {

namespace acrobot_consts {
constexpr double kM1 = 1.0, kM2 = 1.0;
constexpr double kI1 = 0.33, kI2 = 0.33;
constexpr double kL1 = 1.0;
constexpr double kLC1 = 0.5, kLC2 = 0.5;
constexpr double kG = 9.81;
constexpr double kF1 = 0.1, kF2 = 0.1;
constexpr double kH = 0.1;                 // acrobot_discrete's step
constexpr double kPi = 3.141592653589793;  // math.pi, the goal's q1
}  // namespace acrobot_consts

// kGoal: the terminal goal equality x_T = (pi, 0, 0, 0) (4 rows, no
// inequalities); without it the spec has no constraint rows (nc = 0).
// The stage constraint block is empty either way.
template <bool kGoal>
struct AcrobotModel {
  static constexpr int NX = 4, NU = 1, NW = 0, NP = 0;
  static constexpr int NC_STAGE = 0;
  static constexpr int NC_TERM = kGoal ? 4 : 0;
  static constexpr int NC = NC_TERM;            // the spec's padded nc
  static constexpr unsigned INEQ_STAGE = 0u, INEQ_TERM = 0u;
  // K3 and K4 stream the step inputs through the ring (sl_forward.cu)
  static constexpr bool kStream = true;

  // acrobot_continuous
  template <typename T>
  __device__ static void continuous(const T* x, T u0, T* f) {
    using namespace acrobot_consts;
    const T q2 = x[1], v1 = x[2], v2 = x[3];
    const T cq2 = cos(q2);
    const T sq2 = sin(q2);
    const T s1 = sin(x[0]);
    const T s12 = sin(x[0] + q2);
    // mass matrix (c = INERTIA2 is a Python float)
    const T a = T(kI1 + kI2 + kM2 * (kL1 * kL1)) + T(2.0 * kM2 * kL1 * kLC2) * cq2;
    const T b = T(kI2) + T(kM2 * kL1 * kLC2) * cq2;
    const T det = a * T(kI2) - b * b;
    // gravity torque
    const T tau1 = T(-kM1 * kG * kLC1) * s1 - T(kM2 * kG) * (T(kL1) * s1 + T(kLC2) * s12);
    const T tau2 = T(-kM2 * kG * kLC2) * s12;
    // Coriolis
    const T c11 = T(-2.0 * kM2 * kL1 * kLC2) * sq2 * v2;
    const T c12 = T(-kM2 * kL1 * kLC2) * sq2 * v2;
    const T c21 = T(kM2 * kL1 * kLC2) * sq2 * v1;
    const T rhs1 = -(c11 * v1 + c12 * v2) + tau1 - T(kF1) * v1;
    const T rhs2 = -(c21 * v1) + tau2 + u0 - T(kF2) * v2;
    f[0] = v1;
    f[1] = v2;
    f[2] = (T(kI2) * rhs1 - b * rhs2) / det;
    f[3] = (-b * rhs1 + a * rhs2) / det;
  }

  // acrobot_discrete: explicit midpoint (RK2)
  template <typename T>
  __device__ static void dyn(const T* x, const T* u, const T* /*w*/, const T* /*prm*/, T* xn) {
    using namespace acrobot_consts;
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
    return T(0.1) * (x[2] * x[2] + x[3] * x[3]) + T(0.1) * (u[0] * u[0]);
  }

  template <typename T>
  __device__ static T term_cost(const T* x, const T* /*w*/, const T* /*prm*/) {
    return T(0.1) * (x[2] * x[2] + x[3] * x[3]);
  }

  template <typename T>
  __device__ static void stage_con(const T*, const T*, const T*, const T*, T*) {}

  // goal_constraint: x - (pi, 0, 0, 0)
  template <typename T>
  __device__ static void term_con(const T* x, const T* /*w*/, const T* /*prm*/, T* c) {
    c[0] = x[0] - T(acrobot_consts::kPi);
    c[1] = x[1] - T(0);
    c[2] = x[2] - T(0);
    c[3] = x[3] - T(0);
  }
};

using Acrobot = AcrobotModel<true>;
using AcrobotNc0 = AcrobotModel<false>;

}  // namespace sl_models
