// Device functions of the cartpole model (iterativelqr_tpu_torch/models/
// cartpole.py) for the line-search rollout kernels (sl_forward.cu).
//
// Each function repeats the torch function's operations in their order.  A
// constant that the Python code forms from module floats (MASS_POLE *
// LENGTH, MASS_CART + MASS_POLE) is formed in double here and then cast to
// T.  The problem's parameters arrive as doubles in the order of
// models/cartpole.py::Parameters.flat and are cast to T once per thread:
//   prm[0] the control limit, prm[1] the shaping weight.
#pragma once

#include <cuda_runtime.h>

namespace sl_models {

namespace cartpole_consts {
constexpr double kMC = 1.0, kMP = 0.2, kL = 0.5, kG = 9.81;
constexpr double kH = 0.05;                // cartpole_discrete's step
constexpr double kPi = 3.141592653589793;  // math.pi
}  // namespace cartpole_consts

struct Cartpole {
  static constexpr int NX = 4, NU = 1, NW = 0, NP = 2;
  static constexpr int NC_STAGE = 2, NC_TERM = 4;
  static constexpr int NC = 4;                  // the spec's padded nc
  static constexpr unsigned INEQ_STAGE = 0x3u;  // both control limits
  static constexpr unsigned INEQ_TERM = 0u;     // the upright goal
  // K3 and K4 stream the step inputs through the ring: a step's two
  // dynamics calls take four sin/cos and four divisions, a chain like
  // acrobot's (sl_forward.cu)
  static constexpr bool kStream = true;

  // cartpole_continuous
  template <typename T>
  __device__ static void continuous(const T* x, T f, T* out) {
    using namespace cartpole_consts;
    const T th = x[1], xd = x[2], thd = x[3];
    const T s = sin(th), c = cos(th);
    const T total = T(kMC + kMP);
    const T tmp = (f + (T(kMP * kL) * (thd * thd)) * s) / total;
    const T thdd = (T(kG) * s - c * tmp) / (T(kL) * (T(4.0 / 3.0) - (T(kMP) * (c * c)) / total));
    const T xdd = tmp - ((T(kMP * kL) * thdd) * c) / total;
    out[0] = xd;
    out[1] = thd;
    out[2] = xdd;
    out[3] = thdd;
  }

  // cartpole_discrete: explicit midpoint (RK2)
  template <typename T>
  __device__ static void dyn(const T* x, const T* u, const T* /*w*/, const T* /*prm*/, T* xn) {
    using namespace cartpole_consts;
    T f1[NX], xm[NX], f2[NX];
    continuous(x, u[0], f1);
#pragma unroll
    for (int i = 0; i < NX; ++i) xm[i] = x[i] + T(0.5 * kH) * f1[i];
    continuous(xm, u[0], f2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + T(kH) * f2[i];
  }

  template <typename T>
  __device__ static T stage_cost(const T* x, const T* u, const T* /*w*/, const T* prm) {
    return ((T(0.01) * (u[0] * u[0]) + T(0.1) * (x[2] * x[2] + x[3] * x[3])) +
            prm[1] * (T(1) + cos(x[1]))) +
           T(0.1) * (x[0] * x[0]);
  }

  template <typename T>
  __device__ static T term_cost(const T* x, const T* /*w*/, const T* /*prm*/) {
    return T(0.1) * (x[2] * x[2] + x[3] * x[3]);
  }

  // -u_limit <= u <= u_limit
  template <typename T>
  __device__ static void stage_con(const T* /*x*/, const T* u, const T* /*w*/, const T* prm, T* c) {
    c[0] = -prm[0] - u[0];
    c[1] = u[0] - prm[0];
  }

  // (x0, sin((theta - pi) / 2), xd, thetad)
  template <typename T>
  __device__ static void term_con(const T* x, const T* /*w*/, const T* /*prm*/, T* c) {
    c[0] = x[0];
    c[1] = sin((x[1] - T(cartpole_consts::kPi)) / T(2));
    c[2] = x[2];
    c[3] = x[3];
  }
};

}  // namespace sl_models
