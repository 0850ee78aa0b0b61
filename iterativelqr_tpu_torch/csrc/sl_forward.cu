// Line-search rollout kernels of the batched AL-iLQR solver (K3, K4).
//
// sl_score_kernel replaces the TPU kernel
// iterativelqr_tpu/ops/sl_forward_kernel.py::_score_kernel (entry
// make_score_rollout), sl_reroll_kernel replaces ::_reroll_kernel (entry
// make_winner_reroll).  Their plain versions are score_rollout_reference and
// winner_reroll_reference in iterativelqr_tpu_torch/ops/sl_forward_kernel.py.
//
// What they compute, per lane b, from the solver's live arrays:
//   x_0 = xbar_0; for t < T-1:
//     u_t = ubar_t + K_t (x_t - xbar_t) + alpha k_t
//     J += g(x_t, u_t)
//     J += sum over rows of lam c + 1/2 a rho c^2, c = c(x_t, u_t), with
//          a = 0 where the row is an inequality, c < 0 and lam == 0
//     x_{t+1} = f(x_t, u_t)
//   then J += g_T(x_T), and the terminal AL term at u = 0.
// K3 scores nb candidates alpha_j = 2^-j, j0 <= j < j0+nb, and writes
// J [nb, B].  K4 rolls out at a per-lane alpha [B] and writes xs [T,nx,B],
// us [T-1,nu,B], J [B] and c [T,nc,B] (padded constraint rows are zero).
// The accumulation order is the plain version's: the Armijo choice compares
// J values.  A model without stage constraints skips the stage AL term,
// which adds exactly 0 in the plain version.
//
// Layout: batch-last and contiguous, [T, *dims, B], as K1.  K3: threadIdx.x
// walks 32 neighbouring lanes and the candidate rides threadIdx.y (and
// blockIdx.y past 16 candidates), so the warps of a block read the same step
// inputs (L1 serves the repeats) and every load of a warp coalesces.  K4:
// one thread per lane; its stores of xs, us and c coalesce across the warp.
// The ragged lane edge is masked.
//
// What bounds them.  Bytes: K3 reads xbar, ubar, K, k (and the stage duals
// and penalties where the model has stage constraints) once per step and
// lane.  Acrobot T=101, B=4096, f32: 10 floats x 100 steps x 4096 lanes =
// 16.4 MB, plus 0.3 MB of terminal inputs and J, about 5 us at 3.35 TB/s.
// K4 reads the same and writes xs, us and c (908 floats a lane, 14.9 MB):
// about 31 MB, 9.4 us.  Car T=51: 23 floats a step, about 18.8 MB, 5.6 us
// for K3.  Quadrotor T=41: 84 floats a step, about 55 MB, 16 us for K3.
// Operations: each step evaluates the dynamics twice (RK2), and
// acrobot's dynamics take four sin/cos each, so a step is a dependent chain
// of several hundred instructions (chip_smoke.py counts them); 100 dependent
// steps per lane make both kernels latency-bound, far above the byte bound.
// This first design answers that only with K3's candidate warps (8-9 times
// more warps than one thread per lane).  Staging the step inputs in shared
// memory and prefetching them (cp.async, or registers as K1 does) is later
// work.
//
// Numerics: the model's device functions (sl_model_*.cuh) repeat the torch
// functions' operations in their order; alpha = 2^-j exactly (ldexp); sin,
// cos and division are the precise ones (the build has no --use_fast_math).
//
// Build: iterativelqr_tpu_torch/_build.py.  Plain C entry points below, one
// pair per instantiated (model, dtype); each returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "sl_model_acrobot.cuh"
#include "sl_model_car.cuh"
#include "sl_model_quadrotor.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kMaxCandWarps = 16;
constexpr int kMaxParams = 16;   // _MAX_PARAMS in ops/sl_forward_kernel.py

// model parameters, passed by value with the launch
struct Params {
  double v[kMaxParams];
};

// the size of a local array that holds N values (a zero-size array is not
// C++)
template <int N>
__host__ __device__ constexpr int at_least_one() { return N > 0 ? N : 1; }

template <typename M, typename T>
__device__ __forceinline__ void load_params(const Params& p, T* prm) {
#pragma unroll
  for (int i = 0; i < M::NP; ++i) prm[i] = T(p.v[i]);
}

// sum over rows, in row order, of lam c + 1/2 a rho c^2
template <int NROWS, typename T>
__device__ __forceinline__ T al_term(const T* c, const T* lam, const T* rho,
                                     unsigned ineq) {
  T total = T(0);
#pragma unroll
  for (int i = 0; i < NROWS; ++i) {
    T quad = T(0.5) * rho[i] * c[i] * c[i];
    if (((ineq >> i) & 1u) && c[i] < T(0) && lam[i] == T(0)) quad = T(0);
    total += lam[i] * c[i] + quad;
  }
  return total;
}

// rows [0, NROWS) of duals and penalty at step t
template <typename M, int NROWS, typename T>
__device__ __forceinline__ void load_al(const T* __restrict__ duals,
                                        const T* __restrict__ penalty,
                                        size_t t, size_t b, size_t B,
                                        T* lam, T* rho) {
#pragma unroll
  for (int i = 0; i < NROWS; ++i) {
    lam[i] = __ldg(duals + (t * M::NC + i) * B + b);
    rho[i] = __ldg(penalty + (t * M::NC + i) * B + b);
  }
}

// u = ubar_t + K_t (x - xbar_t) + alpha k_t
template <typename M, typename T>
__device__ __forceinline__ void control(
    const T* x, const T* __restrict__ xbar, const T* __restrict__ ubar,
    const T* __restrict__ K, const T* __restrict__ k, size_t t, size_t b,
    size_t B, T alpha, T* u) {
  T dx[M::NX];
#pragma unroll
  for (int j = 0; j < M::NX; ++j) dx[j] = x[j] - __ldg(xbar + (t * M::NX + j) * B + b);
#pragma unroll
  for (int a = 0; a < M::NU; ++a) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < M::NX; ++j)
      acc += __ldg(K + ((t * M::NU + a) * M::NX + j) * B + b) * dx[j];
    u[a] = (__ldg(ubar + (t * M::NU + a) * B + b) + acc)
           + alpha * __ldg(k + (t * M::NU + a) * B + b);
  }
}

template <typename M, typename T>
__global__ void __launch_bounds__(kLanes * kMaxCandWarps) sl_score_kernel(
    const T* __restrict__ xbar, const T* __restrict__ ubar,
    const T* __restrict__ K, const T* __restrict__ k,
    const T* __restrict__ duals, const T* __restrict__ penalty,
    T* __restrict__ J_out, int horizon, int B_int, int j0, int nb,
    Params params) {
  const size_t b = static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x;
  const int cand = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t B = static_cast<size_t>(B_int);
  if (b >= B || cand >= nb) return;
  const int Tm1 = horizon - 1;

  T prm[at_least_one<M::NP>()];
  load_params<M>(params, prm);
  const T alpha = T(ldexp(1.0, -(j0 + cand)));

  T x[M::NX];
#pragma unroll
  for (int i = 0; i < M::NX; ++i) x[i] = __ldg(xbar + i * B + b);
  T J = T(0);
  for (int t = 0; t < Tm1; ++t) {
    const size_t tt = static_cast<size_t>(t);
    T u[M::NU];
    control<M>(x, xbar, ubar, K, k, tt, b, B, alpha, u);
    J += M::stage_cost(x, u, prm);
    if constexpr (M::NC_STAGE > 0) {
      T c[at_least_one<M::NC_STAGE>()], lam[at_least_one<M::NC_STAGE>()],
          rho[at_least_one<M::NC_STAGE>()];
      M::stage_con(x, u, prm, c);
      load_al<M, M::NC_STAGE>(duals, penalty, tt, b, B, lam, rho);
      J += al_term<M::NC_STAGE>(c, lam, rho, M::INEQ_STAGE);
    }
    T xn[M::NX];
    M::dyn(x, u, prm, xn);
#pragma unroll
    for (int i = 0; i < M::NX; ++i) x[i] = xn[i];
  }
  J += M::term_cost(x, prm);
  if constexpr (M::NC_TERM > 0) {
    T c[at_least_one<M::NC_TERM>()], lam[at_least_one<M::NC_TERM>()],
        rho[at_least_one<M::NC_TERM>()];
    M::term_con(x, prm, c);
    load_al<M, M::NC_TERM>(duals, penalty, static_cast<size_t>(Tm1), b, B, lam, rho);
    J += al_term<M::NC_TERM>(c, lam, rho, M::INEQ_TERM);
  }
  J_out[static_cast<size_t>(cand) * B + b] = J;
}

template <typename M, typename T>
__global__ void __launch_bounds__(kLanes) sl_reroll_kernel(
    const T* __restrict__ alpha_in, const T* __restrict__ xbar,
    const T* __restrict__ ubar, const T* __restrict__ K,
    const T* __restrict__ k, const T* __restrict__ duals,
    const T* __restrict__ penalty, T* __restrict__ xs, T* __restrict__ us,
    T* __restrict__ J_out, T* __restrict__ c_out, int horizon, int B_int,
    Params params) {
  const size_t b = static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x;
  const size_t B = static_cast<size_t>(B_int);
  if (b >= B) return;
  const int Tm1 = horizon - 1;

  T prm[at_least_one<M::NP>()];
  load_params<M>(params, prm);
  const T alpha = alpha_in[b];

  T x[M::NX];
#pragma unroll
  for (int i = 0; i < M::NX; ++i) x[i] = __ldg(xbar + i * B + b);
  T J = T(0);
  for (int t = 0; t < Tm1; ++t) {
    const size_t tt = static_cast<size_t>(t);
    T u[M::NU];
    control<M>(x, xbar, ubar, K, k, tt, b, B, alpha, u);
    J += M::stage_cost(x, u, prm);
    T c[at_least_one<M::NC_STAGE>()];
    if constexpr (M::NC_STAGE > 0) {
      T lam[M::NC_STAGE], rho[M::NC_STAGE];
      M::stage_con(x, u, prm, c);
      load_al<M, M::NC_STAGE>(duals, penalty, tt, b, B, lam, rho);
      J += al_term<M::NC_STAGE>(c, lam, rho, M::INEQ_STAGE);
    }
#pragma unroll
    for (int i = 0; i < M::NC; ++i)
      c_out[(tt * M::NC + i) * B + b] = i < M::NC_STAGE ? c[i] : T(0);
#pragma unroll
    for (int i = 0; i < M::NX; ++i) xs[(tt * M::NX + i) * B + b] = x[i];
#pragma unroll
    for (int a = 0; a < M::NU; ++a) us[(tt * M::NU + a) * B + b] = u[a];
    T xn[M::NX];
    M::dyn(x, u, prm, xn);
#pragma unroll
    for (int i = 0; i < M::NX; ++i) x[i] = xn[i];
  }
  const size_t tT = static_cast<size_t>(Tm1);
  J += M::term_cost(x, prm);
  T c[at_least_one<M::NC_TERM>()];
  if constexpr (M::NC_TERM > 0) {
    T lam[M::NC_TERM], rho[M::NC_TERM];
    M::term_con(x, prm, c);
    load_al<M, M::NC_TERM>(duals, penalty, tT, b, B, lam, rho);
    J += al_term<M::NC_TERM>(c, lam, rho, M::INEQ_TERM);
  }
#pragma unroll
  for (int i = 0; i < M::NC; ++i)
    c_out[(tT * M::NC + i) * B + b] = i < M::NC_TERM ? c[i] : T(0);
#pragma unroll
  for (int i = 0; i < M::NX; ++i) xs[(tT * M::NX + i) * B + b] = x[i];
  J_out[b] = J;
}

template <typename M>
Params copy_params(const void* params) {
  Params p = {};
  const double* src = static_cast<const double*>(params);
  for (int i = 0; i < M::NP; ++i) p.v[i] = src[i];
  return p;
}

template <typename M, typename T>
int launch_score(const void* xbar, const void* ubar, const void* K,
                 const void* k, const void* duals, const void* penalty,
                 void* J, int horizon, int B, int j0, int nb,
                 const void* params, void* stream) {
  static_assert(M::NP <= kMaxParams, "too many model parameters");
  if (B > 0 && nb > 0 && horizon > 0) {
    const int wy = nb < kMaxCandWarps ? nb : kMaxCandWarps;
    const dim3 block(kLanes, wy);
    const dim3 grid((B + kLanes - 1) / kLanes, (nb + wy - 1) / wy);
    sl_score_kernel<M, T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(xbar), static_cast<const T*>(ubar),
        static_cast<const T*>(K), static_cast<const T*>(k),
        static_cast<const T*>(duals), static_cast<const T*>(penalty),
        static_cast<T*>(J), horizon, B, j0, nb, copy_params<M>(params));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename M, typename T>
int launch_reroll(const void* alpha, const void* xbar, const void* ubar,
                  const void* K, const void* k, const void* duals,
                  const void* penalty, void* xs, void* us, void* J, void* c,
                  int horizon, int B, const void* params, void* stream) {
  static_assert(M::NP <= kMaxParams, "too many model parameters");
  if (B > 0 && horizon > 0) {
    const int blocks = (B + kLanes - 1) / kLanes;
    sl_reroll_kernel<M, T><<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(alpha), static_cast<const T*>(xbar),
        static_cast<const T*>(ubar), static_cast<const T*>(K),
        static_cast<const T*>(k), static_cast<const T*>(duals),
        static_cast<const T*>(penalty), static_cast<T*>(xs),
        static_cast<T*>(us), static_cast<T*>(J), static_cast<T*>(c),
        horizon, B, copy_params<M>(params));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One pair of C entry points per (model, dtype): sl_score_<name> and
// sl_reroll_<name>, named as ops/sl_forward_kernel.py::_kernel_fn looks
// them up (<name> = <DeviceModel.name>_<f32|f64>).
#define SL_ENTRIES(NAME, MODEL, T)                                             \
  extern "C" int sl_score_##NAME(                                              \
      const void* xbar, const void* ubar, const void* K, const void* k,        \
      const void* duals, const void* penalty, void* J, int horizon, int B,     \
      int j0, int nb, const void* params, void* stream) {                      \
    return launch_score<MODEL, T>(xbar, ubar, K, k, duals, penalty, J,         \
                                  horizon, B, j0, nb, params, stream);         \
  }                                                                            \
  extern "C" int sl_reroll_##NAME(                                             \
      const void* alpha, const void* xbar, const void* ubar, const void* K,    \
      const void* k, const void* duals, const void* penalty, void* xs,         \
      void* us, void* J, void* c, int horizon, int B, const void* params,      \
      void* stream) {                                                          \
    return launch_reroll<MODEL, T>(alpha, xbar, ubar, K, k, duals, penalty,    \
                                   xs, us, J, c, horizon, B, params, stream);  \
  }

SL_ENTRIES(acrobot_f32, sl_models::Acrobot, float)
SL_ENTRIES(acrobot_f64, sl_models::Acrobot, double)
SL_ENTRIES(acrobot_nc0_f32, sl_models::AcrobotNc0, float)
SL_ENTRIES(acrobot_nc0_f64, sl_models::AcrobotNc0, double)
SL_ENTRIES(car_f32, sl_models::Car, float)
SL_ENTRIES(car_f64, sl_models::Car, double)
SL_ENTRIES(quadrotor_f32, sl_models::Quadrotor, float)
SL_ENTRIES(quadrotor_f64, sl_models::Quadrotor, double)
