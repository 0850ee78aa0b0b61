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
// blockIdx.y past 16 candidates).  K4: one thread per lane; its stores of
// xs, us and c coalesce across the warp.  The ragged lane edge is masked.
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
//
// K3's design.  Loading each step's inputs inside the step (up to 10
// __ldg's for acrobot; car and the quadrotor also read duals and penalty)
// puts a full memory latency on every step's chain before its RK2 update,
// with the candidate warps of a block waiting on the same lines at the same
// time.  So a producer warp streams the block's step inputs into a ring of
// tiles in shared memory ([slot][32 lanes], async_ring.cuh) up to kDepth
// steps ahead, and every candidate warp reads them there: one copy a block
// instead of one a candidate warp, and no global load on a step's chain.  A
// tile is 10 slots x 128 B for acrobot in f32 (1.3 KB), 23 for car, 84 for
// the quadrotor (10.8 KB; 21.5 KB in f64); kDepth is as many tiles as fit
// 64 KB, at most 8 (acrobot and car 8, the quadrotor 6 in f32 and 3 in f64).
// A candidate warp waits only when its next tile has not landed, and the
// producer only when a candidate warp still reads the tile it would refill:
// no block barrier a step, so the warps may drift up to kDepth steps apart.
// What is left per step is the RK2 chain itself: the quadrotor, with 84
// values a step to load, gains the most; acrobot, with 10, the least.  K4
// loads its step inputs in the step.
//
// Numerics: the model's device functions (sl_model_*.cuh) repeat the torch
// functions' operations in their order; alpha = 2^-j exactly (ldexp); sin,
// cos and division are the precise ones (the build has no --use_fast_math).
//
// Build: iterativelqr_tpu_torch/_build.py.  Plain C entry points below,
// three per instantiated (model, dtype); the kernels' return
// cudaGetLastError() (or the shared-memory attribute call's error).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "async_ring.cuh"
#include "sl_model_acrobot.cuh"
#include "sl_model_car.cuh"
#include "sl_model_quadrotor.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kMaxCandWarps = 16;
constexpr int kProducerWarps = 1;   // K3: warps that copy the step tiles
constexpr int kProducers = kProducerWarps * kLanes;
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

// K3's tile: one step's inputs for the block's 32 lanes, [slot][32 lanes]:
// xbar_t (NX), ubar_t (NU), K_t (NU*NX), k_t (NU) and, where the model has
// stage constraints, the stage rows of duals_t and penalty_t.  The ring
// holds kDepth tiles, as many as fit kRingBudget (2 to 8).
constexpr int kRingBudget = 64 * 1024;

template <typename M, typename T>
struct ScoreTile {
  static constexpr int kXbar = 0, kUbar = kXbar + M::NX, kK = kUbar + M::NU,
                       kKff = kK + M::NU * M::NX, kDuals = kKff + M::NU,
                       kPen = kDuals + M::NC_STAGE, kSlots = kPen + M::NC_STAGE;
  static constexpr int kValues = kSlots * kLanes;
  static constexpr int kTileBytes = kValues * static_cast<int>(sizeof(T));
  static constexpr int kFit = kRingBudget / kTileBytes;
  static constexpr int kDepth = kFit < 2 ? 2 : (kFit > 8 ? 8 : kFit);
  // the tiles, then each tile's full and empty mbarriers
  static constexpr int kBytes = kDepth * kTileBytes + 2 * kDepth * 8;
};

// control() reading step t's xbar, ubar, K, k from this lane's column v of
// the tile: the same operations in the same order
template <typename M, typename T>
__device__ __forceinline__ void control_tile(const T* x, const T* v, T alpha, T* u) {
  using L = ScoreTile<M, T>;
  T dx[M::NX];
#pragma unroll
  for (int j = 0; j < M::NX; ++j) dx[j] = x[j] - v[(L::kXbar + j) * kLanes];
#pragma unroll
  for (int a = 0; a < M::NU; ++a) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < M::NX; ++j) acc += v[(L::kK + a * M::NX + j) * kLanes] * dx[j];
    u[a] = (v[(L::kUbar + a) * kLanes] + acc) + alpha * v[(L::kKff + a) * kLanes];
  }
}

template <typename M, typename T>
__global__ void __launch_bounds__(kLanes * kMaxCandWarps + kProducers) sl_score_kernel(
    const T* __restrict__ xbar, const T* __restrict__ ubar,
    const T* __restrict__ K, const T* __restrict__ k,
    const T* __restrict__ duals, const T* __restrict__ penalty,
    T* __restrict__ J_out, int horizon, int B_int, int j0, int nb,
    Params params, bool vec) {
  using L = ScoreTile<M, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);
  std::uint64_t* const full = reinterpret_cast<std::uint64_t*>(tiles + L::kDepth * L::kValues);
  std::uint64_t* const empty = full + L::kDepth;
  const int lane = threadIdx.x;
  const int wy = blockDim.y - kProducerWarps;     // candidate warps; then the producers
  const int cand0 = blockIdx.y * wy;
  const int warps = nb - cand0 < wy ? nb - cand0 : wy;   // those with a candidate
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kLanes;
  const size_t B = static_cast<size_t>(B_int);
  const int Tm1 = horizon - 1;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    for (int s = 0; s < L::kDepth; ++s) {
      // full: each producer thread arrives when its copies have landed;
      // empty: each candidate thread once it has read the tile
      ring::bar_init(&full[s], kProducers);
      ring::bar_init(&empty[s], kLanes * warps);
    }
    ring::bar_init_fence();
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.y) >= wy) {
    // the producer warps: step t into tile t % kDepth once every candidate
    // warp has read what the tile held kDepth steps before
    const int tid = (threadIdx.y - wy) * kLanes + lane;
    constexpr int P = kProducers;
    for (int t = 0; t < Tm1; ++t) {
      const int s = t % L::kDepth;
      if (t >= L::kDepth) ring::bar_wait(&empty[s], ((t / L::kDepth) + 1) & 1);
      T* tile = tiles + s * L::kValues;
      const size_t tt = static_cast<size_t>(t);
      ring::copy_rows<M::NX, M::NX, P>(tile + L::kXbar * kLanes, xbar, tt, B, b0, tid, vec);
      ring::copy_rows<M::NU, M::NU, P>(tile + L::kUbar * kLanes, ubar, tt, B, b0, tid, vec);
      ring::copy_rows<M::NU * M::NX, M::NU * M::NX, P>(tile + L::kK * kLanes, K, tt, B, b0, tid,
                                                       vec);
      ring::copy_rows<M::NU, M::NU, P>(tile + L::kKff * kLanes, k, tt, B, b0, tid, vec);
      if constexpr (M::NC_STAGE > 0) {
        ring::copy_rows<M::NC_STAGE, M::NC, P>(tile + L::kDuals * kLanes, duals, tt, B, b0, tid,
                                               vec);
        ring::copy_rows<M::NC_STAGE, M::NC, P>(tile + L::kPen * kLanes, penalty, tt, B, b0, tid,
                                               vec);
      }
      ring::bar_arrive_on_copies(&full[s]);
    }
    ring::wait_all();
    return;
  }
  if (static_cast<int>(threadIdx.y) >= warps) return;   // past the last candidate

  // a candidate warp: a lane past the edge reads the tiles (zeros) and
  // releases them, but computes and stores nothing
  const size_t b = b0 + lane;
  const int cand = cand0 + threadIdx.y;
  const bool live = b < B;

  T prm[at_least_one<M::NP>()];
  load_params<M>(params, prm);
  const T alpha = T(ldexp(1.0, -(j0 + cand)));

  T x[M::NX];
#pragma unroll
  for (int i = 0; i < M::NX; ++i) x[i] = live ? __ldg(xbar + i * B + b) : T(0);
  T J = T(0);

  for (int t = 0; t < Tm1; ++t) {
    const int s = t % L::kDepth;
    ring::bar_wait(&full[s], (t / L::kDepth) & 1);
    if (live) {
      const T* v = tiles + s * L::kValues + lane;
      T u[M::NU];
      control_tile<M>(x, v, alpha, u);
      J += M::stage_cost(x, u, prm);
      if constexpr (M::NC_STAGE > 0) {
        T c[at_least_one<M::NC_STAGE>()], lam[at_least_one<M::NC_STAGE>()],
            rho[at_least_one<M::NC_STAGE>()];
        M::stage_con(x, u, prm, c);
#pragma unroll
        for (int i = 0; i < M::NC_STAGE; ++i) {
          lam[i] = v[(L::kDuals + i) * kLanes];
          rho[i] = v[(L::kPen + i) * kLanes];
        }
        J += al_term<M::NC_STAGE>(c, lam, rho, M::INEQ_STAGE);
      }
      ring::bar_arrive(&empty[s]);
      T xn[M::NX];
      M::dyn(x, u, prm, xn);
#pragma unroll
      for (int i = 0; i < M::NX; ++i) x[i] = xn[i];
    } else {
      ring::bar_arrive(&empty[s]);
    }
  }
  if (!live) return;
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
    auto* const kernel = sl_score_kernel<M, T>;
    constexpr int bytes = ScoreTile<M, T>::kBytes;
    static unsigned long long shared_set = 0;
    const cudaError_t err = ring::allow_shared(kernel, bytes, shared_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t Bs = static_cast<size_t>(B);
    const bool vec = M::NC_STAGE > 0
                         ? ring::runs_aligned<T>(Bs, {xbar, ubar, K, k, duals, penalty})
                         : ring::runs_aligned<T>(Bs, {xbar, ubar, K, k});
    const int wy = nb < kMaxCandWarps ? nb : kMaxCandWarps;
    const dim3 block(kLanes, wy + kProducerWarps);   // candidate warps, then the producers
    const dim3 grid((B + kLanes - 1) / kLanes, (nb + wy - 1) / wy);
    kernel<<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(xbar), static_cast<const T*>(ubar),
        static_cast<const T*>(K), static_cast<const T*>(k),
        static_cast<const T*>(duals), static_cast<const T*>(penalty),
        static_cast<T*>(J), horizon, B, j0, nb, copy_params<M>(params), vec);
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

// C entry points per (model, dtype): sl_score_<name>, sl_reroll_<name> and
// sl_score_ring_<name> (K3's ring depth and shared memory a block), named as ops/sl_forward_kernel.py::_kernel_fn looks
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
  }                                                                            \
  extern "C" int sl_score_ring_##NAME(int* depth, int* bytes) {                \
    *depth = ScoreTile<MODEL, T>::kDepth;                                      \
    *bytes = ScoreTile<MODEL, T>::kBytes;                                      \
    return 0;                                                                  \
  }

SL_ENTRIES(acrobot_f32, sl_models::Acrobot, float)
SL_ENTRIES(acrobot_f64, sl_models::Acrobot, double)
SL_ENTRIES(acrobot_nc0_f32, sl_models::AcrobotNc0, float)
SL_ENTRIES(acrobot_nc0_f64, sl_models::AcrobotNc0, double)
SL_ENTRIES(car_f32, sl_models::Car, float)
SL_ENTRIES(car_f64, sl_models::Car, double)
SL_ENTRIES(quadrotor_f32, sl_models::Quadrotor, float)
SL_ENTRIES(quadrotor_f64, sl_models::Quadrotor, double)
