// The rollout body of the line-search kernels K3 and K4, and their C entry
// macro: included by sl_forward.cu (the hand-written device models of
// sl_model_*.cuh) and by each translation unit of a generated device model
// (ops/device_functions.py, built by _build.py::build_generated).
//
// Line-search rollout kernels of the batched AL-iLQR solver (K3, K4): one
// rollout body, sl_rollout_kernel, instantiated with a score policy (K3)
// and a re-roll policy (K4).
//
// The Score instantiation replaces the TPU kernel
// iterativelqr_tpu/ops/sl_forward_kernel.py::_score_kernel (entry
// make_score_rollout), the Reroll one ::_reroll_kernel (entry
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
// The accumulation order is the plain version's, and both policies run the
// same step code (stage()), so K4's J at alpha = 2^-j is K3's J of candidate
// j: the Armijo choice compares K3's J values and takes K4's re-roll of the
// winner.  A model without stage constraints skips the stage AL term,
// which adds exactly 0 in the plain version.
//
// Layout: batch-last and contiguous, [T, *dims, B], as K1.  threadIdx.x
// walks 32 neighbouring lanes; K3's candidate rides threadIdx.y (and
// blockIdx.y past 16 candidates), K4 has one compute warp.  K4's stores of
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
// Design.  Loading each step's inputs inside the step (up to 10 __ldg's
// for acrobot; car and the quadrotor also read duals and penalty, 84 values
// a step for the quadrotor) puts a memory latency on every step's chain
// before its RK2 update, with K3's candidate warps waiting on the same lines
// at the same time.  So, where the model says so (kStream in its
// sl_model_*.cuh), a producer warp streams the block's step inputs into a
// ring of tiles in shared memory ([slot][32 lanes], async_ring.cuh) up to
// kDepth steps ahead, and every compute warp reads them there: one copy a
// block instead of one a candidate warp, and no global load on a step's
// chain.  A tile is 10 slots x 128 B for acrobot in f32 (1.3 KB), 84 for
// the quadrotor (10.8 KB; 21.5 KB in f64); kDepth is as many tiles as fit
// 64 KB, at most 8 (acrobot 8, the quadrotor 6 in f32 and 3 in f64).  A
// compute warp waits only when its next tile has not landed, and the
// producer only when a compute warp still reads the tile it would refill:
// no block barrier a step, so K3's warps may drift up to kDepth steps
// apart.  What is left per
// step is the RK2 chain itself (a cycle-counter probe of K4 on the H100:
// acrobot's loads took 57 of a step's 1,659 cycles, the quadrotor's 482 of
// 4,679 plus the duals' and penalties' loads).  Whether the ring pays is the
// model's choice, timed both ways on the card: car's short chain gains
// about what the ring's waits and producer warp cost, so car's K3 and K4
// load their step inputs in the step.
//
// Numerics: the model's device functions (sl_model_*.cuh) repeat the torch
// functions' operations in their order; alpha = 2^-j exactly (ldexp); sin,
// cos and division are the precise ones (the build has no --use_fast_math).
//
// Per-step parameters w [T, NW, B] (a model with NW > 0) are a step input
// like the others, in the JAX kernels' order (xbar, ubar, w, K, k, duals,
// penalty: iterativelqr_tpu/ops/sl_forward_kernel.py::_Cfg.step_dims):
// through the ring with kStream, else loaded in the step.  dyn, stage_cost
// and stage_con take w_t; term_cost and term_con take w_T (row T-1).
//
// Build: iterativelqr_tpu_torch/_build.py.  Plain C entry points
// (SL_ENTRIES), three per instantiated (model, dtype); the kernels' return
// cudaGetLastError() (or the shared-memory attribute call's error).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "async_ring.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kMaxCandWarps = 16;
constexpr int kProducerWarps = 1;   // warps that copy the step tiles (the ring)
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

// sum over rows, in row order, of lam c + 1/2 a rho c^2; row i < 64 is an
// inequality where bit i of ineq is set (a model with more rows has none
// past row 63: ops/device_functions.py refuses it)
template <int NROWS, typename T>
__device__ __forceinline__ T al_term(const T* c, const T* lam, const T* rho,
                                     unsigned long long ineq) {
  T total = T(0);
#pragma unroll
  for (int i = 0; i < NROWS; ++i) {
    T quad = T(0.5) * rho[i] * c[i] * c[i];
    const bool row_ineq = i < 64 && ((ineq >> i) & 1ull);
    if (row_ineq && c[i] < T(0) && lam[i] == T(0)) quad = T(0);
    total += lam[i] * c[i] + quad;
  }
  return total;
}

// The step tile of the ring: one step's inputs for the block's 32 lanes,
// [slot][32 lanes]: xbar_t (NX), ubar_t (NU), w_t (NW), K_t (NU*NX), k_t
// (NU) and,
// where the model has stage constraints, the stage rows of duals_t and
// penalty_t.  The ring holds kDepth tiles, as many as fit kRingBudget (2 to
// 8), and 1 where two tiles pass a block's shared memory (the team of three
// quadrotors, (36, 12), in f64: a tile of 546 slots is 139,776 B); a model
// whose one tile passes it loads its step inputs in the step (kRing false),
// whatever its kStream.  tests/test_torch_quadrotor_team.py::_ring_rule
// mirrors the rule.
constexpr int kRingBudget = 64 * 1024;
constexpr int kSharedMax = 232448;   // 227 KB: the most a block may use

template <typename M, typename T>
struct ScoreTile {
  static constexpr int kXbar = 0, kUbar = kXbar + M::NX, kW = kUbar + M::NU,
                       kK = kW + M::NW, kKff = kK + M::NU * M::NX, kDuals = kKff + M::NU,
                       kPen = kDuals + M::NC_STAGE, kSlots = kPen + M::NC_STAGE;
  static constexpr int kValues = kSlots * kLanes;
  static constexpr int kTileBytes = kValues * static_cast<int>(sizeof(T));
  static constexpr int kFit = kRingBudget / kTileBytes;
  // at least two tiles (each with its two mbarriers) where they fit a block
  static constexpr int kFloor = 2 * (kTileBytes + 16) <= kSharedMax ? 2 : 1;
  static constexpr int kDepth = kFit < kFloor ? kFloor : (kFit > 8 ? 8 : kFit);
  // the tiles, then each tile's full and empty mbarriers
  static constexpr int kBytes = kDepth * kTileBytes + 2 * kDepth * 8;
  // the model streams its step inputs, and one tile fits a block
  static constexpr bool kRing = M::kStream && kTileBytes + 16 <= kSharedMax;
};

// The solver's live arrays the rollouts read.
template <typename T>
struct Inputs {
  const T* __restrict__ xbar;
  const T* __restrict__ ubar;
  const T* __restrict__ ws;
  const T* __restrict__ K;
  const T* __restrict__ k;
  const T* __restrict__ duals;
  const T* __restrict__ penalty;
};

// Step t's inputs of one lane, from its column v of a ring tile ...
template <typename M, typename T>
struct TileStep {
  using L = ScoreTile<M, T>;
  const T* v;
  __device__ __forceinline__ T xbar(int j) const { return v[(L::kXbar + j) * kLanes]; }
  __device__ __forceinline__ T ubar(int a) const { return v[(L::kUbar + a) * kLanes]; }
  __device__ __forceinline__ T w(int p) const { return v[(L::kW + p) * kLanes]; }
  __device__ __forceinline__ T K(int a, int j) const { return v[(L::kK + a * M::NX + j) * kLanes]; }
  __device__ __forceinline__ T kff(int a) const { return v[(L::kKff + a) * kLanes]; }
  __device__ __forceinline__ T lam(int i) const { return v[(L::kDuals + i) * kLanes]; }
  __device__ __forceinline__ T rho(int i) const { return v[(L::kPen + i) * kLanes]; }
};

// ... or straight from device memory
template <typename M, typename T>
struct MemStep {
  Inputs<T> in;
  size_t t, b, B;
  __device__ __forceinline__ T xbar(int j) const { return __ldg(in.xbar + (t * M::NX + j) * B + b); }
  __device__ __forceinline__ T ubar(int a) const { return __ldg(in.ubar + (t * M::NU + a) * B + b); }
  __device__ __forceinline__ T w(int p) const { return __ldg(in.ws + (t * M::NW + p) * B + b); }
  __device__ __forceinline__ T K(int a, int j) const {
    return __ldg(in.K + ((t * M::NU + a) * M::NX + j) * B + b);
  }
  __device__ __forceinline__ T kff(int a) const { return __ldg(in.k + (t * M::NU + a) * B + b); }
  __device__ __forceinline__ T lam(int i) const { return __ldg(in.duals + (t * M::NC + i) * B + b); }
  __device__ __forceinline__ T rho(int i) const { return __ldg(in.penalty + (t * M::NC + i) * B + b); }
};

// One rollout step's control and cost: w = w_t, u = ubar_t + K_t (x -
// xbar_t) + alpha k_t, J += g(x, u, w) and, where the model has stage
// constraints, J += the stage AL term of c = c(x, u, w) (left in c)
template <typename M, typename T, class S>
__device__ __forceinline__ void stage(const S& s, const T* x, T alpha, const T* prm, T& J, T* u,
                                      T* w, T* c) {
#pragma unroll
  for (int p = 0; p < M::NW; ++p) w[p] = s.w(p);
  T dx[M::NX];
#pragma unroll
  for (int j = 0; j < M::NX; ++j) dx[j] = x[j] - s.xbar(j);
#pragma unroll
  for (int a = 0; a < M::NU; ++a) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < M::NX; ++j) acc += s.K(a, j) * dx[j];
    u[a] = (s.ubar(a) + acc) + alpha * s.kff(a);
  }
  J += M::stage_cost(x, u, w, prm);
  if constexpr (M::NC_STAGE > 0) {
    T lam[M::NC_STAGE], rho[M::NC_STAGE];
    M::stage_con(x, u, w, prm, c);
#pragma unroll
    for (int i = 0; i < M::NC_STAGE; ++i) {
      lam[i] = s.lam(i);
      rho[i] = s.rho(i);
    }
    J += al_term<M::NC_STAGE>(c, lam, rho, M::INEQ_STAGE);
  }
}

// The score policy (K3): each compute warp a candidate alpha_j = 2^-j,
// j0 <= j < j0+nb (candidate warps ride threadIdx.y, and blockIdx.y past
// kMaxCandWarps); J [nb, B].
template <typename T>
struct Score {
  static constexpr int kMaxWarps = kMaxCandWarps;
  T* __restrict__ J;
  int j0, nb;

  __device__ __forceinline__ int warps(int cand0, int wy) const {
    return nb - cand0 < wy ? nb - cand0 : wy;
  }
  __device__ __forceinline__ T alpha(size_t, int cand) const { return T(ldexp(1.0, -(j0 + cand))); }
  template <typename M>
  __device__ __forceinline__ void step(size_t, size_t, size_t, const T*, const T*, const T*) const {}
  template <typename M>
  __device__ __forceinline__ void finish(size_t, size_t b, size_t B, int cand, const T*, const T*,
                                         T Jb) const {
    J[static_cast<size_t>(cand) * B + b] = Jb;
  }
};

// The re-roll policy (K4): one compute warp at a per-lane alpha [B]; each
// step stores x_t, u_t and c_t (padded rows 0), then x_T, c_T and J.  The
// stores coalesce across the warp and block nothing.
template <typename T>
struct Reroll {
  static constexpr int kMaxWarps = 1;
  const T* __restrict__ alpha_in;
  T* __restrict__ xs;
  T* __restrict__ us;
  T* __restrict__ J;
  T* __restrict__ c;

  __device__ __forceinline__ int warps(int, int) const { return 1; }
  __device__ __forceinline__ T alpha(size_t b, int) const { return alpha_in[b]; }
  template <typename M>
  __device__ __forceinline__ void step(size_t t, size_t b, size_t B, const T* x, const T* u,
                                       const T* cs) const {
#pragma unroll
    for (int i = 0; i < M::NC; ++i) c[(t * M::NC + i) * B + b] = i < M::NC_STAGE ? cs[i] : T(0);
#pragma unroll
    for (int i = 0; i < M::NX; ++i) xs[(t * M::NX + i) * B + b] = x[i];
#pragma unroll
    for (int a = 0; a < M::NU; ++a) us[(t * M::NU + a) * B + b] = u[a];
  }
  template <typename M>
  __device__ __forceinline__ void finish(size_t tT, size_t b, size_t B, int, const T* x,
                                         const T* cT, T Jb) const {
#pragma unroll
    for (int i = 0; i < M::NC; ++i) c[(tT * M::NC + i) * B + b] = i < M::NC_TERM ? cT[i] : T(0);
#pragma unroll
    for (int i = 0; i < M::NX; ++i) xs[(tT * M::NX + i) * B + b] = x[i];
    J[b] = Jb;
  }
};

// The rollout body of K3 and K4: threadIdx.x walks 32 neighbouring lanes;
// compute warp y (threadIdx.y) rolls out at the policy's alpha; where the
// model streams its step inputs (ScoreTile::kRing), a last warp copies them
// into the ring.  The launch bound counts that warp only then: a larger
// bound leaves fewer registers a thread.
template <typename M, typename T, class Pol>
__global__ void __launch_bounds__(kLanes * Pol::kMaxWarps +
                                  (ScoreTile<M, T>::kRing ? kProducers : 0))
    sl_rollout_kernel(
    Inputs<T> in, Pol pol, int horizon, int B_int, Params params, bool vec) {
  using L = ScoreTile<M, T>;
  constexpr bool kRing = L::kRing;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);
  std::uint64_t* const full = reinterpret_cast<std::uint64_t*>(tiles + L::kDepth * L::kValues);
  std::uint64_t* const empty = full + L::kDepth;
  const int lane = threadIdx.x;
  const int wy = blockDim.y - (kRing ? kProducerWarps : 0);   // compute warps; then the producer
  const int cand0 = blockIdx.y * wy;
  const int warps = pol.warps(cand0, wy);                      // those with a rollout
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kLanes;
  const size_t B = static_cast<size_t>(B_int);
  const int Tm1 = horizon - 1;
  if constexpr (kRing) {
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      for (int s = 0; s < L::kDepth; ++s) {
        // full: each producer thread arrives when its copies have landed;
        // empty: each compute thread once it has read the tile
        ring::bar_init(&full[s], kProducers);
        ring::bar_init(&empty[s], kLanes * warps);
      }
      ring::bar_init_fence();
    }
    __syncthreads();

    if (static_cast<int>(threadIdx.y) >= wy) {
      // the producer warp: step t into tile t % kDepth once every compute
      // warp has read what the tile held kDepth steps before
      const int tid = (threadIdx.y - wy) * kLanes + lane;
      constexpr int P = kProducers;
      for (int t = 0; t < Tm1; ++t) {
        const int s = t % L::kDepth;
        if (t >= L::kDepth) ring::bar_wait(&empty[s], ((t / L::kDepth) + 1) & 1);
        T* tile = tiles + s * L::kValues;
        const size_t tt = static_cast<size_t>(t);
        ring::copy_rows<M::NX, M::NX, P>(tile + L::kXbar * kLanes, in.xbar, tt, B, b0, tid, vec);
        ring::copy_rows<M::NU, M::NU, P>(tile + L::kUbar * kLanes, in.ubar, tt, B, b0, tid, vec);
        if constexpr (M::NW > 0)
          ring::copy_rows<M::NW, M::NW, P>(tile + L::kW * kLanes, in.ws, tt, B, b0, tid, vec);
        ring::copy_rows<M::NU * M::NX, M::NU * M::NX, P>(tile + L::kK * kLanes, in.K, tt, B, b0,
                                                         tid, vec);
        ring::copy_rows<M::NU, M::NU, P>(tile + L::kKff * kLanes, in.k, tt, B, b0, tid, vec);
        if constexpr (M::NC_STAGE > 0) {
          ring::copy_rows<M::NC_STAGE, M::NC, P>(tile + L::kDuals * kLanes, in.duals, tt, B, b0,
                                                 tid, vec);
          ring::copy_rows<M::NC_STAGE, M::NC, P>(tile + L::kPen * kLanes, in.penalty, tt, B, b0,
                                                 tid, vec);
        }
        ring::bar_arrive_on_copies(&full[s]);
      }
      ring::wait_all();
      return;
    }
  }
  if (static_cast<int>(threadIdx.y) >= warps) return;   // past the last candidate

  // a compute warp: with the ring, a lane past the edge reads the tiles
  // (zeros) and releases them, but computes and stores nothing
  const size_t b = b0 + lane;
  const int cand = cand0 + threadIdx.y;
  const bool live = b < B;
  if (!kRing && !live) return;

  T prm[at_least_one<M::NP>()];
  load_params<M>(params, prm);
  const T alpha = live ? pol.alpha(b, cand) : T(0);

  T x[M::NX];
#pragma unroll
  for (int i = 0; i < M::NX; ++i) x[i] = live ? __ldg(in.xbar + i * B + b) : T(0);
  T J = T(0);

  for (int t = 0; t < Tm1; ++t) {
    const size_t tt = static_cast<size_t>(t);
    T u[M::NU], w[at_least_one<M::NW>()], c[at_least_one<M::NC_STAGE>()];
    if constexpr (kRing) {
      const int s = t % L::kDepth;
      ring::bar_wait(&full[s], (t / L::kDepth) & 1);
      if (!live) {
        ring::bar_arrive(&empty[s]);
        continue;
      }
      stage<M>(TileStep<M, T>{tiles + s * L::kValues + lane}, x, alpha, prm, J, u, w, c);
      ring::bar_arrive(&empty[s]);
    } else {
      stage<M>(MemStep<M, T>{in, tt, b, B}, x, alpha, prm, J, u, w, c);
    }
    pol.template step<M>(tt, b, B, x, u, c);
    T xn[M::NX];
    M::dyn(x, u, w, prm, xn);
#pragma unroll
    for (int i = 0; i < M::NX; ++i) x[i] = xn[i];
  }
  if (!live) return;
  const size_t tT = static_cast<size_t>(Tm1);
  const MemStep<M, T> last{in, tT, b, B};
  T wT[at_least_one<M::NW>()];
#pragma unroll
  for (int p = 0; p < M::NW; ++p) wT[p] = last.w(p);
  J += M::term_cost(x, wT, prm);
  T c[at_least_one<M::NC_TERM>()];
  if constexpr (M::NC_TERM > 0) {
    T lam[M::NC_TERM], rho[M::NC_TERM];
    M::term_con(x, wT, prm, c);
#pragma unroll
    for (int i = 0; i < M::NC_TERM; ++i) {
      lam[i] = last.lam(i);
      rho[i] = last.rho(i);
    }
    J += al_term<M::NC_TERM>(c, lam, rho, M::INEQ_TERM);
  }
  pol.template finish<M>(tT, b, B, cand, x, c, J);
}

template <typename M>
Params copy_params(const void* params) {
  Params p = {};
  const double* src = static_cast<const double*>(params);
  for (int i = 0; i < M::NP; ++i) p.v[i] = src[i];
  return p;
}

// One launch of the rollout body for nb rollouts a lane (K3: nb candidates;
// K4: 1).  Returns cudaGetLastError() (or the shared-memory attribute
// call's error).
template <typename M, typename T, class Pol>
int launch_rollout(const void* xbar, const void* ubar, const void* ws, const void* K,
                   const void* k, const void* duals, const void* penalty, Pol pol, int nb,
                   int horizon, int B, const void* params, void* stream) {
  static_assert(M::NP <= kMaxParams, "too many model parameters");
  if (B > 0 && nb > 0 && horizon > 0) {
    auto* const kernel = sl_rollout_kernel<M, T, Pol>;
    constexpr bool kRing = ScoreTile<M, T>::kRing;
    constexpr int bytes = kRing ? ScoreTile<M, T>::kBytes : 0;
    static unsigned long long shared_set = 0;
    const cudaError_t err = ring::allow_shared(kernel, bytes, shared_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t Bs = static_cast<size_t>(B);
    // the runs the producer copies: ws only where the model has parameters,
    // duals and penalty only where it has stage constraints
    const bool vec = ring::runs_aligned<T>(Bs, {xbar, ubar, K, k}) &&
                     (M::NW == 0 || ring::runs_aligned<T>(Bs, {ws})) &&
                     (M::NC_STAGE == 0 || ring::runs_aligned<T>(Bs, {duals, penalty}));
    const int wy = nb < Pol::kMaxWarps ? nb : Pol::kMaxWarps;
    // compute warps, then (with the ring) the producer
    const dim3 block(kLanes, wy + (kRing ? kProducerWarps : 0));
    const dim3 grid((B + kLanes - 1) / kLanes, (nb + wy - 1) / wy);
    const Inputs<T> in{static_cast<const T*>(xbar), static_cast<const T*>(ubar),
                       static_cast<const T*>(ws), static_cast<const T*>(K), static_cast<const T*>(k),
                       static_cast<const T*>(duals), static_cast<const T*>(penalty)};
    kernel<<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(
        in, pol, horizon, B, copy_params<M>(params), vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points per (model, dtype): sl_score_<name> (K3), sl_reroll_<name>
// (K4) and sl_ring_<name> (their ring: its depth and shared memory a block,
// 0 and 0 where they load the step inputs in the step), named
// as ops/sl_forward_kernel.py looks them up (<name> =
// <DeviceModel.name>_<f32|f64>).
#define SL_ENTRIES(NAME, MODEL, T)                                             \
  extern "C" int sl_score_##NAME(                                              \
      const void* xbar, const void* ubar, const void* ws, const void* K,       \
      const void* k, const void* duals, const void* penalty, void* J,          \
      int horizon, int B, int j0, int nb, const void* params, void* stream) {  \
    return launch_rollout<MODEL, T>(xbar, ubar, ws, K, k, duals, penalty,      \
                                    Score<T>{static_cast<T*>(J), j0, nb}, nb,  \
                                    horizon, B, params, stream);               \
  }                                                                            \
  extern "C" int sl_reroll_##NAME(                                             \
      const void* alpha, const void* xbar, const void* ubar, const void* ws,   \
      const void* K, const void* k, const void* duals, const void* penalty,    \
      void* xs, void* us, void* J, void* c, int horizon, int B,                \
      const void* params, void* stream) {                                      \
    return launch_rollout<MODEL, T>(                                           \
        xbar, ubar, ws, K, k, duals, penalty,                                  \
        Reroll<T>{static_cast<const T*>(alpha), static_cast<T*>(xs),           \
                  static_cast<T*>(us), static_cast<T*>(J), static_cast<T*>(c)}, \
        1, horizon, B, params, stream);                                        \
  }                                                                            \
  extern "C" int sl_ring_##NAME(int* depth, int* bytes) {                     \
    *depth = ScoreTile<MODEL, T>::kRing ? ScoreTile<MODEL, T>::kDepth : 0;     \
    *bytes = ScoreTile<MODEL, T>::kRing ? ScoreTile<MODEL, T>::kBytes : 0;     \
    return 0;                                                                  \
  }

