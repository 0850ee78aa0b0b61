// Backward Riccati recursion of the batched AL-iLQR solver at tall dims
// (n + m > 32): K2, and K5, K6a, K6b at the same dims, one recursion
// template instantiated with a load policy and a mask policy
// (riccati_policies.cuh, shared with K1's and K2's templates).
//
// Replaces the TPU kernel
// iterativelqr_tpu/ops/packed_backward.py::_kernel_mr_stream (step math:
// _riccati_step), which the JAX package takes once the direct outputs
// overflow VMEM, at any (n, m) whose inputs' chunk fits; with the other
// policies it is K5 (::_kernel), K6a and K6b
// (iterativelqr_tpu/ops/pallas_backward.py::_kernel, _kernel_v2) at these
// dims.  The recursion is K1's and K2's: from P = gxxT, p = gxT, per step
// t = Tm1-1 .. 0 form Qx, Qu, Qxx, Quu, Qux; factor the regularized Quu
// (Cholesky); K = -Quu^-1 Qux, k = -Quu^-1 Qu; symmetrized P update and p
// update; per-lane ok = every pivot finite and > 0.
//
// Why not K2's template: a block of it has a row of threads for each of
// P's and Quu's rows, and every state-row thread holds Quu, its factor and
// a row of fx^T P in registers.  At m = 12 that alone passes 255
// registers, and n + m > 32 rows do not fit a warp's lanes.  Here P, the
// step's intermediates, the factor and the gains live in shared memory,
// [value][kLanes lanes], and each product's sums live in registers.
//
// Layout and threads: a block owns kLanes neighbouring lanes (8, 4, 2 or
// 1: RICCATI_TALL_LANES, the most whose state and one step tile fit a
// block's shared memory, chosen by ops/packed_backward.py::riccati_plan)
// and kThreads = 32 max(8, kLanes + 1) threads.  Value e of the kLanes
// lanes is one vector of kLanes * sizeof(T) bytes (Lanes<T>: 16 B at 4
// lanes in f32).  P is kept with p as its last column ([n][n + 1]), so
// that one product gives fx^T P and fx^T p.
//
// The products (phases A1, A2, Q, D; 96% of a step's multiply-adds at
// (36, 12)) run one body of code whatever the product (Prod: operands and
// output addressed at run time by 32-bit shared-memory offsets), in
// register tiles: a thread owns R x C outputs of every lane of its block
// (Shape, 128 bytes: 4 x 2 at 4 lanes in f32), rows tr + nTR a and
// columns tc + nTC b, so that a warp's threads read neighbouring vectors;
// for each k it loads R + C vectors and makes R C kLanes multiply-adds.
// The sums keep the first design's order, so the outputs are bitwise
// equal to its: a sum over n (A1, A2) or m (Q) as four partial sums over k
// mod 4, the last K mod 4 terms on the first, ((s0 + s1) + (s2 + s3))
// (the first design's dot4; s0 and s1 in one sweep over k, in two
// register tiles, their sum waiting in shared memory at the output's
// place, then s2 and s3); the P update as three sequential sums over m,
// ((Qxx + t1) + t2) + t3.  The factor and the solves keep the plain
// version's order (each element's updates k = 0, 1, ...).
//
// One step, each phase ended by __syncthreads:
//   A1  [fx fu]^T [P p]: fx^T P, fu^T P (FTP, [n + m][n + 1]), its last
//       column fx^T p, fu^T p; the step's mask (K6a, K6b) kept beside the
//       state;
//   A2  Quu = guu + (fu^T P) fu, Qux = gux + (fu^T P) fx, Qxx = gxx +
//       (fx^T P) fx (into PN); Qx = gx + fx^T p, Qu = gu + fu^T p;
//   B   each lane's regularized Quu factored (the mask policy's form) and
//       Quu replaced by the value update's Quu_eff: up to m = kRegsMax by
//       one thread a lane in registers, left-looking; past it by 32
//       threads a lane in shared memory, right-looking, a named barrier
//       between columns; meanwhile the last warps (one for each 4,096
//       copies of a tile) issue the copies of the step kDepth on into the
//       tile A1 and A2 read (cp.async, a full mbarrier a tile,
//       async_ring.cuh);
//   C   a thread a column of a lane: column j of Qux (-> K[:, j]) or Qu
//       (-> k) solved by forward and back substitution (in registers up to
//       m = kRegsMax), and the gains (mask policy);
//   Q   Quu_eff K;
//   D   P = Qxx + K^T Quu_eff K + K^T Qux + Qux^T K unsymmetrized (over Qxx
//       in PN), p = Qx + (Quu_eff K)^T k + K^T Qu + Qux^T k;
//   E   P = (PN + PN^T) / 2.
// A lane past B computes on the zero-filled tile (a unit regularizer keeps
// its factor finite) and stores nothing.
//
// Shared memory a block: the tiles' mbarriers (16 B), kDepth step tiles
// (riccati::StepTile at kLanes lanes, each padded to 16 B; kDepth 1 or 2,
// as fit), the state (State: P and p, PN, Qx, Quu, Qux, Qu, k and a scratch
// region that holds FTP in phase A, then the factor, K and Quu_eff K: 5,004
// values a lane at (36, 12)) and the step's mask.  The range is what one
// lane and one tile fit (riccati_plan).
//
// What bounds it.  At (36, 12), T = 41, B = 4096, f32: a lane's step reads
// its 3,648 inputs and writes 528 outputs (2.7 GB in all, 0.82 ms at
// 3.35 TB/s), and does about 185 k multiply-adds (60 GFLOP, 0.90 ms at 67
// TFLOP/s): about as much bytes as operations.  The first design read both
// operands of every multiply-add from shared memory: 77,407 cycles a step
// a block, 13.3 ms.  This one takes 41,152 cycles, 6.5-6.8 ms (14% of the
// bound; NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py::tall_phase_shares,
// chip_kernel_times.py): A1 and A2 (43% of a step) run at the SM's
// shared-memory rate, as a 16-byte load of a value's four lanes costs
// four wavefronts (0.75 a warp's multiply-add; a larger tile spills), and
// the factor (B, 17.5%) is a chain of dependent operations on one thread a
// lane.  Past m = 16 the factor and the solves on a few threads in shared
// memory hold most of a step (1-2% of the bound at m = 62-70).
//
// Build: a translation unit that defines RICCATI_TALL_LANES, includes this
// header and instantiates RICCATI_FAMILY (riccati_policies.cuh) at one
// (n, m, dtype), written and built at first use by
// iterativelqr_tpu_torch/ops/packed_backward.py; each C entry returns
// cudaGetLastError() (or the attribute call's error).  RICCATI_TALL_CLOCKS
// (a build for measuring only) adds the phase clocks.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_ring.cuh"
#include "riccati_policies.cuh"

namespace {

using riccati::Outputs;

#ifndef RICCATI_TALL_LANES
#error "define RICCATI_TALL_LANES, the lanes a block (8, 4, 2 or 1), before this header"
#endif
constexpr int kLanes = RICCATI_TALL_LANES;  // lanes a block
static_assert(kLanes == 8 || kLanes == 4 || kLanes == 2 || kLanes == 1, "8, 4, 2 or 1 lanes");
constexpr int kWarp = 32;
// a Cholesky warp a lane and at least one more warp to issue the copies,
// and at least 8 warps
constexpr int kThreads = kWarp * (kLanes + 1 > 8 ? kLanes + 1 : 8);
constexpr int kSharedMax = 232448;          // 227 KB: the most a block may use
constexpr int kMaxDepth = 2;
constexpr int kBarBytes = 16;               // the tiles' full mbarriers, padded
constexpr int kRegsMax = 16;                // m up to which phases B and C work in registers
constexpr int kChol = kLanes * kWarp;       // phase B's threads: the first kLanes warps
static_assert(kThreads / kWarp > kLanes, "a Cholesky warp a lane, and a copying warp after them");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Phase clocks, for measuring only (RiccatiPlan(..., clocks=True) defines
// RICCATI_TALL_CLOCKS; no solve's library has them): thread 0 of each block
// reads clock64() at each of a step's barriers and adds the cycles since
// the last one to its phase; the blocks' sums land in tall_clocks.
enum Phase { kWait, kA1, kA2, kB, kC, kQ, kD, kE, kPhases };
#ifdef RICCATI_TALL_CLOCKS
__device__ unsigned long long tall_clocks[kPhases];
#define TALL_STAMP(ph)                                            \
  do {                                                            \
    if (tid == 0) {                                               \
      const long long c_ = clock64();                             \
      clk[ph] += static_cast<unsigned long long>(c_ - clk_last);  \
      clk_last = c_;                                              \
    }                                                             \
  } while (0)
#else
#define TALL_STAMP(ph) \
  do {                 \
  } while (0)
#endif

// one value of the block's kLanes lanes: one vector load or store
template <typename T>
struct alignas(kLanes * sizeof(T) < 16 ? kLanes * sizeof(T) : 16) Lanes {
  T v[kLanes];
};

template <typename T>
__device__ __forceinline__ Lanes<T> ld(const T* p) {
  return *reinterpret_cast<const Lanes<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void st(T* p, const Lanes<T>& x) {
  *reinterpret_cast<Lanes<T>*>(p) = x;
}

// A thread's register tile: R x C outputs of every lane of the block, an
// output a vector of the kLanes lanes (Lanes<T>), 128 bytes a tile (two
// tiles, their operands and offsets unspilled in 255 registers; at 256
// bytes they spilled and ran 1.5 x slower at (36, 12)).  For each k a tile
// loads R + C vectors for R C kLanes multiply-adds.
template <typename T>
struct Shape {
  static constexpr int kValues = 128 / static_cast<int>(sizeof(T)) / kLanes;   // R * C
  static constexpr int R = kValues >= 4 ? 4 : kValues;
  static constexpr int C = kValues / R;
};

// z + a b, lane by lane; a + b
template <typename T>
__device__ __forceinline__ void fma_into(Lanes<T>& z, const Lanes<T>& a, const Lanes<T>& b) {
#pragma unroll
  for (int l = 0; l < kLanes; ++l) z.v[l] += a.v[l] * b.v[l];
}

template <typename T>
__device__ __forceinline__ Lanes<T> plus(const Lanes<T>& a, const Lanes<T>& b) {
  Lanes<T> s;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) s.v[l] = a.v[l] + b.v[l];
  return s;
}

// A product of rows x cols outputs of every lane, its operands and output
// addressed at run time, so that every product of a phase runs one body of
// code (a body a product took instructions from the cache each step, and
// a warp whose tiles fell in two products ran both): A(i, k) at a + i ai
// + k ak, B(k, j) at b + k bk + j bj, out(i, j) at d + i di + j dj, and
// g(i, j), added at the end where g >= 0, at g + i di + j dj.  Offsets in
// values from the block's shared memory (after the mbarriers), strides
// times kLanes: 32-bit shared-memory addresses, as a pointer kept in a
// struct or picked at run time would lose its address space and load
// through the generic path with 64-bit arithmetic.
struct Prod {
  int a, b, d, g, ai, ak, bk, bj, di, dj, rows, cols, ntr, ntc;
};

template <typename T>
__device__ __forceinline__ Prod prod(int a, int ai, int ak, int b, int bk, int bj, int d,
                                     int di, int dj, int g, int rows, int cols) {
  constexpr int R = Shape<T>::R, C = Shape<T>::C;
  return Prod{a, b, d, g, ai * kLanes, ak * kLanes, bk * kLanes, bj * kLanes, di * kLanes,
              dj * kLanes, rows, cols, (rows + R - 1) / R, (cols + C - 1) / C};
}

// thread tiles of a product
__device__ __forceinline__ int tiles_of(const Prod& P) { return P.ntr * P.ntc; }

// x where c, else y, field by field (a select of two structs as a whole
// would be kept in local memory)
__device__ __forceinline__ Prod pick(bool c, const Prod& x, const Prod& y) {
  return Prod{c ? x.a : y.a,       c ? x.b : y.b,       c ? x.d : y.d,       c ? x.g : y.g,
              c ? x.ai : y.ai,     c ? x.ak : y.ak,     c ? x.bk : y.bk,     c ? x.bj : y.bj,
              c ? x.di : y.di,     c ? x.dj : y.dj,     c ? x.rows : y.rows, c ? x.cols : y.cols,
              c ? x.ntr : y.ntr,   c ? x.ntc : y.ntc};
}

// Thread tile t of a product: rows tr + ntr a (a < R) and columns tc +
// ntc b (b < C), clamped into range for the loads; an output is its own
// where both are in range.
template <typename T>
struct Tile {
  static constexpr int R = Shape<T>::R, C = Shape<T>::C;
  int oa[R], ob[C];   // A(i_a, 0), B(0, j_b)
  int od[R], oc[C];   // out(i_a, j_b) at d + od[a] + oc[b] (g likewise)
  bool rok[R], cok[C];
  __device__ __forceinline__ Tile(const Prod& P, int t) {
    const int tr = t / P.ntc, tc = t % P.ntc;
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = cmin(tr + P.ntr * a, P.rows - 1);
      oa[a] = P.a + i * P.ai;
      od[a] = i * P.di;
      rok[a] = tr + P.ntr * a < P.rows;
    }
#pragma unroll
    for (int b = 0; b < C; ++b) {
      const int j = cmin(tc + P.ntc * b, P.cols - 1);
      ob[b] = P.b + j * P.bj;
      oc[b] = j * P.dj;
      cok[b] = tc + P.ntc * b < P.cols;
    }
  }
};

template <typename T, int R, int C>
__device__ __forceinline__ void zero(Lanes<T> (&Z)[R][C]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b) Z[a][b] = Lanes<T>{};
}

// Z += A(i_a, k) B(k, j_b) for one k, the operands at sm + oa[a] + ka and
// sm + ob[b] + kb: R + C loads, R C multiply-adds of each lane
template <typename T, int R, int C>
__device__ __forceinline__ void fma_k(Lanes<T> (&Z)[R][C], const T* sm, const int (&oa)[R],
                                      const int (&ob)[C], int ka, int kb) {
  Lanes<T> Bv[C];
#pragma unroll
  for (int b = 0; b < C; ++b) Bv[b] = ld(sm + ob[b] + kb);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const Lanes<T> Av = ld(sm + oa[a] + ka);
#pragma unroll
    for (int b = 0; b < C; ++b) fma_into<T>(Z[a][b], Av, Bv[b]);
  }
}

template <typename T, int R, int C>
__device__ __forceinline__ void add_into(Lanes<T> (&X)[R][C], const Lanes<T> (&Y)[R][C]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b) X[a][b] = plus<T>(X[a][b], Y[a][b]);
}

// Thread tile q of a product over k < K, summed as dot4 sums: four partial
// sums over k mod 4 (the last K mod 4 terms on the first), ((s0 + s1) +
// (s2 + s3)), then g + that where g is given.  Two register tiles: s0 and
// s1 (X, Y) in one sweep over k, their sum waiting at the output's place,
// then s2 and s3.
template <typename T>
__device__ __forceinline__ void dot4_tile(T* sm, const Prod& P, int q, int K) {
  using G = Tile<T>;
  constexpr int R = G::R, C = G::C;
  const G g(P, q);
  const int K4 = K / 4 * 4;
  Lanes<T> X[R][C], Y[R][C];
#pragma unroll 1
  for (int pair = 0; pair < 2; ++pair) {
    zero<T>(X);
    zero<T>(Y);
#pragma unroll 1
    for (int k = 2 * pair; k < K4; k += 4) {
      fma_k<T>(X, sm, g.oa, g.ob, k * P.ak, k * P.bk);
      fma_k<T>(Y, sm, g.oa, g.ob, (k + 1) * P.ak, (k + 1) * P.bk);
    }
    if (pair == 0) {
#pragma unroll 1
      for (int k = K4; k < K; ++k) fma_k<T>(X, sm, g.oa, g.ob, k * P.ak, k * P.bk);
    }
    add_into<T>(X, Y);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < C; ++b) {
        if (!(g.rok[a] && g.cok[b])) continue;
        const int o = g.od[a] + g.oc[b];
        if (pair == 0) {
          st(sm + P.d + o, X[a][b]);   // s0 + s1
        } else {
          Lanes<T> s = plus<T>(ld(sm + P.d + o), X[a][b]);
          if (P.g >= 0) s = plus<T>(ld(sm + P.g + o), s);
          st(sm + P.d + o, s);
        }
      }
  }
}

// Offsets, in values a lane, of the recursion's state in shared memory
// (after the tiles); value e of a lane sits at [e * kLanes + lane].
template <int N, int M>
struct State {
  static constexpr int N1 = N + 1;
  static constexpr int PP = 0;               // P [N][N + 1], symmetrized, p its last column
  static constexpr int PN = PP + N * N1;     // Qxx, then the new P unsymmetrized [N][N]
  static constexpr int QX = PN + N * N;      // Qx [N]
  static constexpr int QUU = QX + N;         // Quu [M][M]
  static constexpr int QUX = QUU + M * M;    // Qux [M][N]
  static constexpr int QU = QUX + M * N;     // Qu [M]
  static constexpr int KFF = QU + M;         // k [M]
  static constexpr int X = KFF + M;          // scratch: phase A's FTP, then:
  static constexpr int FTP = X;              //   fx^T [P p], fu^T [P p] [N + M][N + 1]
  static constexpr int LF = X;               //   the factor [M][M] (lower)
  static constexpr int K = LF + M * M;       //   K [M][N]
  static constexpr int QUUK = K + M * N;     //   Quu_eff K [M][N]
  static constexpr int TOTAL = X + cmax((N + M) * N1, M * M + 2 * M * N);
};

// The ring: as many tiles (each padded to 16 B) as fit beside the state,
// at most kMaxDepth.
template <int N, int M, typename T, bool kMasked>
struct Ring {
  using Tile = riccati::StepTile<N, M, T, kMasked, kLanes>;
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kTileBytes = (Tile::kValues * kSize + 15) / 16 * 16;
  static constexpr int kTileStride = kTileBytes / kSize;   // values from tile to tile
  // the state of kLanes lanes, then the step's mask (one for the block)
  static constexpr int kStateBytes = (State<N, M>::TOTAL * kLanes + M) * kSize;
  static constexpr int kFit = (kSharedMax - kBarBytes - kStateBytes) / kTileBytes;
  static constexpr int kDepth = kFit > kMaxDepth ? kMaxDepth : kFit;
  static_assert(kDepth >= 1, "one step tile and the state must fit a block's shared memory");
  static constexpr int kBytes = kBarBytes + kDepth * kTileBytes + kStateBytes;
};

template <int N, int M, typename T, class Load, class Mask>
__global__ void __launch_bounds__(kThreads) riccati_tall_kernel(
    Load load, Mask mask, const T* __restrict__ gxxT, const T* __restrict__ gxT,
    const T* __restrict__ reg, Outputs<T> out, int Tm1, int B_int, bool vec) {
  using R = Ring<N, M, T, Mask::kMasked>;
  using L = typename R::Tile;
  using S = State<N, M>;
  constexpr int kDepth = R::kDepth, N1 = S::N1;
  constexpr int kStride = kThreads / kLanes;   // a lane's items a pass of the block
  extern __shared__ __align__(16) unsigned char smem[];
  std::uint64_t* const full = reinterpret_cast<std::uint64_t*>(smem);
  T* const tiles = reinterpret_cast<T*>(smem + kBarBytes);
  T* const state = tiles + kDepth * R::kTileStride;
  T* const ums = state + S::TOTAL * kLanes;   // the step's mask [M], all lanes'
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kLanes;
  const size_t B = static_cast<size_t>(B_int);
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, i0 = tid / kLanes;   // a thread's lane; its first item
  const size_t b = b0 + lane;
  const bool live = b < B;
  const T r = live ? reg[b] : T(1);
  // phase B: the first kLanes warps, 32 threads of each lane (lane fastest);
  // a thread keeps its lane's ok
  const bool chol = tid < kChol;
  bool ok = true;
  const int warp = tid / kWarp, wl = tid % kWarp;
  // The copies' issuers, the last kFillWarps warps: a warp for each 4,096
  // copies of a tile (16 bytes each, or a value each where a lane-run of
  // the block is shorter: 15.8 k at (62, 2) in f32, where one warp issuing
  // them held a step back by a third), among the warps phase B leaves idle
  // (it runs on warp 0 up to m = kRegsMax, on the first kLanes warps past
  // it), so that the issue overlaps the factor
  constexpr int kRun = kLanes * static_cast<int>(sizeof(T));   // a value's bytes, every lane
  constexpr int kCopies = L::kF * (kRun >= 16 ? kRun / 16 : kLanes);
  constexpr int kFillWarps =
      cmin(cmax((kCopies + 4095) / 4096, 1), kThreads / kWarp - (M <= kRegsMax ? 1 : kLanes));
  constexpr int kFill0 = kThreads - kFillWarps * kWarp;
  constexpr int kFillers = kFillWarps * kWarp;
  const bool filler = tid >= kFill0;
  if (tid == 0) {
    // each copying thread arrives when its copies have landed
    for (int s = 0; s < kDepth; ++s) ring::bar_init(&full[s], kFillers);
    ring::bar_init_fence();
  }
  __syncthreads();

  // the copies of the i-th step of the sweep (t = Tm1-1-i) into tile
  // i % kDepth, by the kFillers threads from kFill0 on
  auto fill = [&](int i) {
    const int s = i % kDepth;
    T* tile = tiles + s * R::kTileStride;
    const size_t t = static_cast<size_t>(Tm1 - 1 - i);
    load.template copy<L, kFillers>(tile, t, B, b0, tid - kFill0, vec);
    mask.template copy<M, kFillers>(tile + L::kF * L::kW, t, tid - kFill0);
    ring::bar_arrive_on_copies(&full[s]);
  };
  if (filler) {
    for (int i = 0; i < kDepth && i < Tm1; ++i) fill(i);
  }
#ifdef RICCATI_TALL_CLOCKS
  unsigned long long clk[kPhases] = {};
  long long clk_last = clock64();
#endif
  T* const sv = state + lane;   // this lane's column: value e at sv[e * kLanes]
#define SH(e) sv[(e) * kLanes]
#define V(e) (state + (e) * kLanes)   // value e of every lane
  for (int e = i0; e < N * N; e += kStride)
    SH(S::PP + e / N * N1 + e % N) = live ? gxxT[e * B + b] : T(0);
  for (int e = i0; e < N; e += kStride) SH(S::PP + e * N1 + N) = live ? gxT[e * B + b] : T(0);
  __syncthreads();

  for (int step = 0; step < Tm1; ++step) {
    const size_t t = static_cast<size_t>(Tm1 - 1 - step);
    const int slot = step % kDepth;
    ring::bar_wait(&full[slot], (step / kDepth) & 1);
    TALL_STAMP(kWait);
    const T* const tile = tiles + slot * R::kTileStride;
#define TV(e) (tile + (e) * kLanes)   // value e of the tile, every lane
    // the same as offsets from tiles (32-bit shared addresses, Prod)
    const int to = slot * R::kTileStride;
#define TO(e) (to + (e) * kLanes)
#define SO(e) (kDepth * R::kTileStride + (e) * kLanes)

    // A1: FTP = [fx fu]^T [P p], rows N + M, columns N + 1 (its last one
    // fx^T p, fu^T p); the step's mask kept beside the state
    if constexpr (Mask::kMasked) {
      for (int a = tid; a < M; a += kThreads) ums[a] = tile[L::kF * L::kW + a];
    }
    {
      const Prod px = prod<T>(TO(L::kFx), 1, N, SO(S::PP), N1, 1, SO(S::FTP), N1, 1, -1, N, N1);
      const Prod pu = prod<T>(TO(L::kFu), 1, M, SO(S::PP), N1, 1, SO(S::FTP + N * N1), N1, 1,
                              -1, M, N1);
      const int nx = tiles_of(px);
      for (int q = tid; q < nx + tiles_of(pu); q += kThreads)
        dot4_tile(tiles, pick(q < nx, px, pu), q < nx ? q : q - nx, N);
    }
    __syncthreads();
    TALL_STAMP(kA1);

    // A2: Quu, Qux, Qxx (into PN), each guu, gux or gxx + FTP times fu or fx;
    // Qx = gx + fx^T p and Qu = gu + fu^T p by the last threads
    {
      const Prod puu = prod<T>(SO(S::FTP + N * N1), N1, 1, TO(L::kFu), M, 1, SO(S::QUU), M, 1,
                               TO(L::kGuu), M, M);
      const Prod pux = prod<T>(SO(S::FTP + N * N1), N1, 1, TO(L::kFx), N, 1, SO(S::QUX), N, 1,
                               TO(L::kGux), M, N);
      const Prod pxx = prod<T>(SO(S::FTP), N1, 1, TO(L::kFx), N, 1, SO(S::PN), N, 1,
                               TO(L::kGxx), N, N);
      const int nuu = tiles_of(puu), nux = tiles_of(pux);
      for (int q = tid; q < nuu + nux + tiles_of(pxx); q += kThreads)
        dot4_tile(tiles, pick(q < nuu, puu, pick(q < nuu + nux, pux, pxx)),
                  q < nuu ? q : q < nuu + nux ? q - nuu : q - nuu - nux, N);
      for (int e = kThreads - 1 - tid; e < N + M; e += kThreads) {
        const bool xr = e < N;
        const Lanes<T> s = ld(V(S::FTP + e * N1 + N));
        const Lanes<T> gv = ld(TV(xr ? L::kGx + e : L::kGu + (e - N)));
        Lanes<T> q;
#pragma unroll
        for (int l = 0; l < kLanes; ++l) q.v[l] = gv.v[l] + s.v[l];
        st(V(xr ? S::QX + e : S::QU + (e - N)), q);
        T* const o = xr ? out.Qx + (t * N + e) * B : out.Qu + (t * M + (e - N)) * B;
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
          if (b0 + l < B) o[b0 + l] = q.v[l];
      }
    }
#undef TV
#undef TO
    __syncthreads();   // the tile read: the fillers refill it with the step kDepth on
    TALL_STAMP(kA2);
    if (filler && step + kDepth < Tm1) fill(step + kDepth);

    // B: each lane's regularized Quu factored, L L^T (the factor in the
    // scratch region), and Quu replaced by the value update's Quu_eff (the
    // mask policy's forms): up to m = kRegsMax by one thread a lane in
    // registers, left-looking; past it by 32 threads a lane in shared
    // memory, right-looking, column by column, a named barrier over the
    // first kLanes warps between; each element's updates in the plain
    // version's order either way
    if constexpr (M <= kRegsMax) {
      if (tid < kLanes) {
        T* const lc = state + tid;   // lane tid's column
        T Qreg[M][M], Lf[M][M];
#pragma unroll
        for (int a = 0; a < M; ++a)
#pragma unroll
          for (int c = 0; c < M; ++c) {
            T& q = lc[(S::QUU + a * M + c) * kLanes];
            const T quu = q;
            if (c <= a) Qreg[a][c] = mask.reg_at(ums, quu, r, a, c);
            q = mask.eff_at(ums, quu, r, a, c);
          }
        riccati::cholesky(Qreg, Lf, ok);
#pragma unroll
        for (int a = 0; a < M; ++a)
#pragma unroll
          for (int c = 0; c <= a; ++c) lc[(S::LF + a * M + c) * kLanes] = Lf[a][c];
      }
    } else if (chol) {
      const int lb = tid % kLanes, slot = tid / kLanes;
      T* const lc = state + lb;   // lane lb's column
      const T rc = b0 + lb < B ? reg[b0 + lb] : T(1);
#define LF(i, j) lc[(S::LF + (i) * M + (j)) * kLanes]
      auto chol_sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(kChol) : "memory"); };
      for (int e = slot; e < M * M; e += kWarp) {
        const int a = e / M, c = e % M;
        T& q = lc[(S::QUU + e) * kLanes];
        const T quu = q;
        if (c <= a) LF(a, c) = mask.reg_at(ums, quu, rc, a, c);
        q = mask.eff_at(ums, quu, rc, a, c);
      }
      chol_sync();
      for (int j = 0; j < M; ++j) {
        const T d = sqrt(LF(j, j));
        ok = ok && isfinite(d) && (d > T(0));
        chol_sync();
        for (int i = j + slot; i < M; i += kWarp) LF(i, j) = i == j ? d : LF(i, j) / d;
        chol_sync();
        for (int i = j + 1 + slot; i < M; i += kWarp) {
          const T lij = LF(i, j);
          // eight elements of the row at a time: their loads issue
          // together, where a store before each load would order them
          for (int c0 = j + 1; c0 <= i; c0 += 8) {
            T v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int c = cmin(c0 + u, i);
              v[u] = LF(i, c) - lij * LF(c, j);
            }
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (c0 + u <= i) LF(i, c0 + u) = v[u];
          }
        }
        chol_sync();
      }
#undef LF
    }
    __syncthreads();
    TALL_STAMP(kB);

    // C: column j < N of K from column j of Qux, or k (item N) from Qu, a
    // thread a column of a lane: forward and back substitution (in
    // registers up to m = kRegsMax, past it in shared memory), the gains;
    // then Quu_eff K (register tiles, dot4 sums over m)
#define LF(i, k) SH(S::LF + (i) * M + (k))
    for (int j = i0; j <= N; j += kStride) {
      const bool kc = j < N;
      // row i of the solution at X(i), of the right-hand side at ro + i xs
      const int xo = kc ? S::K + j : S::KFF, ro = kc ? S::QUX + j : S::QU, xs = kc ? N : 1;
#define X(i) SH(xo + (i) * xs)
      auto gains = [&](int a, T x) {
        const T g = mask.gain_at(ums, -x, a);
        X(a) = g;
        if (live) {
          if (kc) {
            out.K[((t * M + a) * N + j) * B + b] = g;
          } else {
            out.k[(t * M + a) * B + b] = g;
          }
        }
      };
      if constexpr (M <= kRegsMax) {
        T x[M];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          T acc = SH(ro + i * xs);
#pragma unroll
          for (int k = 0; k < i; ++k) acc -= LF(i, k) * x[k];
          x[i] = acc / LF(i, i);
        }
#pragma unroll
        for (int i = M - 1; i >= 0; --i) {
          T acc = x[i];
#pragma unroll
          for (int k = i + 1; k < M; ++k) acc -= LF(k, i) * x[k];
          x[i] = acc / LF(i, i);
        }
#pragma unroll
        for (int a = 0; a < M; ++a) gains(a, x[a]);
      } else {
        for (int i = 0; i < M; ++i) {
          T acc = SH(ro + i * xs);
#pragma unroll 4
          for (int k = 0; k < i; ++k) acc -= LF(i, k) * X(k);
          X(i) = acc / LF(i, i);
        }
        for (int i = M - 1; i >= 0; --i) {
          T acc = X(i);
#pragma unroll 4
          for (int k = i + 1; k < M; ++k) acc -= LF(k, i) * X(k);
          X(i) = acc / LF(i, i);
        }
        for (int a = 0; a < M; ++a) gains(a, X(a));
      }
#undef X
    }
#undef LF
    __syncthreads();
    TALL_STAMP(kC);
    {
      const Prod pq = prod<T>(SO(S::QUU), M, 1, SO(S::K), N, 1, SO(S::QUUK), N, 1, -1, M, N);
      for (int q = tid; q < tiles_of(pq); q += kThreads) dot4_tile(tiles, pq, q, M);
    }
    __syncthreads();
    TALL_STAMP(kQ);

    // D: the new P, unsymmetrized, over Qxx in register tiles, t1 = K^T
    // Quu_eff K, t2 = K^T Qux, t3 = Qux^T K each a sequential sum over m,
    // ((Qxx + t1) + t2) + t3; p by the last threads, a thread an element of
    // a lane
    {
      using G = Tile<T>;
      constexpr int RR = G::R, CC = G::C;
      // A(i, a) = K[a][i] (Qux[a][i] in t3), B(a, j) = K[a][j] (Quu_eff K,
      // Qux in t1, t2): offsets from K
      const Prod pd = prod<T>(SO(S::K), 1, N, SO(S::K), N, 1, SO(S::PN), N, 1, -1, N, N);
      for (int q = tid; q < tiles_of(pd); q += kThreads) {
        const G g(pd, q);
        Lanes<T> X[RR][CC], Y[RR][CC];
#pragma unroll 1
        for (int term = 0; term < 3; ++term) {
          const int oa = term == 2 ? (S::QUX - S::K) * kLanes : 0;
          const int ob = term == 0 ? (S::QUUK - S::K) * kLanes
                                   : term == 1 ? (S::QUX - S::K) * kLanes : 0;
          zero<T>(Y);
#pragma unroll 2
          for (int k = 0; k < M; ++k)
            fma_k<T>(Y, tiles, g.oa, g.ob, oa + k * pd.ak, ob + k * pd.bk);
          if (term == 0) {
#pragma unroll
            for (int a = 0; a < RR; ++a)
#pragma unroll
              for (int c = 0; c < CC; ++c)
                X[a][c] = plus<T>(ld(tiles + pd.d + g.od[a] + g.oc[c]), Y[a][c]);
          } else {
            add_into<T>(X, Y);
          }
        }
#pragma unroll
        for (int a = 0; a < RR; ++a)
#pragma unroll
          for (int c = 0; c < CC; ++c)
            if (g.rok[a] && g.cok[c]) st(tiles + pd.d + g.od[a] + g.oc[c], X[a][c]);
      }
      for (int q = kThreads - 1 - tid; q < N * kLanes; q += kThreads) {
        const int i = q / kLanes, l = q % kLanes;
        T* const lv = state + l;
#define SL(e) lv[(e) * kLanes]
        T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll 4
        for (int a = 0; a < M; ++a) {
          t1 += SL(S::QUUK + a * N + i) * SL(S::KFF + a);
          t2 += SL(S::K + a * N + i) * SL(S::QU + a);
          t3 += SL(S::QUX + a * N + i) * SL(S::KFF + a);
        }
        const T pn = ((SL(S::QX + i) + t1) + t2) + t3;
        SL(S::PP + i * N1 + N) = pn;
        if (b0 + l < B) out.p[(t * N + i) * B + b0 + l] = pn;
#undef SL
      }
    }
    __syncthreads();
    TALL_STAMP(kD);

    // E: P = (PN + PN^T) / 2
    for (int e = tid; e < N * N; e += kThreads) {
      const int i = e / N, j = e % N;
      const Lanes<T> x = ld(V(S::PN + e)), y = ld(V(S::PN + j * N + i));
      Lanes<T> z;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) z.v[l] = T(0.5) * (x.v[l] + y.v[l]);
      st(V(S::PP + i * N1 + j), z);
    }
    __syncthreads();
    TALL_STAMP(kE);
  }
#undef SO
#undef V
#undef SH
#ifdef RICCATI_TALL_CLOCKS
  if (tid == 0) {
    for (int ph = 0; ph < kPhases; ++ph) atomicAdd(&tall_clocks[ph], clk[ph]);
  }
#endif
  if (tid < kLanes && b0 + tid < B) out.ok[b0 + tid] = ok ? T(1) : T(0);
}

template <int N, int M, typename T, class Load, class Mask>
int launch(Load load, Mask mask, const void* gxxT, const void* gxT, const void* reg,
           void* K, void* k, void* Qx, void* Qu, void* p, void* ok, int Tm1, int B,
           void* stream) {
  if (B > 0) {
    auto* const kernel = riccati_tall_kernel<N, M, T, Load, Mask>;
    constexpr int bytes = Ring<N, M, T, Mask::kMasked>::kBytes;
    static unsigned long long shared_set = 0;
    const cudaError_t err = ring::allow_shared(kernel, bytes, shared_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (B + kLanes - 1) / kLanes;
    const Outputs<T> out{static_cast<T*>(K), static_cast<T*>(k), static_cast<T*>(Qx),
                         static_cast<T*>(Qu), static_cast<T*>(p), static_cast<T*>(ok)};
    kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        load, mask, static_cast<const T*>(gxxT), static_cast<const T*>(gxT),
        static_cast<const T*>(reg), out, Tm1, B, load.aligned(static_cast<size_t>(B)));
  }
  return static_cast<int>(cudaGetLastError());
}

// the ring of an instantiation: its depth and its dynamic shared memory a
// block
template <int N, int M, typename T, bool kMasked>
int ring_info(int* depth, int* bytes) {
  *depth = Ring<N, M, T, kMasked>::kDepth;
  *bytes = Ring<N, M, T, kMasked>::kBytes;
  return 0;
}

}  // namespace

#ifdef RICCATI_TALL_CLOCKS
// the phases' cycles summed over the blocks of the launches since the last
// reset (tall_clocks), then zeroed where reset
extern "C" int riccati_tall_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tall_clocks, sizeof(tall_clocks));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(tall_clocks, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
