// Backward Riccati recursion of the batched AL-iLQR solver at tall dims
// (32 < n + m <= 64): K2, and K5, K6a, K6b at the same dims, one recursion
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
// a row of fx^T P in registers and factors Quu for itself.  At m = 12 that
// alone passes 255 registers, and n + m > 32 rows do not fit a warp's
// lanes.  Here nothing of size n or m lives in a thread's registers: P, the
// step's intermediates, the factor and the gains live in shared memory,
// [value][kLanes lanes], and each phase of a step hands its output
// elements to the block's threads in turn.
//
// Layout and threads: a block owns kLanes neighbouring lanes (8, 4, 2 or
// 1: RICCATI_TALL_LANES, the most whose state and one step tile fit a
// block's shared memory, chosen by ops/packed_backward.py::riccati_plan)
// and kThreads = min(256 kLanes, 1024) threads.  A phase walks its items
// (an output element of one lane) with the lane fastest, so a thread serves
// one lane throughout (lane = threadIdx.x % kLanes) and a warp reads 32 /
// kLanes neighbouring elements of each lane: neighbouring words.  One step,
// each phase ended by __syncthreads:
//   A1  rows of fx^T P and fu^T P (FTP, [n + m][n]); Qx = gx + fx^T p and
//       Qu = gu + fu^T p; the step's mask (K6a, K6b) kept beside the state;
//   A2  Qxx = gxx + (fx^T P) fx (into PN), Quu = guu + (fu^T P) fu, Qux =
//       gux + (fu^T P) fx; then the tile is free and the last warp issues
//       the copies of the step kDepth on into it (cp.async, a full mbarrier
//       a tile, async_ring.cuh);
//   B   warp w factors lane w's regularized Quu (the mask policy's form) in
//       shared memory: a right-looking Cholesky over its rows, __syncwarp
//       between columns, each element's updates in the plain version's
//       order (k = 0, 1, ...), so it rounds as the left-looking plain
//       version does; the warp keeps the lane's ok;
//   C   a thread a column: column j of Qux (-> K[:, j]) or Qu (-> k) solved
//       in place by forward and back substitution, the gains (mask
//       policy), and column j of Quu_eff K;
//   D   P = Qxx + K^T Quu_eff K + K^T Qux + Qux^T K unsymmetrized (over Qxx
//       in PN), p = Qx + (Quu_eff K)^T k + K^T Qu + Qux^T k;
//   E   P = (PN + PN^T) / 2.
// Every element is formed by the plain version's products; a sum over n
// (phases A1, A2) or over m (Quu_eff K) runs as four interleaved partial
// sums, added pairwise at the end (dot4): four independent chains of
// multiply-adds, and about a quarter of a sequential sum's rounding growth,
// which at (62, 2) in f32 put a sequential kernel at 4 x the plain f32
// version's distance from f64 on an H100 (with dot4, 0.7-1.2 x).  The factor, the solves and the P and p
// updates keep the plain version's order.
// A lane past B computes on the zero-filled tile (a unit regularizer keeps
// its factor finite) and stores nothing.
//
// Shared memory a block: the tiles' mbarriers (16 B), kDepth step tiles
// (riccati::StepTile at kLanes lanes, each padded to 16 B; kDepth 1 or 2,
// as fit), the state (State: P, PN, p, Qx, Quu, Qux, Qu, k and a scratch
// region that holds FTP in phase A, then the factor, K and Quu_eff K:
// 4,992 values a lane at (36, 12)) and the step's mask.  At (36, 12) f32
// 4 lanes and 2 tiles take 196,672 B; (62, 2) and (48, 16) in f64 1 lane.
// Any (n, m) with n + m <= 64 fits 1 lane and 2 tiles in f64.
//
// What bounds it.  At (36, 12), T = 41, B = 4096, f32: a lane's step reads
// its 3,648 inputs and writes 528 outputs (2.7 GB in all, 0.82 ms at
// 3.35 TB/s), and does about 185 k multiply-adds (60 GFLOP, 0.90 ms at 67
// TFLOP/s): about as much bytes as operations.  This design reads both
// operands of every multiply-add from shared memory (one of them a
// broadcast), so a block's pace is its SM's shared-memory bandwidth: about
// 16 multiply-adds a cycle, ten times the operations' bound.  On an H100
// (chip_smoke.py phase 11c) it takes 13.2 ms there, 7% of the bound, and
// 31.5 ms at (48, 16) (2 lanes a block).
//
// Build: a translation unit that defines RICCATI_TALL_LANES, includes this
// header and instantiates RICCATI_FAMILY (riccati_policies.cuh) at one
// (n, m, dtype), written and built at first use by
// iterativelqr_tpu_torch/ops/packed_backward.py; each C entry returns
// cudaGetLastError() (or the attribute call's error).
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
constexpr int kThreads = 256 * kLanes < 1024 ? 256 * kLanes : 1024;
constexpr int kStride = kThreads / kLanes;  // a lane's items a pass of the block
constexpr int kProducers = kWarp;           // the copies' issuers: the last warp
constexpr int kSharedMax = 232448;          // 227 KB: the most a block may use
constexpr int kMaxDepth = 2;
constexpr int kBarBytes = 16;               // the tiles' full mbarriers, padded
static_assert(kThreads / kWarp > kLanes, "a Cholesky warp a lane, and the producer warp after them");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// sum over k < K of term(k) as four interleaved partial sums
// ((s0 + s1) + (s2 + s3))
template <int K, typename T, class Term>
__device__ __forceinline__ T dot4(Term term) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int k = 0;
#pragma unroll 2
  for (; k + 3 < K; k += 4) {
    s0 += term(k);
    s1 += term(k + 1);
    s2 += term(k + 2);
    s3 += term(k + 3);
  }
  for (; k < K; ++k) s0 += term(k);
  return (s0 + s1) + (s2 + s3);
}

// Offsets, in values a lane, of the recursion's state in shared memory
// (after the tiles); value e of a lane sits at [e * kLanes + lane].
template <int N, int M>
struct State {
  static constexpr int P = 0;                // P [N][N], symmetrized
  static constexpr int PN = P + N * N;       // Qxx, then the new P unsymmetrized [N][N]
  static constexpr int PV = PN + N * N;      // p [N]
  static constexpr int QX = PV + N;          // Qx [N]
  static constexpr int QUU = QX + N;         // Quu [M][M]
  static constexpr int QUX = QUU + M * M;    // Qux [M][N]
  static constexpr int QU = QUX + M * N;     // Qu [M]
  static constexpr int KFF = QU + M;         // k [M]
  static constexpr int X = KFF + M;          // scratch: phase A's FTP, then:
  static constexpr int FTP = X;              //   fx^T P, fu^T P [N + M][N]
  static constexpr int LF = X;               //   the factor [M][M] (lower)
  static constexpr int K = LF + M * M;       //   K [M][N]
  static constexpr int QUUK = K + M * N;     //   Quu_eff K [M][N]
  static constexpr int TOTAL = X + cmax((N + M) * N, M * M + 2 * M * N);
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
  constexpr int kDepth = R::kDepth;
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
  // phase B: warp w < kLanes factors lane w's Quu and keeps its ok
  const int warp = tid / kWarp, wl = tid % kWarp;
  const size_t bc = b0 + warp;
  const bool chol = warp < kLanes;
  const T rc = chol && bc < B ? reg[bc] : T(1);
  bool ok = true;
  const bool producer = warp == kThreads / kWarp - 1;
  if (tid == 0) {
    // each copying thread arrives when its copies have landed
    for (int s = 0; s < kDepth; ++s) ring::bar_init(&full[s], kProducers);
    ring::bar_init_fence();
  }
  __syncthreads();

  // the copies of the i-th step of the sweep (t = Tm1-1-i) into tile
  // i % kDepth, by the last warp's 32 threads
  auto fill = [&](int i) {
    const int s = i % kDepth;
    T* tile = tiles + s * R::kTileStride;
    const size_t t = static_cast<size_t>(Tm1 - 1 - i);
    load.template copy<L, kProducers>(tile, t, B, b0, wl, vec);
    mask.template copy<M, kProducers>(tile + L::kF * L::kW, t, wl);
    ring::bar_arrive_on_copies(&full[s]);
  };
  if (producer) {
    for (int i = 0; i < kDepth && i < Tm1; ++i) fill(i);
  }
  T* const sv = state + lane;   // this lane's column: value e at sv[e * kLanes]
#define SH(e) sv[(e) * kLanes]
  for (int e = i0; e < N * N; e += kStride) SH(S::P + e) = live ? gxxT[e * B + b] : T(0);
  for (int e = i0; e < N; e += kStride) SH(S::PV + e) = live ? gxT[e * B + b] : T(0);
  __syncthreads();

  for (int step = 0; step < Tm1; ++step) {
    const size_t t = static_cast<size_t>(Tm1 - 1 - step);
    const int slot = step % kDepth;
    ring::bar_wait(&full[slot], (step / kDepth) & 1);
    const T* const tile = tiles + slot * R::kTileStride;
    const T* const v = tile + lane;   // this lane's column of the tile
#define TL(e) v[(e) * kLanes]

    // A1: row rr of FTP = column rr of fx (rr < N) or of fu (row N + a)
    // times P; Qx (item i < N) and Qu (item N + a)
    if constexpr (Mask::kMasked) {
      for (int a = tid; a < M; a += kThreads) ums[a] = tile[L::kF * L::kW + a];
    }
    for (int e = i0; e < (N + M) * N; e += kStride) {
      const int rr = e / N, j = e % N;
      const int col = rr < N ? L::kFx + rr : L::kFu + (rr - N);
      const int cs = rr < N ? N : M;
      SH(S::FTP + e) = dot4<N, T>([&](int k) { return TL(col + k * cs) * SH(S::P + k * N + j); });
    }
    for (int e = i0; e < N + M; e += kStride) {
      const bool xr = e < N;
      const int col = xr ? L::kFx + e : L::kFu + (e - N);
      const int cs = xr ? N : M;
      const T acc = dot4<N, T>([&](int k) { return TL(col + k * cs) * SH(S::PV + k); });
      if (xr) {
        const T q = TL(L::kGx + e) + acc;
        SH(S::QX + e) = q;
        if (live) out.Qx[(t * N + e) * B + b] = q;
      } else {
        const T q = TL(L::kGu + (e - N)) + acc;
        SH(S::QU + (e - N)) = q;
        if (live) out.Qu[(t * M + (e - N)) * B + b] = q;
      }
    }
    __syncthreads();

    // A2: Qxx (into PN), Quu, Qux
    for (int e = i0; e < N * N + M * M + M * N; e += kStride) {
      if (e < N * N) {
        const int i = e / N, j = e % N;
        const T acc =
            dot4<N, T>([&](int k) { return SH(S::FTP + i * N + k) * TL(L::kFx + k * N + j); });
        SH(S::PN + e) = TL(L::kGxx + e) + acc;
      } else if (e < N * N + M * M) {
        const int q = e - N * N, a = q / M, c = q % M;
        const T acc = dot4<N, T>(
            [&](int k) { return SH(S::FTP + (N + a) * N + k) * TL(L::kFu + k * M + c); });
        SH(S::QUU + q) = TL(L::kGuu + q) + acc;
      } else {
        const int q = e - N * N - M * M, a = q / N, j = q % N;
        const T acc = dot4<N, T>(
            [&](int k) { return SH(S::FTP + (N + a) * N + k) * TL(L::kFx + k * N + j); });
        SH(S::QUX + q) = TL(L::kGux + q) + acc;
      }
    }
#undef TL
    __syncthreads();   // the tile read: the last warp refills it with the step kDepth on
    if (producer && step + kDepth < Tm1) fill(step + kDepth);

    // B: lane `warp`'s regularized Quu factored in place, L L^T
    if (chol) {
      T* const lc = state + warp;   // lane `warp`'s column
#define LF(i, j) lc[(S::LF + (i) * M + (j)) * kLanes]
      for (int e = wl; e < M * M; e += kWarp) {
        const int a = e / M, c = e % M;
        if (c <= a) LF(a, c) = mask.reg_at(ums, lc[(S::QUU + e) * kLanes], rc, a, c);
      }
      __syncwarp();
      for (int j = 0; j < M; ++j) {
        const T d = sqrt(LF(j, j));
        ok = ok && isfinite(d) && (d > T(0));
        __syncwarp();
        if (wl == 0) LF(j, j) = d;
        for (int i = j + 1 + wl; i < M; i += kWarp) LF(i, j) = LF(i, j) / d;
        __syncwarp();
        for (int i = j + 1 + wl; i < M; i += kWarp) {
          const T lij = LF(i, j);
          for (int c = j + 1; c <= i; ++c) LF(i, c) -= lij * LF(c, j);
        }
        __syncwarp();
      }
#undef LF
    }
    __syncthreads();

    // C: column j < N of K from column j of Qux, or k (item N) from Qu,
    // solved in place; then column j of Quu_eff K
    for (int j = i0; j <= N; j += kStride) {
      const bool kc = j < N;
      T* const x = kc ? &SH(S::K + j) : &SH(S::KFF);
      const T* const rhs = kc ? &SH(S::QUX + j) : &SH(S::QU);
      const int xs = (kc ? N : 1) * kLanes;   // from row to row
#define LF(i, k) SH(S::LF + (i) * M + (k))
      for (int i = 0; i < M; ++i) {
        T acc = rhs[i * xs];
        for (int k = 0; k < i; ++k) acc -= LF(i, k) * x[k * xs];
        x[i * xs] = acc / LF(i, i);
      }
      for (int i = M - 1; i >= 0; --i) {
        T acc = x[i * xs];
        for (int k = i + 1; k < M; ++k) acc -= LF(k, i) * x[k * xs];
        x[i * xs] = acc / LF(i, i);
      }
#undef LF
      for (int a = 0; a < M; ++a) {
        const T g = mask.gain_at(ums, -x[a * xs], a);
        x[a * xs] = g;
        if (live) {
          if (kc) {
            out.K[((t * M + a) * N + j) * B + b] = g;
          } else {
            out.k[(t * M + a) * B + b] = g;
          }
        }
      }
      if (kc) {
        for (int a = 0; a < M; ++a) {
          SH(S::QUUK + a * N + j) = dot4<M, T>(
              [&](int c) { return mask.eff_at(ums, SH(S::QUU + a * M + c), r, a, c) * x[c * xs]; });
        }
      }
    }
    __syncthreads();

    // D: the new P, unsymmetrized, over Qxx (items i N + j), and p (items
    // N^2 + i)
    for (int e = i0; e < N * N + N; e += kStride) {
      if (e < N * N) {
        const int i = e / N, j = e % N;
        T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll 4
        for (int a = 0; a < M; ++a) {
          const T ka = SH(S::K + a * N + i);
          t1 += ka * SH(S::QUUK + a * N + j);
          t2 += ka * SH(S::QUX + a * N + j);
          t3 += SH(S::QUX + a * N + i) * SH(S::K + a * N + j);
        }
        SH(S::PN + e) = ((SH(S::PN + e) + t1) + t2) + t3;
      } else {
        const int i = e - N * N;
        T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll 4
        for (int a = 0; a < M; ++a) {
          t1 += SH(S::QUUK + a * N + i) * SH(S::KFF + a);
          t2 += SH(S::K + a * N + i) * SH(S::QU + a);
          t3 += SH(S::QUX + a * N + i) * SH(S::KFF + a);
        }
        const T pn = ((SH(S::QX + i) + t1) + t2) + t3;
        SH(S::PV + i) = pn;
        if (live) out.p[(t * N + i) * B + b] = pn;
      }
    }
    __syncthreads();

    // E: P = (PN + PN^T) / 2
    for (int e = i0; e < N * N; e += kStride) {
      const int i = e / N, j = e % N;
      SH(S::P + e) = T(0.5) * (SH(S::PN + e) + SH(S::PN + j * N + i));
    }
    __syncthreads();
  }
#undef SH
  if (chol && wl == 0 && bc < B) out.ok[bc] = ok ? T(1) : T(0);
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
