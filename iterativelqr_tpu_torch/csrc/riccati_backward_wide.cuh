// Backward Riccati recursion of the batched AL-iLQR solver at wide dims: K2,
// and K5, K6a, K6b at the same dims, one recursion template instantiated
// with a load policy and a mask policy (riccati_policies.cuh, shared with
// K1's template in riccati_backward.cuh).
//
// Replaces the TPU kernel
// iterativelqr_tpu/ops/packed_backward.py::_kernel_mr_stream (step math:
// _riccati_step), which the JAX package takes over _kernel_mr when the
// direct outputs overflow VMEM: the quadrotor's n=12, m=4.  It computes the
// same recursion as K1: start from P = gxxT, p = gxT; per step
// t = Tm1-1 .. 0 form Qx, Qu, Qxx, Quu, Qux; factor the regularized Quu with
// an unrolled Cholesky; K = -Quu^-1 Qux, k = -Quu^-1 Qu; symmetrized P update
// and p update; per-lane ok = every Cholesky pivot finite and > 0.  The TPU
// kernel's chunked DMA, packed output buffer and output streaming have no
// counterpart here: the outputs go straight to device memory as the five
// batch-last arrays K1 writes.  The same template, with K1's other
// policies, is K5 (packed buffer), K6a (step mask) and K6b (packed, the mask
// in v2's order) at these dims: the JAX package runs those TPU kernels at
// any (n, m) (iterativelqr_tpu/ops/packed_backward.py::_kernel,
// ops/pallas_backward.py::_kernel, _kernel_v2).
//
// Why not K1's design: K1's team of 4 threads a lane holds P, one step's
// inputs and its temporaries in registers.  At (12, 4) that is about 1,000
// live values a lane (ops/packed_backward.py::riccati_plan states the
// rule), so P, the step's inputs and the shared intermediates live in
// shared memory, [value][kLanes lanes].
//
// Layout and threads: a block owns kLanes neighbouring lanes (32; 16, 8 or
// 4 where 32 lanes' state and one step tile pass a block's shared memory:
// RICCATI_WIDE_LANES, chosen by riccati_plan) and has a row of kLanes
// threads for each of P's N rows and each of the M control rows (row =
// threadIdx.x / kLanes, lane = threadIdx.x % kLanes).  With fewer than 32
// lanes a warp holds 32 / kLanes rows; the state rows and the control rows
// are each padded to whole warps (idle padding rows), so every barrier is
// met by whole warps.  At 32 lanes a row is a warp and nothing is padded.
// Rows 0..N-1 (the state rows) own a row of fx^T P, Qxx and the new P and a
// column of K and Quu K; the control rows (from the first row of the warp
// after the state rows) own a row of fu^T P, Quu and Qux.  The steps'
// inputs (416 values a lane at
// (12, 4)) stream into a ring of kDepth tiles with cp.async (async_ring.cuh:
// a full mbarrier a tile, 16-byte chunks where every run is 16-byte
// aligned, else one value a copy), so the loads leave the step's chain.  The
// copies are issued by the last warp (control rows), which has nothing else
// to do once phase A is done: right after barrier B1 (by which every warp
// has read the step's tile) it refills that tile with the step kDepth on,
// while the state warps run phases B to E.  So the block needs no producer
// warp of its own and no empty mbarriers, and 512 threads a block at
// (12, 4) leave 128 registers a thread.  A step, with named barriers
// (bar.sync id, count) so that only the warps that exchange values wait:
//   A  state row i: Qx_i, row i of fx^T P (registers) and of Qxx (shared
//      memory); control row a: Qu_a, row a of fu^T P, Quu, Qux (shared);
//   B1 (all warps): Quu, Qux, Qu visible, the tile read;
//   B  every state warp and the first control warp: the mask policy's Quu
//      forms and their Cholesky, redundantly in registers (no barrier);
//      state row j solves column j of K and forms column j of Quu K, the
//      first control row solves k and keeps ok;
//   B2 (state warps and the first control warp): K, Quu K, k visible;
//   D  state row i: row i of the unsymmetrized new P (over Qxx's row) and
//      p_i;
//   B3 (state warps): the new P's rows visible;
//   E  state row i: row i of (P + P^T) / 2 into the P buffer;
//   B4 (all warps): P and p visible for the next step.
// Four barriers a step, two of them block-wide (the design before took six
// __syncthreads a step, and staged each step only after the previous one:
// a cycle-counter probe on the H100 put 60% of its step in those loads).
// Every element is formed by the operations of the plain version in its
// order.  f32 stays on the CUDA cores: the tensor cores compute f32 only as
// TF32, which the port's numerics forbid (f32 matmuls at full precision).
//
// What bounds it.  Bytes: per step and lane it reads 416 inputs and writes
// 80 outputs (K 48, k 4, Qx 12, Qu 4, p 12), plus 158 values of gxxT, gxT,
// reg and ok a lane: at T=41 (40 steps), B=4096 in f32 that is
// (40*496 + 158) * 4096 * 4 B = 328 MB, about 0.098 ms at 3.35 TB/s.
// Operations: about 13 k a step and lane, 2.1 G in all, about 0.03 ms at
// 67 TFLOP/s: bytes bound.  With one block of 32 lanes an SM, what sets the
// pace is each step's arithmetic on operands read from shared memory (an
// FMA of phase A reads one operand there).
//
// Shared memory a block: kDepth tiles, the state (P, its unsymmetrized
// successor, p, Quu, Qux, Qu, K, k, Quu K: 468 values a lane at (12, 4)) and
// the tiles' mbarriers.  In f32 three tiles fit (219,672 B; a tile is
// 53,248 B); in f64 only one (226,312 B): f64 is the tests' dtype, not the
// solve's, so it keeps 32 lanes a block and a ring of depth 1 (the next
// step's copies still land while the state warps run phases B to E).
// Where not even one tile fits beside 32 lanes' state ((13, 4) in f64,
// (24, 8) in either dtype), a block takes 16, 8 or 4 lanes: the state and
// the tiles shrink with the lanes, and the block's rows stay.
//
// Build: a translation unit that defines RICCATI_WIDE_LANES, includes this
// header and instantiates RICCATI_FAMILY (riccati_policies.cuh) at one
// (n, m, dtype), written and built at first use by
// iterativelqr_tpu_torch/ops/packed_backward.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC,
// _build.py::build_generated); each C entry returns cudaGetLastError() (or
// the attribute call's error).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_ring.cuh"
#include "riccati_policies.cuh"

namespace {

using riccati::Outputs;

#ifndef RICCATI_WIDE_LANES
#error "define RICCATI_WIDE_LANES, the lanes a block (32, 16, 8 or 4), before this header"
#endif
constexpr int kLanes = RICCATI_WIDE_LANES;  // lanes a block
static_assert(kLanes == 32 || kLanes == 16 || kLanes == 8 || kLanes == 4,
              "a warp holds whole rows");
constexpr int kWarp = 32;
constexpr int kRowsPerWarp = kWarp / kLanes;
constexpr int kProducers = kWarp;           // the copies' issuers: one warp
constexpr int kSharedMax = 232448;          // 227 KB: the most a block may use
constexpr int kMaxDepth = 3;

// rows padded to whole warps
__host__ __device__ constexpr int whole_warps(int rows) {
  return (rows + kRowsPerWarp - 1) / kRowsPerWarp * kRowsPerWarp;
}

// the block: the N state rows and the M control rows, each padded to whole
// warps, of kLanes threads each
template <int N, int M>
__host__ __device__ constexpr int block_threads() {
  return kLanes * (whole_warps(N) + whole_warps(M));
}

// Offsets, in values a lane, of the recursion's state in shared memory
// (after the tiles); value e of a lane sits at [e * kLanes + lane].
template <int N, int M>
struct State {
  static constexpr int P = 0;                // P [N][N], symmetrized
  static constexpr int PN = P + N * N;       // the new P [N][N], unsymmetrized
  static constexpr int PV = PN + N * N;      // p [N]
  static constexpr int QUU = PV + N;         // Quu [M][M]
  static constexpr int QUX = QUU + M * M;    // Qux [M][N]
  static constexpr int QU = QUX + M * N;     // Qu [M]
  static constexpr int K = QU + M;           // K [M][N]
  static constexpr int KFF = K + M * N;      // k [M]
  static constexpr int QUUK = KFF + M;       // Quu K [M][N]
  static constexpr int TOTAL = QUUK + M * N;
};

// The ring: as many tiles as fit beside the state, at most kMaxDepth.
template <int N, int M, typename T, bool kMasked>
struct Ring {
  using Tile = riccati::StepTile<N, M, T, kMasked, kLanes>;
  static constexpr int kTileBytes = Tile::kValues * static_cast<int>(sizeof(T));
  static constexpr int kStateBytes = State<N, M>::TOTAL * kLanes * static_cast<int>(sizeof(T));
  static constexpr int kFit = (kSharedMax - kStateBytes) / (kTileBytes + 8);
  static constexpr int kDepth = kFit > kMaxDepth ? kMaxDepth : kFit;
  static_assert(kDepth >= 1, "one step tile and the state must fit a block's shared memory");
  // the tiles, the state, then each tile's full mbarrier
  static constexpr int kBytes = kDepth * kTileBytes + kStateBytes + kDepth * 8;
};

// bar.sync on named barrier `id` by `count` threads (whole warps)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

template <int N, int M, typename T, class Load, class Mask>
__global__ void __launch_bounds__(block_threads<N, M>()) riccati_wide_kernel(
    Load load, Mask mask, const T* __restrict__ gxxT, const T* __restrict__ gxT,
    const T* __restrict__ reg, Outputs<T> out, int Tm1, int B_int, bool vec) {
  using R = Ring<N, M, T, Mask::kMasked>;
  using L = typename R::Tile;
  using S = State<N, M>;
  constexpr int kCompute = block_threads<N, M>();
  constexpr int kDepth = R::kDepth;
  constexpr int kStateRows = whole_warps(N);        // rows of the state warps
  constexpr int kRowsAll = kCompute / kLanes;
  constexpr int kFirstControl = kStateRows;          // the row that solves k
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);
  T* const state = tiles + kDepth * L::kValues;
  std::uint64_t* const full = reinterpret_cast<std::uint64_t*>(state + S::TOTAL * kLanes);
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kLanes;
  const size_t B = static_cast<size_t>(B_int);
  if (threadIdx.x == 0) {
    // each copying thread arrives when its copies have landed
    for (int s = 0; s < kDepth; ++s) ring::bar_init(&full[s], kProducers);
    ring::bar_init_fence();
  }
  __syncthreads();

  // a thread: row `row` of lane `lane`.  A lane past the edge computes on
  // the zero-filled tile (a unit regularizer keeps it finite) and stores
  // nothing; a padding row computes nothing and meets its warp's barriers.
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const bool state_row = row < N;
  const int ctl = row - kStateRows;                 // control row a = ctl
  // at 32 lanes no row is padding: kAll lets the compiler drop the row tests
  constexpr bool kAll = kRowsPerWarp == 1;
  const bool control_row = kAll || (ctl >= 0 && ctl < M);
  const bool producer = threadIdx.x >= kCompute - kWarp;   // the last warp
  const int ptid = threadIdx.x % kWarp;
  const size_t b = b0 + lane;
  const bool live = b < B;
  // the copies of the i-th step of the sweep (t = Tm1-1-i) into tile
  // i % kDepth, by the last warp's 32 threads
  auto fill = [&](int i) {
    const int s = i % kDepth;
    T* tile = tiles + s * L::kValues;
    const size_t t = static_cast<size_t>(Tm1 - 1 - i);
    load.template copy<L, kProducers>(tile, t, B, b0, ptid, vec);
    mask.template copy<M>(tile + L::kF * L::kW, t, ptid);
    ring::bar_arrive_on_copies(&full[s]);
  };
  if (producer) {
    for (int i = 0; i < kDepth && i < Tm1; ++i) fill(i);
  }
  // warps whose rows took different branches meet again before a barrier
  auto converge = [] {
    if constexpr (kRowsPerWarp > 1) __syncwarp();
  };
  T* const sv = state + lane;   // this lane's column: value e at sv[e * kLanes]
#define SH(e) sv[(e) * kLanes]
  // P and p from gxxT, gxT: rows row, row + kRowsAll, ...
  for (int e = row; e < N * N; e += kRowsAll) SH(S::P + e) = live ? gxxT[e * B + b] : T(0);
  for (int e = row; e < N; e += kRowsAll) SH(S::PV + e) = live ? gxT[e * B + b] : T(0);
  const T r = live ? reg[b] : T(1);
  bool ok = true;
  converge();
  named_sync(4, kCompute);

  for (int step = 0; step < Tm1; ++step) {
    const size_t t = static_cast<size_t>(Tm1 - 1 - step);
    const int slot = step % kDepth;
    ring::bar_wait(&full[slot], (step / kDepth) & 1);
    const T* const v = tiles + slot * L::kValues + lane;   // this lane's column of the tile
#define TL(e) v[(e) * kLanes]

    // A: Qx = gx + fx^T p and Qxx = gxx + (fx^T P) fx, row i (state rows);
    // Qu = gu + fu^T p, Quu = guu + (fu^T P) fu, Qux = gux + (fu^T P) fx,
    // row a (control rows)
    T um[M];
    riccati::read_um<M, T, L, Mask>(um, tiles + slot * L::kValues);
    T Qx = T(0), Qu = T(0);
    if (state_row) {
      const int i = row;
      T col[N];   // column i of fx
#pragma unroll
      for (int k = 0; k < N; ++k) col[k] = TL(L::kFx + k * N + i);
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += col[k] * SH(S::PV + k);
      Qx = TL(L::kGx + i) + acc;
      T fxTP[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += col[k] * SH(S::P + k * N + j);
        fxTP[j] = a2;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += fxTP[k] * TL(L::kFx + k * N + j);
        SH(S::PN + i * N + j) = TL(L::kGxx + i * N + j) + a2;   // Qxx, row i
      }
    } else if (control_row) {
      const int a = ctl;
      T col[N];   // column a of fu
#pragma unroll
      for (int k = 0; k < N; ++k) col[k] = TL(L::kFu + k * M + a);
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += col[k] * SH(S::PV + k);
      Qu = TL(L::kGu + a) + acc;
      SH(S::QU + a) = Qu;
      T fuTP[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += col[k] * SH(S::P + k * N + j);
        fuTP[j] = a2;
      }
#pragma unroll
      for (int c = 0; c < M; ++c) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += fuTP[k] * TL(L::kFu + k * M + c);
        SH(S::QUU + a * M + c) = TL(L::kGuu + a * M + c) + a2;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += fuTP[k] * TL(L::kFx + k * N + j);
        SH(S::QUX + a * N + j) = TL(L::kGux + a * N + j) + a2;
      }
    }
#undef TL
    if (live) {
      if (state_row) {
        out.Qx[(t * N + row) * B + b] = Qx;
      } else if (control_row) {
        out.Qu[(t * M + ctl) * B + b] = Qu;
      }
    }
    converge();
    named_sync(1, kCompute);   // B1: Quu, Qux, Qu visible; P, p and the tile read
    // the tile is free: the last warp refills it with the step kDepth on
    // while the state rows run phases B to E
    if (producer && step + kDepth < Tm1) fill(step + kDepth);

    // B: the factored Quu and the value update's (mask policy), the
    // Cholesky; state row j solves column j of Qux (-> K[:, j]) and forms
    // column j of Quu_eff K; the first control row solves Qu (-> k)
    T Kc[M], Quxc[M], QuuKc[M];   // state row j: column j of K, Qux, Quu_eff K
    if (row < kFirstControl + kRowsPerWarp) {   // the state warps and the first control warp
      if (kAll || state_row || row == kFirstControl) {
        T Quu[M][M], Qreg[M][M], Qeff[M][M], Lf[M][M];
#pragma unroll
        for (int a = 0; a < M; ++a) {
#pragma unroll
          for (int c = 0; c < M; ++c) Quu[a][c] = SH(S::QUU + a * M + c);
        }
        mask.form(um, Quu, r, Qreg, Qeff);
        riccati::cholesky(Qreg, Lf, ok);
        T rhs[M], x[M];
#pragma unroll
        for (int i = 0; i < M; ++i) rhs[i] = state_row ? SH(S::QUX + i * N + row) : SH(S::QU + i);
        riccati::cho_solve(Lf, rhs, x);
        T g[M];
#pragma unroll
        for (int a = 0; a < M; ++a) g[a] = mask.gain(um, -x[a], a);
        if (state_row) {
          // QuuK = Quu_eff K, column j
#pragma unroll
          for (int a = 0; a < M; ++a) {
            T acc = T(0);
#pragma unroll
            for (int c = 0; c < M; ++c) acc += Qeff[a][c] * g[c];
            Kc[a] = g[a];
            Quxc[a] = rhs[a];
            QuuKc[a] = acc;
            SH(S::K + a * N + row) = g[a];
            SH(S::QUUK + a * N + row) = acc;
            if (live) out.K[((t * M + a) * N + row) * B + b] = g[a];
          }
        } else {
#pragma unroll
          for (int a = 0; a < M; ++a) {
            SH(S::KFF + a) = g[a];
            if (live) out.k[(t * M + a) * B + b] = g[a];
          }
        }
      }
      converge();
      named_sync(2, kLanes * (kFirstControl + kRowsPerWarp));   // B2: K, Quu K, k visible
    }

    if (row < kStateRows) {   // the state warps
      // D: P = Qxx + K^T Quu K + K^T Qux + Qux^T K, row i, unsymmetrized
      // into PN (over Qxx's row); p = Qx + (Quu K)^T k + K^T Qu + Qux^T k
      // (column i of K, Qux and Quu K from the registers)
      const int i = row;
      T Pn[N];
      if (kAll || state_row) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll
          for (int a = 0; a < M; ++a) {
            t1 += Kc[a] * SH(S::QUUK + a * N + j);
            t2 += Kc[a] * SH(S::QUX + a * N + j);
            t3 += Quxc[a] * SH(S::K + a * N + j);
          }
          Pn[j] = ((SH(S::PN + i * N + j) + t1) + t2) + t3;
          SH(S::PN + i * N + j) = Pn[j];
        }
        T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll
        for (int a = 0; a < M; ++a) {
          t1 += QuuKc[a] * SH(S::KFF + a);
          t2 += Kc[a] * SH(S::QU + a);
          t3 += Quxc[a] * SH(S::KFF + a);
        }
        const T pn = ((Qx + t1) + t2) + t3;
        SH(S::PV + i) = pn;
        if (live) out.p[(t * N + i) * B + b] = pn;
      }
      converge();
      named_sync(3, kLanes * kStateRows);   // B3: the new P's rows visible

      // E: P = (P + P^T) / 2, row i from the registers and column i of PN
      if (kAll || state_row) {
#pragma unroll
        for (int j = 0; j < N; ++j) SH(S::P + i * N + j) = T(0.5) * (Pn[j] + SH(S::PN + j * N + i));
      }
    }
    converge();
    named_sync(4, kCompute);   // B4: P and p visible for the next step
  }
#undef SH
  if (row == kFirstControl && live) out.ok[b] = ok ? T(1) : T(0);
}

template <int N, int M, typename T, class Load, class Mask>
int launch(Load load, Mask mask, const void* gxxT, const void* gxT, const void* reg,
           void* K, void* k, void* Qx, void* Qu, void* p, void* ok, int Tm1, int B,
           void* stream) {
  if (B > 0) {
    auto* const kernel = riccati_wide_kernel<N, M, T, Load, Mask>;
    constexpr int bytes = Ring<N, M, T, Mask::kMasked>::kBytes;
    static unsigned long long shared_set = 0;
    const cudaError_t err = ring::allow_shared(kernel, bytes, shared_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (B + kLanes - 1) / kLanes;
    const Outputs<T> out{static_cast<T*>(K), static_cast<T*>(k), static_cast<T*>(Qx),
                         static_cast<T*>(Qu), static_cast<T*>(p), static_cast<T*>(ok)};
    kernel<<<blocks, block_threads<N, M>(), bytes, static_cast<cudaStream_t>(stream)>>>(
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
