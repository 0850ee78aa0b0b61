// Backward Riccati recursion of the batched AL-iLQR solver: K1, K5, K6a and
// K6b, one recursion template instantiated with a load policy and a mask
// policy.
//
// Replaces four TPU kernels that compute the same recursion:
//   K1  iterativelqr_tpu/ops/packed_backward.py::_kernel_mr (step math:
//       _riccati_step): seven separate stacks, mask-free;
//   K5  iterativelqr_tpu/ops/packed_backward.py::_kernel (v3): one packed
//       per-step buffer, mask-free (invalid action dims carry a unit guu
//       diagonal from pack_stacks);
//   K6a iterativelqr_tpu/ops/pallas_backward.py::_kernel (v1): seven
//       stacks with the terminal P, p in row Tm1 of gxx, gx, and the action
//       mask applied inside the step;
//   K6b iterativelqr_tpu/ops/pallas_backward.py::_kernel_v2: K6a's masked
//       step reading K5's packed buffer, in its own operation order.
// Start from P = gxxT, p = gxT; per step t = Tm1-1 .. 0 form Qx, Qu, Qxx,
// Quu, Qux; factor the regularized Quu with an unrolled Cholesky;
// K = -Quu^-1 Qux, k = -Quu^-1 Qu; symmetrized P update and p update; per-lane
// ok = every Cholesky pivot finite and > 0.
//
// The load policies (SevenArrays: seven batch-last arrays [Tm1, *dims, B];
// PackedBuffer: one buffer [Tm1, F, B], F = 46 at (4, 1)) and the mask
// policies (NoMask for K1, K5; StepMask for K6a and, in its own order, K6b)
// are riccati_policies.cuh's, shared with K2's template
// (riccati_backward_wide.cuh), as are the C entry points.
//
// Layout and threads: a block owns 32 neighbouring batch lanes.  Each lane
// has a team of kTeam = 4 threads in its compute warps: thread `row` forms
// rows `row`, `row` + 4, ... (kRows = ceil(n / 4) of them) of fx^T P, Qxx
// and the P update and solves gain columns `row`, `row` + 4, ..., the team
// shares them by shuffles, and every thread of the team forms the small
// rest (Qx, Qu, fu^T P, Quu, Qux, the Cholesky, the symmetrized P, p)
// itself; (3, 2) leaves the fourth row idle, (5, m) three of the eight.
// The registers a thread holds grow with n^2 (P, fx and the gathered new
// P whole), so the dims this template takes are
// ops/packed_backward.py::riccati_plan's to choose.  The
// block's kProducerWarps = 2 producer warps stream the steps' inputs into a
// ring of kDepth = 8 tiles in shared memory (async_ring.cuh).  Every array is
// batch-last, so slot f of step t for the block's lanes is one contiguous
// run of 32 values (128 B in f32, 256 B in f64): in SevenArrays at
// arr + ((t*E + e)*B + b0), in PackedBuffer at packed + ((t*F + f)*B + b0).
// A load policy is only "where the runs of step t are"; the copy is one
// pipeline shared by all four instantiations.  The ragged edge (b >= B)
// computes on the zero-filled tile with its team (the shuffles need every
// thread) and stores nothing; no batch padding and no horizon padding (the
// TPU kernels' pass-through steps) is needed.  Every element is formed by
// the same operations in the same order as with one thread a lane.
//
// What bounds it.  Per step and lane it reads 46 values at (4, 1) and writes
// mn+m+n+m+n (14), against a few hundred flops: at B=4096, T=101 in f32
// about 98.7 MB a sweep for every variant (K6a's mask adds Tm1*m values,
// 400 B), 0.0295 ms at 3.35 TB/s.  But 4096 lanes are 128 blocks, about one
// per SM, so the bytes in flight, not the bandwidth, set what the loads can
// draw (Little's law): a one-step register prefetch in the computing thread
// keeps 46 loads a lane in flight, 0.75 MB over the card, and pays a memory
// latency every step.  The ring keeps up to kDepth steps a block in flight
// (8 x 5,888 B in f32 at (4, 1), 6 MB over the card), as the TPU kernel
// _kernel_mr streams chunks into VMEM with double-buffered async copies.
// The copies have warps of their own: a warp that issues its own cp.async's
// stalls in the issue once the SM's outstanding requests are full, about as
// long as its arithmetic takes, so the ring pays only once the copying
// leaves the computing warps.  Then the step's dependent arithmetic sets the
// pace: one warp a lane group on each warp scheduler, so little of its
// latency is hidden.  The team spreads the n^3 products over four warp
// schedulers, but the parts each thread repeats keep most of the step's
// instructions (cycle-counter probes on the H100: the compute warps' step
// shrank a little, and one producer warp then only just kept up, hence
// two).
// Dynamic shared memory: 8 tiles of F*32 values (+ the step mask) and 16
// mbarriers, 47,232 B in f32 and 94,336 B in f64 at (4, 1);
// cudaFuncSetAttribute raises the 48 KB limit once per kernel and device.
// Runs that are not 16-byte aligned (B * sizeof(T) not a multiple of 16, as
// B = 4097) go one value a copy, which the producers issue more slowly.
//
// Build: a translation unit that includes this header and instantiates
// RICCATI_FAMILY (riccati_policies.cuh) at one (n, m, dtype), written and
// built at first use by iterativelqr_tpu_torch/ops/packed_backward.py
// (nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC, _build.py::build_generated); each C entry returns
// cudaGetLastError() (or the attribute call's error).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_ring.cuh"
#include "riccati_policies.cuh"

namespace {

using riccati::Outputs;

// a block: a team of kTeam threads for each of its 32 lanes (the compute
// warps; the team's thread `row` owns row `row` of the lane's fx^T P, Qxx
// and P update), then kProducerWarps warps that copy the step tiles
constexpr int kTeam = 4;
constexpr int kCompute = ring::kLanes * kTeam;
constexpr int kProducerWarps = 2;
constexpr int kProducers = kProducerWarps * ring::kLanes;
constexpr int kThreads = kCompute + kProducers;

// v of thread `src` of this thread's team
template <typename T>
__device__ __forceinline__ T team(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src, kTeam);
}

// x[i] for an index known at run time, by selects (no local memory)
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&x)[N], int i) {
  T v = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = (i == j) ? x[j] : v;
  return v;
}
constexpr int kDepth = 8;                // tiles in the ring

template <int N, int M, typename T>
struct StepInputs {
  T fx[N][N];
  T fu[N][M];
  T gx[N];
  T gu[M];
  T guu[M][M];
  T gux[M][N];
  T um[M];  // the step's action mask (1 without StepMask)
};

// A tile (riccati::StepTile) and the ring of kDepth of them
template <int N, int M, typename T, bool kMasked>
struct Tile : riccati::StepTile<N, M, T, kMasked> {
  using S = riccati::StepTile<N, M, T, kMasked>;
  // the tiles, then each tile's full and empty mbarriers
  static constexpr int kBytes = kDepth * S::kValues * static_cast<int>(sizeof(T)) + 2 * kDepth * 8;

  // the step's inputs of this thread's lane, from the tile (but gxx: a
  // thread needs only its row, read_row)
  template <class Mask>
  static __device__ __forceinline__ void read(StepInputs<N, M, T>& s, const T* tile, int lane) {
    const T* v = tile + lane;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) s.fx[i][j] = v[(S::kFx + i * N + j) * ring::kLanes];
#pragma unroll
      for (int a = 0; a < M; ++a) s.fu[i][a] = v[(S::kFu + i * M + a) * ring::kLanes];
      s.gx[i] = v[(S::kGx + i) * ring::kLanes];
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      s.gu[a] = v[(S::kGu + a) * ring::kLanes];
#pragma unroll
      for (int c = 0; c < M; ++c) s.guu[a][c] = v[(S::kGuu + a * M + c) * ring::kLanes];
#pragma unroll
      for (int j = 0; j < N; ++j) s.gux[a][j] = v[(S::kGux + a * N + j) * ring::kLanes];
    }
    riccati::read_um<M, T, S, Mask>(s.um, tile);
  }

  // row `row` of gxx and column `row` of fx of this thread's lane
  static __device__ __forceinline__ void read_row(T (&gxx_row)[N], T (&fx_col)[N], const T* tile,
                                                  int lane, int row) {
    const T* v = tile + lane;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      gxx_row[j] = v[(S::kGxx + row * N + j) * ring::kLanes];
      fx_col[j] = v[(S::kFx + j * N + row) * ring::kLanes];
    }
  }
};

// ---- the recursion ---------------------------------------------------------

template <int N, int M, typename T, class Load, class Mask>
__global__ void __launch_bounds__(kThreads) riccati_kernel(
    Load load, Mask mask, const T* __restrict__ gxxT, const T* __restrict__ gxT,
    const T* __restrict__ reg, Outputs<T> out, int Tm1, int B_int, bool vec) {
  using L = Tile<N, M, T, Mask::kMasked>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);
  std::uint64_t* const full = reinterpret_cast<std::uint64_t*>(tiles + kDepth * L::kValues);
  std::uint64_t* const empty = full + kDepth;
  const size_t b0 = static_cast<size_t>(blockIdx.x) * ring::kLanes;
  const size_t B = static_cast<size_t>(B_int);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDepth; ++s) {
      // full: each producer thread arrives when its copies have landed;
      // empty: each compute thread once it has read the tile
      ring::bar_init(&full[s], kProducers);
      ring::bar_init(&empty[s], kCompute);
    }
    ring::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kCompute) {
    // the producer warps: step Tm1-1-i into tile i % kDepth once the
    // compute warps have read what the tile held kDepth steps before
    const int tid = threadIdx.x - kCompute;
    for (int i = 0; i < Tm1; ++i) {
      const int s = i % kDepth;
      if (i >= kDepth) ring::bar_wait(&empty[s], ((i / kDepth) + 1) & 1);
      const size_t t = static_cast<size_t>(Tm1 - 1 - i);
      T* tile = tiles + s * L::kValues;
      load.template copy<L, kProducers>(tile, t, B, b0, tid, vec);
      mask.template copy<M>(tile + L::kF * L::kW, t, tid);
      ring::bar_arrive_on_copies(&full[s]);
    }
    ring::wait_all();
    return;
  }

  // the compute warps: thread `row` of lane `lane`'s team, which owns rows
  // row + q * kTeam, q < kRows.  A lane past the edge computes on the
  // zero-filled tile (a unit regularizer keeps it finite) with its team, as
  // the shuffles need, and stores nothing.
  constexpr int kRows = (N + kTeam - 1) / kTeam;
  const int lane = threadIdx.x / kTeam, row = threadIdx.x % kTeam;
  int rr[kRows];   // a row past the last one reads row N-1
#pragma unroll
  for (int q = 0; q < kRows; ++q) rr[q] = row + q * kTeam < N ? row + q * kTeam : N - 1;
  const size_t b = b0 + lane;
  const bool live = b < B;
  T P[N][N], p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = live ? gxT[i * B + b] : T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) P[i][j] = live ? gxxT[(i * N + j) * B + b] : T(0);
  }
  const T r = live ? reg[b] : T(1);
  bool ok = true;
  constexpr int kRounds = (N + 1 + kTeam - 1) / kTeam;   // gain columns a thread solves

  for (int step = 0; step < Tm1; ++step) {
    const int t = Tm1 - 1 - step;
    const int slot = step % kDepth;
    ring::bar_wait(&full[slot], (step / kDepth) & 1);
    StepInputs<N, M, T> s;
    T gxx_row[kRows][N], fx_col[kRows][N];
    L::template read<Mask>(s, tiles + slot * L::kValues, lane);
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      L::read_row(gxx_row[q], fx_col[q], tiles + slot * L::kValues, lane, rr[q]);
    ring::bar_arrive(&empty[slot]);

    // Qx = gx + fx^T p, Qu = gu + fu^T p (every thread: the p update needs
    // them all)
    T Qx[N], Qu[M];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += s.fx[k][i] * p[k];
      Qx[i] = s.gx[i] + acc;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += s.fu[k][a] * p[k];
      Qu[a] = s.gu[a] + acc;
    }

    // this thread's rows of fx^T P; fu^T P whole
    T fxTP_row[kRows][N], fuTP[M][N];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += fx_col[q][k] * P[k][j];
        fxTP_row[q][j] = acc;
      }
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += s.fu[k][a] * P[k][j];
        fuTP[a][j] = acc;
      }
    }

    // this thread's rows of Qxx = gxx + fx^T P fx; Quu = guu + fu^T P fu
    // and Qux = gux + fu^T P fx whole
    T Qxx_row[kRows][N], Quu[M][M], Qux[M][N];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += fxTP_row[q][k] * s.fx[k][j];
        Qxx_row[q][j] = gxx_row[q][j] + acc;
      }
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += fuTP[a][k] * s.fu[k][c];
        Quu[a][c] = s.guu[a][c] + acc;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += fuTP[a][k] * s.fx[k][j];
        Qux[a][j] = s.gux[a][j] + acc;
      }
    }

    // the factored matrix and the value update's (mask policy)
    T Qreg[M][M], Qeff[M][M];
    mask.form(s.um, Quu, r, Qreg, Qeff);

    // unrolled Cholesky of Qreg (lower factor L)
    T L[M][M];
    riccati::cholesky(Qreg, L, ok);

    // solve (L L^T) X = [Qux | Qu]; K = -X[:, :N], k = -X[:, N]: thread
    // `row` solves columns row, row + kTeam, ...; then every column to the
    // whole team
    T v[kRounds][M];
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const int col = row + q * kTeam;
      T rhs[M], x[M];
#pragma unroll
      for (int i = 0; i < M; ++i) rhs[i] = (col < N) ? pick(Qux[i], col) : Qu[i];
      riccati::cho_solve(L, rhs, x);
#pragma unroll
      for (int i = 0; i < M; ++i) v[q][i] = mask.gain(s.um, -x[i], i);
    }
    T K[M][N], kff[M];
#pragma unroll
    for (int col = 0; col <= N; ++col) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const T g = team(v[col / kTeam][i], col % kTeam);
        if (col < N) K[i][col] = g; else kff[i] = g;
      }
    }

    // QuuK = Quu_eff K
    T QuuK[M][N];
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < M; ++c) acc += Qeff[a][c] * K[c][j];
        QuuK[a][j] = acc;
      }
    }

    // this thread's rows of P = Qxx + K^T Quu K + K^T Qux + Qux^T K; the
    // whole matrix to every thread of the team, then symmetrized
    T Pn_row[kRows][N];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll
        for (int a = 0; a < M; ++a) {
          const T K_ar = pick(K[a], rr[q]), Qux_ar = pick(Qux[a], rr[q]);
          t1 += K_ar * QuuK[a][j];
          t2 += K_ar * Qux[a][j];
          t3 += Qux_ar * K[a][j];
        }
        Pn_row[q][j] = ((Qxx_row[q][j] + t1) + t2) + t3;
      }
    }
    T Pn[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) Pn[i][j] = team(Pn_row[i / kTeam][j], i % kTeam);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) P[i][j] = T(0.5) * (Pn[i][j] + Pn[j][i]);
    }

    // p = Qx + (Quu K)^T k + K^T Qu + Qux^T k
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll
      for (int a = 0; a < M; ++a) {
        t1 += QuuK[a][i] * kff[a];
        t2 += K[a][i] * Qu[a];
        t3 += Qux[a][i] * kff[a];
      }
      p[i] = ((Qx[i] + t1) + t2) + t3;
    }

    // thread `row` stores its columns of K and rows of Qx and p; thread 0
    // also k and Qu
    if (live && row < N) {
      const size_t tt = static_cast<size_t>(t);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = row + q * kTeam;
        if (r < N) {
#pragma unroll
          for (int a = 0; a < M; ++a) out.K[((tt * M + a) * N + r) * B + b] = pick(K[a], r);
          out.Qx[(tt * N + r) * B + b] = pick(Qx, r);
          out.p[(tt * N + r) * B + b] = pick(p, r);
        }
      }
      if (row == 0) {
#pragma unroll
        for (int a = 0; a < M; ++a) {
          out.k[(tt * M + a) * B + b] = kff[a];
          out.Qu[(tt * M + a) * B + b] = Qu[a];
        }
      }
    }
  }
  if (live && row == 0) out.ok[b] = ok ? T(1) : T(0);
}

template <int N, int M, typename T, class Load, class Mask>
int launch(Load load, Mask mask, const void* gxxT, const void* gxT, const void* reg,
           void* K, void* k, void* Qx, void* Qu, void* p, void* ok, int Tm1, int B,
           void* stream) {
  if (B > 0) {
    auto* const kernel = riccati_kernel<N, M, T, Load, Mask>;
    constexpr int bytes = Tile<N, M, T, Mask::kMasked>::kBytes;
    static unsigned long long shared_set = 0;
    const cudaError_t err = ring::allow_shared(kernel, bytes, shared_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (B + ring::kLanes - 1) / ring::kLanes;
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
  *depth = kDepth;
  *bytes = Tile<N, M, T, kMasked>::kBytes;
  return 0;
}

}  // namespace
