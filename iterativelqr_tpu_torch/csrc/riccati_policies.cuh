// The parts of the backward Riccati recursion that K1's template
// (riccati_backward.cuh), K2's (riccati_backward_wide.cuh) and the tall
// template (riccati_backward_tall.cuh) share: the
// layout of one step's tile in the ring (async_ring.cuh), the load policies
// (where the runs of step t are), the mask policies (the factored and the
// value update's Quu, the gains' scaling), the outputs, and the C entry
// points of one (n, m, dtype) family.  A translation unit written by
// iterativelqr_tpu_torch/ops/packed_backward.py at first use includes one
// template's header and instantiates RICCATI_FAMILY with that header's
// `launch` and `ring_info` templates.
//
// Load policies: SevenArrays reads element (t, i, j) of lane b from seven
// batch-last arrays [Tm1, *dims, B]; PackedBuffer reads slot f of step t from
// one buffer [Tm1, F, B] at packed[(t*F + f)*B + b], F = n^2+nm+n+m+n^2+m^2+mn,
// slots in the order fx, fu, gx, gu, gxx, guu, gux.  Mask policies: NoMask
// (K1, K2, K5) factors Quu + reg*I and updates the value with Quu; StepMask
// (K6a, K6b) reads the step's action mask um[t, a], shared by all lanes (one
// [Tm1, m] array, copied into the step's tile), and forms
//   Quu_eff = Quu .* (um um^T) + diag(1 - um),  Quu_reg = Quu_eff + diag(reg um)
// with gains scaled by um and the value update on Quu_eff; K6b's order then
// recomputes Quu_eff = Quu_reg - diag(reg um), which floating point does not
// return to K6a's Quu_eff, so both orders are kept.  The mask products are
// exact (um is 0 or 1), so FMA contraction leaves them as the TPU kernel
// rounds them.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "async_ring.cuh"

namespace riccati {

// A tile: the step's slots [kF][W lanes] in the packed order fx, fu, gx,
// gu, gxx, guu, gux, then (StepMask only) the step's mask, padded to 16 B.
// W is a block's lanes: 32, or fewer in K2's template at wide dims and in
// the tall template (which pads each tile to a multiple of 16 B).
template <int N, int M, typename T, bool kMasked, int W = ring::kLanes>
struct StepTile {
  static constexpr int kW = W;
  static constexpr int kFx = 0, kFu = kFx + N * N, kGx = kFu + N * M, kGu = kGx + N,
                       kGxx = kGu + M, kGuu = kGxx + N * N, kGux = kGuu + M * M,
                       kF = kGux + M * N;
  static constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  static constexpr int kUm = kMasked ? (M + kPer16 - 1) / kPer16 * kPer16 : 0;
  static constexpr int kValues = kF * W + kUm;   // a multiple of 16 B when W * sizeof(T) is
};

// ---- load policies: where the runs of step t are ---------------------------
//
// copy<L, P>: the producer thread tid's share (of P producer threads) of the
// async copies of step t's slots for lanes [b0, b0+L::kW) into a tile of
// layout L; aligned: may they go as 16-byte chunks (host side).

template <int N, int M, typename T>
struct SevenArrays {
  const T* __restrict__ fx;
  const T* __restrict__ fu;
  const T* __restrict__ gx;
  const T* __restrict__ gu;
  const T* __restrict__ gxx;
  const T* __restrict__ guu;
  const T* __restrict__ gux;

  template <class L, int P>
  __device__ __forceinline__ void copy(T* tile, size_t t, size_t B, size_t b0, int tid,
                                       bool vec) const {
    constexpr int W = L::kW;
    ring::copy_rows<N * N, N * N, P, W>(tile + L::kFx * W, fx, t, B, b0, tid, vec);
    ring::copy_rows<N * M, N * M, P, W>(tile + L::kFu * W, fu, t, B, b0, tid, vec);
    ring::copy_rows<N, N, P, W>(tile + L::kGx * W, gx, t, B, b0, tid, vec);
    ring::copy_rows<M, M, P, W>(tile + L::kGu * W, gu, t, B, b0, tid, vec);
    ring::copy_rows<N * N, N * N, P, W>(tile + L::kGxx * W, gxx, t, B, b0, tid, vec);
    ring::copy_rows<M * M, M * M, P, W>(tile + L::kGuu * W, guu, t, B, b0, tid, vec);
    ring::copy_rows<M * N, M * N, P, W>(tile + L::kGux * W, gux, t, B, b0, tid, vec);
  }

  bool aligned(size_t B) const {
    return ring::runs_aligned<T>(B, {fx, fu, gx, gu, gxx, guu, gux});
  }
};

template <int N, int M, typename T>
struct PackedBuffer {
  static constexpr int kF = N * N + N * M + N + M + N * N + M * M + M * N;
  const T* __restrict__ packed;

  template <class L, int P>
  __device__ __forceinline__ void copy(T* tile, size_t t, size_t B, size_t b0, int tid,
                                       bool vec) const {
    static_assert(L::kF == kF, "the tile holds the packed slots in their order");
    ring::copy_rows<kF, kF, P, L::kW>(tile, packed, t, B, b0, tid, vec);
  }

  bool aligned(size_t B) const { return ring::runs_aligned<T>(B, {packed}); }
};

// ---- mask policies ---------------------------------------------------------
//
// copy: the step's mask into the tile (by P producer threads); form:
// Quu_reg (factored) and Quu_eff (the value update's) from Quu, reg and the
// step's mask um; gain: a gain entry of action row a.  reg_at, eff_at and
// gain_at are the same one entry (a, c) at a time, with um in shared memory
// (the tall template, riccati_backward_tall.cuh).

struct NoMask {
  static constexpr bool kMasked = false;

  template <int M, int P = ring::kLanes, typename T>
  __device__ __forceinline__ void copy(T*, size_t, int) const {}

  template <int M, typename T>
  __device__ __forceinline__ void form(const T (&)[M], const T (&Quu)[M][M], T r,
                                       T (&Qreg)[M][M], T (&Qeff)[M][M]) const {
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        Qreg[a][c] = Quu[a][c] + (a == c ? r : T(0));
        Qeff[a][c] = Quu[a][c];
      }
    }
  }

  template <int M, typename T>
  __device__ __forceinline__ T gain(const T (&)[M], T v, int) const {
    return v;
  }

  template <typename T>
  __device__ __forceinline__ T reg_at(const T*, T quu, T r, int a, int c) const {
    return quu + (a == c ? r : T(0));
  }

  template <typename T>
  __device__ __forceinline__ T eff_at(const T*, T quu, T, int, int) const {
    return quu;
  }

  template <typename T>
  __device__ __forceinline__ T gain_at(const T*, T v, int) const {
    return v;
  }
};

template <typename T, bool kV2Order>
struct StepMask {
  static constexpr bool kMasked = true;
  const T* __restrict__ um;  // [Tm1, M], shared by all lanes

  // producer threads tid < M copy one value each (values tid, tid + P,
  // ... where M > P)
  template <int M, int P = ring::kLanes>
  __device__ __forceinline__ void copy(T* tile_um, size_t t, int tid) const {
    if constexpr (M <= P) {
      if (tid < M) ring::copy<sizeof(T)>(tile_um + tid, um + t * M + tid, true);
    } else {
      for (int a = tid; a < M; a += P) ring::copy<sizeof(T)>(tile_um + a, um + t * M + a, true);
    }
  }

  template <int M>
  __device__ __forceinline__ void form(const T (&um)[M], const T (&Quu)[M][M], T r,
                                       T (&Qreg)[M][M], T (&Qeff)[M][M]) const {
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const T mask2 = um[a] * um[c];
        if (a == c) {
          const T ru = r * um[a];
          Qeff[a][c] = Quu[a][c] * mask2 + (T(1) - um[a]);
          Qreg[a][c] = Qeff[a][c] + ru;
          if constexpr (kV2Order) Qeff[a][c] = Qreg[a][c] - ru;
        } else {
          Qeff[a][c] = Quu[a][c] * mask2;
          Qreg[a][c] = Qeff[a][c];
        }
      }
    }
  }

  template <int M>
  __device__ __forceinline__ T gain(const T (&um)[M], T v, int a) const {
    return v * um[a];
  }

  __device__ __forceinline__ T reg_at(const T* um, T quu, T r, int a, int c) const {
    const T mask2 = um[a] * um[c];
    if (a != c) return quu * mask2;
    return (quu * mask2 + (T(1) - um[a])) + r * um[a];
  }

  __device__ __forceinline__ T eff_at(const T* um, T quu, T r, int a, int c) const {
    const T mask2 = um[a] * um[c];
    if (a != c) return quu * mask2;
    const T eff = quu * mask2 + (T(1) - um[a]);
    if constexpr (kV2Order) {
      const T ru = r * um[a];
      return (eff + ru) - ru;
    }
    return eff;
  }

  __device__ __forceinline__ T gain_at(const T* um, T v, int a) const { return v * um[a]; }
};

// the step's mask from the tile (StepMask), every value 1 otherwise
template <int M, typename T, class L, class Mask>
__device__ __forceinline__ void read_um(T (&um)[M], const T* tile) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    if constexpr (Mask::kMasked) {
      um[a] = tile[L::kF * L::kW + a];
    } else {
      um[a] = T(1);
    }
  }
}

// Cholesky of Qreg (lower factor), unrolled; ok stays true while every pivot
// is finite and > 0
template <int M, typename T>
__device__ __forceinline__ void cholesky(const T (&Qreg)[M][M], T (&Lf)[M][M], bool& ok) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T acc = Qreg[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc -= Lf[i][k] * Lf[j][k];
      Lf[i][j] = (i == j) ? sqrt(acc) : acc / Lf[j][j];
    }
  }
#pragma unroll
  for (int a = 0; a < M; ++a) ok = ok && isfinite(Lf[a][a]) && (Lf[a][a] > T(0));
}

// x = (L L^T)^-1 rhs, forward then back substitution
template <int M, typename T>
__device__ __forceinline__ void cho_solve(const T (&Lf)[M][M], const T (&rhs)[M], T (&x)[M]) {
  T y[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= Lf[i][k] * y[k];
    y[i] = acc / Lf[i][i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc -= Lf[k][i] * x[k];
    x[i] = acc / Lf[i][i];
  }
}

template <typename T>
struct Outputs {
  T* __restrict__ K;
  T* __restrict__ k;
  T* __restrict__ Qx;
  T* __restrict__ Qu;
  T* __restrict__ p;
  T* __restrict__ ok;
};

template <int N, int M, typename T>
SevenArrays<N, M, T> seven(const void* fx, const void* fu, const void* gx, const void* gu,
                           const void* gxx, const void* guu, const void* gux) {
  return SevenArrays<N, M, T>{static_cast<const T*>(fx), static_cast<const T*>(fu),
                              static_cast<const T*>(gx), static_cast<const T*>(gu),
                              static_cast<const T*>(gxx), static_cast<const T*>(guu),
                              static_cast<const T*>(gux)};
}

}  // namespace riccati

// C entry points of one (n, m, dtype), each calling the including header's
// launch<N, M, T>(load, mask, gxxT, gxT, reg, K, k, Qx, Qu, p, ok, Tm1, B,
// stream) and ring_info<N, M, T, masked>(depth, bytes).

// seven stacks (gx, gxx without the terminal row), terminal gxxT, gxT (K1, K2)
#define RICCATI_ENTRY(NAME, N, M, T)                                          \
  extern "C" int NAME(const void* fx, const void* fu, const void* gx,        \
                      const void* gu, const void* gxx, const void* guu,      \
                      const void* gux, const void* gxxT, const void* gxT,    \
                      const void* reg, void* K, void* k, void* Qx, void* Qu, \
                      void* p, void* ok, int Tm1, int B, void* stream) {     \
    return launch<N, M, T>(riccati::seven<N, M, T>(fx, fu, gx, gu, gxx, guu, \
                                                   gux),                     \
                           riccati::NoMask{}, gxxT, gxT, reg, K, k, Qx, Qu,  \
                           p, ok, Tm1, B, stream);                           \
  }

// K5: one packed buffer [Tm1, F, B], terminal gxxT, gxT.
#define RICCATI_PACKED_ENTRY(NAME, N, M, T)                                   \
  extern "C" int NAME(const void* packed, const void* gxxT, const void* gxT, \
                      const void* reg, void* K, void* k, void* Qx, void* Qu, \
                      void* p, void* ok, int Tm1, int B, void* stream) {     \
    return launch<N, M, T>(                                                   \
        riccati::PackedBuffer<N, M, T>{static_cast<const T*>(packed)},        \
        riccati::NoMask{}, gxxT, gxT, reg, K, k, Qx, Qu, p, ok, Tm1, B,       \
        stream);                                                              \
  }

// K6a: seven stacks with gx [T, n, B] and gxx [T, n, n, B] whole: the
// terminal P, p are their row Tm1, as the TPU kernel reads them.
#define RICCATI_MASKED_ENTRY(NAME, N, M, T)                                    \
  extern "C" int NAME(const void* fx, const void* fu, const void* gx,         \
                      const void* gu, const void* gxx, const void* guu,       \
                      const void* gux, const void* um, const void* reg,       \
                      void* K, void* k, void* Qx, void* Qu, void* p, void* ok, \
                      int Tm1, int B, void* stream) {                          \
    const size_t Bs = static_cast<size_t>(B), t1 = static_cast<size_t>(Tm1);  \
    return launch<N, M, T>(                                                    \
        riccati::seven<N, M, T>(fx, fu, gx, gu, gxx, guu, gux),                \
        riccati::StepMask<T, false>{static_cast<const T*>(um)},                \
        static_cast<const T*>(gxx) + t1 * N * N * Bs,                          \
        static_cast<const T*>(gx) + t1 * N * Bs, reg, K, k, Qx, Qu, p, ok,     \
        Tm1, B, stream);                                                       \
  }

// K6b: one packed buffer, terminal gxxT, gxT, the mask in K6b's order.
#define RICCATI_MASKED_PACKED_ENTRY(NAME, N, M, T)                            \
  extern "C" int NAME(const void* packed, const void* gxxT, const void* gxT, \
                      const void* um, const void* reg, void* K, void* k,     \
                      void* Qx, void* Qu, void* p, void* ok, int Tm1, int B, \
                      void* stream) {                                         \
    return launch<N, M, T>(                                                   \
        riccati::PackedBuffer<N, M, T>{static_cast<const T*>(packed)},        \
        riccati::StepMask<T, true>{static_cast<const T*>(um)}, gxxT, gxT,     \
        reg, K, k, Qx, Qu, p, ok, Tm1, B, stream);                            \
  }

// The ring of (n, m, dtype), masked (K6a, K6b) or not (K1, K2, K5): its depth
// and dynamic shared memory a block.
#define RICCATI_RING_ENTRY(NAME, N, M, T)                          \
  extern "C" int NAME(int masked, int* depth, int* bytes) {        \
    return masked ? ring_info<N, M, T, true>(depth, bytes)         \
                  : ring_info<N, M, T, false>(depth, bytes);       \
  }

// The family of one (n, m, dtype): the ring, the seven-array recursion
// (MAIN: riccati_backward for K1, riccati_backward_wide for K2), K5, K6a and
// K6b, named <kernel>_<TAG>_n<N>_m<M>.
#define RICCATI_FAMILY(MAIN, RING, N, M, T, TAG)                                    \
  RICCATI_RING_ENTRY(RING##_##TAG##_n##N##_m##M, N, M, T)                           \
  RICCATI_ENTRY(MAIN##_##TAG##_n##N##_m##M, N, M, T)                                \
  RICCATI_PACKED_ENTRY(riccati_packed_##TAG##_n##N##_m##M, N, M, T)                 \
  RICCATI_MASKED_ENTRY(riccati_masked_##TAG##_n##N##_m##M, N, M, T)                 \
  RICCATI_MASKED_PACKED_ENTRY(riccati_masked_packed_##TAG##_n##N##_m##M, N, M, T)
