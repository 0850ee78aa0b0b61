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
// Load policies: SevenArrays reads element (t, i, j) of lane b from seven
// batch-last arrays [Tm1, *dims, B]; PackedBuffer reads slot f of step t from
// one buffer [Tm1, F, B] at packed[(t*F + f)*B + b], F = n^2+nm+n+m+n^2+m^2+mn
// (46 at (4, 1)), slots in the order fx, fu, gx, gu, gxx, guu, gux.  Mask
// policies: NoMask (K1, K5) factors Quu + reg*I and updates the value with
// Quu; StepMask (K6a, K6b) reads the step's action mask um[t, a], shared by
// all lanes (one [Tm1, m] array), and forms
//   Quu_eff = Quu .* (um um^T) + diag(1 - um),  Quu_reg = Quu_eff + diag(reg um)
// with gains scaled by um and the value update on Quu_eff; K6b's order then
// recomputes Quu_eff = Quu_reg - diag(reg um), which floating point does not
// return to K6a's Quu_eff, so both orders are kept.  The mask products are
// exact (um is 0 or 1), so FMA contraction leaves them as the TPU kernel
// rounds them.
//
// Layout and threads: one thread owns one batch lane and walks the horizon;
// the 32 threads of a warp read 32 neighbouring values, so every load and
// store coalesces (in the packed buffer too: a slot is a run of B values).
// The ragged edge (b >= B) is masked; no batch padding and no horizon
// padding (the TPU kernels' pass-through steps) is needed.
//
// What bounds it: bytes.  Per step and lane it reads 46 values at (4, 1) and
// writes mn+m+n+m+n (14), against a few hundred flops.  At B=4096, T=101 in
// f32 that is about 98.7 MB a sweep for every variant (K6a's mask adds
// Tm1*m values, 400 B), 0.0295 ms at 3.35 TB/s; but 4096 lanes are only 128
// warps, about one per SM, so a sweep is bound by the latency of each step's
// loads rather than by bandwidth.  The design answers that in one way: the
// next step's inputs (and mask) are loaded into registers before the current
// step is computed, so one step's memory latency overlaps the previous
// step's arithmetic.  Left for later work: several lanes per cooperative
// group, deeper prefetch (cp.async), larger batches per launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (iterativelqr_tpu_torch/_build.py).  Plain C entry points
// below, one per kernel and instantiated (n, m, dtype); each returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;

template <int N, int M, typename T>
struct StepInputs {
  T fx[N][N];
  T fu[N][M];
  T gx[N];
  T gu[M];
  T gxx[N][N];
  T guu[M][M];
  T gux[M][N];
  T um[M];  // the step's action mask (StepMask only)
};

// ---- load policies ---------------------------------------------------------

template <int N, int M, typename T>
struct SevenArrays {
  const T* __restrict__ fx;
  const T* __restrict__ fu;
  const T* __restrict__ gx;
  const T* __restrict__ gu;
  const T* __restrict__ gxx;
  const T* __restrict__ guu;
  const T* __restrict__ gux;

  __device__ __forceinline__ void load(StepInputs<N, M, T>& s, int t, size_t b,
                                       size_t B) const {
    const size_t tt = static_cast<size_t>(t);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s.fx[i][j] = __ldg(fx + ((tt * N + i) * N + j) * B + b);
        s.gxx[i][j] = __ldg(gxx + ((tt * N + i) * N + j) * B + b);
      }
#pragma unroll
      for (int a = 0; a < M; ++a) s.fu[i][a] = __ldg(fu + ((tt * N + i) * M + a) * B + b);
      s.gx[i] = __ldg(gx + (tt * N + i) * B + b);
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      s.gu[a] = __ldg(gu + (tt * M + a) * B + b);
#pragma unroll
      for (int c = 0; c < M; ++c) s.guu[a][c] = __ldg(guu + ((tt * M + a) * M + c) * B + b);
#pragma unroll
      for (int j = 0; j < N; ++j) s.gux[a][j] = __ldg(gux + ((tt * M + a) * N + j) * B + b);
    }
  }
};

template <int N, int M, typename T>
struct PackedBuffer {
  static constexpr int kF = N * N + N * M + N + M + N * N + M * M + M * N;
  const T* __restrict__ packed;

  __device__ __forceinline__ void load(StepInputs<N, M, T>& s, int t, size_t b,
                                       size_t B) const {
    const T* base = packed + static_cast<size_t>(t) * kF * B + b;
    int f = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) s.fx[i][j] = __ldg(base + (f++) * B);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int a = 0; a < M; ++a) s.fu[i][a] = __ldg(base + (f++) * B);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) s.gx[i] = __ldg(base + (f++) * B);
#pragma unroll
    for (int a = 0; a < M; ++a) s.gu[a] = __ldg(base + (f++) * B);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) s.gxx[i][j] = __ldg(base + (f++) * B);
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int c = 0; c < M; ++c) s.guu[a][c] = __ldg(base + (f++) * B);
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) s.gux[a][j] = __ldg(base + (f++) * B);
    }
  }
};

// ---- mask policies ---------------------------------------------------------
//
// load: the step's mask into s.um; form: Quu_reg (factored) and Quu_eff (the
// value update's) from Quu and reg; gain: a gain entry of action row a.

struct NoMask {
  template <int N, int M, typename T>
  __device__ __forceinline__ void load(StepInputs<N, M, T>&, int) const {}

  template <int N, int M, typename T>
  __device__ __forceinline__ void form(const StepInputs<N, M, T>&, const T (&Quu)[M][M], T r,
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

  template <int N, int M, typename T>
  __device__ __forceinline__ T gain(const StepInputs<N, M, T>&, T v, int) const {
    return v;
  }
};

template <typename T, bool kV2Order>
struct StepMask {
  const T* __restrict__ um;  // [Tm1, M], shared by all lanes

  template <int N, int M>
  __device__ __forceinline__ void load(StepInputs<N, M, T>& s, int t) const {
#pragma unroll
    for (int a = 0; a < M; ++a) s.um[a] = __ldg(um + static_cast<size_t>(t) * M + a);
  }

  template <int N, int M>
  __device__ __forceinline__ void form(const StepInputs<N, M, T>& s, const T (&Quu)[M][M], T r,
                                       T (&Qreg)[M][M], T (&Qeff)[M][M]) const {
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const T mask2 = s.um[a] * s.um[c];
        if (a == c) {
          const T ru = r * s.um[a];
          Qeff[a][c] = Quu[a][c] * mask2 + (T(1) - s.um[a]);
          Qreg[a][c] = Qeff[a][c] + ru;
          if constexpr (kV2Order) Qeff[a][c] = Qreg[a][c] - ru;
        } else {
          Qeff[a][c] = Quu[a][c] * mask2;
          Qreg[a][c] = Qeff[a][c];
        }
      }
    }
  }

  template <int N, int M>
  __device__ __forceinline__ T gain(const StepInputs<N, M, T>& s, T v, int a) const {
    return v * s.um[a];
  }
};

// ---- the recursion ---------------------------------------------------------

template <typename T>
struct Outputs {
  T* __restrict__ K;
  T* __restrict__ k;
  T* __restrict__ Qx;
  T* __restrict__ Qu;
  T* __restrict__ p;
  T* __restrict__ ok;
};

template <int N, int M, typename T, class Load, class Mask>
__global__ void __launch_bounds__(kThreads) riccati_kernel(
    Load load, Mask mask, const T* __restrict__ gxxT, const T* __restrict__ gxT,
    const T* __restrict__ reg, Outputs<T> out, int Tm1, int B_int) {
  const size_t b = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t B = static_cast<size_t>(B_int);
  if (b >= B) return;

  T P[N][N], p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = gxT[i * B + b];
#pragma unroll
    for (int j = 0; j < N; ++j) P[i][j] = gxxT[(i * N + j) * B + b];
  }
  const T r = reg[b];
  bool ok = true;

  StepInputs<N, M, T> cur, nxt;
  if (Tm1 > 0) {
    load.load(cur, Tm1 - 1, b, B);
    mask.load(cur, Tm1 - 1);
  }

  for (int t = Tm1 - 1; t >= 0; --t) {
    // prefetch step t-1 while step t is computed
    if (t > 0) {
      load.load(nxt, t - 1, b, B);
      mask.load(nxt, t - 1);
    }
    const StepInputs<N, M, T>& s = cur;

    // Qx = gx + fx^T p, Qu = gu + fu^T p
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

    // fx^T P, fu^T P
    T fxTP[N][N], fuTP[M][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += s.fx[k][i] * P[k][j];
        fxTP[i][j] = acc;
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

    // Qxx = gxx + fx^T P fx, Quu = guu + fu^T P fu, Qux = gux + fu^T P fx
    T Qxx[N][N], Quu[M][M], Qux[M][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += fxTP[i][k] * s.fx[k][j];
        Qxx[i][j] = s.gxx[i][j] + acc;
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
    mask.form(s, Quu, r, Qreg, Qeff);

    // unrolled Cholesky of Qreg (lower factor L)
    T L[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = Qreg[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) acc -= L[i][k] * L[j][k];
        L[i][j] = (i == j) ? sqrt(acc) : acc / L[j][j];
      }
    }
#pragma unroll
    for (int a = 0; a < M; ++a) ok = ok && isfinite(L[a][a]) && (L[a][a] > T(0));

    // solve (L L^T) X = [Qux | Qu]; K = -X[:, :N], k = -X[:, N]
    T K[M][N], kff[M];
#pragma unroll
    for (int col = 0; col <= N; ++col) {
      T y[M], x[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        T acc = (col < N) ? Qux[i][col] : Qu[i];
#pragma unroll
        for (int k = 0; k < i; ++k) acc -= L[i][k] * y[k];
        y[i] = acc / L[i][i];
      }
#pragma unroll
      for (int i = M - 1; i >= 0; --i) {
        T acc = y[i];
#pragma unroll
        for (int k = i + 1; k < M; ++k) acc -= L[k][i] * x[k];
        x[i] = acc / L[i][i];
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const T v = mask.gain(s, -x[i], i);
        if (col < N) K[i][col] = v; else kff[i] = v;
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

    // P = Qxx + K^T Quu K + K^T Qux + Qux^T K, then symmetrized
    T Pn[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll
        for (int a = 0; a < M; ++a) {
          t1 += K[a][i] * QuuK[a][j];
          t2 += K[a][i] * Qux[a][j];
          t3 += Qux[a][i] * K[a][j];
        }
        Pn[i][j] = ((Qxx[i][j] + t1) + t2) + t3;
      }
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

    const size_t tt = static_cast<size_t>(t);
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) out.K[((tt * M + a) * N + j) * B + b] = K[a][j];
      out.k[(tt * M + a) * B + b] = kff[a];
      out.Qu[(tt * M + a) * B + b] = Qu[a];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      out.Qx[(tt * N + i) * B + b] = Qx[i];
      out.p[(tt * N + i) * B + b] = p[i];
    }

    if (t > 0) cur = nxt;
  }
  out.ok[b] = ok ? T(1) : T(0);
}

template <int N, int M, typename T, class Load, class Mask>
int launch(Load load, Mask mask, const void* gxxT, const void* gxT, const void* reg,
           void* K, void* k, void* Qx, void* Qu, void* p, void* ok, int Tm1, int B,
           void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    const Outputs<T> out{static_cast<T*>(K), static_cast<T*>(k), static_cast<T*>(Qx),
                         static_cast<T*>(Qu), static_cast<T*>(p), static_cast<T*>(ok)};
    riccati_kernel<N, M, T, Load, Mask>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            load, mask, static_cast<const T*>(gxxT), static_cast<const T*>(gxT),
            static_cast<const T*>(reg), out, Tm1, B);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int N, int M, typename T>
SevenArrays<N, M, T> seven(const void* fx, const void* fu, const void* gx, const void* gu,
                           const void* gxx, const void* guu, const void* gux) {
  return SevenArrays<N, M, T>{static_cast<const T*>(fx), static_cast<const T*>(fu),
                              static_cast<const T*>(gx), static_cast<const T*>(gu),
                              static_cast<const T*>(gxx), static_cast<const T*>(guu),
                              static_cast<const T*>(gux)};
}

}  // namespace

// C entry points, one per kernel and (dtype, n, m).  Keep the lists equal to
// _INSTANTIATIONS in iterativelqr_tpu_torch/ops/packed_backward.py.

// K1: seven stacks (gx, gxx without the terminal row), terminal gxxT, gxT.
#define RICCATI_ENTRY(NAME, N, M, T)                                          \
  extern "C" int NAME(const void* fx, const void* fu, const void* gx,        \
                      const void* gu, const void* gxx, const void* guu,      \
                      const void* gux, const void* gxxT, const void* gxT,    \
                      const void* reg, void* K, void* k, void* Qx, void* Qu, \
                      void* p, void* ok, int Tm1, int B, void* stream) {     \
    return launch<N, M, T>(seven<N, M, T>(fx, fu, gx, gu, gxx, guu, gux),    \
                           NoMask{}, gxxT, gxT, reg, K, k, Qx, Qu, p, ok,    \
                           Tm1, B, stream);                                   \
  }

// K5: one packed buffer [Tm1, F, B], terminal gxxT, gxT.
#define RICCATI_PACKED_ENTRY(NAME, N, M, T)                                   \
  extern "C" int NAME(const void* packed, const void* gxxT, const void* gxT, \
                      const void* reg, void* K, void* k, void* Qx, void* Qu, \
                      void* p, void* ok, int Tm1, int B, void* stream) {     \
    return launch<N, M, T>(                                                   \
        PackedBuffer<N, M, T>{static_cast<const T*>(packed)}, NoMask{}, gxxT, \
        gxT, reg, K, k, Qx, Qu, p, ok, Tm1, B, stream);                       \
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
        seven<N, M, T>(fx, fu, gx, gu, gxx, guu, gux),                         \
        StepMask<T, false>{static_cast<const T*>(um)},                         \
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
        PackedBuffer<N, M, T>{static_cast<const T*>(packed)},                 \
        StepMask<T, true>{static_cast<const T*>(um)}, gxxT, gxT, reg, K, k,   \
        Qx, Qu, p, ok, Tm1, B, stream);                                       \
  }

#define RICCATI_FAMILY(N, M)                                                      \
  RICCATI_ENTRY(riccati_backward_f32_n##N##_m##M, N, M, float)                    \
  RICCATI_ENTRY(riccati_backward_f64_n##N##_m##M, N, M, double)                   \
  RICCATI_PACKED_ENTRY(riccati_packed_f32_n##N##_m##M, N, M, float)               \
  RICCATI_PACKED_ENTRY(riccati_packed_f64_n##N##_m##M, N, M, double)              \
  RICCATI_MASKED_ENTRY(riccati_masked_f32_n##N##_m##M, N, M, float)               \
  RICCATI_MASKED_ENTRY(riccati_masked_f64_n##N##_m##M, N, M, double)              \
  RICCATI_MASKED_PACKED_ENTRY(riccati_masked_packed_f32_n##N##_m##M, N, M, float) \
  RICCATI_MASKED_PACKED_ENTRY(riccati_masked_packed_f64_n##N##_m##M, N, M, double)

RICCATI_FAMILY(4, 1)
RICCATI_FAMILY(3, 2)
