// Backward Riccati recursion of the batched AL-iLQR solver (K1).
//
// Replaces the TPU kernel iterativelqr_tpu/ops/packed_backward.py::_kernel_mr
// (step math: _riccati_step).  It computes the same recursion: start from
// P = gxxT, p = gxT; per step t = Tm1-1 .. 0 form Qx, Qu, Qxx, Quu, Qux;
// factor Quu + reg*I with an unrolled Cholesky; K = -Quu^-1 Qux,
// k = -Quu^-1 Qu; symmetrized P update and p update; per-lane ok = every
// Cholesky pivot finite and > 0.
//
// Layout: every tensor is batch-last and contiguous, [Tm1, *dims, B].  One
// thread owns one batch lane and walks the horizon; thread b reads element
// (t, i, j, b), so the 32 threads of a warp read 32 neighbouring values and
// every load and store coalesces.  The ragged edge (b >= B) is masked; no
// batch padding and no horizon padding is needed.
//
// What bounds it: bytes.  Per step and lane it reads n^2+nm+n+m+n^2+m^2+mn
// values (46 for acrobot n=4, m=1) and writes mn+m+n+m+n (14), against a few
// hundred flops.  At B=4096, T=101 in f32 that is about 98 MB a sweep; but
// 4096 lanes are only 128 warps, about one per SM, so a sweep is bound by the
// latency of each step's loads rather than by bandwidth.  The design answers
// that in one way: the next step's 46 inputs are loaded into registers before
// the current step is computed, so one step's memory latency overlaps the
// previous step's arithmetic.  Left for later work: several lanes per
// cooperative group, deeper prefetch (cp.async), larger batches per launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (iterativelqr_tpu_torch/_build.py).  Plain C entry points
// below, one per instantiated (n, m, dtype); each returns cudaGetLastError().

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
};

template <int N, int M, typename T>
__device__ __forceinline__ void load_step(
    StepInputs<N, M, T>& s, int t, size_t b, size_t B,
    const T* __restrict__ fx, const T* __restrict__ fu,
    const T* __restrict__ gx, const T* __restrict__ gu,
    const T* __restrict__ gxx, const T* __restrict__ guu,
    const T* __restrict__ gux) {
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

template <int N, int M, typename T>
__global__ void __launch_bounds__(kThreads) riccati_backward_kernel(
    const T* __restrict__ fx, const T* __restrict__ fu,
    const T* __restrict__ gx, const T* __restrict__ gu,
    const T* __restrict__ gxx, const T* __restrict__ guu,
    const T* __restrict__ gux, const T* __restrict__ gxxT,
    const T* __restrict__ gxT, const T* __restrict__ reg,
    T* __restrict__ K_out, T* __restrict__ k_out, T* __restrict__ Qx_out,
    T* __restrict__ Qu_out, T* __restrict__ p_out, T* __restrict__ ok_out,
    int Tm1, int B_int) {
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
  if (Tm1 > 0) load_step(cur, Tm1 - 1, b, B, fx, fu, gx, gu, gxx, guu, gux);

  for (int t = Tm1 - 1; t >= 0; --t) {
    // prefetch step t-1 while step t is computed
    if (t > 0) load_step(nxt, t - 1, b, B, fx, fu, gx, gu, gxx, guu, gux);
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

    // unrolled Cholesky of Quu + reg*I (lower factor L)
    T L[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = Quu[i][j] + (i == j ? r : T(0));
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
        if (col < N) K[i][col] = -x[i]; else kff[i] = -x[i];
      }
    }

    // QuuK = Quu K (unregularized Quu)
    T QuuK[M][N];
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < M; ++c) acc += Quu[a][c] * K[c][j];
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
      for (int j = 0; j < N; ++j) K_out[((tt * M + a) * N + j) * B + b] = K[a][j];
      k_out[(tt * M + a) * B + b] = kff[a];
      Qu_out[(tt * M + a) * B + b] = Qu[a];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Qx_out[(tt * N + i) * B + b] = Qx[i];
      p_out[(tt * N + i) * B + b] = p[i];
    }

    if (t > 0) cur = nxt;
  }
  ok_out[b] = ok ? T(1) : T(0);
}

template <int N, int M, typename T>
int launch(const void* fx, const void* fu, const void* gx, const void* gu,
           const void* gxx, const void* guu, const void* gux,
           const void* gxxT, const void* gxT, const void* reg,
           void* K, void* k, void* Qx, void* Qu, void* p, void* ok,
           int Tm1, int B, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    riccati_backward_kernel<N, M, T>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(fx), static_cast<const T*>(fu),
            static_cast<const T*>(gx), static_cast<const T*>(gu),
            static_cast<const T*>(gxx), static_cast<const T*>(guu),
            static_cast<const T*>(gux), static_cast<const T*>(gxxT),
            static_cast<const T*>(gxT), static_cast<const T*>(reg),
            static_cast<T*>(K), static_cast<T*>(k), static_cast<T*>(Qx),
            static_cast<T*>(Qu), static_cast<T*>(p), static_cast<T*>(ok),
            Tm1, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One C entry point per (dtype, n, m).  Keep this list equal to
// _INSTANTIATIONS in iterativelqr_tpu_torch/ops/packed_backward.py.
#define RICCATI_ENTRY(NAME, N, M, T)                                          \
  extern "C" int NAME(const void* fx, const void* fu, const void* gx,        \
                      const void* gu, const void* gxx, const void* guu,      \
                      const void* gux, const void* gxxT, const void* gxT,    \
                      const void* reg, void* K, void* k, void* Qx, void* Qu, \
                      void* p, void* ok, int Tm1, int B, void* stream) {     \
    return launch<N, M, T>(fx, fu, gx, gu, gxx, guu, gux, gxxT, gxT, reg, K, \
                           k, Qx, Qu, p, ok, Tm1, B, stream);                \
  }

RICCATI_ENTRY(riccati_backward_f32_n4_m1, 4, 1, float)
RICCATI_ENTRY(riccati_backward_f64_n4_m1, 4, 1, double)
RICCATI_ENTRY(riccati_backward_f32_n3_m2, 3, 2, float)
RICCATI_ENTRY(riccati_backward_f64_n3_m2, 3, 2, double)
