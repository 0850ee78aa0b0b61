// Backward Riccati recursion of the batched AL-iLQR solver at wide dims (K2).
//
// Replaces the TPU kernel
// iterativelqr_tpu/ops/packed_backward.py::_kernel_mr_stream (step math:
// _riccati_step), which the JAX package takes over _kernel_mr when the
// direct outputs overflow VMEM: the quadrotor's n=12, m=4.  It computes the
// same recursion as K1 (csrc/riccati_backward.cu): start from P = gxxT,
// p = gxT; per step t = Tm1-1 .. 0 form Qx, Qu, Qxx, Quu, Qux; factor
// Quu + reg*I with an unrolled Cholesky; K = -Quu^-1 Qux, k = -Quu^-1 Qu;
// symmetrized P update and p update; per-lane ok = every Cholesky pivot
// finite and > 0.  The TPU kernel's chunked DMA, packed output buffer and
// output streaming have no counterpart here: the outputs go straight to
// device memory as the five batch-last arrays K1 writes.
//
// Why not K1's design: K1 runs one thread per lane with P, one step's inputs,
// the prefetched next step and its temporaries in registers.  At (12, 4)
// that is about 1,000 live values against the 255-register cap
// (ops/packed_backward.py::uses_wide_kernel states the rule).
//
// Design: a block owns 32 lanes and a team of N+M threads per lane;
// threadIdx.x is the lane, threadIdx.y the thread's row, so each warp has
// one row and no warp diverges.  Rows 0..N-1 own a row of P, fx^T P and Qxx;
// rows N..N+M-1 own a row of Quu, Qux, Quu K and of fu^T P.  Each step's 416
// inputs are staged in shared memory as [element][32 lanes], loaded warp by
// warp so that every load is 32 neighbouring values (128 coalesced bytes in
// f32) and every shared-memory read of a warp is conflict-free.  A thread
// keeps its own rows of fx^T P, Qxx and the new P in registers; P, p, Quu,
// Qux, Qu, K, k and Quu K live in shared memory.  The 4x4 Cholesky runs
// redundantly in every thread (no extra barrier); state thread j solves
// column j of K, the first control thread solves k and keeps ok.  Six
// barriers a step.  Shared memory: 740 values a lane, 94,720 bytes a block
// in f32 and 189,440 in f64 (above the 48 KB default, so the launch raises
// the block's limit with cudaFuncSetAttribute and returns its error).
//
// What bounds it.  Bytes: per step and lane it reads 416 inputs and writes
// 80 outputs (K 48, k 4, Qx 12, Qu 4, p 12), plus 158 values of gxxT, gxT,
// reg and ok a lane: at T=41 (40 steps), B=4096 in f32 that is
// (40*496 + 158) * 4096 * 4 B = 328 MB, about 0.098 ms at 3.35 TB/s.
// Operations: about 13 k a step and lane (the products with P and fx
// dominate), 2.1 G in all, about 0.03 ms at 67 TFLOP/s (f32): bytes bound.
// This first design does not reach either: each step's loads are issued
// only after the previous step ends (no prefetch) and each step is a chain
// of dependent phases separated by barriers, with one block of 16 warps per
// SM (4096 lanes are 128 blocks).  Left for later work: double-buffered
// staging (cp.async or TMA) of the next step, fewer barriers, more lanes
// per block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (iterativelqr_tpu_torch/_build.py).  Plain C entry points
// below, one per instantiated (n, m, dtype); each returns a CUDA error code.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;

// Offsets, in values a lane, of the shared-memory regions of one block; the
// value e of a lane sits at smem[e * kLanes + lane].
template <int N, int M>
struct Layout {
  // one step's inputs
  static constexpr int FX = 0;               // fx [N][N]
  static constexpr int FU = FX + N * N;      // fu [N][M]
  static constexpr int GX = FU + N * M;      // gx [N]
  static constexpr int GU = GX + N;          // gu [M]
  static constexpr int GXX = GU + M;         // gxx [N][N]
  static constexpr int GUU = GXX + N * N;    // guu [M][M]
  static constexpr int GUX = GUU + M * M;    // gux [M][N]
  // the recursion's state and one step's shared intermediates
  static constexpr int P = GUX + M * N;      // P [N][N]
  static constexpr int PV = P + N * N;       // p [N]
  static constexpr int QUU = PV + N;         // Quu [M][M]
  static constexpr int QUX = QUU + M * M;    // Qux [M][N]
  static constexpr int QU = QUX + M * N;     // Qu [M]
  static constexpr int K = QU + M;           // K [M][N]
  static constexpr int KFF = K + M * N;      // k [M]
  static constexpr int QUUK = KFF + M;       // Quu K [M][N]
  static constexpr int TOTAL = QUUK + M * N;
};

// Rows row, row+TEAM, ... of `count` values a lane, from the batch-last
// global array src [count, B] to shared memory dst [count][kLanes] (dst
// already offset to the thread's lane).  Lanes past B read zeros.
template <int COUNT, int TEAM, typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      size_t b, size_t B, bool live, int row) {
#pragma unroll
  for (int i = 0; i < (COUNT + TEAM - 1) / TEAM; ++i) {
    const int e = row + i * TEAM;
    if (e < COUNT) {
      dst[e * kLanes] = live ? __ldg(src + static_cast<size_t>(e) * B + b) : T(0);
    }
  }
}

template <int N, int M, typename T>
__global__ void __launch_bounds__(kLanes * (N + M)) riccati_backward_wide_kernel(
    const T* __restrict__ fx, const T* __restrict__ fu,
    const T* __restrict__ gx, const T* __restrict__ gu,
    const T* __restrict__ gxx, const T* __restrict__ guu,
    const T* __restrict__ gux, const T* __restrict__ gxxT,
    const T* __restrict__ gxT, const T* __restrict__ reg,
    T* __restrict__ K_out, T* __restrict__ k_out, T* __restrict__ Qx_out,
    T* __restrict__ Qu_out, T* __restrict__ p_out, T* __restrict__ ok_out,
    int Tm1, int B_int) {
  using L = Layout<N, M>;
  constexpr int kTeam = N + M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const size_t B = static_cast<size_t>(B_int);
  const size_t b = static_cast<size_t>(blockIdx.x) * kLanes + lane;
  const bool live = b < B;
  // this lane's column of shared memory: value e at s[e * kLanes]
  T* s = reinterpret_cast<T*>(smem_raw) + lane;
#define SH(e) s[(e) * kLanes]

  stage<N * N, kTeam>(s + L::P * kLanes, gxxT, b, B, live, row);
  stage<N, kTeam>(s + L::PV * kLanes, gxT, b, B, live, row);
  const T r = live ? reg[b] : T(0);
  bool ok = true;

  for (int t = Tm1 - 1; t >= 0; --t) {
    const size_t tt = static_cast<size_t>(t);
    stage<N * N, kTeam>(s + L::FX * kLanes, fx + tt * N * N * B, b, B, live, row);
    stage<N * M, kTeam>(s + L::FU * kLanes, fu + tt * N * M * B, b, B, live, row);
    stage<N, kTeam>(s + L::GX * kLanes, gx + tt * N * B, b, B, live, row);
    stage<M, kTeam>(s + L::GU * kLanes, gu + tt * M * B, b, B, live, row);
    stage<N * N, kTeam>(s + L::GXX * kLanes, gxx + tt * N * N * B, b, B, live, row);
    stage<M * M, kTeam>(s + L::GUU * kLanes, guu + tt * M * M * B, b, B, live, row);
    stage<M * N, kTeam>(s + L::GUX * kLanes, gux + tt * M * N * B, b, B, live, row);
    __syncthreads();   // (1) inputs, P and p of the step visible

    // Qx = gx + fx^T p and Qxx = gxx + (fx^T P) fx, row i (state rows);
    // Qu = gu + fu^T p, Quu = guu + (fu^T P) fu, Qux = gux + (fu^T P) fx,
    // row a (control rows)
    T Qx = T(0), Qu = T(0), Qxx[N];
    if (row < N) {
      const int i = row;
      T col[N];   // column i of fx
#pragma unroll
      for (int k = 0; k < N; ++k) col[k] = SH(L::FX + k * N + i);
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += col[k] * SH(L::PV + k);
      Qx = SH(L::GX + i) + acc;
      T fxTP[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += col[k] * SH(L::P + k * N + j);
        fxTP[j] = a2;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += fxTP[k] * SH(L::FX + k * N + j);
        Qxx[j] = SH(L::GXX + i * N + j) + a2;
      }
    } else {
      const int a = row - N;
      T col[N];   // column a of fu
#pragma unroll
      for (int k = 0; k < N; ++k) col[k] = SH(L::FU + k * M + a);
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += col[k] * SH(L::PV + k);
      Qu = SH(L::GU + a) + acc;
      SH(L::QU + a) = Qu;
      T fuTP[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += col[k] * SH(L::P + k * N + j);
        fuTP[j] = a2;
      }
#pragma unroll
      for (int c = 0; c < M; ++c) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += fuTP[k] * SH(L::FU + k * M + c);
        SH(L::QUU + a * M + c) = SH(L::GUU + a * M + c) + a2;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T a2 = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) a2 += fuTP[k] * SH(L::FX + k * N + j);
        SH(L::QUX + a * N + j) = SH(L::GUX + a * N + j) + a2;
      }
    }
    __syncthreads();   // (2) Quu, Qux, Qu visible; the inputs, P, p are dead

    // unrolled Cholesky of Quu + reg*I (lower factor), in every thread
    T Lc[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = SH(L::QUU + i * M + j) + (i == j ? r : T(0));
#pragma unroll
        for (int k = 0; k < j; ++k) acc -= Lc[i][k] * Lc[j][k];
        Lc[i][j] = (i == j) ? sqrt(acc) : acc / Lc[j][j];
      }
    }
    // state row j solves column j of Qux (-> K[:, j]); the first control
    // row solves Qu (-> k) and keeps ok
    if (row <= N) {
      T y[M], x[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        T acc = row < N ? SH(L::QUX + i * N + row) : SH(L::QU + i);
#pragma unroll
        for (int k = 0; k < i; ++k) acc -= Lc[i][k] * y[k];
        y[i] = acc / Lc[i][i];
      }
#pragma unroll
      for (int i = M - 1; i >= 0; --i) {
        T acc = y[i];
#pragma unroll
        for (int k = i + 1; k < M; ++k) acc -= Lc[k][i] * x[k];
        x[i] = acc / Lc[i][i];
      }
      if (row < N) {
#pragma unroll
        for (int a = 0; a < M; ++a) {
          SH(L::K + a * N + row) = -x[a];
          if (live) K_out[((tt * M + a) * N + row) * B + b] = -x[a];
        }
      } else {
#pragma unroll
        for (int a = 0; a < M; ++a) {
          ok = ok && isfinite(Lc[a][a]) && (Lc[a][a] > T(0));
          SH(L::KFF + a) = -x[a];
          if (live) k_out[(tt * M + a) * B + b] = -x[a];
        }
      }
    }
    if (live) {
      if (row < N) {
        Qx_out[(tt * N + row) * B + b] = Qx;
      } else {
        Qu_out[(tt * M + (row - N)) * B + b] = Qu;
      }
    }
    __syncthreads();   // (3) K, k visible

    // Quu K (unregularized Quu), row a
    if (row >= N) {
      const int a = row - N;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < M; ++c) acc += SH(L::QUU + a * M + c) * SH(L::K + c * N + j);
        SH(L::QUUK + a * N + j) = acc;
      }
    }
    __syncthreads();   // (4) Quu K visible

    // P = Qxx + K^T Quu K + K^T Qux + Qux^T K, row i, into shared memory
    // unsymmetrized; p = Qx + (Quu K)^T k + K^T Qu + Qux^T k
    if (row < N) {
      const int i = row;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll
        for (int a = 0; a < M; ++a) {
          t1 += SH(L::K + a * N + i) * SH(L::QUUK + a * N + j);
          t2 += SH(L::K + a * N + i) * SH(L::QUX + a * N + j);
          t3 += SH(L::QUX + a * N + i) * SH(L::K + a * N + j);
        }
        Qxx[j] = ((Qxx[j] + t1) + t2) + t3;   // now row i of the new P
        SH(L::P + i * N + j) = Qxx[j];
      }
      T t1 = T(0), t2 = T(0), t3 = T(0);
#pragma unroll
      for (int a = 0; a < M; ++a) {
        t1 += SH(L::QUUK + a * N + i) * SH(L::KFF + a);
        t2 += SH(L::K + a * N + i) * SH(L::QU + a);
        t3 += SH(L::QUX + a * N + i) * SH(L::KFF + a);
      }
      const T pn = ((Qx + t1) + t2) + t3;
      SH(L::PV + i) = pn;
      if (live) p_out[(tt * N + i) * B + b] = pn;
    }
    __syncthreads();   // (5) the unsymmetrized P visible

    // P = (P + P^T) / 2: row i from the thread's registers and column i
    if (row < N) {
#pragma unroll
      for (int j = 0; j < N; ++j) Qxx[j] = T(0.5) * (Qxx[j] + SH(L::P + j * N + row));
    }
    __syncthreads();   // (6) every column read before any row is replaced
    if (row < N) {
#pragma unroll
      for (int j = 0; j < N; ++j) SH(L::P + row * N + j) = Qxx[j];
    }
    // the next step's barrier (1) makes the new P visible
  }
#undef SH
  if (row == N && live) ok_out[b] = ok ? T(1) : T(0);
}

template <int N, int M, typename T>
int launch(const void* fx, const void* fu, const void* gx, const void* gu,
           const void* gxx, const void* guu, const void* gux,
           const void* gxxT, const void* gxT, const void* reg,
           void* K, void* k, void* Qx, void* Qu, void* p, void* ok,
           int Tm1, int B, void* stream) {
  if (B > 0) {
    const int smem = static_cast<int>(sizeof(T) * Layout<N, M>::TOTAL * kLanes);
    cudaError_t err = cudaFuncSetAttribute(
        riccati_backward_wide_kernel<N, M, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (B + kLanes - 1) / kLanes;
    const dim3 block(kLanes, N + M);
    riccati_backward_wide_kernel<N, M, T>
        <<<blocks, block, smem, static_cast<cudaStream_t>(stream)>>>(
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

// One C entry point per (dtype, n, m), with K1's signature.  Keep this list
// equal to _WIDE_INSTANTIATIONS in iterativelqr_tpu_torch/ops/packed_backward.py.
#define RICCATI_WIDE_ENTRY(NAME, N, M, T)                                     \
  extern "C" int NAME(const void* fx, const void* fu, const void* gx,        \
                      const void* gu, const void* gxx, const void* guu,      \
                      const void* gux, const void* gxxT, const void* gxT,    \
                      const void* reg, void* K, void* k, void* Qx, void* Qu, \
                      void* p, void* ok, int Tm1, int B, void* stream) {     \
    return launch<N, M, T>(fx, fu, gx, gu, gxx, guu, gux, gxxT, gxT, reg, K, \
                           k, Qx, Qu, p, ok, Tm1, B, stream);                \
  }

RICCATI_WIDE_ENTRY(riccati_backward_wide_f32_n12_m4, 12, 4, float)
RICCATI_WIDE_ENTRY(riccati_backward_wide_f64_n12_m4, 12, 4, double)
