// The derive kernel of the batched AL-iLQR solver's SL loop: the stage
// functions' Jacobians, gradients and Hessians at every (lane, stage) in
// one launch.  Included by each translation unit of a derive model
// (iterativelqr_tpu_torch/ops/derive_kernel.py, built by
// _build.py::build_generated), after the model's generated header.
//
// It replaces no Pallas kernel: the JAX package leaves derive
// (iterativelqr_tpu/ops/packed_pipeline.py, the vmapped jacfwd/grad stacks)
// to XLA, which fuses it.  Its plain version is the torch.func path of
// iterativelqr_tpu_torch/ops/packed_pipeline.py::make_derive_backward_sl,
// where each tiny product of the vmapped graphs is a batched gemv.
//
// What it computes, per lane b and stage t, from xs [T,NX,B], us [T-1,NU,B]
// and ws [T,NW,B]: for t < T-1 the model's stage program at (x_t, u_t, w_t)
// -> fx [NX,NX], fu [NX,NU], gx [NX], gu [NU], gxx [NX,NX], guu [NU,NU],
// gux [NU,NX], cx [NC,NX], cu [NC,NU]; for t = T-1 its terminal program at
// (x_T, u = 0, w_T) -> gx, gxx, cx.  Each output goes straight into its
// batch-last stack [T-1 or T, *dims, B] (row t; gx, gxx and cx have the
// terminal row), the layout the AL augmentation reads; padded rows are the
// programs' literal zeros.  The programs are the traced functions' scalar
// programs (ops/device_functions.py): the same functions evaluated in
// registers, in the traced order, literals cast to T.
//
// What bounds it: bytes.  A lane reads (T-1)(NX+NU+NW) + NX + NW values and
// writes (T-1)(NX^2 + NX NU + NU + NU^2 + NU NX + NC NU) + T(NX + NX^2 +
// NC NX).  The car (3, 2), NC = 5, T=51 at 131072 lanes, f32: 3,480
// values a lane, 1.82 GB, 0.545 ms at 3.35 TB/s; its stage program is
// about 110 operations, so a thread's arithmetic hides behind its stores.
//
// Design.  One thread a (lane, stage) over a grid of ceil(B / 128) x T
// blocks (blockIdx.y is the stage, so a block never diverges between the
// stage and the terminal program), the terminal stage in the same launch:
// one launch a derive.  A warp's 32 threads are neighbouring lanes, so
// every load of x, u, w and every store of an output entry is one
// coalesced run of 32 values.  Each stack is written once, with no
// intermediate in device memory; the generated function hands each entry
// to out(k, j, v) with constant k and j, which the compiler resolves to
// one store at the stack's row address.
//
// Build: iterativelqr_tpu_torch/_build.py.  One plain C entry point a
// (model, dtype) (DERIVE_ENTRY); it returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kDeriveThreads = 128;
constexpr int kDeriveStacks = 9;   // len(STACKS) in ops/derive_kernel.py
constexpr int kMaxStages = 65535;  // MAX_HORIZON: the grid's y dimension

// the stacks' base pointers, in ops/derive_kernel.py's STACKS order (fx,
// fu, gx, gu, gxx, guu, gux, cx, cu); cx and cu are unused without
// constraint rows
template <typename T>
struct DeriveStacks {
  T* p[kDeriveStacks];
};

// entries a (lane, stage) writes into stack k
template <typename M>
__host__ __device__ constexpr int stack_entries(int k) {
  return k == 0 ? M::NX * M::NX : k == 1 ? M::NX * M::NU : k == 2 ? M::NX
       : k == 3 ? M::NU : k == 4 ? M::NX * M::NX : k == 5 ? M::NU * M::NU
       : k == 6 ? M::NU * M::NX : k == 7 ? M::NC * M::NX : M::NC * M::NU;
}

// the size of a local array that holds N values (a zero-size array is not
// C++)
template <int N>
__host__ __device__ constexpr int derive_slots() { return N > 0 ? N : 1; }

// the store of one (lane, stage)'s entry j of stack k: row t of the stack,
// lane b
template <typename M, typename T>
struct DeriveOut {
  DeriveStacks<T> s;
  size_t t, b, B;
  __host__ __device__ __forceinline__ void operator()(int k, int j, T v) const {
    s.p[k][(t * stack_entries<M>(k) + j) * B + b] = v;
  }
};

template <typename M, typename T>
__global__ void __launch_bounds__(kDeriveThreads)
sl_derive_kernel(const T* __restrict__ xs, const T* __restrict__ us,
                 const T* __restrict__ ws, DeriveStacks<T> stacks, int horizon, int B) {
  const int lane = blockIdx.x * kDeriveThreads + threadIdx.x;
  if (lane >= B) return;   // no shuffle or barrier follows
  const size_t Bs = static_cast<size_t>(B), b = static_cast<size_t>(lane);
  const size_t t = blockIdx.y;
  T x[M::NX], u[derive_slots<M::NU>()], w[derive_slots<M::NW>()];
#pragma unroll
  for (int i = 0; i < M::NX; ++i) x[i] = xs[(t * M::NX + i) * Bs + b];
#pragma unroll
  for (int i = 0; i < M::NW; ++i) w[i] = ws[(t * M::NW + i) * Bs + b];
  const DeriveOut<M, T> out{stacks, t, b, Bs};
  if (t + 1 < static_cast<size_t>(horizon)) {
#pragma unroll
    for (int i = 0; i < M::NU; ++i) u[i] = us[(t * M::NU + i) * Bs + b];
    M::template stage<T>(x, u, w, out);
  } else {
    M::template terminal<T>(x, w, out);
  }
}

template <typename M, typename T>
int launch_derive(const void* xs, const void* us, const void* ws, void* const* stacks,
                  int horizon, int B, void* stream) {
  if (horizon > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && horizon > 0) {
    DeriveStacks<T> s;
    for (int k = 0; k < kDeriveStacks; ++k) s.p[k] = static_cast<T*>(stacks[k]);
    const dim3 grid((B + kDeriveThreads - 1) / kDeriveThreads, horizon);
    sl_derive_kernel<M, T><<<grid, kDeriveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(xs), static_cast<const T*>(us), static_cast<const T*>(ws), s,
        horizon, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry point of one (model, dtype), named as
// ops/derive_kernel.py looks it up: sl_derive_<DeriveModel.name>_<f32|f64>.
// stacks: kDeriveStacks pointers (nullptr past the model's stacks).
#define DERIVE_ENTRY(NAME, MODEL, T)                                                  \
  extern "C" int sl_derive_##NAME(const void* xs, const void* us, const void* ws,     \
                                  void* const* stacks, int horizon, int B,            \
                                  void* stream) {                                     \
    return launch_derive<MODEL, T>(xs, us, ws, stacks, horizon, B, stream);           \
  }
