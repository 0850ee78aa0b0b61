// A ring of shared-memory tiles that a producer warp fills with the step
// inputs of a batch-last recursion while the block's other warps compute:
// shared by the recursion templates of K1 (riccati_backward.cuh) and K2
// (riccati_backward_wide.cuh, whose last warp doubles as the producer)
// and the rollout body of K3/K4 (sl_forward.cu).
//
// A tile holds rows of one step for the 32 neighbouring lanes of a block,
// laid out [row][32 lanes].  Row r of step t of a batch-last array
// A [.., R, B] for lanes [b0, b0+32) is one contiguous run at
// A + (t*R + r)*B + b0: 128 bytes in f32, 256 in f64.  The producer copies
// the runs with cp.async (LDGSTS): 16-byte chunks when every run is 16-byte
// aligned (the caller checks the base pointers and B * sizeof(T) on the
// host, runs_aligned), else one value per copy.  Lanes >= B are zero-filled
// and read nothing (src-size 0).
//
// Why a producer warp: a warp that issues its own copies stalls in the
// issue once the SM's outstanding requests are full, about as long as its
// arithmetic takes (a cycle-counter probe on the H100), so the copies go to
// a warp of their own and the compute warps wait only when the ring is
// empty.  (Bulk copies through the TMA, one per 128-byte run, measured
// slower than these.)  Each tile has two mbarriers: `full` (each producer
// thread arrives when its copies have landed: cp.async.mbarrier.arrive) and
// `empty` (each compute thread arrives once it has read the tile).  Step i
// uses tile i % D in phase (i / D) & 1.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace ring {

constexpr int kLanes = 32;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES (16, or one value: 4 or 8) by cp.async; zero-filled, reading
// nothing, where !valid
template <int BYTES>
__device__ __forceinline__ void copy(void* dst, const void* src, bool valid) {
  const unsigned d = smem_addr(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(n) : "memory");
  }
}

// wait for every cp.async this thread issued
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void bar_init(std::uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// make the barriers' initialisation visible (then the block synchronises)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(std::uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// arrive once every cp.async this thread has issued so far has landed
__device__ __forceinline__ void bar_arrive_on_copies(std::uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(std::uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// ---- copies ----------------------------------------------------------------

// Rows [0, E) of step t of A [.., R, B] for lanes [b0, b0+W) into
// dst [E][W] (W = 32 but in K2's template at wide dims, which may take 16,
// 8 or 4 lanes a block, and the tall template's 8, 4, 2 or 1), by the NT
// threads of the producer warps (tid < NT).  vec: a row is kChunks 16-byte
// chunks; thread tid copies chunk tid % kChunks of rows tid / kChunks,
// + G, + 2G, ... (G = NT / kChunks), so its lanes, their validity and its
// source column are fixed and only the row offset moves; else (and where a
// row is shorter than 16 bytes) each thread copies one value (its lane
// tid % W) of rows tid / W, + NT / W, ...  Lanes past B are zero-filled
// and read nothing.
template <int E, int R, int NT, int W = kLanes, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ A, size_t t,
                                          size_t B, size_t b0, int tid, bool vec) {
  static_assert(NT % kLanes == 0, "whole producer warps");
  static_assert(W * sizeof(T) % 16 == 0 || W * sizeof(T) < 16,
                "a row of a tile is whole 16-byte chunks, or shorter than one");
  constexpr bool kChunked = W * sizeof(T) % 16 == 0;
  const T* step = A + t * R * B;
  if (kChunked && vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values a chunk
    constexpr int kChunks = kChunked ? W / kPer : 1;        // chunks a row
    constexpr int G = NT / kChunks;
    const int q = tid % kChunks;
    const size_t b = b0 + static_cast<size_t>(q * kPer);
    const bool valid = b < B;
    const T* src = valid ? step + b : A;
    const size_t dB = valid ? B : 0;
#pragma unroll
    for (int k = 0; k < (E + G - 1) / G; ++k) {
      const int e = tid / kChunks + k * G;
      if (e < E) copy<16>(dst + e * W + q * kPer, src + e * dB, valid);
    }
  } else {
    // up to F rows a thread: a loop, not unrolled, keeps its registers few
    constexpr int G = NT / W;
    const int q = tid % W;
    const size_t b = b0 + static_cast<size_t>(q);
    const bool valid = b < B;
    const T* src = valid ? step + b : A;
    const size_t dB = valid ? B : 0;
#pragma unroll 1
    for (int e = tid / W; e < E; e += G)
      copy<sizeof(T)>(dst + e * W + q, src + e * dB, valid);
  }
}

// Host side: may the rows go as 16-byte chunks (16-byte aligned runs)?
template <typename T>
inline bool runs_aligned(size_t B, std::initializer_list<const void*> ptrs) {
  if ((B * sizeof(T)) % 16 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// Host side: let `kernel` take `bytes` of dynamic shared memory (above the
// 48 KB default) on the current device, once per kernel and device.
template <class Kernel>
inline cudaError_t allow_shared(Kernel kernel, int bytes, unsigned long long& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace ring
