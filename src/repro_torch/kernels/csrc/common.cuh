// Shared device code of the port's kernels.  matvec_cols.cu takes only the
// type helpers (to_f32); the Eva kernels (rank1_update.cu, matvec.cuh and
// the row-tile kernels of eva_tiles.cuh: eva_fused.cu, bilinear.cu,
// eva_f_fused.cu) share the rest.  Each kernel has its own partition (see
// its header) and takes from here the reduction rules below, the block sum,
// the vector loads, the warp norm, rank1_elem and the last-block finish.
//
// Reductions are deterministic: a fixed warp-shuffle tree inside each warp,
// then the warp sums in a fixed order, and every partial summed in an order
// that the partition fixes.  No float atomics anywhere.  A reduction across
// blocks finishes inside its launch (last_arrival below): each block writes
// its partial, takes a ticket from an integer arrival counter, and the block
// that draws the last ticket sums the partials of its group in a fixed
// order.  The ticket only picks which block sums; what is summed, and in
// which order, is fixed by the partition, so the bits are those of a
// separate finishing launch.  Integer atomics are exact, and their order
// decides no value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;  // threads of a block that calls block_sum
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Sums K values per thread over the block in a fixed order.  The totals are
// valid in thread 0 only.  Every thread of the block must call it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K]) {
  __shared__ float warp_sums[K][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    if (lane == 0) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = lane < kWarps ? warp_sums[k][lane] : 0.0f;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1)
        v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }
}

// Fixed-order sum of a warp's values; the total lands in lane 0.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// One element of the rank-one update, scale * (g - coeff * (a_i * b_j)), each
// product rounded on its own in the reference's order (_rank1_tile in
// src/repro/kernels/rank1_update.py), so no multiply-add is fused.
__device__ __forceinline__ float rank1_elem(float g, float a_i, float b_j,
                                            float coeff, float scale) {
  return __fmul_rn(scale, __fsub_rn(g, __fmul_rn(coeff, __fmul_rn(a_i, b_j))));
}

// ---------------------------------------------------------------------------
// Vector loads and the last-block finish of matvec.cuh and eva_tiles.cuh.

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = unsigned int;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = unsigned short;
};

__device__ __forceinline__ float bits_to_f32(unsigned int b) {
  return __uint_as_float(b);
}
// bf16 -> f32 is exact: the bf16 bits are the f32's upper half
__device__ __forceinline__ float bits_to_f32(unsigned short b) {
  return __uint_as_float(static_cast<unsigned int>(b) << 16);
}

// N consecutive elements of T from p, as f32: one 8- or 16-byte load when
// vec (the caller has checked p's alignment and that all N are in range),
// else cnt scalar loads and zeros past them.  The values are the same
// either way; only the number of memory transactions differs.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, int cnt,
                                         bool vec, float (&x)[N]) {
  using B = typename Bits<T>::type;
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes == 8 || kBytes == 16, "8- or 16-byte vectors only");
  union {
    uint4 v16;
    uint2 v8;
    B b[N];
  } u;
  if (vec) {
    if constexpr (kBytes == 16)
      u.v16 = __ldg(reinterpret_cast<const uint4*>(p));
    else
      u.v8 = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    const B* q = reinterpret_cast<const B*>(p);
#pragma unroll
    for (int k = 0; k < N; ++k) u.b[k] = k < cnt ? __ldg(q + k) : B(0);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = bits_to_f32(u.b[k]);
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// |v|^2 over n values, summed by one warp: lane l adds v[l]^2, v[l + 32]^2,
// ... in that order, then warp_sum; the total lands in lane 0, with the
// loads issued kBatch at a time (zeros past n: s + 0 * 0 is s, since
// s >= +0).
template <int kBatch>
__device__ __forceinline__ float warp_sumsq(const float* __restrict__ v,
                                            int n) {
  float s = 0.0f;
  for (int k = threadIdx.x & 31; k < n; k += kBatch * 32) {
    float y[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      y[q] = k + 32 * q < n ? __ldg(v + k + 32 * q) : 0.0f;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) s += __fmul_rn(y[q], y[q]);
  }
  return warp_sum(s);
}

// The arrival of one block at its group's integer ticket counter.  Returns
// true, in every thread of the block, for the block that arrives last;
// that block then reads the group's partials (with __ldcg, past the SM's
// own L1) and resets the counter to 0 for the next launch.  Every thread
// must call it, after storing its share of the partials.  The memory
// ordering is that of the cooperative-groups grid barrier: the block
// barrier orders every thread's stores before thread 0's device-scope
// fence, whose cumulativity makes them visible to any thread that sees the
// ticket taken after it; thread 0 takes the ticket and broadcasts the
// verdict through shared memory, and the last block's thread 0 fences
// again before the barrier that lets the block read the partials.  One
// fence per block, where a fence in every thread would wait on every
// thread's stores in turn.
__device__ __forceinline__ bool last_arrival(unsigned int* counter,
                                             unsigned int blocks) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1u) == blocks - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

}  // namespace repro

// Each source compiles into a shared library of its own, so each carries one
// copy of this.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A kernel that does nothing: chip_smoke.py times its launch as the floor
// that every launch of the port pays.
namespace repro {
__global__ void empty_kernel() {}
}  // namespace repro

extern "C" int repro_empty(void* stream) {
  repro::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
