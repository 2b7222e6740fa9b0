// Shared device code of the port's kernels.  matvec_cols.cu takes only the
// type helpers (to_f32); the Eva kernels (bilinear.cu, rank1_update.cu,
// eva_fused.cu, matvec.cu, eva_f_fused.cu) share the rest.
//
// Work partition of the Eva kernels.  Each cuts each stack item's flattened G
// (d_in * d_out elements, row-major) into contiguous chunks of kChunk
// elements and gives one block of kThreads threads to each (chunk, item)
// pair: grid = (chunks, L).  Thread t of a block visits the chunk's elements
// t, t + kThreads, t + 2 kThreads, ... so neighbouring threads read
// neighbouring addresses.  The partition depends on d_in * d_out alone, never
// on L, so an item of a stack is reduced exactly as it would be alone: the
// stacked and per-item launches agree bit for bit.
//
// Reductions are deterministic: a fixed warp-shuffle tree inside each warp,
// then the warp sums in a fixed order, one f32 partial per block written to
// scratch, and a second launch (repro_sum_partials) that sums each item's
// partials in a fixed order.  No float atomics anywhere.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8192;  // elements of one item per block (32 per thread)

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

// The emit body of the fused kernels over elements [start, end) of one item:
// P = rank1_elem(...), out = mu * m + P (kFold) or P, written in f32, and the
// block's [<out,G>, <out,out>, <G,G>] partial written to dst[0..2] by thread 0.
// Every thread of the block must call it.
template <typename T, bool kFold>
__device__ __forceinline__ void emit_rank1_chunk(
    const T* __restrict__ gl, const float* __restrict__ al,
    const float* __restrict__ bl, float coeff, float scale, float mu,
    const float* __restrict__ ml, float* __restrict__ ol, int start, int end,
    int d_out, float* __restrict__ dst) {
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int e = start + threadIdx.x; e < end; e += kThreads) {
    const int i = e / d_out;
    const int j = e - i * d_out;
    const float gv = to_f32(gl[e]);
    const float p = rank1_elem(gv, al[i], bl[j], coeff, scale);
    const float o = kFold ? __fadd_rn(__fmul_rn(mu, ml[e]), p) : p;
    ol[e] = o;
    acc[0] += o * gv;
    acc[1] += o * o;
    acc[2] += gv * gv;
  }
  block_sum<3>(acc);
  if (threadIdx.x == 0) {
    dst[0] = acc[0];
    dst[1] = acc[1];
    dst[2] = acc[2];
  }
}

inline int num_chunks(long long n, int chunk = kChunk) {
  return static_cast<int>((n + chunk - 1) / chunk);
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
