// Rank-one update P_l = s_l * (G_l - c_l * a_l b_l^T) over a stack of L
// items (the second half of Eq. 13).
//
// Replaces the TPU kernels src/repro/kernels/rank1_update.py::rank1_update
// and ::rank1_update_stacked.  Where those pad G up to a multiple of the tile
// (tiles.fit_block) and slice the pad off, this kernel walks each item's
// flattened G in chunks (common.cuh) and stops at the item's last element, so
// ragged shapes such as 1000 x 513 and 30 x 250 need no padding.
//
// Bound on an H100: bytes.  G is read once and P written once; a, b and the
// (L, 2) [coeff, scale] pairs are tiny and stay in L1/L2.  Three multiplies
// and a subtract per element are far below the f32 rate.  Compute is f32 and
// P has G's dtype.  The products are rounded one at a time (rank1_elem in
// common.cuh) in the reference's order, scale * (g - coeff * (a_i * b_j)),
// so the result equals the plain PyTorch version bit for bit.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rank1_update_kernel(const T* __restrict__ g, const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ cs, T* __restrict__ out,
                        int d_in, int d_out) {
  const int n = d_in * d_out;
  const long long item = blockIdx.y;
  const T* gl = g + item * n;
  T* ol = out + item * n;
  const float* al = a + item * d_in;
  const float* bl = b + item * d_out;
  const float coeff = cs[2 * item];
  const float scale = cs[2 * item + 1];
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, n);
  for (int e = start + threadIdx.x; e < end; e += kThreads) {
    const int i = e / d_out;
    const int j = e - i * d_out;
    ol[e] = from_f32<T>(
        rank1_elem(to_f32(gl[e]), al[i], bl[j], coeff, scale));
  }
}

}  // namespace repro

extern "C" {

// cs: (L, 2) f32 device tensor of [coeff, scale] per item.
int repro_rank1_update(const void* g, int g_is_bf16, const void* a,
                       const void* b, const void* cs, void* out, long long L,
                       long long d_in, long long d_out, void* stream) {
  const dim3 grid(repro::num_chunks(d_in * d_out), static_cast<unsigned>(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    repro::rank1_update_kernel<__nv_bfloat16><<<grid, repro::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<const float*>(cs),
        static_cast<__nv_bfloat16*>(out), static_cast<int>(d_in),
        static_cast<int>(d_out));
  else
    repro::rank1_update_kernel<float><<<grid, repro::kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<const float*>(cs),
        static_cast<float*>(out), static_cast<int>(d_in),
        static_cast<int>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
