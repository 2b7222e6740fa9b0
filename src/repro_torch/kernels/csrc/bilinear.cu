// Bilinear form d_l = a_l^T G_l b_l over a stack of L items (Eq. 13's
// numerator), and the fixed-order partial sum that finishes it.
//
// Replaces the TPU kernels src/repro/kernels/bilinear.py::bilinear and
// ::bilinear_stacked.  Those accumulate into one resident (1, 1) output block
// across a sequential grid; CUDA blocks run concurrently, so here each
// (chunk, item) block writes one f32 partial to scratch and
// repro_bilinear_finish sums each item's partials in a fixed order (see
// common.cuh for the partition and why stacked equals per-item bit for bit).
// The finishing launch also returns |a|^2 and |b|^2 per item, summed in a
// fixed order, for the Eq. 13 denominator.
//
// Bound on an H100: bytes.  G is read once (4 or 2 bytes per element), a and
// b are read once per element from L1/L2, and the work is 2 multiplies and an
// add per element, far below the card's f32 rate.  The design streams G with
// coalesced loads, one pass, with no second read; the finishing launch
// touches L * chunks floats.  It uses no wgmma or TMA: there is no product to
// feed them.
#include "common.cuh"

namespace repro {

// One block: the chunk blockIdx.x of item blockIdx.y.  Each element adds
// (a_i * g_ij) * b_j, the Pallas tile formula, with the products rounded
// separately so that the compiler does not fuse them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bilinear_partials_kernel(const T* __restrict__ g,
                             const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ partials, int d_in,
                             int d_out) {
  const int n = d_in * d_out;
  const long long item = blockIdx.y;
  const T* gl = g + item * n;
  const float* al = a + item * d_in;
  const float* bl = b + item * d_out;
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, n);
  float acc[1] = {0.0f};
  for (int e = start + threadIdx.x; e < end; e += kThreads) {
    const int i = e / d_out;
    const int j = e - i * d_out;
    acc[0] += __fmul_rn(__fmul_rn(al[i], to_f32(gl[e])), bl[j]);
  }
  block_sum<1>(acc);
  if (threadIdx.x == 0) partials[item * gridDim.x + blockIdx.x] = acc[0];
}

// out[l, k] = sum over p of partials[l, p, k], in the order p = lane,
// lane + 32, ... within a warp, then a fixed shuffle tree.  One warp per item.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    float* __restrict__ out, int n_partials,
                                    int k_values) {
  const long long item = blockIdx.x;
  const int lane = threadIdx.x;
  for (int k = 0; k < k_values; ++k) {
    float s = 0.0f;
    for (int p = lane; p < n_partials; p += 32)
      s += partials[(item * n_partials + p) * k_values + k];
    s = warp_sum(s);
    if (lane == 0) out[item * k_values + k] = s;
  }
}

// The finishing launch of aT G b: dot[l] from the partials, as
// sum_partials_kernel, and sq[l] = [|a_l|^2, |b_l|^2] in the same fixed
// order, so that the wrapper's denominator gamma + |a|^2 |b|^2 is also the
// same for an item alone or in a stack.  One warp per item.
__global__ void bilinear_finish_kernel(const float* __restrict__ partials,
                                       const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float* __restrict__ dot,
                                       float* __restrict__ sq, int n_partials,
                                       int d_in, int d_out) {
  const long long item = blockIdx.x;
  const int lane = threadIdx.x;
  float s = 0.0f, sa = 0.0f, sb = 0.0f;
  for (int p = lane; p < n_partials; p += 32)
    s += partials[item * n_partials + p];
  for (int i = lane; i < d_in; i += 32) {
    const float v = a[item * d_in + i];
    sa += __fmul_rn(v, v);
  }
  for (int j = lane; j < d_out; j += 32) {
    const float v = b[item * d_out + j];
    sb += __fmul_rn(v, v);
  }
  s = warp_sum(s);
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  if (lane == 0) {
    dot[item] = s;
    sq[2 * item] = sa;
    sq[2 * item + 1] = sb;
  }
}

}  // namespace repro

extern "C" {

int repro_chunk_elems() { return repro::kChunk; }

// partials: (L, chunks) f32 scratch, chunks = ceil(d_in * d_out / kChunk).
int repro_bilinear_partials(const void* g, int g_is_bf16, const void* a,
                            const void* b, void* partials, long long L,
                            long long d_in, long long d_out, void* stream) {
  const dim3 grid(repro::num_chunks(d_in * d_out), static_cast<unsigned>(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    repro::bilinear_partials_kernel<__nv_bfloat16>
        <<<grid, repro::kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(a),
            static_cast<const float*>(b), static_cast<float*>(partials),
            static_cast<int>(d_in), static_cast<int>(d_out));
  else
    repro::bilinear_partials_kernel<float><<<grid, repro::kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(partials),
        static_cast<int>(d_in), static_cast<int>(d_out));
  return static_cast<int>(cudaGetLastError());
}

// partials: (L, chunks) from repro_bilinear_partials -> dot (L,) f32 and
// sq (L, 2) f32 = [|a|^2, |b|^2].
int repro_bilinear_finish(const void* partials, const void* a, const void* b,
                          void* dot, void* sq, long long L,
                          long long n_partials, long long d_in,
                          long long d_out, void* stream) {
  repro::bilinear_finish_kernel<<<static_cast<unsigned>(L), 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(dot),
      static_cast<float*>(sq), static_cast<int>(n_partials),
      static_cast<int>(d_in), static_cast<int>(d_out));
  return static_cast<int>(cudaGetLastError());
}

// partials: (L, n_partials, k_values) f32 -> out: (L, k_values) f32.
int repro_sum_partials(const void* partials, void* out, long long L,
                       long long n_partials, long long k_values,
                       void* stream) {
  repro::sum_partials_kernel<<<static_cast<unsigned>(L), 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<float*>(out),
      static_cast<int>(n_partials), static_cast<int>(k_values));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
