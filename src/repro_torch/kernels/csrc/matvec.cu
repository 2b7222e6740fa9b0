// Vector-matrix product u_l = a_l^T G_l over a stack of L items (Eq. 21's
// u = a^T G), and the fixed-order finishing launch that also gives |a_l|^2.
//
// Replaces the TPU kernels src/repro/kernels/matvec.py::matvec and
// ::matvec_stacked.  Those accumulate each (bn,) output block in VMEM across
// a sequential reduction grid axis over d_in.  CUDA blocks run concurrently,
// so here the reduction over d_in is cut in two launches:
//
//   1. repro_matvec_partials: block (x, y, l) covers a strip of kMvCols
//      columns and the row chunk [y * kMvRows, (y + 1) * kMvRows) of item l.
//      Thread t owns column x * kMvCols + t and walks the chunk's rows in
//      order, so a warp reads 32 neighbouring values of one row: coalesced.
//      It writes one f32 partial per (item, row chunk, column).
//   2. repro_matvec_finish: one thread per (item, column) sums the row-chunk
//      partials in chunk order into u; the first block of each item also sums
//      |a_l|^2 with one warp (the order of bilinear.cu's finishing launch), so
//      Eq. 21's denominator gamma + |a|^2 is the same for an item alone or in
//      a stack.
//
// The partition depends on (d_in, d_out) alone, never on L, and there is no
// float atomicAdd: a stacked launch equals the per-item launches bit for bit.
// The kernels stop at the ragged edge (d_in or d_out not a multiple of the
// strip or chunk) instead of padding.
//
// Bound on an H100: bytes.  G is read once; a is read once per column strip
// from L1/L2; the work is a multiply and an add per element, far below the
// f32 rate.  The partials add 4 * d_in * d_out / kMvRows bytes each way
// (1/16 of an f32 G).  Short chunks give the autoencoder's 784 x 1000 layer
// 8 x 49 = 392 blocks, about three per SM, where one 8192-element chunk per
// block (bilinear.cu) gives under one.
#include "common.cuh"

namespace repro {

constexpr int kMvCols = 128;  // columns per block, one per thread
constexpr int kMvRows = 16;   // rows of one item per block

template <typename T>
__global__ void __launch_bounds__(kMvCols)
    matvec_partials_kernel(const T* __restrict__ g,
                           const float* __restrict__ a,
                           float* __restrict__ partials, int d_in,
                           int d_out) {
  const long long item = blockIdx.z;
  const int j = blockIdx.x * kMvCols + threadIdx.x;
  if (j >= d_out) return;
  const int r0 = blockIdx.y * kMvRows;
  const int r1 = min(r0 + kMvRows, d_in);
  const T* gl = g + item * d_in * d_out;
  const float* al = a + item * d_in;
  float acc = 0.0f;
  for (int i = r0; i < r1; ++i)
    acc += __fmul_rn(al[i], to_f32(gl[static_cast<long long>(i) * d_out + j]));
  partials[(item * gridDim.y + blockIdx.y) * d_out + j] = acc;
}

// u[l, j] = sum over chunks c of partials[l, c, j], c in order; asq[l] =
// |a_l|^2 from the first block of item l.
__global__ void __launch_bounds__(kMvCols)
    matvec_finish_kernel(const float* __restrict__ partials,
                         const float* __restrict__ a, float* __restrict__ u,
                         float* __restrict__ asq, int n_chunks, int d_in,
                         int d_out) {
  const long long item = blockIdx.y;
  const int j = blockIdx.x * kMvCols + threadIdx.x;
  if (j < d_out) {
    const float* p = partials + item * n_chunks * d_out + j;
    float s = 0.0f;
    for (int c = 0; c < n_chunks; ++c)
      s += p[static_cast<long long>(c) * d_out];
    u[item * d_out + j] = s;
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float sa = 0.0f;
    for (int i = threadIdx.x; i < d_in; i += 32) {
      const float v = a[item * d_in + i];
      sa += __fmul_rn(v, v);
    }
    sa = warp_sum(sa);
    if (threadIdx.x == 0) asq[item] = sa;
  }
}

inline unsigned n_strips(long long d_out) {
  return static_cast<unsigned>((d_out + kMvCols - 1) / kMvCols);
}

}  // namespace repro

extern "C" {

int repro_matvec_rows() { return repro::kMvRows; }

// partials: (L, ceil(d_in / kMvRows), d_out) f32 scratch.
int repro_matvec_partials(const void* g, int g_is_bf16, const void* a,
                          void* partials, long long L, long long d_in,
                          long long d_out, void* stream) {
  const dim3 grid(repro::n_strips(d_out),
                  repro::num_chunks(d_in, repro::kMvRows),
                  static_cast<unsigned>(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    repro::matvec_partials_kernel<__nv_bfloat16>
        <<<grid, repro::kMvCols, 0, s>>>(
            static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(a),
            static_cast<float*>(partials), static_cast<int>(d_in),
            static_cast<int>(d_out));
  else
    repro::matvec_partials_kernel<float><<<grid, repro::kMvCols, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(a),
        static_cast<float*>(partials), static_cast<int>(d_in),
        static_cast<int>(d_out));
  return static_cast<int>(cudaGetLastError());
}

// partials from repro_matvec_partials -> u (L, d_out) f32, asq (L,) f32.
int repro_matvec_finish(const void* partials, const void* a, void* u,
                        void* asq, long long L, long long n_chunks,
                        long long d_in, long long d_out, void* stream) {
  const dim3 grid(repro::n_strips(d_out), static_cast<unsigned>(L));
  repro::matvec_finish_kernel<<<grid, repro::kMvCols, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<const float*>(a),
      static_cast<float*>(u), static_cast<float*>(asq),
      static_cast<int>(n_chunks), static_cast<int>(d_in),
      static_cast<int>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
