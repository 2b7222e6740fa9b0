// Rank-one update P_l = s_l * (G_l - c_l * a_l b_l^T) over a stack of L
// items (the second half of Eq. 13).
//
// Replaces the TPU kernels src/repro/kernels/rank1_update.py::rank1_update
// and ::rank1_update_stacked.  Where those pad G up to a multiple of the tile
// (tiles.fit_block) and slice the pad off, this kernel streams each item's
// flattened G and stops at the item's last element, so ragged shapes such as
// 1000 x 513 and 30 x 250 need no padding.
//
// Bound on an H100: bytes.  G is read once and P written once; a, b and the
// coefficients are tiny and stay in L1/L2.  Three multiplies and a subtract
// per element are far below the f32 rate, so the design is all about bytes
// in flight:
//   * 16-byte loads and stores (4 f32 or 8 bf16 elements a vector);
//   * kR1Threads-thread blocks, enough of them that every SM holds several,
//     each thread walking its item's vectors in a grid-stride loop (one
//     vector a thread on the autoencoder's layers);
//   * the row index worked out once per vector, not once per element;
//   * a, b and the coefficients read through the read-only path.
// An item whose base is not 16-byte aligned (the second item of a 129 x 127
// stack, a view with a storage offset) takes a scalar head up to the first
// aligned element, and an item whose length is not a multiple of the vector
// width a scalar tail; nothing is padded.  Where G and P sit at different
// offsets from a 16-byte boundary the item runs scalar throughout.
//
// The partition reduces nothing, so it cannot change a bit.  Every element
// is rank1_elem (common.cuh), the products rounded one at a time in the
// reference's order, so P equals the plain PyTorch version bit for bit and
// a stacked launch equals the per-item launches.
//
// The coefficients come through two pointers with a stride each, so the
// caller passes coeff (L,) and scale (L,) as they are, or the reference's
// (L, 2) [coeff, scale] pairs with stride 2, without stacking them first.
#include "common.cuh"

namespace repro {

constexpr int kR1Threads = 256;
constexpr int kR1BlocksPerSm = 8;  // 2048 threads: a full SM

template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void r1_scalar(const T* __restrict__ gl,
                                          T* __restrict__ ol,
                                          const float* __restrict__ al,
                                          const float* __restrict__ bl,
                                          float coeff, float scale, int e,
                                          int d_out) {
  const int i = e / d_out;
  const int j = e - i * d_out;
  ol[e] = from_f32<T>(
      rank1_elem(to_f32(gl[e]), __ldg(al + i), __ldg(bl + j), coeff, scale));
}

template <typename T>
__global__ void __launch_bounds__(kR1Threads)
    rank1_update_kernel(const T* __restrict__ g, const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ coeffs, long long c_stride,
                        const float* __restrict__ scales, long long s_stride,
                        T* __restrict__ out, int d_in, int d_out) {
  constexpr int V = Vec16<T>::kN;
  const int n = d_in * d_out;
  const long long item = blockIdx.y;
  const T* gl = g + item * n;
  T* ol = out + item * n;
  const float* al = a + item * d_in;
  const float* bl = b + item * d_out;
  const float coeff = __ldg(coeffs + item * c_stride);
  const float scale = __ldg(scales + item * s_stride);
  const int tid = blockIdx.x * kR1Threads + threadIdx.x;
  const int stride = gridDim.x * kR1Threads;

  const uintptr_t gaddr = reinterpret_cast<uintptr_t>(gl);
  const uintptr_t oaddr = reinterpret_cast<uintptr_t>(ol);
  if ((gaddr - oaddr) % 16 != 0) {  // never both aligned: scalar throughout
    for (int e = tid; e < n; e += stride)
      r1_scalar(gl, ol, al, bl, coeff, scale, e, d_out);
    return;
  }
  // elements before the first 16-byte boundary of G (and so of P)
  const int head = min(static_cast<int>(((16 - gaddr % 16) % 16) / sizeof(T)),
                       n);
  const int n_vec = (n - head) / V;
  const int tail = head + n_vec * V;
  if (tid < head) r1_scalar(gl, ol, al, bl, coeff, scale, tid, d_out);
  if (tid < n - tail) r1_scalar(gl, ol, al, bl, coeff, scale, tail + tid,
                                d_out);
  const uint4* gv = reinterpret_cast<const uint4*>(gl + head);
  uint4* ov = reinterpret_cast<uint4*>(ol + head);
  for (int v = tid; v < n_vec; v += stride) {
    const int e0 = head + v * V;
    int i = e0 / d_out;
    int j = e0 - i * d_out;
    const uint4 raw = gv[v];
    const T* x = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* y = reinterpret_cast<T*>(&res);
    float a_i = __ldg(al + i);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      y[k] = from_f32<T>(
          rank1_elem(to_f32(x[k]), a_i, __ldg(bl + j), coeff, scale));
      if (++j == d_out && k + 1 < V) {
        j = 0;
        a_i = __ldg(al + ++i);
      }
    }
    ov[v] = res;  // cached: the optimizer reads P next
  }
}

// SM count of the current device, read once per device.
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = counts[dev & 63];
  if (c == 0) cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
  return c;
}

template <typename T>
cudaError_t launch_rank1(const void* g, const void* a, const void* b,
                         const void* coeffs, long long c_stride,
                         const void* scales, long long s_stride, void* out,
                         long long L, long long d_in, long long d_out,
                         cudaStream_t s) {
  const long long n_vec = d_in * d_out / Vec16<T>::kN + 1;
  // enough blocks to fill every SM, spread over the items; no more than the
  // vectors need
  const long long per_item = (static_cast<long long>(sm_count()) *
                                  kR1BlocksPerSm + L - 1) / L;
  const long long need = (n_vec + kR1Threads - 1) / kR1Threads;
  const dim3 grid(static_cast<unsigned>(need < per_item ? need : per_item),
                  static_cast<unsigned>(L));
  rank1_update_kernel<T><<<grid, kR1Threads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(coeffs),
      c_stride, static_cast<const float*>(scales), s_stride,
      static_cast<T*>(out), static_cast<int>(d_in), static_cast<int>(d_out));
  return cudaGetLastError();
}

}  // namespace repro

extern "C" {

// g, out: (L, d_in, d_out) f32 or bf16; a: (L, d_in) f32; b: (L, d_out) f32;
// item l's coefficient at coeffs[l * c_stride], its scale at
// scales[l * s_stride] (f32 device memory).
int repro_rank1_update(const void* g, int g_is_bf16, const void* a,
                       const void* b, const void* coeffs, long long c_stride,
                       const void* scales, long long s_stride, void* out,
                       long long L, long long d_in, long long d_out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      g_is_bf16 ? repro::launch_rank1<__nv_bfloat16>(
                      g, a, b, coeffs, c_stride, scales, s_stride, out, L,
                      d_in, d_out, s)
                : repro::launch_rank1<float>(g, a, b, coeffs, c_stride,
                                             scales, s_stride, out, L, d_in,
                                             d_out, s));
}

}  // extern "C"
