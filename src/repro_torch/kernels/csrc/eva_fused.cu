// Emit phase of the fused Eva precondition -> update epilogue.
//
// Replaces phase 1 of the TPU kernel src/repro/kernels/fused.py::
// eva_fused_stacked.  On the TPU one launch runs a sequential grid
// (L, 2, i, j): phase 0 accumulates a^T G b into a resident output block and
// phase 1 reads it back.  CUDA blocks run concurrently, so neither that
// read-back nor the aux accumulation across tiles survives.  The port runs
// four launches on one stream, each finishing before the next starts:
//
//   1. bilinear.cu's partials kernel   (a^T G b per chunk)
//   2. bilinear.cu's finishing launch -> dot (L,) and [|a|^2, |b|^2];
//      the wrapper forms denom = gamma + |a|^2 |b|^2 from them
//   3. this kernel: coeff = dot / denom in-kernel (as fused.py does), the
//      rank-one tile P = s * (G - coeff * a b^T), out = mu * m + P (or P),
//      the f32 output written, and one [<out,G>, <out,out>, <G,G>] partial
//      per block
//   4. bilinear.cu's fixed-order sum over those partials -> aux (L, 3)
//
// Bound on an H100: bytes.  The function needs G and m read once and out
// written once; this design reads G twice (launches 1 and 3), as the TPU
// kernel does.  Fusing the four launches into one is later work.
#include "common.cuh"

namespace repro {

// sc: (L, 3) f32 [denom, scale, mu] per item; dot: (L,) f32 from launch 2.
template <typename T, bool kFold>
__global__ void __launch_bounds__(kThreads)
    eva_fused_emit_kernel(const T* __restrict__ g, const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ sc,
                          const float* __restrict__ dot,
                          const float* __restrict__ m, float* __restrict__ out,
                          float* __restrict__ aux_partials, int d_in,
                          int d_out) {
  const int n = d_in * d_out;
  const long long item = blockIdx.y;
  const T* gl = g + item * n;
  // m is read only with the fold, and may be null without it
  const float* ml = kFold ? m + item * n : nullptr;
  float* ol = out + item * n;
  const float* al = a + item * d_in;
  const float* bl = b + item * d_out;
  const float coeff = __fdiv_rn(dot[item], sc[3 * item]);
  const int start = blockIdx.x * kChunk;
  emit_rank1_chunk<T, kFold>(gl, al, bl, coeff, sc[3 * item + 1],
                             sc[3 * item + 2], ml, ol, start,
                             min(start + kChunk, n), d_out,
                             aux_partials + (item * gridDim.x + blockIdx.x) * 3);
}

template <typename T>
void launch_emit(dim3 grid, cudaStream_t s, int fold, const void* g,
                 const void* a, const void* b, const void* sc, const void* dot,
                 const void* m, void* out, void* aux_partials, int d_in,
                 int d_out) {
  const T* gt = static_cast<const T*>(g);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* scf = static_cast<const float*>(sc);
  const float* dotf = static_cast<const float*>(dot);
  const float* mf = static_cast<const float*>(m);
  float* outf = static_cast<float*>(out);
  float* auxf = static_cast<float*>(aux_partials);
  if (fold)
    eva_fused_emit_kernel<T, true><<<grid, kThreads, 0, s>>>(
        gt, af, bf, scf, dotf, mf, outf, auxf, d_in, d_out);
  else
    eva_fused_emit_kernel<T, false><<<grid, kThreads, 0, s>>>(
        gt, af, bf, scf, dotf, mf, outf, auxf, d_in, d_out);
}

}  // namespace repro

extern "C" {

// m: (L, d_in, d_out) f32, read only with fold_momentum (else may be null);
// out: (L, d_in, d_out) f32; aux_partials: (L, chunks, 3) f32 scratch.
int repro_eva_fused_emit(const void* g, int g_is_bf16, const void* a,
                         const void* b, const void* sc, const void* dot,
                         const void* m, void* out, void* aux_partials,
                         long long L, long long d_in, long long d_out,
                         int fold_momentum, void* stream) {
  const dim3 grid(repro::num_chunks(d_in * d_out), static_cast<unsigned>(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    repro::launch_emit<__nv_bfloat16>(grid, s, fold_momentum, g, a, b, sc, dot,
                                      m, out, aux_partials,
                                      static_cast<int>(d_in),
                                      static_cast<int>(d_out));
  else
    repro::launch_emit<float>(grid, s, fold_momentum, g, a, b, sc, dot, m, out,
                              aux_partials, static_cast<int>(d_in),
                              static_cast<int>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
