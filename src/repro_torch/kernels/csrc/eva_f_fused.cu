// Emit phase of the fused Eva-f precondition -> update epilogue (Eq. 21).
//
// Replaces phase 1 of the TPU kernel src/repro/kernels/fused.py::
// eva_f_fused_stacked.  On the TPU one launch runs a sequential grid
// (L, 2, j, i): phase 0 accumulates u = a^T G into a resident (bn,) output
// block per column block and phase 1 reads it back.  CUDA blocks run
// concurrently, so neither that read-back nor the aux accumulation across
// tiles survives.  The port runs four launches on one stream, each finishing
// before the next starts:
//
//   1. matvec.cu's partials kernel   (a^T G per row chunk and column)
//   2. matvec.cu's finishing launch -> u (L, d_out) and |a|^2 (L,); the
//      wrapper forms denom = gamma + |a|^2 from them
//   3. this kernel: coeff = 1 / denom in-kernel (as fused.py does), the
//      rank-one tile P = s * (G - coeff * a u^T) rounded as rank1_update.cu,
//      out = mu * m + P (or P), the f32 output written, and one
//      [<out,G>, <out,out>, <G,G>] partial per block (emit_rank1_chunk in
//      common.cuh, the body eva_fused.cu's emit kernel runs too)
//   4. bilinear.cu's fixed-order sum over those partials -> aux (L, 3)
//
// Each block covers kEmitChunk elements of one item: a quarter of the other
// kernels' chunk, so the autoencoder's 784 x 1000 layer gets 383 blocks
// instead of 96.  The partition depends on d_in * d_out alone, so an item
// alone and in a stack gets the same bits.
//
// Bound on an H100: bytes.  The function needs G read once and out written
// once (and m read when the momentum folds in); this design reads G twice
// (launches 1 and 3), as the TPU kernel does.  Fusing the launches is later
// work.
#include "common.cuh"

namespace repro {

constexpr int kEmitChunk = 2048;  // elements of one item per block

// sc: (L, 3) f32 [denom, scale, mu] per item; u: (L, d_out) f32 from
// launch 2.
template <typename T, bool kFold>
__global__ void __launch_bounds__(kThreads)
    eva_f_fused_emit_kernel(const T* __restrict__ g,
                            const float* __restrict__ a,
                            const float* __restrict__ u,
                            const float* __restrict__ sc,
                            const float* __restrict__ m,
                            float* __restrict__ out,
                            float* __restrict__ aux_partials, int d_in,
                            int d_out) {
  const int n = d_in * d_out;
  const long long item = blockIdx.y;
  const float coeff = __fdiv_rn(1.0f, sc[3 * item]);
  const int start = blockIdx.x * kEmitChunk;
  emit_rank1_chunk<T, kFold>(
      g + item * n, a + item * d_in, u + item * d_out, coeff, sc[3 * item + 1],
      sc[3 * item + 2], kFold ? m + item * n : nullptr, out + item * n, start,
      min(start + kEmitChunk, n), d_out,
      aux_partials + (item * gridDim.x + blockIdx.x) * 3);
}

template <typename T>
void launch_emit(dim3 grid, cudaStream_t s, int fold, const void* g,
                 const void* a, const void* u, const void* sc, const void* m,
                 void* out, void* aux_partials, int d_in, int d_out) {
  const T* gt = static_cast<const T*>(g);
  const float* af = static_cast<const float*>(a);
  const float* uf = static_cast<const float*>(u);
  const float* scf = static_cast<const float*>(sc);
  const float* mf = static_cast<const float*>(m);
  float* outf = static_cast<float*>(out);
  float* auxf = static_cast<float*>(aux_partials);
  if (fold)
    eva_f_fused_emit_kernel<T, true><<<grid, kThreads, 0, s>>>(
        gt, af, uf, scf, mf, outf, auxf, d_in, d_out);
  else
    eva_f_fused_emit_kernel<T, false><<<grid, kThreads, 0, s>>>(
        gt, af, uf, scf, mf, outf, auxf, d_in, d_out);
}

}  // namespace repro

extern "C" {

int repro_eva_f_chunk_elems() { return repro::kEmitChunk; }

// m: (L, d_in, d_out) f32, read only with fold_momentum (else may be null);
// out: (L, d_in, d_out) f32; aux_partials: (L, chunks, 3) f32 scratch with
// chunks = ceil(d_in * d_out / kEmitChunk).
int repro_eva_f_fused_emit(const void* g, int g_is_bf16, const void* a,
                           const void* u, const void* sc, const void* m,
                           void* out, void* aux_partials, long long L,
                           long long d_in, long long d_out, int fold_momentum,
                           void* stream) {
  const dim3 grid(repro::num_chunks(d_in * d_out, repro::kEmitChunk),
                  static_cast<unsigned>(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    repro::launch_emit<__nv_bfloat16>(grid, s, fold_momentum, g, a, u, sc, m,
                                      out, aux_partials,
                                      static_cast<int>(d_in),
                                      static_cast<int>(d_out));
  else
    repro::launch_emit<float>(grid, s, fold_momentum, g, a, u, sc, m, out,
                              aux_partials, static_cast<int>(d_in),
                              static_cast<int>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
