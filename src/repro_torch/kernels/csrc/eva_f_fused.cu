// Fused Eva-f precondition -> update epilogue (Eq. 21 + momentum + the KL
// partials), in two launches.
//
// Replaces the TPU kernel src/repro/kernels/fused.py::eva_f_fused_stacked.
// On the TPU one launch runs a sequential grid (L, 2, j, i): phase 0
// accumulates u = a^T G into a resident (bn,) output block per column block
// and phase 1 reads it back.  CUDA blocks run concurrently, so here each
// phase is a launch of its own on one stream, with no PyTorch op between:
//
//   1. matvec.cuh's kernel, unchanged: u (L, d_out) and |a|^2 (L,) into the
//      stream's workspace, with the matvec op's bits.
//   2. eva_f_emit_kernel (emit_tile of eva_tiles.cuh with EvaFSrc), a
//      programmatic dependent of launch 1: its blocks may start while
//      launch 1 runs and load their G (and m) and a before
//      griddepcontrol.wait.  After the wait each thread reads u at its own
//      columns and |a|^2, forms c = 1 / (gamma + |a|^2), each operation
//      rounded once as PyTorch's 1.0 / (gamma + asq) rounds it, with no
//      barrier between, and writes out = mu * m + P (or P without the
//      fold), P = scale * (G - c * a u^T) rounded as rank1_elem; each block
//      writes one [<out,G>, <out,out>, <G,G>] partial, and the block that
//      draws the item's last ticket sums those partials into aux (L, 3).
//
// The emit body, its partition (kTile elements a block, kVec a thread) and
// its order of summing are eva_fused.cu's second launch's, with b and the
// coefficient taken from launch 1.  So out keeps the element formula and
// roundings of Eva-f composed from matvec and rank1_update: without the
// fold the two agree bit for bit on f32 G.  gamma, scale = 1/gamma and mu
// come as f32 arguments, rounded on the host as torch.full_like rounds
// them.  Every sum is in a fixed order and the partitions depend on (d_in,
// d_out) alone, so a stacked launch equals the per-item launches bit for
// bit; no float atomic.
//
// Bound on an H100: bytes.  The function needs G read once and out written
// once (and m read when the momentum folds in); this design reads G twice
// (launches 1 and 2), the second time mostly from the 50 MB L2.  The 784 x
// 1000 layer gets 63 blocks of 7 warps in launch 1 and 766 blocks in
// launch 2.
#include "eva_tiles.cuh"
#include "matvec.cuh"

namespace repro {

// Launch 2.  src: launch 1's u and |a|^2; partials: (L, blocks, 3) f32;
// aux: (L, 3) f32; counters: (L,), zero on entry and on exit.
template <typename T, bool kFold>
__global__ void __launch_bounds__(kEfThreads)
    eva_f_emit_kernel(const T* __restrict__ g, const float* __restrict__ a,
                      EvaFSrc src, float gamma, float scale, float mu,
                      const float* __restrict__ m, float* __restrict__ out,
                      float* __restrict__ aux, float* __restrict__ partials,
                      unsigned int* __restrict__ counters, int d_in,
                      int d_out) {
  emit_tile<T, kFold>(g, a, src, gamma, scale, mu, m, out, aux, partials,
                      counters, d_in, d_out);
}

template <typename T>
cudaError_t launch_f_fused(const void* g, const void* a, const void* m,
                           void* out, void* aux, float* ws,
                           unsigned int* counters, float gamma, float scale,
                           float mu, int fold, long long L, long long d_in,
                           long long d_out, int warps, int blocks,
                           cudaStream_t s) {
  const T* gt = static_cast<const T*>(g);
  const float* af = static_cast<const float*>(a);
  const float* mf = static_cast<const float*>(m);
  float* outf = static_cast<float*>(out);
  float* auxf = static_cast<float*>(aux);
  // workspace: u (L, d_out), |a|^2 (L,), launch 2's partials (L, blocks, 3)
  float* u = ws;
  float* asq = u + L * d_out;
  float* partials = asq + L;
  cudaError_t err = launch_matvec<T>(g, a, u, asq, L, d_in, d_out, warps, s);
  if (err != cudaSuccess) return err;
  const EvaFSrc src{u, asq};
  const dim3 grid(blocks, static_cast<unsigned>(L));
  const int di = static_cast<int>(d_in), dn = static_cast<int>(d_out);
  if (fold)
    return launch_dependent(eva_f_emit_kernel<T, true>, grid, s, gt, af, src,
                            gamma, scale, mu, mf, outf, auxf, partials,
                            counters, di, dn);
  return launch_dependent(eva_f_emit_kernel<T, false>, grid, s, gt, af, src,
                          gamma, scale, mu, mf, outf, auxf, partials,
                          counters, di, dn);
}

}  // namespace repro

extern "C" {

// g: (L, d_in, d_out) f32 or bf16; a: (L, d_in) f32; m: (L, d_in, d_out)
// f32, read only with fold_momentum (else may be null) -> out (L, d_in,
// d_out) f32, aux (L, 3) f32.  ws: L * (d_out + 1 + 3 * emit_blocks) f32
// and counters: L zeroed int32 of the workspace (kernels/fused.py::
// eva_f_fused_plan), whose capacity the caller passes: a launch that would
// overrun it is refused.  warps: launch 1's warps a block
// (kernels/matvec.py::matvec_plan), 1 to kMvWarps.
int repro_eva_f_fused(const void* g, int g_is_bf16, const void* a,
                      const void* m, void* out, void* aux, void* ws,
                      long long ws_cap, void* counters,
                      long long counters_cap, float gamma, float scale,
                      float mu, int fold_momentum, long long L,
                      long long d_in, long long d_out, int warps,
                      void* stream) {
  const long long blocks = repro::emit_blocks(d_in, d_out);
  if (L * (d_out + 1 + 3 * blocks) > ws_cap || L > counters_cap ||
      warps < 1 || warps > repro::kMvWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  const int nb = static_cast<int>(blocks);
  return static_cast<int>(
      g_is_bf16
          ? repro::launch_f_fused<__nv_bfloat16>(
                g, a, m, out, aux, wsf, cnt, gamma, scale, mu, fold_momentum,
                L, d_in, d_out, warps, nb, s)
          : repro::launch_f_fused<float>(g, a, m, out, aux, wsf, cnt, gamma,
                                         scale, mu, fold_momentum, L, d_in,
                                         d_out, warps, nb, s));
}

}  // extern "C"
