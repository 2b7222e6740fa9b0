// Fused Eva precondition -> update epilogue (Eq. 13 + momentum + the KL
// partials), in two launches of the row-tile bodies of eva_tiles.cuh.
//
// Replaces the TPU kernel src/repro/kernels/fused.py::eva_fused_stacked.  On
// the TPU one launch runs a sequential grid (L, 2, i, j): phase 0
// accumulates a^T G b into a resident output block and phase 1 reads it
// back.  CUDA blocks run concurrently, so here each phase is a launch of its
// own on one stream:
//
//   1. eva_dot_kernel (dot_block): block x < blocks of item l covers the
//      whole rows [x * rows, (x + 1) * rows), rows = max(1, kTile / d_out),
//      and writes the partial sum of a_i * g_ij * b_j over them; one more
//      block sums |a|^2 and |b|^2.  Nothing else: no ticket, no finishing
//      block.
//   2. eva_emit_kernel (emit_tile with EvaSrc): block x of item l covers the
//      elements [x * kTile, (x + 1) * kTile) of the flattened item.  It
//      loads its G (and m), then sums launch 1's partials itself, in a
//      fixed order (thread t takes partials t, t + kEfThreads, ..., then
//      block_sum), so that every block forms the same dot and coeff = dot /
//      (gamma + |a|^2 |b|^2), the denominator rounded as PyTorch's two eager
//      ops round it.  It writes out = mu * m + P (or P without the fold), P
//      = scale * (G - coeff * a b^T) rounded as rank1_elem, and one
//      [<out,G>, <out,out>, <G,G>] partial.  The block that draws the last
//      ticket from the item's integer arrival counter (common.cuh's
//      last_arrival) sums those partials in a fixed order into aux (L, 3)
//      and resets the counter.
//
// Every block summing the dot partials costs each block one more read of a
// few KB from L2, where a finishing block in launch 1 put a ticket, a
// serial sum and a store between the two launches.  Launch 2 is a
// programmatic dependent launch: its blocks may start while launch 1 runs,
// load their G, m, a and b, and wait (griddepcontrol.wait, which returns
// once launch 1 has completed and its stores are visible) before they read
// launch 1's partials or touch the workspace.
//
// gamma, scale = 1/gamma and mu come as f32 arguments, rounded on the host
// from the Python floats as torch.full_like rounds them.
//
// Slots, alignment and the order of every sum are eva_tiles.cuh's: a
// stacked launch equals the per-item launches bit for bit.  bilinear.cu
// runs launch 1's partition with the dot finished in the launch, in the
// order each block here sums it, so Eva composed from bilinear and
// rank1_update forms the same coeff and P as this kernel without the fold.
//
// Bound on an H100: bytes.  The function needs G and m read once and out
// written once; this design reads G twice (launches 1 and 2), the second
// time mostly from the 50 MB L2 (the largest item is 3.1 MB).  The 784 x
// 1000 layer gets 785 blocks in launch 1 and 766 in launch 2, about six on
// every one of the 132 SMs.
#include "eva_tiles.cuh"

namespace repro {

// Launch 1.  partials: (L, blocks) f32; norms: (L, 2) f32.  gridDim.x is
// blocks + 1.
template <typename T>
__global__ void __launch_bounds__(kEfThreads)
    eva_dot_kernel(const T* __restrict__ g, const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ partials,
                   float* __restrict__ norms, int d_in, int d_out, int rows) {
  // let launch 2 start loading G and m while this launch runs
  asm volatile("griddepcontrol.launch_dependents;");
  dot_block<T, false>(g, a, b, partials, norms, nullptr, nullptr, d_in, d_out,
                      rows);
}

// Launch 2.  dots: launch 1's (L, dot_blocks) partials and (L, 2) norms;
// partials: (L, blocks, 3) f32; aux: (L, 3) f32; counters: (L,), zero on
// entry and on exit.
template <typename T, bool kFold>
__global__ void __launch_bounds__(kEfThreads)
    eva_emit_kernel(const T* __restrict__ g, const float* __restrict__ a,
                    EvaSrc src, float gamma, float scale, float mu,
                    const float* __restrict__ m, float* __restrict__ out,
                    float* __restrict__ aux, float* __restrict__ partials,
                    unsigned int* __restrict__ counters, int d_in,
                    int d_out) {
  emit_tile<T, kFold>(g, a, src, gamma, scale, mu, m, out, aux, partials,
                      counters, d_in, d_out);
}

template <typename T>
cudaError_t launch_fused(const void* g, const void* a, const void* b,
                         const void* m, void* out, void* aux, float* ws,
                         unsigned int* counters, float gamma, float scale,
                         float mu, int fold, long long L, long long d_in,
                         long long d_out, int dot_blocks, int emit_blocks,
                         cudaStream_t s) {
  const T* gt = static_cast<const T*>(g);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(m);
  float* outf = static_cast<float*>(out);
  float* auxf = static_cast<float*>(aux);
  const unsigned lu = static_cast<unsigned>(L);
  // workspace: norms (L, 2), launch 1's partials (L, dot_blocks), launch 2's
  // (L, emit_blocks, 3)
  float* norms = ws;
  float* dots = ws + 2 * L;
  float* partials = dots + L * dot_blocks;
  const int di = static_cast<int>(d_in), dn = static_cast<int>(d_out);
  eva_dot_kernel<T><<<dim3(dot_blocks + 1, lu), kEfThreads, 0, s>>>(
      gt, af, bf, dots, norms, di, dn, dot_rows(d_out));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // launch 2 as a programmatic dependent of launch 1 (see emit_tile)
  const EvaSrc src{bf, dots, norms, dot_blocks};
  const dim3 grid(emit_blocks, lu);
  if (fold)
    return launch_dependent(eva_emit_kernel<T, true>, grid, s, gt, af, src,
                            gamma, scale, mu, mf, outf, auxf, partials,
                            counters, di, dn);
  return launch_dependent(eva_emit_kernel<T, false>, grid, s, gt, af, src,
                          gamma, scale, mu, mf, outf, auxf, partials,
                          counters, di, dn);
}

}  // namespace repro

extern "C" {

// g: (L, d_in, d_out) f32 or bf16; a: (L, d_in), b: (L, d_out) f32; m:
// (L, d_in, d_out) f32, read only with fold_momentum (else may be null) ->
// out (L, d_in, d_out) f32, aux (L, 3) f32.  ws: L * (2 + dot_blocks + 3 *
// emit_blocks) f32 and counters: L zeroed int32 of the workspace
// (kernels/fused.py::eva_fused_plan), whose capacity the caller passes: a
// launch that would overrun it is refused.
int repro_eva_fused(const void* g, int g_is_bf16, const void* a,
                    const void* b, const void* m, void* out, void* aux,
                    void* ws, long long ws_cap, void* counters,
                    long long counters_cap, float gamma, float scale,
                    float mu, int fold_momentum, long long L, long long d_in,
                    long long d_out, void* stream) {
  const long long dot_blocks = repro::dot_blocks(d_in, d_out);
  const long long emit_blocks = repro::emit_blocks(d_in, d_out);
  const long long per_item = 2 + dot_blocks + 3 * emit_blocks;
  if (L * per_item > ws_cap || L > counters_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  const int db = static_cast<int>(dot_blocks);
  const int eb = static_cast<int>(emit_blocks);
  return static_cast<int>(
      g_is_bf16
          ? repro::launch_fused<__nv_bfloat16>(g, a, b, m, out, aux, wsf, cnt,
                                               gamma, scale, mu, fold_momentum,
                                               L, d_in, d_out, db, eb, s)
          : repro::launch_fused<float>(g, a, b, m, out, aux, wsf, cnt, gamma,
                                       scale, mu, fold_momentum, L, d_in,
                                       d_out, db, eb, s));
}

}  // extern "C"
