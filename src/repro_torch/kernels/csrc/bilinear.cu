// Bilinear form d_l = a_l^T G_l b_l over a stack of L items (Eq. 13's
// numerator), and [|a_l|^2, |b_l|^2] for its denominator, in one launch.
//
// Replaces the TPU kernels src/repro/kernels/bilinear.py::bilinear and
// ::bilinear_stacked.  Those accumulate into one resident (1, 1) output block
// across a sequential grid; CUDA blocks run concurrently, so here the sum
// crosses blocks once, inside the launch.  The launch is eva_fused.cu's
// first launch (dot_block of eva_tiles.cuh) with the sum finished: block x <
// blocks of item l sums a_i * g_ij * b_j over the whole rows [x * rows,
// (x + 1) * rows), rows = max(1, kTile / d_out), into a partial in the
// stream's workspace; block `blocks` writes |a|^2 and |b|^2; the block that
// draws the item's last ticket from its integer arrival counter sums the
// partials, thread t taking t, t + kEfThreads, ..., then a fixed block sum,
// and writes dot.  That is the partition, and the order, in which each
// block of eva_fused.cu's second launch sums the dot, so on the same
// operands this kernel returns eva_fused's dot and norms bit for bit, and
// Eva composed from this kernel and rank1_update equals fused Eva without
// the fold.  The partition depends on (d_in, d_out) alone, never on L, so a
// stacked launch equals the per-item launches bit for bit; no float atomic.
//
// Bound on an H100: bytes.  G is read once (4 or 2 bytes per element), a and
// b once per element from L1/L2, and the work is 2 multiplies and an add per
// element, far below the card's f32 rate.  Each thread loads 16 bytes of a
// row at a time, neighbouring threads neighbouring addresses.  The 784 x
// 1000 layer gets 785 blocks, about six on each of the 132 SMs, where the
// design this replaces (8192-element chunks, then a one-warp finishing
// launch) gave it 96 blocks and a second launch.  It uses no wgmma or TMA:
// there is no product to feed them.
#include "eva_tiles.cuh"

namespace repro {

// partials: (L, blocks) f32 and counters: (L,) of the workspace, the
// counters zero on entry and on exit; dot: (L,) f32; sq: (L, 2) f32.
// gridDim.x is blocks + 1.
template <typename T>
__global__ void __launch_bounds__(kEfThreads)
    bilinear_kernel(const T* __restrict__ g, const float* __restrict__ a,
                    const float* __restrict__ b, float* __restrict__ partials,
                    unsigned int* __restrict__ counters,
                    float* __restrict__ dot, float* __restrict__ sq, int d_in,
                    int d_out, int rows) {
  dot_block<T, true>(g, a, b, partials, sq, dot, counters, d_in, d_out, rows);
}

template <typename T>
cudaError_t launch_bilinear(const void* g, const void* a, const void* b,
                            void* dot, void* sq, float* ws,
                            unsigned int* counters, long long L,
                            long long d_in, long long d_out, int blocks,
                            cudaStream_t s) {
  bilinear_kernel<T><<<dim3(blocks + 1, static_cast<unsigned>(L)),
                       kEfThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const float*>(a),
      static_cast<const float*>(b), ws, counters, static_cast<float*>(dot),
      static_cast<float*>(sq), static_cast<int>(d_in),
      static_cast<int>(d_out), dot_rows(d_out));
  return cudaGetLastError();
}

}  // namespace repro

extern "C" {

// g: (L, d_in, d_out) f32 or bf16; a: (L, d_in), b: (L, d_out) f32 -> dot
// (L,) f32, sq (L, 2) f32 = [|a|^2, |b|^2].  ws: L * blocks f32 and
// counters: L zeroed int32 of the workspace (kernels/bilinear.py::
// bilinear_plan), whose capacity the caller passes: a launch that would
// overrun it is refused.
int repro_bilinear(const void* g, int g_is_bf16, const void* a,
                   const void* b, void* dot, void* sq, void* ws,
                   long long ws_cap, void* counters, long long counters_cap,
                   long long L, long long d_in, long long d_out,
                   void* stream) {
  const long long blocks = repro::dot_blocks(d_in, d_out);
  if (L * blocks > ws_cap || L > counters_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  const int nb = static_cast<int>(blocks);
  return static_cast<int>(
      g_is_bf16 ? repro::launch_bilinear<__nv_bfloat16>(
                      g, a, b, dot, sq, wsf, cnt, L, d_in, d_out, nb, s)
                : repro::launch_bilinear<float>(g, a, b, dot, sq, wsf, cnt,
                                                L, d_in, d_out, nb, s));
}

}  // extern "C"
