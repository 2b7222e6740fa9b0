// The matvec op: u_l = a_l^T G_l and |a_l|^2 over a stack of L items, one
// launch of matvec.cuh's kernel (the partition, the order of every sum and
// the bound are described there).
//
// Replaces the TPU kernels src/repro/kernels/matvec.py::matvec and
// ::matvec_stacked.
#include "matvec.cuh"

extern "C" {

// g: (L, d_in, d_out) f32 or bf16; a: (L, d_in) f32 -> u (L, d_out) f32,
// asq (L,) f32; blocks of ``warps`` warps, 1 to kMvWarps.
int repro_matvec(const void* g, int g_is_bf16, const void* a, void* u,
                 void* asq, long long L, long long d_in, long long d_out,
                 int warps, void* stream) {
  if (warps < 1 || warps > repro::kMvWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      g_is_bf16 ? repro::launch_matvec<__nv_bfloat16>(g, a, u, asq, L, d_in,
                                                      d_out, warps, s)
                : repro::launch_matvec<float>(g, a, u, asq, L, d_in, d_out,
                                              warps, s));
}

}  // extern "C"
