// Band partial U_l = A_l G_l of the factor-sharded solve, over a stack of L
// items: G_l (m, n) is one row band of a symmetric (n, n) Kronecker factor,
// A_l (R, m) the matching columns of R vectors, U_l (R, n) f32.
//
// Replaces the TPU kernels src/repro/kernels/matvec.py::matvec_cols and
// ::matvec_cols_stacked.  Those keep a (1, bn) output block resident in VMEM
// across a sequential grid axis over the band rows and accumulate it with an
// elementwise multiply and an axis sum per tile.  CUDA blocks run
// concurrently, so nothing is carried between blocks here: block (x, y, l)
// owns the 64 x 64 output tile (rows y * 64 .., columns x * 64 ..) of item l
// and walks the whole band depth m itself, 16 band rows at a time through
// shared memory.  Each of its 256 threads keeps a 4 x 4 tile of outputs in
// registers and adds a_rk * g_kc for k = 0, 1, ..., m - 1 in that order with
// one rounded f32 multiply-add each (__fmaf_rn; no TF32, no tensor cores).
// Every output is therefore the same sequential chain whatever the tiling,
// the stack size L or the vector count R: a stacked launch equals the
// per-item launches bit for bit, and no float atomicAdd or cross-block
// reduction is needed.  Ragged edges stop at m, n and R: the last stage runs
// only the band rows that exist and out-of-range outputs are not written;
// nothing is padded.  A bf16 G is widened to f32 as it is staged.
//
// Bound on an H100: operations.  A call does 2 R m n flops on R m + m n
// inputs; at the autoencoder's R = 784, m = n = 1000 that is 1.57 GFLOP
// against 7 MB, 23.4 us at the 67 TFLOP/s f32 rate against 2.1 us of
// memory.  The design is a plain shared-memory tiled product on the CUDA
// cores: per band row a thread reads two float4 from shared memory for 16
// multiply-adds.  Making it fast (wgmma with split-precision TF32, larger
// tiles, a pipelined TMA ring) is later work.
#include "common.cuh"

namespace repro {

constexpr int kMcTile = 64;    // output rows (of R) and columns (of n) a block
constexpr int kMcDepth = 16;   // band rows per shared-memory stage
constexpr int kMcSide = 16;    // 16 x 16 threads, each a 4 x 4 output tile
constexpr int kMcThreads = kMcSide * kMcSide;
constexpr int kMcPad = 4;      // spreads A's staging stores over the banks;
                               // rows stay 16 B aligned for float4 reads

template <typename T>
__global__ void __launch_bounds__(kMcThreads)
    matvec_cols_kernel(const T* __restrict__ g, const float* __restrict__ a,
                       float* __restrict__ u, int R, int m, int n) {
  __shared__ __align__(16) float as[kMcDepth][kMcTile + kMcPad];  // as[k][r]
  __shared__ __align__(16) float gs[kMcDepth][kMcTile];           // gs[k][c]
  const long long item = blockIdx.z;
  const int r0 = blockIdx.y * kMcTile;
  const int c0 = blockIdx.x * kMcTile;
  const T* gl = g + item * m * static_cast<long long>(n);
  const float* al = a + item * R * static_cast<long long>(m);
  float* ul = u + item * R * static_cast<long long>(n);
  const int tx = threadIdx.x % kMcSide;  // output columns c0 + 4 tx ..
  const int ty = threadIdx.x / kMcSide;  // output rows r0 + 4 ty ..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < m; k0 += kMcDepth) {
    const int depth = min(kMcDepth, m - k0);
    // A tile (64 rows x 16 band rows): neighbouring threads read
    // neighbouring band rows of one vector.
    for (int e = threadIdx.x; e < kMcTile * kMcDepth; e += kMcThreads) {
      const int r = e / kMcDepth;
      const int k = e % kMcDepth;
      float v = 0.0f;
      if (r0 + r < R && k < depth)
        v = al[static_cast<long long>(r0 + r) * m + k0 + k];
      as[k][r] = v;
    }
    // G tile (16 band rows x 64 columns): neighbouring threads read
    // neighbouring columns of one band row.
    for (int e = threadIdx.x; e < kMcDepth * kMcTile; e += kMcThreads) {
      const int k = e / kMcTile;
      const int c = e % kMcTile;
      float v = 0.0f;
      if (k < depth && c0 + c < n)
        v = to_f32(gl[static_cast<long long>(k0 + k) * n + c0 + c]);
      gs[k][c] = v;
    }
    __syncthreads();
    for (int k = 0; k < depth; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][4 * ty]);
      const float4 gv = *reinterpret_cast<const float4*>(&gs[k][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float gc[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(ar[i], gc[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < n) ul[static_cast<long long>(r) * n + c] = acc[i][j];
    }
  }
}

inline unsigned n_tiles(long long d) {
  return static_cast<unsigned>((d + kMcTile - 1) / kMcTile);
}

}  // namespace repro

extern "C" {

// g: (L, m, n) f32 or bf16; a: (L, R, m) f32; u: (L, R, n) f32.
int repro_matvec_cols(const void* g, int g_is_bf16, const void* a, void* u,
                      long long L, long long R, long long m, long long n,
                      void* stream) {
  const dim3 grid(repro::n_tiles(n), repro::n_tiles(R),
                  static_cast<unsigned>(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    repro::matvec_cols_kernel<__nv_bfloat16>
        <<<grid, repro::kMcThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(a),
            static_cast<float*>(u), static_cast<int>(R), static_cast<int>(m),
            static_cast<int>(n));
  else
    repro::matvec_cols_kernel<float><<<grid, repro::kMcThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(a),
        static_cast<float*>(u), static_cast<int>(R), static_cast<int>(m),
        static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
