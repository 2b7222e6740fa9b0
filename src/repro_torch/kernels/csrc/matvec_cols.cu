// Band partial U_l = A_l G_l of the factor-sharded solve, over a stack of L
// items: G_l (m, n) is one row band of a symmetric (n, n) Kronecker factor,
// A_l (R, m) the matching columns of R vectors, U_l (R, n) f32.
//
// Replaces the TPU kernels src/repro/kernels/matvec.py::matvec_cols and
// ::matvec_cols_stacked.  Those keep a (1, bn) output block resident in VMEM
// across a sequential grid axis over the band rows and accumulate it with an
// elementwise multiply and an axis sum per tile.  CUDA blocks run
// concurrently, so nothing is carried between blocks here: block (x, y, l)
// owns one BM x BN output tile of item l and walks the whole band depth m
// itself, BK band rows at a time through a ring of kColsStages shared-memory
// stages.
//
// Bound on an H100: operations.  A call does 2 R m n flops on R m + m n
// inputs; at the autoencoder's R = 784, m = n = 1000 that is 1.57 GFLOP
// against 7 MB, 23.4 us at the 67 TFLOP/s f32 rate against 2.1 us of
// memory.  What holds a CUDA-core product of this size back is the SM's
// shared memory: every band row, each thread reads its TM values of A and
// TN values of G from it, and the stages are written into it.  So:
//   * a TM x TN register tile per thread (8 x 4 or 7 x 4 outputs): per four
//     band rows a thread reads TM float4 of A (four band rows of one vector
//     each) and one float4 of G per band row, so each shared-memory read
//     feeds 8 to 14 multiply-adds; the threads of a quarter warp share their
//     A rows (a broadcast) and read neighbouring G columns (no conflict);
//   * the stages are filled by the Tensor Memory Accelerator (the TMA path):
//     one thread asks for two boxes a stage, A's BM x BK and G's BK x BN,
//     the copy engine writes them and signals a "full"
//     mbarrier, and the compute warps free a stage through an "empty" one.
//     The compute warps issue no copies, and the fill leaves the shared
//     memory's read port to them (on the card, 16-byte cp.async fills issued
//     by the compute warps cost a third of the kernel's time; the TMA path
//     removed most of it).  Boxes past R, m or n are filled with zeros by
//     the copy engine;
//   * a tile shape chosen per call from (R, n) and the SM count alone
//     (matvec.py's cols_plan), so that the tiles spread evenly over 132 SMs:
//     56 x 112 tiles at R = 784 (126 blocks, one wave), 64 x 64 at R = 500
//     (128 blocks, one wave); BK, 16 or 32, as measured best for each.
// The TMA path needs f32 operands whose rows are 16-byte aligned (m and n
// multiples of 4, aligned bases).  Any other launch (a bf16 G, odd m or n, a
// view with a storage offset) takes the general path: the same tiles and
// arithmetic, stages filled by the compute warps with cp.async (16-byte
// copies where a row is aligned, 4-byte copies where not) and a bf16 G
// widened to f32 through registers.  The wrapper decides per launch from the
// pointers and widths.  Nothing is padded in device memory.
//
// Each output is one f32 multiply-add chain over k = 0, 1, ..., m - 1 in
// that order (__fmaf_rn; no split of the depth, no TF32, no tensor cores, no
// atomics) on either path: the same bits whatever the tile, the path, the
// stack size L or R, and the bits of cuBLAS's f32 product where it too sums
// in order.  A stacked launch equals the per-item launches bit for bit.
// Band rows past m are zeros in both operands, and a multiply-add of 0 * 0
// leaves a sum bit for bit as it was; rows and columns past R and n are
// computed on zeros or stale stage data and never written.
#include <cuda.h>  // CUtensorMap and its encoder's types; no driver library

#include "common.cuh"

namespace repro {

constexpr int kColsStages = 3;   // stages in the ring

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 (or 4) bytes from device to shared memory without waiting; when
// !valid the destination is filled with zeros and nothing is read.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// One 3-D box of `map` at element coordinates (x, y, z), x innermost.
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map,
                                            int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <int TM, int TN, int TY, int TX>
struct ColsTile {
  static constexpr int kBM = TM * TY;       // output rows (of R) a block
  static constexpr int kBN = TN * TX;       // output columns (of n) a block
  static constexpr int kThreads = TX * TY;  // compute threads
  static_assert(TN == 4 || TN == 8, "a thread's columns are 1 or 2 float4");
};

// acc += A G over one stage of BK band rows: `as` points at the thread's
// first A row (row stride lda floats), `gs` at its first G column of band
// row 0 (row stride BN).  Columns 4 tx .. and BN / 2 + 4 tx ..
template <int TM, int TN, int BN, int BK>
__device__ __forceinline__ void stage_fma(const float* as, int lda,
                                          const float* gs,
                                          float (&acc)[TM][TN]) {
  static_assert(BK % 4 == 0, "the depth goes 4 band rows a step");
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(as + i * lda + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 gv[TN / 4];
#pragma unroll
      for (int h = 0; h < TN / 4; ++h)
        gv[h] = *reinterpret_cast<const float4*>(gs + (kk + q) * BN +
                                                 h * (BN / 2));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ai = lane(av[i], q);
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          acc[i][4 * h] = __fmaf_rn(ai, gv[h].x, acc[i][4 * h]);
          acc[i][4 * h + 1] = __fmaf_rn(ai, gv[h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = __fmaf_rn(ai, gv[h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = __fmaf_rn(ai, gv[h].w, acc[i][4 * h + 3]);
        }
      }
    }
  }
}

// Write the thread's outputs that lie inside (R, n).
template <int TM, int TN, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[TM][TN],
                                           float* ul, int R, int n, int r_top,
                                           int c_left) {
  const bool u_vec = (n & 3) == 0;  // u from torch.empty: rows 16 B aligned
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r_top + i;
    if (r >= R) continue;
    float* row = ul + static_cast<long long>(r) * n;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = c_left + h * (BN / 2);
      if (u_vec && c < n) {
        *reinterpret_cast<float4*>(row + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n) row[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

// TMA path: kThreads compute threads and one more warp whose first thread
// fills the ring.  Stage s holds A as [BM][BK] and G as [BK][BN], dense, as
// the copy engine writes a box.
template <int TM, int TN, int TY, int TX, int BK, int S>
__global__ void __launch_bounds__(TX * TY + 32)
    matvec_cols_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                           const __grid_constant__ CUtensorMap g_map,
                           float* __restrict__ u, int R, int m, int n) {
  using Tile = ColsTile<TM, TN, TY, TX>;
  constexpr int BM = Tile::kBM, BN = Tile::kBN, NT = Tile::kThreads;
  constexpr int SA = BM * BK, SG = BK * BN;
  extern __shared__ float smem_raw[];
  // the copy engine writes boxes to 128-byte aligned addresses
  float* As = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* Gs = As + S * SA;
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int item = blockIdx.z;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);            // the filling thread's arrival
      mbar_init(&empty[s], NT / 32);     // one arrival per compute warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nk = (m + BK - 1) / BK;
  if (tid >= NT) {
    if (tid == NT) {
      for (int t = 0; t < nk; ++t) {
        const int slot = t % S;
        if (t >= S) mbar_wait(&empty[slot], (t / S - 1) & 1);
        // whole boxes count, the zeros past R, m or n included
        mbar_expect_tx(&full[slot], (SA + SG) * 4);
        tma_load_3d(As + slot * SA, &a_map, t * BK, r0, item, &full[slot]);
        tma_load_3d(Gs + slot * SG, &g_map, c0, t * BK, item, &full[slot]);
      }
    }
    return;
  }
  const int tx = tid % TX, ty = tid / TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  for (int t = 0; t < nk; ++t) {
    const int slot = t % S;
    mbar_wait(&full[slot], (t / S) & 1);
    stage_fma<TM, TN, BN, BK>(As + slot * SA + ty * TM * BK, BK,
                          Gs + slot * SG + 4 * tx, acc);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[slot]);
  }
  store_tile<TM, TN, BN>(acc, u + static_cast<long long>(item) * R * n, R, n,
                         r0 + ty * TM, c0 + 4 * tx);
}

// General path: the compute threads fill the ring themselves with cp.async;
// A stages as [BM][BK + 4] (rows stay 16-byte aligned).
template <int TM, int TN, int TY, int TX, int BK, int S, typename TG>
__global__ void __launch_bounds__(TX * TY)
    matvec_cols_kernel(const TG* __restrict__ g, const float* __restrict__ a,
                       float* __restrict__ u, int R, int m, int n, int a_vec,
                       int g_vec) {
  using Tile = ColsTile<TM, TN, TY, TX>;
  constexpr int BM = Tile::kBM, BN = Tile::kBN, NT = Tile::kThreads;
  constexpr int LDA = BK + 4;
  constexpr int SA = BM * LDA, SG = BK * BN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;          // [S][BM][LDA]: As[r][k]
  float* Gs = smem + S * SA;  // [S][BK][BN]:  Gs[k][c]
  const long long item = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const TG* gl = g + item * m * static_cast<long long>(n);
  const float* al = a + item * R * static_cast<long long>(m);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // Stage band rows k0 .. k0 + BK - 1 into ring slot `slot`.
  auto stage = [&](int slot, int k0) {
    float* as = As + slot * SA;
    float* gs = Gs + slot * SG;
    if (a_vec) {  // m % 4 == 0: a 4-wide chunk lies all in or all out
      for (int e = tid; e < BM * (BK / 4); e += NT) {
        const int r = e / (BK / 4), k = (e % (BK / 4)) * 4;
        const bool ok = r0 + r < R && k0 + k < m;
        cp_async16(as + r * LDA + k,
                   ok ? al + static_cast<long long>(r0 + r) * m + k0 + k : al,
                   ok);
      }
    } else {
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, k = e % BK;
        const bool ok = r0 + r < R && k0 + k < m;
        cp_async4(as + r * LDA + k,
                  ok ? al + static_cast<long long>(r0 + r) * m + k0 + k : al,
                  ok);
      }
    }
    if constexpr (sizeof(TG) == 4) {
      if (g_vec) {  // n % 4 == 0
        for (int e = tid; e < BK * (BN / 4); e += NT) {
          const int k = e / (BN / 4), c = (e % (BN / 4)) * 4;
          const bool ok = k0 + k < m && c0 + c < n;
          cp_async16(gs + k * BN + c,
                     ok ? gl + static_cast<long long>(k0 + k) * n + c0 + c
                        : gl,
                     ok);
        }
      } else {
        for (int e = tid; e < BK * BN; e += NT) {
          const int k = e / BN, c = e % BN;
          const bool ok = k0 + k < m && c0 + c < n;
          cp_async4(gs + k * BN + c,
                    ok ? gl + static_cast<long long>(k0 + k) * n + c0 + c
                       : gl,
                    ok);
        }
      }
    } else {  // bf16: widened through registers
      for (int e = tid; e < BK * BN; e += NT) {
        const int k = e / BN, c = e % BN;
        gs[k * BN + c] =
            k0 + k < m && c0 + c < n
                ? to_f32(gl[static_cast<long long>(k0 + k) * n + c0 + c])
                : 0.0f;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int nk = (m + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) stage(s, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<S - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();         // ... and every thread's; slot t - 1 is free
    if (t + S - 1 < nk) stage((t + S - 1) % S, (t + S - 1) * BK);
    cp_async_commit();
    stage_fma<TM, TN, BN, BK>(As + (t % S) * SA + ty * TM * LDA, LDA,
                          Gs + (t % S) * SG + 4 * tx, acc);
  }
  cp_async_wait<0>();
  store_tile<TM, TN, BN>(acc, u + item * R * static_cast<long long>(n), R, n,
                         r0 + ty * TM, c0 + 4 * tx);
}

typedef CUresult (*TensorMapEncoder)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver through the runtime once.
inline TensorMapEncoder tensor_map_encoder() {
  static TensorMapEncoder fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<TensorMapEncoder>(p);
  }();
  return fn;
}

// A map of an (d2, d1, d0) f32 array, d0 innermost, read in (1, b1, b0)
// boxes; elements past the array read as zeros.
inline bool encode_map(CUtensorMap* map, const void* base, long long d0,
                       long long d1, long long d2, int b0, int b1) {
  TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0 * 4),
                                 static_cast<cuuint64_t>(d0 * d1 * 4)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch one tile configuration on the TMA path (tma != 0) or the general
// one.  The grid (tiles of n, tiles of R) comes from the wrapper's plan; a
// plan made for another tile is refused.
template <int TM, int TN, int TY, int TX, int BK, int S = kColsStages>
cudaError_t launch_cols(int tma, const void* g, int g_is_bf16, const void* a,
                        void* u, long long L, long long R, long long m,
                        long long n, int a_vec, int g_vec, long long grid_x,
                        long long grid_y, cudaStream_t s) {
  using Tile = ColsTile<TM, TN, TY, TX>;
  constexpr int BM = Tile::kBM, BN = Tile::kBN;
  if (grid_x * BN < n || (grid_x - 1) * BN >= n || grid_y * BM < R ||
      (grid_y - 1) * BM >= R)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y), static_cast<unsigned>(L));
  cudaError_t err;
  if (tma) {
    CUtensorMap a_map, g_map;
    if (g_is_bf16 || !encode_map(&a_map, a, m, R, L, BK, BM) ||
        !encode_map(&g_map, g, n, m, L, BN, BK))
      return cudaErrorInvalidValue;
    constexpr int bytes = S * (BM * BK + BK * BN) * 4 + 128;
    auto k = matvec_cols_tma_kernel<TM, TN, TY, TX, BK, S>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    k<<<grid, Tile::kThreads + 32, bytes, s>>>(a_map, g_map,
                                               static_cast<float*>(u),
                                               static_cast<int>(R),
                                               static_cast<int>(m),
                                               static_cast<int>(n));
    return cudaGetLastError();
  }
  constexpr int bytes = S * (BM * (BK + 4) + BK * BN) * 4;
  if (g_is_bf16) {
    auto k = matvec_cols_kernel<TM, TN, TY, TX, BK, S, __nv_bfloat16>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    k<<<grid, Tile::kThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(a),
        static_cast<float*>(u), static_cast<int>(R), static_cast<int>(m),
        static_cast<int>(n), a_vec, 0);
  } else {
    auto k = matvec_cols_kernel<TM, TN, TY, TX, BK, S, float>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    k<<<grid, Tile::kThreads, bytes, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(a),
        static_cast<float*>(u), static_cast<int>(R), static_cast<int>(m),
        static_cast<int>(n), a_vec, g_vec);
  }
  return cudaGetLastError();
}

}  // namespace repro

extern "C" {

// cfg: index into matvec.py's COLS_TILES, (TM, TN, TY, TX) each; the depth
// BK of each is set here.
// tma: 1 for the TMA path (f32 g and a, rows 16-byte aligned), else 0.
// g: (L, m, n) f32 or bf16; a: (L, R, m) f32; u: (L, R, n) f32, fresh.
// a_vec / g_vec: 1 where that operand's rows are 16-byte aligned.
int repro_matvec_cols(int cfg, int tma, const void* g, int g_is_bf16,
                      const void* a, void* u, long long L, long long R,
                      long long m, long long n, int a_vec, int g_vec,
                      long long grid_x, long long grid_y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cfg) {
    case 0:
      err = repro::launch_cols<8, 4, 8, 16, 16, 3>(
          tma, g, g_is_bf16, a, u, L, R, m, n, a_vec, g_vec, grid_x, grid_y,
          s);
      break;
    case 1:
      err = repro::launch_cols<7, 4, 8, 28, 32, 3>(
          tma, g, g_is_bf16, a, u, L, R, m, n, a_vec, g_vec, grid_x, grid_y,
          s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
