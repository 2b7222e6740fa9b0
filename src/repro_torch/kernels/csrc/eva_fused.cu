// Fused Eva precondition -> update epilogue (Eq. 13 + momentum + the KL
// partials), in two launches.
//
// Replaces the TPU kernel src/repro/kernels/fused.py::eva_fused_stacked.  On
// the TPU one launch runs a sequential grid (L, 2, i, j): phase 0
// accumulates a^T G b into a resident output block and phase 1 reads it
// back.  CUDA blocks run concurrently, so here each phase is a launch of its
// own on one stream:
//
//   1. eva_dot_kernel: block x < blocks of item l covers the whole rows
//      [x * rows, (x + 1) * rows), rows = max(1, kTile / d_out), and writes
//      the partial sum of a_i * g_ij * b_j over them; one more block sums
//      |a|^2 and |b|^2 (one warp each, in bilinear.cu's finishing order).
//      Nothing else: no ticket, no finishing block.
//   2. eva_emit_kernel: block x of item l covers the elements [x * kTile,
//      (x + 1) * kTile) of the flattened item.  It loads its G (and m),
//      then sums launch 1's partials itself, in a fixed order (thread t
//      takes partials t, t + kEfThreads, ..., then block_sum), so that
//      every block forms the same dot and coeff = dot / (gamma + |a|^2
//      |b|^2), the denominator rounded as PyTorch's two eager ops round it.
//      It writes out = mu * m + P (or P without the fold), P = scale * (G -
//      coeff * a b^T) rounded as rank1_elem, and one [<out,G>, <out,out>,
//      <G,G>] partial.  The block that draws the last ticket from the
//      item's integer arrival counter (common.cuh's last_arrival) sums those
//      partials in a fixed order into aux (L, 3) and resets the counter.
//
// Every block summing the dot partials costs each block one more read of a
// few KB from L2, where a finishing block in launch 1 put a ticket, a
// serial sum and a store between the two launches.  Launch 2 is a
// programmatic dependent launch: its blocks may start while launch 1 runs,
// load their G and m, and wait (griddepcontrol.wait, which returns once
// launch 1 has completed and its stores are visible) before they read
// launch 1's partials or touch the workspace.
//
// gamma, scale = 1/gamma and mu come as f32 arguments, rounded on the host
// from the Python floats as torch.full_like rounds them.
//
// Each thread takes slots of kVec = 4 consecutive elements, slot s of a
// block starting kVec * s elements into the block's range; the thread's
// slots, and its order of summing them, follow from the element indices
// counted from the item's start (and d_in, d_out) alone.  A slot is loaded
// and stored as one vector (16 bytes of f32; 8 bytes of bf16 G) when every
// operand's slot address is aligned to it, else element by element; the
// block's range starts a multiple of kVec elements into a row (launch 1) or
// the item (launch 2), so one test per block decides.  Alignment decides
// only the loads: an item of a 2 x 129 x 127 stack, whose second item sits
// 4 bytes off a 16-byte boundary, gets the bits it gets alone.  The row and
// column of each element are carried along, with one division per thread.
// Every sum is in a fixed order and no float atomic is used, so a stacked
// launch equals the per-item launches bit for bit.
//
// Bound on an H100: bytes.  The function needs G and m read once and out
// written once; this design reads G twice (launches 1 and 2), the second
// time mostly from the 50 MB L2 (the largest item is 3.1 MB).  The 784 x
// 1000 layer gets 785 blocks in launch 1 and 766 in launch 2, about six on
// every one of the 132 SMs.
#include "common.cuh"

namespace repro {

constexpr int kEfThreads = 256;
constexpr int kVec = 4;                       // elements a slot
constexpr int kTile = kEfThreads * kVec;      // elements a block, about

inline int dot_rows(long long d_out) {
  return static_cast<int>(d_out >= kTile ? 1 : kTile / d_out);
}

// Sums partials[0..n) * k_values + k in a fixed order (thread t takes
// t, t + kEfThreads, ..., then block_sum); the totals land in thread 0.
template <int K>
__device__ __forceinline__ void sum_own_partials(
    const float* __restrict__ partials, int n, float (&s)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = 0.0f;
#pragma unroll 4
  for (int p = threadIdx.x; p < n; p += kEfThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] += __ldcg(partials + p * K + k);
  }
  block_sum<K>(s);
}

// Launch 1.  partials: (L, blocks) f32; norms: (L, 2) f32.  gridDim.x is
// blocks + 1.
template <typename T>
__global__ void __launch_bounds__(kEfThreads)
    eva_dot_kernel(const T* __restrict__ g, const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ partials,
                   float* __restrict__ norms, int d_in, int d_out, int rows) {
  // let launch 2 start loading G and m while this launch runs
  asm volatile("griddepcontrol.launch_dependents;");
  const long long item = blockIdx.y;
  const int blocks = gridDim.x - 1;
  const float* al = a + item * d_in;
  const float* bl = b + item * d_out;
  if (blockIdx.x == blocks) {  // the norms' block
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const float s =
          warp == 0 ? warp_sumsq<16>(al, d_in) : warp_sumsq<16>(bl, d_out);
      if ((threadIdx.x & 31) == 0) norms[2 * item + warp] = s;
    }
    return;
  }
  const T* gl = g + item * d_in * d_out;
  const int r0 = blockIdx.x * rows;
  const T* gb = gl + static_cast<long long>(r0) * d_out;  // the block's range
  const int len = (min(r0 + rows, d_in) - r0) * d_out;
  const bool vec = aligned(gb, kVec * sizeof(T));
  // (i, j) of the thread's current slot, and the step between its slots
  int off = kVec * threadIdx.x;
  int i = r0 + off / d_out, j = off % d_out;
  const int di = kTile / d_out, dj = kTile % d_out;
  float acc[1] = {0.0f};
  for (; off < len; off += kTile) {
    const int cnt = min(kVec, len - off);
    float x[kVec];
    load_f32<T, kVec>(gb + off, cnt, vec && cnt == kVec, x);
    int ii = i, jj = j;
    float ai = __ldg(al + ii);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < cnt) {
        acc[0] += __fmul_rn(__fmul_rn(ai, x[k]), __ldg(bl + jj));
        if (++jj == d_out && k + 1 < cnt) {
          jj = 0;
          ai = __ldg(al + ++ii);
        }
      }
    }
    i += di;
    j += dj;
    if (j >= d_out) {
      j -= d_out;
      ++i;
    }
  }
  block_sum<1>(acc);
  if (threadIdx.x == 0) partials[item * blocks + blockIdx.x] = acc[0];
}

// Launch 2.  dots: launch 1's (L, dot_blocks) partials and (L, 2) norms;
// partials: (L, blocks, 3) f32; aux: (L, 3) f32; counters: (L,), zero on
// entry and on exit.
template <typename T, bool kFold>
__global__ void __launch_bounds__(kEfThreads)
    eva_emit_kernel(const T* __restrict__ g, const float* __restrict__ a,
                    const float* __restrict__ b,
                    const float* __restrict__ dots,
                    const float* __restrict__ norms, int dot_blocks,
                    float gamma, float scale, float mu,
                    const float* __restrict__ m, float* __restrict__ out,
                    float* __restrict__ aux, float* __restrict__ partials,
                    unsigned int* __restrict__ counters, int d_in,
                    int d_out) {
  const long long item = blockIdx.y;
  const int blocks = gridDim.x;
  const int n = d_in * d_out;
  const T* gl = g + item * n;
  // m is read only with the fold, and may be null without it
  const float* ml = kFold ? m + item * n : nullptr;
  float* ol = out + item * n;
  const float* al = a + item * d_in;
  const float* bl = b + item * d_out;
  // every block's range starts a multiple of kVec elements into the item
  const bool vec = aligned(gl, kVec * sizeof(T)) && aligned(ol, 16) &&
                   (!kFold || aligned(ml, 16));
  const int e = blockIdx.x * kTile + kVec * threadIdx.x;  // one slot each
  const int cnt = min(kVec, n - e);                       // may be <= 0
  const bool v = vec && cnt == kVec;
  float x[kVec], mv[kVec];
  if (cnt > 0) {
    load_f32<T, kVec>(gl + e, cnt, v, x);
    if (kFold) load_f32<float, kVec>(ml + e, cnt, v, mv);
  }
  // launch 1's results are read only after it has completed (programmatic
  // dependent launch: this launch may start before)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // coeff, formed alike in every block of the item
  __shared__ float coeff_s;
  float na = 0.0f, nb = 0.0f;
  if (threadIdx.x == 0) {
    na = __ldcg(norms + 2 * item);
    nb = __ldcg(norms + 2 * item + 1);
  }
  float dot[1];
  sum_own_partials<1>(dots + item * dot_blocks, dot_blocks, dot);
  if (threadIdx.x == 0)
    coeff_s = __fdiv_rn(dot[0], __fadd_rn(gamma, __fmul_rn(na, nb)));
  __syncthreads();
  const float c = coeff_s;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float o[kVec];
  if (cnt > 0) {
    int i = e / d_out, j = e - i * d_out;
    float ai = __ldg(al + i);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < cnt) {
        const float p = rank1_elem(x[k], ai, __ldg(bl + j), c, scale);
        o[k] = kFold ? __fadd_rn(__fmul_rn(mu, mv[k]), p) : p;
        acc[0] = __fmaf_rn(o[k], x[k], acc[0]);
        acc[1] = __fmaf_rn(o[k], o[k], acc[1]);
        acc[2] = __fmaf_rn(x[k], x[k], acc[2]);
        if (++j == d_out && k + 1 < cnt) {
          j = 0;
          ai = __ldg(al + ++i);
        }
      }
    }
  }
  block_sum<3>(acc);
  float* dst = partials + (item * blocks + blockIdx.x) * 3;
  if (threadIdx.x == 0) {
    dst[0] = acc[0];
    dst[1] = acc[1];
    dst[2] = acc[2];
  }
  // the ticket before out's stores, so that its fence waits on the partial
  // alone; the finishing block does not read out
  const bool last = last_arrival(counters + item, blocks);
  if (cnt > 0) {
    if (v) {
      *reinterpret_cast<float4*>(ol + e) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (k < cnt) ol[e + k] = o[k];
    }
  }
  if (!last) return;

  float s[3];
  sum_own_partials<3>(partials + item * blocks * 3, blocks, s);
  if (threadIdx.x == 0) {
    aux[3 * item] = s[0];
    aux[3 * item + 1] = s[1];
    aux[3 * item + 2] = s[2];
    counters[item] = 0;
  }
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
  // launch 2 as a programmatic dependent of launch 1 (see eva_emit_kernel)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(emit_blocks, lu);
  cfg.blockDim = dim3(kEfThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* dd = dots;
  const float* nn = norms;
  if (fold)
    return cudaLaunchKernelEx(&cfg, eva_emit_kernel<T, true>, gt, af, bf, dd,
                              nn, dot_blocks, gamma, scale, mu, mf, outf, auxf,
                              partials, counters, di, dn);
  return cudaLaunchKernelEx(&cfg, eva_emit_kernel<T, false>, gt, af, bf, dd,
                            nn, dot_blocks, gamma, scale, mu, mf, outf, auxf,
                            partials, counters, di, dn);
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
  const long long rows = repro::dot_rows(d_out);
  const long long dot_blocks = (d_in + rows - 1) / rows;
  const long long emit_blocks = repro::num_chunks(d_in * d_out, repro::kTile);
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
