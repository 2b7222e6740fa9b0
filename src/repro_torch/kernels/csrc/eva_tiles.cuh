// The row-tile partition of the rank-one Eva kernels, shared by eva_fused.cu
// (Eq. 13 fused), bilinear.cu (Eq. 13's numerator and norms) and
// eva_f_fused.cu (Eq. 21 fused).  Two device bodies:
//
//   * dot_block: block x < blocks of item l covers the whole rows [x * rows,
//     (x + 1) * rows), rows = dot_rows(d_out) = max(1, kTile / d_out), and
//     writes the partial sum of a_i * g_ij * b_j over them; block `blocks`
//     sums |a|^2 and |b|^2 (one warp each, lane-strided, then a fixed
//     shuffle tree).  eva_fused.cu's first launch stops there and lets every
//     block of its second launch sum the partials; bilinear.cu finishes the
//     sum in the launch: the block that draws the item's last ticket
//     (common.cuh's last_arrival) sums the partials in sum_own_partials<1>'s
//     order, the order in which each block of eva_fused.cu's second launch
//     sums them, so the two give the same dot bit for bit.
//   * emit_tile: block x of item l covers the elements [x * kTile, (x + 1) *
//     kTile) of the flattened item, one slot of kVec elements a thread.  It
//     loads its G (and m, a and an operand b), waits for the launch before
//     it (programmatic dependent launch: griddepcontrol.wait returns once
//     that launch has completed and its stores are visible), forms the
//     item's coefficient from what that launch left (Src, below), and
//     writes out =
//     mu * m + P (or P without the fold), P = scale * (G - coeff * a b^T)
//     rounded as rank1_elem, and one [<out,G>, <out,out>, <G,G>] partial.
//     The block that draws the item's last ticket sums those partials in a
//     fixed order into aux (L, 3) and resets the counter.
//
// Src says where b and the coefficient come from:
//   * EvaSrc (Eq. 13): b is an operand; each block sums launch 1's dot
//     partials itself (sum_own_partials<1>) and forms coeff = dot / (gamma
//     + |a|^2 |b|^2), the denominator rounded as PyTorch's eager ops round
//     gamma + sq0 * sq1;
//   * EvaFSrc (Eq. 21): b is u = a^T G, and the coefficient 1 / (gamma +
//     |a|^2), from u and |a|^2 that matvec.cuh's kernel wrote into the
//     workspace; the rounding is that of PyTorch's 1.0 / (gamma + asq).
//
// Each thread's slot, and its order of summing, follow from the element
// indices counted from the item's start (and d_in, d_out) alone.  A slot is
// loaded and stored as one vector (16 bytes of f32; 8 bytes of bf16 G) when
// every operand's slot address is aligned to it, else element by element;
// a block's range starts a multiple of kVec elements into a row
// (dot_block) or the item (emit_tile), so one test per block decides.
// Alignment decides only the loads: an item of a 2 x 129 x 127 stack, whose
// second item sits 4 bytes off a 16-byte boundary, gets the bits it gets
// alone.  Every sum is in a fixed order and no float atomic is used, so a
// stacked launch equals the per-item launches bit for bit.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kEfThreads = kThreads;          // threads a block
constexpr int kVec = 4;                       // elements a slot
constexpr int kTile = kEfThreads * kVec;      // elements a block, about

inline int dot_rows(long long d_out) {
  return static_cast<int>(d_out >= kTile ? 1 : kTile / d_out);
}

// Row blocks of dot_block per item (its norms block not counted).
inline long long dot_blocks(long long d_in, long long d_out) {
  const long long rows = dot_rows(d_out);
  return (d_in + rows - 1) / rows;
}

// Blocks of emit_tile per item.
inline long long emit_blocks(long long d_in, long long d_out) {
  return (d_in * d_out + kTile - 1) / kTile;
}

// Sums partials[0..n) * K values + k in a fixed order (thread t takes
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

// One block of a row-tile dot launch: gridDim.x is blocks + 1, the last the
// norms' block.  partials: (L, blocks) f32; norms: (L, 2) f32.  With
// kFinish, dot: (L,) f32 and counters: (L,), zero on entry and on exit.
template <typename T, bool kFinish>
__device__ __forceinline__ void dot_block(
    const T* __restrict__ g, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ partials,
    float* __restrict__ norms, float* __restrict__ dot,
    unsigned int* __restrict__ counters, int d_in, int d_out, int rows) {
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
  float* pl = partials + item * blocks;
  if (threadIdx.x == 0) pl[blockIdx.x] = acc[0];
  if constexpr (kFinish) {
    if (!last_arrival(counters + item, blocks)) return;
    float s[1];
    sum_own_partials<1>(pl, blocks, s);
    if (threadIdx.x == 0) {
      dot[item] = s[0];
      counters[item] = 0;
    }
  }
}

// Where b and the coefficient of emit_tile come from.  kOperand: b is an
// operand, read before griddepcontrol.wait; else launch 1 wrote it, and it
// is read after.  b_at(bl, j): b_j of the item's row bl.  coeff(item,
// gamma): the item's coefficient, formed alike in every block and returned
// to every thread; every thread calls it, after the wait.

// Eq. 13: b an operand; launch 1's (L, dot_blocks) partials and (L, 2)
// norms give coeff = dot / (gamma + |a|^2 |b|^2), formed by thread 0 and
// passed on through shared memory.
struct EvaSrc {
  static constexpr bool kOperand = true;
  const float* b;
  const float* dots;
  const float* norms;
  int dot_blocks;

  __device__ __forceinline__ const float* row(long long item,
                                              int d_out) const {
    return b + item * d_out;
  }
  __device__ __forceinline__ float b_at(const float* bl, int j) const {
    return __ldg(bl + j);
  }
  __device__ __forceinline__ float coeff(long long item, float gamma) const {
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
    return coeff_s;
  }
};

// Eq. 21: b = u (L, d_out) and asq (L,) from matvec.cuh's kernel;
// coeff = 1 / (gamma + |a|^2), formed by every thread from the one value,
// so no barrier waits on it.  Both are read with ld.global.ca after the
// wait, which makes launch 1's stores visible to this launch: the blocks
// of an SM share the item's row of u through L1.
struct EvaFSrc {
  static constexpr bool kOperand = false;
  const float* u;
  const float* asq;

  __device__ __forceinline__ const float* row(long long item,
                                              int d_out) const {
    return u + item * d_out;
  }
  __device__ __forceinline__ float b_at(const float* bl, int j) const {
    return __ldca(bl + j);
  }
  __device__ __forceinline__ float coeff(long long item, float gamma) const {
    return __fdiv_rn(1.0f, __fadd_rn(gamma, __ldca(asq + item)));
  }
};

// One block of an emit launch.  partials: (L, blocks, 3) f32; aux: (L, 3)
// f32; counters: (L,), zero on entry and on exit.  m is read only with the
// fold, and may be null without it.  Each thread loads its slot's G, m and
// a (and an operand b) before the wait, so that only launch 1's results
// stand between the wait and the arithmetic.
template <typename T, bool kFold, typename Src>
__device__ __forceinline__ void emit_tile(
    const T* __restrict__ g, const float* __restrict__ a, const Src& src,
    float gamma, float scale, float mu, const float* __restrict__ m,
    float* __restrict__ out, float* __restrict__ aux,
    float* __restrict__ partials, unsigned int* __restrict__ counters,
    int d_in, int d_out) {
  const long long item = blockIdx.y;
  const int blocks = gridDim.x;
  const int n = d_in * d_out;
  const T* gl = g + item * n;
  const float* ml = kFold ? m + item * n : nullptr;
  float* ol = out + item * n;
  const float* al = a + item * d_in;
  const float* bl = src.row(item, d_out);
  // every block's range starts a multiple of kVec elements into the item
  const bool vec = aligned(gl, kVec * sizeof(T)) && aligned(ol, 16) &&
                   (!kFold || aligned(ml, 16));
  const int e = blockIdx.x * kTile + kVec * threadIdx.x;  // one slot each
  const int cnt = min(kVec, n - e);                       // may be <= 0
  const bool v = vec && cnt == kVec;
  // the slot's first (row, column); its elements run along the row and on
  // into the next
  const int i0 = e / d_out, j0 = e - i0 * d_out;
  float x[kVec], mv[kVec], av[kVec], bv[kVec];
  if (cnt > 0) {
    load_f32<T, kVec>(gl + e, cnt, v, x);
    if (kFold) load_f32<float, kVec>(ml + e, cnt, v, mv);
    int i = i0, j = j0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < cnt) {
        av[k] = __ldg(al + i);
        if (Src::kOperand) bv[k] = src.b_at(bl, j);
        if (++j == d_out) {
          j = 0;
          ++i;
        }
      }
    }
  }
  // the launch before's results are read only after it has completed
  // (programmatic dependent launch: this launch may start before)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!Src::kOperand && cnt > 0) {
    int j = j0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < cnt) {
        bv[k] = src.b_at(bl, j);
        if (++j == d_out) j = 0;
      }
    }
  }
  const float c = src.coeff(item, gamma);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float o[kVec];
  if (cnt > 0) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < cnt) {
        const float p = rank1_elem(x[k], av[k], bv[k], c, scale);
        o[k] = kFold ? __fadd_rn(__fmul_rn(mu, mv[k]), p) : p;
        acc[0] = __fmaf_rn(o[k], x[k], acc[0]);
        acc[1] = __fmaf_rn(o[k], o[k], acc[1]);
        acc[2] = __fmaf_rn(x[k], x[k], acc[2]);
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

// Launches ``kernel`` on ``grid`` as a programmatic dependent of the launch
// before it on stream s (see emit_tile).
template <typename... P, typename... A>
cudaError_t launch_dependent(void (*kernel)(P...), dim3 grid, cudaStream_t s,
                             A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kEfThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace repro
