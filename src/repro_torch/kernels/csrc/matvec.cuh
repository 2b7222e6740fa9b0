// Vector-matrix product u_l = a_l^T G_l over a stack of L items (Eq. 21's
// u = a^T G), and |a_l|^2, in one launch: the kernel of matvec.cu (the
// matvec op) and the first launch of eva_f_fused.cu.
//
// Replaces the TPU kernels src/repro/kernels/matvec.py::matvec and
// ::matvec_stacked.  Those accumulate each (bn,) output block in VMEM across
// a sequential reduction grid axis over d_in.  Here one block owns the
// column strip [x * kMvCols, (x + 1) * kMvCols) of item l whole, and the
// reduction over d_in stays inside it:
//
//   * d_in is cut into chunks of kMvRows = 16 rows.  A lane owns kMvVec = 4
//     neighbouring columns of one chunk (a 16-byte vector of f32, 8 bytes
//     of bf16) and sums them over the chunk's rows in order, one in-order
//     f32 chain a column; a warp covers kMvSub = 8 chunks, the block's
//     warps kMvSub * warps chunks a round, and each chain's result goes to
//     shared memory;
//   * after each round the first warp adds the round's chunk results to
//     its running sums, column by column in chunk order, and finally writes
//     u;
//   * the item's first block also sums |a_l|^2 with one warp (lane-strided,
//     then a fixed shuffle tree), in a warp that then takes its chunks.
//
// Those are the sums, and the orders, of the two-launch design this
// replaces (per-chunk partials in scratch, then a finishing launch that
// summed them in chunk order), so u and |a|^2 keep its bits, with no
// scratch and no second launch.  The partition depends on (d_in, d_out)
// alone, never on L, so a stacked launch equals the per-item launches bit
// for bit; there is no atomic of any kind.
//
// A row of G is loaded as one vector a lane where the lane's first element
// of the row is aligned to the vector, else element by element: at d_out =
// 250 or 30 the rows alternate in alignment, and an item of a stack sits at
// another offset than alone.  A column's chain is the same either way.
//
// Bound on an H100: bytes.  G is read once; the work is a multiply and an
// add per element, far below the f32 rate.  A lane loads its 16 rows before
// it adds, so each lane keeps 16 vectors in flight.  The 16-column strips
// give the autoencoder's 784 x 1000 layer 63 blocks of 7 warps, its 1000 x
// 784 layer 49 of 8: the whole of G in flight in one round, where blocks of
// one warp each with a block that finished the sum after all others (an
// integer ticket per strip) had a serial tail longer than the loads.
//
// The kernel starts with griddepcontrol.launch_dependents, so that a launch
// made after it as a programmatic dependent (eva_f_fused.cu's emit launch)
// may start while it runs; where no such launch follows, as in the matvec
// op, the instruction does nothing.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kMvRows = 16;                   // rows a chunk
constexpr int kMvVec = 4;                     // columns a lane
constexpr int kMvCols = 16;                   // columns a block
constexpr int kMvSub = 32 / (kMvCols / kMvVec);  // chunks a warp
constexpr int kMvWarps = 8;                   // warps a block, at most

// One block per (strip, item), of ``warps`` warps (kernels/matvec.py::
// matvec_plan).
template <typename T>
__global__ void __launch_bounds__(kMvWarps * 32)
    matvec_kernel(const T* __restrict__ g, const float* __restrict__ a,
                  float* __restrict__ u, float* __restrict__ asq, int d_in,
                  int d_out) {
  asm volatile("griddepcontrol.launch_dependents;");
  constexpr int V = kMvVec;
  __shared__ float part[kMvWarps * kMvSub][kMvCols];
  const long long item = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int per_round = warps * kMvSub;
  const int grp = lane % (kMvCols / V), sub = lane / (kMvCols / V);
  const int j0 = blockIdx.x * kMvCols + grp * V;
  const int cnt = min(V, d_out - j0);  // columns of this lane; may be <= 0
  const int chunks = (d_in + kMvRows - 1) / kMvRows;
  const T* gl = g + item * d_in * d_out;
  const float* al = a + item * d_in;
  if (blockIdx.x == 0 && warp == warps - 1) {
    const float sa = warp_sumsq<32>(al, d_in);
    if (lane == 0) asq[item] = sa;
  }
  float s = 0.0f;  // the running sum of column blockIdx.x * kMvCols + lane
  for (int base = 0; base < chunks; base += per_round) {
    const int slot = warp * kMvSub + sub;
    const int c = base + slot;
    if (cnt > 0 && c < chunks) {
      const int r0 = c * kMvRows;
      const int rows = min(kMvRows, d_in - r0);
      float x[kMvRows][V];
#pragma unroll
      for (int r = 0; r < kMvRows; ++r) {
        if (r < rows) {
          const T* p = gl + static_cast<long long>(r0 + r) * d_out + j0;
          load_f32<T, V>(p, cnt, cnt == V && aligned(p, V * sizeof(T)),
                         x[r]);
        }
      }
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int r = 0; r < kMvRows; ++r) {
        if (r < rows) {
          const float ai = __ldg(al + r0 + r);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] += __fmul_rn(ai, x[r][k]);
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) part[slot][grp * V + k] = acc[k];
    }
    __syncthreads();
    if (warp == 0 && lane < kMvCols) {
      const int n = min(per_round, chunks - base);
#pragma unroll 8
      for (int q = 0; q < n; ++q) s += part[q][lane];
    }
    __syncthreads();
  }
  const int col = blockIdx.x * kMvCols + lane;
  if (warp == 0 && lane < kMvCols && col < d_out) u[item * d_out + col] = s;
}

template <typename T>
cudaError_t launch_matvec(const void* g, const void* a, void* u, void* asq,
                          long long L, long long d_in, long long d_out,
                          int warps, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((d_out + kMvCols - 1) / kMvCols),
                  static_cast<unsigned>(L));
  matvec_kernel<T><<<grid, warps * 32, 0, s>>>(
      static_cast<const T*>(g), static_cast<const float*>(a),
      static_cast<float*>(u), static_cast<float*>(asq),
      static_cast<int>(d_in), static_cast<int>(d_out));
  return cudaGetLastError();
}

}  // namespace repro

