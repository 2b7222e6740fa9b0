// Mamba-2's chunked SSD (state-space duality) scan: forward and backward.
//
// Replaces no TPU kernel: the reference (src/repro/models/ssm.py::
// ssd_chunked) is plain JAX, a lax.scan over chunks.  Its plain PyTorch
// version (models/ssm.py::ssd_plain) builds the (b, c, q, k, h) decay and
// score tensors in f32, about 0.8 GB each at mamba2-780m's shapes, three
// times a layer under remat.  Here no tensor with both chunk positions and
// the heads reaches device memory: each decay exp(seg_q - seg_k), its mask
// and its product with C·Bᵀ and dt live in a tile of shared memory or in
// registers.
//
// Per batch row b, chunk c of Q positions and head h (x: (b, s, h, P);
// dt: (b, s, h); B, C: (b, s, N), one group shared by every head):
//   seg_q  = Σ_{j<=q} dt_j·a_h            (within the chunk, in order)
//   S_c    = Σ_k B_k ⊗ exp(seg_{Q-1} - seg_k)·dt_k·x_k      (N x P)
//   S_in   : S_in[0] = 0, S_in[c+1] = exp(seg_{Q-1})·S_in[c] + S_c
//   y_q    = Σ_{k<=q} CB[q,k]·exp(seg_q - seg_k)·dt_k·x_k
//            + exp(seg_q)·C_q·S_in[c] + D_h·x_q
// The mask goes in before the exp (every exponent is <= 0), so nothing
// overflows at any decay.  A length that does not fill the last chunk reads
// zeros past it (dt = 0 there: an identity on the carried state), and
// nothing past it is written.
//
// Launches (stream order):
//   forward : seg, cb (C·Bᵀ a (b, c), lower tiles), states (S_c), pass
//             (S_in and the final state, in place), out (y)
//   backward: states (the state gradient each chunk's output sends back),
//             pass_bwd (its reverse recurrence), dcb (dM = dy·xᵀ summed over
//             the heads into d(C·Bᵀ), with the per-head row sums of its
//             products), dbc twice (dC, dB: the d(C·Bᵀ) product plus a sum
//             over (head, headdim) against the states), out (dx, and the
//             column sums), finish (the reverse cumsum into ddt, and
//             per-chunk partials of da and dD), head_sums (da, dD).
// Sums across blocks go through partials summed in a fixed order: no float
// atomics, so two runs give the same bits.
//
// Precision: every product and sum is f32 FMA on the SIMT pipes; bf16
// operands (x, B, C and dy at bf16) are widened exactly to f32 as they are
// staged.  No tensor core and no rounding of an f32 intermediate.
//
// Bound on an H100: operations.  At mamba2-780m's shapes (b 8, s 2048,
// h 48, P 64, N 128, Q 256) the forward needs 39.2 GFLOP a layer and the
// backward 78.5 (the products below the diagonal), against 0.66 GB of
// inputs and outputs: 1.76 ms as f32 FMA (67 TFLOP/s), 0.43 ms on the
// tensor cores (the products of two bf16 operands at 989 TFLOP/s, the rest
// as two TF32 products of a split f32 operand at 495), 0.20 ms of bytes
// (chip_smoke.py::_ssd_bounds).  The design
// is a shared-memory tiled product with register micro-tiles (4 x 4 to
// 8 x 4 outputs a thread), tiles wholly above the diagonal skipped, and a
// thread whose outputs are all masked skipping the products of a slice.
//
// Shapes are compile-time: (Q, N, P) in {(256, 128, 64), (256, 16, 64),
// (8, 16, 16)}, f32 or bf16 x, B and C; the entries return
// cudaErrorInvalidValue for any other (kernels/ssd.py raises first, naming
// the shape).
#include "common.cuh"

namespace repro {
namespace ssd {

constexpr int kRowTile = 64;      // chunk rows a block of the row kernels takes
constexpr int kPassThreads = 256; // threads of the state pass, one (b, h) a block

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// A BM x BN output tile: NT threads, thread (ty, tx) = (tid / CT, tid % CT)
// holds rows ty·TM.. and columns tx·TN.. of it.
template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int TM = cmax(1, BM / 16), TN = cmax(1, BN / 16);
  static constexpr int RT = BM / TM, CT = BN / TN, NT = RT * CT;
  // leading dimensions of the staged operands: 4 floats of padding keep
  // the rows 16-byte aligned and the transposing stores apart in the banks
  static constexpr int LA = BM + 4, LB = BN + 4;
  static_assert(NT % 32 == 0 && NT <= 256, "whole warps, at most 256");
  static_assert(CT <= 32 && 32 % CT == 0, "a row group within one warp");
};

template <typename T_, int Q_, int N_, int P_>
struct Shape {
  using T = T_;
  static constexpr int Q = Q_, N = N_, P = P_;
  static constexpr int RB = cmin(Q, kRowTile);     // rows a row tile
  static constexpr int QT = Q / RB;                // row tiles a chunk
  static constexpr int PAIRS = QT * (QT + 1) / 2;  // lower tile pairs
  // K slices: over chunk positions, d_state and headdim
  static constexpr int BKQ = cmin(32, Q), BKN = cmin(32, N), BKP = cmin(32, P);
  static constexpr int PT = P / BKP;               // headdim slices a head
  static constexpr int EPT = N * P / kPassThreads; // state elements a thread
  static constexpr int FT = cmax(32, Q);           // threads of finish
  static_assert(N * P % kPassThreads == 0 && Q % 8 == 0, "shape");
};

template <typename T>
struct Args {
  // inputs: rows (b, t) at b·sb + t·st elements, each row contiguous
  const T* x;
  long long xsb, xst;
  const float* dt;
  long long dtsb, dtst;
  const float* a;
  const T* bm;
  long long bsb, bst;
  const T* cm;
  long long csb, cst;
  const float* dskip;
  const T* dy;               // backward: the gradient of y, rows as x's
  long long dysb, dyst;
  const float* dfinal;       // backward: of the final state, or null
  int bsz, s, h, nc;
  // forward outputs and the saved scratch
  T* y;                      // (b, s, h, P) contiguous
  float* final_state;        // (b, h, N, P)
  float* seg;                // (b, nc, h, Q)
  float* cb;                 // (b, nc, Q, Q), lower tiles
  float* states;             // (b, nc, h, N, P): S_c, then S_in
  // backward outputs (contiguous) and scratch
  T* dx;
  float* ddt;                // (b, s, h)
  float* da;                 // (h,)
  T* dbm;                    // (b, s, N)
  T* dcm;
  float* ddskip;             // (h,)
  float* ds;                 // (b, nc, h, N, P)
  float* dcb;                // (b, nc, Q, Q), lower tiles
  float* rowp;               // (b, nc, QT, h, Q): Σ_k over a k tile
  float* col;                // (b, nc, h, Q): off the diagonal
  float* cold;               // (b, nc, h, Q): the diagonal's
  float* qside;              // (b, nc, h, Q)
  float* rho;                // (b, nc, h, Q)
  float* dtotp;              // (b, nc, h)
  float* ddp;                // (b, nc, h, QT)
  float* dap;                // (b, nc, h)
};

template <typename T>
__device__ __forceinline__ float rowval(const T* p, long long sb, long long st,
                                        int b, int t, int col, int s) {
  return t < s ? to_f32(p[b * sb + t * st + col]) : 0.0f;
}

__device__ __forceinline__ float dt_at(const float* dt, long long sb,
                                       long long st, int b, int t, int h,
                                       int s) {
  return t < s ? dt[b * sb + t * st + h] : 0.0f;
}

// One K slice of an operand, BK x W, on its way from memory to shared
// memory (row k at k·(W + 4)): fetch() loads it into registers, commit()
// stores them, so the next slice's loads are in flight while the current
// one is multiplied.  f(k, j) gives element (k, j); consecutive threads
// take consecutive j, or consecutive k where TRANS (memory contiguous
// along k: the loads coalesce and the stores transpose).
template <int BK, int W, int NT, bool TRANS>
struct Stage {
  static constexpr int R = (BK * W + NT - 1) / NT;
  float r[R];
  __device__ __forceinline__ static void at(int e, int& k, int& j) {
    if constexpr (TRANS) {
      k = e % BK;
      j = e / BK;
    } else {
      k = e / W;
      j = e % W;
    }
  }
  template <class F>
  __device__ __forceinline__ void fetch(int tid, int k0, F f) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int e = tid + i * NT;
      int k, j;
      at(e, k, j);
      if (R * NT == BK * W || e < BK * W) r[i] = f(k0 + k, j);
    }
  }
  __device__ __forceinline__ void commit(float* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int e = tid + i * NT;
      int k, j;
      at(e, k, j);
      if (R * NT == BK * W || e < BK * W) dst[k * (W + 4) + j] = r[i];
    }
  }
};

template <int TM>
__device__ __forceinline__ void lds(const float* p, float (&v)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TM / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) v[i] = p[i];
  }
}

// acc[i][j] += Σ_k As[k][ty·TM + i]·Bs[k][tx·TN + j]
template <class TL, int BK>
__device__ __forceinline__ void mma(const float* As, const float* Bs,
                                    float (&acc)[TL::TM][TL::TN], int ty,
                                    int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float av[TL::TM], bv[TL::TN];
    lds<TL::TM>(As + k * TL::LA + ty * TL::TM, av);
    lds<TL::TN>(Bs + k * TL::LB + tx * TL::TN, bv);
#pragma unroll
    for (int i = 0; i < TL::TM; ++i)
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc += A·B over K indices [k_begin, k_end) in slices of BK, A(k, m) =
// fa(k, m), B(k, j) = fb(k, j); need(k0): whether this thread's outputs
// take anything from the slice at k0.  Every thread of the block calls it.
template <class TL, int BK, bool TA, bool TB, class FA, class FB, class NEED>
__device__ __forceinline__ void kloop(float* As, float* Bs,
                                      float (&acc)[TL::TM][TL::TN],
                                      int k_begin, int k_end, FA fa, FB fb,
                                      NEED need) {
  const int tid = threadIdx.x, ty = tid / TL::CT, tx = tid % TL::CT;
  Stage<BK, TL::BM, TL::NT, TA> sa;
  Stage<BK, TL::BN, TL::NT, TB> sb;
  if (k_begin >= k_end) return;
  sa.fetch(tid, k_begin, fa);
  sb.fetch(tid, k_begin, fb);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    sa.commit(As, tid);
    sb.commit(Bs, tid);
    __syncthreads();
    if (k0 + BK < k_end) {
      sa.fetch(tid, k0 + BK, fa);
      sb.fetch(tid, k0 + BK, fb);
    }
    if (need(k0)) mma<TL, BK>(As, Bs, acc, ty, tx);
    __syncthreads();
  }
}

struct Always {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

// Sum of v over the CT consecutive lanes of a row group, in every lane.
template <int CT>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = CT / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block's NT threads, in a fixed order; valid in
// thread 0.  Every thread must call it; it ends with a barrier.
template <int NT>
__device__ __forceinline__ float block_total(float v) {
  __shared__ float warps[NT / 32];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += warps[w];
  __syncthreads();
  return s;
}

// tile pair i -> (qt, kt), qt >= kt, row by row
__device__ __forceinline__ void pair_of(int i, int& qt, int& kt) {
  qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= i) ++qt;
  kt = i - qt * (qt + 1) / 2;
}

// the row of seg (Q values) of (b, c, h), bch = (b·nc + c)·h_count + h
__device__ __forceinline__ long long seg_row(long long bch, int Q) {
  return bch * Q;
}

__device__ __forceinline__ long long state_at(int b, int c, int h, int nc,
                                              int H, int NP) {
  return ((static_cast<long long>(b) * nc + c) * H + h) * NP;
}

// A thread's share of one (b, c, h) state in the pass: EPT elements,
// float4 i of thread t at float4 i·kPassThreads + t, so that each load
// of the block is one contiguous run.
template <int EPT>
struct Share {
  float v[EPT];
  __device__ __forceinline__ void load(const float* p, int tid) {
    if constexpr (EPT % 4 == 0) {
#pragma unroll
      for (int i = 0; i < EPT / 4; ++i) {
        const float4 t = reinterpret_cast<const float4*>(p)[i * kPassThreads + tid];
        v[4 * i] = t.x;
        v[4 * i + 1] = t.y;
        v[4 * i + 2] = t.z;
        v[4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < EPT; ++i) v[i] = p[i * kPassThreads + tid];
    }
  }
  __device__ __forceinline__ void store(float* p, int tid) const {
    if constexpr (EPT % 4 == 0) {
#pragma unroll
      for (int i = 0; i < EPT / 4; ++i)
        reinterpret_cast<float4*>(p)[i * kPassThreads + tid] =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < EPT; ++i) p[i * kPassThreads + tid] = v[i];
    }
  }
};

// ---------------------------------------------------------------------------
// Forward

// One thread a (b, c, h): seg, summed in order as torch.cumsum sums a
// non-innermost dimension on the card (one thread walks it), each product
// and sum rounded on its own; dt is loaded eight positions at a time.
template <class Sh>
__global__ void seg_kernel(Args<typename Sh::T> A) {
  const long long bch = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (bch >= static_cast<long long>(A.bsz) * A.nc * A.h) return;
  const int h = static_cast<int>(bch % A.h);
  const int bc = static_cast<int>(bch / A.h);
  const int c = bc % A.nc, b = bc / A.nc;
  const float ah = A.a[h];
  float* out = A.seg + seg_row(bch, Sh::Q);
  float acc = 0.0f;
  for (int q0 = 0; q0 < Sh::Q; q0 += 8) {
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      d[i] = dt_at(A.dt, A.dtsb, A.dtst, b, c * Sh::Q + q0 + i, h, A.s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(d[i], ah));
      out[q0 + i] = acc;
    }
  }
}

// C·Bᵀ of a (b, c), one lower tile pair a block (blockIdx.y).
template <class Sh>
__global__ void __launch_bounds__(Tile<Sh::RB, Sh::RB>::NT)
    cb_kernel(Args<typename Sh::T> A) {
  using TL = Tile<Sh::RB, Sh::RB>;
  constexpr int BK = Sh::BKN, Q = Sh::Q;
  __shared__ __align__(16) float As[BK * TL::LA];
  __shared__ __align__(16) float Bs[BK * TL::LB];
  const int bc = blockIdx.x, b = bc / A.nc, c = bc % A.nc;
  int qt, kt;
  pair_of(blockIdx.y, qt, kt);
  const int q0 = qt * Sh::RB, k0 = kt * Sh::RB;
  const int tid = threadIdx.x, ty = tid / TL::CT, tx = tid % TL::CT;
  float acc[TL::TM][TL::TN] = {};
  kloop<TL, BK, true, true>(
      As, Bs, acc, 0, Sh::N,
      [&](int n, int m) {
        return rowval(A.cm, A.csb, A.cst, b, c * Q + q0 + m, n, A.s);
      },
      [&](int n, int j) {
        return rowval(A.bm, A.bsb, A.bst, b, c * Q + k0 + j, n, A.s);
      },
      Always());
  float* out = A.cb + static_cast<long long>(bc) * Q * Q;
#pragma unroll
  for (int i = 0; i < TL::TM; ++i)
#pragma unroll
    for (int j = 0; j < TL::TN; ++j)
      out[(q0 + ty * TL::TM + i) * Q + k0 + tx * TL::TN + j] = acc[i][j];
}

// One (b, c, h) a block: out[n][p] = Σ_q U[q][n]·coef_q·V[q][p].
// Forward: U = B, V = x, coef = exp(seg_{Q-1} - seg_q)·dt_q: the chunk's
// state S_c.  Backward: U = C, V = dy, coef = exp(seg_q): the gradient the
// chunk's output sends to the state entering it.
template <class Sh, bool BWD>
__global__ void __launch_bounds__(Tile<Sh::N, Sh::P>::NT, 2)
    states_kernel(Args<typename Sh::T> A) {
  using T = typename Sh::T;
  using TL = Tile<Sh::N, Sh::P>;
  constexpr int BK = Sh::BKQ, Q = Sh::Q, P = Sh::P;
  __shared__ __align__(16) float As[BK * TL::LA];
  __shared__ __align__(16) float Bs[BK * TL::LB];
  __shared__ float coef[Q];
  const int bch = blockIdx.x, h = bch % A.h, bc = bch / A.h;
  const int c = bc % A.nc, b = bc / A.nc;
  const int tid = threadIdx.x, ty = tid / TL::CT, tx = tid % TL::CT;
  const float* segp = A.seg + seg_row(bch, Q);
  const float total = segp[Q - 1];
  for (int q = tid; q < Q; q += TL::NT) {
    if constexpr (BWD)
      coef[q] = expf(segp[q]);
    else
      coef[q] = expf(total - segp[q]) *
                dt_at(A.dt, A.dtsb, A.dtst, b, c * Q + q, h, A.s);
  }
  const T* U = BWD ? A.cm : A.bm;
  const long long usb = BWD ? A.csb : A.bsb, ust = BWD ? A.cst : A.bst;
  const T* V = BWD ? A.dy : A.x;
  const long long vsb = BWD ? A.dysb : A.xsb, vst = BWD ? A.dyst : A.xst;
  __syncthreads();
  float acc[TL::TM][TL::TN] = {};
  kloop<TL, BK, false, false>(
      As, Bs, acc, 0, Q,
      [&](int q, int n) { return rowval(U, usb, ust, b, c * Q + q, n, A.s); },
      [&](int q, int p) {
        return coef[q] * rowval(V, vsb, vst, b, c * Q + q, h * P + p, A.s);
      },
      Always());
  float* out = (BWD ? A.ds : A.states) + static_cast<long long>(bch) * Sh::N * P;
#pragma unroll
  for (int i = 0; i < TL::TM; ++i)
#pragma unroll
    for (int j = 0; j < TL::TN; ++j)
      out[(ty * TL::TM + i) * P + tx * TL::TN + j] = acc[i][j];
}

// One (b, h) a block: S_c becomes S_in in place, chunk by chunk, and the
// state after the last chunk is the final state.
template <class Sh>
__global__ void __launch_bounds__(kPassThreads)
    pass_kernel(Args<typename Sh::T> A) {
  constexpr int NP = Sh::N * Sh::P, Q = Sh::Q;
  const int bh = blockIdx.x, h = bh % A.h, b = bh / A.h, tid = threadIdx.x;
  Share<Sh::EPT> st;
#pragma unroll
  for (int i = 0; i < Sh::EPT; ++i) st.v[i] = 0.0f;
  for (int c = 0; c < A.nc; ++c) {
    float* p = A.states + state_at(b, c, h, A.nc, A.h, NP);
    Share<Sh::EPT> sc;
    sc.load(p, tid);
    st.store(p, tid);
    const long long bch = static_cast<long long>(b * A.nc + c) * A.h + h;
    const float et = expf(A.seg[seg_row(bch, Q) + Q - 1]);
#pragma unroll
    for (int i = 0; i < Sh::EPT; ++i)
      st.v[i] = __fadd_rn(__fmul_rn(st.v[i], et), sc.v[i]);
  }
  st.store(A.final_state + static_cast<long long>(bh) * NP, tid);
}

// The row kernel, one (b, c, h) and RB rows a block.
// Forward, rows q:  y = Σ_{k<=q} CB[q,k]·exp(seg_q - seg_k)·dt_k·x_k
//                       + exp(seg_q)·C_q·S_in + D·x_q
// Backward, rows k: dx = dt_k·(I_k + exp(seg_{Q-1} - seg_k)·B_k·dS)
//                       + D·dy_k,  I_k = Σ_{q>=k} CB[q,k]·exp(seg_q - seg_k)·dy_q,
// with the column sums of CB·L·(dy·xᵀ): col_k over q > k (Σ_p x_k·I_k
// before the diagonal joins I) and cold_k = CB[k,k]·x_k·dy_k, and the
// block's share of dD = Σ dy·x.  The diagonal terms of d(seg) cancel in
// exact arithmetic (the q = k decay is exp(0)), so they are kept out of
// col and out of dcb_kernel's row sums: under strong decay they are
// nearly all of both sums, and their rounding would be nearly all of d(a).
// Away from the diagonal tile each decay factors through the seg m of the
// tile's edge, exp(seg_q - seg_k) = exp(seg_q - m)·exp(m - seg_k), both
// exponents <= 0 (seg falls along the chunk: dt >= 0 and a <= 0), so the
// tile's own rows take one exp each and the products there need none; only
// the diagonal tile takes an exp an element, under the mask.
template <class Sh, bool BWD>
__global__ void __launch_bounds__(Tile<Sh::RB, Sh::P>::NT, 3)
    out_kernel(Args<typename Sh::T> A) {
  using T = typename Sh::T;
  using TL = Tile<Sh::RB, Sh::P>;
  constexpr int Q = Sh::Q, N = Sh::N, P = Sh::P, RB = Sh::RB;
  constexpr int BKQ = Sh::BKQ, BKN = Sh::BKN, BK = cmax(BKQ, BKN);
  __shared__ __align__(16) float As[BK * TL::LA];
  __shared__ __align__(16) float Bs[BK * TL::LB];
  __shared__ float segs[Q], dts[Q], fac[Q];
  const int bch = blockIdx.x, h = bch % A.h, bc = bch / A.h;
  const int c = bc % A.nc, b = bc / A.nc;
  const int rt = blockIdx.y, r0 = rt * RB;
  const int tid = threadIdx.x, ty = tid / TL::CT, tx = tid % TL::CT;
  const float* segp = A.seg + seg_row(bch, Q);
  // m: seg at the tile's first row (forward) or last row (backward)
  const float m = segp[BWD ? r0 + RB - 1 : r0];
  for (int q = tid; q < Q; q += TL::NT) {
    segs[q] = segp[q];
    dts[q] = dt_at(A.dt, A.dtsb, A.dtst, b, c * Q + q, h, A.s);
    // the off-diagonal positions' factors: exp(m - seg_k)·dt_k below the
    // tile (forward), exp(seg_q - m) above it (backward)
    fac[q] = BWD ? expf(segs[q] - m) : expf(m - segs[q]) * dts[q];
  }
  __syncthreads();
  const float* cbp = A.cb + static_cast<long long>(bc) * Q * Q;
  const float* sp = (BWD ? A.ds : A.states) + state_at(b, c, h, A.nc, A.h, N * P);
  const T* V = BWD ? A.dy : A.x;
  const long long vsb = BWD ? A.dysb : A.xsb, vst = BWD ? A.dyst : A.xst;
  const int row_lo = r0 + ty * TL::TM, row_hi = row_lo + TL::TM - 1;
  auto v_at = [&](int t, int p) {
    return rowval(V, vsb, vst, b, c * Q + t, h * P + p, A.s);
  };
  float acc[TL::TM][TL::TN] = {};
  float rowf[TL::TM];
  if constexpr (!BWD) {
    // exp(seg_q)·C_q·S_in = exp(seg_q - m)·C_q·(exp(m)·S_in)
    const float em = expf(m);
    kloop<TL, BKN, true, false>(
        As, Bs, acc, 0, N,
        [&](int n, int i) {
          return rowval(A.cm, A.csb, A.cst, b, c * Q + r0 + i, n, A.s);
        },
        [&](int n, int p) { return em * sp[n * P + p]; }, Always());
    kloop<TL, BKQ, true, false>(
        As, Bs, acc, 0, r0,
        [&](int k, int i) { return cbp[(r0 + i) * Q + k] * fac[k]; }, v_at,
        Always());
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) {
      rowf[i] = expf(segs[row_lo + i] - m);
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) acc[i][j] *= rowf[i];
    }
    kloop<TL, BKQ, true, false>(
        As, Bs, acc, r0, r0 + RB,
        [&](int k, int i) {
          const int q = r0 + i;
          return q >= k ? cbp[q * Q + k] * expf(segs[q] - segs[k]) * dts[k]
                        : 0.0f;
        },
        v_at, [&](int k0) { return row_hi >= k0; });
  } else {
    // exp(seg_{Q-1} - seg_k) = exp(m - seg_k)·exp(seg_{Q-1} - m)
    const float etm = expf(segs[Q - 1] - m);
    float acc2[TL::TM][TL::TN] = {};
    kloop<TL, BKN, true, false>(
        As, Bs, acc2, 0, N,
        [&](int n, int i) {
          return rowval(A.bm, A.bsb, A.bst, b, c * Q + r0 + i, n, A.s);
        },
        [&](int n, int p) { return etm * sp[n * P + p]; }, Always());
    kloop<TL, BKQ, false, false>(
        As, Bs, acc, r0 + RB, Q,
        [&](int q, int i) { return cbp[q * Q + r0 + i]; },
        [&](int q, int p) { return fac[q] * v_at(q, p); }, Always());
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) {
      rowf[i] = expf(m - segs[row_lo + i]);
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) {
        acc[i][j] *= rowf[i];
        acc2[i][j] *= rowf[i];
      }
    }
    kloop<TL, BKQ, false, false>(
        As, Bs, acc, r0, r0 + RB,
        [&](int q, int i) {
          const int k = r0 + i;
          return q > k ? cbp[q * Q + k] * expf(segs[q] - segs[k]) : 0.0f;
        },
        v_at, [&](int q0) { return row_lo < q0 + BKQ - 1; });
    // col_k = Σ_p x·I and cold_k, then I takes its diagonal term
    // CB[k,k]·dy_k and acc = dt_k·(I + the states' term)
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) {
      const int k = row_lo + i, t = c * Q + k;
      const float cbd = cbp[k * Q + k];
      float v = 0.0f, vd = 0.0f;
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) {
        const int p = tx * TL::TN + j;
        const float xv = rowval(A.x, A.xsb, A.xst, b, t, h * P + p, A.s);
        const float dv = v_at(k, p);
        v += xv * acc[i][j];
        vd += xv * dv;
        acc[i][j] += cbd * dv;
      }
      v = group_sum<TL::CT>(v);
      vd = group_sum<TL::CT>(vd);
      if (tx == 0) {
        A.col[seg_row(bch, Q) + k] = v;
        A.cold[seg_row(bch, Q) + k] = cbd * vd;
      }
      const float d = dts[k];
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) acc[i][j] = d * (acc[i][j] + acc2[i][j]);
    }
  }
  const float dd = A.dskip[h];
  T* out = BWD ? A.dx : A.y;
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < TL::TM; ++i) {
    const int t = c * Q + row_lo + i;
    if (t >= A.s) continue;
    const T* vrow = V + b * vsb + t * vst + h * P;
    T* orow = out + (static_cast<long long>(b) * A.s + t) * A.h * P + h * P;
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) {
      const int p = tx * TL::TN + j;
      const float v = to_f32(vrow[p]);
      orow[p] = from_f32<T>(acc[i][j] + dd * v);
      if constexpr (BWD)
        part += v * to_f32(A.x[b * A.xsb + t * A.xst + h * P + p]);
    }
  }
  if constexpr (BWD) {
    part = block_total<TL::NT>(part);
    if (tid == 0) A.ddp[static_cast<long long>(bch) * Sh::QT + rt] = part;
  }
}

// ---------------------------------------------------------------------------
// Backward

// Reverse recurrence over the chunks, one (b, h) a block: ds[c] holds the
// gradient of S_in[c] from chunk c's output; it becomes g_{c+1}, the
// gradient of the state leaving chunk c (of S_c), and d(seg_{Q-1}) of
// chunk c, exp(seg_{Q-1})·Σ g_{c+1}·S_in[c], goes to dtotp.
template <class Sh>
__global__ void __launch_bounds__(kPassThreads)
    pass_bwd_kernel(Args<typename Sh::T> A) {
  constexpr int NP = Sh::N * Sh::P, Q = Sh::Q;
  const int bh = blockIdx.x, h = bh % A.h, b = bh / A.h, tid = threadIdx.x;
  Share<Sh::EPT> g;
  if (A.dfinal) {
    g.load(A.dfinal + static_cast<long long>(bh) * NP, tid);
  } else {
#pragma unroll
    for (int i = 0; i < Sh::EPT; ++i) g.v[i] = 0.0f;
  }
  for (int c = A.nc - 1; c >= 0; --c) {
    const long long off = state_at(b, c, h, A.nc, A.h, NP);
    Share<Sh::EPT> t, sin;
    t.load(A.ds + off, tid);
    sin.load(A.states + off, tid);
    g.store(A.ds + off, tid);
    const long long bch = static_cast<long long>(b * A.nc + c) * A.h + h;
    const float et = expf(A.seg[seg_row(bch, Q) + Q - 1]);
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < Sh::EPT; ++i) part += g.v[i] * sin.v[i];
    part = block_total<kPassThreads>(part);
    if (tid == 0) A.dtotp[bch] = et * part;
#pragma unroll
    for (int i = 0; i < Sh::EPT; ++i)
      g.v[i] = __fadd_rn(__fmul_rn(et, g.v[i]), t.v[i]);
  }
}

// One lower tile pair of a (b, c) a block, every head in turn, its P in
// slices: dM = dy_q·x_kᵀ, L = exp(seg_q - seg_k) masked to q >= k (off the
// diagonal exp(seg_q - m)·exp(m - seg_k) through the k tile's last seg m),
// d(C·Bᵀ)[q,k] = Σ_h L·dt_k·dM, and per head Σ_{k<q} CB·L·dt_k·dM (rowp,
// this k tile's share; the column sums come from out_kernel's I, and the
// diagonal terms cancel: see out_kernel).
template <class Sh>
__global__ void __launch_bounds__(Tile<Sh::RB, Sh::RB>::NT, 3)
    dcb_kernel(Args<typename Sh::T> A) {
  using TL = Tile<Sh::RB, Sh::RB>;
  constexpr int Q = Sh::Q, P = Sh::P, RB = Sh::RB, BK = Sh::BKP;
  constexpr int PT = Sh::PT;
  __shared__ __align__(16) float As[BK * TL::LA];
  __shared__ __align__(16) float Bs[BK * TL::LB];
  const int bc = blockIdx.x, b = bc / A.nc, c = bc % A.nc;
  int qt, kt;
  pair_of(blockIdx.y, qt, kt);
  const int q0 = qt * RB, k0 = kt * RB;
  const int tid = threadIdx.x, ty = tid / TL::CT, tx = tid % TL::CT;
  const float* cbp = A.cb + static_cast<long long>(bc) * Q * Q;
  float cbr[TL::TM][TL::TN], dcb[TL::TM][TL::TN], acc[TL::TM][TL::TN];
#pragma unroll
  for (int i = 0; i < TL::TM; ++i)
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) {
      cbr[i][j] = cbp[(q0 + ty * TL::TM + i) * Q + k0 + tx * TL::TN + j];
      dcb[i][j] = acc[i][j] = 0.0f;
    }
  // some output of this thread has q >= k
  const bool active = q0 + ty * TL::TM + TL::TM - 1 >= k0 + tx * TL::TN;
  Stage<BK, RB, TL::NT, true> sa, sb;
  auto fetch = [&](int s) {
    const int hh = s / PT, p0 = (s % PT) * BK;
    sa.fetch(tid, p0, [&](int p, int m) {
      return rowval(A.dy, A.dysb, A.dyst, b, c * Q + q0 + m, hh * P + p, A.s);
    });
    sb.fetch(tid, p0, [&](int p, int j) {
      return rowval(A.x, A.xsb, A.xst, b, c * Q + k0 + j, hh * P + p, A.s);
    });
  };
  const int slices = A.h * PT;
  fetch(0);
  for (int s = 0; s < slices; ++s) {
    sa.commit(As, tid);
    sb.commit(Bs, tid);
    __syncthreads();
    if (s + 1 < slices) fetch(s + 1);
    if (active) mma<TL, BK>(As, Bs, acc, ty, tx);
    __syncthreads();
    if ((s + 1) % PT) continue;
    // the head's products are complete
    const int h = s / PT;
    const long long bch = static_cast<long long>(bc) * A.h + h;
    const float* segp = A.seg + seg_row(bch, Q);
    const float mk = segp[k0 + RB - 1];
    float eq[TL::TM], ek[TL::TN], dk[TL::TN], rowp[TL::TM];
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) {
      eq[i] = segp[q0 + ty * TL::TM + i];
      if (qt > kt) eq[i] = expf(eq[i] - mk);
      rowp[i] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) {
      const int k = k0 + tx * TL::TN + j;
      ek[j] = qt > kt ? expf(mk - segp[k]) : segp[k];
      dk[j] = dt_at(A.dt, A.dtsb, A.dtst, b, c * Q + k, h, A.s);
    }
#pragma unroll
    for (int i = 0; i < TL::TM; ++i)
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) {
        float l;
        bool strict = true;
        if (qt > kt) {
          l = eq[i] * ek[j];
        } else {
          const int d = ty * TL::TM + i - (tx * TL::TN + j);
          l = d >= 0 ? expf(eq[i] - ek[j]) : 0.0f;
          strict = d > 0;
        }
        const float v = l * acc[i][j] * dk[j];
        dcb[i][j] += v;
        if (strict) rowp[i] += cbr[i][j] * v;
        acc[i][j] = 0.0f;
      }
    const long long rbase = ((static_cast<long long>(bc) * Sh::QT + kt) * A.h + h) * Q;
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) {
      const float v = group_sum<TL::CT>(rowp[i]);
      if (tx == 0) A.rowp[rbase + q0 + ty * TL::TM + i] = v;
    }
  }
  float* out = A.dcb + static_cast<long long>(bc) * Q * Q;
#pragma unroll
  for (int i = 0; i < TL::TM; ++i)
#pragma unroll
    for (int j = 0; j < TL::TN; ++j)
      out[(q0 + ty * TL::TM + i) * Q + k0 + tx * TL::TN + j] = dcb[i][j];
}

// One (b, c) and RB rows a block, then every head in turn, its P in slices.
// dC (rows q): Σ_{k<=q} d(CB)[q,k]·B_k + Σ_h exp(seg_q)·dy_q·S_inᵀ, with
//   qside[h, q] = Σ_n C[q,n]·(the head's term)[q,n];
// dB (rows k): Σ_{q>=k} d(CB)[q,k]·C_q + Σ_h dt_k·exp(seg_{Q-1} - seg_k)·
//   x_k·dSᵀ, with rho[h, k] = Σ_n B[k,n]·(the head's term without dt)[k,n].
template <class Sh, bool ISB>
__global__ void __launch_bounds__(Tile<Sh::RB, Sh::N>::NT, 2)
    dbc_kernel(Args<typename Sh::T> A) {
  using T = typename Sh::T;
  using TL = Tile<Sh::RB, Sh::N>;
  constexpr int Q = Sh::Q, N = Sh::N, P = Sh::P, RB = Sh::RB;
  constexpr int BKQ = Sh::BKQ, BKP = Sh::BKP, BK = cmax(BKQ, BKP);
  constexpr int PT = Sh::PT;
  __shared__ __align__(16) float As[BK * TL::LA];
  __shared__ __align__(16) float Bs[BK * TL::LB];
  const int bc = blockIdx.x, b = bc / A.nc, c = bc % A.nc;
  const int r0 = blockIdx.y * RB;
  const int tid = threadIdx.x, ty = tid / TL::CT, tx = tid % TL::CT;
  const int row_lo = r0 + ty * TL::TM, row_hi = row_lo + TL::TM - 1;
  const float* dcbp = A.dcb + static_cast<long long>(bc) * Q * Q;
  // the other operand of the d(CB) product, and U of the per-head sums
  const T* W = ISB ? A.cm : A.bm;
  const long long wsb = ISB ? A.csb : A.bsb, wst = ISB ? A.cst : A.bst;
  const T* U = ISB ? A.bm : A.cm;
  const long long usb = ISB ? A.bsb : A.csb, ust = ISB ? A.bst : A.cst;
  auto w_at = [&](int t, int n) {
    return rowval(W, wsb, wst, b, c * Q + t, n, A.s);
  };
  float acc[TL::TM][TL::TN] = {};
  if constexpr (!ISB) {
    kloop<TL, BKQ, true, false>(
        As, Bs, acc, 0, r0 + RB,
        [&](int k, int m) { return dcbp[(r0 + m) * Q + k]; }, w_at,
        [&](int k0) { return row_hi >= k0; });
  } else {
    kloop<TL, BKQ, false, false>(
        As, Bs, acc, r0, Q,
        [&](int q, int m) { return dcbp[q * Q + r0 + m]; }, w_at,
        [&](int q0) { return row_lo <= q0 + BKQ - 1; });
  }
  const T* V = ISB ? A.x : A.dy;
  const long long vsb = ISB ? A.xsb : A.dysb, vst = ISB ? A.xst : A.dyst;
  const float* sbase = ISB ? A.ds : A.states;
  float* side = ISB ? A.rho : A.qside;
  Stage<BKP, RB, TL::NT, true> sa;
  Stage<BKP, N, TL::NT, true> sb;
  auto fetch = [&](int s) {
    const int hh = s / PT, p0 = (s % PT) * BKP;
    const float* sp = sbase + state_at(b, c, hh, A.nc, A.h, N * P);
    sa.fetch(tid, p0, [&](int p, int m) {
      return rowval(V, vsb, vst, b, c * Q + r0 + m, hh * P + p, A.s);
    });
    sb.fetch(tid, p0, [&](int p, int n) { return sp[n * P + p]; });
  };
  float acch[TL::TM][TL::TN] = {};
  const int slices = A.h * PT;
  fetch(0);
  for (int s = 0; s < slices; ++s) {
    sa.commit(As, tid);
    sb.commit(Bs, tid);
    __syncthreads();
    if (s + 1 < slices) fetch(s + 1);
    mma<TL, BKP>(As, Bs, acch, ty, tx);
    __syncthreads();
    if ((s + 1) % PT) continue;
    const int h = s / PT;
    const long long sbase_h = (static_cast<long long>(bc) * A.h + h) * Q;
    const float* segp = A.seg + sbase_h;
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) {
      const int t = c * Q + row_lo + i;
      // exp(seg_{Q-1} - seg_k) (dB) or exp(seg_q) (dC) of the row
      const float coef = ISB ? expf(segp[Q - 1] - segp[row_lo + i])
                             : expf(segp[row_lo + i]);
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) acch[i][j] *= coef;
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < TL::TN; ++j)
        v += rowval(U, usb, ust, b, t, tx * TL::TN + j, A.s) * acch[i][j];
      v = group_sum<TL::CT>(v);
      if (tx == 0) side[sbase_h + row_lo + i] = v;
      const float f = ISB ? dt_at(A.dt, A.dtsb, A.dtst, b, t, h, A.s) : 1.0f;
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) {
        acc[i][j] += f * acch[i][j];
        acch[i][j] = 0.0f;
      }
    }
  }
  T* out = ISB ? A.dbm : A.dcm;
#pragma unroll
  for (int i = 0; i < TL::TM; ++i) {
    const int t = c * Q + row_lo + i;
    if (t >= A.s) continue;
    T* orow = out + (static_cast<long long>(b) * A.s + t) * N;
#pragma unroll
    for (int j = 0; j < TL::TN; ++j)
      orow[tx * TL::TN + j] = from_f32<T>(acc[i][j]);
  }
}

// One (b, c, h) a block, a thread a position: d(seg_q) from its parts,
// its reverse cumsum (plus d(seg_{Q-1}) from the states) into d(dt·a),
// then ddt and the chunk's share of da.
template <class Sh>
__global__ void __launch_bounds__(Sh::FT) finish_kernel(Args<typename Sh::T> A) {
  constexpr int Q = Sh::Q, QT = Sh::QT, RB = Sh::RB;
  __shared__ float dseg[Q];
  const int bch = blockIdx.x, h = bch % A.h, bc = bch / A.h;
  const int c = bc % A.nc, b = bc / A.nc;
  const int q = threadIdx.x, t = c * Q + q;
  float direct = 0.0f, rdt = 0.0f, dtq = 0.0f;
  if (q < Q) {
    float rows = 0.0f;
    for (int kt = 0; kt <= q / RB; ++kt)
      rows += A.rowp[((static_cast<long long>(bc) * QT + kt) * A.h + h) * Q + q];
    const long long o = seg_row(bch, Q) + q;
    const float cols = A.col[o];
    const float r = A.rho[o];
    dtq = dt_at(A.dt, A.dtsb, A.dtst, b, t, h, A.s);
    direct = cols + A.cold[o] + r;
    rdt = dtq * r;
    dseg[q] = rows + A.qside[o] - dtq * (cols + r);
  }
  const float srdt = block_total<Sh::FT>(rdt);
  if (threadIdx.x == 0) {
    float run = srdt + A.dtotp[bch];
    for (int j = Q - 1; j >= 0; --j) {
      run += dseg[j];
      dseg[j] = run;
    }
  }
  __syncthreads();
  float dap = 0.0f;
  if (q < Q) {
    const float ddta = dseg[q];
    if (t < A.s)
      A.ddt[(static_cast<long long>(b) * A.s + t) * A.h + h] =
          direct + A.a[h] * ddta;
    dap = dtq * ddta;
  }
  dap = block_total<Sh::FT>(dap);
  if (threadIdx.x == 0) A.dap[bch] = dap;
}

// da and dD, one head a block: the chunks' partials in a fixed order.
template <class Sh>
__global__ void __launch_bounds__(256) head_sums_kernel(Args<typename Sh::T> A) {
  const int h = blockIdx.x;
  const int nbc = A.bsz * A.nc;
  float sa = 0.0f, sd = 0.0f;
  for (int i = threadIdx.x; i < nbc; i += 256) {
    const long long o = static_cast<long long>(i) * A.h + h;
    sa += A.dap[o];
    for (int r = 0; r < Sh::QT; ++r) sd += A.ddp[o * Sh::QT + r];
  }
  sa = block_total<256>(sa);
  sd = block_total<256>(sd);
  if (threadIdx.x == 0) {
    A.da[h] = sa;
    A.ddskip[h] = sd;
  }
}

// ---------------------------------------------------------------------------
// Launch

template <class Sh>
cudaError_t forward(const Args<typename Sh::T>& A, cudaStream_t st) {
  using TC = Tile<Sh::RB, Sh::RB>;
  const unsigned bch = static_cast<unsigned>(A.bsz * A.nc * A.h);
  const unsigned bc = static_cast<unsigned>(A.bsz * A.nc);
  seg_kernel<Sh><<<(bch + 255) / 256, 256, 0, st>>>(A);
  cb_kernel<Sh><<<dim3(bc, Sh::PAIRS), TC::NT, 0, st>>>(A);
  states_kernel<Sh, false><<<bch, Tile<Sh::N, Sh::P>::NT, 0, st>>>(A);
  pass_kernel<Sh><<<A.bsz * A.h, kPassThreads, 0, st>>>(A);
  out_kernel<Sh, false><<<dim3(bch, Sh::QT), Tile<Sh::RB, Sh::P>::NT, 0, st>>>(A);
  return cudaGetLastError();
}

template <class Sh>
cudaError_t backward(const Args<typename Sh::T>& A, cudaStream_t st) {
  using TC = Tile<Sh::RB, Sh::RB>;
  using TB = Tile<Sh::RB, Sh::N>;
  const unsigned bch = static_cast<unsigned>(A.bsz * A.nc * A.h);
  const unsigned bc = static_cast<unsigned>(A.bsz * A.nc);
  states_kernel<Sh, true><<<bch, Tile<Sh::N, Sh::P>::NT, 0, st>>>(A);
  pass_bwd_kernel<Sh><<<A.bsz * A.h, kPassThreads, 0, st>>>(A);
  dcb_kernel<Sh><<<dim3(bc, Sh::PAIRS), TC::NT, 0, st>>>(A);
  dbc_kernel<Sh, false><<<dim3(bc, Sh::QT), TB::NT, 0, st>>>(A);
  dbc_kernel<Sh, true><<<dim3(bc, Sh::QT), TB::NT, 0, st>>>(A);
  out_kernel<Sh, true><<<dim3(bch, Sh::QT), Tile<Sh::RB, Sh::P>::NT, 0, st>>>(A);
  finish_kernel<Sh><<<bch, Sh::FT, 0, st>>>(A);
  head_sums_kernel<Sh><<<A.h, 256, 0, st>>>(A);
  return cudaGetLastError();
}

// The instantiation for (q, n, p) and the element type, or an error.
template <typename T, bool BWD>
cudaError_t dispatch(const Args<T>& A, int q, int n, int p, cudaStream_t st) {
#define REPRO_SSD_SHAPE(Q_, N_, P_)                                   \
  if (q == Q_ && n == N_ && p == P_)                                  \
    return BWD ? backward<Shape<T, Q_, N_, P_>>(A, st)                \
               : forward<Shape<T, Q_, N_, P_>>(A, st);
  REPRO_SSD_SHAPE(256, 128, 64)
  REPRO_SSD_SHAPE(256, 16, 64)
  REPRO_SSD_SHAPE(8, 16, 16)
#undef REPRO_SSD_SHAPE
  return cudaErrorInvalidValue;
}

template <typename T>
Args<T> inputs(const void* x, long long xsb, long long xst, const void* dt,
               long long dtsb, long long dtst, const void* a, const void* bm,
               long long bsb, long long bst, const void* cm, long long csb,
               long long cst, const void* dskip, int bsz, int s, int h, int q) {
  Args<T> A = {};
  A.x = static_cast<const T*>(x);
  A.xsb = xsb;
  A.xst = xst;
  A.dt = static_cast<const float*>(dt);
  A.dtsb = dtsb;
  A.dtst = dtst;
  A.a = static_cast<const float*>(a);
  A.bm = static_cast<const T*>(bm);
  A.bsb = bsb;
  A.bst = bst;
  A.cm = static_cast<const T*>(cm);
  A.csb = csb;
  A.cst = cst;
  A.dskip = static_cast<const float*>(dskip);
  A.bsz = bsz;
  A.s = s;
  A.h = h;
  A.nc = (s + q - 1) / q;
  return A;
}

template <typename T>
cudaError_t run_forward(const void* x, long long xsb, long long xst,
                        const void* dt, long long dtsb, long long dtst,
                        const void* a, const void* bm, long long bsb,
                        long long bst, const void* cm, long long csb,
                        long long cst, const void* dskip, void* y,
                        void* final_state, void* seg, void* cb, void* states,
                        int bsz, int s, int h, int q, int n, int p,
                        cudaStream_t st) {
  Args<T> A = inputs<T>(x, xsb, xst, dt, dtsb, dtst, a, bm, bsb, bst, cm, csb,
                        cst, dskip, bsz, s, h, q);
  A.y = static_cast<T*>(y);
  A.final_state = static_cast<float*>(final_state);
  A.seg = static_cast<float*>(seg);
  A.cb = static_cast<float*>(cb);
  A.states = static_cast<float*>(states);
  return dispatch<T, false>(A, q, n, p, st);
}

// The backward's f32 workspace, its parts in order: the state gradients,
// d(C·Bᵀ), the row partials, the column sums off and on the diagonal,
// qside, rho, and the partials of d(seg_{Q-1}), dD and da.  Writes each
// part's offset into at; returns the floats of the whole.
constexpr int kWorkspaceParts = 10;

inline long long workspace(int bsz, int s, int h, int q, int n, int p,
                           long long at[kWorkspaceParts]) {
  const long long bc = static_cast<long long>(bsz) * ((s + q - 1) / q);
  const long long qt = q / cmin(q, kRowTile);
  const long long size[kWorkspaceParts] = {
      bc * h * n * p, bc * q * q, bc * qt * q * h, bc * q * h, bc * q * h,
      bc * q * h,     bc * q * h, bc * h,          bc * h * qt, bc * h};
  long long total = 0;
  for (int i = 0; i < kWorkspaceParts; ++i) {
    at[i] = total;
    total += size[i];
  }
  return total;
}

template <typename T>
cudaError_t run_backward(const void* x, long long xsb, long long xst,
                         const void* dt, long long dtsb, long long dtst,
                         const void* a, const void* bm, long long bsb,
                         long long bst, const void* cm, long long csb,
                         long long cst, const void* dskip, const void* dy,
                         long long dysb, long long dyst, const void* dfinal,
                         const void* seg, const void* cb, const void* states,
                         void* dx, void* ddt, void* da, void* dbm, void* dcm,
                         void* ddskip, void* ws, int bsz, int s, int h, int q,
                         int n, int p, cudaStream_t st) {
  Args<T> A = inputs<T>(x, xsb, xst, dt, dtsb, dtst, a, bm, bsb, bst, cm, csb,
                        cst, dskip, bsz, s, h, q);
  A.dy = static_cast<const T*>(dy);
  A.dysb = dysb;
  A.dyst = dyst;
  A.dfinal = static_cast<const float*>(dfinal);
  // read-only here; Args holds the forward's pointers as writable
  A.seg = const_cast<float*>(static_cast<const float*>(seg));
  A.cb = const_cast<float*>(static_cast<const float*>(cb));
  A.states = const_cast<float*>(static_cast<const float*>(states));
  A.dx = static_cast<T*>(dx);
  A.ddt = static_cast<float*>(ddt);
  A.da = static_cast<float*>(da);
  A.dbm = static_cast<T*>(dbm);
  A.dcm = static_cast<T*>(dcm);
  A.ddskip = static_cast<float*>(ddskip);
  long long at[kWorkspaceParts];
  workspace(bsz, s, h, q, n, p, at);
  float* w = static_cast<float*>(ws);
  A.ds = w + at[0];
  A.dcb = w + at[1];
  A.rowp = w + at[2];
  A.col = w + at[3];
  A.cold = w + at[4];
  A.qside = w + at[5];
  A.rho = w + at[6];
  A.dtotp = w + at[7];
  A.ddp = w + at[8];
  A.dap = w + at[9];
  return dispatch<T, true>(A, q, n, p, st);
}

}  // namespace ssd
}  // namespace repro

extern "C" {

// x: (bsz, s, h, p) and bm, cm: (bsz, s, n), f32 or bf16 (x_is_bf16 for all
// three), rows (b, t) at b·*sb + t·*st elements, each row contiguous; dt:
// (bsz, s, h) f32 the same way; a, dskip: (h,) f32.  Writes y (bsz, s, h, p)
// contiguous in x's type, final_state (bsz, h, n, p) f32, and the saved seg
// (bsz, nc, h, q), cb (bsz, nc, q, q) and states (bsz, nc, h, n, p), f32,
// nc = ceil(s / q).
int repro_ssd_forward(const void* x, long long xsb, long long xst,
                      const void* dt, long long dtsb, long long dtst,
                      const void* a, const void* bm, long long bsb,
                      long long bst, const void* cm, long long csb,
                      long long cst, const void* dskip, void* y,
                      void* final_state, void* seg, void* cb, void* states,
                      int bsz, int s, int h, int q, int n, int p,
                      int x_is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_is_bf16
          ? repro::ssd::run_forward<__nv_bfloat16>(
                x, xsb, xst, dt, dtsb, dtst, a, bm, bsb, bst, cm, csb, cst,
                dskip, y, final_state, seg, cb, states, bsz, s, h, q, n, p, st)
          : repro::ssd::run_forward<float>(
                x, xsb, xst, dt, dtsb, dtst, a, bm, bsb, bst, cm, csb, cst,
                dskip, y, final_state, seg, cb, states, bsz, s, h, q, n, p,
                st));
}

// The forward's inputs and saved tensors, dy laid out as x (dfinal
// (bsz, h, n, p) f32 or null); writes dx, dbm, dcm (contiguous, x's type),
// ddt (bsz, s, h), da, ddskip (h,), f32; ws: the f32 workspace of
// repro_ssd_workspace_floats.
int repro_ssd_backward(const void* x, long long xsb, long long xst,
                       const void* dt, long long dtsb, long long dtst,
                       const void* a, const void* bm, long long bsb,
                       long long bst, const void* cm, long long csb,
                       long long cst, const void* dskip, const void* dy,
                       long long dysb, long long dyst, const void* dfinal,
                       const void* seg, const void* cb, const void* states,
                       void* dx, void* ddt, void* da, void* dbm, void* dcm,
                       void* ddskip, void* ws, int bsz, int s, int h, int q,
                       int n, int p, int x_is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_is_bf16
          ? repro::ssd::run_backward<__nv_bfloat16>(
                x, xsb, xst, dt, dtsb, dtst, a, bm, bsb, bst, cm, csb, cst,
                dskip, dy, dysb, dyst, dfinal, seg, cb, states, dx, ddt, da,
                dbm, dcm, ddskip, ws, bsz, s, h, q, n, p, st)
          : repro::ssd::run_backward<float>(
                x, xsb, xst, dt, dtsb, dtst, a, bm, bsb, bst, cm, csb, cst,
                dskip, dy, dysb, dyst, dfinal, seg, cb, states, dx, ddt, da,
                dbm, dcm, ddskip, ws, bsz, s, h, q, n, p, st));
}

// The f32 values repro_ssd_backward's workspace takes at these sizes, into
// *floats.
int repro_ssd_workspace_floats(int bsz, int s, int h, int q, int n, int p,
                               long long* floats) {
  long long at[repro::ssd::kWorkspaceParts];
  *floats = repro::ssd::workspace(bsz, s, h, q, n, p, at);
  return 0;
}

}  // extern "C"
