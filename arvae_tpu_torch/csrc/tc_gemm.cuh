// The backward's products on the tensor cores, for Hopper (sm_90a): one
// 3xTF32 GEMM engine (mma.sync m16n8k8) with two loader / epilogue forms,
// which both recurrence backwards (gru_chain.cu and hier_tick_chain.cu)
// launch:
//   (a) A^T X over the (t, b) terms: the weight gradients dW = sum h^T dg
//       and db = sum dg (gru_chain's dW_hh / db_hh at every layout, the
//       tick loop's 2L + 2 weight and embedding gradients);
//   (b) A W or A W^T over many rows, with a caller's epilogue: the tick
//       loop's row products (the recomputed input-side gates, dlog out_w^T,
//       the input gradients dgi w_ih^T).
//
// Replaces, in the port of the Pallas TPU kernels' backwards, the products
// those kernels compute in their own bodies: arvae_tpu/ops/gru_pallas.py
// :198-203 (dw_scr += h_prev^T dgh, db_scr += sum dgh) and
// arvae_tpu/ops/hier_decoder_pallas.py :385-410 (_matT_a_b, :167, for
// every weight gradient; _a_bT for the transposed products).
//
// What bounds it: operations. The 512-wide music step's weight gradients
// are about 72 GFLOP (an (H x 3H) output over T B = 6,144 terms, 9.66
// GFLOP, nine times a step) and its row products about 20 GFLOP: 1.07 ms
// and 0.31 ms at the card's fp32 rate, 0.43 ms and 0.12 ms at its TF32
// rate in 3xTF32 (three TF32 products an fp32 one). Each operand is read
// from device memory a few times at most (the tiles re-read it from L2).
//
// The design: a CTA of 8 warps owns a BM x BN output tile and walks the
// depth in K tiles of 32 terms, fed by a ring of kTcStages shared-memory
// stages with cp.async (two tiles in flight while one is multiplied); two
// CTAs an SM (128 registers a thread, 104-111 KB of shared memory each).
// Each warp owns a (16 MT) x (8 NT) piece of the tile as MT x NT m16n8
// tiles of tensor-core products; each fp32 operand is split into a TF32
// part and the TF32 rest of its remainder, and a b is summed as a_rest
// b_big + a_big b_rest + a_big b_big into one fp32 accumulator (the
// dropped a_rest b_rest is 2^-22 of the product): about fp32's accuracy
// at a third of the TF32 rate. Tiles per shape (the plan, mirrored by
// ops/gru_kernel.py::atb_tile): 128 x 128 (warps 2 x 4 of 64 x 32), and for
// the tiny shapes 16 x 128 (an output of at most 16 rows: dW_ih0e at E = 10)
// and 128 x 16 (at most 16 columns: the embedding's gradient, dpe); a row
// product of fewer 128 x 128 tiles than SMs (at H = 128) takes 64 x 64. A
// thread loads one term (one row) of each K tile and steps its (t, b) from
// the last tile's (TermRow).
//
// Layout. In A^T X both tiles are term-major (the output's rows and
// columns are the contiguous axes): a tile is held [k][c] with a leading
// dimension of c + 8, 8 or 24 mod 32, so that a warp's fragment loads
// (lane (g, t) at row t, column g) hit 32 distinct banks. In the row
// products A is row-major ([m][k], leading dimension 36, 4 mod 32: lane
// (g, t) at row g, term t) and W is [k][n] (A W) or [n][k] (A W^T).
// TF32 wgmma reads its operands from shared memory only K-major, so the
// term-major tiles would need a transpose in shared memory first; mma.sync
// takes the fragments as they lie.
//
// The bias of a weight gradient is not a row of ones appended to A (which
// at M = 512 takes a fifth 128-row tile): the CTAs of m-tile 0 sum the X
// tiles already in shared memory by column, in term order, in fp32.
//
// Order: each output sums its terms in the same order at every call (the
// K tiles in order, the products of a K tile in the mma's fixed order); a
// GEMM whose terms are split over CTAs writes each split's partial sums,
// and gemm_finish adds them in split order. No float atomics, so repeats
// are bitwise equal.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "gru_common.cuh"

namespace arvae {

// ---------------------------------------------------------------------------
// 3xTF32 products
// ---------------------------------------------------------------------------

// x as a TF32 part and the rest of its remainder (whose bits below TF32's
// the tensor cores drop). The part is x rounded to TF32's 10 mantissa bits,
// to nearest with ties away from zero, as cvt.rna.tf32.f32 rounds it (bit
// for bit for finite x), in two integer operations: half a TF32 ulp added
// to the bits, the 13 low bits cleared (cvt.rna.tf32.f32 takes more issue
// slots, and the engine's products are bound by issue).
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& rest) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  rest = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][n] += a_m b_n in 3xTF32 for a warp's MT x NT tiles: the two
// small terms first, then big times big, each product over every tile in
// turn, so that no mma waits for the one before it on its accumulator
// (the asm is volatile: issued in this order).
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32(float (*acc)[NT][4], uint32_t (*ab)[4],
                                           uint32_t (*ar)[4], uint32_t (*bb)[2],
                                           uint32_t (*br)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int m = 0; m < MT; ++m) mma_tf32(acc[m][n], ar[m], bb[n]);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int m = 0; m < MT; ++m) mma_tf32(acc[m][n], ab[m], br[n]);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int m = 0; m < MT; ++m) mma_tf32(acc[m][n], ab[m], bb[n]);
}

// ---------------------------------------------------------------------------
// The engine
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kTcDepth = 32;     // terms a K tile
constexpr int kTcStages = 3;     // K tiles in shared memory: two loads in flight
constexpr int kTcLdRow = kTcDepth + 4;  // a [c][k] tile's leading dimension (4 mod 32)

// A CTA's tile: WM x WN warps, each MT x NT m16n8 tiles.
template <int WM, int WN, int MT, int NT>
struct TcShape {
  static_assert(WM * WN * 32 == kTcThreads, "a CTA is 8 warps");
  static constexpr int kWM = WM, kWN = WN, kMT = MT, kNT = NT;
  static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
};
using TcBig = TcShape<2, 4, 4, 4>;      // 128 x 128
using TcNarrowM = TcShape<1, 8, 1, 2>;  // 16 x 128
using TcNarrowN = TcShape<8, 1, 1, 2>;  // 128 x 16
using TcMid = TcShape<2, 4, 2, 2>;      // 64 x 64

enum TcTile { kTcBig = 0, kTcNarrowM = 1, kTcNarrowN = 2, kTcMid = 3 };

// SMs of an H100 SXM: a row product with fewer 128 x 128 tiles takes 64 x
// 64 ones.
constexpr int kTcSms = 132;

// The tile of an M x N weight gradient (ops/gru_kernel.py::atb_tile
// mirrors it).
__host__ __device__ inline int tc_tile(int M, int N) {
  return N <= 16 ? kTcNarrowN : M <= 16 ? kTcNarrowM : kTcBig;
}

// The tile of an M-row, N-column row product (ops/gru_kernel.py::row_tile).
__host__ __device__ inline int tc_row_tile(int M, int N) {
  if (N <= 16) return kTcNarrowN;
  return ((M + 127) / 128) * ((N + 127) / 128) < kTcSms ? kTcMid : kTcBig;
}

// Floats of a [k][c] (kKMajor) or [c][k] tile of c = `width` columns.
__host__ __device__ constexpr int tc_tile_ld(bool kKMajor, int width) {
  return kKMajor ? width + 8 : kTcLdRow;
}
__host__ __device__ constexpr int tc_tile_floats(bool kKMajor, int width) {
  return kKMajor ? kTcDepth * (width + 8) : width * kTcLdRow;
}

// Dynamic shared memory of the engine's CTA: kTcStages stages of an A tile
// (BM columns) and a B tile (BN columns).
template <class S, bool kAK, bool kBK>
__host__ __device__ constexpr int tc_smem_bytes() {
  return 4 * kTcStages * (tc_tile_floats(kAK, S::BM) + tc_tile_floats(kBK, S::BN));
}

// The m16 x k8 A fragment at rows m, terms k of a stage's A tile ([k][m] or
// [m][k]), split into its TF32 parts.
template <bool kAK, int LD>
__device__ __forceinline__ void tc_frag_a(const float* as, int m, int k, int g, int t,
                                          uint32_t* big, uint32_t* rest) {
  float v[4];
  if (kAK) {
    const float* p = as + (k + t) * LD + m + g;
    v[0] = p[0], v[1] = p[8], v[2] = p[4 * LD], v[3] = p[4 * LD + 8];
  } else {
    const float* p = as + (m + g) * LD + k + t;
    v[0] = p[0], v[1] = p[8 * LD], v[2] = p[4], v[3] = p[8 * LD + 4];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(v[i], big[i], rest[i]);
}

// The k8 x n8 B fragment at terms k, columns n of a stage's B tile ([k][n]
// or [n][k]), split likewise.
template <bool kBK, int LD>
__device__ __forceinline__ void tc_frag_b(const float* bs, int n, int k, int g, int t,
                                          uint32_t* big, uint32_t* rest) {
  float v[2];
  if (kBK) {
    const float* p = bs + (k + t) * LD + n + g;
    v[0] = p[0], v[1] = p[4 * LD];
  } else {
    const float* p = bs + (n + g) * LD + k + t;
    v[0] = p[0], v[1] = p[4];
  }
  tf32_split(v[0], big[0], rest[0]);
  tf32_split(v[1], big[1], rest[1]);
}

// acc (the warp's MT x NT m16n8 tiles) = the CTA tile's products over
// `tiles` K tiles: load(as, bs, i) fills a stage with K tile i (cp.async,
// or plain stores; the engine commits), each_tile(bs, i) runs on every
// thread once K tile i has landed (before its products). Every thread of
// the CTA calls it; one __syncthreads a K tile. Lane (g, t) of warp w
// holds the outputs at rows mw + 16 i + g (+ 8) and columns nw + 8 n + 2 t
// (+ 1), mw and nw from tc_warp_origin.
template <class S, bool kAK, bool kBK, class Load, class EachTile>
__device__ __forceinline__ void tc_mainloop(float (*acc)[S::kNT][4], float* smem, int tiles,
                                            Load load, EachTile each_tile) {
  constexpr int LDA = tc_tile_ld(kAK, S::BM), LDB = tc_tile_ld(kBK, S::BN);
  constexpr int AF = tc_tile_floats(kAK, S::BM);
  constexpr int STAGE = AF + tc_tile_floats(kBK, S::BN);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mw = (warp / S::kWN) * 16 * S::kMT, nw = (warp % S::kWN) * 8 * S::kNT;
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int n = 0; n < S::kNT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < tiles) load(smem + s * STAGE, smem + s * STAGE + AF, s);
    cp_async_commit();  // a group a K tile, empty past the last
  }
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kTcStages - 2>();  // K tile i has landed, for this thread
    __syncthreads();  // for every thread; and K tile i - 1's stage is free
    const int next = i + kTcStages - 1;
    if (next < tiles) {
      float* st = smem + (next % kTcStages) * STAGE;
      load(st, st + AF, next);
    }
    cp_async_commit();
    const float* as = smem + (i % kTcStages) * STAGE;
    const float* bs = as + AF;
    each_tile(bs, i);
#pragma unroll
    for (int k = 0; k < kTcDepth; k += 8) {
      uint32_t ab[S::kMT][4], ar[S::kMT][4], bb[S::kNT][2], br[S::kNT][2];
#pragma unroll
      for (int m = 0; m < S::kMT; ++m) tc_frag_a<kAK, LDA>(as, mw + 16 * m, k, g, t, ab[m], ar[m]);
#pragma unroll
      for (int n = 0; n < S::kNT; ++n) tc_frag_b<kBK, LDB>(bs, nw + 8 * n, k, g, t, bb[n], br[n]);
      mma_3xtf32<S::kMT, S::kNT>(acc, ab, ar, bb, br);
    }
  }
  cp_async_wait<0>();
}

// Row and column of output element c of m16n8 tile (i, n) of this lane.
template <class S>
__device__ __forceinline__ void tc_element(int i, int n, int c, int& r, int& col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  r = (warp / S::kWN) * 16 * S::kMT + 16 * i + (lane >> 2) + 8 * (c >> 1);
  col = (warp % S::kWN) * 8 * S::kNT + 8 * n + 2 * (lane & 3) + (c & 1);
}

// ---------------------------------------------------------------------------
// Form (a): weight gradients, A^T X over (t, b), fixed order
// ---------------------------------------------------------------------------

// An operand of the GEMM, element (d, t, b, c) at
//   base[d * ds + t * ts + b * rs + c]
// or, when base0 is set (a hidden state one step back, h_{t-1}), at
//   base0[d * ds + (t / period) * ps + b * rs + c]  where t % period == 0
//                                                   (the state resets),
//   base[d * ds + (t - 1) * ts + b * rs + c]         elsewhere:
// gru_chain's h_{t-1} (h0 at t = 0, period T) and the tick loop's
// hiddens (tick_h0[beat] at the start of each beat) are read in place.
struct Operand {
  const float* base;
  const float* base0;
  long long ds, ts, rs;
  int period;
  long long ps;
};

__device__ __forceinline__ const float* op_addr(const Operand& o, int d, int t, int b, int c) {
  if (o.base0 != nullptr) {
    if (t % o.period == 0) return o.base0 + d * o.ds + (t / o.period) * o.ps + b * o.rs + c;
    return o.base + d * o.ds + (t - 1) * o.ts + b * o.rs + c;
  }
  return o.base + d * o.ds + t * o.ts + b * o.rs + c;
}

// Whether every row of the operand starts on a 16-byte boundary.
__device__ __forceinline__ bool rows_aligned(const Operand& o) {
  const size_t bases = reinterpret_cast<size_t>(o.base) | reinterpret_cast<size_t>(o.base0);
  return (bases & 15) == 0 && ((o.ds | o.ts | o.rs | o.ps) & 3) == 0;
}

// Terms (t, b) each split sums: whole K tiles.
__host__ __device__ inline int gemm_chunk(int K, int splits) {
  const int per = (K + splits - 1) / splits;
  return (per + kTcDepth - 1) / kTcDepth * kTcDepth;
}

//   out[d][j][k] = sum_{t < T, b < B} A(d, t, b, j) X(d, t, b, k)   (j < M)
//   bias[d][k]   = sum_{t, b} X(d, t, b, k)                        (if set)
// A(d, t, b, j) is the one-hot (tok == j) when tokens is set, tok = -1 for
// the first tok_shift terms and tokens[s - tok_shift] after (the tick
// loop's fed tokens, one step back).
struct AtbArgs {
  Operand A;
  const int* tokens;
  int tok_shift, M;
  Operand X;
  int N, T, B, splits;
  float* out;
  float* bias;
  float* partial;  // [d][split][M + 1 (bias)][N] with more than one split
};

// The loads of a K tile: thread (r, q) = (threadIdx.x / 8, threadIdx.x %
// 8) copies term s0 + r of it, columns 4 q, 4 q + 32, ... of the tile, so
// that each thread works out one term's (t, b) and row addresses a K tile,
// stepping them from the last tile's: the loads' cost is their address
// arithmetic, which takes issue slots from the products.
struct TermRow {
  int s, t, b;  // s = t B + b

  __device__ void start(int s0, int B) {
    s = s0 + (threadIdx.x >> 3);
    t = s / B;
    b = s - t * B;
  }
  __device__ void step(int B) {
    s += kTcDepth;
    b += kTcDepth;
    while (b >= B) b -= B, ++t;
  }
};

// `cols` columns from c0 of the thread's term (row r of a [k][c] tile of
// leading dimension ld) from its row `row` of the operand (null past K1):
// 16-byte copies where the row is aligned and the four columns lie inside
// it, else one float at a time; zeros past the term range and `width`.
template <int COLS>
__device__ __forceinline__ void atb_load_row(float* dst, int ld, const float* row, bool wide,
                                             int width, int c0, const float* any) {
  const int r = threadIdx.x >> 3;
#pragma unroll
  for (int c = 4 * (threadIdx.x & 7); c < COLS; c += 32) {
    const int j = c0 + c;
    float* to = dst + r * ld + c;
    if (wide && j + 3 < width) {
      cp_async16(to, row != nullptr ? row + j : any, row != nullptr);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool v = row != nullptr && j + q < width;
        cp_async4(to + q, v ? row + j + q : any, v);
      }
    }
  }
}

// One tile of the GEMM over split s = blockIdx.z % splits of the terms:
// the BM x BN output tile at (blockIdx.y, blockIdx.x) of slice d. With one
// split the tile is written to out (and bias), with more to partial.
template <class S>
__global__ void __launch_bounds__(kTcThreads, 2) atb_tc(AtbArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDA = S::BM + 8, LDX = S::BN + 8;
  const int d = blockIdx.z / p.splits;
  const int split = blockIdx.z - d * p.splits;
  const int j0 = blockIdx.y * S::BM;
  const int k0 = blockIdx.x * S::BN;
  const int K = p.T * p.B;
  const int chunk = gemm_chunk(K, p.splits);
  const int K0 = min(split * chunk, K);
  const int K1 = min(K0 + chunk, K);
  const int tiles = (K1 - K0 + kTcDepth - 1) / kTcDepth;
  const bool wide_a = p.tokens == nullptr && rows_aligned(p.A);
  const bool wide_x = rows_aligned(p.X);
  // the bias: the CTAs of m-tile 0 sum their X tiles by column, in term order
  const bool sums = p.bias != nullptr && blockIdx.y == 0 && threadIdx.x < S::BN;
  float colsum = 0.f;
  float acc[S::kMT][S::kNT][4];
  TermRow w;  // the thread's term of each K tile, in order
  w.start(K0, p.B);
  tc_mainloop<S, true, true>(
      acc, smem, tiles,
      [&](float* as, float* xs, int) {
        const bool in = w.s < K1;
        if (p.tokens != nullptr) {
          const int tok = !in || w.s < p.tok_shift ? -1 : p.tokens[w.s - p.tok_shift];
          const int r = threadIdx.x >> 3;
#pragma unroll
          for (int c = 4 * (threadIdx.x & 7); c < S::BM; c += 32) {
#pragma unroll
            for (int q = 0; q < 4; ++q) as[r * LDA + c + q] = tok == j0 + c + q ? 1.f : 0.f;
          }
        } else {
          atb_load_row<S::BM>(as, LDA, in ? op_addr(p.A, d, w.t, w.b, 0) : nullptr, wide_a, p.M,
                              j0, p.X.base);
        }
        atb_load_row<S::BN>(xs, LDX, in ? op_addr(p.X, d, w.t, w.b, 0) : nullptr, wide_x, p.N,
                            k0, p.X.base);
        w.step(p.B);
      },
      [&](const float* xs, int) {
        if (sums) {
#pragma unroll 8
          for (int s = 0; s < kTcDepth; ++s) colsum += xs[s * LDX + threadIdx.x];
        }
      });

  // each lane's two neighbouring columns at once where they lie inside N
  const int rows = p.M + (p.bias != nullptr ? 1 : 0);
  const bool pairs = (p.N & 1) == 0;
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int n = 0; n < S::kNT; ++n)
#pragma unroll
      for (int c = 0; c < 4; c += 2) {
        int r, col;
        tc_element<S>(i, n, c, r, col);
        const int j = j0 + r, k = k0 + col;
        if (j >= p.M || k >= p.N) continue;
        float* to = p.splits > 1
                        ? p.partial + (static_cast<size_t>(blockIdx.z) * rows + j) * p.N + k
                        : p.out + (static_cast<size_t>(d) * p.M + j) * p.N + k;
        if (pairs) {
          *reinterpret_cast<float2*>(to) = make_float2(acc[i][n][c], acc[i][n][c + 1]);
        } else {
          to[0] = acc[i][n][c];
          if (k + 1 < p.N) to[1] = acc[i][n][c + 1];
        }
      }
  const int k = k0 + threadIdx.x;
  if (sums && k < p.N) {
    if (p.splits > 1) {
      p.partial[(static_cast<size_t>(blockIdx.z) * rows + p.M) * p.N + k] = colsum;
    } else {
      p.bias[static_cast<size_t>(d) * p.N + k] = colsum;
    }
  }
}

// Adds the splits' partials of each output in order of s.
__global__ void gemm_finish(const float* __restrict__ partial, int splits, int rows, int M,
                            int N, float* __restrict__ out, float* __restrict__ bias) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = blockIdx.y;
  if (i >= rows * N) return;
  const float* p = partial + static_cast<size_t>(d) * splits * rows * N + i;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += p[static_cast<size_t>(s) * rows * N];
  const int j = i / N;
  if (j < M) {
    out[static_cast<size_t>(d) * M * N + i] = acc;
  } else {
    bias[static_cast<size_t>(d) * N + (i - M * N)] = acc;
  }
}

// Floats of partial sums launch_atb needs (0 for one split).
inline long long atb_scratch_floats(int M, bool bias, int N, int D, int splits) {
  return splits > 1 ? static_cast<long long>(D) * splits * (M + (bias ? 1 : 0)) * N : 0;
}

// The engine's kernel with its shared memory raised to what it needs.
template <class... Params, class... Args>
cudaError_t launch_tc(void (*kernel)(Params...), int smem, dim3 grid, cudaStream_t st,
                      Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <class S>
cudaError_t launch_atb_tile(const AtbArgs& p, int D, cudaStream_t st) {
  const dim3 grid((p.N + S::BN - 1) / S::BN, (p.M + S::BM - 1) / S::BM, D * p.splits);
  return launch_tc(atb_tc<S>, tc_smem_bytes<S, true, true>(), grid, st, p);
}

// Launches the GEMM over D slices in `splits` splits of the terms (the
// caller's plan, ops/gru_kernel.py::atb_splits), then, with more than one
// split, the fixed-order sum; scratch holds atb_scratch_floats. Returns
// cudaGetLastError().
inline cudaError_t launch_atb(const Operand& A, const int* tokens, int tok_shift, int M,
                              const Operand& X, int N, int T, int B, int D, int splits,
                              float* out, float* bias, float* scratch, cudaStream_t st) {
  if (splits < 1 || M < 1 || N < 1 || T < 1 || B < 1 || D < 1) return cudaErrorInvalidValue;
  const AtbArgs p{A, tokens, tok_shift, M, X, N, T, B, splits, out, bias, scratch};
  const int tile = tc_tile(M, N);
  cudaError_t err = tile == kTcBig       ? launch_atb_tile<TcBig>(p, D, st)
                    : tile == kTcNarrowM ? launch_atb_tile<TcNarrowM>(p, D, st)
                                         : launch_atb_tile<TcNarrowN>(p, D, st);
  if (err != cudaSuccess || splits == 1) return err;
  const int rows = M + (bias != nullptr ? 1 : 0);
  const dim3 grid((rows * N + 255) / 256, D);
  gemm_finish<<<grid, 256, 0, st>>>(scratch, splits, rows, M, N, out, bias);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Form (b): row products, A W or A W^T over many rows
// ---------------------------------------------------------------------------

// The rows [r0, r0 + ROWS) of a row-major operand (row stride ld, `width`
// rows) as a [r][k] tile's loads: thread (r, q) copies terms 4 q .. 4 q + 3
// of the K tile of rows r, r + 32, ..., their addresses worked out once.
template <int ROWS>
struct RowTile {
  static constexpr int kRows = (ROWS + 31) / 32;
  const float* row[kRows];  // null past the operand's rows

  __device__ void init(const float* src, int ld, int r0, int width) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = (threadIdx.x >> 3) + 32 * i;
      row[i] = r < ROWS && r0 + r < width ? src + static_cast<size_t>(r0 + r) * ld : nullptr;
    }
  }
  // the K tile of terms [k0, k0 + kTcDepth) (of K) into dst ([r][k])
  __device__ void load(float* dst, const float* any, int k0, int K, bool wide) const {
    const int c = 4 * (threadIdx.x & 7), k = k0 + c;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = (threadIdx.x >> 3) + 32 * i;
      if (r >= ROWS) continue;
      float* to = dst + r * kTcLdRow + c;
      const float* p = row[i];
      if (wide && k + 3 < K) {
        cp_async16(to, p != nullptr ? p + k : any, p != nullptr);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool v = p != nullptr && k + q < K;
          cp_async4(to + q, v ? p + k + q : any, v);
        }
      }
    }
  }
};

// epi(m, n, v) for v = sum_k A[m * lda + k] W(k, n) over k < K, for m < M
// and n < N, where W(k, n) = W[k * ldw + n] (A W) or, with kTransW,
// W[n * ldw + k] (A W^T): the BM x BN output tile at (blockIdx.y,
// blockIdx.x), all K tiles in one CTA in order, so a repeat is bitwise
// equal.
template <class S, bool kTransW, class Epi>
__global__ void __launch_bounds__(kTcThreads, 2)
rows_tc(const float* __restrict__ A, int lda, const float* __restrict__ W, int ldw, int M,
        int K, int N, Epi epi) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kWK = !kTransW;  // W's tile [k][n] (A W), else [n][k]
  constexpr int LDW = tc_tile_ld(kWK, S::BN);
  const int m0 = blockIdx.y * S::BM;
  const int n0 = blockIdx.x * S::BN;
  const bool wide_a = (reinterpret_cast<size_t>(A) & 15) == 0 && lda % 4 == 0;
  const bool wide_w = (reinterpret_cast<size_t>(W) & 15) == 0 && ldw % 4 == 0;
  // the thread's rows of the A tile (and of W's, transposed), fixed for the call
  RowTile<S::BM> arows;
  arows.init(A, lda, m0, M);
  RowTile<kTransW ? S::BN : 1> wrows;
  if (kTransW) wrows.init(W, ldw, n0, N);
  float acc[S::kMT][S::kNT][4];
  tc_mainloop<S, false, kWK>(
      acc, smem, (K + kTcDepth - 1) / kTcDepth,
      [&](float* as, float* ws, int i) {
        const int k0 = i * kTcDepth;
        arows.load(as, A, k0, K, wide_a);
        if (kTransW) {
          wrows.load(ws, W, k0, K, wide_w);
        } else {
          constexpr int chunks = S::BN / 4;
          for (int idx = threadIdx.x; idx < kTcDepth * chunks; idx += kTcThreads) {
            const int kk = idx / chunks;
            const int c = (idx - kk * chunks) * 4;
            const int k = k0 + kk, n = n0 + c;
            float* to = ws + kk * LDW + c;
            const float* from = W + static_cast<size_t>(k) * ldw + n;
            if (wide_w && n + 3 < N) {
              cp_async16(to, k < K ? from : W, k < K);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const bool v = k < K && n + q < N;
                cp_async4(to + q, v ? from + q : W, v);
              }
            }
          }
        }
      },
      [](const float*, int) {});
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int n = 0; n < S::kNT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int r, col;
        tc_element<S>(i, n, c, r, col);
        if (m0 + r < M && n0 + col < N) epi(m0 + r, n0 + col, acc[i][n][c]);
      }
}

template <class S, bool kTransW, class Epi>
cudaError_t launch_rows_tile(const float* A, int lda, const float* W, int ldw, int M, int K,
                             int N, Epi epi, cudaStream_t st) {
  const dim3 grid((N + S::BN - 1) / S::BN, (M + S::BM - 1) / S::BM);
  return launch_tc(rows_tc<S, kTransW, Epi>, tc_smem_bytes<S, false, !kTransW>(), grid, st, A,
                   lda, W, ldw, M, K, N, epi);
}

// Launches the row product on the stream (its tile: tc_row_tile); returns
// cudaGetLastError().
template <bool kTransW, class Epi>
cudaError_t launch_row_gemm(const float* A, int lda, const float* W, int ldw, int M, int K,
                            int N, Epi epi, cudaStream_t st) {
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  const int tile = tc_row_tile(M, N);
  return tile == kTcNarrowN ? launch_rows_tile<TcNarrowN, kTransW>(A, lda, W, ldw, M, K, N, epi, st)
         : tile == kTcMid   ? launch_rows_tile<TcMid, kTransW>(A, lda, W, ldw, M, K, N, epi, st)
                            : launch_rows_tile<TcBig, kTransW>(A, lda, W, ldw, M, K, N, epi, st);
}

}  // namespace arvae
