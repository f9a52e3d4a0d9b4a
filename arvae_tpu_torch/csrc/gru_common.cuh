// Pieces shared by the two recurrence kernels (gru_chain.cu and
// hier_tick_chain.cu): torch-exact GRU gate math forward and backward;
// block-wide products of a tile of rows with a weight slice resident in
// shared memory (the cluster kernels); cp.async copies; the tiled
// fixed-order fp32 A^T X GEMM that sums weight gradients over (t, b) for
// both backwards; and a tiled fp32 row GEMM (A W or A W^T, one output
// element a thread-register, a caller's epilogue) for the tick loop's
// products over all of its rows at once.
//
// Gate math, as torch.nn.GRU and arvae_tpu/ops/gru_pallas.py::_gates:
//   r = sigmoid(i_r + h_r), z = sigmoid(i_z + h_z),
//   n = tanh(i_n + r * h_n)   (b_hn rides inside the reset gate),
//   h' = (1 - z) n + z h.
#pragma once

#include <cuda_runtime.h>

namespace arvae {

// The largest dynamic shared memory a block may use on Hopper.
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

struct Gates {
  float r, z, n, hn;  // hn = h W_hn + b_hn, kept for the backward
};

// The fused multiply-adds are written out, so that every kernel rounds
// the cell alike whatever the compiler would contract in its context.
__device__ __forceinline__ Gates gru_gates(float ir, float iz, float in, float hr,
                                           float hz, float hn) {
  Gates g;
  g.r = sigmoid_f(ir + hr);
  g.z = sigmoid_f(iz + hz);
  g.n = tanhf(__fmaf_rn(g.r, hn, in));
  g.hn = hn;
  return g;
}

__device__ __forceinline__ float gru_out(const Gates& g, float h) {
  return __fmaf_rn(1.f - g.z, g.n, __fmul_rn(g.z, h));
}

// Backward through one cell (arvae_tpu/ops/gru_pallas.py::_gru_bwd).
// dgi = (dr, dz, dn_pre), dgh = (dr, dz, dn_pre * r); dh_prev is
// dh_z + dgh @ w_hh^T, whose product the caller adds.
struct CellGrads {
  float dr, dz, dn, dgh_n, dh_z;
};

__device__ __forceinline__ CellGrads gru_cell_bwd(float dh, const Gates& g, float h_prev) {
  const float dn = dh * (1.f - g.z);
  const float dzz = dh * (h_prev - g.n);
  const float da_n = dn * (1.f - g.n * g.n);
  const float dr = da_n * g.hn;
  CellGrads o;
  o.dn = da_n;
  o.dgh_n = da_n * g.r;
  o.dz = dzz * g.z * (1.f - g.z);
  o.dr = dr * g.r * (1.f - g.r);
  o.dh_z = dh * g.z;
  return o;
}

// ---------------------------------------------------------------------------
// Products of a tile of rows in shared memory with a weight slice resident
// in shared memory (the cluster kernels of gru_chain.cu)
// ---------------------------------------------------------------------------

// Rows a thread owns in the products below; tiles hold a multiple of it.
constexpr int kRowsPerThread = 4;

// The threads that run one product: [first, first + count) of the block,
// whole warps, synchronised by named barrier `bar` (0: the whole block,
// __syncthreads). Two groups with their own barriers and scratch run two
// independent products at once.
struct ThreadGroup {
  int first, count, bar;

  __device__ int rank() const { return static_cast<int>(threadIdx.x) - first; }
  __device__ void sync() const {
    if (bar == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(count) : "memory");
    }
  }
};

__device__ __forceinline__ ThreadGroup whole_block() {
  return ThreadGroup{0, static_cast<int>(blockDim.x), 0};
}

// Leading dimension of an array of n-float rows in shared memory: a
// multiple of 4 (16-byte rows) that is 4 mod 8, so that eight threads
// reading float4s of eight neighbouring rows hit eight distinct bank
// groups.
__host__ __device__ inline int slice_ld(int n) {
  const int ld = (n + 3) & ~3;
  return (ld & 7) == 0 ? ld + 4 : ld;
}

// The products below give each thread kRowsPerThread rows and two
// columns (c, c + ceil(N / 2)) of the output: `items` such pieces. When
// the block has threads to spare, the depth K is cut into S slices
// (S a power of two up to 8, each slice whole float4 groups), thread
// s * items + it sums slice s of piece it, and slice 0 adds the others'
// partial sums in the order s = 1 .. S-1. So a repeat rounds alike.
__host__ __device__ inline int depth_splits(int items, int K, int threads) {
  int s = 1;
  while (s < 8 && items * 2 * s <= threads && K % (8 * s) == 0) s *= 2;
  return s;
}

// Floats of shared scratch the products need for the partial sums.
__host__ __device__ inline int product_scratch_floats(int threads) {
  return threads * 2 * kRowsPerThread;
}

// Floats of that scratch one product of `rows` rows over the depth K into
// N columns needs (vec: K a multiple of 4, as rows_times_w passes it).
__host__ __device__ inline int product_part_floats(int rows, int K, int N, int threads) {
  const int items = rows / kRowsPerThread * ((N + 1) / 2);
  const int S = K % 4 == 0 ? depth_splits(items, K, threads) : 1;
  return (S - 1) * items * 2 * kRowsPerThread;
}

// a0[r] += sum_j x[r * ldx + j] * w0[j * wj] and a1 likewise with w1,
// over j in [j0, j1), in order; (j1 - j0) % 4 == 0 where `vec` is set,
// and x 16-byte aligned there (and w0, w1 too when kContiguous: wj = 1).
template <bool kContiguous>
__device__ __forceinline__ void dot_rows(const float* x, int ldx, const float* w0,
                                         const float* w1, int wj, int j0, int j1, bool vec,
                                         float* a0, float* a1) {
  constexpr int RR = kRowsPerThread;
  if (vec) {
#pragma unroll 2
    for (int j = j0; j < j1; j += 4) {
      float u[4], v[4];
      if (kContiguous) {
        const float4 p = *reinterpret_cast<const float4*>(w0 + j);
        const float4 q = *reinterpret_cast<const float4*>(w1 + j);
        u[0] = p.x, u[1] = p.y, u[2] = p.z, u[3] = p.w;
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          u[q] = w0[(j + q) * wj];
          v[q] = w1[(j + q) * wj];
        }
      }
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const float4 e = *reinterpret_cast<const float4*>(x + r * ldx + j);
        a0[r] = fmaf(e.x, u[0], a0[r]);
        a0[r] = fmaf(e.y, u[1], a0[r]);
        a0[r] = fmaf(e.z, u[2], a0[r]);
        a0[r] = fmaf(e.w, u[3], a0[r]);
        a1[r] = fmaf(e.x, v[0], a1[r]);
        a1[r] = fmaf(e.y, v[1], a1[r]);
        a1[r] = fmaf(e.z, v[2], a1[r]);
        a1[r] = fmaf(e.w, v[3], a1[r]);
      }
    }
  } else {
    for (int j = j0; j < j1; ++j) {
      const float u = w0[j * wj];
      const float v = w1[j * wj];
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        a0[r] = fmaf(x[r * ldx + j], u, a0[r]);
        a1[r] = fmaf(x[r * ldx + j], v, a1[r]);
      }
    }
  }
}

// The two products below, in one: piece it covers rows (it / half) * RR
// and columns c0 = it % half, c1 = c0 + half; the weights of column c
// are w(c)[j * wj] over the depth K.
template <bool kContiguous, class WeightCol, class Store>
__device__ __forceinline__ void block_product(const float* x, int ldx, int rows, int K, int N,
                                              int wj, bool vec, float* part, WeightCol wcol,
                                              Store store, const ThreadGroup& grp) {
  constexpr int RR = kRowsPerThread;
  const int half = (N + 1) / 2;
  const int items = rows / RR * half;
  const int S = vec ? depth_splits(items, K, grp.count) : 1;
  const int span = K / S;
  const int me = grp.rank();
  // with S > 1 every piece is one thread's; with S = 1 threads loop
  for (int base = 0; base < items; base += S > 1 ? items : grp.count) {
    const int tid = base + me;
    const int it = S > 1 ? me % items : tid;
    const int s = S > 1 ? me / items : 0;
    const bool active = S > 1 ? s < S : tid < items;
    float a0[RR], a1[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) a0[r] = a1[r] = 0.f;
    const int c0 = it % half;
    const int c1 = c0 + half;
    const bool two = c1 < N;
    const int r0 = (it / half) * RR;
    if (active) {
      dot_rows<kContiguous>(x + r0 * ldx, ldx, wcol(c0), wcol(two ? c1 : c0), wj, s * span,
                            (s + 1) * span, vec, a0, a1);
    }
    if (S > 1) {
      if (active && s > 0) {
        float* p = part + ((s - 1) * items + it) * 2 * RR;
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          p[r] = a0[r];
          p[RR + r] = a1[r];
        }
      }
      grp.sync();
      if (!(active && s == 0)) continue;
      for (int k = 1; k < S; ++k) {
        const float* p = part + ((k - 1) * items + it) * 2 * RR;
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          a0[r] += p[r];
          a1[r] += p[RR + r];
        }
      }
    } else if (!active) {
      continue;
    }
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      store(r0 + r, c0, a0[r]);
      if (two) store(r0 + r, c1, a1[r]);
    }
  }
}

// store(r, n, v) for v = sum_j in[r * ldi + j] * W[j * ldw + n] over
// j < K, for r < rows and n < N; rows a multiple of kRowsPerThread, ldi a
// multiple of 4 and in 16-byte aligned. Every thread of the group (the
// block by default) must call it (it may synchronise the group); part
// holds product_part_floats(rows, K, N, group size) floats.
template <class Store>
__device__ __forceinline__ void rows_times_w(const float* in, int ldi, int rows, int K,
                                             const float* W, int ldw, int N, float* part,
                                             Store store, const ThreadGroup& grp = whole_block()) {
  block_product<false>(in, ldi, rows, K, N, ldw, K % 4 == 0, part,
                       [&](int c) { return W + c; }, store, grp);
}

// store(r, j, v) for v = sum_k g[r * ldg + k] * W[j * ldw + k] over k < N
// (g @ W^T), for r < rows and j < M: the transposed product, with the
// slice's rows contiguous in k. Same rules as rows_times_w.
template <class Store>
__device__ __forceinline__ void rows_times_wt(const float* g, int ldg, int rows, int N,
                                              const float* W, int ldw, int M, float* part,
                                              Store store) {
  block_product<true>(g, ldg, rows, N, M, 1, N % 4 == 0 && ldw % 4 == 0, part,
                      [&](int j) { return W + j * ldw; }, store, whole_block());
}

// ---------------------------------------------------------------------------
// Asynchronous copies (cp.async, 4 or 16 bytes, zero-filled when masked)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// src[r * sld + c] -> dst[r * dld + c] for r < rows, c < cols, zeros in
// rows >= valid_rows, spread over the block's threads: 16-byte copies
// when every row starts 16-byte aligned on both sides and cols is a
// multiple of 4, else 4-byte ones.
__device__ __forceinline__ void copy_tile(float* dst, int dld, const float* src, long long sld,
                                          int rows, int cols, int valid_rows) {
  const bool wide = ((reinterpret_cast<size_t>(src) | __cvta_generic_to_shared(dst)) & 15) == 0 &&
                    ((sld | dld | cols) & 3) == 0;
  const int v = wide ? 4 : 1;
  const int per_row = cols / v;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * v;
    const bool in = r < valid_rows;
    const float* from = in ? src + r * sld + c : src;
    if (wide) {
      cp_async16(dst + r * dld + c, from, in);
    } else {
      cp_async4(dst + r * dld + c, from, in);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Weight gradients: a tiled fp32 A^T X GEMM over (t, b), fixed order
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

constexpr int kGemmTile = 64;    // output tile, rows and columns
constexpr int kGemmDepth = 32;   // terms (t, b) per K tile
// Outputs a thread owns: kGemmRows rows by kGemmCols columns of the tile.
constexpr int kGemmRows = 8;
constexpr int kGemmCols = 4;
constexpr int kGemmThreads = (kGemmTile / kGemmRows) * (kGemmTile / kGemmCols);

// Terms (t, b) each split sums: a multiple of kGemmDepth.
__host__ __device__ inline int gemm_chunk(int K, int splits) {
  const int per = (K + splits - 1) / splits;
  return (per + kGemmDepth - 1) / kGemmDepth * kGemmDepth;
}

// Whether every row of the operand starts on a 16-byte boundary.
__device__ __forceinline__ bool rows_aligned(const Operand& o) {
  const size_t bases = reinterpret_cast<size_t>(o.base) | reinterpret_cast<size_t>(o.base0);
  return (bases & 15) == 0 && ((o.ds | o.ts | o.rs | o.ps) & 3) == 0;
}

// Loads K tile [s0, s0 + kGemmDepth) of the terms into as and xs, four
// columns at a time: 16-byte copies where a row is aligned and the four
// columns lie inside it, else one float at a time.
__device__ __forceinline__ void gemm_load(float (*as)[kGemmTile], float (*xs)[kGemmTile],
                                          const Operand& A, bool wide_a, const int* tokens,
                                          int tok_shift, int M, const Operand& X, bool wide_x,
                                          int N, int B, int rows, int d, int j0, int k0, int s0,
                                          int K1) {
  constexpr int kChunks = kGemmTile / 4;
#pragma unroll
  for (int i = 0; i < kGemmDepth * kChunks / kGemmThreads; ++i) {
    const int idx = threadIdx.x + i * kGemmThreads;
    const int sl = idx / kChunks;
    const int c = (idx - sl * kChunks) * 4;
    const int s = s0 + sl;
    const bool in = s < K1;
    const int t = in ? s / B : 0;
    const int b = in ? s - t * B : 0;
    const int j = j0 + c;
    if (tokens != nullptr) {
      const int tok = !in || s < tok_shift ? -1 : tokens[s - tok_shift];
#pragma unroll
      for (int q = 0; q < 4; ++q) as[sl][c + q] = tok == j + q ? 1.f : 0.f;
    } else if (wide_a && j + 3 < M) {
      cp_async16(&as[sl][c], in ? op_addr(A, d, t, b, j) : X.base, in);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (j + q < M) {
          cp_async4(&as[sl][c + q], in ? op_addr(A, d, t, b, j + q) : X.base, in);
        } else {
          as[sl][c + q] = in && j + q < rows ? 1.f : 0.f;  // the bias row
        }
      }
    }
    const int k = k0 + c;
    if (wide_x && k + 3 < N) {
      cp_async16(&xs[sl][c], in ? op_addr(X, d, t, b, k) : X.base, in);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool kin = in && k + q < N;
        cp_async4(&xs[sl][c + q], kin ? op_addr(X, d, t, b, k + q) : X.base, kin);
      }
    }
  }
  cp_async_commit();
}

// One tile of the GEMM
//   out[d][j][k] = sum_{t < T, b < B} A(d, t, b, j) * X(d, t, b, k)   (j < M)
//   bias[d][k]   = sum_{t, b} X(d, t, b, k)                  (row M, if set)
// over split s of the terms, s = blockIdx.z % splits: a 64 x 64 output
// tile, kGemmRows x kGemmCols a thread, K tiles of 32 terms double-buffered with
// cp.async. A(d, t, b, j) is the one-hot (tok == j) when tokens is set,
// tok = -1 for the first tok_shift terms and tokens[s - tok_shift] after
// (the tick loop's fed tokens, one step back). With one split the tile
// is written to out and bias; with more, to partial[d][s][rows][N] for
// gemm_finish. The terms of a split are summed in order, so repeats are
// bitwise equal (no atomics).
__global__ void __launch_bounds__(kGemmThreads)
gemm_atb(Operand A, const int* __restrict__ tokens, int tok_shift, int M, Operand X, int N,
         int T, int B, int rows, int splits, float* __restrict__ out, float* __restrict__ bias,
         float* __restrict__ partial) {
  __shared__ __align__(16) float as[2][kGemmDepth][kGemmTile];
  __shared__ __align__(16) float xs[2][kGemmDepth][kGemmTile];
  const int d = blockIdx.z / splits;
  const int split = blockIdx.z - d * splits;
  const int j0 = blockIdx.y * kGemmTile;
  const int k0 = blockIdx.x * kGemmTile;
  constexpr int TM = kGemmRows, TN = kGemmCols;
  const int tx = threadIdx.x % (kGemmTile / TN);  // columns TN tx ..
  const int ty = threadIdx.x / (kGemmTile / TN);  // rows TM ty ..
  const int K = T * B;
  const int chunk = gemm_chunk(K, splits);
  const int K0 = split * chunk;
  const int K1 = min(K0 + chunk, K);
  const bool wide_a = tokens == nullptr && rows_aligned(A);
  const bool wide_x = rows_aligned(X);
  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[a][c] = 0.f;

  int buf = 0;
  if (K0 < K1) {
    gemm_load(as[0], xs[0], A, wide_a, tokens, tok_shift, M, X, wide_x, N, B, rows, d, j0, k0,
              K0, K1);
  }
  for (int s0 = K0; s0 < K1; s0 += kGemmDepth) {
    if (s0 + kGemmDepth < K1) {
      gemm_load(as[buf ^ 1], xs[buf ^ 1], A, wide_a, tokens, tok_shift, M, X, wide_x, N, B, rows,
                d, j0, k0, s0 + kGemmDepth, K1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 4
    for (int sl = 0; sl < kGemmDepth; ++sl) {
      float av[TM], xv[TN];
#pragma unroll
      for (int p = 0; p < TM; p += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&as[buf][sl][ty * TM + p]);
        av[p] = a.x, av[p + 1] = a.y, av[p + 2] = a.z, av[p + 3] = a.w;
      }
#pragma unroll
      for (int q = 0; q < TN; q += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&xs[buf][sl][tx * TN + q]);
        xv[q] = x.x, xv[q + 1] = x.y, xv[q + 2] = x.z, xv[q + 3] = x.w;
      }
#pragma unroll
      for (int p = 0; p < TM; ++p)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[p][q] = fmaf(av[p], xv[q], acc[p][q]);
    }
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int p = 0; p < TM; ++p) {
    const int j = j0 + ty * TM + p;
    if (j >= rows) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int k = k0 + tx * TN + q;
      if (k >= N) continue;
      if (splits > 1) {
        partial[(static_cast<size_t>(blockIdx.z) * rows + j) * N + k] = acc[p][q];
      } else if (j < M) {
        out[(static_cast<size_t>(d) * M + j) * N + k] = acc[p][q];
      } else {
        bias[static_cast<size_t>(d) * N + k] = acc[p][q];
      }
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

// Launches the GEMM over D slices in `splits` splits of the terms (the
// caller's plan), then, with more than one split, the fixed-order sum;
// scratch holds atb_scratch_floats. Returns cudaGetLastError().
inline cudaError_t launch_atb(const Operand& A, const int* tokens, int tok_shift, int M,
                              const Operand& X, int N, int T, int B, int D, int splits,
                              float* out, float* bias, float* scratch, cudaStream_t st) {
  if (splits < 1) return cudaErrorInvalidValue;
  const int rows = M + (bias != nullptr ? 1 : 0);
  const dim3 grid((N + kGemmTile - 1) / kGemmTile, (rows + kGemmTile - 1) / kGemmTile,
                  D * splits);
  gemm_atb<<<grid, kGemmThreads, 0, st>>>(A, tokens, tok_shift, M, X, N, T, B, rows, splits,
                                          out, bias, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const dim3 grid2((rows * N + 255) / 256, D);
  gemm_finish<<<grid2, 256, 0, st>>>(scratch, splits, rows, M, N, out, bias);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row products: out = A W or A W^T over many rows, fixed order
// ---------------------------------------------------------------------------

constexpr int kRowTile = 64;     // output tile, rows and columns
constexpr int kRowDepth = 16;    // terms of the depth a K tile holds
constexpr int kRowThreads = 256; // 4 x 4 outputs a thread

// epi(m, n, v) for v = sum_k A[m * lda + k] * W(k, n) over k < K, for
// m < M and n < N, where W(k, n) = W[k * ldw + n] (A W) or, with
// kTransW, W[n * ldw + k] (A W^T). A 64 x 64 output tile a block, K
// tiles of 16 terms in shared memory; each output sums its terms in
// the order k = 0 .. K-1 in one register, so a repeat is bitwise equal.
template <bool kTransW, class Epi>
__global__ void __launch_bounds__(kRowThreads)
row_gemm(const float* __restrict__ A, int lda, const float* __restrict__ W, int ldw, int M,
         int K, int N, Epi epi) {
  __shared__ __align__(16) float as[kRowDepth][kRowTile + 4];  // as[k][m]
  __shared__ __align__(16) float ws[kRowDepth][kRowTile + 4];  // ws[k][n]
  const int m0 = blockIdx.y * kRowTile;
  const int n0 = blockIdx.x * kRowTile;
  const int tx = threadIdx.x % 16;  // columns 4 tx ..
  const int ty = threadIdx.x / 16;  // rows 4 ty ..
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kRowDepth) {
    for (int i = threadIdx.x; i < kRowDepth * kRowTile; i += kRowThreads) {
      const int r = i / kRowDepth;  // k fastest: neighbouring threads, neighbouring terms
      const int k = i - r * kRowDepth;
      const bool kin = k0 + k < K;
      as[k][r] = kin && m0 + r < M ? A[static_cast<size_t>(m0 + r) * lda + k0 + k] : 0.f;
      if (kTransW) {
        ws[k][r] = kin && n0 + r < N ? W[static_cast<size_t>(n0 + r) * ldw + k0 + k] : 0.f;
      } else {
        const int kk = i / kRowTile;  // n fastest
        const int n = i - kk * kRowTile;
        ws[kk][n] = k0 + kk < K && n0 + n < N ? W[static_cast<size_t>(k0 + kk) * ldw + n0 + n]
                                              : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowDepth; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k][4 * ty]);
      const float4 w = *reinterpret_cast<const float4*>(&ws[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], wv[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + 4 * ty + p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + 4 * tx + q;
      if (m < M && n < N) epi(m, n, acc[p][q]);
    }
  }
}

// Launches row_gemm on the stream; returns cudaGetLastError().
template <bool kTransW, class Epi>
cudaError_t launch_row_gemm(const float* A, int lda, const float* W, int ldw, int M, int K,
                            int N, Epi epi, cudaStream_t st) {
  const dim3 grid((N + kRowTile - 1) / kRowTile, (M + kRowTile - 1) / kRowTile);
  row_gemm<kTransW><<<grid, kRowThreads, 0, st>>>(A, lda, W, ldw, M, K, N, epi);
  return cudaGetLastError();
}

}  // namespace arvae
