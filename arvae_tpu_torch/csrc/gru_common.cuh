// Pieces shared by the two recurrence kernels (gru_chain.cu and
// hier_tick_chain.cu): torch-exact GRU gate math forward and backward;
// block-wide products of a tile of rows with a weight slice resident in
// shared memory (the cluster kernels); cp.async copies. The backwards'
// weight gradients and row products run on tc_gemm.cuh's tensor-core
// engine.
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

}  // namespace arvae
