// The GRU chain's wide layout, forward and backward, for Hopper (sm_90a):
// the layout of the widths whose w_hh slices no cluster holds in shared
// memory beside its tile (H = 384 and 512, the reference's own width).
// gru_chain.cu runs both kernels; hier_tick_chain.cu runs the backward for
// its tick loop's chains, and builds its forward's wave layout from the
// barrier, the 3xTF32 product and the cooperative launch below. The
// resident cluster kernels (gru_cluster.cuh) keep the narrower widths.
//
// Replaces, at these widths, the Pallas TPU kernel pair of
// arvae_tpu/ops/gru_pallas.py::gru_chain (_fwd_kernel :121, _bwd_kernel
// :169), in the layout of gru_chain.cu: gi (T, D, B, 3H), w_hh (D, H, 3H),
// b_hh (D, 3H), h0 (D, B, H) -> outs (T, D, B, H).
//
// What bounds it: a T-long chain of dependent products, each step
// (D B x H) @ (H x 3H) forward and (D B x 3H) @ (3H x H) backward: 0.8
// GFLOP a step at (D, B, H) = (2, 256, 512), 12 µs at the card's fp32
// rate when every SM works on it, and the step's operand (h, or dgh)
// has to reach every SM that multiplies it. The w_hh of both
// directions is 6.3 MB: no SM holds it, but 128 SMs hold 49 KB of it
// each.
//
// The design: one wave of persistent CTAs, launched cooperatively so the
// runtime guarantees that they are co-resident, with a grid barrier a step
// (one integer counter; no float atomics). CTA (d, g, q) owns the U
// hidden units [g U, (g + 1) U) of direction d (U = 32 at these widths,
// 16 beyond 544) for the batch rows of row group q, and keeps its slice of
// w_hh in shared memory for the whole call, read from device memory once:
// the forward's 3U gate columns (H x 3U, stored column by column, 198 KB
// at H = 512), the backward's U rows of w_hh (U x 3H, the transposed
// product's). Rows are decoupled from threads: the CTA multiplies its rows
// in passes of P = 2048 / U rows; in the forward each pair of its 8 warps
// owns 32 rows by 16 units (x 3 gates) and splits the depth in two, in the
// backward each group of 4 warps owns 64 rows by 16 units and splits it in
// four; the partial sums meet in shared memory, added in a fixed order.
// Each step it streams the previous step's operand rows from L2 in chunks
// of 32 terms through three buffers (cp.async, two chunks in flight) while
// it multiplies.
//
// The products run on the tensor cores in 3xTF32 (mma.sync m16n8k8): each
// fp32 operand is split into a TF32 part and the TF32 rest of its
// remainder, and a x b is summed as a_big b_big + (a_rest b_big +
// a_big b_rest), each term in its own fp32 accumulator over the whole
// depth (no mma waits on the one before it): about fp32's accuracy (the
// dropped a_rest b_rest term is 2^-22 of the product), at a third of the
// TF32 rate, with fragment loads from shared memory that no bank conflict
// slows (on the CUDA cores, float4 loads of a 4 x 2 register tile reached
// a third of the fp32 rate). Each output sums its terms in the same order
// at every call, so a repeat is bitwise equal.
//
// Forward: at step t each CTA multiplies h_{t-1}'s rows (h0, or outs[t-1],
// written by every CTA at step t-1) by its gate columns, stages the
// products in shared memory, applies the gate math to its own (row, unit)
// cells four neighbouring units a thread (16-byte loads and stores of
// gi_t, h_{t-1}, h_t), writes h_t to outs, and, for a caller that trains,
// the hidden-side pre-activations gh_t = h_{t-1} w_hh + b_hh to a
// (T, D, B, 3H) buffer; one grid barrier a step.
//
// Backward: at step t (T-1 down to 0) each CTA runs the cell backward of
// its own cells from gh_t, gi_t, h_{t-1}, douts_t and the carried dh,
// writes dgi_t and dgh_t (the exchange, and the weight gradient's
// operand), and keeps dh z; after the step's one grid barrier it forms
// dh_{t-1} = dh z + dgh_t w_hh^T for its own units: the sum over all 3H
// gate columns stays inside the CTA, in a fixed order, because the CTA
// holds w_hh's rows of its units. The carry lives in dh0, which holds the
// answer after step 0. gh is always the forward's: gru_chain's wide
// forward keeps it for a backward that autograd records, and the tick
// loop's chains read its wave forward's. dW_hh and db_hh then come
// from tc_gemm.cuh's fixed-order A^T X GEMM
// over (t, b), as in the cluster layout (ops/gru_kernel.py::atb_splits).
//
// The launch plan (U, rows a CTA, shared memory) comes from
// arvae_tpu_torch/ops/gru_kernel.py::gru_plan, which mirrors wide_layout
// below; the entries refuse a plan that does not fit, and a cooperative
// launch whose CTAs the card would not hold at once fails.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "gru_common.cuh"
#include "tc_gemm.cuh"

namespace arvae {

constexpr int kWideThreads = 256;  // 8 warps
constexpr int kWideDepth = 32;  // terms of a streamed chunk
constexpr int kWideStages = 3;  // chunk buffers: two loads in flight while one is multiplied
constexpr int kWideLd = kWideDepth + 4;  // a chunk's leading dimension (4 mod 32: no conflicts)
constexpr int kWideQuads = 2;   // quads (4 neighbouring units of a row) of a thread's cell math

// Shared-memory layout of one CTA, in floats. The forward's slice is
// ws[c * ldf + k] = w_hh[k, gate(c) H + u0 + unit(c)] for its 3U columns
// c = gate U + unit; the backward's is ws[j * ldb + c] = w_hh[u0 + j, c].
// Both are padded with zeros to whole chunks (kf, kb terms); leading
// dimensions 4 mod 32 keep a warp's fragment loads on 32 distinct banks.
struct WideLayout {
  int U, P;     // units a CTA, rows a pass
  int kf, ldf;  // the forward's depth H in whole chunks, its slice's leading dimension
  int kb, ldb;  // the backward's depth 3H, likewise
  int x;        // the kWideStages chunk buffers, P x kWideLd each
  int total;
};

__host__ __device__ inline WideLayout wide_layout(bool bwd, int H, int U) {
  WideLayout L;
  L.U = U;
  L.P = 2048 / U;  // 4 warp pairs of 32 rows x 16 units (x 3 gates)
  L.kf = (H + kWideDepth - 1) / kWideDepth * kWideDepth;
  L.ldf = L.kf + 4;
  L.kb = (3 * H + kWideDepth - 1) / kWideDepth * kWideDepth;
  L.ldb = L.kb + 4;
  const int w = bwd ? U * L.ldb : 3 * U * L.ldf;
  L.x = w;
  L.total = w + kWideStages * L.P * kWideLd;
  return L;
}

// The gate product's warps: warp (ks, rest) of the 8 multiplies the
// pass's rows [mrow, mrow + 32) into units [16 np, 16 np + 16), each in its
// r, z and n columns (2 x 6 m16n8 tiles), over the depth steps ks, ks + 2,
// ... of every chunk; (ks 1)'s sums go to (ks 0), which keeps the tile's
// fragments: lane (g, t) their rows g, g + 8 and columns 2t, 2t + 1.
struct GateWarp {
  int ks, rest, np, mrow;
};

__device__ __forceinline__ GateWarp gate_warp(int U) {
  const int warp = threadIdx.x >> 5;
  GateWarp w;
  w.ks = warp & 1;
  w.rest = warp >> 1;
  w.np = w.rest % (U / 16);
  w.mrow = 32 * (w.rest / (U / 16));
  return w;
}

// The cell math runs on quads, so that its loads and stores of the
// operands in device memory are whole 16-byte words of neighbouring
// threads: quad j < kWideQuads of a thread is quad threadIdx.x + 256 j of
// the pass (P U / 4 = 512 of them): row r of the pass, the CTA's units
// u .. u + 3 (zeros, and no stores, past H).
struct Quad {
  int r, u;
  bool live;
};

__device__ __forceinline__ Quad wide_quad(int j, int U, int nr, int u0, int H) {
  const int q = threadIdx.x + kWideThreads * j;
  Quad x;
  x.r = q / (U / 4);
  x.u = u0 + (q - x.r * (U / 4)) * 4;
  x.live = x.r < nr && x.u < H;
  return x;
}

// Units u .. u + 3 at p (p at unit u): a float4 where vec (H a multiple
// of 4), else the units below H one by one. kOp: 0 a plain load, 1 through
// the read-only cache (inputs), 2 from L2 only (what other CTAs wrote).
template <int kOp>
__device__ __forceinline__ void quad_load(const float* p, int u, int H, bool vec, float* v) {
  if (vec) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 f = kOp == 1 ? __ldg(q) : kOp == 2 ? __ldcg(q) : *q;
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = u + i >= H ? 0.f : kOp == 1 ? __ldg(p + i) : kOp == 2 ? __ldcg(p + i) : p[i];
  }
}

__device__ __forceinline__ void quad_store(float* p, int u, int H, bool vec, const float* v) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (u + i < H) p[i] = v[i];
  }
}

// The CTA's place in the grid: direction d, units [u0, u0 + U), batch rows
// [row0, row0 + nrows) of its row group.
struct WideCta {
  int d, u0, row0, nrows;
};

__device__ __forceinline__ WideCta wide_cta(int B, int H, int U, int rows) {
  const int groups = (H + U - 1) / U;
  const int row_groups = (B + rows - 1) / rows;
  WideCta c;
  int b = blockIdx.x;
  const int q = b % row_groups;
  b /= row_groups;
  c.u0 = (b % groups) * U;
  c.d = b / groups;
  c.row0 = q * rows;
  c.nrows = min(rows, B - c.row0);
  return c;
}

// ---------------------------------------------------------------------------
// The grid barrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Barrier `pass` (0, 1, ...) of `members` CTAs of a cooperative launch,
// called alike by each of them: *count, zero before the launch, counts
// their arrivals over the whole call; a CTA arrives with a release and
// leaves once every member has arrived at this barrier, with an acquire,
// so the writes of every member before it are seen by every member after
// it. A CTA that waits for more than 2^34 cycles (about 10 s) traps, so
// that a fault surfaces as a launch error and not as a hung card.
__device__ __forceinline__ void group_sync(unsigned* count, unsigned members, unsigned pass) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned target = (pass + 1) * members;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
    const long long t0 = clock64();
    while (ld_acquire(count) < target) {
      if (clock64() - t0 > (1LL << 34)) __trap();
    }
  }
  __syncthreads();
}

// The barrier of the whole grid.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned pass) {
  group_sync(count, gridDim.x * gridDim.y * gridDim.z, pass);
}

// ---------------------------------------------------------------------------
// The streamed 3xTF32 product of a pass
// ---------------------------------------------------------------------------

// Chunk [k0, k0 + kWideDepth) of the pass's P rows of a (rows, K) operand
// (row r at src + r * lds) into dst (P x kWideLd) with cp.async (the caller
// commits the group), zeros past nr rows and K terms; 16-byte copies where
// vec (K and lds multiples of 4, src 16-byte aligned).
__device__ __forceinline__ void wide_chunk(float* dst, const float* src, long long lds, int P,
                                           int nr, int K, int k0, bool vec) {
  constexpr int kGroups = kWideDepth / 4;
  for (int idx = threadIdx.x; idx < P * kGroups; idx += kWideThreads) {
    const int r = idx / kGroups;
    const int c = (idx - r * kGroups) * 4;
    const int k = k0 + c;
    const float* from = src + r * lds + k;
    float* to = dst + r * kWideLd + c;
    if (vec) {
      const bool in = r < nr && k < K;
      cp_async16(to, in ? from : src, in);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = r < nr && k + q < K;
        cp_async4(to + q, in ? from + q : src, in);
      }
    }
  }
}

// acc[i][n] += X[mrow + 16 i .. + 16, :] W[:, n-tile n], 3xTF32: the
// warp's MT x NT m16n8 tiles, n-tile n holding the 8 slice rows wcol(n) ..
// (ws[(wcol(n) + j) * ldw + k] = W[k, j]), over the steps k8 = 8 ks,
// 8 (ks + KS), ... of every chunk of the kpad terms (KS warps split the
// depth; their caller adds their sums). The operand X is streamed in
// chunks (load(dst, k0)) through kWideStages buffers, the loads of the next
// two chunks in flight while one is multiplied: one __syncthreads a
// chunk. Every thread of the CTA calls it; a warp whose rows all lie past
// nr skips the arithmetic.
template <int MT, int NT, int KS, class Load, class WCol>
__device__ __forceinline__ void wide_product(float (*acc)[NT][4], const float* ws, int ldw,
                                             int kpad, float* xs, int P, int mrow, int ks,
                                             int nr, Load load, WCol wcol) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nchunks = kpad / kWideDepth;
  const bool busy = mrow < nr;
  // the three terms in three accumulators, so that no mma waits for the
  // one before it on the same tile; added in a fixed order at the end
  float rb[MT][NT][4], cr[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) rb[i][n][c] = cr[i][n][c] = 0.f;
  int woff[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) woff[n] = (wcol(n) + g) * ldw + t;
  const int stage = P * kWideLd;
#pragma unroll
  for (int s = 0; s < kWideStages - 1; ++s) {
    if (s < nchunks) load(xs + s * stage, s * kWideDepth);
    cp_async_commit();  // a group a chunk, empty past the last
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kWideStages - 2>();  // chunk ch has landed, for this thread
    __syncthreads();  // for every thread; and chunk ch - 1's buffer is free
    const int next = ch + kWideStages - 1;
    if (next < nchunks) load(xs + (next % kWideStages) * stage, next * kWideDepth);
    cp_async_commit();
    if (busy) {
      const float* x = xs + (ch % kWideStages) * stage + (mrow + g) * kWideLd + t;
      const float* w = ws + ch * kWideDepth;
#pragma unroll
      for (int k8 = 8 * ks; k8 < kWideDepth; k8 += 8 * KS) {
        uint32_t ab[MT][4], ar[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* xi = x + 16 * i * kWideLd + k8;
          tf32_split(xi[0], ab[i][0], ar[i][0]);
          tf32_split(xi[8 * kWideLd], ab[i][1], ar[i][1]);
          tf32_split(xi[4], ab[i][2], ar[i][2]);
          tf32_split(xi[8 * kWideLd + 4], ab[i][3], ar[i][3]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bb[2], br[2];
          tf32_split(w[woff[n] + k8], bb[0], br[0]);
          tf32_split(w[woff[n] + k8 + 4], bb[1], br[1]);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_tf32(rb[i][n], ar[i], bb);
            mma_tf32(cr[i][n], ab[i], br);
            mma_tf32(acc[i][n], ab[i], bb);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] += rb[i][n][c] + cr[i][n][c];
  __syncthreads();  // every buffer free for the next product
}

// The forward's slice of direction d into ws (3U columns, transposed,
// zeros past H), with cp.async: every copy in flight at once. The caller
// synchronises the CTA before reading it.
__device__ __forceinline__ void wide_load_fwd_slice(float* ws, const WideLayout& L,
                                                    const float* wd, int H, int u0) {
  const int n3 = 3 * L.U;
  for (int idx = threadIdx.x; idx < n3 * L.kf; idx += kWideThreads) {
    const int k = idx / n3;
    const int c = idx - k * n3;
    const int gate = c / L.U;
    const int u = u0 + c - gate * L.U;
    const bool in = k < H && u < H;
    cp_async4(ws + c * L.ldf + k, in ? wd + static_cast<size_t>(k) * 3 * H + gate * H + u : wd,
              in);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// gh_t's pre-bias products of a pass, rows [r0, r0 + nr) of h_{t-1}
// (hprev, row stride H), into the chunk buffers, which the product has
// freed: gs[r * (3U + 4) + gate U + unit] (P (3U + 4) <= kWideStages P
// kWideLd for U <= 32). (ks 1) hands its sums to (ks 0) through the same
// buffers first, which adds them in that order. Returns gs; the caller
// synchronises the CTA before reading it.
__device__ __forceinline__ float* wide_gate_product(const float* ws, const WideLayout& L,
                                                    float* xs, const float* hprev, int r0,
                                                    int nr, int H, bool vec) {
  const int U = L.U;
  const GateWarp w = gate_warp(U);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
  const float* src = hprev + static_cast<size_t>(r0) * H;
  wide_product<2, 6, 2>(
      acc, ws, L.ldf, L.kf, xs, L.P, w.mrow, w.ks, nr,
      [&](float* dst, int k0) { wide_chunk(dst, src, H, L.P, nr, H, k0, vec); },
      [&](int n) { return (n % 3) * U + 16 * w.np + 8 * (n / 3); });
  float* red = xs + w.rest * 48 * 32 + lane;  // [rest][e][lane]
  if (w.ks == 1) {
#pragma unroll
    for (int e = 0; e < 48; ++e) red[e * 32] = acc[e / 24][(e >> 2) % 6][e & 3];
  }
  __syncthreads();
  if (w.ks == 0) {
#pragma unroll
    for (int e = 0; e < 48; ++e) acc[e / 24][(e >> 2) % 6][e & 3] += red[e * 32];
  }
  __syncthreads();
  if (w.ks == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = w.mrow + 16 * i + g + 8 * (c >> 1);
        if (r >= nr) continue;
#pragma unroll
        for (int n = 0; n < 6; ++n) {
          xs[r * (3 * U + 4) + (n % 3) * U + 16 * w.np + 8 * (n / 3) + 2 * t + (c & 1)] =
              acc[i][n][c];
        }
      }
  }
  return xs;
}

// gh_t's quad x from the staged products and b_hh: q[gate][i].
__device__ __forceinline__ void quad_gates(const float* gs, const float* bd, const Quad& x, int U,
                                           int u0, int H, float (*q)[4]) {
  const float* s = gs + x.r * (3 * U + 4) + (x.u - u0);
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float4 f = *reinterpret_cast<const float4*>(s + g * U);
    const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) q[g][i] = v[i] + (x.u + i < H ? __ldg(bd + g * H + x.u + i) : 0.f);
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// outs (T, D, B, H) from gi, w_hh, b_hh, h0; gh (T, D, B, 3H) = h_{t-1}
// w_hh + b_hh where gh is set. rows: batch rows a CTA (the plan's).
template <int U>
__global__ void __launch_bounds__(kWideThreads, 1)
gru_wide_fwd(const float* __restrict__ gi, const float* __restrict__ w_hh,
             const float* __restrict__ b_hh, const float* __restrict__ h0, int T, int D, int B,
             int H, int rows, float* outs, float* gh, unsigned* bar) {
  extern __shared__ __align__(16) float smem[];
  const WideLayout L = wide_layout(false, H, U);
  const WideCta cta = wide_cta(B, H, U, rows);
  float* ws = smem;
  float* xs = smem + L.x;
  const int H3 = 3 * H;
  const int d = cta.d;
  const bool vec = H % 4 == 0;
  const float* bd = b_hh + d * H3;
  wide_load_fwd_slice(ws, L, w_hh + static_cast<size_t>(d) * H * H3, H, cta.u0);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? h0 + static_cast<size_t>(d) * B * H
                                : outs + (static_cast<size_t>(t - 1) * D + d) * B * H;
    const size_t step = (static_cast<size_t>(t) * D + d) * B;
    for (int r0 = cta.row0; r0 < cta.row0 + cta.nrows; r0 += L.P) {
      const int nr = min(L.P, cta.row0 + cta.nrows - r0);
      // the quads' gate inputs and h_{t-1}, in flight during the product
      float gx[kWideQuads][3][4], hp[kWideQuads][4];
#pragma unroll
      for (int j = 0; j < kWideQuads; ++j) {
        const Quad x = wide_quad(j, U, nr, cta.u0, H);
        if (!x.live) continue;
        const size_t row = r0 + x.r;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          quad_load<1>(gi + (step + row) * H3 + g * H + x.u, x.u, H, vec, gx[j][g]);
        }
        quad_load<2>(hprev + row * H + x.u, x.u, H, vec, hp[j]);
      }
      const float* gs = wide_gate_product(ws, L, xs, hprev, r0, nr, H, vec);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kWideQuads; ++j) {
        const Quad x = wide_quad(j, U, nr, cta.u0, H);
        if (!x.live) continue;
        const size_t row = step + r0 + x.r;
        float q[3][4], hn[4];
        quad_gates(gs, bd, x, U, cta.u0, H, q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Gates G = gru_gates(gx[j][0][i], gx[j][1][i], gx[j][2][i], q[0][i], q[1][i],
                                    q[2][i]);
          hn[i] = gru_out(G, hp[j][i]);
        }
        quad_store(outs + row * H + x.u, x.u, H, vec, hn);
        if (gh != nullptr) {
#pragma unroll
          for (int g = 0; g < 3; ++g) quad_store(gh + row * H3 + g * H + x.u, x.u, H, vec, q[g]);
        }
      }
      __syncthreads();  // the staging buffers are the next product's
    }
    if (t + 1 < T) grid_sync(bar, t);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// dgi (T, D, B, 3H), dh0 (D, B, H) and dgh (T, D, B, 3H) from gi, the
// forward's gh, w_hh, h0, outs, douts; dh0 carries dh between steps.
template <int U>
__global__ void __launch_bounds__(kWideThreads, 1)
gru_wide_bwd(const float* __restrict__ gi, const float* __restrict__ gh,
             const float* __restrict__ w_hh,
             const float* __restrict__ h0, const float* __restrict__ outs,
             const float* __restrict__ douts, int T, int D, int B, int H, int rows,
             float* __restrict__ dgi, float* dh0, float* dgh, unsigned* bar) {
  extern __shared__ __align__(16) float smem[];
  const WideLayout L = wide_layout(true, H, U);
  const WideCta cta = wide_cta(B, H, U, rows);
  float* ws = smem;
  float* xs = smem + L.x;
  const int H3 = 3 * H;
  const int d = cta.d;
  const float* wd = w_hh + static_cast<size_t>(d) * H * H3;
  const float* h0d = h0 + static_cast<size_t>(d) * B * H;
  auto hprev_of = [&](int t) {
    return t == 0 ? h0d : outs + (static_cast<size_t>(t - 1) * D + d) * B * H;
  };

  const bool vec = H % 4 == 0;
  // the backward's slice: w_hh's rows of the own units, zeros past 3H and H
  for (int idx = threadIdx.x; idx < U * L.kb / 4; idx += kWideThreads) {
    const int j = idx / (L.kb / 4);
    const int c = (idx - j * (L.kb / 4)) * 4;
    const int u = cta.u0 + j;
    const float* from = wd + static_cast<size_t>(u) * H3 + c;
    if (vec) {
      const bool in = c < H3 && u < H;
      cp_async16(ws + j * L.ldb + c, in ? from : wd, in);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = c + q < H3 && u < H;
        cp_async4(ws + j * L.ldb + c + q, in ? from + q : wd, in);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const float* hprev = hprev_of(t);
    const size_t step = (static_cast<size_t>(t) * D + d) * B;
    // the cells, by quads: dgi_t and dgh_t out, dh z kept in dh0. Every
    // input of a thread's quads is loaded before any output is stored, so
    // the loads overlap (the outputs may alias nothing the compiler can
    // prove); the carry in dh0 was written by other threads' fragments
    __syncthreads();
    for (int r0 = cta.row0; r0 < cta.row0 + cta.nrows; r0 += L.P) {
      const int nr = min(L.P, cta.row0 + cta.nrows - r0);
      float in_i[kWideQuads][3][4], in_h[kWideQuads][3][4], dh[kWideQuads][4];
      float hp[kWideQuads][4], carry[kWideQuads][4];
#pragma unroll
      for (int j = 0; j < kWideQuads; ++j) {
        const Quad x = wide_quad(j, U, nr, cta.u0, H);
        if (!x.live) continue;
        const size_t row = step + r0 + x.r;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          quad_load<1>(gi + row * H3 + g * H + x.u, x.u, H, vec, in_i[j][g]);
          quad_load<1>(gh + row * H3 + g * H + x.u, x.u, H, vec, in_h[j][g]);
        }
        quad_load<1>(douts + row * H + x.u, x.u, H, vec, dh[j]);
        quad_load<1>(hprev + (r0 + x.r) * static_cast<size_t>(H) + x.u, x.u, H, vec, hp[j]);
        quad_load<0>(dh0 + (static_cast<size_t>(d) * B + r0 + x.r) * H + x.u, x.u, H, vec,
                     carry[j]);
      }
#pragma unroll
      for (int j = 0; j < kWideQuads; ++j) {
        const Quad x = wide_quad(j, U, nr, cta.u0, H);
        if (!x.live) continue;
        const size_t row = step + r0 + x.r;
        float dr[4], dz[4], dn[4], dghn[4], dhz[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Gates G = gru_gates(in_i[j][0][i], in_i[j][1][i], in_i[j][2][i], in_h[j][0][i],
                                    in_h[j][1][i], in_h[j][2][i]);
          const CellGrads cgr =
              gru_cell_bwd(t < T - 1 ? dh[j][i] + carry[j][i] : dh[j][i], G, hp[j][i]);
          dr[i] = cgr.dr;
          dz[i] = cgr.dz;
          dn[i] = cgr.dn;
          dghn[i] = cgr.dgh_n;
          dhz[i] = cgr.dh_z;
        }
        float* o = dgi + row * H3 + x.u;
        quad_store(o, x.u, H, vec, dr);
        quad_store(o + H, x.u, H, vec, dz);
        quad_store(o + 2 * H, x.u, H, vec, dn);
        float* e = dgh + row * H3 + x.u;
        quad_store(e, x.u, H, vec, dr);
        quad_store(e + H, x.u, H, vec, dz);
        quad_store(e + 2 * H, x.u, H, vec, dghn);
        quad_store(dh0 + (static_cast<size_t>(d) * B + r0 + x.r) * H + x.u, x.u, H, vec, dhz);
      }
    }
    grid_sync(bar, T - 1 - t);  // every CTA's dgh_t written
    // dh_{t-1} = dh z + dgh_t w_hh^T over the own units: warp (half, ks)
    // multiplies 64 rows by 16 units (4 x 2 m16n8 tiles) over the depth
    // steps ks, ks + 4, ... of every chunk; the warps of ks 1-3 hand their
    // sums to ks 0's through the freed chunk buffers, which adds them in
    // that order
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ks = warp & 3, half = warp >> 2;
    const int np = U == 32 ? half : 0, mrow = U == 32 ? 0 : 64 * half;
    for (int r0 = cta.row0; r0 < cta.row0 + cta.nrows; r0 += L.P) {
      const int nr = min(L.P, cta.row0 + cta.nrows - r0);
      float acc[4][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
      const float* src = dgh + (step + r0) * H3;
      wide_product<4, 2, 4>(
          acc, ws, L.ldb, L.kb, xs, L.P, mrow, ks, nr,
          [&](float* dst, int k0) { wide_chunk(dst, src, H3, L.P, nr, H3, k0, vec); },
          [&](int n) { return 16 * np + 8 * n; });
      float* red = xs + half * 32 * 32 + lane;  // [ks - 1][half][e][lane]
      if (ks > 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          red[((ks - 1) * 2 * 32 + e) * 32] = acc[e >> 3][(e >> 2) & 1][e & 3];
        }
      }
      __syncthreads();
      if (ks == 0 && mrow < nr) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = e >> 3, n = (e >> 2) & 1, c = e & 3;
          const int r = mrow + 16 * i + (lane >> 2) + 8 * (c >> 1);
          const int u = cta.u0 + 16 * np + 8 * n + 2 * (lane & 3) + (c & 1);
          if (r >= nr || u >= H) continue;
          float sum = acc[i][n][c];
#pragma unroll
          for (int k = 0; k < 3; ++k) sum += red[(k * 2 * 32 + e) * 32];
          float* carry = dh0 + (static_cast<size_t>(d) * B + r0 + r) * H + u;
          *carry = *carry + sum;
        }
      }
      __syncthreads();  // the chunk buffers are the next product's
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: plans and launches
// ---------------------------------------------------------------------------

// Returns the shared-memory bytes a plan (U units, rows a CTA) needs, or 0
// when the kernels do not take it.
inline int wide_checked_smem(bool bwd, int H, int U, int rows, int smem_bytes) {
  if ((U != 16 && U != 32) || H < 1 || rows < 1) return 0;
  const long long need = 4LL * wide_layout(bwd, H, U).total;
  if (need > kMaxSmem || smem_bytes < need || smem_bytes > kMaxSmem) return 0;
  return static_cast<int>(need);
}

inline int wide_ctas(int D, int B, int H, int U, int rows) {
  return D * ((H + U - 1) / U) * ((B + rows - 1) / rows);
}

// CTAs of the kernel, smem bytes each, that the card holds at once
// (occupancy a SM times the SMs); a negative CUDA error code when a query
// fails.
template <class... Params>
inline int wide_resident_ctas(void (*kernel)(Params...), int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// A cooperative launch of ctas CTAs: the runtime refuses it unless the
// card holds them all at once. bar (the barrier's counter) is zeroed on
// the stream first.
template <class... Params, class... Args>
inline cudaError_t launch_wide(void (*kernel)(Params...), int ctas, int smem, unsigned* bar,
                               cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(bar, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The wide backward chain: plan (U, rows a CTA, smem bytes); gh the
// forward's hidden-side pre-activations. Returns cudaGetLastError().
inline cudaError_t launch_wide_bwd(const float* gi, const float* gh, const float* w_hh,
                                   const float* h0, const float* outs, const float* douts,
                                   int T, int D, int B, int H, int U, int rows, int smem,
                                   float* dgi, float* dh0, float* dgh, unsigned* bar,
                                   cudaStream_t st) {
  const int ctas = wide_ctas(D, B, H, U, rows);
  return U == 32 ? launch_wide(gru_wide_bwd<32>, ctas, smem, bar, st, gi, gh, w_hh, h0, outs,
                               douts, T, D, B, H, rows, dgi, dh0, dgh, bar)
                 : launch_wide(gru_wide_bwd<16>, ctas, smem, bar, st, gi, gh, w_hh, h0, outs,
                               douts, T, D, B, H, rows, dgi, dh0, dgh, bar);
}

}  // namespace arvae
