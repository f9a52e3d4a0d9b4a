// The hierarchical decoder's sampled-feedback tick loop, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair of
// arvae_tpu/ops/hier_decoder_pallas.py::hier_tick_chain (_fwd_kernel,
// _bwd_kernel). For t = 0 .. T-1, with beat = t / ticks_per_beat:
//
//   at t % ticks_per_beat == 0: (h0, h1) = tick_h0[beat]   (beat resets)
//   gi0 = prev_emb @ w_ih0e + gi_beat[beat];  h0 = GRU(gi0, h0; w_hh0, b_hh0)
//   inter = h0 * dropout_mask(seed, t)        (training with dropout only)
//   h1 = GRU(inter @ w_ih1 + b_ih1, h1; w_hh1, b_hh1)
//   weights[t] = relu(h1 @ out_w + out_b)
//   sampled = argmax (lowest index on ties), or Gumbel-max (multinomial)
//   tok = clamp(teacher ? score[t] : sampled, 0, V-1);  prev_emb = emb[tok]
//
// with prev_emb = x0 at t = 0. The forward saves weights, samples (the fed
// tokens) and both layers' hiddens for the backward.
//
// Forward. What bounds it: a 24-step chain of dependent small products
// (two GRU layers of (rows x H) @ (H x 3H) and the (rows x H) @ (H x V)
// head) with an argmax and a gather between steps: latency, not bytes or
// arithmetic throughput. The step really is sequential (free-running, each
// tick's argmax feeds the next). The design: a thread-block cluster of C
// CTAs owns a tile of RB batch rows for the whole measure. CTA c holds in
// shared memory, loaded once, the gate columns of its H/C hidden units of
// w_ih0e, w_hh0, w_ih1 and w_hh1, its ceil(V/C) columns of out_w and
// out_b, and a full copy of emb for the gather (about 182 KB at H = 128,
// V = 130, C = 4), so no tick reads a weight from L2. A tick has three
// cluster barriers: layer 0 (own units, the new h0 and its dropout-masked
// copy written into every peer's shared memory), layer 1 (the new h1
// likewise), and the head (the CTA's V slice of the logits, a per-row
// partial (max, lowest index) written to every peer, combined by each CTA
// in the same way, then the teacher select and the re-embedding from the
// local emb). The products are gru_common.cuh's depth-split
// rows_times_w, a layer's two (input and hidden side) at once on the two
// halves of the block; one thread owns one (row, unit) of the cell math. The
// hiddens are double-buffered by tick parity. The plan (C, RB, shared
// memory) comes from arvae_tpu_torch/ops/hier_decoder_kernel.py::hier_plan,
// which mirrors fwd_layout below term for term; the entry refuses a plan
// that does not fit.
//
// Backward. The only dependence between ticks is the two hidden-gradient
// carries, and they restart at every beat (routed to dtick_h0); tokens
// carry no gradient. So it is n_beats independent chains of
// ticks_per_beat ticks a layer. Everything that does not touch a carry
// runs over all T x B rows at once through the tiled fixed-order row GEMM
// of gru_common.cuh: the recomputed gi0 and gi1, dlog @ out_w^T,
// dgi1 @ w_ih1^T and dgi0 @ w_ih0e^T; the ReLU's mask is the forward's
// own (weights > 0), so the backward agrees with it at the kink. Each layer's chain is the GRU
// chain's cluster backward (gru_cluster.cuh) over ticks_per_beat steps on
// n_beats x B rows. Chain operands use the layout (tick in beat,
// beat * B + b); the forward saves h0_all and h1_all in it, with zero
// rows for the padded ticks of a short last beat (T not a multiple of
// ticks_per_beat), whose gi and douts are zero too. The six weight and
// embedding gradients go through the A^T X GEMM of gru_common.cuh. All of
// it launches from the one C entry, in a fixed order on one stream; no
// float atomics, so repeats are bitwise equal.
//
// Random bits: a counter-based 32-bit hash of (seed, t, salt, row, col),
// indexed by the global batch row and column, salt 0 for dropout and
// 3571 for the Gumbel noise. The plain PyTorch version in
// arvae_tpu_torch/ops/hier_decoder_kernel.py computes the same function
// with integer tensor ops, and the uniform is formed with explicitly
// rounded multiply and add, so both give bitwise-equal masks.
//
// Plain C interface, loaded with ctypes: each entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "gru_cluster.cuh"

using namespace arvae;

namespace {

// ---------------------------------------------------------------------------
// Random bits
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// Uniform in (0, 1) from the top 24 bits, kept away from 0 and 1 as in
// arvae_tpu/ops/hier_decoder_pallas.py::_uniform01. The multiply and add
// are rounded separately (no fused multiply-add), as the plain version
// rounds them.
__device__ __forceinline__ float uniform01(uint32_t seed, int t, uint32_t salt, int row,
                                           int col) {
  uint32_t h = mix32(mix32(mix32(seed) ^ static_cast<uint32_t>(t)) ^ salt);
  h = mix32(mix32(h ^ static_cast<uint32_t>(row)) ^ static_cast<uint32_t>(col));
  const float u = static_cast<float>(h >> 8) * (1.f / 16777216.f);
  return __fadd_rn(__fmul_rn(u, 1.f - 2.f / 16777216.f), 1.f / 16777216.f);
}

constexpr uint32_t kSaltDropout = 0;
constexpr uint32_t kSaltGumbel = 3571;

__device__ __forceinline__ float dropout_mask(uint32_t seed, int t, int row, int col,
                                              float keep, float scale) {
  return uniform01(seed, t, kSaltDropout, row, col) < keep ? scale : 0.f;
}

// ---------------------------------------------------------------------------
// Arguments
// ---------------------------------------------------------------------------

struct Weights {
  const float* gi_beat;  // (n_beats, B, 3H)
  const float* tick_h0;  // (n_beats, 2, B, H)
  const float* x0;       // (B, E)
  const float* emb;      // (V, E)
  const float* w_ih0e;   // (E, 3H)
  const float* w_hh0;    // (H, 3H)
  const float* b_hh0;    // (3H,)
  const float* w_ih1;    // (H, 3H)
  const float* b_ih1;    // (3H,)
  const float* w_hh1;    // (H, 3H)
  const float* b_hh1;    // (3H,)
  const float* out_w;    // (H, V)
  const float* out_b;    // (V,)
};

struct Dims {
  int T, B, H, E, V, tpb;  // tpb: ticks per beat
  int dropout;             // 1: training with a dropout rate > 0
  float keep, scale;       // keep probability and 1 / keep
  int multinomial;         // 1: Gumbel-max sampling, 0: argmax

  __host__ __device__ int beats() const { return (T + tpb - 1) / tpb; }
};

// A row m of a chain operand, (tick in beat k, beat * B + b): its tick
// t = beat * tpb + k, its batch row b, and whether t < T (the last beat's
// padded ticks are not).
struct ChainRow {
  int k, rem, t, b;
  bool live;
};

__host__ __device__ inline ChainRow chain_row(const Dims& dm, int m) {
  ChainRow c;
  const int rows = dm.beats() * dm.B;
  c.k = m / rows;
  c.rem = m - c.k * rows;
  const int beat = c.rem / dm.B;
  c.b = c.rem - beat * dm.B;
  c.t = beat * dm.tpb + c.k;
  c.live = c.t < dm.T;
  return c;
}

// Element (t, b, j) of a saved (ticks_per_beat, n_beats * B, width) array.
__device__ __forceinline__ size_t chain_index(const Dims& dm, int t, int b, int j, int width) {
  const int beat = t / dm.tpb;
  const int k = t - beat * dm.tpb;
  return ((static_cast<size_t>(k) * dm.beats() + beat) * dm.B + b) * width + j;
}

struct FwdOut {
  float* weights;  // (T, B, V) relu logits
  int* samples;    // (T, B) fed tokens
  float* h0_all;   // (tpb, n_beats * B, H), chain layout
  float* h1_all;   // (tpb, n_beats * B, H)
};

// ---------------------------------------------------------------------------
// Forward: one cluster a tile of rows, weights resident in shared memory
// ---------------------------------------------------------------------------

// Shared-memory layout of one CTA of the forward, in floats; every array
// starts on a 16-byte boundary. ops/hier_decoder_kernel.py::fwd_smem_floats
// mirrors it term for term.
struct FwdLayout {
  int hc, n3, vc;                // hidden units, gate columns, vocabulary columns owned
  int ldw, ldv, ldh, ldg, lde, ldl;
  int w_ih0e, w_hh0, w_ih1, w_hh1, out_w;  // weight slices
  int b_hh0, b_ih1, b_hh1, out_b;          // bias slices
  int emb;                                 // the whole table
  int h0, h1;                              // full hiddens of the tile, 2 buffers each
  int x, pe, ga, gb, lg;                   // layer-1 input, fed embedding, gates, logits
  int part, part_hi;                       // partial sums: the head's; a layer's two halves
  int pm, pi, tok;                         // argmax partials [source CTA][row], fed tokens
  int total;
};

__host__ __device__ inline FwdLayout fwd_layout(int H, int E, int V, int C, int RB) {
  FwdLayout L;
  L.hc = H / C;
  L.n3 = 3 * L.hc;
  L.vc = (V + C - 1) / C;
  L.ldw = slice_ld(L.n3);
  L.ldv = slice_ld(L.vc);
  L.ldh = up4(H);
  L.ldg = up4(L.n3);
  L.lde = up4(E);
  L.ldl = up4(L.vc);
  int o = 0;
  auto take = [&](int& at, int n) {
    at = o;
    o += n;
  };
  take(L.w_ih0e, E * L.ldw);
  take(L.w_hh0, H * L.ldw);
  take(L.w_ih1, H * L.ldw);
  take(L.w_hh1, H * L.ldw);
  take(L.out_w, H * L.ldv);
  take(L.b_hh0, L.ldg);
  take(L.b_ih1, L.ldg);
  take(L.b_hh1, L.ldg);
  take(L.out_b, L.ldl);
  take(L.emb, up4(V * E));
  take(L.h0, 2 * RB * L.ldh);
  take(L.h1, 2 * RB * L.ldh);
  take(L.x, RB * L.ldh);
  take(L.pe, RB * L.lde);
  take(L.ga, RB * L.ldg);
  take(L.gb, RB * L.ldg);
  take(L.lg, RB * L.ldl);
  // the partial sums: a layer's two products run at once, each on half
  // the block with its own half of the scratch; the head on the whole
  const int half = up4(max(product_part_floats(RB, E, L.n3, kThreads / 2),
                           product_part_floats(RB, H, L.n3, kThreads / 2)));
  take(L.part, max(2 * half, up4(product_part_floats(RB, H, L.vc, kThreads))));
  L.part_hi = L.part + half;
  take(L.pm, up4(C * RB));
  take(L.pi, up4(C * RB));
  take(L.tok, up4(RB));
  L.total = o;
  return L;
}

// The CTA's gate columns of a (K, 3H) weight into a (K, ldw) slice.
__device__ __forceinline__ void load_gate_slice(float* dst, const FwdLayout& L, const float* w,
                                                int K, int H, int u0) {
  for (int g = 0; g < 3; ++g) copy_tile(dst + g * L.hc, L.ldw, w + g * H + u0, 3 * H, K, L.hc, K);
}

__global__ void __launch_bounds__(kThreads)
hier_fwd(Weights w, Dims dm, int RB, const int* __restrict__ teacher_ptr,
         const int* __restrict__ seed_ptr, const int* __restrict__ score, FwdOut out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int T = dm.T, B = dm.B, H = dm.H, E = dm.E, V = dm.V, H3 = 3 * H;
  const FwdLayout L = fwd_layout(H, E, V, C, RB);
  float* s_wi0 = smem + L.w_ih0e;
  float* s_wh0 = smem + L.w_hh0;
  float* s_wi1 = smem + L.w_ih1;
  float* s_wh1 = smem + L.w_hh1;
  float* s_ow = smem + L.out_w;
  float* s_bh0 = smem + L.b_hh0;
  float* s_bi1 = smem + L.b_ih1;
  float* s_bh1 = smem + L.b_hh1;
  float* s_ob = smem + L.out_b;
  float* s_emb = smem + L.emb;
  float* s_x = smem + L.x;
  float* s_pe = smem + L.pe;
  float* s_ga = smem + L.ga;
  float* s_gb = smem + L.gb;
  float* s_lg = smem + L.lg;
  float* part = smem + L.part;
  float* part_hi = smem + L.part_hi;
  float* s_pm = smem + L.pm;
  int* s_pi = reinterpret_cast<int*>(smem + L.pi);
  int* s_tok = reinterpret_cast<int*>(smem + L.tok);
  const int hbuf = RB * L.ldh;

  const int row0 = (blockIdx.x / C) * RB;
  const int nr = min(RB, B - row0);
  const int u0 = c * L.hc;                  // own hidden units
  const int v0 = c * L.vc;                  // own vocabulary columns
  const int nv = max(0, min(L.vc, V - v0));
  const bool teacher = *teacher_ptr != 0;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const Unit me = my_unit(RB, L.hc, nr);
  const int u = u0 + me.i;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // each layer's two products run at once on the two halves of the block
  const bool lo = threadIdx.x < kThreads / 2;
  const ThreadGroup half = lo ? ThreadGroup{0, kThreads / 2, 1}
                              : ThreadGroup{kThreads / 2, kThreads / 2, 2};

  // the weight slices, once for the whole measure
  load_gate_slice(s_wi0, L, w.w_ih0e, E, H, u0);
  load_gate_slice(s_wh0, L, w.w_hh0, H, H, u0);
  load_gate_slice(s_wi1, L, w.w_ih1, H, H, u0);
  load_gate_slice(s_wh1, L, w.w_hh1, H, H, u0);
  cp_async_commit();
  for (int i = threadIdx.x; i < H * L.vc; i += blockDim.x) {
    const int j = i / L.vc;
    const int n = i - j * L.vc;
    s_ow[j * L.ldv + n] = n < nv ? w.out_w[static_cast<size_t>(j) * V + v0 + n] : 0.f;
  }
  for (int i = threadIdx.x; i < L.n3; i += blockDim.x) {
    const int g = i / L.hc;
    const int col = g * H + u0 + i - g * L.hc;
    s_bh0[i] = w.b_hh0[col];
    s_bi1[i] = w.b_ih1[col];
    s_bh1[i] = w.b_hh1[col];
  }
  for (int i = threadIdx.x; i < L.vc; i += blockDim.x) s_ob[i] = i < nv ? w.out_b[v0 + i] : 0.f;
  for (int i = threadIdx.x; i < V * E; i += blockDim.x) s_emb[i] = w.emb[i];
  for (int i = threadIdx.x; i < RB * E; i += blockDim.x) {
    const int r = i / E;
    s_pe[r * L.lde + i - r * E] = r < nr ? w.x0[static_cast<size_t>(row0) * E + i] : 0.f;
  }
  cp_async_wait<0>();
  cluster.sync();  // every peer runs: its shared memory may be written

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const int beat = t / dm.tpb;
    float* h0c = smem + L.h0 + cur * hbuf;  // h_{t-1}, read this tick
    float* h0n = smem + L.h0 + (cur ^ 1) * hbuf;  // h_t, written by every CTA
    float* h1c = smem + L.h1 + cur * hbuf;
    float* h1n = smem + L.h1 + (cur ^ 1) * hbuf;
    if (t % dm.tpb == 0) {  // the beat's reset; nobody writes these buffers this tick
      const float* init = w.tick_h0 + (static_cast<size_t>(beat) * 2 * B + row0) * H;
      copy_tile(h0c, L.ldh, init, H, RB, H, nr);
      copy_tile(h1c, L.ldh, init + static_cast<size_t>(B) * H, H, RB, H, nr);
      cp_async_commit();
    }
    float gb3[3];  // the unit's gi_beat row
    load_gates(w.gi_beat + (static_cast<size_t>(beat) * B + row0 + me.r) * H3, H, u, me.row, gb3);
    cp_async_wait<0>();
    __syncthreads();

    // layer 0: gi0 = pe w_ih0e[:, own] + gi_beat, gh0 = h0 w_hh0[:, own] + b_hh0
    if (lo) {
      rows_times_w(s_pe, L.lde, RB, E, s_wi0, L.ldw, L.n3, part,
                   [&](int r, int n, float v) { s_ga[r * L.ldg + n] = v; }, half);
    } else {
      rows_times_w(h0c, L.ldh, RB, H, s_wh0, L.ldw, L.n3, part_hi,
                   [&](int r, int n, float v) { s_gb[r * L.ldg + n] = v + s_bh0[n]; }, half);
    }
    __syncthreads();
    if (me.live) {
      const float* a = s_ga + me.r * L.ldg;
      const float* b = s_gb + me.r * L.ldg;
      const Gates G = gru_gates(a[me.i] + gb3[0], a[L.hc + me.i] + gb3[1],
                                a[2 * L.hc + me.i] + gb3[2], b[me.i], b[L.hc + me.i],
                                b[2 * L.hc + me.i]);
      const float hn = gru_out(G, h0c[me.r * L.ldh + u]);
      if (me.row) out.h0_all[chain_index(dm, t, row0 + me.r, u, H)] = hn;
      const float x =
          dm.dropout ? hn * dropout_mask(seed, t, row0 + me.r, u, dm.keep, dm.scale) : hn;
      float* ph = h0n + me.r * L.ldh + u;
      float* px = s_x + me.r * L.ldh + u;
      for (int p = 0; p < C; ++p) {
        *cluster.map_shared_rank(ph, p) = hn;
        *cluster.map_shared_rank(px, p) = x;
      }
    }
    cluster.sync();

    // layer 1: gi1 = x w_ih1[:, own] + b_ih1, gh1 = h1 w_hh1[:, own] + b_hh1
    if (lo) {
      rows_times_w(s_x, L.ldh, RB, H, s_wi1, L.ldw, L.n3, part,
                   [&](int r, int n, float v) { s_ga[r * L.ldg + n] = v + s_bi1[n]; }, half);
    } else {
      rows_times_w(h1c, L.ldh, RB, H, s_wh1, L.ldw, L.n3, part_hi,
                   [&](int r, int n, float v) { s_gb[r * L.ldg + n] = v + s_bh1[n]; }, half);
    }
    __syncthreads();
    if (me.live) {
      const float* a = s_ga + me.r * L.ldg;
      const float* b = s_gb + me.r * L.ldg;
      const Gates G = gru_gates(a[me.i], a[L.hc + me.i], a[2 * L.hc + me.i], b[me.i],
                                b[L.hc + me.i], b[2 * L.hc + me.i]);
      const float hn = gru_out(G, h1c[me.r * L.ldh + u]);
      if (me.row) out.h1_all[chain_index(dm, t, row0 + me.r, u, H)] = hn;
      float* ph = h1n + me.r * L.ldh + u;
      for (int p = 0; p < C; ++p) *cluster.map_shared_rank(ph, p) = hn;
    }
    cluster.sync();

    // head: the CTA's V slice of the relu logits, then the sampling scores
    rows_times_w(h1n, L.ldh, RB, H, s_ow, L.ldv, L.vc, part,
                 [&](int r, int n, float v) { s_lg[r * L.ldl + n] = v + s_ob[n]; });
    __syncthreads();
    for (int i = threadIdx.x; i < RB * L.vc; i += blockDim.x) {
      const int r = i / L.vc;
      const int n = i - r * L.vc;
      if (n >= nv) continue;
      const float x = s_lg[r * L.ldl + n];
      const float l = x < 0.f ? 0.f : x;  // relu, NaN passes through
      if (r < nr) out.weights[(static_cast<size_t>(t) * B + row0 + r) * V + v0 + n] = l;
      s_lg[r * L.ldl + n] =
          dm.multinomial ? l - logf(-logf(uniform01(seed, t, kSaltGumbel, row0 + r, v0 + n)))
                         : l;
    }
    __syncthreads();
    // a per-row partial over the slice, one warp a row: the max (NaN if
    // any score is NaN) and the lowest index holding it (V if none), to
    // slot c of every CTA
    for (int r = warp; r < RB; r += blockDim.x >> 5) {
      const float* s = s_lg + r * L.ldl;
      float m = -INFINITY;
      for (int n = lane; n < nv; n += 32) {
        const float x = s[n];
        m = (x != x || m != m) ? NAN : fmaxf(m, x);
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, m, off);
        m = (o != o || m != m) ? NAN : fmaxf(m, o);
      }
      int idx = V;
      for (int n = lane; n < nv; n += 32) {
        if (s[n] == m) {
          idx = v0 + n;
          break;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        idx = min(idx, __shfl_xor_sync(0xffffffffu, idx, off));
      }
      if (lane == 0) {
        for (int p = 0; p < C; ++p) {
          *cluster.map_shared_rank(s_pm + c * RB + r, p) = m;
          *cluster.map_shared_rank(s_pi + c * RB + r, p) = idx;
        }
      }
    }
    cluster.sync();
    // every CTA combines the C partials alike: the max over slices (NaN
    // if any is NaN), then the lowest index among the slices holding it
    // (V for a NaN row); then the teacher select and the clamp
    if (threadIdx.x < RB) {
      const int r = threadIdx.x;
      float m = s_pm[r];
      for (int q = 1; q < C; ++q) {
        const float o = s_pm[q * RB + r];
        m = (o != o || m != m) ? NAN : fmaxf(m, o);
      }
      int idx = V;
      for (int q = 0; q < C; ++q) {
        if (s_pm[q * RB + r] == m) idx = min(idx, s_pi[q * RB + r]);
      }
      int tok = teacher && r < nr ? score[static_cast<size_t>(t) * B + row0 + r] : idx;
      tok = min(max(tok, 0), V - 1);
      if (c == 0 && r < nr) out.samples[static_cast<size_t>(t) * B + row0 + r] = tok;
      s_tok[r] = tok;
    }
    __syncthreads();
    // re-embed from the local table: the next tick's fed embedding
    for (int i = threadIdx.x; i < RB * E; i += blockDim.x) {
      const int r = i / E;
      const int e = i - r * E;
      s_pe[r * L.lde + e] = s_emb[s_tok[r] * E + e];
    }
  }
  // the padded ticks of a short last beat: zero hiddens for the backward
  for (int t = T; t < dm.beats() * dm.tpb; ++t) {
    if (me.row) {
      out.h0_all[chain_index(dm, t, row0 + me.r, u, H)] = 0.f;
      out.h1_all[chain_index(dm, t, row0 + me.r, u, H)] = 0.f;
    }
  }
  // no CTA may exit while a peer can still write into its shared memory:
  // the last writes precede the head's cluster barrier of tick T-1
}

// Refuses a forward plan the kernel cannot run: returns the shared-memory
// bytes it needs, or 0.
int fwd_checked_smem(int H, int E, int V, int C, int RB, int smem_bytes) {
  if (C < 1 || C > 8 || (C & (C - 1)) != 0 || H < 1 || H % C != 0 || E < 1 || V < 1) return 0;
  if (RB < kRowsPerThread || RB % kRowsPerThread != 0 || RB * (H / C) > kThreads) return 0;
  const long long need = 4LL * fwd_layout(H, E, V, C, RB).total;
  if (need > kMaxSmem || smem_bytes < need || smem_bytes > kMaxSmem) return 0;
  return static_cast<int>(need);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
struct BwdGrads {
  float* dgi_beat;  // (n_beats, B, 3H)
  float* dtick_h0;  // (n_beats, 2, B, H)
  float* dx0;       // (B, E)
  float* demb;      // (V, E)
  float* dw_ih0e;   // (E, 3H)
  float* dw_hh0;    // (H, 3H)
  float* db_hh0;    // (3H,)
  float* dw_ih1;    // (H, 3H)
  float* db_ih1;    // (3H,)
  float* dw_hh1;    // (H, 3H)
  float* db_hh1;    // (3H,)
  float* dout_w;    // (H, V)
  float* dout_b;    // (V,)
};

// The backward's scratch, carved from one buffer. Chain layout: R =
// ticks_per_beat * n_beats * B rows (tick in beat, beat * B + b); the
// chains' initial hiddens and their gradients have n_beats * B rows.
struct BwdScratch {
  int* tok;       // (R,) fed token, -1 at t = 0 and on padded ticks
  float* pe;      // (R, E) fed embedding
  float* inter;   // (R, H) layer-1 input after dropout
  float* gi0;     // (R, 3H)
  float* gi1;     // (R, 3H)
  float* dlog;    // (R, V) dlogits: dweights where the forward's logit > 0
  float* dh1;     // (R, H) dlog @ out_w^T: layer 1's incoming gradient
  float* init0;   // (n_beats * B, H) tick_h0[:, 0]
  float* init1;   // (n_beats * B, H) tick_h0[:, 1]
  float* dgi1;    // (R, 3H)
  float* dgh1;    // (R, 3H)
  float* dinit1;  // (n_beats * B, H)
  float* dx;      // (R, H) layer 0's incoming gradient
  float* dgi0;    // (R, 3H)
  float* dgh0;    // (R, 3H)
  float* dinit0;  // (n_beats * B, H)
  float* dpe;     // (R, E)
  long long floats;  // the floats taken; the GEMMs' partial sums follow
};

BwdScratch carve(const Dims& dm, float* base) {
  const long long bc = static_cast<long long>(dm.beats()) * dm.B;
  const long long R = dm.tpb * bc, H = dm.H, H3 = 3LL * dm.H;
  BwdScratch s;
  long long o = 0;
  auto take = [&](long long n) {
    float* p = base != nullptr ? base + o : nullptr;
    o += (n + 3) & ~3LL;  // 16-byte aligned regions
    return p;
  };
  s.tok = reinterpret_cast<int*>(take(R));
  s.pe = take(R * dm.E);
  s.inter = take(R * H);
  s.gi0 = take(R * H3);
  s.gi1 = take(R * H3);
  s.dlog = take(R * dm.V);
  s.dh1 = take(R * H);
  s.init0 = take(bc * H);
  s.init1 = take(bc * H);
  s.dgi1 = take(R * H3);
  s.dgh1 = take(R * H3);
  s.dinit1 = take(bc * H);
  s.dx = take(R * H);
  s.dgi0 = take(R * H3);
  s.dgh0 = take(R * H3);
  s.dinit0 = take(bc * H);
  s.dpe = take(R * dm.E);
  s.floats = o;
  return s;
}

// The chain operands the recompute needs: fed tokens and embeddings, the
// layer-1 input (the dropout mask replayed), the chains' initial hiddens,
// and dlog = dweights where the forward's relu logit is > 0 (its own
// decision at the kink, not a recomputed one).
__global__ void hier_bwd_prep(Weights w, Dims dm, const int* __restrict__ seed_ptr,
                              const int* __restrict__ samples, const float* __restrict__ h0_all,
                              const float* __restrict__ weights,
                              const float* __restrict__ dweights, BwdScratch s) {
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const int B = dm.B, H = dm.H, E = dm.E, V = dm.V;
  const int bc = dm.beats() * B;
  const int R = dm.tpb * bc;
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = i0; i < R * H; i += stride) {
    const int m = i / H;
    const int j = i - m * H;
    const ChainRow cr = chain_row(dm, m);
    const float x = h0_all[i];
    s.inter[i] = dm.dropout ? x * dropout_mask(seed, cr.t, cr.b, j, dm.keep, dm.scale) : x;
  }
  for (int i = i0; i < R * E; i += stride) {
    const int m = i / E;
    const int e = i - m * E;
    const ChainRow cr = chain_row(dm, m);
    float v = 0.f;
    if (cr.live) {
      v = cr.t == 0 ? w.x0[cr.b * E + e]
                    : w.emb[samples[(cr.t - 1) * B + cr.b] * E + e];
    }
    s.pe[i] = v;
  }
  for (int i = i0; i < R * V; i += stride) {
    const int m = i / V;
    const ChainRow cr = chain_row(dm, m);
    const size_t o = (static_cast<size_t>(cr.t) * B + cr.b) * V + i - m * V;
    s.dlog[i] = cr.live && weights[o] > 0.f ? dweights[o] : 0.f;
  }
  for (int m = i0; m < R; m += stride) {
    const ChainRow cr = chain_row(dm, m);
    s.tok[m] = cr.live && cr.t > 0 ? samples[(cr.t - 1) * B + cr.b] : -1;
  }
  for (int i = i0; i < bc * H; i += stride) {
    const int rem = i / H;
    const int beat = rem / B;
    const size_t src = (static_cast<size_t>(beat) * 2 * B + rem - beat * B) * H + i - rem * H;
    s.init0[i] = w.tick_h0[src];
    s.init1[i] = w.tick_h0[src + static_cast<size_t>(B) * H];
  }
}

// Epilogues of the batched row products (row m of a chain operand).

// gi = acc (+ bias[n]) (+ gi_beat[beat][b][n]) on live rows, 0 on padded.
struct EpiGates {
  Dims dm;
  float* out;
  const float* bias;
  const float* add;  // (n_beats * B, 3H), row beat * B + b
  __device__ void operator()(int m, int n, float v) const {
    const ChainRow cr = chain_row(dm, m);
    const int ld = 3 * dm.H;
    if (bias != nullptr) v += bias[n];
    if (add != nullptr) v += add[static_cast<size_t>(cr.rem) * ld + n];
    out[static_cast<size_t>(m) * ld + n] = cr.live ? v : 0.f;
  }
};

struct EpiStore {
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const {
    out[static_cast<size_t>(m) * ld + n] = v;
  }
};

// dx = acc times layer 1's input dropout mask (0 on padded rows).
struct EpiMask {
  Dims dm;
  float* out;
  const int* seed;
  __device__ void operator()(int m, int n, float v) const {
    const ChainRow cr = chain_row(dm, m);
    if (dm.dropout) {
      v *= dropout_mask(static_cast<uint32_t>(*seed), cr.t, cr.b, n, dm.keep, dm.scale);
    }
    out[static_cast<size_t>(m) * dm.H + n] = cr.live ? v : 0.f;
  }
};

// The gradients of one row each: dgi_beat (a beat's dgi0 summed in tick
// order), dx0 (dpe at t = 0), dtick_h0 (the chains' dh0).
__global__ void hier_bwd_finish(Dims dm, BwdScratch s, BwdGrads g) {
  const int B = dm.B, H = dm.H, E = dm.E, H3 = 3 * dm.H;
  const int bc = dm.beats() * B;
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = i0; i < bc * H3; i += stride) {
    float acc = 0.f;
    for (int k = 0; k < dm.tpb; ++k) acc += s.dgi0[static_cast<size_t>(k) * bc * H3 + i];
    g.dgi_beat[i] = acc;
  }
  for (int i = i0; i < B * E; i += stride) g.dx0[i] = s.dpe[i];
  for (int i = i0; i < bc * H; i += stride) {
    const int rem = i / H;
    const int beat = rem / B;
    const size_t o = (static_cast<size_t>(beat) * 2 * B + rem - beat * B) * H + i - rem * H;
    g.dtick_h0[o] = s.dinit0[i];
    g.dtick_h0[o + static_cast<size_t>(B) * H] = s.dinit1[i];
  }
}

Weights make_weights(const float* gi_beat, const float* tick_h0, const float* x0,
                     const float* emb, const float* w_ih0e, const float* w_hh0,
                     const float* b_hh0, const float* w_ih1, const float* b_ih1,
                     const float* w_hh1, const float* b_hh1, const float* out_w,
                     const float* out_b) {
  return Weights{gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0,
                 w_ih1, b_ih1, w_hh1, b_hh1, out_w, out_b};
}

// Blocks of the elementwise launches: enough to fill the card, each
// thread striding over the rest.
inline int elementwise_blocks(long long n) {
  return static_cast<int>(std::min<long long>((n + 255) / 256, 4 * 132));
}

}  // namespace

extern "C" {

const char* hier_tick_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of shared memory a CTA of the forward plan (C, RB) needs: the
// layout that ops/hier_decoder_kernel.py::fwd_smem_floats mirrors.
int hier_tick_chain_smem_floats(int H, int E, int V, int C, int RB) {
  return fwd_layout(H, E, V, C, RB).total;
}

// Clusters of C CTAs of the forward, smem_bytes of dynamic shared memory
// each, that the card can hold at once (cudaOccupancyMaxActiveClusters);
// a negative CUDA error code when the query fails.
int hier_tick_chain_resident_clusters(int C, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(hier_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * 1024);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, hier_fwd, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Floats of the backward's scratch before the GEMMs' partial sums.
long long hier_tick_chain_bwd_scratch_floats(int T, int B, int H, int E, int V,
                                              int ticks_per_beat) {
  const Dims dm{T, B, H, E, V, ticks_per_beat, 0, 1.f, 1.f, 0};
  return carve(dm, nullptr).floats;
}

// teacher, seed: (1,) i32 on the device; score (T, B) i32; the float
// operands as in struct Weights; the plan: clusters of C CTAs of RB rows,
// smem_bytes of dynamic shared memory each. Writes weights (T, B, V),
// samples (T, B) i32, h0_all and h1_all (ticks_per_beat, n_beats * B, H).
int hier_tick_chain_fwd(const int* teacher, const int* seed, const int* score,
                        const float* gi_beat, const float* tick_h0, const float* x0,
                        const float* emb, const float* w_ih0e, const float* w_hh0,
                        const float* b_hh0, const float* w_ih1, const float* b_ih1,
                        const float* w_hh1, const float* b_hh1, const float* out_w,
                        const float* out_b, int T, int B, int H, int E, int V,
                        int ticks_per_beat, int dropout, float keep, float scale,
                        int multinomial, int C, int RB, int smem_bytes, float* weights,
                        int* samples, float* h0_all, float* h1_all, void* stream) {
  if (fwd_checked_smem(H, E, V, C, RB, smem_bytes) == 0 || T < 1 || B < 1 ||
      ticks_per_beat < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Weights w = make_weights(gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0, w_ih1,
                                 b_ih1, w_hh1, b_hh1, out_w, out_b);
  const Dims dm{T, B, H, E, V, ticks_per_beat, dropout, keep, scale, multinomial};
  const FwdOut out{weights, samples, h0_all, h1_all};
  const dim3 grid(C * ((B + RB - 1) / RB));
  return static_cast<int>(launch_cluster(hier_fwd, C, grid, smem_bytes,
                                         static_cast<cudaStream_t>(stream), w, dm, RB, teacher,
                                         seed, score, out));
}

// The backward. grads: the 13 gradient outputs in the order of struct
// BwdGrads; chain_C, chain_RB, chain_smem: gru_plan's plan of the chain
// backward on n_beats * B rows; scratch: hier_tick_chain_bwd_scratch_floats
// floats, then the GEMMs' partial sums; splits: the split of the terms of
// each of the six weight-gradient GEMMs, in the order they run below
// (ops/hier_decoder_kernel.py::gemm_shapes).
int hier_tick_chain_bwd(const int* seed, const int* samples, const float* h0_all,
                        const float* h1_all, const float* weights, const float* dweights,
                        const float* gi_beat,
                        const float* tick_h0, const float* x0, const float* emb,
                        const float* w_ih0e, const float* w_hh0, const float* b_hh0,
                        const float* w_ih1, const float* b_ih1, const float* w_hh1,
                        const float* b_hh1, const float* out_w, const float* out_b, int T,
                        int B, int H, int E, int V, int ticks_per_beat, int dropout,
                        float keep, float scale, int chain_C, int chain_RB, int chain_smem,
                        float* dgi_beat, float* dtick_h0, float* dx0, float* demb,
                        float* dw_ih0e, float* dw_hh0, float* db_hh0, float* dw_ih1,
                        float* db_ih1, float* dw_hh1, float* db_hh1, float* dout_w,
                        float* dout_b, float* scratch, const int* splits, void* stream) {
  const Dims dm{T, B, H, E, V, ticks_per_beat, dropout, keep, scale, 0};
  if (T < 1 || B < 1 || ticks_per_beat < 1 ||
      chain_checked_smem(true, H, chain_C, chain_RB, chain_smem) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bc = dm.beats() * B;
  const long long rows = static_cast<long long>(ticks_per_beat) * bc;
  if (rows * std::max(3 * H, std::max(V, E)) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);  // 32-bit element indices
  }
  const int R = static_cast<int>(rows), H3 = 3 * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = make_weights(gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0, w_ih1,
                                 b_ih1, w_hh1, b_hh1, out_w, out_b);
  const BwdGrads g{dgi_beat, dtick_h0, dx0,    demb,   dw_ih0e, dw_hh0, db_hh0,
                   dw_ih1,   db_ih1,   dw_hh1, db_hh1, dout_w,  dout_b};
  const BwdScratch s = carve(dm, scratch);
  float* red = scratch + s.floats;

  hier_bwd_prep<<<elementwise_blocks(rows * std::max(H, V)), 256, 0, st>>>(
      w, dm, seed, samples, h0_all, weights, dweights, s);
  cudaError_t err = cudaGetLastError();
  // 1. batched over all rows: the recomputed gates' inputs, and the
  // head's gradient into layer 1
  if (err == cudaSuccess) {
    err = launch_row_gemm<false>(s.pe, E, w_ih0e, H3, R, E, H3,
                                 EpiGates{dm, s.gi0, nullptr, gi_beat}, st);
  }
  if (err == cudaSuccess) {
    err = launch_row_gemm<false>(s.inter, H, w_ih1, H3, R, H, H3,
                                 EpiGates{dm, s.gi1, b_ih1, nullptr}, st);
  }
  if (err == cudaSuccess) {
    err = launch_row_gemm<true>(s.dlog, V, out_w, V, R, V, H, EpiStore{s.dh1, H}, st);
  }
  // 2. layer 1's chains, one a beat
  const dim3 chain_grid(chain_C * ((bc + chain_RB - 1) / chain_RB));
  if (err == cudaSuccess) {
    err = launch_cluster(gru_bwd, chain_C, chain_grid, chain_smem, st, s.gi1, w_hh1, b_hh1,
                         s.init1, h1_all, s.dh1, ticks_per_beat, 1, bc, H, chain_RB, s.dgi1,
                         s.dinit1, s.dgh1);
  }
  // 3. the gradient of layer 1's input, through the dropout mask
  if (err == cudaSuccess) {
    err = launch_row_gemm<true>(s.dgi1, H3, w_ih1, H3, R, H3, H, EpiMask{dm, s.dx, seed}, st);
  }
  // 4. layer 0's chains
  if (err == cudaSuccess) {
    err = launch_cluster(gru_bwd, chain_C, chain_grid, chain_smem, st, s.gi0, w_hh0, b_hh0,
                         s.init0, h0_all, s.dx, ticks_per_beat, 1, bc, H, chain_RB, s.dgi0,
                         s.dinit0, s.dgh0);
  }
  // 5. the fed embedding's gradient, and the gradients of one row each
  if (err == cudaSuccess) {
    err = launch_row_gemm<true>(s.dgi0, H3, w_ih0e, H3, R, H3, E, EpiStore{s.dpe, E}, st);
  }
  if (err == cudaSuccess) {
    hier_bwd_finish<<<elementwise_blocks(static_cast<long long>(bc) * H3), 256, 0, st>>>(dm, s, g);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  // 6. the weight and embedding gradients: fixed-order sums over the
  // chain rows (padded ticks add exact zeros)
  const long long h = H, h3 = H3;
  auto dense = [&](const float* p, long long width) {
    return Operand{p, nullptr, 0, static_cast<long long>(bc) * width, width, 1, 0};
  };
  // a layer's h_{t-1}: its saved hiddens one tick back, the chain's
  // initial hidden at the first tick of a beat
  auto prev = [&](const float* all, const float* init) {
    return Operand{all, init, 0, static_cast<long long>(bc) * h, h, ticks_per_beat, 0};
  };
  struct Job {
    Operand a;
    const int* tokens;
    int m;
    Operand x;
    int n;
    float* out;
    float* bias;
  };
  const Job jobs[] = {
      {dense(h1_all, h), nullptr, H, dense(s.dlog, V), V, dout_w, dout_b},
      {dense(s.inter, h), nullptr, H, dense(s.dgi1, h3), H3, dw_ih1, db_ih1},
      {prev(h1_all, s.init1), nullptr, H, dense(s.dgh1, h3), H3, dw_hh1, db_hh1},
      {prev(h0_all, s.init0), nullptr, H, dense(s.dgh0, h3), H3, dw_hh0, db_hh0},
      {dense(s.pe, E), nullptr, E, dense(s.dgi0, h3), H3, dw_ih0e, nullptr},
      // one-hot of the fed token (-1: none, at t = 0 and on padded ticks)
      {dense(nullptr, V), s.tok, V, dense(s.dpe, E), E, demb, nullptr},
  };
  for (int i = 0; i < 6; ++i) {
    const Job& j = jobs[i];
    err = launch_atb(j.a, j.tokens, 0, j.m, j.x, j.n, ticks_per_beat, bc, 1, splits[i], j.out,
                     j.bias, red, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
