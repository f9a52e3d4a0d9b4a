// The hierarchical decoder's sampled-feedback tick loop, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair of
// arvae_tpu/ops/hier_decoder_pallas.py::hier_tick_chain (_fwd_kernel,
// _bwd_kernel). For t = 0 .. T-1, with beat = t / ticks_per_beat and a
// tick GRU of L layers (1 <= L <= kMaxLayers):
//
//   at t % ticks_per_beat == 0: h_l = tick_h0[beat][l] for every l (beat resets)
//   gi_0 = prev_emb @ w_ih0e + gi_beat[beat];  h_0 = GRU(gi_0, h_0; w_hh_0, b_hh_0)
//   for l = 1 .. L-1:
//     x_l = h_{l-1} * dropout_mask(seed, t, salt l-1)   (training with dropout only)
//     h_l = GRU(x_l @ w_ih_l + b_ih_l, h_l; w_hh_l, b_hh_l)
//   weights[t] = relu(h_{L-1} @ out_w + out_b)
//   sampled = argmax (lowest index on ties), or Gumbel-max (multinomial)
//   tok = clamp(teacher ? score[t] : sampled, 0, V-1);  prev_emb = emb[tok]
//
// with prev_emb = x0 at t = 0. The forward saves weights, samples (the fed
// tokens) and every layer's hiddens for the backward.
//
// Forward. What bounds it: a 24-step chain of dependent small products
// (L GRU layers of (rows x H) @ (H x 3H) and the (rows x H) @ (H x V)
// head) with an argmax and a gather between steps: latency, not bytes or
// arithmetic throughput. The step really is sequential (free-running, each
// tick's argmax feeds the next). The design: a thread-block cluster of C
// CTAs owns a tile of RB batch rows for the whole measure. In the resident
// layout CTA c holds in shared memory, loaded once, the gate columns of
// its H/C hidden units of w_ih0e and of every layer's w_hh and w_ih, its
// ceil(V/C) columns of out_w and out_b, and a full copy of emb for the
// gather (about 182 KB at H = 128, V = 130, C = 4, L = 2), so no tick
// reads a weight from L2. A tick has L + 1 cluster barriers: one a layer
// (own units, the new h_l and its dropout-masked copy, the next layer's
// input, written into every peer's shared memory), and the head (the
// CTA's V slice of the logits, a per-row partial (max, lowest index)
// written to every peer, combined by each CTA in the same way, then the
// teacher select and the re-embedding from the local emb). The products
// are gru_common.cuh's depth-split rows_times_w, a layer's two (input and
// hidden side) at once on the two halves of the block; one thread owns
// one (row, unit) of the cell math. The hiddens are double-buffered by
// tick parity, and the layers' inputs by layer parity.
//
// Where no cluster of 8 CTAs holds those slices (H >= 256 at L = 2, or 4
// layers at H = 128), the plan takes the streamed layout: the CTA keeps
// only biases, emb and its tiles, and every product reads its weight
// slice from L2 (about 9 MB of matrices at H = 512, L = 2; 21 MB at L = 4,
// against 50 MB of L2) in stages of 32 rows, double-buffered with
// cp.async, on the whole block, one product after the other (the
// streamed products of gru_common.cuh: each output adds its stages'
// partial sums in stage order). The plan (C, RB, shared memory, layout)
// comes from arvae_tpu_torch/ops/hier_decoder_kernel.py::hier_plan, which
// mirrors fwd_layout below term for term; the entry refuses a plan that
// does not fit.
//
// Backward. The only dependence between ticks is the L hidden-gradient
// carries, and they restart at every beat (routed to dtick_h0); tokens
// carry no gradient. So it is n_beats independent chains of
// ticks_per_beat ticks a layer. Everything that does not touch a carry
// runs over all T x B rows at once through the tiled fixed-order row GEMM
// of gru_common.cuh: the recomputed gi_l, dlog @ out_w^T,
// dgi_l @ w_ih_l^T (masked by gap l-1's dropout) and dgi_0 @ w_ih0e^T;
// the ReLU's mask is the forward's own (weights > 0), so the backward
// agrees with it at the kink. The layers run from the top down: each
// layer's chain is the GRU chain's cluster backward (gru_cluster.cuh, in
// its resident or streamed layout as gru_plan gives it) over
// ticks_per_beat steps on n_beats x B rows, followed by its weight
// gradients. Chain operands use the layout (tick in beat, beat * B + b);
// the forward saves the hiddens in it, with zero rows for the padded
// ticks of a short last beat (T not a multiple of ticks_per_beat), whose
// gi and douts are zero too. The 2L + 2 weight and embedding gradients go
// through the A^T X GEMM of gru_common.cuh. All of it launches from the
// one C entry, in a fixed order on one stream; no float atomics, so
// repeats are bitwise equal.
//
// Random bits: a counter-based 32-bit hash of (seed, t, salt, row, col),
// indexed by the global batch row and column, salt l for the dropout of
// the gap after layer l and 3571 for the Gumbel noise. The plain PyTorch
// version in arvae_tpu_torch/ops/hier_decoder_kernel.py computes the same
// function with integer tensor ops, and the uniform is formed with
// explicitly rounded multiply and add, so both give bitwise-equal masks.
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

constexpr uint32_t kSaltDropout = 0;  // + the gap: the gap after layer l draws salt l
constexpr uint32_t kSaltGumbel = 3571;

__device__ __forceinline__ float dropout_mask(uint32_t seed, int t, int gap, int row, int col,
                                              float keep, float scale) {
  return uniform01(seed, t, kSaltDropout + gap, row, col) < keep ? scale : 0.f;
}

// ---------------------------------------------------------------------------
// Arguments
// ---------------------------------------------------------------------------

// Tick-GRU layers the kernels take.
constexpr int kMaxLayers = 4;

struct Weights {
  const float* gi_beat;  // (n_beats, B, 3H)
  const float* tick_h0;  // (n_beats, L, B, H)
  const float* x0;       // (B, E)
  const float* emb;      // (V, E)
  const float* w_ih0e;   // (E, 3H)
  const float* w_hh[kMaxLayers];  // (H, 3H) each
  const float* b_hh[kMaxLayers];  // (3H,)
  const float* w_ih[kMaxLayers];  // (H, 3H), layers 1 .. L-1 ([0] unused)
  const float* b_ih[kMaxLayers];  // (3H,), layers 1 .. L-1
  const float* out_w;    // (H, V)
  const float* out_b;    // (V,)
};

struct Dims {
  int T, B, H, E, V, tpb;  // tpb: ticks per beat
  int L;                   // tick-GRU layers
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
  float* weights;               // (T, B, V) relu logits
  int* samples;                 // (T, B) fed tokens
  float* h_all[kMaxLayers];     // (tpb, n_beats * B, H) each, chain layout
};

// ---------------------------------------------------------------------------
// Forward: one cluster a tile of rows
// ---------------------------------------------------------------------------

// Shared-memory layout of one CTA of the forward, in floats; every array
// starts on a 16-byte boundary. ops/hier_decoder_kernel.py::fwd_smem_floats
// mirrors it term for term.
struct FwdLayout {
  int hc, n3, vc;  // hidden units, gate columns, vocabulary columns owned
  int ldw, ldv, ldh, ldg, lde, ldl;
  int wsz;         // floats of one resident H x 3H slice
  int w_ih0e;      // resident: w_ih0e's slice; streamed: the two stages
  int wl;          // resident: the layers' slices, w_hh_0, then w_ih_l, w_hh_l for l >= 1
  int out_w;       // resident: out_w's slice
  int bl;          // bias slices: b_hh_0, then b_ih_l, b_hh_l for l >= 1
  int out_b, emb;  // out_b's slice, the whole table
  int h;           // hiddens of the tile: layer l's 2 buffers from h + 2 l RB ldh
  int x;           // the next layer's input: 1 buffer at L = 2, 2 by layer parity at L > 2
  int pe, ga, gb, lg;  // fed embedding, gates (input and hidden side), logits
  int part, part_hi;   // partial sums: the head's; a layer's two halves (resident)
  int pm, pi, tok;     // argmax partials [source CTA][row], fed tokens
  int total;

  __host__ __device__ int whh(int l) const { return wl + 2 * l * wsz; }
  __host__ __device__ int wih(int l) const { return wl + (2 * l - 1) * wsz; }
  __host__ __device__ int bhh(int l) const { return bl + 2 * l * ldg; }
  __host__ __device__ int bih(int l) const { return bl + (2 * l - 1) * ldg; }
};

__host__ __device__ inline FwdLayout fwd_layout(int H, int E, int V, int C, int RB, int NL,
                                                bool stream) {
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
  L.wsz = H * L.ldw;
  int o = 0;
  auto take = [&](int& at, int n) {
    at = o;
    o += n;
  };
  if (stream) {
    take(L.w_ih0e, 2 * kStreamDepth * max(L.ldw, L.ldv));
    L.wl = L.out_w = L.w_ih0e;
  } else {
    take(L.w_ih0e, E * L.ldw);
    take(L.wl, (2 * NL - 1) * L.wsz);
    take(L.out_w, H * L.ldv);
  }
  take(L.bl, (2 * NL - 1) * L.ldg);
  take(L.out_b, L.ldl);
  take(L.emb, up4(V * E));
  take(L.h, NL * 2 * RB * L.ldh);
  take(L.x, min(NL - 1, 2) * RB * L.ldh);
  take(L.pe, RB * L.lde);
  take(L.ga, RB * L.ldg);
  take(L.gb, RB * L.ldg);
  take(L.lg, RB * L.ldl);
  if (stream) {
    // the products run one at a time on the whole block, a stage deep
    const int depth = min(kStreamDepth, H);
    take(L.part, up4(max(product_part_floats(RB, E, L.n3, kThreads),
                         max(product_part_floats(RB, depth, L.n3, kThreads),
                             product_part_floats(RB, depth, L.vc, kThreads)))));
    L.part_hi = L.part;
  } else {
    // a layer's two products run at once, each on half the block with
    // its own half of the scratch; the head on the whole
    const int half = up4(max(product_part_floats(RB, E, L.n3, kThreads / 2),
                             product_part_floats(RB, H, L.n3, kThreads / 2)));
    take(L.part, max(2 * half, up4(product_part_floats(RB, H, L.vc, kThreads))));
    L.part_hi = L.part + half;
  }
  take(L.pm, up4(C * RB));
  take(L.pi, up4(C * RB));
  take(L.tok, up4(RB));
  L.total = o;
  return L;
}

// The CTA's gate columns of a (K, 3H) weight into a (K, ldw) slice.
__device__ __forceinline__ void load_gate_slice(float* dst, const FwdLayout& L, const float* w,
                                                int K, int H, int u0) {
  load_gate_rows(dst, L.ldw, w, H, L.hc, u0, 0, K);
}

// A streamed product's loader of the CTA's vocabulary columns [v0, v0 + nv)
// of out_w (H, V), zeros in the slice's columns past V.
struct VocabRows {
  const float* w;
  int V, v0, nv, vc, ldv;
  __device__ void operator()(float* dst, int k0, int kt) const {
    for (int i = threadIdx.x; i < kt * vc; i += blockDim.x) {
      const int r = i / vc;
      const int n = i - r * vc;
      const bool in = n < nv;
      cp_async4(dst + r * ldv + n, in ? w + static_cast<size_t>(k0 + r) * V + v0 + n : w, in);
    }
  }
};

template <bool kStream>
__global__ void __launch_bounds__(kThreads)
hier_fwd(Weights w, Dims dm, int RB, const int* __restrict__ teacher_ptr,
         const int* __restrict__ seed_ptr, const int* __restrict__ score, FwdOut out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int T = dm.T, B = dm.B, H = dm.H, E = dm.E, V = dm.V, NL = dm.L, H3 = 3 * H;
  const FwdLayout L = fwd_layout(H, E, V, C, RB, NL, kStream);
  float* stage = smem + L.w_ih0e;  // streamed: the weight stages
  float* s_ow = smem + L.out_w;
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
  // resident: each layer's two products run at once on the two halves of the block
  const bool lo = threadIdx.x < kThreads / 2;
  const ThreadGroup half = lo ? ThreadGroup{0, kThreads / 2, 1}
                              : ThreadGroup{kThreads / 2, kThreads / 2, 2};

  // the weight slices, once for the whole measure (resident)
  if (!kStream) {
    load_gate_slice(smem + L.w_ih0e, L, w.w_ih0e, E, H, u0);
    for (int l = 0; l < NL; ++l) {
      load_gate_slice(smem + L.whh(l), L, w.w_hh[l], H, H, u0);
      if (l > 0) load_gate_slice(smem + L.wih(l), L, w.w_ih[l], H, H, u0);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < H * L.vc; i += blockDim.x) {
      const int j = i / L.vc;
      const int n = i - j * L.vc;
      s_ow[j * L.ldv + n] = n < nv ? w.out_w[static_cast<size_t>(j) * V + v0 + n] : 0.f;
    }
  }
  for (int i = threadIdx.x; i < L.n3; i += blockDim.x) {
    const int g = i / L.hc;
    const int col = g * H + u0 + i - g * L.hc;
    for (int l = 0; l < NL; ++l) {
      smem[L.bhh(l) + i] = w.b_hh[l][col];
      if (l > 0) smem[L.bih(l) + i] = w.b_ih[l][col];
    }
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
    if (t % dm.tpb == 0) {  // the beat's reset; nobody writes these buffers this tick
      for (int l = 0; l < NL; ++l) {
        copy_tile(smem + L.h + (2 * l + cur) * hbuf, L.ldh,
                  w.tick_h0 + ((static_cast<size_t>(beat) * NL + l) * B + row0) * H, H, RB, H,
                  nr);
      }
      cp_async_commit();
    }
    float gb3[3];  // the unit's gi_beat row
    load_gates(w.gi_beat + (static_cast<size_t>(beat) * B + row0 + me.r) * H3, H, u, me.row, gb3);
    cp_async_wait<0>();
    __syncthreads();

    for (int l = 0; l < NL; ++l) {
      const float* hc = smem + L.h + (2 * l + cur) * hbuf;  // h_{t-1}, read this tick
      float* hn = smem + L.h + (2 * l + (cur ^ 1)) * hbuf;  // h_t, written by every CTA
      // layer 0 takes the fed embedding, layer l > 0 the masked h_{l-1}
      const float* in = l == 0 ? s_pe : s_x + ((l - 1) & 1) * hbuf;
      const int ldin = l == 0 ? L.lde : L.ldh;
      const int kin = l == 0 ? E : H;
      const float* bi = l > 0 ? smem + L.bih(l) : nullptr;
      const float* bh = smem + L.bhh(l);
      // gi = in w_ih[:, own] (+ b_ih), gh = h w_hh[:, own] + b_hh
      auto ga_store = [&](int r, int n, float v) { s_ga[r * L.ldg + n] = l == 0 ? v : v + bi[n]; };
      auto gb_store = [&](int r, int n, float v) { s_gb[r * L.ldg + n] = v + bh[n]; };
      if (kStream) {
        const GateRows in_rows{l == 0 ? w.w_ih0e : w.w_ih[l], H, L.hc, u0, L.ldw};
        const GateRows h_rows{w.w_hh[l], H, L.hc, u0, L.ldw};
        streamed_times_w(in, ldin, RB, kin, L.n3, in_rows, stage, L.ldw, s_ga, L.ldg, part,
                         ga_store);
        streamed_times_w(hc, L.ldh, RB, H, L.n3, h_rows, stage, L.ldw, s_gb, L.ldg, part,
                         gb_store);
      } else if (lo) {
        rows_times_w(in, ldin, RB, kin, smem + (l == 0 ? L.w_ih0e : L.wih(l)), L.ldw, L.n3, part,
                     ga_store, half);
      } else {
        rows_times_w(hc, L.ldh, RB, H, smem + L.whh(l), L.ldw, L.n3, part_hi, gb_store, half);
      }
      __syncthreads();
      if (me.live) {
        const float* a = s_ga + me.r * L.ldg;
        const float* b = s_gb + me.r * L.ldg;
        const Gates G =
            l == 0 ? gru_gates(a[me.i] + gb3[0], a[L.hc + me.i] + gb3[1],
                               a[2 * L.hc + me.i] + gb3[2], b[me.i], b[L.hc + me.i],
                               b[2 * L.hc + me.i])
                   : gru_gates(a[me.i], a[L.hc + me.i], a[2 * L.hc + me.i], b[me.i],
                               b[L.hc + me.i], b[2 * L.hc + me.i]);
        const float h = gru_out(G, hc[me.r * L.ldh + u]);
        if (me.row) out.h_all[l][chain_index(dm, t, row0 + me.r, u, H)] = h;
        float* ph = hn + me.r * L.ldh + u;
        if (l + 1 < NL) {
          const float x = dm.dropout
                              ? h * dropout_mask(seed, t, l, row0 + me.r, u, dm.keep, dm.scale)
                              : h;
          float* px = s_x + (l & 1) * hbuf + me.r * L.ldh + u;
          for (int p = 0; p < C; ++p) {
            *cluster.map_shared_rank(ph, p) = h;
            *cluster.map_shared_rank(px, p) = x;
          }
        } else {
          for (int p = 0; p < C; ++p) *cluster.map_shared_rank(ph, p) = h;
        }
      }
      cluster.sync();
    }

    // head: the CTA's V slice of the relu logits, then the sampling scores
    const float* top = smem + L.h + (2 * (NL - 1) + (cur ^ 1)) * hbuf;
    auto lg_store = [&](int r, int n, float v) { s_lg[r * L.ldl + n] = v + s_ob[n]; };
    if (kStream) {
      streamed_times_w(top, L.ldh, RB, H, L.vc, VocabRows{w.out_w, V, v0, nv, L.vc, L.ldv}, stage,
                       L.ldv, s_lg, L.ldl, part, lg_store);
    } else {
      rows_times_w(top, L.ldh, RB, H, s_ow, L.ldv, L.vc, part, lg_store);
    }
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
      for (int l = 0; l < NL; ++l) out.h_all[l][chain_index(dm, t, row0 + me.r, u, H)] = 0.f;
    }
  }
  // no CTA may exit while a peer can still write into its shared memory:
  // the last writes precede the head's cluster barrier of tick T-1
}

// Refuses a forward plan the kernel cannot run: returns the shared-memory
// bytes it needs, or 0.
int fwd_checked_smem(int H, int E, int V, int C, int RB, int NL, bool stream, int smem_bytes) {
  if (C < 1 || C > 8 || (C & (C - 1)) != 0 || H < 1 || H % C != 0 || E < 1 || V < 1) return 0;
  if (NL < 1 || NL > kMaxLayers) return 0;
  if (RB < kRowsPerThread || RB % kRowsPerThread != 0 || RB * (H / C) > kThreads) return 0;
  const long long need = 4LL * fwd_layout(H, E, V, C, RB, NL, stream).total;
  if (need > kMaxSmem || smem_bytes < need || smem_bytes > kMaxSmem) return 0;
  return static_cast<int>(need);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
// The gradients hier_bwd_finish writes; the GEMMs write the others.
struct RowGrads {
  float* dgi_beat;  // (n_beats, B, 3H)
  float* dtick_h0;  // (n_beats, L, B, H)
  float* dx0;       // (B, E)
};

// The backward's scratch, carved from one buffer. Chain layout: R =
// ticks_per_beat * n_beats * B rows (tick in beat, beat * B + b); the
// chains' initial hiddens and their gradients have n_beats * B rows. The
// layers run one after the other from the top, so one layer's operands
// are kept at a time.
struct BwdScratch {
  int* tok;       // (R,) fed token, -1 at t = 0 and on padded ticks
  float* pe;      // (R, E) fed embedding
  float* dlog;    // (R, V) dlogits: dweights where the forward's logit > 0
  float* init;    // (L, n_beats * B, H) tick_h0[:, l]
  float* dinit;   // (L, n_beats * B, H)
  float* inter;   // (R, H) the layer's input after dropout (layers l >= 1)
  float* gi;      // (R, 3H) the layer's recomputed input-side gates
  float* dh;      // (R, H) the layer's incoming gradient
  float* dgi;     // (R, 3H)
  float* dgh;     // (R, 3H)
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
  s.dlog = take(R * dm.V);
  s.init = take(dm.L * bc * H);
  s.dinit = take(dm.L * bc * H);
  s.inter = take(R * H);
  s.gi = take(R * H3);
  s.dh = take(R * H);
  s.dgi = take(R * H3);
  s.dgh = take(R * H3);
  s.dpe = take(R * dm.E);
  s.floats = o;
  return s;
}

// The top layer's input after dropout: inter = h_prev * mask(gap).
__device__ __forceinline__ void masked_rows(const Dims& dm, uint32_t seed, int gap,
                                            const float* __restrict__ h_prev,
                                            float* __restrict__ inter, int i0, int stride) {
  const int R = dm.tpb * dm.beats() * dm.B;
  for (int i = i0; i < R * dm.H; i += stride) {
    const int m = i / dm.H;
    const int j = i - m * dm.H;
    const ChainRow cr = chain_row(dm, m);
    const float x = h_prev[i];
    inter[i] = dm.dropout ? x * dropout_mask(seed, cr.t, gap, cr.b, j, dm.keep, dm.scale) : x;
  }
}

// The chain operands the recompute needs: fed tokens and embeddings, the
// chains' initial hiddens, dlog = dweights where the forward's relu logit
// is > 0 (its own decision at the kink, not a recomputed one), and, with
// h_prev, the top layer's input (the dropout mask of gap L-2 replayed).
__global__ void hier_bwd_prep(Weights w, Dims dm, const int* __restrict__ seed_ptr,
                              const int* __restrict__ samples, const float* __restrict__ h_prev,
                              const float* __restrict__ weights,
                              const float* __restrict__ dweights, BwdScratch s) {
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const int B = dm.B, H = dm.H, E = dm.E, V = dm.V;
  const int bc = dm.beats() * B;
  const int R = dm.tpb * bc;
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (h_prev != nullptr) masked_rows(dm, seed, dm.L - 2, h_prev, s.inter, i0, stride);
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
    for (int l = 0; l < dm.L; ++l) {
      const size_t src = ((static_cast<size_t>(beat) * dm.L + l) * B + rem - beat * B) * H +
                         i - rem * H;
      s.init[static_cast<size_t>(l) * bc * H + i] = w.tick_h0[src];
    }
  }
}

// A lower layer's input after dropout (gap `gap`), for its recompute and
// its w_ih gradient.
__global__ void hier_bwd_inter(Dims dm, const int* __restrict__ seed_ptr, int gap,
                               const float* __restrict__ h_prev, float* __restrict__ inter) {
  masked_rows(dm, static_cast<uint32_t>(*seed_ptr), gap, h_prev, inter,
              blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
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

// dh = acc times the dropout mask of gap `gap` (0 on padded rows).
struct EpiMask {
  Dims dm;
  float* out;
  const int* seed;
  int gap;
  __device__ void operator()(int m, int n, float v) const {
    const ChainRow cr = chain_row(dm, m);
    if (dm.dropout) {
      v *= dropout_mask(static_cast<uint32_t>(*seed), cr.t, gap, cr.b, n, dm.keep, dm.scale);
    }
    out[static_cast<size_t>(m) * dm.H + n] = cr.live ? v : 0.f;
  }
};

// The gradients of one row each: dgi_beat (a beat's dgi_0 summed in tick
// order), dx0 (dpe at t = 0), dtick_h0 (the chains' dh0, every layer).
__global__ void hier_bwd_finish(Dims dm, BwdScratch s, RowGrads g) {
  const int B = dm.B, H = dm.H, E = dm.E, H3 = 3 * dm.H;
  const int bc = dm.beats() * B;
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = i0; i < bc * H3; i += stride) {
    float acc = 0.f;
    for (int k = 0; k < dm.tpb; ++k) acc += s.dgi[static_cast<size_t>(k) * bc * H3 + i];
    g.dgi_beat[i] = acc;
  }
  for (int i = i0; i < B * E; i += stride) g.dx0[i] = s.dpe[i];
  for (int i = i0; i < bc * H; i += stride) {
    const int rem = i / H;
    const int beat = rem / B;
    for (int l = 0; l < dm.L; ++l) {
      const size_t o = ((static_cast<size_t>(beat) * dm.L + l) * B + rem - beat * B) * H +
                       i - rem * H;
      g.dtick_h0[o] = s.dinit[static_cast<size_t>(l) * bc * H + i];
    }
  }
}

// The float operands as the entries take them: the layers' matrices as
// host arrays of kMaxLayers pointers (entries past L unused).
Weights make_weights(const float* gi_beat, const float* tick_h0, const float* x0,
                     const float* emb, const float* w_ih0e, const float* const* w_hh,
                     const float* const* b_hh, const float* const* w_ih,
                     const float* const* b_ih, const float* out_w, const float* out_b, int NL) {
  Weights w = {};
  w.gi_beat = gi_beat;
  w.tick_h0 = tick_h0;
  w.x0 = x0;
  w.emb = emb;
  w.w_ih0e = w_ih0e;
  for (int l = 0; l < NL; ++l) {
    w.w_hh[l] = w_hh[l];
    w.b_hh[l] = b_hh[l];
    w.w_ih[l] = l > 0 ? w_ih[l] : nullptr;
    w.b_ih[l] = l > 0 ? b_ih[l] : nullptr;
  }
  w.out_w = out_w;
  w.out_b = out_b;
  return w;
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

// Floats of shared memory a CTA of the forward plan (C, RB) needs for a
// tick GRU of L layers, resident (stream 0) or streamed: the layout that
// ops/hier_decoder_kernel.py::fwd_smem_floats mirrors.
int hier_tick_chain_smem_floats(int H, int E, int V, int C, int RB, int L, int stream) {
  return fwd_layout(H, E, V, C, RB, L, stream != 0).total;
}

// Clusters of C CTAs of the forward in the resident (stream 0) or
// streamed layout, smem_bytes of dynamic shared memory each, that the card
// can hold at once (cudaOccupancyMaxActiveClusters); a negative CUDA error
// code when the query fails.
int hier_tick_chain_resident_clusters(int stream, int C, int smem_bytes) {
  return stream != 0 ? resident_clusters(hier_fwd<true>, C, smem_bytes)
                     : resident_clusters(hier_fwd<false>, C, smem_bytes);
}

// Floats of the backward's scratch before the GEMMs' partial sums.
long long hier_tick_chain_bwd_scratch_floats(int T, int B, int H, int E, int V,
                                              int ticks_per_beat, int L) {
  const Dims dm{T, B, H, E, V, ticks_per_beat, L, 0, 1.f, 1.f, 0};
  return carve(dm, nullptr).floats;
}

// teacher, seed: (1,) i32 on the device; score (T, B) i32; the float
// operands as in struct Weights, the layers' as host arrays of kMaxLayers
// pointers; the plan: clusters of C CTAs of RB rows, smem_bytes of dynamic
// shared memory each, the weights resident (streamed 0) or streamed.
// Writes weights (T, B, V), samples (T, B) i32 and the L layers' hiddens
// h_all[l] (ticks_per_beat, n_beats * B, H).
int hier_tick_chain_fwd(const int* teacher, const int* seed, const int* score,
                        const float* gi_beat, const float* tick_h0, const float* x0,
                        const float* emb, const float* w_ih0e, const float* const* w_hh,
                        const float* const* b_hh, const float* const* w_ih,
                        const float* const* b_ih, const float* out_w, const float* out_b, int T,
                        int B, int H, int E, int V, int L, int ticks_per_beat, int dropout,
                        float keep, float scale, int multinomial, int C, int RB, int smem_bytes,
                        int streamed, float* weights, int* samples, float* const* h_all,
                        void* stream) {
  if (fwd_checked_smem(H, E, V, C, RB, L, streamed != 0, smem_bytes) == 0 || T < 1 || B < 1 ||
      ticks_per_beat < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Weights w =
      make_weights(gi_beat, tick_h0, x0, emb, w_ih0e, w_hh, b_hh, w_ih, b_ih, out_w, out_b, L);
  const Dims dm{T, B, H, E, V, ticks_per_beat, L, dropout, keep, scale, multinomial};
  FwdOut out = {};
  out.weights = weights;
  out.samples = samples;
  for (int l = 0; l < L; ++l) out.h_all[l] = h_all[l];
  const dim3 grid(C * ((B + RB - 1) / RB));
  auto* kernel = streamed != 0 ? &hier_fwd<true> : &hier_fwd<false>;
  return static_cast<int>(launch_cluster(kernel, C, grid, smem_bytes,
                                         static_cast<cudaStream_t>(stream), w, dm, RB, teacher,
                                         seed, score, out));
}

// The backward. h_all: the forward's L saved hiddens; the gradient
// outputs in the order of the float operands, the layers' as host arrays of
// kMaxLayers pointers; chain_C, chain_RB, chain_smem, chain_streamed:
// gru_plan's plan of the chain backward on n_beats * B rows; scratch:
// hier_tick_chain_bwd_scratch_floats floats, then the GEMMs' partial sums;
// splits: the split of the terms of each of the 2L + 2 weight-gradient
// GEMMs, in the order they run below (ops/hier_decoder_kernel.py::
// gemm_shapes).
int hier_tick_chain_bwd(const int* seed, const int* samples, const float* const* h_all,
                        const float* weights, const float* dweights, const float* gi_beat,
                        const float* tick_h0, const float* x0, const float* emb,
                        const float* w_ih0e, const float* const* w_hh, const float* const* b_hh,
                        const float* const* w_ih, const float* const* b_ih, const float* out_w,
                        const float* out_b, int T, int B, int H, int E, int V, int L,
                        int ticks_per_beat, int dropout, float keep, float scale, int chain_C,
                        int chain_RB, int chain_smem, int chain_streamed, float* dgi_beat,
                        float* dtick_h0, float* dx0, float* demb, float* dw_ih0e,
                        float* const* dw_hh, float* const* db_hh, float* const* dw_ih,
                        float* const* db_ih, float* dout_w, float* dout_b, float* scratch,
                        const int* splits, void* stream) {
  const Dims dm{T, B, H, E, V, ticks_per_beat, L, dropout, keep, scale, 0};
  if (T < 1 || B < 1 || ticks_per_beat < 1 || L < 1 || L > kMaxLayers ||
      chain_checked_smem(true, H, chain_C, chain_RB, chain_smem, chain_streamed != 0) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bc = dm.beats() * B;
  const long long rows = static_cast<long long>(ticks_per_beat) * bc;
  if (rows * std::max(3 * H, std::max(V, E)) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);  // 32-bit element indices
  }
  const int R = static_cast<int>(rows), H3 = 3 * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w =
      make_weights(gi_beat, tick_h0, x0, emb, w_ih0e, w_hh, b_hh, w_ih, b_ih, out_w, out_b, L);
  const BwdScratch s = carve(dm, scratch);
  float* red = scratch + s.floats;
  auto* chain = chain_streamed != 0 ? &gru_bwd<true> : &gru_bwd<false>;
  const dim3 chain_grid(chain_C * ((bc + chain_RB - 1) / chain_RB));

  // the GEMMs' operands: a dense chain operand, and a layer's h_{t-1}
  // (its saved hiddens one tick back, the chain's initial hidden at the
  // first tick of a beat)
  const long long h = H, h3 = H3;
  auto dense = [&](const float* p, long long width) {
    return Operand{p, nullptr, 0, static_cast<long long>(bc) * width, width, 1, 0};
  };
  auto prev = [&](const float* all, const float* init) {
    return Operand{all, init, 0, static_cast<long long>(bc) * h, h, ticks_per_beat, 0};
  };
  int job = 0;  // the next GEMM, in the order of splits
  auto atb = [&](const Operand& a, const int* tokens, int m, const Operand& x, int n, float* out,
                 float* bias) {
    return launch_atb(a, tokens, 0, m, x, n, ticks_per_beat, bc, 1, splits[job++], out, bias,
                      red, st);
  };

  hier_bwd_prep<<<elementwise_blocks(rows * std::max(H, V)), 256, 0, st>>>(
      w, dm, seed, samples, L > 1 ? h_all[L - 2] : nullptr, weights, dweights, s);
  cudaError_t err = cudaGetLastError();
  // the head's gradient into the top layer
  if (err == cudaSuccess) {
    err = launch_row_gemm<true>(s.dlog, V, out_w, V, R, V, H, EpiStore{s.dh, H}, st);
  }
  for (int l = L - 1; l >= 0 && err == cudaSuccess; --l) {
    const float* init = s.init + static_cast<size_t>(l) * bc * H;
    // the layer's input after dropout (the top layer's came with prep)
    if (l > 0 && l < L - 1) {
      hier_bwd_inter<<<elementwise_blocks(rows * H), 256, 0, st>>>(dm, seed, l - 1, h_all[l - 1],
                                                                   s.inter);
      err = cudaGetLastError();
    }
    // its recomputed input-side gates, over all rows at once
    if (err == cudaSuccess) {
      err = l > 0 ? launch_row_gemm<false>(s.inter, H, w_ih[l], H3, R, H, H3,
                                           EpiGates{dm, s.gi, b_ih[l], nullptr}, st)
                  : launch_row_gemm<false>(s.pe, E, w_ih0e, H3, R, E, H3,
                                           EpiGates{dm, s.gi, nullptr, gi_beat}, st);
    }
    // its chains, one a beat
    if (err == cudaSuccess) {
      err = launch_cluster(chain, chain_C, chain_grid, chain_smem, st, s.gi, w_hh[l], b_hh[l],
                           init, h_all[l], s.dh, ticks_per_beat, 1, bc, H, chain_RB, s.dgi,
                           s.dinit + static_cast<size_t>(l) * bc * H, s.dgh);
    }
    // the gradient of its input: the layer below's (through the dropout
    // mask), or the fed embedding's
    if (err == cudaSuccess) {
      err = l > 0 ? launch_row_gemm<true>(s.dgi, H3, w_ih[l], H3, R, H3, H,
                                          EpiMask{dm, s.dh, seed, l - 1}, st)
                  : launch_row_gemm<true>(s.dgi, H3, w_ih0e, H3, R, H3, E, EpiStore{s.dpe, E},
                                          st);
    }
    // its weight gradients: fixed-order sums over the chain rows (padded
    // ticks add exact zeros)
    if (err == cudaSuccess && l > 0) {
      err = atb(dense(s.inter, h), nullptr, H, dense(s.dgi, h3), H3, dw_ih[l], db_ih[l]);
    }
    if (err == cudaSuccess) {
      err = atb(prev(h_all[l], init), nullptr, H, dense(s.dgh, h3), H3, dw_hh[l], db_hh[l]);
    }
    if (err == cudaSuccess && l == 0) {
      err = atb(dense(s.pe, E), nullptr, E, dense(s.dgi, h3), H3, dw_ih0e, nullptr);
    }
  }
  // the gradients of one row each, from layer 0's dgi and dpe
  const RowGrads g{dgi_beat, dtick_h0, dx0};
  if (err == cudaSuccess) {
    hier_bwd_finish<<<elementwise_blocks(static_cast<long long>(bc) * H3), 256, 0, st>>>(dm, s,
                                                                                          g);
    err = cudaGetLastError();
  }
  // the embedding's (one-hot of the fed token; -1: none, at t = 0 and on
  // padded ticks) and the head's
  if (err == cudaSuccess) err = atb(dense(nullptr, V), s.tok, V, dense(s.dpe, E), E, demb, nullptr);
  if (err == cudaSuccess) {
    err = atb(dense(h_all[L - 1], h), nullptr, H, dense(s.dlog, V), V, dout_w, dout_b);
  }
  return static_cast<int>(err);
}

}  // extern "C"
