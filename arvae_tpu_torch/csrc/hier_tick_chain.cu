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
// Forward. What bounds it: a T-step chain of dependent products (L GRU
// layers of (rows x H) @ (H x 3H) and the (rows x H) @ (H x V) head) with
// an argmax and a gather between steps: each tick's argmax feeds the
// next, so the chain is sequential and every tick pays its products'
// latency and the exchange of its hiddens. Two layouts, by the plan
// (arvae_tpu_torch/ops/hier_decoder_kernel.py::hier_plan, which mirrors
// fwd_layout and wave_layout below term for term; the entry refuses a
// plan that does not fit).
//
// Resident (hier_fwd), where a cluster of at most 8 CTAs holds the
// weights (H = 128 at L <= 3): a thread-block cluster of C CTAs owns a
// tile of RB batch rows for the whole measure. CTA c holds in shared
// memory, loaded once, the gate columns of its H/C hidden units of w_ih0e
// and of every layer's w_hh and w_ih, its ceil(V/C) columns of out_w and
// out_b, and a full copy of emb for the gather (about 182 KB at H = 128,
// V = 130, C = 4, L = 2). A tick has L + 1 cluster barriers: one a layer
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
// Wave (hier_wave_fwd), every other shape: the weights (9.76 MB at
// H = 512, L = 2; 22.5 MB at L = 4) fit no cluster (at most 16 CTAs, 3.6
// MB of shared memory) but fit the card's 132 SMs. One cooperative wave of
// persistent CTAs of 256 threads (gru_wide.cuh's launch_wide: the runtime
// refuses a grid the card cannot hold at once), at most one an SM. CTA
// (unit group g, row group q) owns the U hidden units [g U, (g + 1) U) of
// the R batch rows of row group q and holds in shared memory, read from
// device memory once a call, its units' gate columns of w_ih0e and of the
// 2L - 1 H x 3H matrices, and a slice of Vc columns of out_w and out_b
// (V in nh slices, each on G / nh CTAs of a row group, a share of its
// rows each). At (B, H, V, L) = (256, 512, 130, 2): U = 8, so 64 unit
// groups x 2 row groups of 128 rows = 128 CTAs, 3 x 512 x 24 floats =
// 147 KB of slices (U = 16 would be 295 KB), 17 slices of 8 columns on 3
// CTAs of 43 rows each, 225,728 B of shared memory a CTA. Each CTA multiplies all of its rows
// (in passes of P rows) by its slices on the tensor cores in 3xTF32
// (gru_wide.cuh's wide_product: the operand's rows streamed from L2 in
// chunks through three buffers, each weight float loaded from shared
// memory serving the whole pass), each warp a 16-row m-tile of one 8-unit
// tile's three gates, so that the warp holds gi and gh of its cells in
// registers for the cell math; where a pass has fewer items than warps,
// the depth is split over KS warps and added in split order. Hiddens are
// exchanged through L2: a CTA writes its cells of h_l to the saved
// h_all (and, with dropout, the masked copy the next layer reads) and the
// row group meets at a barrier (group_sync, one counter a row group; row
// groups never exchange). A tick has L + 1 barriers: one a layer, and one
// after the head, whose CTAs write per-row partials (max, lowest index;
// NaN -> (NaN, V)) of their V slice's scores (after the Gumbel noise in
// multinomial mode), each combined from the slice's 8-column tiles; every
// CTA of the row group then combines all nh partials alike (a commutative
// combine, so one token whatever the order), selects the teacher's token,
// clamps, and gathers the next tick's fed embedding from emb by token.
// The argmax is taken over exactly the floats written to weights. For a
// caller that trains where the backward's chains take the wide layout
// (H = 384, 512), each CTA also writes the hidden-side pre-activations of
// its cells, gh_t = h_{t-1} w_hh + b_hh (the floats its gate math took),
// to a (ticks_per_beat, n_beats * B, 3H) buffer a layer, with zeros on
// the padded ticks, which the backward's wide chains read. Every
// output sums in a fixed order, so a repeat is bitwise equal.
//
// Backward. The only dependence between ticks is the L hidden-gradient
// carries, and they restart at every beat (routed to dtick_h0); tokens
// carry no gradient. So it is n_beats independent chains of
// ticks_per_beat ticks a layer. Everything that does not touch a carry
// runs over all T x B rows at once through the row products of
// tc_gemm.cuh's 3xTF32 tensor-core engine: the recomputed gi_l, dlog @
// out_w^T, dgi_l @ w_ih_l^T (masked by gap l-1's dropout) and dgi_0 @
// w_ih0e^T; the ReLU's mask is the forward's own (weights > 0), so the
// backward agrees with it at the kink. The layers run from the top down:
// each layer's chain is the GRU chain's backward (the cluster kernel of
// gru_cluster.cuh where its slices fit, which recomputes its gates step by
// step, else the wide layout of gru_wide.cuh, from the wave forward's kept
// hidden-side gates; as gru_plan gives it) over ticks_per_beat steps on
// n_beats x B rows, followed by its weight gradients. Chain operands use
// the layout (tick in beat, beat * B + b);
// the forward saves the hiddens in it, with zero rows for the padded
// ticks of a short last beat (T not a multiple of ticks_per_beat), whose
// gi and douts are zero too. The 2L + 2 weight and embedding gradients go
// through the engine's A^T X GEMM. All of it launches from the
// one C entry, in a fixed order on one stream; no float atomics, so
// repeats are bitwise equal.
//
// Random bits: a counter-based 32-bit hash of (seed, t, salt, row, col),
// indexed by the global batch row (row_base + the call's row: a rank of a
// data-parallel step holds rows row_base.. of the global batch, and draws
// what one card draws for them) and column, salt l for the dropout of
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
#include "gru_wide.cuh"

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
  int row_base;            // the global batch row of the call's row 0 (random bits)

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
  float* gh[kMaxLayers];        // (tpb, n_beats * B, 3H) each, or null: the wave layout's kept gh
};

// ---------------------------------------------------------------------------
// Forward, resident layout: one cluster a tile of rows
// ---------------------------------------------------------------------------

// Shared-memory layout of one CTA of the resident forward, in floats;
// every array starts on a 16-byte boundary. ops/hier_decoder_kernel.py::
// fwd_smem_floats mirrors it term for term.
struct FwdLayout {
  int hc, n3, vc;  // hidden units, gate columns, vocabulary columns owned
  int ldw, ldv, ldh, ldg, lde, ldl;
  int wsz;         // floats of one resident H x 3H slice
  int w_ih0e;      // w_ih0e's slice
  int wl;          // the layers' slices, w_hh_0, then w_ih_l, w_hh_l for l >= 1
  int out_w;       // out_w's slice
  int bl;          // bias slices: b_hh_0, then b_ih_l, b_hh_l for l >= 1
  int out_b, emb;  // out_b's slice, the whole table
  int h;           // hiddens of the tile: layer l's 2 buffers from h + 2 l RB ldh
  int x;           // the next layer's input: 1 buffer at L = 2, 2 by layer parity at L > 2
  int pe, ga, gb, lg;  // fed embedding, gates (input and hidden side), logits
  int part, part_hi;   // partial sums: the head's; a layer's two halves
  int pm, pi, tok;     // argmax partials [source CTA][row], fed tokens
  int total;

  __host__ __device__ int whh(int l) const { return wl + 2 * l * wsz; }
  __host__ __device__ int wih(int l) const { return wl + (2 * l - 1) * wsz; }
  __host__ __device__ int bhh(int l) const { return bl + 2 * l * ldg; }
  __host__ __device__ int bih(int l) const { return bl + (2 * l - 1) * ldg; }
};

__host__ __device__ inline FwdLayout fwd_layout(int H, int E, int V, int C, int RB, int NL) {
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
  take(L.w_ih0e, E * L.ldw);
  take(L.wl, (2 * NL - 1) * L.wsz);
  take(L.out_w, H * L.ldv);
  take(L.bl, (2 * NL - 1) * L.ldg);
  take(L.out_b, L.ldl);
  take(L.emb, up4(V * E));
  take(L.h, NL * 2 * RB * L.ldh);
  take(L.x, min(NL - 1, 2) * RB * L.ldh);
  take(L.pe, RB * L.lde);
  take(L.ga, RB * L.ldg);
  take(L.gb, RB * L.ldg);
  take(L.lg, RB * L.ldl);
  // a layer's two products run at once, each on half the block with its
  // own half of the scratch; the head on the whole
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
  load_gate_rows(dst, L.ldw, w, H, L.hc, u0, 0, K);
}

__global__ void __launch_bounds__(kThreads)
hier_fwd(Weights w, Dims dm, int RB, const int* __restrict__ teacher_ptr,
         const int* __restrict__ seed_ptr, const int* __restrict__ score, FwdOut out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int T = dm.T, B = dm.B, H = dm.H, E = dm.E, V = dm.V, NL = dm.L, H3 = 3 * H;
  const FwdLayout L = fwd_layout(H, E, V, C, RB, NL);
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
  // each layer's two products run at once on the two halves of the block
  const bool lo = threadIdx.x < kThreads / 2;
  const ThreadGroup half = lo ? ThreadGroup{0, kThreads / 2, 1}
                              : ThreadGroup{kThreads / 2, kThreads / 2, 2};

  // the weight slices, once for the whole measure
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
      if (lo) {
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
          const float x =
              dm.dropout
                  ? h * dropout_mask(seed, t, l, dm.row_base + row0 + me.r, u, dm.keep, dm.scale)
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
    rows_times_w(top, L.ldh, RB, H, s_ow, L.ldv, L.vc, part, lg_store);
    __syncthreads();
    for (int i = threadIdx.x; i < RB * L.vc; i += blockDim.x) {
      const int r = i / L.vc;
      const int n = i - r * L.vc;
      if (n >= nv) continue;
      const float x = s_lg[r * L.ldl + n];
      const float l = x < 0.f ? 0.f : x;  // relu, NaN passes through
      if (r < nr) out.weights[(static_cast<size_t>(t) * B + row0 + r) * V + v0 + n] = l;
      s_lg[r * L.ldl + n] =
          dm.multinomial
              ? l - logf(-logf(uniform01(seed, t, kSaltGumbel, dm.row_base + row0 + r, v0 + n)))
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

// Refuses a resident forward plan the kernel cannot run: returns the
// shared-memory bytes it needs, or 0.
int fwd_checked_smem(int H, int E, int V, int C, int RB, int NL, int smem_bytes) {
  if (C < 1 || C > 8 || (C & (C - 1)) != 0 || H < 1 || H % C != 0 || E < 1 || V < 1) return 0;
  if (NL < 1 || NL > kMaxLayers) return 0;
  if (RB < kRowsPerThread || RB % kRowsPerThread != 0 || RB * (H / C) > kThreads) return 0;
  const long long need = 4LL * fwd_layout(H, E, V, C, RB, NL).total;
  if (need > kMaxSmem || smem_bytes < need || smem_bytes > kMaxSmem) return 0;
  return static_cast<int>(need);
}

// ---------------------------------------------------------------------------
// Forward, wave layout: one cooperative wave of CTAs a call
// ---------------------------------------------------------------------------

// The row-combinable partial of an argmax: the max (NaN if any score is
// NaN) and the lowest index holding it (V for NaN). combine() is
// commutative and associative, so every CTA that combines the same
// partials gets the same token whatever their order;
// ops/hier_decoder_kernel.py::argmax_by_slices mirrors it.
__device__ __forceinline__ void argmax_combine(float& m, int& idx, float m2, int i2) {
  if (m != m) return;  // NaN already: stays (NaN, V)
  if (m2 != m2 || m2 > m) {
    m = m2;
    idx = i2;
  } else if (m2 == m) {
    idx = min(idx, i2);
  }
}

// Depth splits at most of a wave product (KS), the template instances.
constexpr int kWaveMaxSplits = 4;

// Shared-memory layout of one CTA of the wave forward, in floats. A CTA
// owns U hidden units (unit tiles of 8: UT = max(1, U / 8); at U = 4 the
// tile's columns past U are not the CTA's, their outputs unused) of a row
// group of R rows, which it multiplies in passes of P rows; each slice is
// stored column by column (ws[c * ld + k] = W[k, gate(c) H + u0 + unit(c)],
// c = gate U + unit), zeros past the depth, ld = the depth in whole chunks
// + 4 (4 mod 32: conflict-free fragment loads). A gate product's warp
// items are (m-tile of 16 rows, unit tile) pairs, items = P / 16 * UT <= 8;
// the depth is split over KS = min(4, 8 / items) warps an item. The head:
// V in nh slices of Vc columns (whole n-tiles of 8, VT of them), each on
// G / nh CTAs of the row group, a share of its rows each.
// ops/hier_decoder_kernel.py::wave_smem_floats mirrors it term for term.
struct WaveLayout {
  int U, UT, P, items, KS;
  int G, Vc, VT, nh;
  int kh, ldk, ke, lde;  // the depths H and E in whole chunks; the slices' leading dimensions
  int w_ih0e, wl, out_w, bl, out_b;
  int xs;      // the chunk buffers (kWideStages x P x kWideLd); the depth splits' partial sums
  int pm, pi;  // the head's per-row partials by n-tile (P x VT each)
  int tok;     // the row group's fed tokens
  int total;

  __host__ __device__ int wsz() const { return 3 * U * ldk; }
  __host__ __device__ int whh(int l) const { return wl + 2 * l * wsz(); }
  __host__ __device__ int wih(int l) const { return wl + (2 * l - 1) * wsz(); }
  __host__ __device__ int bhh(int l) const { return bl + 2 * l * up4(3 * U); }
  __host__ __device__ int bih(int l) const { return bl + (2 * l - 1) * up4(3 * U); }
};

__host__ __device__ inline int chunks_of(int K) {
  return (K + kWideDepth - 1) / kWideDepth * kWideDepth;
}

// The head's slices of V over the G = H / U unit groups: Vc columns each
// (whole n-tiles of 8), nh of them.
__host__ __device__ inline void wave_head(int H, int V, int U, int& Vc, int& nh) {
  const int G = H / U;
  Vc = ((V + G - 1) / G + 7) / 8 * 8;
  nh = (V + Vc - 1) / Vc;
}

__host__ __device__ inline WaveLayout wave_layout(int H, int E, int V, int NL, int U, int R,
                                                  int P) {
  WaveLayout L;
  L.U = U;
  L.UT = U < 8 ? 1 : U / 8;
  L.P = P;
  L.items = P / 16 * L.UT;
  L.KS = min(kWaveMaxSplits, 8 / L.items);
  L.G = H / U;
  wave_head(H, V, U, L.Vc, L.nh);
  L.VT = L.Vc / 8;
  L.kh = chunks_of(H);
  L.ldk = L.kh + 4;
  L.ke = chunks_of(E);
  L.lde = L.ke + 4;
  int o = 0;
  auto take = [&](int& at, int n) {
    at = o;
    o += n;
  };
  take(L.w_ih0e, 3 * U * L.lde);
  take(L.wl, (2 * NL - 1) * L.wsz());
  take(L.out_w, L.Vc * L.ldk);
  take(L.bl, (2 * NL - 1) * up4(3 * U));
  take(L.out_b, L.Vc);
  take(L.xs, max(kWideStages * P * kWideLd, (L.KS - 1) * L.items * 12 * 32));
  take(L.pm, up4(P * L.VT));
  take(L.pi, up4(P * L.VT));
  take(L.tok, up4(R));
  L.total = o;
  return L;
}

// The wave forward's scratch in device memory: the row groups' barrier
// counters, the head's partials [V slice][row] and, with dropout,
// the masked inputs of layers 1 .. L-1 [gap][row][unit].
struct WaveScratch {
  unsigned* bar;
  float* pm;
  int* pi;
  float* x;
  long long floats;
};

WaveScratch wave_scratch(int B, int H, int V, int NL, int U, int R, float* base) {
  int Vc, nh;
  wave_head(H, V, U, Vc, nh);
  WaveScratch s;
  long long o = 0;
  auto take = [&](long long n) {
    float* p = base != nullptr ? base + o : nullptr;
    o += (n + 3) & ~3LL;
    return p;
  };
  s.bar = reinterpret_cast<unsigned*>(take((B + R - 1) / R));
  s.pm = take(static_cast<long long>(nh) * B);
  s.pi = reinterpret_cast<int*>(take(static_cast<long long>(nh) * B));
  s.x = take(static_cast<long long>(NL - 1) * B * H);
  s.floats = o;
  return s;
}

// The CTA's gate columns of a (K, 3H) weight into ws (column by column,
// zeros past K up to kpad), with cp.async.
__device__ __forceinline__ void load_wave_slice(float* ws, int ld, const float* w, int K, int kpad,
                                                int H, int U, int u0) {
  const int n3 = 3 * U;
  for (int idx = threadIdx.x; idx < n3 * kpad; idx += blockDim.x) {
    const int k = idx / n3;
    const int c = idx - k * n3;
    const int gate = c / U;
    const bool in = k < K;
    const float* from = w + static_cast<size_t>(k) * 3 * H + gate * H + u0 + c - gate * U;
    cp_async4(ws + c * ld + k, in ? from : w, in);
  }
}

template <int KS>
__global__ void __launch_bounds__(kWideThreads, 1)
hier_wave_fwd(Weights w, Dims dm, int U, int R, int P, const int* __restrict__ teacher_ptr,
              const int* __restrict__ seed_ptr, const int* __restrict__ score, FwdOut out,
              WaveScratch s) {
  extern __shared__ __align__(16) float smem[];
  const int T = dm.T, B = dm.B, H = dm.H, E = dm.E, V = dm.V, NL = dm.L, H3 = 3 * H;
  const WaveLayout L = wave_layout(H, E, V, NL, U, R, P);
  const int Q = (B + R - 1) / R;
  const int q = blockIdx.x % Q;
  const int grp = blockIdx.x / Q;
  const int u0 = grp * U;
  const int row0 = q * R;
  const int nrows = min(R, B - row0);
  // the head: V slice grp % nh, on its share grp / nh of the row group's
  // rows (each slice spread over S = G / nh CTAs)
  const int shares = max(1, L.G / L.nh);
  const bool head = grp < L.nh * shares;
  const int vs = grp % L.nh;
  const int v0 = vs * L.Vc;
  const int nv = max(0, min(L.Vc, V - v0));
  const int share = (nrows + shares - 1) / shares;
  const int hrow0 = row0 + min(nrows, grp / L.nh * share);
  const int hrows = min(share, row0 + nrows - hrow0);
  float* xs = smem + L.xs;
  float* s_pm = smem + L.pm;
  int* s_pi = reinterpret_cast<int*>(smem + L.pi);
  int* s_tok = reinterpret_cast<int*>(smem + L.tok);
  const float* s_ob = smem + L.out_b;
  const bool teacher = *teacher_ptr != 0;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  unsigned* bar = s.bar + q;
  unsigned passed = 0;  // the row group's barriers so far

  // the weight slices, once for the whole call
  load_wave_slice(smem + L.w_ih0e, L.lde, w.w_ih0e, E, L.ke, H, U, u0);
  for (int l = 0; l < NL; ++l) {
    load_wave_slice(smem + L.whh(l), L.ldk, w.w_hh[l], H, L.kh, H, U, u0);
    if (l > 0) load_wave_slice(smem + L.wih(l), L.ldk, w.w_ih[l], H, L.kh, H, U, u0);
  }
  for (int idx = threadIdx.x; idx < L.Vc * L.kh; idx += blockDim.x) {
    const int k = idx / L.Vc;
    const int c = idx - k * L.Vc;
    const bool in = k < H && c < nv;
    cp_async4(smem + L.out_w + c * L.ldk + k,
              in ? w.out_w + static_cast<size_t>(k) * V + v0 + c : w.out_w, in);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 3 * U; i += blockDim.x) {
    const int gate = i / U;
    const int col = gate * H + u0 + i - gate * U;
    for (int l = 0; l < NL; ++l) {
      smem[L.bhh(l) + i] = w.b_hh[l][col];
      if (l > 0) smem[L.bih(l) + i] = w.b_ih[l][col];
    }
  }
  for (int i = threadIdx.x; i < L.Vc; i += blockDim.x) {
    smem[L.out_b + i] = i < nv ? w.out_b[v0 + i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps of a gate product: item (m-tile, unit tile), depth split ks
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int ks = warp % KS, item = warp / KS;
  const bool worker = item < L.items;
  const int mrow = worker ? 16 * (item / L.UT) : P;  // P: no rows, the warp idles
  const int ut = item % L.UT;
  // a dense operand's rows [r0, r0 + nr) (row stride H) in chunks
  auto dense = [&](const float* src, int r0, int nr) {
    return [=](float* dst, int k0) {
      wide_chunk(dst, src + static_cast<size_t>(r0) * H, H, P, nr, H, k0, true);
    };
  };
  // acc = the operand's rows times the CTA's slice of a matrix: the
  // three gates of the warp's unit tile, the depth splits added in order
  auto gate_product = [&](float (*acc)[3][4], const float* ws, int ld, int kpad, auto load,
                          int nr) {
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[0][n][c] = 0.f;
    wide_product<1, 3, KS>(acc, ws, ld, kpad, xs, P, mrow, ks, nr, load,
                           [&](int n) { return n * U + 8 * ut; });
    if (KS > 1) {
      // split k > 0 hands its sums over through the freed chunk buffers,
      // [k - 1][item][e][lane]; split 0 adds them in the order k = 1, 2, ...
      if (worker && ks > 0) {
#pragma unroll
        for (int e = 0; e < 12; ++e) {
          xs[(((ks - 1) * L.items + item) * 12 + e) * 32 + lane] = acc[0][e >> 2][e & 3];
        }
      }
      __syncthreads();
      if (worker && ks == 0) {
        for (int k = 1; k < KS; ++k) {
#pragma unroll
          for (int e = 0; e < 12; ++e) {
            acc[0][e >> 2][e & 3] += xs[(((k - 1) * L.items + item) * 12 + e) * 32 + lane];
          }
        }
      }
      __syncthreads();  // the buffers are the next product's
    }
  };

  for (int t = 0; t < T; ++t) {
    const int beat = t / dm.tpb;
    const bool reset = t % dm.tpb == 0;
    for (int l = 0; l < NL; ++l) {
      // h_{t-1} of the layer (the beat's tick_h0 at a reset), h_t's rows
      // in the saved hiddens, and the layer's input: the masked copy of
      // h_{l-1} with dropout, else h_{l-1} itself
      const float* hprev = reset ? w.tick_h0 + (static_cast<size_t>(beat) * NL + l) * B * H
                                 : out.h_all[l] + chain_index(dm, t - 1, 0, 0, H);
      float* hnew = out.h_all[l] + chain_index(dm, t, 0, 0, H);
      const float* xin = l == 0 ? nullptr
                         : dm.dropout ? s.x + static_cast<size_t>(l - 1) * B * H
                                      : out.h_all[l - 1] + chain_index(dm, t, 0, 0, H);
      const float* bi = l > 0 ? smem + L.bih(l) : nullptr;
      const float* bh = smem + L.bhh(l);
      for (int r0 = row0; r0 < row0 + nrows; r0 += P) {
        const int nr = min(P, row0 + nrows - r0);
        // the cells' h_{t-1} and (layer 0) gi_beat, in flight during the products
        float hp[4], gb[3][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = mrow + g8 + 8 * (c >> 1);
          const int j = 8 * ut + 2 * t4 + (c & 1);
          const bool live = worker && ks == 0 && r < nr && j < U;
          const size_t row = r0 + r;
          hp[c] = live ? __ldcg(hprev + row * H + u0 + j) : 0.f;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            gb[g][c] = live && l == 0
                           ? __ldg(w.gi_beat + (static_cast<size_t>(beat) * B + row) * H3 + g * H +
                                   u0 + j)
                           : 0.f;
          }
        }
        float gi[1][3][4], gh[1][3][4];
        if (l == 0) {
          // the fed embedding (x0 at t = 0), gathered by token into the chunks
          gate_product(gi, smem + L.w_ih0e, L.lde, L.ke, [&](float* dst, int k0) {
            for (int idx = threadIdx.x; idx < P * kWideDepth; idx += kWideThreads) {
              const int r = idx / kWideDepth;
              const int c = idx - r * kWideDepth;
              const int k = k0 + c;
              const bool in = r < nr && k < E;
              cp_async4(dst + r * kWideLd + c,
                        !in      ? w.emb
                        : t == 0 ? w.x0 + static_cast<size_t>(r0 + r) * E + k
                                 : w.emb + static_cast<size_t>(s_tok[r0 - row0 + r]) * E + k,
                        in);
            }
          }, nr);
        } else {
          gate_product(gi, smem + L.wih(l), L.ldk, L.kh, dense(xin, r0, nr), nr);
        }
        gate_product(gh, smem + L.whh(l), L.ldk, L.kh, dense(hprev, r0, nr), nr);
        if (worker && ks == 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = mrow + g8 + 8 * (c >> 1);
            const int j = 8 * ut + 2 * t4 + (c & 1);
            if (r >= nr || j >= U) continue;
            const int row = r0 + r;
            const int u = u0 + j;
            float ir = gi[0][0][c], iz = gi[0][1][c], in = gi[0][2][c];
            if (l == 0) {
              ir += gb[0][c], iz += gb[1][c], in += gb[2][c];
            } else {
              ir += bi[j], iz += bi[U + j], in += bi[2 * U + j];
            }
            const float hr = gh[0][0][c] + bh[j], hz = gh[0][1][c] + bh[U + j],
                        hn = gh[0][2][c] + bh[2 * U + j];
            const Gates G = gru_gates(ir, iz, in, hr, hz, hn);
            const float h = gru_out(G, hp[c]);
            hnew[static_cast<size_t>(row) * H + u] = h;
            if (out.gh[l] != nullptr) {
              float* keep = out.gh[l] + chain_index(dm, t, row, u, H3);
              keep[0] = hr, keep[H] = hz, keep[2 * H] = hn;
            }
            if (dm.dropout && l + 1 < NL) {
              s.x[(static_cast<size_t>(l) * B + row) * H + u] =
                  h * dropout_mask(seed, t, l, dm.row_base + row, u, dm.keep, dm.scale);
            }
          }
        }
      }
      group_sync(bar, L.G, passed++);  // the row group's h_t (and its masked copy) written
    }

    // head: the CTA's V slice of the relu logits of its rows, the scores,
    // and a per-row partial of their argmax to the exchange
    if (head) {
      const float* top = out.h_all[NL - 1] + chain_index(dm, t, 0, 0, H);
      const int items = P / 16 * L.VT;
      for (int r0 = hrow0; r0 < hrow0 + hrows; r0 += P) {
        const int nr = min(P, hrow0 + hrows - r0);
        for (int it = 0; it < items; it += kWideThreads / 32) {
          const int hi = it + warp;  // item (m-tile, n-tile), one a warp, the whole depth
          const bool busy = hi < items;
          const int hm = busy ? 16 * (hi / L.VT) : P;
          const int hv = hi % L.VT;
          float acc[1][1][4] = {{{0.f, 0.f, 0.f, 0.f}}};
          wide_product<1, 1, 1>(acc, smem + L.out_w, L.ldk, L.kh, xs, P, hm, 0, nr,
                                dense(top, r0, nr), [&](int) { return 8 * hv; });
          if (busy) {
            // rows hm + g8 and + 8, columns 8 hv + 2 t4 and + 1 of the slice
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = hm + g8 + 8 * half;
              float m = -INFINITY;
              int idx = V;
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const int col = 8 * hv + 2 * t4 + cc;
                if (r >= nr || col >= nv) continue;
                const int v = v0 + col;
                const int row = r0 + r;
                const float x = acc[0][0][2 * half + cc] + s_ob[col];
                const float l = x < 0.f ? 0.f : x;  // relu, NaN passes through
                out.weights[(static_cast<size_t>(t) * B + row) * V + v] = l;
                const float sc =
                    dm.multinomial
                        ? l - logf(-logf(uniform01(seed, t, kSaltGumbel, dm.row_base + row, v)))
                        : l;
                argmax_combine(m, idx, sc, sc != sc ? V : v);
              }
#pragma unroll
              for (int off = 1; off < 4; off <<= 1) {
                const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
                const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
                argmax_combine(m, idx, m2, i2);
              }
              if (t4 == 0 && r < nr) {
                s_pm[r * L.VT + hv] = m;
                s_pi[r * L.VT + hv] = idx;
              }
            }
          }
        }
        __syncthreads();
        for (int r = threadIdx.x; r < nr; r += blockDim.x) {
          float m = -INFINITY;
          int idx = V;
          for (int j = 0; j < L.VT; ++j) {
            argmax_combine(m, idx, s_pm[r * L.VT + j], s_pi[r * L.VT + j]);
          }
          s.pm[static_cast<size_t>(vs) * B + r0 + r] = m;
          s.pi[static_cast<size_t>(vs) * B + r0 + r] = idx;
        }
      }
    }
    group_sync(bar, L.G, passed++);  // every head CTA's partials written
    // every CTA combines its rows' nh partials alike, then the teacher
    // select and the clamp: the next tick's fed tokens
    for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
      const size_t row = row0 + r;
      float m = -INFINITY;
      int idx = V;
#pragma unroll 4
      for (int j = 0; j < L.nh; ++j) {
        argmax_combine(m, idx, __ldcg(s.pm + static_cast<size_t>(j) * B + row),
                       __ldcg(s.pi + static_cast<size_t>(j) * B + row));
      }
      int tok = teacher ? score[static_cast<size_t>(t) * B + row] : idx;
      tok = min(max(tok, 0), V - 1);
      if (grp == 0) out.samples[static_cast<size_t>(t) * B + row] = tok;
      s_tok[r] = tok;
    }
    __syncthreads();
  }
  // the padded ticks of a short last beat: zero hiddens for the backward
  for (int t = T; t < dm.beats() * dm.tpb; ++t) {
    for (int i = threadIdx.x; i < nrows * U; i += blockDim.x) {
      const int r = i / U;
      const int u = u0 + i - r * U;
      for (int l = 0; l < NL; ++l) {
        out.h_all[l][chain_index(dm, t, row0 + r, u, H)] = 0.f;
        if (out.gh[l] == nullptr) continue;
        for (int g = 0; g < 3; ++g) out.gh[l][chain_index(dm, t, row0 + r, g * H + u, H3)] = 0.f;
      }
    }
  }
}

// Refuses a wave plan the kernel cannot run: returns the shared-memory
// bytes it needs, or 0.
int wave_checked_smem(int H, int E, int V, int NL, int U, int R, int P, int smem_bytes) {
  if ((U != 4 && U != 8 && U != 16 && U != 32) || H < U || H % U != 0 || E < 1 || V < 1) return 0;
  if (NL < 1 || NL > kMaxLayers || R < 1) return 0;
  if ((P != 16 && P != 32 && P != 64 && P != 128) || P / 16 * (U < 8 ? 1 : U / 8) > 8) return 0;
  const long long need = 4LL * wave_layout(H, E, V, NL, U, R, P).total;
  if (need > kMaxSmem || smem_bytes < need || smem_bytes > kMaxSmem) return 0;
  return static_cast<int>(need);
}

template <class... Args>
cudaError_t launch_wave(int KS, int ctas, int smem, unsigned* bar, cudaStream_t st,
                        Args... args) {
  return KS == 1   ? launch_wide(hier_wave_fwd<1>, ctas, smem, bar, st, args...)
         : KS == 2 ? launch_wide(hier_wave_fwd<2>, ctas, smem, bar, st, args...)
                   : launch_wide(hier_wave_fwd<4>, ctas, smem, bar, st, args...);
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
  unsigned* bar;  // the wide chains' grid barrier
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
  s.bar = reinterpret_cast<unsigned*>(take(1));
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
    inter[i] = dm.dropout ? x * dropout_mask(seed, cr.t, gap, dm.row_base + cr.b, j, dm.keep,
                                                dm.scale) : x;
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
      v *= dropout_mask(static_cast<uint32_t>(*seed), cr.t, gap, dm.row_base + cr.b, n, dm.keep,
                        dm.scale);
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

// Floats of shared memory a CTA of the resident forward plan (C, RB)
// needs for a tick GRU of L layers: the layout that
// ops/hier_decoder_kernel.py::fwd_smem_floats mirrors.
int hier_tick_chain_smem_floats(int H, int E, int V, int C, int RB, int L) {
  return fwd_layout(H, E, V, C, RB, L).total;
}

// Clusters of C CTAs of the resident forward, smem_bytes of dynamic shared
// memory each, that the card can hold at once
// (cudaOccupancyMaxActiveClusters); a negative CUDA error code when the
// query fails.
int hier_tick_chain_resident_clusters(int C, int smem_bytes) {
  return resident_clusters(hier_fwd, C, smem_bytes);
}

// Floats of shared memory a CTA of the wave forward plan (U units, R rows
// a row group in passes of P) needs: the layout that
// ops/hier_decoder_kernel.py::wave_smem_floats mirrors.
int hier_tick_chain_wave_smem_floats(int H, int E, int V, int L, int U, int R, int P) {
  return wave_layout(H, E, V, L, U, R, P).total;
}

// CTAs of the wave forward with KS depth splits, smem_bytes of dynamic
// shared memory each, that the card holds at once (one cooperative wave
// must fit in it); a negative CUDA error code when a query fails.
int hier_tick_chain_wave_resident_ctas(int KS, int smem_bytes) {
  return KS == 1   ? wide_resident_ctas(hier_wave_fwd<1>, smem_bytes)
         : KS == 2 ? wide_resident_ctas(hier_wave_fwd<2>, smem_bytes)
                   : wide_resident_ctas(hier_wave_fwd<4>, smem_bytes);
}

// Floats of the wave forward's scratch in device memory (its barrier
// counters, the head's partials and the masked layer inputs).
long long hier_tick_chain_wave_scratch_floats(int B, int H, int V, int L, int U, int R) {
  return wave_scratch(B, H, V, L, U, R, nullptr).floats;
}

// Floats of the backward's scratch before the GEMMs' partial sums (ops/
// hier_decoder_kernel.py::bwd_scratch_floats mirrors it).
long long hier_tick_chain_bwd_scratch_floats(int T, int B, int H, int E, int V,
                                              int ticks_per_beat, int L) {
  const Dims dm{T, B, H, E, V, ticks_per_beat, L, 0, 1.f, 1.f, 0, 0};
  return carve(dm, nullptr).floats;
}

// teacher, seed: (1,) i32 on the device; score (T, B) i32; the float
// operands as in struct Weights, the layers' as host arrays of kMaxLayers
// pointers; row_base: the global batch row of row 0, for the random bits;
// the plan: wave 0, the resident layout, clusters of C CTAs of RB rows
// (P unused); wave 1, the wave layout, C units a CTA and RB rows a row
// group in passes of P rows, with `scratch` of
// hier_tick_chain_wave_scratch_floats floats; smem_bytes of dynamic shared
// memory a CTA.
// Writes weights (T, B, V), samples (T, B) i32 and the L layers' hiddens
// h_all[l] (ticks_per_beat, n_beats * B, H); where gh is not null (the
// wave layout only), the L layers' hidden-side pre-activations gh[l]
// (ticks_per_beat, n_beats * B, 3H) for the backward's wide chains.
int hier_tick_chain_fwd(const int* teacher, const int* seed, const int* score,
                        const float* gi_beat, const float* tick_h0, const float* x0,
                        const float* emb, const float* w_ih0e, const float* const* w_hh,
                        const float* const* b_hh, const float* const* w_ih,
                        const float* const* b_ih, const float* out_w, const float* out_b, int T,
                        int B, int H, int E, int V, int L, int ticks_per_beat, int dropout,
                        float keep, float scale, int multinomial, int row_base, int wave, int C,
                        int RB, int P, int smem_bytes, float* weights, int* samples,
                        float* const* h_all, float* const* gh, float* scratch, void* stream) {
  const bool ok = wave != 0 ? wave_checked_smem(H, E, V, L, C, RB, P, smem_bytes) != 0
                            : fwd_checked_smem(H, E, V, C, RB, L, smem_bytes) != 0;
  if (!ok || T < 1 || B < 1 || ticks_per_beat < 1 || (wave != 0 && scratch == nullptr) ||
      (wave == 0 && gh != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Weights w =
      make_weights(gi_beat, tick_h0, x0, emb, w_ih0e, w_hh, b_hh, w_ih, b_ih, out_w, out_b, L);
  const Dims dm{T, B, H, E, V, ticks_per_beat, L, dropout, keep, scale, multinomial, row_base};
  FwdOut out = {};
  out.weights = weights;
  out.samples = samples;
  for (int l = 0; l < L; ++l) {
    out.h_all[l] = h_all[l];
    out.gh[l] = gh != nullptr ? gh[l] : nullptr;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wave == 0) {
    const dim3 grid(C * ((B + RB - 1) / RB));
    return static_cast<int>(launch_cluster(hier_fwd, C, grid, smem_bytes, st, w, dm, RB, teacher,
                                           seed, score, out));
  }
  const WaveScratch s = wave_scratch(B, H, V, L, C, RB, scratch);
  const int groups = (B + RB - 1) / RB;
  cudaError_t err = cudaMemsetAsync(s.bar, 0, sizeof(unsigned) * groups, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WaveLayout lay = wave_layout(H, E, V, L, C, RB, P);
  return static_cast<int>(launch_wave(lay.KS, lay.G * groups, smem_bytes, s.bar, st, w, dm, C,
                                      RB, P, teacher, seed, score, out, s));
}

// The backward. h_all: the forward's L saved hiddens; the gradient
// outputs in the order of the float operands, the layers' as host arrays of
// kMaxLayers pointers; row_base as in the forward; chain_C, chain_RB, chain_smem, chain_wide:
// gru_plan's plan of the chain backward on n_beats * B rows (chain_wide 0:
// clusters of chain_C CTAs of chain_RB rows; 1: the wide layout, chain_C
// units and chain_RB rows a CTA, whose chains read gh: the L layers'
// hidden-side pre-activations the wave forward kept); scratch:
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
                        int ticks_per_beat, int dropout, float keep, float scale, int row_base,
                        int chain_C,
                        int chain_RB, int chain_smem, int chain_wide,
                        const float* const* gh, float* dgi_beat,
                        float* dtick_h0, float* dx0, float* demb, float* dw_ih0e,
                        float* const* dw_hh, float* const* db_hh, float* const* dw_ih,
                        float* const* db_ih, float* dout_w, float* dout_b, float* scratch,
                        const int* splits, void* stream) {
  const Dims dm{T, B, H, E, V, ticks_per_beat, L, dropout, keep, scale, 0, row_base};
  if (T < 1 || B < 1 || ticks_per_beat < 1 || L < 1 || L > kMaxLayers ||
      (chain_wide != 0 ? wide_checked_smem(true, H, chain_C, chain_RB, chain_smem)
                       : chain_checked_smem(true, H, chain_C, chain_RB, chain_smem)) == 0 ||
      (chain_wide != 0 && gh == nullptr)) {
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
    float* dinit = s.dinit + static_cast<size_t>(l) * bc * H;
    if (err == cudaSuccess && chain_wide != 0) {
      // the wave forward's gh
      err = launch_wide_bwd(s.gi, gh[l], w_hh[l], init, h_all[l], s.dh, ticks_per_beat, 1, bc,
                            H, chain_C, chain_RB, chain_smem, s.dgi, dinit, s.dgh, s.bar, st);
    } else if (err == cudaSuccess) {
      err = launch_cluster(gru_bwd, chain_C, chain_grid, chain_smem, st, s.gi, w_hh[l], b_hh[l],
                           init, h_all[l], s.dh, ticks_per_beat, 1, bc, H, chain_RB, s.dgi, dinit,
                           s.dgh);
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
