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
// What bounds it: a 24-step chain of dependent small products (two GRU
// layers of (rows x H) @ (H x 3H) and the (rows x H) @ (H x V) head) with
// an argmax and a gather between steps: latency, not bytes or arithmetic
// throughput. As in gru_chain.cu, a block owns a tile of batch rows and
// loops over t itself, with every recurrent quantity (both hiddens, the
// fed embedding, the logits) in shared memory for the whole measure; the
// weights are read from global memory, where they stay L2-resident. The
// re-embedding is a gather of one table row, not the TPU's one-hot
// matmul, and the argmax is a warp reduction per row.
//
// Backward: the same row tiles walk t from T-1 down to 0, recompute the
// gates and the ReLU mask from the saved hiddens and fed tokens, replay
// the dropout mask, and carry the hidden gradients in shared memory.
// Results of one row stay in the sequential launch (dgi_beat summed over
// a beat's ticks, dtick_h0 at the resets, dx0 at t = 0). The weight and
// embedding gradients sum over (t, b) across row tiles: the sequential
// launch writes the products' operands that exist nowhere else to
// scratch buffers, and the tiled fixed-order GEMM of gru_common.cuh sums
// them, reading the layers' h_{t-1} (the saved hiddens one tick back,
// tick_h0 at the resets) and the fed tokens in place, so repeats are
// bitwise equal (no float atomics).
//
// Random bits: a counter-based 32-bit hash of (seed, t, salt, row, col),
// salt 0 for dropout and 3571 for the Gumbel noise. The plain PyTorch
// version in arvae_tpu_torch/ops/hier_decoder_kernel.py computes the same
// function with integer tensor ops, and the uniform is formed with
// explicitly rounded multiply and add, so both give bitwise-equal masks.
//
// Plain C interface, loaded with ctypes: each entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cmath>
#include <cstdint>

#include "gru_common.cuh"

using namespace arvae;

namespace {

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

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
};

struct FwdOut {
  float* weights;  // (T, B, V) relu logits
  int* samples;    // (T, B) fed tokens
  float* h0_all;   // (T, B, H)
  float* h1_all;   // (T, B, H)
};

// Gradients and the backward's scratch (every (T, B, .) buffer is
// written by the sequential launch and read by the GEMMs).
struct BwdOut {
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
  // scratch
  float* inter;   // (T, B, H)  layer-1 input after dropout
  float* pe;      // (T, B, E)  fed embedding
  float* dpe;     // (T, B, E)  its gradient
  float* dlog;    // (T, B, V)  dlogits after the ReLU mask
  float* dgi1;    // (T, B, 3H)
  float* dgh1;    // (T, B, 3H)
  float* dgi0;    // (T, B, 3H)
  float* dgh0;    // (T, B, 3H)
};

inline int fwd_floats(int rb, int H, int E, int V) {
  return 3 * up4(rb * H) + 2 * up4(rb * 3 * H) + up4(rb * E) + up4(rb * V) + up4(rb);
}

inline int bwd_floats(int rb, int H, int E, int V) {
  return 7 * up4(rb * H) + 9 * up4(rb * 3 * H) + up4(rb * E) + up4(rb * V);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int RB>
__global__ void __launch_bounds__(kSeqThreads)
hier_fwd(Weights w, Dims dm, const int* __restrict__ teacher_ptr,
         const int* __restrict__ seed_ptr, const int* __restrict__ score, FwdOut out) {
  extern __shared__ __align__(16) float smem[];
  const int T = dm.T, B = dm.B, H = dm.H, E = dm.E, V = dm.V, H3 = 3 * H;
  float* h0_s = smem;                 // RB x H
  float* h1_s = h0_s + up4(RB * H);   // RB x H
  float* x_s = h1_s + up4(RB * H);    // RB x H: layer-1 input
  float* ga_s = x_s + up4(RB * H);    // RB x 3H: input-side gate pre-activations
  float* gb_s = ga_s + up4(RB * H3);  // RB x 3H: hidden-side
  float* pe_s = gb_s + up4(RB * H3);  // RB x E: fed embedding
  float* sc_s = pe_s + up4(RB * E);   // RB x V: sampling scores
  int* tok_s = reinterpret_cast<int*>(sc_s + up4(RB * V));  // RB

  const int row0 = blockIdx.x * RB;
  const int nr = min(RB, B - row0);
  const bool teacher = *teacher_ptr != 0;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);

  for (int i = threadIdx.x; i < RB * H; i += blockDim.x) {
    h0_s[i] = 0.f;
    h1_s[i] = 0.f;
    x_s[i] = 0.f;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int beat = t / dm.tpb;
    if (t % dm.tpb == 0) {
      const float* init = w.tick_h0 + (static_cast<size_t>(beat) * 2 * B + row0) * H;
      for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
        h0_s[i] = init[i];
        h1_s[i] = init[static_cast<size_t>(B) * H + i];
      }
    }
    for (int i = threadIdx.x; i < RB * E; i += blockDim.x) {
      const int r = i / E;
      const int e = i - r * E;
      float v = 0.f;
      if (r < nr) {
        v = t == 0 ? w.x0[static_cast<size_t>(row0 + r) * E + e]
                   : w.emb[static_cast<size_t>(tok_s[r]) * E + e];
      }
      pe_s[i] = v;
    }
    __syncthreads();

    // layer 0
    block_matvec<RB>(pe_s, E, w.w_ih0e, H3, nullptr,
                     w.gi_beat + (static_cast<size_t>(beat) * B + row0) * H3, H3, nr, ga_s);
    block_matvec<RB>(h0_s, H, w.w_hh0, H3, w.b_hh0, nullptr, 0, nr, gb_s);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
      const int r = i / H;
      const int c = i - r * H;
      const float* a = ga_s + r * H3;
      const float* b = gb_s + r * H3;
      const Gates q = gru_gates(a[c], a[H + c], a[2 * H + c], b[c], b[H + c], b[2 * H + c]);
      const float hn = gru_out(q, h0_s[i]);
      h0_s[i] = hn;
      out.h0_all[(static_cast<size_t>(t) * B + row0) * H + i] = hn;
      x_s[i] = dm.dropout ? hn * dropout_mask(seed, t, row0 + r, c, dm.keep, dm.scale) : hn;
    }
    __syncthreads();

    // layer 1
    block_matvec<RB>(x_s, H, w.w_ih1, H3, w.b_ih1, nullptr, 0, nr, ga_s);
    block_matvec<RB>(h1_s, H, w.w_hh1, H3, w.b_hh1, nullptr, 0, nr, gb_s);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
      const int r = i / H;
      const int c = i - r * H;
      const float* a = ga_s + r * H3;
      const float* b = gb_s + r * H3;
      const Gates q = gru_gates(a[c], a[H + c], a[2 * H + c], b[c], b[H + c], b[2 * H + c]);
      const float hn = gru_out(q, h1_s[i]);
      h1_s[i] = hn;
      out.h1_all[(static_cast<size_t>(t) * B + row0) * H + i] = hn;
    }
    __syncthreads();

    // head: relu logits, then the sampling scores
    block_matvec<RB>(h1_s, H, w.out_w, V, w.out_b, nullptr, 0, nr, sc_s);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * V; i += blockDim.x) {
      const int r = i / V;
      const int v = i - r * V;
      const float x = sc_s[i];
      const float l = x < 0.f ? 0.f : x;  // relu, NaN passes through
      out.weights[(static_cast<size_t>(t) * B + row0) * V + i] = l;
      sc_s[i] = dm.multinomial
                    ? l - logf(-logf(uniform01(seed, t, kSaltGumbel, row0 + r, v)))
                    : l;
    }
    __syncthreads();

    // argmax per row, one warp a row: the max (NaN if any score is NaN),
    // then the lowest index holding it (V if none: the all-NaN row).
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int r = warp; r < nr; r += blockDim.x >> 5) {
      const float* s = sc_s + r * V;
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) {
        const float x = s[v];
        m = (x != x || m != m) ? NAN : fmaxf(m, x);
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, m, off);
        m = (o != o || m != m) ? NAN : fmaxf(m, o);
      }
      int idx = V;
      for (int v = lane; v < V; v += 32) {
        if (s[v] == m) {
          idx = v;
          break;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        idx = min(idx, __shfl_xor_sync(0xffffffffu, idx, off));
      }
      if (lane == 0) {
        int tok = teacher ? score[static_cast<size_t>(t) * B + row0 + r] : idx;
        tok = min(max(tok, 0), V - 1);
        out.samples[static_cast<size_t>(t) * B + row0 + r] = tok;
        tok_s[r] = tok;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <int RB>
__global__ void __launch_bounds__(kSeqThreads)
hier_bwd(Weights w, Dims dm, const int* __restrict__ seed_ptr,
         const int* __restrict__ samples, const float* __restrict__ h0_all,
         const float* __restrict__ h1_all, const float* __restrict__ dweights, BwdOut g) {
  extern __shared__ __align__(16) float smem[];
  const int T = dm.T, B = dm.B, H = dm.H, E = dm.E, V = dm.V, H3 = 3 * H;
  float* h0p_s = smem;                  // RB x H: layer-0 h_{t-1}
  float* h1p_s = h0p_s + up4(RB * H);   // RB x H: layer-1 h_{t-1}
  float* h1n_s = h1p_s + up4(RB * H);   // RB x H: layer-1 h_t
  float* x_s = h1n_s + up4(RB * H);     // RB x H: layer-1 input
  float* dh0_s = x_s + up4(RB * H);     // RB x H: layer-0 hidden-grad carry
  float* dh1_s = dh0_s + up4(RB * H);   // RB x H: layer-1 hidden-grad carry
  float* dx_s = dh1_s + up4(RB * H);    // RB x H: grad of the layer-1 input
  float* ga_s = dx_s + up4(RB * H);     // RB x 3H: gi0
  float* gb_s = ga_s + up4(RB * H3);    // RB x 3H: gh0
  float* gc_s = gb_s + up4(RB * H3);    // RB x 3H: gi1
  float* gd_s = gc_s + up4(RB * H3);    // RB x 3H: gh1
  float* dgi1_s = gd_s + up4(RB * H3);  // RB x 3H
  float* dgh1_s = dgi1_s + up4(RB * H3);
  float* dgi0_s = dgh1_s + up4(RB * H3);
  float* dgh0_s = dgi0_s + up4(RB * H3);
  float* dgb_s = dgh0_s + up4(RB * H3);  // RB x 3H: dgi_beat of the current beat
  float* pe_s = dgb_s + up4(RB * H3);    // RB x E
  float* dl_s = pe_s + up4(RB * E);      // RB x V: pre-activations, then dlogits

  const int row0 = blockIdx.x * RB;
  const int nr = min(RB, B - row0);
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);

  for (int i = threadIdx.x; i < RB * H; i += blockDim.x) {
    h0p_s[i] = h1p_s[i] = h1n_s[i] = x_s[i] = 0.f;
    dh0_s[i] = dh1_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < RB * H3; i += blockDim.x) dgb_s[i] = 0.f;
  for (int i = threadIdx.x; i < RB * E; i += blockDim.x) pe_s[i] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const int beat = t / dm.tpb;
    const bool reset = t % dm.tpb == 0;
    const size_t slab = static_cast<size_t>(t) * B + row0;  // row (t, row0) of a (T, B, .) array

    // recompute the step's inputs and save the GEMMs' operands
    const float* init = w.tick_h0 + (static_cast<size_t>(beat) * 2 * B + row0) * H;
    for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
      const int r = i / H;
      const int c = i - r * H;
      const float a = reset ? init[i] : h0_all[(slab - B) * H + i];
      const float b = reset ? init[static_cast<size_t>(B) * H + i] : h1_all[(slab - B) * H + i];
      const float h0n = h0_all[slab * H + i];
      const float x = dm.dropout ? h0n * dropout_mask(seed, t, row0 + r, c, dm.keep, dm.scale) : h0n;
      h0p_s[i] = a;
      h1p_s[i] = b;
      h1n_s[i] = h1_all[slab * H + i];
      x_s[i] = x;
      g.inter[slab * H + i] = x;
    }
    for (int i = threadIdx.x; i < nr * E; i += blockDim.x) {
      const int r = i / E;
      const int e = i - r * E;
      const float v = t > 0 ? w.emb[static_cast<size_t>(samples[(slab - B) + r]) * E + e]
                            : w.x0[static_cast<size_t>(row0 + r) * E + e];
      pe_s[i] = v;
      g.pe[slab * E + i] = v;
    }
    __syncthreads();

    block_matvec<RB>(pe_s, E, w.w_ih0e, H3, nullptr,
                     w.gi_beat + (static_cast<size_t>(beat) * B + row0) * H3, H3, nr, ga_s);
    block_matvec<RB>(h0p_s, H, w.w_hh0, H3, w.b_hh0, nullptr, 0, nr, gb_s);
    block_matvec<RB>(x_s, H, w.w_ih1, H3, w.b_ih1, nullptr, 0, nr, gc_s);
    block_matvec<RB>(h1p_s, H, w.w_hh1, H3, w.b_hh1, nullptr, 0, nr, gd_s);
    block_matvec<RB>(h1n_s, H, w.out_w, V, w.out_b, nullptr, 0, nr, dl_s);
    __syncthreads();

    // head: dlogits = dweights * (pre-activation > 0)
    for (int i = threadIdx.x; i < nr * V; i += blockDim.x) {
      const float dl = dl_s[i] > 0.f ? dweights[slab * V + i] : 0.f;
      dl_s[i] = dl;
      g.dlog[slab * V + i] = dl;
    }
    __syncthreads();
    // dh1 = carry + dlogits @ out_w^T
    block_matvec_t<RB>(dl_s, V, w.out_w, H, nr, dh1_s, H, true);
    __syncthreads();

    // layer 1
    for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
      const int r = i / H;
      const int c = i - r * H;
      const float* a = gc_s + r * H3;
      const float* b = gd_s + r * H3;
      const Gates q = gru_gates(a[c], a[H + c], a[2 * H + c], b[c], b[H + c], b[2 * H + c]);
      const CellGrads cg = gru_cell_bwd(dh1_s[i], q, h1p_s[i]);
      float* di = dgi1_s + r * H3;
      float* dh = dgh1_s + r * H3;
      di[c] = dh[c] = cg.dr;
      di[H + c] = dh[H + c] = cg.dz;
      di[2 * H + c] = cg.dn;
      dh[2 * H + c] = cg.dgh_n;
      const size_t o = (slab + r) * H3;
      g.dgi1[o + c] = g.dgh1[o + c] = cg.dr;
      g.dgi1[o + H + c] = g.dgh1[o + H + c] = cg.dz;
      g.dgi1[o + 2 * H + c] = cg.dn;
      g.dgh1[o + 2 * H + c] = cg.dgh_n;
      dh1_s[i] = cg.dh_z;
    }
    __syncthreads();
    // dh1_{t-1} = dh1 z1 + dgh1 @ w_hh1^T;  dinter = dgi1 @ w_ih1^T
    block_matvec_t<RB>(dgh1_s, H3, w.w_hh1, H, nr, dh1_s, H, true);
    block_matvec_t<RB>(dgi1_s, H3, w.w_ih1, H, nr, dx_s, H, false);
    __syncthreads();

    // layer 0
    for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
      const int r = i / H;
      const int c = i - r * H;
      const float dx = dm.dropout ? dx_s[i] * dropout_mask(seed, t, row0 + r, c, dm.keep, dm.scale)
                                  : dx_s[i];
      const float* a = ga_s + r * H3;
      const float* b = gb_s + r * H3;
      const Gates q = gru_gates(a[c], a[H + c], a[2 * H + c], b[c], b[H + c], b[2 * H + c]);
      const CellGrads cg = gru_cell_bwd(dh0_s[i] + dx, q, h0p_s[i]);
      float* di = dgi0_s + r * H3;
      float* dh = dgh0_s + r * H3;
      float* db = dgb_s + r * H3;
      di[c] = dh[c] = cg.dr;
      di[H + c] = dh[H + c] = cg.dz;
      di[2 * H + c] = cg.dn;
      dh[2 * H + c] = cg.dgh_n;
      db[c] += cg.dr;
      db[H + c] += cg.dz;
      db[2 * H + c] += cg.dn;
      const size_t o = (slab + r) * H3;
      g.dgi0[o + c] = g.dgh0[o + c] = cg.dr;
      g.dgi0[o + H + c] = g.dgh0[o + H + c] = cg.dz;
      g.dgi0[o + 2 * H + c] = cg.dn;
      g.dgh0[o + 2 * H + c] = cg.dgh_n;
      dh0_s[i] = cg.dh_z;
    }
    __syncthreads();
    // dh0_{t-1} = dh0 z0 + dgh0 @ w_hh0^T;  dprev_emb = dgi0 @ w_ih0e^T,
    // which is dx0 at t = 0 and an embedding-row gradient after it
    block_matvec_t<RB>(dgh0_s, H3, w.w_hh0, H, nr, dh0_s, H, true);
    block_matvec_t<RB>(dgi0_s, H3, w.w_ih0e, E, nr, t == 0 ? g.dx0 + static_cast<size_t>(row0) * E
                                                       : g.dpe + slab * E,
                   E, false);
    __syncthreads();

    // a reset routes the hidden grads to the beat's inits, and closes
    // the beat's dgi_beat sum
    if (reset) {
      float* dinit = g.dtick_h0 + (static_cast<size_t>(beat) * 2 * B + row0) * H;
      for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
        dinit[i] = dh0_s[i];
        dinit[static_cast<size_t>(B) * H + i] = dh1_s[i];
        dh0_s[i] = 0.f;
        dh1_s[i] = 0.f;
      }
      float* dgb = g.dgi_beat + (static_cast<size_t>(beat) * B + row0) * H3;
      for (int i = threadIdx.x; i < nr * H3; i += blockDim.x) {
        dgb[i] = dgb_s[i];
        dgb_s[i] = 0.f;
      }
      __syncthreads();
    }
  }
  // t = 0 feeds x0, not an embedding row, so its dpe slab was never
  // written; the embedding GEMM multiplies it by 0 (no token is fed
  // there), and 0 times an uninitialised NaN would poison the sum, so
  // zero it
  for (int i = threadIdx.x; i < nr * E; i += blockDim.x) g.dpe[static_cast<size_t>(row0) * E + i] = 0.f;
}

int rows_per_block(bool fwd, int H, int E, int V) {
  for (int rb = 8; rb >= 1; rb /= 2) {
    const int floats = fwd ? fwd_floats(rb, H, E, V) : bwd_floats(rb, H, E, V);
    if (static_cast<long long>(floats) * 4 <= kMaxSmem) return rb;
  }
  return 0;
}

template <int RB>
cudaError_t launch_fwd(const Weights& w, const Dims& dm, const int* teacher, const int* seed,
                       const int* score, const FwdOut& out, cudaStream_t st) {
  const int smem = fwd_floats(RB, dm.H, dm.E, dm.V) * 4;
  cudaError_t err = cudaFuncSetAttribute(hier_fwd<RB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  hier_fwd<RB><<<(dm.B + RB - 1) / RB, kSeqThreads, smem, st>>>(w, dm, teacher, seed, score, out);
  return cudaGetLastError();
}

template <int RB>
cudaError_t launch_bwd(const Weights& w, const Dims& dm, const int* seed, const int* samples,
                       const float* h0_all, const float* h1_all, const float* dweights,
                       const BwdOut& g, cudaStream_t st) {
  const int smem = bwd_floats(RB, dm.H, dm.E, dm.V) * 4;
  cudaError_t err = cudaFuncSetAttribute(hier_bwd<RB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  hier_bwd<RB><<<(dm.B + RB - 1) / RB, kSeqThreads, smem, st>>>(w, dm, seed, samples, h0_all,
                                                                h1_all, dweights, g);
  return cudaGetLastError();
}

Weights make_weights(const float* gi_beat, const float* tick_h0, const float* x0,
                     const float* emb, const float* w_ih0e, const float* w_hh0,
                     const float* b_hh0, const float* w_ih1, const float* b_ih1,
                     const float* w_hh1, const float* b_hh1, const float* out_w,
                     const float* out_b) {
  return Weights{gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0,
                 w_ih1, b_ih1, w_hh1, b_hh1, out_w, out_b};
}

}  // namespace

extern "C" {

const char* hier_tick_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows of the batch a block owns (0 = the widths are too large).
int hier_tick_chain_rows(int fwd, int H, int E, int V) {
  return rows_per_block(fwd != 0, H, E, V);
}

// teacher, seed: (1,) i32 on the device; score (T, B) i32; the float
// operands as in struct Weights. Writes weights (T, B, V), samples
// (T, B) i32, h0_all and h1_all (T, B, H).
int hier_tick_chain_fwd(const int* teacher, const int* seed, const int* score,
                        const float* gi_beat, const float* tick_h0, const float* x0,
                        const float* emb, const float* w_ih0e, const float* w_hh0,
                        const float* b_hh0, const float* w_ih1, const float* b_ih1,
                        const float* w_hh1, const float* b_hh1, const float* out_w,
                        const float* out_b, int T, int B, int H, int E, int V,
                        int ticks_per_beat, int dropout, float keep, float scale,
                        int multinomial, float* weights, int* samples, float* h0_all,
                        float* h1_all, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = make_weights(gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0, w_ih1,
                                 b_ih1, w_hh1, b_hh1, out_w, out_b);
  const Dims dm{T, B, H, E, V, ticks_per_beat, dropout, keep, scale, multinomial};
  const FwdOut out{weights, samples, h0_all, h1_all};
  switch (rows_per_block(true, H, E, V)) {
    case 8: return launch_fwd<8>(w, dm, teacher, seed, score, out, st);
    case 4: return launch_fwd<4>(w, dm, teacher, seed, score, out, st);
    case 2: return launch_fwd<2>(w, dm, teacher, seed, score, out, st);
    case 1: return launch_fwd<1>(w, dm, teacher, seed, score, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward. grads: the 13 gradient outputs in the order of struct
// BwdOut; scratch: inter, pe, dpe, dlog, dgi1, dgh1, dgi0, dgh0, then
// red, the GEMMs' partial sums; splits: the split of the (t, b) terms of
// each of the six weight-gradient GEMMs, in the order they run below
// (ops/hier_decoder_kernel.py::gemm_shapes), red sized for the largest.
int hier_tick_chain_bwd(const int* seed, const int* samples, const float* h0_all,
                        const float* h1_all, const float* dweights, const float* gi_beat,
                        const float* tick_h0, const float* x0, const float* emb,
                        const float* w_ih0e, const float* w_hh0, const float* b_hh0,
                        const float* w_ih1, const float* b_ih1, const float* w_hh1,
                        const float* b_hh1, const float* out_w, const float* out_b, int T,
                        int B, int H, int E, int V, int ticks_per_beat, int dropout,
                        float keep, float scale, float* dgi_beat, float* dtick_h0,
                        float* dx0, float* demb, float* dw_ih0e, float* dw_hh0,
                        float* db_hh0, float* dw_ih1, float* db_ih1, float* dw_hh1,
                        float* db_hh1, float* dout_w, float* dout_b, float* s_inter,
                        float* s_pe, float* s_dpe, float* s_dlog, float* s_dgi1,
                        float* s_dgh1, float* s_dgi0, float* s_dgh0, float* red,
                        const int* splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = make_weights(gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0, w_ih1,
                                 b_ih1, w_hh1, b_hh1, out_w, out_b);
  const Dims dm{T, B, H, E, V, ticks_per_beat, dropout, keep, scale, 0};
  const BwdOut g{dgi_beat, dtick_h0, dx0,     demb,  dw_ih0e, dw_hh0, db_hh0, dw_ih1,
                 db_ih1,   dw_hh1,   db_hh1,  dout_w, dout_b, s_inter, s_pe,   s_dpe,
                 s_dlog,   s_dgi1,   s_dgh1,  s_dgi0, s_dgh0};
  cudaError_t err;
  switch (rows_per_block(false, H, E, V)) {
    case 8: err = launch_bwd<8>(w, dm, seed, samples, h0_all, h1_all, dweights, g, st); break;
    case 4: err = launch_bwd<4>(w, dm, seed, samples, h0_all, h1_all, dweights, g, st); break;
    case 2: err = launch_bwd<2>(w, dm, seed, samples, h0_all, h1_all, dweights, g, st); break;
    case 1: err = launch_bwd<1>(w, dm, seed, samples, h0_all, h1_all, dweights, g, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  // the weight and embedding gradients: fixed-order sums over (t, b)
  const long long h = H, h3 = 3LL * H, bh = static_cast<long long>(B) * H;
  auto dense = [&](const float* p, long long width) {
    return Operand{p, nullptr, 0, static_cast<long long>(B) * width, width, 1, 0};
  };
  // a layer's h_{t-1}: its saved hiddens one tick back, tick_h0 at resets
  auto prev = [&](const float* all, int layer) {
    return Operand{all, tick_h0 + layer * bh, 0, bh, h, ticks_per_beat, 2 * bh};
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
      {dense(h1_all, h), nullptr, H, dense(s_dlog, V), V, dout_w, dout_b},
      {dense(s_inter, h), nullptr, H, dense(s_dgi1, h3), 3 * H, dw_ih1, db_ih1},
      {prev(h1_all, 1), nullptr, H, dense(s_dgh1, h3), 3 * H, dw_hh1, db_hh1},
      {prev(h0_all, 0), nullptr, H, dense(s_dgh0, h3), 3 * H, dw_hh0, db_hh0},
      {dense(s_pe, E), nullptr, E, dense(s_dgi0, h3), 3 * H, dw_ih0e, nullptr},
      // the fed token of step t is samples[t - 1]; none at t = 0
      {dense(nullptr, V), samples, V, dense(s_dpe, E), E, demb, nullptr},
  };
  for (int i = 0; i < 6; ++i) {
    const Job& j = jobs[i];
    err = launch_atb(j.a, j.tokens, B, j.m, j.x, j.n, T, B, 1, splits[i], j.out, j.bias, red,
                     st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
