// Whole-sequence GRU recurrence, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair of
// arvae_tpu/ops/gru_pallas.py::gru_chain (_fwd_kernel, _bwd_kernel).
// Directions are batched on a leading axis; any time flip of a backward
// direction happens in the caller (arvae_tpu_torch/ops/gru.py):
//
//   gi (T, D, B, 3H) = x @ w_ih + b_ih, precomputed;
//   w_hh (D, H, 3H), b_hh (D, 3H), h0 (D, B, H)  ->  outs (T, D, B, H).
//
// What bounds it: a T-long chain of dependent (rows x H) @ (H x 3H)
// products, 24 steps at the encoder's shape: latency, step after step,
// far above the fp32 operations bound (utils/kernel_work.py). Two things
// set that latency: how much of the card works on each step, and how
// long one CTA takes for its share of it.
//
// The design: a thread-block cluster of C CTAs owns a tile of RB batch
// rows of one direction and loops over t itself. CTA c of the cluster
// owns the hidden units [c H/C, (c+1) H/C) and their three gate columns
// of w_hh, which it loads once into shared memory and keeps for the
// whole chain (98 KB at H = 128, C = 2). Each of its 512 threads owns one
// (row, hidden unit) of the tile's cell math. The plan fills the card
// with one CTA an SM in one wave (128 CTAs at both music shapes: C = 2
// with 8 rows, or 4 rows for the beat GRU); a CTA of more than half an
// SM's shared memory keeps a second one off its SM, which would halve
// the product's speed. No step reads a weight from L2.
//
// Wider layers (H = 384 or 512 at the reference's own width) have slices
// that no cluster of 8 CTAs holds beside its tile (253 KB forward at
// H = 384, C = 8, 4 rows). There the plan takes the streamed layout: the
// CTA keeps no weight, and each step reads its slice from L2 (3 MB a
// direction at H = 512, against 50 MB of L2) in stages of 32 rows,
// double-buffered with cp.async, into the same depth-split product; each
// output adds its stages' partial sums in stage order, so repeats stay
// bitwise equal. gru_plan keeps the resident layout wherever it fits.
//
// Each step's product gh = h_{t-1} w_hh[:, own] runs on the CUDA cores in
// fp32: a thread owns 4 rows by 2 columns, and the spare threads take
// slices of the depth H whose partial sums the first slice adds in a
// fixed order (gru_common.cuh::block_product), which cuts the chain a
// thread walks a step. The unit's gi_t (and douts_t) are loaded into
// registers a step ahead.
//
// Forward: each step, every CTA multiplies the full h_{t-1} of its rows
// by its weight slice, applies the gate math to its own units, and
// writes the new hidden units into every peer's shared memory
// (distributed shared memory, double-buffered by step); one cluster
// barrier a step publishes them.
//
// Backward: the same clusters walk t from T-1 down to 0, recompute the
// gates from h_{t-1} (outs[t-1], or h0 at t = 0; copied a step ahead
// with cp.async) and gi_t, carry dh for their own units, and write dgi_t
// and dgh_t. dh_{t-1} = dh z + dgh_t w_hh^T needs every CTA's columns:
// each CTA computes the partial over its own columns for all H units and
// writes the part owned by CTA o into o's slot c (reduce-scatter through
// distributed shared memory, double-buffered by step); the owner adds its
// C slots in the fixed order c = 0 .. C-1. dW_hh and db_hh sum over
// (t, b) across clusters: the tiled GEMM of gru_common.cuh reads
// h_{t-1} in place and dgh from the sequential launch, in a fixed order.
// No float atomics anywhere, so repeats are bitwise equal.
//
// The backward's cluster kernel and its layout live in gru_cluster.cuh,
// which hier_tick_chain.cu includes too: the tick loop's backward runs
// its two layers as one such chain a beat. The launch plan (C, RB,
// shared-memory bytes) is chosen by the caller
// (arvae_tpu_torch/ops/gru_kernel.py::gru_plan, which mirrors
// chain_layout); the entries check it and refuse a plan that does not
// fit.
//
// Plain C interface, loaded with ctypes: each entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include "gru_cluster.cuh"

using namespace arvae;

namespace {

template <bool kStream>
__global__ void __launch_bounds__(kThreads)
gru_fwd(const float* __restrict__ gi, const float* __restrict__ w_hh,
        const float* __restrict__ b_hh, const float* __restrict__ h0, int T, int D, int B,
        int H, int RB, float* __restrict__ outs) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const ChainLayout L = chain_layout(false, H, C, RB, kStream);
  float* ws = smem + L.w;  // the resident slice, or the streamed stages
  float* bs = smem + L.b;
  float* hs = smem + L.h;
  float* ghs = smem + L.gh;
  float* part = smem + L.part;
  const int H3 = 3 * H;
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * RB;
  const int nr = min(RB, B - row0);
  const int u0 = c * L.hc;
  const int hbuf = RB * L.ldh;
  const Unit me = my_unit(RB, L.hc, nr);
  const int u = u0 + me.i;

  const float* wd = w_hh + static_cast<size_t>(d) * H * H3;
  const GateRows rows{wd, H, L.hc, u0, L.ldw};
  if (kStream) {
    load_bias(b_hh + static_cast<size_t>(d) * H3, H, u0, L, bs);
  } else {
    load_slice(wd, b_hh + static_cast<size_t>(d) * H3, H, u0, L, ws, bs);
  }
  copy_tile(hs, L.ldh, h0 + (static_cast<size_t>(d) * B + row0) * H, H, RB, H, nr);
  cp_async_commit();
  float gn[3];  // gi_t of this thread's unit
  load_gates(gi + ((static_cast<size_t>(d) * B + row0 + me.r) * H3), H, u, me.row, gn);
  cp_async_wait<0>();
  cluster.sync();  // every peer runs: its shared memory may be written

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    float gcur[3] = {gn[0], gn[1], gn[2]};
    if (t + 1 < T) {
      load_gates(gi + ((static_cast<size_t>(t + 1) * D + d) * B + row0 + me.r) * H3, H, u,
                 me.row, gn);
    }
    const float* hcur = hs + cur * hbuf;
    // gh = h_{t-1} w_hh[:, own] + b_hh[own]
    auto gh_store = [&](int r, int n, float v) { ghs[r * L.ldg + n] = v + bs[n]; };
    if (kStream) {
      streamed_times_w(hcur, L.ldh, RB, H, L.n3, rows, ws, L.ldw, ghs, L.ldg, part, gh_store);
    } else {
      rows_times_w(hcur, L.ldh, RB, H, ws, L.ldw, L.n3, part, gh_store);
    }
    __syncthreads();
    // the unit's new hidden, to every CTA's next buffer
    if (me.live) {
      const float* q = ghs + me.r * L.ldg;
      const Gates G = gru_gates(gcur[0], gcur[1], gcur[2], q[me.i], q[L.hc + me.i],
                                q[2 * L.hc + me.i]);
      const float hn = gru_out(G, hcur[me.r * L.ldh + u]);
      if (me.row) outs[((static_cast<size_t>(t) * D + d) * B + row0 + me.r) * H + u] = hn;
      float* mine = hs + (cur ^ 1) * hbuf + me.r * L.ldh + u;
      for (int p = 0; p < C; ++p) *cluster.map_shared_rank(mine, p) = hn;
    }
    cluster.sync();
  }
}

}  // namespace

extern "C" {

const char* gru_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of shared memory a CTA of the plan (H, C, RB, stream) needs: the
// layout that ops/gru_kernel.py::chain_smem_floats mirrors.
int gru_chain_smem_floats(int bwd, int H, int C, int RB, int stream) {
  return chain_layout(bwd != 0, H, C, RB, stream != 0).total;
}

// Clusters of C CTAs of the forward (bwd 0) or backward kernel in the
// resident (stream 0) or streamed layout, smem_bytes each, that the card
// holds at once; a negative CUDA error code when the query fails.
int gru_chain_resident_clusters(int bwd, int stream, int C, int smem_bytes) {
  if (bwd != 0) {
    return stream != 0 ? resident_clusters(gru_bwd<true>, C, smem_bytes)
                       : resident_clusters(gru_bwd<false>, C, smem_bytes);
  }
  return stream != 0 ? resident_clusters(gru_fwd<true>, C, smem_bytes)
                     : resident_clusters(gru_fwd<false>, C, smem_bytes);
}

// gi (T, D, B, 3H), w_hh (D, H, 3H), b_hh (D, 3H), h0 (D, B, H) f32
// -> outs (T, D, B, H) f32; the plan: clusters of C CTAs of RB rows,
// smem_bytes of dynamic shared memory each, w_hh's slices resident
// (streamed 0) or streamed.
int gru_chain_fwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
                  int T, int D, int B, int H, int C, int RB, int smem_bytes, int streamed,
                  float* outs, void* stream) {
  if (chain_checked_smem(false, H, C, RB, smem_bytes, streamed != 0) == 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(C * ((B + RB - 1) / RB), D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return streamed != 0 ? launch_cluster(gru_fwd<true>, C, grid, smem_bytes, st, gi, w_hh, b_hh,
                                        h0, T, D, B, H, RB, outs)
                       : launch_cluster(gru_fwd<false>, C, grid, smem_bytes, st, gi, w_hh, b_hh,
                                        h0, T, D, B, H, RB, outs);
}

// + outs, douts (T, D, B, H) -> dgi (T, D, B, 3H), dh0 (D, B, H),
// dw (D, H, 3H), db (D, 3H); dgh (T, D, B, 3H) is scratch, and red the
// GEMM's partial sums over `splits` splits (atb_scratch_floats).
int gru_chain_bwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
                  const float* outs, const float* douts, int T, int D, int B, int H, int C,
                  int RB, int smem_bytes, int streamed, int splits, float* dgi, float* dh0,
                  float* dw, float* db, float* dgh, float* red, void* stream) {
  if (chain_checked_smem(true, H, C, RB, smem_bytes, streamed != 0) == 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(C * ((B + RB - 1) / RB), D);
  cudaError_t err =
      streamed != 0 ? launch_cluster(gru_bwd<true>, C, grid, smem_bytes, st, gi, w_hh, b_hh, h0,
                                     outs, douts, T, D, B, H, RB, dgi, dh0, dgh)
                    : launch_cluster(gru_bwd<false>, C, grid, smem_bytes, st, gi, w_hh, b_hh, h0,
                                     outs, douts, T, D, B, H, RB, dgi, dh0, dgh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bh = static_cast<long long>(B) * H;
  const long long bh3 = 3 * bh;
  // dW_hh[d] = sum_{t,b} h_{t-1}^T dgh_t, db_hh[d] = sum_{t,b} dgh_t
  const Operand hprev{outs, h0, bh, D * bh, H, T, 0};
  const Operand grad{dgh, nullptr, bh3, D * bh3, 3 * H, 1, 0};
  return static_cast<int>(
      launch_atb(hprev, nullptr, 0, H, grad, 3 * H, T, B, D, splits, dw, db, red, st));
}

}  // extern "C"
