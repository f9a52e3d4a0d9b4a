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
// H = 384, C = 8, 4 rows). There the plan takes the wide layout of
// gru_wide.cuh: one cooperative wave of CTAs, each holding its units'
// slice of w_hh in shared memory for the whole call, a grid barrier a
// step (its header gives the design). gru_plan keeps the resident layout
// wherever it fits.
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
// (t, b) across clusters: tc_gemm.cuh's 3xTF32 tensor-core A^T X GEMM
// reads h_{t-1} in place and dgh from the sequential launch, in a fixed
// order (both layouts). No float atomics anywhere, so repeats are bitwise
// equal.
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
#include "gru_wide.cuh"

using namespace arvae;

namespace {

__global__ void __launch_bounds__(kThreads)
gru_fwd(const float* __restrict__ gi, const float* __restrict__ w_hh,
        const float* __restrict__ b_hh, const float* __restrict__ h0, int T, int D, int B,
        int H, int RB, float* __restrict__ outs) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const ChainLayout L = chain_layout(false, H, C, RB);
  float* ws = smem + L.w;
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

  load_slice(w_hh + static_cast<size_t>(d) * H * H3, b_hh + static_cast<size_t>(d) * H3, H, u0,
             L, ws, bs);
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
    rows_times_w(hcur, L.ldh, RB, H, ws, L.ldw, L.n3, part, gh_store);
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

// The row products' plain store: out[m * ld + n].
struct TcStore {
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const {
    out[static_cast<size_t>(m) * ld + n] = v;
  }
};

}  // namespace

extern "C" {

const char* gru_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of shared memory a CTA of the resident plan (H, C, RB) needs: the
// layout that ops/gru_kernel.py::chain_smem_floats mirrors.
int gru_chain_smem_floats(int bwd, int H, int C, int RB) {
  return chain_layout(bwd != 0, H, C, RB).total;
}

// Clusters of C CTAs of the resident forward (bwd 0) or backward kernel,
// smem_bytes each, that the card holds at once; a negative CUDA error
// code when the query fails.
int gru_chain_resident_clusters(int bwd, int C, int smem_bytes) {
  return bwd != 0 ? resident_clusters(gru_bwd, C, smem_bytes)
                  : resident_clusters(gru_fwd, C, smem_bytes);
}

// Floats of shared memory a CTA of the wide layout (U units a CTA) needs:
// the layout that ops/gru_kernel.py::wide_smem_floats mirrors.
int gru_chain_wide_smem_floats(int bwd, int H, int U) {
  return wide_layout(bwd != 0, H, U).total;
}

// CTAs of the wide forward (bwd 0) or backward kernel of U units a CTA,
// smem_bytes each, that the card holds at once; a negative CUDA error
// code when a query fails.
int gru_chain_wide_resident_ctas(int bwd, int U, int smem_bytes) {
  if (U != 16 && U != 32) return -static_cast<int>(cudaErrorInvalidValue);
  if (bwd != 0) {
    return U == 32 ? wide_resident_ctas(gru_wide_bwd<32>, smem_bytes)
                   : wide_resident_ctas(gru_wide_bwd<16>, smem_bytes);
  }
  return U == 32 ? wide_resident_ctas(gru_wide_fwd<32>, smem_bytes)
                 : wide_resident_ctas(gru_wide_fwd<16>, smem_bytes);
}

// gi (T, D, B, 3H), w_hh (D, H, 3H), b_hh (D, 3H), h0 (D, B, H) f32
// -> outs (T, D, B, H) f32; the resident plan: clusters of C CTAs of RB
// rows, smem_bytes of dynamic shared memory each.
int gru_chain_fwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
                  int T, int D, int B, int H, int C, int RB, int smem_bytes, float* outs,
                  void* stream) {
  if (chain_checked_smem(false, H, C, RB, smem_bytes) == 0) return cudaErrorInvalidValue;
  const dim3 grid(C * ((B + RB - 1) / RB), D);
  return launch_cluster(gru_fwd, C, grid, smem_bytes, static_cast<cudaStream_t>(stream), gi,
                        w_hh, b_hh, h0, T, D, B, H, RB, outs);
}

// dW_hh[d] = sum_{t,b} h_{t-1}^T dgh_t, db_hh[d] = sum_{t,b} dgh_t, in the
// splits' fixed order (red: atb_scratch_floats).
static cudaError_t weight_grads(const float* h0, const float* outs, const float* dgh, int T,
                                int D, int B, int H, int splits, float* dw, float* db,
                                float* red, cudaStream_t st) {
  const long long bh = static_cast<long long>(B) * H;
  const long long bh3 = 3 * bh;
  const Operand hprev{outs, h0, bh, D * bh, H, T, 0};
  const Operand grad{dgh, nullptr, bh3, D * bh3, 3 * H, 1, 0};
  return launch_atb(hprev, nullptr, 0, H, grad, 3 * H, T, B, D, splits, dw, db, red, st);
}

// + outs, douts (T, D, B, H) -> dgi (T, D, B, 3H), dh0 (D, B, H),
// dw (D, H, 3H), db (D, 3H); dgh (T, D, B, 3H) is scratch, and red the
// GEMM's partial sums over `splits` splits (atb_scratch_floats).
int gru_chain_bwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
                  const float* outs, const float* douts, int T, int D, int B, int H, int C,
                  int RB, int smem_bytes, int splits, float* dgi, float* dh0, float* dw,
                  float* db, float* dgh, float* red, void* stream) {
  if (chain_checked_smem(true, H, C, RB, smem_bytes) == 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(C * ((B + RB - 1) / RB), D);
  cudaError_t err = launch_cluster(gru_bwd, C, grid, smem_bytes, st, gi, w_hh, b_hh, h0, outs,
                                   douts, T, D, B, H, RB, dgi, dh0, dgh);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      weight_grads(h0, outs, dgh, T, D, B, H, splits, dw, db, red, st));
}

// The wide layout's forward: the plan is U units a CTA, rows batch rows a
// CTA, smem_bytes each; gh (T, D, B, 3H), where not null, receives
// h_{t-1} w_hh + b_hh for the backward; bar: 2 unsigned of scratch.
int gru_chain_wide_fwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
                       int T, int D, int B, int H, int U, int rows, int smem_bytes, float* outs,
                       float* gh, unsigned* bar, void* stream) {
  if (wide_checked_smem(false, H, U, rows, smem_bytes) == 0 || T < 1 || B < 1) {
    return cudaErrorInvalidValue;
  }
  const int ctas = wide_ctas(D, B, H, U, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return U == 32 ? launch_wide(gru_wide_fwd<32>, ctas, smem_bytes, bar, st, gi, w_hh, b_hh, h0,
                               T, D, B, H, rows, outs, gh, bar)
                 : launch_wide(gru_wide_fwd<16>, ctas, smem_bytes, bar, st, gi, w_hh, b_hh, h0,
                               T, D, B, H, rows, outs, gh, bar);
}

// The wide layout's backward, as gru_chain_bwd: gh is the wide
// forward's (T, D, B, 3H) kept pre-activations; bar: 2 unsigned of scratch.
int gru_chain_wide_bwd(const float* gi, const float* gh, const float* w_hh, const float* h0,
                       const float* outs, const float* douts, int T, int D, int B, int H, int U,
                       int rows, int smem_bytes, int splits, float* dgi, float* dh0, float* dw,
                       float* db, float* dgh, float* red, unsigned* bar, void* stream) {
  if (wide_checked_smem(true, H, U, rows, smem_bytes) == 0 || T < 1 || B < 1 ||
      gh == nullptr) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_wide_bwd(gi, gh, w_hh, h0, outs, douts, T, D, B, H, U, rows,
                                    smem_bytes, dgi, dh0, dgh, bar, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      weight_grads(h0, outs, dgh, T, D, B, H, splits, dw, db, red, st));
}

// The weight-gradient GEMM alone (tc_gemm.cuh's A^T X form), to hold it
// against its plain version and time it; no recurrence calls it:
//   out (D, M, N) = sum_{t, b} A(d, t, b, :)^T x(d, t, b, :),
//   bias (D, N) = sum_{t, b} x(d, t, b, :)   (where bias is not null),
// x (T, D, B, N); A dense a (T, D, B, M), or with a0 (D, B, M) the state
// one step back (a[t - 1], a0 at t = 0), or with tokens (T B,) the one-hot
// of tokens[s - tok_shift] (-1 for none, and the first tok_shift terms;
// D = 1). splits: the plan's (ops/gru_kernel.py::atb_splits); scratch
// holds atb_scratch_floats.
int gru_chain_atb(const float* a, const float* a0, const int* tokens, int tok_shift, int M,
                  const float* x, int N, int T, int D, int B, int splits, float* out,
                  float* bias, float* scratch, void* stream) {
  if ((tokens == nullptr) == (a == nullptr) || (tokens != nullptr && D != 1) ||
      (splits > 1 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const long long bm = static_cast<long long>(B) * M, bn = static_cast<long long>(B) * N;
  const Operand A{a, a0, bm, D * bm, M, a0 != nullptr ? T : 1, 0};
  const Operand X{x, nullptr, bn, D * bn, N, 1, 0};
  return static_cast<int>(launch_atb(A, tokens, tok_shift, M, X, N, T, B, D, splits, out, bias,
                                     scratch, static_cast<cudaStream_t>(stream)));
}

// A row product alone (tc_gemm.cuh's second form), likewise: out (M, N) =
// A (M, K, row stride lda) times W (K, N, row stride ldw), or with trans
// times W^T (W (N, K)).
int gru_chain_rows(const float* A, int lda, const float* W, int ldw, int M, int K, int N,
                   int trans, float* out, void* stream) {
  const TcStore store{out, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(trans != 0 ? launch_row_gemm<true>(A, lda, W, ldw, M, K, N, store, st)
                                     : launch_row_gemm<false>(A, lda, W, ldw, M, K, N, store, st));
}

// Dynamic shared memory of the engine's CTA (tc_gemm.cuh) by form (0: A^T
// X, 1: A W, 2: A W^T) and tile (TcTile), which ops/gru_kernel.py::
// tc_smem_bytes mirrors.
int gru_chain_tc_smem_bytes(int form, int tile) {
  auto of = [&](auto shape) {
    using S = decltype(shape);
    return form == 0 ? tc_smem_bytes<S, true, true>()
           : form == 1 ? tc_smem_bytes<S, false, true>()
                       : tc_smem_bytes<S, false, false>();
  };
  return tile == kTcBig       ? of(TcBig{})
         : tile == kTcNarrowM ? of(TcNarrowM{})
         : tile == kTcNarrowN ? of(TcNarrowN{})
                              : of(TcMid{});
}

// CTAs of the A^T X kernel of a tile that one SM holds at once (with its
// shared memory); a negative CUDA error code when a query fails.
int gru_chain_atb_ctas_an_sm(int tile) {
  auto query = [](auto kernel, int smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int n = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kTcThreads, smem);
    }
    return err == cudaSuccess ? n : -static_cast<int>(err);
  };
  return tile == kTcBig       ? query(atb_tc<TcBig>, tc_smem_bytes<TcBig, true, true>())
         : tile == kTcNarrowM ? query(atb_tc<TcNarrowM>, tc_smem_bytes<TcNarrowM, true, true>())
                              : query(atb_tc<TcNarrowN>, tc_smem_bytes<TcNarrowN, true, true>());
}

}  // extern "C"
