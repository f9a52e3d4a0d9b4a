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
// products, 24 steps at the encoder's shape. Each step is small, so the
// kernel is bound by latency (step after step), not by device memory or
// arithmetic throughput. The design keeps the whole chain in one launch:
// rows of the batch are independent, so a block owns a tile of RB rows of
// one direction and loops over t itself (the TPU's sequential grid axis
// becomes a loop inside the block). The tile's hidden state stays in
// shared memory across steps; w_hh is read from global memory each step,
// where it stays L2-resident (192 KB a direction at H = 128). Staging it
// in shared memory or running the products on the tensor cores is later
// work.
//
// Backward: the same row tiles walk t from T-1 down to 0, recompute the
// gates from h_{t-1} (outs[t-1], or h0 at t = 0) and gi_t instead of
// saving them, carry dh in shared memory, and write dgi_t. dW_hh and
// db_hh sum over (t, b) across row tiles: the sequential launch writes
// dgh_t to a scratch buffer, and the two-pass reduction of gru_common.cuh
// sums h_{t-1}^T dgh_t in a fixed order, so repeats are bitwise equal (no
// float atomics).
//
// Plain C interface, loaded with ctypes: each entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include "gru_common.cuh"

using namespace arvae;

namespace {

// Floats of dynamic shared memory per row of a tile, rounded up to a
// multiple of 4 so that every row array stays 16-byte aligned.
__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }
inline int fwd_floats_per_row(int H) { return up4(H) + up4(3 * H); }
inline int bwd_floats_per_row(int H) { return 2 * up4(H) + 2 * up4(3 * H); }

template <int RB>
__global__ void __launch_bounds__(kSeqThreads)
gru_fwd(const float* __restrict__ gi, const float* __restrict__ w_hh,
        const float* __restrict__ b_hh, const float* __restrict__ h0, int T, int D,
        int B, int H, float* __restrict__ outs) {
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H;
  float* h_s = smem;                // RB x H
  float* gh_s = h_s + up4(RB * H);  // RB x 3H
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * RB;
  const int nr = min(RB, B - row0);
  const float* w = w_hh + static_cast<size_t>(d) * H * H3;
  const float* bh = b_hh + static_cast<size_t>(d) * H3;

  for (int i = threadIdx.x; i < RB * H; i += blockDim.x) {
    const int r = i / H;
    h_s[i] = r < nr ? h0[(static_cast<size_t>(d) * B + row0) * H + i] : 0.f;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    block_matvec<RB>(h_s, H, w, H3, bh, nullptr, 0, nr, gh_s);
    __syncthreads();
    const size_t slab = (static_cast<size_t>(t) * D + d) * B + row0;
    const float* git = gi + slab * H3;
    float* ot = outs + slab * H;
    for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
      const int r = i / H;
      const int c = i - r * H;
      const float* g = git + static_cast<size_t>(r) * H3;
      const float* hh = gh_s + r * H3;
      const Gates q = gru_gates(g[c], g[H + c], g[2 * H + c], hh[c], hh[H + c], hh[2 * H + c]);
      const float hn = gru_out(q, h_s[i]);
      h_s[i] = hn;
      ot[i] = hn;
    }
    __syncthreads();
  }
}

template <int RB>
__global__ void __launch_bounds__(kSeqThreads)
gru_bwd(const float* __restrict__ gi, const float* __restrict__ w_hh,
        const float* __restrict__ b_hh, const float* __restrict__ h0,
        const float* __restrict__ outs, const float* __restrict__ douts, int T, int D,
        int B, int H, float* __restrict__ dgi, float* __restrict__ dh0,
        float* __restrict__ dgh) {
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H;
  float* hp_s = smem;                  // RB x H: h_{t-1}
  float* dh_s = hp_s + up4(RB * H);    // RB x H: the dh carry
  float* gh_s = dh_s + up4(RB * H);    // RB x 3H: h_{t-1} w_hh + b_hh
  float* dg_s = gh_s + up4(RB * H3);   // RB x 3H: dgh_t
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * RB;
  const int nr = min(RB, B - row0);
  const float* w = w_hh + static_cast<size_t>(d) * H * H3;
  const float* bh = b_hh + static_cast<size_t>(d) * H3;

  for (int i = threadIdx.x; i < RB * H; i += blockDim.x) dh_s[i] = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float* prev = t > 0 ? outs + ((static_cast<size_t>(t - 1) * D + d) * B + row0) * H
                              : h0 + (static_cast<size_t>(d) * B + row0) * H;
    for (int i = threadIdx.x; i < RB * H; i += blockDim.x) {
      hp_s[i] = i / H < nr ? prev[i] : 0.f;
    }
    __syncthreads();
    block_matvec<RB>(hp_s, H, w, H3, bh, nullptr, 0, nr, gh_s);
    __syncthreads();
    const size_t slab = (static_cast<size_t>(t) * D + d) * B + row0;
    const float* git = gi + slab * H3;
    const float* dot = douts + slab * H;
    float* dgit = dgi + slab * H3;
    float* dght = dgh + slab * H3;
    for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
      const int r = i / H;
      const int c = i - r * H;
      const size_t o = static_cast<size_t>(r) * H3;
      const float* g = git + o;
      const float* hh = gh_s + r * H3;
      const Gates q = gru_gates(g[c], g[H + c], g[2 * H + c], hh[c], hh[H + c], hh[2 * H + c]);
      const CellGrads gg = gru_cell_bwd(dot[i] + dh_s[i], q, hp_s[i]);
      dgit[o + c] = gg.dr;
      dgit[o + H + c] = gg.dz;
      dgit[o + 2 * H + c] = gg.dn;
      dght[o + c] = gg.dr;
      dght[o + H + c] = gg.dz;
      dght[o + 2 * H + c] = gg.dgh_n;
      dg_s[r * H3 + c] = gg.dr;
      dg_s[r * H3 + H + c] = gg.dz;
      dg_s[r * H3 + 2 * H + c] = gg.dgh_n;
      dh_s[i] = gg.dh_z;
    }
    __syncthreads();
    // dh_{t-1} = dh z + dgh_t @ w_hh^T
    block_matvec_t<RB>(dg_s, H3, w, H, nr, dh_s, H, true);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nr * H; i += blockDim.x) {
    dh0[(static_cast<size_t>(d) * B + row0) * H + i] = dh_s[i];
  }
}

// The largest row tile whose shared memory fits (8, 4, 2 or 1), or 0.
int rows_per_block(int floats_per_row) {
  for (int rb = 8; rb >= 1; rb /= 2) {
    if (static_cast<long long>(rb) * floats_per_row * 4 + 64 <= kMaxSmem) return rb;
  }
  return 0;
}

template <int RB>
cudaError_t launch_fwd(const float* gi, const float* w_hh, const float* b_hh,
                       const float* h0, int T, int D, int B, int H, float* outs,
                       cudaStream_t st) {
  const int smem = (up4(RB * H) + up4(RB * 3 * H)) * 4;
  cudaError_t err = cudaFuncSetAttribute(gru_fwd<RB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + RB - 1) / RB, D);
  gru_fwd<RB><<<grid, kSeqThreads, smem, st>>>(gi, w_hh, b_hh, h0, T, D, B, H, outs);
  return cudaGetLastError();
}

template <int RB>
cudaError_t launch_bwd(const float* gi, const float* w_hh, const float* b_hh,
                       const float* h0, const float* outs, const float* douts, int T,
                       int D, int B, int H, float* dgi, float* dh0, float* dgh,
                       cudaStream_t st) {
  const int smem = (2 * up4(RB * H) + 2 * up4(RB * 3 * H)) * 4;
  cudaError_t err = cudaFuncSetAttribute(gru_bwd<RB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + RB - 1) / RB, D);
  gru_bwd<RB><<<grid, kSeqThreads, smem, st>>>(gi, w_hh, b_hh, h0, outs, douts, T, D, B,
                                               H, dgi, dh0, dgh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gru_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows of the batch a block owns in the forward (0 = H too large).
int gru_chain_rows_fwd(int H) { return rows_per_block(fwd_floats_per_row(H)); }
// Rows of the batch a block owns in the backward (0 = H too large).
int gru_chain_rows_bwd(int H) { return rows_per_block(bwd_floats_per_row(H)); }

// gi (T, D, B, 3H), w_hh (D, H, 3H), b_hh (D, 3H), h0 (D, B, H) f32
// -> outs (T, D, B, H) f32.
int gru_chain_fwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
                  int T, int D, int B, int H, float* outs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gru_chain_rows_fwd(H)) {
    case 8: return launch_fwd<8>(gi, w_hh, b_hh, h0, T, D, B, H, outs, st);
    case 4: return launch_fwd<4>(gi, w_hh, b_hh, h0, T, D, B, H, outs, st);
    case 2: return launch_fwd<2>(gi, w_hh, b_hh, h0, T, D, B, H, outs, st);
    case 1: return launch_fwd<1>(gi, w_hh, b_hh, h0, T, D, B, H, outs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of the backward's reduction scratch.
long long gru_chain_reduce_floats(int T, int D, int B, int H) {
  return reduce_scratch_floats(H, true, 3 * H, T, B, D);
}

// + outs, douts (T, D, B, H) -> dgi (T, D, B, 3H), dh0 (D, B, H),
// dw (D, H, 3H), db (D, 3H); dgh (T, D, B, 3H) and red
// (gru_chain_reduce_floats) are scratch.
int gru_chain_bwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
                  const float* outs, const float* douts, int T, int D, int B, int H,
                  float* dgi, float* dh0, float* dw, float* db, float* dgh, float* red,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (gru_chain_rows_bwd(H)) {
    case 8: err = launch_bwd<8>(gi, w_hh, b_hh, h0, outs, douts, T, D, B, H, dgi, dh0, dgh, st); break;
    case 4: err = launch_bwd<4>(gi, w_hh, b_hh, h0, outs, douts, T, D, B, H, dgi, dh0, dgh, st); break;
    case 2: err = launch_bwd<2>(gi, w_hh, b_hh, h0, outs, douts, T, D, B, H, dgi, dh0, dgh, st); break;
    case 1: err = launch_bwd<1>(gi, w_hh, b_hh, h0, outs, douts, T, D, B, H, dgi, dh0, dgh, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bh = static_cast<long long>(B) * H;
  const long long bh3 = 3 * bh;
  // dW_hh[d] = sum_{t,b} h_{t-1}^T dgh_t, db_hh[d] = sum_{t,b} dgh_t
  const Operand hprev{outs, h0, bh, D * bh, H};
  const Operand grad{dgh, nullptr, bh3, D * bh3, 3 * H};
  return static_cast<int>(launch_reduce(hprev, nullptr, H, grad, 3 * H, T, B, D, dw, db, red, st));
}

}  // extern "C"
