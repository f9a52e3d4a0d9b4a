// AR pairwise regulariser for Hopper (sm_90a): one launch for the losses
// and their gradient factors, one launch for the gradient.
//
// Replaces the Pallas TPU kernel pair of
// arvae_tpu/ops/reg_pallas.py::fused_reg_loss (_fwd_kernel, _bwd_kernel).
// Per regularised dim r, over the latent column z = z_tilde[:, zc_r] and
// the attribute column a = labels[:, ac_r] of a batch of B, with
// t = tanh(delta (z_i - z_j)) and s = sign(a_i - a_j):
//
//   loss[r] = 1/B^2 sum_ij | t - s |
//
// The cotangent of a per-dim loss is one scalar ct_r, so the forward also
// computes, from the same t, the factors the gradient needs:
//
//   G[r, i] = 2 delta / B^2 sum_j sign(t - s) (1 - t^2)
//   D[r]    = 1/B^2 sum_ij sign(t - s) (1 - t^2) (z_i - z_j)
//
// (the pair term g_ij = sign(t - s)(1 - t^2) is odd under i <-> j, which
// folds the column sum of dz into the row sum), and the backward is a
// scale: dz_tilde[i, zc_r] = sum over r, ascending, of ct_r G[r, i];
// ddelta = sum_r ct_r D[r].
//
// What bounds it: at the training shapes ((R, B) = (5, 128), (4, 256)) a
// call is 82k-262k pairs over a few kilobytes, so it is bound by launch
// latency, not by device memory or arithmetic. The design therefore
// spends one launch a direction and spreads the pairs over the card:
// - reg_fwd: a thread-block cluster of C CTAs a dim r. CTA c owns rows
//   [c RB, (c+1) RB); its threads are (row, slice) items, each walking
//   every S-th column j of the row, so no thread idles because B is
//   smaller than the block. The columns are read in place through their
//   strides into shared memory. G's slice sums are added per row in a
//   fixed order; each CTA's loss and D partials are added by rank 0
//   through distributed shared memory, c = 0 .. C-1, after a cluster
//   barrier. No scratch buffer, no second launch, no float atomic: two
//   runs on the same input give bitwise-equal results. Without a
//   gradient (kFactors = false) G and D are skipped.
// - reg_bwd: one thread an element of the whole (B, Z) gradient of
//   z_tilde, zero in the columns no dim names; thread 0 adds ddelta over
//   r in order.
// The plan (C, RB, S, threads) comes from ops/reg_kernel.py::reg_plan;
// reg_loss_fwd refuses a plan the kernel cannot run.
//
// sign(0) = 0 in both directions, written as (x > 0) - (x < 0): the
// diagonal and tied labels (common, since dSprites labels are discrete)
// contribute nothing to the loss or its factors. tanhf is the accurate
// one (tanh.approx.f32 errs by about 2^-11).
//
// Plain C interface, loaded with ctypes: each entry launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDims = 32;     // regularised dims a call, passed by value
constexpr int kMaxThreads = 1024;
constexpr int kMaxClusters = 8;  // CTAs a cluster (the portable limit)
constexpr int kTile = 2048;      // columns staged in shared memory at once
constexpr int kBwdThreads = 256;

struct Columns {
  const float* base;
  long long stride_b;    // between samples
  long long stride_col;  // between columns
  int col[kMaxDims];     // the column of each regularised dim
};

struct FwdArgs {
  Columns z, a;
  const float* delta;
  int b, rows, slices;
  float* loss;  // (R,)
  float* g;     // (R, B), or null without factors
  float* d;     // (R,), or null without factors
};

struct BwdArgs {
  const float* g;
  const float* d;
  const float* ct;
  long long ct_stride;  // 0 for the expanded cotangent of a sum
  int r_dims, b, z_dims, col_inner;
  int col[kMaxDims];
  float* dz;  // (B, Z) with the strides below
  long long stride_b, stride_col;
  float* ddelta;  // (1,), or null
};

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

__device__ __forceinline__ float inv_b2(int b) {
  return static_cast<float>(1.0 / (static_cast<double>(b) * b));
}

// Stages columns [j0, j0 + n) of a dim's z and a into shared memory.
__device__ __forceinline__ void stage(const float* zc, long long zs_b, const float* ac,
                                      long long as_b, int j0, int n, float* zs,
                                      float* as) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    zs[j] = zc[(j0 + j) * zs_b];
    as[j] = ac[(j0 + j) * as_b];
  }
}

// grid (C, R), clusters of C CTAs along x: one cluster a dim r.
template <bool kFactors>
__global__ void __launch_bounds__(kMaxThreads) reg_fwd(const FwdArgs p) {
  __shared__ float zs[kTile];
  __shared__ float as[kTile];
  __shared__ float part[kMaxThreads];  // each item's slice sum of G
  __shared__ float red[2][kMaxThreads];
  __shared__ float cta[2];  // this CTA's loss and D partials, read by rank 0

  cg::cluster_group cluster = cg::this_cluster();
  const int r = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = p.b, S = p.slices;
  const float* zc = p.z.base + p.z.col[r] * p.z.stride_col;
  const float* ac = p.a.base + p.a.col[r] * p.a.stride_col;
  const float delta = *p.delta;
  const int row0 = rank * p.rows;
  const int nrows = max(0, min(p.rows, b - row0));
  const int items = nrows * S;  // a multiple of S: a pass of nt items holds whole rows
  const bool one_tile = b <= kTile;

  if (one_tile) {
    stage(zc, p.z.stride_b, ac, p.a.stride_b, 0, b, zs, as);
    __syncthreads();
  }
  float lsum = 0.f, dsum = 0.f;
  for (int k0 = 0; k0 < items; k0 += nt) {
    const int k = k0 + tid;
    const bool on = k < items;
    const int i = row0 + (on ? k / S : 0);
    const int s = k % S;
    const float zi = on ? zc[i * p.z.stride_b] : 0.f;
    const float ai = on ? ac[i * p.a.stride_b] : 0.f;
    float l = 0.f, g = 0.f, gd = 0.f;
    for (int j0 = 0; j0 < b; j0 += kTile) {
      const int n = min(kTile, b - j0);
      if (!one_tile) {
        __syncthreads();
        stage(zc, p.z.stride_b, ac, p.a.stride_b, j0, n, zs, as);
        __syncthreads();
      }
      if (on) {
        for (int j = s; j < n; j += S) {
          const float dz = zi - zs[j];
          const float t = tanhf(delta * dz);
          const float e = t - sign_of(ai - as[j]);
          l += fabsf(e);
          if (kFactors) {
            const float core = sign_of(e) * (1.f - t * t);
            g += core;
            gd += core * dz;
          }
        }
      }
    }
    lsum += l;
    if (kFactors) {
      dsum += gd;
      part[tid] = g;
      __syncthreads();
      const int row = k0 / S + tid;  // the pass's rows, nt / S of them
      if (tid < nt / S && row < nrows) {
        float acc = 0.f;
        for (int q = 0; q < S; ++q) acc += part[tid * S + q];
        p.g[static_cast<size_t>(r) * b + row0 + row] = 2.f * delta * inv_b2(b) * acc;
      }
      __syncthreads();
    }
  }

  // the CTA's partials: a fixed tree over its threads (a power of two)
  red[0][tid] = lsum;
  red[1][tid] = dsum;
  __syncthreads();
  for (int h = nt / 2; h > 0; h >>= 1) {
    if (tid < h) {
      red[0][tid] += red[0][tid + h];
      red[1][tid] += red[1][tid + h];
    }
    __syncthreads();
  }
  if (tid == 0) {
    cta[0] = red[0][0];
    cta[1] = red[1][0];
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float loss = 0.f, dd = 0.f;
    const int C = static_cast<int>(cluster.num_blocks());
    for (int c = 0; c < C; ++c) {
      const float* peer = cluster.map_shared_rank(cta, c);
      loss += peer[0];
      dd += peer[1];
    }
    p.loss[r] = loss * inv_b2(b);
    if (kFactors) p.d[r] = dd * inv_b2(b);
  }
  cluster.sync();  // every CTA keeps its shared memory until rank 0 has read it
}

// grid ceil(B Z / kBwdThreads): one thread an element of dz_tilde.
__global__ void __launch_bounds__(kBwdThreads) reg_bwd(const BwdArgs p) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e == 0 && p.ddelta != nullptr) {
    float s = 0.f;
    for (int r = 0; r < p.r_dims; ++r) s += p.ct[r * p.ct_stride] * p.d[r];
    *p.ddelta = s;
  }
  if (e >= static_cast<long long>(p.b) * p.z_dims) return;
  // consecutive threads on consecutive addresses of dz
  const int i = static_cast<int>(p.col_inner ? e / p.z_dims : e % p.b);
  const int c = static_cast<int>(p.col_inner ? e % p.z_dims : e / p.b);
  float acc = 0.f;
  for (int r = 0; r < p.r_dims; ++r) {
    if (p.col[r] == c) acc += p.ct[r * p.ct_stride] * p.g[static_cast<size_t>(r) * p.b + i];
  }
  p.dz[i * p.stride_b + c * p.stride_col] = acc;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// The plans reg_fwd runs: see ops/reg_kernel.py::reg_plan.
bool plan_ok(int r_dims, int b, int clusters, int rows, int slices, int threads) {
  return r_dims >= 1 && r_dims <= kMaxDims && b >= 1 && pow2(clusters) &&
         clusters <= kMaxClusters && pow2(threads) && threads >= 32 &&
         threads <= kMaxThreads && pow2(slices) && slices <= threads && rows >= 1 &&
         static_cast<long long>(rows) * clusters >= b;
}

cudaLaunchConfig_t cluster_config(int clusters, int r_dims, int threads,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, r_dims);
  cfg.blockDim = dim3(threads);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

Columns columns(const float* base, long long stride_b, long long stride_col,
                const int* cols, int r_dims) {
  Columns c{base, stride_b, stride_col, {}};
  for (int r = 0; r < r_dims; ++r) c.col[r] = cols[r];
  return c;
}

}  // namespace

extern "C" {

const char* reg_loss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most regularised dims a call takes.
int reg_loss_max_dims() { return kMaxDims; }

// Clusters of `clusters` CTAs of `threads` threads of the forward that
// the card holds at once (cudaOccupancyMaxActiveClusters); a negative
// CUDA error code when the query fails.
int reg_loss_resident_clusters(int clusters, int threads) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(clusters, 1024, threads, attr);
  int n = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&n, reg_fwd<true>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// z: latent columns z[i * z_sb + z_cols[r] * z_sc]; a: attribute columns
// likewise; delta: (1,) f32; r_dims <= reg_loss_max_dims() dims of a
// batch of b; the plan (clusters, rows, slices, threads). Writes
// loss (R,) and, when g and d are both given, G (R, B) and D (R,).
int reg_loss_fwd(const float* z, long long z_sb, long long z_sc, const int* z_cols,
                 const float* a, long long a_sb, long long a_sc, const int* a_cols,
                 const float* delta, int r_dims, int b, int clusters, int rows,
                 int slices, int threads, float* loss, float* g, float* d,
                 void* stream) {
  if (!plan_ok(r_dims, b, clusters, rows, slices, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool factors = g != nullptr && d != nullptr;
  const FwdArgs p{columns(z, z_sb, z_sc, z_cols, r_dims),
                  columns(a, a_sb, a_sc, a_cols, r_dims),
                  delta, b, rows, slices, loss, factors ? g : nullptr,
                  factors ? d : nullptr};
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(clusters, r_dims, threads, attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = factors ? cudaLaunchKernelEx(&cfg, reg_fwd<true>, p)
                            : cudaLaunchKernelEx(&cfg, reg_fwd<false>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// g: (R, B) and d: (R,) from reg_loss_fwd; ct: the (R,) cotangent of the
// losses, ct[r * ct_stride]; z_cols: the column of each dim in dz, a
// (B, z_dims) tensor dz[i * dz_sb + c * dz_sc], written whole; ddelta:
// (1,) or null.
int reg_loss_bwd(const float* g, const float* d, const float* ct, long long ct_stride,
                 const int* z_cols, int r_dims, int b, int z_dims, float* dz,
                 long long dz_sb, long long dz_sc, float* ddelta, void* stream) {
  if (r_dims < 1 || r_dims > kMaxDims || b < 1 || z_dims < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs p{g, d, ct, ct_stride, r_dims, b, z_dims, dz_sc <= dz_sb ? 1 : 0, {},
            dz, dz_sb, dz_sc, ddelta};
  for (int r = 0; r < r_dims; ++r) p.col[r] = z_cols[r];
  const long long n = static_cast<long long>(b) * z_dims;
  const int blocks = static_cast<int>((n + kBwdThreads - 1) / kBwdThreads);
  reg_bwd<<<blocks, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
