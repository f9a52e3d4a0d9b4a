// The cluster kernel of the GRU chain's backward, shared by gru_chain.cu
// (the encoder's and the beat GRU's layers) and hier_tick_chain.cu (the
// tick loop's layers, one chain a beat): each library instantiates it.
// The design is described in gru_chain.cu's header; the launch plan
// (C, RB, shared-memory bytes, and whether w_hh's slice is resident or
// streamed) comes from the caller
// (arvae_tpu_torch/ops/gru_kernel.py::gru_plan, which mirrors
// chain_layout below) and chain_checked_smem refuses one that does not
// fit.
#pragma once

#include <cooperative_groups.h>

#include "gru_common.cuh"

namespace arvae {

namespace cg = cooperative_groups;

// Threads of a cluster kernel's CTA: one per (row, hidden unit) of its tile.
constexpr int kThreads = 512;

// Shared-memory layout of one CTA, in floats; every array starts on a
// 16-byte boundary.
struct ChainLayout {
  int hc, n3;              // hidden units the CTA owns, its gate columns
  int ldw, ldh, ldg, ldo;  // leading dimensions
  int w, b, h, gh, part;   // weight slice (or its two stages), bias slice, h (2 buffers),
                           // gh, product scratch
  int dg, dz, red;         // backward: dgh, dh z, reduce slots (2 x C)
  int total;
};

// Resident (stream false): the CTA's gate columns of w_hh, all H rows,
// loaded once. Streamed: two stages of kStreamDepth of those rows, read
// from L2 at every step (widths whose slices do not fit).
__host__ __device__ inline ChainLayout chain_layout(bool bwd, int H, int C, int RB,
                                                    bool stream = false) {
  ChainLayout L;
  L.hc = H / C;
  L.n3 = 3 * L.hc;
  L.ldw = slice_ld(L.n3);
  L.ldh = up4(H);
  L.ldg = up4(L.n3);
  L.ldo = up4(L.hc);
  int o = 0;
  L.w = o;
  o += (stream ? 2 * kStreamDepth : H) * L.ldw;
  L.b = o;
  o += L.ldg;
  L.h = o;
  o += 2 * RB * L.ldh;
  L.gh = o;
  o += RB * L.ldg;
  L.part = o;
  o += product_scratch_floats(kThreads);
  L.dg = L.dz = L.red = o;
  if (bwd) {
    L.dg = o;
    o += RB * L.ldg;
    L.dz = o;
    o += RB * L.ldo;
    L.red = o;
    o += 2 * C * RB * L.ldo;
  }
  L.total = o;
  return L;
}

// Rows [k0, k0 + kt) of the CTA's gate columns (hc units from u0, in
// each of the three gates) of a (K, 3H) weight into dst (kt x ldw), with
// cp.async.
__device__ __forceinline__ void load_gate_rows(float* dst, int ldw, const float* w, int H, int hc,
                                               int u0, int k0, int kt) {
  for (int g = 0; g < 3; ++g) {
    copy_tile(dst + g * hc, ldw, w + static_cast<size_t>(k0) * 3 * H + g * H + u0, 3 * H, kt, hc,
              kt);
  }
}

// A streamed product's loader of a (K, 3H) weight's gate-column slice.
struct GateRows {
  const float* w;
  int H, hc, u0, ldw;
  __device__ void operator()(float* dst, int k0, int kt) const {
    load_gate_rows(dst, ldw, w, H, hc, u0, k0, kt);
  }
};

// The CTA's gate columns of b_hh[d] into shared memory.
__device__ inline void load_bias(const float* bias, int H, int u0, const ChainLayout& L,
                                 float* bs) {
  for (int kk = threadIdx.x; kk < L.n3; kk += blockDim.x) {
    const int g = kk / L.hc;
    bs[kk] = bias[g * H + u0 + kk - g * L.hc];
  }
}

// The CTA's gate columns of w_hh[d] (all H rows) and b_hh[d] into shared
// memory: the resident layout.
__device__ inline void load_slice(const float* w, const float* bias, int H, int u0,
                                  const ChainLayout& L, float* ws, float* bs) {
  load_gate_rows(ws, L.ldw, w, H, L.hc, u0, 0, H);
  load_bias(bias, H, u0, L, bs);
}

// This thread's unit of the cell: row r of the tile, hidden unit u0 + i
// (the plan keeps RB * H / C <= kThreads, one unit a thread).
struct Unit {
  int r, i;
  bool live;  // a unit of the tile (r < RB)
  bool row;   // and a row of the batch (row0 + r < B)
};

__device__ __forceinline__ Unit my_unit(int RB, int hc, int nr) {
  Unit u;
  u.r = threadIdx.x / hc;
  u.i = threadIdx.x - u.r * hc;
  u.live = u.r < RB;
  u.row = u.r < nr;
  return u;
}

// The unit's three gate pre-activations of one row of gi (0 past B),
// read into registers a step ahead of their use.
__device__ __forceinline__ void load_gates(const float* row, int H, int u, bool in, float* g) {
#pragma unroll
  for (int k = 0; k < 3; ++k) g[k] = in ? row[k * H + u] : 0.f;
}

template <bool kStream>
__global__ void __launch_bounds__(kThreads)
gru_bwd(const float* __restrict__ gi, const float* __restrict__ w_hh,
        const float* __restrict__ b_hh, const float* __restrict__ h0,
        const float* __restrict__ outs, const float* __restrict__ douts, int T, int D, int B,
        int H, int RB, float* __restrict__ dgi, float* __restrict__ dh0,
        float* __restrict__ dgh) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const ChainLayout L = chain_layout(true, H, C, RB, kStream);
  float* ws = smem + L.w;  // the resident slice, or the streamed stages
  float* bs = smem + L.b;
  float* hps = smem + L.h;  // h_{t-1}, full width, 2 buffers
  float* ghs = smem + L.gh;
  float* part = smem + L.part;
  float* dgs = smem + L.dg;   // dgh_t, own columns
  float* dzs = smem + L.dz;   // dh z, own units
  float* red = smem + L.red;  // [parity][source CTA][RB][own units]
  const int H3 = 3 * H;
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * RB;
  const int nr = min(RB, B - row0);
  const int u0 = c * L.hc;
  const int hbuf = RB * L.ldh;
  const int obuf = RB * L.ldo;
  const Unit me = my_unit(RB, L.hc, nr);
  const int u = u0 + me.i;

  // step t's h_{t-1} rows into buffer t & 1 (cp.async), and its gi and
  // douts of this thread's unit into registers
  auto prefetch = [&](int t, float* g, float& dout) {
    const float* prev = t > 0 ? outs + ((static_cast<size_t>(t - 1) * D + d) * B + row0) * H
                              : h0 + (static_cast<size_t>(d) * B + row0) * H;
    copy_tile(hps + (t & 1) * hbuf, L.ldh, prev, H, RB, H, nr);
    cp_async_commit();
    const size_t row = (static_cast<size_t>(t) * D + d) * B + row0 + me.r;
    load_gates(gi + row * H3, H, u, me.row, g);
    dout = me.row ? douts[row * H + u] : 0.f;
  };

  const float* wd = w_hh + static_cast<size_t>(d) * H * H3;
  const GateRows rows{wd, H, L.hc, u0, L.ldw};
  if (kStream) {
    load_bias(b_hh + static_cast<size_t>(d) * H3, H, u0, L, bs);
  } else {
    load_slice(wd, b_hh + static_cast<size_t>(d) * H3, H, u0, L, ws, bs);
  }
  float gn[3], dn;
  prefetch(T - 1, gn, dn);
  cp_async_wait<0>();
  cluster.sync();  // every peer runs: its shared memory may be written

  for (int t = T - 1; t >= 0; --t) {
    const int cur = t & 1;
    const float gcur[3] = {gn[0], gn[1], gn[2]};
    const float dcur = dn;
    if (t > 0) {
      prefetch(t - 1, gn, dn);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* hp = hps + cur * hbuf;
    // recompute gh = h_{t-1} w_hh[:, own] + b_hh[own]
    auto gh_store = [&](int r, int n, float v) { ghs[r * L.ldg + n] = v + bs[n]; };
    if (kStream) {
      streamed_times_w(hp, L.ldh, RB, H, L.n3, rows, ws, L.ldw, ghs, L.ldg, part, gh_store);
    } else {
      rows_times_w(hp, L.ldh, RB, H, ws, L.ldw, L.n3, part, gh_store);
    }
    __syncthreads();
    if (me.live) {
      const float* q = ghs + me.r * L.ldg;
      const Gates G = gru_gates(gcur[0], gcur[1], gcur[2], q[me.i], q[L.hc + me.i],
                                q[2 * L.hc + me.i]);
      float dh = dcur;
      if (t < T - 1) {  // + dh z + step t+1's partials of dgh w_hh^T
        const float* carry = red + ((t + 1) & 1) * C * obuf + me.r * L.ldo + me.i;
        float s = carry[0];
        for (int p = 1; p < C; ++p) s += carry[p * obuf];
        dh += dzs[me.r * L.ldo + me.i] + s;
      }
      const CellGrads cgr = gru_cell_bwd(dh, G, hp[me.r * L.ldh + u]);
      if (me.row) {
        const size_t o = ((static_cast<size_t>(t) * D + d) * B + row0 + me.r) * H3;
        dgi[o + u] = cgr.dr;
        dgi[o + H + u] = cgr.dz;
        dgi[o + 2 * H + u] = cgr.dn;
        dgh[o + u] = cgr.dr;
        dgh[o + H + u] = cgr.dz;
        dgh[o + 2 * H + u] = cgr.dgh_n;
      }
      float* dg = dgs + me.r * L.ldg;
      dg[me.i] = cgr.dr;
      dg[L.hc + me.i] = cgr.dz;
      dg[2 * L.hc + me.i] = cgr.dgh_n;
      dzs[me.r * L.ldo + me.i] = cgr.dh_z;
    }
    __syncthreads();
    // dgh_t w_hh^T over the own columns, for every unit j, into slot c
    // of j's owner
    const int slot = ((t & 1) * C + c) * obuf;
    auto red_store = [&](int r, int j, float v) {
      const int o = j / L.hc;
      *cluster.map_shared_rank(red + slot + r * L.ldo + j - o * L.hc, o) = v;
    };
    if (kStream) {
      streamed_times_wt(dgs, L.ldg, RB, L.n3, H, rows, ws, L.ldw, part, red_store);
    } else {
      rows_times_wt(dgs, L.ldg, RB, L.n3, ws, L.ldw, H, part, red_store);
    }
    cluster.sync();
  }
  // dh0 = dh z + the partials of step 0
  if (me.row) {
    const float* p0 = red + me.r * L.ldo + me.i;
    float s = p0[0];
    for (int p = 1; p < C; ++p) s += p0[p * obuf];
    dh0[(static_cast<size_t>(d) * B + row0 + me.r) * H + u] = dzs[me.r * L.ldo + me.i] + s;
  }
}

// Refuses a plan the kernels cannot run: returns the shared-memory bytes
// it needs, or 0.
inline int chain_checked_smem(bool bwd, int H, int C, int RB, int smem_bytes, bool stream) {
  if (C < 1 || C > 8 || (C & (C - 1)) != 0 || H < 1 || H % C != 0) return 0;
  if (RB < kRowsPerThread || RB % kRowsPerThread != 0 || RB * (H / C) > kThreads) return 0;
  const long long need = 4LL * chain_layout(bwd, H, C, RB, stream).total;
  if (need > kMaxSmem || smem_bytes < need || smem_bytes > kMaxSmem) return 0;
  return static_cast<int>(need);
}

// The cluster launch configuration of a kernel: clusters of C CTAs of
// kThreads threads, smem bytes of dynamic shared memory each.
struct ClusterConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterConfig(int C, dim3 grid, int smem, cudaStream_t st) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of C CTAs of `kernel`, smem bytes each, that the card holds at
// once (cudaOccupancyMaxActiveClusters); a negative CUDA error code when
// the query fails.
template <class... Params>
inline int resident_clusters(void (*kernel)(Params...), int C, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  ClusterConfig cc(C, dim3(C * 1024), smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cc.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <class... Params, class... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), int C, dim3 grid, int smem,
                           cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ClusterConfig cc(C, grid, smem, st);
  err = cudaLaunchKernelEx(&cc.cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace arvae
