// Weight gradient of a 4x4 convolution or transposed convolution for
// Hopper (sm_90a): fp32 FFMA, a fixed order of summation, two launches.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It exists because cuDNN's deterministic weight gradient
// (wgrad2d_grouped_direct_kernel), which the image trainers need for a
// step that repeats bitwise, ran the dSprites VAE's 8 weight gradients at
// about 1% of their fp32 bound (3.97 ms of a 5.93 ms step on an H100).
//
// Both layers' weight gradient is one contraction. With the small map S
// (B, M, Hs, Ws), the large map L (B, C, Hl, Wl), stride s and padding p:
//
//   dW[m, c, kh, kw] = sum over (b, i, j) of
//                      S[b, m, i, j] * L[b, c, i s - p + kh, j s - p + kw]
//
// with L read as 0 outside its bounds. A convolution's S is its output's
// gradient and L its input (dW is (C_out, C_in, 4, 4)); a transposed
// convolution's S is its input and L its output's gradient (dW is
// (C_in, C_out, 4, 4)). So dW is an (M, N) matrix, N = 16 C, summed over
// K = B Hs Ws positions: small in M and N, long in K.
//
// What bounds it: at the dSprites VAE's shapes (M = 32, N = 16 or 512,
// K = 2,048 to 131,072) the 8 layers are 3.09 GFLOP over about 93 MB of
// maps, 46 us at the card's fp32 peak and 28 us of bytes. The design:
// - pass 1 (conv_wgrad_partial): a CTA of 512 threads owns an (mt, ct)
//   tile of dW (mt rows m, ct channels c, all 16 window taps) and a fixed
//   run of the K rows (b, i), its split. The plan (mt, ct, groups, rows,
//   stages, splits; ops/conv_wgrad_kernel.py::conv_wgrad_plan) comes from
//   the shape alone, so the order of every sum depends on nothing but the
//   inputs. The CTA walks its rows in chunks of up to `rows` rows of one
//   image. A chunk's S rows (position-major) and the L rows under their
//   windows (padding zero-filled) are staged in shared memory with
//   cp.async, in a ring of `stages` buffers issued that many chunks
//   ahead, so each element comes from device memory once a chunk and not
//   16 times, and a CTA of small images waits on one latency and not on
//   one a chunk. A thread holds an 8 x 8 block of the tile in registers:
//   8 rows m by 2 window rows x 4 columns of one channel. A position
//   costs it 2 float4 loads of S (broadcast across the lanes that share
//   m), 8 loads of L (lanes run over channels, whose stride in shared
//   memory is odd, so no bank conflict) and 64 FFMA. The 512 threads hold
//   the tile `groups` times: group g takes every groups-th position of a
//   chunk, and the groups' blocks are added in group order in shared
//   memory at the end (G >= 2: a tile has at most 256 blocks). The CTA
//   writes its tile of the partial sum.
// - pass 2 (conv_wgrad_sum): dW = the partials added over the splits,
//   four threads an output, each over a quarter of the splits in order,
//   then (q0 + q1) + (q2 + q3).
// No atomics: two calls on the same inputs give bitwise-equal results.
// No tensor core and no TF32: FFMA with fp32 accumulation.
//
// Plain C interface, loaded with ctypes: the entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;          // a CTA of pass 1
constexpr int kTaps = 16;              // a 4 x 4 window
constexpr int kBlock = 64;             // a thread's 8 x 8 block of the tile
constexpr int kMaxStages = 8;          // staging buffers in flight
constexpr int kMaxSmem = 232448;       // bytes of shared memory a block can use
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;        // devices a process can launch on
constexpr int kSumThreads = 256;       // a CTA of pass 2
constexpr int kSumWays = 4;            // threads an output in pass 2

struct Args {
  const float* s;  // the small map (B, M, Hs, Ws)
  const float* l;  // the large map (B, C, Hl, Wl)
  float* out;      // (splits, M, N) partials; dW (M, N) when splits == 1
  int b, m, hs, ws, c, hl, wl, stride, pad;
  int mt, ct, groups, rows, stages, splits;  // the plan
  int lw;        // L columns under a row of positions: (ws - 1) s + 4
  int cs;        // a channel's stride in the L buffer (odd)
  int sp;        // a position's stride in the S buffer: mt + 4
  int s_floats;  // floats of a buffer's S part (a multiple of 4)
  int buf;       // floats of a buffer: its S part, then its L part
};

// The buffers of a plan, in floats, and the block's shared memory in bytes.
struct Layout {
  int lw, cs, sp, s_floats, buf, smem;
};

Layout layout(int ws, int stride, int mt, int ct, int rows, int stages) {
  Layout y;
  y.lw = (ws - 1) * stride + 4;
  const int lr = (rows - 1) * stride + 4;
  y.cs = (lr * y.lw) | 1;
  y.sp = mt + 4;
  y.s_floats = rows * ws * y.sp;
  y.buf = (y.s_floats + ct * y.cs + 3) & ~3;
  const int staging = stages * y.buf;
  const int reduce = kThreads * kBlock;
  y.smem = 4 * (staging > reduce ? staging : reduce);
  return y;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Waits until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_wait_at_most(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<kMaxStages - 1>(); break;
  }
}

// A chunk: rows i0 .. i0 + nr - 1 of image b, the first at K row u.
struct Chunk {
  int b, i0, nr;
};

__device__ __forceinline__ Chunk chunk_at(const Args& a, int u, int u1) {
  Chunk k;
  k.b = u / a.hs;
  k.i0 = u - k.b * a.hs;
  k.nr = min(min(a.rows, u1 - u), a.hs - k.i0);
  return k;
}

// Issues the cp.asyncs of chunk k into `buf`: the S rows as (position,
// m), and the L rows under their windows as (c, row, column) with the
// padding's columns and rows zero-filled.
__device__ __forceinline__ void stage(const Args& a, const Chunk& k, int m0, int c0,
                                      float* buf) {
  const int t = threadIdx.x;
  {
    const int p = k.nr * a.ws;
    const size_t plane = static_cast<size_t>(a.hs) * a.ws;
    const float* src = a.s + (static_cast<size_t>(k.b) * a.m + m0) * plane +
                       static_cast<size_t>(k.i0) * a.ws;
    int m = t / p, q = t - m * p;
    const int dm = kThreads / p, dq = kThreads - dm * p;
    while (m < a.mt) {
      cp_async4(buf + q * a.sp + m, src + m * plane + q, true);
      q += dq;
      m += dm;
      if (q >= p) {
        q -= p;
        ++m;
      }
    }
  }
  {
    float* lsm = buf + a.s_floats;
    const int lr = (k.nr - 1) * a.stride + 4;
    const int y0 = k.i0 * a.stride - a.pad;
    const size_t plane = static_cast<size_t>(a.hl) * a.wl;
    const float* src = a.l + (static_cast<size_t>(k.b) * a.c + c0) * plane;
    int col = t % a.lw;
    const int rest = t / a.lw;
    int row = rest % lr, ch = rest / lr;
    const int dcol = kThreads % a.lw, drest = kThreads / a.lw;
    const int drow = drest % lr, dch = drest / lr;
    while (ch < a.ct) {
      const int y = y0 + row, x = col - a.pad;
      const bool ok = y >= 0 && y < a.hl && x >= 0 && x < a.wl;
      cp_async4(lsm + ch * a.cs + row * a.lw + col,
                ok ? src + ch * plane + static_cast<size_t>(y) * a.wl + x : a.l, ok);
      col += dcol;
      row += drow;
      ch += dch;
      if (col >= a.lw) {
        col -= a.lw;
        ++row;
      }
      if (row >= lr) {
        row -= lr;
        ++ch;
      }
    }
  }
}

// grid (splits, C / ct, M / mt): the tile (m0, c0) of split blockIdx.x.
__global__ void __launch_bounds__(kThreads, 1) conv_wgrad_partial(const Args a) {
  extern __shared__ float4 conv_wgrad_smem[];
  float* smem = reinterpret_cast<float*>(conv_wgrad_smem);
  const int t = threadIdx.x;
  const int split = blockIdx.x, c0 = blockIdx.y * a.ct, m0 = blockIdx.z * a.mt;
  // the thread's block: channel cl, rows m 8 mi .. 8 mi + 7, window rows
  // 2 khp and 2 khp + 1; group g
  const int mb = a.mt / 8;
  const int cl = t % a.ct;
  const int mi = (t / a.ct) % mb;
  const int khp = (t / (a.ct * mb)) & 1;
  const int g = t / (2 * a.ct * mb);
  const int units = a.b * a.hs;
  const int u0 = static_cast<int>(static_cast<long long>(split) * units / a.splits);
  const int u1 = static_cast<int>(static_cast<long long>(split + 1) * units / a.splits);
  const int dr = a.groups / a.ws, dj = a.groups - dr * a.ws;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // chunk n is staged in buffer n % stages, issued stages - 1 chunks ahead
  int issue = u0;
  for (int b = 0; b + 1 < a.stages; ++b) {
    if (issue < u1) {
      const Chunk k = chunk_at(a, issue, u1);
      stage(a, k, m0, c0, smem + b * a.buf);
      issue += k.nr;
    }
    cp_commit();
  }
  int u = u0, n = 0;
  while (u < u1) {
    const Chunk k = chunk_at(a, u, u1);
    if (issue < u1) {
      const Chunk next = chunk_at(a, issue, u1);
      stage(a, next, m0, c0, smem + ((n + a.stages - 1) % a.stages) * a.buf);
      issue += next.nr;
    }
    cp_commit();
    cp_wait_at_most(a.stages - 1);
    __syncthreads();
    const float* buf = smem + (n % a.stages) * a.buf;
    const float* sb = buf + 8 * mi;
    const float* lb = buf + a.s_floats + cl * a.cs + 2 * khp * a.lw;
    const int p = k.nr * a.ws;
    int r = g / a.ws, j = g - (g / a.ws) * a.ws;
#pragma unroll 2
    for (int q = g; q < p; q += a.groups) {
      const float* sq = sb + q * a.sp;
      const float4 x0 = *reinterpret_cast<const float4*>(sq);
      const float4 x1 = *reinterpret_cast<const float4*>(sq + 4);
      const float* lq = lb + (r * a.lw + j) * a.stride;
      const float w[8] = {lq[0], lq[1], lq[2], lq[3],
                          lq[a.lw], lq[a.lw + 1], lq[a.lw + 2], lq[a.lw + 3]};
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int mm = 0; mm < 8; ++mm)
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) acc[mm][nn] = fmaf(x[mm], w[nn], acc[mm][nn]);
      j += dj;
      r += dr;
      if (j >= a.ws) {
        j -= a.ws;
        ++r;
      }
    }
    __syncthreads();
    u += k.nr;
    ++n;
  }
  cp_wait<0>();

  const int nw = a.c * kTaps;
  float* out = a.out + static_cast<size_t>(split) * a.m * nw;
  // the groups' blocks, added in group order
  const int nt = a.ct * kTaps, tile = a.mt * nt;
  float* mine = smem + g * tile + 8 * mi * nt + cl * kTaps + 8 * khp;
  __syncthreads();
#pragma unroll
  for (int mm = 0; mm < 8; ++mm) {
    reinterpret_cast<float4*>(mine + mm * nt)[0] =
        make_float4(acc[mm][0], acc[mm][1], acc[mm][2], acc[mm][3]);
    reinterpret_cast<float4*>(mine + mm * nt)[1] =
        make_float4(acc[mm][4], acc[mm][5], acc[mm][6], acc[mm][7]);
  }
  __syncthreads();
  for (int o = t; o < tile; o += kThreads) {
    float v = smem[o];
    for (int gg = 1; gg < a.groups; ++gg) v += smem[gg * tile + o];
    const int row = o / nt;
    out[static_cast<size_t>(m0 + row) * nw + c0 * kTaps + (o - row * nt)] = v;
  }
}

// dW[o] = the partials of output o added over the splits: thread q of
// an output's four adds splits [q S / 4, (q + 1) S / 4) in order.
__global__ void __launch_bounds__(kSumThreads) conv_wgrad_sum(const float* __restrict__ part,
                                                             float* __restrict__ dw,
                                                             int splits, int mn) {
  const int id = blockIdx.x * kSumThreads + threadIdx.x;
  const int o = id / kSumWays, q = id % kSumWays;
  float v = 0.f;
  if (o < mn) {
    const int s1 = (q + 1) * splits / kSumWays;
#pragma unroll 4
    for (int s = q * splits / kSumWays; s < s1; ++s) v += part[static_cast<size_t>(s) * mn + o];
  }
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if (o < mn && q == 0) dw[o] = v;
}

bool plan_ok(int b, int m, int hs, int ws, int c, int hl, int wl, int stride, int pad,
             int mt, int ct, int groups, int rows, int stages, int splits) {
  if (b < 1 || hs < 1 || ws < 1 || hl < 1 || wl < 1 || stride < 1 || pad < 0 || pad > 3)
    return false;
  if (!(mt == 8 || mt == 16 || mt == 32) || m % mt != 0) return false;
  if (ct < 1 || ct > 32 || (ct & (ct - 1)) != 0 || c % ct != 0) return false;
  if (groups * (mt / 8) * 2 * ct != kThreads) return false;
  if (rows < 1 || rows > hs || stages < 1 || stages > kMaxStages || splits < 1 ||
      splits > b * hs)
    return false;
  return layout(ws, stride, mt, ct, rows, stages).smem <= kMaxSmem;
}

}  // namespace

extern "C" {

const char* conv_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Threads a CTA of pass 1.
int conv_wgrad_threads() { return kThreads; }

// Bytes of shared memory pass 1 takes under a plan.
int conv_wgrad_smem_bytes(int ws, int stride, int mt, int ct, int rows, int stages) {
  return layout(ws, stride, mt, ct, rows, stages).smem;
}

// s: the small map (B, M, Hs, Ws) and l: the large map (B, C, Hl, Wl),
// contiguous float32; the plan (mt, ct, groups, rows, stages, splits); partials:
// (splits, M, 16 C) floats of scratch, unused (may be null) when splits
// is 1. Writes dw: (M, 16 C).
int conv_wgrad(const float* s, const float* l, float* partials, float* dw, int b, int m,
               int hs, int ws, int c, int hl, int wl, int stride, int pad, int mt, int ct,
               int groups, int rows, int stages, int splits, void* stream) {
  if (!plan_ok(b, m, hs, ws, c, hl, wl, stride, pad, mt, ct, groups, rows, stages, splits) ||
      (splits > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout y = layout(ws, stride, mt, ct, rows, stages);
  // the largest dynamic shared memory granted so far on each device (the
  // attribute holds for the current device alone); raised before a
  // graph's capture by the eager steps that run each shape first
  static int granted[kMaxDevices];
  int dev = 0;
  cudaError_t set = cudaGetDevice(&dev);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (y.smem > kDefaultSmem && y.smem > granted[dev]) {
    set = cudaFuncSetAttribute(conv_wgrad_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               y.smem);
    if (set != cudaSuccess) return static_cast<int>(set);
    granted[dev] = y.smem;
  }
  const Args a{s,      l,      splits == 1 ? dw : partials,
               b,      m,      hs, ws, c, hl, wl, stride, pad,
               mt,     ct,     groups, rows, stages, splits,
               y.lw,   y.cs,   y.sp, y.s_floats, y.buf};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  conv_wgrad_partial<<<dim3(splits, c / ct, m / mt), kThreads, y.smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int mn = m * c * kTaps;
  const int blocks = (mn * kSumWays + kSumThreads - 1) / kSumThreads;
  conv_wgrad_sum<<<blocks, kSumThreads, 0, st>>>(partials, dw, splits, mn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
